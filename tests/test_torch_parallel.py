"""The port's compiled training step, `parallel.DataParallel`, on CPU
tensors (where it runs its step function eagerly on the plain versions),
against the JAX package's `parallel.DataParallel` with the same weights
(`load_jax_params`): a `bert_small` (64 units, 2 layers, 4 heads, FFN 128;
vocab 97, max_length 32) at dropout 0, Adam at the reference bench's lr
1e-4, three steps on three batches, without and with weight decay.

Tolerances, those of `test_torch_bert.py::test_adam_step_matches_jax_trainer`
(float32, two frameworks, the same arithmetic in other orders): the loss
of each step within 1e-4 (abs and rel), as the scores there. Adam's step
is about lr * sign(g), so where the step's gradient (with ``wd * w``
added) is near zero at any of the steps (within 10 times 1e-4 of its
largest magnitude), the two updates may differ in sign: there a
parameter is held only to the steps' bound, |update| <= lr a step on
each side; elsewhere to 1e-6. This covers the NSP head, which the MLM
loss does not reach: zero gradient, moved only by weight decay.

Dropout (p = 0.1) has no JAX counterpart bit for bit (another
generator); its keys are held to the contract: one seed gives one run,
another seed another, every step draws a fresh mask, the mask is the one
`ops._philox` folds from the step's base key, ``t`` and the site, and the
keep fraction lies within 6 binomial standard deviations of 1 - p.
"""
import math

import numpy as onp
import pytest
import torch
from torch import nn

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd, gluon, np
from incubator_mxnet_tpu import optimizer as jax_optimizer
from incubator_mxnet_tpu.models.bert import bert_small as jax_bert_small
from incubator_mxnet_tpu.parallel import DataParallel as JaxDataParallel
from incubator_mxnet_tpu_torch import npx
from incubator_mxnet_tpu_torch import random as mxrandom
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models.bert import bert_small
from incubator_mxnet_tpu_torch.ops import _philox as ph
from incubator_mxnet_tpu_torch.optimizer import Adam
from incubator_mxnet_tpu_torch.parallel import DataParallel

VOCAB, T, LR, STEPS = 97, 24, 1e-4, 3
GRAD_REL = 1e-4
WDS = (0.0, 0.01)


def _batch(step):
    r = onp.random.RandomState(step)
    return (r.randint(0, VOCAB, (3, T)).astype("int32"),
            r.randint(0, VOCAB, (3, T)).astype("int32"))


@pytest.fixture(scope="module")
def ref():
    """Scaled random weights and, for each wd, the JAX DataParallel's
    losses and parameters after each of the steps, with each step's
    gradient (plus wd * w) at the parameters it started from."""
    mx.random.seed(3)
    jm = jax_bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0)
    jm.initialize()
    r = onp.random.RandomState(0)
    for _name, p in jm.collect_params().items():
        if len(p.shape) >= 2:
            p.set_data(np.array(r.normal(0, 0.2, p.shape).astype("float32")))
    params = {n: p.data().asnumpy() for n, p in jm.collect_params().items()}
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    runs = {}
    for wd in WDS:
        for n, p in jm.collect_params().items():
            p.set_data(np.array(params[n]))
        jdp = JaxDataParallel(jm, lambda out, y: ce(out[0], y),
                              jax_optimizer.Adam(learning_rate=LR, wd=wd))
        losses, grads = [], []
        for step in range(STEPS):
            tok, lab = _batch(step)
            with autograd.record():
                loss = ce(jm(np.array(tok))[0], np.array(lab)).mean()
            loss.backward()
            grads.append({
                n: wd * p.data().asnumpy() + (
                    p.grad().asnumpy() if p.grad() is not None else 0.0)
                for n, p in jm.collect_params().items()})
            losses.append(float(jdp.step(np.array(tok),
                                         np.array(lab)).asnumpy()))
        runs[wd] = dict(losses=losses, grads=grads, params={
            n: p.data().asnumpy() for n, p in jm.collect_params().items()})
    return params, runs


def _ce():
    ce = SoftmaxCrossEntropyLoss()
    return lambda out, y: ce(out[0], y)


def _port(params=None, dropout=0.0, seed=0):
    tm = bert_small(vocab_size=VOCAB, max_length=32, dropout=dropout,
                    device="cpu", seed=seed)
    if params is not None:
        tm.load_jax_params(params)
    return tm


def _steps(dp, n=STEPS):
    losses = []
    for step in range(n):
        tok, lab = _batch(step)
        losses.append(dp.step(torch.from_numpy(tok).long(),
                              torch.from_numpy(lab).long()))
    return losses


@pytest.mark.parametrize("wd", WDS)
def test_losses_and_parameters_match_jax_data_parallel(ref, wd):
    params, runs = ref
    run = runs[wd]
    tm = _port(params)
    losses = _steps(DataParallel(tm, _ce(), Adam(learning_rate=LR, wd=wd)))
    assert all(v.shape == () for v in losses)
    onp.testing.assert_allclose([float(v) for v in losses], run["losses"],
                                rtol=1e-4, atol=1e-4)
    for name, p in tm.named_parameters():
        got, want = p.detach().numpy(), run["params"][name]
        sure = onp.ones(got.shape, bool)
        for g in run["grads"]:
            g = onp.broadcast_to(g[name], got.shape)
            sure &= onp.abs(g) > 10 * GRAD_REL * max(float(onp.abs(g).max()),
                                                     1e-30)
        onp.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-6,
                                    err_msg=name)
        assert (onp.abs(got - want) <= 2 * LR * STEPS * (1 + 1e-5)).all(), name
    nsp = tm.nsp.weight.detach().numpy()
    if wd:  # moved by weight decay alone, as the reference moves it
        assert not onp.array_equal(nsp, params["nsp.weight"])
    else:
        onp.testing.assert_array_equal(nsp, params["nsp.weight"])
        onp.testing.assert_array_equal(run["params"]["nsp.weight"],
                                       params["nsp.weight"])


class _Wide(nn.Module):
    """A linear model with one parameter above the small-parameter limit
    (2^14 elements), three below it, one of them bf16."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.big = nn.Parameter(torch.randn(160, 128, generator=g) * 0.1)
        self.small = nn.Parameter(torch.randn(128, 4, generator=g) * 0.1)
        self.bias = nn.Parameter(torch.zeros(4))
        self.low = nn.Parameter(torch.zeros(4, dtype=torch.bfloat16))

    def forward(self, x):
        h = npx.dropout(x @ self.big, p=0.1, training=self.training)
        return h @ self.small + self.bias + self.low.float()


def _mse(out, y):
    return ((out - y) ** 2).mean(dim=-1)


def test_small_parameter_segment_follows_the_references_rule():
    dp = DataParallel(_Wide(), _mse, Adam())
    assert [tuple(dp.params[i].shape) for i in dp._fused] == [(128, 4),
                                                              (4,)]

    class Stats(Adam):
        elementwise = False

    assert DataParallel(_Wide(), _mse, Stats())._fused == []
    solo = nn.Linear(200, 100)  # one small parameter only: no segment
    assert DataParallel(solo, _mse, Adam())._fused == []


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_small_parameter_segment_equals_the_per_parameter_update(
        monkeypatch, dropout):
    """The segment (`Adam.step_multi`) and the per-parameter update
    (MXNET_OPTIMIZER_AGGREGATION_SIZE=1, the reference's switch) give the
    same parameters bit for bit, weight decay and clipping included."""
    out = []
    for agg in (None, "1"):
        if agg is None:
            monkeypatch.delenv("MXNET_OPTIMIZER_AGGREGATION_SIZE",
                               raising=False)
        else:
            monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", agg)
        tm = _port(dropout=dropout, seed=4)
        opt = Adam(learning_rate=1e-3, wd=0.01, clip_gradient=0.05)
        dp = DataParallel(tm, _ce(), opt)
        assert bool(dp._fused) == (agg is None)
        mxrandom.seed(11)
        losses = _steps(dp, 2)
        out.append((losses, [p.detach().clone() for p in tm.parameters()]))
    (la, pa), (lb, pb) = out
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def test_step_multi_equals_step_with_device_scalars():
    g = torch.Generator().manual_seed(1)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    ws = [torch.randn(s, generator=g) for s in shapes]
    gs = [torch.randn(s, generator=g) for s in shapes]
    lr, wd, t = (torch.tensor(0.01, dtype=torch.float64),
                 torch.tensor(0.1, dtype=torch.float64), torch.tensor(3))
    opt = Adam(clip_gradient=0.5, rescale_grad=0.5)
    one = [w.clone() for w in ws]
    states = [[torch.rand(s, generator=g), torch.rand(s, generator=g)]
              for s in shapes]
    states_one = [[m.clone(), v.clone()] for m, v in states]
    opt.step_multi(ws, gs, states, lr, wd, t)
    for w, gr, s in zip(one, gs, states_one):
        opt.step(w, gr, s, lr, wd, t)
    assert all(torch.equal(a, b) for a, b in zip(ws, one))
    assert all(torch.equal(a, b) for sa, sb in zip(states, states_one)
               for a, b in zip(sa, sb))
    # device scalars give the host numbers' update
    host = [w.clone() for w in one]
    states_host = [[m.clone(), v.clone()] for m, v in states_one]
    for w, gr, s in zip(one, gs, states_one):
        opt.step(w, gr, s, lr, wd, t)
    for w, gr, s in zip(host, gs, states_host):
        opt.step(w, gr, s, 0.01, 0.1, 3)
    for a, b in zip(one, host):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_set_learning_rate_takes_effect_between_steps():
    tm = _port(seed=2)
    dp = DataParallel(tm, _ce(), Adam(learning_rate=1e-3))
    _steps(dp, 1)
    after_one = [p.detach().clone() for p in tm.parameters()]
    dp.optimizer.set_learning_rate(0.0)
    _steps(dp, 1)
    assert float(dp._lr_dev) == 0.0
    assert all(torch.equal(a, p) for a, p in zip(after_one, tm.parameters()))
    dp.optimizer.set_learning_rate(1e-3)
    _steps(dp, 1)
    assert not torch.equal(after_one[0], next(tm.parameters()))
    assert dp.optimizer.num_update == 3 and int(dp._t_dev) == 4


def test_step_differentiates_under_no_grad():
    """The step takes its gradients whatever autograd mode its caller is
    in, as the reference's compiled step does."""
    runs = []
    for grad_mode in (True, False):
        tm = _port(seed=6)
        dp = DataParallel(tm, _ce(), Adam(learning_rate=1e-3))
        with torch.set_grad_enabled(grad_mode):
            _steps(dp, 2)
        runs.append([p.detach().clone() for p in tm.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_mesh_shardings_and_remat_raise():
    tm = _port()
    for kw in ({"mesh": object()}, {"param_shardings": [None]},
               {"remat": "full"}):
        with pytest.raises(MXNetError, match="ROADMAP"):
            DataParallel(tm, _ce(), Adam(), **kw)
    dp = DataParallel(tm, _ce(), Adam())
    for fn in (dp.rebuild, dp.shardcheck_report):
        with pytest.raises(MXNetError, match="ROADMAP"):
            fn()


def _dropout_run(seed, steps=3):
    tm = _port(dropout=0.1, seed=5)
    mxrandom.seed(seed)
    return [float(v) for v in _steps(DataParallel(tm, _ce(),
                                                  Adam(learning_rate=LR)),
                                     steps)]


def test_dropout_is_seeded_and_a_reseed_changes_it():
    a, b, c = _dropout_run(7), _dropout_run(7), _dropout_run(8)
    assert a == b
    assert a != c


class _Probe(nn.Module):
    """One dropout site over a (64, 1024) tensor; records its keep mask."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(1024))
        self.masks = []

    def forward(self, x):
        y = npx.dropout(x * self.w, p=0.1, training=self.training)
        self.masks.append((y != 0).detach())
        return y


def test_each_step_draws_a_fresh_mask_folded_from_its_key():
    net = _Probe()
    dp = DataParallel(net, _mse, Adam(learning_rate=LR))
    x, y = torch.ones(64, 1024), torch.zeros(64, 1024)
    mxrandom.seed(3)
    for _ in range(3):
        t = int(dp._t_dev)
        dp.step(x, y)
        key = ph.DeviceKey(dp._base_key, torch.tensor(t), 0, {})
        assert torch.equal(net.masks[-1],
                           ph.keep_mask(x.shape, ph.key_words(key), 0.1))
    assert not torch.equal(net.masks[0], net.masks[1])
    assert not torch.equal(net.masks[1], net.masks[2])
    for m in net.masks:
        kept, n = int(m.sum()), m.numel()
        assert abs(kept / n - 0.9) <= 6 * math.sqrt(0.1 * 0.9 / n)
    # the step runs in training mode and then restores the module's mode
    net.eval()
    dp.step(x, y)
    assert not net.training and not net.masks[-1].all()
