"""The training slice of the port as a whole: a `bert_small` (64 units, 2
layers, 4 heads, FFN 128; vocab 97, max_length 32) with the JAX model's
weights carried across by `load_jax_params`, on CPU tensors, in training
mode: MLM and NSP scores, every parameter gradient of the MLM
`SoftmaxCrossEntropyLoss`, and the parameters after one `Trainer` step
with Adam, against the JAX model under `mx.autograd.record()` and its
`gluon.Trainer`.

Tolerances (float32, two frameworks, the same arithmetic in different
orders over two layers): scores 1e-4 abs and rel; each gradient within
1e-4 of its largest magnitude. Adam's first step is about lr * sign(g),
so where a gradient is near zero (within 10 times its tolerance; the key
bias of attention, whose true gradient is 0, is all such noise) the two
updates may differ in sign: there the parameters are held only to the
step's bound |update| <= lr on each side; elsewhere to 1e-6.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd, gluon, np
from incubator_mxnet_tpu.models.bert import bert_small as jax_bert_small
from incubator_mxnet_tpu_torch import random as mxrandom
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models.bert import bert_small
from incubator_mxnet_tpu_torch.optimizer import Adam

VOCAB, T, LR = 97, 24, 1e-2
GRAD_REL = 1e-4


def _data(seed):
    r = onp.random.RandomState(seed)
    tok = r.randint(0, VOCAB, (3, T)).astype("int32")
    lab = r.randint(0, VOCAB, (3, T)).astype("int32")
    return tok, lab, onp.asarray([T, 11, 5], "int32")


@pytest.fixture(scope="module")
def ref():
    """Scaled random weights (so the heads see token-dependent inputs) and,
    for each case (without / with valid_length), the JAX model's scores,
    gradients and Adam-stepped parameters."""
    mx.random.seed(3)
    jm = jax_bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0)
    jm.initialize()
    r = onp.random.RandomState(0)
    for _name, p in jm.collect_params().items():
        if len(p.shape) >= 2:
            p.set_data(np.array(r.normal(0, 0.2, p.shape).astype("float32")))
    params = {n: p.data().asnumpy() for n, p in jm.collect_params().items()}
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    cases = {}
    for with_vl in (False, True):
        for n, p in jm.collect_params().items():
            p.set_data(np.array(params[n]))
        tok, lab, vl = _data(1)
        trainer = gluon.Trainer(jm.collect_params(), "adam",
                                {"learning_rate": LR})
        with autograd.record():
            mlm, nsp = jm(np.array(tok), None,
                          np.array(vl) if with_vl else None)
            loss = ce(mlm, np.array(lab))
        loss.backward()
        grads = {n: p.grad().asnumpy() for n, p in
                 jm.collect_params().items() if p.grad() is not None}
        trainer.step(tok.shape[0])
        cases[with_vl] = dict(
            mlm=mlm.asnumpy(), nsp=nsp.asnumpy(), loss=loss.asnumpy(),
            grads=grads,
            stepped={n: p.data().asnumpy()
                     for n, p in jm.collect_params().items()})
    return params, cases


def _port(params, dropout=0.0):
    tm = bert_small(vocab_size=VOCAB, max_length=32, dropout=dropout,
                    device="cpu", seed=0)
    tm.load_jax_params(params)
    return tm


def _step(tm, with_vl, seed=1):
    tok, lab, vl = _data(seed)
    mlm, nsp = tm(torch.from_numpy(tok).long(),
                  valid_length=torch.from_numpy(vl) if with_vl else None)
    loss = SoftmaxCrossEntropyLoss()(mlm, torch.from_numpy(lab))
    loss.sum().backward()
    return mlm, nsp, loss


def _grad_tol(g):
    return GRAD_REL * max(float(onp.abs(g).max()), 1e-30)


@pytest.mark.parametrize("with_vl", [False, True])
def test_scores_and_loss_match_jax(ref, with_vl):
    params, cases = ref
    mlm, nsp, loss = _step(_port(params).train(), with_vl)
    c = cases[with_vl]
    assert mlm.shape == (3, T, VOCAB) and nsp.shape == (3, 2)
    assert loss.shape == (3,)
    for got, want in ((mlm, c["mlm"]), (nsp, c["nsp"]), (loss, c["loss"])):
        onp.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                    atol=1e-4)


@pytest.mark.parametrize("with_vl", [False, True])
def test_every_gradient_matches_jax(ref, with_vl):
    params, cases = ref
    tm = _port(params).train()
    _step(tm, with_vl)
    grads = cases[with_vl]["grads"]
    for name, p in tm.named_parameters():
        want = grads.get(name)
        if p.grad is None:       # not reached by the MLM loss
            assert want is None or not onp.abs(want).any(), name
            continue
        onp.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                    atol=_grad_tol(want), err_msg=name)


@pytest.mark.parametrize("with_vl", [False, True])
def test_adam_step_matches_jax_trainer(ref, with_vl):
    params, cases = ref
    tm = _port(params).train()
    _step(tm, with_vl)
    trainer = Trainer(tm.named_parameters(), Adam(learning_rate=LR))
    trainer.step(3)
    c = cases[with_vl]
    for name, p in tm.named_parameters():
        got, want = p.detach().numpy(), c["stepped"][name]
        g = c["grads"].get(name)
        if g is None:
            onp.testing.assert_array_equal(got, want, err_msg=name)
            continue
        sure = onp.abs(g) > 10 * _grad_tol(g)
        onp.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-6,
                                    err_msg=name)
        assert (onp.abs(got - want) <= 2 * LR * (1 + 1e-5)).all(), name


def test_dropout_is_seeded_and_reaches_the_gradients(ref):
    """dropout 0.1 in training mode: the same framework seed gives the same
    loss and gradients, another seed another loss; eval mode drops
    nothing."""
    params, _ = ref

    def run(seed):
        tm = _port(params, dropout=0.1).train()
        mxrandom.seed(seed)
        _, _, loss = _step(tm, True)
        return loss.detach(), [p.grad for p in tm.parameters()]

    la, ga = run(7)
    lb, gb = run(7)
    lc, _ = run(8)
    assert torch.equal(la, lb)
    assert all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(ga, gb))
    assert not torch.equal(la, lc)
    tok, _, vl = _data(1)
    with torch.no_grad():
        a = _port(params, dropout=0.1).eval()(torch.from_numpy(tok).long())
        b = _port(params, dropout=0.0)(torch.from_numpy(tok).long())
    assert torch.equal(a[0], b[0])


def test_trainer_skips_parameters_without_gradient_and_sets_lr(ref):
    params, _ = ref
    tm = _port(params).train()
    _step(tm, True)
    with pytest.raises(TypeError):
        Trainer(tm.named_parameters(), "adam")
    trainer = Trainer(tm.named_parameters(), Adam(learning_rate=0.5))
    assert trainer.learning_rate == 0.5
    trainer.set_learning_rate(LR)
    before = tm.nsp.weight.detach().clone()
    trainer.step(3)
    assert tm.nsp.weight.grad is None and torch.equal(tm.nsp.weight, before)
    assert trainer.optimizer.num_update == 1


def test_trainer_step_takes_ignore_stale_grad(ref):
    """``trainer.step(batch_size, ignore_stale_grad=True)``, MXNet's common
    idiom (reference `gluon/trainer.py:83`, `:113`), on both packages:
    the flag changes nothing where every gradient is fresh, so both step
    as they do without it (the JAX step bit for bit its own), and the
    port skips the gradient-less NSP head either way."""
    params, cases = ref
    mx.random.seed(3)
    jm = jax_bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0)
    jm.initialize()
    for n, p in jm.collect_params().items():
        p.set_data(np.array(params[n]))
    tok, lab, _ = _data(1)
    trainer = gluon.Trainer(jm.collect_params(), "adam",
                            {"learning_rate": LR})
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            jm(np.array(tok))[0], np.array(lab))
    loss.backward()
    trainer.step(tok.shape[0], ignore_stale_grad=True)
    want = cases[False]["stepped"]
    for n, p in jm.collect_params().items():
        onp.testing.assert_array_equal(p.data().asnumpy(), want[n],
                                       err_msg=n)
    for call in ("step", "update"):
        tm = _port(params).train()
        _step(tm, False)
        tt = Trainer(tm.named_parameters(), Adam(learning_rate=LR))
        getattr(tt, call)(3, ignore_stale_grad=True)
        g = cases[False]["grads"]
        for name, p in tm.named_parameters():
            got = p.detach().numpy()
            if name not in g:
                onp.testing.assert_array_equal(got, params[name])
                continue
            sure = onp.abs(g[name]) > 10 * _grad_tol(g[name])
            onp.testing.assert_allclose(got[sure], want[name][sure], rtol=0,
                                        atol=1e-6, err_msg=name)


def test_only_the_flash_path_is_ported():
    with pytest.raises(MXNetError):
        bert_small(use_flash=False, device="cpu")
