"""gluon's core on the port against the JAX package: Parameters and their
deferred shapes, the initializers, Blocks (collect_params, save/load,
grad_req), the reference's training loop (Trainer by name over
collect_params, SoftmaxCrossEntropyLoss on NDArrays under
autograd.record()), `bert_small` as HybridBlocks through that loop,
hybridize on the CPU, the dropout rule (``autograd.is_training()``), and
the public signatures of the slice's modules.

Inputs come from numpy seeds; the JAX package runs on the CPU as the
oracle. Tolerances: deterministic initializers exactly; the random ones by
their law (the bits are Philox's, not threefry's); a Trainer step over the
verify script's net 1e-5; bert_small as `test_torch_bert.py` holds it
(scores 1e-4, each gradient 1e-4 of its largest magnitude, the Adam step
1e-6 where the gradient is clear of noise).
"""
import os

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd, gluon, initializer, np, npx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.telemetry import compiles

VOCAB, T, LR = 97, 24, 1e-2
GRAD_REL = 1e-4


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [
    ("zeros", (3, 4)), ("ones", (5,)), ("constant", (2, 3)),
    ("bilinear", (2, 1, 4, 4)), ("lstmbias", (16,))])
def test_deterministic_initializers_equal_the_reference(name, shape):
    make = {"zeros": lambda m: m.initializer.Zero(),
            "ones": lambda m: m.initializer.One(),
            "constant": lambda m: m.initializer.Constant(0.37),
            "bilinear": lambda m: m.initializer.Bilinear(),
            "lstmbias": lambda m: m.initializer.LSTMBias(forget_bias=2.5)}
    ref = jmx.np.zeros(shape)
    make[name](jmx)("w", ref)
    with tmx.cpu():
        got = np.zeros(shape)
    make[name](tmx)("w", got)
    onp.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())


def test_name_suffix_dispatch_is_the_references():
    with tmx.cpu():
        arrs = {n: np.full((4,), 7.0) for n in ("d.bias", "ln.gamma",
                                                "ln.beta", "bn.running_var")}
    for n, a in arrs.items():
        initializer.Uniform()(n, a)
    want = {"d.bias": 0.0, "ln.gamma": 1.0, "ln.beta": 0.0,
            "bn.running_var": 1.0}
    for n, a in arrs.items():
        assert (a.asnumpy() == want[n]).all(), n


def _init(init, shape, seed=5):
    tmx.random.seed(seed)
    with tmx.cpu():
        a = np.zeros(shape)
    init("w", a)
    return a.asnumpy().astype("float64")


@pytest.mark.parametrize("case", ["uniform", "normal", "xavier_avg",
                                  "xavier_in_gauss", "xavier_out",
                                  "msraprelu", "orthogonal", "seeded"])
def test_random_initializers_hold_their_law(case):
    shape = (256, 192)
    fan_in, fan_out = 192, 256
    if case == "uniform":
        w = _init(initializer.Uniform(0.3), shape)
        assert w.min() >= -0.3 and w.max() <= 0.3
        assert abs(w.mean()) < 0.01 and abs(w.std() - 0.3 / 3 ** 0.5) < 0.005
    elif case == "normal":
        w = _init(initializer.Normal(0.02), shape)
        assert abs(w.mean()) < 1e-3 and abs(w.std() - 0.02) < 5e-4
    elif case == "xavier_avg":
        w = _init(initializer.Xavier(), shape)
        bound = (3.0 / ((fan_in + fan_out) / 2)) ** 0.5
        assert w.min() >= -bound and w.max() <= bound
        assert w.max() > 0.99 * bound
    elif case == "xavier_in_gauss":
        w = _init(initializer.Xavier("gaussian", "in", 2), shape)
        assert abs(w.std() - (2.0 / fan_in) ** 0.5) < 0.003
    elif case == "xavier_out":
        w = _init(initializer.Xavier(factor_type="out", magnitude=6), shape)
        bound = (6.0 / fan_out) ** 0.5
        assert w.min() >= -bound and w.max() > 0.99 * bound
    elif case == "msraprelu":
        w = _init(initializer.MSRAPrelu(slope=0.5), shape)
        sigma = ((2.0 / 1.25) / ((fan_in + fan_out) / 2)) ** 0.5
        assert abs(w.std() - sigma) < 0.003
    elif case == "orthogonal":
        w = _init(initializer.Orthogonal(scale=1.0), (64, 128))
        onp.testing.assert_allclose(w @ w.T, onp.eye(64), atol=1e-5)
    else:  # mx.random.seed makes initialize() reproducible
        a = _init(initializer.Xavier(), shape, seed=11)
        b = _init(initializer.Xavier(), shape, seed=11)
        c = _init(initializer.Xavier(), shape, seed=12)
        assert (a == b).all() and not (a == c).all()


def test_initializer_registry():
    assert isinstance(initializer.create("xavier"), initializer.Xavier)
    assert isinstance(initializer.create("zeros"), initializer.Zero)
    with pytest.raises(ValueError):
        initializer.create("nope")


# ---------------------------------------------------------------------------
# Parameters and Blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer", ["dense", "dense_noflat", "layernorm"])
@pytest.mark.parametrize("conv", ["ndarray", "tensor"])
def test_deferred_shapes_are_inferred_at_the_first_call(layer, conv):
    x = onp.random.RandomState(1).normal(size=(3, 4, 6)).astype("float32")
    with tmx.cpu():
        blk = {"dense": lambda: gluon.nn.Dense(5),
               "dense_noflat": lambda: gluon.nn.Dense(5, flatten=False),
               "layernorm": lambda: gluon.nn.LayerNorm()}[layer]()
        blk.initialize()
        assert blk.collect_params()[
            "gamma" if layer == "layernorm" else "weight"]._data is None
        out = blk(np.array(x) if conv == "ndarray" else torch.from_numpy(x))
    assert isinstance(out, tmx.NDArray if conv == "ndarray" else torch.Tensor)
    shapes = {n: p.shape for n, p in blk.collect_params().items()}
    want = {"dense": {"weight": (5, 24), "bias": (5,)},
            "dense_noflat": {"weight": (5, 6), "bias": (5,)},
            "layernorm": {"gamma": (6,), "beta": (6,)}}[layer]
    assert shapes == want
    assert {n: tuple(p.shape) for n, p in blk.named_parameters()} == want


def _models():
    from incubator_mxnet_tpu.models import bert as jbert
    from incubator_mxnet_tpu.models import gpt as jgpt
    from incubator_mxnet_tpu_torch.models import bert as tbert
    from incubator_mxnet_tpu_torch.models import gpt as tgpt

    return {"bert": (lambda: jbert.bert_small(vocab_size=VOCAB,
                                             max_length=32),
                     lambda: tbert.bert_small(vocab_size=VOCAB,
                                              max_length=32, device="cpu",
                                              seed=0)),
            "gpt": (lambda: jgpt.gpt_tiny(vocab_size=VOCAB, max_length=32),
                    lambda: tgpt.gpt_tiny(vocab_size=VOCAB, max_length=32,
                                          device="cpu", seed=0))}


@pytest.mark.parametrize("model", ["bert", "gpt"])
def test_collect_params_names_are_the_references(model):
    jm, tm = (f() for f in _models()[model])
    ref = {n: tuple(p.shape) for n, p in jm.collect_params().items()}
    got = {n: tuple(p.shape) for n, p in tm.collect_params().items()}
    assert list(got) == list(ref) and got == ref
    assert [n for n, _ in tm.named_parameters()] == sorted(
        got, key=list(got).index)
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == ref
    for pat in (".*ln", ".*(weight|bias)$", "encoder.layers.1", "blocks"):
        assert list(tm.collect_params(pat)) == list(jm.collect_params(pat))


def test_save_parameters_round_trips_with_the_reference(tmp_path):
    """The JAX package's file loads into the port and back, bit for bit,
    checksum sidecar included; a corrupt file and a legacy binary file
    raise before anything is loaded."""
    jm, tm = (f() for f in _models()["bert"])
    jmx.random.seed(4)
    jm.initialize()
    a, b = str(tmp_path / "ref.params"), str(tmp_path / "port.params")
    jm.save_parameters(a)
    ptr = tm.encoder.word_embed.weight.data()._data.data_ptr()
    tm.load_parameters(a)
    assert tm.encoder.word_embed.weight.data()._data.data_ptr() == ptr
    tm.save_parameters(b)
    assert os.path.exists(b + ".crc32")
    jm2 = _models()["bert"][0]()
    jm2.initialize()
    jm2.load_parameters(b)
    for (n, p), (_, q) in zip(jm.collect_params().items(),
                              jm2.collect_params().items()):
        onp.testing.assert_array_equal(p.data().asnumpy(),
                                       q.data().asnumpy(), err_msg=n)
    with open(b, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    with pytest.raises(MXNetError):
        tm.load_parameters(b)
    legacy = str(tmp_path / "legacy.params")
    with open(legacy, "wb") as f:
        f.write(b"\x12\x01\x00\x00\x00\x00\x00\x00" + b"\x00" * 32)
    with pytest.raises(MXNetError):
        tm.load_parameters(legacy)


def test_set_data_copies_in_place_and_rebinds_on_a_new_shape():
    with tmx.cpu():
        p = gluon.Parameter(shape=(2, 3))
        p.initialize()
        t = p.data()._data
        p.set_data(onp.ones((2, 3), "float32"))
        assert p.data()._data is t and (t == 1).all()
        p.set_data(np.zeros((4,)))
        assert p.data()._data is not t and p.shape == (4,)
        blk = gluon.nn.Dense(2, in_units=3)
        blk.initialize()
        new = torch.nn.Parameter(torch.full((2, 3), 0.5))
        blk.weight = new        # a tensor becomes the Parameter's data
        assert blk.weight.data()._data.data_ptr() == new.data_ptr()
        assert dict(blk.named_parameters())["weight"].data_ptr() == \
            new.data_ptr()


def test_copies_and_pickles_keep_one_tensor_a_parameter():
    """`copy.deepcopy` and pickle of a model: every Parameter's tensor is
    the one its block registers, so a weight given to the copy is seen
    by the copy's module tree and not by the original's."""
    import copy
    import pickle

    from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny

    m = gpt_tiny(vocab_size=VOCAB, max_length=32, dropout=0.0,
                 device="cpu", seed=0)
    x = torch.randint(0, VOCAB, (1, 5))
    for c in (copy.deepcopy(m), pickle.loads(pickle.dumps(m))):
        params = c.collect_params()
        assert all(params[n].data()._data is t
                   for n, t in c.named_parameters())
        assert torch.equal(c.generate(x, 3), m.generate(x, 3))
        new = torch.nn.Parameter(torch.zeros(128, 64))
        c.blocks[0].ffn.ffn1.weight = new
        assert dict(c.named_parameters())[
            "blocks.0.ffn.ffn1.weight"] is new
        assert dict(m.named_parameters())[
            "blocks.0.ffn.ffn1.weight"] is not new


def test_grad_req_add_accumulates_and_null_leaves_out():
    x = onp.random.RandomState(2).normal(size=(4, 3)).astype("float32")
    with tmx.cpu():
        d = gluon.nn.Dense(2, in_units=3)
        d.initialize()
        d.weight.grad_req = "add"
        d.bias.grad_req = "null"
        grads = []
        for _ in range(2):
            with autograd.record():
                loss = (d(np.array(x)) ** 2).sum()
            loss.backward()
            grads.append(d.weight.grad().asnumpy().copy())
        onp.testing.assert_allclose(grads[1], 2 * grads[0], rtol=1e-6)
        with pytest.raises(RuntimeError):
            d.bias.grad()
        assert [n for n, p in d.named_parameters() if p.requires_grad] == \
            ["weight"]
        d.weight.grad_req = "write"
        with autograd.record():
            loss = (d(np.array(x)) ** 2).sum()
        loss.backward()
        onp.testing.assert_allclose(d.weight.grad().asnumpy(), grads[0],
                                    rtol=1e-6)
        d.zero_grad()
        assert not d.weight.grad().asnumpy().any()


def test_one_gradient_whichever_convention_computed_it():
    x = onp.random.RandomState(3).normal(size=(4, 3)).astype("float32")
    with tmx.cpu():
        d = gluon.nn.Dense(2, in_units=3)
        d.initialize()
        with autograd.record():
            loss = d(np.array(x)).sum()
        loss.backward()
        nd_grad = d.weight.grad().asnumpy().copy()
        d.zero_grad()
        d(torch.from_numpy(x)).sum().backward()
        onp.testing.assert_array_equal(d.weight.grad().asnumpy(), nd_grad)
        assert d.weight.grad()._data is dict(d.named_parameters())[
            "weight"].grad


# ---------------------------------------------------------------------------
# the reference's gluon loop: the verify script's net, Trainer by name
# ---------------------------------------------------------------------------

def _verify_net(mx, weights=None):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(32, activation="relu"), mx.gluon.nn.Dense(10))
    net.initialize()
    net.hybridize()
    return net


def _verify_run(mx, x, y, weights, steps=3, opt="adam"):
    net = _verify_net(mx)
    net(mx.np.array(x))  # completes the deferred shapes
    for n, p in net.collect_params().items():
        p.set_data(mx.np.array(weights[n]))
    trainer = mx.gluon.Trainer(net.collect_params(), opt,
                               {"learning_rate": 1e-2})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(mx.np.array(x)), mx.np.array(y))
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(loss.asnumpy())
    return losses, {n: p.data().asnumpy()
                    for n, p in net.collect_params().items()}, trainer


def test_verify_script_trainer_matches_the_reference():
    r = onp.random.RandomState(0)
    x = r.uniform(size=(64, 20)).astype("float32")
    y = r.randint(0, 10, (64,)).astype("int32")
    weights = {"0.weight": r.normal(0, 0.2, (32, 20)).astype("float32"),
               "0.bias": r.normal(0, 0.1, (32,)).astype("float32"),
               "1.weight": r.normal(0, 0.2, (10, 32)).astype("float32"),
               "1.bias": r.normal(0, 0.1, (10,)).astype("float32")}
    ref_l, ref_w, _ = _verify_run(jmx, x, y, weights)
    with tmx.cpu():
        got_l, got_w, _ = _verify_run(tmx, x, y, weights)
    for a, b in zip(got_l, ref_l):
        onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for n in ref_w:
        onp.testing.assert_allclose(got_w[n], ref_w[n], rtol=1e-5,
                                    atol=1e-5, err_msg=n)


def test_verify_script_runs_as_written_and_learns():
    """The reference's quick-start script with the package name changed
    and nothing else, under ``with mx.cpu():``; then 20 more steps lower
    the loss."""
    script = '''
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import np, autograd, gluon
net = gluon.nn.HybridSequential()
net.add(gluon.nn.Dense(32, activation="relu"), gluon.nn.Dense(10))
net.initialize(); net.hybridize()
trainer = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
x, y = np.random.uniform(size=(64, 20)), np.random.randint(0, 10, (64,))
with autograd.record():
    loss = loss_fn(net(x), y)
loss.backward(); trainer.step(64)
print(float(loss.mean().item()))
'''
    body = "\n".join("    " + line for line in script.strip().splitlines())
    scope = {}
    with tmx.cpu():
        exec(compile(body.replace("    ", "", 1).replace("\n    ", "\n"),
                     "verify", "exec"), scope)
        first = float(scope["loss"].mean().item())
        assert onp.isfinite(first)
        net, loss_fn = scope["net"], scope["loss_fn"]
        x, y, trainer = scope["x"], scope["y"], scope["trainer"]
        for _ in range(20):
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(64)
        assert float(loss.mean().item()) < first


def test_trainer_states_round_trip_and_lr(tmp_path):
    r = onp.random.RandomState(1)
    x = r.uniform(size=(8, 20)).astype("float32")
    y = r.randint(0, 10, (8,)).astype("int32")
    weights = {"0.weight": r.normal(0, 0.2, (32, 20)).astype("float32"),
               "0.bias": onp.zeros(32, "float32"),
               "1.weight": r.normal(0, 0.2, (10, 32)).astype("float32"),
               "1.bias": onp.zeros(10, "float32")}
    with tmx.cpu():
        _, _, trainer = _verify_run(tmx, x, y, weights, steps=2)
        f = str(tmp_path / "t.states")
        trainer.save_states(f)
        net2 = _verify_net(tmx)
        net2(np.array(x))
        other = gluon.Trainer(net2.collect_params(), "adam")
        other.load_states(f)
    assert other._optimizer._index_update_count == \
        trainer._optimizer._index_update_count
    for a, b in zip(trainer._states, other._states):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    # the reference's pickle layout: the JAX Trainer reads the file
    jnet = _verify_net(jmx)
    jnet(jmx.np.array(x))
    jt = jmx.gluon.Trainer(jnet.collect_params(), "adam")
    jt.load_states(f)
    onp.testing.assert_array_equal(onp.asarray(jt._states[0][0]),
                                   trainer._states[0][0].numpy())
    trainer.set_learning_rate(0.5)
    assert trainer.learning_rate == 0.5
    # "dist_sync" in one process: the world of one, the identity reduce
    t2 = gluon.Trainer(net2.collect_params(), "adam", kvstore="dist_sync")
    t2.step(1)
    assert type(t2._kvstore).__name__ == "KVStoreDist"
    assert t2._kvstore.num_workers == 1


# ---------------------------------------------------------------------------
# bert_small as HybridBlocks through the gluon loop
# ---------------------------------------------------------------------------

def _data(seed):
    r = onp.random.RandomState(seed)
    tok = r.randint(0, VOCAB, (3, T)).astype("int32")
    lab = r.randint(0, VOCAB, (3, T)).astype("int32")
    return tok, lab, onp.asarray([T, 11, 5], "int32")


def _gluon_bert_step(mx, net, hybridize=False):
    tok, lab, vl = _data(1)
    if hybridize:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": LR})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        mlm, nsp = net(mx.np.array(tok), None, mx.np.array(vl))
        loss = ce(mlm, mx.np.array(lab))
    loss.backward()
    grads = {n: p.grad().asnumpy().copy()
             for n, p in net.collect_params().items()
             if p.grad_or_none is not None or mx is jmx}
    trainer.step(tok.shape[0])
    return dict(mlm=mlm.asnumpy(), nsp=nsp.asnumpy(), loss=loss.asnumpy(),
                grads=grads, stepped={n: p.data().asnumpy() for n, p in
                                      net.collect_params().items()})


@pytest.fixture(scope="module")
def bert_ref():
    from incubator_mxnet_tpu.models.bert import bert_small as jbert

    jmx.random.seed(3)
    jm = jbert(vocab_size=VOCAB, max_length=32, dropout=0.0)
    jm.initialize()
    r = onp.random.RandomState(0)
    for _, p in jm.collect_params().items():
        if len(p.shape) >= 2:
            p.set_data(jmx.np.array(r.normal(0, 0.2, p.shape)
                                    .astype("float32")))
    params = {n: p.data().asnumpy() for n, p in jm.collect_params().items()}
    return params, _gluon_bert_step(jmx, jm)


def _tol(g):
    return GRAD_REL * max(float(onp.abs(g).max()), 1e-30)


@pytest.mark.parametrize("hybridize", [False, True])
def test_bert_small_hybrid_blocks_match_jax_through_the_gluon_loop(
        bert_ref, hybridize):
    from incubator_mxnet_tpu_torch.models.bert import bert_small

    params, ref = bert_ref
    with tmx.cpu():
        tm = bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0)
        tm.initialize()
        tm.load_dict(params)
        got = _gluon_bert_step(tmx, tm, hybridize)
    for k in ("mlm", "nsp", "loss"):
        onp.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4)
    for name, want in ref["grads"].items():
        g = got["grads"].get(name)
        if g is None:  # not reached by the MLM loss
            assert not onp.abs(want).any(), name
            continue
        onp.testing.assert_allclose(g, want, rtol=0, atol=_tol(want),
                                    err_msg=name)
    for name, want in ref["stepped"].items():
        g = ref["grads"][name]
        have = got["stepped"][name]
        sure = onp.abs(g) > 10 * _tol(g)
        onp.testing.assert_allclose(have[sure], want[sure], rtol=0,
                                    atol=1e-6, err_msg=name)
        assert (onp.abs(have - want) <= 2 * LR * (1 + 1e-5)).all(), name


# ---------------------------------------------------------------------------
# hybridize on the CPU, the dropout rule
# ---------------------------------------------------------------------------

def test_hybridize_on_the_cpu_equals_eager_with_one_entry_a_signature():
    r = onp.random.RandomState(4)
    x = r.normal(size=(6, 8)).astype("float32")
    x2 = r.normal(size=(3, 8)).astype("float32")

    def run(hyb):
        tmx.random.seed(0)
        with tmx.cpu():
            net = gluon.nn.HybridSequential()
            net.add(gluon.nn.Dense(16, activation="tanh"),
                    gluon.nn.Dropout(0.2), gluon.nn.Dense(4))
            net.initialize()
            if hyb:
                net.hybridize(static_alloc=True, static_shape=True)
            outs = []
            for inp in (x, x, x2, x):
                outs.append(net(np.array(inp)).asnumpy())
                with autograd.record():
                    loss = (net(np.array(inp)) ** 2).sum()
                loss.backward()
                outs.append(net[0].weight.grad().asnumpy().copy())
        return outs, net

    compiles.reset()
    compiles.enable()
    try:
        eager, _ = run(False)
        assert not compiles.ledger()
        hyb, net = run(True)
        led = compiles.ledger()
    finally:
        compiles.disable()
        compiles.reset()
    for a, b in zip(hyb, eager):
        onp.testing.assert_array_equal(a, b)
    # (predict, x), (record, x), (predict, x2), (record, x2)
    assert len(led["cached_op:HybridSequential"]) == 4
    assert net.captures == 0       # the CPU captures nothing
    with pytest.raises(MXNetError):
        net.hybridize(backend="myb")
    with pytest.raises(MXNetError):
        net.hybridize(remat=True)
    with pytest.raises(MXNetError):
        net.export("x")
    with pytest.raises(MXNetError):
        net.optimize_for(np.array(x))


@pytest.mark.parametrize("conv", ["ndarray", "tensor"])
def test_dropout_follows_autograd_is_training(conv):
    x = onp.ones((64, 64), "float32")
    with tmx.cpu():
        layer = gluon.nn.Dropout(0.5)

        def call():
            inp = np.array(x) if conv == "ndarray" else torch.from_numpy(x)
            out = layer(inp)
            out = out.asnumpy() if conv == "ndarray" else out.numpy()
            return out

        assert (call() == 1).all()                      # predict mode
        with autograd.train_mode():
            assert (call() == 0).any()
        with autograd.record():
            assert (call() == 0).any()
        with autograd.record(train_mode=False):
            assert (call() == 1).all()
        with autograd.predict_mode():
            assert (call() == 1).all()
        layer.train()                                   # the module flag
        assert (call() == 1).all()


def test_not_ported_parts_raise():
    with tmx.cpu():
        for make in (lambda: gluon.nn.Embedding(5, 3, sparse_grad=True),
                     lambda: gluon.SymbolBlock(None)):
            with pytest.raises(MXNetError):
                make()
    with pytest.raises(RuntimeError):
        gluon.utils.download("http://example.invalid/x")


def test_activation_blocks_match_the_reference():
    x = onp.random.RandomState(6).normal(size=(4, 6)).astype("float32") * 3
    blocks = [("Activation", ("softrelu",)), ("LeakyReLU", (0.1,)),
              ("ELU", (0.7,)), ("SELU", ()), ("GELU", ()),
              ("GELU", ("tanh",)), ("SiLU", ()), ("Swish", (1.5,)),
              ("Mish", ()), ("PReLU", ())]
    for name, args in blocks:
        jb = getattr(jmx.gluon.nn, name)(*args)
        jb.initialize()
        with tmx.cpu():
            tb = getattr(gluon.nn, name)(*args)
            tb.initialize()
            got = tb(np.array(x)).asnumpy()
        want = jb(jmx.np.array(x)).asnumpy()
        onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                    err_msg=name)
    for act in ("leaky", "elu", "selu", "gelu"):
        want = jmx.npx.leaky_relu(jmx.np.array(x), act_type=act).asnumpy()
        got = npx.leaky_relu(torch.from_numpy(x), act_type=act).numpy()
        onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_utils_match_the_reference():
    r = onp.random.RandomState(8)
    a = r.normal(size=(6, 4)).astype("float32")
    b = r.normal(size=(3,)).astype("float32")
    with tmx.cpu():
        parts = gluon.utils.split_data(np.array(a), 3)
        ta, tb = np.array(a), np.array(b)
        norm = gluon.utils.clip_global_norm([ta, tb], 1.0)
    ja, jb = jmx.np.array(a), jmx.np.array(b)
    jnorm = jmx.gluon.utils.clip_global_norm([ja, jb], 1.0)
    assert [p.shape for p in parts] == [(2, 4)] * 3
    assert abs(norm - jnorm) <= 1e-5 * jnorm
    onp.testing.assert_allclose(ta.asnumpy(), ja.asnumpy(), rtol=1e-5)
    assert gluon.utils.shape_is_known((2, 3)) and \
        not gluon.utils.shape_is_known((0, 3))


# ---------------------------------------------------------------------------
# the slice's public signatures as the reference's
# ---------------------------------------------------------------------------

SURFACE = ("gluon/parameter.py", "gluon/block.py", "gluon/loss.py",
           "gluon/trainer.py", "gluon/utils.py", "gluon/nn/basic_layers.py",
           "gluon/nn/activations.py", "optimizer/optimizer.py",
           "initializer.py", "lr_scheduler.py", "models/bert.py",
           "models/gpt.py", "parallel/sharded.py", "ndarray/optim_ops.py",
           "models/decoding.py", "amp/__init__.py", "amp/loss_scaler.py",
           "gluon/nn/conv_layers.py", "gluon/nn/extra_layers.py",
           "ops/flash_attention.py", "ops/fused_block.py",
           "ops/layer_norm.py", "ops/dropout.py",
           "numpy_extension/__init__.py",
           "numpy_extension/_contrib_misc.py", "numpy_extension/_spatial.py",
           "gluon/model_zoo/model_store.py",
           "gluon/model_zoo/vision/__init__.py",
           "gluon/model_zoo/vision/alexnet.py",
           "gluon/model_zoo/vision/densenet.py",
           "gluon/model_zoo/vision/inception.py",
           "gluon/model_zoo/vision/mobilenet.py",
           "gluon/model_zoo/vision/resnet.py",
           "gluon/model_zoo/vision/squeezenet.py",
           "gluon/model_zoo/vision/vgg.py",
           # the np/npx/nd remainder
           "numpy_extension/_transformer.py", "numpy/linalg.py",
           "ndarray/legacy_ops.py", "ndarray/legacy_io.py",
           "ndarray/contrib.py",
           # distributed training (`parallel.mesh`'s `Mesh` is a class in
           # the port and a function in the reference, so it stays out)
           "parallel/collectives.py", "parallel/dist.py",
           "parallel/ring_attention.py", "parallel/pipeline.py",
           "parallel/moe.py", "models/sharded_bert.py",
           "gluon/contrib/moe.py", "kvstore/base.py", "kvstore/kvstore.py",
           "kvstore/compression.py", "kvstore/horovod.py",
           "kvstore/byteps.py")
# the reference's public names the port has no counterpart for yet, each
# with its reason (ROADMAP.md §1): the test fails if the port grows one
NOT_PORTED = {
    "gluon/block.py": {"SymbolBlock.forward": "SymbolBlock raises at "
                       "construction (ROADMAP.md §1 item 11b)"},
    "ops/dropout.py": {
        "use_kernel": "the TPU's kernel-or-XLA policy by key type; the port "
                      "launches the kernel for every CUDA tensor "
                      "(ROADMAP.md §3, impl='auto')",
        "supports": "the TPU kernel's shape gate; the port's kernel takes "
                    "every shape and float dtype it is given"},
    "ops/fused_block.py": {
        "supports": "the TPU kernel's lane gate; the port's wrappers gate "
                    "through layer_norm.supports and raise where it fails"},
}
# the npx files the vision path and the np/npx remainder port from: every
# other function of them is ROADMAP.md §1 item 11b's
VISION_NPX = {"numpy_extension/_contrib_misc.py": (
                  "adaptive_avg_pooling2d", "batch_norm_with_relu", "pad",
                  "softsign", "quadratic", "index_copy", "index_array",
                  "gradientmultiplier", "dynamic_reshape", "round_ste",
                  "sign_ste", "all_finite", "multi_all_finite", "norm",
                  "slice", "slice_channel", "add_n"),
              "numpy_extension/_spatial.py": (
                  "deformable_convolution",
                  "modulated_deformable_convolution"),
              # every function the port's npx defines (the vision ops
              # among them)
              "numpy_extension/__init__.py": None}


def _npx_rest(rel, ported):
    import incubator_mxnet_tpu

    path = os.path.join(os.path.dirname(incubator_mxnet_tpu.__file__), rel)
    return {n: "ROADMAP.md §1 item 11b (the npx remainder)"
            for n in _signatures(path)
            if "." not in n and not n.startswith("_") and n not in ported}


def _signatures(path):
    import ast

    out = {}

    def visit(node, prefix=""):
        for n in node.body:
            if isinstance(n, ast.FunctionDef):
                a = n.args
                out[prefix + n.name] = (
                    [x.arg for x in a.posonlyargs + a.args],
                    [ast.unparse(d) for d in a.defaults],
                    [(x.arg, None if d is None else ast.unparse(d))
                     for x, d in zip(a.kwonlyargs, a.kw_defaults)],
                    a.vararg and a.vararg.arg, a.kwarg and a.kwarg.arg)
            elif isinstance(n, ast.ClassDef):
                out[prefix + n.name] = "class"
                visit(n, prefix + n.name + ".")

    with open(path, encoding="utf-8") as f:
        visit(ast.parse(f.read()))
    return out


def _leads(ref, port):
    """Every call valid against ``ref`` is valid against ``port``: the
    reference's parameters lead the port's in order with its defaults;
    the port may add parameters with defaults after them, and keeps
    ``*args``/``**kwargs`` where the reference has them."""
    if ref == "class" or port == "class":
        return ref == port
    args, dflt = ref[0], ref[1]
    pargs, pdflt = port[0], port[1]
    if pargs[:len(args)] != args:
        return False
    rd = dict(zip(args[len(args) - len(dflt):], dflt))
    pd = dict(zip(pargs[len(pargs) - len(pdflt):], pdflt))
    if any(pd.get(a) != d for a, d in rd.items()):
        return False
    if any(a not in pd for a in pargs[len(args):]):
        return False
    if any(kw not in port[2] for kw in ref[2]):
        return False
    return (ref[3] is None or port[3] == ref[3]) and \
        (ref[4] is None or port[4] == ref[4])


@pytest.mark.parametrize("rel", SURFACE)
def test_public_signatures_lead_with_the_references(rel):
    """Every public function and method of the slice's modules takes the
    reference's parameters, in its order and with its defaults, so every
    call valid in the reference is valid in the port (the port's extras,
    ``device=``, ``dtype=``, ``impl=``, ``seed=``, come after them)."""
    import incubator_mxnet_tpu
    import incubator_mxnet_tpu_torch

    ref = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu.__file__), rel))
    port = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu_torch.__file__), rel))
    skip = NOT_PORTED.get(rel, {})
    if rel in VISION_NPX:
        skip = _npx_rest(rel, VISION_NPX[rel] or port)
    for name in skip:
        assert name in ref and name not in port, (rel, name)
    bad = []
    for name, sig in ref.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("_") and leaf != "__init__":
            continue
        if name in skip:
            continue
        if name not in port or not _leads(sig, port[name]):
            bad.append((name, sig, port.get(name)))
    assert not bad, (rel, bad)


@pytest.mark.parametrize("name", ["relu", "sigmoid", "activation",
                                  "leaky_relu", "log_softmax", "softmax",
                                  "softmin", "masked_softmax",
                                  "masked_log_softmax", "batch_dot",
                                  "arange_like", "dropout"])
def test_npx_ops_of_the_slice_lead_with_the_references(name):
    """The npx ops gluon's activations and losses call take the
    reference's parameters, in its order and with its defaults."""
    import incubator_mxnet_tpu
    import incubator_mxnet_tpu_torch

    rel = "numpy_extension/__init__.py"
    ref = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu.__file__), rel))[name]
    port = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu_torch.__file__), rel))[name]
    assert _leads(ref, port), (name, ref, port)
