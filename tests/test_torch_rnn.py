"""The port's RNN family (`npx.rnn`, `rnn_param_size`, `nd.RNN`,
`gluon.utils.split_rnn_params`, `gluon.rnn`'s layers and cells, the zoo's
`lstm_charlm_tiny`) against the JAX package's, on the CPU.

The same numpy-seeded inputs and parameters go into both. Tolerances
(float32): outputs and states rtol 1e-5 (atol 1e-6); gradients (the
reference's `npx.rnn` under one jitted `jax.vjp`, the function its
autograd differentiates) rtol 1e-4, atol 1e-5, a few time steps of
products summed in another order. The
dropout and zoneout cells run at p = 0; the fused layer's dropout between
layers is held to the dropout contract (the kept fraction near 1 - p, the
kept values x / (1 - p), p = 0 the identity).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch.gluon.model_zoo import model_store as tstore

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _r(shape, seed, scale=1.0):
    return (onp.random.RandomState(seed).normal(0, scale, shape)
            .astype("float32"))


def _close(got, want, rtol=RTOL, atol=ATOL):
    onp.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _reference(fn, *arrays):
    """The reference's ``fn`` on NDArrays of ``arrays``, run under one
    ``jax.jit`` (one XLA compile for the call, where its eager path
    compiles op by op); its NDArray outputs, in the same nesting, as
    numpy."""
    def leaf(o):
        return isinstance(o, NDArray)

    def traced(*vals):
        out = fn(*[NDArray(v) for v in vals])
        return jax.tree_util.tree_map(lambda o: o._data, out, is_leaf=leaf)

    out = jax.jit(traced)(*[jnp.asarray(a) for a in arrays])
    return jax.tree_util.tree_map(onp.asarray, out)


# ---------------------------------------------------------------------------
# npx.rnn
# ---------------------------------------------------------------------------

RNN_CASES = {
    "lstm_2layer_bi_clip": ("lstm", 2, True, (-0.6, 0.6)),
    "gru_2layer": ("gru", 2, False, None),
    "rnn_tanh_bi": ("rnn_tanh", 1, True, None),
    "rnn_relu": ("rnn_relu", 1, False, None),
}


@pytest.mark.parametrize("case", sorted(RNN_CASES))
def test_npx_rnn_matches_the_references_with_gradients(case):
    mode, layers, bi, clip = RNN_CASES[case]
    T, N, C, H = 4, 3, 5, 6
    dirs = 2 if bi else 1
    n = tmx.npx.rnn_param_size(mode, layers, C, H, bi)
    assert n == jmx.npx.rnn_param_size(mode, layers, C, H, bi)
    x, p = _r((T, N, C), 1), _r((n,), 2, 0.4)
    h0, c0 = _r((layers * dirs, N, H), 3), _r((layers * dirs, N, H), 4)
    dy = _r((T, N, dirs * H), 5)
    kw = dict(mode=mode, state_size=H, num_layers=layers, bidirectional=bi,
              state_outputs=True)
    if clip:
        kw.update(lstm_state_clip_min=clip[0], lstm_state_clip_max=clip[1])
    lstm = mode == "lstm"
    vals = [x, p, h0] + ([c0] if lstm else [])

    def reference(*args):
        outs = jmx.npx.rnn(*[NDArray(a) for a in args],
                           *([] if lstm else [None]), **kw)
        return tuple(o._data for o in outs)

    def vjp(*args):
        # the cotangent of (outs[0] * dy).sum() + outs[1].sum()
        outs, back = jax.vjp(reference, *args)
        cot = (jnp.asarray(dy), jnp.ones_like(outs[1])) + tuple(
            jnp.zeros_like(o) for o in outs[2:])
        return outs, back(cot)

    want, want_g = jax.jit(vjp)(*vals)
    with tmx.cpu():
        arrs = [tmx.np.array(a) for a in vals]
        for a in arrs:
            a.attach_grad()
        with tmx.autograd.record():
            outs = tmx.npx.rnn(arrs[0], arrs[1], arrs[2],
                               arrs[3] if lstm else None, **kw)
            loss = (outs[0] * tmx.np.array(dy)).sum() + outs[1].sum()
        loss.backward()
        got = [o.asnumpy() for o in outs]
        got_g = [a.grad.asnumpy() for a in arrs]
    assert len(got) == (3 if lstm else 2)
    for g, w in zip(got, want):
        _close(g, onp.asarray(w))
    for g, w in zip(got_g, want_g):
        _close(g, onp.asarray(w), GRAD_RTOL, GRAD_ATOL)


def test_rnn_dropout_between_layers_keeps_the_contract(monkeypatch):
    """p = 0.2 in training: one dropout a layer boundary, each kept value
    x / (1 - p), about 1 - p of them kept; p = 0 in training is the
    predict-mode output exactly."""
    seen = []
    real = tmx.npx.dropout

    def spy(data, p=0.5, **kw):
        out = real(data, p=p, **kw)
        seen.append((data.detach().clone(), out.detach().clone()))
        return out

    monkeypatch.setattr(tmx.npx, "dropout", spy)
    T, N, C, H = 6, 8, 5, 16
    n = tmx.npx.rnn_param_size("lstm", 3, C, H, False)
    args = [_r((T, N, C), 1), _r((n,), 2, 0.4), _r((3, N, H), 3),
            _r((3, N, H), 4)]
    with tmx.cpu():
        nd = [tmx.np.array(a) for a in args]
        kw = dict(mode="lstm", state_size=H, num_layers=3)
        with tmx.autograd.train_mode():
            tmx.npx.rnn(*nd, p=0.2, **kw)
            assert len(seen) == 2
            drop0 = tmx.npx.rnn(*nd, p=0.0, **kw).asnumpy()
        plain = tmx.npx.rnn(*nd, p=0.2, **kw).asnumpy()
    onp.testing.assert_array_equal(drop0, plain)
    assert len(seen) == 4
    for x, y in seen[2:]:                       # predict mode: identity
        assert torch.equal(x, y)
    for x, y in seen[:2]:
        kept = y != 0
        assert 0.7 < kept.float().mean() < 0.9
        torch.testing.assert_close(y[kept], x[kept] * (1 / 0.8), rtol=1e-6,
                                   atol=0)


def test_param_size_split_and_nd_rnn_match_the_references():
    for mode in ("lstm", "gru", "rnn_tanh"):
        for layers, bi in ((1, False), (2, True)):
            assert tmx.npx.rnn_param_size(mode, layers, 7, 5, bi) == \
                jmx.npx.rnn_param_size(mode, layers, 7, 5, bi)
    n = tmx.npx.rnn_param_size("gru", 2, 4, 3, True)
    p = _r((n,), 6)
    want = jmx.gluon.utils.split_rnn_params(jmx.np.array(p), "gru", 2, 4, 3,
                                            True)
    with tmx.cpu():
        got = tmx.gluon.utils.split_rnn_params(tmx.np.array(p), "gru", 2, 4,
                                               3, True)
        with pytest.raises(ValueError, match="consumes"):
            tmx.gluon.utils.split_rnn_params(p[:-1], "gru", 2, 4, 3, True)
    assert list(got) == list(want)
    for k in want:
        onp.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
    assert tmx.nd.RNN is tmx.npx.rnn
    x, h0 = _r((3, 2, 4), 7), _r((2, 2, 3), 8)
    p = _r((tmx.npx.rnn_param_size("rnn_tanh", 1, 4, 3, True),), 9)
    want = _reference(lambda *a: jmx.nd.RNN(*a, mode="rnn_tanh",
                                            state_size=3,
                                            bidirectional=True), x, p, h0)
    with tmx.cpu():
        got = tmx.nd.RNN(tmx.np.array(x), tmx.np.array(p), tmx.np.array(h0),
                         mode="rnn_tanh", state_size=3, bidirectional=True)
    _close(got.asnumpy(), want)


# ---------------------------------------------------------------------------
# gluon.rnn: the fused layers
# ---------------------------------------------------------------------------

LAYERS = {
    "lstm_ntc_states": ("LSTM", dict(num_layers=2, layout="NTC"), True),
    "gru_bi_tnc": ("GRU", dict(bidirectional=True), False),
    "rnn_tanh_ntc": ("RNN", dict(activation="tanh", layout="NTC"), True),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_rnn_layers_match_the_references(case):
    cls, kw, states = LAYERS[case]
    H, C = 6, 4
    x = _r((3, 5, C), 10)
    with tmx.cpu():
        tl = getattr(tmx.gluon.rnn, cls)(H, **kw)
        tl.initialize()
        assert tl.parameters.shape == (0,)          # deferred input size
        tl(tmx.np.array(x))
        p = tl.parameters.data().asnumpy()
        info = tl.state_info(2)
        batch = 3 if kw.get("layout") == "NTC" else 5
        st = tl.begin_state(batch)
        assert [s.shape for s in st] == [i["shape"] for i in
                                         tl.state_info(batch)]
        st = [tmx.np.array(_r(s.shape, 11 + i)) for i, s in enumerate(st)]
        got = tl(tmx.np.array(x), st) if states else tl(tmx.np.array(x))
    jl = getattr(jmx.gluon.rnn, cls)(H, input_size=C, **kw)
    jl.parameters.set_data(jmx.np.array(p))
    assert jl.state_info(2) == info
    jst = [s.asnumpy() for s in st]
    if states:
        want = _reference(lambda xa, *sa: jl(xa, list(sa)), x, *jst)
        _close(got[0].asnumpy(), want[0])
        assert len(got[1]) == len(want[1])
        for g, w in zip(got[1], want[1]):
            _close(g.asnumpy(), w)
    else:
        _close(got.asnumpy(), _reference(jl, x))


def test_charlm_from_the_store_matches_the_references():
    """The zoo's lstm_charlm_tiny (embedding, LSTM, dense head), found in
    the port's store by its sha1 and loaded into both packages' nets."""
    path = tstore.get_model_file("lstm_charlm_tiny")
    assert tstore._sha1(path) == "1d0bb79f9ecf77a0c759803ff9fc83d7522d0b2f"  # noqa: SLF001
    tokens = onp.random.RandomState(12).randint(0, 28, (2, 16)).astype(
        "int32")

    def build(mx, deferred):
        """The reference test's net: sizes deferred to a first call after
        ``initialize()`` (the port's), or given (the oracle's, which then
        compiles no initializer)."""
        g = mx.gluon

        class CharLM(g.HybridBlock):
            def __init__(self):
                super().__init__()
                self.embed = g.nn.Embedding(28, 32)
                self.lstm = g.rnn.LSTM(64, num_layers=1, layout="NTC",
                                       input_size=0 if deferred else 32)
                self.head = g.nn.Dense(28, flatten=False,
                                       in_units=0 if deferred else 64)

            def forward(self, x):
                return self.head(self.lstm(self.embed(x)))

        net = CharLM()
        if deferred:
            net.initialize()
            net(mx.np.array(onp.zeros((1, 8), "int32")))
        net.load_parameters(path)
        return net

    want = _reference(build(jmx, False), tokens)
    with tmx.cpu():
        got = build(tmx, True)(tmx.np.array(tokens)).asnumpy()
    assert got.shape == (2, 16, 28)
    _close(got, want)


# ---------------------------------------------------------------------------
# gluon.rnn: the cells
# ---------------------------------------------------------------------------

def _cells(rnn, C):
    """name -> (cell, its parameter names), the cells built the same way
    in either package."""
    def seq():
        s = rnn.SequentialRNNCell()
        s.add(rnn.LSTMCell(6, input_size=C))
        s.add(rnn.DropoutCell(0.0))
        s.add(rnn.ResidualCell(rnn.GRUCell(6, input_size=6)))
        return s

    return {
        "rnn_relu": lambda: rnn.RNNCell(6, activation="relu", input_size=C),
        "lstm": lambda: rnn.LSTMCell(6, input_size=C),
        "gru": lambda: rnn.GRUCell(6, input_size=C),
        "lstmp": lambda: rnn.LSTMPCell(6, 3, input_size=C),
        "sequential_dropout_residual": seq,
        "zoneout": lambda: rnn.ZoneoutCell(rnn.GRUCell(6, input_size=C),
                                           0.0, 0.0),
        "variational": lambda: rnn.VariationalDropoutCell(
            rnn.LSTMCell(6, input_size=C)),
        "bidirectional": lambda: rnn.BidirectionalCell(
            rnn.GRUCell(4, input_size=C), rnn.RNNCell(3, input_size=C)),
        "conv_rnn": lambda: rnn.ConvRNNCell(3, (3, 3),
                                            input_shape=(2, 5, 5)),
        "conv_lstm": lambda: rnn.ConvLSTMCell(3, (3, 3),
                                              input_shape=(2, 5, 5)),
        "conv_gru": lambda: rnn.Conv1DGRUCell(3, (3,), input_shape=(2, 7)),
    }


CELL_IN = {"conv_rnn": (2, 3, 2, 5, 5), "conv_lstm": (2, 3, 2, 5, 5),
           "conv_gru": (2, 3, 2, 7)}


@pytest.mark.parametrize("case", sorted(_cells(tmx.gluon.rnn, 4)))
def test_cells_unroll_as_the_references(case):
    shape = CELL_IN.get(case, (2, 3, 4))          # NTC (N, T, ...)
    x = _r(shape, 13)
    with tmx.cpu():
        tc = _cells(tmx.gluon.rnn, 4)[case]()
        tc.initialize()
        params = {}
        for i, (name, p) in enumerate(sorted(tc.collect_params().items())):
            p.set_data(_r(p.shape, 20 + i, 0.5))
            params[name] = p.data().asnumpy()
        got, got_states = tc.unroll(3, tmx.np.array(x), layout="NTC",
                                    merge_outputs=True)
    jc = _cells(jmx.gluon.rnn, 4)[case]()
    jp = jc.collect_params()
    assert sorted(jp) == sorted(params)
    for name, p in jp.items():
        p.set_data(jmx.np.array(params[name]))
    want, want_states = _reference(
        lambda xa: jc.unroll(3, xa, layout="NTC", merge_outputs=True), x)
    _close(got.asnumpy(), want)
    assert len(got_states) == len(want_states)
    for g, w in zip(got_states, want_states):
        _close(g.asnumpy(), w)


# ---------------------------------------------------------------------------
# the slice's public signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rel", ["contrib/quantization.py",
                                 "gluon/rnn/rnn_layer.py",
                                 "gluon/rnn/rnn_cell.py",
                                 "gluon/rnn/conv_rnn_cell.py"])
def test_slice_signatures_lead_with_the_references(rel):
    """Every public function and method of the slice's new modules takes
    the reference's parameters in its order with its defaults (the scan
    of `test_torch_gluon.py`)."""
    import os

    import incubator_mxnet_tpu
    import incubator_mxnet_tpu_torch
    from test_torch_gluon import _leads, _signatures

    ref = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu.__file__), rel))
    port = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu_torch.__file__), rel))
    bad = [(name, sig, port.get(name)) for name, sig in ref.items()
           if not (name.rsplit(".", 1)[-1].startswith("_")
                   and name.rsplit(".", 1)[-1] != "__init__")
           and (name not in port or not _leads(sig, port[name]))]
    assert not bad, (rel, bad)
