"""`NDArray`, the funnel, `mx.nd`, `npx` on NDArrays, `dlpack`,
`test_utils` and the device scope of the port, against the JAX package:
the same code on both packages (the port on the CPU, ``with mx.cpu():``)
with the same seeded numpy inputs; values compared within 1e-5 relative
(f32; 1e-4 where attention's softmax sums run in another order), dtypes
exactly. Also the port's own contracts: creation targets the card with no
scope open and raises without one, arrays never alias, x64 off."""
import contextlib
import importlib.util
import os
import pickle
from pathlib import Path

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6
ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-5

_R = onp.random.RandomState(5)
X = _R.uniform(-2, 2, (3, 4)).astype("float32")
Y = _R.uniform(-2, 2, (3, 4)).astype("float32")
M = _R.uniform(-1, 1, (4, 5)).astype("float32")
T3 = _R.uniform(-1, 1, (2, 3, 4)).astype("float32")


def _scope(mx):
    return mx.cpu() if mx is tmx else contextlib.nullcontext()


def _out(v):
    if hasattr(v, "asnumpy"):
        return ("array", v.asnumpy(), str(onp.dtype(v.dtype)))
    if isinstance(v, (list, tuple)):
        return [_out(x) for x in v]
    if isinstance(v, onp.ndarray):
        return ("np", v, str(v.dtype))
    return v


def _cmp(got, want, rtol=RTOL, atol=ATOL, path="out"):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got)
        for i, (g, w) in enumerate(zip(got, want)):
            _cmp(g, w, rtol, atol, f"{path}[{i}]")
    elif isinstance(want, tuple) and want and want[0] in ("array", "np"):
        assert isinstance(got, tuple), (path, got)
        assert got[2] == want[2], (path, "dtype", got[2], want[2])
        assert got[1].shape == want[1].shape, (path, got[1].shape,
                                               want[1].shape)
        onp.testing.assert_allclose(got[1], want[1], rtol=rtol, atol=atol,
                                    err_msg=path, equal_nan=True)
    else:
        assert got == want, (path, got, want)


def _both(fn, **tol):
    with _scope(tmx):
        got = _out(fn(tmx))
    _cmp(got, _out(fn(jmx)), **tol)


# ---------------------------------------------------------------------------
# the NDArray methods (reference ndarray.py:115-686)
# ---------------------------------------------------------------------------

def _a(mx, x=X):
    return mx.np.array(x)


METHODS = {
    "properties": lambda mx: [_a(mx).shape, _a(mx).size, _a(mx).ndim,
                              _a(mx).itemsize, _a(mx).stype,
                              str(onp.dtype(_a(mx).dtype))],
    "T": lambda mx: _a(mx).T,
    "asnumpy_item_tolist": lambda mx: [_a(mx).asnumpy(), _a(mx)[1, 2].item(),
                                       _a(mx).tolist(),
                                       _a(mx)[0, 0].asscalar()],
    "astype": lambda mx: [_a(mx).astype("int32"), _a(mx).astype("float16"),
                          _a(mx).astype("float32", copy=False)],
    "copy": lambda mx: _a(mx).copy(),
    "reshape": lambda mx: [_a(mx).reshape((4, 3)), _a(mx).reshape(2, 6),
                           _a(mx).reshape(-1), _a(mx).reshape_like(
                               _a(mx, M.T[:3, :4]))],
    "transpose": lambda mx: [_a(mx, T3).transpose(), _a(mx, T3).transpose(
        (2, 0, 1)), _a(mx, T3).transpose(1, 0, 2)],
    "flatten_squeeze_expand": lambda mx: [_a(mx, T3).flatten(),
                                          _a(mx, X[None]).squeeze(),
                                          _a(mx, X[None]).squeeze(0),
                                          _a(mx).expand_dims(1)],
    "broadcast": lambda mx: [_a(mx, X[:1]).broadcast_to((3, 4)),
                             _a(mx, X[:1]).broadcast_like(_a(mx))],
    "repeat_tile_swapaxes": lambda mx: [_a(mx).repeat(2), _a(mx).repeat(
        2, axis=0), _a(mx).tile((2, 2)), _a(mx, T3).swapaxes(0, 2)],
    "split": lambda mx: [_a(mx).split(2, axis=1), _a(mx).split(3)],
    "reductions": lambda mx: [
        getattr(_a(mx), m)(**kw) for m in ("sum", "mean", "max", "min",
                                           "prod")
        for kw in ({}, {"axis": 1}, {"axis": 0, "keepdims": True})],
    "std_var": lambda mx: [_a(mx).std(), _a(mx).var(axis=1, ddof=1),
                           _a(mx).std(axis=0, keepdims=True)],
    "arg": lambda mx: [_a(mx).argmax(), _a(mx).argmin(axis=1),
                       _a(mx).argmax(axis=0, keepdims=True),
                       _a(mx).argsort(), _a(mx).sort(axis=0)],
    "elementwise": lambda mx: [_a(mx).square(), _a(mx).abs(),
                               _a(mx).round(1), _a(mx).clip(-1.0, 1.0),
                               _a(mx).cumsum(), _a(mx).cumsum(axis=1)],
    "slice_axis": lambda mx: [_a(mx).slice_axis(1, 1, 3),
                              _a(mx).slice_axis(axis=0, begin=1)],
    "dot_norm": lambda mx: [_a(mx).dot(_a(mx, M)), _a(mx).norm(),
                            _a(mx).norm(axis=1), _a(mx).norm(ord=1, axis=0)],
    "take": lambda mx: [_a(mx).take(mx.np.array([0, 2]), axis=1),
                        _a(mx).take(mx.np.array([[1.0, 5.0]])),
                        _a(mx).take(mx.np.array([7, -1]), axis=0)],
    "like": lambda mx: [_a(mx).zeros_like(), _a(mx).ones_like(),
                        _a(mx).full_like(2.5), _a(mx).tostype("default")],
    "getitem": lambda mx: [_a(mx)[1], _a(mx)[1:, ::2], _a(mx)[..., 1],
                           _a(mx)[_a(mx) > 0], _a(mx)[mx.np.array([2, 0])],
                           _a(mx)[None, 1, 2], _a(mx)[-1]],
    "operators": lambda mx: [
        _a(mx) + _a(mx, Y), _a(mx) - 1.5, 2.0 - _a(mx), _a(mx) * _a(mx, Y),
        3 * _a(mx), _a(mx) / _a(mx, Y), 1.0 / _a(mx), _a(mx) // 0.7,
        5.0 // _a(mx, onp.abs(Y) + 1), _a(mx) % 1.3, 7.0 % _a(mx, Y),
        _a(mx, onp.abs(X)) ** _a(mx, Y), 2.0 ** _a(mx), _a(mx) ** 2,
        _a(mx) @ _a(mx, M), -_a(mx), abs(_a(mx)),
        mx.np.array([1, 2, 3]) + 2, mx.np.array([1, 2, 3]) * 2.5,
        mx.np.array([7, 8]) // 3, mx.np.array([True, False]) * 2],
    "comparisons": lambda mx: [_a(mx) == _a(mx, Y), _a(mx) != 0.5,
                               _a(mx) < _a(mx, Y), _a(mx) <= 0.0,
                               _a(mx) > _a(mx, Y), _a(mx) >= 1.0],
    "protocol": lambda mx: [len(_a(mx)), [r.asnumpy() for r in _a(mx)],
                            bool(mx.np.array([2.0])), float(_a(mx)[0, 1]),
                            int(mx.np.array(7)),
                            list(range(10))[mx.np.array(3)]],
    "repr": lambda mx: repr(_a(mx)).split("\n")[-1].replace("tpu", "cpu"),
    "array_protocols": lambda mx: [onp.asarray(_a(mx)),
                                   onp.add(_a(mx), _a(mx, Y)),
                                   onp.mean(_a(mx), axis=0),
                                   onp.add.reduce(_a(mx), axis=0),
                                   onp.concatenate([_a(mx), _a(mx, Y)]),
                                   onp.maximum(_a(mx), 0.5)],
    "pickle": lambda mx: pickle.loads(pickle.dumps(_a(mx))),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_ndarray_method_matches_reference(name):
    _both(METHODS[name])


def _mutations(mx):
    """The reference's mutation semantics: every write rebinds, so a view
    taken before keeps its values and a name bound to the same array sees
    the write."""
    a = mx.np.array(X)
    b = a[0:2]
    a[0] = 5.0
    a[1, 1:3] = mx.np.array([7.0, 8.0])
    c = a
    a += 1
    a *= mx.np.array(Y)
    d = mx.np.array(Y)
    a.copyto(d)
    a[2] = 0.0
    e = mx.np.array(X)
    e[e > 0] = 0.0
    v0 = e.version
    e[0, 0] = 3.0
    return [b, c, d, a, e, mx.np.may_share_memory(a, b), e.version > v0]


def test_mutation_and_aliasing_match_reference():
    _both(_mutations)


def test_slice_keeps_its_values_although_torch_slices_are_views():
    with tmx.cpu():
        a = tmx.np.array(X)
        b = a[0:2]
        assert b._data._base is not None or b._data.data_ptr() == \
            a._data.data_ptr()           # torch gave a view
        before = b.asnumpy()
        a[0] = 5.0
        a += 1.0
        a[:] = tmx.np.array(Y)
    onp.testing.assert_array_equal(b.asnumpy(), before)
    onp.testing.assert_array_equal(a.asnumpy(), Y)


def test_saved_for_backward_then_written_trips_nothing():
    """A write to an array whose tensor a graph saved for backward rebinds
    it: torch's version counter sees no in-place change, and the gradient
    is the one at the recorded values (as the reference's tape gives)."""
    def run(mx):
        x = mx.np.array(X)
        x.attach_grad()
        with mx.autograd.record():
            y = (mx.np.sin(x) * x).sum()
        x[:] = 0.0
        x += 2.0
        y.backward()
        return [x.grad, x]

    _both(run)


DTYPE_CASES = {
    "float64 host": lambda mx: mx.np.array(onp.ones(3, "float64")),
    "int64 host": lambda mx: mx.np.array(onp.arange(3, dtype="int64")),
    "uint64 host": lambda mx: mx.np.array(onp.arange(3, dtype="uint64")),
    "python floats": lambda mx: mx.np.array([1.5, 2.5]),
    "python ints": lambda mx: mx.np.array([[1, 2], [3, 4]]),
    "bools": lambda mx: mx.np.array([True, False]),
    "float16": lambda mx: mx.np.array(onp.ones(2, "float16")),
    "dtype=float64": lambda mx: mx.np.array([1, 2], dtype="float64"),
    "astype int64": lambda mx: mx.np.array(X).astype("int64"),
    "argmax": lambda mx: mx.np.array(X).argmax(axis=1),
    "np.argmax": lambda mx: mx.np.argmax(mx.np.array(X)),
    "arange": lambda mx: mx.np.arange(5),
    "int sum": lambda mx: mx.np.array([1, 2, 3]).sum(),
    "bool sum": lambda mx: (mx.np.array(X) > 0).sum(),
    "int mean": lambda mx: mx.np.mean(mx.np.array([1, 2, 4])),
    "int / int": lambda mx: mx.np.array([3]) / mx.np.array([2]),
    "int cumsum": lambda mx: mx.np.array([1, 2]).cumsum(),
    "full int": lambda mx: mx.np.full((2,), 3),
    "nonzero": lambda mx: mx.np.nonzero(mx.np.array([0, 3, 0, 1])),
}


@pytest.mark.parametrize("name", sorted(DTYPE_CASES))
def test_x64_off_dtypes_match_reference(name):
    _both(DTYPE_CASES[name])


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

def test_device_scope_and_the_card_default():
    assert tmx.current_device() == tmx.gpu(0)
    assert repr(tmx.gpu(1)) == "gpu(1)" and repr(tmx.cpu()) == "cpu(0)"
    with tmx.cpu():
        assert tmx.current_device() == tmx.cpu()
        a = tmx.np.zeros((2,))
        assert a.device == tmx.cpu() and a.context == tmx.cpu()
        with tmx.Device("cpu", 0):
            assert tmx.np.ones(1)._data.device.type == "cpu"
    assert tmx.current_device() == tmx.gpu(0)
    assert tmx.Device(torch.device("cuda", 2)) == tmx.gpu(2)
    assert tmx.Device("cuda:1") == tmx.gpu(1) == tmx.Context("gpu", 1)
    assert tmx.device.resolve_device(tmx.cpu()) == torch.device("cpu")
    assert tmx.device.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_creation_without_a_scope_targets_the_card_and_raises_here():
    for make in (lambda: tmx.np.array([1.0, 2.0]),
                 lambda: tmx.np.zeros((2,)), lambda: tmx.np.arange(3),
                 lambda: tmx.nd.array([1]),
                 lambda: tmx.np.random.uniform(size=(2,)),
                 lambda: tmx.NDArray(onp.ones(2))):
        with pytest.raises(MXNetError, match="no CUDA device"):
            make()
    with tmx.cpu():
        x = tmx.np.array([1.0])
    with pytest.raises(MXNetError):
        x.to_device(tmx.gpu(0))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_array_of_a_cpu_tensor_or_array_targets_the_card_and_raises_here():
    """`np.array`/`nd.array` make the array on the current device whatever
    the source is (reference numpy/__init__.py:59): a CPU tensor, a CPU
    NDArray or a pickled array is not kept on the CPU with no scope
    open."""
    with tmx.cpu():
        x = tmx.np.array(X)
        blob = pickle.dumps(x)
    for make in (lambda: tmx.np.array(torch.zeros(2)),
                 lambda: tmx.np.asarray(torch.zeros(2)),
                 lambda: tmx.nd.array(torch.zeros(2)),
                 lambda: tmx.np.array(x), lambda: tmx.nd.array(x),
                 lambda: pickle.loads(blob)):
        with pytest.raises(MXNetError, match="no CUDA device"):
            make()
    with tmx.cpu():
        for y in (tmx.np.array(torch.zeros(2)), tmx.nd.array(x),
                  pickle.loads(blob)):
            assert y.device == tmx.cpu()
    z = tmx.np.array(x, device="cpu")
    assert z.device == tmx.cpu() and z is not x


def test_to_device_and_copyto_device():
    with tmx.cpu():
        x = tmx.np.array(X)
        y = x.as_in_context(tmx.cpu())
        z = x.copyto(tmx.cpu())
    assert y is not x and y.device == tmx.cpu()
    onp.testing.assert_array_equal(z.asnumpy(), X)


# ---------------------------------------------------------------------------
# npx on NDArrays against the reference's npx (its CPU path)
# ---------------------------------------------------------------------------

_B, _T, _H, _D = 2, 8, 2, 16
_QKV = _R.normal(0, 1, (3, _B, _T, _H, _D)).astype("float32")
_VL = onp.array([5, 8], "int32")
_LN_X = _R.normal(0.5, 2, (6, 32)).astype("float32")
_LN_G = (1 + 0.2 * _R.normal(size=32)).astype("float32")
_LN_B = (0.2 * _R.normal(size=32)).astype("float32")
_HID = _R.normal(0, 1, (6, 32)).astype("float32")
_W212 = _R.normal(size=(2, 12)).astype("float32")
_U = _R.normal(size=(4, 128)).astype("float32")


def _grads_of(mx, fn, arrays):
    """fn(*NDArrays) and the gradients of (fn * probe).sum() w.r.t. each."""
    xs = [mx.np.array(a) for a in arrays]
    for x in xs:
        x.attach_grad()
    with mx.autograd.record():
        out = fn(*xs)
        probe = mx.np.array(onp.linspace(-1, 1, out.size, dtype="float32")
                            .reshape(out.shape))
        loss = (out * probe).sum()
    loss.backward()
    return [out] + [x.grad for x in xs]


NPX = {
    "gelu": (lambda mx: _grads_of(mx, mx.npx.gelu, [X]), {}),
    "gelu_erf": (lambda mx: _grads_of(
        mx, lambda x: mx.npx.gelu(x, approximate=False), [X]), {}),
    "activation_gelu": (lambda mx: _grads_of(
        mx, lambda x: mx.npx.activation(x, act_type="gelu"), [X]), {}),
    "activation_tanh": (lambda mx: _grads_of(
        mx, lambda x: mx.npx.activation(x, act_type="tanh"), [X]), {}),
    "fully_connected": (lambda mx: _grads_of(
        mx, lambda x, w, b: mx.npx.fully_connected(x, w, b, num_hidden=5,
                                                   flatten=False),
        [T3, M.T, M[0]]), {}),
    "fully_connected_flatten": (lambda mx: _grads_of(
        mx, lambda x, w: mx.npx.fully_connected(x, w, no_bias=True,
                                                num_hidden=2),
        [T3, _W212]), {}),
    "embedding": (lambda mx: _grads_of(
        mx, lambda w: mx.npx.embedding(mx.np.array([[0, 3], [3, 2]]), w),
        [M]), {}),
    "layer_norm": (lambda mx: _grads_of(
        mx, lambda x, g, b: mx.npx.layer_norm(x, g, b, eps=1e-5),
        [_LN_X, _LN_G, _LN_B]), {}),
    "layer_norm_axis1": (lambda mx: _grads_of(
        mx, lambda x, g, b: mx.npx.layer_norm(x, g, b, axis=1),
        [T3, X[0, :3], Y[0, :3]]), {}),
    "dropout_p0_and_eval": (lambda mx: [
        mx.npx.dropout(mx.np.array(X), p=0.0),
        mx.npx.dropout(mx.np.array(X), p=0.5)], {}),
    "flash_attention_bthd_lengths": (lambda mx: _grads_of(
        mx, lambda q, k, v: mx.npx.flash_attention(
            q, k, v, valid_length=mx.np.array(_VL), layout="bthd"),
        list(_QKV)), dict(rtol=ATTN_RTOL, atol=ATTN_ATOL)),
    "flash_attention_bhtd_causal": (lambda mx: _grads_of(
        mx, lambda q, k, v: mx.npx.flash_attention(q, k, v, causal=True),
        [a.transpose(0, 2, 1, 3) for a in _QKV]),
        dict(rtol=ATTN_RTOL, atol=ATTN_ATOL)),
    "residual_dropout_ln_p0": (lambda mx: _grads_of(
        mx, lambda x, h, g, b: mx.npx.residual_dropout_ln(x, h, g, b, p=0.0),
        [_LN_X, _HID, _LN_G, _LN_B]), {}),
    "residual_dropout_ln_eval": (lambda mx: mx.npx.residual_dropout_ln(
        mx.np.array(_LN_X), mx.np.array(_HID), mx.np.array(_LN_G),
        mx.np.array(_LN_B), p=0.5), {}),
    "gelu_dropout_p0": (lambda mx: _grads_of(
        mx, lambda u: mx.npx.gelu_dropout(u, p=0.0, impl="pallas"),
        [_U]), dict(atol=2e-6)),
}


@pytest.mark.parametrize("name", sorted(NPX))
def test_npx_on_ndarrays_matches_reference(name):
    fn, tol = NPX[name]
    _both(fn, **tol)


@pytest.mark.parametrize("op", ["dropout", "residual_dropout_ln",
                                "gelu_dropout"])
def test_npx_dropout_asks_is_training(op):
    """With no ``training=``, dropout applies under ``autograd.record()``
    (``is_training()``), not outside it; ``training=`` overrides, and the
    NDArray path's mask is the torch-tensor path's for the same key."""
    npx = tmx.npx
    x0 = _R.normal(1.0, 0.1, (64, 128)).astype("float32")

    def call(x, **kw):
        if op == "dropout":
            return npx.dropout(x, p=0.5, **kw)
        if op == "residual_dropout_ln":
            z = x * 0 if isinstance(x, torch.Tensor) else x * 0.0
            g = torch.ones(128) if isinstance(x, torch.Tensor) else \
                tmx.np.ones((128,))
            b = torch.zeros(128) if isinstance(x, torch.Tensor) else \
                tmx.np.zeros((128,))
            return npx.residual_dropout_ln(z, x, g, b, p=0.5, **kw)
        return npx.gelu_dropout(x, p=0.5, **kw)

    with tmx.cpu():
        x = tmx.np.array(x0)
        tmx.random.seed(3)
        off = call(x).asnumpy()
        with tmx.autograd.record():
            tmx.random.seed(3)
            on = call(x).asnumpy()
            tmx.random.seed(3)
            forced_off = call(x, training=False).asnumpy()
        tmx.random.seed(3)
        forced_on = call(x, training=True).asnumpy()
        tmx.random.seed(3)
        torch_on = call(torch.tensor(x0), training=True).numpy()
    assert onp.array_equal(off, forced_off)
    assert onp.array_equal(on, forced_on)
    assert onp.array_equal(on, torch_on)
    if op == "dropout":
        assert onp.array_equal(off, x0)
        kept = on != 0
        onp.testing.assert_allclose(on[kept], x0[kept] * 2.0, rtol=1e-6)
        assert 0.45 < kept.mean() < 0.55


def _dtype_name(d):
    """numpy's name of a dtype; "bfloat16" for the reference's ml_dtypes
    type and for the port's torch.bfloat16 alike."""
    return "bfloat16" if "bfloat16" in str(d) else str(onp.dtype(d))


def _amp_funnel(mx, op):
    """Under ``amp.init("bfloat16")``: the op's output and the f32 inputs'
    gradients of its sum, each as (dtype name, values in f32)."""
    from incubator_mxnet_tpu.ndarray import ndarray as jnd
    from incubator_mxnet_tpu_torch.ndarray import ndarray as tnd

    apply_op = (tnd if mx is tmx else jnd).apply_op
    fns = {
        "fully_connected": (lambda x, w, b: mx.npx.fully_connected(
            x, w, b, num_hidden=5, flatten=False), [T3, M.T, M[0]]),
        "embedding": (lambda w: mx.npx.embedding(
            mx.np.array([[0, 3], [3, 2]]), w), [M]),
        "flash_attention": (lambda q, k, v: mx.npx.flash_attention(
            q, k, v, valid_length=mx.np.array(_VL), layout="bthd"),
            list(_QKV)),
        "apply_op_dot": (lambda a, b: apply_op(
            "dot", lambda u, v: u @ v, (a, b)), [X, M]),
        "np_exp_of_bf16": (lambda a: mx.np.exp(a.astype("bfloat16")), [X]),
    }
    fn, arrays = fns[op]
    mx.amp.init("bfloat16")
    try:
        xs = [mx.np.array(a) for a in arrays]
        for x in xs:
            x.attach_grad()
        with mx.autograd.record():
            out = fn(*xs)
        out.backward()              # all-ones head gradient
    finally:
        mx.amp.deinit()
    return [(_dtype_name(v.dtype), onp.asarray(v.asnumpy(), "float32"))
            for v in [out] + [x.grad for x in xs]]


@pytest.mark.parametrize("op", ["fully_connected", "embedding",
                                "flash_attention", "apply_op_dot",
                                "np_exp_of_bf16"])
def test_amp_casts_in_the_funnel_match_reference(op, monkeypatch):
    """The funnel's AMP casts (reference ndarray.py:830-841): a target-list
    op takes bf16 and gives bf16, an fp32-list op gives f32, and each f32
    input's gradient comes back f32 through the cast, with the reference's
    dtypes and values (bf16 rounding: 2^-7 relative). The port casts once
    a call, inside the funnel."""
    from incubator_mxnet_tpu_torch import amp as tamp

    casts = []
    cast_vals = tamp.cast_vals

    def counting(mode, vals):
        casts.append(mode)
        return cast_vals(mode, vals)

    monkeypatch.setattr(tamp, "cast_vals", counting)
    with tmx.cpu():
        got = _amp_funnel(tmx, op)
    want = _amp_funnel(jmx, op)
    assert len(casts) == 1, casts
    assert casts[0] == (("fp32",) if op == "np_exp_of_bf16" else
                        ("target", "bfloat16"))
    assert got[0][0] == want[0][0] == ("float32" if op == "np_exp_of_bf16"
                                       else "bfloat16")
    for i, ((gd, g), (wd, w)) in enumerate(zip(got, want)):
        assert gd == wd, (i, gd, wd)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        onp.testing.assert_allclose(g, w, rtol=2.0 ** -7,
                                    atol=2.0 ** -7 * float(abs(w).max()),
                                    err_msg=f"{op}[{i}]")


def test_npx_dropout_gradient_is_the_mask():
    with tmx.cpu():
        x = tmx.np.array(onp.ones((32, 64), "float32"))
        x.attach_grad()
        with tmx.autograd.record():
            y = tmx.npx.dropout(x, p=0.25)
        y.backward()
        onp.testing.assert_array_equal(x.grad.asnumpy(), y.asnumpy())


# ---------------------------------------------------------------------------
# the slice's composition: BERT's embedding and one encoder layer
# ---------------------------------------------------------------------------

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_nd", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


UNITS, HIDDEN, HEADS, VOCAB, SEQ, BATCH = 32, 64, 2, 50, 8, 2


def _layer_weights():
    from incubator_mxnet_tpu_torch.models.bert import BERTEncoder

    enc = BERTEncoder(VOCAB, UNITS, HIDDEN, 1, HEADS, 16, 0.0,
                      device="cpu")
    rng = onp.random.RandomState(11)
    return {n: rng.uniform(-0.3, 0.3, tuple(p.shape)).astype("float32")
            + (1.0 if n.endswith("gamma") else 0.0)
            for n, p in enc.named_parameters()}


def _run_layer(mx, weights, layer, p=0.0):
    rng = onp.random.RandomState(12)
    tok = rng.randint(0, VOCAB, (BATCH, SEQ)).astype("int32")
    typ = rng.randint(0, 2, (BATCH, SEQ)).astype("int32")
    vl = onp.array([5, 8], "int32")
    gy = rng.normal(size=(BATCH, SEQ, UNITS)).astype("float32")
    P = {n: mx.np.array(w) for n, w in weights.items()}
    for arr in P.values():
        arr.attach_grad()
    with mx.autograd.record():
        out = layer(mx, P, mx.np.array(tok), mx.np.array(typ),
                    mx.np.array(vl), p, HEADS)
        loss = (out * mx.np.array(gy)).sum()
    loss.backward()
    return [out] + [P[n].grad for n in sorted(P)]


def test_encoder_layer_through_ndarrays_matches_reference():
    """chip_smoke's [nd] composition at 2 heads, units 32, hidden 64: the
    port and the reference on the same weights, the output and every
    weight's gradient."""
    layer = _chip_smoke().nd_encoder_layer
    w = _layer_weights()
    _both(lambda mx: _run_layer(mx, w, layer), rtol=ATTN_RTOL,
          atol=ATTN_ATOL)


def test_encoder_layer_equals_the_module_path():
    """The same composition against the port's `BERTEncoder` on the same
    weights: at p = 0, and at p = 0.1 with the same keys, bit for bit."""
    from incubator_mxnet_tpu_torch.models.bert import BERTEncoder

    layer = _chip_smoke().nd_encoder_layer
    w = _layer_weights()
    for p in (0.0, 0.1):
        enc = BERTEncoder(VOCAB, UNITS, HIDDEN, 1, HEADS, 16, p,
                          device="cpu").train(p > 0)
        enc.load_state_dict({n: torch.from_numpy(a) for n, a in w.items()})
        rng = onp.random.RandomState(12)
        tok = torch.from_numpy(rng.randint(0, VOCAB, (BATCH, SEQ)))
        typ = torch.from_numpy(rng.randint(0, 2, (BATCH, SEQ)))
        vl = torch.tensor([5, 8])
        gy = torch.from_numpy(rng.normal(size=(BATCH, SEQ, UNITS))
                              .astype("float32"))
        tmx.random.seed(9)
        out = enc(tok, typ, vl)
        (out * gy).sum().backward()
        want = [out.detach().numpy()] + [
            dict(enc.named_parameters())[n].grad.numpy() for n in sorted(w)]
        with tmx.cpu():
            tmx.random.seed(9)
            got = [a.asnumpy() for a in _run_layer(tmx, w, layer, p)]
        for g, wa in zip(got, want):
            onp.testing.assert_array_equal(g, wa)


# ---------------------------------------------------------------------------
# mx.nd, dlpack, test_utils, the h2d seams, base
# ---------------------------------------------------------------------------

ND = {
    "add_n": lambda mx: [mx.nd.add_n(_a(mx), _a(mx, Y), _a(mx)),
                         mx.nd.add_n([_a(mx), _a(mx, Y)])],
    "concat_stack": lambda mx: [mx.nd.concat(_a(mx), _a(mx, Y)),
                                mx.nd.concat(_a(mx), _a(mx, Y), dim=0),
                                mx.nd.Concat([_a(mx), _a(mx, Y)], axis=1),
                                mx.nd.stack(_a(mx), _a(mx, Y), axis=1)],
    "swapaxes": lambda mx: [mx.nd.swapaxes(_a(mx, T3), 0, 2),
                            mx.nd.SwapAxis(_a(mx, T3), dim1=1, dim2=2)],
    "take_norm_flatten": lambda mx: [
        mx.nd.take(_a(mx), mx.np.array([2, 0])),
        mx.nd.norm(_a(mx)), mx.nd.norm(_a(mx), ord=1, axis=1),
        mx.nd.Flatten(_a(mx, T3)), mx.nd.flatten(_a(mx, T3))],
    "forwarding": lambda mx: [
        mx.nd.broadcast_add(_a(mx), _a(mx, Y[:1])),
        mx.nd.elemwise_mul(_a(mx), _a(mx, Y)), mx.nd.sum_axis(_a(mx), 1),
        mx.nd.Reshape(_a(mx), (4, 3)), mx.nd.exp(_a(mx)),
        mx.nd.Activation(_a(mx), act_type="tanh"),
        mx.nd.FullyConnected(_a(mx), _a(mx, M.T), num_hidden=5,
                             no_bias=True),
        mx.nd.array([1.5, 2.5])],
}


@pytest.mark.parametrize("name", sorted(ND))
def test_nd_namespace_matches_reference(name):
    _both(ND[name])


def test_nd_queued_names_raise_and_hasattr_is_false():
    assert not hasattr(tmx.nd, "Convolution")
    with pytest.raises(MXNetError, match="BatchNorm"):
        tmx.nd.BatchNorm  # noqa: B018
    with pytest.raises(AttributeError):
        tmx.nd.no_such_op  # noqa: B018
    with pytest.raises(MXNetError):
        tmx.nd.sample_multinomial(None)


def test_nd_save_load_roundtrip_readable_by_reference(tmp_path):
    with tmx.cpu():
        a, b = tmx.np.array(X), tmx.np.array([1, 2, 3])
        tmx.nd.save(str(tmp_path / "list"), [a, b])
        tmx.nd.save(str(tmp_path / "dict.npz"), {"w": a})
        got_list = tmx.nd.load(str(tmp_path / "list"))
        got_dict = tmx.nd.load(str(tmp_path / "dict.npz"))
    ref_list = jmx.nd.load(str(tmp_path / "list"))
    _cmp(_out(got_list), _out(ref_list))
    _cmp(_out(got_dict["w"]), _out(jmx.nd.load(str(tmp_path / "dict.npz"))
                                   ["w"]))
    jmx.nd.save(str(tmp_path / "ref"), [jmx.np.array(Y)])
    with tmx.cpu():
        back = tmx.nd.load(str(tmp_path / "ref"))
    onp.testing.assert_array_equal(back[0].asnumpy(), Y)


def test_dlpack_exchange():
    with tmx.cpu():
        a = tmx.np.array(X)
        view = a[0:1]
        t = torch.from_dlpack(tmx.dlpack.to_dlpack_for_read(a))
        onp.testing.assert_array_equal(t.numpy(), X)
        w = torch.from_dlpack(tmx.dlpack.to_dlpack_for_write(a))
        w[0, 0] = 42.0                 # lands in a, not in the older view
        assert a.asnumpy()[0, 0] == 42.0 and view.asnumpy()[0, 0] == X[0, 0]
        b = tmx.dlpack.from_dlpack(onp.arange(3, dtype="float32"))
        c = tmx.dlpack.from_dlpack(torch.ones(2, dtype=torch.float64))
        d = tmx.dlpack.from_dlpack(a)
    onp.testing.assert_array_equal(b.asnumpy(), [0, 1, 2])
    assert str(c.dtype) == "float32" and d.asnumpy()[0, 0] == 42.0
    assert tmx.dlpack.DLDeviceType.DLCPU == jmx.dlpack.DLDeviceType.DLCPU


def test_test_utils():
    tu = tmx.test_utils
    with tmx.cpu():
        assert tu.same(tmx.np.array(X), X)
        assert tu.almost_equal(tmx.np.array(X), X + 1e-7, rtol=1e-5)
        with pytest.raises(AssertionError, match="not almost equal"):
            tu.assert_almost_equal(tmx.np.array(X), X + 1.0)
        onp.random.seed(0)
        s2, s3, sn = tu.rand_shape_2d(), tu.rand_shape_3d(), \
            tu.rand_shape_nd(4, 3)
        assert len(s2) == 2 and len(s3) == 3 and len(sn) == 4
        r = tu.rand_ndarray((3, 2))
        assert r.shape == (3, 2) and float(abs(r).max()) <= 1.0
        assert tu.default_device() == tmx.cpu()
        tu.check_numeric_gradient(lambda a: tmx.np.sin(a) * a,
                                  [tmx.np.array(X[:2, :2])], eps=1e-2,
                                  rtol=1e-2, atol=1e-3)
        tu.check_consistency(lambda a: tmx.np.tanh(a) + 1,
                             [tmx.np.array(X)], devices=[tmx.cpu(),
                                                         tmx.cpu()])
        assert tu.effective_dtype(tmx.np.array(X)) == onp.float32
    with tu.environment("MXNET_ND_TEST_VAR", "1"):
        assert os.environ["MXNET_ND_TEST_VAR"] == "1"
    assert "MXNET_ND_TEST_VAR" not in os.environ
    with pytest.raises(MXNetError, match="symbol"):
        tu.check_symbolic_forward(None, [], [])


def test_h2d_telemetry_and_fault_seam():
    from incubator_mxnet_tpu_torch.fault import injection
    from incubator_mxnet_tpu_torch.ndarray import ndarray as ndmod
    from incubator_mxnet_tpu_torch.telemetry import registry

    assert ndmod._H2D_HOOK is registry.add_h2d_bytes
    ctr = registry.counter("mx_h2d_bytes_total",
                           "host->device transfer bytes at the NDArray "
                           "inlet")
    before = ctr.value
    with tmx.cpu():
        tmx.np.array(onp.ones((4, 8), "float32"))
    assert ctr.value - before == 128
    assert registry.report()["mx_h2d_bytes_total"]["value"] >= 128
    assert ndmod._FAULT_HOOK is None
    injection.configure_injection({"h2d": (1.0, 0, 1)})
    try:
        assert ndmod._FAULT_HOOK is not None
        with tmx.cpu(), pytest.raises(injection.FaultInjected):
            tmx.np.array([1.0])
        with tmx.cpu():
            tmx.np.array([1.0])          # the limit of one fired
    finally:
        injection.clear_injection()
    assert ndmod._FAULT_HOOK is None


def test_base_dtypes_and_op_registry():
    from incubator_mxnet_tpu_torch import base

    for d in ("float32", "int32", "bool", "float16", onp.float64, float,
              int, torch.int64):
        assert base.np_dtype(d) == jmx.base.np_dtype(
            d if not isinstance(d, torch.dtype) else "int64")
    assert base.np_dtype("bfloat16") is torch.bfloat16
    assert base.dtype_name(torch.bfloat16) == "bfloat16"
    assert base.dtype_name("float32") == jmx.base.dtype_name("float32")
    assert base.canonical_dtype("float64") == torch.float32
    assert "add" in base.list_ops("np") and "zeros" in base.list_ops("np")


def test_waitall_on_the_cpu_is_a_no_op():
    tmx.waitall()
    tmx.nd.waitall()
