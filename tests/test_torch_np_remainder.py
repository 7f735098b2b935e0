"""The np/npx remainder (`ROADMAP.md` §1 item 4) against the JAX package:
npx's plain ops, its contrib and transformer ops, the control flow and
the mode switches, each called on both packages with the same numpy
inputs (made from a seed) through NDArrays, the port on the CPU; outputs
compared by value, shape and dtype, and where the op has a gradient the
gradients of ``sum(out * c)`` (c a fixed random cotangent) through
``autograd.record()``/``backward()``.

Tolerances: float32 elementwise ops and gathers rtol 1e-5 / atol 1e-6
(``TOL``); the special functions and the products (einsum, a reduction
over a window) rtol 1e-4 / atol 1e-5 (``LOOSE``): the two packages'
libraries round differently. Integer and boolean outputs are equal.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)


def _arr(mx, a):
    return mx.np.array(a) if isinstance(a, onp.ndarray) else a


def _outs(out):
    if isinstance(out, (list, tuple)):
        return [o for o in out]
    return [out]


def run(mx, fn, inputs, grad):
    """``fn(mx, *arrays)`` on ``mx``: (outputs, gradients) as numpy."""
    xs = [_arr(mx, a) for a in inputs]
    for i in grad:
        xs[i].attach_grad()
    with mx.autograd.record():
        outs = _outs(fn(mx, *xs))
    if grad:
        heads = [o for o in outs
                 if onp.issubdtype(onp.dtype(o.dtype), onp.floating)]
        cots = [mx.np.array(onp.random.RandomState(100 + k).uniform(
            -1, 1, o.shape).astype(o.dtype)) for k, o in enumerate(heads)]
        mx.autograd.backward(heads, cots)
    return ([o.asnumpy() for o in outs],
            [xs[i].grad.asnumpy() for i in grad])


def both(fn, inputs, grad=(), tol=TOL):
    """Run on both packages and compare; returns the port's outputs."""
    ref_out, ref_grad = run(jmx, fn, inputs, grad)
    with tmx.cpu():
        out, grads = run(tmx, fn, inputs, grad)
    assert len(out) == len(ref_out)
    for got, want in zip(out + grads, ref_out + ref_grad):
        assert got.shape == want.shape, (got.shape, want.shape)
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        if onp.issubdtype(want.dtype, onp.floating):
            onp.testing.assert_allclose(got, want, **tol)
        else:
            onp.testing.assert_array_equal(got, want)
    return out


R = onp.random.RandomState(0)
X34 = R.uniform(-1, 1, (3, 4)).astype("float32")
X234 = R.uniform(-1, 1, (2, 3, 4)).astype("float32")
SEQ = R.uniform(-1, 1, (4, 3, 2)).astype("float32")       # (T, N, C)
LEN = onp.array([2, 4, 1], "float32")
TIES = onp.array([[1, 3, 3, 2, 3], [5, 5, 1, 0, 5]], "float32")
IDX = onp.array([[0, 2, 1, 2, 0], [1, 3, 0, 3, 1]], "int32")


# ---------------------------------------------------------------------------
# npx's plain ops
# ---------------------------------------------------------------------------

PLAIN = {
    "reshape_like": (lambda mx, a, b: mx.npx.reshape_like(a, b),
                     [X34, onp.zeros((2, 6), "float32")], (0,)),
    "reshape_like_range": (
        lambda mx, a, b: mx.npx.reshape_like(a, b, lhs_begin=1, lhs_end=2,
                                             rhs_begin=0, rhs_end=2),
        [R.uniform(size=(2, 6)).astype("float32"),
         onp.zeros((3, 2), "float32")], (0,)),
    "l2_normalization_instance": (
        lambda mx, a: mx.npx.l2_normalization(a), [X234], (0,)),
    "l2_normalization_channel": (
        lambda mx, a: mx.npx.l2_normalization(a, mode="channel"), [X234],
        (0,)),
    "l2_normalization_spatial": (
        lambda mx, a: mx.npx.l2_normalization(a, mode="spatial"), [X234],
        (0,)),
    "one_hot": (lambda mx, i: mx.npx.one_hot(i, 3),
                [onp.array([0, 2, -1, 5, 1], "int32")], ()),
    "one_hot_int_on_off": (
        lambda mx, i: mx.npx.one_hot(i, 4, on_value=2, off_value=1,
                                     dtype="int32"),
        [onp.array([[0, 3], [2, 9]], "int32")], ()),
    "one_hot_float_index": (
        lambda mx, i: mx.npx.one_hot(i, 3, on_value=0.5, off_value=-1.0),
        [onp.array([0.0, 2.7, 1.2], "float32")], ()),
    "pick_clip": (lambda mx, a, i: mx.npx.pick(a, i),
                  [X34, onp.array([0, 3, 7], "float32")], (0,)),
    "pick_wrap_axis0_keepdims": (
        lambda mx, a, i: mx.npx.pick(a, i, axis=0, mode="wrap",
                                     keepdims=True),
        [X34, onp.array([0, -1, 4, 2], "int32")], (0,)),
    "topk_indices_ties": (lambda mx, a: mx.npx.topk(a, k=3), [TIES], ()),
    "topk_value": (lambda mx, a: mx.npx.topk(a, k=2, ret_typ="value"),
                   [X34], (0,)),
    "topk_both_ascend_ties": (
        lambda mx, a: mx.npx.topk(a, k=3, ret_typ="both", is_ascend=True),
        [TIES], (0,)),
    "topk_axis0_int32": (
        lambda mx, a: mx.npx.topk(a, axis=0, k=2, dtype="int32"), [TIES],
        ()),
    "topk_mask_1d": (lambda mx, a: mx.npx.topk(a, k=2, ret_typ="mask"),
                     [TIES[0]], ()),
    "gather_nd": (lambda mx, a, i: mx.npx.gather_nd(a, i), [X34, IDX],
                  (0,)),
    "scatter_nd_repeats": (
        lambda mx, d, i: mx.npx.scatter_nd(d, i, (3, 4)),
        [R.uniform(size=(5,)).astype("float32"), IDX], (0,)),
    "sequence_mask": (
        lambda mx, x, ln: mx.npx.sequence_mask(
            x, ln, use_sequence_length=True, value=-1.0), [SEQ, LEN], (0,)),
    "sequence_mask_axis1": (
        lambda mx, x, ln: mx.npx.sequence_mask(
            x, ln, use_sequence_length=True, axis=1),
        [SEQ.transpose(1, 0, 2).copy(), LEN], (0,)),
    "sequence_last": (
        lambda mx, x, ln: mx.npx.sequence_last(
            x, ln, use_sequence_length=True), [SEQ, LEN], (0,)),
    "sequence_last_axis1": (
        lambda mx, x, ln: mx.npx.sequence_last(
            x, ln, use_sequence_length=True, axis=1),
        [SEQ.transpose(1, 0, 2).copy(), LEN], (0,)),
    "sequence_last_no_length": (lambda mx, x: mx.npx.sequence_last(x),
                                [SEQ], (0,)),
    "sequence_reverse": (
        lambda mx, x, ln: mx.npx.sequence_reverse(
            x, ln, use_sequence_length=True), [SEQ, LEN], (0,)),
    "sequence_reverse_no_length": (
        lambda mx, x: mx.npx.sequence_reverse(x), [SEQ], (0,)),
    "smooth_l1": (lambda mx, x: mx.npx.smooth_l1(x * 3), [X34], (0,)),
    "cast_float16": (lambda mx, x: mx.npx.cast(x, "float16"), [X34], ()),
    "cast_int32": (lambda mx, x: mx.npx.cast(x * 5, "int32"), [X34], ()),
    "shape_array": (lambda mx, x: mx.npx.shape_array(x), [X234], ()),
    "stop_gradient": (
        lambda mx, x: mx.npx.stop_gradient(x * 2) * x + x, [X34], (0,)),
    "slice_like": (lambda mx, x, s: mx.npx.slice_like(x, s),
                   [X234, onp.zeros((1, 2, 3), "float32")], (0,)),
    "slice_like_axes": (lambda mx, x, s: mx.npx.slice_like(x, s, axes=(2,)),
                        [X234, onp.zeros((1, 2, 3), "float32")], (0,)),
    "broadcast_like": (lambda mx, x, o: mx.npx.broadcast_like(x, o),
                       [X34[:1], X34], (0,)),
    "broadcast_like_axes": (
        lambda mx, x, o: mx.npx.broadcast_like(x, o, lhs_axes=(0,),
                                               rhs_axes=(1,)),
        [X34[:1], onp.zeros((2, 5), "float32")], (0,)),
    "batch_take": (lambda mx, x, i: mx.npx.batch_take(x, i),
                   [X34, onp.array([3, 0, 2], "int32")], (0,)),
    "boolean_mask": (lambda mx, x, m: mx.npx.boolean_mask(x, m),
                     [X34, onp.array([1, 0, 1], "int32")], (0,)),
    "boolean_mask_axis1_none": (
        lambda mx, x, m: mx.npx.boolean_mask(x, m, axis=1),
        [X34, onp.zeros(4, "float32")], ()),
}


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_plain_op_matches_the_reference(name):
    fn, inputs, grad = PLAIN[name]
    both(fn, inputs, grad)


SPECIAL = {
    "erf": (lambda mx, x: mx.npx.erf(x * 2), X34),
    "erfinv": (lambda mx, x: mx.npx.erfinv(x * 0.9), X34),
    # negative non-integers: the reference's exp(gammaln(x)) is |Γ(x)|
    "gamma": (lambda mx, x: mx.npx.gamma(x * 3 + 0.37), X34),
    "gammaln": (lambda mx, x: mx.npx.gammaln(x * 3 + 0.37), X34),
    "digamma": (lambda mx, x: mx.npx.digamma(x * 3 + 0.37), X34),
}


@pytest.mark.parametrize("name", sorted(SPECIAL))
def test_special_function_matches_the_reference(name):
    fn, x = SPECIAL[name]
    both(fn, [x], (0,), LOOSE)


def test_gamma_of_negative_non_integers_is_the_references_absolute_value():
    x = onp.array([-0.5, -1.5, -2.5, 0.5, 3.0], "float32")
    got = both(lambda mx, a: mx.npx.gamma(a), [x], ())[0]
    onp.testing.assert_allclose(got, [3.5449077, 2.3632718, 0.9453087,
                                      1.7724539, 2.0], rtol=1e-5)


RESHAPES = [(0, -1), (-2,), (-3, -2), (-4, 1, 2, -2), (-4, -1, 2, -2),
            (-4, 2, -1, -2), (2, -5), (-1,), (0, 0, -1), (-3, -1), (4, 0, -1),
            (-2, 1), (6, 4)]


@pytest.mark.parametrize("newshape", RESHAPES, ids=str)
def test_reshape_codes_match_the_reference(newshape):
    out = both(lambda mx, x: mx.npx.reshape(x, newshape), [X234], (0,))
    # reverse= is taken and ignored, as in the reference
    rev = both(lambda mx, x: mx.npx.reshape(x, newshape, reverse=True),
               [X234], ())
    onp.testing.assert_array_equal(out[0], rev[0])


def test_reshape_with_an_unknown_code_raises_on_both():
    with pytest.raises(Exception):
        jmx.npx.reshape(jmx.np.array(X234), (-6, 2, 3))
    with tmx.cpu(), pytest.raises(Exception):
        tmx.npx.reshape(tmx.np.array(X234), (-6, 2, 3))


def test_topk_mask_is_per_row():
    """2-D mask: each row's own k positions (MXNet's mask); the reference
    marks the union of every row's indices in every row (its "approximate"
    scatter, `ROADMAP.md` §3)."""
    with tmx.cpu():
        m = tmx.npx.topk(tmx.np.array(TIES), k=2, ret_typ="mask").asnumpy()
    onp.testing.assert_array_equal(m, [[0, 1, 1, 0, 0], [1, 1, 0, 0, 0]])


def test_clip_global_norm_matches_the_reference():
    arrays = [X34 * 3, X234 * 2]
    res = []
    for mx, scope in ((jmx, None), (tmx, tmx.cpu())):
        if scope is not None:
            scope.__enter__()
        try:
            xs = [mx.np.array(a) for a in arrays]
            norm = mx.npx.clip_global_norm(xs, 1.0)
            xs2 = [mx.np.array(a) for a in arrays]
            big = mx.npx.clip_global_norm(xs2, 100.0)
            res.append((norm, [x.asnumpy() for x in xs], big,
                        [x.asnumpy() for x in xs2]))
        finally:
            if scope is not None:
                scope.__exit__(None, None, None)
    (jn, jx, jb, jx2), (tn, tx, tb, tx2) = res
    assert isinstance(tn, float)
    assert abs(tn - jn) <= 1e-6 * jn and abs(tb - jb) <= 1e-6 * jb
    for a, b in zip(tx + tx2, jx + jx2):
        onp.testing.assert_allclose(a, b, **TOL)
    with tmx.cpu(), pytest.raises(ValueError):
        tmx.npx.clip_global_norm([tmx.np.array([onp.inf, 1.0])], 1.0)


# ---------------------------------------------------------------------------
# npx's contrib and transformer ops
# ---------------------------------------------------------------------------

QKV = R.uniform(-1, 1, (5, 2, 3 * 2 * 4)).astype("float32")   # heads 2, d 4
Q_ED = R.uniform(-1, 1, (3, 2, 8)).astype("float32")
KV_ED = R.uniform(-1, 1, (5, 2, 16)).astype("float32")
ATT = R.uniform(0, 1, (4, 5, 5)).astype("float32")
ATT_ED = R.uniform(0, 1, (4, 3, 5)).astype("float32")
QB = R.uniform(-1, 1, (2, 6, 2, 4)).astype("float32")        # (b, t, h, d)
KB = R.uniform(-1, 1, (2, 6, 2, 4)).astype("float32")
DIL = onp.array([1, 2], "int32")
VLEN = onp.array([6, 4], "int32")

CONTRIB = {
    "quadratic": (lambda mx, x: mx.npx.quadratic(x, 0.5, -1.0, 2.0), [X34],
                  (0,), TOL),
    "index_copy": (lambda mx, o, i, n: mx.npx.index_copy(o, i, n),
                   [X34, onp.array([2, 0], "int32"), X34[:2] * 5], (0, 2),
                   TOL),
    "index_array": (lambda mx, x: mx.npx.index_array(x), [X234], (), TOL),
    "index_array_axes": (lambda mx, x: mx.npx.index_array(x, axes=(1, 0)),
                         [X234], (), TOL),
    "gradientmultiplier": (
        lambda mx, x: mx.npx.gradientmultiplier(x, scalar=-0.5) * x, [X34],
        (0,), TOL),
    "dynamic_reshape": (
        lambda mx, x, s: mx.npx.dynamic_reshape(x, s),
        [X234, onp.array([4, 6], "int32")], (0,), TOL),
    "round_ste": (lambda mx, x: mx.npx.round_ste(x * 4) * x, [X34], (0,),
                  TOL),
    "sign_ste": (lambda mx, x: mx.npx.sign_ste(x) * x, [X34], (0,), TOL),
    "all_finite": (lambda mx, x: mx.npx.all_finite(x), [X34], (), TOL),
    "all_finite_inf": (lambda mx, x: mx.npx.all_finite(x / 0.0),
                       [X34], (), TOL),
    "multi_all_finite": (lambda mx, a, b: mx.npx.multi_all_finite(a, b),
                         [X34, X234], (), TOL),
    "multi_all_finite_list_nan": (
        lambda mx, a, b: mx.npx.multi_all_finite([a, mx.np.log(b - 2)]),
        [X34, X234], (), TOL),
    "norm_l2": (lambda mx, x: mx.npx.norm(x), [X234], (0,), TOL),
    "norm_l1_axis_keepdims": (
        lambda mx, x: mx.npx.norm(x, ord=1, axis=(0, 2), keepdims=True),
        [X234], (0,), TOL),
    "slice": (lambda mx, x: mx.npx.slice(x, (0, 1), (2, None)), [X234],
              (0,), TOL),
    "slice_negative_step": (
        lambda mx, x: mx.npx.slice(x, (None, 2, 3), (None, None, 0),
                                   (1, -1, -2)), [X234], (0,), TOL),
    "slice_channel": (lambda mx, x: mx.npx.slice_channel(x, 2, axis=2),
                      [X234], (0,), TOL),
    "slice_channel_squeeze": (
        lambda mx, x: mx.npx.slice_channel(x, 3, axis=1, squeeze_axis=True),
        [X234], (0,), TOL),
    "add_n": (lambda mx, a, b, c: mx.npx.add_n(a, b, c),
              [X34, X34 * 2, X34[:1]], (0, 1, 2), TOL),
    "add_n_list": (lambda mx, a, b: mx.npx.add_n([a, b]), [X34, X34], (0,),
                   TOL),
    "selfatt_qk": (
        lambda mx, x: mx.npx.interleaved_matmul_selfatt_qk(x, heads=2),
        [QKV], (0,), LOOSE),
    "selfatt_valatt": (
        lambda mx, x, a: mx.npx.interleaved_matmul_selfatt_valatt(
            x, a, heads=2), [QKV, ATT], (0, 1), LOOSE),
    "encdec_qk": (
        lambda mx, q, kv: mx.npx.interleaved_matmul_encdec_qk(q, kv,
                                                              heads=2),
        [Q_ED, KV_ED], (0, 1), LOOSE),
    "encdec_valatt": (
        lambda mx, kv, a: mx.npx.interleaved_matmul_encdec_valatt(
            kv, a, heads=2), [KV_ED, ATT_ED], (0, 1), LOOSE),
    "div_sqrt_dim": (lambda mx, x: mx.npx.div_sqrt_dim(x), [X234], (0,),
                     TOL),
    "sldwin_score": (
        lambda mx, q, k, d: mx.npx.sldwin_atten_score(q, k, d, w=2),
        [QB, KB, DIL], (0, 1), LOOSE),
    "sldwin_score_causal": (
        lambda mx, q, k, d: mx.npx.sldwin_atten_score(q, k, d, w=2,
                                                      symmetric=False),
        [QB, KB, DIL], (0, 1), LOOSE),
    "sldwin_context": (
        lambda mx, s, v, d: mx.npx.sldwin_atten_context(s, v, d, w=2),
        [R.uniform(size=(2, 6, 2, 5)).astype("float32"), KB, DIL], (0, 1),
        LOOSE),
    "sldwin_mask_like": (
        lambda mx, s, d, v: mx.npx.sldwin_atten_mask_like(s, d, v, w=2),
        [R.uniform(size=(2, 6, 2, 5)).astype("float32"), DIL, VLEN], (),
        TOL),
    "sldwin_mask_like_causal": (
        lambda mx, s, d, v: mx.npx.sldwin_atten_mask_like(
            s, d, v, w=2, symmetric=False),
        [R.uniform(size=(2, 6, 2, 3)).astype("float32"), DIL, VLEN], (),
        TOL),
}


@pytest.mark.parametrize("name", sorted(CONTRIB))
def test_contrib_op_matches_the_reference(name):
    fn, inputs, grad, tol = CONTRIB[name]
    both(fn, inputs, grad, tol)


# ---------------------------------------------------------------------------
# control flow: eager, and the captured form against the reference traced
# ---------------------------------------------------------------------------

def _cumsum_body(x, states):
    s = states[0] + x
    return s * 2, [s]


def _loop_cond(i, s):
    return i < 3


def _loop_func(i, s):
    return s * s, (i + 1, s + 1)


FLOW = {
    "foreach": (lambda mx, x, s0: mx.npx.foreach(_cumsum_body, x, [s0]),
                [X34, X34[0]], (0, 1)),
    "foreach_multi": (
        lambda mx, x, y, s0: mx.npx.foreach(
            lambda xs, st: ([xs[0] * st, xs[1]], st + xs[0]), [x, y], s0),
        [X34, X34 * 2, X34[0]], (0, 1, 2)),
    "while_loop": (
        lambda mx, i, s: mx.npx.while_loop(_loop_cond, _loop_func, [i, s]),
        [onp.array(0.0, "float32"), X34[0]], (1,)),
    "while_loop_padded": (
        lambda mx, i, s: mx.npx.while_loop(_loop_cond, _loop_func, [i, s],
                                           max_iterations=6),
        [onp.array(0.0, "float32"), X34[0]], (1,)),
    "while_loop_cut": (
        lambda mx, i, s: mx.npx.while_loop(_loop_cond, _loop_func, [i, s],
                                           max_iterations=2),
        [onp.array(0.0, "float32"), X34[0]], (1,)),
    "while_loop_no_step": (
        lambda mx, i, s: mx.npx.while_loop(_loop_cond, _loop_func, [i + 5, s],
                                           max_iterations=4),
        [onp.array(0.0, "float32"), X34[0]], ()),
    "cond_then": (lambda mx, p, x: mx.npx.cond(
        p > 0, lambda: x * 2, lambda: x - 1),
        [onp.array(1.0, "float32"), X34], (1,)),
    "cond_else": (lambda mx, p, x: mx.npx.cond(
        p > 0, lambda: [x * 2, x], lambda: [x - 1, x * x]),
        [onp.array(-1.0, "float32"), X34], (1,)),
}


def _flat(out):
    res = []
    for o in out if isinstance(out, (list, tuple)) else [out]:
        if isinstance(o, (list, tuple)):
            res += _flat(o)
        elif o is not None:
            res.append(o)
    return res


@pytest.mark.parametrize("name", sorted(FLOW))
def test_control_flow_matches_the_reference_eagerly(name):
    fn, inputs, grad = FLOW[name]
    both(lambda mx, *a: _flat(fn(mx, *a)), inputs, grad)


def _traced(fn, arrays):
    """The reference's traced form: ``fn`` under ``jax.jit`` on NDArrays
    of tracers."""
    import jax

    def f(*vals):
        out = fn(jmx, *[jmx.nd.NDArray(v) for v in vals])
        return [o._data for o in _flat(out)]

    return [onp.asarray(o) for o in jax.jit(f)(*arrays)]


def _captured(fn, arrays):
    with tmx.cpu():
        out = fn(tmx, *[tmx.np.array(a) for a in arrays])
        return [o.asnumpy() for o in _flat(out)]


CAPTURED = {
    "while_loop": (
        lambda mx, i, s: (tmx.npx._while_loop_captured
                          if mx is tmx else mx.npx.while_loop)(
            _loop_cond, _loop_func, [i, s], max_iterations=6),
        [onp.array(0.0, "float32"), X34[0]]),
    "while_loop_no_step": (
        lambda mx, i, s: (tmx.npx._while_loop_captured
                          if mx is tmx else mx.npx.while_loop)(
            _loop_cond, _loop_func, [i + 5, s], max_iterations=4),
        [onp.array(0.0, "float32"), X34[0]]),
    "cond": (
        lambda mx, p, x: (tmx.npx._cond_captured
                          if mx is tmx else mx.npx.cond)(
            p > 0, lambda: [x * 2, x + 1], lambda: [x - 1, x * x]),
        [onp.array(-1.0, "float32"), X34]),
}


@pytest.mark.parametrize("name", sorted(CAPTURED))
def test_captured_control_flow_matches_the_reference_traced(name):
    """The port's capture-safe forms (no value read on the host:
    `_while_loop_captured` runs max_iterations predicated steps) against
    the reference's ``lax.while_loop``/``lax.cond`` under ``jax.jit``."""
    fn, arrays = CAPTURED[name]
    want = _traced(fn, arrays)
    got = _captured(fn, arrays)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        onp.testing.assert_allclose(g, w, **TOL)


def test_captured_while_loop_needs_max_iterations_and_keeps_gradients():
    with tmx.cpu():
        i, s = tmx.np.array(0.0), tmx.np.array(X34[0])
        with pytest.raises(tmx.base.MXNetError):
            tmx.npx._while_loop_captured(_loop_cond, _loop_func, [i, s],
                                         None)
        s.attach_grad()
        with tmx.autograd.record():
            out, _ = tmx.npx._while_loop_captured(_loop_cond, _loop_func,
                                                  [i, s], 5)
            out.sum().backward()
        # sum over the 3 live steps of (s + k)^2: 2 * (3 s + 3)
        onp.testing.assert_allclose(s.grad.asnumpy(), 6 * X34[0] + 6,
                                    **TOL)


# ---------------------------------------------------------------------------
# mode switches and state
# ---------------------------------------------------------------------------

def test_mode_switches_answer_as_the_references():
    for mx in (jmx, tmx):
        assert mx.npx.set_np() is True and mx.npx.reset_np() is True
        assert mx.npx.is_np_array() and mx.npx.is_np_shape()
        assert mx.util.set_np(shape=True, array=True) is True
        assert mx.util.reset_np() is True
        assert mx.util.is_np_array() and mx.util.is_np_shape()
        with mx.util.np_shape(True), mx.util.np_array(False):
            pass
        mx.npx.waitall()

        @mx.util.use_np
        class Net:
            pass

        @mx.util.use_np
        def f(a, b=2):
            return a * b

        assert isinstance(Net(), Net) and f(3) == 6
        assert f.__name__ == "f"


def test_util_env_and_defaults_match_the_reference(monkeypatch):
    for mx in (jmx, tmx):
        mx.util.setenv("MXNET_NP_REMAINDER_TEST", 5)
        assert mx.util.getenv("MXNET_NP_REMAINDER_TEST") == "5"
        assert mx.util.getenv("MXNET_NP_REMAINDER_MISSING") is None
    del __import__("os").environ["MXNET_NP_REMAINDER_TEST"]
    for env, want in (({}, (0, 2)),
                      ({"MXNET_CPU_WORKER_NTHREADS": "3",
                        "MXNET_WORKER_RETRIES": "5"}, (3, 5)),
                      ({"MXNET_MP_WORKER_NTHREADS": "junk",
                        "MXNET_WORKER_RETRIES": "-1"}, (0, 0))):
        for k in ("MXNET_CPU_WORKER_NTHREADS", "MXNET_MP_WORKER_NTHREADS",
                  "MXNET_WORKER_RETRIES"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for mx in (jmx, tmx):
            assert (mx.util.default_num_workers(),
                    mx.util.default_worker_retries()) == want
    with tmx.cpu():
        a = tmx.util.default_array([[1, 2]], dtype="float16")
    j = jmx.util.default_array([[1, 2]], dtype="float16")
    assert a.dtype == j.dtype and a.shape == j.shape
    assert tmx.util.default_array([1.0], ctx=tmx.cpu()).device == tmx.cpu()


def test_random_state_and_npx_seed_reproduce():
    assert tmx.random.rng_impl() == "philox"
    tmx.npx.seed(7)
    s1 = tmx.random.get_state()
    k1 = tmx.random.next_key()
    tmx.random.seed(7)
    assert torch.equal(tmx.random.get_state(), s1)
    assert tmx.random.next_key() == k1
    assert not torch.equal(tmx.random.get_state(), s1)
    jmx.npx.seed(7)
    assert jmx.random.get_state() is not None
    assert tmx.test_utils.tpu(0) == tmx.gpu(0)


def test_npx_save_and_load_round_trip(tmp_path):
    path = str(tmp_path / "arrays")
    with tmx.cpu():
        tmx.npx.save(path, {"a": tmx.np.array(X34)})
        back = tmx.npx.load(path)
    jback = jmx.npx.load(path)
    onp.testing.assert_array_equal(back["a"].asnumpy(), X34)
    onp.testing.assert_array_equal(jback["a"].asnumpy(), X34)


# ---------------------------------------------------------------------------
# what must not run inside a CUDA-graph capture
# ---------------------------------------------------------------------------

def test_host_reading_ops_raise_inside_a_capture(monkeypatch):
    """boolean_mask, dynamic_reshape and clip_global_norm read device
    values on the host: inside a capture they raise MXNetError (the
    capture is stubbed on the CPU; `tests/test_torch_cuda.py` captures on
    the card)."""
    npx = tmx.npx
    monkeypatch.setattr(npx, "_capturing", lambda: True)
    with tmx.cpu():
        x = tmx.np.array(X34)
        for call in (lambda: npx.boolean_mask(x, tmx.np.array([1, 0, 1])),
                     lambda: npx.dynamic_reshape(x, tmx.np.array([4, 3])),
                     lambda: npx.clip_global_norm([x], 1.0)):
            with pytest.raises(tmx.base.MXNetError, match="capture"):
                call()
        # all_finite stays on the device: no read, no raise
        assert npx.all_finite(x).shape == (1,)
        # control flow takes the captured forms
        out, _ = npx.while_loop(_loop_cond, _loop_func,
                                [tmx.np.array(0.0), x[0]], max_iterations=4)
        assert out.shape == (4, 4)
        assert npx.cond(tmx.np.array(1.0), lambda: x, lambda: -x).shape == \
            (3, 4)


# ---------------------------------------------------------------------------
# the signatures of what this slice ports from files it ports in part
# (the whole files are in `test_torch_gluon.SURFACE`)
# ---------------------------------------------------------------------------

PART_PORTED = {
    ("util.py", "util.py"): (
        "is_np_array is_np_shape set_np reset_np use_np np_shape np_array "
        "getenv setenv default_array default_num_workers "
        "default_worker_retries").split(),
    ("random.py", "random.py"): ["get_state", "rng_impl"],
    ("numpy_extension/_boxes.py", "numpy_extension/__init__.py"): [
        "slice_like", "broadcast_like", "batch_take"],
}


@pytest.mark.parametrize("files", sorted(PART_PORTED), ids=str)
def test_partly_ported_files_lead_with_the_references_signatures(files):
    import os

    import incubator_mxnet_tpu
    import incubator_mxnet_tpu_torch
    from test_torch_gluon import _leads, _signatures

    ref = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu.__file__), files[0]))
    port = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu_torch.__file__), files[1]))
    bad = [n for n in PART_PORTED[files]
           if n not in port or not _leads(ref[n], port[n])]
    assert not bad, [(n, ref[n], port.get(n)) for n in bad]
