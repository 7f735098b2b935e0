"""The port's vision ops (``npx.convolution``, ``deconvolution``,
``pooling``, ``batch_norm``, ``group_norm``, ``instance_norm``,
``batch_flatten``, ``adaptive_avg_pooling2d``, ``batch_norm_with_relu``,
``pad``, ``deformable_convolution``) against the JAX package's, on the
same numpy-seeded inputs: the outputs, and the gradients of every input
(the reference's autograd tape, ``jax.vjp`` of each op, against torch's
autograd on CPU tensors) for a random output cotangent.

Tolerances (float32): outputs within 2e-5 of the largest entry plus 2e-5
relative (convolutions sum up to 108 products in another order;
cuDNN-free on the CPU, MKL-DNN on the port's side); gradients within
1e-4 normwise. The running statistics after a training call within
1e-6 relative (the port takes the biased variance back from the fused
op's 1/sqrt(var + eps)). Windows that lie wholly in the padding are
-inf (max) or nan (average over no element) on both sides.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
STAT_TOL = 1e-6


def _x(shape, seed, scale=1.0):
    return onp.random.RandomState(seed).normal(0, scale, shape) \
        .astype("float32")


def _close(got, want, tol, what=""):
    got = onp.asarray(got, onp.float64)
    want = onp.asarray(want, onp.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = onp.isfinite(want)
    assert (onp.isfinite(got) == fin).all(), what
    assert (got[~fin] == want[~fin]).all() or \
        (onp.isnan(got[~fin]) == onp.isnan(want[~fin])).all(), what
    g, w = got[fin], want[fin]
    scale = max(onp.abs(w).max(initial=0.0), 1e-30)
    onp.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                err_msg=what)


def _normwise(got, want, tol, what=""):
    got = onp.asarray(got, onp.float64)
    want = onp.asarray(want, onp.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = onp.linalg.norm(got - want)
    assert err <= tol * max(onp.linalg.norm(want), 1e-30), (what, err)


def _ref(op, arrays, train=False, grad=True, seed=99):
    """``op(jmx, *arrays)`` on the reference, and the gradients of every
    array for a seeded cotangent (first output)."""
    xs = [jmx.np.array(a) for a in arrays]
    if grad:
        for x in xs:
            x.attach_grad()
    with jmx.autograd.record(train_mode=train):
        out = op(jmx, *xs)
    first = out[0] if isinstance(out, (tuple, list)) else out
    dy = _x(first.shape, seed)
    if grad:
        first.backward(jmx.np.array(dy))
    outs = [o.asnumpy() for o in (out if isinstance(out, (tuple, list))
                                  else [out])]
    return outs, [x.grad.asnumpy() for x in xs] if grad else None, dy


def _port(op, arrays, dy, train=False, grad=True):
    """``op(tmx, *tensors)`` on the port's tensor path (CPU), and the
    gradients for the cotangent ``dy``."""
    xs = [torch.tensor(a, requires_grad=grad) for a in arrays]
    with tmx.cpu():
        scope = tmx.autograd.train_mode() if train \
            else tmx.autograd.predict_mode()
        with scope:
            out = op(tmx, *xs)
    first = out[0] if isinstance(out, (tuple, list)) else out
    if grad:
        first.backward(torch.from_numpy(dy))
    outs = [o.detach().numpy() for o in (out if isinstance(out, (tuple, list))
                                         else [out])]
    return outs, [x.grad.numpy() for x in xs] if grad else None


def _port_nd(op, arrays, train=False):
    """``op`` through the port's NDArray funnel (CPU)."""
    with tmx.cpu():
        xs = [tmx.np.array(a) for a in arrays]
        scope = tmx.autograd.train_mode() if train \
            else tmx.autograd.predict_mode()
        with scope:
            out = op(tmx, *xs)
    return [o.asnumpy() for o in (out if isinstance(out, (tuple, list))
                                  else [out])]


def _check(op, arrays, train=False, grad=True, fwd_tol=FWD_TOL,
           what=""):
    want, wgrads, dy = _ref(op, arrays, train, grad)
    got, ggrads = _port(op, arrays, dy, train, grad)
    for g, w in zip(got, want):
        _close(g, w, fwd_tol, what)
    for g, w in zip(_port_nd(op, arrays, train), want):
        _close(g, w, fwd_tol, what + " (NDArray)")
    if grad:
        for i, (g, w) in enumerate(zip(ggrads, wgrads)):
            _normwise(g, w, GRAD_TOL, f"{what} grad {i}")


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------

CONV_CASES = {
    "1d_stride_pad": ((2, 4, 9), (6, 4, 3), dict(kernel=(3,), stride=2,
                                                 pad=1), True),
    "2d_groups_dilate": ((2, 4, 8, 8), (6, 2, 3, 3),
                         dict(kernel=(3, 3), pad=2, dilate=2, num_group=2),
                         True),
    "2d_depthwise": ((2, 4, 7, 7), (4, 1, 3, 3),
                     dict(kernel=(3, 3), stride=2, pad=1, num_group=4),
                     False),
    "2d_rect_kernel": ((1, 3, 9, 9), (5, 3, 1, 7),
                       dict(kernel=(1, 7), pad=(0, 3)), True),
    "3d": ((1, 2, 5, 5, 5), (3, 2, 3, 3, 3),
           dict(kernel=(3, 3, 3), stride=(1, 2, 1), pad=1), True),
    "2d_nhwc": ((2, 8, 8, 4), (3, 3, 4, 6),
                dict(kernel=(3, 3), pad=1, layout="NHWC"), True),
    "2d_nhwc_groups": ((2, 6, 6, 4), (3, 3, 2, 6),
                       dict(kernel=(3, 3), stride=2, num_group=2,
                            layout="NHWC"), False),
    "1d_nwc": ((2, 9, 4), (3, 4, 5),
               dict(kernel=(3,), pad=1, layout="NWC"), True),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_reference(case):
    xs, ws, kw, bias = CONV_CASES[case]
    layout = kw.get("layout")
    n_out = ws[-1] if layout and layout[1] != "C" else ws[0]
    arrays = [_x(xs, 1), _x(ws, 2, 0.3)]
    if bias:
        arrays.append(_x((n_out,), 3))

    def op(mx, x, w, b=None):
        return mx.npx.convolution(x, w, b, num_filter=n_out,
                                  no_bias=b is None, **kw)

    _check(op, arrays, what=case)


# The reference reads a deconvolution weight as (out, in, *k) and drops
# adj and num_group; the port follows MXNet's (in, out/g, *k) with both.
# So the port with W is held against the reference with W's first two
# axes swapped; adj against the reference's unpadded output cropped;
# groups against the reference a group at a time.
DECONV_CASES = {
    "2d_s2_p1": ((2, 4, 5, 5), (4, 6, 3, 3),
                 dict(kernel=(3, 3), stride=2, pad=1)),
    "2d_k4_s2": ((2, 3, 4, 4), (3, 5, 4, 4),
                 dict(kernel=(4, 4), stride=2, pad=1)),
    "2d_dilate": ((1, 4, 5, 5), (4, 4, 3, 3),
                  dict(kernel=(3, 3), pad=1, dilate=2)),
    "1d": ((2, 3, 7), (3, 4, 3), dict(kernel=(3,), stride=2)),
    "3d": ((1, 2, 3, 4, 4), (2, 3, 3, 3, 3),
           dict(kernel=(3, 3, 3), stride=(1, 2, 2), pad=1)),
}


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconvolution_matches_reference(case):
    xs, ws, kw = DECONV_CASES[case]
    x, w, b = _x(xs, 4), _x(ws, 5, 0.3), _x((ws[1],), 6)
    wt = onp.ascontiguousarray(w.swapaxes(0, 1))
    want, wgrads, dy = _ref(
        lambda mx, xv, wv, bv: mx.npx.deconvolution(
            xv, wv, bv, num_filter=ws[1], **kw), [x, wt, b])
    got, ggrads = _port(
        lambda mx, xv, wv, bv: mx.npx.deconvolution(
            xv, wv, bv, num_filter=ws[1], **kw), [x, w, b], dy)
    _close(got[0], want[0], FWD_TOL, case)
    _normwise(ggrads[0], wgrads[0], GRAD_TOL, "dx")
    _normwise(ggrads[1], wgrads[1].swapaxes(0, 1), GRAD_TOL, "dw")
    _normwise(ggrads[2], wgrads[2], GRAD_TOL, "db")


def test_deconvolution_adj_extends_the_reference_output():
    x, w = _x((2, 3, 5, 5), 7), _x((3, 4, 3, 3), 8, 0.3)
    wt = jmx.np.array(onp.ascontiguousarray(w.swapaxes(0, 1)))
    full = jmx.npx.deconvolution(jmx.np.array(x), wt, kernel=(3, 3),
                                 stride=2, no_bias=True).asnumpy()
    with tmx.cpu():
        got = tmx.npx.deconvolution(tmx.np.array(x), tmx.np.array(w),
                                    kernel=(3, 3), stride=2, pad=1,
                                    adj=(1, 1), no_bias=True).asnumpy()
    # (5 - 1) * 2 - 2 + 3 + 1 = 10 rows: rows 1..10 of the unpadded 11
    assert got.shape == (2, 4, 10, 10)
    _close(got, full[:, :, 1:11, 1:11], FWD_TOL)


def test_deconvolution_groups_are_the_reference_a_group_at_a_time():
    x, w = _x((2, 4, 5, 5), 9), _x((4, 3, 3, 3), 10, 0.3)
    parts = []
    for gi in range(2):
        wg = onp.ascontiguousarray(w[2 * gi:2 * gi + 2].swapaxes(0, 1))
        parts.append(jmx.npx.deconvolution(
            jmx.np.array(x[:, 2 * gi:2 * gi + 2]), jmx.np.array(wg),
            kernel=(3, 3), stride=2, pad=1, no_bias=True).asnumpy())
    with tmx.cpu():
        got = tmx.npx.deconvolution(tmx.np.array(x), tmx.np.array(w),
                                    kernel=(3, 3), stride=2, pad=1,
                                    num_group=2, no_bias=True).asnumpy()
    _close(got, onp.concatenate(parts, 1), FWD_TOL)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

POOL_CASES = {
    # (shape, kwargs, finite): torch's own pooling where its windows are
    # the reference's, the explicit padding elsewhere
    "max_3_2_1": ((2, 3, 9, 9), dict(kernel=(3, 3), stride=(2, 2),
                                     pad=(1, 1), pool_type="max"), True),
    "avg_3_2_1_incl": ((2, 3, 9, 9), dict(kernel=(3, 3), stride=(2, 2),
                                          pad=(1, 1), pool_type="avg"), True),
    "avg_3_2_1_excl": ((2, 3, 9, 9), dict(kernel=(3, 3), stride=(2, 2),
                                          pad=(1, 1), pool_type="avg",
                                          count_include_pad=False), True),
    "avg_2_2": ((2, 3, 8, 8), dict(kernel=(2, 2), stride=(2, 2),
                                   pool_type="avg"), True),
    "sum_3_1_1": ((1, 2, 6, 6), dict(kernel=(3, 3), stride=(1, 1),
                                     pad=(1, 1), pool_type="sum"), True),
    "max_full_ceil": ((2, 3, 10, 10), dict(kernel=(3, 3), stride=(2, 2),
                                           pool_type="max",
                                           pooling_convention="full"), True),
    "avg_full_incl": ((2, 3, 10, 9), dict(kernel=(3, 3), stride=(2, 2),
                                          pad=(1, 1), pool_type="avg",
                                          pooling_convention="full"), True),
    "avg_full_excl": ((2, 3, 10, 9), dict(kernel=(3, 3), stride=(2, 2),
                                          pad=(1, 1), pool_type="avg",
                                          count_include_pad=False,
                                          pooling_convention="full"), True),
    # torch's ceil mode would drop the last window (it starts in the high
    # padding); the reference keeps it
    "max_full_window_in_pad": ((1, 2, 5, 5), dict(
        kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="max",
        pooling_convention="full"), False),
    "avg_full_window_in_pad_incl": ((1, 2, 5, 5), dict(
        kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="avg",
        pooling_convention="full"), True),
    "avg_full_window_in_pad_excl": ((1, 2, 5, 5), dict(
        kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="avg",
        count_include_pad=False, pooling_convention="full"), False),
    # padding past half the window: torch refuses it, the reference pads
    "max_pad_over_half": ((1, 2, 6, 6), dict(kernel=(2, 2), stride=(1, 1),
                                             pad=(2, 2), pool_type="max"),
                          False),
    "avg_pad_over_half_excl": ((1, 2, 6, 6), dict(
        kernel=(3, 3), stride=(2, 2), pad=(2, 2), pool_type="avg",
        count_include_pad=False), True),
    "max_1d": ((2, 3, 11), dict(kernel=(3,), stride=(2,), pad=(1,),
                                pool_type="max"), True),
    "avg_1d_full": ((2, 3, 10), dict(kernel=(3,), stride=(2,),
                                     pool_type="avg",
                                     pooling_convention="full"), True),
    "max_3d": ((1, 2, 5, 6, 6), dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                                     pool_type="max"), True),
    "avg_3d_pad": ((1, 2, 5, 5, 5), dict(kernel=(3, 3, 3), stride=(2, 2, 2),
                                         pad=(1, 1, 1), pool_type="avg"),
                   True),
    "max_nhwc": ((2, 7, 7, 3), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                    pool_type="max", layout="NHWC"), True),
    "global_max": ((2, 3, 5, 6), dict(global_pool=True, pool_type="max"),
                   True),
    "global_avg": ((2, 3, 5, 6), dict(global_pool=True, pool_type="avg"),
                   True),
    "global_sum_3d": ((2, 3, 3, 4, 5), dict(global_pool=True,
                                            pool_type="sum"), True),
    "global_lp": ((2, 3, 5, 6), dict(global_pool=True, pool_type="lp"),
                  True),
    "global_avg_nhwc": ((2, 5, 6, 3), dict(global_pool=True, pool_type="avg",
                                           layout="NHWC"), True),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_reference(case):
    shape, kw, finite = POOL_CASES[case]

    def op(mx, x):
        return mx.npx.pooling(x, **kw)

    # gradients where every window holds an input element
    _check(op, [_x(shape, 11)], grad=finite, what=case)


def test_windowed_lp_and_integer_max_pooling_raise():
    """Windowed "lp" raises; integer max pooling (the int8 chain's codes,
    the padding the type's minimum) computes the reference's; integer
    average pooling raises, as the reference computes none."""
    q = onp.random.RandomState(3).randint(-128, 128, (1, 2, 5, 5)).astype(
        "int8")
    want = jmx.npx.pooling(jmx.np.array(q), kernel=(2, 2), stride=(2, 2),
                           pad=(1, 1)).asnumpy()
    with tmx.cpu():
        x = torch.zeros(1, 1, 4, 4)
        with pytest.raises(ValueError):
            tmx.npx.pooling(x, kernel=(2, 2), pool_type="lp")
        got = tmx.npx.pooling(torch.from_numpy(q), kernel=(2, 2),
                              stride=(2, 2), pad=(1, 1))
        with pytest.raises(MXNetError, match="max only"):
            tmx.npx.pooling(x.to(torch.int8), kernel=(2, 2), pool_type="avg")
    assert got.dtype == torch.int8
    onp.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

BN_CASES = {
    "nchw_gamma": ((4, 3, 5, 5), 1, False),
    "nchw_fix_gamma": ((4, 3, 5, 5), 1, True),
    "nc": ((6, 5), 1, False),
    "nhwc_axis3": ((2, 4, 4, 3), 3, False),
    "ncdhw": ((2, 2, 3, 4, 4), 1, False),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_matches_reference(case, train):
    shape, axis, fix = BN_CASES[case]
    c = shape[axis]
    x = _x(shape, 12, 2.0) + 0.5
    g, b = _x((c,), 13) + 1.0, _x((c,), 14)
    rm0, rv0 = _x((c,), 15), onp.abs(_x((c,), 16)) + 0.5
    stats = {}

    def make(which):
        def op(mx, xv, gv, bv):
            rm, rv = mx.np.array(rm0), mx.np.array(rv0)
            stats[which] = (rm, rv)
            return mx.npx.batch_norm(xv, gv, bv, rm, rv, eps=1e-5,
                                     momentum=0.9, fix_gamma=fix,
                                     axis=axis)
        return op

    want, wgrads, dy = _ref(make("ref"), [x, g, b], train=train)
    # the port's tensor path: the running statistics are torch tensors
    xs = [torch.tensor(a, requires_grad=True) for a in (x, g, b)]
    rm, rv = torch.tensor(rm0), torch.tensor(rv0)
    with tmx.cpu():
        scope = tmx.autograd.train_mode() if train \
            else tmx.autograd.predict_mode()
        with scope:
            y = tmx.npx.batch_norm(*xs, rm, rv, eps=1e-5, momentum=0.9,
                                   fix_gamma=fix, axis=axis)
    y.backward(torch.from_numpy(dy))
    _close(y.detach().numpy(), want[0], FWD_TOL, case)
    for i, (gg, ww) in enumerate(zip(xs, wgrads)):
        if fix and i == 1:
            # gamma fixed at one: the reference's gradient is zeros, the
            # port's None (no tensor reaches it)
            assert gg.grad is None and not ww.any()
            continue
        _normwise(gg.grad.numpy(), ww, GRAD_TOL, f"{case} grad {i}")
    ref_rm, ref_rv = (a.asnumpy() for a in stats["ref"])
    _close(rm.numpy(), ref_rm, STAT_TOL, "running_mean")
    _close(rv.numpy(), ref_rv, STAT_TOL, "running_var")
    if not train:
        assert (rm.numpy() == rm0).all() and (rv.numpy() == rv0).all()
    # the NDArray funnel: the same output, the statistics updated in place
    got_nd = _port_nd(make("nd"), [x, g, b], train)
    _close(got_nd[0], want[0], FWD_TOL, case + " (NDArray)")
    nd_rm, nd_rv = (a.asnumpy() for a in stats["nd"])
    _close(nd_rm, ref_rm, STAT_TOL, "NDArray running_mean")
    _close(nd_rv, ref_rv, STAT_TOL, "NDArray running_var")


def test_batch_norm_running_stats_use_the_biased_variance():
    """rm = m rm + (1 - m) mean, rv = m rv + (1 - m) var with var the
    biased batch variance (not torch's unbiased N / (N - 1) one)."""
    x = _x((8, 2, 3, 3), 17, 3.0)
    rm, rv = torch.zeros(2), torch.ones(2)
    with tmx.cpu(), tmx.autograd.train_mode():
        tmx.npx.batch_norm(torch.from_numpy(x), torch.ones(2), torch.zeros(2),
                           rm, rv, momentum=0.9, fix_gamma=False)
    mean = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3))
    _close(rm.numpy(), 0.1 * mean, 1e-6)
    _close(rv.numpy(), 0.9 + 0.1 * var, 1e-6)


def test_batch_norm_output_mean_var_matches_reference():
    x = _x((4, 3, 4, 4), 18)
    g, b = _x((3,), 19) + 1, _x((3,), 20)

    def op(mx, xv, gv, bv):
        return mx.npx.batch_norm(xv, gv, bv, mx.np.zeros(3), mx.np.ones(3),
                                 fix_gamma=False, output_mean_var=True)

    _check(op, [x, g, b], train=True, what="output_mean_var")


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_norm_matches_reference(groups):
    x = _x((2, 4, 5, 6), 21, 2.0)

    def op(mx, xv, gv, bv):
        return mx.npx.group_norm(xv, gv, bv, num_groups=groups, eps=1e-5)

    _check(op, [x, _x((4,), 22) + 1, _x((4,), 23)], what=f"G={groups}")


@pytest.mark.parametrize("shape", [(2, 3, 7), (2, 3, 5, 6), (1, 2, 3, 4, 5)])
def test_instance_norm_matches_reference(shape):
    c = shape[1]

    def op(mx, xv, gv, bv):
        return mx.npx.instance_norm(xv, gv, bv, eps=1e-5)

    _check(op, [_x(shape, 24, 2.0), _x((c,), 25) + 1, _x((c,), 26)],
           what=str(shape))


def test_batch_norm_with_relu_matches_reference():
    x = _x((4, 3, 4, 4), 27)

    def op(mx, xv, gv, bv):
        return mx.npx.batch_norm_with_relu(xv, gv, bv, mx.np.zeros(3),
                                           mx.np.ones(3), fix_gamma=False)

    _check(op, [x, _x((3,), 28) + 1, _x((3,), 29)], train=True)


# ---------------------------------------------------------------------------
# the rest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out", [1, (3, 4), (5, 2)])
def test_adaptive_avg_pooling2d_matches_reference(out):
    def op(mx, x):
        return mx.npx.adaptive_avg_pooling2d(x, output_size=out)

    _check(op, [_x((2, 3, 7, 9), 30)], what=str(out))


PAD_CASES = {
    "constant": ("constant", (0, 0, 0, 0, 1, 2, 3, 1), 1.5),
    "edge": ("edge", (0, 0, 0, 0, 2, 1, 1, 3), 0.0),
    "reflect": ("reflect", (0, 0, 0, 0, 2, 3, 1, 1), 0.0),
    "reflect_3d": ("reflect", (0, 0, 0, 0, 1, 1, 2, 2), 0.0),
}


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_pad_matches_reference(case):
    mode, pw, cv = PAD_CASES[case]

    def op(mx, x):
        return mx.npx.pad(x, mode=mode, pad_width=pw, constant_value=cv)

    _check(op, [_x((2, 3, 4, 5), 31)], what=case)


def test_batch_flatten_matches_reference():
    _check(lambda mx, x: mx.npx.batch_flatten(x), [_x((2, 3, 4, 5), 32)])


@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
def test_deformable_convolution_matches_reference(modulated):
    g, kh, kw = 2, 3, 3
    x = _x((2, 4, 7, 7), 33)
    off = _x((2, 2 * g * kh * kw, 5, 5), 34, 1.5)
    w, b = _x((5, 4, kh, kw), 35, 0.3), _x((5,), 36)
    arrays = [x, off, w, b]
    if modulated:
        arrays.append(onp.random.RandomState(37).uniform(
            0, 1, (2, g * kh * kw, 5, 5)).astype("float32"))

    def op(mx, xv, ov, wv, bv, mk=None):
        return mx.npx.deformable_convolution(
            xv, ov, wv, bv, kernel=(kh, kw), num_filter=5,
            num_deformable_group=g, mask=mk)

    _check(op, arrays, what="v2" if modulated else "v1")
