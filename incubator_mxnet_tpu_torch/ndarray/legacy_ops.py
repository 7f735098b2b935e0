"""``mx.nd``'s legacy operator long tail (port of
`incubator_mxnet_tpu/ndarray/legacy_ops.py`): the regression outputs,
LRN, UpSampling, im2col/col2im, moments, the activation variants, the
storage cast and the legacy random names.

Each op is one funnel call over plain torch (the reference's are jnp
compositions, with no kernel). The ops whose reference backward is not
the gradient of their forward (``make_loss``, the ``*RegressionOutput``
and ``SVMOutput`` losses, ``IdentityAttachKLSparseReg``) are
`torch.autograd.Function`s with the reference's backward formulas (its
``jax.custom_vjp``).
"""
from __future__ import annotations

import builtins
import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .ndarray import NDArray, apply_op

__all__ = [
    "slice_axis", "crop", "reverse", "depth_to_space", "space_to_depth",
    "im2col", "col2im", "moments", "hard_sigmoid", "mish", "log_sigmoid",
    "rcbrt", "rsqrt", "softmax_cross_entropy", "make_loss", "MakeLoss",
    "BlockGrad", "LRN", "UpSampling", "SoftmaxActivation",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "SVMOutput", "IdentityAttachKLSparseReg",
    "argmax_channel", "choose_element_0index", "size_array", "shuffle",
    "cast_storage", "broadcast_axis", "broadcast_axes",
    "normal", "uniform", "poisson", "exponential",
    "negative_binomial", "generalized_negative_binomial",
    "random_normal", "random_uniform", "random_poisson",
    "random_exponential", "random_gamma",
    "normal_like", "uniform_like", "poisson_like", "exponential_like",
    "gamma_like", "negative_binomial_like",
    "generalized_negative_binomial_like",
]

_11B = "ROADMAP.md §1 item 11b"


def slice_axis(data, axis=0, begin=0, end=None):
    """``data[begin:end]`` along one axis."""
    def fn(x):
        key = [builtins.slice(None)] * x.dim()
        key[axis] = builtins.slice(begin, end)
        return x[tuple(key)]

    return apply_op("slice_axis", fn, (data,))


def crop(data, begin=None, end=None, **kwargs):  # noqa: ARG001
    """The deprecated spelling of `npx.slice`."""
    from ..numpy_extension import slice as _slice

    return _slice(data, begin=begin, end=end)


def reverse(data, axis=0):
    """``data`` flipped along ``axis`` (an int or a list of them)."""
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)
    return apply_op("reverse", lambda x: x.flip(ax), (data,))


def depth_to_space(data, block_size):
    """NCHW depth to space, DCR order (the reference kernel's)."""
    b = int(block_size)

    def fn(x):
        n, c, h, w = x.shape
        x = x.reshape(n, b, b, c // (b * b), h, w)
        x = x.permute(0, 3, 4, 1, 5, 2)
        return x.reshape(n, c // (b * b), h * b, w * b)

    return apply_op("depth_to_space", fn, (data,))


def space_to_depth(data, block_size):
    """NCHW space to depth, :func:`depth_to_space`'s inverse."""
    b = int(block_size)

    def fn(x):
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // b, b, w // b, b)
        x = x.permute(0, 3, 5, 1, 2, 4)
        return x.reshape(n, c * b * b, h // b, w // b)

    return apply_op("space_to_depth", fn, (data,))


def _tup(v, n=2):
    if v is None:
        return (1,) * n if n == 2 else (0,) * n
    return tuple(int(x) for x in v) if not isinstance(v, int) \
        else (int(v),) * n


def _conv_args(kernel, stride, dilate, pad):
    return dict(kernel_size=_tup(kernel), stride=_tup(stride),
                dilation=_tup(dilate),
                padding=(pad, pad) if isinstance(pad, int) else _tup(pad))


def im2col(data, kernel, stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """NCHW unfolded into convolution patches: (N, C·kh·kw, L), the
    channel slowest (``F.unfold``, the order of the reference's
    ``conv_general_dilated_patches``)."""
    kw = _conv_args(kernel, stride, dilate, pad)
    return apply_op("im2col", lambda x: F.unfold(x, **kw), (data,))


def col2im(data, output_size, kernel, stride=(1, 1), dilate=(1, 1),
           pad=(0, 0)):
    """Patches folded back onto an (N, C, oh, ow) image, overlaps summed
    (:func:`im2col`'s transpose, ``F.fold``)."""
    kw = _conv_args(kernel, stride, dilate, pad)
    size = tuple(int(v) for v in output_size)
    return apply_op("col2im", lambda c: F.fold(c, size, **kw), (data,))


def moments(data, axes=None, keepdims=False):
    """(mean, biased variance) over ``axes`` (every axis by default)."""
    ax = None if axes is None else tuple(int(a) for a in axes)

    def fn(x):
        dims = tuple(range(x.dim())) if ax is None else ax
        m = x.mean(dim=dims, keepdim=keepdims)
        mk = x.mean(dim=dims, keepdim=True)
        v = ((x - mk) ** 2).mean(dim=dims, keepdim=keepdims)
        return m, v

    return apply_op("moments", fn, (data,), n_outputs=2)


def hard_sigmoid(data, alpha=0.2, beta=0.5):
    return apply_op("hard_sigmoid",
                    lambda x: (alpha * x + beta).clamp(0.0, 1.0), (data,))


def mish(data):
    """``x·tanh(softplus(x))``."""
    return apply_op("mish", lambda x: x * torch.tanh(F.softplus(x)),
                    (data,))


def log_sigmoid(data):
    return apply_op("log_sigmoid", F.logsigmoid, (data,))


def rcbrt(data):
    """``1/∛x`` with the real cube root of a negative x."""
    return apply_op("rcbrt", lambda x: 1.0 / (torch.sign(x) * x.abs().pow(
        1.0 / 3.0)), (data,))


def rsqrt(data):
    return apply_op("rsqrt", lambda x: 1.0 / torch.sqrt(x), (data,))


def softmax_cross_entropy(data, label):
    """The batch's total softmax cross-entropy, shape (1,)."""
    def fn(x, y):
        lp = torch.log_softmax(x, dim=-1)
        picked = lp.gather(1, y.to(torch.int64)[:, None])[:, 0]
        return -picked.sum().reshape(1)

    return apply_op("softmax_cross_entropy", fn, (data, label))


def make_loss(data, grad_scale=1.0, **kwargs):  # noqa: ARG001
    """A gradient source: forward the identity, backward the incoming
    gradient times ``grad_scale`` (`npx.gradientmultiplier`'s
    Function)."""
    from ..numpy_extension._contrib_misc import _Scaled

    s = float(grad_scale)
    return apply_op("make_loss", lambda x: _Scaled.apply(x, s), (data,))


MakeLoss = make_loss


def BlockGrad(data, **kwargs):  # noqa: N802, ARG001
    """``stop_gradient`` under its legacy name."""
    return apply_op("BlockGrad", lambda x: x.detach(), (data,))


def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):  # noqa: N802
    """Local response normalisation across channels:
    ``x / (k + α/n·Σ_window x²)^β`` over a window of ``nsize``
    channels."""
    n = int(nsize)

    def fn(x):
        half = n // 2
        sq = F.pad(x * x, (0, 0, 0, 0, half, half))
        acc = sum(sq[:, i:i + x.shape[1]] for i in range(n))
        return x / (knorm + (alpha / n) * acc) ** beta

    return apply_op("LRN", fn, (data,))


def UpSampling(*data, scale=1, sample_type="nearest", num_args=1,  # noqa: N802, ARG001
               num_filter=0, multi_input_mode="concat", **kwargs):  # noqa: ARG001
    """NCHW upsampling. "nearest" repeats each input up to the first
    input's size times ``scale``, then concatenates the channels (or sums,
    ``multi_input_mode="sum"``). "bilinear" with a weight (data[1], (C,
    1, k, k)) is the reference's depthwise transposed convolution; without
    one it needs `npx.bilinear_resize2d`, which is not ported
    (`ROADMAP.md` §1 item 11b)."""
    x = data[0]
    s = int(scale)
    oh, ow = x.shape[2] * s, x.shape[3] * s
    if sample_type == "nearest":
        outs = []
        for d in data:
            ri, rj = oh // d.shape[2], ow // d.shape[3]
            outs.append(apply_op(
                "UpSampling",
                lambda v, ri=ri, rj=rj: v.repeat_interleave(ri, dim=2)
                .repeat_interleave(rj, dim=3), (d,)))
        if len(outs) == 1:
            return outs[0]
        from .. import numpy as _np

        if multi_input_mode == "sum":
            total = outs[0]
            for o in outs[1:]:
                total = _np.add(total, o)
            return total
        return _np.concatenate(outs, axis=1)
    if len(data) > 1:
        wgt = data[1]
        k = wgt.shape[-1]
        p = (k - s) // 2

        def fn(v, w):
            return F.conv_transpose2d(v, w.to(v.dtype), stride=s, padding=p,
                                      groups=v.shape[1])

        return apply_op("UpSampling", fn, (x, wgt))
    raise MXNetError(f"nd.UpSampling(sample_type='bilinear') without a "
                     f"weight needs npx.bilinear_resize2d, which is not "
                     f"ported ({_11B})")


def SoftmaxActivation(data, mode="instance"):  # noqa: N802
    """Softmax over each instance's flattened trailing axes ("instance")
    or over axis 1 ("channel")."""
    def fn(x):
        if mode == "channel":
            return torch.softmax(x, dim=1)
        return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(
            x.shape)

    return apply_op("SoftmaxActivation", fn, (data,))


class _RegressionOutput(torch.autograd.Function):
    """A loss op: ``fwd(x)`` forward; backward ``bwd(x, y) · scale / n``
    (n the batch), whatever gradient comes in, and none for the label."""

    @staticmethod
    def forward(ctx, x, y, fwd, bwd, scale):
        ctx.save_for_backward(x, y)
        ctx.bwd, ctx.scale = bwd, scale
        return fwd(x)

    @staticmethod
    def backward(ctx, g):  # noqa: ARG004
        x, y = ctx.saved_tensors
        n = x.shape[0] if x.dim() > 0 else 1
        gx = ctx.bwd(x, y.reshape(x.shape).to(x.dtype)) \
            * (ctx.scale / max(n, 1))
        return gx, None, None, None, None


def _regression_output(name, fwd, bwd):
    def op(data, label, grad_scale=1.0, **kwargs):  # noqa: ARG001
        s = float(grad_scale)
        return apply_op(name, lambda x, y: _RegressionOutput.apply(
            x, y, fwd, bwd, s), (data, label))

    op.__name__ = name
    op.__doc__ = (f"The reference's {name}: forward {fwd.__doc__}; "
                  f"backward ({bwd.__doc__})·grad_scale / batch.")
    return op


def _identity(x):
    """the identity"""
    return x


def _diff(x, y):
    """x - y"""
    return x - y


def _sign_diff(x, y):
    """sign(x - y)"""
    return torch.sign(x - y)


def _sigmoid_diff(x, y):
    """sigmoid(x) - y"""
    return torch.sigmoid(x) - y


def _sigmoid(x):
    """sigmoid"""
    return torch.sigmoid(x)


LinearRegressionOutput = _regression_output(
    "LinearRegressionOutput", _identity, _diff)
MAERegressionOutput = _regression_output(
    "MAERegressionOutput", _identity, _sign_diff)
LogisticRegressionOutput = _regression_output(
    "LogisticRegressionOutput", _sigmoid, _sigmoid_diff)


class _SVMOutput(torch.autograd.Function):
    """Identity forward; backward the hinge (L1) or squared hinge (L2)
    gradient of each class's margin against the true class's score."""

    @staticmethod
    def forward(ctx, x, y, margin, reg, linear):
        ctx.save_for_backward(x, y)
        ctx.p = (margin, reg, linear)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):  # noqa: ARG004
        x, y = ctx.saved_tensors
        m, reg, linear = ctx.p
        yi = y.to(torch.int64)
        onehot = F.one_hot(yi, x.shape[1]).to(x.dtype)
        score_y = x.gather(1, yi[:, None])
        viol = (m - (score_y - x)) * (1 - onehot)
        if linear:
            mask = (viol > 0).to(x.dtype)
            gx = reg * (mask - mask.sum(dim=1, keepdim=True) * onehot)
        else:
            v = viol.clamp_min(0)
            gx = 2 * reg * (v - v.sum(dim=1, keepdim=True) * onehot)
        return gx, None, None, None, None


def SVMOutput(data, label, margin=1.0, regularization_coefficient=1.0,  # noqa: N802
              use_linear=False, **kwargs):  # noqa: ARG001
    """Forward the identity; backward the SVM's (squared) hinge gradient
    (the reference's, not the identity's)."""
    p = (float(margin), float(regularization_coefficient), bool(use_linear))
    return apply_op("SVMOutput", lambda x, y: _SVMOutput.apply(x, y, *p),
                    (data, label))


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; backward adds the KL sparseness penalty's
    gradient at the batch's mean activation."""

    @staticmethod
    def forward(ctx, x, rho, pen):
        ctx.save_for_backward(x)
        ctx.p = (rho, pen)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        rho, pen = ctx.p
        rho_hat = x.mean(dim=0, keepdim=True)
        kl = pen * (-rho / (rho_hat + 1e-12)
                    + (1 - rho) / (1 - rho_hat + 1e-12))
        return g + kl, None, None


def IdentityAttachKLSparseReg(data, sparseness_target=0.1, penalty=0.001,  # noqa: N802
                              momentum=0.9, **kwargs):  # noqa: ARG001
    """Identity with a KL sparseness regulariser on its gradient."""
    rho, pen = float(sparseness_target), float(penalty)
    return apply_op("IdentityAttachKLSparseReg",
                    lambda x: _KLSparseReg.apply(x, rho, pen), (data,))


def argmax_channel(data):
    """argmax over axis 1, float32."""
    return apply_op("argmax_channel",
                    lambda x: x.argmax(dim=1).to(torch.float32), (data,))


def choose_element_0index(lhs, rhs):
    """``lhs[i, rhs[i]]``."""
    return apply_op("choose_element_0index", lambda x, idx: x.gather(
        1, idx.to(torch.int64)[:, None])[:, 0], (lhs, rhs))


def size_array(data):
    """The element count as a (1,) int32 array (the reference's int64
    with x64 off) on data's device."""
    t = data._data if isinstance(data, NDArray) else data
    n = math.prod(t.shape) if t.dim() else 1
    return NDArray(torch.tensor([n], dtype=torch.int32, device=t.device))


def shuffle(data, **kwargs):  # noqa: ARG001
    """A random permutation of axis 0 (a new array), from the framework's
    key source."""
    from ..numpy.random import _gen

    dev = data._data.device if isinstance(data, NDArray) else data.device
    perm = torch.randperm(data.shape[0], generator=_gen(dev), device=dev)
    return apply_op("shuffle", lambda x: x.index_select(0, perm), (data,))


def cast_storage(data, stype):
    """Dense to dense (the array itself); a sparse ``stype`` raises
    :class:`MXNetError` (sparse storage: `ROADMAP.md` §1 item 11b)."""
    if stype in ("row_sparse", "csr"):
        raise MXNetError(f"nd.cast_storage(stype={stype!r}): sparse "
                         f"storage is not ported ({_11B})")
    return data.tostype(stype)


def broadcast_axis(data, axis=0, size=1):
    """Size-1 ``axis`` (or axes) broadcast to ``size``."""
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    sizes = size if isinstance(size, (list, tuple)) else (size,)

    def fn(x):
        shape = list(x.shape)
        for a, n in zip(axes, sizes):
            shape[a] = int(n)
        return torch.broadcast_to(x, shape)

    return apply_op("broadcast_axis", fn, (data,))


broadcast_axes = broadcast_axis


# ------------------------------------------------------ legacy random names

def _legacy_random(np_name):
    def op(*args, shape=None, dtype=None, **kwargs):
        from ..numpy import random as nprandom

        ctx = kwargs.pop("ctx", None)
        if shape is not None:
            kwargs["size"] = shape if not isinstance(shape, int) \
                else (shape,)
        if ctx is not None and np_name in ("normal", "uniform"):
            kwargs["device"] = ctx
        out = getattr(nprandom, np_name)(*args, **kwargs)
        if dtype is not None and str(out.dtype) != str(dtype):
            out = out.astype(dtype)
        return out

    op.__name__ = np_name
    op.__doc__ = (f"Legacy mx.nd.{np_name}: mx.np.random.{np_name} with "
                  f"``shape`` for ``size``.")
    return op


normal = random_normal = _legacy_random("normal")
uniform = random_uniform = _legacy_random("uniform")
poisson = random_poisson = _legacy_random("poisson")
exponential = random_exponential = _legacy_random("exponential")
# no bare `gamma`: nd.gamma is the Γ function (npx.gamma)
random_gamma = _legacy_random("gamma")
negative_binomial = _legacy_random("negative_binomial")


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype=None, **kwargs):  # noqa: ARG001
    """The gamma-Poisson mixture: λ ~ Gamma(1/α, α·μ), then Poisson(λ)."""
    from ..numpy import random as nprandom

    size = shape if shape is None or not isinstance(shape, int) \
        else (shape,)
    lam = nprandom.gamma(1.0 / alpha, alpha * mu, size=size)
    out = nprandom.poisson(lam=lam)
    if dtype is not None:
        out = out.astype(dtype)
    return out


def _like(fn):
    def op(data, *args, **kwargs):
        kwargs.pop("ctx", None)
        return fn(*args, shape=tuple(data.shape), **kwargs)

    op.__name__ = fn.__name__ + "_like"
    return op


normal_like = _like(normal)
uniform_like = _like(uniform)
poisson_like = _like(poisson)
exponential_like = _like(exponential)
gamma_like = _like(random_gamma)
negative_binomial_like = _like(negative_binomial)
generalized_negative_binomial_like = _like(generalized_negative_binomial)
