"""LayerNorm forward and backward: the hand-written CUDA kernels and their
plain versions (K4, K4b).

Port of `incubator_mxnet_tpu/ops/layer_norm.py` (`_fwd_kernel` :49,
`_fwd` :63, `_bwd_kernel` :93, `_bwd` :122, the `_ln_core` custom vjp
:150-172, public `layer_norm` :175). The kernels are
``csrc/layer_norm.cu`` over the row code of ``csrc/common.cuh``: one warp
per row; the forward holds the row in registers, so x is read once and y
written once; the backward writes dx and per-block dgamma/dbeta partials
that a second kernel sums in a fixed order. Both are bound by bytes on
the H100.

:func:`plain_layer_norm` and :func:`plain_layer_norm_bwd` repeat the
kernels' arithmetic in PyTorch: mean first, then the centred variance,
rstd = rsqrt(var + eps), all in f32, y in the input dtype; the backward's
explicit formula (the reference's :106-110), not autograd of the forward.
A wrapper uses them only for CPU tensors (or when the caller asks for
``impl="plain"``); on a CUDA tensor ``impl="auto"`` launches the kernel or
raises. :func:`layer_norm` is differentiable: an autograd Function pairs
the forward with the backward and saves x, gamma, mean and rstd, as
`_ln_core_fwd` does.

``launches`` counts forward kernel launches and ``bwd_launches`` backward
ones: a backward call that reaches the card launches :data:`BWD_KERNELS`
kernels, the row kernel and the reduction of its dgamma/dbeta partials.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["MAX_FEATURES", "BWD_KERNELS", "supports", "column_sum_tol", "plain_layer_norm", "plain_ln_grads",
           "plain_layer_norm_bwd", "layer_norm_fwd", "layer_norm_bwd",
           "layer_norm", "launches", "bwd_launches"]

#: Largest feature size the kernels take: 32 lanes x 32 float4 vectors
#: (f32) or 16 eight-wide vectors (bf16) held in registers per row.
MAX_FEATURES = 4096
#: Most blocks the backward grid takes: its dgamma/dbeta partials are
#: (blocks, 2, C) f32, and a fixed grid for a given row count fixes the
#: order of the sums.
BWD_MAX_BLOCKS = 512
#: Kernels one backward call launches: the row kernel, then the reduction
#: of its per-block dgamma/dbeta partials.
BWD_KERNELS = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0
_LIB = None


def supports(shape, axis, feat, dtype=torch.float32):
    """Kernel eligibility on Hopper: last-axis norm, a float32/bfloat16
    feature size that is a whole number of 16-byte vectors and at most
    :data:`MAX_FEATURES` (replaces the TPU lane rule ``C % 128 == 0``)."""
    ndim = len(shape)
    if axis not in (-1, ndim - 1) or dtype not in _DTYPES:
        return False
    vec = 16 // (torch.finfo(dtype).bits // 8)
    return 0 < feat <= MAX_FEATURES and feat % vec == 0


def plain_layer_norm(x2d, gamma, beta, eps=1e-5):
    """(y, mean, rstd) of a (rows, C) tensor, the kernel's arithmetic in
    PyTorch ops."""
    x = x2d.float()
    c = x.shape[-1]
    mean = x.sum(dim=-1, keepdim=True) / c
    xc = x - mean
    var = (xc * xc).sum(dim=-1, keepdim=True) / c
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * gamma.float() + beta.float()
    return y.to(x2d.dtype), mean[:, 0], rstd[:, 0]


def plain_ln_grads(s, dy, mean, rstd, gamma):
    """(ds, dgamma, dbeta) in f32 of y = LN(s) at the saved statistics:
    the backward formula of the kernels and of the reference."""
    c = s.shape[-1]
    xhat = (s.float() - mean[:, None]) * rstd[:, None]
    dy = dy.float()
    wdy = dy * gamma.float()
    c1 = wdy.sum(dim=-1, keepdim=True) / c
    c2 = (wdy * xhat).sum(dim=-1, keepdim=True) / c
    ds = (wdy - c1 - xhat * c2) * rstd[:, None]
    return ds, (dy * xhat).sum(dim=0), dy.sum(dim=0)


def plain_layer_norm_bwd(x2d, dy2d, mean, rstd, gamma):
    """(dx, dgamma, dbeta): dx in x's dtype, dgamma/dbeta in gamma's."""
    dx, dg, db = plain_ln_grads(x2d, dy2d, mean, rstd, gamma)
    return dx.to(x2d.dtype), dg.to(gamma.dtype), db.to(gamma.dtype)


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("layer_norm")
        fn = lib.mx_layer_norm_fwd
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.mx_layer_norm_bwd
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_kernel_args(what, x2d, params, others=()):
    """Raise unless the row kernels take x2d with these (C,) parameters
    and same-shape companions."""
    feat = x2d.shape[1]
    if x2d.dtype not in _DTYPES:
        raise MXNetError(f"{what} kernel takes float32/bfloat16, got "
                         f"{x2d.dtype}")
    if any(t.dtype != x2d.dtype for t in (*params, *others)):
        raise MXNetError(f"{what} kernel: gamma/beta and the other inputs "
                         f"must have the input dtype {x2d.dtype}")
    if any(t.shape != (feat,) for t in params):
        raise MXNetError(f"{what}: gamma/beta must be ({feat},), got "
                         f"{[tuple(t.shape) for t in params]}")
    if any(t.shape != x2d.shape for t in others):
        raise MXNetError(f"{what}: inputs must share the shape "
                         f"{tuple(x2d.shape)}")
    if not supports(x2d.shape, -1, feat, x2d.dtype):
        raise MXNetError(
            f"{what} kernel takes a feature size that is a multiple of "
            f"{16 // x2d.element_size()} and at most {MAX_FEATURES}, got "
            f"{feat}")
    if any(t.device != x2d.device for t in (*params, *others)):
        raise MXNetError(f"{what}: all inputs must share a device")


def bwd_blocks(rows):
    """The backward's grid: eight rows a block (one a warp), at most
    BWD_MAX_BLOCKS."""
    return max(1, min(-(-rows // 8), BWD_MAX_BLOCKS))


def column_sum_tol(terms_abs_sum, rows):
    """Bound on |kernel - plain| of a float32 dgamma/dbeta column summed
    over ``rows`` rows, from the orders of the two sums. The backward grid
    (:func:`bwd_blocks`, blocks of at least 4 warps) gives a warp at most
    ceil(rows / (4 * BWD_MAX_BLOCKS)) rows; a block sums its up to 8 warp
    slots; each of the reduce kernel's 8 warps adds BWD_MAX_BLOCKS / 8
    block partials, then the 8 warp sums. The plain sum is a tree of depth
    log2(rows). Each side errs by at most its depth times 2^-24 times the
    sum of |terms|, plus a few ulps of each term, whose inputs differ in
    their last bits."""
    per_warp = -(-rows // (4 * BWD_MAX_BLOCKS))
    depth = (per_warp + 8 + BWD_MAX_BLOCKS // 8 + 8
             + max(1, rows.bit_length()) + 4)
    return depth * 2.0 ** -24 * terms_abs_sum


def _kernel(x2d, gamma, beta, eps):
    global launches
    rows = x2d.shape[0]
    check_kernel_args("layer_norm", x2d, (gamma, beta))
    x2d, gamma, beta = (_build.aligned(t) for t in (x2d, gamma, beta))
    y = torch.empty_like(x2d)
    mean = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    if rows == 0:
        return y, mean, rstd
    lib = _lib()
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        err = lib.mx_layer_norm_fwd(
            _DTYPES[x2d.dtype], x2d.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            rows, x2d.shape[1], float(eps), stream)
    _build.check(lib, err, "layer_norm_fwd")
    launches += 1
    return y, mean, rstd


def _kernel_bwd(x2d, dy2d, mean, rstd, gamma):
    global bwd_launches
    rows, feat = x2d.shape
    check_kernel_args("layer_norm_bwd", x2d, (gamma,), (dy2d,))
    x2d, dy2d, gamma = (_build.aligned(t) for t in (x2d, dy2d, gamma))
    mean, rstd = mean.float().contiguous(), rstd.float().contiguous()
    dx = torch.empty_like(x2d)
    if rows == 0:
        zero = torch.zeros(feat, dtype=gamma.dtype, device=x2d.device)
        return dx, zero, zero.clone()
    nblocks = bwd_blocks(rows)
    partials = torch.empty((nblocks, 2, feat), dtype=torch.float32,
                           device=x2d.device)
    dgb = torch.empty((2, feat), dtype=torch.float32, device=x2d.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        err = lib.mx_layer_norm_bwd(
            _DTYPES[x2d.dtype], x2d.data_ptr(), dy2d.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
            dx.data_ptr(), partials.data_ptr(), dgb.data_ptr(), rows, feat,
            nblocks, stream)
    _build.check(lib, err, "layer_norm_bwd")
    bwd_launches += BWD_KERNELS
    return dx, dgb[0].to(gamma.dtype), dgb[1].to(gamma.dtype)


def use_plain(what, x2d, impl):
    """:func:`_build.use_plain` for (rows, C) inputs."""
    if x2d.dim() != 2:
        raise ValueError(f"{what} expects (rows, C), got "
                         f"{tuple(x2d.shape)}")
    return _build.use_plain(what, x2d, impl)


def layer_norm_fwd(x2d, gamma, beta, eps=1e-5, impl="auto"):
    """(y, mean, rstd) of a (rows, C) tensor, the statistics f32 (rows,).

    ``impl``: "auto" launches the kernel for a CUDA tensor and runs the
    plain version for a CPU tensor; "kernel" requires a CUDA tensor;
    "plain" forces the plain version (the reference the kernel is held
    against)."""
    if use_plain("layer_norm", x2d, impl):
        return plain_layer_norm(x2d, gamma, beta, eps)
    return _kernel(x2d, gamma, beta, eps)


def layer_norm_bwd(x2d, dy2d, mean, rstd, gamma, impl="auto"):
    """(dx, dgamma, dbeta) of :func:`layer_norm_fwd` at its saved
    statistics; ``impl`` as there."""
    if use_plain("layer_norm_bwd", x2d, impl):
        return plain_layer_norm_bwd(x2d, dy2d, mean, rstd, gamma)
    return _kernel_bwd(x2d, dy2d, mean, rstd, gamma)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps, impl):
        y, mean, rstd = layer_norm_fwd(x2d, gamma, beta, eps, impl)
        ctx.save_for_backward(x2d, gamma, mean, rstd)
        ctx.impl = impl
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, gamma, mean, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x2d, dy, mean, rstd, gamma, ctx.impl)
        return dx, dg, db, None, None


def layer_norm(x, gamma, beta, eps=1e-5, impl="auto"):
    """Last-axis layer norm over a tensor of any rank (leading axes
    collapse to rows); differentiable. See :func:`layer_norm_fwd` for
    ``impl``."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma, beta)):
        y = _LayerNorm.apply(x2d, gamma, beta, eps, impl)
    else:
        y, _, _ = layer_norm_fwd(x2d, gamma, beta, eps, impl=impl)
    return y.reshape(shape)
