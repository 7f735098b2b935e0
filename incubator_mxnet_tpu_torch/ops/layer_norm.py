"""LayerNorm forward and backward: the hand-written CUDA kernels and their
plain versions (K4, K4b).

Port of `incubator_mxnet_tpu/ops/layer_norm.py` (`_fwd_kernel` :49,
`_fwd` :63, `_bwd_kernel` :93, `_bwd` :122, the `_ln_core` custom vjp
:150-172, public `layer_norm` :175). The kernels are
``csrc/layer_norm.cu`` over the row code of ``csrc/common.cuh``: one warp
per row; the forward holds the row in registers, so x is read once and y
written once; the backward writes dx and per-block dgamma/dbeta partials
that a second kernel sums in a fixed order. Both are bound by bytes on
the H100: the backward's grid fills the card once (:func:`bwd_blocks`)
and its warps walk the rows, summing dgamma/dbeta in registers.

:func:`plain_layer_norm` and :func:`plain_layer_norm_bwd` repeat the
kernels' arithmetic in PyTorch: mean first, then the centred variance,
rstd = rsqrt(var + eps), all in f32, y in the input dtype; the backward's
explicit formula (the reference's :106-110), not autograd of the forward.
A wrapper uses them only for CPU tensors (or when the caller asks for
``impl="plain"``); on a CUDA tensor ``impl="auto"`` launches the kernel or
raises. :func:`layer_norm` is differentiable: an autograd Function pairs
the forward with the backward and saves x, gamma, mean and rstd, as
`_ln_core_fwd` does.

Layouts (:data:`LAYOUTS`): x, y and dx in one dtype and gamma/beta and
dgamma/dbeta in one, both float32, both bfloat16, or bfloat16 x with
float32 gamma/beta, what AMP feeds a LayerNorm whose input is a bf16
product (BERT's ``mlm_ln``), as the reference's kernels take any mix
(they cast every input to f32 and write y in x's dtype, dgamma/dbeta in
gamma's). A CUDA tensor in another layout raises: nothing is cast to a
layout the kernels take, which would add a pass over the row.

``launches`` counts forward kernel launches and ``bwd_launches`` backward
ones: a backward call that reaches the card launches :data:`BWD_KERNELS`
kernels, the row kernel and the reduction of its dgamma/dbeta partials.
``layout_launches`` and ``bwd_layout_launches`` count the same launches by
layout name (:func:`layout_name`), so a run can show which layout it
took.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..base import MXNetError
from . import _build

__all__ = ["MAX_FEATURES", "BWD_KERNELS", "LAYOUTS", "RESIDUAL_LAYOUTS",
           "supports", "layout_name", "bwd_blocks", "sm_count",
           "column_sum_tol",
           "plain_layer_norm", "plain_ln_grads", "plain_layer_norm_bwd",
           "layer_norm_fwd", "layer_norm_bwd", "layer_norm", "launches",
           "bwd_launches", "layout_launches", "bwd_layout_launches"]

#: Largest feature size the kernels take: 32 lanes x 32 float4 vectors
#: (f32) or 16 eight-wide vectors (bf16) held in registers per row.
MAX_FEATURES = 4096
#: Backward blocks an SM (csrc/common.cuh kLnBwdBlocksPerSm): the grid is
#: at most two 8-warp blocks per SM, all resident at once, and its
#: dgamma/dbeta partials are (blocks, 2, C) f32. A fixed grid for a given
#: row count and card fixes the order of the sums.
BWD_BLOCKS_PER_SM = 2
#: Rows a backward block takes before the grid is full: one a warp.
BWD_WARPS = 8
#: Warps of the reduction of the partials (csrc/common.cuh
#: kLnReduceWarps): each adds every BWD_REDUCE_WARPS-th partial in turn.
BWD_REDUCE_WARPS = 32
#: Kernels one backward call launches: the row kernel, then the reduction
#: of its per-block dgamma/dbeta partials.
BWD_KERNELS = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (x, gamma) dtypes the LayerNorm kernels take; the last is AMP's
LAYOUTS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
           (torch.bfloat16, torch.float32))
#: (x, h, gamma) dtypes the fused residual + dropout + LayerNorm kernels
#: (`ops/fused_block.py`, the same row code) take; the last is AMP's
RESIDUAL_LAYOUTS = ((torch.float32,) * 3, (torch.bfloat16,) * 3,
                    (torch.float32, torch.bfloat16, torch.float32))

launches = 0
bwd_launches = 0
layout_launches = collections.Counter()
bwd_layout_launches = collections.Counter()
_LIB = None


def supports(shape, axis, feat, dtype=torch.float32, param_dtype=None,
             h_dtype=None):
    """Kernel eligibility on Hopper: last-axis norm; x and gamma/beta
    (``param_dtype``, x's dtype when None) in one of :data:`LAYOUTS`, or
    with the residual's ``h_dtype`` one of :data:`RESIDUAL_LAYOUTS`; a
    feature size that is a whole number of 16-byte vectors of x and at
    most :data:`MAX_FEATURES` (replaces the TPU lane rule
    ``C % 128 == 0``)."""
    ndim = len(shape)
    param_dtype = dtype if param_dtype is None else param_dtype
    layout = (dtype, param_dtype) if h_dtype is None else (
        dtype, h_dtype, param_dtype)
    if axis not in (-1, ndim - 1) or layout not in (
            LAYOUTS if h_dtype is None else RESIDUAL_LAYOUTS):
        return False
    vec = 16 // (torch.finfo(dtype).bits // 8)
    return 0 < feat <= MAX_FEATURES and feat % vec == 0


_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16"}


def layout_name(x_dtype, param_dtype, h_dtype=None):
    """"f32" or "bf16" when every operand has one dtype, else e.g.
    "bf16 x, f32 gamma" or "f32 x, bf16 h, f32 gamma"."""
    dts = (x_dtype, param_dtype) + (() if h_dtype is None else (h_dtype,))
    if len(set(dts)) == 1:
        return _SHORT[x_dtype]
    h = "" if h_dtype is None else f", {_SHORT[h_dtype]} h"
    return f"{_SHORT[x_dtype]} x{h}, {_SHORT[param_dtype]} gamma"


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
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.mx_layer_norm_bwd
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _names(dtypes):
    return "(" + ", ".join(str(d).replace("torch.", "") for d in dtypes) + ")"


def check_kernel_args(what, x2d, params, others=(), h=None):
    """Raise unless the row kernels take x2d with these (C,) parameters,
    same-shape companions ``others`` in x's dtype (dy) and, for the
    residual kernels, a same-shape ``h``: the dtypes of (x, gamma) must be
    one of :data:`LAYOUTS`, or those of (x, h, gamma) one of
    :data:`RESIDUAL_LAYOUTS`."""
    feat = x2d.shape[1]
    comp = (*others, *(() if h is None else (h,)))
    if h is None:
        names, layouts = "x, gamma", LAYOUTS
        got = (x2d.dtype, params[0].dtype)
    else:
        names, layouts = "x, h, gamma", RESIDUAL_LAYOUTS
        got = (x2d.dtype, h.dtype, params[0].dtype)
    if got not in layouts or any(t.dtype != got[-1] for t in params):
        raise MXNetError(
            f"{what} kernel takes ({names}) dtypes "
            f"{', '.join(_names(k) for k in layouts)}, beta in gamma's; got "
            f"{_names(got)}, beta {_names(t.dtype for t in params[1:])}")
    if any(t.dtype != x2d.dtype for t in others):
        raise MXNetError(f"{what} kernel: dy must have x's dtype "
                         f"{x2d.dtype}")
    if any(t.shape != (feat,) for t in params):
        raise MXNetError(f"{what}: gamma/beta must be ({feat},), got "
                         f"{[tuple(t.shape) for t in params]}")
    if any(t.shape != x2d.shape for t in comp):
        raise MXNetError(f"{what}: inputs must share the shape "
                         f"{tuple(x2d.shape)}")
    if not supports(x2d.shape, -1, feat, x2d.dtype):
        raise MXNetError(
            f"{what} kernel takes a feature size that is a multiple of "
            f"{16 // x2d.element_size()} and at most {MAX_FEATURES}, got "
            f"{feat}")
    if any(t.device != x2d.device for t in (*params, *comp)):
        raise MXNetError(f"{what}: all inputs must share a device")


def bwd_blocks(rows, sms):
    """The backward's grid on a card of ``sms`` SMs: one row a warp
    (BWD_WARPS a block) while rows are few, else BWD_BLOCKS_PER_SM blocks
    an SM whose warps walk the rows."""
    return max(1, min(-(-rows // BWD_WARPS), BWD_BLOCKS_PER_SM * sms))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device):
    """The SMs of a CUDA device (what :func:`bwd_blocks` sizes for)."""
    device = torch.device(device)
    return _sm_count(torch.cuda.current_device() if device.index is None
                     else device.index)


def column_sum_tol(terms_abs_sum, rows, nblocks):
    """Bound on |kernel - plain| of a float32 dgamma/dbeta column summed
    over ``rows`` rows on a backward grid of ``nblocks`` blocks
    (:func:`bwd_blocks`), from the orders of the two sums. A block has at
    least 4 warps (7 at C = 4096), so a warp adds at most
    ceil(rows / (4 * nblocks)) rows in turn; a block sums its up to 8 warp
    slots; each of the reduce kernel's BWD_REDUCE_WARPS warps adds
    ceil(nblocks / BWD_REDUCE_WARPS) block partials, then warp 0 adds the
    warp sums. The plain sum is a tree of depth log2(rows). Each side errs
    by at most its depth times 2^-24 times the sum of |terms|, plus a few
    ulps of each term, whose inputs differ in their last bits."""
    depth = (-(-rows // (4 * nblocks)) + 8 + -(-nblocks // BWD_REDUCE_WARPS)
             + BWD_REDUCE_WARPS + max(1, rows.bit_length()) + 4)
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
            _DTYPES[x2d.dtype], _DTYPES[gamma.dtype], x2d.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), rows, x2d.shape[1], float(eps), stream)
    _build.check(lib, err, "layer_norm_fwd")
    launches += 1
    layout_launches[layout_name(x2d.dtype, gamma.dtype)] += 1
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
    nblocks = bwd_blocks(rows, sm_count(x2d.device))
    partials = torch.empty((nblocks, 2, feat), dtype=torch.float32,
                           device=x2d.device)
    dgb = torch.empty((2, feat), dtype=gamma.dtype, device=x2d.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        err = lib.mx_layer_norm_bwd(
            _DTYPES[x2d.dtype], _DTYPES[gamma.dtype], x2d.data_ptr(),
            dy2d.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            gamma.data_ptr(), dx.data_ptr(), partials.data_ptr(),
            dgb.data_ptr(), rows, feat, nblocks, stream)
    _build.check(lib, err, "layer_norm_bwd")
    bwd_launches += BWD_KERNELS
    bwd_layout_launches[layout_name(x2d.dtype, gamma.dtype)] += BWD_KERNELS
    return dx, dgb[0], dgb[1]


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
