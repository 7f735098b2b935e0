"""Fused residual + dropout + LayerNorm: the hand-written CUDA kernels and
their plain versions (K3).

Port of `incubator_mxnet_tpu/ops/fused_block.py` `residual_dropout_ln`
(:394) with its kernels `_fwd_kernel` (:62, `_fwd` :133) and `_bwd_kernel`
(:83, `_bwd` :169) and the `_core` custom vjp (:214-235). The kernels are
``csrc/fused_block.cu`` over the LayerNorm row code of ``csrc/common.cuh``
(shared with ``csrc/layer_norm.cu``): y = LN(x + dropout_p(h)), one warp
per row. The forward reads x and h once and writes y and the f32 row
statistics; the backward regenerates the mask from the key and writes
dx, dh and dgamma/dbeta (per-block partials summed in a fixed order).
Bound by bytes on the H100: 3 * rows * C * itemsize forward,
5 * rows * C * itemsize backward.

The mask is the Philox stream of `ops/_philox.py` over the flat index of
each element of h, so for the same key and shape it is the mask
`ops/dropout.py` draws: ``residual_dropout_ln(x, h, ...)`` equals
``layer_norm(x + dropout(h))`` in float32, bit for bit. The saved
residuals are x, h, gamma, the key, mean and rstd, as `_core_fwd` (:220)
saves them: neither the mask nor the sum.

As on the TPU, the kernel runs at p = 0 too, adding h without drawing a
mask (eval passes and dropout-free models go through it). At p = 1 all of
h is dropped, so the wrapper runs the LayerNorm kernels of
`ops/layer_norm.py` on x alone (K4 forward, K4b backward) and dh is zero. :func:`plain_residual_dropout_ln` and
:func:`plain_residual_dropout_ln_bwd` repeat the kernels' arithmetic in
PyTorch (the backward's explicit formula, not autograd); a wrapper uses
them only for CPU tensors or when asked with ``impl="plain"``.

``launches`` counts forward kernel launches and ``bwd_launches`` backward
ones: a backward call that reaches the card launches two kernels, the row
kernel and the reduction of its dgamma/dbeta partials.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build
from ._philox import dropout_scale, keep_mask, threshold
from .layer_norm import (BWD_KERNELS, bwd_blocks, check_kernel_args,
                         layer_norm_bwd, layer_norm_fwd, plain_layer_norm,
                         plain_ln_grads, use_plain)

__all__ = ["plain_residual_dropout_ln", "plain_residual_dropout_ln_bwd",
           "residual_dropout_ln_fwd", "residual_dropout_ln_bwd",
           "residual_dropout_ln", "launches", "bwd_launches"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/common.cuh LnMode
_ADD, _DROP = 1, 2

launches = 0
bwd_launches = 0
_LIB = None


def _check_p(p):
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"residual_dropout_ln: p must be in [0, 1], got {p}")


def _dropped(h2d, key, p):
    """The f32 dropout of h: what the kernels add to x."""
    if p == 0:
        return h2d.float()
    if p == 1:
        return torch.zeros_like(h2d, dtype=torch.float32)
    keep = keep_mask(h2d.shape, key, p, device=h2d.device)
    scale = torch.tensor(dropout_scale(p), dtype=torch.float32)
    return torch.where(keep, h2d.float() * scale, 0.0)


def plain_residual_dropout_ln(x2d, h2d, gamma, beta, key, p, eps=1e-5):
    """(y, mean, rstd): LN(x + dropout(h)) with the sum in f32, y in x's
    dtype."""
    y, mean, rstd = plain_layer_norm(x2d.float() + _dropped(h2d, key, p),
                                     gamma, beta, eps)
    return y.to(x2d.dtype), mean, rstd


def plain_residual_dropout_ln_bwd(x2d, h2d, dy2d, mean, rstd, gamma, key,
                                  p):
    """(dx, dh, dgamma, dbeta), regenerating the mask from the key."""
    s = x2d.float() + _dropped(h2d, key, p)
    ds, dg, db = plain_ln_grads(s, dy2d, mean, rstd, gamma)
    dh = _dropped(ds, key, p)
    return (ds.to(x2d.dtype), dh.to(h2d.dtype), dg.to(gamma.dtype),
            db.to(gamma.dtype))


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("fused_block")
        fn = lib.mx_residual_dropout_ln_fwd
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                       + [ctypes.c_uint32] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.mx_residual_dropout_ln_bwd
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 3 + [ctypes.c_uint32] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _mode_key_args(key, p):
    """The LnMode and the keep rule's arguments for 0 <= p < 1."""
    if p == 0:
        return _ADD, 0, 0, 0, 1.0
    return _DROP, int(key[0]), int(key[1]), threshold(p), dropout_scale(p)


def _kernel(x2d, h2d, gamma, beta, key, p, eps):
    global launches
    rows, feat = x2d.shape
    check_kernel_args("residual_dropout_ln", x2d, (gamma, beta), (h2d,))
    x2d, h2d, gamma, beta = (_build.aligned(t)
                             for t in (x2d, h2d, gamma, beta))
    y = torch.empty_like(x2d)
    mean = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    if rows == 0:
        return y, mean, rstd
    mode, *key_args = _mode_key_args(key, p)
    lib = _lib()
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        err = lib.mx_residual_dropout_ln_fwd(
            _DTYPES[x2d.dtype], mode, x2d.data_ptr(), h2d.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), rows, feat, float(eps), *key_args, stream)
    _build.check(lib, err, "residual_dropout_ln_fwd")
    launches += 1
    return y, mean, rstd


def _kernel_bwd(x2d, h2d, dy2d, mean, rstd, gamma, key, p):
    global bwd_launches
    rows, feat = x2d.shape
    check_kernel_args("residual_dropout_ln_bwd", x2d, (gamma,),
                      (h2d, dy2d))
    x2d, h2d, dy2d, gamma = (_build.aligned(t)
                             for t in (x2d, h2d, dy2d, gamma))
    mean, rstd = mean.float().contiguous(), rstd.float().contiguous()
    dx, dh = torch.empty_like(x2d), torch.empty_like(h2d)
    if rows == 0:
        zero = torch.zeros(feat, dtype=gamma.dtype, device=x2d.device)
        return dx, dh, zero, zero.clone()
    nblocks = bwd_blocks(rows)
    partials = torch.empty((nblocks, 2, feat), dtype=torch.float32,
                           device=x2d.device)
    dgb = torch.empty((2, feat), dtype=torch.float32, device=x2d.device)
    mode, *key_args = _mode_key_args(key, p)
    lib = _lib()
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        err = lib.mx_residual_dropout_ln_bwd(
            _DTYPES[x2d.dtype], mode, x2d.data_ptr(), h2d.data_ptr(),
            dy2d.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            gamma.data_ptr(), dx.data_ptr(), dh.data_ptr(),
            partials.data_ptr(), dgb.data_ptr(), rows, feat, nblocks,
            *key_args, stream)
    _build.check(lib, err, "residual_dropout_ln_bwd")
    bwd_launches += BWD_KERNELS
    return dx, dh, dgb[0].to(gamma.dtype), dgb[1].to(gamma.dtype)


def residual_dropout_ln_fwd(x2d, h2d, gamma, beta, key, p, eps=1e-5,
                            impl="auto"):
    """(y, mean, rstd) of (rows, C) tensors; ``key`` is two uint32 words
    (unused at p = 0 or 1). ``impl``: "auto" launches the kernel for CUDA
    tensors and runs the plain version for CPU tensors; "kernel" requires
    CUDA tensors; "plain" forces the plain version."""
    _check_p(p)
    if use_plain("residual_dropout_ln", x2d, impl):
        return plain_residual_dropout_ln(x2d, h2d, gamma, beta, key, p, eps)
    if p == 1:  # all of h dropped: LayerNorm of x
        check_kernel_args("residual_dropout_ln", x2d, (gamma, beta), (h2d,))
        return layer_norm_fwd(x2d, gamma, beta, eps, impl)
    return _kernel(x2d, h2d, gamma, beta, key, p, eps)


def residual_dropout_ln_bwd(x2d, h2d, dy2d, mean, rstd, gamma, key, p,
                            impl="auto"):
    """(dx, dh, dgamma, dbeta) at the forward's statistics and key."""
    _check_p(p)
    if use_plain("residual_dropout_ln_bwd", x2d, impl):
        return plain_residual_dropout_ln_bwd(x2d, h2d, dy2d, mean, rstd,
                                             gamma, key, p)
    if p == 1:  # all of h dropped: dh = 0
        check_kernel_args("residual_dropout_ln_bwd", x2d, (gamma,),
                          (h2d, dy2d))
        dx, dg, db = layer_norm_bwd(x2d, dy2d, mean, rstd, gamma, impl)
        return dx, torch.zeros_like(h2d), dg, db
    return _kernel_bwd(x2d, h2d, dy2d, mean, rstd, gamma, key, p)


class _ResidualDropoutLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, h2d, gamma, beta, key, p, eps, impl):
        y, mean, rstd = residual_dropout_ln_fwd(x2d, h2d, gamma, beta, key,
                                                p, eps, impl)
        ctx.save_for_backward(x2d, h2d, gamma, mean, rstd)
        ctx.key, ctx.p, ctx.impl = key, p, impl
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, h2d, gamma, mean, rstd = ctx.saved_tensors
        dx, dh, dg, db = residual_dropout_ln_bwd(
            x2d, h2d, dy, mean, rstd, gamma, ctx.key, ctx.p, ctx.impl)
        return dx, dh, dg, db, None, None, None, None


def residual_dropout_ln(x, h, gamma, beta, p, key, eps=1e-5, impl="auto"):
    """``layer_norm(x + dropout_p(h))`` over the last axis, one fused pass
    each way; differentiable. x and h share a shape (leading axes collapse
    to rows); gamma/beta are (C,); ``key`` two uint32 words (a fresh
    framework key per call)."""
    if tuple(x.shape) != tuple(h.shape):
        raise MXNetError(f"residual_dropout_ln: x {tuple(x.shape)} and h "
                         f"{tuple(h.shape)} must share a shape")
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    h2d = h.reshape(-1, shape[-1])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, h, gamma, beta)):
        y = _ResidualDropoutLN.apply(x2d, h2d, gamma, beta, key, float(p),
                                     eps, impl)
    else:
        y, _, _ = residual_dropout_ln_fwd(x2d, h2d, gamma, beta, key,
                                          float(p), eps, impl)
    return y.reshape(shape)
