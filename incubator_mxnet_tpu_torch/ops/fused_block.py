"""The fused blocks of the reference's `ops/fused_block.py`: residual +
dropout + LayerNorm (K3) and exact-erf GELU + dropout (K6), the
hand-written CUDA kernels and their plain versions.

**K3.**
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

Layouts (`ops.layer_norm.RESIDUAL_LAYOUTS`): x, y, dx and dy in one
dtype, h and dh in one, gamma/beta and dgamma/dbeta in one: all float32,
all bfloat16, or float32 x with bfloat16 h and float32 gamma/beta, what
AMP feeds BERT's residual sites (the residual stream f32, the attention
and FFN outputs bf16 products), as the reference's kernels take any mix.
Another layout raises on a CUDA tensor; nothing is cast to one the
kernels take (casting h to f32 would add a pass and 2 bytes an element).

``launches`` counts forward kernel launches and ``bwd_launches`` backward
ones: a backward call that reaches the card launches two kernels, the row
kernel and the reduction of its dgamma/dbeta partials.
``layout_launches`` and ``bwd_layout_launches`` count them by layout
(`ops.layer_norm.layout_name`).

**K6.** Port of `gelu_dropout` (:366) with its kernels `_gd_fwd_kernel`
(:289) and `_gd_bwd_kernel` (:298), launched through `_gd_call` (:311),
and the `_gd_core` custom vjp (:335-352). The kernels are
``csrc/gelu_dropout.cu``: y = dropout_p(gelu(u)) with the exact erf form
of GELU, and du = dy * gelu'(u) * mask * scale with gelu'(u) = Phi(u) +
u * phi(u), all in f32, one (f32) or two (bf16) 16-byte vectors a
thread. Bound by bytes on the H100: 2 * numel * itemsize forward,
3 * numel * itemsize backward. The saved residuals are u and the key, as
`_gd_core_fwd` (:340) saves them: neither the mask nor gelu(u). The mask
is K5's for the same key and shape, so the plain ``gelu_dropout(u, key,
p)`` equals ``dropout(F.gelu(u, approximate="none"), key, p)`` in
float32, bit for bit. The reference's erf is the Abramowitz-Stegun
approximation (within 1.5e-7), there only because Pallas has no erf
lowering on the TPU. The kernel computes Phi and phi from one rational
approximation of the normal tail, no further from float64 than erff's
form (``chip_smoke.py`` measures both), so it agrees with the plain
version within a few f32 roundings, not bit for bit. At p = 0 the kernel
still runs, without drawing a mask, as `_gd_call` does
(``use_rng=False``); at p = 1 the result and the gradient are zeros and
nothing is launched. The counters
are ``gd_launches`` and ``gd_bwd_launches``.

**Keys.** A key is two host words or, inside `random.trace_key_scope`
(a step replayed as a CUDA graph), an `ops._philox.DeviceKey`: K3 and
K6 then read its words from the card (the ``_dk`` entries of their
sources) at the address `ops.dropout.site_key_ptr` gives, and the plain
versions fold the same words in PyTorch ops. The autograd functions keep
the forward's key for the backward, whichever form it has.
"""
from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import _build
from ._philox import DeviceKey, dropout_scale, keep_mask, threshold
from .dropout import site_key_ptr
from .layer_norm import (BWD_KERNELS, bwd_blocks, check_kernel_args,
                         layer_norm_bwd, layer_norm_fwd, layout_name,
                         plain_layer_norm, plain_ln_grads, sm_count,
                         use_plain)

__all__ = ["plain_residual_dropout_ln", "plain_residual_dropout_ln_bwd",
           "residual_dropout_ln_fwd", "residual_dropout_ln_bwd",
           "residual_dropout_ln", "launches", "bwd_launches",
           "layout_launches", "bwd_layout_launches",
           "plain_gelu_dropout", "plain_gelu_dropout_bwd", "gelu_dropout_fwd",
           "gelu_dropout_bwd", "gelu_dropout", "gd_launches",
           "gd_bwd_launches"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/common.cuh LnMode
_ADD, _DROP = 1, 2

launches = 0
bwd_launches = 0
layout_launches = collections.Counter()
bwd_layout_launches = collections.Counter()
gd_launches = 0
gd_bwd_launches = 0
_LIB = None
_GD_LIB = None


def _check_p(p, what="residual_dropout_ln"):
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"{what}: p must be in [0, 1], got {p}")


def _dropped(h2d, key, p):
    """The f32 dropout of h: what the K3 kernels add to x, and K6's mask
    and scale."""
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
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                       + [ctypes.c_uint32] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.mx_residual_dropout_ln_bwd
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 3 + [ctypes.c_uint32] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.mx_residual_dropout_ln_fwd_dk
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.mx_residual_dropout_ln_bwd_dk
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p,
                                               ctypes.c_uint32,
                                               ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _codes(x2d, h2d, gamma):
    """The C entries' dtype codes of x, h and gamma."""
    return _DTYPES[x2d.dtype], _DTYPES[h2d.dtype], _DTYPES[gamma.dtype]


def _mode_key_args(key, p):
    """The LnMode and the keep rule's arguments for 0 <= p < 1."""
    if p == 0:
        return _ADD, 0, 0, 0, 1.0
    return _DROP, int(key[0]), int(key[1]), threshold(p), dropout_scale(p)


def _kernel(x2d, h2d, gamma, beta, key, p, eps):
    global launches
    rows, feat = x2d.shape
    check_kernel_args("residual_dropout_ln", x2d, (gamma, beta), h=h2d)
    x2d, h2d, gamma, beta = (_build.aligned(t)
                             for t in (x2d, h2d, gamma, beta))
    y = torch.empty_like(x2d)
    mean = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    if rows == 0:
        return y, mean, rstd
    lib = _lib()
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        args = (x2d.data_ptr(), h2d.data_ptr(), gamma.data_ptr(),
                   beta.data_ptr(), y.data_ptr(), mean.data_ptr(),
                   rstd.data_ptr(), rows, feat, float(eps))
        if isinstance(key, DeviceKey) and p > 0:
            err = lib.mx_residual_dropout_ln_fwd_dk(
                *_codes(x2d, h2d, gamma), *args,
                site_key_ptr(key, x2d.device), threshold(p),
                dropout_scale(p), stream)
        else:
            mode, *key_args = _mode_key_args(key, p)
            err = lib.mx_residual_dropout_ln_fwd(
                *_codes(x2d, h2d, gamma), mode, *args, *key_args, stream)
    _build.check(lib, err, "residual_dropout_ln_fwd")
    launches += 1
    layout_launches[layout_name(x2d.dtype, gamma.dtype, h2d.dtype)] += 1
    return y, mean, rstd


def _kernel_bwd(x2d, h2d, dy2d, mean, rstd, gamma, key, p):
    global bwd_launches
    rows, feat = x2d.shape
    check_kernel_args("residual_dropout_ln_bwd", x2d, (gamma,), (dy2d,),
                      h=h2d)
    x2d, h2d, dy2d, gamma = (_build.aligned(t)
                             for t in (x2d, h2d, dy2d, gamma))
    mean, rstd = mean.float().contiguous(), rstd.float().contiguous()
    dx, dh = torch.empty_like(x2d), torch.empty_like(h2d)
    if rows == 0:
        zero = torch.zeros(feat, dtype=gamma.dtype, device=x2d.device)
        return dx, dh, zero, zero.clone()
    nblocks = bwd_blocks(rows, sm_count(x2d.device))
    partials = torch.empty((nblocks, 2, feat), dtype=torch.float32,
                           device=x2d.device)
    dgb = torch.empty((2, feat), dtype=gamma.dtype, device=x2d.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        args = (x2d.data_ptr(), h2d.data_ptr(), dy2d.data_ptr(),
                   mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
                   dx.data_ptr(), dh.data_ptr(), partials.data_ptr(),
                   dgb.data_ptr(), rows, feat, nblocks)
        if isinstance(key, DeviceKey) and p > 0:
            err = lib.mx_residual_dropout_ln_bwd_dk(
                *_codes(x2d, h2d, gamma), *args,
                site_key_ptr(key, x2d.device), threshold(p),
                dropout_scale(p), stream)
        else:
            mode, *key_args = _mode_key_args(key, p)
            err = lib.mx_residual_dropout_ln_bwd(
                *_codes(x2d, h2d, gamma), mode, *args, *key_args, stream)
    _build.check(lib, err, "residual_dropout_ln_bwd")
    bwd_launches += BWD_KERNELS
    bwd_layout_launches[layout_name(x2d.dtype, gamma.dtype,
                                    h2d.dtype)] += BWD_KERNELS
    return dx, dh, dgb[0], dgb[1]


def residual_dropout_ln_fwd(x2d, h2d, gamma, beta, key, p, eps=1e-5,
                            impl="auto"):
    """(y, mean, rstd) of (rows, C) tensors; ``key`` is two uint32 words
    or a `DeviceKey` (unused at p = 0 or 1). ``impl``: "auto" launches the
    kernel for CUDA tensors and runs the plain version for CPU tensors;
    "kernel" requires CUDA tensors; "plain" forces the plain version."""
    _check_p(p)
    if use_plain("residual_dropout_ln", x2d, impl):
        return plain_residual_dropout_ln(x2d, h2d, gamma, beta, key, p, eps)
    if p == 1:  # all of h dropped: LayerNorm of x
        check_kernel_args("residual_dropout_ln", x2d, (gamma, beta), h=h2d)
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
        check_kernel_args("residual_dropout_ln_bwd", x2d, (gamma,), (dy2d,),
                          h=h2d)
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


# -- K6: exact-erf GELU + dropout -------------------------------------------

_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _normal_cdf(uf):
    return 0.5 * (1.0 + torch.erf(uf * _SQRT_HALF))


def plain_gelu_dropout(u, key, p):
    """``dropout_p(gelu(u))``: the exact gelu u * Phi(u) in f32 (PyTorch's
    erf form, whose CPU kernel rounds otherwise than ``torch.erf``), then
    the mask and f32 scale of `ops/dropout.py`; returned in u's dtype."""
    g = F.gelu(u.float(), approximate="none")
    return _dropped(g, key, p).to(u.dtype)


def plain_gelu_dropout_bwd(u, dy, key, p):
    """du = dy * gelu'(u) under the forward's mask and scale, with
    gelu'(u) = Phi(u) + u * phi(u) (the explicit formula)."""
    uf = u.float()
    pdf = torch.exp(-0.5 * uf * uf) * _INV_SQRT_2PI
    return _dropped(dy.float() * (_normal_cdf(uf) + uf * pdf), key,
                    p).to(u.dtype)


def _gd_lib():
    global _GD_LIB
    if _GD_LIB is None:
        lib = _build.load("gelu_dropout")
        tail = [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                ctypes.c_void_p]
        lib.mx_gelu_dropout_fwd.argtypes = [ctypes.c_int] + [
            ctypes.c_void_p] * 2 + tail
        lib.mx_gelu_dropout_fwd.restype = ctypes.c_int
        lib.mx_gelu_dropout_bwd.argtypes = [ctypes.c_int] + [
            ctypes.c_void_p] * 3 + tail
        lib.mx_gelu_dropout_bwd.restype = ctypes.c_int
        dk_tail = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_uint32,
                   ctypes.c_float, ctypes.c_void_p]
        lib.mx_gelu_dropout_fwd_dk.argtypes = [ctypes.c_int] + [
            ctypes.c_void_p] * 2 + dk_tail
        lib.mx_gelu_dropout_fwd_dk.restype = ctypes.c_int
        lib.mx_gelu_dropout_bwd_dk.argtypes = [ctypes.c_int] + [
            ctypes.c_void_p] * 3 + dk_tail
        lib.mx_gelu_dropout_bwd_dk.restype = ctypes.c_int
        _GD_LIB = lib
    return _GD_LIB


def _gd_kernel(u, dy, key, p):
    """One launch of the forward (``dy`` None) or the backward kernel."""
    global gd_launches, gd_bwd_launches
    what = "gelu_dropout" if dy is None else "gelu_dropout_bwd"
    tensors = (u,) if dy is None else (u, dy)
    for t in tensors:
        if t.dtype not in _DTYPES:
            raise MXNetError(f"{what} kernel takes float32/bfloat16, got "
                             f"{t.dtype}")
    if dy is not None and (dy.shape != u.shape or dy.dtype != u.dtype):
        raise MXNetError(f"{what}: dy {tuple(dy.shape)} {dy.dtype} must "
                         f"match u {tuple(u.shape)} {u.dtype}")
    u = _build.aligned(u)
    out = torch.empty_like(u)
    if u.numel() == 0:
        return out
    drop = 0 < p
    lib = _gd_lib()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    if dy is not None:
        dy = _build.aligned(dy)
    with torch.cuda.device(u.device):
        args = ((u.data_ptr(), out.data_ptr()) if dy is None else
                   (u.data_ptr(), dy.data_ptr(), out.data_ptr()))
        if isinstance(key, DeviceKey) and drop:
            entry = (lib.mx_gelu_dropout_fwd_dk if dy is None
                     else lib.mx_gelu_dropout_bwd_dk)
            err = entry(_DTYPES[u.dtype], *args, u.numel(),
                        site_key_ptr(key, u.device), threshold(p),
                        dropout_scale(p), stream)
        else:
            key_args = ((int(key[0]), int(key[1]), threshold(p),
                         dropout_scale(p)) if drop else (0, 0, 0, 1.0))
            entry = (lib.mx_gelu_dropout_fwd if dy is None
                     else lib.mx_gelu_dropout_bwd)
            err = entry(_DTYPES[u.dtype], *args, u.numel(), int(drop),
                        *key_args, stream)
    _build.check(lib, err, what)
    if dy is None:
        gd_launches += 1
    else:
        gd_bwd_launches += 1
    return out


def gelu_dropout_fwd(u, key, p, impl="auto"):
    """``dropout_p(gelu(u))`` (exact erf gelu) under ``key`` (two uint32
    words, unused at p = 0), no gradient. ``impl``: "auto" launches the
    kernel for a CUDA tensor and runs the plain version for a CPU tensor;
    "kernel" requires a CUDA tensor; "plain" forces the plain version."""
    _check_p(p, "gelu_dropout")
    plain = _build.use_plain("gelu_dropout", u, impl)
    if p == 1:
        return torch.zeros_like(u)
    return plain_gelu_dropout(u, key, p) if plain else _gd_kernel(
        u, None, key, p)


def gelu_dropout_bwd(u, dy, key, p, impl="auto"):
    """du of :func:`gelu_dropout_fwd` at the forward's u and key."""
    _check_p(p, "gelu_dropout")
    plain = _build.use_plain("gelu_dropout_bwd", u, impl)
    if p == 1:
        return torch.zeros_like(u)
    return plain_gelu_dropout_bwd(u, dy, key, p) if plain else _gd_kernel(
        u, dy, key, p)


class _GeluDropout(torch.autograd.Function):
    """Saves u and the key; the backward recomputes mask and gelu'(u)."""

    @staticmethod
    def forward(ctx, u, key, p, impl):
        ctx.save_for_backward(u)
        ctx.key, ctx.p, ctx.impl = key, p, impl
        return gelu_dropout_fwd(u, key, p, impl)

    @staticmethod
    def backward(ctx, dy):
        (u,) = ctx.saved_tensors
        return (gelu_dropout_bwd(u, dy, ctx.key, ctx.p, ctx.impl), None,
                None, None)


def gelu_dropout(u, key, p, impl="auto"):
    """``dropout_p(gelu(u))`` with the exact erf gelu, one fused pass each
    way; differentiable. Any shape (the mask follows the flat index);
    ``key`` two uint32 words (a fresh framework key per call). An empty
    ``u`` is returned as it is."""
    p = float(p)
    _check_p(p, "gelu_dropout")
    if u.numel() == 0:
        return u
    if torch.is_grad_enabled() and u.requires_grad:
        return _GeluDropout.apply(u, key, p, impl)
    return gelu_dropout_fwd(u, key, p, impl)
