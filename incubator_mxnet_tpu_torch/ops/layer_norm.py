"""LayerNorm forward: the hand-written CUDA kernel and its plain version.

Port of `incubator_mxnet_tpu/ops/layer_norm.py` forward (`_fwd_kernel`
:49, `_fwd` :63, public `layer_norm` :175). The kernel is
``csrc/layer_norm.cu``: one warp per row, the row held in registers, so x
is read once and y written once (the op is bound by bytes on the H100:
2 * rows * C * itemsize + 8 * rows). The backward kernel (`_bwd_kernel`
:93) belongs to the training slice; on a CUDA tensor that needs a
gradient the wrapper raises rather than return a result with no backward.

:func:`plain_layer_norm` repeats the kernel's arithmetic in PyTorch: mean
first, then the centred variance, rstd = rsqrt(var + eps), all in f32,
y in the input dtype. A wrapper uses it only for CPU tensors (or when the
caller asks for ``impl="plain"``); on a CUDA tensor ``impl="auto"``
launches the kernel or raises.

``launches`` counts kernel launches (one per call that reaches the card).
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["MAX_FEATURES", "supports", "plain_layer_norm", "layer_norm_fwd",
           "layer_norm", "launches"]

#: Largest feature size the kernel takes: 32 lanes x 32 float4 vectors
#: (f32) or 16 eight-wide vectors (bf16) held in registers per row.
MAX_FEATURES = 4096
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IMPLS = ("auto", "kernel", "plain")

launches = 0
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


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("layer_norm")
        fn = lib.mx_layer_norm_fwd
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel(x2d, gamma, beta, eps):
    global launches
    rows, feat = x2d.shape
    if x2d.dtype not in _DTYPES:
        raise MXNetError(f"layer_norm kernel takes float32/bfloat16, got "
                         f"{x2d.dtype}")
    if gamma.dtype != x2d.dtype or beta.dtype != x2d.dtype:
        raise MXNetError("layer_norm kernel: gamma/beta must have the input "
                         f"dtype {x2d.dtype}, got {gamma.dtype}/{beta.dtype}")
    if gamma.shape != (feat,) or beta.shape != (feat,):
        raise MXNetError(f"layer_norm: gamma/beta must be ({feat},), got "
                         f"{tuple(gamma.shape)}/{tuple(beta.shape)}")
    if not supports(x2d.shape, -1, feat, x2d.dtype):
        raise MXNetError(
            f"layer_norm kernel takes a feature size that is a multiple of "
            f"{16 // x2d.element_size()} and at most {MAX_FEATURES}, got "
            f"{feat}")
    if any(t.device != x2d.device for t in (gamma, beta)):
        raise MXNetError("layer_norm: x, gamma and beta must share a device")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x2d, gamma, beta)):
        raise MXNetError("layer_norm: the backward kernel is not ported "
                         "yet; call under torch.no_grad()")
    x2d, gamma, beta = _aligned(x2d), _aligned(gamma), _aligned(beta)
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
            rows, feat, float(eps), stream)
    _build.check(lib, err, "layer_norm_fwd")
    launches += 1
    return y, mean, rstd


def layer_norm_fwd(x2d, gamma, beta, eps=1e-5, impl="auto"):
    """(y, mean, rstd) of a (rows, C) tensor, the statistics f32 (rows,).

    ``impl``: "auto" launches the kernel for a CUDA tensor and runs the
    plain version for a CPU tensor; "kernel" requires a CUDA tensor;
    "plain" forces the plain version (the reference the kernel is held
    against)."""
    if impl not in _IMPLS:
        raise ValueError(f"layer_norm: unknown impl {impl!r}")
    if x2d.dim() != 2:
        raise ValueError(f"layer_norm_fwd expects (rows, C), got "
                         f"{tuple(x2d.shape)}")
    if impl == "plain" or (impl == "auto" and x2d.device.type != "cuda"):
        return plain_layer_norm(x2d, gamma, beta, eps)
    if x2d.device.type != "cuda":
        raise MXNetError("layer_norm: impl='kernel' needs a CUDA tensor")
    return _kernel(x2d, gamma, beta, eps)


def layer_norm(x, gamma, beta, eps=1e-5, impl="auto"):
    """Last-axis layer norm over a tensor of any rank (leading axes
    collapse to rows). See :func:`layer_norm_fwd` for ``impl``."""
    shape = x.shape
    y, _, _ = layer_norm_fwd(x.reshape(-1, shape[-1]), gamma, beta, eps,
                             impl=impl)
    return y.reshape(shape)
