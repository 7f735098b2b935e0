"""Dropout: the hand-written CUDA kernel and its plain version (K5).

Port of `incubator_mxnet_tpu/ops/dropout.py` (`_mask_kernel_body` :35,
`_run_kernel` :61, `_dropout_core` :84). The kernel is ``csrc/dropout.cu``:
y = x * 1/(1-p) where the element's Philox word is >= the threshold, else
0, one 16-byte vector a thread (bound by bytes on the H100:
2 * numel * itemsize). The mask is drawn from the key (`ops/_philox.py`),
never stored: as in the reference (:13-15), the backward is the same
kernel run on dy with the same key.

:func:`plain_dropout` computes the same bits and the same f32 arithmetic
in PyTorch ops. A wrapper uses it only for CPU tensors (or when the caller
asks for ``impl="plain"``); on a CUDA tensor ``impl="auto"`` launches the
kernel or raises. ``p == 0`` is the identity and launches nothing;
``p == 1`` gives zeros, as the reference's composed path does.

A key is two host words or, inside `random.trace_key_scope` (a step
replayed as a CUDA graph), an `ops._philox.DeviceKey`, whose words the
kernel reads from the card (``mx_dropout_dk``): the scope's table of
site keys, which :func:`site_key_ptr` fills with the fold kernel of
``csrc/dropout.cu`` at a chunk's first use. The plain version folds the
same words in PyTorch ops (`ops._philox.fold`), so both draw the mask the
by-value kernel draws for those words.

``launches`` counts kernel launches, forward and backward alike (one per
call that reaches the card); ``fold_launches`` the fold kernel's.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build
from ._philox import DeviceKey, dropout_scale, keep_mask, threshold

__all__ = ["plain_dropout", "dropout_fwd", "dropout", "launches",
           "fold_launches", "site_key_ptr", "KEY_CHUNK"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: site keys the fold kernel writes a launch: a step's first dropout site
#: of each chunk launches it once (BERT-base's 49 sites take one chunk)
KEY_CHUNK = 64

launches = 0
fold_launches = 0
_LIB = None


def _check_p(p):
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout: p must be in [0, 1], got {p}")


def plain_dropout(x, key, p):
    """``where(keep, x * scale, 0)`` in f32, returned in x's dtype."""
    keep = keep_mask(x.shape, key, p, device=x.device)
    scale = torch.tensor(dropout_scale(p), dtype=torch.float32)
    return torch.where(keep, x.float() * scale, 0.0).to(x.dtype)


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("dropout")
        fn = lib.mx_dropout
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_uint32, ctypes.c_uint32,
                       ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.mx_dropout_dk
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_uint32,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.mx_fold_keys
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def site_key_ptr(key, device):
    """The device address of a `DeviceKey`'s two words in its scope's
    table of site keys on ``device``. The first site of a chunk of
    :data:`KEY_CHUNK` launches the fold kernel for the chunk's sites on
    the current stream, ahead of the kernels that read them: each table
    entry is ``fold(fold(base, t), site)`` at the time the fold kernel
    runs, as `ops._philox.key_words` computes it."""
    global fold_launches
    if key.device != device:
        raise MXNetError(f"dropout: the step's key is on {key.device}, the "
                         f"tensor on {device}")
    chunk, row = divmod(key.site, KEY_CHUNK)
    table = key.tables.get(chunk)
    if table is None:
        base = key.base.to(torch.int64).contiguous()
        t = key.t.to(torch.int64).contiguous()
        table = torch.empty((KEY_CHUNK, 2), dtype=torch.int32, device=device)
        lib = _lib()
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            err = lib.mx_fold_keys(base.data_ptr(), t.data_ptr(),
                                   table.data_ptr(), chunk * KEY_CHUNK,
                                   KEY_CHUNK, stream)
        _build.check(lib, err, "fold_keys")
        fold_launches += 1
        key.tables[chunk] = table
    return table[row].data_ptr()


def _kernel(x, key, p):
    global launches
    if x.dtype not in _DTYPES:
        raise MXNetError(f"dropout kernel takes float32/bfloat16, got "
                         f"{x.dtype}")
    x = _build.aligned(x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if isinstance(key, DeviceKey):
            err = lib.mx_dropout_dk(_DTYPES[x.dtype], x.data_ptr(),
                                    y.data_ptr(), x.numel(),
                                    site_key_ptr(key, x.device),
                                    threshold(p), dropout_scale(p), stream)
        else:
            err = lib.mx_dropout(_DTYPES[x.dtype], x.data_ptr(),
                                 y.data_ptr(), x.numel(), int(key[0]),
                                 int(key[1]), threshold(p),
                                 dropout_scale(p), stream)
    _build.check(lib, err, "dropout")
    launches += 1
    return y


def dropout_fwd(x, key, p, impl="auto"):
    """Dropout of ``x`` with drop probability ``p`` under ``key`` (two
    uint32 words or a `DeviceKey`): no gradient, the function both
    directions run.

    ``impl``: "auto" launches the kernel for a CUDA tensor and runs the
    plain version for a CPU tensor; "kernel" requires a CUDA tensor;
    "plain" forces the plain version (the reference the kernel is held
    against)."""
    _check_p(p)
    plain = _build.use_plain("dropout", x, impl)
    if p == 0:
        return x
    if p == 1:
        return torch.zeros_like(x)
    return plain_dropout(x, key, p) if plain else _kernel(x, key, p)


class _Dropout(torch.autograd.Function):
    """Forward and backward are the same masked scale under one key."""

    @staticmethod
    def forward(ctx, x, key, p, impl):
        ctx.key, ctx.p, ctx.impl = key, p, impl
        return dropout_fwd(x, key, p, impl)

    @staticmethod
    def backward(ctx, dy):
        return dropout_fwd(dy, ctx.key, ctx.p, ctx.impl), None, None, None


def dropout(x, key, p, impl="auto"):
    """Differentiable dropout; see :func:`dropout_fwd`."""
    _check_p(p)
    if torch.is_grad_enabled() and x.requires_grad and 0 < p:
        return _Dropout.apply(x, key, p, impl)
    return dropout_fwd(x, key, p, impl)
