"""Symmetric int8 quantization (port of `incubator_mxnet_tpu/contrib/
quantization.py`: `quantize_symmetric` :221, `dequantize_symmetric` :243).

Only these two helpers are ported: the serving engine's int8 KV pool
(`serve.SlotDecoder`, ``kv_dtype="int8"``) quantizes each pool page with
them. The reference's calibration and quantized blocks are not ported.

The convention is the reference's: one f32 scale per group, ``max(absmax,
1e-8) / 127``, and codes ``clip(round(x / scale), -127, 127)`` as int8,
where `torch.round` rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_symmetric", "dequantize_symmetric"]


def quantize_symmetric(x, axes, scale=None):
    """Symmetric int8 quantization of ``x``.

    ``axes`` are the reduction axes of the absmax group (a KV page's
    token x head-dim block is ``(2, 3)``); ``scale`` overrides the derived
    ``absmax / 127`` (re-quantizing into an existing page's scale), and
    then ``axes`` is unused. Returns ``(q_int8, scale)`` with ``scale``
    keeping the reduced axes as size-1 dims, so ``q * scale`` dequantizes
    by broadcast."""
    if scale is None:
        absmax = x.abs()
        if axes:
            absmax = absmax.amax(dim=tuple(axes), keepdim=True)
        scale = torch.clamp_min(absmax, 1e-8).float() / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_symmetric(q, scale, dtype=None):
    """Inverse of `quantize_symmetric`: ``q * scale`` in the scale's dtype
    (or ``dtype``)."""
    x = q.to(scale.dtype) * scale
    return x if dtype is None else x.to(dtype)
