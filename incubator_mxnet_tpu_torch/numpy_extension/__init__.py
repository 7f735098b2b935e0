"""``mx.npx`` operators of the port: the ones the serving slice calls.

Port of `incubator_mxnet_tpu/numpy_extension/__init__.py` (`activation`
:168, `layer_norm` :591, `flash_attention` :834) over torch tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ops import flash_attention as _fa
from ..ops import layer_norm as _ln

__all__ = ["activation", "layer_norm", "flash_attention"]


def activation(data, act_type, **kwargs):  # noqa: ARG001
    """``act_type="gelu"``, the one activation the slice calls. It is the
    tanh approximation: the reference calls ``jax.nn.gelu``, whose default
    that is, and PyTorch's default is the exact erf form. The reference's
    other activations are ported with the slice that first calls them."""
    if act_type != "gelu":
        raise ValueError(f"activation {act_type!r} is not ported; the port "
                         f"has 'gelu'")
    return F.gelu(data, approximate="tanh")


def layer_norm(data, gamma=None, beta=None, axis=-1, eps=1e-5, **kwargs):  # noqa: ARG001
    """Layer norm over ``axis`` with f32 statistics, output in the input
    dtype.

    A CUDA tensor goes to the LayerNorm kernel (the gate of the reference,
    re-keyed from "the backend is a TPU" to "the tensor is on the card"),
    which launches or raises :class:`MXNetError`: for another axis than the
    last, a feature size it does not take (:func:`ops.layer_norm.supports`)
    or gamma/beta of another dtype. A missing gamma or beta is ones or
    zeros. A CPU tensor takes the composed ops, as the reference does off
    the TPU."""
    if data.device.type == "cuda":
        if axis not in (-1, data.dim() - 1):
            raise MXNetError(f"npx.layer_norm: the kernel normalises the "
                             f"last axis, got axis={axis} of a "
                             f"{data.dim()}-d tensor")
        c = data.shape[-1]
        if gamma is None:
            gamma = torch.ones(c, dtype=data.dtype, device=data.device)
        if beta is None:
            beta = torch.zeros(c, dtype=data.dtype, device=data.device)
        return _ln.layer_norm(data, gamma, beta, eps=eps)

    xd = data.dtype
    x = data.float()
    axis = axis % x.dim()
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    bshape = [1] * x.dim()
    bshape[axis] = -1
    if gamma is not None:
        g = gamma.float()
        out = out * (g.reshape(bshape) if g.dim() == 1 and x.dim() > 1
                     else g)
    if beta is not None:
        b = beta.float()
        out = out + (b.reshape(bshape) if b.dim() == 1 and x.dim() > 1
                     else b)
    return out.to(xd)


def flash_attention(query, key, value, valid_length=None, causal=False,
                    sm_scale=None, layout="bhtd"):
    """Fused memory-linear attention: the kernel in
    `ops/flash_attention.py` for CUDA tensors, its plain version for CPU
    tensors. ``valid_length``: (B,) valid sequence lengths."""
    return _fa.flash_attention(query, key, value, lengths=valid_length,
                               causal=causal, sm_scale=sm_scale,
                               layout=layout)
