"""``mx.npx`` operators of the port: the ones the serving and training
slices call.

Port of `incubator_mxnet_tpu/numpy_extension/__init__.py` (`activation`
:168, `layer_norm` :591, `dropout` :699, `flash_attention` :834,
`residual_dropout_ln` :860) over torch tensors.

Dropout applies when the caller says it is training (``training=True``;
the layers pass their module's ``training`` flag, the port's counterpart
of the reference's ``autograd.is_training()``) or with
``mode="always"``. Each application draws a fresh key from
:func:`random.next_key`.

``impl`` ("auto" | "kernel" | "plain") is handed to the kernels'
wrappers: "auto" launches the kernel for a CUDA tensor and runs the plain
version for a CPU tensor; "plain" runs the plain version on any device,
which is how a model on the card is held against its kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from ..ops import dropout as _dp
from ..ops import flash_attention as _fa
from ..ops import fused_block as _fb
from ..ops import layer_norm as _ln

__all__ = ["activation", "layer_norm", "dropout", "flash_attention",
           "residual_dropout_ln"]

_ACTIVATIONS = {
    # the reference calls jax.nn.gelu, whose default is the tanh
    # approximation; PyTorch's default is the exact erf form
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
}


def activation(data, act_type="relu", **kwargs):  # noqa: ARG001
    """``act_type`` "gelu" (the tanh approximation, as the reference's) or
    "tanh", the activations the ported models call. The reference's other
    activations are ported with the slice that first calls them."""
    if act_type not in _ACTIVATIONS:
        raise ValueError(f"activation {act_type!r} is not ported; the port "
                         f"has {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[act_type](data)


def layer_norm(data, gamma=None, beta=None, axis=-1, eps=1e-5, impl="auto",
               **kwargs):  # noqa: ARG001
    """Layer norm over ``axis`` with f32 statistics, output in the input
    dtype; differentiable.

    Over the last axis it is `ops.layer_norm` (forward and backward): a
    CUDA tensor goes to the LayerNorm kernels (the gate of the reference,
    re-keyed from "the backend is a TPU" to "the tensor is on the card"),
    which launch or raise :class:`MXNetError` for a feature size they do
    not take (:func:`ops.layer_norm.supports`) or gamma/beta of another
    dtype; a CPU tensor takes the plain versions. A CUDA tensor over
    another axis raises. A CPU tensor over another axis takes the composed
    ops, as the reference does off the TPU. A missing gamma or beta is
    ones or zeros."""
    last = axis in (-1, data.dim() - 1)
    if data.device.type == "cuda" and not last and impl != "plain":
        raise MXNetError(f"npx.layer_norm: the kernel normalises the "
                         f"last axis, got axis={axis} of a "
                         f"{data.dim()}-d tensor")
    if last:
        c = data.shape[-1]
        if gamma is None:
            gamma = torch.ones(c, dtype=data.dtype, device=data.device)
        if beta is None:
            beta = torch.zeros(c, dtype=data.dtype, device=data.device)
        return _ln.layer_norm(data, gamma, beta, eps=eps, impl=impl)

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


def _applies(p, mode, training):
    if mode not in ("training", "always"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    return p > 0 and (mode == "always" or training)


def dropout(data, p=0.5, axes=(), mode="training", training=False,
            impl="auto", **kwargs):  # noqa: ARG001
    """Dropout with drop probability ``p`` where it applies (``training``
    or ``mode="always"``), else the identity. A CUDA tensor goes to the
    dropout kernel (`ops/dropout.py`), which launches or raises; a CPU
    tensor takes its plain version. Broadcast masks (``axes``) are not
    ported."""
    if axes:
        raise ValueError("dropout: broadcast masks (axes) are not ported")
    if not _applies(p, mode, training):
        return data
    return _dp.dropout(data, _random.next_key(), float(p), impl=impl)


def flash_attention(query, key, value, valid_length=None, causal=False,
                    sm_scale=None, layout="bhtd", impl="auto"):
    """Fused memory-linear attention, differentiable: the kernels in
    `ops/flash_attention.py` for CUDA tensors, their plain versions for
    CPU tensors. ``valid_length``: (B,) valid sequence lengths."""
    return _fa.flash_attention(query, key, value, lengths=valid_length,
                               causal=causal, sm_scale=sm_scale, impl=impl,
                               layout=layout)


def residual_dropout_ln(x, h, gamma, beta, p=0.0, eps=1e-5, axis=-1,
                        training=False, impl="auto"):
    """``layer_norm(x + dropout_p(h))``, the post-LN transformer's residual
    site, through the fused kernels of `ops/fused_block.py` (forward and
    backward) for CUDA tensors and their plain versions for CPU tensors.

    As on the TPU, the fused op runs whether or not dropout applies: out
    of training, or at p = 0, it adds h without drawing a key. It takes
    the last axis only and same-shape x and h; a CUDA tensor it cannot
    take raises :class:`MXNetError`."""
    if axis not in (-1, x.dim() - 1):
        raise MXNetError(f"npx.residual_dropout_ln: the kernel normalises "
                         f"the last axis, got axis={axis}")
    p_eff = float(p) if training else 0.0
    key = _random.next_key() if 0 < p_eff < 1 else (0, 0)
    return _fb.residual_dropout_ln(x, h, gamma, beta, p_eff, key, eps=eps,
                                   impl=impl)
