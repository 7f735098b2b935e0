"""Basic layers (port of `incubator_mxnet_tpu/gluon/nn/basic_layers.py`).

Thin `torch.nn.Module`s with MXNet's constructor arguments and parameter
names. Shapes are given up front (``in_units``, ``in_channels``): the
port has no deferred shape inference. Parameters are created on
``device`` (default: :func:`device.default_device`, the card) and
initialised as the reference's defaults do: weights uniform in
[-0.07, 0.07], biases and betas zero, gammas one. ``reset_parameters``
takes an optional `torch.Generator` so a model can be made from a seed.

Under AMP (`amp.init("bfloat16")`) ``Dense`` and ``Embedding`` take their
inputs as the reference's "fully_connected" and "embedding" ops do
(`amp.cast_inputs`): float32 inputs, weight and bias cast to bfloat16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ... import amp
from ... import numpy_extension as npx
from ...device import resolve_device

__all__ = ["HybridSequential", "Dense", "LayerNorm", "Dropout", "Embedding"]

#: scale of the reference's default `Uniform` initializer
UNIFORM_SCALE = 0.07


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=_dtype(dtype),
                                    device=resolve_device(device)))


class HybridSequential(nn.Sequential):
    """Runs its children in order; ``add`` appends as in gluon."""

    def add(self, *blocks):
        for b in blocks:
            self.append(b)


class Dense(nn.Module):
    """Fully-connected layer: ``y = act(x @ weight.T + bias)`` with weight
    ``(units, in_units)`` and ``act`` an ``npx.activation`` type or None;
    ``flatten=True`` collapses all but the first axis of the input
    first. Under AMP x, weight and bias are cast to bf16 and the bias is
    added inside the product (``F.linear``, one rounding of x @ W.T + b),
    where the reference rounds the product and then the sum."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", in_units=0, device=None):
        super().__init__()
        if in_units <= 0:
            raise ValueError("Dense: in_units is required")
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = _param((units, in_units), dtype, device)
        if use_bias:
            self.bias = _param((units,), dtype, device)
        else:
            self.register_parameter("bias", None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.uniform_(-UNIFORM_SCALE, UNIFORM_SCALE,
                                 generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        if self._flatten:
            x = x.reshape(x.shape[0], -1)
        y = F.linear(*amp.cast_inputs("fully_connected", x, self.weight,
                                      self.bias))
        if self._activation is not None:
            y = npx.activation(y, act_type=self._activation)
        return y

    def extra_repr(self):
        return (f"{self._units}, flatten={self._flatten}, "
                f"activation={self._activation}")


class LayerNorm(nn.Module):
    """Layer norm over ``axis`` with learned ``gamma``/``beta``
    (``npx.layer_norm``: the LayerNorm kernel for CUDA tensors)."""

    def __init__(self, axis=-1, epsilon=1e-5, in_channels=0,
                 dtype="float32", device=None, impl="auto"):
        super().__init__()
        if in_channels <= 0:
            raise ValueError("LayerNorm: in_channels is required")
        self._axis = axis
        self._epsilon = epsilon
        self._impl = impl
        self.gamma = _param((in_channels,), dtype, device)
        self.beta = _param((in_channels,), dtype, device)
        self.reset_parameters()

    def reset_parameters(self, generator=None):  # noqa: ARG002 — constant
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x):
        return npx.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._epsilon, impl=self._impl)


class Dropout(nn.Module):
    """Dropout with drop probability ``rate`` in training mode
    (``npx.dropout``: the dropout kernel for CUDA tensors); the identity
    in eval mode. ``impl`` is handed to the kernel's wrapper."""

    def __init__(self, rate, axes=(), impl="auto"):
        super().__init__()
        if axes:
            raise ValueError("Dropout: broadcast masks (axes) are not "
                             "ported")
        self._rate = rate
        self._impl = impl

    def forward(self, x):
        return npx.dropout(x, p=self._rate, training=self.training,
                           impl=self._impl)

    def extra_repr(self):
        return f"p={self._rate}"


class Embedding(nn.Module):
    """Index → vector lookup with weight ``(input_dim, output_dim)``.
    Under AMP the whole table is cast to bf16 and then gathered, as the
    reference's funnel casts it, so the backward adds bf16 cotangents."""

    def __init__(self, input_dim, output_dim, dtype="float32", device=None):
        super().__init__()
        self.weight = _param((input_dim, output_dim), dtype, device)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.uniform_(-UNIFORM_SCALE, UNIFORM_SCALE,
                                 generator=generator)

    def forward(self, x):
        (weight,) = amp.cast_inputs("embedding", self.weight)
        return weight[x]
