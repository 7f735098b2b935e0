"""Basic layers (port of `incubator_mxnet_tpu/gluon/nn/basic_layers.py`).

The reference's layers, line for line: `Parameter`s with deferred shapes
(``in_units``/``in_channels`` 0 are inferred at the first call, in either
calling convention), the reference's default initializers (weights
`Uniform` ±0.07 unless ``weight_initializer`` says otherwise, biases and
betas zero, gammas one), ``npx`` ops in ``forward``.

The port's extras: ``device=`` places a layer's parameters when
``initialize()`` is given no device (default: the current device), and
``impl=`` ("auto" | "kernel" | "plain") is handed to the kernels'
wrappers of `LayerNorm` and `Dropout`, so a model on the card can run
the plain versions its kernels are held against. Dropout applies where
``autograd.is_training()`` says, as in the reference.

Under AMP (`amp.init("bfloat16")`) ``Dense`` and ``Embedding`` take their
inputs as the reference's "fully_connected" and "embedding" ops do:
float32 inputs, weight and bias cast to bfloat16; the norms
(``BatchNorm``, ``GroupNorm``, ``InstanceNorm``) compute in float32.

``BatchNorm``'s running statistics are Parameters with ``grad_req``
"null" (their tensors do not require a gradient, so no optimizer sees
them); a training call updates them in place (`npx.batch_norm`), once a
call, eager or replayed in a captured graph.
"""
from __future__ import annotations

import torch

from ... import numpy_extension as npx
from ...base import MXNetError
from ..block import Block, HybridBlock
from ..parameter import Parameter

__all__ = [
    "Sequential", "HybridSequential", "Dense", "Dropout", "Flatten",
    "BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm", "Embedding",
    "Lambda", "HybridLambda", "Identity", "Concatenate", "HybridConcatenate",
]

def _place(device, *params):
    for p in params:
        if p is not None:
            p._device_hint = device


class Sequential(Block):
    """Stack of blocks (reference: basic_layers.py Sequential)."""

    def __init__(self):
        super().__init__()
        self._layers = []

    def add(self, *blocks):
        for b in blocks:
            self._layers.append(b)
            self.register_child(b)

    def forward(self, x, *args):
        for block in self._layers:
            x = block(x, *args)
            args = ()
        return x

    def __len__(self):
        return len(self._layers)

    def __getitem__(self, key):
        if isinstance(key, slice):
            net = type(self)()
            net.add(*self._layers[key])
            return net
        return self._layers[key]

    def __iter__(self):
        return iter(self._layers)

    def hybridize(self, active=True, **kwargs):
        for b in self._layers:
            b.hybridize(active, **kwargs)


class HybridSequential(HybridBlock):
    def __init__(self):
        super().__init__()
        self._layers = []

    def add(self, *blocks):
        for b in blocks:
            self._layers.append(b)
            self.register_child(b)

    def forward(self, x, *args):
        for block in self._layers:
            x = block(x, *args)
            args = ()
        return x

    def __len__(self):
        return len(self._layers)

    def __getitem__(self, key):
        if isinstance(key, slice):
            net = type(self)()
            net.add(*self._layers[key])
            return net
        return self._layers[key]

    def __iter__(self):
        return iter(self._layers)


class Dense(HybridBlock):
    """Fully-connected layer: ``y = act(x @ weight.T + bias)`` with weight
    ``(units, in_units)``; ``flatten=True`` collapses all but the first
    axis of the input first. Under AMP x, weight and bias are cast to
    bf16 and the bias is added inside the product (``F.linear``, one
    rounding of x @ W.T + b), where the reference rounds the product and
    then the sum."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None, bias_initializer="zeros",
                 in_units=0, device=None):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self.act = Activation(activation) if activation else None
        self.weight = Parameter(shape=(units, in_units), dtype=dtype,
                                init=weight_initializer, allow_deferred_init=True)
        self.bias = Parameter(shape=(units,), dtype=dtype,
                              init=bias_initializer,
                              allow_deferred_init=True) if use_bias else None
        _place(device, self.weight, self.bias)
        if self.act is not None:
            self.register_child(self.act, "act")

    def infer_shape(self, x, *args):
        size = x.numel() if isinstance(x, torch.Tensor) else x.size
        in_units = size // x.shape[0] if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)
        if self.bias is not None:
            self.bias.shape = (self._units,)

    def forward(self, x):
        out = npx.fully_connected(
            x, self.weight.data(), None if self.bias is None else self.bias.data(),
            num_hidden=self._units, no_bias=self.bias is None,
            flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return f"Dense({self._units}, flatten={self._flatten})"


class Dropout(HybridBlock):
    """Dropout with drop probability ``rate`` where ``autograd.is_training()``
    (the dropout kernel for CUDA tensors), else the identity."""

    def __init__(self, rate, axes=(), impl="auto"):
        super().__init__()
        self._rate = rate
        self._axes = axes
        self._impl = impl

    def forward(self, x):
        return npx.dropout(x, p=self._rate, axes=self._axes, impl=self._impl)

    def __repr__(self):
        return f"Dropout(p={self._rate})"


class Flatten(HybridBlock):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class _NormBase(HybridBlock):
    def __init__(self, in_channels, scale=True, center=True, dtype="float32",
                 gamma_initializer="ones", beta_initializer="zeros"):
        super().__init__()
        self.gamma = Parameter(shape=(in_channels,), dtype=dtype,
                               init=gamma_initializer, allow_deferred_init=True,
                               differentiable=scale)
        self.beta = Parameter(shape=(in_channels,), dtype=dtype,
                              init=beta_initializer, allow_deferred_init=True,
                              differentiable=center)


class BatchNorm(_NormBase):
    """Batch normalisation over every axis but ``axis`` with running
    statistics (reference: basic_layers.py BatchNorm): batch statistics
    in training (``autograd.is_training()``), the running ones otherwise
    or with ``use_global_stats``; ``scale=False`` fixes gamma at one."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0,
                 dtype="float32", **kwargs):  # noqa: ARG002
        super().__init__(in_channels, scale, center, dtype)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._use_global_stats = use_global_stats
        self._scale = scale
        self.running_mean = Parameter(shape=(in_channels,), dtype=dtype,
                                      init="zeros", allow_deferred_init=True,
                                      differentiable=False)
        self.running_var = Parameter(shape=(in_channels,), dtype=dtype,
                                     init="ones", allow_deferred_init=True,
                                     differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def forward(self, x):
        return npx.batch_norm(
            x, self.gamma.data(), self.beta.data(), self.running_mean.data(),
            self.running_var.data(), eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale, use_global_stats=self._use_global_stats,
            axis=self._axis)

    def __repr__(self):
        return (f"BatchNorm(axis={self._axis}, eps={self._epsilon}, "
                f"momentum={self._momentum})")


class LayerNorm(HybridBlock):
    """Layer norm over ``axis`` with learned ``gamma``/``beta``
    (``npx.layer_norm``: the LayerNorm kernel for CUDA tensors)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 in_channels=0, dtype="float32", device=None, impl="auto",
                 **kwargs):  # noqa: ARG002
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        self._impl = impl
        self.gamma = Parameter(shape=(in_channels,), dtype=dtype, init="ones",
                               allow_deferred_init=True, differentiable=scale)
        self.beta = Parameter(shape=(in_channels,), dtype=dtype, init="zeros",
                              allow_deferred_init=True, differentiable=center)
        _place(device, self.gamma, self.beta)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def forward(self, x):
        return npx.layer_norm(x, self.gamma.data(), self.beta.data(),
                              axis=self._axis, eps=self._epsilon,
                              impl=self._impl)


class GroupNorm(HybridBlock):
    """Normalisation over groups of channels and the spatial axes of each
    sample (reference: basic_layers.py GroupNorm)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 in_channels=0, dtype="float32", **kwargs):  # noqa: ARG002
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.gamma = Parameter(shape=(in_channels,), dtype=dtype, init="ones",
                               allow_deferred_init=True, differentiable=scale)
        self.beta = Parameter(shape=(in_channels,), dtype=dtype, init="zeros",
                              allow_deferred_init=True, differentiable=center)

    def infer_shape(self, x, *args):
        c = x.shape[1]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def forward(self, x):
        return npx.group_norm(x, self.gamma.data(), self.beta.data(),
                              num_groups=self._num_groups, eps=self._epsilon)


class InstanceNorm(HybridBlock):
    """Normalisation over the spatial axes of each sample and channel
    (reference: basic_layers.py InstanceNorm; its ``axis`` is taken and,
    as there, unused)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 in_channels=0, dtype="float32", **kwargs):  # noqa: ARG002
        super().__init__()
        self._epsilon = epsilon
        self.gamma = Parameter(shape=(in_channels,), dtype=dtype, init="ones",
                               allow_deferred_init=True, differentiable=scale)
        self.beta = Parameter(shape=(in_channels,), dtype=dtype, init="zeros",
                              allow_deferred_init=True, differentiable=center)

    def infer_shape(self, x, *args):
        c = x.shape[1]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def forward(self, x):
        return npx.instance_norm(x, self.gamma.data(), self.beta.data(),
                                 eps=self._epsilon)


class Embedding(HybridBlock):
    """Index → vector lookup with weight ``(input_dim, output_dim)``.
    Under AMP the whole table is cast to bf16 and then gathered, as the
    reference's funnel casts it, so the backward adds bf16 cotangents.
    ``sparse_grad=True`` (row-sparse gradients) raises."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, device=None,
                 **kwargs):  # noqa: ARG002
        super().__init__()
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True): row-sparse "
                             "gradients are not ported (ROADMAP.md §1 item "
                             "11, ndarray/sparse.py)")
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        self.weight = Parameter(shape=(input_dim, output_dim), dtype=dtype,
                                init=weight_initializer)
        _place(device, self.weight)

    def forward(self, x):
        return npx.embedding(x, self.weight.data(), input_dim=self._input_dim,
                             output_dim=self._output_dim,
                             sparse_grad=self._sparse_grad)


class Lambda(Block):
    def __init__(self, function):
        super().__init__()
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    def __init__(self, function):
        super().__init__()
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class Identity(HybridBlock):
    def forward(self, x):
        return x


def _concat(outs, axis):
    from ...ndarray.ndarray import NDArray

    if any(isinstance(o, NDArray) for o in outs):
        from ... import numpy as np

        return np.concatenate(outs, axis=axis)
    return torch.cat(outs, dim=axis)


class Concatenate(Sequential):
    """Run children on the same input, concat outputs along `axis`."""

    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return _concat([block(x) for block in self._layers], self._axis)


class HybridConcatenate(HybridSequential):
    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return _concat([block(x) for block in self._layers], self._axis)


from .activations import Activation  # noqa: E402  (used by Dense)
