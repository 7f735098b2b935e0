"""Activation blocks (port of `incubator_mxnet_tpu/gluon/nn/activations.py`).
Each takes NDArrays or torch tensors, through the ``npx`` ops."""
from __future__ import annotations

from ... import numpy_extension as npx
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "SiLU",
           "Swish", "Mish"]


class Activation(HybridBlock):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return npx.activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return npx.leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer="zeros", in_channels=1):  # noqa: ARG002
        super().__init__()
        from ... import initializer

        self.alpha = Parameter(shape=(in_channels,),
                               init=initializer.Constant(0.25))

    def forward(self, x):
        return npx.leaky_relu(x, gamma=self.alpha.data(), act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return npx.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return npx.leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    def __init__(self, approximation="erf"):
        super().__init__()
        self._approx = approximation

    def forward(self, x):
        return npx.gelu(x, approximate=self._approx != "erf")


class SiLU(HybridBlock):
    def forward(self, x):
        return npx.activation(x, act_type="silu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        return x * npx.sigmoid(self._beta * x)


class Mish(HybridBlock):
    def forward(self, x):
        return npx.activation(x, act_type="mish")
