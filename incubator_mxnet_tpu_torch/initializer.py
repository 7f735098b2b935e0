"""Weight initializers (port of `incubator_mxnet_tpu/initializer.py`).

The reference's registry and name-suffix dispatch: a parameter whose name
ends in ``bias``, ``beta``, ``running_mean``/``moving_mean`` is zeroed and
one ending in ``gamma``, ``running_var``/``moving_var`` set to one unless
the initializer is asked for that parameter by name (`Parameter.init`).

An initializer fills its NDArray's tensor in place under
``torch.no_grad()``. Random draws come from a `torch.Generator` on the
tensor's device seeded from the framework's key stream
(:func:`random.host_seed`), so ``mx.random.seed(s)`` followed by
``initialize()`` draws the same weights every time. The bits are not the
reference's (Philox against threefry): the laws are, and the tests hold
the bounds, moments and scales. Inside :func:`generator_scope` every draw
comes from the one generator given, in call order.
"""
from __future__ import annotations

import math
import threading

import numpy as onp
import torch

from . import random as _random

__all__ = [
    "Initializer", "Zero", "One", "Constant", "Uniform", "Normal", "Orthogonal",
    "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias", "register", "create",
]

_REGISTRY: dict = {}


class _Scope(threading.local):
    def __init__(self):
        self.generator = None


_SCOPE = _Scope()


class generator_scope:
    """Every draw of an initializer inside the scope comes from
    ``generator``, in call order (a model made from a seed)."""

    def __init__(self, generator):
        self._gen = generator

    def __enter__(self):
        self._prev, _SCOPE.generator = _SCOPE.generator, self._gen
        return self._gen

    def __exit__(self, *exc):
        _SCOPE.generator = self._prev
        return False


def _generator(t):
    """The generator a draw into tensor ``t`` takes."""
    if _SCOPE.generator is not None:
        return _SCOPE.generator
    gen = torch.Generator(device=t.device)
    gen.manual_seed(_random.host_seed())
    return gen


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    if name is None:
        return Uniform()
    if callable(name) and not isinstance(name, type):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown initializer {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


class Initializer:
    """Base initializer. Call with (name, NDArray) to fill in place."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr):
        self.init_weight(name, arr)

    def init_weight(self, name, arr):
        name = name or ""
        if name.endswith("bias"):
            self._init_zero(arr)
        elif name.endswith("gamma"):
            self._init_one(arr)
        elif name.endswith("beta"):
            self._init_zero(arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(arr)
        else:
            self._init_weight(name, arr)

    # -- default fills ------------------------------------------------------
    def _init_zero(self, arr):
        with torch.no_grad():
            arr._data.zero_()

    def _init_one(self, arr):
        with torch.no_grad():
            arr._data.fill_(1.0)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


def _fill(arr, values):
    """Copy ``values`` (a tensor or a numpy array) into ``arr``'s tensor."""
    t = arr._data
    if not isinstance(values, torch.Tensor):
        values = torch.from_numpy(onp.ascontiguousarray(values))
    with torch.no_grad():
        t.copy_(values.reshape(t.shape))


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        self._init_zero(arr)


Zeros = Zero
_REGISTRY["zeros"] = Zero


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(arr)


Ones = One
_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        v = self.value
        if hasattr(v, "asnumpy"):
            v = v.asnumpy()
        t = arr._data
        with torch.no_grad():
            t.copy_(torch.as_tensor(onp.asarray(v, onp.float32)
                                    if not isinstance(v, torch.Tensor) else v)
                    .to(t.dtype).expand(t.shape))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        t = arr._data
        with torch.no_grad():
            t.uniform_(-self.scale, self.scale, generator=_generator(t))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        t = arr._data
        with torch.no_grad():
            t.normal_(0.0, self.sigma, generator=_generator(t))


@register
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        t = arr._data
        nout = t.shape[0]
        nin = int(onp.prod(t.shape[1:])) if t.dim() > 1 else 1
        tmp = torch.empty((nout, nin), dtype=torch.float32, device=t.device)
        gen = _generator(t)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        _fill(arr, (self.scale * q).to(t.dtype))


@register
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        t = arr._data
        shape = tuple(t.shape)
        hw_scale = 1.0
        if len(shape) < 2:
            raise ValueError(f"Xavier requires ndim >= 2, got shape {shape} for {name}")
        if len(shape) > 2:
            hw_scale = float(onp.prod(shape[2:]))
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        with torch.no_grad():
            if self.rnd_type == "uniform":
                t.uniform_(-scale, scale, generator=_generator(t))
            else:
                t.normal_(0.0, scale, generator=_generator(t))


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    def _init_weight(self, name, arr):
        shape = tuple(arr._data.shape)
        weight = onp.zeros(int(onp.prod(shape)), dtype="float32")
        f = onp.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(onp.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        _fill(arr, weight.reshape(shape))


@register
class LSTMBias(Initializer):
    """Initialize LSTM biases with forget-gate bias = forget_bias."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        t = arr._data
        num_hidden = t.shape[0] // 4
        with torch.no_grad():
            t.zero_()
            t[num_hidden:2 * num_hidden] = self.forget_bias


class InitDesc(str):
    """Parameter-name descriptor carrying init attrs (reference parity)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj
