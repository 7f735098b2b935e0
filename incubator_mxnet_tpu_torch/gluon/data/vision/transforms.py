"""Vision transforms (port of `incubator_mxnet_tpu/gluon/data/vision/
transforms.py`).

A transform takes an HWC image (or an NHWC batch) as an NDArray or a
numpy array and computes on host numpy in float32, as the reference's
ops compute in float32; the result is an NDArray on the input's device
(a numpy array for a numpy input). The random transforms draw from
Python's `random` in the reference's order, so under the same seed they
crop, flip and jitter alike. Resizing is the reference's bilinear
(`jax.image.resize(method="bilinear")`, antialiased when shrinking)
through `image._resize_weights`, cast back to the input's dtype.
"""
from __future__ import annotations

import numpy as onp

from ....ndarray.ndarray import NDArray
from ...nn.basic_layers import HybridSequential
from ...block import Block, HybridBlock

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "CropResize", "RandomCrop"]


def _host(x):
    return x.asnumpy() if isinstance(x, NDArray) else onp.asarray(x)


def _like(x, v):
    """``v`` (numpy) as ``x`` came: an NDArray on its device, or numpy."""
    if isinstance(x, NDArray):
        return NDArray(onp.ascontiguousarray(v), device=x.device)
    return v


def _apply(x, fn):
    return _like(x, fn(_host(x)))


def _f32(v):
    """The reference's promotion of an image to float32 before float
    arithmetic (an integer image times a Python float is float32)."""
    return v if v.dtype == onp.float32 else v.astype(onp.float32)


def _resize_hwc(v, size):
    """Bilinear resize of an HWC image or NHWC batch to ``size`` ((W, H)
    or an int for both) in float32, cast back to ``v``'s dtype."""
    from ....image import _resize_weights

    h, w = (size, size) if isinstance(size, int) else (size[1], size[0])
    x = v.astype(onp.float32)
    wh = _resize_weights(x.shape[-3], h)
    ww = _resize_weights(x.shape[-2], w)
    out = onp.einsum("ij,...jkc->...ikc", wh, x)
    out = onp.einsum("kj,...ijc->...ikc", ww, out)
    return out.astype(v.dtype)


class Compose(HybridSequential):
    def __init__(self, transforms=None):
        super().__init__()
        for t in transforms or []:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] → CHW float32 [0,1] (reference: transforms ToTensor)."""

    def forward(self, x):
        def f(v):
            v = v.astype(onp.float32) / onp.float32(255.0)
            if v.ndim == 3:
                return onp.transpose(v, (2, 0, 1))
            return onp.transpose(v, (0, 3, 1, 2))

        return _apply(x, f)


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = onp.asarray(mean, dtype="float32")
        self._std = onp.asarray(std, dtype="float32")

    def forward(self, x):
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return _apply(x, lambda v: (_f32(v) - mean) / std)


class Resize(HybridBlock):
    """Resize to (W, H); int size + keep_ratio=True resizes the SHORTER
    edge to `size` preserving aspect (reference transforms.Resize)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):  # noqa: ARG002
        super().__init__()
        self._size = size
        self._keep = keep_ratio and isinstance(size, int)

    def forward(self, x):
        if self._keep:
            h, w = x.shape[-3], x.shape[-2]
            s = self._size
            tw, th = (s, s * h // w) if h > w else (s * w // h, s)
            return _apply(x, lambda v: _resize_hwc(v, (tw, th)))
        return _apply(x, lambda v: _resize_hwc(v, self._size))


class CenterCrop(HybridBlock):
    def __init__(self, size, interpolation=1):  # noqa: ARG002
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        w, h = self._size

        def f(v):
            H, W = v.shape[-3], v.shape[-2]
            y0 = max((H - h) // 2, 0)
            x0 = max((W - w) // 2, 0)
            out = v[..., y0:y0 + h, x0:x0 + w, :]
            if out.shape[-3] != h or out.shape[-2] != w:
                out = _resize_hwc(out, (w, h))
            return out

        return _apply(x, f)


class CropResize(HybridBlock):
    def __init__(self, x, y, width, height, size=None, interpolation=None):  # noqa: ARG002
        super().__init__()
        self._x, self._y, self._w, self._h = x, y, width, height
        self._size = size

    def forward(self, img):
        x0, y0, w, h = self._x, self._y, self._w, self._h
        size = self._size

        def f(v):
            out = v[..., y0:y0 + h, x0:x0 + w, :]
            if size is not None:
                out = _resize_hwc(out, size)
            return out

        return _apply(img, f)


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):  # noqa: ARG002
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        import math
        import random as pyrandom

        H, W = x.shape[-3], x.shape[-2]
        area = H * W
        for _ in range(10):
            target_area = pyrandom.uniform(*self._scale) * area
            log_ratio = (math.log(self._ratio[0]), math.log(self._ratio[1]))
            aspect = math.exp(pyrandom.uniform(*log_ratio))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if 0 < w <= W and 0 < h <= H:
                x0 = pyrandom.randint(0, W - w)
                y0 = pyrandom.randint(0, H - h)
                return _apply(x, lambda v: _resize_hwc(
                    v[..., y0:y0 + h, x0:x0 + w, :], self._size))
        return _apply(x, lambda v: _resize_hwc(v, self._size))


class _RandomFlip(Block):
    _axis = -2

    def forward(self, x):
        import random as pyrandom

        if pyrandom.random() < 0.5:
            return x
        ax = self._axis
        return _apply(x, lambda v: onp.flip(v, axis=ax))


class RandomFlipLeftRight(_RandomFlip):
    _axis = -2


class RandomFlipTopBottom(_RandomFlip):
    _axis = -3


class _RandomJitter(Block):
    def __init__(self, value):
        super().__init__()
        self._value = value


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        import random as pyrandom

        alpha = onp.float32(1.0 + pyrandom.uniform(-self._value,
                                                   self._value))
        return _apply(x, lambda v: _f32(v) * alpha)


class RandomContrast(_RandomJitter):
    def forward(self, x):
        import random as pyrandom

        alpha = onp.float32(1.0 + pyrandom.uniform(-self._value,
                                                   self._value))

        def f(v):
            v = _f32(v)
            gray = onp.mean(v, axis=tuple(range(v.ndim - 3, v.ndim)),
                            keepdims=True, dtype=onp.float32)
            return v * alpha + gray * (onp.float32(1) - alpha)

        return _apply(x, f)


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        import random as pyrandom

        alpha = onp.float32(1.0 + pyrandom.uniform(-self._value,
                                                   self._value))

        def f(v):
            v = _f32(v)
            gray = onp.mean(v, axis=-1, keepdims=True, dtype=onp.float32)
            return v * alpha + gray * (onp.float32(1) - alpha)

        return _apply(x, f)


class RandomCrop(Block):
    """Random spatial crop, padding when the image is smaller (reference:
    `gluon/data/vision/transforms.py` RandomCrop)."""

    def __init__(self, size, pad=None, interpolation=1):  # noqa: ARG002
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        # pad: int (all four sides) or 4-tuple (left, top, right, bottom),
        # applied to the H/W dims of an HWC image (reference RandomCrop)
        if pad is not None and not isinstance(pad, int):
            pad = tuple(pad)
            if len(pad) != 4:
                raise ValueError("RandomCrop: pad must be an int or a "
                                 "(left, top, right, bottom) 4-tuple")
        self._pad = pad

    def forward(self, x):
        import random as pyrandom

        if x.ndim != 3:
            raise ValueError(f"RandomCrop expects an HWC image, got rank "
                             f"{x.ndim}")
        w, h = self._size
        if self._pad:
            p = self._pad
            widths = ((p, p), (p, p), (0, 0)) if isinstance(p, int) else \
                ((p[1], p[3]), (p[0], p[2]), (0, 0))
            x = _apply(x, lambda v: onp.pad(v, widths))
        H, W = x.shape[-3], x.shape[-2]
        if H < h or W < w:
            return _apply(x, lambda v: _resize_hwc(v, self._size))
        y0 = pyrandom.randint(0, H - h)
        x0 = pyrandom.randint(0, W - w)
        return x[..., y0:y0 + h, x0:x0 + w, :]
