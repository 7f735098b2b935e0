"""Further gluon layers (port of `incubator_mxnet_tpu/gluon/nn/
extra_layers.py`): `PixelShuffle1D/2D/3D`, `SyncBatchNorm`,
`BatchNormReLU`, `DeformableConvolution` and
`ModulatedDeformableConvolution`."""
from __future__ import annotations

from ... import numpy_extension as npx
from ...numpy_extension import _op
from ..block import HybridBlock
from ..parameter import Parameter
from .basic_layers import BatchNorm

__all__ = ["PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D",
           "SyncBatchNorm", "BatchNormReLU", "DeformableConvolution",
           "ModulatedDeformableConvolution"]


class PixelShuffle1D(HybridBlock):
    """(N, C·f, W) -> (N, C, W·f) sub-pixel upsampling."""

    def __init__(self, factor):
        super().__init__()
        self._factor = int(factor)

    def forward(self, x):
        f = self._factor

        def fn(v):
            n, cf, w = v.shape
            c = cf // f
            return v.reshape(n, c, f, w).permute(0, 1, 3, 2) \
                .reshape(n, c, w * f)

        return _op("pixel_shuffle1d", fn, x)


class PixelShuffle2D(HybridBlock):
    """(N, C·f1·f2, H, W) -> (N, C, H·f1, W·f2)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = (factor, factor) if isinstance(factor, int) \
            else tuple(factor)

    def forward(self, x):
        f1, f2 = self._factors

        def fn(v):
            n, c_all, h, w = v.shape
            c = c_all // (f1 * f2)
            v = v.reshape(n, c, f1, f2, h, w).permute(0, 1, 4, 2, 5, 3)
            return v.reshape(n, c, h * f1, w * f2)

        return _op("pixel_shuffle2d", fn, x)


class PixelShuffle3D(HybridBlock):
    """(N, C·f1·f2·f3, D, H, W) -> (N, C, D·f1, H·f2, W·f3)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = (factor,) * 3 if isinstance(factor, int) \
            else tuple(factor)

    def forward(self, x):
        f1, f2, f3 = self._factors

        def fn(v):
            n, c_all, d, h, w = v.shape
            c = c_all // (f1 * f2 * f3)
            v = v.reshape(n, c, f1, f2, f3, d, h, w) \
                .permute(0, 1, 5, 2, 6, 3, 7, 4)
            return v.reshape(n, c, d * f1, h * f2, w * f3)

        return _op("pixel_shuffle3d", fn, x)


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm. On one card the batch is the whole batch,
    so this is `BatchNorm`, as in the reference, where one compiled
    program holds the global batch; ``num_devices`` and the reference's
    other arguments are taken for the signature."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,  # noqa: ARG002
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, **kwargs):
        super().__init__(momentum=momentum, epsilon=epsilon, center=center,
                         scale=scale, use_global_stats=use_global_stats,
                         in_channels=in_channels, **kwargs)


class BatchNormReLU(BatchNorm):
    """``relu(BatchNorm(x))``."""

    def forward(self, x):
        return npx.relu(super().forward(x))


class DeformableConvolution(HybridBlock):
    """Deformable convolution v1: an inner convolution predicts each
    tap's offsets (zeros-initialised, so it starts as a plain
    convolution), then `npx.deformable_convolution` samples there."""

    _use_mask = False

    def __init__(self, channels, kernel_size=(3, 3), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), use_bias=True,
                 in_channels=0, num_deformable_group=1,
                 weight_initializer=None, bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", dtype="float32"):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size, kernel_size)
        self._channels = channels
        self._kernel = tuple(kernel_size)
        self._stride = (strides, strides) if isinstance(strides, int) \
            else tuple(strides)
        self._pad = (padding, padding) if isinstance(padding, int) \
            else tuple(padding)
        self._dilate = (dilation, dilation) if isinstance(dilation, int) \
            else tuple(dilation)
        self._groups = num_deformable_group
        kh, kw = self._kernel
        taps = self._groups * kh * kw
        self._n_off = (3 if self._use_mask else 2) * taps
        self.weight = Parameter(
            shape=(channels, in_channels, kh, kw), dtype=dtype,
            init=weight_initializer, allow_deferred_init=True)
        self.bias = Parameter(shape=(channels,), dtype=dtype,
                              init=bias_initializer) if use_bias else None
        self.offset_weight = Parameter(
            shape=(self._n_off, in_channels, kh, kw), dtype=dtype,
            init=offset_weight_initializer, allow_deferred_init=True)
        self.offset_bias = Parameter(shape=(self._n_off,), dtype=dtype,
                                     init=offset_bias_initializer)

    def infer_shape(self, x, *args):
        in_c = x.shape[1]
        kh, kw = self._kernel
        self.weight.shape = (self._channels, in_c, kh, kw)
        self.offset_weight.shape = (self._n_off, in_c, kh, kw)

    def forward(self, x):
        pred = npx.convolution(
            x, self.offset_weight.data(), self.offset_bias.data(),
            kernel=self._kernel, stride=self._stride, dilate=self._dilate,
            pad=self._pad, num_filter=self._n_off)
        kh, kw = self._kernel
        taps = self._groups * kh * kw
        if self._use_mask:
            offset = pred[:, :2 * taps]
            mask = npx.sigmoid(pred[:, 2 * taps:])
        else:
            offset, mask = pred, None
        return npx.deformable_convolution(
            x, offset, self.weight.data(),
            None if self.bias is None else self.bias.data(),
            kernel=self._kernel, stride=self._stride, pad=self._pad,
            dilate=self._dilate, num_filter=self._channels,
            num_deformable_group=self._groups,
            no_bias=self.bias is None, mask=mask)


class ModulatedDeformableConvolution(DeformableConvolution):
    """Deformable convolution v2: offsets and a sigmoid modulation a tap."""

    _use_mask = True
