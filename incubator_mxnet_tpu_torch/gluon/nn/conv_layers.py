"""Convolution and pooling layers (port of
`incubator_mxnet_tpu/gluon/nn/conv_layers.py`: `Conv1D`-`Conv3D`, the
transposed convolutions, the max, average and global pools and
`ReflectionPad2D`).

The reference's layers, line for line, over `npx.convolution`,
`npx.deconvolution` and `npx.pooling` (cuDNN and PyTorch's pooling on the
card). ``in_channels`` 0 is inferred at the first call, in either calling
convention, as the reference's ``infer_shape`` does. A transposed
convolution's weight is (in_channels, channels / groups, *kernel), as the
reference declares it (`npx.deconvolution` says how the reference's op
reads it). Under AMP the convolutions run in the target dtype.
"""
from __future__ import annotations

from ... import numpy_extension as npx
from ..block import HybridBlock
from ..parameter import Parameter
from .activations import Activation

__all__ = [
    "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
    "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
    "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
    "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
    "ReflectionPad2D",
]


def _pair(x, n):
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 dtype="float32"):
        super().__init__()
        ndim = len(kernel_size)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = kernel_size
        self._stride = _pair(strides, ndim)
        self._pad = _pair(padding, ndim)
        self._dilate = _pair(dilation, ndim)
        self._groups = groups
        self._layout = layout
        self.act = Activation(activation) if activation else None
        wshape = (channels, in_channels // groups if in_channels else 0) + kernel_size
        self.weight = Parameter(shape=wshape, dtype=dtype,
                                init=weight_initializer, allow_deferred_init=True)
        self.bias = Parameter(shape=(channels,), dtype=dtype,
                              init=bias_initializer,
                              allow_deferred_init=True) if use_bias else None
        if self.act is not None:
            self.register_child(self.act, "act")

    def infer_shape(self, x, *args):
        c_axis = self._layout.index("C")
        in_c = x.shape[c_axis]
        self._in_channels = in_c
        self.weight.shape = (self._channels, in_c // self._groups) + self._kernel
        if self.bias is not None:
            self.bias.shape = (self._channels,)

    def forward(self, x):
        out = npx.convolution(
            x, self.weight.data(),
            None if self.bias is None else self.bias.data(),
            kernel=self._kernel, stride=self._stride, dilate=self._dilate,
            pad=self._pad, num_filter=self._channels, num_group=self._groups,
            no_bias=self.bias is None, layout=self._layout)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return (f"{type(self).__name__}({self._channels}, kernel_size="
                f"{self._kernel}, stride={self._stride})")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32"):
        super().__init__(channels, _pair(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer, dtype)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32"):
        super().__init__(channels, _pair(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer, dtype)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 dtype="float32"):
        super().__init__(channels, _pair(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer, dtype)


class _ConvTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides, padding, output_padding,
                 dilation, groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype)
        self._output_padding = _pair(output_padding, len(kernel_size))

    def infer_shape(self, x, *args):
        c_axis = self._layout.index("C")
        in_c = x.shape[c_axis]
        self._in_channels = in_c
        # transposed conv weight: (in_channels, channels//groups, *kernel)
        self.weight.shape = (in_c, self._channels // self._groups) + self._kernel
        if self.bias is not None:
            self.bias.shape = (self._channels,)

    def forward(self, x):
        out = npx.deconvolution(
            x, self.weight.data(),
            None if self.bias is None else self.bias.data(),
            kernel=self._kernel, stride=self._stride, dilate=self._dilate,
            pad=self._pad, adj=self._output_padding, num_filter=self._channels,
            num_group=self._groups, no_bias=self.bias is None,
            layout=self._layout)
        if self.act is not None:
            out = self.act(out)
        return out


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 dtype="float32"):
        super().__init__(channels, _pair(kernel_size, 1), strides, padding,
                         output_padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, dtype)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 dtype="float32"):
        super().__init__(channels, _pair(kernel_size, 2), strides, padding,
                         output_padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, dtype)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32"):
        super().__init__(channels, _pair(kernel_size, 3), strides, padding,
                         output_padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, dtype)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None):
        super().__init__()
        self._kernel = pool_size
        self._stride = _pair(strides if strides is not None else pool_size,
                             len(pool_size))
        self._pad = _pair(padding, len(pool_size))
        self._global_pool = global_pool
        self._pool_type = pool_type
        self._layout = layout
        self._count_include_pad = (True if count_include_pad is None
                                   else count_include_pad)
        self._ceil_mode = ceil_mode

    def forward(self, x):
        return npx.pooling(
            x, kernel=self._kernel, stride=self._stride, pad=self._pad,
            pool_type=self._pool_type, global_pool=self._global_pool,
            layout=self._layout, count_include_pad=self._count_include_pad,
            pooling_convention="full" if self._ceil_mode else "valid")

    def __repr__(self):
        return (f"{type(self).__name__}(size={self._kernel}, "
                f"stride={self._stride}, padding={self._pad})")


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False):
        super().__init__(_pair(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", layout)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(_pair(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", layout)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(_pair(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", layout)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True):
        super().__init__(_pair(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(_pair(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True):
        super().__init__(_pair(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW"):
        super().__init__((1,), None, 0, True, True, "max", layout)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, True, True, "max", layout)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, 0, True, True, "max", layout)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW"):
        super().__init__((1,), None, 0, True, True, "avg", layout)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, True, True, "avg", layout)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, 0, True, True, "avg", layout)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the two spatial axes of NCHW data by
    ``padding`` (an int for all four sides, or numpy-style pairs a
    axis)."""

    def __init__(self, padding=0):
        super().__init__()
        self._padding = padding

    def forward(self, x):
        p = self._padding
        pw = ((0, 0), (0, 0), (p, p), (p, p)) if isinstance(p, int) else p
        return npx.pad(x, mode="reflect",
                       pad_width=[int(v) for pair in pw for v in pair])
