"""Inception v3 (port of
`incubator_mxnet_tpu/gluon/model_zoo/vision/inception.py`): BatchNorm
``epsilon=0.001``, 299 x 299 inputs, ``Dropout(0.5)`` through the dropout
kernel (K5) on the card."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ...nn.basic_layers import _concat

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Branches(HybridBlock):
    """Parallel branches concatenated on channels (the HybridConcurrent
    analogue; reference: gluon/contrib/nn/basic_layers.py HybridConcurrent)."""

    def __init__(self):
        super().__init__()
        self._order = []

    def add(self, block):
        name = f"b{len(self._order)}"
        self.register_block(name, block)
        self._order.append(name)

    def forward(self, x):
        return _concat([self._children[n](x) for n in self._order], 1)


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential()
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for channels, kernel_size, strides, padding in conv_settings:
        kw = {"channels": channels, "kernel_size": kernel_size}
        if strides is not None:
            kw["strides"] = strides
        if padding is not None:
            kw["padding"] = padding
        out.add(_make_basic_conv(**kw))
    return out


def _make_A(pool_features):
    out = _Branches()
    out.add(_make_branch(None, (64, 1, None, None)))
    out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, None, 1)))
    out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B():
    out = _Branches()
    out.add(_make_branch(None, (384, 3, 2, None)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7):
    out = _Branches()
    out.add(_make_branch(None, (192, 1, None, None)))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0))))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (192, (1, 7), None, (0, 3))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D():
    out = _Branches()
    out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
    out.add(_make_branch(None, (192, 1, None, None),
                         (192, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0)),
                         (192, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


class _SplitConcat(HybridBlock):
    """1x1 reduce then parallel (1,3)/(3,1) convs, concatenated — the E-mix
    sub-branch shape."""

    def __init__(self, reduce_settings, split_settings):
        super().__init__()
        self.reduce = (_make_branch(None, *reduce_settings)
                       if reduce_settings else None)
        self.split = _Branches()
        for setting in split_settings:
            self.split.add(_make_branch(None, setting))

    def forward(self, x):
        if self.reduce is not None:
            x = self.reduce(x)
        return self.split(x)


def _make_E():
    out = _Branches()
    out.add(_make_branch(None, (320, 1, None, None)))
    out.add(_SplitConcat([(384, 1, None, None)],
                         [(384, (1, 3), None, (0, 1)),
                          (384, (3, 1), None, (1, 0))]))
    out.add(_SplitConcat([(448, 1, None, None), (384, 3, None, 1)],
                         [(384, (1, 3), None, (0, 1)),
                          (384, (3, 1), None, (1, 0))]))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


class Inception3(HybridBlock):
    """Inception v3 (reference: inception.py:154)."""

    def __init__(self, classes=1000, **kwargs):  # noqa: ARG002
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                           strides=2))
        self.features.add(_make_basic_conv(channels=32, kernel_size=3))
        self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                           padding=1))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_basic_conv(channels=80, kernel_size=1))
        self.features.add(_make_basic_conv(channels=192, kernel_size=3))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_make_E())
        self.features.add(_make_E())
        self.features.add(nn.AvgPool2D(pool_size=8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        x = self.features(x)
        x = self.output(x.reshape((x.shape[0], -1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    """Inception v3 model (reference: inception.py:193)."""
    from . import _load_pretrained, _split_store_kwargs

    store_kw, kwargs = _split_store_kwargs(kwargs)
    net = Inception3(**kwargs)
    if pretrained:
        _load_pretrained(net, "inceptionv3", store_kw)
    return net
