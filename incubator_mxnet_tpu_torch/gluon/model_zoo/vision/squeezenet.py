"""SqueezeNet 1.0/1.1 (port of
`incubator_mxnet_tpu/gluon/model_zoo/vision/squeezenet.py`): ``ceil_mode``
max pools (the reference's "full" convention), ``Dropout(0.5)`` through
the dropout kernel (K5) on the card."""
from ... import nn
from ...block import HybridBlock


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(squeeze_channels, 1, activation="relu"))
    expand = nn.HybridConcatenate(axis=1)
    left = nn.HybridSequential()
    left.add(nn.Conv2D(expand1x1_channels, 1, activation="relu"))
    right = nn.HybridSequential()
    right.add(nn.Conv2D(expand3x3_channels, 3, padding=1, activation="relu"))
    expand.add(left)
    expand.add(right)
    out.add(expand)
    return out


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000):
        super().__init__()
        assert version in ("1.0", "1.1")
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(nn.Conv2D(96, 7, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(64, 256, 256))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_make_fire(64, 256, 256))
        else:
            self.features.add(nn.Conv2D(64, 3, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(64, 256, 256))
            self.features.add(_make_fire(64, 256, 256))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, 1, activation="relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def _squeezenet(version, pretrained, kwargs):
    from . import _load_pretrained, _split_store_kwargs

    store_kw, kwargs = _split_store_kwargs(kwargs)
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        _load_pretrained(net, f"squeezenet{version}", store_kw)
    return net


def squeezenet1_0(pretrained=False, **kwargs):
    return _squeezenet("1.0", pretrained, kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return _squeezenet("1.1", pretrained, kwargs)
