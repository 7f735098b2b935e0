"""AlexNet (port of `incubator_mxnet_tpu/gluon/model_zoo/vision/alexnet.py`).

Its two ``Dropout(0.5)`` run through the dropout kernel (K5) on the card."""
from ... import nn
from ...block import HybridBlock


class AlexNet(HybridBlock):
    def __init__(self, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(64, 11, 4, 2, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Conv2D(192, 5, padding=2, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Conv2D(384, 3, padding=1, activation="relu"))
        self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
        self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, **kwargs):
    from . import _load_pretrained, _split_store_kwargs

    store_kw, kwargs = _split_store_kwargs(kwargs)
    net = AlexNet(**kwargs)
    if pretrained:
        _load_pretrained(net, "alexnet", store_kw)
    return net
