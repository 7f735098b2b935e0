"""The vision model zoo (port of
`incubator_mxnet_tpu/gluon/model_zoo/vision/`): AlexNet, ResNet V1/V2,
VGG, MobileNet V1/V2, SqueezeNet, DenseNet and Inception v3, with the
reference's constructors, structure and parameter names, so a reference
net's ``collect_params()`` arrays load into the port's by name.

``pretrained=True`` resolves against the local store
(`model_zoo/model_store.py`) or raises; nothing downloads. The weights
land on ``device`` (or ``ctx``) when given, else on the current device.
"""


def _split_store_kwargs(kwargs):
    """Split model-store kwargs (root/device/ctx) from model kwargs."""
    store_kw = {k: kwargs.pop(k) for k in ("root", "device", "ctx")
                if k in kwargs}
    return store_kw, kwargs


def _load_pretrained(net, name, store_kw):
    """Load weights for `name` from the local store
    (`model_zoo/model_store.py`), onto the store's ``device``/``ctx``
    or the current device."""
    from ....device import current_device
    from ..model_store import get_model_file

    device = store_kw.get("device", store_kw.get("ctx"))
    net.load_parameters(get_model_file(name, root=store_kw.get("root")),
                        device=device)
    net.reset_device(device if device is not None else current_device())


from .alexnet import AlexNet, alexnet  # noqa: F401,E402
from .inception import Inception3, inception_v3  # noqa: F401
from .mobilenet import (  # noqa: F401
    MobileNet, MobileNetV2, mobilenet0_25, mobilenet0_5, mobilenet0_75,
    mobilenet1_0, mobilenet_v2_0_25, mobilenet_v2_0_5, mobilenet_v2_0_75,
    mobilenet_v2_1_0,
)
from .resnet import (  # noqa: F401
    BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2, ResNetV1, ResNetV2,
    get_resnet, resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
    resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
    resnet152_v2,
)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .vgg import (  # noqa: F401
    VGG, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16, vgg16_bn, vgg19, vgg19_bn,
)
from .densenet import DenseNet, densenet121, densenet161, densenet169, densenet201  # noqa: F401

_models = {
    "alexnet": alexnet,
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
}


def get_model(name, **kwargs):
    name = name.lower()
    if name not in _models:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_models)}")
    return _models[name](**kwargs)
