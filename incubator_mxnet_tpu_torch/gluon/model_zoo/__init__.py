"""The model zoo (port of `incubator_mxnet_tpu/gluon/model_zoo/`): the
local pretrained-weight store and the vision models."""
from . import model_store  # noqa: F401
from . import vision  # noqa: F401
