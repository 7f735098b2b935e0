"""gluon.contrib (port of `incubator_mxnet_tpu/gluon/contrib/__init__.py`):
the composable vision loader, the Estimator and `MoEFFN`."""
from . import data, estimator
from .moe import MoEFFN

__all__ = ["estimator", "data", "MoEFFN"]
