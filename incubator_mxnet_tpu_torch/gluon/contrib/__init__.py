"""gluon.contrib (port of `incubator_mxnet_tpu/gluon/contrib/__init__.py`):
the composable vision loader and the Estimator. The reference's `MoEFFN`
is `ROADMAP.md` §1 item 11b."""
from . import data, estimator

__all__ = ["estimator", "data"]
