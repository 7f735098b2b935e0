"""gluon.contrib.data (reference: `python/mxnet/gluon/contrib/data/`)."""
from . import vision  # noqa: F401
