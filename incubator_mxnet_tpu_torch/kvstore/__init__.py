"""Key-value stores (port of `incubator_mxnet_tpu/kvstore/`): `mx.kv` and
`mx.kvstore`."""
from .base import KVStoreBase, create, register  # noqa: F401
from .byteps import BytePS  # noqa: F401
from .horovod import Horovod  # noqa: F401
from .kvstore import KVStore, KVStoreDevice, KVStoreDist, KVStoreLocal  # noqa: F401
