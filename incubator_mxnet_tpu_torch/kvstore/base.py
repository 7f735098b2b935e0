"""KVStore base and registry (port of `incubator_mxnet_tpu/kvstore/base.py`:
`KVStoreBase` :9, `register` :69, `create` :72), so Trainer code is
backend-agnostic."""
from __future__ import annotations

__all__ = ["KVStoreBase", "register", "create"]


class KVStoreBase:
    """Key-value store interface: broadcast / push / pull / pushpull."""

    OPTIMIZER = "optimizer"

    _registry: dict = {}

    # -- interface ----------------------------------------------------------
    def broadcast(self, key, value, out):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    def push(self, key, value, priority=0):
        raise NotImplementedError

    def pull(self, key, out=None, priority=0):
        raise NotImplementedError

    def set_optimizer(self, optimizer):
        raise NotImplementedError

    @staticmethod
    def is_capable(capability):  # noqa: ARG004
        return False

    @property
    def type(self):
        return type(self).__name__

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        pass

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise NotImplementedError

    def load_optimizer_states(self, fname):
        raise NotImplementedError

    # -- registry -----------------------------------------------------------
    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        KVStoreBase._registry[name] = klass
        return klass


register = KVStoreBase.register


def create(name="local"):
    """Create a KVStore by its type string.

    'local', 'device' (one process: the identity reduce), 'dist',
    'dist_sync', 'dist_device_sync' (the processes of a torch.distributed
    world, `parallel.dist`), 'dist_async' (accepted, warns, and runs
    synchronously: every update is a synchronous all-reduce), 'nccl' (an
    alias of 'device'), 'horovod' and 'byteps' (the facades)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    key = name.lower()
    if key.startswith("dist_async"):
        import warnings

        warnings.warn(
            f"KVStore type {name!r} runs synchronously here: every update "
            "is a synchronous all-reduce over the world, so updates are "
            "globally ordered (no stale gradients). Port scripts relying "
            "on asynchronous staleness accordingly.",
            UserWarning, stacklevel=2)
    aliases = {
        "nccl": "device",
        "dist_sync": "dist",
        "dist_device_sync": "dist",
        "dist_sync_device": "dist",
        "dist_async": "dist",
        "dist_async_device": "dist",
        "p3": "dist",
        "local_allreduce_cpu": "local",
        "local_allreduce_device": "device",
    }
    key = aliases.get(key, key)
    mapping = {"local": "kvstorelocal", "device": "kvstoredevice",
               "dist": "kvstoredist"}
    klass = KVStoreBase._registry.get(mapping.get(key, key))
    if klass is None:
        raise ValueError(f"unknown KVStore type {name!r}")
    return klass()
