"""Horovod-compatible kvstore facade (port of `incubator_mxnet_tpu/
kvstore/horovod.py:27`): rank, local_rank, num_workers, broadcast (rank
0's tensor wins) and pushpull over the world's all-reduce; `pull` is
unsupported and the optimizer does not run on the store, as in
Horovod."""
from __future__ import annotations

import os

from .base import register
from .kvstore import KVStoreDevice

__all__ = ["Horovod"]


@register
class Horovod(KVStoreDevice):
    """`kv = mx.kv.create('horovod')` — allreduce-only store."""

    def __init__(self):
        super().__init__()
        from ..parallel import dist

        dist.initialize()
        self._dist = dist

    @property
    def rank(self):
        return self._dist.rank()

    @property
    def local_rank(self):
        """Rank within the host: the launcher's local-rank variable where
        one is set (tools/launch.py, OpenMPI, torchrun), else the global
        rank."""
        for name in ("MXNET_LOCAL_RANK", "HOROVOD_LOCAL_RANK",
                     "OMPI_COMM_WORLD_LOCAL_RANK", "LOCAL_RANK"):
            v = os.environ.get(name)
            if v:
                try:
                    return int(v)
                except ValueError:
                    continue   # a malformed export
        return self._dist.rank()

    @property
    def num_workers(self):
        return self._dist.num_processes()

    def _reduce(self, value):
        from ..ndarray.ndarray import NDArray

        if self._dist.num_processes() > 1 and isinstance(value, NDArray):
            return NDArray(self._dist.allreduce(value._data, op="sum"))
        return super()._reduce(value)

    def init(self, key, value):
        from ..ndarray.ndarray import NDArray

        keys = key if isinstance(key, (list, tuple)) else [key]
        values = value if isinstance(value, (list, tuple)) else [value]
        for k, v in zip(keys, values):
            arr = v if isinstance(v, NDArray) else NDArray(v)
            if self._dist.num_processes() > 1:
                # rank 0's tensor wins (the Horovod broadcast contract)
                arr = NDArray(self._dist.broadcast(arr._data, root=0))
            self._store[k] = arr.copy()

    def broadcast(self, key, value, out=None, priority=0):  # noqa: ARG002
        """init (rank 0's tensor wins), then write into ``out`` directly:
        the base class routes through pull(), which this store forbids."""
        self.init(key, value)
        if out is None:
            return
        keys = key if isinstance(key, (list, tuple)) else [key]
        outs = out if isinstance(out, (list, tuple)) else [out]
        if not isinstance(key, (list, tuple)):
            outs = [out]
        for k, o in zip(keys, outs):
            v = self._store[k]
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                if t is not None:
                    t._set_data(v._data.detach().clone())

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        raise NotImplementedError(
            "Horovod kvstore does not support pull; use pushpull")

    @staticmethod
    def is_capable(capability):  # noqa: ARG004
        return False          # no optimizer on the store
