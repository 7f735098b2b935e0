"""KVStore implementations (port of `incubator_mxnet_tpu/kvstore/
kvstore.py`: the single-process store :27, `KVStoreLocal` :315,
`KVStoreDevice` :320, `KVStoreDist` :336).

- ``local``/``device``: one process; the values a push brings for a key
  (a list: the per-device copies) are summed, and the reduce across
  processes is the identity.
- ``dist*``: `KVStoreDist` joins the `torch.distributed` world
  (`parallel.dist.initialize`, from `tools/launch.py`'s environment), and
  `push`/`pushpull` all-reduce (sum) across the processes; `init` and
  `broadcast` ship rank 0's value to every process. ``dist_async`` runs
  synchronously (`base.create` warns).

Row-sparse values are `ROADMAP.md` §1 item 11b's (the port has no sparse
storage): `row_sparse_pull` raises.
"""
from __future__ import annotations

import pickle

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..telemetry import tracing
from .base import KVStoreBase, register

__all__ = ["KVStore", "KVStoreLocal", "KVStoreDevice", "KVStoreDist"]


def _nd(v):
    return v if isinstance(v, NDArray) else NDArray(v)


class _SingleProcessStore(KVStoreBase):
    def __init__(self):
        self._store: dict = {}
        self._updater = None
        self._optimizer = None
        self._compression = None

    @staticmethod
    def _chaos_probe(seam):
        """Fault-injection probe at the sync point's entry, retried under
        the 'kvstore' policy (it comes before any mutation, so a retry is
        safe); the off path is one check."""
        from ..fault import injection

        if not injection.injection_enabled(seam):
            return
        from ..fault.retry import RetryPolicy

        RetryPolicy.from_env("kvstore").call(injection.inject_at, seam)

    def set_gradient_compression(self, compression_params):
        """Compress the push leg (reference: kvstore.py
        set_gradient_compression)."""
        from . import compression

        self._compression = compression.create(compression_params)

    def _maybe_compress(self, key, value):
        if self._compression is None or not isinstance(value, NDArray):
            return value
        return self._compression.compress(key, value)

    # -- legacy init/push/pull ---------------------------------------------
    def init(self, key, value):
        keys = key if isinstance(key, (list, tuple)) else [key]
        values = value if isinstance(value, (list, tuple)) else [value]
        for k, v in zip(keys, values):
            self._store[k] = _nd(v).copy()

    def push(self, key, value, priority=0):  # noqa: ARG002
        with tracing.span("kvstore.push"):
            self._push_impl(key, value)

    def _aggregate(self, k, v):
        vs = v if isinstance(v, (list, tuple)) else [v]
        agg = _nd(vs[0])
        for extra in vs[1:]:
            agg = agg + extra
        return self._reduce(self._maybe_compress(k, agg))

    def _push_impl(self, key, value):
        self._chaos_probe("kvstore_push")
        if isinstance(key, (list, tuple)):
            keys, values = key, value
        else:
            # a scalar key: a list value is the per-device copies of it
            keys, values = [key], [value]
        for k, v in zip(keys, values):
            agg = self._aggregate(k, v)
            if self._updater is not None and k in self._store:
                self._updater(k, agg, self._store[k])
            elif k in self._store:
                self._store[k]._set_data(agg._data.detach().clone())
            else:
                self._store[k] = agg.copy()

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):  # noqa: ARG002
        raise MXNetError("KVStore.row_sparse_pull: sparse storage is not "
                         "ported yet (ROADMAP.md §1 item 11b)")

    def pull(self, key, out=None, priority=0, ignore_sparse=True):  # noqa: ARG002
        with tracing.span("kvstore.pull"):
            self._chaos_probe("kvstore_pull")
            if isinstance(key, (list, tuple)):
                keys, outs = key, out if out is not None \
                    else [None] * len(key)
            else:
                keys, outs = [key], [out]
            results = []
            for k, o in zip(keys, outs):
                v = self._store[k]
                targets = o if isinstance(o, (list, tuple)) else [o]
                for t in targets:
                    if t is not None:
                        t._set_data(v._data.detach().clone().to(
                            t._data.device))
                results.append(v)
            return results if isinstance(key, (list, tuple)) else results[0]

    def pushpull(self, key, value, out=None, priority=0):  # noqa: ARG002
        """All-reduce: push and pull fused (reference: kvstore.h:58). For
        one key, ``value`` may be a list of per-device copies: they are
        summed, and the result is written to every entry of ``out`` (to
        the first value when ``out`` is None)."""
        with tracing.span("kvstore.pushpull"):
            self._pushpull_impl(key, value, out)

    def _pushpull_impl(self, key, value, out):
        self._chaos_probe("kvstore_push")
        if not isinstance(key, (list, tuple)):
            key, value, out = [key], [value], [out]
        elif out is None:
            out = [None] * len(key)
        for k, v, o in zip(key, value, out):
            vs = v if isinstance(v, (list, tuple)) else [v]
            targets = o if isinstance(o, (list, tuple)) else [o]
            red = self._aggregate(k, vs)
            for t in targets:
                if t is not None:
                    t._set_data(red._data.detach().clone().to(
                        t._data.device))
            if all(t is None for t in targets) and isinstance(vs[0], NDArray):
                vs[0]._set_data(red._data.detach().clone())

    def broadcast(self, key, value, out=None, priority=0):  # noqa: ARG002
        self.init(key, value)
        if out is not None:
            self.pull(key, out)

    def _reduce(self, value):
        return value

    def barrier(self):
        with tracing.span("kvstore.barrier"):
            self._chaos_probe("kvstore_barrier")

    # -- optimizer on kvstore ----------------------------------------------
    def set_optimizer(self, optimizer):
        from ..optimizer import get_updater

        self._optimizer = optimizer
        self._updater = get_updater(optimizer)

    def set_updater(self, updater):
        self._updater = updater

    @staticmethod
    def is_capable(capability):
        return capability in ("optimizer",)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        state = self._updater.get_states(dump_optimizer) if self._updater \
            else pickle.dumps({})
        with open(fname, "wb") as f:
            f.write(state)

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            data = f.read()
        if self._updater is not None:
            self._updater.set_states(data)


@register
class KVStoreLocal(_SingleProcessStore):
    """type='local' — one process's aggregation (identity reduce)."""


@register
class KVStoreDevice(_SingleProcessStore):
    """type='device'/'nccl' — one process: a single value is already the
    same for every consumer, so the reduce is the identity by design; the
    per-device copies of a key are summed in push/pushpull."""

    def _reduce(self, value):
        return value


@register
class KVStoreDist(_SingleProcessStore):
    """type='dist*' — data parallel across processes.

    Joins the world on construction (`parallel.dist.initialize`: the
    reference's environment names). `pushpull`/`push` sum across the
    processes with an all-reduce, retried under the 'kvstore' policy (it
    is idempotent); `init`/`broadcast` ship rank 0's value to every
    process. 'dist_async' runs synchronously."""

    def __init__(self):
        super().__init__()
        from ..parallel import dist

        dist.initialize()
        self._dist = dist

    @property
    def rank(self):
        return self._dist.rank()

    @property
    def num_workers(self):
        return self._dist.num_processes()

    def _reduce(self, value):
        if self._dist.num_processes() == 1 or not isinstance(value, NDArray):
            return value
        from ..fault.retry import RetryPolicy

        return NDArray(RetryPolicy.from_env("kvstore").call(
            self._dist.allreduce, value._data, op="sum"))

    def init(self, key, value):
        keys = key if isinstance(key, (list, tuple)) else [key]
        values = value if isinstance(value, (list, tuple)) else [value]
        for k, v in zip(keys, values):
            arr = _nd(v)
            if self._dist.num_processes() > 1:
                arr = NDArray(self._dist.broadcast(arr._data, root=0))
            self._store[k] = arr.copy()

    def barrier(self):
        from .. import profiler
        from ..fault.retry import RetryPolicy
        from ..telemetry import monitor as _telem_monitor

        with tracing.span("kvstore.barrier", dist=True):
            self._chaos_probe("kvstore_barrier")
            # the sync point doubles as the command channel: queued
            # profile_process='server' commands ship and apply here, and
            # the rank-stat summaries ride the same exchange
            profiler.sync_remote_commands()
            _telem_monitor.sync_rank_stats()
            RetryPolicy.from_env("kvstore").call(self._dist.barrier)


KVStore = KVStoreLocal
