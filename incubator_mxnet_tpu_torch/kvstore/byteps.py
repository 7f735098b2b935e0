"""BytePS-compatible kvstore facade (port of `incubator_mxnet_tpu/kvstore/
byteps.py:20`): `broadcast` must come before `pushpull` on a key, and
`pull` is unsupported, over the same all-reduce as every other store."""
from __future__ import annotations

from .base import register
from .horovod import Horovod

__all__ = ["BytePS"]


@register
class BytePS(Horovod):
    """`kv = mx.kv.create('byteps')` — push-pull store, no raw pull."""

    def pushpull(self, key, value, out=None, priority=0):
        keys = key if isinstance(key, (list, tuple)) else [key]
        for k in keys:
            if k not in self._store:
                raise ValueError(
                    f"BytePS requires broadcast(key={k!r}) before pushpull "
                    "(reference byteps.py contract)")
        return super().pushpull(key, value, out=out, priority=priority)
