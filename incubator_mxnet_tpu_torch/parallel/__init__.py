"""Parallelism (port of `incubator_mxnet_tpu/parallel/`): the compiled
training step, `DataParallel`, on one card. The mesh, the collectives
and the sharded paths are not ported yet (`ROADMAP.md` §1 item 9)."""
from .sharded import DataParallel

__all__ = ["DataParallel"]
