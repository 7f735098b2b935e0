"""Parallelism (port of `incubator_mxnet_tpu/parallel/`): the mesh of
ranks, its collectives over `torch.distributed`, the compiled training
step (`DataParallel`, on one card or on a mesh), ring attention, the
GPipe pipeline, expert-parallel MoE and the multi-process runtime
(`dist`)."""
from . import collectives, dist, mesh, moe, pipeline  # noqa: F401
from .collectives import (  # noqa: F401
    all_gather, all_reduce, broadcast, reduce_scatter, ring_permute,
)
from .mesh import Mesh, current_mesh, make_mesh, mesh_scope  # noqa: F401
from .ring_attention import ring_attention, ring_self_attention  # noqa: F401
from .sharded import DataParallel, shard_train_step  # noqa: F401

__all__ = ["Mesh", "current_mesh", "make_mesh", "mesh_scope", "all_gather",
           "all_reduce", "broadcast", "reduce_scatter", "ring_permute",
           "DataParallel", "shard_train_step", "ring_attention",
           "ring_self_attention"]
