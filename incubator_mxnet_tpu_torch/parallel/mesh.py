"""The mesh of ranks (port of `incubator_mxnet_tpu/parallel/mesh.py`:
`Mesh` :20, `make_mesh` :26, `mesh_scope` :69, `current_mesh` :84).

The reference's mesh is an array of the devices one controller drives.
The port runs one process per rank, so a :class:`Mesh` is an array of
**ranks** of the `torch.distributed` world, with named axes. Its
collectives run over `torch.distributed.device_mesh.DeviceMesh`, built on
first use: ``mesh.group(axis)`` is the process group of this rank's slice
along an axis, and ``mesh.coordinate(axis)`` this rank's index there.

With no initialised world the mesh is a world of one (every axis of size
1), and its collectives are the identity. ``devices=`` takes ranks, as
the reference's takes devices; :func:`make_mesh` counts the world's
ranks where the reference counts devices, and keeps the reference's
rules and errors (the wildcard, its divisibility, unique axis names).

A mesh over **part** of a gloo world (the survivors of an elastic
transition, `fault.elastic`) cannot build a `DeviceMesh`: that needs
every rank of the world, and the departed ones take no part. Its groups
are :class:`SubGroup`\\ s instead: a gloo process group over the slice's
ranks alone, made from the world's store under a prefix only those ranks
use. `parallel.collectives` exchanges over either kind.
"""
from __future__ import annotations

import datetime
import threading

import numpy as onp

__all__ = ["Mesh", "make_mesh", "mesh_scope", "current_mesh", "SubGroup"]


class _TLS(threading.local):
    def __init__(self):
        self.stack = []


_STATE = _TLS()
_SUB_MADE: dict = {}     # ranks -> sub-groups made over them in this process


class SubGroup:
    """A gloo process group over ``ranks`` (global ranks, this rank among
    them) that the other ranks of the world take no part in: made from
    the world's store under a prefix keyed by the membership generation,
    the ranks and how many such groups this process made before (the
    ranks make their groups in the same order, so they agree)."""

    backend = "gloo"

    def __init__(self, ranks):
        import torch.distributed as tdist

        from . import dist

        self.ranks = tuple(int(r) for r in ranks)
        _, me, _ = _world()
        if me not in self.ranks:
            raise ValueError(f"rank {me} is not among {self.ranks}")
        if str(tdist.get_backend()) != "gloo":
            raise ValueError("a mesh over part of the world needs a gloo "
                             "world (NCCL groups are made by every rank)")
        n = _SUB_MADE[self.ranks] = _SUB_MADE.get(self.ranks, 0) + 1
        prefix = (f"mx/submesh/g{dist.generation()}/"
                  f"{'-'.join(map(str, self.ranks))}/{n}")
        store = tdist.PrefixStore(prefix,
                                  tdist.distributed_c10d._get_default_store())
        self.pg = tdist.ProcessGroupGloo(
            store, self.ranks.index(me), len(self.ranks),
            datetime.timedelta(seconds=dist._TIMEOUT_S))

    @property
    def size(self):
        return len(self.ranks)

    @property
    def rank(self):
        return self.ranks.index(_world()[1])

    def __repr__(self):
        return f"SubGroup{self.ranks}"


def _world():
    """(initialised, this rank, world size) of torch.distributed."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return True, tdist.get_rank(), tdist.get_world_size()
    return False, 0, 1


class Mesh:
    """Named axes over an array of ranks.

    ``devices`` is the array of ranks (``mesh.devices.size`` ranks),
    ``axis_names`` its axes; ``shape`` maps each axis to its size, as the
    reference's `jax.sharding.Mesh` does."""

    def __init__(self, devices, axis_names):
        self.devices = onp.asarray(devices, dtype=onp.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self._device_mesh = None
        self._sub = {}      # axis (or None: every rank) -> SubGroup

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape})"

    def _index(self):
        """This rank's coordinates in the array, or None off the mesh."""
        _, me, _ = _world()
        hit = onp.argwhere(self.devices == me)
        return tuple(int(i) for i in hit[0]) if len(hit) else None

    def coordinate(self, axis):
        """This rank's index along ``axis`` (0 on an axis the mesh lacks)."""
        if axis not in self.shape:
            return 0
        idx = self._index()
        if idx is None:
            raise ValueError(f"rank {_world()[1]} is not on {self}")
        return idx[self.axis_names.index(axis)]

    def axis_size(self, axis):
        """The size of ``axis`` (1 for an axis the mesh lacks)."""
        return int(self.shape.get(axis, 1))

    def device_mesh(self):
        """The `DeviceMesh` over the world's ranks, made on first use (a
        collective: every rank of the world makes its meshes in the same
        order)."""
        if self._device_mesh is None:
            import torch.distributed as tdist
            from torch.distributed.device_mesh import DeviceMesh

            up, _, n = _world()
            if not up:
                raise ValueError(f"{self} has no torch.distributed world; "
                                 f"call parallel.dist.initialize first")
            if self.size != n:
                raise ValueError(f"{self} spans {self.size} ranks, the "
                                 f"world has {n}")
            kind = "cuda" if tdist.get_backend() == "nccl" else "cpu"
            self._device_mesh = DeviceMesh(
                kind, self.devices.tolist(), mesh_dim_names=self.axis_names)
        return self._device_mesh

    def group(self, axis):
        """The process group of this rank's slice along ``axis``; None
        where there is nothing to exchange (no world, or an axis of size 1
        in a world of more than one)."""
        up, _, n = _world()
        if not up or (self.axis_size(axis) == 1 and n > 1):
            return None
        if axis not in self.shape:
            raise ValueError(f"axis {axis!r} is not on {self}")
        if self.size < n:
            if axis not in self._sub:
                idx = list(self._index())
                idx[self.axis_names.index(axis)] = slice(None)
                self._sub[axis] = SubGroup(self.devices[tuple(idx)].tolist())
            return self._sub[axis]
        return self.device_mesh().get_group(axis)

    def group_all(self):
        """The process group of every rank of the mesh (the world's when
        the mesh spans it); None with no world or one rank."""
        import torch.distributed as tdist

        up, _, n = _world()
        if not up or self.size == 1:
            return None
        if self.size < n:
            if None not in self._sub:
                self._sub[None] = SubGroup(sorted(self.devices.ravel()
                                                  .tolist()))
            return self._sub[None]
        return tdist.group.WORLD


def make_mesh(axis_shapes, devices=None):
    """A mesh from ``{'axis': size}`` (or ordered ``(axis, size)`` pairs),
    e.g. ``{'dp': 2, 'tp': 2}``.

    It spans every rank of the world by default (``devices``: a list of
    ranks). The sizes must multiply to the rank count; one axis may be
    -1, inferred, and must divide evenly."""
    if devices is None:
        _, _, n = _world()
        devices = list(range(n))
    devices = list(devices)
    if not isinstance(axis_shapes, dict):
        axis_shapes = [(a, s) for a, s in axis_shapes]
        names = [a for a, _ in axis_shapes]
        axis_shapes = dict(axis_shapes)
    else:
        names = list(axis_shapes)
    if len(set(names)) != len(names):
        dupes = sorted({a for a in names if names.count(a) > 1})
        raise ValueError(f"mesh axis names must be unique, got duplicate "
                         f"{dupes} in {names}")
    sizes = list(axis_shapes.values())
    n = len(devices)
    if sizes.count(-1) > 1:
        raise ValueError(f"at most one -1 wildcard axis allowed, got "
                         f"{dict(zip(names, sizes))}")
    if -1 in sizes:
        wild = sizes.index(-1)
        known = int(onp.prod([s for s in sizes if s != -1]))
        if known <= 0 or n % known:
            raise ValueError(
                f"cannot infer wildcard axis {names[wild]!r}: {n} devices "
                f"not divisible by the known axes "
                f"{ {a: s for a, s in zip(names, sizes) if s != -1} } "
                f"(product {known})")
        sizes[wild] = n // known
    total = int(onp.prod(sizes))
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n}")
    return Mesh(onp.asarray(devices[:total]).reshape(sizes), names)


class mesh_scope:
    """Context manager installing a mesh as the active one."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _STATE.stack.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _STATE.stack.pop()
        return False


def current_mesh():
    return _STATE.stack[-1] if _STATE.stack else None
