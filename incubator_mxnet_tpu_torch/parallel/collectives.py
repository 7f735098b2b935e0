"""Collectives over a mesh axis (port of `incubator_mxnet_tpu/parallel/
collectives.py`: `pvary` :18, `axis_size` :43, `all_reduce` :54,
`all_gather` :77, `reduce_scatter` :89, `broadcast` :101, `ring_permute`
:115, `all_to_all` :132, the `_CENSUS` hook :151).

The reference calls these inside a `shard_map`, where an axis name binds
to the traced mesh. The port runs one process per rank: an axis name
binds to the active mesh (`mesh_scope`), and each op is a
`torch.distributed` collective over the process group of this rank's
slice along the axis (`Mesh.group`). With no world, or along an axis of
size 1 in a larger world, an op is the identity.

Each op is differentiable, with the transpose the reference's shard_map
gives it: `all_gather` ↔ `reduce_scatter`, `ring_permute` by the inverse
shift, `all_to_all` by the inverse exchange, `broadcast` to the source's
gradient; `all_reduce`'s gradient is the output's (the reduced value is
the same on every rank, and its loss is counted once).

The transport follows the group's backend. NCCL takes CUDA tensors as
they are (and can be captured in a CUDA graph). Gloo takes CPU tensors;
on a gloo group a CUDA tensor is copied to the host, exchanged and copied
back, and the first such copy of a process is logged
(`incubator_mxnet_tpu_torch.parallel`) naming the backend. That is the
transport the card's multi-rank runs take when NCCL refuses more than one
rank on one card.

``_CENSUS`` is the reference's hook for the fleet plane: when set, each
op reports ``(op, axis, value)`` before it runs. ``_STEP_CENSUS`` sees
every raw exchange underneath (the ops above and the layout's own, which
`parallel._layout` makes without autograd): ``(op, group, in bytes, out
bytes, operands)`` with ``op`` the HLO-style name ("all-reduce",
"all-gather", "reduce-scatter", "all-to-all", "collective-permute") and
``operands`` the whole bytes of each parameter a flat exchange carries
(:class:`operands`; None for an activation's); it is what
`analysis.shardcheck`'s census tier counts. A group is a
`torch.distributed` process group or a `mesh.SubGroup` (a mesh over part
of the world).
"""
from __future__ import annotations

import logging

import torch

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "ring_permute", "all_to_all", "axis_size", "pvary"]

_LOG = logging.getLogger("incubator_mxnet_tpu_torch.parallel")
_LOGGED = set()
_CENSUS = None   # (op, axis, value) hook
_STEP_CENSUS = None   # (op, group, in bytes, out bytes, operands) hook
_OPERANDS = [None]    # the whole bytes of the parameters an exchange carries


class operands:
    """Marks the exchanges inside as carrying parameters whose whole
    tensors are ``sizes`` bytes each (`_layout.flat_all_gather`)."""

    def __init__(self, sizes):
        self.sizes = tuple(int(b) for b in sizes)

    def __enter__(self):
        self.saved = _OPERANDS[0]
        _OPERANDS[0] = self.sizes
        return self

    def __exit__(self, *exc):
        _OPERANDS[0] = self.saved
        return False


def _unwrap(x):
    from ..ndarray.ndarray import NDArray

    return (x._data, True) if isinstance(x, NDArray) else (x, False)


def _wrap(out, was_nd):
    from ..ndarray.ndarray import NDArray

    return NDArray(out) if was_nd else out


def _mesh():
    from .mesh import current_mesh

    mesh = current_mesh()
    if mesh is None:
        raise ValueError("collectives need an active mesh (enter a "
                         "parallel.mesh_scope)")
    return mesh


def _group(axis_name):
    return _mesh().group(axis_name)


def axis_size(axis_name):
    """The size of a mesh axis (an int). Not a communication, so no
    census."""
    return _mesh().axis_size(axis_name)


def pvary(x, axis_name):  # noqa: ARG001
    """The identity: the reference's replication-typing mark for
    shard_map has no counterpart with one process per rank."""
    return x


def transport(group, device):
    """"host" when ``group`` exchanges tensors of ``device`` through host
    memory (a gloo group and a CUDA tensor), else "direct"."""
    if group is None or device.type != "cuda":
        return "direct"
    backend = group_backend(group)
    if backend == "nccl":
        return "direct"
    key = (backend, str(device))
    if key not in _LOGGED:
        _LOGGED.add(key)
        _LOG.warning("collectives: %s group with %s tensors: exchanging "
                     "through host memory", backend, device)
    return "host"


def _exchange(group, fn, out, *ins):
    """``fn(out, *ins)``, which writes ``out`` in place, on the group's
    transport: on the host for a gloo group and CUDA tensors (only
    ``out`` is copied back: an input may be a tensor autograd saved)."""
    if transport(group, out.device) == "host":
        host = out.detach().cpu()
        fn(host, *(t.detach().cpu() for t in ins))
        out.copy_(host)
        return
    fn(out, *ins)


def _sub(group):
    from .mesh import SubGroup

    return group.pg if isinstance(group, SubGroup) else None


def group_backend(group):
    """The backend's name of a process group or `mesh.SubGroup`."""
    import torch.distributed as tdist

    return "gloo" if _sub(group) is not None else str(
        tdist.get_backend(group))


def _ranks(group):
    """The global ranks of a group, in its order."""
    import torch.distributed as tdist

    if _sub(group) is not None:
        return list(group.ranks)
    return tdist.get_process_group_ranks(group)


def _group_size(group):
    import torch.distributed as tdist

    if group is None:
        return 1
    return group.size if _sub(group) is not None else \
        tdist.get_world_size(group)


def _group_rank(group):
    import torch.distributed as tdist

    return group.rank if _sub(group) is not None else tdist.get_rank(group)


def _note(op, group, src, out):
    c = _STEP_CENSUS
    if c is not None:
        c(op, group, src.numel() * src.element_size(),
          out.numel() * out.element_size(), _OPERANDS[0])


def _all_reduce_into(o, rop, group):
    import torch.distributed as tdist

    pg = _sub(group)
    if pg is None:
        tdist.all_reduce(o, rop, group=group)
        return
    opts = tdist.AllreduceOptions()
    opts.reduceOp = rop
    pg.allreduce([o], opts).wait()


def _all_gather_into(o, s, group):
    import torch.distributed as tdist

    pg = _sub(group)
    if pg is None:
        tdist.all_gather_into_tensor(o, s, group=group)
    else:
        pg._allgather_base(o, s).wait()


def _reduce_scatter_into(o, s, group):
    import torch.distributed as tdist

    pg = _sub(group)
    if pg is None:
        tdist.reduce_scatter_tensor(o, s, group=group)
    else:
        pg._reduce_scatter_base(o, s).wait()


def _all_to_all_into(o, s, group):
    import torch.distributed as tdist

    pg = _sub(group)
    if pg is None:
        tdist.all_to_all_single(o, s, group=group)
    else:
        pg.alltoall_base(o, s, [], []).wait()


# -- raw exchanges (no autograd) --------------------------------------------
_REDUCE_OPS = ("sum", "mean", "max", "min")


def _raw_all_reduce(t, group, op="sum"):
    import torch.distributed as tdist

    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown op {op!r}")
    out = t.detach().clone()
    if group is None:
        return out
    rop = {"sum": tdist.ReduceOp.SUM, "mean": tdist.ReduceOp.SUM,
           "max": tdist.ReduceOp.MAX, "min": tdist.ReduceOp.MIN}[op]
    _note("all-reduce", group, out, out)
    _exchange(group, lambda o: _all_reduce_into(o, rop, group), out)
    if op == "mean":
        n = _group_size(group)
        out = out / n if out.is_floating_point() else out // n
    return out


def _raw_all_gather(t, group, dim):
    if group is None:
        return t.detach().clone()
    n = _group_size(group)
    src = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _note("all-gather", group, src, out)
    _exchange(group, lambda o, s: _all_gather_into(o, s, group), out, src)
    return out.movedim(0, dim).contiguous()


def _raw_reduce_scatter(t, group, dim):
    if group is None:
        return t.detach().clone()
    n = _group_size(group)
    src = t.detach().movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size {src.shape[0]} "
                         f"does not divide over {n} ranks")
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _note("reduce-scatter", group, src, out)
    _exchange(group, lambda o, s: _reduce_scatter_into(o, s, group), out,
              src)
    return out.movedim(0, dim).contiguous()


def _raw_ring_permute(t, group, shift):
    import torch.distributed as tdist

    if group is None:
        return t.detach().clone()
    ranks = _ranks(group)
    n = len(ranks)
    if n == 1 or shift % n == 0:
        return t.detach().clone()
    me = _group_rank(group)
    src = t.detach().contiguous()
    out = torch.empty_like(src)
    pg = _sub(group)

    def run(o, s):
        if pg is not None:
            reqs = [pg.send([s], (me + shift) % n, 0),
                    pg.recv([o], (me - shift) % n, 0)]
            for req in reqs:
                req.wait()
            return
        ops = [tdist.P2POp(tdist.isend, s, ranks[(me + shift) % n], group),
               tdist.P2POp(tdist.irecv, o, ranks[(me - shift) % n], group)]
        for req in tdist.batch_isend_irecv(ops):
            req.wait()

    _note("collective-permute", group, src, out)
    _exchange(group, run, out, src)
    return out


def _raw_all_to_all(t, group, split_axis, concat_axis):
    if group is None:
        return t.detach().clone()
    n = _group_size(group)
    if t.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of size "
                         f"{t.shape[split_axis]} does not split over {n}")
    src = t.detach().movedim(split_axis, 0).contiguous()
    out = torch.empty_like(src)
    _note("all-to-all", group, src, out)
    _exchange(group, lambda o, s: _all_to_all_into(o, s, group), out, src)
    # block j came from peer j: put it back in the split axis's place and
    # join the blocks along the concat axis
    blocks = [b.movedim(0, split_axis) for b in out.chunk(n, dim=0)]
    return torch.cat(blocks, dim=concat_axis).contiguous()


# -- differentiable ops -----------------------------------------------------
class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        ctx.op, ctx.n = op, _group_size(group)
        return _raw_all_reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        if ctx.op in ("max", "min"):
            raise RuntimeError("all_reduce: max/min take no gradient")
        return (g / ctx.n if ctx.op == "mean" else g), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _raw_all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _raw_reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_gather(g, ctx.group, ctx.dim), None, None


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _raw_ring_permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _raw_ring_permute(g, ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _raw_all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return (_raw_all_to_all(g, group, concat_axis, split_axis),
                None, None, None)


def _census(op, axis_name, v):
    c = _CENSUS
    if c is not None:
        c(op, axis_name, v)


def all_reduce(x, axis_name, op="sum"):
    """Reduce over ``axis_name`` ("sum", "mean", "max" or "min"); every
    rank of the slice gets the result."""
    v, nd = _unwrap(x)
    _census("all_reduce", axis_name, v)
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown op {op!r}")
    return _wrap(_AllReduce.apply(v, _group(axis_name), op), nd)


def all_gather(x, axis_name, axis=0, tiled=True):
    """Every rank's ``x`` joined along ``axis`` (``tiled=False`` stacks
    them on a new axis there)."""
    v, nd = _unwrap(x)
    _census("all_gather", axis_name, v)
    if not tiled:
        v = v.unsqueeze(axis)
    return _wrap(_AllGather.apply(v, _group(axis_name), axis), nd)


def reduce_scatter(x, axis_name, axis=0):
    """The sum over ``axis_name``, each rank keeping its block of
    ``axis``."""
    v, nd = _unwrap(x)
    _census("reduce_scatter", axis_name, v)
    return _wrap(_ReduceScatter.apply(v, _group(axis_name), axis), nd)


def broadcast(x, axis_name, src=0):
    """The value of the rank at index ``src`` of the axis, on every rank
    (the reference's masked psum)."""
    v, nd = _unwrap(x)
    _census("broadcast", axis_name, v)
    mesh = _mesh()
    mask = 1.0 if mesh.coordinate(axis_name) == src else 0.0
    out = _AllReduce.apply(v * mask, mesh.group(axis_name), "sum")
    return _wrap(out, nd)


def ring_permute(x, axis_name, shift=1):
    """Send each rank's ``x`` to the rank ``shift`` places on along the
    axis's ring (`batch_isend_irecv`)."""
    v, nd = _unwrap(x)
    _census("ring_permute", axis_name, v)
    return _wrap(_RingPermute.apply(v, _group(axis_name), int(shift)), nd)


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True):
    """Scatter ``split_axis``'s blocks to the axis's ranks and join what
    arrives along ``concat_axis`` (the MoE exchange)."""
    v, nd = _unwrap(x)
    _census("all_to_all", axis_name, v)
    if not tiled:
        raise ValueError("all_to_all: only tiled=True is ported")
    return _wrap(_AllToAll.apply(v, _group(axis_name), split_axis,
                                 concat_axis), nd)
