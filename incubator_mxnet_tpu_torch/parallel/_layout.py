"""Shards of tensors over a mesh, for the port's one-process-per-rank
layout (the reference leaves layout to GSPMD, which the port has no
counterpart of).

A spec is the reference's `PartitionSpec` as a tuple: one entry per
dimension, an axis name, a tuple of axis names, or None; ``()`` or None
is replicated. Axes the mesh lacks are dropped, as in the reference. A
dimension of size S over n ranks is cut as `torch.chunk` cuts it (and as
GSPMD pads it): blocks of ceil(S / n), the last ones short or empty, so
an uneven dimension (a vocabulary of 97 over 2) works.

**Storage by the spec.** A parameter cut by its spec over axes of more
than one rank is stored as the rank's block (:class:`Placement`, set on
the `gluon.Parameter` by `parallel.DataParallel`): the rank keeps no
whole copy. A tensor-parallel model computes from the block itself;
anything else that reads the parameter gets the whole tensor gathered
on demand, a transient whose gradient is this rank's block of the whole
one (:meth:`Placement.whole`), or, inside a step that gathered its
weights once, that step's transient (:class:`whole_params`).

`copy_to` and `reduce_from` are Megatron's f and g around a
tensor-parallel region (each rank computes a share of the heads or
hidden units: the identity with its gradient summed over the axis, and
the sum of the partial results). `seq_enter` and `seq_exit` are
Megatron's sequence-parallel pair in their place: the residual stream
stays cut by rows of the sequence between the regions, an all-gather
joins the rows on entry to a region (its gradient reduce-scattered) and
a reduce-scatter sums the partial results into the rank's rows on exit
(its gradient all-gathered). `head_rows` gives a rank its heads' rows of
a fused projection (``[q|k|v]``) that the spec cuts contiguously, by one
all-to-all (its gradient sent back by the inverse one) into the stored
block's gradient.

`scatter` and `gather` are the two sides of a sequence-parallel region
with **replicated** semantics: outside the region every rank of the
axis holds the whole activation, and the gradients arriving there are
whole and the same on each rank. `scatter` keeps this rank's block (its
gradient is gathered back) and `gather` joins the blocks (its gradient
is this rank's block of the whole one). A parameter used inside a
region sees this rank's rows only, so its gradient is this rank's share:
the region names it to the step's :class:`partial_grads` collector, and
the step sums it over the axis together with its other gradients
(`parallel.sharded._MeshPlan`, `models.sharded_bert`).

`flat_all_reduce`, `flat_all_gather` and `flat_reduce_scatter` move the
gradients and weights of a step, one exchange of one flat buffer per
dtype whatever the number of tensors: the gradients' means, and, for a
net that computes with whole weights, the cut weights gathered for the
step and their whole gradients reduce-scattered into the blocks where
the data axis cuts them.
"""
from __future__ import annotations

import functools
import threading

import torch

from . import collectives as _coll


class _TLS(threading.local):
    def __init__(self):
        self.laid_out = ()
        self.tp = None          # (mesh, axis) of a tensor-parallel step
        self.partial = None     # {id(param): axis} of the step at hand
        self.wholes = None      # {id(Placement): whole tensor} of a step
        self.stream = None      # whole length of a stream cut by rows


_STATE = _TLS()


class laid_out:
    """Marks mesh axes the tensors at hand are already local along (a
    data-parallel step's batch axis): `npx.sharding_constraint` leaves
    them alone."""

    def __init__(self, *axes):
        self.axes = tuple(a for a in axes if a is not None)

    def __enter__(self):
        self.saved = _STATE.laid_out
        _STATE.laid_out = self.saved + self.axes
        return self

    def __exit__(self, *exc):
        _STATE.laid_out = self.saved
        return False


def laid_out_axes():
    return _STATE.laid_out


class tensor_parallel:
    """Marks a step whose model splits its compute over mesh ``axis``
    (Megatron tensor parallelism; `models.bert`'s TP path reads it
    through :func:`tp`)."""

    def __init__(self, mesh, axis):
        self.value = (mesh, axis) if axis is not None else None

    def __enter__(self):
        self.saved = _STATE.tp
        _STATE.tp = self.value
        return self

    def __exit__(self, *exc):
        _STATE.tp = self.saved
        return False


class cut_stream:
    """Marks the residual stream as cut by rows of the sequence over the
    tensor-parallel axis (Megatron SP), of whole length ``size``; None
    marks it whole."""

    def __init__(self, size):
        self.size = size

    def __enter__(self):
        self.saved = _STATE.stream
        _STATE.stream = self.size
        return self

    def __exit__(self, *exc):
        _STATE.stream = self.saved
        return False


def stream_len():
    """The whole sequence length of a stream cut by rows, or None."""
    return _STATE.stream


def tp():
    """``(mesh, axis, size, index)`` of the tensor-parallel step at hand,
    or None (none, or an axis of one rank)."""
    v = _STATE.tp
    if v is None:
        return None
    mesh, axis = v
    n = mesh.axis_size(axis)
    return (mesh, axis, n, mesh.coordinate(axis)) if n > 1 else None


def clean_spec(spec, ndim, mesh):
    """A spec as ``ndim`` tuples of the mesh's axes (empty: not cut)."""
    if spec is None:
        spec = ()
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dimensions")
    out = []
    for entry in spec + (None,) * (ndim - len(spec)):
        if entry is None:
            out.append(())
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        out.append(tuple(a for a in names if a in mesh.shape))
    return tuple(out)


def is_cut(cspec):
    return any(cspec)


def live_spec(cspec, mesh):
    """``cspec`` without the axes of one rank (a block over them is the
    whole dimension)."""
    return tuple(tuple(a for a in axes if mesh.axis_size(a) > 1)
                 for axes in cspec)


def _index(mesh, axes):
    """(this rank's block index, block count) over ``axes`` taken
    together, the first axis major."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.axis_size(a) + mesh.coordinate(a)
        n *= mesh.axis_size(a)
    return idx, n


def bounds(size, idx, n):
    """[start, stop) of block ``idx`` of ``n`` along a dimension of
    ``size`` (blocks of ceil(size / n))."""
    c = -(-size // n) if n else size
    start = min(idx * c, size)
    return start, min(start + c, size)


def local_slice(x, cspec, mesh):
    """This rank's block of a whole tensor ``x`` (a view)."""
    for d, axes in enumerate(cspec):
        if axes:
            idx, n = _index(mesh, axes)
            start, stop = bounds(x.shape[d], idx, n)
            x = x.narrow(d, start, stop - start)
    return x


def _gather_dim(x, d, size, mesh, axes):
    """Join the blocks of dimension ``d`` (whole size ``size``) over
    ``axes``: each block padded to ceil(size / n), gathered over the last
    axis first, then trimmed."""
    _, n = _index(mesh, axes)
    c = -(-size // n)
    pad = c - x.shape[d]
    if pad:
        shape = list(x.shape)
        shape[d] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=d)
    for a in reversed(axes):
        x = _coll._raw_all_gather(x, mesh.group(a), d)
    return x.narrow(d, 0, size)


def gather_full(x, cspec, full_shape, mesh):
    """The whole tensor from this rank's block (no autograd)."""
    for d, axes in enumerate(cspec):
        if axes:
            x = _gather_dim(x, d, full_shape[d], mesh, axes)
    return x


def _sum_rows(x, d, size, mesh, axes):
    """This rank's block of dimension ``d`` (whole size ``size``) of the
    sum of ``x`` over ``axes``: dimension ``d`` padded to n blocks of
    ceil(size / n), reduce-scattered over the first axis first, then
    trimmed."""
    idx, n = _index(mesh, axes)
    c = -(-size // n)
    pad = n * c - x.shape[d]
    if pad:
        shape = list(x.shape)
        shape[d] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=d)
    for a in axes:
        x = _coll._raw_reduce_scatter(x, mesh.group(a), d)
    start, stop = bounds(size, idx, n)
    return x.narrow(d, 0, stop - start)


class Placement:
    """How a parameter is stored on a mesh: this rank's block, cut by the
    clean spec ``cspec`` (`live_spec`: axes of more than one rank only),
    of a whole tensor of ``shape``."""

    def __init__(self, mesh, cspec, shape):
        self.mesh = mesh
        self.cspec = tuple(cspec)
        self.shape = tuple(shape)

    def __repr__(self):
        return f"Placement({self.cspec}, whole {self.shape})"

    def block_of(self, whole):
        """This rank's block of a whole tensor (a view)."""
        return local_slice(whole, self.cspec, self.mesh)

    def gather(self, block):
        """The whole tensor from the rank's block (no autograd; every rank
        of the cut axes calls it)."""
        return gather_full(block.detach(), self.cspec, self.shape, self.mesh)

    def dim(self, axis):
        """The dimension this placement cuts over ``axis`` alone, or None."""
        return cut_dim(self.cspec, axis)

    def whole(self, block):
        """The whole tensor for a reader that needs it: the step's
        transient when one is in scope (:class:`whole_params`), else
        gathered now, its gradient this rank's block of the whole one (the
        readers of a replicated computation get the same whole gradient)."""
        table = _STATE.wholes
        if table is not None and id(self) in table:
            return table[id(self)]
        return _WholeParam.apply(block, self)


class _WholeParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, placement):
        ctx.placement = placement
        return placement.gather(block)

    @staticmethod
    def backward(ctx, g):
        return ctx.placement.block_of(g).contiguous(), None


class whole_params:
    """The step's whole weights, gathered once (``{id(Placement):
    tensor}``): what :meth:`Placement.whole` answers inside it."""

    def __init__(self, table):
        self.table = table

    def __enter__(self):
        self.saved = _STATE.wholes
        _STATE.wholes = self.table
        return self

    def __exit__(self, *exc):
        _STATE.wholes = self.saved
        return False


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, d):
        ctx.args = (mesh, axes, d, x.shape[d])
        idx, n = _index(mesh, axes)
        start, stop = bounds(x.shape[d], idx, n)
        return x.narrow(d, start, stop - start).clone()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, d, size = ctx.args
        return _gather_dim(g.contiguous(), d, size, mesh, axes), None, None, \
            None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, d, size):
        ctx.args = (mesh, axes, d, size)
        return _gather_dim(x.contiguous(), d, size, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, d, size = ctx.args
        idx, n = _index(mesh, axes)
        start, stop = bounds(size, idx, n)
        return g.narrow(d, start, stop - start).contiguous(), None, None, \
            None, None


class _CopyTo(torch.autograd.Function):
    """Megatron's f: the identity, its gradient summed over the axis (each
    rank's share of the compute gives a share of the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return _coll._raw_all_reduce(g, mesh.group(axis), "sum"), None, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: the sum of the ranks' partial results, its gradient
    the output's (the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _coll._raw_all_reduce(x, mesh.group(axis), "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SeqEnter(torch.autograd.Function):
    """Megatron-SP's entry into a tensor-parallel region: the rank's rows
    joined by an all-gather; the gradient (each rank's share of the
    whole) summed into the rank's rows by a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, mesh, axes, d, size):
        ctx.args = (mesh, axes, d, size)
        return _gather_dim(x.contiguous(), d, size, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, d, size = ctx.args
        return _sum_rows(g.contiguous(), d, size, mesh, axes), None, None, \
            None, None


class _SeqExit(torch.autograd.Function):
    """Megatron-SP's exit from a tensor-parallel region: the partial
    results summed into the rank's rows by a reduce-scatter; the gradient
    of the rows joined by an all-gather."""

    @staticmethod
    def forward(ctx, x, mesh, axes, d):
        ctx.args = (mesh, axes, d, x.shape[d])
        return _sum_rows(x.contiguous(), d, x.shape[d], mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, d, size = ctx.args
        return _gather_dim(g.contiguous(), d, size, mesh, axes), None, None, \
            None


def seq_enter(x, mesh, axis, size, dim=1):
    """The whole of dimension ``dim`` (of ``size``) from the rank's rows,
    on entry to a tensor-parallel region (the gradient reduce-scattered)."""
    return _SeqEnter.apply(x, mesh, (axis,), dim, size)


def seq_exit(x, mesh, axis, dim=1):
    """The sum over ``axis`` of the region's partial results, the rank's
    rows of dimension ``dim`` (the gradient all-gathered)."""
    return _SeqExit.apply(x, mesh, (axis,), dim)


def copy_to(x, mesh, axis):
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis):
    return _ReduceFrom.apply(x, mesh, axis)


def scatter(x, mesh, axes, d):
    """This rank's block of dimension ``d`` over ``axes`` (replicated
    semantics: the gradient is gathered)."""
    return _Scatter.apply(x, mesh, tuple(axes), d)


def gather(x, mesh, axes, d, size):
    """The whole of dimension ``d`` (of ``size``) from the blocks over
    ``axes`` (the gradient: this rank's block)."""
    return _Gather.apply(x, mesh, tuple(axes), d, size)


class partial_grads:
    """Collects, for the step at hand, the parameters whose gradients its
    sequence-parallel regions leave as this rank's share: ``found`` (a
    dict the caller keeps) maps ``id(param)`` to the mesh axis the share
    is to be summed over."""

    def __init__(self, found):
        self.found = found

    def __enter__(self):
        self.saved = _STATE.partial
        self.found.clear()
        _STATE.partial = self.found
        return self

    def __exit__(self, *exc):
        _STATE.partial = self.saved
        return False


def _note_partial(params, axis):
    found = _STATE.partial
    if found is None:
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            from ..base import MXNetError

            raise MXNetError(
                f"a sequence-parallel region over {axis!r} differentiates "
                f"parameters outside a step that sums their shares over the "
                f"axis (parallel.DataParallel, "
                f"models.sharded_bert.make_train_step)")
        return
    for p in params:
        found[id(p)] = axis


def seq_region(fn, xs, axis, params=(), dim=1, local=False):
    """``fn(*xs, *params)`` on this rank's rows of dimension ``dim`` of
    ``xs`` along mesh ``axis`` (a sequence-parallel region: LayerNorm and
    dropout work row by row), joined back into the whole activation; with
    ``local=True`` the ``xs`` are the rank's rows already (Megatron-SP's
    stream, cut between the regions) and so is the result. ``params`` are
    used on the local rows only, so their gradients are this rank's
    shares: the region names them to the step's :class:`partial_grads`
    collector, which sums them over the axis (and raises when there is
    none to do so); the dropout sites inside draw keys folded with this
    rank's coordinate, so each block draws its own mask. With no active
    mesh, or an axis it lacks, this is ``fn(*xs, *params)``."""
    from .. import random as _random
    from .mesh import current_mesh

    mesh = current_mesh()
    if mesh is None or axis is None or axis not in mesh.shape:
        return fn(*xs, *params)
    from ..numpy_extension import _op
    from .mesh import _world

    if not _world()[0]:
        return fn(*xs, *params)
    axes, n = (axis,), len(xs)

    def run_local(*ts):
        if mesh.axis_size(axis) == 1:
            return fn(*ts)
        _note_partial(ts[n:], axis)
        with _random.fold_key_scope(mesh.coordinate(axis)):
            return fn(*ts)

    if local:
        return _op("seq_region", run_local, *xs, *params)

    def run(*ts):
        size = ts[0].shape[dim]
        local = [scatter(t, mesh, axes, dim) for t in ts[:n]]
        if mesh.axis_size(axis) > 1:
            _note_partial(ts[n:], axis)
            with _random.fold_key_scope(mesh.coordinate(axis)):
                y = fn(*local, *ts[n:])
        else:
            y = fn(*local, *ts[n:])
        return gather(y, mesh, axes, dim, size)

    return _op("seq_region", run, *xs, *params)


def note_partial(params, axis):
    """Name ``params`` (tensors) to the step as having gradients that are
    this rank's shares over ``axis`` (used on the rank's rows of a cut
    stream)."""
    from .mesh import current_mesh

    mesh = current_mesh()
    if mesh is not None and mesh.axis_size(axis) > 1:
        _note_partial(params, axis)


@functools.lru_cache(maxsize=64)
def _head_plan(rows, fused, n, me):
    """The all-to-all of :func:`head_rows` for rank ``me`` of ``n``: a
    fused projection of ``rows`` rows (``fused`` parts, each of ``rows /
    fused`` units) stored in contiguous blocks of ceil(rows / n). Rank j
    needs rows [s U + j U / n, s U + (j + 1) U / n) of each part s; the
    rows it stores itself stay local. Returns (chunk rows M: the most one
    rank sends another, block rows B, send index (n M rows of the block,
    B pads, the own chunk all pads), take index (the rows this rank
    needs, in order, as positions of the received buffer followed by the
    block's rows))."""
    units = rows // fused
    ul = units // n
    blk = -(-rows // n)

    def need(j):
        return [s * units + j * ul + i for s in range(fused)
                for i in range(ul)]

    def piece(k, j):
        return [r for r in need(j) if k * blk <= r < (k + 1) * blk]

    m = max([len(piece(k, j)) for k in range(n) for j in range(n)
             if k != j] or [0])
    send = []
    for j in range(n):
        rows_ = [] if j == me else [r - me * blk for r in piece(me, j)]
        send += rows_ + [blk] * (m - len(rows_))
    take = []
    for r in need(me):
        k = r // blk
        take.append(n * m + r - me * blk if k == me
                    else k * m + piece(k, me).index(r))
    return m, blk, tuple(send), tuple(take)


class _HeadRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, rows, fused, mesh, axis):
        group = mesh.group(axis)
        n, me = mesh.axis_size(axis), mesh.coordinate(axis)
        m, blk, send, take = _head_plan(rows, fused, n, me)
        dev = block.device
        send_i = torch.tensor(send, dtype=torch.long, device=dev)
        take_i = torch.tensor(take, dtype=torch.long, device=dev)
        ctx.args = (group, send_i, take_i, n * m, blk)
        padded = torch.cat([block, block.new_zeros((1,) + block.shape[1:])])
        got = _coll._raw_all_to_all(padded.index_select(0, send_i), group,
                                    0, 0)
        return torch.cat([got, block]).index_select(0, take_i)

    @staticmethod
    def backward(ctx, g):
        group, send_i, take_i, total, blk = ctx.args
        rest = tuple(g.shape[1:])
        # the rows' gradients where they came from: peers' chunks, then
        # this rank's own block
        buf = g.new_zeros((total + blk,) + rest)
        buf.index_copy_(0, take_i, g.contiguous())
        back = _coll._raw_all_to_all(buf[:total], group, 0, 0)
        out = g.new_zeros((blk + 1,) + rest)
        out.index_add_(0, send_i, back)
        return out[:blk] + buf[total:], None, None, None, None


def head_rows(block, rows, fused, mesh, axis):
    """This rank's heads' rows of a fused projection (``fused`` parts of
    ``rows / fused`` units each, ``[q|k|v]``) whose spec cuts its ``rows``
    contiguously over ``axis``, from the stored ``block`` (its rows along
    dim 0): the rows of each part the rank's heads use, in part order,
    gathered by one all-to-all. The gradient goes back by the inverse
    all-to-all into the block's rows (each row is one rank's)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return block
    return _HeadRows.apply(block, rows, fused, mesh, axis)


def cut_dim(cspec, axis):
    """The dimension a clean spec cuts over mesh ``axis`` alone, when that
    is all it cuts; else None."""
    dims = [d for d, axes in enumerate(cspec) if axes]
    if len(dims) == 1 and cspec[dims[0]] == (axis,):
        return dims[0]
    return None


def _by_dtype(tensors, idx):
    out: dict = {}
    for i in idx:
        out.setdefault(tensors[i].dtype, []).append(i)
    return out.values()


def flat_reduce_scatter(vals, idx, dims, mesh, axis):
    """For each ``i`` in ``idx``, ``vals[i]`` (a whole tensor, this rank's
    share of a sum over mesh ``axis``) becomes this rank's block, along
    dimension ``dims[i]``, of the sum: one reduce-scatter of one flat
    buffer per dtype. Each dimension is padded to n blocks of ceil(S /
    n), as :func:`bounds` cuts it."""
    group = mesh.group(axis)
    n, j = mesh.axis_size(axis), mesh.coordinate(axis)
    for same in _by_dtype(vals, idx):
        parts = []
        for i in same:
            g = vals[i].movedim(dims[i], 0)
            pad = n * -(-g.shape[0] // n) - g.shape[0]
            if pad:
                g = torch.cat([g, g.new_zeros((pad,) + tuple(g.shape[1:]))])
            parts.append(g.reshape(n, -1))
        flat = _coll._raw_reduce_scatter(torch.cat(parts, dim=1).reshape(-1),
                                         group, 0)
        off = 0
        for i, part in zip(same, parts):
            d, m = dims[i], part.shape[1]
            size = vals[i].shape[d]
            rest = tuple(vals[i].movedim(d, 0).shape[1:])
            start, stop = bounds(size, j, n)
            blk = flat[off:off + m].view((-(-size // n),) + rest)
            vals[i] = blk[:stop - start].movedim(0, d).contiguous()
            off += m


def flat_all_gather(blocks, wholes, idx, dims, mesh, axis):
    """For each ``i`` in ``idx``, ``wholes[i]`` (written in place) joined
    from the ranks' ``blocks[i]`` along dimension ``dims[i]`` over mesh
    ``axis``: one all-gather of one flat buffer per dtype."""
    group = mesh.group(axis)
    n = mesh.axis_size(axis)
    for same in _by_dtype(blocks, idx):
        parts, rows = [], []
        for i in same:
            d = dims[i]
            b = blocks[i].movedim(d, 0)
            c = -(-wholes[i].shape[d] // n)
            if c > b.shape[0]:
                b = torch.cat([b, b.new_zeros((c - b.shape[0],)
                                              + tuple(b.shape[1:]))])
            parts.append(b.reshape(-1))
            rows.append(c)
        with _coll.operands([wholes[i].numel() * wholes[i].element_size()
                             for i in same]):
            flat = _coll._raw_all_gather(torch.cat(parts), group,
                                         0).view(n, -1)
        off = 0
        for i, part, c in zip(same, parts, rows):
            d, m = dims[i], part.numel()
            w = wholes[i]
            rest = tuple(w.movedim(d, 0).shape[1:])
            whole = flat[:, off:off + m].reshape((n * c,) + rest)
            w.copy_(whole[:w.shape[d]].movedim(0, d))
            off += m


def flat_all_reduce(vals, idx, group, op):
    """``vals[i]`` for each ``i`` in ``idx`` reduced over ``group`` ("sum"
    or "mean"), one flat buffer a dtype, in place in the list."""
    for same in _by_dtype(vals, idx):
        flat = torch.cat([vals[i].reshape(-1) for i in same])
        flat = _coll._raw_all_reduce(flat, group, op)
        off = 0
        for i in same:
            n = vals[i].numel()
            vals[i] = flat[off:off + n].view_as(vals[i])
            off += n


def split_batch(x, mesh, axis):
    """This rank's rows of a global batch along mesh ``axis`` (the batch
    divides evenly, as the reference's batch sharding requires)."""
    n = mesh.axis_size(axis) if axis in mesh.shape else 1
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} does not divide over the "
                         f"{n} ranks of mesh axis {axis!r}")
    c = x.shape[0] // n
    return x.narrow(0, mesh.coordinate(axis) * c, c)




def tree_leaves(tree):
    """The tensors of a tree of dicts (in key order), lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_rebuild(tree, leaves):
    """``tree``'s structure with ``leaves`` (an iterator) in its places."""
    if isinstance(tree, dict):
        return {k: tree_rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_rebuild(t, leaves) for t in tree)
    return next(leaves)


def tree_map(fn, *trees):
    leaves = [fn(*xs) for xs in zip(*(tree_leaves(t) for t in trees))]
    return tree_rebuild(trees[0], iter(leaves))
