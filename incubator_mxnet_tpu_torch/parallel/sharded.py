"""The compiled training step (port of `incubator_mxnet_tpu/parallel/
sharded.py`: `_build_pure_step` :19, `DataParallel` :194), on one card.

The reference compiles the whole step, forward, backward and the
optimizer over every parameter, into one XLA program and calls it once a
step. The port's counterpart of that program is a CUDA graph: the first call
of an input signature runs the step eagerly (a real step, on a side
stream, so that everything a kernel wrapper does once has happened), the
second captures it and replays the capture, and every later call of the
signature copies its batch into the capture's input buffers and replays
it. A capture that fails raises
:class:`MXNetError`; nothing falls back to the eager loop.

What the reference passes into its program as traced values lives here in
device buffers the graph reads when it replays: the step counter ``t``
(Adam's bias correction and the dropout keys), ``lr`` and ``wd``
(uploaded only when they change, so `set_learning_rate` takes effect with
no new capture) and the base key. The dropout keys are folded on the
card from the base key and ``t`` (`random.trace_key_scope`,
`ops._philox.fold`), as the reference folds ``t`` into its base key
(:123), so each replay drops other elements. Parameters and optimizer
states are updated in place (the reference donates them, :287), so the
``nn.Module`` is current between steps.

Auxiliary state (BatchNorm's running statistics, Parameters with
``grad_req`` "null") is written in place by the forward itself
(`npx.batch_norm`), the reference's functional aux updates (:38-63)
carried out of its program: the eager step updates it once, the
capture runs no kernel, and each replay updates it once again, by
address.

Every trainable parameter is updated: one the loss does not reach (BERT's
NSP head under an MLM loss) gets a zero gradient, and moves where
``wd > 0``, as in the reference. Small parameters (float32, at most 2^14
elements, at least two of them, an ``elementwise`` optimizer) are updated
together by `Optimizer.step_multi`, the reference's concatenated segment
(:85-113); the rule is elementwise, so the numbers are those of the
per-parameter update.

On a CPU net the same step function runs eagerly on the plain versions
(the tests). ``data_axis`` names the mesh's batch axis; with no mesh it
is unused, as in the reference (:203).

**On a mesh** (``mesh=``, or the ambient `mesh_scope`; one process per
rank, `parallel.mesh`), each rank passes the same global batch and the
step takes its rows along ``data_axis``. ``param_shardings`` (a spec per
trainable parameter, `models.bert.tp_param_shardings`) says how each is
**stored**: a parameter cut by its spec over axes of more than one rank
is held as the rank's block alone (the gluon Parameter's tensor,
`parallel._layout.Placement`), its gradient is the block's and its
optimizer state is made on the block, so a state shaped like the
parameter is cut like it and a scalar is replicated; no rank keeps a
whole copy between steps. Reading such a parameter whole outside the
step (``save_parameters``, a plain eager ``net(x)``) gathers it as a
transient, and a whole ``set_data``/``load_parameters`` writes the
rank's block. The forward and backward run on the rank's rows of the
batch; the gradients are averaged over ``data_axis`` (one all-reduce of
one flat buffer a dtype) and each rank updates what it stores, in place.
A rule with per-tensor norms (LAMB, LANS, LARS: ``norm_combine``) sums
them over a block's cut axes (`optimizer.block_norms`), so every rank's
trust ratio is the whole tensor's; any other rule must be elementwise
where a parameter is cut. How the compute is split:

- a model that supports it (``supports_tensor_parallel``: BERT's flash
  path) given `models.bert.tp_param_shardings`' specs splits its compute
  over their axis as Megatron does (each rank its heads, hidden units
  and vocabulary rows; `models/bert.py`) and computes from the stored
  blocks, so their gradients are the blocks' with no exchange over the
  axis;
- any other net or spec list computes with the whole weights, as GSPMD's
  layout gives the reference: the step gathers them once (a transient,
  one all-gather of one flat buffer a dtype and axis), and their whole
  gradients are averaged over the data axis and cut into the blocks (a
  reduce-scatter where the data axis is the cut one).

Sequence-parallel regions (BERT's ``seq_shard_axis``) run on the rank's
rows, so their parameters' gradients (the LayerNorms' γ and β, and under
Megatron SP the biases and embeddings added on the rank's rows) are the
rank's shares: the regions name them to the step
(`_layout.partial_grads`), which sums them over the axis in one flat
all-reduce. The dropout keys are the world's (the mesh's first rank's
base key, sent to every rank), folded with the rank's coordinate along
``data_axis`` when that axis has more than one rank, so data shards
draw distinct masks and replicas the same ones. At construction every
rank takes the mesh's first rank's parameters.

On an NCCL group the whole step, its collectives included, is captured
and replayed as one CUDA graph, as on one card. A gloo group's
collectives cannot be captured: on the card the step then runs eagerly
every time, exchanging through host memory (`collectives.transport`); it
says so once in the log, and its program-ledger entry's ``cache_key``
names it. `rebuild` moves the trainer onto a new mesh, carrying the
parameters, the optimizer state and the step counter (`fault.elastic`
calls it across a membership change). `shardcheck_report` pre-flights
the layout (`analysis.shardcheck`); ``MXNET_SHARDCHECK=warn|raise`` runs
its spec tier at construction. `remat` is `ROADMAP.md` §1 item 11b's
and raises. Under a data axis of more than one rank, a BatchNorm's
statistics are those of the rank's rows.

Observability (reference :173-176, :313-341): each capture (on a CPU net,
the first step of each input signature) is an entry of the program
ledger under ``"train.DataParallel.step"`` (`telemetry.compiles`), with
the FLOPs of its eager step (counted while the ledger is on) and its
kernels' costs from the capture's launch log; the capture's private
memory pool is the census owner ``"graph:train.DataParallel.step"``; and
the parameters (the blocks, as stored) and the optimizer state are the
device-memory census owners ``"train.params"`` and ``"train.optimizer"``
(`telemetry.hbm`).
As in the reference, the step charges no goodput state.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
import weakref

import torch

from .. import _graphs
from .. import amp
from .. import autograd
from .. import random as _random
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..telemetry import compiles as _compiles
from ..telemetry import hbm as _hbm
from ..telemetry import tracing
from . import _layout
from . import collectives as _coll
from .mesh import Mesh, current_mesh, mesh_scope

__all__ = ["DataParallel", "shard_train_step"]

_SMALL = 1 << 14
_EAGER_STEPS = _graphs.EAGER_CALLS  # a signature's eager steps before its capture
_LOG = logging.getLogger("incubator_mxnet_tpu_torch.parallel")


def _fusion_off():
    # MXNET_OPTIMIZER_AGGREGATION_SIZE <= 1 disables the small-parameter
    # segment, as in the reference
    agg = os.environ.get("MXNET_OPTIMIZER_AGGREGATION_SIZE")
    return agg is not None and agg.isdigit() and int(agg) <= 1


def _fused_indices(params, states, optimizer):
    """Indices of the small-parameter segment (the reference's `_fusable`),
    or [] when fewer than two qualify."""
    if _fusion_off() or not getattr(optimizer, "elementwise", False):
        return []
    idx = [i for i, (p, s) in enumerate(zip(params, states))
           if p.numel() <= _SMALL and p.dtype == torch.float32
           and isinstance(s, list)
           and all(isinstance(x, torch.Tensor) and x.shape == p.shape
                   for x in s)]
    return idx if len(idx) >= 2 else []


class _MeshPlan:
    """A trainer's layout on a mesh, stored by the spec: each trainable
    parameter's clean spec (axes of more than one rank), and, where it
    cuts, the rank's block as the gluon Parameter's tensor
    (`gluon.Parameter._place`): ``stored[i]`` is what the net and the
    optimizer hold, the block or the whole tensor. Every rank takes rank
    0's values before the blocks are cut."""

    def __init__(self, mesh, data_axis, net, tensors, specs, tp_axis=None):
        self.mesh = mesh
        self.data_axis = data_axis if data_axis in mesh.shape else None
        # the axis the model splits its compute over: it reads its cut
        # parameters' blocks itself, so their gradients are the blocks'
        self.tp_axis = (tp_axis if tp_axis in mesh.shape
                        and mesh.axis_size(tp_axis) > 1 else None)
        self.cspecs = [_layout.live_spec(_layout.clean_spec(s, t.dim(), mesh),
                                         mesh)
                       for s, t in zip(specs, tensors)]
        owners = _gluon_params(net)
        self.placements = [None] * len(tensors)
        for i, (t, c) in enumerate(zip(tensors, self.cspecs)):
            if not _layout.is_cut(c):
                continue
            param = owners.get(id(t))
            if param is None:
                raise MXNetError(
                    f"DataParallel: trainable parameter {i} {tuple(t.shape)}"
                    f" is cut by its spec {specs[i]} but is not a gluon "
                    f"Parameter, which a block is stored in")
            pl = _layout.Placement(mesh, c, t.shape)
            param._place(pl)
            self.placements[i] = pl
        # the tensors the net holds now: the blocks of the cut parameters
        self.stored = [p for p in net.parameters() if p.requires_grad]
        self.dp_group = (mesh.group(self.data_axis)
                         if self.data_axis is not None else None)
        self.dp = (mesh.axis_size(self.data_axis)
                   if self.data_axis is not None else 1)
        # a net that does not split its compute computes with the whole
        # weights: the step gathers them once (a transient), and their
        # whole gradients are averaged and cut into the blocks
        self.gathered = ([] if self.tp_axis is not None else
                         [i for i, pl in enumerate(self.placements)
                          if pl is not None])
        # {id(param): axis}: the parameters whose gradients the step's
        # sequence-parallel regions left as this rank's share
        self.partial = {}

    @property
    def shards(self):
        """The rank's stored tensors (blocks where the spec cuts)."""
        return self.stored

    def axes(self):
        """Every mesh axis the step exchanges over."""
        axes = {a for c in self.cspecs for axs in c for a in axs}
        if self.data_axis is not None:
            axes.add(self.data_axis)
        if self.tp_axis is not None:
            axes.add(self.tp_axis)
        return sorted(axes)

    def groups(self):
        """Every process group the step exchanges over."""
        return [g for g in (self.mesh.group(a) for a in self.axes())
                if g is not None]

    def split(self, x):
        return (x if self.data_axis is None
                else _layout.split_batch(x, self.mesh, self.data_axis))

    def key(self, base_key):
        """The rank's base key: the world's, folded with the rank's index
        along the data axis when it has more than one rank."""
        if self.dp == 1:
            return base_key
        from ..ops._philox import fold

        n = torch.full_like(base_key[0], self.mesh.coordinate(self.data_axis))
        return torch.stack(fold((base_key[0], base_key[1]), n))

    @torch.no_grad()
    def wholes(self):
        """The whole weights of :attr:`gathered` (one all-gather of one
        flat buffer per dtype and axis; leaves that take a gradient)."""
        out = [None] * len(self.stored)
        by_axis: dict = {}
        for i in self.gathered:
            pl = self.placements[i]
            axes = [a for axs in pl.cspec for a in axs]
            if len(axes) == 1:
                out[i] = self.stored[i].new_empty(pl.shape)
                by_axis.setdefault(axes[0], {})[i] = pl.dim(axes[0])
            else:
                out[i] = pl.gather(self.stored[i])
        for axis, dims in by_axis.items():
            _layout.flat_all_gather(self.stored, out, list(dims), dims,
                                    self.mesh, axis)
        return {i: out[i].requires_grad_(True) for i in self.gathered}

    def scope(self, wholes):
        stack = contextlib.ExitStack()
        table = {id(self.placements[i]): w for i, w in wholes.items()}
        for cm in (mesh_scope(self.mesh), _layout.laid_out(self.data_axis),
                   _layout.tensor_parallel(self.mesh, self.tp_axis),
                   _layout.partial_grads(self.partial),
                   _layout.whole_params(table)):
            stack.enter_context(cm)
        return stack

    def reduce(self, loss, grads):
        """(mean loss, the rank's gradients of its stored tensors). The
        shares that sequence-parallel regions left (LayerNorms' γ and β,
        the biases and embeddings added on the rank's rows) are summed
        over their axis in one all-reduce; then every gradient and the
        loss are averaged over the data axis in one all-reduce; the whole
        gradients of :attr:`gathered` are then cut into the blocks. A
        tensor-parallel model's cut gradients are the blocks' already.
        Each exchange sends one flat buffer per dtype."""
        vals = list(grads) + [loss.reshape(1)]
        sums: dict = {}
        for i, p in enumerate(self.stored):
            axis = self.partial.get(id(p))
            if axis is not None:
                sums.setdefault(axis, []).append(i)
        for axis, idx in sums.items():
            _layout.flat_all_reduce(vals, idx, self.mesh.group(axis), "sum")
        # a whole gradient cut over the data axis alone: its mean is
        # reduce-scattered into the rank's block
        scatter = {}
        if self.dp_group is not None:
            scatter = {i: self.placements[i].dim(self.data_axis)
                       for i in self.gathered
                       if self.placements[i].dim(self.data_axis) is not None}
            if scatter:
                _layout.flat_reduce_scatter(vals, list(scatter), scatter,
                                            self.mesh, self.data_axis)
                for i in scatter:
                    vals[i] = vals[i] / self.dp
            _layout.flat_all_reduce(
                vals, [i for i in range(len(vals)) if i not in scatter],
                self.dp_group, "mean")
        loss = vals[-1].reshape(())
        for i in self.gathered:
            if i not in scatter:
                vals[i] = self.placements[i].block_of(vals[i]).contiguous()
        return loss, vals[:-1]

    def norm_groups(self, i):
        """The groups a cut parameter's per-tensor norms are summed over
        (the axes its spec cuts)."""
        return [self.mesh.group(a) for axs in self.cspecs[i] for a in axs]


def _gluon_params(net):
    """{id(tensor): gluon Parameter} of a gluon net (empty for another
    module)."""
    collect = getattr(net, "collect_params", None)
    if collect is None:
        return {}
    return {id(p._data._data): p for p in collect().values()
            if p._data is not None}


def _build_pure_step(net, loss_fn, optimizer, states, plan=None):
    """``(step, update, params, fused)``. ``step(t, lr, wd, base_key, x, y)
    -> loss`` is the reference's pure step with the parameters and
    ``states`` updated in place and ``t`` incremented in place; ``t``
    (int64), ``lr``, ``wd`` (float64) and ``base_key`` (two int64 words)
    are tensors on the net's device. ``update(grads, t, lr, wd)`` is its
    optimizer part; ``fused`` the small-parameter segment's indices. With
    a :class:`_MeshPlan` the step takes the rank's rows of the batch,
    averages the gradients over the data axis and updates the stored
    tensors (the blocks of the cut parameters), with a per-tensor rule's
    norms summed over the cut axes."""
    from ..optimizer.optimizer import block_norms

    params = plan.stored if plan is not None else \
        [p for p in net.parameters() if p.requires_grad]
    fused = _fused_indices(params, states, optimizer)
    rest = sorted(set(range(len(params))) - set(fused))
    cut = ({i for i, pl in enumerate(plan.placements) if pl is not None}
           if plan is not None else set())
    # what the last step applied; kept off the step function itself, whose
    # closure would then reference it (a cycle that keeps the net alive
    # until a cyclic collection, which may run inside a later capture)
    stats = {"grad_bytes": None}

    @torch.no_grad()
    def update(grads, t, lr, wd):
        optimizer.step_multi([params[i] for i in fused],
                             [grads[i] for i in fused],
                             [states[i] for i in fused], lr, wd, t)
        for i in rest:
            if i in cut and not optimizer.elementwise:
                with block_norms(plan.norm_groups(i)):
                    optimizer.step(params[i], grads[i], states[i], lr, wd, t)
            else:
                optimizer.step(params[i], grads[i], states[i], lr, wd, t)

    def step(t, lr, wd, base_key, x, y):
        scope = contextlib.nullcontext()
        targets = params
        if plan is not None:
            x, y = plan.split(x), plan.split(y)
            base_key = plan.key(base_key)
            wholes = plan.wholes()
            targets = [wholes.get(i, p) for i, p in enumerate(params)]
            scope = plan.scope(wholes)
        # the step differentiates whatever autograd mode its caller is in
        with torch.enable_grad(), autograd.train_mode(), \
                _random.trace_key_scope(base_key, t), scope:
            loss = loss_fn(net(x), y).mean()
            grads = torch.autograd.grad(loss, targets, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(targets, grads)]
        loss = loss.detach()
        if plan is not None:
            loss, grads = plan.reduce(loss, grads)
        stats["grad_bytes"] = sum(g.numel() * g.element_size()
                                  for g in grads)
        update(grads, t, lr, wd)
        with torch.no_grad():
            t.add_(1)
        return loss

    step.stats = stats
    return step, update, params, fused


class _Capture:
    """One input signature's graph and its static buffers."""

    def __init__(self, x, y):
        self.x, self.y = x.clone(), y.clone()
        self.calls = 0
        self.graph = None
        self.loss = None
        self.flops = None   # the eager step's torch FLOPs (ledger on)


class DataParallel:
    """The compiled training step of a net on one card.

    Usage::

        dp = DataParallel(net, loss_fn, optimizer.Adam(1e-4))
        loss = dp.step(x_batch, y_batch)   # updates net's parameters

    ``step`` differentiates ``loss_fn(net(x), y).mean()`` and applies the
    optimizer to every trainable parameter. On the card there is one graph
    for each input signature (shape and dtype of x and y, AMP on or off);
    ``captures`` counts them."""

    def __init__(self, net, loss_fn, optimizer, mesh=None, data_axis="dp",
                 param_shardings=None, remat=None):
        if remat is not None:
            raise MXNetError("DataParallel: remat is not ported yet "
                             "(ROADMAP.md §1 item 11b)")
        if mesh is None:
            # the ambient `with mesh_scope(...)`, as in the reference
            mesh = current_mesh()
        if mesh is not None and not isinstance(mesh, Mesh):
            raise MXNetError(f"DataParallel: mesh must be a parallel.Mesh "
                             f"(parallel.make_mesh), got {type(mesh)}")
        _unplace(net)
        params = [p for p in net.parameters() if p.requires_grad]
        if not params:
            raise MXNetError("DataParallel: the net has no trainable "
                             "parameters")
        self.net = net
        self.optimizer = optimizer
        self.mesh = mesh
        self._loss_fn = loss_fn
        self._data_axis = data_axis
        self._param_specs = (list(param_shardings)
                             if param_shardings is not None else None)
        self.device = params[0].device
        plan = None
        if mesh is not None:
            specs = self._param_specs or [()] * len(params)
            if len(specs) != len(params):
                raise MXNetError(f"DataParallel: {len(specs)} "
                                 f"param_shardings for {len(params)} "
                                 f"trainable parameters")
            _shardcheck_at_construction(self, params, specs, mesh)
            _sync_from_rank0(list(net.parameters()), mesh)
            tp_axis = (getattr(param_shardings, "tensor_parallel_axis", None)
                       if getattr(net, "supports_tensor_parallel", False)
                       else None)
            cut = [i for i, (p, sp) in enumerate(zip(params, specs))
                   if _layout.is_cut(_layout.live_spec(
                       _layout.clean_spec(sp, p.dim(), mesh), mesh))]
            if (cut and not optimizer.elementwise
                    and getattr(optimizer, "norm_combine", None) is None):
                raise MXNetError(
                    f"DataParallel: {type(optimizer).__name__} is neither "
                    f"elementwise nor declares how its per-tensor "
                    f"statistics combine over a cut (norm_combine); a "
                    f"parameter cut by its spec is updated by blocks")
            plan = _MeshPlan(mesh, data_axis, net, params, specs, tp_axis)
        self._plan = plan
        targets = plan.stored if plan is not None else params
        self.opt_states = [optimizer.create_state(i, p)
                           for i, p in enumerate(targets)]
        (self._step_fn, self._update_fn, self.params,
         self._fused) = _build_pure_step(net, loss_fn, optimizer,
                                         self.opt_states, plan)
        self._capturable = True
        if plan is not None and self.device.type == "cuda":
            eager = [g for g in plan.groups()
                     if _coll.transport(g, self.device) == "host"]
            if eager:
                self._capturable = False
                _LOG.warning(
                    "DataParallel: the step runs eagerly, not as a CUDA "
                    "graph: its %s group exchanges through host memory "
                    "and cannot be captured",
                    _tdist_backend(eager[0]))
        dev = self.device
        self._t_dev = torch.ones((), dtype=torch.int64, device=dev)
        self._lr_dev = torch.zeros((), dtype=torch.float64, device=dev)
        self._wd_dev = torch.zeros((), dtype=torch.float64, device=dev)
        self._base_key = torch.zeros(2, dtype=torch.int64, device=dev)
        self._host = {"lr": None, "wd": None}
        self._key_epoch = None
        self._captures: dict = {}
        self._eager_sigs = set()        # CPU: input signatures stepped
        self.captures = 0
        self._side = _graphs.SideStream()
        self._register_hbm_owners()

    def _register_hbm_owners(self):
        """Device-memory census owners (`telemetry.hbm`): the parameters
        (frozen ones too) and the optimizer state. The probes read the
        live tensors through a weakref (host state only)."""
        ref = weakref.ref(self)

        def _leaves(obj):
            if isinstance(obj, torch.Tensor):
                return [obj]
            if isinstance(obj, dict):
                obj = list(obj.values())
            if isinstance(obj, (list, tuple)):
                return [t for o in obj for t in _leaves(o)]
            return []

        def _params_probe():
            tr = ref()
            if tr is None:
                return None
            return {"arrays": list(tr.net.parameters())}

        def _opt_probe():
            tr = ref()
            if tr is None:
                return None
            return {"arrays": _leaves(tr.opt_states)}

        _hbm.register_owner("train.params", _params_probe)
        _hbm.register_owner("train.optimizer", _opt_probe)

    def _set_scalar(self, name, value):
        """Upload ``lr`` or ``wd`` only when it changed since the last step
        (into the same buffer, which the graphs read)."""
        if self._host[name] != value:
            getattr(self, f"_{name}_dev").fill_(value)
            self._host[name] = value

    def _prepare(self):
        """The step's device arguments, refreshed from the host's values."""
        self._set_scalar("lr", float(self.optimizer.learning_rate))
        self._set_scalar("wd", float(self.optimizer.wd))
        if self._key_epoch != _random.seed_epoch():
            # a new base key after mx.random.seed(), so a re-seed changes
            # the dropout streams (reference semantics)
            self._base_key.copy_(torch.tensor(_random.next_key()))
            if self._plan is not None:
                # one base key for the world: the mesh's first rank's
                _sync_from_rank0([self._base_key], self.mesh)
            self._key_epoch = _random.seed_epoch()
        return self._t_dev, self._lr_dev, self._wd_dev, self._base_key

    def step(self, x, y):
        """One training step on the batch ``(x, y)``; returns the mean loss
        (a 0-dim tensor of its own; an NDArray when ``x`` is one, as in
        the reference)."""
        if isinstance(x, NDArray):
            return NDArray(self.step(x._data, y._data if isinstance(
                y, NDArray) else y))
        self.optimizer.num_update += 1
        args = self._prepare()
        x = torch.as_tensor(x, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        sig = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               amp.amp_active(), amp.amp_active() and amp.amp_dtype())
        if self.device.type != "cuda" or not self._capturable:
            if sig in self._eager_sigs:
                return self._step_fn(*args, x, y)
            self._eager_sigs.add(sig)
            t0 = time.perf_counter()
            loss = self._step_fn(*args, x, y)
            self._ledger(t0, x, y, cache_key=self._eager_note())
            return loss
        cap = self._captures.get(sig)
        if cap is None:
            cap = self._captures[sig] = _Capture(x, y)
        else:
            cap.x.copy_(x)
            cap.y.copy_(y)
        cap.calls += 1
        if cap.calls <= _EAGER_STEPS:
            return self._eager(cap, args)
        if cap.graph is None:
            self._capture(cap, args)
        cap.graph.replay()
        return cap.loss.clone()

    def _eager(self, cap, args):
        """A warm-up step: the step function on a side stream (its torch
        FLOPs counted for the ledger while the ledger is on)."""
        def run():
            return self._step_fn(*args, cap.x, cap.y).clone()

        if not _compiles.is_enabled():
            return self._side.run(self.device, run)
        loss, cap.flops = self._side.run(
            self.device, lambda: _graphs.count_flops(run))
        return loss

    def _capture(self, cap, args):
        t0 = time.perf_counter()
        try:
            cap.graph, cap.loss = _graphs.capture(
                lambda: self._step_fn(*args, cap.x, cap.y),
                "DataParallel: the step",
                owner="graph:train.DataParallel.step")
        except MXNetError:
            self.optimizer.num_update -= 1
            cap.calls -= 1
            raise
        self.captures += 1
        self._ledger(t0, cap.x, cap.y, cap.flops, cap.graph.launch_log)

    def _eager_note(self):
        """The ledger's note for a step that runs eagerly on the card."""
        if self.device.type != "cuda":
            return None
        backend = _tdist_backend(self._plan.groups()[0])
        return (f"eager: {backend} group exchanges through host memory, "
                f"not captured")

    @staticmethod
    def _ledger(t0, x, y, flops=None, launch_log=None, cache_key=None):
        """One program-ledger entry for the step just built (a capture,
        or an eager net's first step of a signature)."""
        if _compiles.is_enabled():
            _compiles.record_capture("train.DataParallel.step",
                                     time.perf_counter() - t0, args=(x, y),
                                     donate=(0, 2, 3), flops=flops,
                                     launch_log=launch_log,
                                     cache_key=cache_key)
    def rebuild(self, mesh, data_axis=None, param_shardings=None,
                joining=None):
        """Move the trainer onto a new mesh (reference :459), carrying the
        parameters, the optimizer state and the step counter: each block
        is gathered whole on the old mesh and cut again by the new specs.
        Every rank of the new mesh calls it. Where a rank rejoins the
        fleet (`fault.elastic`), every rank passes ``joining``: True on
        the rank that rejoins (it gathers nothing on the mesh it left),
        False on the others; all then take the new mesh's first rank's
        parameters, state and counters."""
        if mesh is None:
            raise ValueError("DataParallel.rebuild requires a target mesh")
        specs = (list(param_shardings) if param_shardings is not None
                 else self._param_specs)
        with tracing.span("elastic.rebuild", devices=int(mesh.size)):
            if joining:
                whole = [self._placeholder_state(i, s)
                         for i, s in enumerate(self.opt_states)]
            else:
                whole = [self._whole_state(i, s)
                         for i, s in enumerate(self.opt_states)]
            counters = torch.tensor(
                [int(self._t_dev.item()), self.optimizer.num_update],
                dtype=torch.float64, device=self.device)
            _unplace(self.net, gather=not joining)
            self.__init__(self.net, self._loss_fn, self.optimizer, mesh=mesh,
                          data_axis=data_axis or self._data_axis,
                          param_shardings=specs)
            if joining is not None:
                # every rank takes the first rank's state and counters
                _sync_from_rank0([t for t in _layout.tree_leaves(whole)
                                  if isinstance(t, torch.Tensor)]
                                 + [counters], mesh)
            for i, (new, old) in enumerate(zip(self.opt_states, whole)):
                self._restore_state(i, new, old)
            self._t_dev.fill_(int(counters[0]))
            self.optimizer.num_update = int(counters[1])
        return self

    def _placeholder_state(self, i, state):
        """Zeros of a state's whole shape (a rejoining rank's, before it
        takes the fleet's values)."""
        if isinstance(state, (list, tuple)):
            return type(state)(self._placeholder_state(i, s) for s in state)
        if not isinstance(state, torch.Tensor):
            return state
        pl = self._placement(i)
        if pl is not None and state.shape == self.params[i].shape:
            return state.new_zeros(pl.shape)
        return torch.zeros_like(state)

    def _placement(self, i):
        plan = self._plan
        return None if plan is None else plan.placements[i]

    def _whole_state(self, i, state):
        """A parameter's optimizer state with each block gathered whole."""
        pl = self._placement(i)
        if isinstance(state, (list, tuple)):
            return type(state)(self._whole_state(i, s) for s in state)
        if not isinstance(state, torch.Tensor):
            return state
        if pl is not None and state.shape == self.params[i].shape:
            return pl.gather(state).clone()
        return state.detach().clone()

    @torch.no_grad()
    def _restore_state(self, i, new, old):
        if isinstance(new, (list, tuple)):
            for a, b in zip(new, old):
                self._restore_state(i, a, b)
            return
        if not isinstance(new, torch.Tensor):
            return
        pl = self._placement(i)
        if pl is not None and tuple(old.shape) == pl.shape:
            old = pl.block_of(old.to(new.device))
        new.copy_(old)

    def stored_bytes(self):
        """This rank's bytes of trainable parameters (as stored: blocks
        where the spec cuts), of the gradients the last step applied (None
        before a step) and of the optimizer state, counted from its
        tensors."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts
                       if isinstance(t, torch.Tensor))

        return {"params": nbytes(self.params),
                "grads": self._step_fn.stats["grad_bytes"],
                "optimizer": nbytes(_layout.tree_leaves(self.opt_states))}

    def shardcheck_report(self, x=None, y=None, hbm_budget_gb=None,
                          mode=None, compile=True):  # noqa: A002
        """Pre-flight the trainer's layout (reference :343) with
        `analysis.shardcheck`: the spec tier over every trainable
        parameter (its whole shape and spec) and its optimizer state, the
        per-rank bytes those specs leave; given a batch (and ``compile``),
        the census tier: one eager step on it, its exchanges counted by
        op, the parameters, the state and the step counter put back after
        it, and SC004 for a stored tensor the step did not update in place
        by address."""
        from ..analysis.shardcheck import _apply_mode, shardcheck

        specs = self._param_specs or [()] * len(self.params)
        wholes = [self._whole_meta(i) for i in range(len(self.params))]
        states = [self._whole_meta_state(i, s)
                  for i, s in enumerate(self.opt_states)]
        state_specs = [
            _layout.tree_map(
                lambda leaf, _sp=sp, _shape=tuple(w.shape):
                    (_sp if tuple(getattr(leaf, "shape", ())) == _shape
                     else ()), st)
            for st, sp, w in zip(states, specs, wholes)]
        mesh = self.mesh
        step, args, arg_specs = None, [wholes, states], [list(specs),
                                                         state_specs]
        if x is not None and compile:
            step = self._census_step
            data = ((self._data_axis,) if mesh is not None
                    and self._data_axis in mesh.shape else ())
            args += [x, y]
            arg_specs += [data, data]
        self._census_moved = []
        report = shardcheck(step, *args, mesh=mesh, specs=arg_specs,
                            hbm_budget_gb=hbm_budget_gb,
                            name="DataParallel.step")
        names = _param_names(self.net, len(self.params))
        for i in self._census_moved:
            report.add_rule(
                "SC004",
                f"{names[i]} was not updated in place by address: the "
                f"captured step reads the old tensor",
                severity="warn", site=names[i],
                nbytes=self.params[i].numel() * self.params[i].element_size())
        _apply_mode(report, mode)
        return report

    def _whole_meta(self, i):
        from ..analysis.shardcheck import ShapeDtype

        p = self.params[i]
        pl = self._placement(i)
        return ShapeDtype(pl.shape if pl is not None else p.shape, p.dtype)

    def _whole_meta_state(self, i, state):
        from ..analysis.shardcheck import ShapeDtype

        if isinstance(state, (list, tuple)):
            return type(state)(self._whole_meta_state(i, s) for s in state)
        if not isinstance(state, torch.Tensor):
            return state
        pl = self._placement(i)
        if pl is not None and state.shape == self.params[i].shape:
            return ShapeDtype(pl.shape, state.dtype)
        return ShapeDtype(state.shape, state.dtype)

    def _census_step(self, _params, _states, x, y):
        """One eager step on ``(x, y)`` for shardcheck's census tier, the
        trainer's state put back after it (the parameters, the optimizer
        state and the counters). Notes in ``_census_moved`` the stored
        tensors the step rebound instead of updating in place."""
        leaves = [s for s in _layout.tree_leaves(self.opt_states)
                  if isinstance(s, torch.Tensor)]
        saved = [p.detach().clone() for p in self.params]
        saved_states = [s.detach().clone() for s in leaves]
        ptrs = [p.data_ptr() for p in self.params]
        t, num_update = self._t_dev.clone(), self.optimizer.num_update
        try:
            args = self._prepare()
            self._step_fn(*args, torch.as_tensor(x, device=self.device),
                          torch.as_tensor(y, device=self.device))
            current = [p for p in self.net.parameters() if p.requires_grad]
            self._census_moved = [
                i for i, p in enumerate(current)
                if i < len(ptrs) and p.data_ptr() != ptrs[i]]
        finally:
            with torch.no_grad():
                for p, v in zip(self.params, saved):
                    p.copy_(v)
                for s, v in zip(leaves, saved_states):
                    s.copy_(v)
                self._t_dev.copy_(t)
            self.optimizer.num_update = num_update


def _param_names(net, n):
    """The trainable parameters' names (their indices for another
    module)."""
    collect = getattr(net, "collect_params", None)
    if collect is None:
        return [f"param/{i}" for i in range(n)]
    names = [k for k, p in collect().items() if p.grad_req != "null"]
    return names if len(names) == n else [f"param/{i}" for i in range(n)]


def _tdist_backend(group):
    return _coll.group_backend(group)


def _unplace(net, gather=True):
    """Every gluon Parameter of ``net`` stored as a block holds its whole
    tensor again: gathered on the mesh it was cut on (every rank of its
    axes calls it), or, with ``gather=False`` (a rank that left that mesh),
    zeros of the whole shape that the caller overwrites."""
    collect = getattr(net, "collect_params", None)
    if collect is None:
        return
    for p in collect().values():
        pl = getattr(p, "_placement", None)
        if pl is None:
            continue
        if gather:
            p._unplace()
        else:
            t = p._data._data
            p._placement = None
            p._bind(t.new_zeros(pl.shape))


def _shardcheck_at_construction(dp, params, specs, mesh):
    """``MXNET_SHARDCHECK=warn|raise``: the spec tier over the layout at
    construction (reference: the trainer's construction-time run)."""
    mode = (os.environ.get("MXNET_SHARDCHECK") or "").strip().lower()
    if mode not in ("warn", "raise"):
        return
    from ..analysis.shardcheck import ShapeDtype, shardcheck

    shardcheck(None, [ShapeDtype(p.shape, p.dtype) for p in params],
               mesh=mesh, specs=(list(specs),), name="DataParallel",
               mode=mode)


@torch.no_grad()
def _sync_from_rank0(tensors, mesh):
    """Every rank of ``mesh`` takes the values of its first rank's
    ``tensors`` (one broadcast of one flat buffer per dtype over the
    mesh's ranks)."""
    import torch.distributed as tdist

    group = mesh.group_all()
    if group is None:
        return
    src = tdist.get_rank() == int(mesh.devices.min())
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        if not src:
            flat.zero_()
        flat = _coll._raw_all_reduce(flat, group, "sum")
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def shard_train_step(step_fn, mesh, in_specs, out_specs):
    """``step_fn`` run SPMD over ``mesh`` (the reference's shard_map,
    :520): every rank passes the global inputs, ``step_fn`` gets this
    rank's block of each (``in_specs``, one spec per input) inside the
    mesh's scope, where the collectives bind to its axes, and its output
    blocks (``out_specs``: one spec, or one per output) are gathered into
    global outputs."""
    in_specs = tuple(in_specs)

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_train_step: {len(args)} inputs for "
                             f"{len(in_specs)} in_specs")
        local = [_layout.local_slice(a, _layout.clean_spec(s, a.dim(), mesh),
                                     mesh) if isinstance(a, torch.Tensor)
                 else a for a, s in zip(args, in_specs)]
        with mesh_scope(mesh):
            out = step_fn(*local)
        single = not isinstance(out, (tuple, list))
        outs = [out] if single else list(out)
        specs = ([out_specs] if single or not _is_spec_list(out_specs)
                 else list(out_specs))
        if len(specs) == 1 and len(outs) > 1:
            specs = specs * len(outs)
        res = [_gather_out(o, s, mesh) for o, s in zip(outs, specs)]
        return res[0] if single else type(out)(res)

    return run


def _is_spec_list(specs):
    return (isinstance(specs, (list, tuple)) and len(specs) > 0
            and all(s is None or isinstance(s, (tuple, list))
                    for s in specs))


def _gather_out(x, spec, mesh):
    """A global output from this rank's block: each cut dimension
    gathered (its blocks are whole, so sizes multiply)."""
    if not isinstance(x, torch.Tensor):
        return x
    cspec = _layout.clean_spec(spec, x.dim(), mesh)
    for d, axes in enumerate(cspec):
        for a in reversed(axes):
            x = _coll._raw_all_gather(x, mesh.group(a), d)
    return x
