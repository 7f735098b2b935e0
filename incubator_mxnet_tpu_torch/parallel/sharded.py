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
trainable parameter, `models.bert.tp_param_shardings`) places each
parameter's optimizer state: the rank's block of the parameter
(`parallel._layout`) is a view of the whole tensor, the optimizer
updates the block, and its state is made on the block, so a state shaped
like the parameter is sharded like it and a scalar is replicated. The
parameters themselves, and their gradients, stay whole on every rank:
the net computes with them and is current between steps, so the specs
save optimizer-state memory only (`ROADMAP.md` §3). The forward and
backward run on the rank's rows of the batch; the gradients are averaged
over ``data_axis`` (one all-reduce of one flat buffer a dtype), each
rank applies the optimizer to its blocks, and the updated blocks are
gathered into the whole parameters (one all-gather of one flat buffer a
dtype and axis), so the replicas of a replicated parameter hold the same
bits. The optimizer
must be elementwise where a parameter is cut. How the compute is split:

- a model that supports it (``supports_tensor_parallel``: BERT's flash
  path) given `models.bert.tp_param_shardings`' specs splits its compute
  over their axis as Megatron does (each rank its heads, hidden units
  and vocabulary rows; `models/bert.py`), and the cut parameters'
  gradient shares are summed over the axis straight into the rank's
  blocks (one reduce-scatter of one flat buffer a dtype) before the data
  axis's mean;
- any other net or spec list computes with the whole parameters on every
  rank, which is what GSPMD's layout gives the reference too.

Sequence-parallel regions (BERT's ``seq_shard_axis``) run on the rank's
rows, so their parameters' gradients (the LayerNorms' γ and β) are the
rank's shares: the regions name them to the step
(`_layout.partial_grads`), which sums them over the axis in one flat
all-reduce. The dropout keys are the world's (rank 0's base key, sent to
every rank), folded with the rank's coordinate along ``data_axis`` when
that axis has more than one rank, so data shards draw distinct masks and
replicas the same ones. At construction every rank takes rank 0's
parameters.

On an NCCL group the whole step, its collectives included, is captured
and replayed as one CUDA graph, as on one card. A gloo group's
collectives cannot be captured: on the card the step then runs eagerly
every time, exchanging through host memory (`collectives.transport`); it
says so once in the log, and its program-ledger entry's ``cache_key``
names it. `rebuild` moves the trainer onto a new mesh, carrying the
parameters, the optimizer state and the step counter. `remat` is
`ROADMAP.md` §1 item 11b's and `shardcheck_report` item 13's: both
raise. Under a data axis of more than one rank, a BatchNorm's statistics
are those of the rank's rows.

Observability (reference :173-176, :313-341): each capture (on a CPU net,
the first step of each input signature) is an entry of the program
ledger under ``"train.DataParallel.step"`` (`telemetry.compiles`), with
the FLOPs of its eager step (counted while the ledger is on) and its
kernels' costs from the capture's launch log; the capture's private
memory pool is the census owner ``"graph:train.DataParallel.step"``; and
the parameters and the optimizer state are the device-memory census
owners ``"train.params"`` and ``"train.optimizer"`` (`telemetry.hbm`).
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
    """A trainer's layout on a mesh: each trainable parameter's spec, its
    whole tensor (the net's, which the step computes with) and the rank's
    block of it (a view, which the optimizer updates; the tensor itself
    where the spec cuts nothing)."""

    def __init__(self, mesh, data_axis, params, specs, tp_axis=None):
        self.mesh = mesh
        self.data_axis = data_axis if data_axis in mesh.shape else None
        # the axis the model splits its compute over (its cut parameters'
        # gradients are then shares, summed over it)
        self.tp_axis = (tp_axis if tp_axis in mesh.shape
                        and mesh.axis_size(tp_axis) > 1 else None)
        self.full = params
        self.cspecs = [_layout.clean_spec(s, p.dim(), mesh)
                       for s, p in zip(specs, params)]
        # the blocks are views of the whole tensors: what a load into the
        # net writes, the optimizer reads
        self.shards = [
            _layout.local_slice(p.detach(), c, mesh)
            if _layout.is_cut(c) else p
            for p, c in zip(params, self.cspecs)]
        self.dp_group = (mesh.group(self.data_axis)
                         if self.data_axis is not None else None)
        self.dp = (mesh.axis_size(self.data_axis)
                   if self.data_axis is not None else 1)
        # under tensor parallelism a parameter cut over the tp axis alone
        # has a gradient that is this rank's share of the whole: it is
        # summed straight into the rank's block (a reduce-scatter)
        self.scatter_dims = {}
        if self.tp_axis is not None:
            for i, c in enumerate(self.cspecs):
                d = _layout.cut_dim(c, self.tp_axis)
                if d is not None:
                    self.scatter_dims[i] = d
        # the updated blocks of a parameter cut over one axis of more than
        # one rank are joined in one all-gather per axis
        self.gather_dims = {}
        for i, c in enumerate(self.cspecs):
            axes = [a for axs in c for a in axs]
            if len(axes) == 1 and mesh.axis_size(axes[0]) > 1:
                self.gather_dims.setdefault(axes[0], {})[i] = \
                    _layout.cut_dim(c, axes[0])
        # {id(param): axis}: the parameters whose gradients the step's
        # sequence-parallel regions left as this rank's share
        self.partial = {}

    def groups(self):
        """Every process group the step exchanges over."""
        axes = {a for c in self.cspecs for axs in c for a in axs}
        if self.data_axis is not None:
            axes.add(self.data_axis)
        return [g for g in (self.mesh.group(a) for a in sorted(axes))
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

    def scope(self):
        stack = contextlib.ExitStack()
        for cm in (mesh_scope(self.mesh), _layout.laid_out(self.data_axis),
                   _layout.tensor_parallel(self.mesh, self.tp_axis),
                   _layout.partial_grads(self.partial)):
            stack.enter_context(cm)
        return stack

    def reduce(self, loss, grads):
        """(mean loss, the rank's gradient blocks). Under tensor
        parallelism the cut parameters' shares are summed over its axis
        into the rank's blocks (one reduce-scatter); the shares that
        sequence-parallel regions left (their LayerNorms' γ and β) are
        summed over their axis, over tp in one all-reduce with any cut
        parameter the reduce-scatter does not take; then the gradients
        and the loss are averaged over the data axis. Each exchange sends
        one flat buffer per dtype."""
        vals = list(grads) + [loss.reshape(1)]
        sums: dict = {}
        if self.tp_axis is not None:
            _layout.flat_reduce_scatter(vals, list(self.scatter_dims),
                                        self.scatter_dims, self.mesh,
                                        self.tp_axis)
            sums[self.tp_axis] = [
                i for i, c in enumerate(self.cspecs)
                if _layout.is_cut(c) and i not in self.scatter_dims]
        for i, p in enumerate(self.full):
            axis = self.partial.get(id(p))
            if axis is not None:
                sums.setdefault(axis, []).append(i)
        for axis, idx in sums.items():
            if idx:
                _layout.flat_all_reduce(vals, idx, self.mesh.group(axis),
                                        "sum")
        if self.dp_group is not None:
            _layout.flat_all_reduce(vals, range(len(vals)), self.dp_group,
                                    "mean")
        loss = vals[-1].reshape(())
        blocks = [g if i in self.scatter_dims or not _layout.is_cut(c)
                  else _layout.local_slice(g, c, self.mesh).contiguous()
                  for i, (g, c) in enumerate(zip(vals[:-1], self.cspecs))]
        return loss, blocks

    @torch.no_grad()
    def gather(self):
        """The updated blocks joined into the whole parameters (a block
        that is the whole tensor is a view of it already)."""
        for axis, dims in self.gather_dims.items():
            _layout.flat_all_gather(self.shards, self.full, list(dims), dims,
                                    self.mesh, axis)
        done = {i for dims in self.gather_dims.values() for i in dims}
        for i, (p, b, c) in enumerate(zip(self.full, self.shards,
                                          self.cspecs)):
            if i not in done and _layout.is_cut(c) and b.shape != p.shape:
                p.copy_(_layout.gather_full(b, c, p.shape, self.mesh))


def _build_pure_step(net, loss_fn, optimizer, states, plan=None):
    """``(step, update, params, fused)``. ``step(t, lr, wd, base_key, x, y)
    -> loss`` is the reference's pure step with the parameters and
    ``states`` updated in place and ``t`` incremented in place; ``t``
    (int64), ``lr``, ``wd`` (float64) and ``base_key`` (two int64 words)
    are tensors on the net's device. ``update(grads, t, lr, wd)`` is its
    optimizer part; ``fused`` the small-parameter segment's indices. With
    a :class:`_MeshPlan` the step takes the rank's rows of the batch,
    averages the gradients over the data axis and updates the blocks."""
    params = [p for p in net.parameters() if p.requires_grad]
    targets = plan.shards if plan is not None else params
    fused = _fused_indices(targets, states, optimizer)
    rest = sorted(set(range(len(params))) - set(fused))

    @torch.no_grad()
    def update(grads, t, lr, wd):
        optimizer.step_multi([targets[i] for i in fused],
                             [grads[i] for i in fused],
                             [states[i] for i in fused], lr, wd, t)
        for i in rest:
            optimizer.step(targets[i], grads[i], states[i], lr, wd, t)

    def step(t, lr, wd, base_key, x, y):
        scope = contextlib.nullcontext()
        if plan is not None:
            x, y = plan.split(x), plan.split(y)
            base_key = plan.key(base_key)
            scope = plan.scope()
        # the step differentiates whatever autograd mode its caller is in
        with torch.enable_grad(), autograd.train_mode(), \
                _random.trace_key_scope(base_key, t), scope:
            loss = loss_fn(net(x), y).mean()
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        loss = loss.detach()
        if plan is not None:
            loss, grads = plan.reduce(loss, grads)
        update(grads, t, lr, wd)
        if plan is not None:
            plan.gather()
        with torch.no_grad():
            t.add_(1)
        return loss

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
            _sync_from_rank0(list(net.parameters()))
            tp_axis = (getattr(param_shardings, "tensor_parallel_axis", None)
                       if getattr(net, "supports_tensor_parallel", False)
                       else None)
            plan = _MeshPlan(mesh, data_axis, params, specs, tp_axis)
            if (any(_layout.is_cut(c) for c in plan.cspecs)
                    and not getattr(optimizer, "elementwise", False)):
                raise MXNetError(
                    f"DataParallel: {type(optimizer).__name__} is not "
                    f"elementwise; a parameter cut by its spec needs an "
                    f"elementwise optimizer (each rank updates its block)")
        self._plan = plan
        targets = plan.shards if plan is not None else params
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
                # one base key for the world: rank 0's
                _sync_from_rank0([self._base_key])
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
    def rebuild(self, mesh, data_axis=None, param_shardings=None):
        """Move the trainer onto a new mesh (reference :459), carrying the
        parameters, the optimizer state and the step counter: each state
        block is gathered whole on the old mesh and cut again by the new
        specs. Every rank of the world calls it."""
        if mesh is None:
            raise ValueError("DataParallel.rebuild requires a target mesh")
        specs = (list(param_shardings) if param_shardings is not None
                 else self._param_specs)
        with tracing.span("elastic.rebuild", devices=int(mesh.size)):
            whole = [self._whole_state(i, s)
                     for i, s in enumerate(self.opt_states)]
            t, num_update = int(self._t_dev.item()), self.optimizer.num_update
            self.__init__(self.net, self._loss_fn, self.optimizer, mesh=mesh,
                          data_axis=data_axis or self._data_axis,
                          param_shardings=specs)
            for i, (new, old) in enumerate(zip(self.opt_states, whole)):
                self._restore_state(i, new, old)
            self._t_dev.fill_(t)
            self.optimizer.num_update = num_update
        return self

    def _block_spec(self, i):
        plan = self._plan
        if plan is None or not _layout.is_cut(plan.cspecs[i]):
            return None
        return plan.cspecs[i]

    def _whole_state(self, i, state):
        """A parameter's optimizer state with each block gathered whole."""
        c = self._block_spec(i)
        if isinstance(state, (list, tuple)):
            return type(state)(self._whole_state(i, s) for s in state)
        if not isinstance(state, torch.Tensor):
            return state
        if c is not None and state.shape == self._plan.shards[i].shape:
            return _layout.gather_full(state, c, self.params[i].shape,
                                       self._plan.mesh).clone()
        return state.detach().clone()

    @torch.no_grad()
    def _restore_state(self, i, new, old):
        if isinstance(new, (list, tuple)):
            for a, b in zip(new, old):
                self._restore_state(i, a, b)
            return
        if not isinstance(new, torch.Tensor):
            return
        c = self._block_spec(i)
        if c is not None and old.shape == self.params[i].shape:
            old = _layout.local_slice(old, c, self._plan.mesh)
        new.copy_(old)

    def shardcheck_report(self, x=None, y=None, hbm_budget_gb=None,  # noqa: ARG002
                          mode=None, compile=True):  # noqa: A002,ARG002
        raise MXNetError("DataParallel.shardcheck_report is not ported yet "
                         "(ROADMAP.md §1 item 13: analysis.shardcheck)")


def _tdist_backend(group):
    import torch.distributed as tdist

    return str(tdist.get_backend(group))


@torch.no_grad()
def _sync_from_rank0(tensors):
    """Every rank takes rank 0's values of ``tensors`` (one broadcast of
    one flat buffer per dtype over the world)."""
    import torch.distributed as tdist

    if not (tdist.is_initialized() and tdist.get_world_size() > 1):
        return
    src = tdist.get_rank() == 0
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        if not src:
            flat.zero_()
        flat = _coll._raw_all_reduce(flat, tdist.group.WORLD, "sum")
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
