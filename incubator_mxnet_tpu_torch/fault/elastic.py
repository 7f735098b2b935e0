"""Elastic training: survive a topology change without losing the run
(port of `incubator_mxnet_tpu/fault/elastic.py`: `checkpoint_layout`
:151, `reshard_state` :194, `reshard_net` :229, `ElasticController`
:302, `transition` :443, `_preflight` :606).

A rank that leaves (a preemption notice, the ``topology_change`` chaos
seam) or a rank that comes back turns into a coordinated
**membership-epoch transition**::

    STABLE ──trigger──▶ VOTE ──▶ PREFLIGHT ──▶ DRAIN ──▶ RENDEZVOUS ──▶ RESHARD
                       (store)  (shardcheck)  (save_now) (generation+1) (rebuild)

The reference runs one controller over many devices and simulates a
multi-host fleet in one process. The port runs one process per rank,
each with one card, so a transition is the fleet's:

- **triggers** (:meth:`ElasticController.poll`, at a drained step
  boundary): the ``topology_change`` seam (`fault.injection`; ``@rank``
  picks the rank that departs, ``grow=N`` brings the fleet back to N),
  `preemption.preempted()` (this rank departs), a peer's departure or
  re-admission marker (`dist.pending_departures`, `pending_rejoins`) and
  the fleet plane's crash markers (``fleet_crash_rank<r>.marker`` under
  `telemetry.tracing._flight_dir`, written by `telemetry.fleet`'s crash
  fanout);
- **vote**: every active rank posts what it saw through the store
  (ranks with a departure or crash marker are not waited for), so all
  agree on who leaves, and a departure is never half seen;
- **preflight**: the post-transition layout goes through
  `analysis.shardcheck`'s spec tier before anything commits: a layout
  that would silently replicate (SC001) or break the budget (SC006)
  aborts with :class:`ElasticTransitionAborted`;
- **drain** (the checkpointer's ``save_now``), **rendezvous**
  (`dist.rendezvous`: the roster, generation + 1) and **reshard**: the
  trainer is rebuilt on the survivors' mesh (`DataParallel.rebuild`: each
  block gathered whole over the old mesh's axes, which must lie among the
  survivors, and cut again by the specs on the new one), and
  `gluon.data.ElasticSampler` re-strides the unconsumed data.

The survivors' mesh keeps every axis but the data axis, which shrinks
to the survivors (dp 2 × tp 2 → dp 1 × tp 2). It spans part of the
world, so its groups are `parallel.mesh.SubGroup`\\ s. A rank that comes
back calls :meth:`ElasticController.rejoin`; the survivors see its
marker (or the ``grow`` seam) and grow the data axis again, and every
rank takes the first rank's parameters, state and counters
(``rebuild(joining=)``).

Checkpoints round-trip through the same machinery: `checkpoint_layout`
is the ``layout_fn`` for `preemption.TrainingCheckpointer` (mesh axes
and each leaf's spec fingerprint), and `reshard_net` / `reshard_state`
cut loaded whole values by those specs onto the live mesh when `resume`
sees another device count. In the port the device count is the
membership's rank count (one card a rank).

Env knobs (`util.env_knobs()`): ``MXNET_ELASTIC`` (default on; ``0``
turns a cross-topology resume into `preemption.LayoutMismatch` and
`poll` into a no-op), ``MXNET_ELASTIC_MIN_RANKS``,
``MXNET_ELASTIC_DRAIN_S``.
"""
from __future__ import annotations

import logging
import os
import pickle
import time

__all__ = ["elastic_enabled", "mesh_layout", "checkpoint_layout",
           "spec_fingerprint", "reshard_state", "reshard_net",
           "ElasticTransitionAborted", "ElasticController"]

_LOG = logging.getLogger("incubator_mxnet_tpu_torch.fault")
_VOTE = "mx/elastic/vote"


def elastic_enabled():
    """``MXNET_ELASTIC`` gate (default ON). Off = a checkpoint written
    under a different device count raises `preemption.LayoutMismatch`
    instead of resharding, and `ElasticController.poll` is a no-op."""
    v = (os.environ.get("MXNET_ELASTIC") or "").strip().lower()
    return v not in ("0", "false", "off", "no")


# -- layout sidecar ----------------------------------------------------------

def spec_fingerprint(sharding):
    """JSON-able fingerprint of a spec (the port's tuple, or a
    `parallel._layout.Placement`'s): one entry per dim — ``None``, an axis
    name, or a list of axis names, trailing Nones dropped. ``[]`` =
    explicitly replicated; ``None`` (the whole fingerprint) = unknown."""
    if sharding is None:
        return None
    spec = getattr(sharding, "cspec", sharding)
    out = []
    for e in tuple(spec):
        if e is None or e == ():
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append([str(a) for a in e] if len(e) > 1 else str(e[0]))
        else:
            out.append(str(e))
    while out and out[-1] is None:
        out.pop()
    return out


def _spec_from_fingerprint(fp, mesh):
    """Fingerprint -> (spec tuple or None, degraded). Axes the target mesh
    no longer has are dropped; `degraded` is True when any were, so the
    preflight can name a fully degraded large parameter (SC001)."""
    if fp is None:
        return None, False
    live = set(mesh.axis_names) if mesh is not None else set()
    entries, degraded = [], False
    for e in fp:
        if e is None:
            entries.append(None)
        elif isinstance(e, (list, tuple)):
            kept = tuple(a for a in e if a in live)
            degraded = degraded or len(kept) != len(e)
            entries.append(kept if len(kept) > 1
                           else (kept[0] if kept else None))
        elif e in live:
            entries.append(e)
        else:
            entries.append(None)
            degraded = True
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries), degraded


def mesh_layout(mesh):
    """``{"axes": [[name, size], ...]}`` for a mesh (None for no mesh)."""
    if mesh is None:
        return None
    return {"axes": [[str(n), int(s)] for n, s in
                     zip(mesh.axis_names, mesh.devices.shape)]}


def checkpoint_layout(trainer):
    """Rich layout sidecar for a `parallel.DataParallel` trainer: the
    format, the membership generation, the device (rank) and process
    counts, the mesh axes and each leaf's spec fingerprint (``param/<i>``
    in trainable-parameter order, ``opt/<i>/<j>`` per optimizer-state
    tensor: the parameter's spec where the state is shaped like its
    block, else replicated). Install it as the checkpointer's
    layout_fn::

        ckpt = TrainingCheckpointer(
            prefix, net, layout_fn=lambda: elastic.checkpoint_layout(dp))
    """
    import torch

    from ..parallel import _layout, dist

    layout = {"format": 2, "generation": dist.generation(),
              "device_count": int(dist.world_size()),
              "process_count": int(dist.num_processes())}
    mesh = getattr(trainer, "mesh", None)
    layout["mesh"] = mesh_layout(mesh)
    leaves = {}
    declared = getattr(trainer, "_param_specs", None)
    params = list(getattr(trainer, "params", ()) or ())
    specs = []
    for i, p in enumerate(params):
        spec = declared[i] if declared is not None else (
            () if mesh is not None else None)
        specs.append(spec)
        leaves[f"param/{i}"] = spec_fingerprint(spec)
    for i, s in enumerate(getattr(trainer, "opt_states", ()) or ()):
        tensors = [t for t in _layout.tree_leaves(s)
                   if isinstance(t, torch.Tensor)]
        for j, leaf in enumerate(tensors):
            same = i < len(params) and leaf.shape == params[i].shape
            leaves[f"opt/{i}/{j}"] = spec_fingerprint(
                specs[i] if same and specs[i] is not None else ())
    layout["leaves"] = leaves
    return layout


# -- resharding ----------------------------------------------------------------

def _cut(host, fp, mesh):
    """The rank's block on ``mesh`` of a whole host value (a tensor),
    cut by the fingerprint's spec; (block, degraded)."""
    from ..parallel import _layout

    spec, degraded = _spec_from_fingerprint(fp, mesh)
    cspec = _layout.live_spec(_layout.clean_spec(spec, host.dim(), mesh),
                              mesh)
    return _layout.local_slice(host, cspec, mesh).clone(), degraded


def reshard_state(tree, old_layout, new_mesh, specs=None,
                  key_prefix="param"):
    """Re-partition a tree of arrays onto ``new_mesh``, host-side: each
    leaf (a whole value: a numpy array or a tensor) becomes this rank's
    block (a tensor) of it under its target spec, from ``specs`` (one
    fingerprint per leaf, flatten order) or the layout sidecar's
    ``leaves`` map (``<key_prefix>/<i>``); axes the new mesh lost degrade
    to replicated. Non-array leaves and a None mesh pass through."""
    import numpy as onp
    import torch

    from ..parallel import _layout

    leaves = _layout.tree_leaves(tree)
    lmap = (old_layout or {}).get("leaves") or {}
    out, degraded_n = [], 0
    for i, leaf in enumerate(leaves):
        if new_mesh is None or not hasattr(leaf, "shape"):
            out.append(leaf)
            continue
        fp = (specs[i] if specs is not None
              else lmap.get(f"{key_prefix}/{i}"))
        host = (leaf.detach() if isinstance(leaf, torch.Tensor)
                else torch.from_numpy(onp.array(leaf, copy=True)))
        block, degraded = _cut(host, fp, new_mesh)
        degraded_n += bool(degraded)
        out.append(block)
    if degraded_n:
        _LOG.warning(
            "elastic.reshard_state: %d leaf spec(s) named axes the new "
            "mesh does not have — degraded to replicated", degraded_n)
    return _layout.tree_rebuild(tree, iter(out))


def reshard_net(net, old_layout, mesh=None):
    """Re-partition a net's (freshly loaded, whole) parameters onto the
    live topology, the `TrainingCheckpointer.resume` half of an elastic
    resume across a device-count change: on a mesh (``mesh`` or the
    ambient one) each trainable parameter keeps the rank's block of its
    sidecar spec (``param/<i>`` in trainable order) and frozen ones stay
    whole; with no mesh the values stay whole, for a `DataParallel` to
    cut. Returns the number of parameters moved."""
    from ..parallel import _layout
    from ..parallel.mesh import current_mesh
    from ..telemetry import registry, tracing
    from .retry import suppressed

    mesh = mesh if mesh is not None else current_mesh()
    lmap = (old_layout or {}).get("leaves") or {}
    t0 = time.perf_counter()
    n = trainable_i = 0
    with tracing.span("elastic.reshard_net",
                      devices=int(mesh.size) if mesh is not None else 1):
        for p in net.collect_params().values():
            try:
                p._check_initialized()
            except Exception as e:      # deferred-init param: nothing to move
                suppressed("elastic.reshard_net", e)
                continue
            fp = []
            if p.grad_req != "null":
                fp = lmap.get(f"param/{trainable_i}")
                trainable_i += 1
            if mesh is not None:
                spec, _ = _spec_from_fingerprint(fp, mesh)
                whole = p._whole_tensor()
                cspec = _layout.live_spec(
                    _layout.clean_spec(spec, whole.dim(), mesh), mesh)
                if _layout.is_cut(cspec):
                    p._place(_layout.Placement(mesh, cspec, whole.shape))
            n += 1
    registry.gauge(
        "mx_elastic_reshard_seconds",
        "wall seconds of the last host-side elastic reshard").set(
            time.perf_counter() - t0)
    _LOG.info("elastic.reshard_net: re-partitioned %d params onto the "
              "live topology", n)
    return n


# -- the controller ----------------------------------------------------------

class ElasticTransitionAborted(RuntimeError):
    """The shardcheck pre-flight rejected the post-transition layout: the
    transition did NOT commit (the fleet stays on the old generation and
    the old mesh). Non-retryable: the same layout would fail again."""

    non_retryable = True

    def __init__(self, findings, report=None):
        self.findings = list(findings)
        self.report = report
        named = "; ".join(
            f"{f.rule} @ {f.site}: {f.message}" for f in self.findings)
        super().__init__(
            f"elastic transition aborted by shardcheck pre-flight: {named}")


class ElasticController:
    """Membership-epoch state machine (see module docstring).

    Call :meth:`poll` at every DRAINED train-step boundary (no step in
    flight), on every active rank; it returns ``"stable"``, ``"shrunk"``
    or ``"grown"`` (this rank took part in a transition: the trainer is
    rebuilt on the new mesh, the sampler re-strided, `dist.generation`
    bumped), or ``"leave"`` (THIS rank departed: its state was
    checkpointed and its membership marked stale; exit 0 or call
    :meth:`rejoin` later).

    Parameters
    ----------
    trainer : parallel.DataParallel, optional
        Rebuilt on the survivors' mesh across a transition.
    checkpointer : preemption.TrainingCheckpointer, optional
        Drain target: `save_now` before every transition and departure.
    sampler : gluon.data.ElasticSampler, optional
        Re-strided over the new roster.
    min_ranks : int
        Floor for the rendezvous roster (``MXNET_ELASTIC_MIN_RANKS``).
    drain_s : float
        Rendezvous settle/timeout budget (``MXNET_ELASTIC_DRAIN_S``).
    hbm_budget_gb : float, optional
        Per-rank budget for the SC006 pre-flight check
        (``MXNET_SHARDCHECK_HBM_GB`` when unset).
    on_leave : callable, optional
        Called with the trigger after a clean departure.
    """

    def __init__(self, trainer=None, checkpointer=None, sampler=None,
                 min_ranks=None, drain_s=None, hbm_budget_gb=None,
                 on_leave=None):
        self.trainer = trainer
        self.checkpointer = checkpointer
        self.sampler = sampler
        self.min_ranks = int(min_ranks if min_ranks is not None
                             else os.environ.get(
                                 "MXNET_ELASTIC_MIN_RANKS", "1"))
        self.drain_s = (float(drain_s) if drain_s is not None else None)
        self.hbm_budget_gb = hbm_budget_gb
        self.on_leave = on_leave
        self._polls = {}          # generation -> polls made under it

    # -- triggers ------------------------------------------------------------
    def _crashed_ranks(self):
        """Fleet-plane crash markers naming a still-active peer."""
        import glob
        import re

        from ..parallel import dist
        from ..telemetry import tracing
        from .retry import suppressed

        try:
            d = tracing._flight_dir()
        except Exception as e:
            suppressed("elastic._crashed_ranks", e)
            return ()
        gone = set()
        for p in glob.glob(os.path.join(d, "fleet_crash_rank*.marker")):
            m = re.search(r"rank(\d+)\.marker$", p)
            if m:
                gone.add(int(m.group(1)))
        me = dist.rank()
        return tuple(sorted(r for r in gone
                            if r != me and r in dist.active_ranks()))

    @staticmethod
    def _multi():
        from ..parallel import dist

        return dist.is_initialized() and dist.num_processes() > 1

    def _pending_trigger(self):
        """(kind, detail) or None. ``leave`` = this rank departs;
        ``shrink`` = a peer departs; ``grow`` = the fleet widens."""
        from .. import preemption
        from ..parallel import dist
        from .injection import TopologyChanged, inject_at

        multi = self._multi()
        try:
            inject_at("topology_change")
        except TopologyChanged as e:
            if e.grow is not None:
                return ("grow", e.grow)
            return ("leave", e) if multi else ("shrink", e.shrink)
        if multi and preemption.preempted():
            return ("leave", "preemption")
        if multi and dist.pending_rejoins():
            return ("grow", None)
        if multi and dist.pending_departures():
            return ("shrink", None)
        if multi and self._crashed_ranks():
            return ("shrink", None)
        return None

    def _vote(self, trig):
        """Every active rank's trigger, by rank, through the store: each
        posts its own, then reads those of the ranks not already marked
        departed or crashed (a departure is seen by all or by none)."""
        from ..parallel import dist

        gen = dist.generation()
        seq = self._polls[gen] = self._polls.get(gen, 0) + 1
        gone = set(dist.pending_departures()) | set(self._crashed_ranks())
        voters = [r for r in dist.active_ranks() if r not in gone]
        store = dist._store()
        me = dist.rank()
        kind = None if trig is None else (trig[0], trig[1] if isinstance(
            trig[1], (int, type(None))) else None)
        pfx = f"{_VOTE}/g{gen}/{seq}"
        if seq > 1:
            # every voter read this rank's last vote before the step that
            # separates the two polls
            store.delete_key(f"{_VOTE}/g{gen}/{seq - 1}/{me:03d}")
        store.set(f"{pfx}/{me:03d}", pickle.dumps(kind))
        votes = {r: pickle.loads(bytes(store.get(f"{pfx}/{r:03d}")))
                 for r in voters}
        return votes

    # -- state machine -------------------------------------------------------
    def poll(self):
        """Run one trigger check at a drained step boundary; transition if
        one fired. Returns ``"stable" | "shrunk" | "grown" | "leave"``."""
        if not elastic_enabled():
            return "stable"
        trig = self._pending_trigger()
        if not self._multi():
            if trig is None:
                return "stable"
            kind, detail = trig
            if kind == "grow":
                return self.transition(grow=(detail if detail else True))
            return self.transition(shrink=detail)
        from ..parallel import dist

        votes = self._vote(trig)
        leavers = sorted(r for r, v in votes.items()
                         if v is not None and v[0] == "leave")
        if dist.rank() in leavers:
            return self._leave(trig[1])
        if leavers:
            return self.transition(
                shrink=len(votes) - len(leavers),
                survivors=[r for r in sorted(votes) if r not in leavers])
        grows = [v for v in votes.values()
                 if v is not None and v[0] == "grow"]
        if grows:
            sizes = [v[1] for v in grows if v[1]]
            return self.transition(grow=max(sizes) if sizes else True)
        if any(v is not None and v[0] == "shrink" for v in votes.values()):
            return self.transition(shrink=len(votes), survivors=sorted(votes))
        return "stable"

    def rejoin(self):
        """Departed-rank side of a grow: rendezvous back into the fleet at
        its next membership epoch (a roster of the whole world), take the
        fleet's parameters and state on the grown mesh. Returns
        ``"grown"``."""
        from ..parallel import dist

        return self.transition(grow=dist.num_processes(), joining=True)

    def _leave(self, why):
        from ..parallel import dist
        from ..telemetry import goodput, registry, tracing

        if self.checkpointer is not None:
            self.checkpointer.save_now()   # checkpoint lease inside
        with goodput.lease("drain"):
            gen, _ = dist.rendezvous(leave=True)
        registry.counter(
            "mx_elastic_departures_total",
            "clean elastic departures (this rank left the fleet)").inc()
        tracing.event("elastic.leave", generation=gen, reason=str(why))
        _LOG.warning("elastic: departing the fleet at generation %d (%s) "
                     "— exit 0 so the launcher keeps the survivors up",
                     gen, why)
        if self.on_leave is not None:
            self.on_leave(why)
        return "leave"

    def transition(self, shrink=None, grow=None, survivors=None,
                   joining=False):
        """Preflight -> drain -> rendezvous -> reshard, in either
        direction: ``shrink=N`` contracts the membership (``survivors``:
        the ranks that stay, when the vote knows them), ``grow=N`` (or
        ``True``) widens it; ``joining`` is the side of a rank coming
        back. Raises :class:`ElasticTransitionAborted` (pre-flight) BEFORE
        any state commits; afterwards the fleet is on generation N+1."""
        from ..parallel import dist
        from ..telemetry import goodput, registry, tracing

        growing = grow is not None
        was_active = dist.is_active()
        t0 = time.perf_counter()
        with tracing.span("elastic.transition", shrink=int(shrink or 0),
                          grow=int(grow or 0) if grow is not True else -1), \
                goodput.lease("reshard"):
            specs = None
            planned = (None if growing or self.trainer is None
                       else self._mesh_over(survivors))
            if planned is not None:
                self._check_blocks(survivors)
                specs = self._preflight(planned)    # raises on SC001/SC006
            if self.checkpointer is not None and not joining:
                # drain point: a rank that restarts instead of resharding
                # in place resumes from here across the layout change
                self.checkpointer.save_now()
            min_ranks = self.min_ranks
            if growing:
                min_ranks = max(min_ranks, (
                    int(grow) if grow is not True else
                    len(dist.active_ranks()) + len(dist.pending_rejoins())))
            elif survivors is not None:
                min_ranks = max(min_ranks, len(survivors))
            with goodput.lease("drain"):
                gen, members = dist.rendezvous(min_ranks=min_ranks,
                                               timeout_s=self.drain_s)
            new_mesh = self._mesh_over(members) if self._multi() else None
            if new_mesh is not None and self.trainer is not None:
                if specs is None:
                    specs = self._preflight(new_mesh)
                self.trainer.rebuild(new_mesh, param_shardings=specs,
                                     joining=(joining if growing else None))
            self._reshard_sampler(members, growing, joining)
            elapsed = time.perf_counter() - t0
            registry.counter(
                "mx_elastic_transitions_total",
                "committed elastic membership-epoch transitions").inc()
            registry.counter(
                "mx_elastic_scale_events_total",
                "committed elastic scale events by direction",
                labels={"direction": "up" if growing else "down"}).inc()
            if growing and was_active:
                # the survivor-side count; a re-admitting rank counts
                # itself inside dist.rendezvous instead
                dist._count_readmission()
            registry.gauge(
                "mx_elastic_generation",
                "current membership epoch (dist.generation)").set(gen)
            registry.gauge(
                "mx_elastic_reshard_seconds",
                "wall seconds of the last host-side elastic "
                "reshard").set(elapsed)
            tracing.event("elastic.transition", generation=gen,
                          members=len(members or ()),
                          direction="up" if growing else "down",
                          devices=(int(new_mesh.size)
                                   if new_mesh is not None else 0),
                          seconds=round(elapsed, 3))
        tracing.maybe_flight_dump("elastic_transition")
        _LOG.warning(
            "elastic: transition committed — generation %d, %d member(s)"
            "%s, %.3fs", gen, len(members or ()),
            (f", a mesh of {new_mesh.size} rank(s)"
             if new_mesh is not None else ""), elapsed)
        return "grown" if growing else "shrunk"

    def _reshard_sampler(self, members, growing, joining):
        from ..parallel import dist

        if self.sampler is None or not members or not self._multi():
            return
        consumed = None
        if growing:
            # the rank coming back holds a fresh sampler: it takes the
            # fleet's consumed count from the ranks that stayed
            mine = (None if joining else
                    len(self.sampler._perm) - self.sampler.remaining())
            got = [c for c in dist.exchange_objs(mine) if c is not None]
            consumed = got[0] if joining and got else None
        me = dist.rank()
        if me in members:
            self.sampler.reshard(len(members), list(members).index(me),
                                 consumed=consumed)

    def _check_blocks(self, survivors):
        """Every block this rank's slice of the old mesh holds must stay
        among ``survivors``: resharding in place gathers them there. A
        block only a departed rank held is lost to the live fleet."""
        from ..base import MXNetError

        tr = self.trainer
        old = tr.mesh
        idx = old._index()
        if idx is None:
            return
        axes = {a for pl in tr._plan.placements if pl is not None
                for axs in pl.cspec for a in axs} if tr._plan else set()
        for axis in sorted(axes):
            sl = list(idx)
            sl[old.axis_names.index(axis)] = slice(None)
            gone = sorted(set(old.devices[tuple(sl)].tolist())
                          - set(survivors))
            if gone:
                raise MXNetError(
                    f"elastic: rank(s) {gone} held blocks over {axis!r} "
                    f"that no survivor holds; resume the survivors from "
                    f"the drain checkpoint instead")

    def _mesh_over(self, ranks):
        """The trainer's mesh over ``ranks``: every axis as it was but the
        data axis, which takes the ranks there are (None without a
        multi-rank trainer or ranks)."""
        from ..parallel.mesh import make_mesh

        tr = self.trainer
        if tr is None or getattr(tr, "mesh", None) is None or not ranks:
            return None
        old = tr.mesh
        names = list(old.axis_names)
        shape = dict(old.shape)
        da = tr._data_axis if tr._data_axis in shape else names[0]
        other = 1
        for nm, s in shape.items():
            if nm != da:
                other *= int(s)
        dp_new = max(1, len(ranks) // other)
        if dp_new * other > len(ranks):
            from ..base import MXNetError

            raise MXNetError(f"elastic: {len(ranks)} rank(s) cannot hold the "
                             f"mesh's other axes ({other} ranks)")
        shape[da] = dp_new
        return make_mesh([(nm, shape[nm]) for nm in names],
                         devices=sorted(ranks)[:dp_new * other])

    def _preflight(self, new_mesh):
        """Spec-tier shardcheck of the post-transition layout BEFORE any
        commit: each parameter's target spec is its declared spec's
        fingerprint mapped onto the new mesh; a large parameter whose
        spec fully degraded (its axes are gone) is passed unconstrained so
        SC001 names it, and the per-rank byte estimate drives SC006.
        Returns the rebuild-ready spec list; raises
        :class:`ElasticTransitionAborted` on a blocking finding."""
        import torch

        from ..analysis.shardcheck import ShapeDtype, shardcheck
        from ..parallel import _layout

        tr = self.trainer
        declared = getattr(tr, "_param_specs", None)
        param_specs, rebuild_specs, avals = [], [], []
        for i, p in enumerate(tr.params):
            pl = tr._placement(i)
            avals.append(ShapeDtype(pl.shape if pl is not None
                                    else p.shape, p.dtype))
            src = declared[i] if declared is not None else ()
            fp = spec_fingerprint(src)
            spec, degraded = _spec_from_fingerprint(fp, new_mesh)
            replicated = spec is None or not len(spec)
            if degraded and replicated:
                # silently degraded to replicated: let SC001 judge it
                param_specs.append(None)
                rebuild_specs.append(())
            else:
                param_specs.append(spec if spec is not None else ())
                rebuild_specs.append(spec if spec is not None else ())
        states, state_specs = [], []
        for i, (s, sp) in enumerate(zip(tr.opt_states, param_specs)):
            pl = tr._placement(i)
            leaves = []
            for leaf in _layout.tree_leaves(s):
                if not isinstance(leaf, torch.Tensor):
                    continue
                like = leaf.shape == tr.params[i].shape
                shape = pl.shape if like and pl is not None else leaf.shape
                leaves.append((ShapeDtype(shape, leaf.dtype),
                               sp if like else ()))
            states.append([a for a, _ in leaves])
            state_specs.append([b for _, b in leaves])
        report = shardcheck(
            None, avals, states, mesh=new_mesh,
            specs=(param_specs, state_specs),
            hbm_budget_gb=self.hbm_budget_gb, name="elastic.preflight")
        blocking = [f for f in report.findings
                    if f.rule in ("SC001", "SC006")
                    or f.severity == "error"]
        if blocking:
            from ..telemetry import registry

            registry.counter(
                "mx_elastic_aborts_total",
                "elastic transitions aborted by the shardcheck "
                "pre-flight").inc()
            raise ElasticTransitionAborted(blocking, report)
        if declared is None:
            return None
        return [tuple(s) for s in rebuild_specs]
