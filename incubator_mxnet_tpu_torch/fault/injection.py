"""Deterministic fault injection (port of
`incubator_mxnet_tpu/fault/injection.py`: the full `SEAMS` tuple :118 and
the ``MXNET_FAULT_INJECT`` grammar), host-only code ported nearly
verbatim. A seam whose probe belongs to a module the port does not have
yet is still a valid name: it arms and draws nothing until that module
comes.

Reference role: the reference stack is *implicitly* hardened — ps-lite
retries messages and tolerates worker churn — but offers no way to TEST
that hardening. This module makes failure a first-class, reproducible
input: a seeded schedule armed by the ``MXNET_FAULT_INJECT`` knob fires
:class:`FaultInjected` at named probe points ("seams") threaded through
the real failure surfaces of the framework.

Schedule grammar (comma-separated entries)::

    MXNET_FAULT_INJECT="seam[@rank]:prob[:seed[:limit[:kind]]],..."

- ``seam``  — one of :data:`SEAMS` (below). An optional ``@rank`` suffix
  (``collective_delay@1:1.0``) restricts the seam to ONE process of a
  multi-rank launch: the probe compares against ``PROCESS_ID`` /
  ``DMLC_RANK`` (what `tools/launch.py` exports), falling back to
  the ``torch.distributed`` rank once a process group is up — the
  deterministic-straggler fixture for the fleet observability plane;
- ``prob``  — per-draw fire probability in [0, 1];
- ``seed``  — per-seam PRNG seed (default 0). The draw sequence is
  ``random.Random(seed)`` — identical across runs, platforms and the
  two packages, so a chaos run REPLAYS exactly;
- ``limit`` — optional max number of fires (``prob=1.0, limit=N`` fails
  exactly the first N draws then goes quiet — the deterministic form the
  test suites use);
- ``kind``  — the failure flavor: ``fault`` (default,
  :class:`FaultInjected`), ``oom``
  (:class:`InjectedResourceExhausted`, whose message carries the XLA
  ``RESOURCE_EXHAUSTED`` marker so the HBM observatory's OOM post-mortem
  seams treat it as a real allocator failure — the fixture behind
  `telemetry/hbm.py`'s flight-dump test), ``delay`` (SLEEP
  ``MXNET_FAULT_DELAY_MS`` milliseconds, default 50, instead of raising
  — a slow rank, not a dead one; the default kind for the
  ``collective_delay`` seam), or ``shrink=N`` (the ``topology_change``
  seam's payload: raise :class:`TopologyChanged` carrying the
  post-transition world size ``N`` — the deterministic membership-loss
  fixture `fault/elastic.py`'s chaos gate replays; with ``@rank``
  targeting, that one rank "dies" and its survivors re-rendezvous), or
  ``grow=N`` (the reverse direction: :class:`TopologyChanged` carrying
  the LARGER post-transition world size — recovered/new ranks re-admit
  at the next membership epoch, `fault/elastic.py`'s scale-UP fixture).

Seams (where the reference's probes live):

===========================  ==============================================
``dataloader_worker``        `gluon/data/dataloader._worker_fn` (in the
                             worker process — arms from the inherited env)
``dataloader_worker_exit``   same site, but the worker hard-exits
                             (``os._exit``) instead of raising: simulates
                             an OOM-killed/segfaulted worker
``kvstore_push``             `_SingleProcessStore.push` / `pushpull`
``kvstore_pull``             `_SingleProcessStore.pull`
``kvstore_barrier``          `KVStore*.barrier`
``dist_init``                `parallel/dist.initialize` rendezvous attempt
``h2d``                      NDArray host→device inlet (module-global
                             ``ndarray._FAULT_HOOK``, None when off —
                             the same dead-branch discipline as
                             `telemetry/stages.py`)
``checkpoint_write``         `preemption.atomic_save` write body
``estimator_step``           `Estimator.fit` batch body (mid-step crash)
``serve_step``               `serve.Scheduler.step` entry (serving-loop
                             crash mid-flight)
``gateway_step``             `serve.Gateway.step` entry (multi-tenant
                             front door crash with tiered queues live;
                             the flight recorder snapshots queue state)
``collective_delay``         `parallel/dist.allreduce` entry — the choke
                             point broadcast/barrier/exchange_objs ride
                             (module-global ``dist._FAULT_HOOK``, the
                             h2d dead-branch discipline). Default kind
                             ``delay``: with ``@rank`` targeting it
                             turns one process into a reproducible
                             straggler for `telemetry/fleet.py`
``topology_change``          `fault/elastic.ElasticController.poll` step
                             boundary — deterministic mid-run membership
                             change. Default kind ``topology``
                             (:class:`TopologyChanged`); ``shrink=N`` /
                             ``grow=N`` name the post-transition world
                             size (smaller / larger roster), and
                             ``@rank`` makes ONE specific process die
``replica_crash``            `serve/elastic.ReplicaSetController.tick`
                             per-replica liveness probe — the serve-plane
                             analogue of ``topology_change``. ``@N``
                             targets the REPLICA INDEX (not the process
                             rank): replica ``model#N`` "dies" and the
                             controller must replace it with its queued
                             work re-dispatched
``replica_spawn``            `serve/elastic.ReplicaSetController` spawn
                             body, AFTER the engine is built but BEFORE
                             registration — the failed-spawn rollback
                             fixture (fleet must stay at N replicas, no
                             half-registered replica)
``page_migration``           `serve/disagg._migrate` handoff body, AFTER
                             destination pages are allocated but BEFORE
                             the copy — the mid-migration rollback
                             fixture: destination refs roll back, the
                             request falls back to co-located serving on
                             its prefill replica, and allocator
                             refcounts return to baseline (no page leak)
===========================  ==============================================

The port's probes so far: ``serve_step`` (`serve.Scheduler.step`),
``gateway_step`` (`serve.Gateway.step`) and ``page_migration``
(`serve.disagg._migrate`).

Off-path contract: when no schedule is configured, ``_SCHEDULE is None``
and every probe is a global load + ``is None`` check.
"""
from __future__ import annotations

import os

from ..telemetry.locks import tracked_lock

__all__ = ["FaultInjected", "InjectedResourceExhausted", "TopologyChanged",
           "SEAMS", "inject_at", "injection_enabled",
           "configure_injection", "configure_from_env", "clear_injection",
           "schedule_info"]

SEAMS = ("dataloader_worker", "dataloader_worker_exit", "kvstore_push",
         "kvstore_pull", "kvstore_barrier", "dist_init", "h2d",
         "checkpoint_write", "estimator_step", "serve_step",
         "gateway_step", "collective_delay", "topology_change",
         "replica_crash", "replica_spawn", "page_migration")


class FaultInjected(RuntimeError):
    """Raised by an armed probe point. Carries the seam name and the
    1-based draw index so a failing schedule can be replayed exactly."""

    def __init__(self, seam, draw):
        super().__init__(
            f"injected fault at seam '{seam}' (draw #{draw}, "
            f"MXNET_FAULT_INJECT)")
        self.seam = seam
        self.draw = draw

    def __reduce__(self):
        # default exception pickling replays __init__ with self.args (the
        # formatted message) — wrong arity; a DataLoader worker's fault
        # must cross the pool's result pipe intact
        return (FaultInjected, (self.seam, self.draw))


class InjectedResourceExhausted(FaultInjected):
    """The ``oom`` flavor: message carries XLA's ``RESOURCE_EXHAUSTED``
    marker, so every is-this-an-OOM classifier (e.g.
    `telemetry.hbm.is_resource_exhausted`) treats it as the real thing."""

    def __init__(self, seam, draw):
        RuntimeError.__init__(
            self,
            f"RESOURCE_EXHAUSTED: Out of memory (injected fault at seam "
            f"'{seam}', draw #{draw}, MXNET_FAULT_INJECT)")
        self.seam = seam
        self.draw = draw

    def __reduce__(self):
        return (InjectedResourceExhausted, (self.seam, self.draw))


class TopologyChanged(FaultInjected):
    """The ``topology_change`` seam fired: the membership is about to
    change. NOT a transient (``non_retryable``): retry policies must let
    it surface to `fault.elastic.ElasticController`, which turns it into
    an epoch transition. ``shrink`` is the smaller post-transition world
    size (``None`` = lose exactly the ``@rank``-targeted process);
    ``grow`` is the LARGER one (re-admission / scale-up direction) —
    at most one of the two is set."""

    non_retryable = True

    def __init__(self, seam, draw, shrink=None, grow=None):
        RuntimeError.__init__(
            self,
            f"injected topology change at seam '{seam}' (draw #{draw}, "
            f"shrink={shrink}, grow={grow}, MXNET_FAULT_INJECT)")
        self.seam = seam
        self.draw = draw
        self.shrink = shrink
        self.grow = grow

    def __reduce__(self):
        return (TopologyChanged,
                (self.seam, self.draw, self.shrink, self.grow))


_KINDS = {"fault": FaultInjected, "oom": InjectedResourceExhausted}
_DELAY_KIND = "delay"            # sleeps instead of raising (slow, not dead)
_TOPOLOGY_KIND = "topology"      # raises TopologyChanged (with .shrink)


class _SeamState:
    __slots__ = ("prob", "seed", "limit", "kind", "rng", "draws", "fired",
                 "rank", "shrink", "grow")

    def __init__(self, prob, seed=0, limit=None, kind="fault", rank=None,
                 shrink=None, grow=None):
        import random

        self.prob = float(prob)
        self.seed = int(seed)
        self.limit = None if limit is None else int(limit)
        kind, _, arg = str(kind).partition("=")
        if kind == "shrink":      # "shrink=N" sugar for kind topology
            kind, shrink = _TOPOLOGY_KIND, arg
        elif kind == "grow":      # "grow=N": the scale-UP direction
            kind, grow = _TOPOLOGY_KIND, arg
        if kind not in _KINDS and kind not in (_DELAY_KIND, _TOPOLOGY_KIND):
            raise ValueError(
                f"unknown fault kind {kind!r} (valid: "
                f"{', '.join((*_KINDS, _DELAY_KIND, _TOPOLOGY_KIND))}"
                ", shrink=N, grow=N)")
        self.kind = kind
        self.rank = None if rank is None else int(rank)
        self.shrink = None if shrink in (None, "") else int(shrink)
        self.grow = None if grow in (None, "") else int(grow)
        self.rng = random.Random(self.seed)
        self.draws = 0
        self.fired = 0


def _split_rank(seam):
    """``seam@rank`` → (seam, rank). No suffix → (seam, None)."""
    if "@" in seam:
        base, _, r = seam.partition("@")
        try:
            return base.strip(), int(r)
        except ValueError:
            raise ValueError(
                f"MXNET_FAULT_INJECT: bad rank suffix in {seam!r} "
                "(expected 'seam@<int>')") from None
    return seam, None


def _self_rank():
    """This process's rank for ``@rank`` targeting: the launcher's env
    first, a live ``torch.distributed`` process group second, else 0."""
    import sys

    v = os.environ.get("PROCESS_ID") or os.environ.get("DMLC_RANK")
    if v is not None:
        try:
            return int(v)
        except ValueError:
            pass
    dist = sys.modules.get("torch.distributed")
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank())
        except Exception:   # no process group: the rank filter falls back to 0
            pass
    return 0


def _delay_seconds():
    try:
        return float(os.environ.get("MXNET_FAULT_DELAY_MS", "50")) / 1000.0
    except ValueError:
        return 0.05


_SCHEDULE = None                 # None = off (every probe a dead branch)
_LOCK = tracked_lock("fault.injection", kind="lock")


def _parse_spec(spec):
    sched = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if not 2 <= len(bits) <= 5:
            raise ValueError(
                f"MXNET_FAULT_INJECT entry {part!r}: expected "
                "'seam:prob[:seed[:limit[:kind]]]'")
        seam, rank = _split_rank(bits[0].strip())
        if seam not in SEAMS:
            raise ValueError(
                f"MXNET_FAULT_INJECT: unknown seam {seam!r} "
                f"(valid: {', '.join(SEAMS)})")
        prob = float(bits[1])
        if not 0.0 <= prob <= 1.0:
            raise ValueError(
                f"MXNET_FAULT_INJECT seam {seam!r}: prob {prob} ∉ [0, 1]")
        seed = int(bits[2]) if len(bits) >= 3 else 0
        limit = int(bits[3]) if len(bits) >= 4 and bits[3] else None
        kind = (bits[4].strip().lower() if len(bits) == 5
                else _default_kind(seam))
        sched[seam] = _SeamState(prob, seed, limit, kind, rank)
    return sched


def _default_kind(seam):
    # collective_delay exists to make a rank SLOW, not to kill it;
    # topology_change exists to make the MEMBERSHIP smaller
    if seam == "collective_delay":
        return _DELAY_KIND
    if seam == "topology_change":
        return _TOPOLOGY_KIND
    return "fault"


def configure_injection(spec):
    """Arm the chaos schedule. `spec` is the ``MXNET_FAULT_INJECT`` grammar
    string or a ``{seam[@rank]: (prob[, seed[, limit[, kind]]])}`` dict
    (kind ``fault`` | ``oom`` | ``delay``). Empty/None clears. Returns
    the armed seam names."""
    global _SCHEDULE
    if not spec:
        clear_injection()
        return ()
    if isinstance(spec, str):
        sched = _parse_spec(spec)
    else:
        sched = {}
        for seam, cfg in dict(spec).items():
            seam, rank = _split_rank(seam)
            if seam not in SEAMS:
                raise ValueError(f"unknown seam {seam!r} "
                                 f"(valid: {', '.join(SEAMS)})")
            cfg = (cfg,) if isinstance(cfg, (int, float)) else tuple(cfg)
            if len(cfg) < 4:
                cfg = cfg + (0, None, _default_kind(seam))[len(cfg) - 1:]
            sched[seam] = _SeamState(*cfg, rank=rank)
    with _LOCK:
        _SCHEDULE = sched or None
    _arm_hot_hooks()
    return tuple(sched)


def configure_from_env():
    """Arm from ``MXNET_FAULT_INJECT`` if set (called from
    `util._apply_env_config` at the package's import)."""
    spec = os.environ.get("MXNET_FAULT_INJECT")
    if spec:
        return configure_injection(spec)
    return ()


def clear_injection():
    """Disarm every seam; probes return to dead branches."""
    global _SCHEDULE
    with _LOCK:
        _SCHEDULE = None
    _arm_hot_hooks()


def _arm_hot_hooks():
    """The NDArray host->device inlet is the one per-op-hot seam: a
    module-global hook (`ndarray._FAULT_HOOK`) that stays None unless the
    schedule names 'h2d', so an is-None check is the whole off-path. The
    NDArray module arms itself at import from the schedule already set."""
    import sys

    sched = _SCHEDULE
    nd_mod = sys.modules.get("incubator_mxnet_tpu_torch.ndarray.ndarray")
    if nd_mod is not None:
        nd_mod._FAULT_HOOK = (_h2d_probe
                              if (sched and "h2d" in sched) else None)


def _h2d_probe(nbytes):  # noqa: ARG001 — hook signature shared with telemetry
    inject_at("h2d")


def injection_enabled(seam=None):
    sched = _SCHEDULE
    if sched is None:
        return False
    return True if seam is None else seam in sched


def inject_at(seam, index=None):
    """Probe point: no-op unless the armed schedule names `seam`, in which
    case a seeded Bernoulli draw decides whether to fire — raising
    :class:`FaultInjected` (kinds ``fault``/``oom``) or sleeping
    ``MXNET_FAULT_DELAY_MS`` (kind ``delay``). Draw order is
    deterministic per seam; an ``@rank``-targeted seam draws only on
    that rank (so each rank's sequence stays deterministic). When the
    caller passes ``index`` (the serve plane's per-replica probes), the
    ``@N`` suffix targets THAT index instead of the process rank —
    ``replica_crash@1`` kills replica #1 wherever it lives."""
    sched = _SCHEDULE
    if sched is None:                 # the dead branch
        return
    st = sched.get(seam)
    if st is None:
        return
    if st.rank is not None and st.rank != (
            _self_rank() if index is None else int(index)):
        return
    with _LOCK:
        st.draws += 1
        draw = st.draws
        fire = (st.limit is None or st.fired < st.limit) \
            and st.rng.random() < st.prob
        if fire:
            st.fired += 1
    if fire:
        from ..telemetry import registry, tracing

        registry.counter("mx_faults_injected_total",
                         "faults fired by the MXNET_FAULT_INJECT "
                         "schedule").inc()
        registry.counter("mx_faults_injected_total",
                         "faults fired by the MXNET_FAULT_INJECT schedule",
                         labels={"seam": seam}).inc()
        # annotate the enclosing span (serve.step, estimator.step, ...)
        # so the flight-recorder dump shows WHERE the chaos landed
        tracing.event("fault.injected", seam=seam, draw=draw,
                      kind=st.kind)
        if st.kind == _DELAY_KIND:
            import time

            d = _delay_seconds()
            registry.counter("mx_fault_delay_seconds_total",
                             "seconds slept by delay-kind injected "
                             "faults", labels={"seam": seam}).inc(d)
            time.sleep(d)
            return
        if st.kind == _TOPOLOGY_KIND:
            raise TopologyChanged(seam, draw, st.shrink, st.grow)
        raise _KINDS[st.kind](seam, draw)


def schedule_info():
    """Introspection: {seam: {prob, seed, limit, draws, fired}} (empty when
    disarmed) — what a chaos run reports next to the registry dump."""
    sched = _SCHEDULE
    if sched is None:
        return {}
    with _LOCK:
        return {seam: dict({"prob": st.prob, "seed": st.seed,
                            "limit": st.limit, "kind": st.kind,
                            "rank": st.rank,
                            "draws": st.draws, "fired": st.fired},
                           **({"shrink": st.shrink, "grow": st.grow}
                              if st.kind == _TOPOLOGY_KIND else {}))
                for seam, st in sched.items()}
