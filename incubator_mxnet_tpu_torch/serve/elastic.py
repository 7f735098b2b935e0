"""Elastic replica-set control plane: act on the advisor, survive
replica death (port of `incubator_mxnet_tpu/serve/elastic.py`, host code
kept nearly verbatim; on one card the replicas share the device).

The gateway fronts a model with N independent replica engines behind the
router, and `serve.advisor.AutoscaleAdvisor` only *recommends*. This
module closes the loop: `ReplicaSetController`
consumes those recommendations and resizes the LIVE replica set through
the existing seams, so a pod rides a diurnal load curve without static
peak provisioning and treats a dead replica as a routine membership
event.

State machine, per tick (`Gateway.step` → `tick`, under the gateway
lock)::

    reap crashed ──▶ finish drains ──▶ heal to min ──▶ act on advice
    (replica_crash    (draining ∧ idle   (spawn while    (scale_up →
     seam → replace)   → retire+free)     < min)          spawn/undrain,
                                                          scale_down →
                                                          drain one)

Invariants the controller owns:

- **one choke point** — every mutation of a model's replica list
  happens in THIS module under one ``tracked_lock``;
- **warm before dispatch** — a spawned replica has BOTH program
  families (one eager prefill chunk per bucket + the decode graph's
  capture) driven through it while it is still outside the routing set,
  so scale-up builds no program on the request path (the program ledger,
  `telemetry.compiles`, proves it: no entry for a replica after it
  joined the routing set). On the card that warmup runs on the step
  thread while the other replicas serve; its wall is kept in
  ``warm_seconds``;
- **funded before built** — `ModelRegistry.rebalance_pages` recomputes
  the per-replica page cut for the NEW count first and raises
  `PagePoolExhausted` LOUDLY when the budget cannot pay (never a
  silent over-commit);
- **failed-spawn rollback** — an exception anywhere between engine
  construction and publication (the ``replica_spawn`` chaos seam
  fires exactly there) releases the partial engine and leaves the
  fleet at N: no half-registered replica;
- **memory comes back** — a retired or dead replica's engine is
  released (`SlotDecoder.release`): its pools and its captured graphs
  (their private memory pools) go, and nothing else holds them;
- **zero lost work** — a replica killed by the ``replica_crash`` seam
  is removed from the routing set first, its queued + running requests
  are re-owned by the gateway (tokens generated so far survive on the
  handle; the remainder re-dispatches to a surviving replica exactly
  like a preemption resume), and a replacement is spawned;
- **floors and ceilings** — scale-down drains (router stops
  dispatching, in-flight slots finish, pages + prefix refs freed at
  retire) and never drops below ``min_replicas``; scale-up and healing
  never exceed ``max_replicas``.

Knobs: ``MXNET_ELASTIC_SERVE`` (arms the controller at Gateway
construction), ``MXNET_ELASTIC_MIN_REPLICAS`` /
``MXNET_ELASTIC_MAX_REPLICAS`` (defaults 1 / 8). Telemetry:
``mx_elastic_scale_events_total{direction=}`` and the
``mx_serve_replicas{model=}`` pull gauge (TELEMETRY.md).
"""
from __future__ import annotations

import logging
import time

import numpy as onp

from ..telemetry import registry, tracing
from ..telemetry.locks import tracked_lock
from ..util import env_int as _env_int
from .scheduler import _NULL, Scheduler

__all__ = ["ReplicaSetController", "ReplicaScaleError"]

_LOG = logging.getLogger("incubator_mxnet_tpu_torch.serve")

_WARM_STEP_GUARD = 50_000     # scheduler steps before a warmup is "stalled"


def _scale_event(direction):
    return registry.counter(
        "mx_elastic_scale_events_total",
        "committed elastic scale events by direction",
        labels={"direction": direction})


class ReplicaScaleError(RuntimeError):
    """A replica-set mutation could not complete (spawn failed, warmup
    stalled, no idle mesh slice, ...). The fleet is unchanged — the
    failed replica was rolled back before registration."""


class ReplicaSetController:
    """Closed-loop replica-set sizing for one `serve.Gateway`.

    The gateway ticks the controller from every `step()` (under the
    gateway lock); all replica-list mutations additionally serialize on
    the controller's own ``tracked_lock`` — THE choke point.

    Parameters
    ----------
    gateway : serve.Gateway
        The fleet to control.
    min_replicas / max_replicas : int, optional
        Floor/ceiling per model (``MXNET_ELASTIC_MIN_REPLICAS`` /
        ``MXNET_ELASTIC_MAX_REPLICAS``, defaults 1 / 8).
    factories : {model: callable}, optional
        ``factory(n_pages) -> engine`` per model — required for models
        registered with pre-built decoders (tests, stubs), optional
        otherwise (the registry spec is the default recipe).
    warm_lens : sequence of int, optional
        Prompt lengths driven through a fresh replica before it may
        receive traffic (cover every prefill bucket the live traffic
        touches; default ``(8,)``).
    warm_new : int
        Decode tokens per warmup request (default 2).
    """

    def __init__(self, gateway, min_replicas=None, max_replicas=None,
                 factories=None, warm_lens=None, warm_new=2):
        self._gw = gateway
        self.min_replicas = int(
            min_replicas if min_replicas is not None
            else _env_int("MXNET_ELASTIC_MIN_REPLICAS", 1))
        self.max_replicas = int(
            max_replicas if max_replicas is not None
            else _env_int("MXNET_ELASTIC_MAX_REPLICAS", 8))
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")
        self._factories = dict(factories or {})
        self.warm_lens = tuple(warm_lens) if warm_lens else (8,)
        self.warm_new = max(1, int(warm_new))
        # THE replica-set choke point: every mutation
        # of a model's replica list happens under this lock, in this
        # module
        self._lock = tracked_lock("serve.elastic")
        self._consumed_t = {}     # model -> newest advisor t acted on
        self._next_index = {}     # model -> next replica index (never reused)
        self._heal_logged = set()
        self.events = []          # scale-event journal (bench integrates it)
        self.warm_programs = {}   # label -> program count at publication
        self.warm_seconds = {}    # label -> spawn warmup wall seconds

    # -- introspection -------------------------------------------------------

    def replica_count(self, model, live_only=False):
        m = self._gw._models[model]
        if live_only:
            return sum(1 for r in m.replicas if not r.draining)
        return len(m.replicas)

    def scale_log(self, tail=None):
        """The scale-event journal (time-ordered dicts)."""
        return list(self.events) if tail is None \
            else list(self.events)[-int(tail):]

    # -- the tick ------------------------------------------------------------

    def tick(self, now=None):
        """One control iteration (the gateway calls this from `_step`,
        already holding the gateway lock). Returns the number of
        replica-set mutations performed."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            n = self._reap_crashed(now)
            n += self._finish_drains(now)
            n += self._heal(now)
            n += self._consume_advice(now)
        return n

    # -- public scaling surface (tests / operators) --------------------------

    def scale_up(self, model, n=1):
        """Spawn up to `n` replicas for `model` (ceiling-clamped).
        Raises `PagePoolExhausted` / `ReplicaScaleError` on a replica
        the budget or the spawn path cannot deliver — the fleet stays
        at its current size. Returns the replicas added."""
        with self._gw._lock, self._lock:
            return self._scale_up(self._gw._models[model], n,
                                  time.monotonic(), reason="manual")

    def scale_down(self, model, n=1):
        """Mark up to `n` replicas of `model` draining (floor-clamped;
        they retire once idle). Returns the number marked."""
        with self._gw._lock, self._lock:
            return self._scale_down(self._gw._models[model], n,
                                    time.monotonic(), reason="manual")

    # -- crash detection + replacement ---------------------------------------

    def _reap_crashed(self, now):
        from ..fault.injection import FaultInjected, inject_at

        gw = self._gw
        n = 0
        for m in list(gw._models.values()):
            for rep in list(m.replicas):
                try:
                    # the liveness probe doubles as the chaos seam:
                    # @N targets the replica INDEX, not the process rank
                    inject_at("replica_crash", index=rep.index)
                except FaultInjected as e:
                    self._replace_dead(m, rep, now, reason=str(e))
                    n += 1
        return n

    def _replace_dead(self, m, rep, now, reason):
        """A replica died: out of the routing set first, then re-own
        its work (zero requests fail), then free its host state, then
        spawn the replacement (healed next tick if the spawn fails)."""
        gw = self._gw
        m.replicas.remove(rep)
        requeued = 0
        for req in list(rep.live):
            rep.live.remove(req)
            # the engine segment died with the replica; forward what it
            # already produced into the gateway handle, then the
            # remainder re-dispatches like a preemption resume
            if req._segment is not None:
                gw._drain_segment(req, req._segment, now)
            req._segment = None
            gen = onp.asarray(req.tokens, onp.int32)
            req._resume_prompt = onp.concatenate(
                [onp.asarray(req.prompt, onp.int32), gen])
            req._remaining = req.max_new - len(req.tokens)
            req.state = "queued"
            req.replica = None
            if req._anatomy is not None:
                req._anatomy.requeued(now, "crash_resume")
            req._spans["admit"] = tracing.open_span(
                "gateway.admit", parent=req._spans.get("request", _NULL),
                resumed=True, crash=rep.label)
            gw._queues[req.priority].push(req.tenant, req)
            requeued += 1
        self._release(rep)
        _scale_event("replace").inc()
        self._journal(now, m, "replace", rep.label,
                      f"{reason}; requeued {requeued} request(s)")
        _LOG.warning(
            "serve.elastic: replica %s died (%s) — removed from the "
            "routing set, %d live request(s) re-queued", rep.label,
            reason, requeued)
        try:
            # role-aware replacement: a dead decode replica is replaced
            # by a decode replica — the pod's role split survives crashes
            self._spawn(m, now, reason=f"replace {rep.label}",
                        role=getattr(rep, "role", "both"))
        except Exception as e:   # noqa: FL006 - degraded fleet beats a dead step loop
            _LOG.error(
                "serve.elastic: replacement spawn for %s failed (%s: %s)"
                " — fleet degraded to %d replica(s); healing retries "
                "next tick", rep.label, type(e).__name__, e,
                len(m.replicas))

    def _release(self, rep):
        """Free a retired/dead replica's host state: scheduler book-
        keeping, prefix refs, page pool."""
        from ..fault.retry import suppressed

        try:
            if rep.live or rep.sched.n_active:
                rep.sched.abandon()       # dead engine: nothing to drain
            else:
                rep.sched.close(drain=False)
        except Exception as e:
            suppressed("serve.elastic.release", e)
        for fn in (lambda: rep.slots.prefix_cache.clear(),
                   lambda: rep.slots.release()):
            try:
                fn()
            except Exception as e:
                suppressed("serve.elastic.release", e)

    # -- drains --------------------------------------------------------------

    def _finish_drains(self, now):
        n = 0
        for m in list(self._gw._models.values()):
            for rep in [r for r in m.replicas if r.draining]:
                if rep.live or not rep.sched.idle:
                    continue              # in-flight slots still finishing
                m.replicas.remove(rep)
                self._release(rep)
                _scale_event("down").inc()
                self._journal(now, m, "down", rep.label, "drain complete")
                _LOG.info("serve.elastic: replica %s drained and retired "
                          "(%d left)", rep.label, len(m.replicas))
                n += 1
        return n

    def _scale_down(self, m, n, now, reason):
        marked = 0
        for _ in range(int(n)):
            alive = [r for r in m.replicas if not r.draining]
            if len(alive) <= self.min_replicas:
                break
            if m.disagg:
                # a disaggregated pod must keep >= 1 live replica of
                # each role: no prefill replica means no admission, no
                # decode replica means every migration falls back
                from collections import Counter

                by_role = Counter(getattr(r, "role", "both")
                                  for r in alive)
                alive = [r for r in alive
                         if by_role[getattr(r, "role", "both")] > 1]
                if not alive:
                    break
            # retire the least-loaded, newest replica first
            rep = min(alive, key=lambda r: (len(r.live)
                                            + r.sched.queue_depth,
                                            -r.index))
            rep.draining = True
            tracing.event("serve.elastic.drain_start", replica=rep.label,
                          reason=str(reason))
            marked += 1
        return marked

    # -- healing + advice ----------------------------------------------------

    def _heal(self, now):
        """Spawn while a model is below ``min_replicas`` (a crash whose
        replacement spawn failed leaves a deficit; this retries every
        tick until the fleet is whole)."""
        n = 0
        for m in list(self._gw._models.values()):
            while sum(1 for r in m.replicas if not r.draining) \
                    < self.min_replicas:
                try:
                    self._spawn(m, now, reason="heal")
                    self._heal_logged.discard(m.name)
                    n += 1
                except Exception as e:   # noqa: FL006 - keep the step loop alive; retried next tick
                    if m.name not in self._heal_logged:
                        self._heal_logged.add(m.name)
                        _LOG.error(
                            "serve.elastic: heal spawn for %s failed "
                            "(%s: %s) — retrying every tick", m.name,
                            type(e).__name__, e)
                    break
        return n

    def _consume_advice(self, now):
        gw = self._gw
        n = 0
        for name, adv in list(gw._advisors.items()):
            m = gw._models.get(name)
            if m is None:
                continue
            rec = adv.pending_action(self._consumed_t.get(name))
            if rec is None:
                continue
            self._consumed_t[name] = rec["t"]
            want = max(1, int(rec.get("n", 1)))
            act = rec["action"]
            if act in ("scale_up", "scale_up_prefill", "scale_up_decode"):
                # role-aware advice (anatomy residency evidence) pins
                # the new replicas' disaggregation role
                role = {"scale_up_prefill": "prefill",
                        "scale_up_decode": "decode"}.get(act)
                n += self._scale_up(m, want, now,
                                    reason=rec.get("reason", "advisor"),
                                    best_effort=True, role=role)
            elif act == "scale_down":
                n += self._scale_down(m, want, now,
                                      reason=rec.get("reason", "advisor"))
        return n

    # -- scale-up ------------------------------------------------------------

    def _scale_up(self, m, n, now, reason, best_effort=False, role=None):
        added = []
        for _ in range(int(n)):
            # cheapest capacity first: cancel a drain in progress (of
            # the requested role, when the advice is role-aware)
            draining = [r for r in m.replicas if r.draining
                        and (role is None
                             or getattr(r, "role", "both") == role)]
            if draining:
                rep = max(draining, key=lambda r: r.index)
                rep.draining = False
                _scale_event("up").inc()
                self._journal(now, m, "up", rep.label, "drain cancelled")
                added.append(rep)
                continue
            if len(m.replicas) >= self.max_replicas:
                break
            try:
                added.append(self._spawn(m, now, reason=reason,
                                         role=role))
            except Exception as e:
                if not best_effort:
                    raise
                _LOG.warning(
                    "serve.elastic: advisor scale-up for %s stopped at "
                    "%d replica(s): %s: %s", m.name, len(m.replicas),
                    type(e).__name__, e)
                break
        return added if not best_effort else len(added)

    def _spawn(self, m, now, reason, role=None):
        """Build → load weights → warm → publish, with rollback: an
        exception ANYWHERE before publication (the ``replica_spawn``
        chaos seam included) releases the partial engine and leaves the
        fleet exactly as it was. `role` pins the new replica's
        disaggregation role (crash replacement preserves it); a
        disaggregated pod scales up on the DECODE side by default —
        resident decode slots, not prefill throughput, are what
        saturates first."""
        from ..fault.injection import inject_at
        from ..fault.retry import suppressed
        from .gateway import _Replica

        gw = self._gw
        name = m.name
        if role is None:
            role = "decode" if m.disagg else "both"
        # funded before built: the per-replica cut for the NEW count —
        # raises PagePoolExhausted loudly when the budget can't pay
        if m.disagg or role != "both":
            n_p = sum(1 for r in m.replicas
                      if getattr(r, "role", "both") == "prefill")
            n_d = sum(1 for r in m.replicas
                      if getattr(r, "role", "both") == "decode")
            if role == "prefill":
                n_p += 1
            else:
                n_d += 1
            per_p, per_d = gw._registry.rebalance_pages_disagg(
                name, max(1, n_p), max(1, n_d))
            n_pages = per_p if role == "prefill" else per_d
        else:
            n_pages = gw._registry.rebalance_pages(name,
                                                   len(m.replicas) + 1)
        j = self._next_index.get(name)
        if j is None:
            j = max((r.index for r in m.replicas), default=-1) + 1
        label = f"{name}#{j}"
        slots = sched = None
        try:
            factory = self._factories.get(name)
            if factory is not None:
                slots = factory(n_pages)
            else:
                slots = gw._registry.build_engine(
                    name, mesh=self._spawn_mesh(m, j), n_pages=n_pages)
            # the hot-swap path: the engine read the shared
            # block's CURRENT params at construction; refresh makes the
            # load explicit (and re-places sharded weights)
            if hasattr(slots, "_refresh_params"):
                slots._refresh_params()
            if hasattr(slots, "census_name"):
                slots.census_name = f"serve:{label}"
            inject_at("replica_spawn")    # chaos: mid-spawn, pre-publication
            bp = gw._build_params
            i = list(gw._models).index(name)
            sched = Scheduler(slots, max_queue=bp["max_queue"],
                              policy=bp["policy"],
                              default_deadline=bp["default_deadline"],
                              eos_id=bp["eos_id"],
                              seed=bp["seed"] + i + 997 * j)
            sched.capacity_model = name
            rep = _Replica(name, j, label, slots, sched, role=role)
            t_warm = time.perf_counter()
            self._warm(rep)
            warm_s = time.perf_counter() - t_warm
        except Exception:
            # failed-spawn rollback: nothing was published; the fleet
            # stays at N and the partial engine is released
            if sched is not None:
                try:
                    sched.abandon()
                except Exception as e:
                    suppressed("serve.elastic.spawn_rollback", e)
            if slots is not None:
                try:
                    slots.release()
                except Exception as e:
                    suppressed("serve.elastic.spawn_rollback", e)
            raise
        # publication: the ONE place a replica enters the routing set
        self._next_index[name] = j + 1
        self.warm_programs[label] = int(slots.xla_program_count()) \
            if hasattr(slots, "xla_program_count") else None
        self.warm_seconds[label] = warm_s
        m.replicas.append(rep)
        gw._arm_replica_probe(rep)
        _scale_event("up").inc()
        self._journal(now, m, "up", label, reason)
        _LOG.info("serve.elastic: replica %s spawned, warmed and "
                  "published (%d live): %s", label, len(m.replicas),
                  reason)
        return rep

    def _spawn_mesh(self, m, j):  # noqa: ARG002
        """The idle mesh slice for replica index `j`. Mesh-sharded
        replicas are not ported (`ModelRegistry.add(mesh=...)` raises,
        `ROADMAP.md` §1 item 9), so every replica is a single-device
        engine: None."""
        return None

    def _warm(self, rep):
        """Drive a fresh replica's program families while it is still
        outside the routing set — zero cold compiles on the request
        path. Role-aware: a decode-role replica warms via adopted
        segments (`serve.disagg.warm_decode_replica`) so its ledger
        never grows a prefill family; everything else warms BOTH
        families through ordinary submits."""
        if getattr(rep, "role", "both") == "decode":
            from . import disagg

            try:
                disagg.warm_decode_replica(rep, self.warm_lens,
                                           self.warm_new)
            except ReplicaScaleError:
                raise
            except Exception as e:
                raise ReplicaScaleError(
                    f"replica {rep.label}: decode warmup failed: "
                    f"{type(e).__name__}: {e}") from e
            return
        max_len = int(getattr(rep.slots, "max_len", 1 << 30))
        for i, L in enumerate(self.warm_lens):
            L = max(1, min(int(L), max_len - self.warm_new - 1))
            # distinct constant per warm length: a shared-prefix hit
            # across warm prompts skips whole chunks and leaves a
            # prefill bucket cold for live traffic to compile on the
            # request path
            seg = rep.sched.submit(onp.full(L, i + 1, onp.int32),
                                   self.warm_new)
            guard = 0
            while not seg.done:
                try:
                    rep.sched.step()
                except Exception as e:
                    raise ReplicaScaleError(
                        f"replica {rep.label}: warmup (len {L}) failed: "
                        f"{type(e).__name__}: {e}") from e
                guard += 1
                if guard > _WARM_STEP_GUARD:
                    raise ReplicaScaleError(
                        f"replica {rep.label}: warmup (len {L}) did not "
                        f"finish within {_WARM_STEP_GUARD} engine steps")
            if seg.error is not None:
                raise ReplicaScaleError(
                    f"replica {rep.label}: warmup (len {L}) failed: "
                    f"{type(seg.error).__name__}: {seg.error}")

    def _journal(self, now, m, direction, label, reason):
        ev = {"t": float(now), "model": m.name, "direction": direction,
              "replica": label, "n": len(m.replicas),
              "reason": str(reason)}
        self.events.append(ev)
        tracing.event("serve.elastic.scale", **{k: v for k, v in
                                                ev.items() if k != "t"})
