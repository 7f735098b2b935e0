"""Multi-tenant serving gateway: many models, many tenants, three
priority tiers, one front door (port of
`incubator_mxnet_tpu/serve/gateway.py`: `ModelRegistry`, `GatewayRequest`,
`Gateway` with `_pick_victim` :1022, `_preempt_one` :1135, the
``gateway_step`` seam :950 and `hot_swap`), host code ported nearly
verbatim; on one card its engines share the device.

`ServeEngine` serves ONE model for ONE implicit tenant at ONE priority.
Production traffic is none of those things — this module is the
missing multiplexing layer, in the spirit of model-co-residence serving
systems (AlpaServe) and predictable-SLO schedulers (Clockwork):

- :class:`ModelRegistry` — co-resident models. Each entry builds its
  own `SlotDecoder` + `Scheduler` pair (its own prefill buckets and
  graphs — the per-engine flat-program-count guarantee is untouched),
  but the device page budget is ONE number split across the per-model
  pools proportional to each entry's ``share``.

- :class:`Gateway` — ``submit(model, prompt, max_new, tenant=...,
  priority=...)``. Requests land in one WDRR queue per priority tier
  (`serve.tenancy`); every ``step()`` expires deadlines, dispatches
  tier-by-tier (highest first, weighted deficit round robin across
  tenants inside a tier, token-rate quotas deferring over-quota
  tenants), steps every engine once, and pumps generated tokens back
  into the gateway-level handles.

- **preemption** — when a higher-tier request cannot dispatch because
  its model's slots are full, the lowest-tier / least-progressed
  running request is PREEMPTED via `Scheduler.preempt`: its page-
  aligned resident KV pages are registered in the prefix cache (kept
  while the page budget allows), and the request re-enters the gateway
  queue as *remaining-chunk work* — the resumed segment's prompt is
  ``original prompt + tokens so far``, so the cached pages re-attach
  and only the unaligned tail re-prefills. Preempted work is never
  silently dropped: it finishes later, or fails LOUDLY (deadline while
  re-queued ⇒ `DeadlineExceeded`, retryable — never an eviction error).

Observability: gateway spans join the per-request trace
(``gateway.request`` → ``gateway.admit`` → ``serve.request``), the
flight recorder snapshots gateway queue state on crash
(`tracing.register_flight_context`), `mx_serve_ttft_seconds` /
`mx_serve_tokens_total` gain ``model``/``priority``/``tenant``-labeled
series, evictions gain ``reason="preempted"``, and
``mx_gateway_queue_depth{priority=}`` is a pull gauge over the live
queues. Chaos rides the ``gateway_step`` fault seam. Knobs:
``MXNET_SERVE_PRIORITY_TIERS``, ``MXNET_SERVE_TENANT_QUOTA``,
``MXNET_GATEWAY_MAX_QUEUE``, ``MXNET_GATEWAY_QUANTUM``,
``MXNET_GATEWAY_PREEMPT``.

Pod-scale: ``add(..., replicas=N)`` fronts a model with N independent
engines behind least-loaded + prefix-affinity routing
(`serve.router.ReplicaRouter`; ``MXNET_SERVE_REPLICAS`` /
``MXNET_SERVE_AFFINITY``), with `Gateway.hot_swap` rolling refreshed
weights one replica at a time, drain-free. On one card the N engines
share the device, each with its own pool and graphs.
``add(prefill_replicas=, decode_replicas=)`` splits a model into prefill
and decode replicas whose KV pages migrate on the card (`serve.disagg`).

Elastic: ``MXNET_ADVISOR`` arms one `serve.advisor.AutoscaleAdvisor` a
model (evaluated on the step cadence, `advisor_log`), and
`Gateway.enable_elastic` (or ``MXNET_ELASTIC_SERVE=1``) a
`serve.elastic.ReplicaSetController` that acts on the advice, spawning,
draining and replacing replicas; both tick at the end of every `step()`.
A failed step gets the device-memory post-mortem (`telemetry.hbm`) when
it ran out of memory, else the flight dump.

Not ported yet, and raising `MXNetError` that names the `ROADMAP.md` item:
``add(mesh=...)`` and the sharded engine (`serve.sharded`, §1 item 9).
"""
from __future__ import annotations

import os
import queue as _queue
import threading
import time
import weakref

import numpy as onp

from ..base import MXNetError
from ..telemetry import anatomy, capacity, registry, tracing
from ..telemetry.locks import tracked_lock
from ..util import env_int as _env_int
from . import disagg, tenancy
from .engine import PagePoolExhausted, SlotDecoder
from .scheduler import (_DONE, _NULL, DeadlineExceeded, EngineClosed,
                        QueueFull, Scheduler)

__all__ = ["ModelRegistry", "Gateway", "GatewayRequest"]

_IDLE_SLEEP_S = 0.002
_DRIVER_MAX_CONSECUTIVE_FAILURES = 3
_FLIGHT_QUEUE_SAMPLE = 64     # queued requests snapshotted per dump
# disaggregated page split: prefill replicas hold only transient prompt
# pages, so they share this fraction of a model's page cut and decode
# replicas get the rest (ModelRegistry.rebalance_pages_disagg)
_PREFILL_PAGE_FRAC = 0.25


def _q_help():
    return ("gateway admission-queue depth per priority tier "
            "(pull gauge over the live WDRR queues)")


class _Replica:
    """One serving engine instance: a SlotDecoder + Scheduler pair, plus
    the gateway-side list of live (dispatched) requests. ``label`` is
    the metric/census identity — ``"<model>"`` for a single-replica
    model (the pre-replica series names), ``"<model>#<i>"`` otherwise.
    ``draining`` marks a replica being retired: the router stops
    dispatching to it while its in-flight work finishes
    (`serve/elastic.py` owns the flag and the replica list). ``role`` is
    the disaggregation assignment: ``"both"`` (homogeneous default) serves
    the full request; ``"prefill"`` runs only chunked prefill and hands
    finished segments to the migration plane; ``"decode"`` only ever
    receives already-prefilled requests via `Scheduler.adopt` and never
    runs a prefill chunk."""

    __slots__ = ("model", "index", "label", "slots", "sched", "live",
                 "draining", "role")

    def __init__(self, model, index, label, slots, sched, role="both"):
        self.model = model
        self.index = index
        self.label = label
        self.slots = slots
        self.sched = sched
        self.live = []                    # dispatched GatewayRequests
        self.draining = False
        self.role = role                  # "prefill" | "decode" | "both"
        # residency identity for the anatomy ledger: the scheduler's
        # compute seams charge this replica's role-residency series
        sched.anatomy_replica = (label, role)


class _Model:
    """One co-resident model: N replica engines behind one
    `serve.router.ReplicaRouter`. The single-replica accessors
    (``slots``/``sched``/``live`` → replica 0) keep the pre-replica
    surface working for introspection and config reads — every replica
    of a model is built with identical engine kwargs."""

    __slots__ = ("name", "replicas", "share", "router")

    def __init__(self, name, replicas, share, router):
        self.name = name
        self.replicas = replicas
        self.share = share
        self.router = router

    @property
    def slots(self):
        return self.replicas[0].slots

    @property
    def sched(self):
        return self.replicas[0].sched

    @property
    def live(self):
        return self.replicas[0].live

    @property
    def disagg(self):
        """True when the pod is role-split — the gateway then runs
        two-stage dispatch and the migration pump for this model."""
        return any(getattr(r, "role", "both") != "both"
                   for r in self.replicas)

    def role_replicas(self, *roles):
        return [r for r in self.replicas
                if getattr(r, "role", "both") in roles]


class ModelRegistry:
    """Declares the co-resident model set and splits one HBM page
    budget across their pools.

    ``total_pages`` is the SHARED budget (pool pages, incl. each pool's
    reserved trash page); each model gets
    ``max(4, floor(total * share / sum_shares))`` pages. With
    ``total_pages=None`` every engine sizes its own pool (the
    single-model `SlotDecoder` default) — co-residence without a joint
    budget."""

    def __init__(self, total_pages=None):
        self.total_pages = None if total_pages is None else int(total_pages)
        self._specs = {}

    def add(self, name, block_or_decoder, share=1.0, replicas=None,
            mesh=None, prefill_replicas=None, decode_replicas=None,
            **engine_kwargs):
        """Register `name` → model. ``share`` weights this model's cut
        of the page budget; ``engine_kwargs`` forward to `SlotDecoder`
        (max_slots, max_len, page_tokens, kv_dtype, ...).

        ``replicas`` fronts the model with N independent engines behind
        least-loaded + prefix-affinity routing (default: the
        ``MXNET_SERVE_REPLICAS`` knob, else 1); the model's page cut is
        split evenly across them, and on one card they share the device.
        ``mesh`` (mesh-sharded replicas) raises `MXNetError` until the
        sharded engine is ported (`ROADMAP.md` §1 item 9). A list of
        pre-built decoders is also accepted as ``block_or_decoder`` (one
        per replica).

        ``prefill_replicas``/``decode_replicas`` make the pod
        DISAGGREGATED: the first
        ``prefill_replicas`` engines take role ``"prefill"`` (chunked
        prefill only, ~25% of the model's page cut between them), the
        next ``decode_replicas`` take role ``"decode"`` (adopt-only;
        the remaining pages). Mutually exclusive with ``replicas``.
        Under a truthy ``MXNET_DISAGG`` every freshly-built model
        defaults to disaggregation with ``MXNET_SERVE_PREFILL_REPLICAS``
        / ``MXNET_SERVE_DECODE_REPLICAS`` (1/1) roles."""
        name = str(name)
        if mesh is not None:
            raise MXNetError(
                f"model {name!r}: mesh= (mesh-sharded replicas, "
                "serve.sharded.ShardedSlotDecoder) is not ported yet "
                "(ROADMAP.md §1 item 9)")
        if name in self._specs:
            raise ValueError(f"model {name!r} already registered")
        share = float(share)
        if share <= 0:
            raise ValueError(
                f"model {name!r}: share must be > 0, got {share}")
        if replicas is not None and int(replicas) < 1:
            raise ValueError(
                f"model {name!r}: replicas must be >= 1, got {replicas}")
        n_p = None if prefill_replicas is None else int(prefill_replicas)
        n_d = None if decode_replicas is None else int(decode_replicas)
        if (n_p is None) != (n_d is None):
            raise ValueError(
                f"model {name!r}: prefill_replicas and decode_replicas "
                "come as a pair — pass both or neither")
        if n_p is not None:
            if replicas is not None:
                raise ValueError(
                    f"model {name!r}: replicas= is mutually exclusive "
                    "with prefill_replicas=/decode_replicas= (the role "
                    "split IS the replica count)")
            if n_p < 1 or n_d < 1:
                raise ValueError(
                    f"model {name!r}: a disaggregated pod needs >= 1 "
                    f"replica of each role, got prefill={n_p} "
                    f"decode={n_d}")
        self._specs[name] = (block_or_decoder, share, dict(engine_kwargs),
                             None if replicas is None else int(replicas),
                             n_p, n_d)
        return self

    def __len__(self):
        return len(self._specs)

    def __contains__(self, name):
        return name in self._specs

    def names(self):
        return list(self._specs)

    @staticmethod
    def _is_engine(obj):
        return hasattr(obj, "prefill_chunk_step") \
            and hasattr(obj, "allocator")

    def rebalance_pages(self, name, n_replicas):
        """THE page-budget split: per-replica page count for model
        `name` at `n_replicas` replicas — used both at construction
        (`_build`) and by `serve.elastic.ReplicaSetController` every
        time the replica count changes, so the two can never disagree.
        Returns None when there is no joint budget (``total_pages``
        unset). Raises `PagePoolExhausted` LOUDLY when the model's cut
        cannot fund that many replicas (< 4 pages each) — a replica the
        budget cannot pay for must be refused, never silently
        over-committed."""
        if self.total_pages is None:
            return None
        spec = self._specs.get(name)
        if spec is None:
            raise ValueError(f"unknown model {name!r} (registered: "
                             f"{', '.join(sorted(self._specs))})")
        total_share = sum(s[1] for s in self._specs.values())
        cut = int(self.total_pages * spec[1] / total_share)
        per = cut // max(1, int(n_replicas))
        if per < 4:
            raise PagePoolExhausted(
                f"model {name!r}: {n_replicas} replica(s) cannot be "
                f"funded from its {cut}-page cut of the "
                f"{self.total_pages}-page budget (every replica needs "
                ">= 4 pages) — lower the replica count, raise "
                "total_pages, or raise the model's share")
        return per

    def rebalance_pages_disagg(self, name, n_prefill, n_decode):
        """The DISAGGREGATED page split: ``(per_prefill, per_decode)``
        pages for model `name`. Prefill replicas hold only transient
        prompt pages (a handoff segment releases them the moment its
        pages migrate), so they share a `_PREFILL_PAGE_FRAC` sliver of
        the model's cut and the decode side gets everything else — the
        tilt that buys disaggregation's higher resident decode slot
        count at equal hardware. Returns ``(None, None)`` without a
        joint budget; raises `PagePoolExhausted` when either role
        cannot be funded (>= 4 pages per replica)."""
        if self.total_pages is None:
            return None, None
        spec = self._specs.get(name)
        if spec is None:
            raise ValueError(f"unknown model {name!r} (registered: "
                             f"{', '.join(sorted(self._specs))})")
        n_prefill = max(1, int(n_prefill))
        n_decode = max(1, int(n_decode))
        total_share = sum(s[1] for s in self._specs.values())
        cut = int(self.total_pages * spec[1] / total_share)
        per_p = max(4, int(cut * _PREFILL_PAGE_FRAC) // n_prefill)
        per_d = (cut - per_p * n_prefill) // n_decode
        if per_d < 4:
            raise PagePoolExhausted(
                f"model {name!r}: a {n_prefill}-prefill/{n_decode}-"
                f"decode pod cannot be funded from its {cut}-page cut "
                f"of the {self.total_pages}-page budget (every replica "
                f">= 4 pages; decode side got {per_d}) — lower the "
                "replica counts, raise total_pages, or raise the "
                "model's share")
        return per_p, per_d

    def build_engine(self, name, mesh=None, n_pages=None):
        """Construct ONE fresh engine for `name` from its registered
        spec — the elastic controller's scale-up path (the construction
        path is `_build`). Pre-built-decoder entries carry no recipe to
        rebuild from; scaling those needs a factory passed to the
        controller. ``mesh`` raises until the sharded engine is
        ported."""
        spec = self._specs.get(name)
        if spec is None:
            raise ValueError(f"unknown model {name!r} (registered: "
                             f"{', '.join(sorted(self._specs))})")
        block, _share, kw = spec[0], spec[1], spec[2]
        if self._is_engine(block) or (
                isinstance(block, (list, tuple))
                and all(self._is_engine(b) for b in block)):
            raise ValueError(
                f"model {name!r} was registered with pre-built "
                "decoder(s) — there is no recipe to build another; "
                "pass factories={...} to the elastic controller")
        rkw = dict(kw)
        if n_pages is not None:
            rkw["n_pages"] = int(n_pages)
        if mesh is not None:
            raise MXNetError(
                f"model {name!r}: a mesh-sharded engine "
                "(serve.sharded.ShardedSlotDecoder) is not ported yet "
                "(ROADMAP.md §1 item 9)")
        return SlotDecoder(block, **rkw)

    def _build(self, policy, max_queue, default_deadline, eos_id, seed):
        from .router import ReplicaRouter

        if not self._specs:
            raise ValueError("ModelRegistry is empty — add() a model "
                             "before constructing the Gateway")
        models = {}
        for i, (name, (block, share, kw, n_rep,
                       n_p, n_d)) in enumerate(self._specs.items()):
            prebuilt = None
            if isinstance(block, (list, tuple)) \
                    and all(self._is_engine(b) for b in block):
                prebuilt = list(block)   # one pre-built engine per replica
                if n_rep is not None and n_rep != len(prebuilt):
                    raise ValueError(
                        f"model {name!r}: replicas={n_rep} but "
                        f"{len(prebuilt)} pre-built decoders were given")
                if n_p is not None and n_p + n_d != len(prebuilt):
                    raise ValueError(
                        f"model {name!r}: prefill_replicas={n_p} + "
                        f"decode_replicas={n_d} but {len(prebuilt)} "
                        "pre-built decoders were given (first "
                        "prefill_replicas are the prefill side)")
                n_rep = len(prebuilt)
            elif self._is_engine(block):
                prebuilt = [block]       # pre-built SlotDecoder / stub
                if n_rep is not None and n_rep != 1:
                    raise ValueError(
                        f"model {name!r}: replicas={n_rep} needs a list "
                        "of pre-built decoders (one per replica)")
                if n_p is not None:
                    raise ValueError(
                        f"model {name!r}: a disaggregated pod needs a "
                        "list of pre-built decoders (one per replica), "
                        "or a block to build them from")
                n_rep = 1
            if n_p is None and n_rep is None and prebuilt is None \
                    and _env_int("MXNET_DISAGG", 0):
                # opt-in default: every freshly-built model splits into
                # dedicated prefill/decode replicas
                n_p = max(1, _env_int("MXNET_SERVE_PREFILL_REPLICAS", 1))
                n_d = max(1, _env_int("MXNET_SERVE_DECODE_REPLICAS", 1))
            if n_p is not None:
                n_rep = n_p + n_d
            if n_rep is None:
                n_rep = max(1, _env_int("MXNET_SERVE_REPLICAS", 1))
            if prebuilt is not None and kw:
                raise ValueError(
                    f"model {name!r}: engine kwargs {sorted(kw)} "
                    "cannot apply to a pre-built decoder — configure "
                    "it at construction instead")
            if n_p is not None:
                per_role_pages = self.rebalance_pages_disagg(name, n_p,
                                                             n_d)
            replicas = []
            for j in range(n_rep):
                role = "both" if n_p is None \
                    else ("prefill" if j < n_p else "decode")
                if prebuilt is not None:
                    slots = prebuilt[j]
                else:
                    rkw = dict(kw)
                    if self.total_pages is not None \
                            and "n_pages" not in rkw:
                        if n_p is not None:
                            rkw["n_pages"] = per_role_pages[
                                0 if role == "prefill" else 1]
                        else:
                            rkw["n_pages"] = self.rebalance_pages(name,
                                                                  n_rep)
                    slots = SlotDecoder(block, **rkw)
                label = name if n_rep == 1 else f"{name}#{j}"
                # the engine's registry series carry the replica label
                # (serve:<model>#<j>)
                if hasattr(slots, "census_name"):
                    slots.census_name = f"serve:{label}"
                # replica 0 keeps the pre-replica seed stream so
                # single-replica traces stay reproducible round-over-round
                sched = Scheduler(slots, max_queue=max_queue,
                                  policy=policy,
                                  default_deadline=default_deadline,
                                  eos_id=eos_id, seed=seed + i + 997 * j)
                sched.capacity_model = name   # cost-ledger attribution
                replicas.append(_Replica(name, j, label, slots, sched,
                                         role=role))
            models[name] = _Model(name, replicas, share, ReplicaRouter())
        return models


class GatewayRequest:
    """The tenant-facing handle: same surface as the engine `Request`
    (``done`` / ``ttft`` / ``wait`` / ``result`` / token stream) but
    survives preemption — tokens accumulate across engine segments."""

    __slots__ = ("id", "model", "tenant", "priority", "tier", "prompt",
                 "max_new", "temperature", "eos_id", "deadline",
                 "submit_t", "first_token_t", "finish_t", "tokens",
                 "state", "error", "error_class", "preemptions",
                 "est_cost", "trace_id", "replica", "_spans", "_segment",
                 "_resume_prompt", "_remaining", "_charged", "_anatomy",
                 "_stream", "_done")

    def __init__(self, rid, model, tenant, priority, tier, prompt,
                 max_new, temperature, eos_id, deadline):
        self.id = rid
        self.model = model
        self.tenant = tenant
        self.priority = priority          # tier NAME
        self.tier = tier                  # tier INDEX (0 = highest)
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.eos_id = eos_id
        self.deadline = deadline          # absolute monotonic, or None
        self.submit_t = None
        self.first_token_t = None
        self.finish_t = None
        self.tokens = []
        self.state = "queued"             # queued|dispatched|done|failed
        self.error = None
        self.error_class = None
        self.preemptions = 0
        self.replica = None               # replica label once dispatched
        self.est_cost = int(prompt.size) + int(max_new)
        self._segment = None              # live engine Request, or None
        self._resume_prompt = None        # set after a preemption
        self._remaining = int(max_new)
        self._charged = False             # quota debited once, ever
        self._anatomy = None              # latency-anatomy record, or None
        root = tracing.open_span("gateway.request", lane=f"greq {rid}",
                                 request=rid, model=model, tenant=tenant,
                                 priority=priority,
                                 prompt_len=int(prompt.size),
                                 max_new=max_new)
        self.trace_id = root.trace_id
        self._spans = {"request": root,
                       "admit": tracing.open_span("gateway.admit",
                                                  parent=root)}
        # bounded by max_new tokens + one sentinel per request
        self._stream = _queue.Queue()
        self._done = threading.Event()

    # -- handle surface ----------------------------------------------------

    @property
    def done(self):
        return self._done.is_set()

    @property
    def ttft(self):
        """Seconds from GATEWAY submit to first token (queue wait at the
        gateway + engine admission + prefill)."""
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    def wait(self, timeout=None):
        return self._done.wait(timeout)

    def result(self):
        if not self._done.is_set():
            raise RuntimeError(
                f"gateway request {self.id} not finished "
                f"(state={self.state}); wait() on it or drive the gateway")
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    # -- gateway side ------------------------------------------------------

    def _emit(self, tok, now):
        if self.first_token_t is None:
            self.first_token_t = now
            ttft = now - self.submit_t
            # one labeled VIEW per dimension (this registry has no
            # query-time aggregation, so {priority=} and {model=} are
            # separate series — slo.gateway_ttft reads the tier view;
            # the {replica=} view shows routing skew across replicas)
            views = [{"priority": self.priority}, {"model": self.model}]
            if self.replica is not None and self.replica != self.model:
                views.append({"replica": self.replica})
            for labels in views:
                registry.histogram(
                    "mx_serve_ttft_seconds",
                    "time-to-first-token: submit() to the final prefill "
                    "chunk's sampled token",
                    labels=labels).observe(ttft)
        self.tokens.append(tok)
        self._stream.put(tok)
        capacity.charge_tokens(self.tenant, self.model)
        views = [{"tenant": self.tenant}, {"model": self.model}]
        if self.replica is not None and self.replica != self.model:
            views.append({"replica": self.replica})
        for labels in views:
            registry.counter(
                "mx_serve_tokens_total",
                "tokens generated by the serving engine",
                labels=labels).inc()

    def _close_spans(self, error=None):
        self._spans.pop("admit", _NULL).close(error=error)
        self._spans.pop("request", _NULL).annotate(
            tokens=len(self.tokens), state=self.state,
            preemptions=self.preemptions).close(error=error)

    def _finish(self, now):
        self.state = "done"
        self.finish_t = now
        if self._anatomy is not None:
            anatomy.complete(self._anatomy, now, "ok",
                             tokens=len(self.tokens))
        self._close_spans()
        self._stream.put(_DONE)
        self._done.set()

    def _fail(self, exc, now):
        from ..fault.retry import classify_exception

        self.state = "failed"
        self.error = exc
        self.error_class = classify_exception(exc)
        self.finish_t = now
        if self._anatomy is not None:
            anatomy.complete(
                self._anatomy, now,
                "expired" if isinstance(exc, DeadlineExceeded)
                else "failed",
                tokens=len(self.tokens))
        self._close_spans(error=exc)
        self._stream.put(_DONE)
        self._done.set()


class Gateway:
    """The multi-tenant front door over a `ModelRegistry`.

    Parameters
    ----------
    models : ModelRegistry
        The co-resident model set (page budget already declared there).
    tiers : str | sequence, optional
        Priority tier names, highest first (default
        ``MXNET_SERVE_PRIORITY_TIERS`` or ``high,normal,low``).
    tenants : dict, optional
        ``{name: {"weight": w, "rate": r, "burst": b}}`` profiles.
        Unknown tenants are auto-created at first submit with weight 1
        and the default quota.
    quota : (rate, burst), optional
        Default per-tenant token-rate quota (``MXNET_SERVE_TENANT_QUOTA``
        fallback; None = unmetered).
    quantum : float, optional
        WDRR quantum in tokens (``MXNET_GATEWAY_QUANTUM`` or 256).
    max_queue : int, optional
        Gateway admission bound across all tiers
        (``MXNET_GATEWAY_MAX_QUEUE`` or 256); full ⇒ `QueueFull`.
    preempt : bool, optional
        Allow higher-tier arrivals to preempt lower-tier running slots
        (``MXNET_GATEWAY_PREEMPT``, default on).
    policy / engine_max_queue / deadline_s / eos_id / seed
        Forwarded to each per-model `Scheduler`.
    """

    def __init__(self, models, tiers=None, tenants=None, quota=None,
                 quantum=None, max_queue=None, preempt=None, policy="fifo",
                 engine_max_queue=64, deadline_s=None, eos_id=None,
                 seed=0):
        if not isinstance(models, ModelRegistry):
            raise TypeError("Gateway takes a ModelRegistry (got "
                            f"{type(models).__name__})")
        if tiers is None:
            tiers = os.environ.get("MXNET_SERVE_PRIORITY_TIERS")
        self.tiers = tenancy.parse_tiers(
            tiers if tiers is None or isinstance(tiers, str)
            else ",".join(tiers))
        if quota is None:
            quota = tenancy.parse_quota(
                os.environ.get("MXNET_SERVE_TENANT_QUOTA"))
        self._default_rate, self._default_burst = quota
        if quantum is None:
            quantum = _env_int("MXNET_GATEWAY_QUANTUM", 256)
        if max_queue is None:
            max_queue = _env_int("MXNET_GATEWAY_MAX_QUEUE", 256)
        self.max_queue = int(max_queue)
        if preempt is None:
            preempt = bool(_env_int("MXNET_GATEWAY_PREEMPT", 1))
        self.preempt_enabled = bool(preempt)
        self._registry = models
        self._models = models._build(policy, engine_max_queue, deadline_s,
                                     eos_id, seed)
        self._queues = {t: tenancy.WDRRQueue(quantum) for t in self.tiers}
        self._tenants = {}
        for name, prof in (tenants or {}).items():
            prof = dict(prof)
            self._tenants[name] = tenancy.Tenant(
                name, weight=prof.get("weight", 1.0),
                rate=prof.get("rate", self._default_rate),
                burst=prof.get("burst", self._default_burst))
        self._next_id = 0
        self.closed = False
        self._lock = tracked_lock("serve.gateway")
        self._driver = None
        self._stop = threading.Event()
        self.preemptions_total = 0
        # the controller rebuilds schedulers for spawned replicas with
        # the same knobs the construction path used
        self._build_params = {"policy": policy,
                              "max_queue": engine_max_queue,
                              "default_deadline": deadline_s,
                              "eos_id": eos_id, "seed": seed}
        self._advisors = {}
        self._advisor_period = None
        self._advisor_next_t = None
        adv = os.environ.get("MXNET_ADVISOR", "")
        if adv not in ("", "0"):
            self._arm_advisor(5.0 if adv == "1" else float(adv))
        self._elastic = None
        es = os.environ.get("MXNET_ELASTIC_SERVE", "")
        if es not in ("", "0"):
            self.enable_elastic()
        self._arm_probes()

    def enable_elastic(self, **kwargs):
        """Arm the `serve.elastic.ReplicaSetController` (the
        ``MXNET_ELASTIC_SERVE=1`` path does this automatically): the
        controller is ticked from every `step()` and acts on advisor
        recommendations, drains/spawns replicas, and replaces dead
        ones. kwargs forward to the controller ctor (min_replicas,
        max_replicas, factories, warm_lens...). Returns the
        controller."""
        from .elastic import ReplicaSetController

        ctl = ReplicaSetController(self, **kwargs)
        with self._lock:
            self._elastic = ctl
        return ctl

    def _arm_advisor(self, period_s):
        """One observe-only `serve.advisor.AutoscaleAdvisor` per model,
        evaluated every ``period_s`` seconds on the step loop
        (``MXNET_ADVISOR``). Arms the timeseries history layer if the
        caller hasn't — the advisor is blind without it."""
        from ..telemetry import timeseries
        from .advisor import AutoscaleAdvisor

        if not timeseries.is_enabled():
            timeseries.enable()
        self._advisor_period = float(period_s)
        self._advisor_next_t = None
        for name in self._models:
            self._advisors[name] = AutoscaleAdvisor(name)

    def _advise(self, now):
        """Periodic advisor tick (the step loop's cadence)."""
        if not self._advisors:
            return
        if self._advisor_next_t is not None \
                and now < self._advisor_next_t:
            return
        self._advisor_next_t = now + self._advisor_period
        for adv in self._advisors.values():
            adv.evaluate()

    def advisor_log(self, tail=None):
        """Merged advisor decision log across models (time-ordered)."""
        recs = [r for adv in self._advisors.values()
                for r in adv.decision_log()]
        recs.sort(key=lambda r: r["t"])
        return recs if tail is None else recs[-int(tail):]

    # -- observability probes (weakly bound: a collected gateway drops
    # -- its series instead of being kept alive by the registry) ----------

    def _arm_probes(self):
        ref = weakref.ref(self)
        for tier in self.tiers:
            def _probe(tier=tier, ref=ref):
                gw = ref()
                if gw is None:
                    return None
                return len(gw._queues[tier])
            registry.register_pull_gauge(
                "mx_gateway_queue_depth", _probe, _q_help(),
                labels={"priority": tier})

        for m in self._models.values():
            for rep in m.replicas:
                self._arm_replica_probe(rep)

        for name in self._models:
            def _nrep(name=name, ref=ref):
                gw = ref()
                if gw is None:
                    return None
                m = gw._models.get(name)
                return None if m is None else len(m.replicas)
            registry.register_pull_gauge(
                "mx_serve_replicas", _nrep,
                "live replica count per served model (moves when the "
                "elastic controller scales/replaces)",
                labels={"model": name})

        def _flight(ref=ref):
            gw = ref()
            return None if gw is None else gw._flight_state()
        tracing.register_flight_context("gateway", _flight)

    def _arm_replica_probe(self, rep):
        """Per-replica free-page pull gauge — also called by the
        elastic controller for every replica it spawns."""
        sref = weakref.ref(rep.slots)

        def _free(sref=sref):
            s = sref()
            alloc = None if s is None \
                else getattr(s, "allocator", None)
            if alloc is None:
                return None
            return alloc.free_pages
        registry.register_pull_gauge(
            "mx_serve_replica_free_pages", _free,
            "free KV pool pages per serving replica (the "
            "router's least-loaded signal)",
            labels={"replica": rep.label})

    def _flight_state(self):
        """Queue/slot snapshot for the flight recorder: what was queued
        where, and what each model was running, at crash time."""
        queued = []
        for tier in self.tiers:
            for r in self._queues[tier].items()[:_FLIGHT_QUEUE_SAMPLE]:
                queued.append({
                    "id": r.id, "model": r.model, "tenant": r.tenant,
                    "priority": r.priority, "state": r.state,
                    "preemptions": r.preemptions,
                    "tokens": len(r.tokens)})
        return {
            "tiers": {t: len(self._queues[t]) for t in self.tiers},
            "queued": queued,
            "live": {rep.label: [
                {"id": r.id, "tenant": r.tenant, "priority": r.priority,
                 "tokens": len(r.tokens),
                 "segment_state": None if r._segment is None
                 else r._segment.state}
                for r in rep.live]
                for m in self._models.values() for rep in m.replicas},
            "preemptions_total": self.preemptions_total,
            "spec": {rep.label: rep.slots.spec_stats()
                     for m in self._models.values()
                     for rep in m.replicas
                     if getattr(rep.slots, "spec_k", 0)},
            "closed": self.closed,
        }

    # -- introspection ------------------------------------------------------

    def models(self):
        return list(self._models)

    def tenant(self, name):
        """The (auto-created) tenant record — counters, quota bucket."""
        with self._lock:
            return self._get_tenant(name)

    @property
    def queue_depth(self):
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def queue_depths(self):
        """Per-tier gateway queue depth {tier: n}."""
        with self._lock:
            return {t: len(self._queues[t]) for t in self.tiers}

    def xla_program_counts(self, per_replica=False):
        """Programs built per model, under the reference's name: each
        engine's `xla_program_count()` (chunk buckets seen plus captured
        graphs) summed across its replicas; ``per_replica=True`` keys by
        replica label. Flat in steady state."""
        with self._lock:
            if per_replica:
                return {rep.label: rep.slots.xla_program_count()
                        for m in self._models.values()
                        for rep in m.replicas}
            return {n: sum(rep.slots.xla_program_count()
                           for rep in m.replicas)
                    for n, m in self._models.items()}

    # -- admission ----------------------------------------------------------

    def _get_tenant(self, name):
        t = self._tenants.get(name)
        if t is None:
            t = tenancy.Tenant(name, rate=self._default_rate,
                               burst=self._default_burst)
            self._tenants[name] = t
        return t

    def submit(self, model, prompt_ids, max_new_tokens, tenant="default",
               priority=None, temperature=1.0, eos_id=None,
               deadline_s=None):
        """Enqueue one request for `model` on behalf of `tenant` at
        `priority` (a tier name; default = the middle tier). Returns a
        `GatewayRequest` handle.

        Loud rejections: unknown model/priority (`ValueError`), gateway
        at capacity (`QueueFull`), a request that could never fit the
        model's page pool (`PagePoolExhausted`), shutdown
        (`EngineClosed`)."""
        with self._lock:
            if self.closed:
                raise EngineClosed("gateway is shut down; new work is "
                                   "rejected")
            m = self._models.get(model)
            if m is None:
                raise ValueError(
                    f"unknown model {model!r} (registered: "
                    f"{', '.join(sorted(self._models))})")
            if priority is None:
                priority = self.tiers[len(self.tiers) // 2]
            if priority not in self.tiers:
                raise ValueError(
                    f"unknown priority {priority!r} (tiers, highest "
                    f"first: {', '.join(self.tiers)})")
            prompt = onp.asarray(prompt_ids, onp.int32).reshape(-1)
            if prompt.size == 0:
                raise ValueError("empty prompt")
            max_new = int(max_new_tokens)
            if max_new < 1:
                raise ValueError(
                    f"max_new_tokens must be >= 1, got {max_new}")
            if prompt.size + max_new > m.slots.max_len:
                raise ValueError(
                    f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                    f"exceeds model {model!r}'s max_len "
                    f"({m.slots.max_len})")
            pt = m.slots.page_tokens
            need = -(-(prompt.size + max_new - 1) // pt)
            if m.disagg:
                # the footprint splits across roles: the prompt's pages
                # must fit some prefill-capable pool, the full decode
                # budget some decode-capable pool (replica 0 is a
                # prefill replica with a deliberately small pool — it
                # is NOT the viability bar)
                p_need = -(-prompt.size // pt)
                p_max = max((r.slots.allocator.usable_pages
                             for r in m.role_replicas("prefill", "both")),
                            default=0)
                d_max = max((r.slots.allocator.usable_pages
                             for r in m.role_replicas("decode", "both")),
                            default=0)
                if p_need > p_max or need > d_max:
                    raise PagePoolExhausted(
                        f"request needs {p_need} prefill / {need} decode "
                        f"KV pages but model {model!r}'s largest pools "
                        f"hold {p_max} / {d_max} — raise its share/"
                        "total_pages or shrink the request")
            elif need > m.slots.allocator.usable_pages:
                raise PagePoolExhausted(
                    f"request needs {need} KV pages but model {model!r}'s "
                    f"pool only has {m.slots.allocator.usable_pages} — "
                    "raise its share/total_pages or shrink the request")
            if sum(len(q) for q in self._queues.values()) >= self.max_queue:
                raise QueueFull(
                    f"gateway admission queue at capacity "
                    f"({self.max_queue} waiting) — shed load, raise "
                    "MXNET_GATEWAY_MAX_QUEUE, or retry with backoff")
            now = time.monotonic()
            tier = self.tiers.index(priority)
            req = GatewayRequest(
                self._next_id, model, str(tenant), priority, tier, prompt,
                max_new, float(temperature), eos_id,
                None if deadline_s is None else now + float(deadline_s))
            self._next_id += 1
            req.submit_t = now
            req._anatomy = anatomy.begin(req.id, req.tenant, model,
                                         priority, now,
                                         deadline=req.deadline)
            self._get_tenant(req.tenant)
            self._queues[priority].push(req.tenant, req)
            return req

    # -- the step loop ------------------------------------------------------

    def step(self):
        """One gateway iteration: expire → dispatch (tier order, WDRR,
        quotas, preemption) → one engine step per model → pump tokens.
        Returns True if any progress was made. A crash leaves a flight-
        recorder dump carrying the gateway queue snapshot."""
        try:
            with self._lock:
                return self._step()
        except Exception as e:
            from ..telemetry import hbm

            if hbm.maybe_oom_postmortem("gateway_step", e) is None:
                tracing.maybe_flight_dump("gateway_step", e)
            raise

    def _step(self):
        from ..fault.injection import inject_at

        with tracing.span("gateway.step", queued=self.queue_depth):
            inject_at("gateway_step")
            now = time.monotonic()
            expired = self._expire(now)
            dispatched = self._dispatch(now)
            stepped = False
            for m in self._models.values():
                for rep in m.replicas:
                    if rep.live or not rep.sched.idle:
                        stepped |= bool(rep.sched.step())
            # disaggregation: move freshly-prefilled segments to decode
            # replicas before pumping (the pump would otherwise see a
            # segment with no live stream progress)
            for m in self._models.values():
                if m.disagg:
                    stepped |= bool(
                        disagg.pump_migrations(self, m,
                                               time.monotonic()))
            pumped = self._pump(time.monotonic())
            self._advise(now)
            scaled = (self._elastic.tick(now)
                      if self._elastic is not None else 0)
        return bool(expired or dispatched or stepped or pumped or scaled)

    def _expire(self, now):
        """Fail gateway-queued requests past their deadline — INCLUDING
        preempted ones waiting to resume: a deadline that passes while
        re-queued is `DeadlineExceeded` (retryable), never an eviction
        error."""
        n = 0
        for tier in self.tiers:
            q = self._queues[tier]
            for req in [r for r in q.items()
                        if r.deadline is not None and now > r.deadline]:
                q.remove(req)
                req._fail(DeadlineExceeded(
                    f"gateway request {req.id} expired after "
                    f"{now - req.submit_t:.3f}s "
                    f"({req.preemptions} preemption(s), "
                    f"{len(req.tokens)}/{req.max_new} tokens)"), now)
                n += 1
        return n

    def _rep_capacity(self, rep):
        """Slots this replica can still absorb this step: free slots
        minus work already staged in its engine queue (the engine
        admits those first). A draining replica absorbs nothing — the
        router must never dispatch to it."""
        if rep.draining:
            return 0
        return rep.sched.free_slots - rep.sched.queue_depth

    def _dispatch_reps(self, m):
        """Replicas a fresh (or resumed) submit may land on: everything
        for a homogeneous model, prefill-capable replicas for a
        disaggregated one — decode replicas only ever receive work via
        `Scheduler.adopt` (the migration plane), so they never run a
        prefill chunk."""
        if not m.disagg:
            return m.replicas
        return m.role_replicas("prefill", "both")

    def _capacity(self, m):
        """Best replica headroom for `m` (the model can dispatch if ANY
        replica can). ``default=0``: a model transiently at zero
        replicas (a crash whose replacement spawn failed) queues its
        work instead of crashing the step loop."""
        return max((self._rep_capacity(rep)
                    for rep in self._dispatch_reps(m)), default=0)

    def _pick_victim(self, m, tier):
        """Lowest-priority / least-progressed running request across
        `m`'s replicas with a tier strictly below `tier`, as
        ``(replica, request)`` — ``(None, None)`` when nothing is
        preemptable. Scoped to dispatch-capable replicas: preempting on
        a decode replica would push the arrival's prefill onto it."""
        best = None
        for rep in self._dispatch_reps(m):
            for r in rep.live:
                seg = r._segment
                if seg is None or seg.slot is None or r.tier <= tier:
                    continue
                key = (-r.tier, len(r.tokens), -r.id)
                if best is None or key < best[0]:
                    best = (key, rep, r)
        return (None, None) if best is None else (best[1], best[2])

    def _can_dispatch(self, req, now):
        m = self._models[req.model]
        if self._capacity(m) <= 0:
            if not (self.preempt_enabled
                    and self._pick_victim(m, req.tier)[1] is not None):
                return False
        if not req._charged:
            t = self._tenants[req.tenant]
            lvl = t.bucket.level(now)
            if lvl is not None and lvl < req.est_cost:
                return False              # over quota: defer, never drop
        return True

    def _dispatch(self, now):
        weights = {n: t.weight for n, t in self._tenants.items()}
        n = 0
        for tier_idx, tier in enumerate(self.tiers):
            q = self._queues[tier]
            while len(q):
                req = q.pop_next(weights, lambda r: r.est_cost,
                                 lambda r: self._can_dispatch(r, now))
                if req is None:
                    break
                self._do_dispatch(req, tier_idx, now)
                n += 1
        return n

    def _do_dispatch(self, req, tier_idx, now):
        m = self._models[req.model]
        prompt = req.prompt if req._resume_prompt is None \
            else req._resume_prompt
        # route: affinity (warm prefix pages — a resumed preemptee's
        # registered KV naturally pulls it back to its old replica),
        # then least-loaded among replicas with capacity. Disaggregated
        # models dispatch stage 1 only: least chunk-backlog among
        # prefill-capable replicas; the migration plane places stage 2.
        if m.disagg:
            rep = m.router.pick_prefill(
                m.replicas, viable=lambda r: self._rep_capacity(r) > 0)
        else:
            rep = m.router.pick(m.replicas, prompt=prompt,
                                tenant=req.tenant,
                                viable=lambda r:
                                self._rep_capacity(r) > 0)
        if rep is None and self.preempt_enabled:
            vrep, victim = self._pick_victim(m, tier_idx)
            if victim is not None:
                self._preempt_one(vrep, victim, now)
                rep = vrep
        if rep is None:               # _can_dispatch said yes; be loud
            raise RuntimeError(
                f"gateway: no dispatchable replica for model "
                f"{req.model!r} (this is a bug — please report)")
        t = self._tenants[req.tenant]
        if not req._charged:
            t.bucket.try_debit(req.est_cost, now)   # checked in _can_dispatch
            req._charged = True
        if req._resume_prompt is None and req.submit_t is not None:
            # first dispatch only — resumed segments would double-count
            # the wait (their delay is preemption, not admission)
            wait = max(now - req.submit_t, 0.0)
            registry.histogram(
                "mx_serve_queue_wait_seconds",
                "gateway admission-queue wait: submit() to first "
                "dispatch into an engine",
                labels={"tenant": req.tenant}).observe(wait)
            capacity.charge_queue_wait(req.tenant, req.model, wait)
        deadline_s = None if req.deadline is None \
            else max(req.deadline - now, 1e-6)
        seg = rep.sched.submit(prompt, req._remaining,
                               temperature=req.temperature,
                               eos_id=req.eos_id, deadline_s=deadline_s,
                               parent_span=req._spans.get("request", _NULL),
                               tenant=req.tenant,
                               prefill_only=m.disagg)
        req._segment = seg
        req.replica = rep.label
        req.state = "dispatched"
        if req._anatomy is not None:
            # closes queue_wait on first dispatch, `preempted` on a
            # resumed one (satellite: re-queued wall is attributed to
            # the preempted state, never dropped)
            req._anatomy.dispatched(now, rep.label)
            seg.anatomy = req._anatomy
        req._spans.pop("admit", _NULL).annotate(
            engine_request=seg.id, replica=rep.label,
            resumed=req._resume_prompt is not None,
            preemptions=req.preemptions).close()
        rep.live.append(req)
        t.dispatched += 1
        registry.counter(
            "mx_gateway_dispatch_total",
            "requests handed to a model engine (resumed segments "
            "included)",
            labels={"model": req.model, "priority": req.priority}).inc()

    def _preempt_one(self, rep, victim, now):
        """Evict `victim`'s slot (on replica `rep`) for a higher-tier
        arrival and re-queue its remaining work (tokens survive;
        resident page-aligned KV stays warm in THAT replica's prefix
        cache — prefix affinity later resumes it there)."""
        seg = victim._segment
        self._drain_segment(victim, seg, now)
        rep.sched.preempt(seg.slot, now)
        rep.live.remove(victim)
        victim._segment = None
        gen = onp.asarray(victim.tokens, onp.int32)
        victim._resume_prompt = onp.concatenate([victim.prompt, gen])
        victim._remaining = victim.max_new - len(victim.tokens)
        victim.preemptions += 1
        victim.state = "queued"
        victim.replica = None
        if victim._anatomy is not None:
            victim._anatomy.requeued(now, "preempted")
        self.preemptions_total += 1
        self._tenants[victim.tenant].preempted += 1
        tracing.event("gateway.preempt", request=victim.id,
                      model=rep.model, replica=rep.label,
                      tenant=victim.tenant,
                      priority=victim.priority,
                      preemptions=victim.preemptions,
                      tokens_kept=len(victim.tokens))
        victim._spans["admit"] = tracing.open_span(
            "gateway.admit", parent=victim._spans.get("request", _NULL),
            resumed=True, preemptions=victim.preemptions)
        self._queues[victim.priority].push(victim.tenant, victim)

    def _drain_segment(self, req, seg, now):
        """Forward every token the engine segment has produced so far
        into the gateway handle (idempotent; `_DONE` is left to the
        finish/fail paths)."""
        moved = 0
        while True:
            try:
                item = seg._stream.get_nowait()
            except _queue.Empty:
                return moved
            if item is _DONE:
                return moved
            req._emit(item, now)
            self._tenants[req.tenant].tokens_out += 1
            moved += 1

    def _pump(self, now):
        """Move tokens from engine segments into gateway handles and
        fold finished segments (done → done, failed → failed — engine
        errors propagate with their own class)."""
        moved = 0
        for m in self._models.values():
            for rep in m.replicas:
                for req in list(rep.live):
                    seg = req._segment
                    if seg is None:
                        rep.live.remove(req)
                        continue
                    moved += self._drain_segment(req, seg, now)
                    if not seg.done:
                        continue
                    rep.live.remove(req)
                    req._segment = None
                    t = self._tenants[req.tenant]
                    if seg.error is not None:
                        req._fail(seg.error, now)
                    else:
                        t.bucket.credit(req.est_cost
                                        - int(req.prompt.size)
                                        - len(req.tokens))
                        req._finish(now)
                    moved += 1
        return moved

    # -- driving ------------------------------------------------------------

    def _driver_running(self):
        d = self._driver
        return d is not None and d.is_alive()

    def _drive_until(self, reqs, timeout=None):
        t_end = None if timeout is None else time.monotonic() + timeout
        for req in reqs:
            while not req.done:
                if t_end is not None and time.monotonic() > t_end:
                    raise TimeoutError(
                        f"gateway request {req.id} still {req.state} "
                        f"after {timeout}s")
                if self._driver_running():
                    req.wait(0.05)
                else:
                    progressed = self.step()
                    if not progressed and not req.done:
                        raise RuntimeError(
                            f"gateway stalled: request {req.id} is "
                            f"{req.state} but nothing is progressing "
                            "(this is a bug — please report)")

    def generate(self, model, prompt_ids, max_new_tokens, tenant="default",
                 priority=None, temperature=1.0, eos_id=None,
                 deadline_s=None, timeout=None):
        """Blocking convenience: submit + drive; returns the FULL
        sequence (prompt + generated) as 1D int32 numpy."""
        req = self.submit(model, prompt_ids, max_new_tokens, tenant=tenant,
                          priority=priority, temperature=temperature,
                          eos_id=eos_id, deadline_s=deadline_s)
        self._drive_until([req], timeout=timeout)
        toks = req.result()
        return onp.concatenate([onp.asarray(req.prompt, onp.int32),
                                onp.asarray(toks, onp.int32)])

    def iter_tokens(self, handle, timeout=30.0):
        """Stream `handle`'s tokens (across preemptions — the handle's
        stream is continuous even when the slot moves)."""
        while True:
            try:
                item = handle._stream.get_nowait()
            except _queue.Empty:
                if self._driver_running() or handle.done:
                    try:
                        item = handle._stream.get(timeout=timeout)
                    except _queue.Empty:
                        raise TimeoutError(
                            f"no token from gateway request {handle.id} "
                            f"in {timeout}s (state={handle.state})") \
                            from None
                else:
                    self.step()
                    continue
            if item is _DONE:
                if handle.error is not None:
                    raise handle.error
                return
            yield item

    # -- driver thread -------------------------------------------------------

    def start(self):
        """Background driver thread owning the step loop. Idempotent."""
        if self._driver_running():
            return self
        self._stop.clear()

        def _loop():
            import logging

            log = logging.getLogger("incubator_mxnet_tpu.serve")
            failures = 0
            while not self._stop.is_set():
                try:
                    progressed = self.step()
                    failures = 0
                except Exception as e:
                    failures += 1
                    log.error(
                        "gateway driver: step failed (%d consecutive): "
                        "%s: %s", failures, type(e).__name__, e)
                    if failures >= _DRIVER_MAX_CONSECUTIVE_FAILURES:
                        log.error(
                            "gateway driver: stopping after %d "
                            "consecutive step failures — drive manually "
                            "after the cause is fixed", failures)
                        break
                    time.sleep(_IDLE_SLEEP_S)
                    continue
                if not progressed:
                    time.sleep(_IDLE_SLEEP_S)

        self._driver = threading.Thread(target=_loop,
                                        name="mx-gateway-driver",
                                        daemon=True)
        self._driver.start()
        return self

    def stop(self):
        self._stop.set()
        d = self._driver
        if d is not None:
            d.join(timeout=5.0)
        self._driver = None

    # -- lifecycle ----------------------------------------------------------

    def hot_swap(self, model=None):
        """Roll refreshed weights across serving replicas ONE AT A
        TIME, drain-free.

        A weight updated in place is read by every engine's graphs as it
        is; one replaced by a new tensor changes the engine's weight
        fingerprint, which it would pick up lazily at its next step. This
        makes the roll explicit and STAGGERED: the gateway lock is taken
        per replica and released between them, so the driver keeps
        stepping the other replicas while one drops its graphs
        (`SlotDecoder._refresh_params`) to capture them again over the
        new weights. In-flight requests keep their slots and KV — decode
        simply continues under the new weights. Returns
        ``{replica_label: changed}``."""
        with self._lock:
            if model is not None and model not in self._models:
                raise ValueError(
                    f"unknown model {model!r} (registered: "
                    f"{', '.join(sorted(self._models))})")
            groups = [self._models[model]] if model is not None \
                else list(self._models.values())
            reps = [rep for g in groups for rep in g.replicas]
        out = {}
        for rep in reps:
            with self._lock:
                refresh = getattr(rep.slots, "_refresh_params", None)
                changed = bool(refresh()) if refresh is not None else False
                out[rep.label] = changed
            tracing.event("gateway.hot_swap", replica=rep.label,
                          changed=changed)
        return out

    def shutdown(self, drain=True, timeout=None):
        """Stop the gateway. ``drain=True`` finishes dispatched work;
        gateway-queued (never-dispatched) requests fail with
        `EngineClosed` either way — loudly, never silently dropped."""
        with self._lock:
            self.closed = True
            now = time.monotonic()
            for tier in self.tiers:
                q = self._queues[tier]
                for req in q.items():
                    q.remove(req)
                    req._fail(EngineClosed(
                        f"gateway shut down before request {req.id} was "
                        "dispatched"), now)
            for m in self._models.values():
                for rep in m.replicas:
                    rep.sched.close(drain=drain)
            self._pump(now)
        if drain:
            t_end = None if timeout is None else time.monotonic() + timeout
            while True:
                with self._lock:
                    busy = any(rep.sched.n_active
                               for m in self._models.values()
                               for rep in m.replicas)
                    if busy:
                        if not self._driver_running():
                            for m in self._models.values():
                                for rep in m.replicas:
                                    if rep.sched.n_active:
                                        rep.sched.step()
                            self._pump(time.monotonic())
                if not busy:
                    break
                if t_end is not None and time.monotonic() > t_end:
                    raise TimeoutError(
                        f"gateway drain did not finish in {timeout}s")
                if self._driver_running():
                    time.sleep(0.01)
        self.stop()
        with self._lock:
            self._pump(time.monotonic())
            for m in self._models.values():
                for rep in m.replicas:
                    rep.sched.slots.prefix_cache.clear()
                    rep.sched.slots.release()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)
