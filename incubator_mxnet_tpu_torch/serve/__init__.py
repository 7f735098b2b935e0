"""Continuous-batching inference serving (port of
`incubator_mxnet_tpu/serve/`, its base configuration): requests arrive
and finish at different times and share a fixed number of decode slots
over a paged KV pool (Orca's iteration-level batching, vLLM's paged KV).

- `engine`: `SlotDecoder`, the per-layer paged device pool (in the
  weights' dtype, or int8 with one scale per page and head), the host
  `PageAllocator` (refcounts, loud `PagePoolExhausted`) and `PrefixCache`
  (a shared system prompt prefilled once), page-aligned chunked prefill,
  the batched decode step, and speculative decoding's verify step and
  draft-model step; on the card decode, verify and draft are each
  replayed as one CUDA graph;
- `scheduler`: `Scheduler`, the bounded admission queue (FIFO or
  remaining-chunk SJF), loud `QueueFull` backpressure, per-request
  deadlines (`DeadlineExceeded`), the ``step()`` loop that interleaves
  prefill chunks with decode steps (or speculative rounds: draft,
  verify, accept, roll back the rejected pages) and retires slots on EOS
  or length mid-flight, and ``preempt``;
- `api`: `ServeEngine`, thread-safe blocking ``generate``, streaming
  ``submit``/``iter_tokens``, ``generate_many``, a background driver
  thread, ``spec_stats()`` and ``shutdown(drain=True)``;
- `gateway`: `ModelRegistry` (co-resident models under one page budget,
  N replicas a model sharing the card, or a prefill/decode split) and
  `Gateway`, the multi-tenant front door: priority tiers, weighted
  deficit round robin across tenants (`tenancy`), token quotas,
  preemption through ``Scheduler.preempt``, replica routing (`router`),
  ``hot_swap``;
- `disagg`: the migration plane of a disaggregated pod: a prefill
  replica's finished prompt pages are copied whole into a decode
  replica's pools on the card and the request is adopted there;
- `advisor`: `AutoscaleAdvisor`, observe-only scale recommendations from
  the timeseries history (occupancy, queue depth) and the burn-rate
  alerts, refined by role residency on a disaggregated pod;
- `elastic`: `ReplicaSetController`, which acts on the advice: spawns
  (funded, built, warmed, then published), drains and retires replicas,
  and replaces a dead one with its requests re-queued.

The engine joins the telemetry plane: each request is a trace
(``serve.request`` with its queue, prefill and decode spans, under the
gateway's ``gateway.request`` when it came through one), every step a
``serve.step`` span with the ``serve_step`` fault seam, the capacity and
anatomy ledgers are charged at the prefill and decode seams, and a
failed step leaves a flight-recorder dump. The registry
(`telemetry.registry`) carries ``mx_serve_ttft_seconds``,
``mx_serve_tokens_total``, ``mx_serve_queue_depth``,
``mx_serve_slot_occupancy``, ``mx_serve_page_occupancy``,
``mx_serve_prefix_hits_total``, ``mx_serve_prefill_chunks_total``,
``mx_serve_evictions_total``, ``mx_serve_spec_drafted_tokens_total``,
``mx_serve_spec_accepted_tokens_total``,
``mx_serve_spec_accept_rate{model=...}``,
``mx_decode_bucket_pad_tokens_total``, the gateway's
``mx_gateway_queue_depth{priority=}``, ``mx_gateway_dispatch_total``,
``mx_serve_replica_free_pages{replica=}``, and the migration plane's
``mx_serve_page_migration_pages_total`` and ``..._bytes_total``, the
advisor's ``mx_advisor_recommendation{action=}``, the controller's
``mx_elastic_scale_events_total{direction=}`` and
``mx_serve_replicas{model=}``. Each engine's KV pool and weights are
device-memory census owners (`telemetry.hbm`), and each program it
builds (a captured step, a new prefill bucket) is a ledger entry
(`telemetry.compiles`). The sharded engine is not ported yet
(`ROADMAP.md`).

Typical use::

    from incubator_mxnet_tpu_torch import serve

    engine = serve.ServeEngine(model, max_slots=8, spec_k=4,
                               draft="ngram").start()
    h = engine.submit(prompt_ids, max_new_tokens=128)
    for tok in engine.iter_tokens(h):
        ...
    engine.shutdown(drain=True)

    reg = serve.ModelRegistry(total_pages=120)
    reg.add("chat", model, share=2.0, max_slots=4, max_len=128)
    gw = serve.Gateway(reg, tenants={"acme": {"weight": 3.0}})
    out = gw.generate("chat", prompt_ids, 32, tenant="acme",
                      priority="high")
"""
from __future__ import annotations

from . import (advisor, api, disagg, elastic, engine, gateway, router,
               scheduler, tenancy)
from .advisor import AutoscaleAdvisor
from .api import ServeEngine
from .engine import PageAllocator, PagePoolExhausted, PrefixCache, SlotDecoder
from .elastic import ReplicaScaleError, ReplicaSetController
from .gateway import Gateway, GatewayRequest, ModelRegistry
from .router import ReplicaRouter
from .scheduler import (DeadlineExceeded, EngineClosed, QueueFull, Request,
                        Scheduler)

__all__ = ["ServeEngine", "SlotDecoder", "Scheduler", "Request",
           "PageAllocator", "PrefixCache", "PagePoolExhausted",
           "QueueFull", "DeadlineExceeded", "EngineClosed",
           "ModelRegistry", "Gateway", "GatewayRequest", "ReplicaRouter",
           "ReplicaSetController", "ReplicaScaleError", "AutoscaleAdvisor",
           "api", "engine", "scheduler", "gateway", "tenancy", "router",
           "disagg", "advisor", "elastic"]
