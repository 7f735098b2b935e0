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
  thread, ``spec_stats()`` and ``shutdown(drain=True)``.

The registry (`telemetry.registry`) carries ``mx_serve_ttft_seconds``,
``mx_serve_tokens_total``, ``mx_serve_queue_depth``,
``mx_serve_slot_occupancy``, ``mx_serve_page_occupancy``,
``mx_serve_prefix_hits_total``, ``mx_serve_prefill_chunks_total``,
``mx_serve_evictions_total``, ``mx_serve_spec_drafted_tokens_total``,
``mx_serve_spec_accepted_tokens_total``,
``mx_serve_spec_accept_rate{model=...}`` and
``mx_decode_bucket_pad_tokens_total``. The disaggregation hand-off, the
sharding and HBM pre-flights, tracing spans, the capacity and anatomy
ledgers, the gateway, tenancy, routing and the sharded engine are not
ported yet (`ROADMAP.md`).

Typical use::

    from incubator_mxnet_tpu_torch import serve

    engine = serve.ServeEngine(model, max_slots=8, spec_k=4,
                               draft="ngram").start()
    h = engine.submit(prompt_ids, max_new_tokens=128)
    for tok in engine.iter_tokens(h):
        ...
    engine.shutdown(drain=True)
"""
from __future__ import annotations

from . import api, engine, scheduler
from .api import ServeEngine
from .engine import PageAllocator, PagePoolExhausted, PrefixCache, SlotDecoder
from .scheduler import (DeadlineExceeded, EngineClosed, QueueFull, Request,
                        Scheduler)

__all__ = ["ServeEngine", "SlotDecoder", "Scheduler", "Request",
           "PageAllocator", "PrefixCache", "PagePoolExhausted",
           "QueueFull", "DeadlineExceeded", "EngineClosed",
           "api", "engine", "scheduler"]
