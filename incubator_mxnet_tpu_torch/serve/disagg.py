"""Disaggregated prefill/decode serving: heterogeneous replica roles
with KV page migration (port of `incubator_mxnet_tpu/serve/disagg.py`:
`pump_migrations`, `_migrate`, `_fallback_colocate`, `_requeue`,
`warm_decode_replica`, `decode_prefill_families` :374 and the migration
counters), host code ported nearly verbatim. On one card the replicas
share the device, and a migration is a device-to-device copy of whole
pages into the adopting replica's pools, written in place
(`SlotDecoder.copy_pages_in`), so its captured graphs read them.

Prefill and decode sit on opposite ends of the roofline — prefill is
compute-bound (big matmuls over whole prompt chunks), decode is
bandwidth-bound (one token per resident request per step, gathered
through the page table). A homogeneous pod makes every replica serve
both, so every replica's memory carries peak-prefill working sets AND
the full resident-KV population. Disaggregation (DistServe,
Zhong et al., OSDI'24; Splitwise, Patel et al., ISCA'24) splits the
pod by ROLE:

- ``role="prefill"`` replicas run ONLY chunked prefill. Their slots
  turn over per-prompt (a handoff segment frees its slot the moment
  the final chunk samples the first token) and their pool holds only
  transient prompt pages — a ~25% cut of the model's page budget
  (`ModelRegistry.rebalance_pages_disagg`).
- ``role="decode"`` replicas run ONLY the gather-by-table decode step
  (plus spec-decode verify/draft when armed). They never see a prompt
  to prefill — requests arrive ALREADY PREFILLED through
  `Scheduler.adopt` — so they never run a prefill chunk, and the memory
  that would have funded prefill working sets funds pages instead: more
  resident decode slots per card.
- ``role="both"`` is the homogeneous default; a model whose replicas
  are all ``"both"`` never enters this module.

THE MIGRATION PLANE (this module is the one place in serve/ that
touches another replica's pool):

1. the gateway dispatches a fresh request to a prefill replica with
   ``prefill_only=True`` (placement: least chunk-backlog,
   `ReplicaRouter.pick_prefill`);
2. when the final chunk samples the first token, the scheduler parks
   the segment in ``take_prefilled()`` — slot freed, page refs kept;
3. `pump_migrations` (called from ``Gateway._step`` under the gateway
   lock) claims the segment, picks a decode replica (free pages +
   prefix warmth, `ReplicaRouter.pick_decode`), allocates the full
   decode-side page budget up front (the same no-mid-flight-OOM rule
   as admission), and copies the prompt's pages whole —
   `SlotDecoder.copy_pages_out` → `copy_pages_in`, whole-page copies
   on the card, so the decode side is BIT-IDENTICAL to having prefilled
   locally (trailing garbage in a partial last page is masked by
   position exactly like locally-prefilled padding);
4. the moved pages become a content-addressed `PrefixCache` fill on
   the decode side — the same blake2b page-boundary digests now
   resolve there, so a follow-up request with the same prompt prefix
   warms against the DECODE replica (and the migration itself is
   idempotent against re-sends);
5. refcounts hand off: the source replica's request refs drop (its
   prefix cache keeps the prompt warm for future prefills), the
   destination request owns fresh refs, and the cache fill increfs the
   aligned pages — audited by ``mx_serve_page_migration_pages_total``
   and ``mx_serve_page_migration_bytes_total{model=}`` (bytes is
   EXACTLY pages-moved × `SlotDecoder.page_bytes`);
6. `Scheduler.adopt` admits the request directly into the decoding
   state, first token seeded, positions identical to a co-located
   request — greedy output is bit-identical.

ROLLBACK: a mid-handoff fault (the ``page_migration`` chaos seam) or
a page-exhausted decode side falls back to ``role="both"``
co-location — the request is adopted on its OWN prefill replica (the
KV never left), with a gateway-queue resume as the last resort when
even that pool cannot fund the decode tail. No path leaks a page:
destination pages allocated before a failed copy are rolled back
before the fallback runs, and tests assert allocator refcounts return
to baseline.

Knobs: ``MXNET_DISAGG`` (make every ``add()`` disaggregated by
default), ``MXNET_SERVE_PREFILL_REPLICAS`` /
``MXNET_SERVE_DECODE_REPLICAS`` (role counts under that gate).
"""
from __future__ import annotations

import time

import numpy as onp

from ..fault.injection import FaultInjected
from ..telemetry import anatomy, registry, tracing
from .engine import PagePoolExhausted
from .scheduler import _NULL

__all__ = ["MigrationAborted", "pump_migrations", "warm_decode_replica",
           "decode_prefill_families", "migration_counts"]

_WARM_STEP_GUARD = 50_000


class MigrationAborted(RuntimeError):
    """A page migration could not run (no viable decode replica, or
    its pool is exhausted). The request is NOT lost — the caller falls
    back to co-located serving on the prefill replica."""


# -- telemetry ---------------------------------------------------------------

def _pages_counter(model):
    return registry.counter(
        "mx_serve_page_migration_pages_total",
        "KV pool pages moved prefill→decode by the disagg migration "
        "plane",
        labels={"model": model})


def _bytes_counter(model):
    return registry.counter(
        "mx_serve_page_migration_bytes_total",
        "bytes of KV moved prefill→decode (exactly pages moved × "
        "per-page pool bytes)",
        labels={"model": model})


def migration_counts(model):
    """Live ``(pages, bytes)`` counter values for `model` — the byte
    audit surface for tests and benches."""
    return (int(_pages_counter(model).value),
            int(_bytes_counter(model).value))


# -- role helpers ------------------------------------------------------------

def role_of(rep):
    return getattr(rep, "role", "both")


def is_disagg(model):
    """True when any replica of `model` (a gateway `_Model`) carries a
    dedicated role — the gateway's gate for running the migration
    plane at all."""
    return any(role_of(r) != "both" for r in model.replicas)


def _can_adopt(rep, prompt_len, max_new):
    """Viability predicate for decode placement: a free slot now (adopt
    never queues) and a page budget the pool could cover after
    dropping unused cache entries."""
    if rep.draining or role_of(rep) == "prefill":
        return False
    sched = rep.sched
    if sched.free_slots <= 0:
        return False
    plan = getattr(sched, "adopt_page_plan", None)
    if plan is None:
        return False
    _content, physical, reserved = plan(prompt_len, max_new)
    alloc = rep.slots.allocator
    reclaimable = getattr(rep.slots.prefix_cache, "cached_pages", 0)
    return (physical + reserved
            <= alloc.free_pages - sched._spec_reserved_total()
            + reclaimable)


# -- the migration plane -----------------------------------------------------

def pump_migrations(gw, m, now):
    """Claim every segment whose prefill-only pass completed this step
    and move it to a decode replica (or fall back). Runs under the
    gateway lock from ``Gateway._step``; this function and its callees
    are the ONLY code that touches another replica's allocator, prefix
    cache, or pool leaves."""
    moved = 0
    for rep in list(m.replicas):
        take = getattr(rep.sched, "take_prefilled", None)
        if take is None:
            continue
        for seg in take():
            greq = next((r for r in rep.live if r._segment is seg), None)
            if greq is None:
                # orphaned segment (its gateway handle was re-owned by
                # a crash requeue): release the pages, loudly traced
                if seg.pages:
                    rep.slots.allocator.decref(seg.pages)
                seg.pages = None
                rep.sched.finish_handoff(seg)
                tracing.event("serve.disagg.orphan", request=seg.id,
                              replica=rep.label)
                continue
            # the first token reaches the tenant handle before the
            # pages move — TTFT is a prefill-side property
            gw._drain_segment(greq, seg, now)
            try:
                moved += _migrate(gw, m, rep, greq, seg, now)
            except (MigrationAborted, PagePoolExhausted,
                    FaultInjected) as e:
                _fallback_colocate(gw, rep, greq, seg, now, reason=e)
                moved += 1
    return moved


def _migrate(gw, m, src, greq, seg, now):
    prompt = seg.prompt
    p_len = int(prompt.size)
    dst = m.router.pick_decode(
        m.replicas, prompt=prompt,
        viable=lambda r: r is not src
        and _can_adopt(r, p_len, seg.max_new))
    if dst is None:
        raise MigrationAborted(
            f"no decode replica can adopt request {seg.id} "
            "(slots or pages exhausted everywhere)")
    content, physical, reserved = dst.sched.adopt_page_plan(
        p_len, seg.max_new)
    alloc = dst.slots.allocator
    need = physical + reserved
    spec_total = dst.sched._spec_reserved_total()
    if need > alloc.free_pages - spec_total:
        dst.slots.prefix_cache.evict_unused(need + spec_total)
    if need > alloc.free_pages - spec_total:
        raise MigrationAborted(
            f"decode replica {dst.label} is page-exhausted: request "
            f"{seg.id} needs {need} pages, {alloc.free_pages} free")
    # full decode budget up front — the adopted request can never hit
    # a mid-flight page OOM, same rule as local admission
    mig_t0 = time.perf_counter() if anatomy._ENABLED else None
    dst_pages = alloc.alloc(physical)
    try:
        from ..fault.injection import inject_at

        inject_at("page_migration")
        if hasattr(src.slots, "copy_pages_out") \
                and hasattr(dst.slots, "copy_pages_in"):
            payload = src.slots.copy_pages_out(seg.pages[:content])
            dst.slots.copy_pages_in(dst_pages[:content], payload)
    except BaseException:
        # rollback: the destination never saw this request
        alloc.decref(dst_pages)
        raise
    # content-addressed cache fill: the prompt's page digests now
    # resolve on the decode side (increfs the aligned pages)
    dst.slots.prefix_cache.register(prompt, dst_pages[:content])
    page_bytes = int(getattr(src.slots, "page_bytes", 0) or 0)
    _pages_counter(m.name).inc(content)
    _bytes_counter(m.name).inc(content * page_bytes)
    deadline_s = None if greq.deadline is None \
        else max(greq.deadline - now, 1e-6)
    new_seg = dst.sched.adopt(
        prompt, seg.first_token, seg.max_new, dst_pages,
        spec_reserved=reserved, temperature=greq.temperature,
        eos_id=greq.eos_id, deadline_s=deadline_s,
        parent_span=greq._spans.get("request", _NULL),
        tenant=greq.tenant)
    # refcount handoff: the request's source refs drop; the source
    # prefix cache keeps the prompt warm for future prefills there
    src.slots.allocator.decref(seg.pages)
    seg.pages = None
    src.sched.finish_handoff(seg)
    src.live.remove(greq)
    dst.live.append(greq)
    greq._segment = new_seg
    greq.replica = dst.label
    if mig_t0 is not None:
        # the copy+adopt window is migration residency on the ADOPTING
        # side (it funds the pages and runs the adopt)
        anatomy.on_migration(dst.sched, mig_t0, time.perf_counter())
    rec = greq._anatomy
    if rec is not None:
        new_seg.anatomy = rec
        rec.adopted(now, migrated=True)
    tracing.event("serve.disagg.migrate", request=greq.id,
                  src=src.label, dst=dst.label, pages=content,
                  bytes=content * page_bytes)
    return 1


def _fallback_colocate(gw, src, greq, seg, now, reason):
    """Rollback to ``role="both"`` co-location: finish the request on
    the replica that already holds its KV. Used when the handoff
    faulted mid-copy (``page_migration`` seam) or every decode replica
    is page-exhausted. Falls through to a gateway-queue resume when
    even the source pool cannot fund the decode tail — the request is
    never dropped and no page leaks on any path."""
    sched = src.sched
    alloc = src.slots.allocator
    _content, physical, reserved = sched.adopt_page_plan(
        int(seg.prompt.size), seg.max_new)
    extra = physical - len(seg.pages)
    need = extra + reserved
    ok = sched.free_slots > 0
    if ok and need > alloc.free_pages - sched._spec_reserved_total():
        src.slots.prefix_cache.evict_unused(
            need + sched._spec_reserved_total())
        ok = need <= alloc.free_pages - sched._spec_reserved_total()
    if not ok:
        _requeue(gw, src, greq, seg, now, reason)
        return
    pages = list(seg.pages) + (alloc.alloc(extra) if extra > 0 else [])
    seg.pages = None            # ownership moves to the adopted request
    deadline_s = None if greq.deadline is None \
        else max(greq.deadline - now, 1e-6)
    new_seg = sched.adopt(
        seg.prompt, seg.first_token, seg.max_new, pages,
        spec_reserved=reserved, temperature=greq.temperature,
        eos_id=greq.eos_id, deadline_s=deadline_s,
        parent_span=greq._spans.get("request", _NULL),
        tenant=greq.tenant)
    sched.finish_handoff(seg)
    greq._segment = new_seg     # stays in src.live, same replica label
    rec = greq._anatomy
    if rec is not None:
        new_seg.anatomy = rec
        rec.adopted(now, migrated=False)
    tracing.event("serve.disagg.fallback", request=greq.id,
                  replica=src.label, reason=str(reason))


def _requeue(gw, src, greq, seg, now, reason):
    """Last-resort fallback: re-enter the gateway queue as a resume —
    the preemption path, so the first token survives on the handle and
    the re-prefill lands warm (the prompt's pages are registered in
    the source replica's prefix cache)."""
    if seg.pages:
        src.slots.allocator.decref(seg.pages)
    seg.pages = None
    src.sched.finish_handoff(seg)
    src.live.remove(greq)
    greq._segment = None
    gen = onp.asarray(greq.tokens, onp.int32)
    greq._resume_prompt = onp.concatenate(
        [onp.asarray(greq.prompt, onp.int32), gen])
    greq._remaining = greq.max_new - len(greq.tokens)
    greq.preemptions += 1
    greq.state = "queued"
    greq.replica = None
    if greq._anatomy is not None:
        greq._anatomy.requeued(now, "migration_fallback")
    gw.preemptions_total += 1
    greq._spans["admit"] = tracing.open_span(
        "gateway.admit", parent=greq._spans.get("request", _NULL),
        resumed=True, migration_fallback=True)
    gw._queues[greq.priority].push(greq.tenant, greq)
    tracing.event("serve.disagg.requeue", request=greq.id,
                  replica=src.label, reason=str(reason))


# -- warm + gates ------------------------------------------------------------

def warm_decode_replica(rep, warm_lens=(8,), warm_new=2):
    """Warm ONLY the decode side of a decode-role replica: fake
    already-prefilled requests are adopted (page content is garbage —
    a graph's capture depends on shapes alone) and driven to
    completion, capturing decode (and, when armed, spec verify/draft)
    while the replica is still outside the routing set. No prefill
    chunk runs, so the invariant — decode replicas never run a prefill
    chunk — holds from the replica's first live request."""
    sched = rep.sched
    alloc = rep.slots.allocator
    warm_tok = anatomy.warmup_begin(sched)
    max_len = int(getattr(rep.slots, "max_len", 1 << 30))
    warm_new = max(2, int(warm_new))    # >= 1 real decode step
    for i, L in enumerate(warm_lens):
        L = max(1, min(int(L), max_len - warm_new - 1))
        prompt = onp.full(L, i + 1, onp.int32)
        _content, physical, reserved = sched.adopt_page_plan(L, warm_new)
        pages = alloc.alloc(physical)
        seg = sched.adopt(prompt, 1, warm_new, pages,
                          spec_reserved=reserved)
        guard = 0
        while not seg.done:
            sched.step()
            guard += 1
            if guard > _WARM_STEP_GUARD:
                raise RuntimeError(
                    f"replica {rep.label}: decode warmup (len {L}) did "
                    f"not finish within {_WARM_STEP_GUARD} engine steps")
        if seg.error is not None:
            raise RuntimeError(
                f"replica {rep.label}: decode warmup (len {L}) failed: "
                f"{type(seg.error).__name__}: {seg.error}")
    anatomy.warmup_end(sched, warm_tok)


def decode_prefill_families(gw, model):
    """Prefill evidence on `model`'s decode-role replicas — MUST be
    empty; tests and `chip_smoke.py` assert on it. Checks both the live
    evidence (the prefill chunk buckets a decode replica has run,
    ``SlotDecoder._buckets_seen``, the port's counterpart of the
    reference's built ``_prefill_jit``) and the program ledger (any
    ``serve:<label>.*prefill*`` family with entries, `telemetry.compiles`)."""
    from ..telemetry import compiles

    m = gw._models[model]
    led = compiles.ledger()
    bad = {}
    for rep in m.replicas:
        if role_of(rep) != "decode":
            continue
        evidence = []
        seen = getattr(rep.slots, "_buckets_seen", None)
        if seen:
            evidence.append(f"live:_buckets_seen={sorted(seen)}")
        prefix = f"serve:{rep.label}."
        for fam, entries in led.items():
            if fam.startswith(prefix) and "prefill" in fam and entries:
                evidence.append(f"ledger:{fam}")
        if evidence:
            bad[rep.label] = evidence
    return bad
