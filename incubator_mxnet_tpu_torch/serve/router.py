"""Replica routing for pod-scale serving: which of a model's N engines
gets the next request (port of `incubator_mxnet_tpu/serve/router.py`:
`replica_meshes` :45, `ReplicaRouter` :75 with its host scoring, `pick`,
`pick_prefill` and `pick_decode`).

One model behind the gateway may be served by N independent replicas
(`ModelRegistry.add(..., replicas=N)`) — each its own `SlotDecoder` (or,
with ``mesh=``, `serve.sharded.ShardedSlotDecoder` over its own slice of
the world's ranks), page pool, prefix cache, scheduler and graphs; on one
card they share the device. This module decides placement:

- **least-loaded** — replicas are ranked by headroom: the free fraction
  of their KV page pool minus a queue-depth penalty
  (``w_pages * free_page_frac − w_queue * queue_depth``). Pages are the
  scarce serving resource (a deep queue with free pages drains faster
  than a shallow queue on a full pool), so pages carry the larger
  weight.

- **session affinity** (``MXNET_SERVE_AFFINITY``) — ``prefix`` (default)
  probes each replica's prefix cache with the request's prompt
  (`PrefixCache.shared_tokens`, a read-only host-side digest walk) and
  prefers the replicas holding the longest warm page-aligned prefix: a
  tenant's shared-system-prompt burst lands where its KV pages already
  live instead of re-prefilling on a cold replica. ``tenant`` pins each
  tenant to a stable hash-preferred replica (useful when prompts do not
  share pages but per-tenant batching locality matters). ``off`` is
  pure least-loaded.

Affinity never overrides viability: a warm replica with no capacity is
skipped (the gateway may then preempt on the chosen replica, not the
warm one). Ties inside the warm set fall back to least-loaded.

`replica_meshes` carves the world's ranks (the reference: one host's
devices) into disjoint, consecutive per-replica mesh slices.
"""
from __future__ import annotations

import hashlib
import os

__all__ = ["ReplicaRouter", "replica_meshes"]

_AFFINITY_MODES = ("prefix", "tenant", "off")


def replica_meshes(spec, n_replicas, devices=None):
    """N disjoint serving meshes of ``prod(spec)`` ranks each, carved
    consecutively from ``devices`` (default: every rank of the world).
    Raises when the world cannot seat ``n_replicas × prod(spec)``
    ranks."""
    from ..parallel.mesh import _world
    from .sharded import parse_mesh_spec, serve_mesh

    axes = parse_mesh_spec(spec)
    per = 1
    for v in axes.values():
        per *= int(v)
    if devices is None:
        devices = range(_world()[2])
    devices = list(devices)
    need = per * int(n_replicas)
    if len(devices) < need:
        raise ValueError(
            f"replica_meshes: {n_replicas} replicas of {axes} need "
            f"{need} devices, have {len(devices)}")
    return [serve_mesh(axes, devices=devices[i * per:(i + 1) * per])
            for i in range(int(n_replicas))]


def _tenant_hash(tenant, n):
    """Stable (process-independent) tenant → replica-index hash."""
    h = hashlib.blake2b(str(tenant).encode(), digest_size=4)
    return int.from_bytes(h.digest(), "big") % max(int(n), 1)


class ReplicaRouter:
    """Pick a replica for one request: affinity first, least-loaded
    within the affinity set. Stateless between calls — every decision
    reads the replicas' live allocator/scheduler counters, so the
    router never drifts from reality."""

    def __init__(self, affinity=None, w_pages=1.0, w_queue=0.25):
        if affinity is None:
            affinity = os.environ.get("MXNET_SERVE_AFFINITY", "") \
                or "prefix"
        affinity = str(affinity).lower()
        if affinity in ("0", "none", "false"):
            affinity = "off"
        if affinity not in _AFFINITY_MODES:
            raise ValueError(
                f"unknown affinity mode {affinity!r} (one of "
                f"{', '.join(_AFFINITY_MODES)}; knob MXNET_SERVE_AFFINITY)")
        self.affinity = affinity
        self.w_pages = float(w_pages)
        self.w_queue = float(w_queue)

    # -- scoring ------------------------------------------------------------

    def load_score(self, replica):
        """Headroom score: higher = better target. Free-page fraction
        of the pool minus a queue-depth penalty (pool pressure is the
        scarcer resource; see module docstring)."""
        slots = replica.slots
        alloc = getattr(slots, "allocator", None)
        if alloc is not None and getattr(alloc, "usable_pages", 0):
            free_frac = alloc.free_pages / alloc.usable_pages
        else:
            free_frac = 1.0
        return (self.w_pages * free_frac
                - self.w_queue * replica.sched.queue_depth)

    def warm_tokens(self, replica, prompt):
        """Tokens of `prompt` already resident in the replica's prefix
        cache (0 when it has none, e.g. test stubs)."""
        cache = getattr(replica.slots, "prefix_cache", None)
        if cache is None or prompt is None:
            return 0
        try:
            return int(cache.shared_tokens(prompt))
        except Exception:
            return 0

    # -- selection ----------------------------------------------------------

    def pick(self, replicas, prompt=None, tenant=None, viable=None):
        """The replica to dispatch to, or None when `replicas` is empty
        / nothing passes `viable`. `viable` is the gateway's capacity
        (or capacity-after-preemption) predicate. A replica marked
        ``draining`` by the elastic controller is never picked, even
        for callers routing without a viability predicate."""
        cands = [r for r in replicas
                 if not getattr(r, "draining", False)
                 and (viable is None or viable(r))]
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0]
        if self.affinity == "prefix":
            warm = [(self.warm_tokens(r, prompt), r) for r in cands]
            best = max(w for w, _ in warm)
            if best > 0:
                cands = [r for w, r in warm if w == best]
        elif self.affinity == "tenant" and tenant is not None:
            idx = _tenant_hash(tenant, len(replicas))
            preferred = replicas[idx]
            if any(r is preferred for r in cands):
                return preferred
        return max(cands, key=self.load_score)

    # -- two-stage disaggregated dispatch (serve/disagg.py) -----------------

    def pick_prefill(self, replicas, viable=None):
        """Stage 1 of disaggregated dispatch: the prefill-capable
        replica (role ``prefill`` or ``both``) with the SHALLOWEST
        chunk backlog — prefill replicas are compute-bound, so queued
        prompt chunks (not pages) are the contended resource. Ties
        break by load score."""
        cands = [r for r in replicas
                 if not getattr(r, "draining", False)
                 and getattr(r, "role", "both") != "decode"
                 and (viable is None or viable(r))]
        if not cands:
            return None
        def backlog(r):
            return int(getattr(r.sched, "prefill_backlog",
                               r.sched.queue_depth))
        return min(cands, key=lambda r: (backlog(r),
                                         -self.load_score(r)))

    def pick_decode(self, replicas, prompt=None, viable=None):
        """Stage 2 of disaggregated dispatch: the decode-capable
        replica (role ``decode`` or ``both``) a prefilled request's
        pages migrate to. Prefix warmth first — a replica already
        holding this prompt's page-aligned digests adopts the request
        with fewer (or zero) pages to copy — then free pages, the
        decode-side scarce resource."""
        cands = [r for r in replicas
                 if not getattr(r, "draining", False)
                 and getattr(r, "role", "both") != "prefill"
                 and (viable is None or viable(r))]
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0]
        if self.affinity == "prefix":
            warm = [(self.warm_tokens(r, prompt), r) for r in cands]
            best = max(w for w, _ in warm)
            if best > 0:
                cands = [r for w, r in warm if w == best]
        return max(cands, key=self.load_score)
