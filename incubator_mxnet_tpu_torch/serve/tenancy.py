"""Multi-tenant serving primitives: priority tiers, token-rate quotas,
and weighted deficit-round-robin (WDRR) fairness (port of
`incubator_mxnet_tpu/serve/tenancy.py`, verbatim but for this paragraph).

Pure host-side machinery for `serve.gateway` — nothing here touches the
device or imports anything of the package. Three pieces:

- **priority tiers** — an ordered tuple of tier names, highest first
  (default ``("high", "normal", "low")``; override via
  ``MXNET_SERVE_PRIORITY_TIERS=a,b,c``). The gateway keeps one WDRR
  queue per tier and always drains higher tiers first; a higher-tier
  arrival may PREEMPT a lower-tier running slot (gateway.py).

- :class:`TokenBucket` — the per-tenant token-rate quota. Capacity
  refills continuously at ``rate`` tokens/s up to ``burst``; a request
  is dispatched only when the bucket covers its estimated cost
  (prompt + max_new tokens), and the UNUSED part of the estimate is
  credited back at completion, so quotas meter real token work, not
  worst-case reservations. ``rate=None`` = unmetered (the default
  tenant profile unless ``MXNET_SERVE_TENANT_QUOTA`` says otherwise).

- :class:`WDRRQueue` — deficit round robin with per-tenant weights
  (Shreedhar & Varghese, SIGCOMM '95) over heterogeneous request costs:
  each visit grants a tenant ``quantum * weight`` deficit; its head
  request dispatches only when the accumulated deficit covers the
  request's cost. A tenant whose queue empties forfeits its deficit
  (no banking), so long-idle tenants cannot burst past the weights.

All clocks are explicit ``now`` parameters (monotonic seconds) — the
tests drive virtual time, the gateway passes ``time.monotonic()``.
"""
from __future__ import annotations

import collections

__all__ = ["DEFAULT_TIERS", "parse_tiers", "parse_quota", "TokenBucket",
           "Tenant", "WDRRQueue"]

DEFAULT_TIERS = ("high", "normal", "low")


def parse_tiers(spec=None):
    """Tier names from a ``MXNET_SERVE_PRIORITY_TIERS``-style spec
    (comma-separated, highest priority first). None/"" → the default
    three tiers. Duplicates and empty names are loud errors."""
    if spec is None or not str(spec).strip():
        return DEFAULT_TIERS
    names = tuple(s.strip() for s in str(spec).split(","))
    if any(not n for n in names):
        raise ValueError(
            f"empty tier name in priority-tier spec {spec!r}")
    if len(set(names)) != len(names):
        raise ValueError(
            f"duplicate tier name in priority-tier spec {spec!r}")
    return names


def parse_quota(spec=None):
    """Default per-tenant token-rate quota from a
    ``MXNET_SERVE_TENANT_QUOTA``-style spec: tokens/second as a float,
    with an optional ``:burst`` suffix. ``None``/""/"0" → unmetered
    (returns ``(None, None)``)."""
    if spec is None or not str(spec).strip():
        return None, None
    parts = str(spec).split(":")
    rate = float(parts[0])
    if rate <= 0:
        return None, None
    burst = float(parts[1]) if len(parts) > 1 else 4.0 * rate
    return rate, burst


class TokenBucket:
    """Continuous-refill token bucket (``rate`` tokens/s, ``burst``
    cap). ``rate=None`` disables metering — every debit succeeds."""

    __slots__ = ("rate", "burst", "_level", "_t")

    def __init__(self, rate=None, burst=None):
        self.rate = None if rate is None else float(rate)
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"quota rate must be > 0, got {rate}")
        self.burst = (None if self.rate is None
                      else float(burst if burst is not None
                                 else 4.0 * self.rate))
        self._level = self.burst
        self._t = None

    def _refill(self, now):
        if self._t is not None and now > self._t:
            self._level = min(self.burst,
                              self._level + (now - self._t) * self.rate)
        self._t = now

    def level(self, now):
        """Current token level (None = unmetered)."""
        if self.rate is None:
            return None
        self._refill(now)
        return self._level

    def try_debit(self, n, now):
        """Take `n` tokens if the bucket covers them; False otherwise
        (the caller keeps the request queued — quotas defer, they never
        drop)."""
        if self.rate is None:
            return True
        self._refill(now)
        if self._level >= n:
            self._level -= n
            return True
        return False

    def credit(self, n):
        """Refund unused estimate (request finished short of max_new)."""
        if self.rate is not None and n > 0:
            self._level = min(self.burst, self._level + n)


class Tenant:
    """Per-tenant accounting record: fairness weight, quota bucket, and
    lifetime token counters (the gateway labels its metric series off
    these names)."""

    __slots__ = ("name", "weight", "bucket", "tokens_out", "dispatched",
                 "preempted")

    def __init__(self, name, weight=1.0, rate=None, burst=None):
        self.name = str(name)
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError(
                f"tenant {name!r}: weight must be > 0, got {weight}")
        self.bucket = TokenBucket(rate, burst)
        self.tokens_out = 0
        self.dispatched = 0
        self.preempted = 0


class WDRRQueue:
    """Weighted deficit round robin over per-tenant FIFO queues (one
    instance per priority tier).

    ``pop_next`` pops the next dispatchable item, visiting tenants in
    rotation: every visit grants ``quantum * weight`` deficit, the head
    item pops once the deficit covers its cost. Costs are token
    estimates, so a tenant sending few huge requests and one sending
    many small ones converge to the same weighted token share."""

    def __init__(self, quantum=256):
        self.quantum = float(quantum)
        if self.quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        # bounded by the gateway's max_queue admission check (QueueFull
        # at submit); maxlen would silently drop — wrong semantics
        self._q = collections.OrderedDict()   # tenant -> deque
        self._deficit = {}

    def __len__(self):
        return sum(len(d) for d in self._q.values())

    def push(self, tenant, item):
        if tenant not in self._q:
            # bounded by the gateway admission check
            self._q[tenant] = collections.deque()
            self._deficit[tenant] = 0.0
        self._q[tenant].append(item)

    def items(self):
        """Every queued item, tenant-grouped (expiry scans, flight
        recorder)."""
        out = []
        for d in self._q.values():
            out.extend(d)
        return out

    def remove(self, item):
        """Drop one queued item (deadline expiry); False if absent."""
        for t, d in self._q.items():
            try:
                d.remove(item)
            except ValueError:
                continue
            if not d:
                self._drop_tenant(t)
            return True
        return False

    def _drop_tenant(self, tenant):
        # an emptied tenant forfeits its deficit: no banking while idle
        del self._q[tenant]
        del self._deficit[tenant]

    def pop_next(self, weights, cost_fn, can_dispatch):
        """The next item to dispatch under WDRR, or None.

        ``weights``: tenant name → weight (missing = 1.0).
        ``cost_fn(item)``: token cost estimate.
        ``can_dispatch(item)``: False defers the tenant this call (quota
        exhausted, model backlogged) without burning its deficit.

        Each call performs at most two rotation sweeps: one where every
        visited tenant earns a quantum grant, and a bounded continuation
        so a lone tenant with an outsized head request accumulates
        enough deficit to make progress instead of starving."""
        if not self._q:
            return None
        # cost of the cheapest dispatchable head bounds how many grants
        # a full sweep must accumulate before SOMETHING pops
        sweeps = 0
        while sweeps < 2:
            sweeps += 1
            progressed = False
            for tenant in list(self._q.keys()):
                d = self._q.get(tenant)
                if not d:
                    continue
                head = d[0]
                if not can_dispatch(head):
                    continue
                w = float(weights.get(tenant, 1.0))
                self._deficit[tenant] += self.quantum * w
                cost = float(cost_fn(head))
                if self._deficit[tenant] < cost:
                    progressed = True      # earned deficit: retry sweep
                    continue
                self._deficit[tenant] -= cost
                d.popleft()
                # rotate the tenant to the back so the next pop starts
                # from its successor (round robin between pops)
                self._q.move_to_end(tenant)
                if not d:
                    self._drop_tenant(tenant)
                return head
            if not progressed:
                return None                # nothing dispatchable at all
        # dispatchable heads exist but none affordable in two sweeps:
        # grant the single neediest head outright (bounded unfairness
        # beats starvation — its tenant pays by going deeply negative)
        best, best_gap = None, None
        for tenant, d in self._q.items():
            if not d or not can_dispatch(d[0]):
                continue
            gap = float(cost_fn(d[0])) - self._deficit[tenant]
            if best_gap is None or gap < best_gap:
                best, best_gap = tenant, gap
        if best is None:
            return None
        d = self._q[best]
        head = d.popleft()
        self._deficit[best] -= float(cost_fn(head))
        self._q.move_to_end(best)
        if not d:
            self._drop_tenant(best)
        return head
