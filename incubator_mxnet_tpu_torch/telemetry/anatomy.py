"""Per-request latency anatomy + per-replica role residency for the
serving plane (port of `incubator_mxnet_tpu/telemetry/anatomy.py`, with
`on_migration` :456, `warmup_begin` :466 and `warmup_end` :480),
host-only code ported nearly verbatim.

The sum-to-wall discipline: every wall second attributed to exactly one
state, idle as the honest remainder, applied PER REQUEST on the serving
side. A gateway request's wall (submit → finish) is decomposed
into

    {queue_wait, preempted, prefill_wait, prefill_compute,
     handoff_migration, decode_compute, spec_overhead}

by a per-record state machine driven from the EXISTING serving seams —
the gateway's dispatch/preempt/finish paths, the scheduler's
prefill/decode/spec capacity seams (no new timers fire on a hot path
that did not already read a perf_counter), and the disagg migration
plane. Ambient phases (queue_wait, preempted, prefill_wait,
handoff_migration, decode_compute) partition the timeline; compute
charges (prefill_compute, spec_overhead) are carved out of the ambient
phase they occur in, so the states sum to the request's wall by
construction (clock-resolution residual only; the committed gate holds
it ≤ 2%).

ROLE RESIDENCY: every replica's wall is attributed to
{prefill, decode, migration, warmup, idle} from the same seam deltas —
exported as ``mx_replica_residency_seconds_total{replica=,role=,state=}``
plus ``mx_replica_residency_frac{replica=,state=}`` pull gauges. The
compute deltas are the SAME values `telemetry.capacity` banks once via
`split_device_seconds`, so the residency plane audits against
``capacity.measured_wall_s()`` (``report()["device_audit"]``). This is
the evidence the reference's role-aware autoscale advisor reads
(`serve.advisor`, not ported yet).

TAIL-SAMPLED ARCHIVE: completed anatomy records land in a bounded ring
that ALWAYS retains the interesting tail — SLO-violating, preempted,
migrated, and crash-resumed requests — and keeps a deterministic
``MXNET_ANATOMY_SAMPLE`` fraction of normal ones (``MXNET_ANATOMY_RING``
bounds each ring). Surfaced as a flight-recorder context block and as
text waterfalls (`format_waterfall`).

Off-path contract: disarmed, every seam pays a single None-check (the
per-request handle is None and the module flag is False). Arms with the
rest of the telemetry plane (``MXNET_TELEMETRY=1`` at import) or via
`enable()`.
"""
from __future__ import annotations

import collections
import os
import time

from . import registry, tracing
from .locks import tracked_lock

__all__ = ["enable", "disable", "is_enabled", "reset", "STATES",
           "RESIDENCY_STATES", "begin", "complete", "RequestAnatomy",
           "on_prefill_chunk", "on_decode_step", "on_migration",
           "warmup_begin", "warmup_end", "charge_replica",
           "residency_report", "archive", "report", "format_waterfall",
           "set_sample", "set_ring", "sample_rate"]

STATES = ("queue_wait", "preempted", "prefill_wait", "prefill_compute",
          "handoff_migration", "decode_compute", "spec_overhead")

# ambient phases partition the timeline; the other two are carved
_PHASES = ("queue_wait", "preempted", "prefill_wait",
           "handoff_migration", "decode_compute")

RESIDENCY_STATES = ("prefill", "decode", "migration", "warmup", "idle")

_ENABLED = False
_LOCK = tracked_lock("telemetry.anatomy", kind="lock")


def _env_float(name, default):
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name, default):
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


_SAMPLE = min(max(_env_float("MXNET_ANATOMY_SAMPLE", 0.05), 0.0), 1.0)
_RING = max(_env_int("MXNET_ANATOMY_RING", 256), 1)

# always-keep ring (SLO violators / preempted / migrated / crash-resumed)
_TAIL = collections.deque(maxlen=_RING)
# deterministically sampled normal completions
_SAMPLED = collections.deque(maxlen=_RING)
_NORMAL_SEEN = [0]
_COMPLETED = [0]
_STATE_TOTALS = {s: 0.0 for s in STATES}


def enable():
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def is_enabled():
    return _ENABLED


def set_sample(rate):
    """Override the normal-completion sampling rate (tests, demo)."""
    global _SAMPLE
    _SAMPLE = min(max(float(rate), 0.0), 1.0)


def sample_rate():
    return _SAMPLE


def set_ring(n):
    """Resize both archive rings (drops current contents)."""
    global _RING, _TAIL, _SAMPLED
    with _LOCK:
        _RING = max(int(n), 1)
        _TAIL = collections.deque(maxlen=_RING)
        _SAMPLED = collections.deque(maxlen=_RING)


def reset():
    """Drop every record and residency ledger (tests). The mx_* series
    live in the registry and reset with `registry.reset()`."""
    with _LOCK:
        _TAIL.clear()
        _SAMPLED.clear()
        _NORMAL_SEEN[0] = 0
        _COMPLETED[0] = 0
        for s in STATES:
            _STATE_TOTALS[s] = 0.0
        _REPLICAS.clear()


# ---------------------------------------------------------------------------
# per-request anatomy records
# ---------------------------------------------------------------------------

class RequestAnatomy:
    """One request's wall-time decomposition. Ambient phase transitions
    take a ``time.monotonic()`` timestamp from the calling seam; compute
    carves take perf_counter deltas measured by the same seam that feeds
    the capacity ledger. Never constructed while the plane is disarmed —
    the gateway holds ``None`` instead, so the off path is one
    None-check."""

    __slots__ = ("req_id", "tenant", "model", "tier", "submit_t",
                 "finish_t", "deadline", "states", "flags", "replica",
                 "tokens", "outcome", "resumes", "owner", "_t", "_phase",
                 "_carve")

    def __init__(self, req_id, tenant, model, tier, now, deadline=None):
        self.req_id = req_id
        # which plane completes this record: None = the gateway (its
        # GatewayRequest choke points), "engine" = a standalone
        # ServeEngine request (the engine Request's _finish/_fail) —
        # gateway segments carry gateway-owned records through the same
        # scheduler, so the engine seams must not double-complete them
        self.owner = None
        self.tenant = str(tenant) if tenant else "anon"
        self.model = str(model)
        self.tier = str(tier)
        self.submit_t = float(now)
        self.finish_t = None
        self.deadline = deadline          # absolute monotonic, or None
        self.states = {s: 0.0 for s in STATES}
        self.flags = set()
        self.replica = None
        self.tokens = 0
        self.outcome = None
        self.resumes = 0
        self._t = float(now)
        self._phase = "queue_wait"
        self._carve = 0.0

    # -- the state machine -------------------------------------------------

    def _transition(self, now, phase):
        """Close the current ambient phase at `now` (charging its wall
        minus any carved compute) and enter `phase` (None = final)."""
        dur = float(now) - self._t
        if dur < 0.0:
            dur = 0.0
        amb = dur - self._carve
        if amb < 0.0:
            amb = 0.0
        if self._phase is not None:
            self.states[self._phase] += amb
        self._t = float(now)
        self._carve = 0.0
        self._phase = phase

    def carve(self, state, seconds):
        """Charge `seconds` of compute to `state`, carved out of the
        ambient phase it occurred in (keeps the sum-to-wall invariant)."""
        seconds = float(seconds)
        if seconds <= 0.0:
            return
        self.states[state] += seconds
        self._carve += seconds

    # -- seam surface (gateway / scheduler / disagg / elastic) --------------

    def dispatched(self, now, replica=None):
        """First dispatch closes ``queue_wait``; a resumed dispatch
        closes ``preempted`` — the wall a request spends RE-queued after
        preemption / migration fallback / crash resume is attributed,
        never dropped."""
        self._transition(now, "prefill_wait")
        if replica is not None:
            self.replica = replica

    def requeued(self, now, flag):
        """Back into the gateway queue (``flag`` ∈ preempted /
        migration_fallback / crash_resume) — subsequent wall charges to
        the ``preempted`` state until re-dispatch."""
        self._transition(now, "preempted")
        self.flags.add(str(flag))
        self.resumes += 1

    def prefill_done(self, now, handoff=False):
        """The final prefill chunk sampled the first token: a disagg
        handoff segment parks in ``handoff_migration`` (waiting for the
        migration plane), everything else enters ``decode_compute``."""
        self._transition(
            now, "handoff_migration" if handoff else "decode_compute")

    def adopted(self, now, migrated=True):
        """The decode side owns the request (page migration done, or
        fallback co-location on the prefill replica)."""
        self._transition(now, "decode_compute")
        if migrated:
            self.flags.add("migrated")

    def close(self, now, outcome, tokens=0):
        self._transition(now, None)
        self.finish_t = float(now)
        self.outcome = str(outcome)
        self.tokens = int(tokens)
        if outcome != "ok" or (self.deadline is not None
                               and self.finish_t > self.deadline):
            self.flags.add("slo_violation")

    # -- reading -----------------------------------------------------------

    @property
    def wall_s(self):
        end = self.finish_t if self.finish_t is not None else self._t
        return max(end - self.submit_t, 0.0)

    @property
    def residual_s(self):
        """states sum minus wall — the invariant's error term."""
        return sum(self.states.values()) - self.wall_s

    def snapshot(self):
        return {"id": self.req_id, "tenant": self.tenant,
                "model": self.model, "tier": self.tier,
                "replica": self.replica, "submit_t": self.submit_t,
                "finish_t": self.finish_t, "wall_s": self.wall_s,
                "states": dict(self.states),
                "residual_s": self.residual_s,
                "outcome": self.outcome, "flags": sorted(self.flags),
                "tokens": self.tokens, "resumes": self.resumes}


def begin(req_id, tenant, model, tier, now, deadline=None):
    """Open a record at gateway submit. Returns None while disarmed —
    the caller stores it on the request and every later seam is a single
    ``is not None`` check."""
    if not _ENABLED:
        return None
    return RequestAnatomy(req_id, tenant, model, tier, now,
                          deadline=deadline)


# the always-keep retention predicate: anything that made the request's
# life interesting (tail-latency forensics must never lose these)
_KEEP_FLAGS = ("slo_violation", "preempted", "migration_fallback",
               "crash_resume", "migrated")


def complete(rec, now, outcome, tokens=0):
    """Close `rec` and archive it: interesting records always retained,
    normal ones deterministically sampled at `MXNET_ANATOMY_SAMPLE`."""
    if rec is None or not _ENABLED:
        return
    rec.close(now, outcome, tokens=tokens)
    snap = rec.snapshot()
    with _LOCK:
        _COMPLETED[0] += 1
        for s, v in rec.states.items():
            _STATE_TOTALS[s] += v
    for s, v in rec.states.items():
        if v > 0.0:
            registry.counter(
                "mx_request_anatomy_seconds_total",
                "request wall seconds attributed per anatomy state "
                "(sum-to-wall per request)",
                labels={"state": s}).inc(v)
    registry.counter(
        "mx_request_anatomy_requests_total",
        "completed gateway requests folded into the anatomy archive",
        labels={"outcome": rec.outcome}).inc()
    if any(f in rec.flags for f in _KEEP_FLAGS):
        with _LOCK:
            _TAIL.append(snap)
        return
    with _LOCK:
        n = _NORMAL_SEEN[0]
        _NORMAL_SEEN[0] = n + 1
        # deterministic rate sampling: keep when the accumulator
        # crosses an integer (rate 1.0 keeps all, 0.0 none)
        if int((n + 1) * _SAMPLE) > int(n * _SAMPLE):
            _SAMPLED.append(snap)


def archive():
    """Completed records (always-keep tail + sampled normals), oldest →
    newest by finish time."""
    with _LOCK:
        out = list(_TAIL) + list(_SAMPLED)
    return sorted(out, key=lambda r: (r["finish_t"] or 0.0, r["id"]))


# ---------------------------------------------------------------------------
# per-replica role residency
# ---------------------------------------------------------------------------

class _ReplicaLedger:
    __slots__ = ("label", "role", "start_t", "last_t", "states",
                 "idle_banked")

    def __init__(self, label, role, now):
        self.label = label
        self.role = role
        self.start_t = now
        self.last_t = now
        self.states = {s: 0.0 for s in RESIDENCY_STATES if s != "idle"}
        self.idle_banked = 0.0


_REPLICAS = {}
_PULL_REGISTERED = set()


def _replica_frac_probe(label, state):
    def probe():
        led = _REPLICAS.get(label)
        if led is None:
            return None
        wall = max(led.last_t - led.start_t, 0.0)
        if wall <= 0.0:
            return None
        active = sum(led.states.values())
        if state == "idle":
            return max(wall - active, 0.0) / wall
        return min(led.states[state] / wall, 1.0)
    return probe


def charge_replica(label, role, state, seconds, now=None):
    """Attribute `seconds` of replica wall to a residency state. `now`
    (monotonic) advances the replica's wall horizon; the seams pass the
    timestamp they already read, virtual-clock harnesses pass theirs."""
    if not _ENABLED:
        return
    seconds = float(seconds)
    if seconds < 0.0:
        seconds = 0.0
    if now is None:
        now = time.monotonic()
    with _LOCK:
        led = _REPLICAS.get(label)
        fresh = led is None
        if fresh:
            led = _REPLICAS[label] = _ReplicaLedger(str(label), str(role),
                                                    float(now) - seconds)
        led.states[state] = led.states.get(state, 0.0) + seconds
        if now > led.last_t:
            led.last_t = float(now)
    if fresh and label not in _PULL_REGISTERED:
        # once per label EVER (registry collectors survive both
        # registry.reset() and anatomy.reset(); the probe returns None
        # for a label with no live ledger, omitting the series)
        _PULL_REGISTERED.add(label)
        for s in RESIDENCY_STATES:
            registry.register_pull_gauge(
                "mx_replica_residency_frac",
                _replica_frac_probe(str(label), s),
                "fraction of a serving replica's wall in each residency "
                "state (idle = honest remainder)",
                labels={"replica": str(label), "state": s})
    registry.counter(
        "mx_replica_residency_seconds_total",
        "serving replica wall seconds attributed per residency state "
        "(prefill / decode / migration / warmup; idle banked at report)",
        labels={"replica": str(label), "role": str(role),
                "state": str(state)}).inc(seconds)


def _sched_replica(sched):
    info = getattr(sched, "anatomy_replica", None)
    if info is not None:
        return info
    return (str(getattr(sched, "capacity_model", None) or "engine"),
            "both")


def on_prefill_chunk(sched, req, t0, t1, now=None):
    """One prefill chunk ran on `sched` for `req` over the perf_counter
    window ``[t0, t1]`` — the same window the capacity ledger splits.
    Charges the replica's ``prefill`` residency and carves the request's
    ``prefill_compute`` out of its ambient phase."""
    if not _ENABLED:
        return
    dt = float(t1) - float(t0)
    label, role = _sched_replica(sched)
    charge_replica(label, role, "prefill", dt, now=now)
    rec = getattr(req, "anatomy", None)
    if rec is not None:
        rec.carve("prefill_compute", dt)


def on_decode_step(sched, t0, t1, now=None):
    """One batched decode (or spec draft+verify) program ran over
    ``[t0, t1]`` — charges the replica's ``decode`` residency and
    returns the delta (the spec seam shares it out as overhead)."""
    if not _ENABLED:
        return 0.0
    dt = float(t1) - float(t0)
    label, role = _sched_replica(sched)
    charge_replica(label, role, "decode", dt, now=now)
    return dt


def on_migration(sched, t0, t1, now=None):
    """A KV page migration window ``[t0, t1]`` on the adopting
    (decode-side) replica."""
    if not _ENABLED:
        return
    label, role = _sched_replica(sched)
    charge_replica(label, role, "migration", float(t1) - float(t0),
                   now=now)


def warmup_begin(sched):
    """Open a warmup window on `sched`'s replica. Returns an opaque
    token (None while disarmed); close with `warmup_end`. The window's
    charge is the wall MINUS whatever the decode/prefill seams already
    attributed inside it, so warm steps are never double-counted."""
    if not _ENABLED:
        return None
    label, _role = _sched_replica(sched)
    with _LOCK:
        led = _REPLICAS.get(label)
        seam_s = sum(led.states.values()) if led is not None else 0.0
    return (time.perf_counter(), seam_s)


def warmup_end(sched, token):
    if token is None or not _ENABLED:
        return
    t0, seam_before = token
    label, role = _sched_replica(sched)
    with _LOCK:
        led = _REPLICAS.get(label)
        seam_s = sum(led.states.values()) if led is not None else 0.0
    dt = (time.perf_counter() - t0) - (seam_s - seam_before)
    charge_replica(label, role, "warmup", max(dt, 0.0))


def residency_report(now=None):
    """{label: {"role", "wall_s", "states" (idle included),
    "frac"}} — idle is the honest remainder of each replica's observed
    wall, banked into the counter series as a side effect."""
    out = {}
    with _LOCK:
        items = [(label, led.role, led.start_t, led.last_t,
                  dict(led.states), led.idle_banked)
                 for label, led in _REPLICAS.items()]
    for label, role, start_t, last_t, states, idle_banked in items:
        horizon = last_t if now is None else max(float(now), last_t)
        wall = max(horizon - start_t, 0.0)
        active = sum(states.values())
        idle = max(wall - active, 0.0)
        grow = idle - idle_banked
        if grow > 0.0:
            registry.counter(
                "mx_replica_residency_seconds_total",
                "serving replica wall seconds attributed per residency "
                "state (prefill / decode / migration / warmup; idle "
                "banked at report)",
                labels={"replica": label, "role": role,
                        "state": "idle"}).inc(grow)
            with _LOCK:
                led = _REPLICAS.get(label)
                if led is not None:
                    led.idle_banked = idle
        full = dict(states)
        full["idle"] = idle
        frac = {s: (v / wall if wall > 0.0 else 0.0)
                for s, v in full.items()}
        out[label] = {"role": role, "wall_s": wall, "states": full,
                      "frac": frac}
    return out


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

def report(now=None):
    """The full anatomy ledger: aggregate state seconds, the archive,
    per-replica residency, and the device audit against the capacity
    ledger's measured wall (the residency prefill+decode charges are
    the SAME seam deltas `split_device_seconds` banks once)."""
    from . import capacity

    residency = residency_report(now=now)
    device_s = sum(r["states"].get("prefill", 0.0)
                   + r["states"].get("decode", 0.0)
                   for r in residency.values())
    with _LOCK:
        totals = dict(_STATE_TOTALS)
        completed = _COMPLETED[0]
        normal_seen = _NORMAL_SEEN[0]
        tail_n, sampled_n = len(_TAIL), len(_SAMPLED)
    return {
        "enabled": _ENABLED,
        "requests_completed": completed,
        "states": totals,
        "archive": archive(),
        "archive_depth": {"tail": tail_n, "sampled": sampled_n},
        "normal_seen": normal_seen,
        "sample_rate": _SAMPLE,
        "replicas": residency,
        "device_audit": {
            "residency_device_s": device_s,
            "capacity_wall_s": capacity.measured_wall_s(),
        },
    }


_BAR = "█"


def format_waterfall(rec, width=40):
    """One archived record (a `snapshot()` dict) as a text waterfall."""
    wall = rec.get("wall_s") or 0.0
    lines = [f"request {rec['id']} [{rec['model']}/{rec['tenant']}"
             f"/tier {rec['tier']}] wall {wall * 1e3:.1f} ms "
             f"outcome={rec['outcome']}"
             + (f" flags={','.join(rec['flags'])}" if rec["flags"]
                else "")]
    for s in STATES:
        v = rec["states"].get(s, 0.0)
        if v <= 0.0:
            continue
        frac = v / wall if wall > 0.0 else 0.0
        bar = _BAR * max(int(round(frac * width)), 1)
        lines.append(f"  {s:<18} {v * 1e3:9.2f} ms {frac:6.1%} {bar}")
    return "\n".join(lines)


def _flight_probe():
    with _LOCK:
        tail = list(_TAIL)[-8:]
        return {"requests_completed": _COMPLETED[0],
                "archive_tail": tail,
                "state_totals": dict(_STATE_TOTALS)}


registry.register_pull_gauge(
    "mx_request_archive_depth",
    lambda: float(len(_TAIL) + len(_SAMPLED)),
    "completed anatomy records currently retained (always-keep tail "
    "ring + sampled-normal ring)")

tracing.register_flight_context("anatomy", _flight_probe)

# arm with the rest of the telemetry plane (the serving seams check the
# flag once per already-timed window — disarmed, one None-check)
if os.environ.get("MXNET_TELEMETRY", "0") not in ("0", ""):
    _ENABLED = True
