"""Training goodput ledger: every wall second attributed to one state
(port of `incubator_mxnet_tpu/telemetry/goodput.py`, host code kept
nearly verbatim).

Per the goodput methodology of large-fleet training systems
(MegaScale-style production observability; Pathways-style
multi-controller accounting), the metric that matters at pod scale is
the fraction of wall-clock seconds spent in productive compute —
attributed *by cause* when it isn't. This module is that ledger: a stack of `lease(state)`
context managers rides the seams the stack already has (estimator step
spans, dataloader batch waits, the checkpoint write/resume seams, the
`ElasticController` transition phases) and attributes every interval of
wall time to exactly one of:

``compute``     inside the estimator's fit_batch/trainer.step body
``data_wait``   blocked on the dataloader for the next batch
``checkpoint``  writing a checkpoint (periodic, drain, or departure)
``reshard``     rebuilding trainer/sampler onto a new topology
``drain``       waiting at the rendezvous for the fleet to quiesce
``recovery``    resuming state after a crash or a topology change
``idle``        none of the above (the honest remainder)

Leases nest innermost-wins: the `checkpoint` lease inside an elastic
transition takes its own interval and hands the surrounding time back to
the transition's `reshard`/`drain` lease. Because ``idle`` is itself a
state, the states always sum to measured wall time — `report()` exposes
``accounted_frac`` (non-idle fraction) so "the ledger accounts for X% of
the run" is a real claim, not an artifact of the bookkeeping.

Off by default (`_ENABLED` dead branch — `lease()` returns a shared null
context manager). Armed by `MXNET_TELEMETRY=1` with the rest of the
telemetry plane. Exported as ``mx_goodput_seconds_total{state=}``
counters + a ``mx_goodput_frac`` pull gauge, so `fleet.fleet_report()`
aggregates the per-rank ledgers for free; a dedicated goodput section in
that report names the rank with the worst data_wait. A flight-context
block carries the last snapshot into every flight record (elastic
transitions dump one).

In the port the ledger stands alone: its producers in the reference (the
estimator, the dataloader, `preemption.py`, `fault/elastic.py`) are not
ported yet, and each charges it when it is (`ROADMAP.md` §1 items 6, 10
and 11). `parallel.DataParallel` does not charge it, as the reference's
does not.
"""
from __future__ import annotations

import threading
import time

from .locks import tracked_lock

from . import registry, tracing

__all__ = ["STATES", "lease", "report", "goodput_frac", "format_waterfall",
           "enable", "disable", "is_enabled", "reset"]

# exactly-one-of states; idle is the honest remainder, not a leak bucket
STATES = ("compute", "data_wait", "checkpoint", "reshard", "drain",
          "recovery", "idle")

_ENABLED = False
_LOCK = tracked_lock("telemetry.goodput", kind="lock")
_SECONDS: dict = {}          # state -> attributed seconds
_STACK: list = []            # active lease states, innermost last
_T_BEGIN = None              # perf_counter at first lease (ledger epoch)
_MARK = None                 # perf_counter of the last attribution boundary
_COUNTERS: dict = {}         # state -> registry Counter (cached)


def _counter(state):
    c = _COUNTERS.get(state)
    if c is None:
        c = registry.counter(
            "mx_goodput_seconds_total",
            "wall seconds attributed to a goodput state",
            labels={"state": state})
        _COUNTERS[state] = c
    return c


def _attribute(now):
    """Close the open interval [_MARK, now) into the current top state
    (idle when no lease is active). Caller holds _LOCK."""
    global _MARK
    if _MARK is None:
        _MARK = now
        return
    dt = now - _MARK
    _MARK = now
    if dt <= 0.0:
        return
    state = _STACK[-1] if _STACK else "idle"
    _SECONDS[state] = _SECONDS.get(state, 0.0) + dt
    _counter(state).inc(dt)


class _NullLease:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_LEASE = _NullLease()


class _Lease:
    __slots__ = ("state",)

    def __init__(self, state):
        self.state = state

    def __enter__(self):
        global _T_BEGIN, _MARK
        now = time.perf_counter()
        with _LOCK:
            if _T_BEGIN is None:
                _T_BEGIN = now       # ledger epoch: first lease arms it
                _MARK = now
            _attribute(now)
            _STACK.append(self.state)
        return self

    def __exit__(self, *exc):
        now = time.perf_counter()
        with _LOCK:
            _attribute(now)
            if _STACK and _STACK[-1] == self.state:
                _STACK.pop()
            elif self.state in _STACK:   # tolerate out-of-order exits
                _STACK.remove(self.state)
        return False


def lease(state):
    """Context manager attributing the enclosed wall time to ``state``
    (one of `STATES`). Nesting wins innermost: a ``checkpoint`` lease
    inside a ``reshard`` transition takes its own interval and hands the
    surrounding time back to reshard. Returns a shared null context when
    the ledger is off — the instrumented seams stay dead branches."""
    if not _ENABLED:
        return _NULL_LEASE
    if state not in STATES:
        raise ValueError(f"unknown goodput state {state!r}; "
                         f"one of {STATES}")
    return _Lease(state)


def report():
    """Snapshot: per-state seconds, wall seconds since the first lease,
    non-idle ``accounted_s``/``accounted_frac``, and ``goodput_frac``
    (compute / wall). Reading the report closes the open interval, so
    the states sum to wall time exactly at every snapshot."""
    now = time.perf_counter()
    with _LOCK:
        if _T_BEGIN is not None:
            _attribute(now)
        secs = {s: _SECONDS.get(s, 0.0) for s in STATES}
        wall = (now - _T_BEGIN) if _T_BEGIN is not None else 0.0
        active = _STACK[-1] if _STACK else None
    accounted = sum(v for s, v in secs.items() if s != "idle")
    return {"enabled": _ENABLED, "wall_s": wall, "states": secs,
            "accounted_s": accounted,
            "accounted_frac": (accounted / wall) if wall > 0 else 0.0,
            "goodput_frac": (secs["compute"] / wall) if wall > 0 else 0.0,
            "active_lease": active}


def goodput_frac():
    """compute seconds / wall seconds, or None before the first lease
    (the `mx_goodput_frac` pull-gauge probe)."""
    with _LOCK:
        if _T_BEGIN is None:
            return None
        _attribute(time.perf_counter())
        wall = _MARK - _T_BEGIN
        compute = _SECONDS.get("compute", 0.0)
    return (compute / wall) if wall > 0 else 0.0


def format_waterfall(rep=None, width=40):
    """Text waterfall of a `report()` snapshot — one bar per state,
    widths proportional to wall share (kernelscope's rendering)."""
    rep = rep or report()
    wall = rep["wall_s"]
    lines = [f"goodput waterfall — wall {wall:.3f}s, "
             f"goodput {rep['goodput_frac'] * 100:.1f}%, "
             f"accounted {rep['accounted_frac'] * 100:.1f}%"]
    for state in STATES:
        s = rep["states"].get(state, 0.0)
        frac = (s / wall) if wall > 0 else 0.0
        bar = "#" * max(0, round(frac * width))
        lines.append(f"  {state:<10} {s:>9.3f}s {frac * 100:>6.1f}% {bar}")
    return "\n".join(lines)


def _flight_probe():
    with _LOCK:
        if _T_BEGIN is None:
            return None
    return report()


def enable():
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def is_enabled():
    return _ENABLED


def reset():
    """Forget all attribution and the ledger epoch (tests). Open leases
    held across a reset are dropped; their exits are tolerated."""
    global _T_BEGIN, _MARK
    with _LOCK:
        _SECONDS.clear()
        del _STACK[:]
        _T_BEGIN = None
        _MARK = None


registry.register_pull_gauge(
    "mx_goodput_frac", goodput_frac,
    "fraction of wall seconds attributed to productive compute")
tracing.register_flight_context("goodput", _flight_probe)
