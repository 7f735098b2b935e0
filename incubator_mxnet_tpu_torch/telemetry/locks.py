"""Instrumented-lock registry, the racecheck runtime tier (port of
`incubator_mxnet_tpu/telemetry/locks.py`: `tracked_lock` :323,
`TrackedLock` :194, `TrackedCondition` :266, the order graph and the
contention table), host-only code ported nearly verbatim.

The reference's static tier (`analysis/racecheck.py`, not ported yet)
proves properties about lock use it can see in the source; this module
witnesses the orders that actually happen. `tracked_lock(name)` hands out locks that record, per
thread, the stack of locks currently held — every acquisition of B while
holding A adds the edge A→B to a process-wide lock-order graph, and a
cycle in that graph is a **witnessed order inversion** (rule RC005):
two threads that have each taken the same pair of locks in opposite
orders are one unlucky preemption away from deadlock, even if this run
never hung (the classic witness/Goodlock observation — the *order* is
the defect, not the hang).

Contention telemetry rides the same hooks:

- ``mx_lock_wait_seconds{lock=}``  — time blocked in acquire
- ``mx_lock_held_seconds{lock=}``  — critical-section length
- ``mx_lock_order_inversions_total{pair=}`` — RC005 witnesses
- a one-shot warning when a lock is held longer than
  ``MXNET_RACECHECK_HOLD_S`` (default 1.0s)

Off-path contract (the usual telemetry dead-branch discipline, pushed
one step further): a Python-level per-acquire enabled check would cost
more than the raw ``lock.acquire()`` it guards, so the dead branch lives
in the **factory** — with telemetry off, ``tracked_lock(name)`` returns
the raw ``threading`` primitive itself (the name is still reserved in
the registry). Off-path overhead is therefore zero by construction.
Locks created while disarmed stay raw — arm via ``MXNET_TELEMETRY=1``
(read at import, like the rest of the telemetry plane) or call
`enable()` before constructing the engines you want witnessed.

This module is the one place in telemetry/ that constructs raw
``threading`` locks: the tracked locks' own registry cannot be built out
of tracked locks.
"""
from __future__ import annotations

import logging
import os
import threading
import time
import traceback

__all__ = ["tracked_lock", "enable", "disable", "is_enabled",
           "order_graph", "inversions", "contention_table",
           "known_locks", "reset", "TrackedLock", "TrackedCondition"]

log = logging.getLogger("incubator_mxnet_tpu_torch.telemetry.locks")

_ENABLED = False

# -- global witness state (guarded by _G, itself a raw lock) ---------------
_G = threading.Lock()
_NAMES: dict = {}          # name -> count handed out (for #2 suffixing)
_EDGES: dict = {}          # (a, b) -> {"stack": [...], "thread": str,
                           #            "line": "file:ln in fn", "count": n}
_INVERSIONS: list = []     # RC005 records (dicts; see _check_cycle)
_SEEN_CYCLES: set = set()  # frozenset(edge names) dedup
_WARNED_HOLDS: set = set()

# per-thread stack of currently-held tracked locks (acquisition order)
_TLS = threading.local()

# lazily-created metric handles (None until first enabled acquisition —
# keeps import light and avoids registry work when disarmed)
_METRICS = None


def _hold_warn_s():
    try:
        return float(os.environ.get("MXNET_RACECHECK_HOLD_S", "1.0"))
    except ValueError:
        return 1.0


def _held():
    h = getattr(_TLS, "held", None)
    if h is None:
        h = []
        _TLS.held = h
    return h


def _metrics_for(name):
    global _METRICS
    if _METRICS is None:
        _METRICS = {}
    h = _METRICS.get(name)
    if h is None:
        from . import registry

        # sub-ms-biased buckets: lock waits live in the µs..ms range
        buckets = (1e-6, 1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2,
                   0.1, 0.5, 1.0, 5.0)
        h = (registry.histogram("mx_lock_wait_seconds",
                                "time blocked acquiring a tracked lock",
                                labels={"lock": name}, buckets=buckets),
             registry.histogram("mx_lock_held_seconds",
                                "tracked-lock critical-section length",
                                labels={"lock": name}, buckets=buckets))
        _METRICS[name] = h
    return h


def _site():
    """One-line acquisition site (skip this module's own frames)."""
    for f in reversed(traceback.extract_stack(limit=12)):
        if not f.filename.endswith("locks.py"):
            return f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}"
    return "?"


def _stack_summary():
    return [f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}"
            for f in traceback.extract_stack(limit=12)
            if not f.filename.endswith("locks.py")][-6:]


def _find_path(src, dst):
    """Edge-name path src→…→dst over _EDGES (caller holds _G)."""
    stack = [(src, (src,))]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for (a, b) in _EDGES:
            if a != node or b in seen:
                continue
            if b == dst:
                return path + (b,)
            seen.add(b)
            stack.append((b, path + (b,)))
    return None


def _note_edges(new_lock):
    """Record held→new edges; a path new→…→held closes a cycle = RC005."""
    held = _held()
    if not held:
        return
    nb = new_lock._tl_name
    tname = threading.current_thread().name
    for h in held:
        na = h._tl_name
        if na == nb:
            continue
        with _G:
            rec = _EDGES.get((na, nb))
            if rec is not None:
                rec["count"] += 1
                continue
            # new edge: remember its first witness, then look for the
            # reverse path that makes (na, nb) an inversion
            _EDGES[(na, nb)] = {"stack": _stack_summary(),
                                "thread": tname, "line": _site(),
                                "count": 1}
            back = _find_path(nb, na)
            if back is None:
                continue
            cycle = frozenset(zip(back, back[1:])) | {(na, nb)}
            if cycle in _SEEN_CYCLES:
                continue
            _SEEN_CYCLES.add(cycle)
            fwd = _EDGES[(na, nb)]
            rev = _EDGES.get((back[0], back[1]))
            inv = {
                "rule": "RC005",
                "pair": f"{na}<->{nb}",
                "cycle": list(back) + [nb],
                "witness_fwd": {"order": f"{na} -> {nb}",
                                "thread": fwd["thread"],
                                "line": fwd["line"],
                                "stack": fwd["stack"]},
                "witness_rev": {"order": " -> ".join(back),
                                "thread": rev["thread"] if rev else "?",
                                "line": rev["line"] if rev else "?",
                                "stack": rev["stack"] if rev else []},
            }
            _INVERSIONS.append(inv)
        # warn + count outside _G (registry takes its own lock)
        log.warning(
            "RC005 lock-order inversion witnessed: %s taken after %s "
            "(%s, thread %s) but the reverse order %s was seen earlier "
            "(%s) — deadlock possible under preemption",
            nb, na, inv["witness_fwd"]["line"], tname,
            inv["witness_rev"]["order"], inv["witness_rev"]["line"])
        from . import registry

        registry.counter("mx_lock_order_inversions_total",
                         "witnessed lock-order inversions (RC005)",
                         labels={"pair": inv["pair"]}).inc()


class TrackedLock:
    """Instrumented Lock/RLock: order witness + contention telemetry.

    Only handed out while the registry is enabled; the disarmed factory
    returns raw primitives instead (see module docstring).
    """

    _tl_kind = "lock"

    def __init__(self, name, reentrant=False):
        self._tl_name = name
        self._tl_reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._t_acquired = 0.0

    # -- core protocol ----------------------------------------------------
    def acquire(self, blocking=True, timeout=-1):
        held = _held()
        reentry = self._tl_reentrant and self in held
        t0 = time.perf_counter()
        got = self._inner.acquire(blocking, timeout)
        if not got:
            return False
        waited = time.perf_counter() - t0
        if not reentry:
            _note_edges(self)
            self._t_acquired = time.perf_counter()
            wait_h, _ = _metrics_for(self._tl_name)
            wait_h.observe(waited)
        held.append(self)
        return True

    def release(self):
        held = _held()
        try:
            # pop the most recent occurrence (reentrant releases unwind)
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break
            if self not in held:             # outermost release
                dt = time.perf_counter() - self._t_acquired
                _, held_h = _metrics_for(self._tl_name)
                held_h.observe(dt)
                warn_s = _hold_warn_s()
                if dt > warn_s and self._tl_name not in _WARNED_HOLDS:
                    _WARNED_HOLDS.add(self._tl_name)
                    log.warning(
                        "tracked lock %r held %.3fs (> %.1fs) at %s — "
                        "long critical section blocks every peer thread",
                        self._tl_name, dt, warn_s, _site())
        finally:
            self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        if self._tl_reentrant:
            raise AttributeError("RLock has no locked()")
        return self._inner.locked()

    def __repr__(self):
        kind = "rlock" if self._tl_reentrant else "lock"
        return f"<TrackedLock {self._tl_name!r} ({kind})>"


class TrackedCondition:
    """Instrumented Condition over a TrackedLock. ``wait()`` releases the
    lock, so the held stack drops it for the duration and the reacquire
    re-witnesses order edges."""

    _tl_kind = "condition"

    def __init__(self, name):
        self._tl_lock = TrackedLock(name, reentrant=True)
        self._inner = threading.Condition(self._tl_lock._inner)

    @property
    def _tl_name(self):
        return self._tl_lock._tl_name

    def acquire(self, *a, **kw):
        return self._tl_lock.acquire(*a, **kw)

    def release(self):
        self._tl_lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout=None):
        held = _held()
        if self._tl_lock in held:
            held.remove(self._tl_lock)
        try:
            return self._inner.wait(timeout)
        finally:
            _note_edges(self._tl_lock)
            held.append(self._tl_lock)

    def wait_for(self, predicate, timeout=None):
        end = None if timeout is None else time.monotonic() + timeout
        result = predicate()
        while not result:
            remaining = None if end is None else end - time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            self.wait(remaining)
            result = predicate()
        return result

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()


def tracked_lock(name, kind="rlock"):
    """Return a named lock for cross-thread control-plane state.

    ``kind``: ``"lock"`` | ``"rlock"`` | ``"condition"``. While the
    registry is disarmed this returns the raw ``threading`` primitive
    (zero off-path cost — the dead branch is the factory itself); armed,
    it returns the instrumented wrapper feeding the order witness and
    the ``mx_lock_*`` contention series.
    """
    with _G:
        n = _NAMES.get(name, 0)
        _NAMES[name] = n + 1
    if n:
        name = f"{name}#{n + 1}"
    if not _ENABLED:
        if kind == "lock":
            return threading.Lock()
        if kind == "rlock":
            return threading.RLock()
        if kind == "condition":
            return threading.Condition()
        raise ValueError(f"tracked_lock kind {kind!r} "
                         "(expected lock|rlock|condition)")
    if kind == "lock":
        return TrackedLock(name)
    if kind == "rlock":
        return TrackedLock(name, reentrant=True)
    if kind == "condition":
        return TrackedCondition(name)
    raise ValueError(f"tracked_lock kind {kind!r} "
                     "(expected lock|rlock|condition)")


# -- lifecycle --------------------------------------------------------------

def enable():
    """Arm the witness: locks created *from now on* are instrumented."""
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def is_enabled():
    return _ENABLED


def reset():
    """Drop all witnessed state (tests). Existing locks keep recording."""
    with _G:
        _EDGES.clear()
        _INVERSIONS.clear()
        _SEEN_CYCLES.clear()
        _WARNED_HOLDS.clear()
        _NAMES.clear()


# -- reading ----------------------------------------------------------------

def order_graph():
    """{(a, b): first-witness record} — the runtime lock-order edges."""
    with _G:
        return {k: dict(v) for k, v in _EDGES.items()}


def inversions():
    """List of RC005 witness records (see `_note_edges`)."""
    with _G:
        return [dict(i) for i in _INVERSIONS]


def known_locks():
    with _G:
        return sorted(_NAMES)


def contention_table():
    """Per-lock contention rows from the ``mx_lock_*`` histograms:
    {lock: {acquisitions, wait_sum_s, wait_max_s, held_sum_s,
    held_max_s}}."""
    if not _METRICS:
        return {}
    rows = {}
    for name, (wait_h, held_h) in sorted(_METRICS.items()):
        w, h = wait_h.snapshot(), held_h.snapshot()
        rows[name] = {
            "acquisitions": w["count"],
            "wait_sum_s": w["sum"], "wait_max_s": w["max"] or 0.0,
            "held_sum_s": h["sum"], "held_max_s": h["max"] or 0.0,
        }
    return rows


# self-arm with the rest of the telemetry plane: this module is imported
# (via the telemetry package) before any engine constructs its locks, so
# reading the knob here means MXNET_TELEMETRY=1 witnesses everything
if os.environ.get("MXNET_TELEMETRY", "0") not in ("0", ""):
    _ENABLED = True
