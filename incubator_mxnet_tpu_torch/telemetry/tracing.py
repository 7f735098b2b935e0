"""Request/step-level span tracing + the crash flight recorder (port of
`incubator_mxnet_tpu/telemetry/tracing.py`: `Span` :124, `span` :223,
`open_span` :238, `chrome_trace` :428, `register_flight_context` :466,
`flight_dump` :488, `maybe_flight_dump` :532), host-only code ported
nearly verbatim.

The registry answers *aggregate* questions — counters, histograms,
stage totals. This module answers the question the serving engine made
acute: "where did THIS request (or THIS step) spend its time?" It is a
Dapper-style tracer (Sigelman et al., 2010): every unit of work is a
**span** with a trace id shared by everything belonging to the same
request/step, a span id, and a parent id — so one slow TTFT p99 sample in
the serving trace decomposes into its queue wait, prefill, and per-step
decode segments instead of being one opaque number.

Design contract:

- **off** (`MXNET_TELEMETRY` unset, the default): every probe —
  ``span()``, ``open_span()``, ``event()``, ``annotate()`` — is one
  module-global ``_ENABLED`` check returning a shared no-op singleton.
  No allocation, no clock read, no lock.
- **on** (`enable()` or any truthy ``MXNET_TELEMETRY``): spans record
  ``perf_counter_ns`` durations and an epoch-µs start timestamp — the
  clock base the reference's profiler rebases its device trace onto, so
  host spans and device slices merge into one Chrome-trace/Perfetto
  timeline (`chrome_events()`).
- **host-side only**: spans are never opened inside a function a CUDA
  graph captures — the serving engine's one-capture-a-step guarantee is
  untouched.

Three ways to open a span:

- ``with tracing.span("serve.prefill", request=rid):`` — the blessed
  context-manager form (ambient: nested spans parent automatically via a
  thread-local stack);
- ``Tracer.start_span(...)`` — same semantics on an explicit tracer;
  MUST be used with ``with``;
- ``open_span(...)`` / ``Span.close()`` — explicit lifecycle for spans
  that cross function/thread boundaries (a serve request's root span is
  opened at submit on the client thread and closed at retire on the
  driver thread). Not ambient: an open_span never enters the TLS stack.

Finished spans land in per-thread ring buffers (bounded; merged on
read), so steady-state tracing is allocation-bounded and lock-free on
the hot path — exactly the registry's shard trick applied to spans.

Flight recorder: `flight_dump(reason)` snapshots the rings (recent
finished spans + still-open spans + orphan events + the armed chaos
schedule) into ``flightrec_<reason>_<pid>.json`` (under
``MXNET_FLIGHTREC_DIR``, else the working directory) so a crash
postmortem carries the last N spans of context. The serving engine's and
the gateway's ``step`` and the installed `sys.excepthook` call
`maybe_flight_dump` — a no-op while tracing is off.

Device lanes: `chrome_trace(include_device=True)` merges the device
events the profiler captured on the last ``profiler.stop()``
(`device_events`: the card's kernels, copies and sets from
torch.profiler, rebased onto this module's epoch-µs clock), a list that
is empty before any device trace completes and on a machine with no
CUDA device.
"""
from __future__ import annotations

import json
import os
import random
import sys
import threading
import time

from collections import deque

from .locks import tracked_lock

__all__ = ["Span", "Tracer", "enable", "disable", "is_enabled", "span",
           "open_span", "event", "annotate", "current_span",
           "current_trace_id", "new_trace_id", "finished_spans",
           "open_spans", "reset", "chrome_events", "chrome_trace",
           "dump_chrome", "flight_dump", "maybe_flight_dump",
           "register_flight_context", "device_events", "RING_CAPACITY"]

RING_CAPACITY = 4096          # finished spans kept per writer thread
_FLIGHT_SPANS = 256           # most-recent spans a flight dump carries

_ENABLED = False
_LOCK = tracked_lock("telemetry.tracing", kind="lock")
_RINGS: list = []             # one deque per writer thread (merged reads)
_OPEN: dict = {}              # span_id -> still-open Span (flight recorder)
_ORPHAN_EVENTS: deque = deque(maxlen=512)   # events with no current span
_TLS = threading.local()
_IDS = random.Random()        # span/trace id entropy (host-side only)
_PREV_EXCEPTHOOK = None


def new_trace_id():
    """Fresh 64-bit correlation id (hex). One per request/step trace."""
    return f"{_IDS.getrandbits(64):016x}"


def _new_span_id():
    return f"{_IDS.getrandbits(32):08x}"


class _NullSpan:
    """Shared no-op span: what every probe returns while tracing is off
    (and what nested calls receive so call sites never branch)."""

    __slots__ = ()
    trace_id = None
    span_id = None
    name = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        return self

    def event(self, name, **attrs):  # noqa: ARG002
        return self

    def close(self, error=None):  # noqa: ARG002
        return self

    def __bool__(self):
        return False


_NULL_SPAN = _NullSpan()


class Span:
    """One timed unit of work. Created via `span()` (ambient context
    manager) or `open_span()` (explicit lifecycle); never construct
    directly."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs",
                 "events", "t0_us", "t0_ns", "dur_ns", "thread", "lane",
                 "_ambient")

    def __init__(self, name, trace_id, parent_id, attrs, lane, ambient):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self.events: list = []
        self.t0_us = time.time() * 1e6       # epoch µs: profiler clock base
        self.t0_ns = time.perf_counter_ns()  # monotonic: duration source
        self.dur_ns = None
        self.thread = threading.current_thread().name
        self.lane = lane
        self._ambient = ambient
        with _LOCK:
            _OPEN[self.span_id] = self

    # -- context-manager (ambient) form -------------------------------------

    def __enter__(self):
        if self._ambient:
            stack = getattr(_TLS, "stack", None)
            if stack is None:
                stack = _TLS.stack = []
            stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):  # noqa: ARG002
        if self._ambient:
            stack = getattr(_TLS, "stack", None)
            if stack and stack[-1] is self:
                stack.pop()
        self.close(error=exc)
        return False

    # -- shared surface ------------------------------------------------------

    @property
    def duration_s(self):
        """Span duration in seconds (None while still open)."""
        return None if self.dur_ns is None else self.dur_ns / 1e9

    def annotate(self, **attrs):
        self.attrs.update(attrs)
        return self

    def event(self, name, **attrs):
        """Point-in-time marker inside this span (Chrome 'instant')."""
        self.events.append((name, time.time() * 1e6, attrs))
        return self

    def close(self, error=None):
        """Stamp the duration and move the span to the finished ring.
        Idempotent (a double close keeps the first duration)."""
        if self.dur_ns is not None:
            return self
        self.dur_ns = time.perf_counter_ns() - self.t0_ns
        if error is not None:
            self.attrs.setdefault("error", type(error).__name__)
            self.attrs.setdefault("error_msg", str(error)[:200])
        with _LOCK:
            _OPEN.pop(self.span_id, None)
        ring = getattr(_TLS, "ring", None)
        if ring is None:
            ring = _TLS.ring = deque(maxlen=RING_CAPACITY)
            with _LOCK:
                _RINGS.append(ring)
        ring.append(self)
        return self

    def to_dict(self):
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "ts_us": self.t0_us,
                "dur_us": None if self.dur_ns is None else self.dur_ns / 1e3,
                "thread": self.thread, "lane": self.lane,
                "attrs": dict(self.attrs),
                "events": [{"name": n, "ts_us": t, "attrs": a}
                           for n, t, a in self.events]}

    def __repr__(self):
        state = "open" if self.dur_ns is None \
            else f"{self.dur_ns / 1e3:.1f}us"
        return (f"<Span {self.name} trace={self.trace_id} "
                f"id={self.span_id} {state}>")


# ---------------------------------------------------------------------------
# probes (module surface — every call a dead branch while off)
# ---------------------------------------------------------------------------

def span(name, parent=None, trace_id=None, lane=None, **attrs):
    """Open an ambient span as a context manager::

        with tracing.span("estimator.step", step=i):
            ...

    Nested calls parent automatically (thread-local stack). `parent`
    (a Span) or `trace_id` override the ambient parent — that is how
    work done on another thread joins a request's trace. Returns the
    shared no-op span while tracing is off."""
    if not _ENABLED:
        return _NULL_SPAN
    return _make_span(name, parent, trace_id, lane, attrs, ambient=True)


def open_span(name, parent=None, trace_id=None, lane=None, **attrs):
    """Open a span with EXPLICIT lifecycle — the caller must `close()`
    it. Never enters the ambient stack (safe to close from another
    thread). Use for spans that outlive a lexical scope, e.g. a serve
    request's root span (submit → retire)."""
    if not _ENABLED:
        return _NULL_SPAN
    return _make_span(name, parent, trace_id, lane, attrs, ambient=False)


def _make_span(name, parent, trace_id, lane, attrs, ambient):
    if parent is None and trace_id is None:
        stack = getattr(_TLS, "stack", None)
        if stack:
            parent = stack[-1]
    if parent is not None and parent.trace_id is not None:
        trace_id = parent.trace_id
        parent_id = parent.span_id
        if lane is None:
            lane = parent.lane
    else:
        parent_id = None
        if trace_id is None:
            trace_id = new_trace_id()
    return Span(name, trace_id, parent_id, attrs, lane, ambient)


def event(name, **attrs):
    """Record a point-in-time event on the CURRENT ambient span (or the
    orphan ring when no span is open — flight dumps still carry it)."""
    if not _ENABLED:
        return
    stack = getattr(_TLS, "stack", None)
    if stack:
        stack[-1].event(name, **attrs)
    else:
        _ORPHAN_EVENTS.append((name, time.time() * 1e6, attrs))


def annotate(**attrs):
    """Attach attributes to the current ambient span (no-op without
    one — annotations never raise from instrumentation sites)."""
    if not _ENABLED:
        return
    stack = getattr(_TLS, "stack", None)
    if stack:
        stack[-1].annotate(**attrs)


def current_span():
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


def current_trace_id():
    s = current_span()
    return s.trace_id if s is not None else None


class Tracer:
    """Object façade over the module tracer (reference-style handle for
    code that wants an injectable tracer). `start_span` is the
    context-manager API: use it with `with`."""

    def start_span(self, name, parent=None, trace_id=None, lane=None,
                   **attrs):
        return span(name, parent=parent, trace_id=trace_id, lane=lane,
                    **attrs)

    def open_span(self, name, parent=None, trace_id=None, lane=None,
                  **attrs):
        return open_span(name, parent=parent, trace_id=trace_id,
                         lane=lane, **attrs)

    @property
    def enabled(self):
        return _ENABLED


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def enable():
    """Arm span recording (idempotent) and install the crash excepthook
    so an unhandled exception leaves a flight-recorder dump behind."""
    global _ENABLED, _PREV_EXCEPTHOOK
    with _LOCK:
        already = _ENABLED
        _ENABLED = True
    if not already and _PREV_EXCEPTHOOK is None:
        _PREV_EXCEPTHOOK = sys.excepthook
        sys.excepthook = _crash_excepthook


def disable():
    """Disarm: every probe goes back to one `_ENABLED` check. Recorded
    spans stay readable until `reset()`."""
    global _ENABLED, _PREV_EXCEPTHOOK
    with _LOCK:
        _ENABLED = False
    if _PREV_EXCEPTHOOK is not None:
        sys.excepthook = _PREV_EXCEPTHOOK
        _PREV_EXCEPTHOOK = None


def is_enabled():
    return _ENABLED


def reset():
    """Drop every recorded span/event (tests)."""
    with _LOCK:
        rings = list(_RINGS)
        _OPEN.clear()
    for r in rings:
        r.clear()
    _ORPHAN_EVENTS.clear()


def finished_spans(trace_id=None):
    """Merged finished spans across all threads, start-ordered; filter
    by `trace_id` to reconstruct one request/step."""
    with _LOCK:
        rings = list(_RINGS)
    out = []
    for r in rings:
        out.extend(list(r))
    if trace_id is not None:
        out = [s for s in out if s.trace_id == trace_id]
    out.sort(key=lambda s: s.t0_us)
    return out


def open_spans():
    """Spans still open right now (crash context: the work that was
    in flight)."""
    with _LOCK:
        return list(_OPEN.values())


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export (the device lanes' clock base)
# ---------------------------------------------------------------------------

_SPAN_PID = 2                 # host op dispatch owns pid 0, device 1000+


def chrome_events(spans=None):
    """Chrome-trace events for `spans` (default: every finished span).

    Lanes: spans carrying a ``lane`` (e.g. serve requests get
    ``"req <id>"``) each get their own tid with a thread_name metadata
    row — one horizontal lane per request in Perfetto; unlaned spans
    share a lane per OS thread. Timestamps are epoch-µs (``time.time``),
    the base device events are rebased onto, so the two sources line up
    in one timeline."""
    if spans is None:
        spans = finished_spans()
    lanes: dict = {}

    def lane_tid(s):
        key = s.lane if s.lane is not None else f"thread {s.thread}"
        if key not in lanes:
            lanes[key] = len(lanes) + 1
        return lanes[key]

    events = []
    for s in spans:
        tid = lane_tid(s)
        args = {"trace_id": s.trace_id, "span_id": s.span_id}
        if s.parent_id:
            args["parent_id"] = s.parent_id
        args.update({k: str(v)[:120] for k, v in s.attrs.items()})
        events.append({"name": s.name, "ph": "X", "pid": _SPAN_PID,
                       "tid": tid, "ts": s.t0_us,
                       "dur": (s.dur_ns or 0) / 1e3, "args": args})
        for name, ts, attrs in s.events:
            events.append({"name": name, "ph": "i", "s": "t",
                           "pid": _SPAN_PID, "tid": tid, "ts": ts,
                           "args": {k: str(v)[:120]
                                    for k, v in attrs.items()}})
    meta = [{"name": "process_name", "ph": "M", "pid": _SPAN_PID,
             "args": {"name": "host: spans"}}]
    for key, tid in lanes.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": _SPAN_PID,
                     "tid": tid, "args": {"name": str(key)}})
    return meta + events


def device_events():
    """The device lanes of the last completed device trace
    (`profiler.device_events()`), as Chrome events on the spans' clock
    base; empty before any device trace completes."""
    from .. import profiler

    return profiler.device_events()


def chrome_trace(include_device=True, spans=None):
    """One Chrome-trace payload: host spans (+ their instant events)
    merged with the device lanes of `device_events`. Both sides share the
    epoch-µs clock base, so request spans sit directly above the device
    slices they caused."""
    events = chrome_events(spans)
    if include_device:
        events = events + device_events()
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome(path, include_device=True):
    """Write `chrome_trace()` as JSON (open in Perfetto:
    https://ui.perfetto.dev → Open trace file). Returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(include_device=include_device), f)
    return path


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _flight_dir():
    return os.environ.get("MXNET_FLIGHTREC_DIR") or "."


_FLIGHT_CONTEXT = {}          # name -> probe() returning a JSON-able dict
_RANK_STAMP = None            # set by telemetry.fleet on multi-rank runs:
                              # rank-stamps default flightrec filenames so
                              # a shared dir keeps every rank's dump apart


def register_flight_context(name, probe):
    """Attach a subsystem state probe to every flight dump: ``probe()``
    returns a JSON-able dict (or None to skip — the weakly-bound-source
    idiom) snapshotted into ``payload["context"][name]`` at crash time.
    The serving gateway registers its queue/slot state here so a crash
    dump shows WHAT was queued where, not just which spans were open.
    Re-registering a name replaces the previous probe."""
    _FLIGHT_CONTEXT[str(name)] = probe


def _flight_context():
    out = {}
    for name, probe in list(_FLIGHT_CONTEXT.items()):
        try:
            state = probe()
        except Exception as e:  # best-effort context, never mask the dump
            state = {"probe_error": f"{type(e).__name__}: {e}"[:200]}
        if state is not None:
            out[name] = state
    return out


def flight_dump(reason, exc=None, path=None):
    """Snapshot the last `_FLIGHT_SPANS` finished spans, every still-open
    span (the in-flight work at crash time), orphan events, and the armed
    chaos schedule into ``flightrec_<reason>_[rank<r>_]<pid>.json`` (the
    rank stamp on a multi-rank run with the fleet plane armed). Returns the
    written path. The file is overwritten per (reason, pid) — bounded
    artifacts, the LAST crash wins."""
    spans = finished_spans()[-_FLIGHT_SPANS:]
    payload = {
        "reason": reason,
        "pid": os.getpid(),
        "wall_time_us": time.time() * 1e6,
        "error": None if exc is None else {
            "type": type(exc).__name__, "message": str(exc)[:500]},
        "open_spans": [s.to_dict() for s in open_spans()],
        "spans": [s.to_dict() for s in spans],
        "orphan_events": [{"name": n, "ts_us": t, "attrs": a}
                          for n, t, a in list(_ORPHAN_EVENTS)],
        "context": _flight_context(),
    }
    try:
        from ..fault.injection import schedule_info

        payload["fault_schedule"] = schedule_info()
    except Exception:  # best-effort context, never mask the dump
        payload["fault_schedule"] = {}
    if path is None:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in str(reason))[:60]
        stamp = (f"rank{_RANK_STAMP:03d}_" if _RANK_STAMP is not None
                 else "")
        path = os.path.join(_flight_dir(),
                            f"flightrec_{safe}_{stamp}{os.getpid()}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)
    import logging

    logging.getLogger("incubator_mxnet_tpu_torch.telemetry").warning(
        "flight recorder: dumped %d spans (+%d open) to %s (reason: %s)",
        len(spans), len(payload["open_spans"]), path, reason)
    return path


def maybe_flight_dump(reason, exc=None):
    """The hook form: dump only when tracing is armed (a disabled tracer
    has nothing to record and must stay zero-cost). Never raises — a
    broken dump must not mask the crash it documents."""
    if not _ENABLED:
        return None
    try:
        return flight_dump(reason, exc=exc)
    except Exception as e:
        from ..fault.retry import suppressed

        suppressed("tracing.flight_dump", e)
        return None


def _crash_excepthook(exc_type, exc, tb):
    maybe_flight_dump("crash", exc=exc)
    if _PREV_EXCEPTHOOK is not None:
        _PREV_EXCEPTHOOK(exc_type, exc, tb)
    else:  # pragma: no cover - excepthook replaced underneath us
        sys.__excepthook__(exc_type, exc, tb)
