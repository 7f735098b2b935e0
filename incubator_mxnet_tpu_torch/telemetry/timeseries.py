"""Time-series history layer over the metrics registry (port of
`incubator_mxnet_tpu/telemetry/timeseries.py`, host code kept nearly
verbatim).

Every observatory below this one reports *point-in-time* snapshots —
`registry.report()` says what the queue depth and error-budget burn are
**now**, but a controller (the burn-rate alerter, the autoscale
advisor, a future actuating autoscaler) needs *windowed* signals:
rates, deltas, percentiles and threshold-fractions **over time**. This
module retains that history: armed, a fixed-interval sampler walks the
registry and appends every series' current value to a bounded ring —
one ring per series, including labeled views, pull gauges, and the
``:count`` / ``:sum`` sub-series it derives from each histogram — and
windowed queries read the rings:

- ``history(series, window_s)``      — raw ``[(t, v), ...]`` samples;
- ``rate(series, window_s)``         — per-second counter increase,
  counter-reset aware (a restarted process's counter drop is treated
  as a reset, not a negative rate — the Prometheus convention);
- ``delta(series, window_s)``        — last minus first value;
- ``avg_over_time`` / ``percentile_over_time`` — gauge aggregation
  (nearest-rank percentile, same convention as `tools/loadgen.py`);
- ``window_frac(series, window_s, pred)`` — fraction of samples in the
  window satisfying a predicate ("how long was occupancy above 0.85?").

Off-path contract (the `telemetry/locks.py` dead-branch discipline):
disarmed there is **no state, no thread, and no hot-path hook** — the
layer is pull-based, so the serving/training hot paths never see it at
all; off-path cost is zero by construction (the committed <3% gate in
tests measures the armed-module-imported case anyway). Arm with
``MXNET_TS_INTERVAL=<seconds>`` at import (spawns the daemon sampler
thread) or call `enable()`; tests and the dryrun drive deterministic
virtual-time histories via ``enable(thread=False)`` +
``sample_now(now=...)``.

The sampler thread reads every pull gauge of the registry, so no probe
the port registers touches the card: a probe reads host state only (no
``.item()``, no ``.cpu()``, no ``torch.cuda.synchronize``), or a sample
would stall the step thread and serialise with its CUDA-graph captures.
The HBM census gauges (`telemetry.hbm`) read the caching allocator's
host-side counters.

Knobs: ``MXNET_TS_INTERVAL`` (sample period seconds, default 1.0),
``MXNET_TS_SAMPLES`` (ring capacity per series, default 512 — bounded
memory: capacity × series count floats, oldest overwritten).

All timestamps are ``time.monotonic()`` (or the caller's virtual
``now``) — wall-clock ``time.time()`` in a duration is lint FL019.
"""
from __future__ import annotations

import os
import threading
import time

from . import registry
from .locks import tracked_lock

__all__ = ["enable", "disable", "is_enabled", "reset", "sample_now",
           "history", "rate", "delta", "avg_over_time",
           "percentile_over_time", "window_frac", "series_names",
           "last", "sample_count", "DEFAULT_INTERVAL_S",
           "DEFAULT_SAMPLES"]

DEFAULT_INTERVAL_S = 1.0
DEFAULT_SAMPLES = 512

_ENABLED = False
_STATE = None                 # _Store while armed (survives disable()
                              # for post-run queries; reset() clears it)


class _Ring:
    """Bounded (t, value) ring: preallocated arrays, oldest overwritten."""

    __slots__ = ("cap", "ts", "vals", "n", "i", "kind")

    def __init__(self, cap, kind):
        self.cap = cap
        self.ts = [0.0] * cap
        self.vals = [0.0] * cap
        self.n = 0                # valid samples (≤ cap)
        self.i = 0                # next write index
        self.kind = kind          # "counter" | "gauge"

    def push(self, t, v):
        self.ts[self.i] = t
        self.vals[self.i] = v
        self.i = (self.i + 1) % self.cap
        if self.n < self.cap:
            self.n += 1

    def items(self):
        """Oldest→newest [(t, v), ...]."""
        if self.n < self.cap:
            return list(zip(self.ts[:self.n], self.vals[:self.n]))
        i = self.i
        return list(zip(self.ts[i:] + self.ts[:i],
                        self.vals[i:] + self.vals[:i]))


class _Store:
    __slots__ = ("interval", "samples", "rings", "lock", "thread",
                 "stop", "ticks")

    def __init__(self, interval, samples):
        self.interval = interval
        self.samples = samples
        self.rings = {}           # series key -> _Ring
        self.lock = tracked_lock("telemetry.timeseries", kind="lock")
        self.thread = None
        self.stop = None
        self.ticks = 0


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_samples():
    try:
        n = int(os.environ.get("MXNET_TS_SAMPLES", "") or DEFAULT_SAMPLES)
    except ValueError:
        n = DEFAULT_SAMPLES
    return max(2, n)


def enable(interval_s=None, samples=None, thread=True):
    """Arm the history layer. ``interval_s``/``samples`` default to the
    ``MXNET_TS_INTERVAL`` / ``MXNET_TS_SAMPLES`` knobs; ``thread=False``
    skips the daemon sampler (tests/dryrun drive `sample_now` with
    virtual timestamps instead). Idempotent; re-arming with a live
    sampler keeps the existing rings."""
    global _ENABLED, _STATE
    if interval_s is None:
        interval_s = _env_float("MXNET_TS_INTERVAL", DEFAULT_INTERVAL_S)
    interval_s = max(float(interval_s), 1e-3)
    if samples is None:
        samples = _env_samples()
    if _STATE is None:
        _STATE = _Store(interval_s, int(samples))
    _ENABLED = True
    st = _STATE
    if thread and st.thread is None:
        stop = threading.Event()

        def _loop():
            while not stop.wait(st.interval):
                try:
                    sample_now()
                except Exception:   # noqa: FL006 - sampler must survive
                    # a mid-teardown registry race; the next tick retries
                    pass
        t = threading.Thread(target=_loop, name="mx-timeseries-sampler",
                             daemon=True)
        st.stop = stop
        st.thread = t
        t.start()
    return st.interval, st.samples


def disable():
    """Stop sampling (the rings stay queryable until `reset()`)."""
    global _ENABLED
    _ENABLED = False
    st = _STATE
    if st is not None and st.stop is not None:
        st.stop.set()
        if st.thread is not None:
            st.thread.join(timeout=2.0)
        st.thread = None
        st.stop = None


def is_enabled():
    return _ENABLED


def reset():
    """Drop every ring and the sampler (tests)."""
    global _STATE
    disable()
    _STATE = None


def sample_now(now=None):
    """Take one sample of every registry series (the sampler thread's
    tick, also the deterministic manual tick — pass a virtual ``now``
    to build wall-clock-free histories). Histograms contribute
    ``<series>:count`` and ``<series>:sum`` counter-kind sub-series
    (windowed latency math wants both). Returns the number of series
    sampled, 0 while disarmed."""
    st = _STATE
    if st is None or not _ENABLED:
        return 0
    if now is None:
        now = time.monotonic()
    else:
        now = float(now)
    rep = registry.report()
    pushed = 0
    with st.lock:
        for key, info in rep.items():
            kind = info.get("type")
            if kind == "histogram":
                for suffix, v in ((":count", info.get("count", 0)),
                                  (":sum", info.get("sum", 0.0))):
                    ring = st.rings.get(key + suffix)
                    if ring is None:
                        ring = _Ring(st.samples, "counter")
                        st.rings[key + suffix] = ring
                    ring.push(now, float(v))
                    pushed += 1
                continue
            v = info.get("value")
            if v is None:
                continue
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            ring = st.rings.get(key)
            if ring is None:
                ring = _Ring(st.samples,
                             "counter" if kind == "counter" else "gauge")
                st.rings[key] = ring
            ring.push(now, v)
            pushed += 1
        st.ticks += 1
    return pushed


# ---------------------------------------------------------------------------
# windowed queries (every one returns None on no data / unknown series)
# ---------------------------------------------------------------------------

def _window(series, window_s, now):
    """Samples of `series` in the trailing window, oldest→newest, or
    None when the layer is cold or the series unknown."""
    st = _STATE
    if st is None:
        return None
    with st.lock:
        ring = st.rings.get(series)
        if ring is None:
            return None
        items = ring.items()
    if not items:
        return None
    if window_s is None:
        return items
    if now is None:
        now = items[-1][0]
    lo = now - float(window_s)
    return [(t, v) for t, v in items if t >= lo]


def history(series, window_s=None, now=None):
    """Raw [(t, value), ...] samples (trailing ``window_s``, or the
    whole ring). None for an unknown series."""
    return _window(series, window_s, now)


def last(series):
    """Most recent (t, value) sample, or None."""
    items = _window(series, None, None)
    return items[-1] if items else None


def delta(series, window_s, now=None):
    """Last minus first sampled value over the window (gauge-style;
    for counters across a reset prefer `rate`). None under 2 samples."""
    items = _window(series, window_s, now)
    if not items or len(items) < 2:
        return None
    return items[-1][1] - items[0][1]


def rate(series, window_s, now=None):
    """Per-second increase of a counter-kind series over the window.
    Counter-reset aware: a sample LOWER than its predecessor means the
    counter restarted from zero, so the new value is the increase since
    the reset (the Prometheus ``rate()`` convention). None under 2
    samples or a zero-length span."""
    items = _window(series, window_s, now)
    if not items or len(items) < 2:
        return None
    span = items[-1][0] - items[0][0]
    if span <= 0:
        return None
    inc = 0.0
    prev = items[0][1]
    for _, v in items[1:]:
        inc += v - prev if v >= prev else v
        prev = v
    return inc / span


def avg_over_time(series, window_s, now=None):
    """Mean of the sampled values in the window. None on no samples."""
    items = _window(series, window_s, now)
    if not items:
        return None
    return sum(v for _, v in items) / len(items)


def percentile_over_time(series, q, window_s, now=None):
    """Nearest-rank percentile (q in [0, 100]) of the sampled values in
    the window — same convention as `tools/loadgen.percentile`."""
    items = _window(series, window_s, now)
    if not items:
        return None
    xs = sorted(v for _, v in items)
    i = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[i]


def window_frac(series, window_s, pred, now=None):
    """Fraction of samples in the window for which ``pred(value)`` is
    true — "how long was occupancy above 0.85?". None on no samples."""
    items = _window(series, window_s, now)
    if not items:
        return None
    return sum(1 for _, v in items if pred(v)) / len(items)


def series_names(prefix=None):
    """Sampled series keys (optionally filtered by prefix), sorted."""
    st = _STATE
    if st is None:
        return []
    with st.lock:
        names = list(st.rings)
    if prefix is not None:
        names = [n for n in names if n.startswith(prefix)]
    return sorted(names)


def sample_count():
    """Sampler ticks taken since arming (0 while disarmed)."""
    st = _STATE
    return 0 if st is None else st.ticks


# self-arm: MXNET_TS_INTERVAL opts into history retention at import
# (the background sampler is a standing thread, so plain
# MXNET_TELEMETRY=1 does NOT arm this layer — it is its own knob)
if os.environ.get("MXNET_TS_INTERVAL", "") not in ("", "0"):
    enable()
