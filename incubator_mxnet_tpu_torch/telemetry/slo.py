"""SLO tracker: declarative service-level objectives over registry series
(port of `incubator_mxnet_tpu/telemetry/slo.py`: `SLO`, `LatencySLO`,
`ThroughputSLO`, `GaugeSLO`, `SLOTracker`, `tracker`, `gateway_ttft`
:319), host-only code ported nearly verbatim.

The registry records what happened; this module says whether that is
*acceptable*. An :class:`SLO` binds an existing series to an objective —
"99% of TTFTs under 250 ms", "serve throughput ≥ 500 tokens/s", "queue
depth ≤ 64" — and every `evaluate()` computes:

- **compliance**: the fraction of good observations (latency SLOs read
  the histogram's bucket counts; throughput SLOs rate the counter delta
  between evaluations; gauge SLOs threshold the last value);
- **error-budget burn**: ``bad_fraction / (1 - target)`` — the standard
  SRE burn statistic. burn < 1 means the objective holds with budget to
  spare; burn ≥ 1 means the budget is exhausted and the SLO is violated.

Results surface three ways, loudest last:

1. gauges in the registry (Prometheus-scrapable, same pipeline as every
   other series): ``mx_slo_compliance{slo=...}``,
   ``mx_slo_error_budget_burn{slo=...}``, ``mx_slo_ok{slo=...}``;
2. `violations()` → the violated subset with numbers attached;
3. the health-monitor hook: `install_health_check()` registers the
   default tracker with `telemetry.monitor`, so `monitor.check()` (the
   call that already surfaces NaN findings) also raises `MXNetError` on
   a burned error budget.

Latency compliance is computed conservatively from histogram buckets:
observations are counted good only up to the largest bucket boundary
≤ threshold (a threshold between boundaries under-counts good, never
over-counts). Pick thresholds on bucket boundaries for exact math — the
default registry buckets are log-spaced 100 µs…2 min.
"""
from __future__ import annotations

import time

from .locks import tracked_lock

from . import registry

__all__ = ["SLO", "SLOTracker", "tracker", "latency", "throughput",
           "gauge_max", "evaluate", "violations", "check",
           "install_health_check", "serve_ttft", "serve_throughput",
           "step_time", "gateway_ttft"]


class SLO:
    """One objective. Subclasses implement `_measure()` returning
    ``(compliance, detail)`` where compliance ∈ [0, 1] or None (no data
    yet — not a violation)."""

    kind = "abstract"

    def __init__(self, name, series, target):
        self.name = str(name)
        self.series = str(series)
        self.target = float(target)
        if not 0.0 < self.target <= 1.0:
            raise ValueError(
                f"SLO {name!r}: target must be in (0, 1], got {target}")

    # -- evaluation ----------------------------------------------------------

    def evaluate(self):
        """Measure, publish the mx_slo_* gauges, return the result dict."""
        compliance, detail = self._measure()
        if compliance is None:
            burn = None
            ok = True                 # no data is not a violation
        else:
            budget = 1.0 - self.target
            bad = 1.0 - compliance
            if budget <= 0.0:         # target == 1.0: any badness burns ∞
                burn = 0.0 if bad <= 0.0 else float("inf")
            else:
                burn = bad / budget
            ok = burn < 1.0
        labels = {"slo": self.name}
        registry.gauge("mx_slo_compliance",
                       "good-observation fraction per SLO",
                       labels=labels).set(compliance)
        registry.gauge("mx_slo_error_budget_burn",
                       "bad fraction / allowed bad fraction (≥1 = violated)",
                       labels=labels).set(
                           None if burn is None else min(burn, 1e9))
        registry.gauge("mx_slo_ok", "1 while the error budget holds",
                       labels=labels).set(1 if ok else 0)
        return {"slo": self.name, "kind": self.kind, "series": self.series,
                "target": self.target, "compliance": compliance,
                "burn": burn, "ok": ok, "detail": detail}

    def _measure(self):  # pragma: no cover - abstract
        raise NotImplementedError


class LatencySLO(SLO):
    """`target` fraction of `series` (a histogram) observations must be
    ≤ `threshold_s`. ``labels`` selects ONE labeled series (e.g. the
    gateway's per-tier TTFT view) instead of the unlabeled aggregate."""

    kind = "latency"

    def __init__(self, name, series, threshold_s, target=0.99,
                 labels=None):
        super().__init__(name, series, target)
        self.threshold_s = float(threshold_s)
        self.labels = dict(labels) if labels else None

    def _measure(self):
        h = registry.histogram(self.series, labels=self.labels)
        snap = h.snapshot()
        total = snap["count"]
        if not total:
            return None, {"observations": 0}
        good = 0
        for b in sorted(snap["buckets"]):
            if b <= self.threshold_s:
                good += snap["buckets"][b]
        return good / total, {"observations": total, "good": good,
                              "threshold_s": self.threshold_s}


class ThroughputSLO(SLO):
    """Counter-rate objective: the `series` counter must advance at
    ≥ `min_rate`/s, measured between consecutive `evaluate()` calls.
    Compliance is the fraction of measured windows that met the rate
    (`target` of them must)."""

    kind = "throughput"

    def __init__(self, name, series, min_rate, target=0.99):
        super().__init__(name, series, target)
        self.min_rate = float(min_rate)
        self._last_value = None
        self._last_t = None
        self._windows = 0
        self._good_windows = 0

    def observe_window(self, now=None):
        """Advance one measurement window; returns the window's rate
        (None on the priming call)."""
        now = time.monotonic() if now is None else now
        value = registry.counter(self.series).value
        rate = None
        if self._last_t is not None and now > self._last_t:
            rate = (value - self._last_value) / (now - self._last_t)
            self._windows += 1
            if rate >= self.min_rate:
                self._good_windows += 1
        self._last_value = value
        self._last_t = now
        return rate

    def _measure(self):
        self.observe_window()
        if not self._windows:
            return None, {"windows": 0}
        return (self._good_windows / self._windows,
                {"windows": self._windows, "good": self._good_windows,
                 "min_rate": self.min_rate})


class GaugeSLO(SLO):
    """Gauge-threshold objective: the `series` gauge's last value must be
    ≤ `max_value` (windowed like ThroughputSLO: each evaluate() is one
    observation)."""

    kind = "gauge"

    def __init__(self, name, series, max_value, target=0.99):
        super().__init__(name, series, target)
        self.max_value = float(max_value)
        self._windows = 0
        self._good_windows = 0

    def _measure(self):
        v = registry.gauge(self.series).value
        if v is None:
            if not self._windows:
                return None, {"windows": 0}
        else:
            self._windows += 1
            if float(v) <= self.max_value:
                self._good_windows += 1
        return (self._good_windows / self._windows,
                {"windows": self._windows, "good": self._good_windows,
                 "max_value": self.max_value, "last": v})


class SLOTracker:
    """A set of SLOs evaluated together (the default module tracker is
    what the health hook and the MXNET_TELEMETRY_DUMP snapshot use)."""

    def __init__(self):
        self._slos: list = []
        self._lock = tracked_lock("telemetry.slo", kind="lock")

    def add(self, slo):
        with self._lock:
            if any(s.name == slo.name for s in self._slos):
                raise ValueError(f"SLO {slo.name!r} already registered")
            self._slos.append(slo)
        return slo

    def remove(self, name):
        with self._lock:
            self._slos = [s for s in self._slos if s.name != name]

    def clear(self):
        with self._lock:
            self._slos = []

    def slos(self):
        with self._lock:
            return list(self._slos)

    # -- constructors --------------------------------------------------------

    def latency(self, name, series, threshold_s, target=0.99, labels=None):
        return self.add(LatencySLO(name, series, threshold_s, target,
                                   labels=labels))

    def throughput(self, name, series, min_rate, target=0.99):
        return self.add(ThroughputSLO(name, series, min_rate, target))

    def gauge_max(self, name, series, max_value, target=0.99):
        return self.add(GaugeSLO(name, series, max_value, target))

    # -- evaluation ----------------------------------------------------------

    def evaluate(self):
        """Evaluate every SLO, refresh the mx_slo_* gauges, return the
        list of result dicts."""
        return [s.evaluate() for s in self.slos()]

    def violations(self):
        return [r for r in self.evaluate() if not r["ok"]]

    def check(self):
        """Loud form: raise `MXNetError` naming every SLO whose error
        budget is burned. The health-monitor hook routes here."""
        bad = self.violations()
        if bad:
            from ..base import MXNetError

            lines = [
                f"{r['slo']}: burn={r['burn']:.2f} "
                f"(compliance {r['compliance']:.4f} < target "
                f"{r['target']:.4f} over {r['series']})" for r in bad]
            raise MXNetError(
                "SLO error budget burned:\n  " + "\n  ".join(lines))


_DEFAULT = SLOTracker()


def tracker():
    """The process-default tracker (what the module-level helpers and
    the monitor health hook operate on)."""
    return _DEFAULT


def latency(name, series, threshold_s, target=0.99, labels=None):
    return _DEFAULT.latency(name, series, threshold_s, target,
                            labels=labels)


def throughput(name, series, min_rate, target=0.99):
    return _DEFAULT.throughput(name, series, min_rate, target)


def gauge_max(name, series, max_value, target=0.99):
    return _DEFAULT.gauge_max(name, series, max_value, target)


def evaluate():
    return _DEFAULT.evaluate()


def violations():
    return _DEFAULT.violations()


def check():
    return _DEFAULT.check()


def install_health_check():
    """Register the default tracker with `telemetry.monitor`: from now
    on `monitor.check()` raises on a burned SLO budget as it raises on a
    pending NaN finding. Idempotent; returns the tracker."""
    from . import monitor

    monitor.add_health_check(_DEFAULT.check, name="slo")
    return _DEFAULT


# -- presets over the built-in series ---------------------------------------

def serve_ttft(threshold_s=0.25, target=0.99, name="serve_ttft"):
    """TTFT objective over the serving engine's histogram
    (`mx_serve_ttft_seconds`)."""
    return _DEFAULT.latency(name, "mx_serve_ttft_seconds", threshold_s,
                            target)


def serve_throughput(min_tokens_s, target=0.9, name="serve_tokens_s"):
    """Decode-throughput objective over `mx_serve_tokens_total`."""
    return _DEFAULT.throughput(name, "mx_serve_tokens_total", min_tokens_s,
                               target)


def step_time(threshold_s, target=0.99, name="step_time"):
    """Train-step latency objective over `mx_step_time_seconds`."""
    return _DEFAULT.latency(name, "mx_step_time_seconds", threshold_s,
                            target)


def gateway_ttft(tier, threshold_s=0.5, target=0.99, name=None):
    """Per-tier TTFT objective over the gateway's tier-labeled TTFT view
    (``mx_serve_ttft_seconds{priority=<tier>}`` — gateway submit to
    first token, queue wait and preemptions included)."""
    if name is None:
        name = f"gateway_ttft_{tier}"
    return _DEFAULT.latency(name, "mx_serve_ttft_seconds", threshold_s,
                            target, labels={"priority": str(tier)})
