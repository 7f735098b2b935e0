"""Multi-window multi-burn-rate alerting over the SLO trackers (port of
`incubator_mxnet_tpu/telemetry/burnrate.py`, host code kept verbatim).

`slo.py` publishes the instantaneous error-budget burn
(``mx_slo_error_budget_burn{slo=}``); paging on the instantaneous value
is the classic flappy alert. The SRE-workbook answer is **multi-window
multi-burn-rate**: fire only when BOTH a fast window (catches sudden
budget incineration) and a slow window (proves it is not a blip) show
burn above their factor — the default pair is the workbook's page
threshold, 5 minutes @ 14.4× AND 1 hour @ 6× — and clear with
**hysteresis**: the alert must observe ``clear_holds`` consecutive
evaluations with every window below ``clear_ratio ×`` its factor
before it stops firing, so a trace hovering at the threshold never
flaps.

Windowed burn comes from the `timeseries` history layer
(``avg_over_time`` of the burn gauge), so both that layer and the SLO
evaluation loop must be live for alerts to see data; no data keeps an
alert in its current state (an observatory outage is not a page, and
not an all-clear either).

Firing state surfaces three ways: ``mx_alert_firing{alert=}`` gauges,
``burnrate.fire`` / ``burnrate.clear`` span events on every transition,
and a flight-recorder block (`tracing.register_flight_context`) so a
crash dump names what was firing.

Knob: ``MXNET_BURN_WINDOWS`` — ``"<window_s>@<factor>,..."`` (e.g.
``"300@14.4,3600@6"``) overrides the default pair for `add` /
`arm_default` callers that don't pass ``windows=``.
"""
from __future__ import annotations

import os

from . import registry, timeseries, tracing
from .locks import tracked_lock

__all__ = ["BurnRateAlert", "add", "remove", "alerts", "firing",
           "evaluate_all", "arm_default", "clear", "parse_windows",
           "DEFAULT_WINDOWS"]

# (window_s, burn factor): fast 5m @ 14.4x AND slow 1h @ 6x — the SRE
# workbook's page-severity pair (14.4x burns a 30d budget in 2 days)
DEFAULT_WINDOWS = ((300.0, 14.4), (3600.0, 6.0))

_LOCK = tracked_lock("telemetry.burnrate", kind="lock")
_ALERTS: dict = {}            # name -> BurnRateAlert
_FLIGHT_ARMED = False


def parse_windows(spec):
    """Parse ``"300@14.4,3600@6"`` into ((300.0, 14.4), (3600.0, 6.0)).
    None/empty → the default pair; a malformed spec raises ValueError
    (a silently-ignored alert config is worse than a loud one)."""
    if not spec:
        return DEFAULT_WINDOWS
    out = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            w, _, f = part.partition("@")
            out.append((float(w), float(f)))
        except ValueError:
            raise ValueError(
                f"MXNET_BURN_WINDOWS: bad entry {part!r} "
                "(want <window_s>@<factor>, e.g. 300@14.4)") from None
    if not out:
        return DEFAULT_WINDOWS
    return tuple(out)


class BurnRateAlert:
    """One multi-window burn alert bound to one SLO's burn series.

    ``windows`` is ((window_s, factor), ...): each pair is an
    INDEPENDENT condition (the SRE fast/slow split — the short window
    catches a flash burst long before the slow average moves; the long
    window catches a slow leak the short one averages away). The alert
    FIRES when ANY window's average burn reaches its factor, and
    CLEARS only after ``clear_holds`` consecutive evaluations with
    EVERY known window below ``clear_ratio × factor`` (hysteresis — no
    flapping at the boundary). Windows with no history yet are skipped
    for firing; with NO window known at all the state freezes (an
    observatory outage must never clear an alert)."""

    __slots__ = ("name", "slo", "windows", "clear_ratio", "clear_holds",
                 "firing", "_below", "last_burns", "fired_at",
                 "transitions")

    def __init__(self, name, slo, windows=None, clear_ratio=0.9,
                 clear_holds=2):
        self.name = str(name)
        self.slo = str(slo)
        if windows is None:
            windows = parse_windows(os.environ.get("MXNET_BURN_WINDOWS"))
        self.windows = tuple((float(w), float(f)) for w, f in windows)
        if not self.windows:
            raise ValueError(f"alert {name!r}: no windows")
        self.clear_ratio = float(clear_ratio)
        self.clear_holds = int(clear_holds)
        self.firing = False
        self._below = 0           # consecutive all-below evaluations
        self.last_burns = {}      # window_s -> last windowed burn
        self.fired_at = None
        self.transitions = 0

    @property
    def series(self):
        return f'mx_slo_error_budget_burn{{slo="{self.slo}"}}'

    def _gauge(self):
        return registry.gauge(
            "mx_alert_firing",
            "1 while a multi-window burn-rate alert fires",
            labels={"alert": self.name})

    def evaluate(self, now=None):
        """One evaluation against the timeseries layer; returns the
        state dict (also what the flight recorder snapshots)."""
        burns = {}
        for w, _f in self.windows:
            burns[w] = timeseries.avg_over_time(self.series, w, now=now)
        self.last_burns = burns
        known = [(w, f, burns[w]) for w, f in self.windows
                 if burns[w] is not None]
        if known:
            exceeded = any(b >= f for _w, f, b in known)
            below = all(b < self.clear_ratio * f for _w, f, b in known)
            if not self.firing:
                if exceeded:
                    self.firing = True
                    self.fired_at = now
                    self.transitions += 1
                    self._below = 0
                    tracing.event("burnrate.fire", alert=self.name,
                                  slo=self.slo,
                                  burns={str(int(w)): round(b, 3)
                                         for w, _f, b in known})
            else:
                if below:
                    self._below += 1
                    if self._below >= self.clear_holds:
                        self.firing = False
                        self.transitions += 1
                        self._below = 0
                        tracing.event("burnrate.clear", alert=self.name,
                                      slo=self.slo)
                else:
                    self._below = 0
        self._gauge().set(1 if self.firing else 0)
        return self.state()

    def state(self):
        return {"alert": self.name, "slo": self.slo,
                "firing": self.firing,
                "windows": [{"window_s": w, "factor": f,
                             "burn": self.last_burns.get(w)}
                            for w, f in self.windows],
                "transitions": self.transitions}


def _arm_flight_context():
    global _FLIGHT_ARMED
    if _FLIGHT_ARMED:
        return
    _FLIGHT_ARMED = True

    def _flight():
        with _LOCK:
            alist = list(_ALERTS.values())
        return {"alerts": [a.state() for a in alist]} if alist else None
    tracing.register_flight_context("burnrate", _flight)


def add(name, slo, windows=None, clear_ratio=0.9, clear_holds=2):
    """Register one alert over `slo`'s burn series. Loud on a duplicate
    name."""
    a = BurnRateAlert(name, slo, windows=windows, clear_ratio=clear_ratio,
                      clear_holds=clear_holds)
    with _LOCK:
        if a.name in _ALERTS:
            raise ValueError(f"burn alert {a.name!r} already registered")
        _ALERTS[a.name] = a
    _arm_flight_context()
    return a


def remove(name):
    with _LOCK:
        _ALERTS.pop(name, None)


def alerts():
    with _LOCK:
        return list(_ALERTS.values())


def firing():
    """Names of currently-firing alerts (what the advisor reads)."""
    with _LOCK:
        return sorted(a.name for a in _ALERTS.values() if a.firing)


def evaluate_all(now=None):
    """Evaluate every registered alert; returns {name: state dict}."""
    return {a.name: a.evaluate(now=now) for a in alerts()}


def arm_default(windows=None, clear_ratio=0.9, clear_holds=2):
    """One burn alert per SLO already registered with the default
    `slo.tracker()` (named ``burn_<slo>``; existing alert names are
    kept). Returns the list of alerts added."""
    from . import slo as slo_mod

    added = []
    for s in slo_mod.tracker().slos():
        name = f"burn_{s.name}"
        with _LOCK:
            exists = name in _ALERTS
        if not exists:
            added.append(add(name, s.name, windows=windows,
                             clear_ratio=clear_ratio,
                             clear_holds=clear_holds))
    return added


def clear():
    """Drop every alert and zero the firing gauges (tests)."""
    with _LOCK:
        alist = list(_ALERTS.values())
        _ALERTS.clear()
    for a in alist:
        a._gauge().set(0)
