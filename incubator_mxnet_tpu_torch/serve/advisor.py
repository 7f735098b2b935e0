"""Observe-only autoscale advisor over the telemetry history layer (port
of `incubator_mxnet_tpu/serve/advisor.py`, host code kept verbatim).

The ROADMAP's "SLO-driven autoscaling" item needs a controller that
reads error-budget burn plus queue/occupancy *trends* and resizes the
replica set. This module is the **decide** half, deliberately without
the actuate half: an :class:`AutoscaleAdvisor` reads ONLY public
observatory APIs — `telemetry.timeseries` windowed queries over the
occupancy/queue-depth histories and `telemetry.burnrate` alert state —
and emits timestamped, *reasoned* recommendations:

- ``scale_up(model, n)``   — a burn-rate alert is firing, or fast-window
  occupancy is pinned above ``up_occupancy`` with a non-empty queue;
- ``scale_down(model, 1)`` — slow-window occupancy below
  ``down_occupancy``, empty queue, no alerts, and no scale-up within
  ``cooldown_s`` (the anti-flap guard: a trough right after a surge
  must prove itself for a full cooldown before shedding capacity);
- ``hold``                 — anything else, including "no history yet"
  (an observatory outage must never drive scaling).

On a disaggregated pod a plain ``scale_up`` is refined with the
anatomy ledger's role-residency evidence
(``mx_replica_residency_seconds_total{replica=,role=,state=}``,
`telemetry.anatomy.residency_report`): when the model's prefill-role
replicas are markedly busier than its decode-role replicas (or vice
versa, by more than ``role_margin`` of wall), the recommendation
becomes ``scale_up_prefill`` / ``scale_up_decode`` and the ``reason``
names the residency series — the ROADMAP's "roofline-driven role-count
autoscaling" evidence plane. `serve.elastic.ReplicaSetController`
consumes the role-aware actions by pinning the spawned replica's role.

Every recommendation names its evidence (series, window, value vs
threshold) in the ``reason`` string, lands in a bounded decision log
(what the future actuating controller will replay), is published as
``mx_advisor_recommendation{action=}`` gauges (1 = current
recommendation), and emits an ``advisor.recommend`` span event on every
action CHANGE.

Determinism: `evaluate(now=...)` takes a virtual timestamp, and the
underlying history can be built with ``timeseries.sample_now(now=...)``
— the committed diurnal-trace test (trough → steady → surge → flash
burst) asserts the exact recommendation sequence with zero flaps on
the steady segment, wall-clock-free.

The gateway arms one advisor per model under ``MXNET_ADVISOR`` (``1`` =
evaluate every 5 s on the step loop; a float = that period in
seconds); `Gateway.advisor_log()` tails the merged decision log.
"""
from __future__ import annotations

import collections
import time

from ..telemetry import burnrate, registry, timeseries, tracing

__all__ = ["AutoscaleAdvisor", "ACTIONS"]

ACTIONS = ("scale_up", "scale_up_prefill", "scale_up_decode",
           "scale_down", "hold")

OCCUPANCY_SERIES = "mx_serve_slot_occupancy"
QUEUE_PREFIX = "mx_gateway_queue_depth"
RESIDENCY_SERIES = "mx_replica_residency_seconds_total"


class AutoscaleAdvisor:
    """Observe-only replica-count advisor for one gateway model."""

    def __init__(self, model, up_occupancy=0.85, down_occupancy=0.25,
                 fast_window_s=60.0, slow_window_s=300.0,
                 cooldown_s=120.0, burst_queue=16,
                 occupancy_series=OCCUPANCY_SERIES,
                 queue_prefix=QUEUE_PREFIX, log_len=256,
                 role_margin=0.1):
        self.model = str(model)
        self.up_occupancy = float(up_occupancy)
        self.down_occupancy = float(down_occupancy)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.cooldown_s = float(cooldown_s)
        self.burst_queue = int(burst_queue)
        self.occupancy_series = occupancy_series
        self.queue_prefix = queue_prefix
        self.role_margin = float(role_margin)
        self._log = collections.deque(maxlen=int(log_len))
        self._last_action = None
        self._last_scale_up_t = None

    # -- signal reads (public timeseries/burnrate APIs only) ---------------

    def _queue_avg(self, window_s, now):
        names = timeseries.series_names(prefix=self.queue_prefix)
        if not names:
            return None
        vals = [timeseries.avg_over_time(n, window_s, now=now)
                for n in names]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None

    def _role_refine(self, now):
        """Residency evidence for a role-aware scale-up: mean busy
        fraction (1 - idle share) of this model's prefill-role vs
        decode-role replicas from the anatomy ledger. Returns
        ``(action, busy_hot, busy_cold)`` when one role is busier by
        more than ``role_margin`` of wall, else None (homogeneous pods
        have no dedicated roles, so they always return None)."""
        from ..telemetry import anatomy

        busy = {"prefill": [], "decode": []}
        for label, row in anatomy.residency_report(now=now).items():
            if label.split("#", 1)[0] != self.model:
                continue
            role = row.get("role")
            if role in busy:
                busy[role].append(1.0 - row["frac"].get("idle", 0.0))
        if not busy["prefill"] or not busy["decode"]:
            return None
        bp = sum(busy["prefill"]) / len(busy["prefill"])
        bd = sum(busy["decode"]) / len(busy["decode"])
        if bp >= bd + self.role_margin:
            return "scale_up_prefill", bp, bd
        if bd >= bp + self.role_margin:
            return "scale_up_decode", bd, bp
        return None

    def _publish(self, action):
        for a in ACTIONS:
            registry.gauge(
                "mx_advisor_recommendation",
                "1 for the advisor's current recommendation per action",
                labels={"action": a}).set(1 if a == action else 0)

    # -- the decision ------------------------------------------------------

    def evaluate(self, now=None):
        """One recommendation: ``{"t", "action", "model", "n",
        "reason", "evidence"}`` (also appended to the decision log)."""
        if now is None:
            now = time.monotonic()
        fast_w, slow_w = self.fast_window_s, self.slow_window_s
        occ_fast = timeseries.avg_over_time(self.occupancy_series,
                                            fast_w, now=now)
        occ_slow = timeseries.avg_over_time(self.occupancy_series,
                                            slow_w, now=now)
        queue_fast = self._queue_avg(fast_w, now)
        alerts = burnrate.firing()
        evidence = {
            f"{self.occupancy_series} avg {fast_w:g}s": occ_fast,
            f"{self.occupancy_series} avg {slow_w:g}s": occ_slow,
            f"{self.queue_prefix}{{*}} sum-avg {fast_w:g}s": queue_fast,
            "alerts_firing": alerts,
        }
        action, n, reason = "hold", 0, "signals nominal"
        if occ_fast is None and not alerts:
            reason = (f"no history yet for {self.occupancy_series} — "
                      "an observatory outage never drives scaling")
        elif alerts:
            action, n = "scale_up", 1
            reason = (f"burn-rate alert(s) {', '.join(alerts)} firing "
                      f"(multi-window burn over mx_slo_error_budget_burn)")
        elif occ_fast >= self.up_occupancy \
                and (queue_fast or 0) > 0:
            action = "scale_up"
            n = 2 if (queue_fast or 0) >= self.burst_queue else 1
            reason = (f"{self.occupancy_series} avg over {fast_w:g}s = "
                      f"{occ_fast:.2f} >= {self.up_occupancy:g} with "
                      f"{self.queue_prefix} sum-avg {queue_fast:.1f} > 0 "
                      f"over {fast_w:g}s")
        elif occ_slow is not None and occ_slow <= self.down_occupancy \
                and not (queue_fast or 0) > 0:
            if self._last_scale_up_t is not None \
                    and now - self._last_scale_up_t < self.cooldown_s:
                reason = (f"{self.occupancy_series} avg over {slow_w:g}s "
                          f"= {occ_slow:.2f} <= {self.down_occupancy:g} "
                          f"but within {self.cooldown_s:g}s scale-up "
                          "cooldown — holding (anti-flap)")
            else:
                action, n = "scale_down", 1
                reason = (f"{self.occupancy_series} avg over {slow_w:g}s "
                          f"= {occ_slow:.2f} <= {self.down_occupancy:g} "
                          f"with empty queue over {fast_w:g}s and no "
                          "burn alerts")
        if action == "scale_up":
            refined = self._role_refine(now)
            if refined is not None:
                action, hot, cold = refined
                role = ("prefill" if action == "scale_up_prefill"
                        else "decode")
                evidence[f"{RESIDENCY_SERIES} busy[{role}]"] = hot
                evidence[f"{RESIDENCY_SERIES} busy[other]"] = cold
                reason += (
                    f"; {RESIDENCY_SERIES} shows {role}-role replicas "
                    f"{hot:.0%} busy vs {cold:.0%} for the other role — "
                    f"scale the {role} side")
        if action.startswith("scale_up"):
            self._last_scale_up_t = now
        rec = {"t": now, "action": action, "model": self.model, "n": n,
               "reason": reason, "evidence": evidence}
        self._log.append(rec)
        self._publish(action)
        if action != self._last_action:
            tracing.event("advisor.recommend", model=self.model,
                          action=action, n=n, reason=reason)
            self._last_action = action
        return rec

    # -- reading -----------------------------------------------------------

    def decision_log(self, tail=None):
        """The bounded recommendation history, oldest→newest."""
        log = list(self._log)
        return log if tail is None else log[-int(tail):]

    def recommendations(self, tail=None):
        """Action sequence (deduplicated runs collapse to one entry) —
        what the diurnal acceptance gate asserts."""
        seq = []
        for rec in self.decision_log(tail=tail):
            if not seq or seq[-1] != rec["action"]:
                seq.append(rec["action"])
        return seq

    def pending_action(self, since_t=None):
        """The newest non-hold recommendation STRICTLY newer than
        ``since_t`` — the `serve.elastic.ReplicaSetController` consume
        surface (the controller remembers the timestamp it acted on, so
        one recommendation is never acted on twice). Returns the
        decision dict or None."""
        for rec in reversed(self._log):
            if since_t is not None and rec["t"] <= since_t:
                return None
            if rec["action"] != "hold":
                return rec
        return None
