"""Per-tenant / per-model cost ledger for the serving plane (port of
`incubator_mxnet_tpu/telemetry/capacity.py`), host-only code ported
nearly verbatim.

A millions-of-users gateway needs to answer "who is spending the
hardware": capacity planning, chargeback, and the autoscale advisor all
start from per-tenant demand curves, not aggregate throughput. This
module attributes four costs at the serving seams (the scheduler's
prefill/decode timing, the gateway's dispatch path):

- **tokens**            — ``mx_capacity_tokens_total{tenant=,model=}``
- **device-seconds**    — ``mx_capacity_device_seconds_total{tenant=,
  model=,phase=}`` with ``phase="prefill"`` (per-chunk, exact per-slot
  attribution) vs ``phase="decode"`` (one batched program per step,
  split evenly across the slots decoding in it);
- **KV page-seconds**   — ``mx_capacity_kv_page_seconds_total{tenant=,
  model=}``: resident pool pages × seconds, the HBM-occupancy integral
  (also mirrored as the serving view
  ``mx_serve_kv_page_seconds_total{tenant=}``);
- **queue-wait**        — ``mx_capacity_queue_wait_seconds_total{
  tenant=,model=}``: gateway submit → first dispatch.

`measured_wall_s()` accumulates the total timed serve wall (every
prefill/decode duration once, BEFORE per-tenant splitting) so the
ledger is self-auditing: per-tenant device-seconds must sum back to it.
The scheduler's windows close after the step's tokens reached the host,
so on the card a window is the step's time, not its launch's.

Off-path contract: every ``charge_*`` is a dead branch
(``if not _ENABLED: return``) and the scheduler/gateway seams check the
module flag once per step before doing any timing — disarmed, the hot
path pays one attribute load. Arms with the rest of the telemetry
plane (``MXNET_TELEMETRY=1`` at import) or via `enable()`.

`ledger_report()` rolls the series into {tenant: {model: costs}} (the
reference's cross-rank rollup, `fleet.fleet_report()`, is not ported
yet).
"""
from __future__ import annotations

import os
import re

from . import registry
from .locks import tracked_lock

__all__ = ["enable", "disable", "is_enabled", "reset",
           "charge_tokens", "charge_device_seconds",
           "split_device_seconds", "charge_kv_page_seconds",
           "charge_queue_wait", "measured_wall_s", "ledger_report",
           "capacity_view"]

_ENABLED = False
_WALL_LOCK = tracked_lock("telemetry.capacity", kind="lock")
_WALL = [0.0]                 # total timed serve wall (pre-split)

_SERIES_RE = re.compile(r'^(mx_capacity_\w+)\{(.*)\}$')
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def enable():
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def is_enabled():
    return _ENABLED


def reset():
    """Zero the wall accumulator (the mx_capacity_* series live in the
    registry and reset with `registry.reset()`)."""
    with _WALL_LOCK:
        _WALL[0] = 0.0


def _t(tenant):
    return str(tenant) if tenant else "anon"


def charge_tokens(tenant, model, n=1):
    """Attribute `n` generated tokens (gateway emit path)."""
    if not _ENABLED:
        return
    registry.counter(
        "mx_capacity_tokens_total",
        "generated tokens attributed per tenant and model",
        labels={"tenant": _t(tenant), "model": str(model)}).inc(n)


def charge_device_seconds(tenant, model, phase, seconds):
    """Attribute `seconds` of device time in `phase` ("prefill" /
    "decode") to one tenant. Callers that timed a BATCHED program over
    several tenants should use `split_device_seconds` instead (it also
    feeds the wall accumulator exactly once)."""
    if not _ENABLED:
        return
    registry.counter(
        "mx_capacity_device_seconds_total",
        "serve device-seconds attributed per tenant/model, split "
        "prefill vs decode",
        labels={"tenant": _t(tenant), "model": str(model),
                "phase": str(phase)}).inc(float(seconds))


def split_device_seconds(tenants, model, phase, seconds):
    """Split one timed program invocation of `seconds` evenly across
    `tenants` (one entry per participating slot — multiplicity is the
    weight) and add `seconds` ONCE to the measured-wall accumulator.
    An empty tenant list still counts toward the wall (the time was
    spent) under the "anon" tenant."""
    if not _ENABLED:
        return
    seconds = float(seconds)
    with _WALL_LOCK:
        _WALL[0] += seconds
    tenants = list(tenants) or [None]
    share = seconds / len(tenants)
    for tenant in tenants:
        charge_device_seconds(tenant, model, phase, share)


def charge_kv_page_seconds(tenant, model, page_seconds):
    """Attribute resident-KV-page × seconds (HBM occupancy integral).
    Also feeds the per-tenant serving view
    ``mx_serve_kv_page_seconds_total{tenant=}``."""
    if not _ENABLED:
        return
    page_seconds = float(page_seconds)
    tenant = _t(tenant)
    registry.counter(
        "mx_capacity_kv_page_seconds_total",
        "resident KV pool pages x seconds per tenant/model",
        labels={"tenant": tenant, "model": str(model)}).inc(page_seconds)
    registry.counter(
        "mx_serve_kv_page_seconds_total",
        "resident KV pool pages x seconds per tenant (serving view of "
        "the capacity ledger)",
        labels={"tenant": tenant}).inc(page_seconds)


def charge_queue_wait(tenant, model, seconds):
    """Attribute gateway queue wait (submit → first dispatch)."""
    if not _ENABLED:
        return
    registry.counter(
        "mx_capacity_queue_wait_seconds_total",
        "gateway queue wait (submit to first dispatch) per tenant/model",
        labels={"tenant": _t(tenant), "model": str(model)}).inc(
            float(seconds))


def measured_wall_s():
    """Total timed serve wall accumulated by `split_device_seconds`
    (the per-tenant device-seconds must sum back to this)."""
    with _WALL_LOCK:
        return _WALL[0]


# ---------------------------------------------------------------------------
# rollups
# ---------------------------------------------------------------------------

def _parse(series_key):
    m = _SERIES_RE.match(series_key)
    if m is None:
        return None, {}
    return m.group(1), dict(_LABEL_RE.findall(m.group(2)))


def capacity_view(snapshot):
    """Roll one registry snapshot (``registry.report()``-shaped dict)
    into {tenant: {model: {tokens, device_s: {phase: s}, kv_page_s,
    queue_wait_s}}} — what `ledger_report` reads."""
    out = {}
    for key, info in snapshot.items():
        base, labels = _parse(key)
        if base is None:
            continue
        v = info.get("value") if isinstance(info, dict) else info
        if v is None:
            continue
        tenant = labels.get("tenant", "anon")
        model = labels.get("model", "?")
        row = out.setdefault(tenant, {}).setdefault(
            model, {"tokens": 0, "device_s": {}, "kv_page_s": 0.0,
                    "queue_wait_s": 0.0})
        if base == "mx_capacity_tokens_total":
            row["tokens"] += int(v)
        elif base == "mx_capacity_device_seconds_total":
            phase = labels.get("phase", "?")
            row["device_s"][phase] = row["device_s"].get(phase, 0.0) \
                + float(v)
        elif base == "mx_capacity_kv_page_seconds_total":
            row["kv_page_s"] += float(v)
        elif base == "mx_capacity_queue_wait_seconds_total":
            row["queue_wait_s"] += float(v)
    return out


def ledger_report():
    """The cost ledger as a dict: per-tenant/per-model rows plus the
    wall audit (device-second sum vs `measured_wall_s`)."""
    view = capacity_view(registry.report())
    device_sum = sum(s for t in view.values() for m in t.values()
                     for s in m["device_s"].values())
    return {"tenants": view, "device_seconds_sum": device_sum,
            "measured_wall_s": measured_wall_s()}


# arm with the rest of the telemetry plane (cheap counter incs at the
# serving seams; disarmed, one flag check a step)
if os.environ.get("MXNET_TELEMETRY", "0") not in ("0", ""):
    _ENABLED = True
