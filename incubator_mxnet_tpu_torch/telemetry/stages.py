"""Funnel stage accounting: where do the eager dispatch microseconds go?
(port of `incubator_mxnet_tpu/telemetry/stages.py`).

`apply_op` / `apply_op_flat` (`ndarray/ndarray.py`) carry per-stage
`perf_counter_ns` probes behind one module-global hook
(`ndarray._STAGE_HOOK`). The contract with the hot path:

- **off** (`_STAGE_HOOK is None`, the default): each probe site is one
  global load and an `is not None` test: no call, no allocation, no
  import;
- **on** (`enable()`): the hook is ``_record(stage, t_start_ns) -> now_ns``:
  it adds `now - t_start` to a per-stage (count, total_ns) cell and
  returns `now`, so consecutive stages chain off one clock read.

Stages (in funnel order), with the reference's names:

=============  ==========================================================
``prologue``   argument scan: the NDArray leaves and their tensors
``amp_lookup`` the AMP cast mode of the op's name
``cache_key``  the reference's op-call jit cache key; eager torch has no
               op-program cache, so the port never records it (absent
               from `stage_report()`, not zero)
``dispatch``   the op itself: AMP casts and the torch call
``wrap``       NDArray wrapping of the outputs
``tape``       under ``autograd.record()``: switching torch's grad mode
               on for the call (torch's graph records the op inside the
               call, so its node is part of ``dispatch``)
=============  ==========================================================

`stage_report()` merges the counters into per-stage µs.
"""
from __future__ import annotations

import threading
import time

from collections import defaultdict

from .locks import tracked_lock

__all__ = ["enable", "disable", "is_enabled", "stage_report", "reset",
           "STAGE_ORDER"]

STAGE_ORDER = ("prologue", "amp_lookup", "cache_key", "dispatch", "wrap",
               "tape")

_LOCK = tracked_lock("telemetry.stages", kind="lock")
_STATS = defaultdict(lambda: [0, 0])     # stage -> [count, total_ns]
_ENABLED = False


def _record(stage, t0_ns):
    """The installed hook: accumulate one stage interval, return 'now' so
    the caller can chain the next stage off a single clock read."""
    now = time.perf_counter_ns()
    cell = _STATS[stage]
    cell[0] += 1
    cell[1] += now - t0_ns
    return now


def enable():
    """Install the stage hook into the op funnel (idempotent)."""
    global _ENABLED
    from ..ndarray import ndarray as nd_mod

    with _LOCK:
        nd_mod._STAGE_HOOK = _record
        _ENABLED = True


def disable():
    """Remove the hook — the funnel probes go back to dead branches."""
    global _ENABLED
    from ..ndarray import ndarray as nd_mod

    with _LOCK:
        nd_mod._STAGE_HOOK = None
        _ENABLED = False


def is_enabled():
    return _ENABLED


def reset():
    with _LOCK:
        _STATS.clear()


def stage_report():
    """Per-stage accounting: {stage: {count, total_us, mean_us}} plus a
    ``total`` row summing every stage (the funnel's Python-side tax per
    op is total.mean_us over the ops measured)."""
    with _LOCK:
        snap = {k: (v[0], v[1]) for k, v in _STATS.items()}
    out = {}
    grand_ns, grand_calls = 0, 0
    for stage in STAGE_ORDER:
        if stage not in snap:
            continue
        count, total_ns = snap[stage]
        out[stage] = {"count": count, "total_us": total_ns / 1e3,
                      "mean_us": (total_ns / count / 1e3) if count else 0.0}
        grand_ns += total_ns
        grand_calls = max(grand_calls, count)
    out["total"] = {"count": grand_calls, "total_us": grand_ns / 1e3,
                    "mean_us": (grand_ns / grand_calls / 1e3)
                    if grand_calls else 0.0}
    return out


def format_report(report=None):
    """Markdown table of `stage_report()`."""
    report = report or stage_report()
    lines = ["| stage | calls | total µs | µs/op |",
             "|---|---:|---:|---:|"]
    for stage in (*STAGE_ORDER, "total"):
        if stage not in report:
            continue
        r = report[stage]
        bold = "**" if stage == "total" else ""
        lines.append(f"| {bold}{stage}{bold} | {r['count']} | "
                     f"{r['total_us']:.1f} | {r['mean_us']:.3f} |")
    return "\n".join(lines)
