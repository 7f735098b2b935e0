"""Per-kernel observatory: census, roofline placement, fusion diff (port
of `incubator_mxnet_tpu/telemetry/kernels.py`).

`telemetry/roofline.py` classifies device time into coarse phases; this
module names the individual kernels of the device trace `profiler.py`
captures:

- `census()`: one row per kernel name: occurrences, device time, bytes
  accessed and FLOPs where the events carry them (the port's kernels:
  their launches' costs, joined from the launch log by the profiler;
  read through the shared `profiler.event_stat_bytes`/`event_stat_flops`
  path), an achieved-GB/s and achieved-TFLOP/s placement against the
  card's roofs (`roofline.PEAK_HBM_GBS`, `PEAK_TFLOPS` here), and a
  ``bound_by`` verdict. Coverage is honest by construction: a kernel
  without a bytes stat (cuBLAS, cuDNN, torch's own) reads as *unknown*,
  never *fast*, and the census reports both the attributed-time fraction
  (named kernels against all device time) and the byte-stat coverage.
  Launches the profiler's launch log holds and the trace lost (the first
  kernels of a profiling session, `PERF.md` §7) are no rows at all:
  a census of the profiler's events reports them as
  ``meta["lost_launches"]`` and logs a warning when there are any, so
  that its counts and device time are not taken for a whole step's.
- the program-ledger join: pass ``ledger=compiles.ledger_report()`` and
  every program family (a captured graph) gets a cost-model placement
  (its FLOPs over its kernels' bytes against the balance point) beside
  the trace's rows; `program_mfu()` turns FLOPs and measured device
  seconds into a trace-measured MFU to hold against a hand-derived one.
- fusion forensics: `diff_census(before, after)` names the kernels that
  appeared, vanished, split or merged between two configurations, counts
  the verdict as ``mx_kernel_fusion_delta{kind=}`` and parks the last
  diff in a flight-context block.
"""
from __future__ import annotations

import logging
import re

from . import registry, tracing
from .roofline import DEFAULT_EXCLUDE, PEAK_HBM_GBS, _device_lane_pids

__all__ = ["census", "from_profiler", "diff_census", "top_bandwidth_bound",
           "program_mfu", "format_census", "format_diff", "PEAK_TFLOPS",
           "last_census", "last_diff", "reset"]

# peak dense bf16/f16 tensor-core TFLOP/s per card, keyed by the
# lower-cased nvidia-smi name (NVIDIA's data sheet, the rate `PERF.md`'s
# bounds use; pass peak_tflops= explicitly for other parts or dtypes)
PEAK_TFLOPS = {"nvidia h100 80gb hbm3": 989.0}

_LAST_CENSUS = None     # meta summary of the last census (flight context)
_LAST_DIFF = None       # last diff_census result (flight context)


def _roofs(device, peak_gbs, peak_tflops):
    if device is not None:
        key = str(device).lower()
        if peak_gbs is None:
            peak_gbs = PEAK_HBM_GBS.get(key)
        if peak_tflops is None:
            peak_tflops = PEAK_TFLOPS.get(key)
    return peak_gbs, peak_tflops


def _bound_by(bytes_known, achieved_gbs, achieved_tflops,
              peak_gbs, peak_tflops):
    """Roofline verdict for one kernel. No bytes stat -> *unknown* (the
    honesty rule: a thin trace must not read as compute-bound-and-fast).
    With bytes, the kernel is bound by whichever roof it sits closer to;
    without a FLOPs stat the memory verdict stands on bytes alone."""
    if not bytes_known or peak_gbs is None or achieved_gbs is None:
        return "unknown"
    hbm_frac = achieved_gbs / peak_gbs
    flops_frac = ((achieved_tflops / peak_tflops)
                  if (achieved_tflops is not None and peak_tflops)
                  else 0.0)
    return "compute" if flops_frac > hbm_frac else "memory"


def census(events=None, ledger=None, device=None, peak_gbs=None,
           peak_tflops=None, exclude=DEFAULT_EXCLUDE):
    """Per-kernel census over Chrome-trace device events (default:
    `profiler.device_events()` from the last trace).

    Returns ``{"rows", "programs", "meta"}``: each row is ``{name, count,
    time_us, bytes, flops, bytes_known, flops_known, achieved_gbs,
    achieved_tflops, hbm_frac, flops_frac, bound_by}`` sorted by device
    time; ``achieved_gbs`` divides known bytes by the kernel's FULL
    device time, so missing byte stats bias it LOW (conservative).
    ``meta`` carries ``attributed_frac`` (named-kernel time over total
    device time including excluded runtime events) and
    ``bytes_coverage`` (fraction of named events carrying a bytes stat);
    over the profiler's events also ``lost_launches``, the launches its
    launch log holds and the trace lost (a warning when not 0).
    ``ledger`` (a `compiles.ledger_report()` dict) adds a ``programs``
    section: per family, cost-model arithmetic intensity and bound-by
    against the machine balance point."""
    global _LAST_CENSUS
    if events is None:
        from .. import profiler

        events = profiler.device_events()
    peak_gbs, peak_tflops = _roofs(device, peak_gbs, peak_tflops)
    rx_excl = re.compile(exclude) if exclude else None
    lane_pids = _device_lane_pids(events)
    from .. import profiler as _prof

    agg: dict = {}      # name -> [count, time_us, bytes, flops, bk, fk]
    total_us = 0.0      # ALL complete device-lane events, excluded or not
    for e in events:
        if e.get("ph") != "X":
            continue
        if lane_pids and e.get("pid") not in lane_pids:
            continue
        dur = float(e.get("dur", 0.0))
        total_us += dur
        name = str(e.get("name", "?"))
        if rx_excl is not None and rx_excl.search(name.lower()):
            continue
        row = agg.setdefault(name, [0, 0.0, 0, 0, 0, 0])
        row[0] += 1
        row[1] += dur
        b = _prof.event_stat_bytes(e)
        if b is not None:
            row[2] += b
            row[4] += 1
        fl = _prof.event_stat_flops(e)
        if fl is not None:
            row[3] += fl
            row[5] += 1
    rows = []
    for name, (n, us, nbytes, nflops, bk, fk) in agg.items():
        secs = us * 1e-6
        gbs = (nbytes / secs / 1e9) if secs > 0 and nbytes else None
        tfl = (nflops / secs / 1e12) if secs > 0 and nflops else None
        rows.append({
            "name": name, "count": n, "time_us": us,
            "bytes": nbytes, "flops": nflops,
            "bytes_known": bk, "flops_known": fk,
            "achieved_gbs": gbs, "achieved_tflops": tfl,
            "hbm_frac": (gbs / peak_gbs) if (gbs and peak_gbs) else None,
            "flops_frac": ((tfl / peak_tflops)
                           if (tfl and peak_tflops) else None),
            "bound_by": _bound_by(bk, gbs, tfl, peak_gbs, peak_tflops),
        })
    rows.sort(key=lambda r: -r["time_us"])
    named_us = sum(r["time_us"] for r in rows)
    named_ev = sum(r["count"] for r in rows)
    known_ev = sum(r["bytes_known"] for r in rows)
    meta = {
        "device": device, "peak_gbs": peak_gbs, "peak_tflops": peak_tflops,
        "total_device_us": total_us, "named_us": named_us,
        "n_kernels": len(rows),
        "attributed_frac": (named_us / total_us) if total_us > 0 else 0.0,
        "bytes_coverage": (known_ev / named_ev) if named_ev else 0.0,
    }
    tallies = [e.get("args") or {} for e in events if e.get("ph") == "M"
               and e.get("name") == _prof.LAUNCH_LOG_ROW]
    if tallies:
        meta["lost_launches"] = sum(int(a.get("lost_launches", 0))
                                    for a in tallies)
        if meta["lost_launches"]:
            logging.getLogger("incubator_mxnet_tpu_torch.telemetry").warning(
                "kernel census: the trace lost %d of the %d port-kernel "
                "launches its launch log holds; the counts and device time "
                "undercount (run the work once inside profiler.pause() "
                "before the profiled run)", meta["lost_launches"],
                sum(int(a.get("launch_log", 0)) for a in tallies))
    out = {"rows": rows, "programs": _join_ledger(
        ledger, peak_gbs, peak_tflops), "meta": meta}
    _LAST_CENSUS = dict(meta)
    _LAST_CENSUS["top"] = [
        {"name": r["name"], "time_us": r["time_us"],
         "bound_by": r["bound_by"]} for r in rows[:5]]
    return out


def _join_ledger(ledger, peak_gbs, peak_tflops):
    """Cost-model roofline placement per program-ledger family:
    arithmetic intensity (the entry's flops over its bytes_accessed) vs
    the machine balance point (peak FLOP/s over peak memory B/s)."""
    if not ledger:
        return {}
    balance = ((peak_tflops * 1e12) / (peak_gbs * 1e9)
               if peak_tflops and peak_gbs else None)
    progs = {}
    for fam, rec in ledger.items():
        if not isinstance(rec, dict):
            continue
        flops = rec.get("flops")
        nbytes = rec.get("bytes_accessed")
        ai = (flops / nbytes) if flops and nbytes else None
        bound = "unknown"
        if ai is not None and balance is not None:
            bound = "compute" if ai > balance else "memory"
        progs[fam] = {"flops": flops, "bytes_accessed": nbytes,
                      "arith_intensity": ai, "balance_flops_per_byte":
                      balance, "bound_by": bound,
                      "compiles": rec.get("compiles")}
    return progs


def from_profiler(**kwargs):
    """Census over the device trace captured by the last
    `profiler.stop()`."""
    return census(**kwargs)


def program_mfu(flops_per_execution, executions, device_seconds,
                peak_tflops=None, device=None):
    """Trace-measured MFU for one program family: cost-model FLOPs per
    execution x executions over measured device seconds, against the
    card's peak. Returns None when any input is missing — the honesty
    rule again: no trace, no MFU claim."""
    _, peak_tflops = _roofs(device, None, peak_tflops)
    if (not flops_per_execution or not executions or not device_seconds
            or device_seconds <= 0 or not peak_tflops):
        return None
    return (float(flops_per_execution) * executions
            / device_seconds / (peak_tflops * 1e12))


def top_bandwidth_bound(result, n=10):
    """The top-``n`` memory-bound kernels by device time — the
    optimization targets a fusion pass should chase. Kernels with
    unknown bytes are excluded (never ranked as fast OR as slow)."""
    return [r for r in result["rows"] if r["bound_by"] == "memory"][:n]


def _base_name(name):
    # strip the trailing instruction index ("fusion.123" -> "fusion") and a
    # kernel's template arguments and parameters ("k<float, 6>(...)" -> "k")
    return re.sub(r"\.\d+$", "", re.sub(r"[<(].*$", "", name))


def diff_census(before, after):
    """Fusion forensics between two censuses (or bare row lists): which
    kernel names appeared, vanished, split (same base name, more
    variants), or merged. The verdict calls the delta ``fused`` when
    names only vanished/merged, ``split`` when they only appeared/split,
    else ``mixed`` (``unchanged`` when nothing moved). Emits
    ``mx_kernel_fusion_delta{kind=}`` counters and parks the result for
    the flight-context block."""
    global _LAST_DIFF
    b_rows = before["rows"] if isinstance(before, dict) else before
    a_rows = after["rows"] if isinstance(after, dict) else after
    b_names = {r["name"] for r in b_rows}
    a_names = {r["name"] for r in a_rows}
    appeared = sorted(a_names - b_names)
    vanished = sorted(b_names - a_names)
    b_bases: dict = {}
    a_bases: dict = {}
    for n in b_names:
        b_bases[_base_name(n)] = b_bases.get(_base_name(n), 0) + 1
    for n in a_names:
        a_bases[_base_name(n)] = a_bases.get(_base_name(n), 0) + 1
    split = sorted(b for b in a_bases
                   if b in b_bases and a_bases[b] > b_bases[b])
    merged = sorted(b for b in b_bases
                    if b in a_bases and b_bases[b] > a_bases[b])
    t_before = sum(r["time_us"] for r in b_rows)
    t_after = sum(r["time_us"] for r in a_rows)
    if (vanished or merged) and not (appeared or split):
        verdict = "fused"
    elif (appeared or split) and not (vanished or merged):
        verdict = "split"
    elif vanished or merged or appeared or split:
        verdict = "mixed"
    else:
        verdict = "unchanged"
    diff = {"appeared": appeared, "vanished": vanished, "split": split,
            "merged": merged, "verdict": verdict,
            "time_before_us": t_before, "time_after_us": t_after,
            "time_delta_us": t_after - t_before}
    for kind, names in (("appeared", appeared), ("vanished", vanished),
                        ("split", split), ("merged", merged)):
        if names:
            registry.counter(
                "mx_kernel_fusion_delta",
                "kernel names changed between two census configs",
                labels={"kind": kind}).inc(len(names))
    _LAST_DIFF = diff
    return diff


def _fmt(v, unit="", nd=1):
    return "-" if v is None else f"{v:.{nd}f}{unit}"


def format_census(result, top=20):
    """Markdown top-``top`` kernel table of a `census()` result."""
    meta = result["meta"]
    lines = ["| kernel | n | time µs | GB/s | TFLOP/s | % HBM roof | "
             "bound by |",
             "|---|---:|---:|---:|---:|---:|---|"]
    for r in result["rows"][:top]:
        lines.append(
            f"| {r['name'][:48]} | {r['count']} | {r['time_us']:.1f} | "
            f"{_fmt(r['achieved_gbs'])} | {_fmt(r['achieved_tflops'], nd=2)}"
            f" | {_fmt(r['hbm_frac'] * 100 if r['hbm_frac'] is not None else None)}"
            f" | {r['bound_by']} |")
    lines.append("")
    lines.append(
        f"{meta['n_kernels']} kernels; "
        f"{meta['attributed_frac'] * 100:.1f}% of device time attributed "
        f"to named kernels; byte-stat coverage "
        f"{meta['bytes_coverage'] * 100:.0f}% of named events (kernels "
        "without a bytes stat read as *unknown*, never *fast*)")
    if meta.get("peak_gbs"):
        lines.append(f"roofs: {meta['peak_gbs']:.0f} GB/s HBM, "
                     f"{_fmt(meta.get('peak_tflops'), ' TFLOP/s bf16')} "
                     f"({meta.get('device') or 'explicit'})")
    for fam, p in (result.get("programs") or {}).items():
        lines.append(
            f"program `{fam}`: cost-model AI "
            f"{_fmt(p['arith_intensity'], ' flop/B')} vs balance "
            f"{_fmt(p['balance_flops_per_byte'], ' flop/B')} -> "
            f"{p['bound_by']}-bound")
    return "\n".join(lines)


def format_diff(diff):
    """Text rendering of a `diff_census()` result."""
    lines = [f"fusion delta: {diff['verdict']} "
             f"(device time {diff['time_before_us']:.1f} -> "
             f"{diff['time_after_us']:.1f} µs, "
             f"{diff['time_delta_us']:+.1f})"]
    for kind in ("appeared", "vanished", "split", "merged"):
        if diff[kind]:
            lines.append(f"  {kind}: {', '.join(diff[kind])}")
    return "\n".join(lines)


def last_census():
    return _LAST_CENSUS


def last_diff():
    return _LAST_DIFF


def _flight_probe():
    if _LAST_CENSUS is None and _LAST_DIFF is None:
        return None
    return {"census": _LAST_CENSUS, "fusion_delta": _LAST_DIFF}


def reset():
    global _LAST_CENSUS, _LAST_DIFF
    _LAST_CENSUS = None
    _LAST_DIFF = None


tracing.register_flight_context("kernels", _flight_probe)
