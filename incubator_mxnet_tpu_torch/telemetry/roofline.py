"""Roofline analyzer: bytes moved against device time against the card's
memory rate, per step phase (port of
`incubator_mxnet_tpu/telemetry/roofline.py`: `analyze`, `format_table`,
`write_report`, `from_profiler`).

Inputs:

- ``trace_events``: Chrome events as `profiler.device_events()` returns
  them: the complete (``ph == "X"``) events of the card's lanes (a
  torch.profiler trace names them ``GPU <n>``; the reference's
  ``/device:`` and ``/host:`` lanes are read too), plus their
  ``process_name`` metadata rows;
- ``mem_analysis``: optional `profiler.analyze_memory()` dict for the
  step: its argument/output/temp bytes give the program-level traffic
  the per-event numbers are checked against.

An event's bytes come from its ``bytes_accessed`` arg (the profiler joins
the port kernels' costs from the launch log); events without one (cuBLAS,
cuDNN and torch's own kernels, copies) contribute device time only, and
the report states the coverage, so a thin trace reads as *unknown*, not
as *fast*.

The phases classify CUDA kernel names (`DEFAULT_PHASES`, first match
wins): cuBLAS's and CUTLASS's GEMMs and cuDNN's convolutions are
matmul/conv; K1/K2 attention; K3/K4/K4b and torch's ``reduce_kernel``
norm/reduce; K5, K6 and the fold rng/dropout; copies, sets and torch's
``direct_copy`` copy/layout; torch's ``elementwise_kernel``
fusion/elementwise. The copy and elementwise rules for torch's names
come first, since its templated names hold words ("mul", "copy",
"add") that the generic rules match; after them the reference's rules
classify the names they always did.
"""
from __future__ import annotations

import re

__all__ = ["analyze", "format_table", "write_report", "from_profiler",
           "PEAK_HBM_GBS", "DEFAULT_PHASES"]

# peak device-memory rate per card, GB/s, keyed by the lower-cased name
# nvidia-smi gives (NVIDIA's data sheet, the rate `PERF.md`'s bounds use;
# pass peak_gbs= explicitly for other parts). The CPU has no such roof:
# peak_fraction is omitted there.
PEAK_HBM_GBS = {"nvidia h100 80gb hbm3": 3350.0}

# events that are tracing/runtime infrastructure, not device work: the
# reference's XLA runtime lanes carry Python frames ("$file:line fn"),
# thunk-executor and pjit wrappers; a torch.profiler card lane carries
# none of them. Excluded by default so the "other" phase means
# *unclassified kernels*, not *the interpreter*.
DEFAULT_EXCLUDE = (r"^\$|^thunkexecutor|^pjitfunction|^xlamodule|"
                   r"^tsl::|^proces|^program_interpreter")

# phase classification by kernel-name pattern, first match wins: torch's
# templated copy and elementwise kernels first (their names hold "copy",
# "mul", "add"), the port's and the libraries' kernels next, then the
# reference's rules
DEFAULT_PHASES = (
    ("copy/layout", r"^memcpy|^memset|direct_copy|catarraybatchedcopy"),
    ("matmul/conv", r"dot|conv|einsum|gemm|mxu|nvjet|xmma|cutlass|cudnn|"
                    r"implicit_gemm|wgrad|dgrad|fprop"),
    ("attention", r"attention|softmax|flash"),
    ("norm/reduce", r"norm|reduce|variance|ln_fwd|ln_bwd|ln_partials"),
    ("rng/dropout", r"rng|dropout|random|threefry|philox|fold_keys"),
    ("fusion/elementwise", r"elementwise_kernel|multi_tensor_apply"),
    ("copy/layout", r"copy|transpose|bitcast|reshape|broadcast|concat|"
                    r"slice|pad|gather|scatter|tuple"),
    ("collectives", r"all-reduce|all-gather|reduce-scatter|collective|"
                    r"permute|nccl"),
    ("infeed/outfeed", r"infeed|outfeed|transfer"),
    ("fusion/elementwise", r"fusion|add|sub|mul|div|tanh|exp|log|gelu|"
                           r"relu|max|min|select|compare|convert"),
)


#: lane names that hold device work: torch.profiler's cards ("GPU 0"),
#: and the reference's XLA lanes
DEVICE_LANES = ("GPU ", "/device:", "/host:")


def _device_lane_pids(events):
    """pids of the device lanes (from process_name metadata rows). Empty
    when the trace carries no metadata (synthetic fixtures): then every
    complete event is taken."""
    pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            lane = e.get("args", {}).get("name", "")
            if lane.startswith(DEVICE_LANES):
                pids.add(e["pid"])
    return pids


def _event_bytes(e):
    """bytes accessed by one device event, or None when the trace has no
    byte accounting for it: `profiler.event_stat_bytes`, the one
    extraction path shared with `telemetry.kernels`."""
    from .. import profiler

    return profiler.event_stat_bytes(e)


_WARNED_DEVICES: set = set()


def _warn_unknown_device(device):
    """One warning per unknown device name: peak_fraction silently
    missing from every row looks like a data bug, not a lookup miss."""
    key = device.lower()
    if key in _WARNED_DEVICES:
        return
    _WARNED_DEVICES.add(key)
    import logging

    logging.getLogger("incubator_mxnet_tpu_torch.telemetry.roofline").warning(
        "roofline: no PEAK_HBM_GBS entry for device %r — peak_fraction "
        "will be omitted; known devices: %s (pass peak_gbs= explicitly "
        "to override)", device, ", ".join(sorted(PEAK_HBM_GBS)))


def _classify(name, compiled_phases):
    low = name.lower()
    for phase, rx in compiled_phases:
        if rx.search(low):
            return phase
    return "other"


def analyze(trace_events, mem_analysis=None, phases=None, peak_gbs=None,
            device=None, exclude=DEFAULT_EXCLUDE):
    """Per-phase roofline table.

    Returns ``{"rows": [...], "total": {...}, "meta": {...}}`` where each
    row is ``{phase, events, time_us, bytes, bytes_known_events,
    achieved_gbs, peak_fraction}``. ``achieved_gbs`` divides known bytes
    by that phase's FULL device time, so missing byte stats bias the
    number LOW (conservative for a "we are at the bandwidth floor"
    claim). ``peak_fraction`` needs ``peak_gbs`` (or a ``device`` key of
    `PEAK_HBM_GBS`, the card's nvidia-smi name). ``exclude`` drops
    runtime/interpreter events (`DEFAULT_EXCLUDE`; pass None to keep
    everything)."""
    if peak_gbs is None and device is not None:
        peak_gbs = PEAK_HBM_GBS.get(str(device).lower())
        if peak_gbs is None:
            _warn_unknown_device(str(device))
    compiled = [(p, re.compile(rx)) for p, rx in (phases or DEFAULT_PHASES)]
    rx_excl = re.compile(exclude) if exclude else None
    lane_pids = _device_lane_pids(trace_events)
    agg = {}                     # phase -> [events, time_us, bytes, known]
    for e in trace_events:
        if e.get("ph") != "X":
            continue
        if lane_pids and e.get("pid") not in lane_pids:
            continue
        name = str(e.get("name", "?"))
        if rx_excl is not None and rx_excl.search(name.lower()):
            continue
        phase = _classify(name, compiled)
        row = agg.setdefault(phase, [0, 0.0, 0, 0])
        row[0] += 1
        row[1] += float(e.get("dur", 0.0))
        b = _event_bytes(e)
        if b is not None:
            row[2] += b
            row[3] += 1
    rows = []
    for phase, (n, us, nbytes, known) in agg.items():
        gbs = (nbytes / (us * 1e-6) / 1e9) if us > 0 and nbytes else 0.0
        rows.append({
            "phase": phase, "events": n, "time_us": us, "bytes": nbytes,
            "bytes_known_events": known, "achieved_gbs": gbs,
            "peak_fraction": (gbs / peak_gbs) if peak_gbs else None,
        })
    rows.sort(key=lambda r: -r["time_us"])
    tot_us = sum(r["time_us"] for r in rows)
    tot_b = sum(r["bytes"] for r in rows)
    tot_ev = sum(r["events"] for r in rows)
    tot_known = sum(r["bytes_known_events"] for r in rows)
    tot_gbs = (tot_b / (tot_us * 1e-6) / 1e9) if tot_us > 0 and tot_b else 0.0
    total = {"phase": "total", "events": tot_ev, "time_us": tot_us,
             "bytes": tot_b, "bytes_known_events": tot_known,
             "achieved_gbs": tot_gbs,
             "peak_fraction": (tot_gbs / peak_gbs) if peak_gbs else None}
    meta = {"peak_gbs": peak_gbs, "device": device,
            "bytes_coverage": (tot_known / tot_ev) if tot_ev else 0.0}
    if mem_analysis:
        meta["program_bytes"] = (
            mem_analysis.get("argument_size_in_bytes", 0)
            + mem_analysis.get("output_size_in_bytes", 0)
            + mem_analysis.get("temp_size_in_bytes", 0))
    return {"rows": rows, "total": total, "meta": meta}


def from_profiler(mem_analysis=None, **kwargs):
    """Analyze the device trace captured by the last `profiler.stop()`."""
    from .. import profiler

    return analyze(profiler.device_events(), mem_analysis=mem_analysis,
                   **kwargs)


def _fmt_bytes(n):
    if n >= 2**30:
        return f"{n / 2**30:.2f} GiB"
    if n >= 2**20:
        return f"{n / 2**20:.2f} MiB"
    if n >= 2**10:
        return f"{n / 2**10:.1f} KiB"
    return f"{n} B"


def format_table(analysis):
    """Markdown per-phase table of an `analyze()` result."""
    meta = analysis["meta"]
    has_peak = meta.get("peak_gbs") is not None
    hdr = "| phase | events | time µs | bytes | GB/s"
    sep = "|---|---:|---:|---:|---:"
    if has_peak:
        hdr += " | % of peak"
        sep += "|---:"
    lines = [hdr + " |", sep + "|"]
    for r in list(analysis["rows"]) + [analysis["total"]]:
        bold = "**" if r["phase"] == "total" else ""
        line = (f"| {bold}{r['phase']}{bold} | {r['events']} | "
                f"{r['time_us']:.1f} | {_fmt_bytes(r['bytes'])} | "
                f"{r['achieved_gbs']:.1f}")
        if has_peak:
            pf = r["peak_fraction"]
            line += f" | {pf * 100:.1f}%" if pf is not None else " | -"
        lines.append(line + " |")
    cov = meta.get("bytes_coverage", 0.0)
    lines.append("")
    lines.append(f"byte-stat coverage: {cov * 100:.0f}% of device events "
                 "(events without a bytes stat contribute time "
                 "only, biasing GB/s low)")
    if has_peak:
        lines.append(f"peak memory rate assumed: {meta['peak_gbs']:.0f} "
                     f"GB/s ({meta.get('device') or 'explicit'})")
    if "program_bytes" in meta:
        lines.append("program-level traffic (analyze_memory, "
                     "arg+out+temp): " + _fmt_bytes(meta["program_bytes"]))
    return "\n".join(lines)


def write_report(path, analysis, title, notes=()):
    """Commit an `analyze()` result as a markdown artifact."""
    parts = [f"# {title}", "", format_table(analysis), ""]
    for n in notes:
        parts.append(f"- {n}")
    with open(path, "w") as f:
        f.write("\n".join(parts) + "\n")
    return path
