"""Profiler (port of `incubator_mxnet_tpu/profiler.py`: `set_config`,
`set_state`, `start`, `stop` :53-160, `pause`/`resume` :265-296,
`record_op` :298, `dump`/`dumps` :415-518, `Scope` :519, `device_events`
:244, `event_stat_bytes`/`event_stat_flops` :212-240, the memory
functions :341-414).

Two sources, merged at `dump()`, as in the reference:

- the host funnel: while the profiler runs, `record_op` times each
  `apply_op` dispatch (the funnel's `_PROFILER` seam): host time, since
  the card runs the op asynchronously;
- the device timeline: `start()` begins a ``torch.profiler`` trace
  (Kineto over CUPTI) of the card; `stop()` ends it and ingests its
  device lanes (`_ingest_trace`): the complete events of the kernels,
  copies and sets, their pids remapped clear of the host funnel's pid 0,
  their ``ts`` rebased onto the epoch-µs clock the spans use
  (`telemetry.tracing`), the work launched inside a paused interval
  dropped, and each port kernel's cost joined from the launch log
  (below) into the ``bytes_accessed`` and ``flops`` args the census and
  roofline read.

The launch log: while the device trace runs, each wrapper of the port's
kernels appends ``(kernel, bytes, flops)`` for every launch
(`ops._build.LAUNCH_LOG`), and each replay of a CUDA graph appends the
log of its capture, as one list (`_graphs.Graph`). Ingest joins the log
to the trace's port-kernel events in stream order, group by group (a
replay's kernels share its launch's correlation id; an eager launch is a
group of one): the longest run of groups from the start that agree
kernel for kernel, and the longest from the end. A group that does not
agree whole joins nothing: its events carry no cost and read *unknown*
in the census, never *fast*; ``trace_meta()`` says how many events
joined and which of the log's groups (``unjoined_groups``, the first 8)
did not. Launches the log holds and the trace lost
(``lost_launches``: the log's entries less the port-kernel events) ride
with the device events as an ``mx_launch_log`` metadata row, so that a
census of them says it undercounts (its ``meta["lost_launches"]``, and a
warning) rather than pass for a whole one.

A profiling session after the process's first loses the records of its
first kernels, eager launches and a graph's replay alike (`PERF.md` §7):
to hold a census whole, run the work once between `pause()` and
`resume()` first. The pause is judged by each kernel's launch call on
the host, which shares its clock, not by where the card's clock puts
the kernel.

A trace started on a machine with no CUDA device records the host lanes
only (the funnel and the spans): ``device_events()`` stays empty and
``trace_meta()`` says why; nothing pretends to be a device lane.
``profile_process="server"`` commands are queued and exchanged at the
next `KVStoreDist.barrier` (`sync_remote_commands`), which applies them
on every rank.

Memory goes through the caching allocator: `memory_stats` reads
``torch.cuda.memory_stats``, `live_buffer_table` and `analyze_memory`
its snapshot and peak counters, and `memory_snapshot` writes
``torch.cuda.memory._snapshot()``.
"""
from __future__ import annotations

import atexit
import bisect
import json
import os
import pickle
import re
import shutil
import sys
import tempfile
import threading
import time
from collections import defaultdict

__all__ = ["set_config", "set_state", "start", "stop", "dump", "dumps",
           "pause", "resume", "Scope", "profiler_scope", "device_events",
           "event_stat_bytes", "event_stat_flops",
           "memory_stats", "live_buffer_table", "memory_snapshot",
           "analyze_memory", "device_op_totals", "trace_meta", "is_running",
           "record_op", "sync_remote_commands"]

_CONFIG = {"filename": "profile.json", "profile_all": False,
           "profile_imperative": True, "aggregate_stats": True,
           "profile_device": True, "profile_memory": False}
_STATE = {"running": False, "device_tracing": False, "prof": None,
          "anchor_us": None, "log": None,
          "meta": {"device_lanes": [], "note": "no device trace yet"}}
_EVENTS: list = []
_DEVICE_EVENTS: list = []
_DEVICE_AGG = defaultdict(lambda: [0, 0.0])        # count, total_us
_AGG = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])  # count, total, min, max
_LOCK = threading.Lock()

# the categories of a torch.profiler trace's device work: kernels, copies
# and sets (the GPU lanes also carry annotation ranges, which are no work)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the host's launch calls (cudaLaunchKernel, cudaGraphLaunch, ...): one
# per correlation id, on the host's clock
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the lanes of the card in a torch.profiler trace: "GPU 0", ... (the
# process_labels rows)
_DEVICE_LANE = re.compile(r"^GPU \d+$")
# the port's kernels as their CUPTI names spell them: the launch log's
# kernel field is the first group
PORT_KERNEL = re.compile(
    r"(flash_fwd_kernel|flash_bwd_delta_kernel|flash_bwd_dq_kernel|"
    r"flash_bwd_dkv_kernel|ln_fwd_kernel|ln_bwd_kernel|"
    r"ln_partials_reduce_kernel|gelu_dropout_kernel|fold_keys_kernel|"
    r"int8_conv_kernel|int8_max_pool_kernel|int8_max_pool_nhwc_kernel|"
    r"(?<![A-Za-z0-9_])dropout_kernel)<?")
_ANCHOR = "mx_profiler_anchor"
#: the metadata row that carries the launch log's tally with the events
LAUNCH_LOG_ROW = "mx_launch_log"
_DEVICE_PID_BASE = 1000          # host funnel events own pid 0

_REMOTE_PENDING: list = []   # ('set_config', {...}) / ('set_state', 'run')


def set_config(**kwargs):
    """Update the profiler's configuration. ``profile_process="server"``
    also queues the config for every process of a distributed job: it is
    applied on each rank at the next kvstore sync point
    (`sync_remote_commands`)."""
    if kwargs.pop("profile_process", "worker") == "server":
        _REMOTE_PENDING.append(("set_config", dict(kwargs)))
    _CONFIG.update(kwargs)


def set_state(state="stop", profile_process="worker"):
    if profile_process == "server":
        _REMOTE_PENDING.append(("set_state", state))
    if state in ("run", "start"):
        start()
    else:
        stop()


def _dist_active():
    try:
        from .parallel import dist

        return dist.is_initialized() and dist.num_processes() > 1
    except Exception:
        return False


def sync_remote_commands():
    """Collective exchange and apply of the queued 'server' profiler
    commands — called from `KVStoreDist.barrier` (every process takes
    part; commands queued on ANY rank apply on ALL ranks, over
    `dist.exchange_objs`). One process has applied them already."""
    global _REMOTE_PENDING
    if not _dist_active():
        _REMOTE_PENDING = []
        return
    from .parallel import dist

    mine, _REMOTE_PENDING = _REMOTE_PENDING, []
    for cmds in dist.exchange_objs(mine):
        for kind, arg in cmds or []:
            if kind == "set_config":
                _CONFIG.update(arg)
            elif kind == "set_state":
                set_state(arg)


def _arm_funnel(on):
    """Point the funnel's profiler seam at this module (or clear it)."""
    from .ndarray import ndarray as nd_mod

    nd_mod._PROFILER = sys.modules[__name__] if on else None


def start(profile_process="worker"):  # noqa: ARG001
    """Start recording: the host funnel (with ``profile_imperative``) and,
    with ``profile_device`` and a CUDA device, the card's timeline and the
    launch log. Each start/stop cycle replaces the device timeline."""
    _STATE["running"] = True
    _arm_funnel(_CONFIG.get("profile_imperative", True))
    if not _CONFIG.get("profile_device", True) or _STATE["device_tracing"]:
        return
    with _LOCK:
        _DEVICE_EVENTS.clear()
        _DEVICE_AGG.clear()
    del _PAUSED_INTERVALS[:]
    import torch

    if not torch.cuda.is_available():
        _STATE["meta"] = {"device_lanes": [], "note": (
            "no CUDA device: the trace holds the host lanes only")}
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    from .ops import _build

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    # the clock anchor: a host annotation whose trace ts is the epoch µs
    # read beside it
    with record_function(_ANCHOR):
        _STATE["anchor_us"] = time.time() * 1e6
    _STATE["prof"] = prof
    _STATE["log"] = _build.LAUNCH_LOG = []
    _STATE["device_tracing"] = True


def stop(profile_process="worker"):  # noqa: ARG001
    """Stop recording; ingest the device timeline when one was traced."""
    _STATE["running"] = False
    _arm_funnel(False)
    if not _STATE.get("device_tracing"):
        return
    import torch

    from .ops import _build

    prof, log = _STATE["prof"], _STATE["log"]
    _STATE.update(device_tracing=False, prof=None, log=None)
    _build.LAUNCH_LOG = None
    tmp = tempfile.mkdtemp(prefix="mx_torch_prof_")
    try:
        torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
        _ingest_trace(data, log or [], anchor_us=_STATE["anchor_us"])
    except Exception as e:
        from .fault.retry import suppressed

        suppressed("profiler.stop", e)      # the device trace is lost
        _STATE["meta"] = {"device_lanes": [],
                          "note": f"the device trace was lost: {e}"}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _device_lanes(events):
    """{pid: lane name} of the card's lanes that hold device work: a
    torch.profiler trace names a card's lane in its ``process_labels``
    row ("GPU 0"; its ``process_name`` is the program's); a lane with
    device work and no such row is named after its pid."""
    busy = {e.get("pid") for e in events
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS}
    lanes = {}
    for e in events:
        if e.get("ph") == "M" and e.get("pid") in busy:
            args = e.get("args") or {}
            label = str(args.get("labels", args.get("name", "")))
            if e.get("name") in ("process_labels", "process_name") \
                    and _DEVICE_LANE.match(label):
                lanes[e["pid"]] = label
    for pid in busy:
        lanes.setdefault(pid, f"GPU {pid}")
    return lanes


def _anchor_offset(events, anchor_us):
    """µs to add to the trace's ts to land on the epoch clock: the anchor
    annotation's epoch time less its trace time (0 without one)."""
    if anchor_us is None:
        return 0.0
    for e in events:
        if e.get("name") == _ANCHOR and e.get("ph") == "X":
            return float(anchor_us) - float(e["ts"])
    return 0.0


def _groups(items):
    """The launch log's groups: a graph replay's entries (a list) are one
    group, an eager launch's entry a group of its own."""
    return [list(it) if isinstance(it, list) else [it] for it in items]


def _event_groups(kernel_events):
    """The port-kernel events (in stream order) grouped as the log is: a
    graph replay's kernels share the correlation id of its launch; an
    eager launch has one of its own (an event with none is its own
    group). Returns lists of indices into kernel_events."""
    groups, where = [], {}
    for i, e in enumerate(kernel_events):
        corr = (e.get("args") or {}).get("correlation")
        if corr is None or corr not in where:
            if corr is not None:
                where[corr] = len(groups)
            groups.append([i])
        else:
            groups[where[corr]].append(i)
    return groups


def join_launch_log(kernel_events, log):
    """Join the launch log (its groups: `_groups`) to the port-kernel
    events (their groups: `_event_groups`), both in stream order: the
    longest run of groups from the start whose kernels agree one for one,
    then the longest such run from the end. A group that does not agree
    whole (a replay that lost a record) joins nothing, so no cost lands
    on the wrong event. Returns ({index into kernel_events: log entry},
    [indices of the log's groups left out])."""
    def agrees(idx, group):
        names = [PORT_KERNEL.search(kernel_events[i].get("name", ""))
                 for i in idx]
        return len(idx) == len(group) and all(
            m is not None and m.group(1) == entry[0]
            for m, entry in zip(names, group))

    ev, lg = _event_groups(kernel_events), _groups(log)
    n, k = len(ev), len(lg)
    pairs = []
    i = 0
    while i < min(n, k) and agrees(ev[i], lg[i]):
        pairs.append((ev[i], lg[i]))
        i += 1
    j = 0
    while j < min(n, k) - i and agrees(ev[n - 1 - j], lg[k - 1 - j]):
        pairs.append((ev[n - 1 - j], lg[k - 1 - j]))
        j += 1
    joined = {e: entry for idx, group in pairs
              for e, entry in zip(idx, group)}
    return joined, list(range(i, k - j))


def _launched_at(events):
    """{correlation id: (ts, end) of the host's launch call} of a trace."""
    out = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("ph") == "X" \
                and e.get("cat") in _LAUNCH_CATS:
            ts = float(e["ts"])
            out[corr] = (ts, ts + float(e.get("dur", 0.0)))
    return out


def _device_shift(events, work, launched):
    """µs to move the device lanes on (negative: back) so that their clock,
    as the trace converts it to the host's, obeys the host's calls: no
    work starts before the call that launched it, and no work the host
    waited for ends after the call that waited returns — a copy to
    pageable host memory (its call returns once the copy is done) and
    everything launched before a ``cudaDeviceSynchronize``. Returns (the
    shift nearest 0 that obeys both, the µs by which the two bounds
    disagree, 0 when they agree); where they disagree (the conversion is
    not one offset across the trace) the shift splits the disagreement,
    so that each bound is missed by half of it."""
    hi = float("inf")
    lo = max([launched[c][0] - float(e["ts"]) for e in work
              for c in [(e.get("args") or {}).get("correlation")]
              if c in launched] + [float("-inf")])
    syncs = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in _LAUNCH_CATS
                   and e.get("name") == "cudaDeviceSynchronize")
    starts = [s for s, _ in syncs]
    first_end = [float("inf")] * (len(syncs) + 1)   # earliest return of a
    for i in range(len(syncs) - 1, -1, -1):          # sync from i on
        first_end[i] = min(first_end[i + 1], syncs[i][1])
    for e in work:
        call = launched.get((e.get("args") or {}).get("correlation"))
        if call is None:
            continue
        end = float(e["ts"]) + float(e.get("dur", 0.0))
        waited = first_end[bisect.bisect_left(starts, call[1])]
        if "DtoH" in e.get("name", "") and "Pageable" in e.get("name", ""):
            waited = min(waited, call[1])
        hi = min(hi, waited - end)
    if lo > hi:
        return (lo + hi) / 2, lo - hi
    return min(max(0.0, lo), hi), 0.0


def _ingest_trace(data, log, anchor_us=None):
    """Keep the device lanes' complete events of a torch.profiler chrome
    trace (``data``), with their lane metadata rows, pids remapped to
    1000 + pid, ts rebased onto the epoch clock (and moved as far as
    the card's clock puts work outside its host calls: `_device_shift`,
    its shift and the bounds' disagreement in the meta), the work
    launched inside
    a paused interval dropped (by the host's launch call, which shares
    the pause's clock, where the trace holds it, else by the event's own
    ts; before the join: the log is off there too), and the launch log
    ``log`` joined onto the port's kernels (``bytes_accessed``, ``flops``
    args; ``correlation`` kept: a graph replay's kernels share their
    launch's); the log's tally as a `LAUNCH_LOG_ROW` metadata row;
    aggregate per-name device totals."""
    events = data.get("traceEvents", [])
    lanes = _device_lanes(events)
    shift = _anchor_offset(events, anchor_us)
    work = sorted((e for e in events
                   if e.get("ph") == "X" and e.get("pid") in lanes
                   and e.get("cat") in _DEVICE_CATS),
                  key=lambda e: float(e.get("ts", 0.0)))
    n_work = len(work)
    launched = _launched_at(events)
    if _PAUSED_INTERVALS:
        work = [e for e in work if not _in_paused_interval(
            shift + launched.get((e.get("args") or {}).get("correlation"),
                                 (float(e["ts"]),))[0])]
    dropped = n_work - len(work)
    # the card's clock, as the trace converts it to the host's, can put a
    # kernel before the host call that launched it (by up to ~2 ms on the
    # card), or a copy after the call that waited for it: the device lanes
    # are moved by the least that puts every event between its bounds
    dev_shift, clock_conflict = _device_shift(events, work, launched)
    shift_dev = shift + dev_shift
    ports = [e for e in work if PORT_KERNEL.search(e.get("name", ""))]
    joined, unjoined = join_launch_log(ports, log)
    cost = {id(ports[i]): entry for i, entry in joined.items()}
    n_log = sum(len(g) for g in _groups(log))
    lost = max(0, n_log - len(ports))
    kept = [{"name": "process_name", "ph": "M",
             "pid": _DEVICE_PID_BASE + int(pid), "args": {"name": name}}
            for pid, name in sorted(lanes.items())]
    if lanes:
        kept.append({"name": LAUNCH_LOG_ROW, "ph": "M",
                     "pid": _DEVICE_PID_BASE + int(min(lanes)),
                     "args": {"launch_log": n_log,
                              "port_kernel_events": len(ports),
                              "lost_launches": lost}})
    for e in events:
        if e.get("ph") == "M" and e.get("pid") in lanes \
                and e.get("name") == "thread_name":
            m = dict(e)
            m["pid"] = _DEVICE_PID_BASE + int(e["pid"])
            m.pop("ts", None)
            kept.append(m)
    for e in work:
        ts = float(e["ts"]) + shift_dev
        corr = (e.get("args") or {}).get("correlation")
        k = {"name": e.get("name", "?"), "ph": "X",
             "pid": _DEVICE_PID_BASE + int(e["pid"]), "tid": e.get("tid", 0),
             "ts": ts, "dur": float(e.get("dur", 0.0)), "cat": e.get("cat"),
             "args": {} if corr is None else {"correlation": corr}}
        entry = cost.get(id(e))
        if entry is not None:
            _kernel, nbytes, flops = entry
            if nbytes is not None:
                k["args"]["bytes_accessed"] = int(nbytes)
            if flops is not None:
                k["args"]["flops"] = int(flops)
        kept.append(k)
    with _LOCK:
        _DEVICE_EVENTS.extend(kept)
        for e in kept:
            if e["ph"] == "X":
                agg = _DEVICE_AGG[e["name"]]
                agg[0] += 1
                agg[1] += e["dur"]
    _STATE["meta"] = {
        "device_lanes": sorted(set(lanes.values())),
        "events": len(work), "paused_dropped": dropped,
        "port_kernel_events": len(ports), "launch_log": n_log,
        "lost_launches": lost, "joined": len(joined),
        "unjoined_groups": unjoined[:8],
        "device_shift_us": dev_shift, "clock_conflict_us": clock_conflict,
        "note": ("device lanes from torch.profiler (CUPTI)" if lanes
                 else "the trace held no device lane")}


def event_stat_bytes(e):
    """Bytes accessed by one trace event, from its args, or None when the
    trace carries no byte accounting for it (the one extraction path of
    `telemetry.roofline` and `telemetry.kernels`)."""
    args = e.get("args") or {}
    for k, v in args.items():
        lk = k.lower()
        if "bytes" in lk and ("access" in lk or lk == "bytes"):
            try:
                return int(float(v))
            except (TypeError, ValueError):
                continue
    return None


def event_stat_flops(e):
    """FLOPs of one trace event (``flops`` / ``model_flops`` /
    ``device_flops`` / ``estimated_flops`` spellings), or None."""
    args = e.get("args") or {}
    for k, v in args.items():
        lk = k.lower().replace(" ", "_")
        if lk in ("flops", "model_flops", "device_flops",
                  "estimated_flops"):
            try:
                return int(float(v))
            except (TypeError, ValueError):
                continue
    return None


def device_events():
    """The device-timeline events of the last stop() (Chrome events on the
    spans' epoch-µs clock; empty before any device trace completes, and on
    a machine with no CUDA device). A port kernel's event carries its
    launch's ``bytes_accessed`` and ``flops`` args."""
    with _LOCK:
        return list(_DEVICE_EVENTS)


def device_op_totals():
    """{kernel name: (count, total_us)} of the device lanes."""
    with _LOCK:
        return {k: (v[0], v[1]) for k, v in _DEVICE_AGG.items()}


def trace_meta():
    """What the last device trace held: its lanes, its events, the launch
    log's length and how many of its entries joined a kernel event (or
    why there are no device lanes)."""
    return dict(_STATE["meta"])


_PAUSED_INTERVALS: list = []   # [start_us, end_us|None] epoch-µs, host clock


def pause(profile_process="worker"):  # noqa: ARG001
    """Stop host-side op recording and the launch log, and mark the
    paused interval: the device trace keeps recording, and ingest drops
    its events inside the interval."""
    from .ops import _build

    _STATE["running"] = False
    _arm_funnel(False)
    _build.LAUNCH_LOG = None
    _PAUSED_INTERVALS.append([time.time() * 1e6, None])


def resume(profile_process="worker"):  # noqa: ARG001
    """Resume host-side op recording (and the launch log) and close the
    paused interval."""
    from .ops import _build

    _STATE["running"] = True
    _arm_funnel(_CONFIG.get("profile_imperative", True))
    if _STATE.get("device_tracing"):
        _build.LAUNCH_LOG = _STATE["log"]
    if _PAUSED_INTERVALS and _PAUSED_INTERVALS[-1][1] is None:
        _PAUSED_INTERVALS[-1][1] = time.time() * 1e6


def _in_paused_interval(ts_us):
    for start_us, end_us in _PAUSED_INTERVALS:
        if ts_us >= start_us and (end_us is None or ts_us <= end_us):
            return True
    return False


def is_running():
    return _STATE["running"]


def record_op(name, dur_s):
    """Called from the op funnel while profiling."""
    mem = None
    if _CONFIG.get("profile_memory"):
        mem = _live_bytes()
    with _LOCK:
        _EVENTS.append({"name": name, "ph": "X", "pid": 0, "tid": 0,
                        "ts": time.time() * 1e6, "dur": dur_s * 1e6})
        agg = _AGG[name]
        agg[0] += 1
        agg[1] += dur_s
        agg[2] = min(agg[2], dur_s)
        agg[3] = max(agg[3], dur_s)
        if mem is not None:
            m = _MEM_AGG[name]
            m[0] = max(m[0], mem)
            if mem > _MEM_STATE["peak"]:
                _MEM_STATE["peak"] = mem
                _MEM_STATE["peak_op"] = name


# ---------------------------------------------------------------------------
# memory (reference: the storage profiler's roles)
# ---------------------------------------------------------------------------

_MEM_AGG = defaultdict(lambda: [0])                 # peak live bytes at op
_MEM_STATE = {"peak": 0, "peak_op": None}


def _on_card():
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _live_bytes():
    """Bytes in use: the caching allocator's on the card, else the live
    CPU tensors' (`telemetry.hbm`'s sweep)."""
    import torch

    if _on_card():
        return int(sum(torch.cuda.memory_allocated(d)
                       for d in range(torch.cuda.device_count())))
    from .telemetry import hbm

    return int(hbm.census(top_k=0)["total"])


def memory_stats(device=None):
    """Per-device memory statistics: ``bytes_in_use`` and
    ``peak_bytes_in_use`` of the caching allocator on each CUDA device
    (plus its other counters), or, with no CUDA device in use, of the
    live CPU tensors (``source: "live_tensors"``)."""
    import torch

    out = {}
    if _on_card():
        devices = ([torch.device(device)] if device is not None else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
        for d in devices:
            st = torch.cuda.memory_stats(d)
            stats = {"bytes_in_use": int(st.get(
                         "allocated_bytes.all.current", 0)),
                     "peak_bytes_in_use": int(st.get(
                         "allocated_bytes.all.peak", 0)),
                     "bytes_reserved": int(st.get(
                         "reserved_bytes.all.current", 0)),
                     "num_allocs": int(st.get("allocation.all.current", 0)),
                     "source": "caching_allocator"}
            out[str(d)] = stats
        return out
    live = _live_bytes()
    out["cpu"] = {"bytes_in_use": live, "peak_bytes_in_use": live,
                  "source": "live_tensors"}
    return out


def live_buffer_table(top=20):
    """The largest live device buffers, ``(shape, dtype, bytes)``: the
    caching allocator's active blocks on the card (the shape is the
    block's size as a flat byte count, the dtype "?"; an allocation
    knows no tensor), else the live CPU tensors."""
    from .telemetry import hbm

    rows = [(tuple(r["shape"]) if r["shape"] is not None
             else (r["bytes"],), str(r["dtype"]), int(r["bytes"]))
            for r in hbm.census(top_k=top).get("top", ())]
    rows.sort(key=lambda r: -r[2])
    return rows[:top]


def memory_snapshot(path="memory.prof"):
    """Write the caching allocator's snapshot
    (``torch.cuda.memory._snapshot()``, pickled; it loads in PyTorch's
    memory viewer) and return the path. With no CUDA device in use, the
    snapshot is of the live CPU tensors (`telemetry.hbm.census`)."""
    import torch

    if _on_card():
        snap = torch.cuda.memory._snapshot()
    else:
        from .telemetry import hbm

        snap = {"segments": [], "device_traces": [],
                "cpu_census": hbm.census(top_k=64)}
    with open(path, "wb") as f:
        pickle.dump(snap, f)
    return path


def analyze_memory(fn, *args, static_argnums=None):  # noqa: ARG001
    """Run ``fn(*args)`` once and return its memory plan as the caching
    allocator saw it: ``argument_size_in_bytes`` (the tensor arguments),
    ``output_size_in_bytes`` (the tensor outputs), ``temp_size_in_bytes``
    (the peak above the arguments during the call, less the outputs),
    ``alias_size_in_bytes`` (outputs that are arguments) and
    ``generated_code_size_in_bytes`` (0: eager torch builds no program).
    The reference asks XLA's compiler without running; the port has no
    compiler to ask, so it runs the function. On a CPU tensor (no
    allocator statistics) it returns None."""
    import torch

    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = next((t.device for t in tensors if t.device.type == "cuda"), None)
    if dev is None:
        return None
    arg_bytes = sum(t.untyped_storage().nbytes() for t in tensors)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    outs = [out] if isinstance(out, torch.Tensor) else [
        o for o in (out if isinstance(out, (tuple, list)) else ())
        if isinstance(o, torch.Tensor)]
    ptrs = {t.untyped_storage().data_ptr() for t in tensors}
    alias = sum(o.untyped_storage().nbytes() for o in outs
                if o.untyped_storage().data_ptr() in ptrs)
    out_bytes = sum(o.untyped_storage().nbytes() for o in outs) - alias
    return {"argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(max(0, peak - base - out_bytes)),
            "alias_size_in_bytes": int(alias),
            "generated_code_size_in_bytes": 0}


def dump(finished=True, profile_process="worker"):  # noqa: ARG001
    """Write one chrome://tracing JSON holding the host dispatch lane
    (pid 0), the device lanes of the last trace (pid 1000 + the card's
    index) and, when span tracing is armed, the request and step spans
    (`telemetry.tracing`), all on the epoch-µs clock."""
    path = _CONFIG["filename"]
    with _LOCK:
        merged = [{"name": "process_name", "ph": "M", "pid": 0,
                   "args": {"name": "host: op dispatch"}}]
        merged += list(_EVENTS)
        merged += list(_DEVICE_EVENTS)
    from .telemetry import tracing

    if tracing.is_enabled():
        merged += tracing.chrome_events()
    payload = {"traceEvents": merged, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def dumps(reset=False, format="table", sort_by="total", ascending=False,
          memory=False):
    """Aggregate per-op stats: the host dispatch table, then the device
    table when a trace was captured; ``memory=True`` appends the memory
    section. ``format="json"`` returns the same aggregates as JSON."""
    if format not in ("table", "json"):
        raise ValueError(f"format must be 'table' or 'json', got {format!r}")
    with _LOCK:
        rows = [(name, c, tot * 1000, mn * 1000, mx * 1000)
                for name, (c, tot, mn, mx) in _AGG.items()]
        dev_rows = [(name, c, tot_us / 1000.0)
                    for name, (c, tot_us) in _DEVICE_AGG.items()]
        mem_rows = [(name, peak[0]) for name, peak in _MEM_AGG.items()]
        mem_peak = dict(_MEM_STATE)
        if reset:
            _AGG.clear()
            _EVENTS.clear()
            _DEVICE_AGG.clear()
            _DEVICE_EVENTS.clear()
            _MEM_AGG.clear()
            _MEM_STATE.update(peak=0, peak_op=None)
    key = {"total": 2, "count": 1, "min": 3, "max": 4}.get(sort_by, 2)
    rows.sort(key=lambda r: r[key], reverse=not ascending)
    if format == "json":
        payload = {
            "host": [{"name": n, "count": c, "total_ms": tot, "min_ms": mn,
                      "max_ms": mx} for n, c, tot, mn, mx in rows],
            "device": sorted(
                ({"name": n, "count": c, "total_ms": tot}
                 for n, c, tot in dev_rows),
                key=lambda r: r["total_ms"], reverse=not ascending),
        }
        if memory:
            payload["memory"] = {
                "devices": memory_stats(),
                "observed_peak": mem_peak,
                "op_peak_live_bytes": {n: p for n, p in mem_rows},
                "largest_live_buffers": [
                    {"shape": list(shape), "dtype": dtype, "nbytes": nb}
                    for shape, dtype, nb in live_buffer_table(10)],
            }
        return json.dumps(payload)
    lines = [f"{'Name':<40}{'Count':>8}{'Total(ms)':>12}{'Min(ms)':>10}"
             f"{'Max(ms)':>10}", "=" * 80]
    for name, c, tot, mn, mx in rows:
        lines.append(f"{name[:39]:<40}{c:>8}{tot:>12.3f}{mn:>10.3f}{mx:>10.3f}")
    if dev_rows:
        dev_rows.sort(key=lambda r: r[2], reverse=not ascending)
        lines += ["", f"{'Device op':<48}{'Count':>8}{'Total(ms)':>12}",
                  "=" * 80]
        for name, c, tot in dev_rows:
            lines.append(f"{name[:47]:<48}{c:>8}{tot:>12.3f}")
    if memory:
        lines += ["", "Memory", "=" * 80]
        for dev, st in memory_stats().items():
            in_use = st.get("bytes_in_use", 0)
            peak = st.get("peak_bytes_in_use", in_use)
            lines.append(f"{dev:<40}{in_use / 2**20:>14.2f} MiB in use"
                         f"{peak / 2**20:>14.2f} MiB peak")
        if mem_peak["peak"]:
            lines.append(
                f"observed live-bytes peak: {mem_peak['peak'] / 2**20:.2f} "
                f"MiB at op {mem_peak['peak_op']}")
            mem_rows.sort(key=lambda r: -r[1])
            lines += ["", f"{'Op (peak live bytes at dispatch)':<48}"
                          f"{'MiB':>12}", "-" * 60]
            for name, peak_b in mem_rows[:15]:
                lines.append(f"{name[:47]:<48}{peak_b / 2**20:>12.2f}")
        lines += ["", f"{'Largest live buffers':<40}{'dtype':>10}"
                      f"{'MiB':>12}", "-" * 62]
        for shape, dtype, nbytes in live_buffer_table(10):
            lines.append(f"{str(shape)[:39]:<40}{dtype:>10}"
                         f"{nbytes / 2**20:>12.2f}")
    return "\n".join(lines)


class Scope:
    """RAII profiling scope (ProfileTask/ProfileEvent parity)."""

    def __init__(self, name="<unk>:"):
        self.name = name
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _STATE["running"]:
            record_op(self.name, time.perf_counter() - self._t0)
        return False


profiler_scope = Scope

if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") == "1":
    # MXNET_PROFILER_MODE: 0 = device only (no per-op host timing), 1 = all
    if os.environ.get("MXNET_PROFILER_MODE", "0") != "1":
        set_config(profile_imperative=False)
    start()
    atexit.register(dump)
