"""Fleet observability: the cross-rank telemetry plane (port of
`incubator_mxnet_tpu/telemetry/fleet.py`).

One slow rank sets the step time for every rank; this module is the
cross-rank counterpart of `registry` and `tracing`:

- **collective profiler** — `parallel.dist`'s host-level collectives
  (`allreduce`, `broadcast`, `barrier`, `exchange_objs`) are wall-timed
  per call through the ``_PROF`` hook armed here (a module global that
  stays None, a dead branch, until `enable()`). The mesh collectives of
  `parallel.collectives` get a per-call byte census (the ``_CENSUS`` hook)
  and `probe_collectives()`, which times each of them eagerly on a mesh's
  group and reports the rate achieved against ``PEAK_LINK_GBS``.
- **barrier arrival skew** — `dist.barrier()` records its local arrival
  time, exchanges arrivals over `dist.exchange_objs` and feeds the spread
  into ``mx_barrier_skew_seconds``; a rank's lateness (its arrival minus
  the earliest) is the direct straggler signal.
- **fleet aggregation** — `fleet_report()` ships every rank's registry
  snapshot over a chunked `exchange_objs` transport (`exchange_large`,
  past the 4 KiB command slot), merges per-rank and fleet views, and names
  a straggler by signed z-score over step time and barrier lateness
  (`straggler_scores`), surfaced as ``mx_fleet_straggler_rank`` and as a
  `monitor.check()` health hook (`install_health_check`).
- **trace stitching** — `estimate_clock_offsets()` (NTP-style, bracketed
  by a barrier), `dump_rank_trace` (a rank-stamped span dump) and
  `stitch_traces` (one Perfetto timeline, one lane a rank, rebased by the
  offsets; collective spans carry ``coll_seq`` to match them across
  lanes).
- **flight-recorder fanout** — on an uncaught exception the crashing rank
  drops ``fleet_crash_rank<r>.marker`` beside its rank-stamped flightrec
  (under `tracing._flight_dir`, where `fault.elastic` reads the markers);
  each surviving rank's atexit hook sees it and dumps a ``peer_crash``
  flightrec. `merge_flight_dumps` collects them into one post-mortem.

**The link's peak is the transport's.** The reference's ``PEAK_LINK_GBS``
is a table of TPU interconnect rates. The port's groups exchange either
through NCCL (several cards) or through gloo, whose CUDA tensors go
through host memory (`parallel.collectives.transport`), so the peak that
bounds a gloo exchange of card tensors is the card's host-copy rate.
``PEAK_LINK_GBS`` is keyed by transport (``"host"``, ``"nccl"``) and holds
only measured rates, written by the caller that measured them (the
card's smoke run times a pinned device-to-host and host-to-device copy);
a transport with no entry (NCCL here: not measured) has no
``peak_frac``.

Arming: `enable()` (or ``MXNET_TELEMETRY=1`` / ``MXNET_FLEET=1``). Enable on
EVERY rank or none: the skew and report exchanges are collectives. Knobs:
``MXNET_FLEET_SKEW_EVERY``, ``MXNET_FLEET_CHUNK_BYTES``,
``MXNET_FLEET_STRAGGLER_Z``, ``MXNET_FLEET_TRACE_DIR``.
"""
from __future__ import annotations

import atexit
import contextlib
import glob as _glob
import json
import math
import os
import pickle
import re
import socket
import sys
import threading
import time
import zlib

from . import registry, tracing
from .locks import tracked_lock

__all__ = [
    "enable", "disable", "is_enabled", "probe_collectives",
    "PEAK_LINK_GBS", "fleet_report", "straggler_scores", "exchange_large",
    "install_health_check", "estimate_clock_offsets", "dump_rank_trace",
    "stitch_traces", "merge_flight_dumps", "barrier_stats", "reset",
]

_PKG = __name__.rsplit(".", 2)[0]

_ENABLED = False
_LOCK = tracked_lock("telemetry.fleet", kind="lock")

#: Measured peak rates (GB/s, one direction) by transport: "host" (gloo,
#: the card's tensors through host memory) and "nccl"; empty until a
#: measurement fills it.
PEAK_LINK_GBS: dict = {}

COLLECTIVE_BUCKETS = (1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2,
                      0.1, 0.25, 1.0, 5.0)
SKEW_BUCKETS = (1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5,
                1.0, 5.0)

_SEQ: dict = {}               # op -> issue sequence (matches across ranks)
_SEQ_LOCK = tracked_lock("telemetry.fleet.seq", kind="lock")

_BARRIER = {"count": 0, "lateness_sum": 0.0, "lateness_max": 0.0,
            "skew_sum": 0.0, "skew_max": 0.0}
_CLOCK: dict = {"offsets": None, "bound_s": None}
_FLEET_TRACE = {"id": None}   # rank 0's trace id, learned at a barrier
_LAST_REPORT = None
_FANOUT = {"armed": False, "prev_hook": None}


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


# ---------------------------------------------------------------------------
# arming
# ---------------------------------------------------------------------------


def is_enabled():
    return _ENABLED


def enable():
    """Arm the fleet plane: the dist profiling hook, the mesh collectives'
    census hook, the flight recorder's rank stamp and crash fanout.
    Idempotent."""
    global _ENABLED
    with _LOCK:
        if _ENABLED:
            return
        _ENABLED = True
    _arm()
    tracing.register_flight_context("fleet", _flight_context)
    _arm_flight_fanout()


def disable():
    global _ENABLED
    with _LOCK:
        _ENABLED = False
    _arm()


def _arm():
    """(Re)point the hot hooks of `parallel.dist` and
    `parallel.collectives`; dist also re-arms at import (`_rearm_hooks`),
    so the order of enable and import does not matter."""
    dist_mod = sys.modules.get(_PKG + ".parallel.dist")
    if dist_mod is not None:
        dist_mod._PROF = sys.modules[__name__] if _ENABLED else None
    coll_mod = sys.modules.get(_PKG + ".parallel.collectives")
    if coll_mod is not None:
        coll_mod._CENSUS = _census_record if _ENABLED else None


def _tdist_up():
    tdist = sys.modules.get("torch.distributed")
    try:
        return tdist is not None and tdist.is_initialized()
    except Exception:
        return False


def _rank_hint():
    """This rank without a collective (usable from excepthooks and before
    `dist.initialize`): the launcher's environment first, the live world
    second."""
    v = os.environ.get("PROCESS_ID") or os.environ.get("DMLC_RANK")
    if v is not None:
        try:
            return int(v)
        except ValueError:
            pass
    if _tdist_up():
        return int(sys.modules["torch.distributed"].get_rank())
    return 0


def _nprocs_hint():
    v = os.environ.get("NUM_PROCESSES") or os.environ.get("DMLC_NUM_WORKER")
    if v is not None:
        try:
            return int(v)
        except ValueError:
            pass
    if _tdist_up():
        return int(sys.modules["torch.distributed"].get_world_size())
    return 1


def _rank():
    try:
        from ..parallel import dist

        if dist.is_initialized():
            return dist.rank()
    except Exception:   # telemetry never breaks the caller
        pass
    return _rank_hint()


def reset():
    """Forget per-run fleet state (tests)."""
    global _LAST_REPORT
    with _SEQ_LOCK:
        _SEQ.clear()
    with _LOCK:
        # the flight-recorder fanout reads these from the crash thread
        _BARRIER.update(count=0, lateness_sum=0.0, lateness_max=0.0,
                        skew_sum=0.0, skew_max=0.0)
        _CLOCK.update(offsets=None, bound_s=None)
    _FLEET_TRACE["id"] = None
    _LAST_REPORT = None


def barrier_stats():
    with _LOCK:
        b = dict(_BARRIER)
    n = b.pop("count")
    return {"count": n,
            "lateness_mean": (b["lateness_sum"] / n) if n else 0.0,
            "lateness_max": b["lateness_max"],
            "skew_mean": (b["skew_sum"] / n) if n else 0.0,
            "skew_max": b["skew_max"]}


# ---------------------------------------------------------------------------
# collective profiler: dist.* hook + mesh collectives' census
# ---------------------------------------------------------------------------


def _next_seq(op):
    with _SEQ_LOCK:
        _SEQ[op] = _SEQ.get(op, 0) + 1
        return _SEQ[op]


def _observe(op, axis, nbytes, seconds, link_bytes=None, peak=None):
    labels = {"op": op, "axis": axis}
    registry.histogram("mx_collective_seconds",
                       "wall time per wrapped collective",
                       labels=labels,
                       buckets=COLLECTIVE_BUCKETS).observe(seconds)
    if nbytes:
        registry.counter("mx_collective_bytes_total",
                         "payload bytes entering wrapped collectives",
                         labels=labels).inc(int(nbytes))
    moved = link_bytes if link_bytes is not None else nbytes
    if moved and seconds > 0:
        gbs = moved / seconds / 1e9
        registry.gauge("mx_collective_gbs",
                       "last achieved collective GB/s",
                       labels=labels).set(gbs)
        if peak:
            registry.gauge("mx_collective_peak_frac",
                           "achieved GB/s / PEAK_LINK_GBS of the transport",
                           labels=labels).set(gbs / peak)


@contextlib.contextmanager
def dist_op(op, nbytes, **attrs):
    """The context `parallel.dist` wraps its collectives in (through the
    ``_PROF`` hook): a ``dist.<op>`` span stamped with the op's issue
    sequence, and its wall time and bytes in the registry."""
    seq = _next_seq(op)
    t0 = time.perf_counter()
    with tracing.span("dist." + op, lane="dist", op=op,
                      nbytes=int(nbytes), coll_seq=seq, **attrs):
        try:
            yield
        finally:
            _observe(op, "host", nbytes, time.perf_counter() - t0)


def barrier_probe(tag, run):
    """Time ``run()`` (the barrier's allreduce) and, every
    ``MXNET_FLEET_SKEW_EVERY``-th barrier, exchange the local arrival times
    to measure the fleet's arrival spread. Every rank must be armed alike:
    the skew exchange is itself a collective."""
    from ..parallel import dist

    seq = _next_seq("barrier")
    t_arrive = time.time()
    with tracing.span("dist.barrier", lane="dist", op="barrier", tag=tag,
                      coll_seq=seq):
        t0 = time.perf_counter()
        run()
        _observe("barrier", "host", 4, time.perf_counter() - t0)
        every = _env_int("MXNET_FLEET_SKEW_EVERY", 1)
        if every > 0 and seq % every == 0:
            _exchange_arrival(dist, t_arrive)


def _exchange_arrival(dist, t_arrive):
    me = dist.rank()
    try:
        got = dist.exchange_objs({"rank": me, "t": t_arrive,
                                  "trace": tracing.current_trace_id()})
    except Exception:
        return
    arrivals = {}
    for g in got:
        if isinstance(g, dict) and "t" in g:
            arrivals[int(g["rank"])] = float(g["t"])
            if int(g["rank"]) == 0 and g.get("trace"):
                # rank 0's ambient trace id is the fleet correlation id
                _FLEET_TRACE["id"] = g["trace"]
    if len(arrivals) < 2:
        return
    offs = _CLOCK.get("offsets")
    if offs:
        arrivals = {r: t - offs[r] if r < len(offs) else t
                    for r, t in arrivals.items()}
    lo = min(arrivals.values())
    skew = max(arrivals.values()) - lo
    lateness = arrivals.get(me, lo) - lo
    registry.histogram("mx_barrier_skew_seconds",
                       "arrival spread at dist.barrier",
                       buckets=SKEW_BUCKETS).observe(skew)
    with _LOCK:
        # the crash fanout's flight context reads these from another
        # thread
        _BARRIER["count"] += 1
        _BARRIER["lateness_sum"] += lateness
        _BARRIER["lateness_max"] = max(_BARRIER["lateness_max"], lateness)
        _BARRIER["skew_sum"] += skew
        _BARRIER["skew_max"] = max(_BARRIER["skew_max"], skew)
    tracing.annotate(skew_s=round(skew, 6), lateness_s=round(lateness, 6),
                     fleet_trace=_FLEET_TRACE["id"])


def _census_record(op, axis_name, v):
    """The mesh collectives' census: counts each call and its payload
    bytes (`probe_collectives` owns their seconds)."""
    try:
        labels = {"op": op, "axis": str(axis_name)}
        registry.counter("mx_collective_trace_calls_total",
                         "wrapped collective calls seen by the census",
                         labels=labels).inc()
        nbytes = int(v.numel()) * int(v.element_size())
        if nbytes:
            registry.counter(
                "mx_collective_bytes_total",
                "payload bytes entering wrapped collectives",
                labels=labels).inc(nbytes)
    except Exception:   # the census must never break the collective
        pass


# ---------------------------------------------------------------------------
# eager collective microbench
# ---------------------------------------------------------------------------


def probe_collectives(mesh=None, axis=None, nbytes=1 << 16, iters=3):
    """Time every `parallel.collectives` op eagerly on ``mesh``'s group
    along ``axis`` (default: the active mesh, else a one-axis mesh over the
    world's ranks) and emit ``mx_collective_seconds{op=,axis=}``,
    ``mx_collective_gbs`` and ``mx_collective_peak_frac`` per op. Every rank
    of the mesh calls it (each op is a collective). ``nbytes`` sizes the
    global payload; the best of ``iters`` wall times, the card synced.

    Returns ``{op: {seconds, payload_bytes, link_bytes, gbs, peak_frac}}``
    plus a ``_meta`` row. ``link_bytes`` models a rank's traffic with the
    ring algorithms' factors; ``peak_frac`` is against ``PEAK_LINK_GBS`` of
    the group's transport, None where that rate was not measured."""
    import torch

    from ..parallel import collectives
    from ..parallel.mesh import _world, current_mesh, make_mesh, mesh_scope

    if mesh is None:
        mesh = current_mesh()
    if mesh is None:
        mesh = make_mesh({"fleet": _world()[2]})
    axis = axis or mesh.axis_names[0]
    n = int(mesh.axis_size(axis))
    # per-shard element count, divisible by n (reduce_scatter needs it)
    m = n * max(1, int(nbytes) // 4 // max(n * n, 1))
    s = m * 4                              # per-shard payload bytes
    ax = axis
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    group = mesh.group(ax)
    transport = collectives.transport(group, dev)
    backend = None if group is None else collectives.group_backend(group)
    key = "host" if transport == "host" else backend
    peak = PEAK_LINK_GBS.get(key)
    ops = {
        "all_reduce": (lambda v: collectives.all_reduce(v, ax), (m,),
                       2 * (n - 1) * s),
        "all_gather": (lambda v: collectives.all_gather(v, ax), (m,),
                       (n - 1) * s),
        "reduce_scatter": (lambda v: collectives.reduce_scatter(v, ax),
                           (m,), (n - 1) * s // n),
        "broadcast": (lambda v: collectives.broadcast(v, ax, 0), (m,),
                      2 * (n - 1) * s),
        "ring_permute": (lambda v: collectives.ring_permute(v, ax, 1),
                         (m,), s),
        "all_to_all": (lambda v: collectives.all_to_all(v, ax, 0, 0),
                       (n, m // n), (n - 1) * s // n),
    }
    out = {"_meta": {"axis": axis, "n": n, "per_shard_bytes": s,
                     "device": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                     "transport": key or "none", "peak_gbs": peak}}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with mesh_scope(mesh), torch.no_grad():
        for op, (fn, shape, link_bytes) in ops.items():
            x = torch.zeros(shape, dtype=torch.float32, device=dev)
            try:
                fn(x)                      # first call outside the timing
                sync()
                best = float("inf")
                for _ in range(max(1, iters)):
                    t0 = time.perf_counter()
                    fn(x)
                    sync()
                    best = min(best, time.perf_counter() - t0)
            except Exception as e:
                out[op] = {"error": f"{type(e).__name__}: {e}"}
                continue
            payload = n * s
            _observe(op, str(axis), payload, best, link_bytes=link_bytes,
                     peak=peak)
            gbs = (link_bytes / best / 1e9) if (link_bytes and best > 0) \
                else None
            out[op] = {"seconds": best, "payload_bytes": payload,
                       "link_bytes": link_bytes,
                       "gbs": round(gbs, 3) if gbs else None,
                       "peak_frac": round(gbs / peak, 4)
                       if (gbs and peak) else None}
    return out


# ---------------------------------------------------------------------------
# chunked snapshot transport + fleet report
# ---------------------------------------------------------------------------


def exchange_large(obj, chunk=None, _exchange=None):
    """`dist.exchange_objs` for objects past the 4 KiB command slot: the
    compressed pickle is split into `chunk`-byte pieces, one metadata
    round ships per-rank piece counts, then max(counts) piece rounds
    reassemble every rank's payload. `_exchange` injects a transport for
    unit tests."""
    from ..parallel import dist

    exchange = _exchange or dist.exchange_objs
    if _exchange is None and (not dist.is_initialized()
                              or dist.num_processes() == 1):
        return [obj]
    chunk = chunk or _env_int("MXNET_FLEET_CHUNK_BYTES", 3000)
    blob = zlib.compress(pickle.dumps(obj), 6)
    pieces = [blob[i:i + chunk] for i in range(0, len(blob), chunk)] or [b""]
    counts = [int(c) for c in exchange(len(pieces))]
    parts = [[] for _ in counts]
    for i in range(max(counts)):
        got = exchange(pieces[i] if i < len(pieces) else b"")
        for r, g in enumerate(got):
            parts[r].append(g if isinstance(g, (bytes, bytearray)) else b"")
    out = []
    for r, p in enumerate(parts):
        try:
            out.append(pickle.loads(zlib.decompress(b"".join(p[:counts[r]]))))
        except Exception:
            out.append(None)
    return out


def straggler_scores(samples):
    """Straggler score per rank: the max SIGNED z-score over the
    per-rank signals (population std) — a slow rank sits ABOVE the mean
    on step time and barrier lateness, so its z is positive and wins the
    argmax. Signals missing on some ranks, present on <2 ranks, or with
    ~zero spread contribute 0.

    `samples`: ``{rank: {signal_name: value-or-None}}`` →
    ``{rank: score}``."""
    scores = {r: 0.0 for r in samples}
    signals = set()
    for s in samples.values():
        signals.update(s)
    for sig in signals:
        vals = {r: float(s[sig]) for r, s in samples.items()
                if isinstance(s.get(sig), (int, float))}
        if len(vals) < 2:
            continue
        mu = sum(vals.values()) / len(vals)
        sd = math.sqrt(sum((v - mu) ** 2 for v in vals.values()) / len(vals))
        if sd <= 1e-12:
            continue
        for r, v in vals.items():
            scores[r] = max(scores[r], (v - mu) / sd)
    return scores


def _hist_mean(report, name):
    cell = report.get(name)
    if isinstance(cell, dict) and cell.get("count"):
        return cell["sum"] / cell["count"]
    return None


def _local_snapshot():
    from ..fault import injection
    from . import goodput

    # close the goodput ledger's open interval so the counters in this
    # registry snapshot are current to the instant of the exchange
    goodput.goodput_frac()
    return {"rank": _rank(), "host": socket.gethostname(),
            "pid": os.getpid(), "wall_time": time.time(),
            "registry": registry.report(),
            "barrier": barrier_stats(),
            "faults": injection.schedule_info(),
            "clock_offset_s": _my_offset()}


def _my_offset():
    offs = _CLOCK.get("offsets") or []
    r = _rank()
    return float(offs[r]) if r < len(offs) else 0.0


def _aggregate_registries(reports):
    """Fleet-aggregate view: counters sum, histograms pool
    count/sum/min/max, gauges keep per-value min/mean/max."""
    agg: dict = {}
    for rep in reports:
        for key, cell in (rep or {}).items():
            if not isinstance(cell, dict):
                continue
            t = cell.get("type")
            a = agg.setdefault(key, {"type": t, "ranks": 0})
            a["ranks"] += 1
            if t == "counter":
                a["value"] = a.get("value", 0) + cell.get("value", 0)
            elif t == "gauge":
                v = cell.get("value")
                if v is None:       # never-set gauge cell
                    continue
                a["min"] = min(a["min"], v) if "min" in a else v
                a["max"] = max(a["max"], v) if "max" in a else v
                a["_sum"] = a.get("_sum", 0.0) + v
                a["_n"] = a.get("_n", 0) + 1
            elif t == "histogram":
                a["count"] = a.get("count", 0) + cell.get("count", 0)
                a["sum"] = a.get("sum", 0.0) + cell.get("sum", 0.0)
                for k, red in (("min", min), ("max", max)):
                    if cell.get(k) is not None:
                        a[k] = (cell[k] if a.get(k) is None
                                else red(a[k], cell[k]))
    for a in agg.values():
        if a["type"] == "gauge" and "_sum" in a:
            a["mean"] = a.pop("_sum") / max(1, a.pop("_n", 1))
        elif a["type"] == "histogram" and a.get("count"):
            a["mean"] = a["sum"] / a["count"]
    return agg


def _goodput_view(ranks):
    """Fleet goodput rollup from each rank's
    ``mx_goodput_seconds_total{state=}`` counters: per-rank state seconds
    + goodput fraction, fleet-summed states, and the rank losing the most
    time to data_wait (a straggling input pipeline's usual signature).
    None when no rank has leased any goodput time yet."""
    per_rank = {}
    fleet: dict = {}
    for r, s in ranks.items():
        states = {}
        for key, cell in (s.get("registry") or {}).items():
            if not key.startswith("mx_goodput_seconds_total{"):
                continue
            m = re.search(r'state="([^"]+)"', key)
            if m and isinstance(cell, dict):
                states[m.group(1)] = float(cell.get("value") or 0.0)
        if not states:
            continue
        wall = sum(states.values())
        per_rank[r] = {
            "states": states, "wall_s": wall,
            "goodput_frac": ((states.get("compute", 0.0) / wall)
                             if wall > 0 else 0.0)}
        for st, v in states.items():
            fleet[st] = fleet.get(st, 0.0) + v
    if not per_rank:
        return None
    tot = sum(fleet.values())
    worst = max(per_rank,
                key=lambda r: per_rank[r]["states"].get("data_wait", 0.0))
    return {"per_rank": per_rank, "fleet_states": fleet,
            "fleet_goodput_frac": ((fleet.get("compute", 0.0) / tot)
                                   if tot > 0 else 0.0),
            "worst_data_wait_rank": int(worst)}


def _capacity_view(ranks):
    """Fleet capacity-ledger rollup from each rank's ``mx_capacity_*``
    series: per-tenant/per-model cost rows summed across ranks (tokens,
    prefill/decode device-seconds, KV page-seconds, queue-wait). None
    when no rank has charged any cost yet."""
    from . import capacity as _capacity

    fleet: dict = {}
    for s in ranks.values():
        view = _capacity.capacity_view(s.get("registry") or {})
        for tenant, per_model in view.items():
            for model, row in per_model.items():
                agg = fleet.setdefault(tenant, {}).setdefault(
                    model, {"tokens": 0, "device_s": {},
                            "kv_page_s": 0.0, "queue_wait_s": 0.0})
                agg["tokens"] += row["tokens"]
                agg["kv_page_s"] += row["kv_page_s"]
                agg["queue_wait_s"] += row["queue_wait_s"]
                for phase, v in row["device_s"].items():
                    agg["device_s"][phase] = \
                        agg["device_s"].get(phase, 0.0) + v
    return fleet or None


def fleet_report():
    """Gather every rank's snapshot (registry report + barrier stats +
    fault schedule) into per-rank and fleet-aggregate views, score the
    straggler, refresh the `mx_fleet_*` gauges, and roll up the per-rank
    goodput ledgers (``report["goodput"]``) and capacity cost ledgers
    (``report["capacity"]``). Collective: every rank must
    call it (each gets the same report). Single-process: a 1-rank report
    over the local registry."""
    global _LAST_REPORT

    snaps = exchange_large(_local_snapshot())
    ranks = {int(s["rank"]): s for s in snaps
             if isinstance(s, dict) and "rank" in s}
    samples = {
        r: {"step_time_mean": _hist_mean(s.get("registry") or {},
                                         "mx_step_time_seconds"),
            "barrier_lateness_mean":
                (s.get("barrier") or {}).get("lateness_mean")}
        for r, s in ranks.items()}
    scores = straggler_scores(samples)
    if scores:
        srank = max(scores, key=lambda r: scores[r])
        sscore = scores[srank]
    else:
        srank, sscore = _rank(), 0.0
    registry.gauge("mx_fleet_straggler_rank",
                   "rank with the worst straggler z-score").set(float(srank))
    registry.gauge("mx_fleet_straggler_score",
                   "straggler z-score of that rank").set(float(sscore))
    registry.gauge("mx_fleet_ranks",
                   "ranks seen by the last fleet_report").set(
                       float(len(ranks)))
    rep = {"n_ranks": len(ranks), "rank": _rank(),
           "wall_time": time.time(),
           "ranks": ranks,
           "aggregate": _aggregate_registries(
               [s.get("registry") for s in ranks.values()]),
           "straggler": {"rank": int(srank), "score": round(sscore, 4),
                         "scores": {int(r): round(v, 4)
                                    for r, v in scores.items()},
                         "signals": samples},
           "goodput": _goodput_view(ranks),
           "capacity": _capacity_view(ranks),
           "clock": {"offsets": _CLOCK.get("offsets"),
                     "bound_s": _CLOCK.get("bound_s")}}
    _LAST_REPORT = rep
    return rep


def last_report():
    return _LAST_REPORT


def install_health_check(threshold=None):
    """Route the straggler score into `monitor.check()`: after that, a
    rank whose score exceeds `threshold` (default
    ``MXNET_FLEET_STRAGGLER_Z``, 2.5) in the LAST `fleet_report()` makes
    `monitor.check()` raise, exactly like a pending NaN finding.
    Idempotent."""
    from . import monitor

    def _fleet_straggler_check():
        rep = _LAST_REPORT
        if not rep:
            return
        thr = (threshold if threshold is not None
               else _env_float("MXNET_FLEET_STRAGGLER_Z", 2.5))
        s = rep["straggler"]
        if s["score"] > thr:
            from ..base import MXNetError

            raise MXNetError(
                f"fleet straggler: rank {s['rank']} z-score "
                f"{s['score']:.2f} exceeds {thr:.2f} "
                f"(signals: {s['signals'].get(s['rank'])})")

    monitor.add_health_check(_fleet_straggler_check, name="fleet_straggler")
    return _fleet_straggler_check


# ---------------------------------------------------------------------------
# clock offsets + trace stitching
# ---------------------------------------------------------------------------


def estimate_clock_offsets(rounds=3):
    """NTP-style offset estimate: after a barrier, every rank brackets
    the same exchange collective with local wall timestamps (t0, t1);
    the collective completes at one global instant, so rank r reads it
    as midpoint (t0_r+t1_r)/2 ± (t1_r−t0_r)/2. offset_r = midpoint_r −
    midpoint_0 (rank 0 is the reference clock); the bound adds rank r's
    and rank 0's half-intervals. Best (smallest-bound) of `rounds`.
    Single-process: zeros."""
    from ..parallel import dist

    if not dist.is_initialized() or dist.num_processes() == 1:
        _CLOCK.update(offsets=[0.0], bound_s=0.0)
        return dict(_CLOCK, rounds=0)
    me = dist.rank()
    nproc = dist.num_processes()
    best = None
    for _ in range(max(1, rounds)):
        dist.barrier(tag="clock_sync")
        t0 = time.time()
        t0s = dist.exchange_objs(("clk0", me, t0))
        t1 = time.time()
        t1s = dist.exchange_objs(("clk1", me, t1))
        try:
            pairs = [(float(t0s[r][2]), float(t1s[r][2]))
                     for r in range(nproc)]
        except (TypeError, IndexError):
            continue
        mid = [(a + b) / 2.0 for a, b in pairs]
        half = [(b - a) / 2.0 for a, b in pairs]
        bound = max(half) + half[0]
        if best is None or bound < best[1]:
            best = ([m - mid[0] for m in mid], bound)
    if best is not None:
        _CLOCK["offsets"], _CLOCK["bound_s"] = best
        registry.gauge("mx_fleet_clock_offset_seconds",
                       "this rank's estimated clock offset vs rank 0"
                       ).set(best[0][me])
    return dict(_CLOCK, rounds=rounds)


def dump_rank_trace(out_dir=None):
    """Write this rank's finished spans (+ clock offset) as
    ``fleet_spans_rank<R>.json`` for `stitch_traces` /
    ``trace_timeline.py --fleet``. Returns the path."""
    out_dir = (out_dir or os.environ.get("MXNET_FLEET_TRACE_DIR")
               or tracing._flight_dir())
    os.makedirs(out_dir, exist_ok=True)
    r = _rank()
    payload = {"rank": r, "n_ranks": _nprocs_hint(),
               "host": socket.gethostname(), "pid": os.getpid(),
               "clock_offset_s": _my_offset(),
               "offset_bound_s": float(_CLOCK.get("bound_s") or 0.0),
               "fleet_trace": _FLEET_TRACE["id"],
               "barrier": barrier_stats(),
               "spans": [s.to_dict() for s in tracing.finished_spans()]}
    path = os.path.join(out_dir, f"fleet_spans_rank{r:03d}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)
    return path


def stitch_traces(span_dir):
    """Merge a directory of per-rank `dump_rank_trace` files into one
    Perfetto/chrome trace: one process lane per rank (pid 3000+rank),
    span timestamps rebased by each rank's estimated clock offset so
    matching `coll_seq` barrier spans line up within the offset bound
    (reported under the ``fleet`` key)."""
    files = sorted(_glob.glob(os.path.join(span_dir,
                                           "fleet_spans_rank*.json")))
    if not files:
        raise FileNotFoundError(
            f"no fleet_spans_rank*.json under {span_dir!r} "
            "(run telemetry.fleet.dump_rank_trace on every rank)")
    events = []
    n_ranks, bound, n_spans = 0, 0.0, 0
    for f in files:
        with open(f) as fh:
            payload = json.load(fh)
        rank = int(payload.get("rank", 0))
        n_ranks = max(n_ranks, rank + 1)
        off_us = float(payload.get("clock_offset_s", 0.0)) * 1e6
        bound = max(bound, float(payload.get("offset_bound_s", 0.0)))
        pid = 3000 + rank
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": (
                           f"rank {rank} ({payload.get('host', '?')}"
                           f" pid {payload.get('pid', '?')})")}})
        tids: dict = {}
        for sd in payload.get("spans", []):
            lane = str(sd.get("lane") or sd.get("thread") or "main")
            if lane not in tids:
                tids[lane] = len(tids)
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tids[lane],
                               "args": {"name": lane}})
            args = dict(sd.get("attrs") or {})
            args["rank"] = rank
            args["trace_id"] = sd.get("trace_id")
            events.append({"ph": "X", "name": sd.get("name", "?"),
                           "pid": pid, "tid": tids[lane],
                           "ts": float(sd.get("ts_us", 0)) - off_us,
                           "dur": max(float(sd.get("dur_us") or 0), 1.0),
                           "args": args})
            n_spans += 1
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "fleet": {"n_ranks": n_ranks, "files": len(files),
                      "n_spans": n_spans, "offset_bound_s": bound}}


# ---------------------------------------------------------------------------
# flight-recorder fanout + post-mortem merge
# ---------------------------------------------------------------------------


def _marker_path(rank):
    return os.path.join(tracing._flight_dir(),
                        f"fleet_crash_rank{rank:03d}.marker")


def _flight_context():
    return {"rank": _rank(), "n_ranks": _nprocs_hint(),
            "host": socket.gethostname(),
            "clock_offset_s": _my_offset(),
            "barrier": barrier_stats()}


def _fanout_excepthook(exc_type, exc, tb):
    try:
        if _ENABLED and _nprocs_hint() > 1:
            with open(_marker_path(_rank()), "w") as fh:
                json.dump({"rank": _rank(), "pid": os.getpid(),
                           "error": f"{exc_type.__name__}: {exc}",
                           "wall_time": time.time()}, fh)
    except Exception:   # a crash hook must never mask the exception
        pass
    prev = _FANOUT["prev_hook"] or sys.__excepthook__
    prev(exc_type, exc, tb)


def _atexit_peer_check():
    """Surviving ranks dump a ``peer_crash`` flightrec when another
    rank's crash marker exists (shared flightrec dir)."""
    if not _ENABLED or _nprocs_hint() <= 1:
        return
    try:
        mine = _marker_path(_rank())
        peers = [m for m in _glob.glob(os.path.join(
            tracing._flight_dir(), "fleet_crash_rank*.marker"))
            if os.path.abspath(m) != os.path.abspath(mine)]
        if peers and not os.path.exists(mine) and tracing.is_enabled():
            tracing.flight_dump("peer_crash")
    except Exception:   # the fanout is best effort on a dying process
        pass


def _sigterm_to_exit(signum, frame):  # noqa: ARG001 — signal handler signature
    sys.exit(128 + signum)


def _arm_flight_fanout():
    if _FANOUT["armed"]:
        return
    _FANOUT["armed"] = True
    _FANOUT["prev_hook"] = sys.excepthook
    sys.excepthook = _fanout_excepthook
    atexit.register(_atexit_peer_check)
    if _nprocs_hint() > 1:
        tracing._RANK_STAMP = _rank_hint()
        try:                       # stale marker from a previous run
            os.remove(_marker_path(_rank_hint()))
        except OSError:
            pass
        # launch.py's fail-fast SIGTERMs the surviving ranks when one
        # crashes; the default handler skips atexit, which would kill
        # the peer_crash dump this fanout exists for. Convert to a
        # clean SystemExit (only where the default action was in place).
        import signal

        try:
            if (threading.current_thread() is threading.main_thread()
                    and signal.getsignal(signal.SIGTERM) == signal.SIG_DFL):
                signal.signal(signal.SIGTERM, _sigterm_to_exit)
        except (ValueError, OSError):   # non-main interpreter contexts
            pass


def merge_flight_dumps(dump_dir):
    """Collect every rank's flightrec (+ crash markers) under `dump_dir`
    into one post-mortem: ``{n_ranks, ranks: {rank: [summaries]},
    markers, dumps}``. Rank comes from the dump's ``context.fleet``
    block, the rank-stamped filename, or (last resort) the pid."""
    merged: dict = {"n_dumps": 0, "ranks": {}, "markers": [], "dumps": []}
    for f in sorted(_glob.glob(os.path.join(dump_dir, "flightrec_*.json"))):
        try:
            with open(f) as fh:
                payload = json.load(fh)
        except (OSError, ValueError):
            continue
        ctx = (payload.get("context") or {}).get("fleet") or {}
        rank = ctx.get("rank")
        if rank is None:
            m = re.search(r"rank(\d+)", os.path.basename(f))
            rank = int(m.group(1)) if m else payload.get("pid", -1)
        merged["ranks"].setdefault(str(int(rank)), []).append(
            {"path": os.path.basename(f),
             "reason": payload.get("reason"),
             "error": payload.get("error"),
             "pid": payload.get("pid"),
             "n_spans": len(payload.get("spans") or []),
             "wall_time_us": payload.get("wall_time_us")})
        merged["dumps"].append(payload)
        merged["n_dumps"] += 1
    for mk in sorted(_glob.glob(os.path.join(dump_dir,
                                             "fleet_crash_rank*.marker"))):
        try:
            with open(mk) as fh:
                merged["markers"].append(json.load(fh))
        except (OSError, ValueError):
            pass
    merged["n_ranks"] = len(merged["ranks"])
    return merged
