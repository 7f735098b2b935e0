"""Training-health monitor (port of
`incubator_mxnet_tpu/telemetry/monitor.py`: `Monitor`, `install_nan_hook`,
`nan_findings`, `check`, the health checks and the rank statistics).

The tap point is the op funnel (`ndarray.apply_op`, its ``_MONITOR_HOOK``
seam): every eager op whose name matches ``pattern`` is observed. Stats
(l2 norm, mean, max|.|, NaN count, Inf count) are computed on the
tensor's device as 0-dim tensors and the host sync is batched: nothing
blocks until `toc()` pulls the whole batch in one copy.

NaN hook (`install_nan_hook`): catches the first non-finite op output.

- an eager op: the finite flag is synced per op (a debugging mode: the
  cost is the point) and ``mode="raise"`` raises `MXNetError` at the
  faulting op, naming it;
- an op inside a CUDA-graph capture (a hybridized block's, a
  `DataParallel` step's; ``torch.cuda.is_current_stream_capturing()``):
  the hook must not sync the host, so it records a device flag instead:
  each replay adds the output's not-all-finite bit to a slot of a flag
  buffer on the card, and `check()` (or `nan_findings()`) reads the
  buffer in one copy and turns each set slot into a finding for its op.
  The reference embeds a ``jax.debug.callback`` in the compiled program
  for the same role. A graph captured before the hook was installed
  keeps no guard; install the hook first.

``MXNET_TELEMETRY=raise`` (or ``warn``) installs the hook at import
(`util._apply_env_config`).

Rank statistics: `queue_rank_stats()` queues this rank's summary,
`sync_rank_stats()` (called by `KVStoreDist.barrier` on every rank)
exchanges the summaries over `dist.exchange_objs`, and `rank_aggregate()`
gives their min/max/mean over the ranks.

`TelemetryHandler` is the Estimator's handler feeding the registry's
step series (`registry.step`): each batch's wall time and examples.
"""
from __future__ import annotations

import json
import os
import re
import time

import torch

from ..base import MXNetError
from ..gluon.contrib.estimator.event_handler import (BatchBegin, BatchEnd,
                                                     EpochEnd, TrainBegin)
from . import registry

__all__ = ["Monitor", "install_nan_hook", "uninstall_nan_hook",
           "nan_findings", "clear_nan_findings", "check",
           "add_health_check", "remove_health_check",
           "queue_rank_stats", "sync_rank_stats", "rank_aggregate",
           "default_stats", "FLAG_SLOTS", "TelemetryHandler"]

_ACTIVE_MONITORS: list = []
_NAN_MODE = None                 # None | "warn" | "raise"
_NAN_FINDINGS: list = []
#: slots of the card's flag buffer: ops a capture can guard in all
FLAG_SLOTS = 1 << 16
# device -> the flag buffer (int32, FLAG_SLOTS): each slot counts the
# replays in which its op's output held a non-finite value
_FLAGS: dict = {}
_SLOTS: list = []                # (op name, device, slot index)


def _install_funnel_hook():
    from ..ndarray import ndarray as nd_mod

    nd_mod._MONITOR_HOOK = _observe if (_ACTIVE_MONITORS or _NAN_MODE) \
        else None


def default_stats(x):
    """Per-tensor health stats as 0-dim tensors on ``x``'s device (no
    host sync), computed in float32."""
    xf = x.detach().float()
    return {"norm": torch.sqrt((xf * xf).sum()),
            "mean": xf.mean(),
            "max_abs": xf.abs().max(),
            "nan": torch.isnan(xf).sum(),
            "inf": torch.isinf(xf).sum()}


def _host_values(values):
    """Floats of 0-dim tensors (or numbers) with one copy a device."""
    out = [None] * len(values)
    by_dev: dict = {}
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            by_dev.setdefault(v.device, []).append(i)
        else:
            out[i] = float(v)
    for idx in by_dev.values():
        host = torch.stack([values[i].detach().double().reshape(())
                            for i in idx]).cpu().tolist()
        for i, h in zip(idx, host):
            out[i] = float(h)
    return out


class Monitor:
    """Observe matching op outputs between `tic()` and `toc()`.

    Parameters mirror the reference: `interval` (observe every N-th
    tic/toc cycle), `stat_func` (tensor -> 0-dim tensor or dict of them;
    default `default_stats`), `pattern` (op-name regex), `sort` (sort
    `toc()` results by name). `callback` additionally receives the synced
    `(step, name, stat, value)` rows at each `toc()`.
    """

    def __init__(self, interval=1, stat_func=None, pattern=".*", sort=False,
                 callback=None):
        self.interval = max(1, int(interval))
        self.stat_func = stat_func or default_stats
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.callback = callback
        self.step = 0
        self.activated = False
        self.queue: list = []            # (step, op name, stat, device val)

    def install(self, block=None):  # noqa: ARG002 - funnel-level tap
        """Reference parity: the funnel tap needs no per-block install."""
        return self

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
            if self not in _ACTIVE_MONITORS:
                _ACTIVE_MONITORS.append(self)
                _install_funnel_hook()
        self.step += 1

    def toc(self):
        """Deactivate and return `[(step, name, stat, value), ...]` with one
        batched host sync for everything observed since `tic()`."""
        if not self.activated:
            return []
        self.activated = False
        if self in _ACTIVE_MONITORS:
            _ACTIVE_MONITORS.remove(self)
            _install_funnel_hook()
        queue, self.queue = self.queue, []
        values = _host_values([v for (_, _, _, v) in queue])
        rows = [(step, name, stat, v)
                for (step, name, stat, _), v in zip(queue, values)]
        if self.sort:
            rows.sort(key=lambda r: (r[1], r[2]))
        if self.callback is not None:
            self.callback(rows)
        return rows

    def toc_print(self):
        for step, name, stat, value in self.toc():
            print(f"Batch: {step:7d} {name + '_' + stat:30s} {value:.6g}")

    def __enter__(self):
        self.tic()
        return self

    def __exit__(self, *exc):
        self.toc_print()
        return False

    def _observe(self, name, out_vals):
        if not self.activated or not self.re_pattern.search(name):
            return
        for val in out_vals:
            stats = self.stat_func(val)
            if not isinstance(stats, dict):
                stats = {"stat": stats}
            for stat, v in stats.items():
                self.queue.append((self.step - 1, name, stat, v))


# ---------------------------------------------------------------------------
# funnel hook (shared by monitors and the NaN guard)
# ---------------------------------------------------------------------------

def _record_finding(name, where):
    _NAN_FINDINGS.append({"op": name, "where": where, "time": time.time()})


def _flag_buffer(device):
    buf = _FLAGS.get(device)
    if buf is None and not torch.cuda.is_current_stream_capturing():
        buf = _FLAGS[device] = torch.zeros(FLAG_SLOTS, dtype=torch.int32,
                                           device=device)
    return buf


def _guard_in_capture(name, val):
    """Inside a capture: add the output's not-all-finite bit to a flag
    slot on the card at every replay (no host sync)."""
    buf = _FLAGS.get(val.device)
    if buf is None or len(_SLOTS) >= FLAG_SLOTS:
        _record_finding(name, "graph: unguarded (no flag slot)")
        return
    i = len(_SLOTS)
    _SLOTS.append((name, val.device, i))
    buf[i:i + 1].add_((~torch.isfinite(val).all()).to(torch.int32))


def _observe(name, out_vals):
    """Installed as `ndarray._MONITOR_HOOK`; receives every funnel op's
    name and output tensors."""
    if _NAN_FINDINGS and _NAN_MODE == "raise":
        f = _NAN_FINDINGS[0]
        raise MXNetError(
            f"non-finite output detected at op '{f['op']}' ({f['where']}) "
            "— raising at the next funnel entry (MXNET_TELEMETRY=raise)")
    capturing = None
    if _NAN_MODE is not None:
        for val in out_vals:
            if not val.is_floating_point() and not val.is_complex():
                continue
            if val.device.type == "cuda":
                if capturing is None:
                    capturing = torch.cuda.is_current_stream_capturing()
                if capturing:
                    _guard_in_capture(name, val)
                    continue
                _flag_buffer(val.device)    # ready for a later capture
            if not bool(torch.isfinite(val).all()):
                _record_finding(name, "eager")
                if _NAN_MODE == "raise":
                    raise MXNetError(
                        f"non-finite output detected at op '{name}' "
                        "(eager, MXNET_TELEMETRY=raise)")
    if _ACTIVE_MONITORS:
        if capturing is None:
            capturing = torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing()
        if not capturing:        # monitors observe eager ops only
            for mon in list(_ACTIVE_MONITORS):
                mon._observe(name, out_vals)


def _read_flags():
    """Turn the set flag slots into findings (one copy a device) and
    clear them."""
    if not _SLOTS or torch.cuda.is_current_stream_capturing():
        return
    for dev, buf in _FLAGS.items():
        slots = [(n, i) for n, d, i in _SLOTS if d == dev]
        if not slots:
            continue
        hi = max(i for _, i in slots) + 1
        host = buf[:hi].cpu()
        if bool(host.any()):
            for n, i in slots:
                if int(host[i]):
                    _record_finding(n, "graph")
            buf[:hi].zero_()


def install_nan_hook(mode="raise"):
    """Arm the non-finite guard on every funnel op output.
    ``mode="raise"`` raises `MXNetError` at the first finding (eager: at
    the faulting op; inside a replayed graph: at `check()` or the next
    funnel entry after it); ``mode="warn"`` only records into
    `nan_findings()`."""
    global _NAN_MODE
    if mode not in ("warn", "raise"):
        raise ValueError(f"mode must be 'warn' or 'raise', got {mode!r}")
    _NAN_MODE = mode
    if torch.cuda.is_available() and torch.cuda.is_initialized() \
            and not torch.cuda.is_current_stream_capturing():
        _flag_buffer(torch.device("cuda", torch.cuda.current_device()))
    _install_funnel_hook()


def uninstall_nan_hook():
    global _NAN_MODE
    _NAN_MODE = None
    _install_funnel_hook()


def nan_findings():
    _read_flags()
    return list(_NAN_FINDINGS)


def clear_nan_findings():
    del _NAN_FINDINGS[:]
    for buf in _FLAGS.values():
        if not torch.cuda.is_current_stream_capturing():
            buf.zero_()


_HEALTH_CHECKS: dict = {}     # name -> callable raising on violation


def add_health_check(fn, name=None):
    """Register an extra health probe run by `check()`: ``fn()`` raises
    on violation (`telemetry.slo.install_health_check()` routes the SLO
    tracker's burned-budget check here). Re-registering a name replaces
    the previous probe."""
    _HEALTH_CHECKS[name or getattr(fn, "__name__", repr(fn))] = fn
    return fn


def remove_health_check(name):
    _HEALTH_CHECKS.pop(name, None)


def check():
    """Raise if any non-finite finding is pending (the flags of replayed
    graphs are read here, after the card's queued work), then run every
    registered health probe (`add_health_check`)."""
    _read_flags()
    if _NAN_FINDINGS:
        f = _NAN_FINDINGS[0]
        raise MXNetError(
            f"non-finite output detected at op '{f['op']}' ({f['where']})")
    for fn in list(_HEALTH_CHECKS.values()):
        fn()


# ---------------------------------------------------------------------------
# per-rank aggregation (single-process path)
# ---------------------------------------------------------------------------

_RANK_SUMMARY: dict = {}
_RANK_AGGREGATE: dict = {}


def queue_rank_stats(stats):
    """Queue this rank's scalar summary ({name: float}) for the next
    `sync_rank_stats()`."""
    for k, v in stats.items():
        _RANK_SUMMARY[str(k)] = float(v)


def sync_rank_stats():
    """Collective min/max/mean of the queued rank summaries — called from
    `KVStoreDist.barrier` on EVERY rank (the channel of
    `profiler.sync_remote_commands`). One process: the local summary.
    Returns the aggregate and caches it for `rank_aggregate()`."""
    global _RANK_SUMMARY
    mine, _RANK_SUMMARY = _RANK_SUMMARY, {}
    from ..parallel import dist

    if dist.is_initialized():
        all_stats = [s or {} for s in dist.exchange_objs(mine)]
    else:
        all_stats = [mine]
    merged = {}
    for stats in all_stats:
        for k, v in stats.items():
            merged.setdefault(k, []).append(v)
    _RANK_AGGREGATE.clear()
    for k, vals in merged.items():
        _RANK_AGGREGATE[k] = {"min": min(vals), "max": max(vals),
                              "mean": sum(vals) / len(vals),
                              "ranks": len(vals)}
    return dict(_RANK_AGGREGATE)


def rank_aggregate():
    """Last synced cross-rank aggregate: {name: {min, max, mean, ranks}}."""
    return dict(_RANK_AGGREGATE)


# ---------------------------------------------------------------------------
# estimator integration
# ---------------------------------------------------------------------------

class TelemetryHandler(TrainBegin, BatchBegin, BatchEnd, EpochEnd):
    """Estimator event handler feeding the metrics registry: per-batch
    step time + example counts into `mx_step_time_seconds` /
    `mx_examples_total`, and a registry report logged at every epoch end
    (plus every MXNET_TELEMETRY_INTERVAL batches when that knob is set).
    The step time is the host's wall time from `batch_begin` to
    `batch_end`, as in the reference: on the card it reads the queued
    work's end only where the step syncs (the metrics' host copy)."""

    def __init__(self, interval=None, priority=-100):
        if interval is None:
            try:
                interval = int(os.environ.get("MXNET_TELEMETRY_INTERVAL",
                                              "0"))
            except ValueError:
                interval = 0
        self.interval = interval          # batches between log lines
        self.priority = priority
        self._t0 = None
        self._batches = 0

    def train_begin(self, estimator, *args, **kwargs):
        self._batches = 0

    def batch_begin(self, estimator, *args, **kwargs):
        self._t0 = time.perf_counter()

    def batch_end(self, estimator, *args, **kwargs):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        batch = kwargs.get("batch")
        n = 0
        try:
            n = int(batch[0].shape[0])
        except (TypeError, AttributeError, IndexError, KeyError):
            pass                      # batch without a leading array leaf
        registry.step(dt, examples=n)
        self._batches += 1
        if self.interval and self._batches % self.interval == 0:
            estimator.logger.info("telemetry[batch %d]: %s", self._batches,
                                  json.dumps(registry.report(),
                                             sort_keys=True, default=str))

    def epoch_end(self, estimator, *args, **kwargs):
        estimator.logger.info("telemetry: %s",
                              json.dumps(registry.report(), sort_keys=True,
                                         default=str))
