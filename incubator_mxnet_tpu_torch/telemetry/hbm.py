"""Device-memory observatory: owner-attributed live-memory census, growth
watchdog, and OOM post-mortem (port of
`incubator_mxnet_tpu/telemetry/hbm.py`, re-grounded on the card).

Subsystems register **owners** (the serving engine's KV pool and params,
`DataParallel`'s params and optimizer state) as weakly bound probes that
return the tensors they own; :func:`census` attributes live memory to the
first owner claiming it and leaves the rest ``unattributed``. The report
keys are the reference's: ``total``, ``n_arrays``, ``owners``,
``derived``, ``detail``, ``unattributed``, ``top``, ``ts``.

Where the reference sweeps ``jax.live_arrays()``, the port reads:

- **on the card**: ``total`` is ``torch.cuda.memory_allocated(device)``
  summed over the devices, ``n_arrays`` the caching allocator's active
  allocations, and ``top`` the largest active blocks of
  ``torch.cuda.memory_snapshot()`` (a block whose address an owner's
  storage starts at carries that owner, its shape and dtype);
- **on the CPU** (no card, the tests): the live tensors that
  ``gc.get_objects()`` yields.

Owners claim **storages**, not tensors (the untyped storage's device and
``data_ptr``), so two views of one pool count once; the first claim still
wins. Everything reads host-side allocator state: no probe syncs the
card, so the census is safe from the timeseries sampler thread.

The CUDA graphs' private memory pools (a captured step's intermediates
and outputs) belong to the graph that owns each pool: on the card the
census reads the snapshot's segments and gives a pool's active blocks
that no owner claimed to the owner the capture named
(``"graph:<program>"``, `_graphs.register_pool`). What stays
``unattributed``: cuBLAS workspaces, the engines' small step buffers
(page table, step inputs) and anything no owner claims. No owner is
invented for them.

The census is exposed three ways, as in the reference: pull gauges
``mx_hbm_live_bytes_total`` / ``mx_hbm_live_bytes{owner=}`` /
``mx_hbm_unattributed_bytes`` (a collector, swept at report time and
only while armed); the :func:`census` report dict; and a flight-recorder
context probe, so every crash dump carries the memory map.

**Growth watchdog**: :func:`watchdog_observe` tracks unattributed bytes
across observations and warns (log + ``mx_hbm_watchdog_warnings_total`` +
trace event) on sustained growth; ``MXNET_MEMWATCH_INTERVAL=<sec>`` arms a
daemon thread that observes on a timer.

**OOM post-mortem**: :func:`maybe_oom_postmortem` sits at the serving
engine's and the gateway's failed-step seams; on an out-of-memory error
(``torch.cuda.OutOfMemoryError``, CUDA's out-of-memory error text, or
an injected ``RESOURCE_EXHAUSTED``) it dumps the flight recorder, whose
census and compile-ledger probes put the memory map and the program
history in the payload. Armed by ``MXNET_TELEMETRY`` or alone with
``MXNET_OOM_POSTMORTEM=1``.

Off-path contract: owner registration is a dict write; nothing sweeps
unless a census is requested (report pull while armed, watchdog tick,
crash dump, or explicit call).
"""
from __future__ import annotations

import gc
import logging
import os
import threading
import time

import torch

from . import registry, tracing
from .locks import tracked_lock

__all__ = ["enable", "disable", "is_enabled", "reset", "register_owner",
           "unregister_owner", "census", "watchdog_observe",
           "arm_memwatch", "disarm_memwatch", "is_resource_exhausted",
           "maybe_oom_postmortem"]

logger = logging.getLogger("incubator_mxnet_tpu_torch.telemetry.hbm")

_ENABLED = False
_LOCK = tracked_lock("telemetry.hbm", kind="lock")
_OWNERS: dict = {}            # name -> probe() (registration order wins ties)

# growth watchdog state
_WD_WINDOW = 5                # default N sustained-growth steps
_WD_MIN_GROWTH = 1 << 20      # ignore jitter below 1 MiB over the window
_WD_SAMPLES: list = []        # (unattributed bytes) ring, newest last
_WD_WARNED_STREAK = False
_MEMWATCH_THREAD = None
_MEMWATCH_STOP = None

# CUDA's and the caching allocator's out-of-memory error texts
_OOM_TEXTS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
              "CUDA_ERROR_OUT_OF_MEMORY", "cudaErrorMemoryAllocation")


def enable():
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def is_enabled():
    return _ENABLED


def reset():
    """Drop owners and watchdog state (tests). Leaves arming alone."""
    global _WD_WARNED_STREAK
    with _LOCK:
        _OWNERS.clear()
        del _WD_SAMPLES[:]
        _WD_WARNED_STREAK = False


# --------------------------------------------------------------------------
# owners + census
# --------------------------------------------------------------------------

def register_owner(name, probe):
    """Register a subsystem as a memory owner. ``probe()`` returns the
    tensors it currently owns — either an iterable, or a dict
    ``{"arrays": [...], "detail": {...}, "derived": {sub: bytes}}`` where
    `detail` is free-form context for the census report and `derived`
    attributes byte counts WITHIN the owner's tensors (e.g. the prefix
    cache's share of the KV pool pages) without counting them twice.
    Probes follow the weakly-bound-source idiom: return None once the
    subsystem is gone (the owner is then skipped). Re-registering a name
    replaces the probe."""
    with _LOCK:
        _OWNERS[str(name)] = probe


def unregister_owner(name):
    with _LOCK:
        _OWNERS.pop(str(name), None)


def _on_card():
    """Census the card when CUDA is up in this process, else the CPU."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _storage_key(t):
    """A tensor's storage identity: (device type, index, data_ptr)."""
    s = t.untyped_storage()
    return (t.device.type, t.device.index, s.data_ptr()), s.nbytes()


def _claims(owners, device_type):
    """Run the owner probes: ({storage key: (owner, nbytes, shape, dtype)},
    owner bytes, derived, detail). The first claim on a storage wins."""
    claim: dict = {}
    owner_bytes: dict = {}
    derived: dict = {}
    detail: dict = {}
    for name, probe in owners:
        try:
            got = probe()
        except Exception:
            got = None
        if got is None:
            continue
        if isinstance(got, dict):
            arrays = got.get("arrays") or ()
            if got.get("detail"):
                detail[name] = got["detail"]
            for sub, b in (got.get("derived") or {}).items():
                derived[f"{name}.{sub}"] = int(b)
        else:
            arrays = got
        owner_bytes.setdefault(name, 0)
        for a in arrays:
            if not isinstance(a, torch.Tensor) \
                    or a.device.type != device_type:
                continue
            key, nbytes = _storage_key(a)
            if key not in claim:
                claim[key] = (name, nbytes, tuple(a.shape), str(a.dtype))
                owner_bytes[name] += nbytes
        # hold no owner's tensors past its turn: a census on the sampler
        # thread must not keep a released replica's pools alive
        got = arrays = a = None
    return claim, owner_bytes, derived, detail


def graph_pool_bytes(snapshot, pools, claimed):
    """{owner: bytes} of the active blocks in the segments of the graphs'
    private pools (``pools``: {pool id: owner}, `_graphs.pool_owners`)
    whose address no owner claimed (``claimed``, a set of addresses)."""
    out: dict = {}
    for seg in snapshot:
        who = pools.get(tuple(seg.get("segment_pool_id") or ()))
        if who is None:
            continue
        for blk in seg.get("blocks", ()):
            if blk.get("state") == "active_allocated" \
                    and blk.get("address") not in claimed:
                out[who] = out.get(who, 0) + int(blk.get("size", 0))
    return out


def _card_sweep(claim, top_k, pools=None):
    """(total, n, tops, graph pools' bytes by owner) of the card: the
    caching allocator's counters and (only when ``top_k`` or ``pools``)
    its snapshot's active blocks."""
    total = n = 0
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        total += int(stats.get("allocated_bytes.all.current", 0))
        n += int(stats.get("active.all.current", 0))
    tops, by_pool = [], {}
    if top_k or pools:
        by_addr = {key[2]: (who, shape, dtype)
                   for key, (who, _b, shape, dtype) in claim.items()
                   if key[0] == "cuda"}
        snap = torch.cuda.memory_snapshot()
        if pools:
            by_pool = graph_pool_bytes(snap, pools, set(by_addr))
        for seg in snap if top_k else ():
            who = (pools or {}).get(tuple(seg.get("segment_pool_id") or ()))
            for blk in seg.get("blocks", ()):
                if blk.get("state") != "active_allocated":
                    continue
                owner, shape, dtype = by_addr.get(
                    blk.get("address"), (who, None, "?"))
                tops.append((int(blk.get("size", 0)), shape, dtype, owner))
    return total, n, tops, by_pool


def _cpu_sweep(claim, top_k):
    """(total, n, tops) of the live CPU tensors ``gc`` sees, each storage
    counted once."""
    seen = {}
    tensor = torch.Tensor
    for obj in gc.get_objects():
        # type(), not isinstance(): some module objects warn when their
        # __class__ is read
        if issubclass(type(obj), tensor) and obj.device.type == "cpu":
            try:
                key, nbytes = _storage_key(obj)
            except Exception:   # noqa: FL006 - a tensor without storage
                continue
            if key not in seen:
                seen[key] = (nbytes, tuple(obj.shape), str(obj.dtype))
    total = sum(b for b, _s, _d in seen.values())
    tops = []
    if top_k:
        for key, (b, shape, dtype) in seen.items():
            who = claim.get(key)
            tops.append((b, shape, dtype, None if who is None else who[0]))
    return total, len(seen), tops, {}


def census(top_k=8):
    """Attribute live device memory to the registered owners (first
    claim on a storage wins). Returns::

        {"total": bytes, "n_arrays": int,
         "owners": {name: bytes}, "derived": {name.sub: bytes},
         "detail": {name: {...}},  # owner-provided context
         "unattributed": bytes,
         "top": [{"bytes", "shape", "dtype", "owner"}, ...],  # largest K
         "ts": unix time}

    On the card ``total`` is the caching allocator's allocated bytes and
    ``top`` its largest active blocks; on the CPU both come from the live
    tensors. ``owners`` counts each claimed storage once."""
    with _LOCK:
        owners = list(_OWNERS.items())
    card = _on_card()
    claim, owner_bytes, derived, detail = _claims(
        owners, "cuda" if card else "cpu")
    try:
        if card:
            from .. import _graphs

            total, n, tops, by_pool = _card_sweep(claim, top_k,
                                                  _graphs.pool_owners())
        else:
            total, n, tops, by_pool = _cpu_sweep(claim, top_k)
    except Exception:
        total, n, tops, by_pool = 0, 0, [], {}
    for who, b in by_pool.items():
        owner_bytes[who] = owner_bytes.get(who, 0) + b
    attributed = sum(owner_bytes.values())
    report = {
        "total": total,
        "n_arrays": n,
        "owners": owner_bytes,
        "derived": derived,
        "detail": detail,
        "unattributed": max(0, total - attributed),
        "ts": time.time(),
    }
    if top_k:
        tops.sort(key=lambda t: -t[0])
        report["top"] = [
            {"bytes": b, "shape": shape, "dtype": dtype,
             "owner": who or "unattributed"}
            for b, shape, dtype, who in tops[:int(top_k)]]
    return report


def _collector():
    """Registry pull collector: the census as gauges, swept only at
    report()/exposition() time and only while armed."""
    if not _ENABLED:
        return {}
    try:
        c = census(top_k=0)
    except Exception:
        return {}
    out = {
        "mx_hbm_live_bytes_total": c["total"],
        "mx_hbm_live_arrays": c["n_arrays"],
        "mx_hbm_unattributed_bytes": c["unattributed"],
    }
    for name, b in c["owners"].items():
        out[f'mx_hbm_live_bytes{{owner="{name}"}}'] = b
    return out


def _flight_probe():
    """Flight-recorder context: census + top buffers in every crash dump
    (the OOM post-mortem payload). Swept at dump time regardless of
    arming — a crash dump should always carry the memory map."""
    try:
        return census(top_k=8)
    except Exception:
        return None


# --------------------------------------------------------------------------
# growth watchdog
# --------------------------------------------------------------------------

def watchdog_observe(window=None, min_growth=None):
    """Record one unattributed-bytes sample; warn when every step across
    the window grew and the total growth clears `min_growth` (default
    1 MiB over 5 samples). One warning per streak — the streak re-arms
    when growth pauses. Returns True when this observation warned."""
    global _WD_WARNED_STREAK
    window = int(window or _WD_WINDOW)
    floor = int(_WD_MIN_GROWTH if min_growth is None else min_growth)
    try:
        c = census(top_k=0)
    except Exception:
        return False
    with _LOCK:
        _WD_SAMPLES.append(c["unattributed"])
        del _WD_SAMPLES[:max(0, len(_WD_SAMPLES) - window)]
        samples = list(_WD_SAMPLES)
    if len(samples) < window:
        return False
    growing = all(b > a for a, b in zip(samples, samples[1:]))
    if not growing:
        _WD_WARNED_STREAK = False
        return False
    if samples[-1] - samples[0] < floor or _WD_WARNED_STREAK:
        return False
    _WD_WARNED_STREAK = True
    mb = (samples[-1] - samples[0]) / 2**20
    logger.warning(
        "device-memory watchdog: unattributed live bytes grew %d steps in "
        "a row (+%.1f MiB, now %.1f MiB) — possible leak outside "
        "registered owners; run telemetry.hbm.census()",
        window, mb, samples[-1] / 2**20)
    registry.counter("mx_hbm_watchdog_warnings_total",
                     "sustained unattributed HBM growth warnings").inc()
    tracing.event("hbm.growth", steps=window, grew_bytes=int(mb * 2**20),
                  unattributed=samples[-1])
    return True


def arm_memwatch(interval_s):
    """Start (or replace) the daemon sampling thread behind
    ``MXNET_MEMWATCH_INTERVAL`` — one watchdog observation every
    `interval_s` seconds. Returns the thread."""
    global _MEMWATCH_THREAD, _MEMWATCH_STOP
    disarm_memwatch()
    stop = threading.Event()

    def _loop():
        while not stop.wait(float(interval_s)):
            try:
                watchdog_observe()
            except Exception as e:  # noqa: FL006 — a broken owner probe
                # must not kill the watchdog timer thread; surface once
                # per tick at debug so a bad probe is still discoverable
                logger.debug("memwatch tick failed: %s", e)

    t = threading.Thread(target=_loop, name="mx-memwatch", daemon=True)
    _MEMWATCH_STOP = stop
    _MEMWATCH_THREAD = t
    t.start()
    return t


def disarm_memwatch():
    global _MEMWATCH_THREAD, _MEMWATCH_STOP
    if _MEMWATCH_STOP is not None:
        _MEMWATCH_STOP.set()
    _MEMWATCH_THREAD = None
    _MEMWATCH_STOP = None


# --------------------------------------------------------------------------
# OOM post-mortem
# --------------------------------------------------------------------------

def is_resource_exhausted(exc):
    """True for out-of-memory failures: ``torch.cuda.OutOfMemoryError``,
    or an error whose text is CUDA's or the caching allocator's
    out-of-memory message or carries ``RESOURCE_EXHAUSTED`` (the injected
    ``oom`` fault's)."""
    if exc is None:
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    try:
        s = f"{type(exc).__name__}: {exc}"
    except Exception:
        return False
    return any(t in s for t in _OOM_TEXTS)


def _postmortem_armed():
    v = os.environ.get("MXNET_OOM_POSTMORTEM")
    if v is not None:
        return v.strip().lower() not in ("", "0", "false", "off", "no")
    return _ENABLED


def maybe_oom_postmortem(where, exc):
    """Failure-seam hook (the engine's and the gateway's step): when
    `exc` is an out-of-memory error and the post-mortem is armed, dump
    the flight recorder — the census and compile-ledger context probes
    put the memory map and program history in the payload. Returns the
    dump path (None when not an OOM, disarmed, or the dump itself failed
    — a broken post-mortem must never mask the OOM)."""
    if not is_resource_exhausted(exc) or not _postmortem_armed():
        return None
    try:
        registry.counter("mx_oom_postmortems_total",
                         "RESOURCE_EXHAUSTED post-mortem flight dumps").inc()
        registry.counter("mx_oom_postmortems_total",
                         "RESOURCE_EXHAUSTED post-mortem flight dumps",
                         labels={"where": str(where)}).inc()
        return tracing.flight_dump(f"oom_{where}", exc=exc)
    except Exception:
        return None


# census gauges + crash-dump context ride along from import: collectors
# are pull-only (dead until a report is actually read) and the flight
# probe only runs at dump time
registry.register_collector(_collector)
tracing.register_flight_context("hbm_census", _flight_probe)
