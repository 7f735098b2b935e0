"""Multi-process runtime and its host-level collectives (port of
`incubator_mxnet_tpu/parallel/dist.py`: `initialize` :109, `allreduce`
:267, `broadcast` :491, `barrier` :515, `exchange_objs` :539, the
membership epochs :199-238 and `rendezvous` :598-802).

The reference joins `jax.distributed` through its coordination service.
The port joins a `torch.distributed` world: a `TCPStore` at the
coordinator's address is the rendezvous and the key-value store the
membership epochs keep their keys in, and the process group's backend is
explicit: NCCL for CUDA, gloo for the CPU (``backend=``; the default is
NCCL where a card is present). `initialize` reads the reference's
environment names (``COORDINATOR_ADDRESS`` or ``DMLC_PS_ROOT_URI`` and
``DMLC_PS_ROOT_PORT``, ``NUM_PROCESSES`` or ``DMLC_NUM_WORKER``,
``PROCESS_ID`` or ``DMLC_RANK``), so `tools/launch.py` starts the port's
workers as it starts the reference's. ``init_method`` (a ``file://``
path, a `FileStore`) serves worlds that need no port, as the tests'.

`allreduce`, `broadcast`, `barrier` and `exchange_objs` act on
host-level values (tensors or arrays, not inside a compiled step) over
the current membership: the world's process group, or after a
transition the store, as the reference's subset collectives ride its
coordination service (a new process group of the survivors would need
every rank of the world to make it). Each checks the caller's generation first
(:func:`check_generation`), and a rank whose fleet has committed a newer
epoch raises :class:`StaleGenerationError` before it enters the
transport, so it fails instead of hanging its peers.

The chaos seams are the reference's: ``dist_init`` at each join attempt,
retried under the ``dist_init`` `RetryPolicy`, and ``collective_delay``
(``_FAULT_HOOK``) at every `allreduce`. The fleet plane's profiler
(``_PROF``, armed by `telemetry.fleet.enable`) times each of the four
collectives and probes the barrier's arrival skew; both hooks are
module globals that stay None, a dead branch, while off.
"""
from __future__ import annotations

import logging
import os
import pickle
import time

import numpy as onp
import torch

__all__ = ["initialize", "is_initialized", "rank", "num_processes",
           "allreduce", "broadcast", "barrier", "exchange_objs",
           "generation", "active_ranks", "world_size", "is_active",
           "check_generation", "rendezvous", "pending_departures",
           "pending_rejoins", "StaleGenerationError"]

_LOG = logging.getLogger("incubator_mxnet_tpu_torch.parallel.dist")

_STATE = {"initialized": False,
          "generation": 0,       # membership epoch counter
          "members": None,       # None = every process; tuple after shrink
          "host_seq": 0}         # store-transport collectives issued
_TIMEOUT_S = 120.0
_PFX = "mx/elastic"


class StaleGenerationError(RuntimeError):
    """A collective was entered under a membership generation that has
    been superseded (or by a rank no longer in the membership): its peers
    re-rendezvoused and will never join it, so it raises instead of
    blocking. Not retryable (``non_retryable``)."""

    non_retryable = True

    def __init__(self, held, current, why="generation superseded"):
        super().__init__(
            f"dist: stale membership — {why} (held generation {held}, "
            f"current {current}); the fleet re-rendezvoused without this "
            "rank. Re-join via dist.rendezvous() or exit cleanly.")
        self.held = held
        self.current = current


def _transient_rendezvous(exc):
    """Retryable join failures: injected faults and connection or
    timeout errors; a double initialisation is a state, not a fault."""
    from ..fault.injection import FaultInjected

    if isinstance(exc, (FaultInjected, ConnectionError, TimeoutError,
                        OSError)):
        return True
    msg = str(exc).lower()
    return isinstance(exc, RuntimeError) and any(
        s in msg for s in ("unavailable", "deadline", "timed out",
                           "timeout", "connect", "refused", "unreachable"))


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return v
    return default


def _tdist():
    import torch.distributed as tdist

    return tdist


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, init_method=None):
    """Join the multi-process world (idempotent).

    ``coordinator_address`` ("host:port", rank 0 serves the store there)
    and the counts fall back to the reference's environment names. With
    neither an address nor ``init_method`` this is a single process and
    nothing is joined. ``backend``: "nccl" or "gloo" (default NCCL where
    a card is present, else gloo)."""
    tdist = _tdist()
    if _STATE["initialized"] or tdist.is_initialized():
        _STATE["initialized"] = True
        return
    coordinator_address = coordinator_address or _env("COORDINATOR_ADDRESS")
    if coordinator_address is None:
        uri = _env("DMLC_PS_ROOT_URI")
        port = _env("DMLC_PS_ROOT_PORT", default="9000")
        if uri is not None:
            coordinator_address = f"{uri}:{port}"
    if num_processes is None:
        v = _env("NUM_PROCESSES", "DMLC_NUM_WORKER")
        num_processes = int(v) if v is not None else None
    if process_id is None:
        v = _env("PROCESS_ID", "DMLC_RANK")
        process_id = int(v) if v is not None else None
    if coordinator_address is None and init_method is None:
        return  # single-process: nothing to join
    if num_processes is None or process_id is None:
        raise ValueError("dist.initialize: a coordinator needs "
                         "num_processes and process_id (or NUM_PROCESSES "
                         "and PROCESS_ID)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    from ..fault import injection
    from ..fault.retry import RetryExhausted, RetryPolicy

    def _join():
        injection.inject_at("dist_init")      # chaos seam
        if backend == "nccl":
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        if init_method is not None:
            tdist.init_process_group(backend, init_method=init_method,
                                     world_size=num_processes,
                                     rank=process_id)
            return
        host, port = coordinator_address.rsplit(":", 1)
        store = tdist.TCPStore(host, int(port), num_processes,
                               is_master=process_id == 0,
                               timeout=_timedelta(_TIMEOUT_S))
        tdist.init_process_group(backend, store=store,
                                 world_size=num_processes, rank=process_id)

    try:
        RetryPolicy.from_env("dist_init",
                             retryable=_transient_rendezvous).call(_join)
    except (RuntimeError, ValueError) as e:
        last = e.last if isinstance(e, RetryExhausted) else e
        if num_processes == 1:
            _LOG.warning("dist.initialize: rendezvous failed but "
                         "num_processes=1 — continuing single-process: %s",
                         last)
            return
        raise RuntimeError(
            f"torch.distributed.init_process_group failed (coordinator "
            f"{coordinator_address or init_method}, num_processes="
            f"{num_processes}): {last}") from e
    _STATE["initialized"] = True


def _timedelta(seconds):
    import datetime

    return datetime.timedelta(seconds=seconds)


def _shutdown():
    """Leave the world: destroy every process group and reset the
    membership (a later `initialize` joins anew)."""
    tdist = _tdist()
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _STATE["initialized"] = False
    _reset_membership()


def is_initialized():
    return _STATE["initialized"] and _tdist().is_initialized()


def rank():
    return _tdist().get_rank() if is_initialized() else 0


def num_processes():
    return _tdist().get_world_size() if is_initialized() else 1


def generation():
    """Current membership-epoch number (0 until the first transition)."""
    return _STATE["generation"]


def active_ranks():
    """Ranks in the current membership, sorted (every process before any
    transition)."""
    if _STATE["members"] is not None:
        return _STATE["members"]
    return tuple(range(num_processes()))


def world_size():
    """Size of the current membership."""
    return len(active_ranks())


def is_active():
    """Is this process in the current membership? False after it left
    through ``rendezvous(leave=True)``."""
    members = _STATE["members"]
    return members is None or rank() in members


def check_generation(generation_, op="collective"):
    """The membership guard each collective runs before the transport: a
    superseded ``generation_`` or a departed rank raises
    :class:`StaleGenerationError`; ``generation_=None`` checks the
    membership only."""
    cur = _STATE["generation"]
    if generation_ is not None and int(generation_) != cur:
        raise StaleGenerationError(int(generation_), cur,
                                   why=f"{op} under a superseded epoch")
    if not is_active():
        raise StaleGenerationError(
            cur if generation_ is None else int(generation_), cur,
            why=f"{op} from a rank outside the membership")


def _store():
    return _tdist().distributed_c10d._get_default_store()


def _fleet_generation():
    """The highest generation any rank has committed, or None."""
    store = _store()
    g = _STATE["generation"]
    best = None
    while store.check([f"{_PFX}/commit/g{g + 1}"]):
        g += 1
        best = g
    return best


def _host_allgather(payload, tag):
    """Each member's bytes, in rank order, through the store (the
    reference's coordination-service transport, which subset collectives
    ride there too): a member posts under a per-collective key, reads the
    others' (a blocking get), and deletes its key once every member has
    read. The members issue collectives in the same order, so their
    counters agree; the keys carry the generation."""
    store = _store()
    me, members = rank(), active_ranks()
    _STATE["host_seq"] += 1
    pfx = f"mx/hostcoll/g{_STATE['generation']}/{tag}/{_STATE['host_seq']}"
    store.set(f"{pfx}/{me:03d}", payload)
    blobs = [bytes(store.get(f"{pfx}/{r:03d}")) for r in members]
    store.add(f"{pfx}/done", 1)
    deadline = time.monotonic() + _TIMEOUT_S
    while int(store.add(f"{pfx}/done", 0)) < len(members):
        if time.monotonic() > deadline:
            raise TimeoutError(f"dist: {tag} #{_STATE['host_seq']} timed "
                               f"out waiting for {members}")
        time.sleep(0.001)
    store.delete_key(f"{pfx}/{me:03d}")
    return blobs


def _host_allreduce(t, op):
    arr = t.detach().cpu().numpy()
    vals = [onp.frombuffer(b, dtype=arr.dtype).reshape(arr.shape)
            for b in _host_allgather(arr.tobytes(), "allreduce")]
    stack = onp.stack(vals)
    out = stack.max(axis=0) if op == "max" else stack.sum(axis=0)
    return torch.from_numpy(out.astype(arr.dtype)).to(t.device)


def _as_tensor(x):
    from ..ndarray.ndarray import NDArray

    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(onp.asarray(x))


def _enter(op, generation_):
    """The guard before any transport: the generation, then the fleet's
    committed epoch (a rank that missed a transition raises)."""
    check_generation(generation_, op=op)
    fh = _FAULT_HOOK
    if fh is not None:
        fh()          # fires single-process too
    if num_processes() == 1:
        return False
    fleet = _fleet_generation()
    if fleet is not None and fleet > _STATE["generation"]:
        raise StaleGenerationError(
            _STATE["generation"], fleet,
            why="the fleet committed a newer membership epoch")
    return True


def allreduce(x, op="sum", generation=None):
    """Reduce a host-level value over the current membership ("sum",
    "mean" or "max"); every member gets the result as a tensor on the
    value's device. One process: ``x`` as a tensor."""
    t = _as_tensor(x)
    if not _enter("allreduce", generation):
        return t.clone()
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"dist.allreduce: unknown op {op!r}")
    prof = _PROF
    if prof is None:
        return _allreduce_impl(t, op)
    with prof.dist_op("allreduce", t.numel() * t.element_size(), red=op):
        return _allreduce_impl(t, op)


def _allreduce_impl(t, op):
    if _STATE["members"] is not None:
        # a membership after a transition rides the store: a new process
        # group would need every rank of the world to make it
        out = _host_allreduce(t, op)
    else:
        from .collectives import _exchange

        tdist = _tdist()
        out = t.clone()
        rop = tdist.ReduceOp.MAX if op == "max" else tdist.ReduceOp.SUM
        _exchange(None, lambda o: tdist.all_reduce(o, rop), out)
    if op == "mean":
        out = (out / world_size()).to(t.dtype if t.is_floating_point()
                                      else torch.float32)
    return out


def broadcast(x, root=0, generation=None):
    """Root's host-level value on every member process."""
    t = _as_tensor(x)
    if num_processes() == 1:
        check_generation(generation, op="broadcast")
        return t.clone()
    contrib = t if rank() == root else torch.zeros_like(t)
    prof = _PROF
    if prof is None:
        return allreduce(contrib, op="sum", generation=generation)
    with prof.dist_op("broadcast", t.numel() * t.element_size(), root=root):
        return allreduce(contrib, op="sum", generation=generation)


def barrier(tag="barrier", generation=None):
    check_generation(generation, op="barrier")
    if num_processes() > 1:
        prof = _PROF
        if prof is None:
            allreduce(torch.zeros(1), generation=generation)
        else:
            # the fleet plane times the barrier and exchanges arrival
            # times (the straggler signal, `telemetry.fleet`)
            prof.barrier_probe(tag, lambda: allreduce(
                torch.zeros(1), generation=generation))


_EXCHANGE_OVERSIZE = "__exchange_objs_oversize__"


def exchange_objs(obj, max_bytes=4096, generation=None):
    """Each member's small picklable object, as a list indexed by rank
    (None at ranks outside the membership). An object over ``max_bytes``
    raises on every rank, after the exchange (raising before it would
    leave the peers blocked)."""
    check_generation(generation, op="exchange_objs")
    if not is_initialized() or num_processes() == 1:
        return [obj]
    payload = pickle.dumps(obj)
    if len(payload) > max_bytes - 4:
        obj = _EXCHANGE_OVERSIZE
    _enter("exchange_objs", generation)
    prof = _PROF
    if prof is None:
        return _exchange_objs_impl(obj, max_bytes)
    with prof.dist_op("exchange_objs", num_processes() * max_bytes):
        return _exchange_objs_impl(obj, max_bytes)


def _exchange_objs_impl(obj, max_bytes):
    members = active_ranks()
    if _STATE["members"] is not None:
        got = [pickle.loads(b) for b in
               _host_allgather(pickle.dumps(obj), "exchange_objs")]
    else:
        got = [None] * len(members)
        _tdist().all_gather_object(got, obj)
    out = [None] * num_processes()
    for r, o in zip(members, got):
        out[r] = o
    if any(o == _EXCHANGE_OVERSIZE for o in got):
        raise ValueError(
            f"exchange_objs: a rank's object exceeded the {max_bytes}-byte "
            "command slot (all ranks raised after the collective)")
    return out


def rendezvous(min_ranks=1, timeout_s=None, settle_s=None, leave=False):
    """Agree on the surviving membership after a topology change and bump
    :func:`generation`; returns ``(generation, members)``.

    Survivors post join keys under the next generation's prefix in the
    store, poll the roster until it is stable for ``settle_s`` (and has
    at least ``min_ranks``), then meet at a commit count over exactly that
    roster; an attempt that times out is retried under the
    ``elastic_rendezvous`` policy. The committed generation is recorded,
    so a rank that missed it raises at its next collective.
    ``leave=True`` is the departing side: it posts a departure marker,
    turns stale and returns at once. A rank that left and calls
    ``rendezvous()`` again is re-admitted: it adopts the fleet's
    generation and posts a re-admission marker (:func:`pending_rejoins`).
    One process turns the epoch over in place."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("MXNET_ELASTIC_DRAIN_S", "20"))
    if settle_s is None:
        settle_s = min(0.5, max(0.05, timeout_s / 8))
    next_gen = _STATE["generation"] + 1
    rejoin = not leave and not is_active()
    if not is_initialized() or num_processes() == 1:
        _STATE["generation"] = next_gen
        _STATE["members"] = () if leave else None
        if rejoin:
            _count_readmission()
        return next_gen, (() if leave else active_ranks())
    store = _store()
    me = rank()
    if rejoin:
        fleet = _fleet_generation()
        if fleet is not None:
            next_gen = max(next_gen, fleet + 1)
        store.delete_key(f"{_PFX}/leave/{me:03d}")
        store.set(f"{_PFX}/rejoin/{me:03d}", "1")
        _LOG.info("dist.rendezvous: rank %d re-admitting at generation %d",
                  me, next_gen)
    pfx = f"{_PFX}/g{next_gen}"
    if leave:
        store.set(f"{_PFX}/leave/{me:03d}", "1")
        _STATE["generation"] = next_gen
        _STATE["members"] = ()
        _LOG.info("dist.rendezvous: rank %d leaving at generation %d",
                  me, next_gen)
        return next_gen, ()

    from ..fault.retry import RetryPolicy
    from ..telemetry import tracing

    attempts = [0]

    def _attempt():
        attempts[0] += 1
        store.set(f"{pfx}/join/{me:03d}", "1")
        deadline = time.monotonic() + timeout_s
        roster, stable_since = None, None
        while True:
            ranks = tuple(r for r in range(num_processes())
                          if store.check([f"{pfx}/join/{r:03d}"]))
            now = time.monotonic()
            if ranks != roster:
                roster, stable_since = ranks, now
            elif (len(roster) >= max(1, int(min_ranks))
                  and now - stable_since >= settle_s):
                break
            if now >= deadline:
                raise TimeoutError(
                    f"dist.rendezvous: generation {next_gen} roster did "
                    f"not settle within {timeout_s}s (last seen {roster}"
                    f", min_ranks={min_ranks})")
            time.sleep(0.02)
        # the commit over exactly the settled roster: each member counts
        # itself in and waits for the roster's count
        key = f"{pfx}/commit/{'-'.join(map(str, roster))}/{attempts[0]}"
        store.add(key, 1)
        while int(store.add(key, 0)) < len(roster):
            if time.monotonic() >= deadline + max(1.0, timeout_s):
                raise TimeoutError(f"dist.rendezvous: generation "
                                   f"{next_gen} commit timed out")
            time.sleep(0.02)
        return roster

    with tracing.span("elastic.rendezvous", generation=next_gen):
        roster = RetryPolicy.from_env(
            "elastic_rendezvous",
            retryable=_transient_rendezvous).call(_attempt)
    _STATE["generation"] = next_gen
    _STATE["members"] = roster
    _STATE["host_seq"] = 0
    store.set(f"{_PFX}/commit/g{next_gen}", "1")
    if rejoin:
        store.delete_key(f"{_PFX}/rejoin/{me:03d}")
        _count_readmission()
    _LOG.info("dist.rendezvous: generation %d committed, members=%s",
              next_gen, roster)
    return next_gen, roster


def pending_departures():
    """Ranks that posted a departure marker but are still in the active
    membership (sorted; empty in one process)."""
    if not is_initialized() or num_processes() == 1:
        return ()
    store = _store()
    return tuple(r for r in active_ranks()
                 if store.check([f"{_PFX}/leave/{r:03d}"]))


def pending_rejoins():
    """Ranks that posted a re-admission marker and are not yet in the
    active membership (sorted; empty in one process)."""
    if not is_initialized() or num_processes() == 1:
        return ()
    store = _store()
    active = set(active_ranks())
    return tuple(r for r in range(num_processes())
                 if r not in active
                 and store.check([f"{_PFX}/rejoin/{r:03d}"]))


def _count_readmission():
    from ..telemetry import registry

    registry.counter(
        "mx_elastic_readmissions_total",
        "ranks re-admitted into a larger membership at a later epoch "
        "(the grow direction of an elastic transition)").inc()


def _reset_membership():
    """Test hook: restore the pristine epoch-0 full membership."""
    _STATE["generation"] = 0
    _STATE["members"] = None
    _STATE["host_seq"] = 0


_FAULT_HOOK = None   # fault.injection._arm_hot_hooks: collective_delay seam
_PROF = None         # telemetry.fleet.enable(): the collective profiler


def _rearm_hooks():
    import sys

    pkg = __name__.rsplit(".", 2)[0]
    inj = sys.modules.get(pkg + ".fault.injection")
    if inj is not None:
        inj._arm_hot_hooks()
    fleet = sys.modules.get(pkg + ".telemetry.fleet")
    if fleet is not None:
        fleet._arm()


_rearm_hooks()
