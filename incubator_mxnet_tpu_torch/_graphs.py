"""CUDA-graph capture, shared by the port's compiled paths: the training
step of `parallel.DataParallel`, the calls of a hybridized
`gluon.HybridBlock` (the counterparts of the reference's jitted programs)
and the serving engine's steps (`serve.engine`).

The pattern is one: the first :data:`EAGER_CALLS` calls of an input
signature run eagerly, on a side stream (:class:`SideStream`), so that
everything a kernel wrapper does once has happened; the next call captures
(:func:`capture`) and replays; later calls copy their inputs into the
capture's static buffers and replay. A capture that fails raises
:class:`MXNetError`: nothing falls back to the eager path. Python's
cyclic collector does not run inside a capture (`torch.cuda.graph`
collects just before it begins): a finalizer it ran there could free a
CUDA resource, another graph or a block recorded on another stream,
which invalidates the capture.

A :class:`Graph` keeps the launch log of its capture (:func:`logging_launches`:
each port kernel's ``(kernel, bytes, flops)``, `ops._build.LAUNCH_LOG`),
since a replay runs no Python: while the profiler's log is open, each
replay appends the capture's entries to it, so a profiled replay carries
the kernels' costs. Each graph's private memory pool is registered under
its owner's name (:func:`register_pool`) for the device-memory census
(`telemetry.hbm`).
"""
from __future__ import annotations

import contextlib
import gc
import weakref

import torch

from .base import MXNetError
from .ops import _build

__all__ = ["EAGER_CALLS", "SideStream", "Graph", "capture",
           "logging_launches", "register_pool", "pool_owners",
           "count_flops"]

EAGER_CALLS = 1  # a signature's eager calls before its capture

# pool id -> (weakref to the graph that owns it, owner name)
_POOLS: dict = {}


class SideStream:
    """Runs a function on a side stream of its device, ordered after the
    current stream's work and before its next."""

    def __init__(self):
        self._streams = {}

    def run(self, device, fn):
        side = self._streams.get(device)
        if side is None:
            side = self._streams[device] = torch.cuda.Stream(device)
        main = torch.cuda.current_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn()
        main.wait_stream(side)
        return out


class Graph(torch.cuda.CUDAGraph):
    """A CUDA graph with the launch log of its capture (``launch_log``, a
    list of ``(kernel, bytes, flops)``): a replay appends it, as one
    list, to the open launch log, if any (one global load and an ``is
    None`` test when none is), and counts itself in ``Graph.replays``."""

    launch_log: list = []
    replays = 0     # replays of every Graph (the registry's cache hits)

    def replay(self):
        super().replay()
        Graph.replays += 1
        log = _build.LAUNCH_LOG
        if log is not None and self.launch_log:
            log.append(self.launch_log)


@contextlib.contextmanager
def logging_launches(graph):
    """Collect the port kernels' launches made inside the block into
    ``graph.launch_log`` (the capture's), instead of the launch log open
    around it: a captured launch runs on the card only when the graph
    replays."""
    saved = _build.LAUNCH_LOG
    log = _build.LAUNCH_LOG = []
    try:
        yield log
    finally:
        _build.LAUNCH_LOG = saved
        graph.launch_log = log


def capture(fn, what, pool=None, owner=None):
    """``(graph, fn())`` with ``fn`` captured into a new :class:`Graph` (in
    ``pool``, a graph's memory pool, when given); raises
    :class:`MXNetError` naming ``what`` when the capture fails. ``owner``
    names the graph's pool in the memory census."""
    graph = Graph()
    collecting = gc.isenabled()
    try:
        with logging_launches(graph), torch.cuda.graph(graph, pool=pool):
            gc.disable()
            out = fn()
    except Exception as e:
        raise MXNetError(f"{what}: capturing as a CUDA graph failed: "
                         f"{e}") from e
    finally:
        if collecting:
            gc.enable()
    if owner is not None and pool is None:
        register_pool(graph, owner)
    return graph, out


def register_pool(graph, owner):
    """Name ``graph``'s private memory pool ``owner`` for the census
    (`telemetry.hbm`), for as long as the graph lives."""
    try:
        pid = tuple(graph.pool())
    except Exception:   # noqa: FL006 - a graph with no pool yet
        return
    _POOLS[pid] = (weakref.ref(graph), str(owner))


def pool_owners():
    """``{pool id: owner}`` of the live graphs' private pools."""
    out = {}
    for pid, (ref, owner) in list(_POOLS.items()):
        if ref() is None:
            _POOLS.pop(pid, None)
        else:
            out[pid] = owner
    return out


def count_flops(fn):
    """``(fn(), flops)``: the torch operations' FLOPs of one run of ``fn``
    (forward and backward), counted by ``torch.utils.flop_counter``. The
    port's kernels are not torch operations: their costs come from the
    launch log."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    return out, int(counter.get_total_flops())
