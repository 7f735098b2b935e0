"""CUDA-graph capture, shared by the port's compiled paths: the training
step of `parallel.DataParallel` and the calls of a hybridized
`gluon.HybridBlock` (the counterparts of the reference's jitted programs).

The pattern is one: the first :data:`EAGER_CALLS` calls of an input
signature run eagerly, on a side stream (:class:`SideStream`), so that
everything a kernel wrapper does once has happened; the next call captures
(:func:`capture`) and replays; later calls copy their inputs into the
capture's static buffers and replay. A capture that fails raises
:class:`MXNetError`: nothing falls back to the eager path.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["EAGER_CALLS", "SideStream", "capture"]

EAGER_CALLS = 1  # a signature's eager calls before its capture


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


def capture(fn, what, pool=None):
    """``(graph, fn())`` with ``fn`` captured into a new CUDA graph (in
    ``pool``, a graph's memory pool, when given); raises
    :class:`MXNetError` naming ``what`` when the capture fails."""
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
    except Exception as e:
        raise MXNetError(f"{what}: capturing as a CUDA graph failed: "
                         f"{e}") from e
    return graph, out
