"""The framework's random keys (port of `incubator_mxnet_tpu/random.py`,
`seed` :69, `seed_epoch` :77, `next_key` :88, `trace_key_scope` :102).

The reference splits a JAX PRNG key for every random op. The port keeps
one CPU `torch.Generator` on the host and draws two uint32 words from it
per :func:`next_key`: a dropout kernel's Philox key (`ops/_philox.py`).
Nothing here reads from the card, so drawing a key never synchronises
with it. :func:`seed` re-seeds the generator, so a seeded run draws the
same keys, and with them the same masks, on the card and on the CPU.

Inside a :class:`trace_key_scope` (a compiled step: `parallel.DataParallel`)
:func:`next_key` draws no host words. It returns an `ops._philox.DeviceKey`
for the next site of the step instead: the scope's base key and step
counter, device tensors that the step's replays read anew, and the
site's index, counted per scope as the reference's frame ``[base_key,
counter]`` counts it.
"""
from __future__ import annotations

import threading

import torch

from .ops._philox import DeviceKey

__all__ = ["seed", "seed_epoch", "next_key", "trace_key_scope"]

_LOCK = threading.Lock()
_GEN = torch.Generator(device="cpu")
_GEN.manual_seed(0)
_EPOCH = 0


class _Frames(threading.local):
    def __init__(self):
        self.stack = []  # the open trace_key_scope objects, innermost last


_FRAMES = _Frames()


def seed(seed_state: int):
    """Seed the framework's key stream (reference: ``mx.random.seed``).
    Bumps :func:`seed_epoch` and restarts the site count of every open
    :class:`trace_key_scope`."""
    global _EPOCH
    with _LOCK:
        _GEN.manual_seed(int(seed_state))
        _EPOCH += 1
    for frame in _FRAMES.stack:
        frame.counter = 0


def seed_epoch() -> int:
    """How many times :func:`seed` has been called: a compiled step whose
    base key predates the last seed draws a new one."""
    return _EPOCH


def next_key():
    """A fresh key: a tuple of two ints, each < 2**32; inside a
    :class:`trace_key_scope`, the scope's next site as a
    `ops._philox.DeviceKey`."""
    if _FRAMES.stack:
        return _FRAMES.stack[-1].next_site()
    with _LOCK:
        words = torch.randint(0, 2 ** 32, (2,), generator=_GEN,
                              dtype=torch.int64)
    return int(words[0]), int(words[1])


class trace_key_scope:
    """Dropout keys of one step drawn on its device: ``base_key`` (an int64
    tensor of two words, each < 2**32) and ``t`` (a 0-dim int64 tensor) on
    the step's device. The n-th :func:`next_key` of the scope is site n,
    whose key is ``fold(fold(base_key, t), n)`` (`ops._philox.fold`)."""

    def __init__(self, base_key, t):
        self.base_key, self.t = base_key, t
        self.counter = 0
        # the card's table of site keys, by chunk (ops.dropout.site_key_ptr)
        self.tables = {}

    def next_site(self):
        key = DeviceKey(self.base_key, self.t, self.counter, self.tables)
        self.counter += 1
        return key

    def __enter__(self):
        _FRAMES.stack.append(self)
        return self

    def __exit__(self, *exc):
        _FRAMES.stack.pop()
        return False
