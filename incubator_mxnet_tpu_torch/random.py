"""The framework's random keys (port of `incubator_mxnet_tpu/random.py`,
`seed` :69, `next_key` :88).

The reference splits a JAX PRNG key for every random op. The port keeps
one CPU `torch.Generator` on the host and draws two uint32 words from it
per :func:`next_key`: a dropout kernel's Philox key (`ops/_philox.py`).
Nothing here reads from the card, so drawing a key never synchronises
with it. :func:`seed` re-seeds the generator, so a seeded run draws the
same keys, and with them the same masks, on the card and on the CPU.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "next_key"]

_LOCK = threading.Lock()
_GEN = torch.Generator(device="cpu")
_GEN.manual_seed(0)


def seed(seed_state: int):
    """Seed the framework's key stream (reference: ``mx.random.seed``)."""
    with _LOCK:
        _GEN.manual_seed(int(seed_state))


def next_key():
    """A fresh key: a tuple of two ints, each < 2**32."""
    with _LOCK:
        words = torch.randint(0, 2 ** 32, (2,), generator=_GEN,
                              dtype=torch.int64)
    return int(words[0]), int(words[1])
