"""The framework's random keys (port of `incubator_mxnet_tpu/random.py`,
`rng_impl` :47, `seed` :69, `seed_epoch` :77, `get_state` :82,
`next_key` :88, `trace_key_scope` :102).

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

Under sharding (`parallel`), a :class:`fold_key_scope` folds a shard's
coordinate into the keys of the sites drawn inside it, so that shards of
one activation draw distinct masks while replicas draw the same one.
"""
from __future__ import annotations

import threading

import torch

from .ops._philox import DeviceKey

__all__ = ["seed", "seed_epoch", "next_key", "host_seed", "trace_key_scope",
           "fold_key_scope", "get_state", "rng_impl"]

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


def rng_impl() -> str:
    """The name of the bit generator the keys feed: "philox" (the
    kernels' `ops/_philox.py`; the reference answers "threefry" or "rbg",
    an accepted divergence, `ROADMAP.md` §3)."""
    return "philox"


def get_state():
    """The key source's state: a copy of the host generator's state (a
    uint8 tensor). ``seed(s)`` then ``get_state()`` gives the same state
    every time, and no key is drawn by reading it."""
    with _LOCK:
        return _GEN.get_state().clone()


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
    return _host_words()


def _host_words():
    with _LOCK:
        words = torch.randint(0, 2 ** 32, (2,), generator=_GEN,
                              dtype=torch.int64)
    return int(words[0]), int(words[1])


def host_seed() -> int:
    """A seed for a `torch.Generator` from the next two host words of the
    key stream (inside a `trace_key_scope` too): initializers draw from
    it, so ``seed(s)`` reproduces an ``initialize()``."""
    w0, w1 = _host_words()
    return ((w0 << 32) | w1) & ((1 << 63) - 1)


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


class fold_key_scope:
    """The sites drawn inside take the enclosing key folded with ``n``
    (an int >= 0): inside a :class:`trace_key_scope`, the scope's base
    key is folded, ``fold(base, n)``, and the sites keep the enclosing
    scope's count, so a site's number is what it would be without this
    scope; outside one, each host key is folded with ``n``. The
    sequence-sharded regions of `parallel` fold a rank's coordinate along
    the sharding axis in, so each shard draws its own mask."""

    def __init__(self, n):
        self.n = int(n)
        self.outer = None    # an enclosing fold_key_scope
        self.parent = None   # the trace_key_scope whose sites count on
        self.base = None
        self.tables = {}

    def next_site(self):
        from .ops._philox import fold

        if self.parent is None:
            inner = (self.outer.next_site() if self.outer is not None
                     else _host_words())
            words = fold(inner, self.n)
            return int(words[0]), int(words[1])
        key = DeviceKey(self.base, self.parent.t, self.parent.counter,
                        self.tables)
        self.parent.counter += 1
        return key

    def __enter__(self):
        from .ops._philox import fold

        top = _FRAMES.stack[-1] if _FRAMES.stack else None
        if isinstance(top, fold_key_scope):
            self.outer = top
            self.parent, base = top.parent, top.base
        else:
            self.parent, base = top, (top.base_key if top is not None else None)
        if self.parent is not None:
            t = self.parent.t
            self.base = torch.stack(fold((base[0], base[1]),
                                         torch.full_like(t, self.n)))
        _FRAMES.stack.append(self)
        return self

    def __exit__(self, *exc):
        _FRAMES.stack.pop()
        return False
