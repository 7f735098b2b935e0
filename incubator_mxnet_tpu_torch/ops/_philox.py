"""Philox4x32-10 in plain PyTorch: the dropout masks of the CUDA kernels.

The kernels (``csrc/philox.cuh``, drawn by ``csrc/dropout.cu`` and
``csrc/fused_block.cu``) and this module compute the same bits: the key is
a framework key's two 32-bit words, the counter is an element's flat index,
and element ``i`` takes word ``i % 4`` of the block drawn at counter
``i // 4``. A mask depends on the key and the element's index only, never
on launch shapes. An element is kept where its word is >= the threshold
``min(int(p * 2**32), 2**32 - 1)`` (the reference's, `ops/dropout.py:86`)
and then scaled by ``1 / (1 - p)``, rounded to f32 once
(:func:`dropout_scale`).

The arithmetic runs on int64 tensors on any device, so the card can hold
its kernels' masks against this version bit for bit. The 32 x 32 -> 64-bit
products that Philox needs would overflow int64, so one factor is split
into 16-bit halves. The reference's bits come from threefry or the TPU's
hardware generator: the port cannot reproduce them, only the contract
(see `ROADMAP.md`).

**Device keys.** A step replayed as a CUDA graph cannot take its
dropout keys as launch arguments: they would be the captured step's in
every replay. Inside `random.trace_key_scope` a dropout site's key is a
:class:`DeviceKey` instead: the step's base key and counter ``t`` (device
tensors) and the site's index. Its words are :func:`fold` applied twice,
``fold(fold(base, t), site)``, as the reference's step folds ``t`` into
its base key (`parallel/sharded.py:123`) and each site its trace counter
(`random.py:88-95`). The fold is Philox4x32-10 itself: the first two
words of the block at counter ``(n mod 2^32, n >> 32, 0, 1)`` under the
key. Word 3 is 1 there, and 0 in every block of a mask's stream, so a
fold never draws a block of a mask under the same key. The kernels read
a site's words from a table on the card that the fold kernel of
``csrc/dropout.cu`` fills (`ops.dropout.site_key_ptr`); this module
folds in PyTorch ops on the key's device, with no sync, the plain
version the table is held against.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["philox4x32_10", "random_words", "keep_mask", "threshold",
           "dropout_scale", "fold", "DeviceKey", "key_words"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def threshold(p):
    """uint32 keep threshold of drop probability ``p`` (as an int)."""
    return min(int(float(p) * 4294967296.0), 4294967295)


def dropout_scale(p):
    """``1 / (1 - p)`` rounded to f32, the value the kernels multiply by."""
    return float(onp.float32(1.0 / (1.0 - float(p))))


def _mulhilo(m, x):
    """(hi, lo) 32-bit words of ``m * x`` for a constant ``m`` < 2**32 and
    an int64 tensor ``x`` of values < 2**32."""
    a = m * (x & 0xFFFF)            # < 2**48
    b = m * (x >> 16)               # < 2**48
    mid = b + (a >> 16)             # (m * x) >> 16, < 2**49
    return mid >> 16, ((mid & 0xFFFF) << 16) | (a & 0xFFFF)


def philox4x32_10(counter, key):
    """The four words of Philox4x32-10 under ``key`` = (k0, k1) at each
    counter, given as its four 32-bit words ``counter`` = (c0, c1, c2, c3),
    int64 tensors of values < 2**32 (returned likewise). The key words are
    ints or int64 tensors (0-dim ones broadcast)."""
    c0, c1, c2, c3 = counter
    k0, k1 = (k & _MASK32 if isinstance(k, torch.Tensor) else int(k)
              & _MASK32 for k in key)
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def fold(key, n):
    """``key`` (two words: ints or int64 tensors) folded with ``n`` (an int
    or an int64 tensor, >= 0): the first two words of the Philox block at
    counter (n mod 2^32, n >> 32, 0, 1), as 0-dim int64 tensors on ``n``'s
    device (or the key's)."""
    like = next((t for t in (n, *key) if isinstance(t, torch.Tensor)), None)
    n = torch.as_tensor(n, dtype=torch.int64,
                        device=None if like is None else like.device)
    zero = torch.zeros_like(n)
    words = philox4x32_10((n & _MASK32, n >> 32, zero, zero + 1), key)
    return words[0], words[1]


class DeviceKey:
    """The key of one dropout site inside `random.trace_key_scope`:
    ``fold(fold(base, t), site)``, with ``base`` (two words, int64, < 2**32)
    and ``t`` (0-dim int64) tensors on the step's device, read when the
    mask is drawn. ``tables`` is the scope's table of site keys on the
    card, shared by its sites and filled as they first need it
    (`ops.dropout.site_key_ptr`)."""

    __slots__ = ("base", "t", "site", "tables")

    def __init__(self, base, t, site, tables):
        self.base, self.t, self.site, self.tables = base, t, site, tables

    @property
    def device(self):
        return self.base.device


def key_words(key):
    """A key's two words: a host key's ints as they are, a
    :class:`DeviceKey`'s folded on its device (0-dim int64 tensors)."""
    if isinstance(key, DeviceKey):
        return fold(fold((key.base[0], key.base[1]), key.t), key.site)
    return key


def random_words(n, key, device="cpu"):
    """The random word (int64, < 2**32) of each of ``n`` elements under
    ``key`` (two words, or a :class:`DeviceKey`)."""
    key = key_words(key)
    counters = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(counters)
    words = torch.stack(philox4x32_10(
        (counters & _MASK32, counters >> 32, zero, zero), key), dim=1)
    return words.reshape(-1)[:n]


def keep_mask(shape, key, p, device="cpu"):
    """Boolean keep mask of a tensor of ``shape`` (flat indices in row-major
    order) for drop probability ``p`` under ``key``."""
    n = 1
    for s in shape:
        n *= int(s)
    return (random_words(n, key, device) >= threshold(p)).reshape(shape)
