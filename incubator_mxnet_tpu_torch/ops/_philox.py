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
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["philox4x32_10", "random_words", "keep_mask", "threshold",
           "dropout_scale"]

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
    int64 tensors of values < 2**32 (returned likewise)."""
    c0, c1, c2, c3 = counter
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def random_words(n, key, device="cpu"):
    """The random word (int64, < 2**32) of each of ``n`` elements."""
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
