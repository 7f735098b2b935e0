"""The port's dropout (`incubator_mxnet_tpu_torch.ops.dropout`, K5) and its
Philox stream (`ops/_philox.py`), on CPU tensors.

The reference draws its mask from threefry or the TPU's hardware
generator, so no bit of it can be reproduced; the tests pin the
generator to the published Philox4x32-10 known-answer vectors (Random123,
``kat_vectors``) and hold the port to the contract that the JAX
package's `ops/dropout.py` `_emulate` keeps: y is x / (1 - p) where kept
and 0 where dropped, the keep fraction is 1 - p within a binomial bound,
forward and backward share one mask, and one key gives one output.

Tolerances: the keep fraction within 6 binomial standard deviations
(sqrt(p (1 - p) / n); a false alarm about once in 10^9 runs); values
exact (one f32 multiply on both sides).
"""
import importlib
import math

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu_torch import autograd, npx
from incubator_mxnet_tpu_torch import random as mxrandom
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon import nn as gnn
from incubator_mxnet_tpu_torch.ops import _philox as ph
from incubator_mxnet_tpu_torch.ops import dropout as tdp

jdp = importlib.import_module("incubator_mxnet_tpu.ops.dropout")

# (counter words, key words) -> output words, from Random123's kat_vectors
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _x(shape, seed):
    return torch.from_numpy(onp.random.RandomState(seed).normal(
        0, 1, shape).astype("float32"))


def _binomial_ok(kept, n, p):
    return abs(kept / n - (1 - p)) <= 6 * math.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("counter,key,expected", KAT)
def test_philox_known_answer_vectors(counter, key, expected):
    words = ph.philox4x32_10(tuple(torch.tensor([c]) for c in counter), key)
    assert tuple(int(w) for w in words) == expected


def test_words_follow_flat_index_and_counter():
    """Element i takes word i % 4 of the block at counter i // 4, so a
    mask does not depend on the tensor's shape or any block size."""
    key = (11, 22)
    words = ph.random_words(10, key)
    c = torch.arange(3)
    zero = torch.zeros_like(c)
    blocks = torch.stack(ph.philox4x32_10((c, zero, zero, zero), key), 1)
    assert torch.equal(words, blocks.reshape(-1)[:10])
    assert torch.equal(ph.keep_mask((6, 4), key, 0.3).reshape(-1),
                       ph.keep_mask((24,), key, 0.3))


def test_threshold_and_scale_are_the_references():
    for p in (0.1, 0.5, 0.9, 1.0 - 2.0 ** -40):
        assert ph.threshold(p) == min(int(p * 4294967296.0), 4294967295)
    assert ph.dropout_scale(0.1) == float(onp.float32(1 / 0.9))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_mask_scale_and_keep_fraction(p):
    x = _x((64, 768), seed=1) + 3.0             # no exact zeros
    y = tdp.dropout(x, (5, 6), p)
    kept = y != 0
    assert _binomial_ok(int(kept.sum()), x.numel(), p)
    scale = torch.tensor(ph.dropout_scale(p))
    assert torch.equal(y[kept], x[kept] * scale)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_contract_matches_the_jax_emulation(p):
    """The JAX package's off-TPU dropout (`_emulate`) and the port keep the
    same contract on the same input: zero or x / (1 - p), keep fraction
    1 - p."""
    x = onp.random.RandomState(2).normal(3, 1, (32, 512)).astype("float32")
    thr = ph.threshold(p)
    ref = onp.asarray(jdp._emulate(jnp.asarray(x), jnp.asarray([3, 4]),
                                   thr, 1.0 / (1.0 - p)))
    got = tdp.dropout(torch.from_numpy(x), (3, 4), p).numpy()
    for y in (ref, got):
        kept = y != 0
        assert _binomial_ok(int(kept.sum()), x.size, p)
        onp.testing.assert_allclose(y[kept], x[kept] / (1 - p), rtol=1e-6)


def test_forward_and_backward_share_the_mask():
    x = _x((16, 40), seed=3).requires_grad_()
    y = tdp.dropout(x, (7, 8), 0.3)
    y.backward(torch.ones_like(y))
    scale = torch.tensor(ph.dropout_scale(0.3))
    assert torch.equal(x.grad, (y != 0).float() * scale)


def test_same_key_same_output_other_key_other_output():
    x = _x((8, 96), seed=4)
    a = tdp.dropout(x, (1, 2), 0.5)
    assert torch.equal(a, tdp.dropout(x, (1, 2), 0.5))
    assert not torch.equal(a, tdp.dropout(x, (1, 3), 0.5))
    assert not torch.equal(a, tdp.dropout(x, (2, 2), 0.5))


def test_p0_identity_p1_zeros_and_bad_p():
    x = _x((4, 8), seed=5).requires_grad_()
    assert tdp.dropout(x, (1, 1), 0.0) is x
    y = tdp.dropout(x, (1, 1), 1.0)
    assert (y == 0).all()
    y.sum().backward()
    assert (x.grad == 0).all()
    with pytest.raises(ValueError):
        tdp.dropout(x, (1, 1), 1.5)
    with pytest.raises(MXNetError):
        tdp.dropout(x, (1, 1), 0.5, impl="kernel")   # CPU tensor


def test_bfloat16_rounds_the_f32_product_once():
    x = _x((8, 64), seed=6).bfloat16()
    y = tdp.dropout(x, (4, 4), 0.25)
    ref = tdp.dropout(x.float(), (4, 4), 0.25).bfloat16()
    assert y.dtype == torch.bfloat16 and torch.equal(y, ref)


def test_key_source_is_seeded_and_fresh():
    mxrandom.seed(42)
    a, b = mxrandom.next_key(), mxrandom.next_key()
    mxrandom.seed(42)
    assert (a, b) == (mxrandom.next_key(), mxrandom.next_key())
    assert a != b and all(0 <= w < 2 ** 32 for w in a + b)


def test_npx_and_gluon_dropout_apply_only_in_training():
    x = _x((6, 32), seed=7)
    assert npx.dropout(x, p=0.5) is x                      # not training
    mxrandom.seed(1)
    y = npx.dropout(x, p=0.5, training=True)
    mxrandom.seed(1)
    assert torch.equal(y, npx.dropout(x, p=0.5, mode="always"))
    layer = gnn.Dropout(0.5)
    mxrandom.seed(1)
    with autograd.train_mode():
        assert torch.equal(layer(x), y)                    # training mode
    assert layer(x) is x
    # broadcast masks (axes): one mask row shared by every row
    y = npx.dropout(x, p=0.5, axes=(0,), training=True)
    assert torch.equal(y != 0, (y[:1] != 0).expand_as(y) & (x != 0))


# -- device keys: a step's keys folded from its base key, t and the site ----

def _dkey(t, site, base=(123456789, 987654321)):
    return ph.DeviceKey(torch.tensor(base), torch.tensor(t), site, {})


def test_fold_is_philox_at_a_counter_no_mask_draws():
    """fold(key, n) is the first two words of the Philox block at counter
    (n mod 2^32, n >> 32, 0, 1): word 3 is 1, where every block of a
    mask's stream has word 3 = 0."""
    key = (0xA4093822, 0x299F31D0)
    for n in (0, 5, 2 ** 32 + 7):
        c = [torch.tensor([v]) for v in (n & 0xFFFFFFFF, n >> 32, 0, 1)]
        words = ph.philox4x32_10(c, key)
        got = ph.fold(key, n)
        assert (int(got[0]), int(got[1])) == (int(words[0]), int(words[1]))
        mask_block = ph.philox4x32_10(c[:3] + [torch.tensor([0])], key)
        assert int(mask_block[0]) != int(words[0])


def test_fold_is_deterministic_and_separates_t_and_site():
    keys = {}
    for t in (1, 2, 3):
        for site in (0, 1, 2):
            w = tuple(int(v) for v in ph.key_words(_dkey(t, site)))
            assert w == tuple(int(v) for v in ph.key_words(_dkey(t, site)))
            assert all(0 <= v < 2 ** 32 for v in w)
            keys[t, site] = w
    assert len(set(keys.values())) == len(keys)  # (1, 2) != (2, 1) too
    assert ph.key_words(_dkey(1, 0, base=(1, 2))) != ph.key_words(
        _dkey(1, 0, base=(1, 3)))
    # host ints and int64 tensors fold alike
    assert tuple(int(v) for v in ph.fold((5, 6), 9)) == tuple(
        int(v) for v in ph.fold((torch.tensor(5), torch.tensor(6)),
                                torch.tensor(9)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_key_gives_the_mask_of_its_host_words(dtype):
    """K5's plain version on a device key drops what it drops on the two
    words the key stands for, forward and backward."""
    key = _dkey(4, 3)
    words = tuple(int(v) for v in ph.key_words(key))
    x = (_x((9, 70), seed=8) + 3.0).to(dtype).requires_grad_()
    y = tdp.dropout(x, key, 0.2)
    assert torch.equal(y, tdp.dropout(x.detach(), words, 0.2))
    y.backward(torch.ones_like(y))
    scale = torch.tensor(ph.dropout_scale(0.2))
    assert torch.equal(x.grad, ((y != 0).float() * scale).to(dtype))


def test_next_key_in_a_trace_scope_draws_sites_not_host_words():
    """Inside `trace_key_scope` next_key() returns the scope's sites in
    order and draws nothing from the host generator; outside it, keys are
    the host words they always were, and a re-seed restarts the sites."""
    mxrandom.seed(42)
    expected = [mxrandom.next_key() for _ in range(2)]
    mxrandom.seed(42)
    base, t = torch.tensor([1, 2]), torch.tensor(3)
    with mxrandom.trace_key_scope(base, t) as scope:
        a, b = mxrandom.next_key(), mxrandom.next_key()
        assert (a.site, b.site) == (0, 1) and a.base is base and a.t is t
        epoch = mxrandom.seed_epoch()
        mxrandom.seed(42)
        assert mxrandom.seed_epoch() == epoch + 1
        assert scope.counter == 0 and mxrandom.next_key().site == 0
    assert [mxrandom.next_key() for _ in range(2)] == expected
    mxrandom.seed(1)
    y = npx.dropout(_x((4, 32), seed=9), p=0.5, training=True)
    mxrandom.seed(1)
    with mxrandom.trace_key_scope(base, t):
        z = npx.dropout(_x((4, 32), seed=9), p=0.5, training=True)
    w = tuple(int(v) for v in ph.key_words(ph.DeviceKey(base, t, 0, {})))
    assert torch.equal(z, tdp.dropout(_x((4, 32), seed=9), w, 0.5))
    mxrandom.seed(1)
    assert torch.equal(y, npx.dropout(_x((4, 32), seed=9), p=0.5,
                                      training=True))
