"""The port's fused exact-erf GELU + dropout (`incubator_mxnet_tpu_torch.
ops.fused_block` `gelu_dropout`, K6) and `npx.gelu`/`npx.gelu_dropout`,
on CPU tensors (the plain versions).

At p = 0 the forward and backward are held against the JAX package's
Pallas kernels themselves: `ops.fused_block._gd_core` (its custom vjp
over `_gd_fwd_kernel` / `_gd_bwd_kernel`) in interpret mode, through
`jax.vjp`; it runs on the CPU at p = 0 because no random seed is traced.
At p > 0 no bit of the reference's mask can be reproduced, so the port is
held to its own composition (with one key, ``gelu_dropout(u)`` equals
``dropout(F.gelu(u))`` bit for bit in float32) and to the reference's
contract (`tests/test_fused_block.py` `test_gelu_dropout_*`).

Tolerances: float32 2e-6 abs against the reference, for |u| <= 6. Its
erf is the Abramowitz-Stegun approximation (within 1.5e-7, so gelu
within 4.5e-7); for negative u, Phi(u) = (1 + erf) / 2 cancels, so each
side's f32 rounding of erf near -1 (a few units of 2^-24) is multiplied
by |u| <= 6; and the value itself rounds (4.8e-7 at |gelu| <= 6). The
differences measured here reach 1.19e-6 (u = 3.44, from the Pallas
kernel) and 1.02e-6 (a negative u). bfloat16: one spacing (both sides
round nearly the same f32 value once: 2^-7 of the value) plus that f32
tolerance, which the reference's absolute erf error needs where gelu is
tiny (u near -5). 1e-6 between the explicit backward and torch autograd
of the composed ops (the same formula, rounded otherwise); exact where
the same arithmetic runs on both sides.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch
import torch.nn.functional as F

from incubator_mxnet_tpu_torch import npx
from incubator_mxnet_tpu_torch import random as mxrandom
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import _philox as ph
from incubator_mxnet_tpu_torch.ops import dropout as tdp
from incubator_mxnet_tpu_torch.ops import fused_block as tfb

jfb = importlib.import_module("incubator_mxnet_tpu.ops.fused_block")

F32_TOL = 2e-6
BF16_RTOL = 2.0 ** -7


def _u(shape, seed, scale=2.0):
    """Normal inputs clipped to |u| <= 6, where the tolerances hold."""
    r = onp.random.RandomState(seed)
    return onp.clip(r.normal(0, scale, shape), -6, 6).astype("float32")


def _close(got, ref, dtype):
    got = onp.asarray(got, dtype="float32")
    ref = onp.asarray(ref, dtype="float32")
    d = onp.abs(got - ref)
    rtol = BF16_RTOL if dtype == "bfloat16" else 0.0
    assert (d <= rtol * onp.abs(ref) + F32_TOL).all(), d.max()


def _binomial_ok(kept, n, p):
    return abs(kept / n - (1 - p)) <= 6 * math.sqrt(p * (1 - p) / n)


def _jax_core(u, dtype):
    def core(u):
        return jfb._gd_core(u, jnp.zeros((2,), jnp.int32), 0.0, True)
    return jax.vjp(core, jnp.asarray(u).astype(dtype))


# the reference's kernel takes rows that are a multiple of its block rows
CASES = [((16, 256), "float32"), ((40, 384), "float32"),
         ((16, 256), "bfloat16")]


@pytest.mark.parametrize("shape,dtype", CASES)
def test_p0_forward_matches_pallas_interpret(shape, dtype):
    u = _u(shape, seed=shape[0])
    ref, _ = _jax_core(u, dtype)
    ut = torch.from_numpy(u).to(getattr(torch, dtype))
    got = tfb.gelu_dropout(ut, (0, 0), 0.0)
    assert got.dtype == ut.dtype and got.shape == shape
    _close(got.float().numpy(), onp.asarray(ref.astype(jnp.float32)), dtype)
    # the reference's exact-gelu emulation agrees at the same tolerance
    emu = jfb._gd_emulate(jnp.asarray(u).astype(dtype), jnp.zeros(2), 0.0)
    _close(got.float().numpy(), onp.asarray(emu.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_p0_backward_matches_pallas_vjp(shape, dtype):
    u = _u(shape, seed=shape[1])
    dy = onp.random.RandomState(3).normal(0, 1, shape).astype("float32")
    _, vjp = _jax_core(u, dtype)
    (ref,) = vjp(jnp.asarray(dy).astype(dtype))
    tdt = getattr(torch, dtype)
    leaf = torch.from_numpy(u).to(tdt).requires_grad_()
    tfb.gelu_dropout(leaf, (0, 0), 0.0).backward(torch.from_numpy(dy).to(tdt))
    ref = onp.asarray(ref.astype(jnp.float32))
    _close(leaf.grad.float().numpy(), ref, dtype)
    explicit = tfb.plain_gelu_dropout_bwd(leaf.detach(),
                                          torch.from_numpy(dy).to(tdt),
                                          (0, 0), 0.0)
    assert torch.equal(explicit, leaf.grad)


def test_gelu_grad_is_finite_where_phi_underflows():
    """phi(u) underflows to 0 past |u| ~ 13; gelu'(u) is then 1 or 0,
    never NaN."""
    u = torch.tensor([-40.0, -14.0, -13.0, 0.0, 13.0, 14.0, 40.0])
    du = tfb.plain_gelu_dropout_bwd(u, torch.ones_like(u), (0, 0), 0.0)
    assert bool(torch.isfinite(du).all())
    assert du[0] == 0 and du[-1] == 1 and du[3] == 0.5


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("shape", [(48, 256), (7, 13)])
def test_equals_dropout_of_gelu_bit_for_bit(p, shape):
    u = torch.from_numpy(_u(shape, seed=7))
    key = (31337, 4242)
    got = tfb.gelu_dropout(u, key, p)
    ref = tdp.plain_dropout(F.gelu(u, approximate="none"), key, p)
    assert torch.equal(got, ref)
    assert torch.equal(got, tfb.plain_gelu_dropout(u, key, p))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_reference_contract(p):
    """The reference's contract: keep fraction 1 - p within a binomial
    bound, kept values gelu / (1 - p), one key one result, and the
    backward drops where the forward dropped."""
    u = torch.from_numpy(_u((64, 512), seed=11)) + 7.0   # gelu(u) != 0
    key = (5, 6)
    y = tfb.gelu_dropout(u, key, p)
    kept = y != 0
    assert _binomial_ok(int(kept.sum()), u.numel(), p)
    scale = torch.tensor(ph.dropout_scale(p))
    g = F.gelu(u, approximate="none")
    torch.testing.assert_close(y[kept], g[kept] / (1 - p), rtol=1e-6,
                               atol=0)
    assert torch.equal(y[kept], g[kept] * scale)
    assert torch.equal(kept, ph.keep_mask(u.shape, key, p))
    assert torch.equal(y, tfb.gelu_dropout(u, key, p))
    assert not torch.equal(y, tfb.gelu_dropout(u, (5, 7), p))
    leaf = u.clone().requires_grad_()
    tfb.gelu_dropout(leaf, key, p).backward(torch.ones_like(u))
    assert torch.equal(leaf.grad != 0, kept)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.3])
def test_autograd_matches_the_composed_plain_ops(dtype, p):
    u = torch.from_numpy(_u((24, 160), seed=13)).to(dtype)
    dy = torch.from_numpy(_u((24, 160), seed=14, scale=1.0)).to(dtype)
    key = (77, 1 << 31)
    leaf = u.clone().requires_grad_()
    y = tfb.gelu_dropout(leaf, key, p)
    y.backward(dy)
    comp = u.float().requires_grad_()
    ref = tdp.dropout(F.gelu(comp, approximate="none"), key, p)
    ref.backward(dy.float())
    if dtype == torch.float32:
        assert torch.equal(y, ref)
        torch.testing.assert_close(leaf.grad, comp.grad, rtol=1e-6,
                                   atol=1e-6)
    else:
        _close(y.detach().float().numpy(), ref.detach().numpy(), "bfloat16")
        _close(leaf.grad.float().numpy(), comp.grad.numpy(), "bfloat16")


def test_p1_zeros_bad_p_empty_and_bad_impl():
    u = torch.from_numpy(_u((4, 8), seed=5)).requires_grad_()
    y = tfb.gelu_dropout(u, (1, 1), 1.0)
    assert (y == 0).all()
    y.sum().backward()
    assert (u.grad == 0).all()
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError):
            tfb.gelu_dropout(u, (1, 1), bad)
        with pytest.raises(ValueError):
            npx.gelu_dropout(u, p=bad, training=True)
    empty = torch.zeros(0, 8)
    assert tfb.gelu_dropout(empty, (1, 1), 0.5) is empty
    with pytest.raises(ValueError):
        tfb.gelu_dropout(u, (1, 1), 0.5, impl="pallas")
    with pytest.raises(ValueError):
        npx.gelu_dropout(u, p=0.5, impl="cuda", training=True)
    with pytest.raises(MXNetError):
        tfb.gelu_dropout(u, (1, 1), 0.5, impl="kernel")  # CPU tensor
    with pytest.raises(MXNetError):
        npx.gelu_dropout(u, p=0.5, impl="pallas", training=True)


@pytest.mark.parametrize("approximate", [True, False])
def test_npx_gelu_matches_the_reference(approximate):
    from incubator_mxnet_tpu import np as jnp_mx
    from incubator_mxnet_tpu import npx as jnpx

    x = _u((5, 33), seed=2)
    ref = jnpx.gelu(jnp_mx.array(x), approximate=approximate).asnumpy()
    got = npx.gelu(torch.from_numpy(x), approximate=approximate).numpy()
    onp.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    other = npx.gelu(torch.from_numpy(x), approximate=not approximate)
    assert onp.abs(other.numpy() - ref).max() > 1e-4


def test_npx_gelu_dropout_out_of_training_matches_the_reference():
    """Out of training both packages compute the exact erf gelu."""
    from incubator_mxnet_tpu import np as jnp_mx
    from incubator_mxnet_tpu import npx as jnpx

    x = _u((2, 7, 96), seed=4)
    ref = jnpx.gelu_dropout(jnp_mx.array(x), p=0.1).asnumpy()
    mxrandom.seed(3)
    got = npx.gelu_dropout(torch.from_numpy(x), p=0.1)
    onp.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL)
    mxrandom.seed(3)
    key = mxrandom.next_key()
    mxrandom.seed(3)
    npx.gelu_dropout(torch.from_numpy(x), p=0.1)          # draws no key
    assert mxrandom.next_key() == key


def test_npx_gelu_dropout_in_training_draws_one_key():
    x = torch.from_numpy(_u((6, 128), seed=8))
    mxrandom.seed(8)
    y = npx.gelu_dropout(x, p=0.3, training=True)
    after = mxrandom.next_key()
    mxrandom.seed(8)
    key = mxrandom.next_key()
    assert mxrandom.next_key() == after                   # one key drawn
    assert torch.equal(y, tfb.gelu_dropout(x, key, 0.3))
    mxrandom.seed(8)
    assert torch.equal(y, npx.gelu_dropout(x, p=0.3, training=True))
    mxrandom.seed(8)
    xla = npx.gelu_dropout(x, p=0.3, training=True, impl="xla")
    mxrandom.seed(8)
    plain = npx.gelu_dropout(x, p=0.3, training=True, impl="plain")
    assert torch.equal(xla, y) and torch.equal(plain, y)
    assert torch.equal(npx.gelu_dropout(x, p=0.0, training=True),
                       F.gelu(x, approximate="none"))
