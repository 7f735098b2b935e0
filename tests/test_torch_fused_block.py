"""The port's fused residual + dropout + LayerNorm
(`incubator_mxnet_tpu_torch.ops.fused_block`, K3; plain path on CPU
tensors).

At p = 0 the forward and backward are held against the JAX package's
Pallas kernels themselves: `ops.fused_block._core` (its custom vjp over
`_fwd` / `_bwd`) in interpret mode, through `jax.vjp`. At p > 0 no bit of
the reference's mask can be reproduced (threefry or the TPU's hardware
generator), so the port is held to its own composition: with one key,
``residual_dropout_ln(x, h)`` equals ``layer_norm(x + dropout(h))`` bit
for bit in float32, and its backward equals autograd of that composition.

Tolerances: 1e-5 abs and rel in float32 for y, dx and dh (f32 row sums in
another order), 1e-4 for dgamma/dbeta (sums over all rows); exact where
the same arithmetic runs on both sides. AMP's layout, f32 x with bf16 h
and f32 gamma/beta, is held to the Pallas kernels given the same mix at
p = 0 (its bf16 dh within one bf16 spacing), and to the port's f32
layout on h widened to f32 at every p.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu_torch import npx
from incubator_mxnet_tpu_torch import random as mxrandom
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import dropout as tdp
from incubator_mxnet_tpu_torch.ops import fused_block as tfb
from incubator_mxnet_tpu_torch.ops import layer_norm as tln

jfb = importlib.import_module("incubator_mxnet_tpu.ops.fused_block")

TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(rows, c, seed):
    r = onp.random.RandomState(seed)
    x = (r.normal(0, 1, (rows, c)) + 0.3).astype("float32")
    h = r.normal(0, 1, (rows, c)).astype("float32")
    g = r.normal(1, 0.3, (c,)).astype("float32")
    b = r.normal(0, 0.3, (c,)).astype("float32")
    dy = r.normal(0, 1, (rows, c)).astype("float32")
    return x, h, g, b, dy


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


# rows a multiple of the reference's block rows (it pads otherwise) with
# several of its blocks, or fewer rows than one block (75 = 72 + 3, one
# block of its own size); C from a narrow width to BERT-base's
@pytest.mark.parametrize("rows,c", [(16, 128), (512, 128), (16, 768),
                                    (75, 768)])
def test_p0_matches_pallas_core_interpret(rows, c):
    x, h, g, b, dy = _inputs(rows, c, seed=rows + c)

    def core(x, h, g, b):
        return jfb._core(x, h, g, b, jnp.zeros((2,), jnp.int32), 0.0, 1e-5,
                         True)

    y_ref, vjp = jax.vjp(core, *(jnp.asarray(a) for a in (x, h, g, b)))
    grads_ref = vjp(jnp.asarray(dy))
    leaves = _leaves(x, h, g, b)
    y = tfb.residual_dropout_ln(*leaves, 0.0, (0, 0))
    y.backward(torch.from_numpy(dy))
    onp.testing.assert_allclose(y.detach().numpy(), onp.asarray(y_ref), **TOL)
    for leaf, ref, tol in zip(leaves, grads_ref, (TOL, TOL, PARAM_TOL,
                                                  PARAM_TOL)):
        onp.testing.assert_allclose(leaf.grad.numpy(), onp.asarray(ref),
                                    **tol)


def test_npx_eval_matches_the_jax_npx():
    """Out of training the JAX npx op (composed off the TPU) and the port's
    fused op compute LN(x + h)."""
    from incubator_mxnet_tpu import np as jnp_mx
    from incubator_mxnet_tpu import npx as jnpx

    x, h, g, b, _ = _inputs(2 * 7, 96, seed=3)
    x3, h3 = x.reshape(2, 7, 96), h.reshape(2, 7, 96)
    ref = jnpx.residual_dropout_ln(jnp_mx.array(x3), jnp_mx.array(h3),
                                   jnp_mx.array(g), jnp_mx.array(b),
                                   p=0.1).asnumpy()
    got = npx.residual_dropout_ln(*(torch.from_numpy(a)
                                    for a in (x3, h3, g, b)), p=0.1)
    assert got.shape == (2, 7, 96)
    onp.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_equals_layer_norm_of_dropout_bit_for_bit(p):
    x, h, g, b, dy = _inputs(48, 256, seed=7)
    key = (31337, 4242)
    leaves = _leaves(x, h, g, b)
    y = tfb.residual_dropout_ln(*leaves, p, key)
    y.backward(torch.from_numpy(dy))
    comp = _leaves(x, h, g, b)
    y_ref = tln.layer_norm(comp[0] + tdp.dropout(comp[1], key, p), comp[2],
                           comp[3])
    assert torch.equal(y, y_ref)
    # the fused backward against autograd through the composition (the
    # LayerNorm and dropout backward formulas)
    y_ref.backward(torch.from_numpy(dy))
    for leaf, ref, tol in zip(leaves, comp, (TOL, TOL, PARAM_TOL,
                                             PARAM_TOL)):
        torch.testing.assert_close(leaf.grad, ref.grad, **tol)
    assert torch.equal(leaves[1].grad == 0, tdp.dropout(
        torch.ones(48, 256), key, p) == 0)


def test_p1_drops_all_of_h():
    x, h, g, b, dy = _inputs(8, 64, seed=9)
    leaves = _leaves(x, h, g, b)
    y = tfb.residual_dropout_ln(*leaves, 1.0, (1, 2))
    y.backward(torch.from_numpy(dy))
    ref = tln.layer_norm(*(torch.from_numpy(a) for a in (x, g, b)))
    assert torch.equal(y.detach(), ref) and (leaves[1].grad == 0).all()


def test_npx_training_draws_a_key_and_is_reproducible():
    x, h, g, b, _ = (torch.from_numpy(a) for a in _inputs(4, 64, seed=2))
    mxrandom.seed(8)
    y1 = npx.residual_dropout_ln(x, h, g, b, p=0.3, training=True)
    mxrandom.seed(8)
    key = mxrandom.next_key()
    assert torch.equal(y1, tfb.residual_dropout_ln(x, h, g, b, 0.3, key))
    mxrandom.seed(8)
    y0 = npx.residual_dropout_ln(x, h, g, b, p=0.3)      # eval: no key
    assert mxrandom.next_key() == key
    assert torch.equal(y0, tfb.residual_dropout_ln(x, h, g, b, 0.0, (0, 0)))


def test_bad_arguments_raise():
    x, h, g, b, _ = (torch.from_numpy(a) for a in _inputs(4, 64, seed=1))
    with pytest.raises(MXNetError):
        tfb.residual_dropout_ln(x, h[:2], g, b, 0.1, (1, 1))
    with pytest.raises(MXNetError):
        tfb.residual_dropout_ln(x, h, g, b, 0.1, (1, 1), impl="kernel")
    with pytest.raises(ValueError):
        tfb.residual_dropout_ln(x, h, g, b, 0.1, (1, 1), impl="pallas")
    with pytest.raises(MXNetError):
        npx.residual_dropout_ln(x, h, g, b, axis=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_plain_bwd_returns_dgamma_dbeta_in_gamma_dtype(dtype, p):
    """As the kernel writes them: dgamma/dbeta in gamma's dtype, the f32
    column sums rounded once; dx and dh in the inputs' dtype."""
    x, h, g, b, dy = (torch.from_numpy(a).to(dtype)
                      for a in _inputs(9, 64, seed=5))
    key = (11, 12)
    _, mean, rstd = tfb.residual_dropout_ln_fwd(x, h, g, b, key, p)
    dx, dh, dg, db = tfb.residual_dropout_ln_bwd(x, h, dy, mean, rstd, g,
                                                 key, p)
    assert dx.dtype == dh.dtype == dg.dtype == db.dtype == dtype
    s = x.float() + tfb._dropped(h, key, p)
    _, dg32, db32 = tln.plain_ln_grads(s, dy, mean, rstd, g)
    assert torch.equal(dg, dg32.to(dtype)) and torch.equal(db, db32.to(dtype))


# -- AMP's layout: f32 x, y and dx; bf16 h and dh; f32 gamma/beta and
# dgamma/dbeta. The reference's kernels take it as they are (every input
# cast to f32, y in x's dtype, dgamma/dbeta in gamma's); dh is rounded to
# bf16 once, so it is within one bf16 spacing (2^-7 relative, plus the
# f32 difference near zero), the f32 outputs as in float32.
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


@pytest.mark.parametrize("rows,c", [(16, 128), (512, 128), (16, 768),
                                    (75, 768)])
def test_f32_x_bf16_h_p0_matches_pallas_core_interpret(rows, c):
    x, h, g, b, dy = _inputs(rows, c, seed=rows * 2 + c)
    hb = torch.from_numpy(h).bfloat16()

    def core(x, h, g, b):
        return jfb._core(x, h, g, b, jnp.zeros((2,), jnp.int32), 0.0, 1e-5,
                         True)

    hj = jnp.asarray(hb.float().numpy()).astype(jnp.bfloat16)
    y_ref, vjp = jax.vjp(core, jnp.asarray(x), hj, jnp.asarray(g),
                         jnp.asarray(b))
    grads_ref = vjp(jnp.asarray(dy))
    assert y_ref.dtype == jnp.float32 and grads_ref[1].dtype == jnp.bfloat16
    leaves = [torch.from_numpy(x).requires_grad_(),
              hb.clone().requires_grad_()] + _leaves(g, b)
    y = tfb.residual_dropout_ln(*leaves, 0.0, (0, 0))
    assert y.dtype == torch.float32
    y.backward(torch.from_numpy(dy))
    assert [t.grad.dtype for t in leaves] == [
        torch.float32, torch.bfloat16, torch.float32, torch.float32]
    onp.testing.assert_allclose(y.detach().numpy(), onp.asarray(y_ref), **TOL)
    for leaf, ref, tol in zip(leaves, grads_ref, (TOL, BF16_TOL, PARAM_TOL,
                                                  PARAM_TOL)):
        onp.testing.assert_allclose(leaf.grad.float().numpy(),
                                    onp.asarray(ref, onp.float32), **tol)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
def test_f32_x_bf16_h_is_the_f32_kernel_on_widened_h(p):
    """The mixed layout computes what the f32 layout computes on h widened
    to f32, bit for bit (the same mask, the sum in f32), with dh rounded
    to bf16 once and dgamma/dbeta in f32."""
    x, h, g, b, dy = (torch.from_numpy(a) for a in _inputs(40, 256, seed=11))
    hb = h.bfloat16()
    key = (4321, 8765)
    y, m, r = tfb.residual_dropout_ln_fwd(x, hb, g, b, key, p)
    y32, m32, r32 = tfb.residual_dropout_ln_fwd(x, hb.float(), g, b, key, p)
    assert y.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(m, m32) and torch.equal(r, r32)
    got = tfb.residual_dropout_ln_bwd(x, hb, dy, m, r, g, key, p)
    ref = tfb.residual_dropout_ln_bwd(x, hb.float(), dy, m, r, g, key, p)
    assert [t.dtype for t in got] == [torch.float32, torch.bfloat16,
                                      torch.float32, torch.float32]
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1],
                                                       ref[1].bfloat16())
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])


# -- device keys (a step replayed as a CUDA graph): K3 and K6 ---------------

def _device_key(t=2, site=5):
    from incubator_mxnet_tpu_torch.ops import _philox as ph

    key = ph.DeviceKey(torch.tensor([31, 41]), torch.tensor(t), site, {})
    return key, tuple(int(w) for w in ph.key_words(key))


def test_k3_device_key_gives_the_mask_of_its_host_words():
    """K3's plain forward and backward (through autograd) on a device key
    equal those on the words it stands for, bit for bit."""
    key, words = _device_key()
    r = onp.random.RandomState(12)
    x, h, dy = (torch.from_numpy(r.normal(0, 1, (6, 64)).astype("float32"))
                for _ in range(3))
    gamma = torch.from_numpy(r.normal(1, 0.2, 64).astype("float32"))
    beta = torch.zeros(64)
    outs = []
    for k in (key, words):
        xl, hl = x.clone().requires_grad_(), h.clone().requires_grad_()
        y = tfb.residual_dropout_ln(xl, hl, gamma, beta, 0.3, k)
        y.backward(dy)
        outs.append((y.detach(), xl.grad, hl.grad))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert (outs[0][2] == 0).any()  # some of h dropped


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_device_key_gives_the_mask_of_its_host_words(dtype):
    key, words = _device_key(t=9, site=0)
    u = torch.from_numpy(onp.random.RandomState(13).normal(
        0, 1, (5, 96)).astype("float32")).to(dtype)
    for fn in (tfb.gelu_dropout_fwd,):
        assert torch.equal(fn(u, key, 0.1), fn(u, words, 0.1))
    dy = torch.ones_like(u)
    assert torch.equal(tfb.gelu_dropout_bwd(u, dy, key, 0.1),
                       tfb.gelu_dropout_bwd(u, dy, words, 0.1))
    assert torch.equal(tfb.gelu_dropout_fwd(u, key, 0.1) != 0,
                       tdp.dropout(torch.ones_like(u), words, 0.1) != 0)


def test_npx_sites_in_a_trace_scope_fold_their_keys():
    """In a `trace_key_scope` each npx site takes the next site's key:
    residual_dropout_ln then gelu_dropout draw sites 0 and 1."""
    from incubator_mxnet_tpu_torch.ops import _philox as ph

    base, t = torch.tensor([7, 8]), torch.tensor(4)
    r = onp.random.RandomState(14)
    x, h = (torch.from_numpy(r.normal(0, 1, (4, 64)).astype("float32"))
            for _ in range(2))
    gamma, beta = torch.ones(64), torch.zeros(64)
    with mxrandom.trace_key_scope(base, t):
        y = npx.residual_dropout_ln(x, h, gamma, beta, p=0.2, training=True)
        g = npx.gelu_dropout(x, p=0.2, training=True)
    w0, w1 = (tuple(int(v) for v in ph.key_words(ph.DeviceKey(base, t, s,
                                                               {})))
              for s in (0, 1))
    assert torch.equal(y, tfb.residual_dropout_ln(x, h, gamma, beta, 0.2,
                                                  w0))
    assert torch.equal(g, tfb.gelu_dropout(x, w1, 0.2))
