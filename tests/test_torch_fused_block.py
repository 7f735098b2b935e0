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
the same arithmetic runs on both sides.
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
# several of its blocks; C from a narrow width to BERT-base's
@pytest.mark.parametrize("rows,c", [(16, 128), (512, 128), (16, 768)])
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
