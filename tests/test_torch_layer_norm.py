"""The port's LayerNorm (`incubator_mxnet_tpu_torch.ops.layer_norm`, K4
and K4b, plain path on CPU tensors) against the JAX package's Pallas
kernels in interpret mode, on the same numpy-seeded inputs: the forward
`ops.layer_norm._fwd` for y, mean and rstd, and the backward through
`jax.vjp` of its `layer_norm` for dx, dgamma and dbeta.

Tolerance: 1e-5 abs and rel in float32 (both sides compute the statistics
in f32, summing in different orders); 1e-4 for dgamma/dbeta, which sum
over all rows.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu.ops import layer_norm as jln
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import layer_norm as tln

TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(rows, c, seed):
    r = onp.random.RandomState(seed)
    x = (r.normal(0, 2, (rows, c)) + 0.5).astype("float32")
    g = r.normal(1, 0.3, (c,)).astype("float32")
    b = r.normal(0, 0.3, (c,)).astype("float32")
    return x, g, b


# rows that are not a multiple of any block; C from a narrow head size to
# GPT-2's width
@pytest.mark.parametrize("rows,c", [(13, 64), (37, 96), (10, 768),
                                    (3, 768)])
def test_matches_pallas_fwd_interpret(rows, c):
    x, g, b = _inputs(rows, c, seed=rows + c)
    y_ref, m_ref, r_ref = jln._fwd(jnp.asarray(x), jnp.asarray(g),
                                   jnp.asarray(b), 1e-5, rows, True)
    y, mean, rstd = tln.layer_norm_fwd(*(torch.from_numpy(a)
                                         for a in (x, g, b)))
    assert y.dtype == torch.float32 and mean.shape == (rows,)
    assert mean.dtype == rstd.dtype == torch.float32
    onp.testing.assert_allclose(y.numpy(), onp.asarray(y_ref), **TOL)
    onp.testing.assert_allclose(mean.numpy(), onp.asarray(m_ref)[:, 0], **TOL)
    onp.testing.assert_allclose(rstd.numpy(), onp.asarray(r_ref)[:, 0], **TOL)


def test_public_layer_norm_any_rank_matches_jax():
    """The public op collapses leading axes to rows, as the reference's
    `layer_norm` (which pads rows to its block) does."""
    x, g, b = _inputs(2 * 150, 128, seed=4)
    x3 = x.reshape(2, 150, 128)
    ref = jln.layer_norm(jnp.asarray(x3), jnp.asarray(g), jnp.asarray(b),
                         interpret=True)
    got = tln.layer_norm(*(torch.from_numpy(a) for a in (x3, g, b)))
    assert got.shape == (2, 150, 128)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref), **TOL)


def test_bfloat16_output_dtype_and_f32_stats():
    x, g, b = _inputs(9, 64, seed=2)
    xt, gt, bt = (torch.from_numpy(a).bfloat16() for a in (x, g, b))
    y, mean, rstd = tln.layer_norm_fwd(xt, gt, bt)
    assert y.dtype == torch.bfloat16 and mean.dtype == torch.float32
    y32, _, _ = tln.layer_norm_fwd(xt.float(), gt.float(), bt.float())
    torch.testing.assert_close(y, y32.bfloat16(), rtol=0, atol=0)


def test_supports_gate_sized_for_hopper():
    assert tln.supports((8, 768), -1, 768)
    assert tln.supports((8, 96), 1, 96)                   # C % 128 != 0
    assert tln.supports((8, 4096), -1, 4096)
    assert not tln.supports((8, 4100), -1, 4100)          # above the max
    assert not tln.supports((8, 766), -1, 766)            # not whole f32x4
    assert tln.supports((8, 776), -1, 776, torch.bfloat16)
    assert not tln.supports((8, 772), -1, 772, torch.bfloat16)
    assert not tln.supports((8, 768, 4), 1, 768)          # not last axis
    assert not tln.supports((8, 768), -1, 768, torch.float16)


def test_impl_kernel_on_cpu_raises():
    x, g, b = (torch.from_numpy(a) for a in _inputs(4, 64, seed=1))
    with pytest.raises(MXNetError):
        tln.layer_norm(x, g, b, impl="kernel")
    with pytest.raises(ValueError):
        tln.layer_norm(x, g, b, impl="pallas")


# rows over several of the reference's 8-row blocks, the last one padded
@pytest.mark.parametrize("rows,c", [(24, 64), (37, 96), (19, 768)])
def test_bwd_matches_pallas_vjp_interpret(rows, c):
    """dx, dgamma and dbeta against `jax.vjp` of the JAX package's
    `layer_norm` (its custom vjp over the Pallas `_fwd` / `_bwd` kernels,
    interpret mode, 8-row blocks, so dgamma/dbeta accumulate across its
    grid). dgamma/dbeta sum over all rows: 1e-4."""
    x, g, b = _inputs(rows, c, seed=rows * c)
    dy = onp.random.RandomState(rows).normal(0, 1, (rows, c)).astype(
        "float32")

    def f(x, g, b):
        return jln.layer_norm(x, g, b, block_r=8, interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, g, b)))
    refs = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    y = tln.layer_norm(*leaves)
    y.backward(torch.from_numpy(dy))
    for leaf, ref, tol in zip(leaves, refs, (TOL, PARAM_TOL, PARAM_TOL)):
        onp.testing.assert_allclose(leaf.grad.numpy(), onp.asarray(ref),
                                    **tol)


def test_plain_bwd_is_the_explicit_formula():
    """`plain_layer_norm_bwd` (the kernel's arithmetic) against autograd
    of the plain forward, bf16 outputs rounded once."""
    x, g, b = _inputs(11, 64, seed=8)
    dy = torch.from_numpy(onp.random.RandomState(1).normal(
        0, 1, (11, 64)).astype("float32"))
    xt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    y, mean, rstd = tln.plain_layer_norm(xt, gt, bt)
    y.backward(dy)
    dx, dg, db = tln.layer_norm_bwd(xt.detach(), dy, mean.detach(),
                                    rstd.detach(), gt.detach())
    for got, ref in ((dx, xt.grad), (dg, gt.grad), (db, bt.grad)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    dxb, dgb, _ = tln.layer_norm_bwd(xt.detach().bfloat16(), dy.bfloat16(),
                                     mean.detach(), rstd.detach(),
                                     gt.detach().bfloat16())
    assert dxb.dtype == dgb.dtype == torch.bfloat16
