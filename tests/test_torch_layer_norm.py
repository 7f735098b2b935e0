"""The port's LayerNorm forward (`incubator_mxnet_tpu_torch.ops.layer_norm`,
plain path on CPU tensors) against the JAX package's Pallas kernel
`ops.layer_norm._fwd` in interpret mode, for y, mean and rstd, on the same
numpy-seeded inputs.

Tolerance: 1e-5 abs and rel in float32 (both sides compute the statistics
in f32, summing in different orders).
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu.ops import layer_norm as jln
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import layer_norm as tln

TOL = dict(rtol=1e-5, atol=1e-5)


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
