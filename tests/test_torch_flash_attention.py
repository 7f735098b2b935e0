"""The port's flash-attention forward (`incubator_mxnet_tpu_torch.ops.
flash_attention`, plain path on CPU tensors) against the JAX package's
Pallas kernel in interpret mode and its XLA path, on the same numpy-seeded
inputs.

Tolerance: 2e-5 abs and rel in float32. Both sides accumulate in f32 but
in different orders (blockwise online softmax vs one softmax), which moves
the last bits of O and lse.
"""
import importlib

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import flash_attention as tfa

# the reference package's `ops` re-exports the function under the
# module's name, so reach the module itself
jfa = importlib.import_module("incubator_mxnet_tpu.ops.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(shape, seed):
    r = onp.random.RandomState(seed)
    return [r.normal(0, 1, shape).astype("float32") for _ in range(3)]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (shape (B, H, T, D), causal, lengths): causal, lengths, both together,
# and T not a multiple of 8 (the Pallas side pads it; the port masks it)
CASES = [
    ((2, 2, 40, 16), True, None),
    ((2, 2, 40, 16), False, [40, 23]),
    ((2, 2, 40, 16), True, [17, 40]),
    ((2, 2, 37, 16), True, None),
    ((2, 2, 37, 16), False, [37, 9]),
]


@pytest.mark.parametrize("shape,causal,lengths", CASES)
def test_matches_pallas_interpret_and_xla(shape, causal, lengths):
    q, k, v = _qkv(shape, seed=sum(shape) + 7 * causal)
    lens = None if lengths is None else onp.asarray(lengths, "int32")
    jl = None if lens is None else jnp.asarray(lens)
    # block 16 gives several q and kv blocks, so the Pallas kernel's
    # online softmax runs across kv steps
    pallas = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), lengths=jl, causal=causal,
                                 block_q=16, block_k=16, interpret=True,
                                 impl="pallas")
    xla = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              lengths=jl, causal=causal, impl="xla")
    tl = None if lens is None else torch.from_numpy(lens)
    got = tfa.flash_attention(*_torch(q, k, v), lengths=tl, causal=causal)
    assert got.shape == shape and got.dtype == torch.float32
    onp.testing.assert_allclose(got.numpy(), onp.asarray(pallas), **TOL)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(xla), **TOL)


@pytest.mark.parametrize("causal,lengths", [(True, None), (False, [40, 11])])
def test_bthd_layout_matches(causal, lengths):
    q, k, v = _qkv((2, 40, 2, 16), seed=3)          # (B, T, H, D)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              lengths=jl, causal=causal, block_q=16,
                              block_k=16, interpret=True, impl="pallas",
                              layout="bthd")
    tl = None if lengths is None else torch.tensor(lengths)
    got = tfa.flash_attention(*_torch(q, k, v), lengths=tl, causal=causal,
                              layout="bthd")
    assert got.shape == (2, 40, 2, 16)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref), **TOL)


@pytest.mark.parametrize("causal,lengths", [
    (False, None), (True, None), (False, [40, 13]), (True, [0, 29])])
def test_lse_matches_pallas_fwd(causal, lengths):
    """lse against the JAX kernel's `_fwd` (interpret mode), +inf rows
    included: rows at or past the length, and every row of a length-0
    sequence."""
    b, h, t, d = 2, 2, 40, 16
    q, k, v = _qkv((b, h, t, d), seed=11 + causal)
    lens = onp.full((b,), t, "int32") if lengths is None \
        else onp.asarray(lengths, "int32")
    need_mask = causal or lengths is not None
    scale = 1.0 / onp.sqrt(d)
    q3, k3, v3 = (jnp.asarray(a.reshape(b * h, t, d)) for a in (q, k, v))
    o_ref, lse_ref = jfa._fwd(q3, k3, v3, jnp.asarray(onp.repeat(lens, h)),
                              float(scale), causal, 8, 8, True, need_mask,
                              lengths is not None)
    tl = None if lengths is None else torch.from_numpy(lens)
    o, lse = tfa.flash_attention_with_lse(*_torch(q, k, v), lengths=tl,
                                          causal=causal)
    assert lse.shape == (b * h, t) and lse.dtype == torch.float32
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(lse_ref)[..., 0],
                                **TOL)
    onp.testing.assert_allclose(o.numpy().reshape(b * h, t, d),
                                onp.asarray(o_ref), **TOL)
    if lengths is not None:
        for i, n in enumerate(lengths):
            assert onp.isposinf(lse.numpy()[i * h:(i + 1) * h, n:]).all()


def test_rows_past_length_are_exactly_zero():
    q, k, v = _qkv((2, 2, 37, 16), seed=5)
    lengths = [20, 0]
    o = tfa.flash_attention(*_torch(q, k, v), lengths=torch.tensor(lengths),
                            causal=True).numpy()
    assert (o[0, :, 20:] == 0).all() and (o[1] == 0).all()
    assert onp.isfinite(o).all() and (o[0, :, :20] != 0).any()


def test_mha_flash_per_row_lengths():
    bh, t, d = 4, 24, 16
    q, k, v = _qkv((bh, t, d), seed=9)
    lens = onp.asarray([24, 5, 17, 1], "int32")
    ref = jfa.mha_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        lengths=jnp.asarray(lens), causal=True)
    got = tfa.mha_flash(*_torch(q, k, v), lengths=torch.from_numpy(lens),
                        causal=True)
    assert got.shape == (bh, t, d)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref), **TOL)


def test_impl_kernel_on_cpu_raises_and_bad_args_rejected():
    q, k, v = _torch(*_qkv((1, 1, 8, 16), seed=1))
    with pytest.raises(MXNetError):
        tfa.flash_attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, layout="tbhd")
    # "plain" and "auto" agree on the CPU (auto takes the plain version)
    torch.testing.assert_close(tfa.flash_attention(q, k, v, impl="plain"),
                               tfa.flash_attention(q, k, v))
