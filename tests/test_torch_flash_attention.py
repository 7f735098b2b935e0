"""The port's flash attention (`incubator_mxnet_tpu_torch.ops.
flash_attention`, K1 and K2, plain path on CPU tensors) against the JAX
package's Pallas kernels in interpret mode and its XLA path, on the same
numpy-seeded inputs: the forward, and dq, dk, dv through `jax.vjp`.

Tolerance: 2e-5 abs and rel in float32 for O and lse. Both sides
accumulate in f32 but in different orders (blockwise online softmax vs
one softmax), which moves their last bits. 1e-4 for the gradients, sums
of products over all rows or keys.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError
tfa = importlib.import_module(
    "incubator_mxnet_tpu_torch.ops.flash_attention")

# the reference package's `ops` re-exports the function under the
# module's name, so reach the module itself
jfa = importlib.import_module("incubator_mxnet_tpu.ops.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


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


@pytest.mark.parametrize("shape,causal,lengths", CASES)
def test_bwd_matches_pallas_interpret_and_xla_vjp(shape, causal, lengths):
    """dq, dk, dv of the port (autograd through its backward's plain
    version, the kernels' arithmetic) against `jax.vjp` of the JAX
    package's Pallas kernels (`_dq_kernel`, `_dkv_kernel`, interpret mode,
    16-blocks) and of its XLA path. Gradients sum over up to 40 rows or
    keys: 1e-4 abs and rel."""
    q, k, v = _qkv(shape, seed=sum(shape) + 3 * causal)
    do = onp.random.RandomState(5).normal(0, 1, shape).astype("float32")
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tl = None if lengths is None else torch.tensor(lengths)
    o = tfa.flash_attention(*leaves, lengths=tl, causal=causal)
    o.backward(torch.from_numpy(do))
    for impl, extra in (("pallas", dict(block_q=16, block_k=16,
                                        interpret=True)), ("xla", {})):
        def f(q, k, v, impl=impl, extra=extra):
            return jfa.flash_attention(q, k, v, lengths=jl, causal=causal,
                                       impl=impl, **extra)

        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
        for leaf, ref in zip(leaves, vjp(jnp.asarray(do))):
            onp.testing.assert_allclose(leaf.grad.numpy(), onp.asarray(ref),
                                        **GRAD_TOL)


def test_bwd_bthd_views_of_one_projection():
    """The models' call: q, k, v are views of one (B, T, 3, H, D) tensor in
    "bthd"; the gradient of that tensor against the JAX Pallas vjp."""
    qkv = onp.random.RandomState(6).normal(0, 1, (2, 40, 3, 2, 16)).astype(
        "float32")
    lens = [40, 17]
    do = onp.random.RandomState(7).normal(0, 1, (2, 40, 2, 16)).astype(
        "float32")

    def f(qkv):
        return jfa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                   lengths=jnp.asarray(lens, jnp.int32),
                                   block_q=16, block_k=16, interpret=True,
                                   impl="pallas", layout="bthd")

    _, vjp = jax.vjp(f, jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(do))
    leaf = torch.from_numpy(qkv).requires_grad_()
    o = tfa.flash_attention(*leaf.unbind(2), lengths=torch.tensor(lens),
                            layout="bthd")
    o.backward(torch.from_numpy(do))
    onp.testing.assert_allclose(leaf.grad.numpy(), onp.asarray(ref),
                                **GRAD_TOL)


def test_plain_bwd_dead_rows_are_zero_not_nan():
    """Rows past the length and sequences of length 0 have lse = +inf:
    their P is 0, so every gradient they touch is exactly 0."""
    q, k, v = _qkv((2, 2, 37, 16), seed=8)
    lens = torch.tensor([20, 0])
    o, lse = tfa.flash_attention_with_lse(*_torch(q, k, v), lengths=lens,
                                          causal=True)
    dq, dk, dv = tfa.flash_attention_bwd(*_torch(q, k, v), o, lse,
                                         torch.ones_like(o), lengths=lens,
                                         causal=True)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
        assert (g[0, :, 20:] == 0).all() and (g[1] == 0).all()


# (shape (B, H, T, D), causal, lengths), T within one reference block
BF16_CASES = [
    ((2, 2, 40, 16), True, None),
    ((2, 2, 37, 16), False, [37, 9]),
    ((1, 2, 64, 32), True, [64]),
]


@pytest.mark.parametrize("shape,causal,lengths", BF16_CASES)
def test_bf16_plain_takes_the_reference_rounding_points(shape, causal,
                                                        lengths):
    """bf16 inputs: the plain forward and backward against the Pallas
    kernels in interpret mode (`jax.vjp` for the backward). T fits one
    reference block (512), so the reference's online softmax takes one
    step and both sides round P and dS to bf16 at the same points (:97,
    :196, :234, :236) from the same f32 values. They differ only where an
    f32 sum taken in another order lands on the other side of a bf16
    rounding boundary and moves one rounded element by one spacing: at
    most 2^-10 of the reference's norm and, elementwise, 2^-9 of its
    largest magnitude. Plain versions that keep P and dS in f32 miss the
    normwise bound by 2-3x here."""
    r = onp.random.RandomState(1)
    q, k, v, do = (r.normal(0, 1, shape).astype("float32") for _ in range(4))
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths)

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, lengths=jl, causal=causal,
                                   interpret=True, impl="pallas")

    ref, vjp = jax.vjp(f, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    refs = (ref, *vjp(jnp.asarray(do, jnp.bfloat16)))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    o, lse = tfa.flash_attention_with_lse(tq, tk, tv, lengths=tl,
                                          causal=causal)
    got = (o, *tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, lengths=tl,
                                       causal=causal))
    for g, rf in zip(got, refs):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        rf = onp.asarray(rf.astype(jnp.float32))
        d = onp.abs(g - rf)
        assert onp.linalg.norm(d) <= 2.0 ** -10 * onp.linalg.norm(rf)
        assert d.max() <= 2.0 ** -9 * onp.abs(rf).max()


@pytest.mark.parametrize("shape,causal,lengths", CASES[:2])
def test_f32_plain_unchanged_by_the_rounding_points(shape, causal, lengths):
    """f32 inputs: rounding P and dS to the input dtype is a no-op, so the
    plain versions give, bit for bit, the formulas without it."""
    q, k, v = _torch(*_qkv(shape, seed=4))
    do = torch.from_numpy(onp.random.RandomState(9).normal(
        0, 1, shape).astype("float32"))
    tl = None if lengths is None else torch.tensor(lengths)
    o, lse = tfa.plain_attention(q, k, v, lengths=tl, causal=causal)
    dq, dk, dv = tfa.plain_attention_bwd(q, k, v, o, lse, do, lengths=tl,
                                         causal=causal)
    scale = 1.0 / onp.sqrt(shape[-1])
    mask, lens = tfa._scores_mask(shape[0], shape[2], shape[2], tl, causal,
                                  q.device)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    o_ref = torch.matmul(p, v) / torch.where(l > 0, l, torch.ones_like(l))
    if lens is not None:
        rows = torch.arange(shape[2])
        o_ref = torch.where((rows[None, :] < lens[:, None])[:, None, :, None],
                            o_ref, torch.zeros_like(o_ref))
    assert torch.equal(o, o_ref)
    lse4 = lse.reshape(shape[0], shape[1], shape[2], 1)
    live = torch.isfinite(lse4)
    p = torch.where(mask & live, torch.exp(
        torch.matmul(q, k.transpose(-1, -2)) * scale
        - torch.where(live, lse4, 0.0)), 0.0)
    ds = p * (torch.matmul(do, v.transpose(-1, -2))
              - (do * o).sum(-1, keepdim=True)) * scale
    assert torch.equal(dq, torch.matmul(ds, k))
    assert torch.equal(dk, torch.matmul(ds.transpose(-1, -2), q))
    assert torch.equal(dv, torch.matmul(p.transpose(-1, -2), do))
