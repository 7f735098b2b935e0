"""The port's LayerNorm (`incubator_mxnet_tpu_torch.ops.layer_norm`, K4
and K4b, plain path on CPU tensors) against the JAX package's Pallas
kernels in interpret mode, on the same numpy-seeded inputs: the forward
`ops.layer_norm._fwd` for y, mean and rstd, and the backward through
`jax.vjp` of its `layer_norm` for dx, dgamma and dbeta.

Tolerance: 1e-5 abs and rel in float32 (both sides compute the statistics
in f32, summing in different orders); 1e-4 for dgamma/dbeta, which sum
over all rows. AMP's layout, bf16 x with f32 gamma/beta, is held to the
same kernels given the same mix: bf16 outputs within one bf16 spacing.
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
                                    (3, 768), (1, 768), (4, 768), (16, 768),
                                    (64, 768), (800, 768)])
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


# rows over several of the reference's 8-row blocks, the last one padded;
# 75 = 72 + 3 rows at BERT-base's width
@pytest.mark.parametrize("rows,c", [(24, 64), (37, 96), (19, 768),
                                    (75, 768)])
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
    bf = (xt.detach().bfloat16(), dy.bfloat16(), mean.detach(),
          rstd.detach(), gt.detach().bfloat16())
    dxb, dgb, dbb = tln.layer_norm_bwd(*bf)
    assert dxb.dtype == dgb.dtype == dbb.dtype == torch.bfloat16
    # dgamma/dbeta as the kernel writes them: the f32 sums rounded once
    _, dg32, db32 = tln.plain_ln_grads(*bf)
    assert torch.equal(dgb, dg32.bfloat16()) and torch.equal(
        dbb, db32.bfloat16())


# (rows, SMs): one row a warp while rows are few; two 8-warp blocks an SM
# past that, whatever the row count
@pytest.mark.parametrize("rows,sms,blocks", [
    (1, 132, 1), (7, 132, 1), (8, 132, 1), (9, 132, 2), (2112, 132, 264),
    (2113, 132, 264), (8192, 132, 264), (65536, 132, 264), (8192, 78, 156)])
def test_bwd_grid_is_fixed_per_row_count(rows, sms, blocks):
    assert tln.row_blocks(rows, sms) == blocks
    assert tln.row_blocks(rows, sms) == tln.row_blocks(rows, sms)
    # every warp of the grid has at most ceil(rows / warps) rows
    assert blocks * tln.ROW_WARPS * -(-rows // (blocks * tln.ROW_WARPS)) \
        >= rows


# SMs: the H100 SXM's 132, the H100 PCIe's 114, a smaller card, one SM
@pytest.mark.parametrize("sms", [132, 114, 78, 1])
def test_row_grid_covers_every_row_count(sms):
    """One grid of the row kernels (forward and backward) for each row
    count from 1 to 65536: every block has a row and every row a warp;
    one row a warp while every row's warp fits on the card at once, the
    card's resident blocks, each walking, past that."""
    full = tln.ROW_WARPS * tln.ROW_BLOCKS_PER_SM * sms
    for rows in range(1, 65537):
        blocks = tln.row_blocks(rows, sms)
        lanes = blocks * tln.ROW_WARPS
        assert 1 <= blocks and (blocks - 1) * tln.ROW_WARPS < rows
        if rows <= full:   # one row a warp
            assert rows <= lanes < rows + tln.ROW_WARPS
        else:              # the card's resident blocks, each walking
            assert blocks == tln.ROW_BLOCKS_PER_SM * sms


@pytest.mark.parametrize("sms", [132, 78])
def test_row_grid_bound_is_the_one_chip_smoke_checks(sms):
    """chip_smoke.py checks the forward's bit-for-bit invariance on both
    sides of the row count past which the grid's warps walk, at one row
    and at 8192."""
    import chip_smoke

    rows = chip_smoke.fwd_invariance_rows(sms)
    assert {1, 8192} <= set(rows)
    full = tln.ROW_WARPS * tln.ROW_BLOCKS_PER_SM * sms
    assert {full, full + 1} <= set(rows)
    assert tln.row_blocks(full, sms) * tln.ROW_WARPS == full
    assert tln.row_blocks(full + 1, sms) == tln.row_blocks(full, sms)


def _kernel_order_sum(terms, nblocks, warps=8):
    """float32 column sums of (rows, C) ``terms`` in the row backward's
    order: warp w of block b adds rows b * warps + w, then every
    nblocks * warps-th row, in turn; a block adds its warps' sums in warp
    order; the reduction's warps add every BWD_REDUCE_WARPS-th block
    partial in turn, then warp 0 adds the warp sums in order."""
    rows, c = terms.shape
    lanes = nblocks * warps
    per = -(-rows // lanes)
    padded = onp.zeros((per * lanes, c), onp.float32)
    padded[:rows] = terms
    # [k, lane] -> row k * lanes + lane; adding zeros is exact
    by_warp = onp.add.accumulate(padded.reshape(per, lanes, c), axis=0,
                                 dtype=onp.float32)[-1]
    blocks = onp.add.accumulate(by_warp.reshape(nblocks, warps, c), axis=1,
                                dtype=onp.float32)[:, -1]
    rw = tln.BWD_REDUCE_WARPS
    rounds = -(-nblocks // rw)
    pb = onp.zeros((rounds * rw, c), onp.float32)
    pb[:nblocks] = blocks
    red = onp.add.accumulate(pb.reshape(rounds, rw, c), axis=0,
                             dtype=onp.float32)[-1]
    return onp.add.accumulate(red, axis=0, dtype=onp.float32)[-1]


@pytest.mark.parametrize("rows", [1, 75, 2113, 8192])
def test_column_sum_tol_covers_the_kernel_order(rows):
    """The kernel's float32 order of a dgamma-like column sum and the
    plain float32 sum each stay within `column_sum_tol` of the exact sum
    (float64), so their difference does too (at half the bound each)."""
    c = 16
    r = onp.random.RandomState(rows)
    terms = (r.normal(0, 1, (rows, c)) * r.lognormal(0, 2, (rows, 1))
             ).astype(onp.float32)
    exact = terms.astype(onp.float64).sum(0)
    nblocks = tln.row_blocks(rows, 132)
    tol = tln.column_sum_tol(
        torch.from_numpy(onp.abs(terms).sum(0).astype(onp.float32)), rows,
        nblocks).double().numpy()
    kernel = _kernel_order_sum(terms, nblocks).astype(onp.float64)
    plain = torch.from_numpy(terms).sum(0).double().numpy()
    assert (onp.abs(kernel - exact) <= tol / 2).all()
    assert (onp.abs(plain - exact) <= tol / 2).all()
    assert (onp.abs(kernel - plain) <= tol).all()


# -- AMP's layout: bf16 x, y and dx with f32 gamma/beta and dgamma/dbeta --
# Both sides compute in f32 and round y and dx to bf16 once, so they are
# equal or one bf16 spacing apart (2^-7 relative, plus the f32 difference
# near zero); the f32 statistics and dgamma/dbeta as in float32.
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _bf16_inputs(rows, c, seed):
    """x rounded to bf16 once, so both sides see the same bf16 values."""
    x, g, b = _inputs(rows, c, seed)
    return torch.from_numpy(x).bfloat16(), g, b


@pytest.mark.parametrize("rows,c", [(13, 64), (10, 768), (3, 768),
                                    (1, 768), (4, 768), (16, 768), (64, 768),
                                    (800, 768)])
def test_bf16_x_f32_gamma_fwd_matches_pallas_interpret(rows, c):
    xt, g, b = _bf16_inputs(rows, c, seed=rows * 3 + c)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    y_ref, m_ref, r_ref = jln._fwd(xj, jnp.asarray(g), jnp.asarray(b), 1e-5,
                                   rows, True)
    y, mean, rstd = tln.layer_norm_fwd(xt, torch.from_numpy(g),
                                       torch.from_numpy(b))
    assert y.dtype == torch.bfloat16 and y_ref.dtype == jnp.bfloat16
    assert mean.dtype == rstd.dtype == torch.float32
    onp.testing.assert_allclose(y.float().numpy(),
                                onp.asarray(y_ref, onp.float32), **BF16_TOL)
    onp.testing.assert_allclose(mean.numpy(), onp.asarray(m_ref)[:, 0], **TOL)
    onp.testing.assert_allclose(rstd.numpy(), onp.asarray(r_ref)[:, 0], **TOL)


@pytest.mark.parametrize("rows,c", [(24, 64), (19, 768), (75, 768)])
def test_bf16_x_f32_gamma_bwd_matches_pallas_vjp_interpret(rows, c):
    """dx in bf16, dgamma/dbeta in f32 (gamma's dtype), against `jax.vjp`
    of the JAX package's `layer_norm` over its interpret-mode kernels."""
    xt, g, b = _bf16_inputs(rows, c, seed=rows + 5 * c)
    dy = torch.from_numpy(onp.random.RandomState(rows).normal(
        0, 1, (rows, c)).astype("float32")).bfloat16()

    def f(x, g, b):
        return jln.layer_norm(x, g, b, block_r=8, interpret=True)

    xj, dyj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
               for t in (xt, dy))
    _, vjp = jax.vjp(f, xj, jnp.asarray(g), jnp.asarray(b))
    refs = vjp(dyj)
    leaves = [xt.clone().requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in (g, b)]
    y = tln.layer_norm(*leaves)
    assert y.dtype == torch.bfloat16
    y.backward(dy)
    assert leaves[0].grad.dtype == torch.bfloat16
    assert leaves[1].grad.dtype == leaves[2].grad.dtype == torch.float32
    assert refs[0].dtype == jnp.bfloat16 and refs[1].dtype == jnp.float32
    for leaf, ref, tol in zip(leaves, refs, (BF16_TOL, PARAM_TOL,
                                             PARAM_TOL)):
        onp.testing.assert_allclose(leaf.grad.float().numpy(),
                                    onp.asarray(ref, onp.float32), **tol)


_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16


# (x, gamma, beta, dy, h): the layouts the row kernels take ...
@pytest.mark.parametrize("dts", [
    (_F32, _F32, _F32, _F32, None), (_BF16, _BF16, _BF16, _BF16, None),
    (_BF16, _F32, _F32, _BF16, None), (_F32, _F32, _F32, _F32, _F32),
    (_BF16, _BF16, _BF16, _BF16, _BF16), (_F32, _F32, _F32, _F32, _BF16)])
def test_check_kernel_args_takes_the_kernels_layouts(dts):
    x, g, b, dy, h = (None if d is None else torch.zeros(4, 64, dtype=d)
                      for d in dts)
    tln.check_kernel_args("t", x, (g[0], b[0]), (dy,), h=h)
    assert tln.supports((4, 64), -1, 64, dts[0], dts[1],
                        None if h is None else h.dtype)


# ... and mixes they do not take, which raise rather than being cast
@pytest.mark.parametrize("dts", [
    (_F32, _BF16, _BF16, _F32, None),      # f32 x, bf16 gamma
    (_BF16, _F32, _BF16, _BF16, None),     # gamma and beta differ
    (_BF16, _F32, _F32, _F32, None),       # dy not in x's dtype
    (_F16, _F16, _F16, _F16, None),        # float16
    (_F16, _F32, _F32, _F16, None),
    (_BF16, _F32, _F32, _BF16, _BF16),     # bf16 x and h, f32 gamma
    (_F32, _BF16, _BF16, _F32, _BF16),     # bf16 h and gamma, f32 x
    (_BF16, _F32, _F32, _BF16, _F32),      # bf16 x, f32 h
    (_F32, _F32, _F32, _F32, _F16)])       # float16 h
def test_check_kernel_args_raises_on_other_layouts(dts):
    x, g, b, dy, h = (None if d is None else torch.zeros(4, 64, dtype=d)
                      for d in dts)
    with pytest.raises(MXNetError):
        tln.check_kernel_args("t", x, (g[0], b[0]), (dy,), h=h)
    if dts[1] == dts[2] and dts[3] == dts[0]:
        assert not tln.supports((4, 64), -1, 64, dts[0], dts[1],
                                None if h is None else h.dtype)


# ... and shapes they do not take: gamma of another width, a companion
# (dy, h) of another shape, C not a whole number of 16-byte vectors
@pytest.mark.parametrize("case", ["gamma", "beta", "dy", "h", "feat"])
def test_check_kernel_args_raises_on_other_shapes(case):
    c = 66 if case == "feat" else 64
    x = torch.zeros(4, c)
    g = torch.zeros(32 if case == "gamma" else c)
    b = torch.zeros(32 if case == "beta" else c)
    dy = torch.zeros(4, 32) if case == "dy" else torch.zeros(4, c)
    h = torch.zeros(3, c) if case == "h" else None
    with pytest.raises(MXNetError):
        tln.check_kernel_args("t", x, (g, b), (dy,), h=h)
