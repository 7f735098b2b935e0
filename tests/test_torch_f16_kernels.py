"""The plain float16 versions of K1-K6 (what each kernel is held against on
the card) against the JAX package's Pallas kernels, on the CPU, as
`tests/test_torch_flash_attention.py`, `test_torch_layer_norm.py`,
`test_torch_fused_block.py` and `test_torch_gelu_dropout.py` hold the
bfloat16 ones:

- K1/K2: the Pallas kernels in interpret mode on float16 q, k, v
  (`jax.vjp` for the backward). T fits one reference block, so both sides
  round P and dS to float16 at the same points (:97, :196, :234, :236)
  from the same f32 values; they differ only where an f32 sum taken in
  another order lands on the other side of a float16 rounding boundary:
  at most 2^-13 of the reference's norm and, elementwise, 2^-12 of its
  largest magnitude (the bfloat16 bounds scaled by float16's 3 extra
  mantissa bits).
- K3: ``_core`` (its custom vjp over the Pallas `_fwd`/`_bwd`, interpret
  mode) at p = 0, in AMP's float16 layout (f32 x, f16 h, f32 gamma/beta)
  and all-f16; at p > 0 the port's own composition, LayerNorm of
  x + dropout(h), bit for bit.
- K4/K4b: the Pallas `_fwd` and `jax.vjp` of `layer_norm` in interpret
  mode, f16 x with f32 gamma/beta and all-f16.
- K5: the mask of a key is the float32 one (one Philox stream), the kept
  values x * 1/(1-p) rounded once.
- K6: ``_gd_core`` at p = 0, forward and backward.

Float16 outputs are held within one spacing (2^-10 rel) plus the float32
tolerance of the bfloat16 tests near zero; float32 outputs (statistics,
f32 x's y and dx, dgamma/dbeta in f32) as in float32.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu.ops import layer_norm as jln
from incubator_mxnet_tpu_torch.ops import _philox as ph
from incubator_mxnet_tpu_torch.ops import dropout as tdp
tfa = importlib.import_module(
    "incubator_mxnet_tpu_torch.ops.flash_attention")
from incubator_mxnet_tpu_torch.ops import fused_block as tfb
from incubator_mxnet_tpu_torch.ops import layer_norm as tln

jfa = importlib.import_module("incubator_mxnet_tpu.ops.flash_attention")
jfb = importlib.import_module("incubator_mxnet_tpu.ops.fused_block")

F16_TOL = dict(rtol=2.0 ** -10, atol=1e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(a):
    return onp.asarray(a.astype(jnp.float32)) if hasattr(a, "astype") and \
        not isinstance(a, onp.ndarray) else onp.asarray(a, onp.float32)


def _t(a):
    return a.detach().float().numpy()


# (shape (B, H, T, D), causal, lengths), T within one reference block
ATTN_CASES = [
    ((2, 2, 40, 16), True, None),
    ((2, 2, 37, 16), False, [37, 9]),
    ((1, 2, 64, 32), True, [64]),
]


@pytest.mark.parametrize("shape,causal,lengths", ATTN_CASES)
def test_f16_attention_takes_the_reference_rounding_points(shape, causal,
                                                           lengths):
    r = onp.random.RandomState(1)
    q, k, v, do = (r.normal(0, 1, shape).astype("float32") for _ in range(4))
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths)

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, lengths=jl, causal=causal,
                                   interpret=True, impl="pallas")

    ref, vjp = jax.vjp(f, *(jnp.asarray(a, jnp.float16) for a in (q, k, v)))
    refs = (ref, *vjp(jnp.asarray(do, jnp.float16)))
    tq, tk, tv, tdo = (torch.from_numpy(a).half() for a in (q, k, v, do))
    o, lse = tfa.flash_attention_with_lse(tq, tk, tv, lengths=tl,
                                          causal=causal)
    got = (o, *tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, lengths=tl,
                                       causal=causal))
    for g, rf in zip(got, refs):
        assert g.dtype == torch.float16 and rf.dtype == jnp.float16
        g, rf = _t(g), _np(rf)
        assert onp.isfinite(g).all()
        d = onp.abs(g - rf)
        assert onp.linalg.norm(d) <= 2.0 ** -13 * onp.linalg.norm(rf)
        assert d.max() <= 2.0 ** -12 * onp.abs(rf).max()


def _inputs(rows, c, seed):
    r = onp.random.RandomState(seed)
    x = (r.normal(0, 1, (rows, c)) + 0.3).astype("float32")
    h = r.normal(0, 1, (rows, c)).astype("float32")
    g = r.normal(1, 0.3, (c,)).astype("float32")
    b = r.normal(0, 0.3, (c,)).astype("float32")
    dy = r.normal(0, 1, (rows, c)).astype("float32")
    return x, h, g, b, dy


def _half(a):
    """A float32 array rounded to float16 once: (torch f16, jax f16)."""
    t = torch.from_numpy(a).half()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.float16)


@pytest.mark.parametrize("layout", ["f32 x, f16 h", "f16"])
@pytest.mark.parametrize("rows,c", [(16, 128), (75, 768)])
def test_f16_residual_p0_matches_pallas_core_interpret(layout, rows, c):
    x, h, g, b, dy = _inputs(rows, c, seed=rows + 3 * c)
    all16 = layout == "f16"
    ht, hj = _half(h)
    if all16:
        (xt, xj), (gt, gj), (bt, bj), (dyt, dyj) = (
            _half(a) for a in (x, g, b, dy))
    else:
        xt, gt, bt, dyt = (torch.from_numpy(a) for a in (x, g, b, dy))
        xj, gj, bj, dyj = (jnp.asarray(a) for a in (x, g, b, dy))

    def core(x, h, g, b):
        return jfb._core(x, h, g, b, jnp.zeros((2,), jnp.int32), 0.0, 1e-5,
                         True)

    y_ref, vjp = jax.vjp(core, xj, hj, gj, bj)
    refs = vjp(dyj)
    leaves = [t.clone().requires_grad_() for t in (xt, ht, gt, bt)]
    y = tfb.residual_dropout_ln(*leaves, 0.0, (0, 0))
    y.backward(dyt)
    assert y.dtype == xt.dtype and leaves[1].grad.dtype == torch.float16
    assert _np(y_ref).shape == y.shape
    # x, h, gamma, beta: f16 ones within one spacing, f32 ones as in
    # float32 (dgamma/dbeta sum the rows in another order: PARAM_TOL)
    x_tol = F16_TOL if all16 else TOL
    p_tol = dict(rtol=2.0 ** -10, atol=1e-4) if all16 else PARAM_TOL
    onp.testing.assert_allclose(_t(y), _np(y_ref), **x_tol)
    for leaf, ref, tol in zip(leaves, refs, (x_tol, F16_TOL, p_tol, p_tol)):
        assert str(leaf.grad.dtype).endswith(str(ref.dtype))
        onp.testing.assert_allclose(_t(leaf.grad), _np(ref), **tol)


@pytest.mark.parametrize("layout", ["f32 x, f16 h", "f16"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_f16_residual_is_layer_norm_of_dropout_bit_for_bit(layout, p):
    """At p > 0: the fused plain version equals the LayerNorm plain version
    of x + the dropout plain version of h (widened to f32), forward and
    every gradient."""
    x, h, g, b, dy = _inputs(33, 256, seed=7)
    all16 = layout == "f16"
    xt = torch.from_numpy(x).half() if all16 else torch.from_numpy(x)
    ht = torch.from_numpy(h).half()
    gt, bt = ((torch.from_numpy(a).half() if all16 else torch.from_numpy(a))
              for a in (g, b))
    key = (2024, 7)
    y, mean, rstd = tfb.residual_dropout_ln_fwd(xt, ht, gt, bt, key, p)
    s = xt.float() + tdp.dropout_fwd(ht.float(), key, p)
    want, wmean, wrstd = tln.plain_layer_norm(s, gt, bt)
    assert torch.equal(y, want.to(xt.dtype))
    assert torch.equal(mean, wmean) and torch.equal(rstd, wrstd)
    dyt = torch.from_numpy(dy).to(xt.dtype)
    dx, dh, dg, db = tfb.residual_dropout_ln_bwd(xt, ht, dyt, mean, rstd, gt,
                                                 key, p)
    ds, wdg, wdb = tln.plain_ln_grads(s, dyt, mean, rstd, gt)
    assert torch.equal(dx, ds.to(xt.dtype))
    assert torch.equal(dh, tdp.dropout_fwd(ds, key, p).half())
    assert torch.equal(dg, wdg.to(gt.dtype)) and torch.equal(db,
                                                             wdb.to(gt.dtype))


@pytest.mark.parametrize("param", ["float32", "float16"])
@pytest.mark.parametrize("rows,c", [(13, 64), (10, 768), (800, 768)])
def test_f16_layer_norm_fwd_matches_pallas_interpret(param, rows, c):
    x, _, g, b, _ = _inputs(rows, c, seed=rows * 5 + c)
    xt, xj = _half(x)
    if param == "float16":
        (gt, gj), (bt, bj) = _half(g), _half(b)
    else:
        gt, bt = torch.from_numpy(g), torch.from_numpy(b)
        gj, bj = jnp.asarray(g), jnp.asarray(b)
    y_ref, m_ref, r_ref = jln._fwd(xj, gj, bj, 1e-5, rows, True)
    y, mean, rstd = tln.layer_norm_fwd(xt, gt, bt)
    assert y.dtype == torch.float16 and y_ref.dtype == jnp.float16
    assert mean.dtype == rstd.dtype == torch.float32
    onp.testing.assert_allclose(_t(y), _np(y_ref), **F16_TOL)
    onp.testing.assert_allclose(mean.numpy(), _np(m_ref)[:, 0], **TOL)
    onp.testing.assert_allclose(rstd.numpy(), _np(r_ref)[:, 0], **TOL)


@pytest.mark.parametrize("param", ["float32", "float16"])
@pytest.mark.parametrize("rows,c", [(24, 64), (75, 768)])
def test_f16_layer_norm_bwd_matches_pallas_vjp_interpret(param, rows, c):
    """dx in f16, dgamma/dbeta in gamma's dtype, against `jax.vjp` of the
    JAX package's `layer_norm` over its interpret-mode kernels."""
    x, _, g, b, dy = _inputs(rows, c, seed=rows + 7 * c)
    (xt, xj), (dyt, dyj) = _half(x), _half(dy)
    if param == "float16":
        (gt, gj), (bt, bj) = _half(g), _half(b)
    else:
        gt, bt = torch.from_numpy(g), torch.from_numpy(b)
        gj, bj = jnp.asarray(g), jnp.asarray(b)

    def f(x, g, b):
        return jln.layer_norm(x, g, b, block_r=8, interpret=True)

    _, vjp = jax.vjp(f, xj, gj, bj)
    refs = vjp(dyj)
    leaves = [t.clone().requires_grad_() for t in (xt, gt, bt)]
    y = tln.layer_norm(*leaves)
    assert y.dtype == torch.float16
    y.backward(dyt)
    pt = F16_TOL if param == "float16" else PARAM_TOL
    for leaf, ref, tol in zip(leaves, refs, (F16_TOL, pt, pt)):
        assert str(leaf.grad.dtype).endswith(str(ref.dtype))
        # dgamma/dbeta sum 24-75 rows: the f32 order's error on top
        onp.testing.assert_allclose(_t(leaf.grad), _np(ref),
                                    rtol=tol["rtol"],
                                    atol=max(tol["atol"], 1e-4))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_f16_dropout_has_the_f32_mask(p):
    x = torch.from_numpy(_inputs(40, 96, seed=3)[0])
    key = (123456789, 987654321)
    y16 = tdp.dropout_fwd(x.half(), key, p)
    keep = ph.keep_mask(x.shape, key, p)
    scale = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    assert y16.dtype == torch.float16
    assert torch.equal(y16, torch.where(keep, x.half().float() * scale,
                                        0.0).half())
    assert torch.equal(y16 != 0, tdp.dropout_fwd(x, key, p) != 0)


@pytest.mark.parametrize("shape", [(16, 256), (40, 384)])
def test_f16_gelu_dropout_p0_matches_pallas_core(shape):
    """K6 at p = 0 against `_gd_core` in interpret mode, forward and
    `jax.vjp` backward; the reference's gelu is the Abramowitz-Stegun erf
    (ROADMAP.md §3), within 2e-6 of the exact form before the rounding."""
    r = onp.random.RandomState(shape[0])
    u = r.normal(0, 1.5, shape).astype("float32")
    dy = r.normal(0, 1, shape).astype("float32")
    (ut, uj), (dyt, dyj) = _half(u), _half(dy)

    def core(u):
        return jfb._gd_core(u, jnp.zeros((2,), jnp.int32), 0.0, True)

    ref, vjp = jax.vjp(core, uj)
    (dref,) = vjp(dyj)
    leaf = ut.clone().requires_grad_()
    y = tfb.gelu_dropout(leaf, 0.0, (0, 0))
    y.backward(dyt)
    assert y.dtype == leaf.grad.dtype == torch.float16
    onp.testing.assert_allclose(_t(y), _np(ref), rtol=2.0 ** -10, atol=2e-5)
    onp.testing.assert_allclose(_t(leaf.grad), _np(dref), rtol=2.0 ** -10,
                                atol=2e-5)
