"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small and ragged shapes (marker ``cuda``; skips without a card).

This file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances (kernel vs plain, same inputs on the card): float32 2e-5 for
LayerNorm forward, dx and dh (f32 row sums in another order), 1e-4 for
attention, and 1e-4 of the largest magnitude for its gradients (sums over
up to a few hundred keys or rows); dgamma/dbeta, summed over all rows,
within the summation-order bound of `ops.layer_norm.column_sum_tol`; bfloat16 2^-7 rel and
1e-5 abs, elementwise (both sides round nearly the same f32 value to bf16
once, so they are equal or neighbours); lse 1e-4 in both (f32 on both
sides). Flash attention in bfloat16 (K1, K2) is held normwise instead:
the kernels round P and dS to bf16 as the reference does, the forward at
its running max and the plain version at the final max, so an element
near zero, a sum of terms that cancel, may differ by more than one
spacing of its own; the error is at most 2^-7 of the plain tensor's norm
and, elementwise, 2^-6 of its largest magnitude. Dropout is bit-identical (same Philox words, same f32 multiply).
AMP's mixed layouts (LayerNorm: bf16 x with f32 gamma/beta; the residual
kernels: f32 x with bf16 h and f32 gamma/beta) by the same rules per
output dtype, and the mixed residual kernels equal the f32 ones on h
widened to f32 bit for bit (dh rounded to bf16 once).
The fused GELU + dropout (K6): float32 2e-6 abs at unit-normal inputs
(the kernel's rational normal tail and the plain version's erf each lie
within ~4e-7 of float64 there; only last bits and the order of the
roundings differ), bfloat16 as above, and its mask bit for bit the
dropout kernel's.
"""
import math

import pytest
import torch

from incubator_mxnet_tpu_torch import npx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models.decoding import GPTDecoder
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.ops import _philox as ph
from incubator_mxnet_tpu_torch.ops import dropout as dp
from incubator_mxnet_tpu_torch.ops import flash_attention as fa
from incubator_mxnet_tpu_torch.ops import fused_block as fb
from incubator_mxnet_tpu_torch.ops import layer_norm as ln

pytestmark = pytest.mark.cuda

# (rtol, atol)
BF16_TOL = (2.0 ** -7, 1e-5)
LN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: BF16_TOL}
# flash attention in bfloat16: normwise relative, and elementwise relative
# to the plain tensor's largest magnitude
ATTN_BF16_NORM_TOL, ATTN_BF16_MAX_TOL = 2.0 ** -7, 2.0 ** -6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", [(1, 64), (5, 96), (13, 768), (40, 768),
                                    (1000, 768), (7, 1000), (3, 4096),
                                    (33, 8)])
def test_layer_norm_kernel_vs_plain(dev, dtype, rows, c):
    if c % (16 // (torch.finfo(dtype).bits // 8)):
        pytest.skip("feature size not a whole number of 16-byte vectors")
    g = _gen(dev, rows * c)
    x = (torch.randn(rows, c, generator=g, device=dev) * 2 + 0.5).to(dtype)
    gamma = (1 + 0.3 * torch.randn(c, generator=g, device=dev)).to(dtype)
    beta = (0.3 * torch.randn(c, generator=g, device=dev)).to(dtype)
    y, m, r = ln.layer_norm_fwd(x, gamma, beta, impl="kernel")
    yp, mp, rp = ln.layer_norm_fwd(x, gamma, beta, impl="plain")
    torch.cuda.synchronize()
    assert y.dtype == dtype and m.dtype == r.dtype == torch.float32
    rtol, atol = LN_TOL[dtype]
    torch.testing.assert_close(y.float(), yp.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(m, mp, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(r, rp, rtol=2e-5, atol=2e-5)


def test_layer_norm_misaligned_and_strided_input(dev):
    base = torch.randn(4 * 768 + 1, device=dev)
    x = base[1:].view(4, 768)                  # 4-byte offset: not 16-aligned
    gamma = torch.rand(768, device=dev)
    beta = torch.rand(768, device=dev)
    torch.testing.assert_close(ln.layer_norm(x, gamma, beta, impl="kernel"),
                               ln.layer_norm(x, gamma, beta, impl="plain"),
                               rtol=2e-5, atol=2e-5)
    x3 = torch.randn(3, 5, 768, device=dev)[:, 2]  # rows with a stride
    torch.testing.assert_close(ln.layer_norm(x3, gamma, beta),
                               ln.layer_norm(x3, gamma, beta, impl="plain"),
                               rtol=2e-5, atol=2e-5)


def test_layer_norm_kernel_rejects_what_it_cannot_take(dev):
    x = torch.randn(4, 8192, device=dev)
    gamma, beta = torch.ones(8192, device=dev), torch.zeros(8192, device=dev)
    with pytest.raises(MXNetError):
        ln.layer_norm(x, gamma, beta)              # above MAX_FEATURES
    with pytest.raises(MXNetError):
        ln.layer_norm(x[:, :766], gamma[:766], beta[:766])
    with pytest.raises(MXNetError):                # gamma of the wrong size
        ln.layer_norm(torch.randn(2, 64, device=dev), gamma[:32], beta[:64])
    w = torch.ones(64, device=dev, requires_grad=True)
    with pytest.raises(MXNetError):                # f32 x, bf16 gamma
        ln.layer_norm(torch.randn(2, 64, device=dev), w.bfloat16(),
                      torch.zeros_like(w).bfloat16())


def test_npx_layer_norm_launches_or_raises_on_the_card(dev):
    """npx.layer_norm (what gluon.nn.LayerNorm calls) never computes a
    CUDA tensor with composed ops: it launches the kernel or raises."""
    x = torch.randn(3, 4100, device=dev)
    g, b = torch.ones(4100, device=dev), torch.zeros(4100, device=dev)
    ln.launches = 0
    with pytest.raises(MXNetError):
        npx.layer_norm(x, g, b)                    # C above MAX_FEATURES
    x = torch.randn(4, 6, 64, device=dev)
    g, b = torch.rand(64, device=dev), torch.rand(64, device=dev)
    with pytest.raises(MXNetError):
        npx.layer_norm(x, torch.rand(4, device=dev),
                       torch.rand(4, device=dev), axis=0)
    with pytest.raises(MXNetError):                # f32 x, bf16 gamma/beta
        npx.layer_norm(x, g.bfloat16(), b.bfloat16())
    assert ln.launches == 0
    ref = ln.layer_norm(x, g, b, impl="plain")
    torch.testing.assert_close(npx.layer_norm(x, g, b), ref,
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(
        npx.layer_norm(x), ln.layer_norm(x, torch.ones_like(g),
                                         torch.zeros_like(b), impl="plain"),
        rtol=2e-5, atol=2e-5)
    assert ln.launches == 2


# (B, H, Tq, Tk, d, causal, lengths)
ATTN_CASES = [
    (2, 3, 64, 64, 64, True, None),
    (1, 2, 37, 37, 64, True, None),
    (2, 2, 130, 130, 64, False, [130, 41]),
    (2, 2, 100, 100, 64, True, [1, 77]),
    (1, 2, 70, 70, 16, True, None),
    (1, 2, 65, 65, 100, False, None),
    (2, 1, 129, 129, 128, True, [129, 0]),
    (1, 2, 20, 150, 64, False, None),
    (1, 1, 1, 1, 64, True, None),
    (2, 2, 90, 90, 40, True, [90, 33]),
    (2, 2, 1, 1000, 64, False, None),
]


def _attn_close(got, ref, dtype):
    """K1/K2 output against its plain version: float32 within 1e-4
    elementwise; bfloat16 normwise (see the module's note)."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        return
    g, r = got.float(), ref.float()
    d = g - r
    assert d.norm().item() <= ATTN_BF16_NORM_TOL * r.norm().item()
    assert d.abs().max().item() <= ATTN_BF16_MAX_TOL * r.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_kernel_vs_plain(dev, dtype, case):
    b, h, tq, tk, d, causal, lengths = case
    g = _gen(dev, tq * d + b)
    q = torch.randn(b, h, tq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, h, tk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, h, tk, d, generator=g, device=dev).to(dtype)
    lens = None if lengths is None else torch.tensor(lengths, device=dev)
    o, lse = fa.flash_attention_with_lse(q, k, v, lengths=lens,
                                         causal=causal, impl="kernel")
    op, lsep = fa.flash_attention_with_lse(q, k, v, lengths=lens,
                                           causal=causal, impl="plain")
    torch.cuda.synchronize()
    assert o.shape == q.shape and o.dtype == dtype
    _attn_close(o, op, dtype)
    assert torch.equal(torch.isinf(lse), torch.isinf(lsep))
    fin = torch.isfinite(lsep)
    torch.testing.assert_close(lse[fin], lsep[fin], rtol=1e-4, atol=1e-4)
    if lengths is not None:
        for i, n in enumerate(lengths):
            assert (o[i, :, n:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bthd_views_of_fused_qkv(dev, dtype):
    """The main path's call: q, k, v are strided views of one (N, T, 3, H,
    d) projection output, read in place."""
    n, t, h, d = 3, 150, 4, 64
    qkv = torch.randn(n, t, 3, h, d, generator=_gen(dev, 3),
                      device=dev).to(dtype)
    q, k, v = qkv.unbind(2)
    o = fa.flash_attention(q, k, v, causal=True, layout="bthd",
                           impl="kernel")
    ref = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True, layout="bthd", impl="plain")
    assert o.shape == (n, t, h, d) and o.is_contiguous()
    _attn_close(o, ref, dtype)


def test_launch_counters_count_kernel_launches_only(dev):
    x = torch.randn(4, 64, device=dev)
    w, bias = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    q = torch.randn(1, 1, 8, 64, device=dev)
    ln.launches = fa.launches = 0
    ln.layer_norm(x, w, bias)
    ln.layer_norm(x, w, bias, impl="plain")
    fa.flash_attention(q, q, q)
    fa.flash_attention(q, q, q, impl="plain")
    assert (ln.launches, fa.launches) == (1, 1)


def test_tiny_gpt_on_card_matches_cpu(dev):
    """End to end at a tiny size: the same seeded weights on the card
    (kernels) and on the CPU (plain versions) give the same greedy tokens
    and logits within 1e-4."""
    cpu = gpt_tiny(vocab_size=97, max_length=64, dropout=0.0, device="cpu",
                   seed=3)
    with torch.no_grad():
        for p in cpu.parameters():
            if p.dim() >= 2:
                p.normal_(0, 0.35, generator=torch.Generator().manual_seed(
                    p.numel()))
    gpu = gpt_tiny(vocab_size=97, max_length=64, dropout=0.0, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randint(0, 97, (2, 12), generator=torch.Generator()
                      .manual_seed(0))
    ln.launches = fa.launches = 0
    got = gpu.generate(x.to(dev), 20).cpu()
    assert fa.launches == 2 and ln.launches == 5 * 20
    torch.testing.assert_close(got, cpu.generate(x, 20), rtol=0, atol=0)
    cont = got[:, 12:]
    lg = GPTDecoder(gpu).score(x.to(dev), cont.to(dev)).cpu()
    lc = GPTDecoder(cpu).score(x, cont)
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        torch.testing.assert_close(gpu(got.to(dev)).cpu(), cpu(got),
                                   rtol=1e-4, atol=1e-4)
    assert math.isfinite(float(lg.abs().max()))


# -- the training slice's kernels: K2, K3, K4b, K5 ---------------------------

def _bf16_close(got, ref):
    g, r = got.float(), ref.float()
    assert bool(((g - r).abs() <= BF16_TOL[0] * r.abs() + BF16_TOL[1]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,p", [((1, 4), 0.5), ((7, 13), 0.1),
                                     ((1000, 768), 0.1), ((33, 3072), 0.1),
                                     ((5, 8), 0.9)])
def test_dropout_kernel_vs_plain_bit_identical(dev, dtype, shape, p):
    """Same key, same Philox words, same f32 multiply: the kernel's output
    equals the plain version's exactly (the tail of a numel that is not a
    whole number of vectors included)."""
    x = torch.randn(*shape, generator=_gen(dev, 5), device=dev).to(dtype)
    key = (123456789, 987654321)
    y = dp.dropout_fwd(x, key, p, impl="kernel")
    yp = dp.dropout_fwd(x, key, p, impl="plain")
    torch.cuda.synchronize()
    assert y.dtype == dtype and torch.equal(y, yp)
    keep = ph.keep_mask(shape, key, p, device=dev)
    assert torch.equal(y != 0, keep & (x != 0))


def test_dropout_misaligned_noncontiguous_and_trivial_p(dev):
    base = torch.randn(4 * 768 + 1, device=dev)
    x = base[1:].view(4, 768)                       # not 16-byte aligned
    key = (3, 4)
    torch.testing.assert_close(dp.dropout_fwd(x, key, 0.2),
                               dp.dropout_fwd(x, key, 0.2, impl="plain"),
                               rtol=0, atol=0)
    xt = torch.randn(64, 96, device=dev).t()        # transposed view
    torch.testing.assert_close(dp.dropout_fwd(xt, key, 0.2),
                               dp.dropout_fwd(xt, key, 0.2, impl="plain"),
                               rtol=0, atol=0)
    dp.launches = 0
    assert dp.dropout_fwd(x, key, 0.0) is x          # p = 0: identity
    assert (dp.dropout_fwd(x, key, 1.0) == 0).all()  # p = 1: zeros
    assert dp.launches == 0
    with pytest.raises(MXNetError):
        dp.dropout_fwd(x.half(), key, 0.2)           # no fp16 kernel


def test_dropout_backward_reuses_the_mask(dev):
    x = torch.randn(16, 64, device=dev, requires_grad=True)
    dp.launches = 0
    y = dp.dropout(x, (9, 9), 0.3)
    y.backward(torch.ones_like(y))
    assert dp.launches == 2
    torch.testing.assert_close(x.grad, (y != 0).float() / 0.7 * (x != 0),
                               rtol=1e-6, atol=0)


def _assert_column_sums(dev, rows, got, ref, dy, xhat):
    """dgamma, dbeta within the summation-order bound of the grid the
    kernel ran on; in bfloat16 plus one spacing of the plain value (each
    side rounds its own f32 sum once; at many rows a column can cancel to
    a value whose f32 order error exceeds its spacing)."""
    nblocks = ln.row_blocks(rows, ln.sm_count(dev))
    dy = dy.float()
    for g, r, terms in zip(got, ref, ((dy * xhat).abs().sum(0),
                                      dy.abs().sum(0))):
        tol = ln.column_sum_tol(terms, rows, nblocks)
        g, r = g.float(), r.float()
        if got[0].dtype == torch.bfloat16:
            tol = BF16_TOL[0] * r.abs() + 2 * tol
        assert ((g - r).abs() <= tol).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", [(1, 64), (5, 96), (13, 768),
                                    (1000, 768), (7, 1000), (3, 4096),
                                    (4100, 64)])
def test_layer_norm_bwd_kernel_vs_plain(dev, dtype, rows, c):
    if c % (16 // (torch.finfo(dtype).bits // 8)):
        pytest.skip("feature size not a whole number of 16-byte vectors")
    g = _gen(dev, rows + c)
    x = (torch.randn(rows, c, generator=g, device=dev) * 2 + 0.5).to(dtype)
    gamma = (1 + 0.3 * torch.randn(c, generator=g, device=dev)).to(dtype)
    beta = torch.zeros(c, device=dev).to(dtype)
    dy = torch.randn(rows, c, generator=g, device=dev).to(dtype)
    _, mean, rstd = ln.layer_norm_fwd(x, gamma, beta, impl="plain")
    dx, dg, db = ln.layer_norm_bwd(x, dy, mean, rstd, gamma, impl="kernel")
    rx, rg, rb = ln.layer_norm_bwd(x, dy, mean, rstd, gamma, impl="plain")
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dg.dtype == db.dtype == dtype
    if dtype == torch.bfloat16:
        for got, ref in ((dx, rx), (dg, rg), (db, rb)):
            _bf16_close(got, ref)
        return
    torch.testing.assert_close(dx, rx, rtol=0, atol=2e-5)
    xhat = (x - mean[:, None]) * rstd[:, None]
    _assert_column_sums(dev, rows, (dg, db), (rg, rb), dy, xhat)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", [(3, 64), (130, 768), (1000, 768)])
@pytest.mark.parametrize("p", [0.0, 0.1, 1.0])
def test_residual_dropout_ln_kernel_vs_plain(dev, dtype, rows, c, p):
    """p = 0 and 0.1 run the fused kernels; p = 1 runs the LayerNorm
    kernels on x, with dh = 0."""
    g = _gen(dev, rows * 7 + c)
    x = (torch.randn(rows, c, generator=g, device=dev) + 0.3).to(dtype)
    h = torch.randn(rows, c, generator=g, device=dev).to(dtype)
    gamma = (1 + 0.3 * torch.randn(c, generator=g, device=dev)).to(dtype)
    beta = (0.3 * torch.randn(c, generator=g, device=dev)).to(dtype)
    dy = torch.randn(rows, c, generator=g, device=dev).to(dtype)
    key = (77, 1 << 31)
    fb.launches = fb.bwd_launches = ln.launches = ln.bwd_launches = 0
    y, m, r = fb.residual_dropout_ln_fwd(x, h, gamma, beta, key, p,
                                         impl="kernel")
    yp, mp, rp = fb.residual_dropout_ln_fwd(x, h, gamma, beta, key, p,
                                            impl="plain")
    grads = fb.residual_dropout_ln_bwd(x, h, dy, mp, rp, gamma, key, p,
                                       impl="kernel")
    refs = fb.residual_dropout_ln_bwd(x, h, dy, mp, rp, gamma, key, p,
                                      impl="plain")
    torch.cuda.synchronize()
    counts = (fb.launches, fb.bwd_launches, ln.launches, ln.bwd_launches)
    assert counts == ((0, 0, 1, 2) if p == 1 else (1, 2, 0, 0))
    torch.testing.assert_close(m, mp, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(r, rp, rtol=2e-5, atol=2e-5)
    if dtype == torch.bfloat16:
        for got, ref in ((y, yp), *zip(grads, refs)):
            _bf16_close(got, ref)
        return
    torch.testing.assert_close(y, yp, rtol=0, atol=2e-5)
    for got, ref in zip(grads[:2], refs[:2]):       # dx, dh
        torch.testing.assert_close(got, ref, rtol=0, atol=2e-5)
    if p > 0:                                        # dh is 0 where dropped
        keep = (ph.keep_mask((rows, c), key, p, device=dev) if p < 1
                else torch.zeros(rows, c, dtype=torch.bool, device=dev))
        assert torch.equal(grads[1] == 0, ~keep | (refs[1] == 0))
    s = x.float() + fb._dropped(h, key, p)
    xhat = (s - mp[:, None]) * rp[:, None]
    _assert_column_sums(dev, rows, grads[2:], refs[2:], dy, xhat)


# NV, the 16-byte vectors a lane takes of a row: each count the row
# backward instantiates apart (C = NV * 32 * vector width)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv", [1, 3, 6, 8, 16])
@pytest.mark.parametrize("rows", [1, 7, 65536])
def test_row_bwd_kernel_vs_plain_at_each_vector_count(dev, dtype, nv, rows):
    """K4b and K3's backward with dropout against their plain versions,
    from one row to 65536 (many rows a warp on the card-sized grid); two
    calls give bitwise-equal outputs, dgamma and dbeta included."""
    c = nv * 32 * (16 // (torch.finfo(dtype).bits // 8))
    g = _gen(dev, rows * 3 + nv)
    x = (torch.randn(rows, c, generator=g, device=dev) * 2 + 0.5).to(dtype)
    h = torch.randn(rows, c, generator=g, device=dev).to(dtype)
    dy = torch.randn(rows, c, generator=g, device=dev).to(dtype)
    gamma = (1 + 0.3 * torch.randn(c, generator=g, device=dev)).to(dtype)
    beta = (0.3 * torch.randn(c, generator=g, device=dev)).to(dtype)
    key, p = (2718, 28182), 0.1
    _, m, r = ln.layer_norm_fwd(x, gamma, beta, impl="plain")
    _, m3, r3 = fb.residual_dropout_ln_fwd(x, h, gamma, beta, key, p,
                                           impl="plain")
    for run, args, s, mean, rstd in (
            (ln.layer_norm_bwd, (x, dy, m, r, gamma), x.float(), m, r),
            (fb.residual_dropout_ln_bwd, (x, h, dy, m3, r3, gamma, key, p),
             x.float() + fb._dropped(h, key, p), m3, r3)):
        got = run(*args, impl="kernel")
        again = run(*args, impl="kernel")
        ref = run(*args, impl="plain")
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert all(t.dtype == dtype for t in got)
        for gt, rf in zip(got[:-2], ref[:-2]):          # dx (and dh)
            if dtype == torch.bfloat16:
                _bf16_close(gt, rf)
            else:
                torch.testing.assert_close(gt, rf, rtol=0, atol=2e-5)
        _assert_column_sums(dev, rows, got[-2:], ref[-2:], dy,
                            (s - mean[:, None]) * rstd[:, None])
    # dh = dx * scale where kept, 0 where dropped (the kernel against
    # itself: at 65536 rows some plain dx cancel to exactly 0 where the
    # kernel's does not, and the other way round)
    keep = ph.keep_mask((rows, c), key, p, device=dev)
    assert torch.equal(got[1] != 0, keep & (got[0] != 0))


def test_residual_dropout_ln_mask_is_the_dropout_kernels(dev):
    """K3 and K5 draw the same mask for one key: the fused kernel agrees
    with the LayerNorm kernel over x + the dropout kernel's output."""
    x, h = torch.randn(2, 256, 768, device=dev).unbind(0)
    gamma, beta = torch.rand(768, device=dev), torch.rand(768, device=dev)
    key = (2024, 7)
    y = fb.residual_dropout_ln(x, h, gamma, beta, 0.1, key, impl="kernel")
    ref = ln.layer_norm(x + dp.dropout(h, key, 0.1, impl="kernel"), gamma,
                        beta, impl="kernel")
    torch.testing.assert_close(y, ref, rtol=0, atol=2e-5)


def _full_grid_rows(dev):
    """The most rows `ln.row_blocks` gives one warp each on this card:
    past them, its warps walk the rows."""
    return ln.ROW_WARPS * ln.ROW_BLOCKS_PER_SM * ln.sm_count(dev)


def _grid_rows(dev):
    """{regime of `ln.row_blocks`: row counts that take it} on this card:
    both ends of each."""
    full = _full_grid_rows(dev)
    return {"one row a warp": (1, full), "walk": (full + 1, 3 * full + 5)}


_ROW_LAYOUTS = [(torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("layout", _ROW_LAYOUTS,
                         ids=["f32", "bf16", "bf16-x-f32-gamma"])
@pytest.mark.parametrize("kind", ["one row a warp", "walk"])
def test_layer_norm_fwd_each_grid_vs_plain(dev, kind, layout):
    """K4 on each regime of its grid (`ln.row_blocks`: one row a warp,
    walking warps) against its plain version."""
    xdt, pdt = layout
    for rows in _grid_rows(dev)[kind]:
        g = _gen(dev, rows)
        x = (torch.randn(rows, 768, generator=g, device=dev) * 2
             + 0.5).to(xdt)
        gamma = (1 + 0.3 * torch.randn(768, generator=g, device=dev)).to(pdt)
        beta = (0.3 * torch.randn(768, generator=g, device=dev)).to(pdt)
        y, m, r = ln.layer_norm_fwd(x, gamma, beta, impl="kernel")
        yp, mp, rp = ln.layer_norm_fwd(x, gamma, beta, impl="plain")
        torch.cuda.synchronize()
        if xdt == torch.bfloat16:
            _bf16_close(y, yp)
        else:
            torch.testing.assert_close(y, yp, rtol=0, atol=2e-5)
        torch.testing.assert_close(m, mp, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(r, rp, rtol=2e-5, atol=2e-5)


def test_layer_norm_fwd_entry_rejects_a_grid_it_cannot_launch(dev):
    x = torch.randn(4, 768, device=dev)
    g, b = torch.ones(768, device=dev), torch.zeros(768, device=dev)
    y, st = torch.empty_like(x), torch.empty(2, 4, device=dev)
    lib = ln._lib()
    for blocks in (0, -1):
        err = lib.mx_layer_norm_fwd(
            0, 0, x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
            st.data_ptr(), st[1].data_ptr(), 4, 768, 1e-5, blocks,
            torch.cuda.current_stream().cuda_stream)
        assert err != 0


@pytest.mark.parametrize("layout", _ROW_LAYOUTS,
                         ids=["f32", "bf16", "bf16-x-f32-gamma"])
@pytest.mark.parametrize("c", [768, 64, 4096])
def test_layer_norm_fwd_rows_are_bit_for_bit_any_row_count(dev, layout, c):
    """A row's y, mean and rstd are the same bits in a call of 1 row, of
    the rows on each side of the count past which the grid's warps walk
    and of many rows a warp: the first n rows alone against the same rows
    of the whole call."""
    xdt, pdt = layout
    if c % (16 // (torch.finfo(xdt).bits // 8)):
        pytest.skip("feature size not a whole number of 16-byte vectors")
    full = _full_grid_rows(dev)
    big = 3 * full + 5
    g = _gen(dev, c)
    x = (torch.randn(big, c, generator=g, device=dev) * 2 + 0.5).to(xdt)
    gamma = (1 + 0.3 * torch.randn(c, generator=g, device=dev)).to(pdt)
    beta = (0.3 * torch.randn(c, generator=g, device=dev)).to(pdt)
    whole = ln.layer_norm_fwd(x, gamma, beta, impl="kernel")
    for n in (1, 7, full, full + 1, 2 * full + 3):
        part = ln.layer_norm_fwd(x[:n], gamma, beta, impl="kernel")
        assert all(torch.equal(a, b[:n]) for a, b in zip(part, whole)), n


@pytest.mark.parametrize("layout", [(torch.float32,) * 3,
                                    (torch.bfloat16,) * 3,
                                    (torch.float32, torch.bfloat16,
                                     torch.float32)],
                         ids=["f32", "bf16", "f32-x-bf16-h"])
@pytest.mark.parametrize("device_key", [False, True])
def test_residual_fwd_rows_bit_for_bit_and_masks_k5s(dev, layout,
                                                     device_key):
    """K3's forward at p = 0.1 on every grid: the first n rows alone
    equal the same rows of the whole call bit for bit (its Philox
    counters are flat element offsets). Its mask is K5's, bit for bit:
    at p = 0.5 (scale 2, exact in bf16) K3 equals K3 at p = 0 on the
    dropout kernel's output on h; and where x is f32 (the lane-to-column
    map of f32 rows), K3 at p = 0.1 equals K4 on x + the dropout kernel's
    output on h widened to f32."""
    xdt, hdt, pdt = layout
    full = _full_grid_rows(dev)
    big = 3 * full + 5
    g = _gen(dev, 3)
    x = (torch.randn(big, 768, generator=g, device=dev) + 0.3).to(xdt)
    h = torch.randn(big, 768, generator=g, device=dev).to(hdt)
    gamma = (1 + 0.3 * torch.randn(768, generator=g, device=dev)).to(pdt)
    beta = (0.3 * torch.randn(768, generator=g, device=dev)).to(pdt)
    key = (ph.DeviceKey(torch.tensor([99, 1 << 30], device=dev),
                        torch.tensor(4, device=dev), 2, {})
           if device_key else (31415, 92653))
    whole = fb.residual_dropout_ln_fwd(x, h, gamma, beta, key, 0.1,
                                       impl="kernel")
    for n in (1, 7, full, full + 1, 2 * full + 3):
        part = fb.residual_dropout_ln_fwd(x[:n], h[:n], gamma, beta, key,
                                          0.1, impl="kernel")
        assert all(torch.equal(a, b[:n]) for a, b in zip(part, whole)), n
    half = fb.residual_dropout_ln_fwd(x, h, gamma, beta, key, 0.5,
                                      impl="kernel")
    ref = fb.residual_dropout_ln_fwd(x, dp.dropout_fwd(h, key, 0.5,
                                                       impl="kernel"),
                                     gamma, beta, key, 0.0, impl="kernel")
    assert all(torch.equal(a, b) for a, b in zip(half, ref))
    if xdt == torch.float32:
        s = x + dp.dropout_fwd(h.float(), key, 0.1, impl="kernel")
        y, m, r = ln.layer_norm_fwd(s, gamma, beta, impl="kernel")
        assert torch.equal(whole[0], y)
        assert torch.equal(whole[1], m) and torch.equal(whole[2], r)


def test_row_fwd_graph_replay_equals_eager(dev):
    """K4 (each layout, each regime of its grid) and K3 captured in one
    CUDA graph: a replay writes the bits the same calls write eagerly."""
    ins = []
    for rows_list in _grid_rows(dev).values():
        for xdt, pdt in _ROW_LAYOUTS:
            rows = rows_list[-1]
            g = _gen(dev, rows)
            x = torch.randn(rows, 768, generator=g, device=dev).to(xdt)
            gamma = torch.rand(768, generator=g, device=dev).to(pdt)
            beta = torch.rand(768, generator=g, device=dev).to(pdt)
            ins.append((x, gamma, beta))
    h = torch.randn(9, 768, device=dev)

    def run():
        outs = [ln.layer_norm_fwd(*a, impl="kernel") for a in ins]
        x, gamma, beta = ins[0]
        outs.append(fb.residual_dropout_ln_fwd(x[:9], h, gamma, beta,
                                               (5, 6), 0.1, impl="kernel"))
        return outs

    eager = run()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for outs in captured:              # the replay must write them again
        for t in outs:
            t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for got, ref in zip(captured, eager):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


# (B, H, Tq, Tk, d, causal, lengths): ATTN_CASES above, run backward
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_bwd_kernel_vs_plain(dev, dtype, case):
    b, h, tq, tk, d, causal, lengths = case
    g = _gen(dev, tq * d + b + 1)
    q, k, v = (torch.randn(b, h, t, d, generator=g, device=dev).to(dtype)
               for t in (tq, tk, tk))
    do = torch.randn(b, h, tq, d, generator=g, device=dev).to(dtype)
    lens = None if lengths is None else torch.tensor(lengths, device=dev)
    o, lse = fa.flash_attention_with_lse(q, k, v, lengths=lens,
                                         causal=causal, impl="plain")
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, lengths=lens,
                                 causal=causal, impl="kernel")
    ref = fa.flash_attention_bwd(q, k, v, o, lse, do, lengths=lens,
                                 causal=causal, impl="plain")
    torch.cuda.synchronize()
    for gt, rf in zip(got, ref):
        assert gt.shape == rf.shape and gt.dtype == dtype
        assert bool(torch.isfinite(gt.float()).all())
        if dtype == torch.bfloat16:
            _attn_close(gt, rf, dtype)
        else:
            scale = max(1.0, rf.abs().max().item())
            torch.testing.assert_close(gt, rf, rtol=0, atol=1e-4 * scale)
    if lengths is not None:
        for i, n in enumerate(lengths):
            assert (got[0][i, :, n:] == 0).all()     # dead rows
            assert (got[1][i, :, n:] == 0).all()     # dead keys
            assert (got[2][i, :, n:] == 0).all()


def test_flash_attention_autograd_bthd_views(dev):
    """The main path's backward: q, k, v are views of one fused
    projection; the gradient reaches it through the kernels."""
    n, t, h, d = 3, 150, 4, 64
    qkv = torch.randn(n, t, 3, h, d, generator=_gen(dev, 4), device=dev)
    lens = torch.tensor([150, 77, 1], device=dev)
    grads = []
    for impl in ("kernel", "plain"):
        leaf = qkv.clone().requires_grad_()
        o = fa.flash_attention(*leaf.unbind(2), lengths=lens, layout="bthd",
                               impl=impl)
        o.backward(torch.ones_like(o))
        grads.append(leaf.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-4)


def test_new_npx_ops_launch_or_raise(dev):
    """npx.dropout and npx.residual_dropout_ln never compute a CUDA tensor
    with composed ops: they launch their kernel or raise."""
    x = torch.randn(4, 6, 64, device=dev)
    g, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    dp.launches = fb.launches = 0
    with pytest.raises(MXNetError):
        npx.dropout(x.half(), p=0.5, training=True)           # fp16
    with pytest.raises(MXNetError):
        npx.residual_dropout_ln(x[..., :62], x[..., :62], g[:62], b[:62],
                                p=0.1, training=True)        # C % 4 != 0
    with pytest.raises(MXNetError):
        npx.residual_dropout_ln(x, x[:2], g, b, p=0.1, training=True)
    with pytest.raises(MXNetError):
        npx.residual_dropout_ln(x, x, g, b, axis=1)
    with pytest.raises(MXNetError):
        npx.residual_dropout_ln(x.bfloat16(), x.bfloat16(), g, b)
    assert dp.launches == fb.launches == 0
    assert npx.dropout(x, p=0.5) is x                       # not training
    npx.dropout(x, p=0.5, training=True)
    npx.residual_dropout_ln(x, x, g, b, p=0.1)              # eval: p -> 0
    npx.residual_dropout_ln(x, x, g, b, p=0.1, training=True)
    assert dp.launches == 1 and fb.launches == 2


def test_tiny_bert_train_step_on_card_matches_cpu(dev):
    """A tiny BERT, dropout 0.1, one forward and backward on the card
    (kernels) and on the CPU (plain versions) from the same weights and
    keys: the same loss and gradients, and every kernel launched."""
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_small

    cpu = bert_small(vocab_size=97, max_length=32, dropout=0.1, device="cpu",
                     seed=1)
    card = bert_small(vocab_size=97, max_length=32, dropout=0.1, device=dev)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(2)
    tok = torch.randint(0, 97, (3, 32), generator=gen)
    lab = torch.randint(0, 97, (3, 32), generator=gen)
    vl = torch.tensor([32, 20, 7])
    ce = SoftmaxCrossEntropyLoss()
    losses = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        mxrandom.seed(5)
        for mod in (fa, ln, fb, dp):
            mod.launches = 0
            if hasattr(mod, "bwd_launches"):
                mod.bwd_launches = 0
        loss = ce(m(tok.to(d), valid_length=vl.to(d))[0], lab.to(d)).sum()
        loss.backward()
        losses.append(loss.item())
    # backward calls launch 3 (flash: delta, dq, dk/dv) and 2 (row kernel,
    # dgamma/dbeta reduction) kernels
    assert (fa.launches, fa.bwd_launches) == (2, 2 * 3)
    assert (ln.launches, ln.bwd_launches) == (2, 2 * ln.BWD_KERNELS)
    assert (fb.launches, fb.bwd_launches) == (4, 4 * ln.BWD_KERNELS)
    assert dp.launches == 2 * 5
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[0])
    for (name, pc), pg in zip(cpu.named_parameters(), card.parameters()):
        if pc.grad is None:
            assert pg.grad is None, name
            continue
        scale = max(1e-6, pc.grad.abs().max().item())
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, rtol=0,
                                   atol=1e-4 * scale, msg=name)


# -- AMP's layouts: K4/K4b with bf16 x and f32 gamma/beta, K3 with f32 x,
# bf16 h and f32 gamma/beta -------------------------------------------------

@pytest.mark.parametrize("rows,c", [(1, 64), (8, 768), (13, 768),
                                    (1000, 768), (8192, 768), (3, 4096)])
def test_amp_layer_norm_layout_kernel_vs_plain(dev, rows, c):
    """bf16 x, y, dy and dx, f32 gamma/beta and dgamma/dbeta: forward and
    backward against the plain versions, two backward calls bitwise
    equal, and the launches counted under the layout's name."""
    g = _gen(dev, rows * 5 + c)
    x = (torch.randn(rows, c, generator=g, device=dev) * 2 + 0.5).bfloat16()
    gamma = 1 + 0.3 * torch.randn(c, generator=g, device=dev)
    beta = 0.3 * torch.randn(c, generator=g, device=dev)
    dy = torch.randn(rows, c, generator=g, device=dev).bfloat16()
    ln.layout_launches.clear()
    ln.bwd_layout_launches.clear()
    y, m, r = ln.layer_norm_fwd(x, gamma, beta, impl="kernel")
    yp, mp, rp = ln.layer_norm_fwd(x, gamma, beta, impl="plain")
    got = ln.layer_norm_bwd(x, dy, mp, rp, gamma, impl="kernel")
    again = ln.layer_norm_bwd(x, dy, mp, rp, gamma, impl="kernel")
    ref = ln.layer_norm_bwd(x, dy, mp, rp, gamma, impl="plain")
    torch.cuda.synchronize()
    name = ln.layout_name(torch.bfloat16, torch.float32)
    assert dict(ln.layout_launches) == {name: 1}
    assert dict(ln.bwd_layout_launches) == {name: 2 * ln.BWD_KERNELS}
    assert y.dtype == got[0].dtype == torch.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    _bf16_close(y, yp)
    torch.testing.assert_close(m, mp, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(r, rp, rtol=2e-5, atol=2e-5)
    _bf16_close(got[0], ref[0])
    _assert_column_sums(dev, rows, got[1:], ref[1:], dy,
                        (x.float() - mp[:, None]) * rp[:, None])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("rows,c", [(3, 64), (130, 768), (1000, 768),
                                    (8192, 768)])
@pytest.mark.parametrize("p", [0.0, 0.1, 1.0])
def test_amp_residual_layout_kernel_vs_plain(dev, rows, c, p):
    """f32 x, y, dy and dx, bf16 h and dh, f32 gamma/beta and
    dgamma/dbeta: against the plain versions, and against the f32 kernels
    on h widened to f32, bit for bit (the same mask and sums; dh rounded
    to bf16 once); p = 1 runs the LayerNorm kernels on x."""
    g = _gen(dev, rows * 11 + c)
    x = torch.randn(rows, c, generator=g, device=dev) + 0.3
    h = torch.randn(rows, c, generator=g, device=dev).bfloat16()
    gamma = 1 + 0.3 * torch.randn(c, generator=g, device=dev)
    beta = 0.3 * torch.randn(c, generator=g, device=dev)
    dy = torch.randn(rows, c, generator=g, device=dev)
    key = (91, 1 << 30)
    fb.launches = fb.bwd_launches = ln.launches = ln.bwd_launches = 0
    fb.layout_launches.clear()
    y, m, r = fb.residual_dropout_ln_fwd(x, h, gamma, beta, key, p,
                                         impl="kernel")
    yp, mp, rp = fb.residual_dropout_ln_fwd(x, h, gamma, beta, key, p,
                                            impl="plain")
    grads = fb.residual_dropout_ln_bwd(x, h, dy, mp, rp, gamma, key, p,
                                       impl="kernel")
    refs = fb.residual_dropout_ln_bwd(x, h, dy, mp, rp, gamma, key, p,
                                      impl="plain")
    torch.cuda.synchronize()
    counts = (fb.launches, fb.bwd_launches, ln.launches, ln.bwd_launches)
    assert counts == ((0, 0, 1, 2) if p == 1 else (1, 2, 0, 0))
    if p < 1:
        assert dict(fb.layout_launches) == {
            ln.layout_name(torch.float32, torch.float32, torch.bfloat16): 1}
    assert y.dtype == grads[0].dtype == torch.float32
    assert grads[1].dtype == torch.bfloat16
    assert grads[2].dtype == grads[3].dtype == torch.float32
    torch.testing.assert_close(y, yp, rtol=0, atol=2e-5)
    torch.testing.assert_close(m, mp, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(r, rp, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(grads[0], refs[0], rtol=0, atol=2e-5)
    _bf16_close(grads[1], refs[1])
    s = x + fb._dropped(h, key, p)
    _assert_column_sums(dev, rows, grads[2:], refs[2:], dy,
                        (s - mp[:, None]) * rp[:, None])
    if 0 < p < 1:                                    # dh is 0 where dropped
        keep = ph.keep_mask((rows, c), key, p, device=dev)
        assert torch.equal(grads[1] == 0, ~keep | (refs[1] == 0))
    y32, m32, r32 = fb.residual_dropout_ln_fwd(x, h.float(), gamma, beta,
                                               key, p, impl="kernel")
    g32 = fb.residual_dropout_ln_bwd(x, h.float(), dy, mp, rp, gamma, key,
                                     p, impl="kernel")
    again = fb.residual_dropout_ln_bwd(x, h, dy, mp, rp, gamma, key, p,
                                       impl="kernel")
    torch.cuda.synchronize()
    assert torch.equal(y, y32) and torch.equal(m, m32) and torch.equal(r, r32)
    assert torch.equal(grads[0], g32[0])
    assert torch.equal(grads[1], g32[1].bfloat16())
    assert torch.equal(grads[2], g32[2]) and torch.equal(grads[3], g32[3])
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_amp_layouts_only_the_taken_mixes_launch(dev):
    """Mixes the kernels do not take raise on the card: nothing is cast
    to a layout they take."""
    x = torch.randn(4, 6, 64, device=dev)
    g32, b32 = torch.rand(64, device=dev), torch.rand(64, device=dev)
    g16, b16 = g32.bfloat16(), b32.bfloat16()
    ln.launches = fb.launches = 0
    for args in ((x.bfloat16(), x.bfloat16(), g32, b32),   # bf16 x and h
                 (x, x.bfloat16(), g16, b16),              # bf16 gamma
                 (x.bfloat16(), x, g32, b32),              # bf16 x, f32 h
                 (x, x.half(), g32, b32)):                 # float16 h
        with pytest.raises(MXNetError):
            npx.residual_dropout_ln(*args, p=0.1, training=True)
    with pytest.raises(MXNetError):
        npx.layer_norm(x, g16, b32)                       # gamma != beta
    assert ln.launches == fb.launches == 0
    y = npx.residual_dropout_ln(x, x.bfloat16(), g32, b32, p=0.1,
                                training=True)
    z = npx.layer_norm(x.bfloat16(), g32, b32)
    assert y.dtype == torch.float32 and z.dtype == torch.bfloat16
    assert ln.launches == fb.launches == 1


def test_tiny_bert_amp_step_on_card_matches_cpu(dev):
    """A tiny BERT under amp.init("bfloat16"), dropout 0.1, one forward
    and backward on the card (kernels) and on the CPU (plain versions)
    from the same weights and keys: the mixed layouts launch (each cell's
    two residual sites f32 x with bf16 h, the MLM LayerNorm bf16 x), and
    the loss and gradients agree at bf16's scale (cuBLAS and the CPU sum
    the bf16 products in other orders): loss within 2^-7, each gradient
    within 2^-4 of its norm."""
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_small

    cpu = bert_small(vocab_size=97, max_length=32, dropout=0.1, device="cpu",
                     seed=1)
    card = bert_small(vocab_size=97, max_length=32, dropout=0.1, device=dev)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(2)
    tok = torch.randint(0, 97, (3, 32), generator=gen)
    lab = torch.randint(0, 97, (3, 32), generator=gen)
    vl = torch.tensor([32, 20, 7])
    ce = SoftmaxCrossEntropyLoss()
    losses = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        mxrandom.seed(5)
        for mod in (ln, fb):
            mod.layout_launches.clear()
            mod.bwd_layout_launches.clear()
        amp.init("bfloat16")
        try:
            loss = ce(m(tok.to(d), valid_length=vl.to(d))[0],
                      lab.to(d)).sum()
            loss.backward()
        finally:
            amp.deinit()
        losses.append(loss.item())
    k3 = ln.layout_name(torch.float32, torch.float32, torch.bfloat16)
    k4 = ln.layout_name(torch.bfloat16, torch.float32)
    assert dict(fb.layout_launches) == {k3: 4}
    assert dict(fb.bwd_layout_launches) == {k3: 4 * ln.BWD_KERNELS}
    assert dict(ln.layout_launches) == {"f32": 1, k4: 1}
    assert dict(ln.bwd_layout_launches) == {"f32": ln.BWD_KERNELS,
                                            k4: ln.BWD_KERNELS}
    assert abs(losses[0] - losses[1]) <= 2.0 ** -7 * abs(losses[0])
    for (name, pc), pg in zip(cpu.named_parameters(), card.parameters()):
        if pc.grad is None:
            assert pg.grad is None, name
            continue
        assert pg.grad.dtype == torch.float32, name
        err = (pg.grad.cpu() - pc.grad).norm() / pc.grad.norm()
        assert err <= 2.0 ** -4, name


# -- K6: fused exact-erf GELU + dropout --------------------------------------

GD_F32_TOL = 2e-6


def _gd_close(got, ref):
    assert got.dtype == ref.dtype and bool(torch.isfinite(got.float()).all())
    if got.dtype == torch.bfloat16:
        _bf16_close(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=0, atol=GD_F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# numels below, at and past one block (4096 f32 / 8192 bf16 elements,
# 16 / 32 a thread), most of them no multiple of a thread's elements
@pytest.mark.parametrize("shape", [(1, 4), (7, 13), (1000, 771),
                                   (33, 3072), (5, 1000), (1001, 777)])
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
def test_gelu_dropout_kernel_vs_plain(dev, dtype, shape, p):
    """Forward and backward against the plain versions (the tail of a
    numel that is not a whole number of vectors included); the zeros are
    the dropout kernel's mask for the same key, bit for bit."""
    g = _gen(dev, shape[0] * 31 + shape[1])
    u = torch.randn(*shape, generator=g, device=dev).to(dtype)
    dy = torch.randn(*shape, generator=g, device=dev).to(dtype)
    key = (123456789, 987654321)
    fb.gd_launches = fb.gd_bwd_launches = dp.launches = 0
    y = fb.gelu_dropout_fwd(u, key, p, impl="kernel")
    du = fb.gelu_dropout_bwd(u, dy, key, p, impl="kernel")
    assert (fb.gd_launches, fb.gd_bwd_launches) == (1, 1)
    _gd_close(y, fb.gelu_dropout_fwd(u, key, p, impl="plain"))
    _gd_close(du, fb.gelu_dropout_bwd(u, dy, key, p, impl="plain"))
    if p > 0:
        k5 = dp.dropout_fwd(torch.ones_like(u), key, p, impl="kernel") != 0
        gelu = fb.gelu_dropout_fwd(u, key, 0.0, impl="kernel")
        assert torch.equal(y != 0, k5 & (gelu != 0))
        assert not bool((du[~k5] != 0).any())
    torch.cuda.synchronize()


def test_gelu_dropout_error_no_larger_than_erffs(dev):
    """K6's gelu and gelu' (its rational normal tail) are no further from
    float64 than the same formulas through erff and expf."""
    import chip_smoke

    for name, (k6, erff) in chip_smoke.gelu_errors(torch, dev,
                                                   2 ** 20 + 1).items():
        assert k6 <= erff, (name, k6, erff)


def test_gelu_dropout_equals_gelu_then_the_dropout_kernel(dev):
    """float32: K6 computes gelu as PyTorch's erf form does and multiplies
    by the same f32 scale under the same mask as K5."""
    u = torch.randn(257, 3072, generator=_gen(dev, 9), device=dev)
    key = (2024, 7)
    y = fb.gelu_dropout_fwd(u, key, 0.1, impl="kernel")
    ref = dp.dropout_fwd(torch.nn.functional.gelu(u, approximate="none"),
                         key, 0.1, impl="kernel")
    torch.testing.assert_close(y, ref, rtol=0, atol=GD_F32_TOL)


def test_gelu_dropout_misaligned_noncontiguous_and_trivial_p(dev):
    base = torch.randn(4 * 768 + 1, device=dev)
    u = base[1:].view(4, 768)                       # not 16-byte aligned
    dyt = torch.randn(768, 4, device=dev).t()       # transposed dy
    key = (3, 4)
    for p in (0.0, 0.2):
        _gd_close(fb.gelu_dropout_fwd(u, key, p),
                  fb.gelu_dropout_fwd(u, key, p, impl="plain"))
        _gd_close(fb.gelu_dropout_bwd(u, dyt, key, p),
                  fb.gelu_dropout_bwd(u, dyt, key, p, impl="plain"))
    ut = torch.randn(64, 96, device=dev).t()        # transposed u
    _gd_close(fb.gelu_dropout_fwd(ut, key, 0.2),
              fb.gelu_dropout_fwd(ut, key, 0.2, impl="plain"))
    fb.gd_launches = fb.gd_bwd_launches = 0
    assert (fb.gelu_dropout_fwd(u, key, 1.0) == 0).all()   # p = 1: zeros
    assert (fb.gelu_dropout_bwd(u, dyt, key, 1.0) == 0).all()
    assert (fb.gd_launches, fb.gd_bwd_launches) == (0, 0)
    with pytest.raises(MXNetError):
        fb.gelu_dropout_fwd(u.half(), key, 0.2)          # no fp16 kernel
    with pytest.raises(MXNetError):
        fb.gelu_dropout_bwd(u, dyt.bfloat16(), key, 0.2)  # dtypes differ
    assert (fb.gd_launches, fb.gd_bwd_launches) == (0, 0)


def test_gelu_dropout_backward_reuses_the_mask(dev):
    u = torch.randn(16, 64, device=dev, requires_grad=True)
    fb.gd_launches = fb.gd_bwd_launches = 0
    y = fb.gelu_dropout(u, (9, 9), 0.3)
    y.backward(torch.ones_like(y))
    assert (fb.gd_launches, fb.gd_bwd_launches) == (1, 1)
    keep = ph.keep_mask(u.shape, (9, 9), 0.3, device=dev)
    assert torch.equal(y != 0, keep)
    ref = fb.plain_gelu_dropout_bwd(u.detach(), torch.ones_like(u), (9, 9),
                                    0.3)
    torch.testing.assert_close(u.grad, ref, rtol=0, atol=GD_F32_TOL)
    assert torch.equal(u.grad != 0, keep)


def test_npx_gelu_dropout_launches_k6_not_k5(dev):
    """npx.gelu_dropout on a CUDA tensor: "auto" launches K6 both ways and
    never K5; "xla" is gelu then K5; out of training it is the exact
    gelu and launches nothing."""
    from incubator_mxnet_tpu_torch import random as mxrandom

    x = torch.randn(4, 6, 64, device=dev, requires_grad=True)
    fb.gd_launches = fb.gd_bwd_launches = dp.launches = 0
    mxrandom.seed(1)
    y = npx.gelu_dropout(x, p=0.1, training=True)
    y.sum().backward()
    assert (fb.gd_launches, fb.gd_bwd_launches, dp.launches) == (1, 1, 0)
    mxrandom.seed(1)
    xla = npx.gelu_dropout(x, p=0.1, training=True, impl="xla")
    assert dp.launches == 1 and fb.gd_launches == 1
    torch.testing.assert_close(xla, y, rtol=0, atol=GD_F32_TOL)
    ev = npx.gelu_dropout(x, p=0.1)
    torch.testing.assert_close(
        ev, torch.nn.functional.gelu(x, approximate="none"))
    assert (fb.gd_launches, dp.launches) == (1, 1)
    with pytest.raises(MXNetError):
        npx.gelu_dropout(x.half(), p=0.1, training=True)


# -- device keys (a step replayed as a CUDA graph) and DataParallel ----------

def _device_key(dev, t=3, site=2, base=(123456789, 987654321)):
    return ph.DeviceKey(torch.tensor(base, device=dev),
                        torch.tensor(t, device=dev), site, {})


def _host_words(key):
    return tuple(int(w) for w in ph.key_words(key))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 13), (1000, 768)])
def test_device_key_launches_equal_the_by_value_launches(dev, dtype, shape):
    """K5, K3 (forward and backward) and K6 (forward and backward) on a
    device key: the fold kernel's table words are the plain fold's, and
    every output is the by-value launch's for those words and the plain
    version's, bit for bit (K6 within its f32 tolerance of the plain
    version, as at a host key)."""
    g = _gen(dev, 7)
    key = _device_key(dev, site=70)  # in the second chunk of the table
    words = _host_words(key)
    fold_before = dp.fold_launches
    x = torch.randn(*shape, generator=g, device=dev).to(dtype)
    got = dp.dropout_fwd(x, key, 0.1)
    assert dp.fold_launches == fold_before + 1
    table = key.tables[70 // dp.KEY_CHUNK][70 % dp.KEY_CHUNK]
    assert tuple(int(w) & 0xFFFFFFFF for w in table.tolist()) == words
    assert torch.equal(got, dp.dropout_fwd(x, words, 0.1))
    assert torch.equal(got, dp.dropout_fwd(x, key, 0.1, impl="plain"))
    if shape[1] % 8 == 0:
        h = torch.randn(*shape, generator=g, device=dev).to(dtype)
        dy = torch.randn(*shape, generator=g, device=dev).to(dtype)
        gamma = torch.ones(shape[1], device=dev, dtype=dtype)
        beta = torch.zeros(shape[1], device=dev, dtype=dtype)
        fwd = fb.residual_dropout_ln_fwd(x, h, gamma, beta, key, 0.1)
        ref = fb.residual_dropout_ln_fwd(x, h, gamma, beta, words, 0.1)
        assert all(torch.equal(a, b) for a, b in zip(fwd, ref))
        _, mean, rstd = fwd
        bwd = fb.residual_dropout_ln_bwd(x, h, dy, mean, rstd, gamma, key,
                                         0.1)
        ref = fb.residual_dropout_ln_bwd(x, h, dy, mean, rstd, gamma, words,
                                         0.1)
        assert all(torch.equal(a, b) for a, b in zip(bwd, ref))
    gd = fb.gelu_dropout_fwd(x, key, 0.1)
    assert torch.equal(gd, fb.gelu_dropout_fwd(x, words, 0.1))
    assert torch.equal(gd != 0, got != 0)
    gdb = fb.gelu_dropout_bwd(x, x, key, 0.1)
    assert torch.equal(gdb, fb.gelu_dropout_bwd(x, x, words, 0.1))
    assert dp.fold_launches == fold_before + 1  # the chunk is filled once


def test_device_key_reads_t_when_the_kernel_runs(dev):
    """A graph captured with a device key drops other elements when t
    changes before a replay, and those of the by-value launch for the new
    words."""
    x = torch.randn(64, 256, device=dev)
    t = torch.tensor(5, device=dev)
    base = torch.tensor([11, 22], device=dev)
    dp.dropout_fwd(x, ph.DeviceKey(base, t, 0, {}), 0.5)  # warm-up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = dp.dropout_fwd(x, ph.DeviceKey(base, t, 0, {}), 0.5)
    masks = []
    for step in (5, 6):
        t.fill_(step)
        graph.replay()
        words = _host_words(ph.DeviceKey(base, t, 0, {}))
        assert torch.equal(y, dp.dropout_fwd(x, words, 0.5))
        masks.append(y != 0)
    assert not torch.equal(*masks)


@pytest.mark.parametrize("amp_on", [False, True])
def test_data_parallel_captures_once_and_replays_its_step_fn(dev, amp_on):
    """DataParallel(bert_small) on the card: one eager warm-up step, then
    one capture; later steps replay it. The losses and parameters of the
    replays equal those of `_step_fn` run eagerly from the same state,
    the Python launch counters do not move on a replay, and successive
    replays draw other masks (the losses differ on the same batch)."""
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch import random as mxrandom
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import bert_small
    from incubator_mxnet_tpu_torch.optimizer import Adam
    from incubator_mxnet_tpu_torch.parallel import DataParallel

    ce = SoftmaxCrossEntropyLoss()
    gen = torch.Generator().manual_seed(2)
    tok = torch.randint(0, 97, (4, 32), generator=gen).to(dev)
    lab = torch.randint(0, 97, (4, 32), generator=gen).to(dev)
    nets = [bert_small(vocab_size=97, max_length=32, dropout=0.1,
                       device=dev, seed=1) for _ in range(2)]
    dps = [DataParallel(n, lambda out, y: ce(out[0], y),
                        Adam(learning_rate=1e-3)) for n in nets]
    if amp_on:
        amp.init("bfloat16")
    try:
        mxrandom.seed(9)
        replayed = [dps[0].step(tok, lab) for _ in range(2)]
        counts = (dp.launches, fb.launches, fb.bwd_launches)
        replayed += [dps[0].step(tok, lab) for _ in range(3)]
        assert (dp.launches, fb.launches, fb.bwd_launches) == counts
        assert dps[0].captures == 1
        mxrandom.seed(9)
        eager = []
        for _ in range(5):
            eager.append(dps[1]._step_fn(*dps[1]._prepare(), tok, lab))
    finally:
        amp.deinit()
    assert dps[1].captures == 0
    assert len({float(v) for v in replayed}) == 5
    for a, b in zip(replayed, eager):
        assert torch.equal(a, b)
    for pa, pb in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(pa, pb)


def test_data_parallel_capture_failure_raises_without_fallback(dev):
    """A step that synchronises with the host (here `.item()` in the
    loss) runs eagerly as its warm-up, then fails to capture: the step
    raises `MXNetError`, nothing of it ran, and the next call tries the
    capture again rather than running eagerly."""
    from incubator_mxnet_tpu_torch.models.bert import bert_small
    from incubator_mxnet_tpu_torch.optimizer import Adam
    from incubator_mxnet_tpu_torch.parallel import DataParallel

    net = bert_small(vocab_size=97, max_length=32, dropout=0.1, device=dev,
                     seed=3)

    def syncing_loss(out, y):
        scores = out[0]
        return (scores.float().logsumexp(-1).mean(-1)
                * (1.0 + 0.0 * scores.sum().item()))

    dp_ = DataParallel(net, syncing_loss, Adam(learning_rate=1e-3))
    tok = torch.randint(0, 97, (2, 16), device=dev)
    dp_.step(tok, tok)  # the eager warm-up step
    before = [p.detach().clone() for p in net.parameters()]
    for _ in range(2):
        with pytest.raises(MXNetError, match="capturing"):
            dp_.step(tok, tok)
    torch.cuda.synchronize()
    assert dp_.captures == 0 and dp_.optimizer.num_update == 1
    assert all(torch.equal(a, p) for a, p in zip(before, net.parameters()))
    assert torch.ones(4, device=dev).sum().item() == 4.0


# -- serve.ServeEngine: the decode step as one CUDA graph -------------------

def _serve_model(dev, seed=3):
    """A tiny GPT on the card with scaled random weights (greedy decode
    then depends on the tokens), and the same weights on the CPU. Built
    on the CPU and moved: the card's default generator is not used."""
    import copy

    cpu = gpt_tiny(vocab_size=97, max_length=64, dropout=0.0, device="cpu",
                   seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in cpu.parameters():
            if p.dim() >= 2:
                p.normal_(0, 0.35, generator=g)
    return copy.deepcopy(cpu).to(dev), cpu


def _serve_prompts(n, seed=0):
    import numpy as onp

    r = onp.random.RandomState(seed)
    return [r.randint(0, 97, (int(r.randint(3, 20)),)).astype(onp.int32)
            for _ in range(n)]


def _one_at_a_time(model, prompt, budget):
    out = GPTDecoder(model).generate(
        torch.from_numpy(prompt[None, :]).to(model.device), budget)
    return out[0].cpu().numpy()


def test_serve_engine_captures_once_over_20_steps(dev):
    """One request of 22 tokens (21 decode steps) and then four more: one
    capture, the program count flat after it, the Python K4 counter still
    on replays, and every token the one-at-a-time decoder's."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve

    model, _ = _serve_model(dev)
    e = serve.ServeEngine(model, max_slots=3, max_len=64)
    s = e._sched.slots
    p = _serve_prompts(1, seed=1)[0]
    got = e.generate(p, 22)
    onp.testing.assert_array_equal(got, _one_at_a_time(model, p, 22))
    assert s.captures == 1
    prompts = _serve_prompts(4, seed=2)
    k4 = ln.launches
    outs = e.generate_many(prompts, 12)
    # the replays launched no K4 through the wrapper; the prefills did
    assert ln.launches - k4 == 4 * (2 * len(model.blocks) + 1)
    for q, out in zip(prompts, outs):
        onp.testing.assert_array_equal(out, _one_at_a_time(model, q, 12))
    count = e.xla_program_count()              # every bucket seen
    again = e.generate_many(prompts, 12)
    assert all(onp.array_equal(a, b) for a, b in zip(again, outs))
    assert s.captures == 1 and e.xla_program_count() == count
    e.shutdown()
    assert s.allocator.used_pages == 0


def test_serve_replay_equals_the_captured_function_run_eagerly(dev):
    """A replay and `_decode_fn` run eagerly from cloned pools on the same
    static inputs: the same tokens and every pool leaf bit for bit."""
    from incubator_mxnet_tpu_torch import serve

    model, _ = _serve_model(dev)
    e = serve.ServeEngine(model, max_slots=3, max_len=64)
    s = e._sched.slots
    hs = [e.submit(p, 16) for p in _serve_prompts(3, seed=4)]
    while "decode" not in s._graphs:
        e.step()
    e.step()
    # the next step's inputs (the last step's would rewrite what it wrote)
    sched = e._sched
    args = s._load_step(sched._last, sched._pos, sched._active,
                        sched._next_key(), sched._temps)
    same_out, same_pools, written = _replay_vs_eager(s, "decode", args)
    assert same_out and same_pools and written > 0
    e._drive_until(hs)


def _replay_vs_eager(s, name, args, trash=True, read=None):
    """Step ``name``'s graph replayed, and its function run eagerly on the
    same static inputs from cloned pools: (outputs equal, every pool leaf
    equal, leaves the step wrote). With ``trash=False`` the trash page is
    left out: rows of inactive slots and rows past ``limit`` write it
    with duplicate indices, in no set order on the card. ``read`` keeps
    the outputs the scheduler reads: a row past its slot's limit attends
    to the trash page, so its token is not the same run to run."""
    graph, out = s._graphs[name]
    pools = s._pool_leaves()
    before = [t.clone() for t in pools]
    graph.replay()
    replayed = out.clone()
    after = [t.clone() for t in pools]
    for t, b in zip(pools, before):
        t.copy_(b)
    eager = getattr(s, f"_{name}_fn")(*args)
    torch.cuda.synchronize()
    lo = 0 if trash else 1
    same = all(torch.equal(a[lo:], t[lo:]) for a, t in zip(after, pools))
    written = sum(not torch.equal(a[lo:], b[lo:])
                  for a, b in zip(after, before))
    if read is not None:
        replayed, eager = replayed[read], eager[read]
    return torch.equal(replayed, eager), same, written


def _next_spec_inputs(e):
    """A speculative round's inputs at the scheduler's state, without its
    page extension: limit at each slot's last mapped position."""
    import numpy as onp

    sched, s = e._sched, e._sched.slots
    limit = onp.array([len(r.pages) * s.page_tokens - 1 if r is not None
                       and a else 0 for r, a in zip(sched._in_slot,
                                                    sched._active)])
    drafts = onp.repeat(sched._last[:, None], s.spec_k, axis=1)
    return sched._last, drafts, sched._pos, sched._active, limit


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_serve_spec_graphs_replay_their_functions(dev, kv_dtype):
    """Speculative decoding with a model draft (the target itself) on the
    card: one capture each of the verify and the draft graph and none of
    decode, a flat program count, the fp tokens the one-at-a-time
    decoder's, the accept rate above 0.9, and a verify and a draft replay
    bit for bit their functions run eagerly from the same pools (the trash
    page left out)."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve

    model, _ = _serve_model(dev)
    e = serve.ServeEngine(model, max_slots=3, max_len=64, spec_k=3,
                          draft=GPTDecoder(model), kv_dtype=kv_dtype)
    s = e._sched.slots
    prompts = _serve_prompts(3, seed=9)
    hs = [e.submit(p, 24) for p in prompts]
    while "verify" not in s._graphs or "draft" not in s._graphs:
        e.step()
    e.step()
    count = e.xla_program_count()
    last, drafts, pos, active, limit = _next_spec_inputs(e)
    for name, args, n in (
            ("verify", s._load_spec(last, drafts, pos, active, limit), 4),
            ("draft", s._load_spec(last, None, pos, active, limit), 3)):
        # the rows the scheduler reads: an inactive slot's, and an active
        # slot's up to its limit
        rows = pos[:, None] + onp.arange(n)
        read = torch.from_numpy(~active[:, None] | (rows <= limit[:, None]))
        same_out, same_pools, written = _replay_vs_eager(
            s, name, args, trash=False, read=read.to(dev))
        assert same_out and same_pools and written > 0, name
    e._drive_until(hs)
    assert s.captures_by_step == {"decode": 0, "verify": 1, "draft": 1}
    assert e.xla_program_count() == count
    assert e.spec_stats()["accept_rate"] > 0.9
    if kv_dtype == "fp":
        for p, h in zip(prompts, hs):
            onp.testing.assert_array_equal(onp.concatenate([p, h.result()]),
                                           _one_at_a_time(model, p, 24))
    e.shutdown()
    assert s.allocator.used_pages == 0


def test_serve_spec_ngram_on_the_card(dev):
    """The n-gram draft: one verify capture, no draft graph, the tokens
    the one-at-a-time decoder's, every page back after shutdown."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve

    model, _ = _serve_model(dev)
    e = serve.ServeEngine(model, max_slots=3, max_len=64, spec_k=4,
                          draft="ngram")
    s = e._sched.slots
    prompts = _serve_prompts(5, seed=10)
    outs = e.generate_many(prompts, 20)
    for p, out in zip(prompts, outs):
        onp.testing.assert_array_equal(out, _one_at_a_time(model, p, 20))
    assert s.captures_by_step == {"decode": 0, "verify": 1, "draft": 0}
    assert e.spec_stats()["drafted"] > 0
    e.shutdown()
    assert s.allocator.used_pages == 0


def test_serve_int8_decode_replay_equals_its_function(dev):
    """The int8 pool's decode graph (grow-only page scales rewritten in
    the replay) against its function run eagerly from cloned pools and
    scale planes, the trash page left out; one capture; finite tokens."""
    from incubator_mxnet_tpu_torch import serve

    model, _ = _serve_model(dev)
    e = serve.ServeEngine(model, max_slots=3, max_len=64, kv_dtype="int8")
    s = e._sched.slots
    hs = [e.submit(p, 16) for p in _serve_prompts(3, seed=11)]
    while "decode" not in s._graphs:
        e.step()
    e.step()
    sched = e._sched
    args = s._load_step(sched._last, sched._pos, sched._active,
                        sched._next_key(), sched._temps)
    same_out, same_pools, written = _replay_vs_eager(s, "decode", args,
                                                     trash=False)
    assert same_out and same_pools and written > 0
    e._drive_until(hs)
    assert s.captures == 1 and all(0 <= t < 97 for h in hs
                                   for t in h.result())


def test_serve_failed_capture_raises_without_an_eager_step(dev):
    """A decode function that syncs with the host runs as the eager first
    step, then fails to capture: the step raises MXNetError, nothing of it
    ran (pools and tokens unchanged), the next step tries the capture
    again rather than running eagerly, and with the sync gone the engine
    captures and finishes with the right tokens."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve

    model, _ = _serve_model(dev)
    e = serve.ServeEngine(model, max_slots=2, max_len=64)
    s = e._sched.slots
    decode_fn = s._decode_fn

    def syncing(*args):
        out = decode_fn(*args)
        return out + 0 * int(out.sum().item())

    s._decode_fn = syncing
    p = _serve_prompts(1, seed=5)[0]
    h = e.submit(p, 8)
    e.step()                                  # prefill + eager first step
    assert len(h.tokens) == 2 and s.captures == 0
    pools = [t.clone() for t in s._pk + s._pv]
    for _ in range(2):
        with pytest.raises(MXNetError, match="capturing"):
            e.step()
        torch.cuda.synchronize()
        assert len(h.tokens) == 2 and s.captures == 0
        assert all(torch.equal(a, t) for a, t in zip(pools, s._pk + s._pv))
    s._decode_fn = decode_fn
    e._drive_until([h])
    assert s.captures == 1
    onp.testing.assert_array_equal(
        onp.concatenate([p, h.result()]), _one_at_a_time(model, p, 8))


def test_serve_replays_from_the_driver_thread(dev):
    """The driver thread captures (thread-local capture mode) and replays
    while this thread only submits and waits."""
    import threading

    import numpy as onp

    from incubator_mxnet_tpu_torch import serve

    model, _ = _serve_model(dev)
    e = serve.ServeEngine(model, max_slots=3, max_len=64)
    s = e._sched.slots
    capture = s._capture
    threads = []

    def recording(*args):
        threads.append(threading.current_thread().name)
        capture(*args)

    s._capture = recording
    e.start()
    try:
        prompts = _serve_prompts(6, seed=6)
        hs = [e.submit(p, 10) for p in prompts]
        assert all(h.wait(timeout=120.0) for h in hs)
    finally:
        e.stop()
    assert threads == ["mx-serve-driver"] and s.captures == 1
    for p, h in zip(prompts, hs):
        onp.testing.assert_array_equal(onp.concatenate([p, h.result()]),
                                       _one_at_a_time(model, p, 10))


def test_serve_recaptures_after_a_weight_is_replaced(dev):
    """A weight replaced by a new tensor changes the fingerprint: the next
    step runs eagerly, the one after captures again (the program count
    rises by one), and the tokens follow the new weight; an in-place
    update is seen by the same graph. (Without prefix reuse: the prefix
    cache keeps pages prefilled under the old weights, as the
    reference's does.)"""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve

    model, _ = _serve_model(dev)
    e = serve.ServeEngine(model, max_slots=2, max_len=64,
                          prefix_reuse=False)
    s = e._sched.slots
    p = _serve_prompts(1, seed=7)[0]
    e.generate(p, 6)
    count = e.xla_program_count()
    assert s.captures == 1
    blk = model.blocks[0]
    blk.ffn.ffn1.weight = torch.nn.Parameter(blk.ffn.ffn1.weight.detach()
                                             * 1.5)
    got = e.generate(p, 6)
    onp.testing.assert_array_equal(got, _one_at_a_time(model, p, 6))
    assert s.captures == 2 and e.xla_program_count() == count + 1
    with torch.no_grad():
        blk.ffn.ffn1.weight.mul_(-1.0)
    got = e.generate(p, 6)
    onp.testing.assert_array_equal(got, _one_at_a_time(model, p, 6))
    assert s.captures == 2


def test_serve_sampling_on_the_card(dev):
    """Sampled decoding inside the graph: each replay reads its step key
    from the key buffer, so the same seed gives the same tokens and
    another seed others; top-k = 1 is greedy; a top-k = 3 draw stays in
    the 3 largest teacher-forced logits."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve

    model, _ = _serve_model(dev)
    prompts = _serve_prompts(4, seed=8)

    def draw(seed, top_k):
        e = serve.ServeEngine(model, max_slots=2, max_len=64,
                              do_sample=True, top_k=top_k, temperature=1.5,
                              seed=seed)
        try:
            return e.generate_many(prompts, 12)
        finally:
            e.shutdown(drain=False)

    a = draw(5, 3)
    assert all(onp.array_equal(x, y) for x, y in zip(a, draw(5, 3)))
    assert not all(onp.array_equal(x, y) for x, y in zip(a, draw(6, 3)))
    for p, out in zip(prompts, a):
        logits = GPTDecoder(model).score(
            torch.from_numpy(p[None, :]).to(dev),
            torch.from_numpy(out[None, p.size:].astype(onp.int64)).to(dev))
        top3 = torch.topk(logits[0], 3, dim=-1).indices.cpu()
        assert all(int(t) in top3[i].tolist()
                   for i, t in enumerate(out[p.size:]))
    for p, out in zip(prompts, draw(5, 1)):
        onp.testing.assert_array_equal(out, _one_at_a_time(model, p, 12))


# -- serve.disagg: pages migrated into captured pools ------------------------

def test_migrated_pages_land_in_the_captured_pools_in_place(dev):
    """A disaggregated pod on the card: the decode replica captures its
    decode graph on the first requests, then a later request's pages are
    copied into its pools (`copy_pages_in`, ``index_copy_``). The next
    replays read them: the tokens are the one-at-a-time decoder's; no new
    capture, the program count unchanged, the pools the same tensors."""
    import numpy as onp

    from incubator_mxnet_tpu_torch import serve

    model, _ = _serve_model(dev)
    reg = serve.ModelRegistry(total_pages=40)
    reg.add("g", model, prefill_replicas=1, decode_replicas=1, max_slots=2,
            max_len=64)
    gw = serve.Gateway(reg)
    try:
        dec = gw._models["g"].replicas[1].slots
        for p in _serve_prompts(2, seed=11):
            got = gw.generate("g", p, 8)
            onp.testing.assert_array_equal(got, _one_at_a_time(model, p, 8))
        assert dec.captures == 1
        count = gw.xla_program_counts(per_replica=True)
        ptrs = [t.data_ptr() for t in dec._pool_leaves()]
        for p in _serve_prompts(3, seed=12):
            h = gw.submit("g", p, 10)
            gw._drive_until([h], timeout=120.0)
            assert h.replica == "g#1"
            onp.testing.assert_array_equal(
                onp.concatenate([p, h.tokens]),
                _one_at_a_time(model, p, 10))
        assert dec.captures == 1
        assert gw.xla_program_counts(per_replica=True) == count
        assert [t.data_ptr() for t in dec._pool_leaves()] == ptrs
        assert not dec._buckets_seen
    finally:
        gw.shutdown(drain=False)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_copy_pages_on_the_card_bit_for_bit(dev, kv_dtype):
    """`copy_pages_out` / `copy_pages_in` between two engines on the card:
    the destination pages equal the source's bit for bit in every plane;
    the payload stays on the card."""
    from incubator_mxnet_tpu_torch import serve

    model, _ = _serve_model(dev)
    src = serve.SlotDecoder(model, max_slots=2, max_len=64,
                            kv_dtype=kv_dtype)
    dst = serve.SlotDecoder(model, max_slots=2, max_len=64,
                            kv_dtype=kv_dtype)
    src.set_slot_pages(0, [3, 5])
    src.prefill_chunk_step(0, _serve_prompts(1, seed=13)[0], 0, (0, 0))
    payload = src.copy_pages_out([3, 5])
    assert all(t.is_cuda for planes in payload.values() for t in planes)
    dst.copy_pages_in([6, 1], payload)
    for name in ("_pk", "_pv", "_sk", "_sv"):
        s_l, d_l = getattr(src, name), getattr(dst, name)
        if s_l is None:
            continue
        for s, d in zip(s_l, d_l):
            assert torch.equal(d[[6, 1]], s[[3, 5]])


def test_oom_postmortem_on_a_real_out_of_memory(dev, tmp_path, monkeypatch):
    """A faulted engine step asks the caching allocator for more than the
    card holds: the real ``torch.cuda.OutOfMemoryError`` propagates, and
    `telemetry.hbm.maybe_oom_postmortem` writes one flight dump carrying
    the census (the engine's owners, the card's top blocks) and the
    program ledger, and the generic dump is skipped."""
    import glob
    import json

    import numpy as onp

    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.telemetry import compiles, hbm, tracing

    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(tmp_path))
    compiles.reset()
    hbm.reset()
    compiles.enable()
    hbm.enable()
    tracing.enable()
    model, _ = _serve_model(dev)
    e = serve.ServeEngine(model, max_slots=2, max_len=64)
    try:
        e.generate(_serve_prompts(1, seed=4)[0], 4)   # a capture, a bucket
        slots = e._sched.slots

        def faulted(*a, **k):
            return torch.empty(1 << 50, dtype=torch.uint8, device=dev)

        slots.decode_step = faulted
        e.submit(_serve_prompts(1, seed=5)[0], 3)
        with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
            for _ in range(4):
                e.step()
        assert hbm.is_resource_exhausted(ei.value)
        dumps = glob.glob(str(tmp_path / "flightrec_*.json"))
        assert [p.split("/")[-1].startswith("flightrec_oom_serve_step_")
                for p in dumps] == [True]
        payload = json.loads(open(dumps[0]).read())
        assert payload["error"]["type"] == "OutOfMemoryError"
        census = payload["context"]["hbm_census"]
        assert census["owners"]["serve.kv_pool"] == slots.cache_bytes
        assert census["total"] >= census["owners"]["serve.kv_pool"]
        assert census["top"] and census["top"][0]["bytes"] > 0
        led = payload["context"]["compile_ledger"]
        assert led["report"]["serve.decode"]["compiles"] == 1
        assert "serve.prefill" in led["report"]
        assert onp.isfinite(census["unattributed"])
    finally:
        compiles.disable()
        compiles.reset()
        hbm.disable()
        hbm.reset()
        tracing.disable()
        tracing.reset()


def test_sampler_during_captured_replays_touches_no_device_state(dev):
    """The timeseries sampler at 0.01 s, with the census armed, while an
    engine captures its decode graph and replays it: the tokens are those
    of a run with the sampler off, one capture, and the sampler took its
    samples (every probe reads host state: no sync, no capture broken)."""
    import time

    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.telemetry import hbm, timeseries

    model, _ = _serve_model(dev)
    prompts = _serve_prompts(6, seed=8)

    def run():
        e = serve.ServeEngine(model, max_slots=3, max_len=64)
        outs = e.generate_many(prompts, 20)
        caps = e._sched.slots.captures
        e.shutdown()
        return outs, caps

    want, _ = run()
    timeseries.reset()
    hbm.enable()
    timeseries.enable(interval_s=0.01, samples=4096)
    try:
        got, caps = run()
        deadline = time.monotonic() + 5.0
        while timeseries.sample_count() < 5:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert timeseries.history("mx_hbm_live_bytes_total")
    finally:
        hbm.disable()
        timeseries.disable()
        timeseries.reset()
    assert caps == 1
    assert all((a == b).all() for a, b in zip(got, want))


def test_release_returns_the_pools_and_the_graphs_memory(dev):
    """`SlotDecoder.release` after prefills and a captured decode graph:
    the card's allocated bytes come back to their level before the
    engine's first use (the pools and the graph's private pool freed)."""
    from incubator_mxnet_tpu_torch import serve

    model, _ = _serve_model(dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    e = serve.ServeEngine(model, max_slots=2, max_len=64)
    e.generate_many(_serve_prompts(3, seed=9), 10)
    slots = e._sched.slots
    assert slots.captures == 1
    held = torch.cuda.memory_allocated(dev) - before
    assert held >= slots.cache_bytes > 0
    e.shutdown()
    slots.release()
    torch.cuda.synchronize()
    assert abs(torch.cuda.memory_allocated(dev) - before) <= 1 << 20


# ---------------------------------------------------------------------------
# NDArrays on the card: each kernel-bearing npx op through the funnel, the
# encoder layer's double backward, the autograd semantics
# ---------------------------------------------------------------------------

def _nd_chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nd_counts():
    return {"K1": fa.launches, "K2": fa.bwd_launches, "K3f": fb.launches,
            "K3b": fb.bwd_launches, "K4": ln.launches,
            "K4b": ln.bwd_launches, "K5": dp.launches,
            "K6f": fb.gd_launches, "K6b": fb.gd_bwd_launches}


def _nd_case(mx, op, device):
    """(output, gradients) of ``op`` on NDArrays made on ``device`` under
    record(); the same seeded inputs and key on every device."""
    g = torch.Generator().manual_seed(7)
    if op == "flash_attention":
        shapes = [(2, 64, 2, 32)] * 3
    elif op in ("layer_norm", "dropout", "residual_dropout_ln"):
        shapes = [(40, 768)] * (2 if op == "residual_dropout_ln" else 1)
    else:
        shapes = [(40, 3072)]
    xs = [mx.nd.array(torch.randn(s, generator=g), device=device)
          for s in shapes]
    params = []
    if op in ("layer_norm", "residual_dropout_ln"):
        params = [mx.nd.array(1 + 0.2 * torch.randn(768, generator=g),
                              device=device),
                  mx.nd.array(0.2 * torch.randn(768, generator=g),
                              device=device)]
    for a in xs + params:
        a.attach_grad()
    probe = None
    mx.random.seed(5)
    with mx.autograd.record():
        if op == "flash_attention":
            vl = mx.nd.array(torch.tensor([40, 64]), device=device)
            out = mx.npx.flash_attention(*xs, valid_length=vl,
                                         layout="bthd")
        elif op == "layer_norm":
            out = mx.npx.layer_norm(xs[0], *params)
        elif op == "dropout":
            out = mx.npx.dropout(xs[0], p=0.1)
        elif op == "residual_dropout_ln":
            out = mx.npx.residual_dropout_ln(xs[0], xs[1], *params, p=0.1)
        else:
            out = mx.npx.gelu_dropout(xs[0], p=0.1)
        probe = mx.nd.array(torch.randn(out.shape, generator=g),
                            device=device)
        loss = (out * probe).sum()
    loss.backward()
    return out.asnumpy(), [a.grad.asnumpy() for a in xs + params]


ND_KERNELS = {"flash_attention": ("K1", "K2"), "layer_norm": ("K4", "K4b"),
              "dropout": ("K5",), "residual_dropout_ln": ("K3f", "K3b"),
              "gelu_dropout": ("K6f", "K6b")}


@pytest.mark.parametrize("op", sorted(ND_KERNELS))
def test_nd_op_launches_its_kernel_and_matches_the_cpu(dev, op):
    """An npx op on NDArrays on the card launches its kernels, forward and
    backward, and agrees with the same NDArray code on the CPU (the plain
    versions; dropout masks bit for bit, the rest within 1e-4 of the
    largest magnitude)."""
    import numpy as onp

    import incubator_mxnet_tpu_torch as mx

    before = _nd_counts()
    got = _nd_case(mx, op, mx.gpu(0))
    after = _nd_counts()
    for k in ND_KERNELS[op]:
        assert after[k] > before[k], (op, k, before, after)
    want = _nd_case(mx, op, mx.cpu())
    if op in ("dropout", "gelu_dropout"):
        assert onp.array_equal(got[0] == 0, want[0] == 0), op   # one mask
    for g, w in zip([got[0]] + got[1], [want[0]] + want[1]):
        assert g.shape == w.shape and onp.isfinite(g).all()
        scale = max(float(onp.abs(w).max()), 1e-30)
        assert float(onp.abs(g - w).max()) <= 1e-4 * scale, op


def test_nd_creation_targets_the_card(dev):
    import incubator_mxnet_tpu_torch as mx

    assert mx.current_device() == mx.gpu(0)
    assert mx.np.zeros((2,))._data.device == torch.device("cuda", 0)
    assert mx.np.array([1.0]).device == mx.gpu(0)
    with mx.cpu():
        assert mx.np.arange(3)._data.device.type == "cpu"


def test_nd_array_of_cpu_data_lands_on_the_card(dev):
    """`np.array`/`nd.array` of a CPU tensor, a CPU NDArray or a pickled
    array land on the current device, ``cuda:0`` with no scope open."""
    import pickle

    import incubator_mxnet_tpu_torch as mx

    with mx.cpu():
        x = mx.np.array([1.0, 2.0])
    for y in (mx.np.array(torch.zeros(2)), mx.nd.array(torch.zeros(2)),
              mx.np.array(x), pickle.loads(pickle.dumps(x))):
        assert y._data.device == torch.device("cuda", 0)


def test_nd_encoder_layer_backward_twice_on_the_card(dev):
    """chip_smoke's composition on the card (units 64, 2 heads, p = 0.1):
    K1, K2, K3 both ways, K4, K4b and K5 launch from NDArray calls, and a
    second backward over the same graph gives every gradient bit for bit
    again (the kernels' Functions keep their saved tensors and key)."""
    import incubator_mxnet_tpu_torch as mx

    layer = _nd_chip_smoke().nd_encoder_layer
    from incubator_mxnet_tpu_torch.models.bert import BERTEncoder

    enc = BERTEncoder(50, 64, 128, 1, 2, 32, 0.1, device=dev)
    P = {n: mx.nd.array(p.detach().clone()) for n, p in
         enc.named_parameters()}
    for a in P.values():
        a.attach_grad()
    g = torch.Generator(device=dev).manual_seed(3)
    tok = mx.nd.array(torch.randint(0, 50, (2, 32), generator=g,
                                    device=dev))
    typ = mx.nd.array(torch.randint(0, 2, (2, 32), generator=g, device=dev))
    vl = mx.nd.array(torch.tensor([20, 32], device=dev))
    before = _nd_counts()
    mx.random.seed(1)
    with mx.autograd.record():
        loss = (layer(mx, P, tok, typ, vl, 0.1, 2) ** 2).sum()
    loss.backward()
    first = {n: a.grad.asnumpy() for n, a in P.items()}
    loss.backward()
    after = _nd_counts()
    for k in ("K1", "K2", "K3f", "K3b", "K4", "K4b", "K5"):
        assert after[k] > before[k], (k, before, after)
    for n, a in P.items():
        assert (a.grad.asnumpy() == first[n]).all(), n


def test_nd_autograd_semantics_on_the_card_match_the_cpu(dev):
    import numpy as onp

    import incubator_mxnet_tpu_torch as mx

    sem = _nd_chip_smoke()._nd_semantics
    card, x0 = sem(mx)
    with mx.cpu():
        cpu, _ = sem(mx)
    for name, arrays in card.items():
        for a, b in zip(arrays, cpu[name]):
            onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                        err_msg=name)
    bt = card["backward_twice"]
    assert (bt[0] == bt[2]).all() and (bt[1] == bt[3]).all()
    onp.testing.assert_allclose(card["grad_req_add"][1],
                                2 * card["grad_req_add"][0], rtol=1e-6)
    onp.testing.assert_allclose(card["create_graph"][1], 6 * x0, rtol=1e-5)
