"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small and ragged shapes (marker ``cuda``; skips without a card).

This file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances (kernel vs plain, same inputs on the card): float32 2e-5 for
LayerNorm and 1e-4 for attention, abs and rel (f32 accumulation in another
order, over up to a few hundred keys); bfloat16 2^-7 rel and 1e-5 abs,
elementwise (both sides round nearly the same f32 value to bf16 once, so
they are equal or neighbours); lse 1e-4 in both (f32 on both sides).
"""
import math

import pytest
import torch

from incubator_mxnet_tpu_torch import npx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models.decoding import GPTDecoder
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.ops import flash_attention as fa
from incubator_mxnet_tpu_torch.ops import layer_norm as ln

pytestmark = pytest.mark.cuda

# (rtol, atol)
BF16_TOL = (2.0 ** -7, 1e-5)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: BF16_TOL}
LN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: BF16_TOL}


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
@pytest.mark.parametrize("rows,c", [(1, 64), (5, 96), (13, 768), (1000, 768),
                                    (7, 1000), (3, 4096), (33, 8)])
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
    w = torch.ones(64, device=dev, requires_grad=True)
    with pytest.raises(MXNetError):
        ln.layer_norm(torch.randn(2, 64, device=dev), w, torch.zeros_like(w))


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
    with pytest.raises(MXNetError):
        npx.layer_norm(x.bfloat16(), g, b)         # gamma/beta f32
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
]


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
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(o.float(), op.float(), rtol=rtol, atol=atol)
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
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(o.float(), ref.float(), rtol=rtol, atol=atol)


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
