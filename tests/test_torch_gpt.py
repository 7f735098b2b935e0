"""The serving slice of the port as a whole: a `gpt_tiny`-shaped GPT
(vocab 97, 64 units, 2 layers, 4 heads, max_length 64) with the JAX
model's weights carried across by `load_jax_params`, on CPU tensors.

Tolerance for logits: 1e-4 abs and rel in float32 (two frameworks, same
f32 arithmetic in different orders over two layers). Greedy tokens must be
identical.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import np
from incubator_mxnet_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models.decoding import (GPTDecoder,
                                                       bucket_prompt)
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny

VOCAB = 97


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) with the same scaled random weights (the
    scaling of `tests/test_gpt.py`'s `spicy_net`, so greedy decode
    exercises token-dependent paths)."""
    mx.random.seed(11)
    jm = jax_gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0)
    jm.initialize()
    r = onp.random.RandomState(42)
    for _name, p in jm.collect_params().items():
        if p.shape and len(p.shape) >= 2:
            p.set_data(np.array(r.normal(0, 0.35, p.shape).astype("float32")))
    params = {n: p.data().asnumpy() for n, p in jm.collect_params().items()}
    tm = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0, device="cpu",
                  seed=0)
    tm.load_jax_params(params)
    return jm, tm, params


def _tok(batch, t, seed=0):
    return onp.random.RandomState(seed).randint(0, VOCAB, (batch, t)) \
        .astype("int32")


def test_forward_logits_match_jax(pair):
    jm, tm, _ = pair
    x = _tok(2, 16, seed=1)
    ref = jm(np.array(x)).asnumpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).long()).numpy()
    assert got.shape == (2, 16, VOCAB)
    onp.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed,shape", [(0, (2, 12, 20)), (1, (1, 1, 8)),
                                        (2, (3, 7, 1))])
def test_kv_cache_greedy_identical_to_jax(pair, seed, shape):
    jm, tm, _ = pair
    b, t0, tnew = shape
    x = _tok(b, t0, seed=seed)
    ref = jm.generate(np.array(x), tnew, use_cache=True).asnumpy()
    got = tm.generate(torch.from_numpy(x), tnew, use_cache=True)
    assert got.shape == (b, t0 + tnew)
    onp.testing.assert_array_equal(got.numpy(), ref)
    # and the port's cached decode equals its own full-forward loop
    loop = tm.generate(torch.from_numpy(x), tnew, use_cache=False)
    onp.testing.assert_array_equal(got.numpy(), loop.numpy())


def test_score_is_teacher_forced_forward(pair):
    """The decoder's teacher-forced logits equal the full forward's logits
    at the same positions (prefill + cached steps vs one causal pass)."""
    _, tm, _ = pair
    x = _tok(2, 9, seed=3)
    cont = _tok(2, 6, seed=4)
    logits = GPTDecoder(tm).score(torch.from_numpy(x), torch.from_numpy(cont))
    full = onp.concatenate([x, cont], axis=1)
    with torch.no_grad():
        ref = tm(torch.from_numpy(full).long())[:, 8:14]
    assert logits.shape == (2, 6, VOCAB)
    torch.testing.assert_close(logits, ref, rtol=1e-4, atol=1e-4)


def test_sampling_seeded_and_varied(pair):
    _, tm, _ = pair
    x = torch.from_numpy(_tok(2, 8, seed=3))

    def draw(seed, **kw):
        return tm.generate(x, 12, do_sample=True, seed=seed, **kw).numpy()

    a = draw(5, top_k=8, temperature=0.9)
    b = draw(5, top_k=8, temperature=0.9)
    c = draw(6, top_k=8, temperature=0.9)
    onp.testing.assert_array_equal(a, b)          # seeded => reproducible
    assert not (a == c).all()                      # seed changes the draw
    assert int(a.max()) < VOCAB and int(a.min()) >= 0
    # temperature ~0 sampling collapses to greedy
    greedy = tm.generate(x, 12).numpy()
    onp.testing.assert_array_equal(draw(5, temperature=1e-6), greedy)
    # the full-forward loop follows the same contract
    d = tm.generate(x, 6, do_sample=True, seed=5, top_k=8, use_cache=False)
    e = tm.generate(x, 6, do_sample=True, seed=5, top_k=8, use_cache=False)
    onp.testing.assert_array_equal(d.numpy(), e.numpy())


def test_max_length_enforced(pair):
    _, tm, _ = pair
    x = torch.from_numpy(_tok(1, 60, seed=4))
    with pytest.raises(ValueError):
        tm.generate(x, 8, use_cache=True)      # 68 > max_length 64
    with pytest.raises(ValueError):
        tm.generate(x, 8, use_cache=False)
    assert tm.generate(x, 0).shape == (1, 60)


def test_load_jax_params_rejects_bad_names_and_shapes(pair):
    _, _, params = pair
    tm = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0, device="cpu")
    before = tm.word_embed.weight.detach().clone()
    missing = dict(params)
    del missing["ln_f.beta"]
    extra = dict(params, **{"blocks.9.ln1.gamma": onp.ones(64, "float32")})
    wrong = dict(params, **{"position_embed": onp.zeros((32, 64), "float32")})
    for bad in (missing, extra, wrong):
        with pytest.raises(MXNetError):
            tm.load_jax_params(bad)
    # nothing was copied by a rejected call
    torch.testing.assert_close(tm.word_embed.weight.detach(), before)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError):
        gpt_tiny()
    with pytest.raises(MXNetError):
        gpt_tiny(device="cuda")
    m = gpt_tiny(device="cpu")
    assert m.device.type == "cpu"


def test_bucket_prompt():
    ids = torch.arange(10).reshape(2, 5)
    padded, t0 = bucket_prompt(ids, buckets=(8, 16))
    assert padded.shape == (2, 8) and t0 == 5
    torch.testing.assert_close(padded[:, :5], ids)
    assert bucket_prompt(torch.zeros(1, 8), buckets=(8, 16))[0].shape == (1, 8)
    assert bucket_prompt(torch.zeros(1, 20), buckets=(8, 16))[0].shape == \
        (1, 20)
    assert bucket_prompt(torch.zeros(1, 5), buckets=(8, 16),
                         max_len=8)[0].shape == (1, 8)
    with pytest.raises(ValueError):
        bucket_prompt(torch.zeros(5))
