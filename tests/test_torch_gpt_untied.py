"""`GPTModel(tie_weights=False)`, the LM head of its own, against the JAX
package's, on the CPU: a `gpt_tiny`-shaped GPT (vocab 97, 64 units, 2
layers, 4 heads, max_length 64) with scaled random weights (the untied
``lm_head.weight`` drawn apart from the embedding) carried across by
`load_jax_params`.

Logits within 1e-4 abs and rel (f32, two frameworks, two layers: the
tolerance of `tests/test_torch_gpt.py`); greedy tokens of `GPTDecoder`
(`generate`) and of the serving engine identical to the JAX model's and
engine's. With ``lm_head.weight`` set to a copy of the embedding, the
untied model's tokens are the tied model's.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import np
from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.models.gpt import GPTModel as JaxGPT
from incubator_mxnet_tpu_torch import serve
from incubator_mxnet_tpu_torch.models.decoding import GPTDecoder
from incubator_mxnet_tpu_torch.models.gpt import GPTModel, gpt_tiny

VOCAB = 97


@pytest.fixture(scope="module")
def pair():
    mx.random.seed(11)
    jm = JaxGPT(VOCAB, 64, 128, 2, 4, 64, 0.0, tie_weights=False)
    jm.initialize()
    r = onp.random.RandomState(42)
    for _name, p in jm.collect_params().items():
        if p.shape and len(p.shape) >= 2:
            p.set_data(np.array(r.normal(0, 0.35, p.shape).astype("float32")))
    params = {n: p.data().asnumpy() for n, p in jm.collect_params().items()}
    tm = GPTModel(VOCAB, 64, 128, 2, 4, 64, 0.0, tie_weights=False,
                  device="cpu", seed=0)
    tm.load_jax_params(params)
    return jm, tm.eval(), params


def _prompts(n, seed=0, lo=3, hi=18):
    r = onp.random.RandomState(seed)
    return [r.randint(0, VOCAB, (int(r.randint(lo, hi)),)).astype(onp.int32)
            for _ in range(n)]


def test_untied_model_has_the_references_parameters(pair):
    jm, tm, _ = pair
    assert sorted(dict(tm.collect_params())) == sorted(jm.collect_params())
    assert tm.lm_head.weight.shape == (VOCAB, 64)
    tied = gpt_tiny(vocab_size=VOCAB, max_length=64, device="cpu", seed=0)
    assert "lm_head.weight" not in dict(tied.collect_params())


def test_untied_logits_match_jax(pair):
    jm, tm, _ = pair
    tok = onp.random.RandomState(1).randint(0, VOCAB, (2, 9)).astype("int32")
    want = jm(np.array(tok)).asnumpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(tok).long()).numpy()
    assert got.shape == (2, 9, VOCAB)
    onp.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_untied_decoder_tokens_match_jax(pair):
    """`GPTModel.generate` (the KV-cache decoder) against the JAX model's
    and the port's own full-forward loop."""
    jm, tm, _ = pair
    tok = onp.random.RandomState(2).randint(0, VOCAB, (3, 6)).astype("int32")
    want = onp.asarray(jm.generate(np.array(tok), 12).asnumpy())
    got = tm.generate(torch.from_numpy(tok), 12).numpy()
    onp.testing.assert_array_equal(got, want)
    full = tm.generate(torch.from_numpy(tok), 12, use_cache=False).numpy()
    onp.testing.assert_array_equal(got, full)


def test_untied_engine_tokens_match_jax(pair):
    """Eight mixed requests through the paged engine on both packages, and
    one at a time through `GPTDecoder`."""
    jm, tm, _ = pair
    prompts = _prompts(8, seed=3)
    outs = []
    for model, pkg in ((tm, serve), (jm, jserve)):
        e = pkg.ServeEngine(model, max_slots=3, max_len=64, max_queue=16)
        try:
            handles = [e.submit(p, 7) for p in prompts]
            e._drive_until(handles)
            outs.append([onp.asarray(h.result(), onp.int32)
                         for h in handles])
        finally:
            e.shutdown(drain=False)
    for p, got, want in zip(prompts, *outs):
        onp.testing.assert_array_equal(got, want)
        one = GPTDecoder(tm).generate(torch.from_numpy(p[None, :]), 7)
        onp.testing.assert_array_equal(one.numpy()[0, len(p):], got)


def test_untied_head_on_the_embedding_gives_the_tied_tokens(pair):
    """``lm_head.weight`` set to a copy of the embedding: the decoder and
    the engine give the tied model's tokens."""
    _, _, params = pair
    tied = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0,
                    device="cpu", seed=0)
    tied.load_jax_params({k: v for k, v in params.items()
                          if k != "lm_head.weight"})
    untied = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0,
                      device="cpu", seed=0, tie_weights=False)
    untied.load_jax_params(dict(params, **{
        "lm_head.weight": params["word_embed.weight"].copy()}))
    tok = torch.from_numpy(onp.random.RandomState(4).randint(
        0, VOCAB, (2, 7)))
    assert torch.equal(untied.eval().generate(tok, 10),
                       tied.eval().generate(tok, 10))
    prompts = _prompts(4, seed=5)
    outs = []
    for model in (untied, tied):
        e = serve.ServeEngine(model, max_slots=2, max_len=64, max_queue=8)
        try:
            handles = [e.submit(p, 5) for p in prompts]
            e._drive_until(handles)
            outs.append([list(h.result()) for h in handles])
        finally:
            e.shutdown(drain=False)
    assert outs[0] == outs[1]
