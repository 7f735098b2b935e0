"""The port's serving engine (`incubator_mxnet_tpu_torch.serve`) against
the JAX `serve.ServeEngine`, on the CPU: a `gpt_tiny`-shaped GPT (vocab 97,
64 units, 2 layers, 4 heads, max_length 64) with `tests/test_serve.py`'s
scaled random weights, carried across with `load_jax_params`.

Greedy tokens must be identical to the JAX engine's and to the port's
one-at-a-time `GPTDecoder.generate`. The paged KV pool (`slot_kv`) is held
to the JAX engine's within 1e-4 abs and rel (f32, two frameworks, two
layers: the tolerance of `tests/test_torch_gpt.py`). On a CPU model the
decode step runs the function the card captures as a CUDA graph, eagerly.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import np
from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from incubator_mxnet_tpu_torch import serve
from incubator_mxnet_tpu_torch.models.decoding import GPTDecoder
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.serve.scheduler import EngineClosed
from incubator_mxnet_tpu_torch.telemetry import registry

VOCAB = 97


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model, weights): the weights of `tests/
    test_serve.py`'s `net` fixture (scaled normal, so greedy decode
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


@pytest.fixture(scope="module")
def eng(pair):
    """Shared port engine: 3 slots, so a dozen requests reuse slots."""
    e = serve.ServeEngine(pair[1], max_slots=3, max_len=64, max_queue=32)
    yield e
    if not e.closed:
        e.shutdown(drain=False)


@pytest.fixture(scope="module")
def jeng(pair):
    e = jserve.ServeEngine(pair[0], max_slots=3, max_len=64, max_queue=32)
    yield e
    if not e.closed:
        e.shutdown(drain=False)


def _prompt(n, seed=0):
    return onp.random.RandomState(seed).randint(
        0, VOCAB, (n,)).astype(onp.int32)


def _mixed_requests(n, seed=0, lo=3, hi=18, budget_lo=2, budget_hi=12):
    r = onp.random.RandomState(seed)
    prompts = [r.randint(0, VOCAB, (int(r.randint(lo, hi)),))
               .astype(onp.int32) for _ in range(n)]
    budgets = [int(r.randint(budget_lo, budget_hi)) for _ in range(n)]
    return prompts, budgets


def _one_at_a_time(tm, prompt, budget):
    out = GPTDecoder(tm).generate(torch.from_numpy(prompt[None, :]), budget)
    return out.numpy()[0].astype(onp.int32)


def _full(prompt, handle):
    return onp.concatenate([prompt, onp.asarray(handle.result(), onp.int32)])


def test_serve_matches_jax_engine_and_one_at_a_time_flat_count(pair, eng,
                                                               jeng):
    """9 mixed requests on 3 slots through paged slot reuse: the port's
    greedy tokens equal the JAX engine's and one-at-a-time
    `GPTDecoder.generate`'s, and the program count stays flat after the
    warm-up (the port of `tests/test_serve.py:394`)."""
    _, tm, _ = pair
    prompts, budgets = _mixed_requests(9, seed=1)
    for e in (eng, jeng):
        # warm-up: one prompt per chunk bucket in play (16/32/64) + decode
        for n in (5, 20, 40):
            e.generate(onp.resize(_prompt(5, seed=9), n), 3)
    warm = eng.xla_program_count()
    # buckets 16 and 32 (the 40-token prompt reuses the 20-token one's
    # first page) and decode, as many programs as the JAX engine compiled
    assert warm == 3 == jeng.xla_program_count()
    outs = []
    for e in (eng, jeng):
        handles = [e.submit(p, b) for p, b in zip(prompts, budgets)]
        e._drive_until(handles)
        outs.append([_full(p, h) for p, h in zip(prompts, handles)])
    for p, b, got, ref in zip(prompts, budgets, *outs):
        onp.testing.assert_array_equal(got, ref)
        onp.testing.assert_array_equal(got, _one_at_a_time(tm, p, b))
    assert eng.xla_program_count() == warm


def test_paged_prefix_reuse_and_chunking_parity(pair):
    """Small pages, multi-chunk prefill and a shared 24-token system
    prompt: tokens identical to the JAX engine's and to one-at-a-time
    generation while the prefix cache takes real hits, the program count
    stays flat, the page gauge is live, and every page comes back after
    shutdown (the port of `tests/test_serve.py:418`)."""
    jm, tm, _ = pair
    system = _prompt(24, seed=42)                   # 3 shared pages
    tails = [_prompt(int(onp.random.RandomState(i).randint(2, 8)),
                     seed=100 + i) for i in range(8)]
    prompts = [onp.concatenate([system, t]) for t in tails]
    kw = dict(max_slots=3, max_len=64, max_queue=32, page_tokens=8,
              prefill_chunk=16)
    e = serve.ServeEngine(tm, **kw)
    je = jserve.ServeEngine(jm, **kw)
    try:
        # warm the chunk buckets (8 and 16) and decode out of the gate
        for eng_ in (e, je):
            eng_.generate(prompts[0][:19], 2)
            eng_.generate(prompts[0][:16], 2)
        warm = e.xla_program_count()
        hits0 = registry.counter("mx_serve_prefix_hits_total").value
        chunks0 = registry.counter("mx_serve_prefill_chunks_total").value
        handles = [e.submit(p, 6) for p in prompts]
        e._drive_until(handles)
        hits = registry.counter("mx_serve_prefix_hits_total").value - hits0
        chunks = registry.counter(
            "mx_serve_prefill_chunks_total").value - chunks0
        jouts = je.generate_many(prompts, 6)
        for p, h, ref in zip(prompts, handles, jouts):
            onp.testing.assert_array_equal(_full(p, h), ref)
            onp.testing.assert_array_equal(_full(p, h),
                                           _one_at_a_time(tm, p, 6))
        assert hits >= 4                   # later waves reuse the prefix
        assert chunks >= len(prompts)      # chunked prefill really ran
        assert e.xla_program_count() == warm
        occ = registry.report()["mx_serve_page_occupancy"]["value"]
        assert 0 < occ <= 1 and occ == e.page_occupancy
    finally:
        e.shutdown(drain=True)
        je.shutdown(drain=False)
    assert e._sched.slots.allocator.used_pages == 0
    assert e.kv_bytes_per_slot == 0        # the pool went with shutdown


@pytest.mark.parametrize("page_tokens,chunk,prompt_len",
                         [(16, 64, 40), (8, 16, 29)])
def test_slot_kv_matches_jax_engine(pair, page_tokens, chunk, prompt_len):
    """The paged pool after a finished prefill (one chunk, or several
    chunks with an offset mask) and after three decode steps equals the
    JAX engine's within 1e-4, and the tokens agree."""
    import jax

    jm, tm, _ = pair
    prompt = _prompt(prompt_len, seed=7)
    kw = dict(max_slots=2, max_len=64, page_tokens=page_tokens,
              prefill_chunk=chunk)
    slots = [serve.SlotDecoder(tm, **kw), jserve.SlotDecoder(jm, **kw)]
    keys = [(1, 2), jax.random.PRNGKey(0)]
    S = 2
    for s in slots:
        s.set_slot_pages(1, s.allocator.alloc(-(-(prompt_len + 3)
                                                // page_tokens)))
    firsts = []
    for s, key in zip(slots, keys):
        for t0 in range(0, prompt_len, s.prefill_chunk):
            first, _, _ = s.prefill_chunk_step(
                1, prompt[t0:t0 + s.prefill_chunk], t0, key)
        firsts.append(first)
    assert firsts[0] == firsts[1]

    def close(n):
        for got, ref in zip(slots[0].slot_kv(1, n), slots[1].slot_kv(1, n)):
            assert got.shape == ref.shape == (2, 4, n, 16)
            onp.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    close(prompt_len)
    last = [onp.array([0, firsts[0]], onp.int32)] * 2
    for i in range(3):
        pos = onp.array([0, prompt_len + i], onp.int32)
        active = onp.array([False, True])
        temps = onp.ones(S, onp.float32)
        nxt = [slots[0].decode_step(last[0], pos, active, (3, i), temps),
               onp.asarray(slots[1].decode_step(
                   last[1], pos, active, keys[1], temps))]
        onp.testing.assert_array_equal(nxt[0], nxt[1])
        assert nxt[0][0] == 0              # inactive slots carry last_tok
        last = [n.astype(onp.int32) for n in nxt]
    close(prompt_len + 3)


def test_out_of_order_completion(pair, eng):
    """An earlier-submitted long request does not block or corrupt a later
    short one: completion is out of order, results per request."""
    _, tm, _ = pair
    p_long, p_short = _prompt(6, seed=2), _prompt(9, seed=3)
    h_long = eng.submit(p_long, 14)
    h_short = eng.submit(p_short, 2)
    eng._drive_until([h_long, h_short])
    assert h_short.finish_t < h_long.finish_t
    for p, b, h in [(p_long, 14, h_long), (p_short, 2, h_short)]:
        onp.testing.assert_array_equal(_full(p, h), _one_at_a_time(tm, p, b))


def test_slot_reuse_after_eos_retirement(pair, eng):
    """EOS retires a slot mid-flight; the freed slot and its pages serve
    the next queued request, and stale cache rows never leak."""
    _, tm, _ = pair
    prompts, _ = _mixed_requests(6, seed=4)
    budget = 10
    ref0 = _one_at_a_time(tm, prompts[0], budget)
    eos = int(ref0[prompts[0].size + 2])
    handles = [eng.submit(p, budget, eos_id=eos) for p in prompts]
    eng._drive_until(handles)
    for p, h in zip(prompts, handles):
        new = [int(t) for t in _one_at_a_time(tm, p, budget)[p.size:]]
        if eos in new:                     # truncated at the first eos
            new = new[:new.index(eos) + 1]
        assert h.result() == new
    assert handles[0].tokens[-1] == eos and len(handles[0].tokens) <= 3
    assert eng.n_active == 0


def test_streaming_iter_tokens_ordering(pair, eng):
    _, tm, _ = pair
    p = _prompt(7, seed=5)
    h = eng.submit(p, 8)
    streamed = list(eng.iter_tokens(h))
    assert streamed == [int(t) for t in _one_at_a_time(tm, p, 8)[p.size:]]
    assert streamed == h.result()


def test_driver_thread_serves_client_submits(pair, eng):
    """A background driver owns the step loop while this thread only
    submits and waits."""
    _, tm, _ = pair
    eng.start()
    try:
        prompts, budgets = _mixed_requests(5, seed=6)
        handles = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        for h in handles:
            assert h.wait(timeout=120.0), h.state
        for p, b, h in zip(prompts, budgets, handles):
            onp.testing.assert_array_equal(_full(p, h),
                                           _one_at_a_time(tm, p, b))
    finally:
        eng.stop()
    assert eng._driver is None


def test_serve_telemetry_series(eng):
    eng.generate(_prompt(20, seed=13), 3)  # a padded chunk, a retirement
    rep = registry.report()
    assert rep["mx_serve_ttft_seconds"]["count"] > 0
    assert rep["mx_serve_ttft_seconds"]["min"] > 0
    assert rep["mx_serve_tokens_total"]["value"] > 0
    assert rep["mx_serve_evictions_total"]["value"] > 0
    assert "mx_serve_queue_depth" in rep
    assert "mx_serve_slot_occupancy" in rep
    assert "mx_serve_page_occupancy" in rep
    assert rep["mx_serve_prefill_chunks_total"]["value"] > 0
    assert "mx_serve_prefix_hits_total" in rep
    assert rep["mx_decode_bucket_pad_tokens_total"]["value"] > 0
    text = registry.exposition()
    assert "# TYPE mx_serve_ttft_seconds histogram" in text


def test_engine_drain_finishes_running_rejects_new(pair):
    """shutdown(drain=True): requests in slots finish (mid-prefill ones
    too); the never-admitted queue and new submits are rejected."""
    _, tm, _ = pair
    e = serve.ServeEngine(tm, max_slots=2, max_len=64, max_queue=8)
    prompts, _ = _mixed_requests(3, seed=7)
    h1 = e.submit(prompts[0], 8)
    h2 = e.submit(prompts[1], 8)
    h3 = e.submit(prompts[2], 8)           # stays queued: only 2 slots
    e.step()
    assert h3.state == "queued"
    e.shutdown(drain=True)
    assert h1.done and h2.done and h1.error is None and h2.error is None
    for p, h in [(prompts[0], h1), (prompts[1], h2)]:
        onp.testing.assert_array_equal(_full(p, h), _one_at_a_time(tm, p, 8))
    with pytest.raises(EngineClosed):
        h3.result()
    with pytest.raises(EngineClosed):
        e.submit(prompts[0], 4)
    assert e._sched.slots.allocator.used_pages == 0


def test_sampling_seeded_and_top_k_limits_support(pair):
    """Sampled decoding (Gumbel-max on Philox words at each step's key):
    the same seed gives the same tokens, another seed other tokens; top-k
    = 1 is greedy, and every token of a top-k = 3 draw is among the 3
    largest teacher-forced logits at its position."""
    _, tm, _ = pair
    prompts, _ = _mixed_requests(4, seed=11)

    def draw(seed, top_k):
        e = serve.ServeEngine(tm, max_slots=2, max_len=64, do_sample=True,
                              top_k=top_k, temperature=1.5, seed=seed)
        try:
            return e.generate_many(prompts, 10)
        finally:
            e.shutdown(drain=False)

    a = draw(5, 3)
    assert all(onp.array_equal(x, y) for x, y in zip(a, draw(5, 3)))
    assert not all(onp.array_equal(x, y) for x, y in zip(a, draw(6, 3)))
    for p, out in zip(prompts, a):
        logits = GPTDecoder(tm).score(
            torch.from_numpy(p[None, :]),
            torch.from_numpy(out[None, p.size:].astype(onp.int64)))[0]
        top3 = torch.topk(logits, 3, dim=-1).indices
        assert all(int(t) in top3[i].tolist()
                   for i, t in enumerate(out[p.size:]))
    for p, out in zip(prompts, draw(5, 1)):
        onp.testing.assert_array_equal(out, _one_at_a_time(tm, p, 10))


def test_replaced_weight_is_seen_and_rebuilds_the_decode_program(pair):
    """A weight replaced by a new tensor (not updated in place) is seen by
    the next step, and the decode program is built once more for it.
    (Without prefix reuse: the prefix cache keeps pages prefilled under
    the old weights, as the reference's does.)"""
    _, tm, params = pair
    m = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0, device="cpu",
                 seed=0)
    m.load_jax_params(params)
    e = serve.ServeEngine(m, max_slots=2, max_len=64, prefix_reuse=False)
    try:
        p = _prompt(21, seed=12)
        e.generate(p, 4)
        count = e.xla_program_count()
        assert count == 2                  # one chunk bucket + decode
        e.generate(p, 4)
        assert e.xla_program_count() == count
        blk = m.blocks[1]
        new = blk.ffn.ffn2.weight.detach() * 1.7
        blk.ffn.ffn2.weight = torch.nn.Parameter(new)
        got = e.generate(p, 6)
        onp.testing.assert_array_equal(got, _one_at_a_time(m, p, 6))
        assert not onp.array_equal(got, _one_at_a_time(tm, p, 6))
        assert e.xla_program_count() == count + 1
        with torch.no_grad():              # in place: no new program
            blk.ffn.ffn2.weight.mul_(0.5)
        onp.testing.assert_array_equal(e.generate(p, 6),
                                       _one_at_a_time(m, p, 6))
        assert e.xla_program_count() == count + 1
    finally:
        e.shutdown(drain=False)
