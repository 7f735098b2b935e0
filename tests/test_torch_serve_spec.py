"""Speculative decoding, the int8 KV pool and `Scheduler.preempt` of the
port's serving engine (`incubator_mxnet_tpu_torch.serve`) against the JAX
`serve.ServeEngine`, on the CPU: the `gpt_tiny`-shaped GPT of
`tests/test_torch_serve.py` (vocab 97, 64 units, 2 layers, 4 heads,
max_length 64, `tests/test_serve.py`'s scaled random weights), carried
across with `load_jax_params`; a one-layer draft model the same way.

Tolerances: greedy tokens, `spec_stats()` and program counts are held
exactly. One verify pass against k + 1 sequential decode steps of the
port: the tokens exactly, the K/V pool within 1e-5 (f32 products over
another row count). The int8 pool (`slot_kv`, dequantized) within one
int8 step of the JAX engine's, elementwise: |port - jax| <= 1.01 x the
larger of the two page scales + 1e-6 (a code may round the other way
when the two frameworks' f32 K/V differ in their last bits; 1 % covers
the scales' own last bits). Against the f32 pool, int8 generation keeps
the reference's bar (`tests/test_serve.py:459`): the first token of a
single-chunk prompt exact, the divergence-free prefix at least half the
tokens, under 0.3 of the f32 pool's bytes a slot.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import np
from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.models.decoding import GPTDecoder as JGPTDecoder
from incubator_mxnet_tpu.models.decoding import \
    NgramProposer as JNgramProposer
from incubator_mxnet_tpu.models.gpt import GPTModel as JGPTModel
from incubator_mxnet_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu_torch import serve
from incubator_mxnet_tpu_torch.contrib.quantization import (
    dequantize_symmetric, quantize_symmetric)
from incubator_mxnet_tpu_torch.models.decoding import (GPTDecoder,
                                                       NgramProposer)
from incubator_mxnet_tpu_torch.models.gpt import GPTModel, gpt_tiny
from incubator_mxnet_tpu_torch.serve.engine import SlotDecoder
from incubator_mxnet_tpu_torch.telemetry import registry

VOCAB = 97
KV_TOL = 1e-5


def _scaled(jm, seed):
    r = onp.random.RandomState(seed)
    for _name, p in jm.collect_params().items():
        if p.shape and len(p.shape) >= 2:
            p.set_data(np.array(r.normal(0, 0.35, p.shape).astype("float32")))
    return {n: p.data().asnumpy() for n, p in jm.collect_params().items()}


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model): `tests/test_serve.py`'s `net` weights."""
    mx.random.seed(11)
    jm = jax_gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0)
    jm.initialize()
    params = _scaled(jm, 42)
    tm = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0, device="cpu",
                  seed=0)
    tm.load_jax_params(params)
    return jm, tm


@pytest.fixture(scope="module")
def drafts():
    """(JAX, port) one-layer draft models of the target's vocabulary, with
    other weights: a draft that is often, not always, right."""
    mx.random.seed(12)
    jd = JGPTModel(VOCAB, 64, 128, 1, 4, 64, 0.0)
    jd.initialize()
    params = _scaled(jd, 7)
    td = GPTModel(VOCAB, 64, 128, 1, 4, 64, 0.0, device="cpu", seed=0)
    td.load_jax_params(params)
    return jd, td


def _prompt(n, seed=0):
    return onp.random.RandomState(seed).randint(
        0, VOCAB, (n,)).astype(onp.int32)


def _mixed_requests(n, seed=0, lo=3, hi=18, budget_lo=2, budget_hi=12):
    r = onp.random.RandomState(seed)
    prompts = [r.randint(0, VOCAB, (int(r.randint(lo, hi)),))
               .astype(onp.int32) for _ in range(n)]
    budgets = [int(r.randint(budget_lo, budget_hi)) for _ in range(n)]
    return prompts, budgets


def _full(prompt, handle):
    return onp.concatenate([prompt, onp.asarray(handle.result(), onp.int32)])


def _serve_both(engines, prompts, budgets):
    """Every request through each engine; the full sequences, per
    engine."""
    outs = []
    for e in engines:
        handles = [e.submit(p, b) for p, b in zip(prompts, budgets)]
        e._drive_until(handles)
        outs.append([_full(p, h) for p, h in zip(prompts, handles)])
    return outs


def _warm(engines):
    """One prompt per chunk bucket in play (16 / 32 / 64) and a spec
    round or a decode step."""
    for e in engines:
        for n in (5, 20, 40):
            e.generate(onp.resize(_prompt(5, seed=9), n), 3)


# ---------------------------------------------------------------------------
# the port's own copies of the reference's host helpers
# ---------------------------------------------------------------------------

def test_ngram_proposer_unit_and_reference():
    """The reference's unit cases (`tests/test_serve.py:644`), and random
    repetitive sequences drafted exactly as `NgramProposer` of the JAX
    package drafts them."""
    p = NgramProposer(3, max_ngram=3)
    assert list(p.propose(onp.array([7, 8, 9, 1, 2, 7, 8]))) == [9, 1, 2]
    assert list(p.propose(onp.array([5, 6, 1, 5, 6]))) == [1, 5, 6]
    assert list(p.propose(onp.array([9, 5, 6, 5, 6]))) == [5, 6, 6]
    assert list(p.propose(onp.array([1, 2, 3]))) == [3, 3, 3]
    assert list(p.propose(onp.array([], onp.int32))) == [0, 0, 0]
    with pytest.raises(ValueError):
        NgramProposer(0)
    with pytest.raises(ValueError):
        NgramProposer(2, max_ngram=0)
    r = onp.random.RandomState(0)
    for k, n_gram in ((1, 1), (3, 3), (4, 2), (5, 4)):
        mine, ref = NgramProposer(k, n_gram), JNgramProposer(k, n_gram)
        for _ in range(50):
            seq = r.randint(0, 6, (int(r.randint(1, 40)),))
            out = mine.propose(seq)
            assert out.dtype == onp.int32 and out.shape == (k,)
            onp.testing.assert_array_equal(out, ref.propose(seq))


@pytest.mark.parametrize("axes", [(2, 3), (1,), ()])
def test_quantize_symmetric_matches_reference(axes):
    """`quantize_symmetric` (derived and given scales) and its inverse
    against the reference's on the same f32 inputs: codes and scales bit
    for bit (the same f32 divisions, round half to even both sides)."""
    from incubator_mxnet_tpu.contrib import quantization as jq

    r = onp.random.RandomState(3)
    x = (r.normal(0, 2, (3, 4, 16, 8)) * r.uniform(0, 1, (3, 4, 1, 1))
         ).astype(onp.float32)
    x[0, 0] = 0.0                                  # an all-zero group
    x[1, 1, 0, :4] = [0.5, -0.5, 1.5, 2.5]         # halves
    q, s = quantize_symmetric(torch.from_numpy(x), axes)
    jqv, js = jq.quantize_symmetric(mx.np.array(x)._data, axes)
    onp.testing.assert_array_equal(q.numpy(), onp.asarray(jqv))
    onp.testing.assert_array_equal(s.numpy(), onp.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    scale = torch.full((3, 4, 1, 1), 0.01)
    q2, _ = quantize_symmetric(torch.from_numpy(x), (), scale=scale)
    jq2, _ = jq.quantize_symmetric(mx.np.array(x)._data, (),
                                   scale=mx.np.array(scale.numpy())._data)
    onp.testing.assert_array_equal(q2.numpy(), onp.asarray(jq2))
    onp.testing.assert_array_equal(
        dequantize_symmetric(q, s).numpy(),
        onp.asarray(jq.dequantize_symmetric(jqv, js)))


def test_spec_engine_validation_and_env_knobs(pair, monkeypatch):
    """The port of `tests/test_serve.py:666`: spec_k rides
    MXNET_SERVE_SPEC_K; sampling, a negative k and an undersized or
    vocabulary-mismatched draft model fail loudly at construction."""
    _, net = pair
    monkeypatch.setenv("MXNET_SERVE_SPEC_K", "2")
    s = SlotDecoder(net, max_slots=2, max_len=64)
    assert s.spec_k == 2 and s.draft_kind == "ngram"
    monkeypatch.delenv("MXNET_SERVE_SPEC_K")
    s = SlotDecoder(net, max_slots=2, max_len=64)
    assert s.spec_k == 0 and s.draft_kind == "off"
    with pytest.raises(ValueError, match="greedy"):
        SlotDecoder(net, max_slots=2, max_len=64, spec_k=3, do_sample=True)
    with pytest.raises(ValueError, match="spec_k"):
        SlotDecoder(net, max_slots=2, max_len=64, spec_k=-1)
    small = gpt_tiny(vocab_size=VOCAB, max_length=32, dropout=0.0,
                     device="cpu", seed=0)
    with pytest.raises(ValueError, match="position table"):
        SlotDecoder(net, max_slots=2, max_len=64, spec_k=3, draft=small)
    other_vocab = gpt_tiny(vocab_size=31, max_length=64, dropout=0.0,
                           device="cpu", seed=0)
    with pytest.raises(ValueError, match="vocab"):
        SlotDecoder(net, max_slots=2, max_len=64, spec_k=3,
                    draft=other_vocab)
    with pytest.raises(TypeError):
        SlotDecoder(net, max_slots=2, max_len=64, spec_k=3, draft=object())


# ---------------------------------------------------------------------------
# speculative decoding against the JAX engine
# ---------------------------------------------------------------------------

def test_spec_ngram_matches_jax_engine_and_never_rebuilds(pair):
    """The port of `tests/test_serve.py:693` against the JAX engine: with
    the n-gram draft (k = 3) every request's tokens equal the JAX spec
    engine's and the non-speculative greedy decode's, `spec_stats()`
    equals the JAX engine's (drafted and accepted exactly), the program
    count stays flat after the warm-up and equals the JAX engine's, and
    the counters and the per-model gauge move."""
    jm, tm = pair
    kw = dict(max_slots=3, max_len=64, max_queue=32, spec_k=3,
              draft="ngram")
    e, je = serve.ServeEngine(tm, **kw), jserve.ServeEngine(jm, **kw)
    base = serve.ServeEngine(tm, max_slots=3, max_len=64, max_queue=32)
    try:
        _warm([e, je])
        warm = e.xla_program_count()
        # buckets 16 and 32 and the verify program, as many as the JAX
        # engine compiled
        assert warm == 3 == je.xla_program_count()
        drafted0 = registry.counter(
            "mx_serve_spec_drafted_tokens_total").value
        accepted0 = registry.counter(
            "mx_serve_spec_accepted_tokens_total").value
        stats0 = e.spec_stats()
        prompts, budgets = _mixed_requests(9, seed=1)
        got, ref, plain = _serve_both([e, je, base], prompts, budgets)
        for a, b, c in zip(got, ref, plain):
            onp.testing.assert_array_equal(a, b)
            onp.testing.assert_array_equal(a, c)
        assert e.xla_program_count() == warm
        st, jst = e.spec_stats(), je.spec_stats()
        assert st == jst
        assert st["k"] == 3 and st["draft"] == "ngram"
        assert st["drafted"] > 0 and st["accepted"] > 0
        drafted = registry.counter(
            "mx_serve_spec_drafted_tokens_total").value - drafted0
        accepted = registry.counter(
            "mx_serve_spec_accepted_tokens_total").value - accepted0
        assert drafted == st["drafted"] - stats0["drafted"]
        assert accepted == st["accepted"] - stats0["accepted"]
        rep = registry.report()
        key = 'mx_serve_spec_accept_rate{model="serve"}'
        assert rep[key]["value"] == pytest.approx(st["accept_rate"])
        assert key in jregistry.report()
    finally:
        for x in (e, je, base):
            x.shutdown(drain=False)
    assert e._sched.slots.allocator.used_pages == 0


@pytest.mark.parametrize("which", ["self", "other"])
def test_spec_model_draft_matches_jax_engine(pair, drafts, which):
    """A model draft, the target itself (the port of `tests/test_serve.py
    :730`: accept rate above 0.9, the canary for holes in the draft pool)
    or a one-layer model with other weights: tokens equal the JAX engine's
    with the same draft and the non-speculative decode's, `spec_stats()`
    equals the JAX engine's, and the program count (prefill buckets for
    the target and the draft, verify, draft) equals the JAX engine's."""
    jm, tm = pair
    jd, td = (jm, tm) if which == "self" else drafts
    kw = dict(max_slots=3, max_len=64, max_queue=32, spec_k=3)
    e = serve.ServeEngine(tm, draft=GPTDecoder(td), **kw)
    je = jserve.ServeEngine(jm, draft=JGPTDecoder(jd), **kw)
    base = serve.ServeEngine(tm, max_slots=3, max_len=64, max_queue=32)
    try:
        prompts = [_prompt(int(onp.random.RandomState(i).randint(4, 12)),
                           seed=50 + i) for i in range(6)]
        got, ref, plain = _serve_both([e, je, base], prompts, [40] * 6)
        for a, b, c in zip(got, ref, plain):
            onp.testing.assert_array_equal(a, b)
            onp.testing.assert_array_equal(a, c)
        st = e.spec_stats()
        assert st == je.spec_stats() and st["draft"] == "model"
        if which == "self":
            assert st["accept_rate"] > 0.9, st
        else:
            assert 0 < st["accept_rate"] < 1, st
        assert e.xla_program_count() == je.xla_program_count() == 4
    finally:
        for x in (e, je, base):
            x.shutdown(drain=False)
    assert e._sched.slots.allocator.used_pages == 0


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_spec_page_rollback_refcounts(pair, draft):
    """The port of `tests/test_serve.py:752`: under rejection pressure
    (k = 4, 8-token pages) after every step each decoding slot holds the
    pages of every position it wrote and none past its position's page
    (the reference asserts exactly ``pos // pt + 1``, which a round whose
    k + 1 tokens end on a page boundary leaves one short until the next
    round's extension: `tests/test_torch_serve_host.py`
    `test_spec_round_acceptance_and_page_ledger`), reservations never
    exceed the free pool, and a drained engine returns every page; the
    tokens stay the non-speculative decode's."""
    _, tm = pair
    kw = dict(max_slots=2, max_len=64, max_queue=32, page_tokens=8)
    e = serve.ServeEngine(tm, spec_k=4,
                          draft="ngram" if draft == "ngram" else tm, **kw)
    base = serve.ServeEngine(tm, **kw)
    sched = e._sched
    alloc = sched.slots.allocator
    pt = sched.slots.page_tokens
    try:
        prompts, budgets = _mixed_requests(6, seed=3, budget_lo=10,
                                           budget_hi=24)
        handles = [e.submit(p, b) for p, b in zip(prompts, budgets)]
        while not all(h.done for h in handles):
            e.step()
            assert alloc.free_pages >= sched._spec_reserved_total()
            for s, req in enumerate(sched._in_slot):
                if req is None or not sched._active[s]:
                    continue
                pos = int(sched._pos[s])
                assert (pos - 1) // pt + 1 <= len(req.pages) <= pos // pt + 1
                assert req.spec_reserved >= 0
        assert sched._spec_reserved_total() == 0
        for p, b, h in zip(prompts, budgets, handles):
            onp.testing.assert_array_equal(_full(p, h), base.generate(p, b))
    finally:
        e.shutdown(drain=False)
        base.shutdown(drain=False)
    assert alloc.used_pages == 0


def test_spec_admission_counts_reservations(pair):
    """Admission under reservations (the reference's `_admit` :459): a
    request admitted under speculation holds its prompt's pages and its
    first decode page, the rest of its worst case reserved; a second
    request whose worst case exceeds the free pages less the reservations
    stays queued even though the pages are physically free, and is
    admitted once the first retires."""
    _, tm = pair
    e = serve.ServeEngine(tm, max_slots=2, max_len=64, n_pages=9,
                          page_tokens=8, spec_k=2, draft="ngram")
    sched = e._sched
    alloc = sched.slots.allocator
    try:
        h1 = e.submit(_prompt(10, seed=1), 40)      # 7 pages worst case
        h2 = e.submit(_prompt(4, seed=2), 20)       # 3 pages worst case
        e.step()
        req = sched._in_slot[0]
        assert req is h1 and len(req.pages) == 2 and req.spec_reserved == 5
        assert h2.state == "queued" and alloc.free_pages == 6
        assert alloc.free_pages >= sched._spec_reserved_total()
        e._drive_until([h1, h2])
        assert h1.error is None and h2.error is None
    finally:
        e.shutdown(drain=False)
    assert alloc.used_pages == 0


def test_verify_equals_sequential_decode_steps(pair):
    """One verify pass over [last, d_1..d_3] (random drafts) gives, row by
    row, the tokens of 4 sequential decode steps fed the same tokens, and
    writes the same K/V (within 1e-5); rows past ``limit`` write the
    trash page only, and an inactive slot's rows carry its own tokens."""
    _, tm = pair
    k, prompt_len = 3, 21
    kw = dict(max_slots=2, max_len=64, page_tokens=8, prefill_chunk=16)
    spec = SlotDecoder(tm, spec_k=k, draft="ngram", **kw)
    dec = SlotDecoder(tm, **kw)
    prompt = _prompt(prompt_len, seed=4)
    for s in (spec, dec):
        s.set_slot_pages(1, s.allocator.alloc(5))   # positions 0..39
        for t0 in range(0, prompt_len, s.prefill_chunk):
            first, _, _ = s.prefill_chunk_step(
                1, prompt[t0:t0 + s.prefill_chunk], t0, (0, 0))
    toks = onp.array([[5, 6, 7, 8], [first, 11, 42, 3]], onp.int64)
    pos = onp.array([0, prompt_len])
    active = onp.array([False, True])
    tgt = spec.spec_verify_step(toks[:, 0], toks[:, 1:], pos, active,
                                onp.array([0, 31]))
    seq = []
    for i in range(k + 1):
        nxt = dec.decode_step(toks[:, i], pos + i, active, (0, 0),
                              onp.ones(2, onp.float32))
        seq.append(nxt[1])
    assert tgt.shape == (2, k + 1) and tgt.dtype == onp.int32
    onp.testing.assert_array_equal(tgt[1], seq)
    onp.testing.assert_array_equal(tgt[0], toks[0])
    for a, b in zip(spec.slot_kv(1, prompt_len + k + 1),
                    dec.slot_kv(1, prompt_len + k + 1)):
        onp.testing.assert_allclose(a, b, rtol=KV_TOL, atol=KV_TOL)
    # rows at 30..33 with limit 31: rows 32 and 33 (page 4, mapped)
    # write the trash page instead
    before = [t.clone() for t in spec._pk]
    spec.spec_verify_step(toks[:, 0], toks[:, 1:], onp.array([0, 30]),
                          active, onp.array([0, 31]))
    for b, t in zip(before, spec._pk):
        changed = (b != t).any(dim=(1, 2, 3)).nonzero().flatten().tolist()
        assert int(spec._table[1, 3]) in changed
        assert set(changed) <= {0, int(spec._table[1, 3])}


# ---------------------------------------------------------------------------
# the int8 KV pool
# ---------------------------------------------------------------------------

def test_int8_kv_parity_with_jax_engine_and_fp_bar(pair):
    """The port of `tests/test_serve.py:459`, against the JAX int8 engine:
    tokens equal the JAX int8 engine's; against the f32 engine the
    reference's bar (first token of a single-chunk prompt exact, the
    divergence-free prefix at least half, under 0.3 of the bytes a slot);
    `page_bytes` the reference's."""
    jm, tm = pair
    kw = dict(max_slots=3, max_len=64, max_queue=32)
    e8 = serve.ServeEngine(tm, kv_dtype="int8", **kw)
    je8 = jserve.ServeEngine(jm, kv_dtype="int8", **kw)
    efp = serve.ServeEngine(tm, **kw)
    try:
        prompts, budgets = _mixed_requests(9, seed=1)
        got, ref, fp = _serve_both([e8, je8, efp], prompts, budgets)
        match, total = 0, 0
        for p, a, b, c in zip(prompts, got, ref, fp):
            onp.testing.assert_array_equal(a, b)
            out, want = a[p.size:], c[p.size:]
            assert out[0] == want[0]
            n = 0
            for x, y in zip(out, want):
                if x != y:
                    break
                n += 1
            match += n
            total += len(want)
        assert match / total >= 0.5, f"int8 drift too large: {match}/{total}"
        assert e8.kv_bytes_per_slot < 0.3 * efp.kv_bytes_per_slot
        assert e8.kv_bytes_per_slot == je8.kv_bytes_per_slot
        s8, js8 = e8._sched.slots, je8._sched.slots
        assert s8.page_bytes == js8.page_bytes
        assert s8.cache_bytes == js8.cache_bytes
    finally:
        for x in (e8, je8, efp):
            x.shutdown(drain=False)


def _int8_close(port, ref, slot, n):
    """The two engines' dequantized K/V of ``slot`` within one int8 step
    of the page's scale, elementwise."""
    pt = port.page_tokens
    pages = port._table[slot, :-(-n // pt)]
    for (got, want), (scales, jscales) in zip(
            zip(port.slot_kv(slot, n), ref.slot_kv(slot, n)),
            ((port._sk, ref._sk), (port._sv, ref._sv))):
        for li in range(got.shape[0]):
            sc = onp.maximum(scales[li].numpy()[pages],
                             onp.asarray(jscales[li])[pages])     # (P, H)
            step = onp.repeat(sc.T, pt, axis=1)[:, :n, None]       # (H, n, 1)
            err = onp.abs(got[li] - want[li])
            assert (err <= 1.01 * step + 1e-6).all(), err.max()


@pytest.mark.parametrize("page_tokens,chunk,prompt_len",
                         [(16, 64, 40), (8, 16, 29)])
def test_int8_slot_kv_within_one_step_of_jax_engine(pair, page_tokens,
                                                    chunk, prompt_len):
    """The int8 pool after a finished prefill (one chunk, or several with
    an offset mask) and after six decode steps that grow the page scales
    is within one int8 step of the JAX engine's, the tokens equal."""
    import jax

    jm, tm = pair
    prompt = _prompt(prompt_len, seed=7)
    kw = dict(max_slots=2, max_len=64, page_tokens=page_tokens,
              prefill_chunk=chunk, kv_dtype="int8")
    slots = [SlotDecoder(tm, **kw), jserve.SlotDecoder(jm, **kw)]
    keys = [(1, 2), jax.random.PRNGKey(0)]
    for s in slots:
        s.set_slot_pages(1, s.allocator.alloc(-(-(prompt_len + 6)
                                                // page_tokens)))
    firsts = []
    for s, key in zip(slots, keys):
        for t0 in range(0, prompt_len, s.prefill_chunk):
            first, _, _ = s.prefill_chunk_step(
                1, prompt[t0:t0 + s.prefill_chunk], t0, key)
        firsts.append(first)
    assert firsts[0] == firsts[1]
    _int8_close(*slots, 1, prompt_len)
    last = onp.array([0, firsts[0]], onp.int32)
    for i in range(6):
        pos = onp.array([0, prompt_len + i], onp.int32)
        active = onp.array([False, True])
        temps = onp.ones(2, onp.float32)
        nxt = [slots[0].decode_step(last, pos, active, (3, i), temps),
               onp.asarray(slots[1].decode_step(last, pos, active, keys[1],
                                                temps))]
        onp.testing.assert_array_equal(nxt[0], nxt[1])
        last = nxt[0].astype(onp.int32)
    _int8_close(*slots, 1, prompt_len + 6)


def test_int8_spec_ngram_matches_jax_engine(pair):
    """The int8 pool under speculative decoding (the verify step's
    column-by-column writes set the page scales): tokens and
    `spec_stats()` equal the JAX int8 spec engine's."""
    jm, tm = pair
    kw = dict(max_slots=3, max_len=64, max_queue=32, kv_dtype="int8",
              spec_k=3, draft="ngram")
    e, je = serve.ServeEngine(tm, **kw), jserve.ServeEngine(jm, **kw)
    try:
        prompts, budgets = _mixed_requests(8, seed=5, budget_lo=8,
                                           budget_hi=20)
        got, ref = _serve_both([e, je], prompts, budgets)
        for a, b in zip(got, ref):
            onp.testing.assert_array_equal(a, b)
        assert e.spec_stats() == je.spec_stats()
    finally:
        e.shutdown(drain=False)
        je.shutdown(drain=False)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [0, 3])
def test_preempt_then_resubmit_continues_with_jax_tokens(pair, spec_k):
    """`Scheduler.preempt` (reference `scheduler.py:793`): the request is
    left ``"preempted"`` (not done, not failed), its slot and pages free
    but for the page-aligned resident prefix the prefix cache keeps; a
    resubmission of prompt + tokens so far re-attaches those pages as a
    shared prefix and continues with the JAX engine's tokens for the
    uninterrupted request."""
    jm, tm = pair
    kw = dict(max_slots=2, max_len=64, max_queue=8, page_tokens=8)
    if spec_k:
        kw.update(spec_k=spec_k, draft="ngram")
    e, je = serve.ServeEngine(tm, **kw), jserve.ServeEngine(jm, **kw)
    sched = e._sched
    alloc = sched.slots.allocator
    prompt, budget = _prompt(13, seed=21), 30
    try:
        want = je.generate(prompt, budget)
        h = e.submit(prompt, budget)
        while len(h.tokens) < 12:
            e.step()
        evictions = registry.counter("mx_serve_evictions_total",
                                     labels={"reason": "preempted"}).value
        resident = int(sched._pos[h.slot])
        req = sched.preempt(h.slot)
        assert req is h and h.state == "preempted" and not h.done
        assert h.error is None and h.pages is None and h.slot is None
        assert sched.n_active == 0 and sched._spec_reserved_total() == 0
        assert registry.counter("mx_serve_evictions_total",
                                labels={"reason": "preempted"}
                                ).value == evictions + 1
        # only the cache's references are left: the aligned resident pages
        assert alloc.used_pages == resident // 8
        with pytest.raises(ValueError, match="empty"):
            sched.preempt(0)
        hits = registry.counter("mx_serve_prefix_hits_total").value
        so_far = onp.concatenate([prompt, onp.asarray(h.tokens, onp.int32)])
        h2 = e.submit(so_far, budget - len(h.tokens))
        e._drive_until([h2])
        assert registry.counter("mx_serve_prefix_hits_total").value \
            == hits + 1
        assert h2.shared_tokens == resident // 8 * 8 > prompt.size
        onp.testing.assert_array_equal(_full(so_far, h2), want)
    finally:
        e.shutdown(drain=False)
        je.shutdown(drain=False)
    assert alloc.used_pages == 0
