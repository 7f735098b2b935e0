"""The host half of the port's serving engine, with no model: the page
allocator, the prefix cache, the scheduler against a stub slot decoder
(the port of `tests/test_serve.py`'s host tests, without the fault-seam
test, whose seam is not ported), the speculative-decoding validation and
the knobs, the step keys, the chunk buckets and the metrics registry
against the reference's.
"""
import time

import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu.fault.retry import classify_exception
from incubator_mxnet_tpu.models import decoding as jdecoding
from incubator_mxnet_tpu import util as jutil
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu_torch import util
from incubator_mxnet_tpu_torch.models.decoding import (bucket_chunk,
                                                       chunk_buckets)
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.ops import _philox
from incubator_mxnet_tpu_torch.serve import ServeEngine, SlotDecoder
from incubator_mxnet_tpu_torch.serve.engine import (PageAllocator,
                                                    PagePoolExhausted,
                                                    PrefixCache)
from incubator_mxnet_tpu_torch.serve.scheduler import (DeadlineExceeded,
                                                       EngineClosed,
                                                       QueueFull, Scheduler)
from incubator_mxnet_tpu_torch.telemetry import registry

VOCAB = 97


# ---------------------------------------------------------------------------
# paging machinery
# ---------------------------------------------------------------------------

def test_page_allocator_alloc_free_refcount():
    a = PageAllocator(n_pages=9, page_tokens=16)        # 8 usable, 0 = trash
    assert a.usable_pages == 8 and a.free_pages == 8 and a.used_pages == 0
    pages = a.alloc(3)
    assert len(pages) == 3 and 0 not in pages           # trash never handed out
    assert a.free_pages == 5 and a.used_pages == 3
    # sharing: a second holder increfs; the first decref keeps the page
    a.incref(pages[:1])
    a.decref(pages[:1])
    assert a.free_pages == 5                            # still referenced
    a.decref(pages)
    assert a.free_pages == 8 and a.used_pages == 0
    with pytest.raises(RuntimeError):                   # double free
        a.decref(pages[:1])
    with pytest.raises(RuntimeError):                   # incref of a free page
        a.incref([pages[0]])
    with pytest.raises(ValueError):
        PageAllocator(n_pages=1, page_tokens=16)


def test_page_allocator_oom_loud():
    a = PageAllocator(n_pages=5, page_tokens=8)         # 4 usable
    held = a.alloc(3)
    with pytest.raises(PagePoolExhausted) as ei:
        a.alloc(2)
    assert "never" in str(ei.value)                     # no silent eviction
    # the reference's fault plane classifies the port's error as its own
    assert classify_exception(ei.value) in ("retryable", "fatal")
    a.decref(held)
    assert len(a.alloc(4)) == 4


def test_prefix_cache_register_lookup_evict():
    a = PageAllocator(n_pages=17, page_tokens=4)        # 16 usable
    cache = PrefixCache(a)
    prompt = onp.arange(11, dtype=onp.int32)            # 2 full pages + tail
    pages = a.alloc(3)
    cache.register(prompt, pages)                       # entries for pages 1,2
    assert len(cache) == 2 and cache.cached_pages == 2
    # longest page-aligned proper prefix: 8 of 11 tokens
    tokens, shared = cache.lookup(prompt)
    assert tokens == 8 and shared == pages[:2]
    longer = onp.concatenate([prompt[:8], onp.full(6, 90, onp.int32)])
    assert cache.lookup(longer) == (8, pages[:2])
    other = onp.concatenate([onp.full(4, 91, onp.int32), prompt[4:]])
    assert cache.lookup(other)[0] == 0
    assert cache.shared_tokens(longer) == 8
    # the request retires: its refs drop, the cache's keep pages live
    a.decref(pages)
    assert a.used_pages == 2                            # page 3 freed
    # eviction drops cache refs only: a page shared into a live request
    # survives (refcount stays positive, page not reused)
    _, sp = cache.lookup(prompt)
    a.incref(sp)                                        # "live request"
    cache.evict_unused(a.usable_pages)                  # evict everything
    assert len(cache) == 0
    assert a.refcount(sp[0]) == 1 and a.refcount(sp[1]) == 1
    got = a.alloc(a.free_pages)
    assert not set(got) & set(sp)                       # never reused
    a.decref(got)
    a.decref(sp)
    assert a.free_pages == a.usable_pages


def test_prefix_cache_leaves_one_token_for_compute():
    """A page-aligned identical prompt still prefills at least one token:
    the final token's forward pass produces the first sampled token."""
    a = PageAllocator(n_pages=9, page_tokens=4)
    cache = PrefixCache(a)
    prompt = onp.arange(8, dtype=onp.int32)             # exactly 2 pages
    pages = a.alloc(2)
    cache.register(prompt, pages)
    tokens, shared = cache.lookup(prompt)
    assert tokens == 4 and shared == pages[:1]          # proper prefix only


def test_prefix_cache_disabled_and_clear():
    a = PageAllocator(n_pages=9, page_tokens=4)
    off = PrefixCache(a, enabled=False)
    pages = a.alloc(3)
    assert off.register(onp.arange(12), pages) == 0
    assert off.lookup(onp.arange(12)) == (0, [])
    on = PrefixCache(a)
    assert on.register(onp.arange(12), pages) == 3
    assert on.register(onp.arange(12), pages) == 0      # idempotent
    a.decref(pages)
    on.clear()
    assert a.used_pages == 0


# ---------------------------------------------------------------------------
# scheduler logic against a stub decoder
# ---------------------------------------------------------------------------

class _StubSlots:
    """The slot decoder's interface over a real allocator and prefix cache,
    pure host arithmetic: the final prefill chunk emits the prompt's
    length as the first token, decode increments."""

    def __init__(self, max_slots=2, max_len=64, page_tokens=16,
                 prefill_chunk=64):
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_tokens = page_tokens
        self.prefill_chunk = prefill_chunk
        pages_per_slot = -(-max_len // page_tokens)
        self.allocator = PageAllocator(max_slots * pages_per_slot + 1,
                                       page_tokens)
        self.prefix_cache = PrefixCache(self.allocator)
        self.chunks = []                  # (slot, t_start, n) per chunk
        self.keys = []

    def set_slot_pages(self, slot, pages):
        pass

    def clear_slot(self, slot):
        pass

    def prefill_chunk_step(self, slot, chunk_tokens, t_start, key,
                           temperature=1.0):
        n = len(chunk_tokens)
        self.chunks.append((slot, int(t_start), n))
        self.keys.append(key)
        return int(t_start) + n, n, 0

    def decode_step(self, last_tok, pos, active, key, temperature):
        self.keys.append(key)
        return onp.where(active, last_tok + 1, last_tok).astype(onp.int32)

    def xla_program_count(self):
        return 0

    def release(self):
        pass


def _prompt(n, seed=0):
    return onp.random.RandomState(seed).randint(
        0, VOCAB, (n,)).astype(onp.int32)


class _SpecStubSlots(_StubSlots):
    """A speculative stub: the target's next token is the last plus one,
    so a draft of last + 1, last + 2, ... is accepted whole, and one that
    is off at column ``miss_at`` is rejected from there. It records, for
    each verify and each active slot, (pos, limit, mapped pages, the
    request) through ``sched``."""

    def __init__(self, spec_k, draft_kind, miss_at=None, **kw):
        super().__init__(**kw)
        self.spec_k, self.draft_kind, self.miss_at = spec_k, draft_kind, \
            miss_at
        self.table = {}
        self.verifies = []
        self.counted = [0, 0]
        self.sched = None

    def set_slot_pages(self, slot, pages):
        self.table[slot] = list(pages)

    def clear_slot(self, slot):
        self.table.pop(slot, None)

    def _drafts(self, last):
        d = last[:, None] + onp.arange(1, self.spec_k + 1)
        if self.miss_at is not None:
            d[:, self.miss_at] += 1000
        return d.astype(onp.int32)

    def spec_propose(self, seqs):
        return self._drafts(onp.array([0 if q is None else q[-1]
                                       for q in seqs]))

    def spec_draft_step(self, last_tok, pos, active, limit):
        return self._drafts(onp.asarray(last_tok))

    def spec_verify_step(self, last_tok, drafts, pos, active, limit):
        self.verifies.append([(int(pos[s]), int(limit[s]),
                               list(self.table[s]), self.sched._in_slot[s])
                              for s in onp.flatnonzero(active)])
        return (onp.asarray(last_tok)[:, None]
                + onp.arange(1, self.spec_k + 2)).astype(onp.int32)

    def spec_count(self, drafted, accepted):
        self.counted[0] += drafted
        self.counted[1] += accepted


@pytest.mark.parametrize("draft_kind,miss_at", [("ngram", None),
                                                ("model", None),
                                                ("ngram", 1)])
def test_spec_round_acceptance_and_page_ledger(draft_kind, miss_at):
    """The speculative round against a stub target (reference
    `scheduler.py:666-755`): a whole accepted draft emits k tokens and the
    bonus with the n-gram draft, k without it with a model draft (the
    draft pool has no K/V for its own last draft), a draft wrong at
    column 1 emits 1 + the bonus; every verify finds every position it may
    write page-mapped (limit >= min(pos + k, the last position the request
    writes)); after every step a decoding slot holds the pages of every
    position it wrote and none past its position's page (a round whose
    tokens end on a page boundary leaves that page to the next round's
    extension), reservations never exceed the free pages, and every page
    comes back."""
    k, pt = 3, 4
    stub = _SpecStubSlots(k, draft_kind, miss_at, max_slots=2, max_len=64,
                          page_tokens=pt)
    sched = Scheduler(stub, max_queue=8)
    stub.sched = sched
    alloc = stub.allocator
    reqs = [sched.submit(_prompt(n, seed=n), b)
            for n, b in ((8, 30), (9, 17), (3, 11))]
    on_boundary = 0
    while not all(r.done for r in reqs):
        sched.step()
        assert alloc.free_pages >= sched._spec_reserved_total()
        for s, req in enumerate(sched._in_slot):
            if req is None or not sched._active[s]:
                continue
            pos = int(sched._pos[s])
            assert (pos - 1) // pt + 1 <= len(req.pages) <= pos // pt + 1
            on_boundary += len(req.pages) == pos // pt
            assert stub.table[s] == req.pages and req.spec_reserved >= 0
    drafted = 0
    for rows in stub.verifies:
        for pos, limit, pages, req in rows:
            assert limit == len(pages) * pt - 1
            assert limit >= min(pos + k, req.prompt.size + req.max_new - 2)
            drafted += k
    per_round = {None: k + (draft_kind == "ngram"), 1: 2}[miss_at]
    for r in reqs:
        # the stub's tokens count up from the prompt length
        assert r.result() == list(range(r.prompt.size,
                                        r.prompt.size + r.max_new))
        assert r.done and r.pages is None and r.spec_reserved == 0
    rounds = len(stub.verifies)
    assert stub.counted[0] == drafted and stub.counted[1] <= drafted
    if miss_at is None and draft_kind == "ngram":
        assert on_boundary > 0             # the case the ledger allows
    assert rounds <= sum(-(-(r.max_new - 1) // per_round) for r in reqs)
    assert alloc.used_pages == len(stub.prefix_cache._entries) and \
        sched._spec_reserved_total() == 0
    stub.prefix_cache.clear()
    assert alloc.used_pages == 0


def test_queue_backpressure_raises():
    sched = Scheduler(_StubSlots(max_slots=1), max_queue=2)
    sched.submit(_prompt(4), 4)
    sched.submit(_prompt(5), 4)
    with pytest.raises(QueueFull) as ei:
        sched.submit(_prompt(6), 4)
    assert "capacity" in str(ei.value)
    assert classify_exception(ei.value) == "retryable"


def test_submit_validation():
    sched = Scheduler(_StubSlots(max_len=16), max_queue=4)
    with pytest.raises(ValueError):
        sched.submit(_prompt(10), 8)       # 18 > max_len 16
    with pytest.raises(ValueError):
        sched.submit(onp.zeros((0,), onp.int32), 4)
    with pytest.raises(ValueError):
        sched.submit(_prompt(4), 0)
    with pytest.raises(ValueError):
        Scheduler(_StubSlots(), policy="weird")


def test_submit_page_budget_loud():
    """A request that could never fit the pool is rejected at submit with
    the loud PagePoolExhausted, not deferred forever."""
    stub = _StubSlots(max_slots=2, max_len=64, page_tokens=16)
    stub.allocator = PageAllocator(3, 16)   # 2 usable pages = 32 tokens
    sched = Scheduler(stub, max_queue=4)
    with pytest.raises(PagePoolExhausted):
        sched.submit(_prompt(30), 20)       # needs 4 pages, pool has 2
    sched.submit(_prompt(10), 10)           # 2 pages: fits


def test_sjf_policy_admits_shortest_first():
    sched = Scheduler(_StubSlots(max_slots=1), policy="sjf", max_queue=8)
    long = sched.submit(_prompt(12), 6)
    short = sched.submit(_prompt(3), 6)
    mid = sched.submit(_prompt(7), 6)
    sched.step()
    assert short.state == "running" and long.state == "queued"
    assert mid.state == "queued"
    # fifo keeps arrival order
    sched2 = Scheduler(_StubSlots(max_slots=1), policy="fifo", max_queue=8)
    a = sched2.submit(_prompt(12), 6)
    b = sched2.submit(_prompt(3), 6)
    sched2.step()
    assert a.state == "running" and b.state == "queued"


def test_sjf_orders_by_remaining_prefill_chunks():
    """A long prompt whose prefix is cached needs fewer remaining chunks
    than a shorter cold prompt: SJF admits it first."""
    stub = _StubSlots(max_slots=1, max_len=64, page_tokens=8,
                      prefill_chunk=8)
    sched = Scheduler(stub, policy="sjf", max_queue=8)
    long_prompt = _prompt(33, seed=3)       # 5 chunks cold
    short_prompt = _prompt(17, seed=4)      # 3 chunks cold
    pages = stub.allocator.alloc(4)         # cache 4 pages: 1 chunk left
    stub.prefix_cache.register(long_prompt[:32], pages)
    h_long = sched.submit(long_prompt, 5)
    h_short = sched.submit(short_prompt, 5)
    sched.step()
    assert h_long.state == "running" and h_short.state == "queued"
    assert h_long.shared_tokens == 32
    # without the cache entry, plain shortest-first wins
    stub2 = _StubSlots(max_slots=1, max_len=64, page_tokens=8,
                       prefill_chunk=8)
    sched2 = Scheduler(stub2, policy="sjf", max_queue=8)
    a = sched2.submit(_prompt(33, seed=3), 2)
    b = sched2.submit(_prompt(17, seed=4), 2)
    sched2.step()
    assert b.state == "running" and a.state == "queued"


def test_chunked_prefill_interleaves_with_decode():
    """A long prompt prefills across several steps; a running request
    keeps producing a token every step in between."""
    stub = _StubSlots(max_slots=2, max_len=64, page_tokens=8,
                      prefill_chunk=8)
    sched = Scheduler(stub, max_queue=8)
    runner = sched.submit(_prompt(4), 20)
    sched.step()      # admit + single-chunk prefill + first decode step
    assert runner.state == "running" and len(runner.tokens) == 2
    long_req = sched.submit(_prompt(33, seed=5), 2)   # 5 chunks
    produced = []
    for _ in range(4):                      # chunks 1..4: still prefilling
        before = len(runner.tokens)
        sched.step()
        produced.append(len(runner.tokens) - before)
        assert long_req.first_token_t is None
    slot = long_req.slot
    assert all(n == 1 for n in produced)
    sched.step()                            # final chunk: first token
    assert long_req.first_token_t is not None
    assert long_req.tokens[0] == 33         # stub: prompt length
    assert len(stub.chunks) >= 5 + 1
    assert [c[1:] for c in stub.chunks if c[0] == slot] == [
        (0, 8), (8, 8), (16, 8), (24, 8), (32, 1)]


def test_deadline_expiry_fails_and_frees_pages():
    sched = Scheduler(_StubSlots(max_slots=1), max_queue=8)
    req = sched.submit(_prompt(4), 4, deadline_s=0.0)
    time.sleep(0.005)
    sched.step()
    assert req.state == "failed"
    with pytest.raises(DeadlineExceeded):
        req.result()
    assert classify_exception(req.error) == "retryable"
    # a mid-decode deadline frees the slot for the next request
    r2 = sched.submit(_prompt(4), 50, deadline_s=0.02)
    sched.step()
    assert r2.state == "running"
    time.sleep(0.03)
    sched.step()
    assert r2.state == "failed" and sched.n_active == 0
    assert sched.slots.allocator.used_pages == 0


def test_drain_semantics_scheduler():
    sched = Scheduler(_StubSlots(max_slots=1), max_queue=8)
    running = sched.submit(_prompt(4), 3)
    queued = sched.submit(_prompt(5), 3)
    sched.step()
    assert running.state == "running"
    # drain: queued (never admitted) fails loudly, running survives ...
    sched.close(drain=True)
    assert queued.state == "failed"
    with pytest.raises(EngineClosed):
        queued.result()
    with pytest.raises(EngineClosed):
        sched.submit(_prompt(3), 2)
    while not running.done:
        sched.step()
    assert running.result() == [4, 5, 6]   # stub: len, +1, +1
    # ... while drain=False also fails the in-flight slots
    sched2 = Scheduler(_StubSlots(max_slots=1), max_queue=8)
    r = sched2.submit(_prompt(4), 10)
    sched2.step()
    sched2.close(drain=False)
    assert r.state == "failed" and sched2.n_active == 0
    with pytest.raises(EngineClosed):
        r.result()


def test_eos_retirement_and_eviction_metrics():
    sched = Scheduler(_StubSlots(max_slots=2), max_queue=8, eos_id=6)
    total = registry.counter("mx_serve_evictions_total")
    by_eos = registry.counter("mx_serve_evictions_total",
                              labels={"reason": "eos"})
    before, eos_before = total.value, by_eos.value
    # stub emits len, len+1, ...: a 4-prompt hits eos_id=6 on token 3
    req = sched.submit(_prompt(4), 10)
    while not req.done:
        sched.step()
    assert req.result() == [4, 5, 6]       # truncated at the eos token
    assert sched.n_active == 0             # slot freed mid-flight
    assert total.value == before + 1 and by_eos.value == eos_before + 1
    assert sched.idle and sched.free_slots == 2


def test_abandon_drops_everything_and_fails_nothing():
    sched = Scheduler(_StubSlots(max_slots=1), max_queue=8)
    running = sched.submit(_prompt(4), 10)
    queued = sched.submit(_prompt(5), 10)
    sched.step()
    sched.abandon()
    assert sched.closed and sched.n_active == 0 and sched.queue_depth == 0
    assert running.error is None and queued.error is None


def test_step_keys_are_the_seeds_philox_fold():
    """The scheduler's step keys are `ops._philox.fold` of the seed's key
    with the step counter: one per prefill chunk and per decode step, the
    same for the same seed, new for every step."""
    def keys(seed):
        stub = _StubSlots(max_slots=1)
        sched = Scheduler(stub, seed=seed)
        sched.submit(_prompt(4), 4)
        while not sched.idle:
            sched.step()
        return stub.keys

    a = keys(7)
    assert len(a) == 4 and len(set(a)) == 4
    assert a == keys(7) and a != keys(8)
    for n, key in enumerate(a, start=1):
        assert key == tuple(int(w) for w in _philox.fold((7, 0), n))
    big = (1 << 40) + 5
    sched = Scheduler(_StubSlots(), seed=big)
    assert sched._next_key() == tuple(
        int(w) for w in _philox.fold((big & 0xFFFFFFFF, big >> 32), 1))


# ---------------------------------------------------------------------------
# knobs, chunk buckets, metrics registry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    return gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0,
                    device="cpu", seed=0)


@pytest.mark.parametrize("case", ["do_sample", "unknown_draft",
                                  "draft_vocab", "draft_positions"])
def test_spec_validation_raises(tiny, case):
    """The reference's spec validation (`tests/test_serve.py:666`):
    sampling with spec_k, an unknown draft string, a draft whose
    vocabulary differs from the target's, and a draft whose position table
    is shorter than max_len all fail loudly at construction."""
    kw, match = dict(max_slots=2, max_len=64, spec_k=3), None
    if case == "do_sample":
        kw["do_sample"], match = True, "greedy"
    elif case == "unknown_draft":
        kw["draft"], match = "medusa", "unknown draft source"
    elif case == "draft_vocab":
        kw["draft"], match = gpt_tiny(vocab_size=31, max_length=64,
                                      dropout=0.0, device="cpu"), "vocab"
    else:
        kw["draft"], match = gpt_tiny(vocab_size=VOCAB, max_length=32,
                                      dropout=0.0, device="cpu"), \
            "position table"
    with pytest.raises(ValueError, match=match):
        SlotDecoder(tiny, **kw)


@pytest.mark.parametrize("how", ["env", "arg"])
def test_spec_and_int8_knobs(tiny, monkeypatch, how):
    """``MXNET_SERVE_SPEC_K``, ``MXNET_SERVE_SPEC_DRAFT`` and
    ``MXNET_SERVE_KV_DTYPE`` are read as the arguments are; the draft knob
    rejects an unknown source; spec_k 0 leaves speculation off."""
    if how == "env":
        monkeypatch.setenv("MXNET_SERVE_SPEC_K", "2")
        monkeypatch.setenv("MXNET_SERVE_SPEC_DRAFT", "ngram")
        monkeypatch.setenv("MXNET_SERVE_KV_DTYPE", "int8")
        s = SlotDecoder(tiny, max_slots=2, max_len=64)
    else:
        s = SlotDecoder(tiny, max_slots=2, max_len=64, spec_k=2,
                        draft="ngram", kv_dtype="int8")
    assert s.spec_k == 2 and s.draft_kind == "ngram"
    assert s.kv_dtype == "int8"
    # int8 K and V codes plus two f32 scales a (page, head), per layer
    assert s.page_bytes == 2 * (2 * 4 * 16 * 16 + 2 * 4 * 4)
    assert s.spec_stats() == {"k": 2, "draft": "ngram", "drafted": 0,
                              "accepted": 0, "accept_rate": None}
    if how == "env":
        monkeypatch.setenv("MXNET_SERVE_SPEC_DRAFT", "medusa")
        with pytest.raises(ValueError, match="MXNET_SERVE_SPEC_DRAFT"):
            SlotDecoder(tiny, max_slots=2, max_len=64)
        monkeypatch.delenv("MXNET_SERVE_SPEC_K")
    s = SlotDecoder(tiny, max_slots=2, max_len=64, spec_k=0)
    assert s.spec_k == 0 and s.draft_kind == "off"


def test_slot_decoder_validation_and_knobs(tiny, monkeypatch):
    with pytest.raises(TypeError):
        SlotDecoder(object())
    with pytest.raises(ValueError):
        SlotDecoder(tiny, max_len=65)                   # > position table
    with pytest.raises(ValueError):
        SlotDecoder(tiny, max_slots=0)
    with pytest.raises(ValueError):
        SlotDecoder(tiny, kv_dtype="fp16")
    with pytest.raises(ValueError):
        SlotDecoder(tiny, spec_k=-1)
    monkeypatch.setenv("MXNET_SERVE_PAGE_TOKENS", "8")
    monkeypatch.setenv("MXNET_SERVE_PREFILL_CHUNK", "20")   # -> 24
    s = SlotDecoder(tiny, max_slots=2, max_len=60)
    assert s.page_tokens == 8 and s.prefill_chunk == 24
    assert s.pages_per_slot == 8 and s.view_tokens == 64
    assert s.chunk_buckets == (8, 16, 24) and s.n_pages == 17
    # page bytes from the shapes: 2 layers x K and V x 4 heads x 8 x 16 f32
    assert s.page_bytes == 2 * 2 * 4 * 8 * 16 * 4 and s.cache_bytes == 0
    monkeypatch.setenv("MXNET_SERVE_MAX_QUEUE", "junk")     # logged default
    monkeypatch.setenv("MXNET_SERVE_DEADLINE_S", "1.5")
    monkeypatch.setenv("MXNET_SERVE_POLICY", "sjf")
    e = ServeEngine(tiny, max_slots=2)
    assert e._sched.max_queue == 128 and e._sched.default_deadline == 1.5
    assert e._sched.policy == "sjf"


def test_env_knobs_name_only_the_serving_knobs_read():
    """The knob table names exactly the knobs the port reads (the serving
    knobs among them): every ``MXNET_*`` name the package's source reads
    from the environment, and no other."""
    import re
    from pathlib import Path

    knobs = util.env_knobs()
    root = Path(util.__file__).resolve().parent
    read = re.compile(r'(?:environ\.get|env_int|env_float|_env_float|'
                      r'_env_int)\(\s*"(MXNET_[A-Z0-9_]+)"')
    names = {m for path in root.rglob("*.py")
             for m in read.findall(path.read_text())}
    assert {"MXNET_SERVE_MAX_QUEUE", "MXNET_SERVE_POLICY",
            "MXNET_SERVE_DEADLINE_S", "MXNET_SERVE_PAGE_TOKENS",
            "MXNET_SERVE_PREFILL_CHUNK", "MXNET_SERVE_KV_DTYPE",
            "MXNET_SERVE_SPEC_K", "MXNET_SERVE_SPEC_DRAFT"} <= names
    assert set(knobs) == names
    # the int8 pool and speculative decoding are ported: their knobs
    # carry the reference's own texts
    ref = jutil._ENV_KNOBS
    for name in ("MXNET_SERVE_KV_DTYPE", "MXNET_SERVE_SPEC_K",
                 "MXNET_SERVE_SPEC_DRAFT"):
        assert knobs[name] == ref[name]
        assert "not ported" not in knobs[name][1]


@pytest.mark.parametrize("pt,chunk", [(16, 64), (8, 16), (8, 24), (4, 4),
                                      (1, 5), (16, 256)])
def test_chunk_buckets_match_reference(pt, chunk):
    buckets = chunk_buckets(pt, chunk)
    assert buckets == jdecoding.chunk_buckets(pt, chunk)
    for n in range(1, chunk + 1):
        assert bucket_chunk(n, buckets) == jdecoding.bucket_chunk(n, buckets)
    with pytest.raises(ValueError):
        bucket_chunk(chunk + 1, buckets)
    if pt > 1:
        with pytest.raises(ValueError):
            chunk_buckets(pt, chunk + 1)


def _family(text, name):
    return [ln for ln in text.splitlines()
            if ln.split("{")[0].split(" ")[0].startswith(name)
            or ln.startswith(("# HELP " + name, "# TYPE " + name))]


def test_registry_exposition_matches_reference():
    """The same operations on the port's registry and the reference's
    give the same report entries and the same exposition lines."""
    for reg in (registry, jregistry):
        c = reg.counter("mx_port_parity_total", "a counter",
                        labels={"k": 'a"b'})
        c.inc()
        c.inc(4)
        reg.gauge("mx_port_parity_gauge", "a gauge").set(0.25)
        h = reg.histogram("mx_port_parity_seconds", "a histogram")
        for v in (2e-4, 0.02, 3.0, 500.0):
            h.observe(v)
        reg.register_pull_gauge("mx_port_parity_pull", lambda: 0.5,
                                "a pull gauge", labels={"tier": "hi"})
        reg.register_pull_gauge("mx_port_parity_gone", lambda: None)
    for name in ("mx_port_parity_total", "mx_port_parity_gauge",
                 "mx_port_parity_seconds", "mx_port_parity_pull"):
        assert _family(registry.exposition(), name) == \
            _family(jregistry.exposition(), name)
    rep, jrep = registry.report(), jregistry.report()
    keys = [k for k in rep if k.startswith("mx_port_parity")]
    assert keys and all(rep[k] == jrep[k] for k in keys)
    assert not any(k.startswith("mx_port_parity_gone") for k in rep)
    with pytest.raises(TypeError):
        registry.gauge("mx_port_parity_seconds")
    with pytest.raises(ValueError):
        registry.histogram("mx_port_parity_seconds", buckets=(1.0,))


def test_registry_threads_and_reset():
    import threading

    c = registry.counter("mx_port_threads_total")
    g = registry.gauge("mx_port_threads_gauge")

    def work(i):
        for _ in range(1000):
            c.inc()
        g.set(i)

    before = c.value
    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert c.value == before + 8000 and g.value in range(8)
    registry.reset()
    assert c.value == 0 and g.value is None
    assert registry.histogram("mx_port_parity_seconds").snapshot()[
        "count"] == 0


def test_gumbel_noise_is_keyed_and_standard():
    """The sampler's Gumbel noise: a function of the key and the element's
    index only, new for another key, with the standard Gumbel's mean
    (Euler's gamma) and variance (pi^2 / 6)."""
    from incubator_mxnet_tpu_torch.serve.engine import _gumbel

    k1 = torch.tensor([1, 2], dtype=torch.int64)
    k2 = torch.tensor([1, 3], dtype=torch.int64)
    a = _gumbel((64, 4096), k1)
    assert torch.equal(a, _gumbel((64, 4096), k1))
    assert torch.equal(a.reshape(-1)[:100], _gumbel((100,), k1))
    assert not torch.equal(a, _gumbel((64, 4096), k2))
    assert torch.isfinite(a).all()
    # 2^18 draws: standard errors 0.0025 (mean) and 0.0067 (variance)
    assert abs(a.mean().item() - 0.5772) < 0.015
    assert abs(a.var().item() - 1.6449) < 0.04
