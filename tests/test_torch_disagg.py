"""The port's disaggregated prefill/decode serving (`serve.disagg`, the
scheduler's hand-off and the engine's page migration) against the JAX
package's, on the CPU.

- the registry's role validation and page split, and the migration
  plane over stub engines (pure host arithmetic over each package's own
  allocator and prefix cache, `tests/test_disagg.py`'s recipe): a
  migrated request continues the same token run, the byte audit is
  exact (bytes = pages moved x ``page_bytes``), the ``page_migration``
  fault falls back co-located with no page leak, an exhausted decode
  pool falls back, prefix warmth routes a repeat migration, tiers and
  preemption hold — each a case of both packages;
- real `gpt_tiny` engines (the scaled weights of `tests/test_serve.py`):
  a request prefilled on one replica and decoded on the other gives the
  tokens of a one-replica pod bit for bit, and of the JAX package's
  disaggregated pod; the pages moved equal the prompts' pages; the
  decode replica never runs a prefill chunk; program counts stay flat on
  a second pass; the migrated pages are the prefill replica's bit for
  bit; the fault seam falls back with every page accounted for.
"""
import os
import sys
from types import SimpleNamespace

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import np as jnp_
from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.fault import injection as jinjection
from incubator_mxnet_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from incubator_mxnet_tpu.serve import disagg as jdisagg
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch.fault import injection as tinjection
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.serve import disagg as tdisagg
from incubator_mxnet_tpu_torch.telemetry import anatomy as tanatomy
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry

VOCAB = 97

PKGS = {
    "ref": SimpleNamespace(serve=jserve, injection=jinjection,
                           registry=jregistry, disagg=jdisagg),
    "port": SimpleNamespace(serve=tserve, injection=tinjection,
                            registry=tregistry, disagg=tdisagg),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    p.injection.clear_injection()
    yield p
    p.injection.clear_injection()


class _StubSlots:
    """`tests/test_disagg.py:43`'s stand-in over a package's allocator:
    the final prefill chunk emits the prompt's length, decode increments;
    ``page_bytes`` makes the byte audit exact."""

    def __init__(self, pkg, max_slots=2, max_len=64, page_tokens=16,
                 prefill_chunk=64, n_pages=None, page_bytes=2048):
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_tokens = page_tokens
        self.prefill_chunk = prefill_chunk
        self.page_bytes = page_bytes
        pages_per_slot = -(-max_len // page_tokens)
        self.allocator = pkg.serve.PageAllocator(
            n_pages if n_pages is not None
            else max_slots * pages_per_slot + 1, page_tokens)
        self.prefix_cache = pkg.serve.PrefixCache(self.allocator)

    def set_slot_pages(self, slot, pages):
        pass

    def clear_slot(self, slot):
        pass

    def prefill_chunk_step(self, slot, chunk_tokens, t_start, key,
                           temperature=1.0):
        n = len(chunk_tokens)
        return int(t_start) + n, n, 0

    def decode_step(self, last_tok, pos, active, key, temperature):
        return onp.where(active, last_tok + 1, last_tok).astype(onp.int32)

    def xla_program_count(self):
        return 0

    def release(self):
        pass


def _prompt(n, seed=0):
    return onp.random.RandomState(seed).randint(
        0, VOCAB, (n,)).astype(onp.int32)


def _disagg_gateway(pkg, n_prefill=1, n_decode=1, decode_pages=None,
                    prefill_pages=None, **gw_kwargs):
    stubs = ([_StubSlots(pkg, n_pages=prefill_pages)
              for _ in range(n_prefill)]
             + [_StubSlots(pkg, n_pages=decode_pages)
                for _ in range(n_decode)])
    reg = pkg.serve.ModelRegistry()
    reg.add("m", stubs, prefill_replicas=n_prefill,
            decode_replicas=n_decode)
    return pkg.serve.Gateway(reg, **gw_kwargs), stubs


def _drive(gw, handles, steps=400):
    for _ in range(steps):
        gw.step()
        if all(h.done for h in handles):
            return
    raise AssertionError(f"requests not done: {[h.state for h in handles]}")


def _moved(pkg, model):
    return pkg.disagg.migration_counts(model)


# ---------------------------------------------------------------------------
# registry roles and the page split
# ---------------------------------------------------------------------------

def test_registry_disagg_validation(pkg):
    reg = pkg.serve.ModelRegistry()
    with pytest.raises(ValueError):
        reg.add("a", _StubSlots(pkg), prefill_replicas=1)
    with pytest.raises(ValueError):
        reg.add("b", _StubSlots(pkg), decode_replicas=1)
    with pytest.raises(ValueError):
        reg.add("c", [_StubSlots(pkg), _StubSlots(pkg)], replicas=2,
                prefill_replicas=1, decode_replicas=1)
    with pytest.raises(ValueError):
        reg.add("d", [_StubSlots(pkg)], prefill_replicas=1,
                decode_replicas=0)
    reg2 = pkg.serve.ModelRegistry()
    reg2.add("m", [_StubSlots(pkg) for _ in range(3)], prefill_replicas=1,
             decode_replicas=1)
    with pytest.raises(ValueError) as ei:
        pkg.serve.Gateway(reg2)
    assert "pre-built" in str(ei.value)
    reg3 = pkg.serve.ModelRegistry()
    reg3.add("m", _StubSlots(pkg), prefill_replicas=1, decode_replicas=1)
    with pytest.raises(ValueError):
        pkg.serve.Gateway(reg3)


@pytest.mark.parametrize("total,n_p,n_d,shares", [
    (100, 1, 2, (1.0,)), (72, 1, 1, (1.0,)), (120, 2, 3, (2.0, 1.0)),
    (40, 1, 1, (1.0, 1.0))])
def test_registry_page_split_equals_reference(total, n_p, n_d, shares):
    """`rebalance_pages_disagg` and `rebalance_pages` give the reference's
    cuts, and both raise `PagePoolExhausted` where it does."""
    outs = []
    for serve_mod in (tserve, jserve):
        reg = serve_mod.ModelRegistry(total_pages=total)
        for i, share in enumerate(shares):
            reg.add(f"m{i}", object(), share=share, prefill_replicas=n_p,
                    decode_replicas=n_d)
        out = [reg.rebalance_pages_disagg("m0", n_p, n_d),
               reg.rebalance_pages("m0", n_p + n_d)]
        with pytest.raises(serve_mod.PagePoolExhausted):
            reg.rebalance_pages_disagg("m0", 1, 100)
        with pytest.raises(ValueError):
            reg.rebalance_pages_disagg("nope", 1, 1)
        outs.append(out)
    assert outs[0] == outs[1]
    assert tserve.ModelRegistry().add(
        "m", object(), prefill_replicas=1,
        decode_replicas=1).rebalance_pages_disagg("m", 1, 1) == (None, None)


def test_roles_assigned_and_dispatch_scoped(pkg):
    gw, _ = _disagg_gateway(pkg, n_prefill=1, n_decode=2)
    try:
        m = gw._models["m"]
        assert m.disagg
        assert [r.role for r in m.replicas] == ["prefill", "decode",
                                                "decode"]
        assert [r.label for r in m.replicas] == ["m#0", "m#1", "m#2"]
        assert [r.role for r in gw._dispatch_reps(m)] == ["prefill"]
    finally:
        gw.shutdown(drain=False)


# ---------------------------------------------------------------------------
# the migration plane over stub engines
# ---------------------------------------------------------------------------

def test_migrated_request_continues_token_run_and_audits_bytes(pkg):
    gw, stubs = _disagg_gateway(pkg)
    try:
        p0, b0 = _moved(pkg, "m")
        h = gw.submit("m", _prompt(20), 6)
        _drive(gw, [h])
        assert h.state == "done"
        assert h.tokens == list(range(20, 26))
        assert h.replica == "m#1"
        p1, b1 = _moved(pkg, "m")
        assert p1 - p0 == 2
        assert b1 - b0 == (p1 - p0) * stubs[0].page_bytes
        assert stubs[0].prefix_cache.cached_pages == 1
        assert stubs[1].prefix_cache.cached_pages == 1
        for rep in gw._models["m"].replicas:
            assert rep.sched.idle and not rep.live
    finally:
        gw.shutdown(drain=False)
    for s in stubs:
        assert s.allocator.free_pages == s.allocator.usable_pages


def test_prefill_pool_is_not_the_submit_viability_bar(pkg):
    gw, _ = _disagg_gateway(pkg, prefill_pages=4, decode_pages=12)
    try:
        h = gw.submit("m", _prompt(20), 40)
        _drive(gw, [h])
        assert h.state == "done" and len(h.tokens) == 40
    finally:
        gw.shutdown(drain=False)
    gw2, _ = _disagg_gateway(pkg, decode_pages=4)
    try:
        with pytest.raises(pkg.serve.PagePoolExhausted):
            gw2.submit("m", _prompt(40), 24)
    finally:
        gw2.shutdown(drain=False)


def test_page_migration_fault_falls_back_colocated_no_leak(pkg):
    gw, stubs = _disagg_gateway(pkg)
    try:
        p0, _ = _moved(pkg, "m")
        pkg.injection.configure_injection("page_migration:1.0:0:1")
        h = gw.submit("m", _prompt(20), 6)
        _drive(gw, [h])
        pkg.injection.clear_injection()
        assert h.state == "done"
        assert h.tokens == list(range(20, 26))
        assert h.replica == "m#0"
        assert _moved(pkg, "m")[0] == p0
        assert stubs[1].allocator.free_pages == \
            stubs[1].allocator.usable_pages
        assert stubs[0].prefix_cache.cached_pages == 1
        stubs[0].prefix_cache.clear()
        assert stubs[0].allocator.free_pages == \
            stubs[0].allocator.usable_pages
    finally:
        gw.shutdown(drain=False)


def test_decode_exhausted_falls_back_colocated(pkg):
    gw, _ = _disagg_gateway(pkg, decode_pages=6)
    try:
        hs = [gw.submit("m", _prompt(20, seed=i), 20) for i in range(2)]
        _drive(gw, hs)
        for h in hs:
            assert h.state == "done"
            assert h.tokens == list(range(20, 40))
        assert sorted(h.replica for h in hs) == ["m#0", "m#1"]
    finally:
        gw.shutdown(drain=False)


def test_migration_feeds_decode_prefix_warmth(pkg):
    gw, stubs = _disagg_gateway(pkg, n_decode=2)
    try:
        h1 = gw.submit("m", _prompt(32, seed=3), 4)
        _drive(gw, [h1])
        warm = [stubs[1 + i].prefix_cache.shared_tokens(_prompt(32, seed=3))
                for i in range(2)]
        assert sorted(warm) == [0, 16]
        h2 = gw.submit("m", _prompt(32, seed=3), 4)
        _drive(gw, [h2])
        assert h2.tokens == h1.tokens == list(range(32, 36))
        assert h2.replica == h1.replica
    finally:
        gw.shutdown(drain=False)


def test_preemption_and_tiers_preserved_under_disagg(pkg):
    gw, _ = _disagg_gateway(pkg, prefill_pages=9)
    try:
        lows = [gw.submit("m", _prompt(60, seed=i), 2, tenant="crawl",
                          priority="low") for i in range(2)]
        for _ in range(2):
            gw.step()
        high = gw.submit("m", _prompt(8, seed=9), 2, tenant="acme",
                         priority="high")
        _drive(gw, lows + [high])
        assert high.state == "done"
        assert {r.state for r in lows} == {"done"}
        for r in lows:
            assert len(r.tokens) == 2
    finally:
        gw.shutdown(drain=False)


def test_warm_decode_replica_adopts_without_prefill(pkg):
    """`warm_decode_replica` adopts fake prefilled requests on a decode
    replica and drives them out: no prefill chunk, every page back."""
    gw, stubs = _disagg_gateway(pkg)
    try:
        rep = gw._models["m"].replicas[1]
        calls = []
        stubs[1].prefill_chunk_step = lambda *a, **k: calls.append(a)
        pkg.disagg.warm_decode_replica(rep, warm_lens=(8, 20), warm_new=3)
        assert not calls and rep.sched.idle
        assert stubs[1].allocator.used_pages == 0
    finally:
        gw.shutdown(drain=False)


def test_mixed_length_replay_on_disagg_pod(pkg):
    """`tools/loadgen.mixed_length_trace` through a stub pod: every
    request completes and pages migrate."""
    loadgen = _loadgen()
    gw, _ = _disagg_gateway(pkg, n_decode=2, decode_pages=24)
    try:
        ev = loadgen.mixed_length_trace(
            12, "m", seed=5, duration_s=0.3, long_prompt=48,
            long_new_range=(2, 4), chat_new_range=(2, 6))
        p0, _ = _moved(pkg, "m")
        rep = loadgen.replay(gw, ev, VOCAB, timeout=60.0)
        assert not rep["failed"] and rep["completed"] == len(ev)
        assert _moved(pkg, "m")[0] > p0
    finally:
        gw.shutdown(drain=False)


def _loadgen():
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    try:
        import loadgen
    finally:
        sys.path.pop(0)
    return loadgen


# ---------------------------------------------------------------------------
# real engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) with `tests/test_disagg.py:487`'s weights."""
    jmx.random.seed(11)
    jm = jax_gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0)
    jm.initialize()
    r = onp.random.RandomState(42)
    for _name, p in jm.collect_params().items():
        if p.shape and len(p.shape) >= 2:
            p.set_data(jnp_.array(r.normal(0, 0.35, p.shape)
                                  .astype("float32")))
    tm = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0, device="cpu",
                  seed=0)
    tm.load_jax_params({n: p.data().asnumpy()
                        for n, p in jm.collect_params().items()})
    return jm, tm


PROMPTS = [(_prompt(21, seed=1), 6), (_prompt(7, seed=2), 8),
           (_prompt(33, seed=3), 5)]


def _serve_one_at_a_time(gw, prompts):
    out = []
    for p, n in prompts:
        h = gw.submit("gpt", p, n)
        gw._drive_until([h], timeout=120.0)
        assert h.state == "done"
        out.append((list(h.tokens), h.replica))
    return out


def test_migrated_page_parity_real_engines(pair):
    """`tests/test_disagg.py:498` on the port, and against the JAX pod:
    the tokens of a request prefilled on replica A and decoded on B equal
    a one-replica pod's bit for bit and the JAX pod's; every request ends
    on the decode replica; pages moved = the prompts' pages, bytes =
    pages x ``page_bytes``; no prefill chunk on the decode replica; a
    second pass at the same lengths builds nothing new anywhere."""
    jm, tm = pair
    reg_b = tserve.ModelRegistry(total_pages=40)
    reg_b.add("gpt", tm, max_slots=2, max_len=64)
    gw_b = tserve.Gateway(reg_b)
    try:
        base = [t for t, _ in _serve_one_at_a_time(gw_b, PROMPTS)]
    finally:
        gw_b.shutdown(drain=False)
    got = {}
    for name, serve_mod, model in (("port", tserve, tm),
                                   ("ref", jserve, jm)):
        reg = serve_mod.ModelRegistry(total_pages=40)
        reg.add("gpt", model, prefill_replicas=1, decode_replicas=1,
                max_slots=2, max_len=64)
        gw = serve_mod.Gateway(reg)
        try:
            m = gw._models["gpt"]
            assert [r.role for r in m.replicas] == ["prefill", "decode"]
            assert (m.replicas[1].slots.allocator.usable_pages
                    > m.replicas[0].slots.allocator.usable_pages)
            got[name] = _serve_one_at_a_time(gw, PROMPTS)
            if name != "port":
                continue
            p0, b0 = tdisagg.migration_counts("gpt")
            programs = gw.xla_program_counts(per_replica=True)
            for i, (p, n) in enumerate(PROMPTS):
                h = gw.submit("gpt", _prompt(p.size, seed=50 + i), n)
                gw._drive_until([h], timeout=120.0)
                assert h.state == "done"
            assert gw.xla_program_counts(per_replica=True) == programs
            p1, b1 = tdisagg.migration_counts("gpt")
            assert p1 - p0 == sum(-(-p.size // 16) for p, _ in PROMPTS)
            assert b1 - b0 == (p1 - p0) * m.replicas[0].slots.page_bytes
            assert tdisagg.decode_prefill_families(gw, "gpt") == {}
            assert not m.replicas[1].slots._buckets_seen
            assert m.replicas[0].slots._buckets_seen
        finally:
            gw.shutdown(drain=False)
    assert [t for t, _ in got["port"]] == base
    assert [t for t, _ in got["port"]] == [t for t, _ in got["ref"]]
    assert all(r == "gpt#1" for _, r in got["port"])


def test_copy_pages_moves_whole_pages_bit_for_bit(pair):
    """`copy_pages_out` then `copy_pages_in` between two engines of one
    model: the destination pages equal the source pages bit for bit, in
    every layer's K and V (and int8's scales); the write is in place (the
    same tensors before and after); a kv_dtype mismatch raises."""
    _, tm = pair
    for kv in ("fp", "int8"):
        src = tserve.SlotDecoder(tm, max_slots=2, max_len=64, kv_dtype=kv)
        dst = tserve.SlotDecoder(tm, max_slots=2, max_len=64, kv_dtype=kv)
        src.set_slot_pages(0, [3, 5])
        src.prefill_chunk_step(0, _prompt(20), 0, (0, 0))
        dst._ensure_pool()
        leaves = list(dst._pool_leaves())
        dst.copy_pages_in([7, 2], src.copy_pages_out([3, 5]))
        assert all(a is b for a, b in zip(leaves, dst._pool_leaves()))
        for name in ("_pk", "_pv", "_sk", "_sv"):
            s_l, d_l = getattr(src, name), getattr(dst, name)
            if s_l is None:
                assert d_l is None
                continue
            for s, d in zip(s_l, d_l):
                assert torch.equal(d[[7, 2]], s[[3, 5]])
                assert not torch.equal(s[3], torch.zeros_like(s[3]))
    fp = tserve.SlotDecoder(tm, max_slots=2, max_len=64, kv_dtype="fp")
    i8 = tserve.SlotDecoder(tm, max_slots=2, max_len=64, kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        fp.copy_pages_in([1], i8.copy_pages_out([1]))
    with pytest.raises(ValueError, match="kv_dtype"):
        i8.copy_pages_in([1], fp.copy_pages_out([1]))


def test_page_migration_fault_on_real_engines_no_leak(pair):
    """The ``page_migration`` seam on a real pod: the request finishes
    co-located on its prefill replica with the one-replica pod's tokens,
    nothing moved, the decode pool untouched, every page back after
    shutdown; the anatomy record is flagged migration-free."""
    _, tm = pair
    reg = tserve.ModelRegistry(total_pages=40)
    reg.add("gpt", tm, prefill_replicas=1, decode_replicas=1, max_slots=2,
            max_len=64)
    gw = tserve.Gateway(reg)
    tanatomy.enable()
    try:
        m = gw._models["gpt"]
        p0, _ = tdisagg.migration_counts("gpt")
        tinjection.configure_injection("page_migration:1.0:0:1")
        h = gw.submit("gpt", PROMPTS[0][0], PROMPTS[0][1])
        gw._drive_until([h], timeout=120.0)
        tinjection.clear_injection()
        assert h.state == "done" and h.replica == "gpt#0"
        assert tdisagg.migration_counts("gpt")[0] == p0
        dec = m.replicas[1].slots.allocator
        assert dec.free_pages == dec.usable_pages
        assert "migrated" not in h._anatomy.flags
        reg_b = tserve.ModelRegistry(total_pages=40)
        reg_b.add("gpt", tm, max_slots=2, max_len=64)
        gw_b = tserve.Gateway(reg_b)
        try:
            assert [t for t, _ in _serve_one_at_a_time(
                gw_b, PROMPTS[:1])] == [list(h.tokens)]
        finally:
            gw_b.shutdown(drain=False)
    finally:
        tinjection.clear_injection()
        tanatomy.disable()
        tanatomy.reset()
        gw.shutdown(drain=False)
    for rep in gw._models["gpt"].replicas:
        assert rep.slots.allocator.used_pages == 0
