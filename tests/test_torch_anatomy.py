"""The port's request anatomy and replica residency
(`incubator_mxnet_tpu_torch.telemetry.anatomy`) against the JAX
package's, on the CPU: `tests/test_anatomy.py`'s host tests as cases of
both packages — the sum-to-wall invariant (2% residual) of plain,
preempted, migrated and speculative requests through a stub gateway, the
tail-sampling truth table, the archive bound, the report and waterfall,
the disarmed dead branch, the residency fractions, and the migration and
warm-up windows (`on_migration`, `warmup_begin`/`warmup_end`) — with the
same virtual-clock records giving the same states in both; and the real
engines: on a disaggregated `gpt_tiny` pod a migrated request's states
sum to its wall, with handoff and prefill and decode compute nonzero,
and the decode replica's residency is decode-dominated.
"""
from types import SimpleNamespace

import numpy as onp
import pytest

from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.fault import injection as jinjection
from incubator_mxnet_tpu.telemetry import anatomy as janatomy
from incubator_mxnet_tpu.telemetry import capacity as jcapacity
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch.fault import injection as tinjection
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.telemetry import anatomy as tanatomy
from incubator_mxnet_tpu_torch.telemetry import capacity as tcapacity
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry

VOCAB = 97

PKGS = {
    "ref": SimpleNamespace(serve=jserve, anatomy=janatomy,
                           capacity=jcapacity, registry=jregistry,
                           injection=jinjection),
    "port": SimpleNamespace(serve=tserve, anatomy=tanatomy,
                            capacity=tcapacity, registry=tregistry,
                            injection=tinjection),
}


def _arm(p):
    p.injection.clear_injection()
    p.anatomy.reset()
    p.anatomy.enable()
    p.anatomy.set_sample(1.0)


def _disarm(p):
    p.anatomy.disable()
    p.anatomy.reset()
    p.anatomy.set_sample(0.05)
    p.injection.clear_injection()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    _arm(p)
    yield p
    _disarm(p)


@pytest.fixture()
def both():
    for p in PKGS.values():
        _arm(p)
    yield PKGS
    for p in PKGS.values():
        _disarm(p)


class _StubSlots:
    """`tests/test_anatomy.py:54`'s stand-in over a package's allocator."""

    def __init__(self, pkg, max_slots=2, max_len=64, page_tokens=16,
                 prefill_chunk=64, n_pages=None):
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_tokens = page_tokens
        self.prefill_chunk = prefill_chunk
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


class _SpecStubSlots(_StubSlots):
    """Drafts the right next token, then a wrong one: every round accepts
    1 of k = 2 (`tests/test_anatomy.py:91`)."""

    spec_k = 2
    draft_kind = "ngram"

    def spec_propose(self, seqs):
        drafts = onp.zeros((self.max_slots, self.spec_k), onp.int32)
        for s, seq in enumerate(seqs):
            if seq is not None:
                drafts[s, 0] = int(seq[-1]) + 1
        return drafts

    def spec_verify_step(self, last, drafts, pos, active, limit):
        out = onp.zeros((self.max_slots, self.spec_k + 1), onp.int32)
        for s in range(self.max_slots):
            for i in range(self.spec_k + 1):
                out[s, i] = int(last[s]) + 1 + i
        return out

    def spec_count(self, k, accepted):
        pass


def _prompt(n, seed=0):
    return onp.random.RandomState(seed).randint(
        0, VOCAB, (n,)).astype(onp.int32)


def _stub_gateway(pkg, max_slots=2, slots_cls=_StubSlots, **gw_kwargs):
    reg = pkg.serve.ModelRegistry()
    reg.add("m", slots_cls(pkg, max_slots=max_slots))
    return pkg.serve.Gateway(reg, **gw_kwargs)


def _drive(gw, handles, steps=400):
    for _ in range(steps):
        gw.step()
        if all(h.done for h in handles):
            return
    raise AssertionError(f"requests not done: {[h.state for h in handles]}")


def _gate(rec, tol=0.02):
    assert rec is not None and rec.wall_s > 0
    assert abs(rec.residual_s) <= tol * rec.wall_s, (rec.residual_s,
                                                     rec.wall_s, rec.states)
    assert all(v >= 0.0 for v in rec.states.values()), rec.states


def test_plain_requests_sum_to_wall(pkg):
    gw = _stub_gateway(pkg)
    try:
        hs = [gw.submit("m", _prompt(4 + i, seed=i), 4) for i in range(3)]
        _drive(gw, hs)
    finally:
        gw.shutdown(drain=False)
    for h in hs:
        rec = h._anatomy
        _gate(rec)
        assert rec.outcome == "ok"
        assert rec.states["decode_compute"] > 0.0
        assert rec.states["prefill_compute"] > 0.0
        assert rec.states["preempted"] == 0.0
        assert not rec.flags
    assert {r["id"] for r in pkg.anatomy.archive()} >= {h.id for h in hs}


def test_preempted_request_charges_requeued_wall(pkg):
    gw = _stub_gateway(pkg, max_slots=1)
    try:
        low = gw.submit("m", _prompt(4), 8, tenant="crawl", priority="low")
        gw.step()
        high = gw.submit("m", _prompt(6, seed=1), 3, tenant="acme",
                         priority="high")
        gw.step()
        assert low.state == "queued" and low.preemptions == 1
        _drive(gw, [low, high])
    finally:
        gw.shutdown(drain=False)
    rec = low._anatomy
    _gate(rec)
    assert "preempted" in rec.flags and rec.states["preempted"] > 0.0
    assert rec.resumes == 1
    _gate(high._anatomy)
    assert "preempted" not in high._anatomy.flags


def test_disagg_migrated_request_sums_to_wall(pkg):
    stubs = [_StubSlots(pkg), _StubSlots(pkg)]
    reg = pkg.serve.ModelRegistry()
    reg.add("m", stubs, prefill_replicas=1, decode_replicas=1)
    gw = pkg.serve.Gateway(reg)
    try:
        hs = [gw.submit("m", _prompt(5 + i, seed=i), 4) for i in range(2)]
        _drive(gw, hs)
    finally:
        gw.shutdown(drain=False)
    for h in hs:
        rec = h._anatomy
        _gate(rec)
        assert "migrated" in rec.flags
        assert rec.states["handoff_migration"] > 0.0
    assert {r["id"] for r in pkg.anatomy.archive()} >= {h.id for h in hs}
    res = pkg.anatomy.residency_report()
    assert res["m#1"]["role"] == "decode"
    assert res["m#1"]["states"]["migration"] > 0.0
    assert res["m#0"]["states"].get("decode", 0.0) == 0.0


def test_spec_decode_round_carves_overhead(pkg):
    gw = _stub_gateway(pkg, slots_cls=_SpecStubSlots)
    try:
        h = gw.submit("m", _prompt(4), 6)
        _drive(gw, [h])
    finally:
        gw.shutdown(drain=False)
    rec = h._anatomy
    _gate(rec)
    assert rec.states["spec_overhead"] > 0.0
    assert h.tokens == list(range(4, 10))


def test_standalone_engine_owns_its_records():
    """A bare `ServeEngine` request (no gateway) gets an engine-owned
    record: dispatched at admission, completed at retirement, summing to
    its wall."""
    _arm(PKGS["port"])
    m = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0,
                 device="cpu", seed=0)
    eng = tserve.ServeEngine(m, max_slots=2, max_len=64)
    try:
        h = eng.submit(_prompt(9), 4)
        eng._drive_until([h])
        rec = h.anatomy
        assert rec.owner == "engine" and rec.outcome == "ok"
        _gate(rec)
        assert rec.states["prefill_compute"] > 0.0
        assert rec.states["decode_compute"] > 0.0
    finally:
        eng.shutdown(drain=False)
        _disarm(PKGS["port"])


def _fake_request(anatomy, i, now, outcome="ok", flag=None):
    rec = anatomy.begin(i, "t", "m", "normal", now)
    rec.dispatched(now + 0.01, "m#0")
    rec.carve("prefill_compute", 0.004)
    rec.prefill_done(now + 0.02)
    if flag is not None:
        rec.requeued(now + 0.03, flag)
        rec.dispatched(now + 0.04, "m#0")
        rec.prefill_done(now + 0.05)
    rec.carve("spec_overhead", 0.01)
    anatomy.complete(rec, now + 0.1, outcome)
    return rec


def test_virtual_clock_records_equal_reference(both):
    """The same seam calls at the same virtual times give the same states,
    flags, archive and report in both packages."""
    outs = []
    for p in (both["port"], both["ref"]):
        p.anatomy.set_sample(0.5)
        recs = [_fake_request(p.anatomy, i, float(i), outcome=o, flag=f)
                for i, (o, f) in enumerate([
                    ("ok", None), ("expired", None), ("ok", "preempted"),
                    ("ok", "migration_fallback"), ("ok", None),
                    ("ok", "crash_resume"), ("ok", None), ("ok", None)])]
        p.anatomy.charge_replica("m#0", "prefill", "prefill", 0.5, now=1.0)
        p.anatomy.charge_replica("m#1", "decode", "decode", 2.0, now=4.0)
        rep = p.anatomy.report(now=5.0)
        outs.append((
            [(r.snapshot()["states"], sorted(r.flags), r.resumes)
             for r in recs],
            [r["id"] for r in p.anatomy.archive()],
            rep["states"], rep["requests_completed"], rep["archive_depth"],
            {k: v["frac"] for k, v in rep["replicas"].items()},
            [p.anatomy.format_waterfall(r) for r in p.anatomy.archive()]))
    assert outs[0] == outs[1]


def test_tail_sampling_truth_table(pkg):
    an = pkg.anatomy
    an.set_sample(0.0)
    _fake_request(an, 0, 0.0)
    _fake_request(an, 1, 1.0, outcome="expired")
    _fake_request(an, 2, 2.0, flag="preempted")
    _fake_request(an, 3, 3.0, flag="migration_fallback")
    _fake_request(an, 4, 4.0, flag="crash_resume")
    _fake_request(an, 5, 5.0)
    assert {r["id"] for r in an.archive()} == {1, 2, 3, 4}
    an.set_sample(1.0)
    _fake_request(an, 6, 6.0)
    assert 6 in {r["id"] for r in an.archive()}
    an.reset()
    an.set_sample(0.5)
    for i in range(6):
        _fake_request(an, i, float(i))
    assert len(an.archive()) == 3


def test_archive_ring_is_bounded(pkg):
    an = pkg.anatomy
    an.set_ring(4)
    try:
        for i in range(10):
            _fake_request(an, i, float(i), flag="preempted")
        assert [r["id"] for r in an.archive()] == [6, 7, 8, 9]
    finally:
        an.set_ring(256)


def test_disarmed_begin_returns_none_and_seams_noop(pkg):
    an = pkg.anatomy
    an.disable()
    assert an.begin(0, "t", "m", "normal", 0.0) is None
    an.charge_replica("m#0", "decode", "decode", 1.0, now=1.0)
    an.on_migration(None, 0.0, 1.0)
    assert an.warmup_begin(None) is None
    an.warmup_end(None, None)
    assert an.residency_report(now=2.0) == {}
    an.complete(None, 1.0, "ok")
    assert an.archive() == []
    gw = _stub_gateway(pkg)
    try:
        h = gw.submit("m", _prompt(4), 3)
        _drive(gw, [h])
    finally:
        gw.shutdown(drain=False)
    assert h._anatomy is None
    assert h.result() == [4, 5, 6]


def test_residency_counters_and_fractions(pkg):
    an = pkg.anatomy
    an.charge_replica("r#0", "prefill", "prefill", 8.0, now=9.0)
    an.charge_replica("r#1", "decode", "decode", 2.0, now=4.0)
    an.charge_replica("r#1", "decode", "migration", 0.5, now=4.5)
    rep = an.residency_report(now=10.0)
    r0, r1 = rep["r#0"], rep["r#1"]
    assert r0["frac"]["prefill"] == pytest.approx(8.0 / 9.0)
    assert r0["frac"]["idle"] == pytest.approx(1.0 / 9.0)
    assert r1["frac"]["idle"] == pytest.approx(
        1.0 - r1["frac"]["decode"] - r1["frac"]["migration"])
    c = pkg.registry.report()[
        'mx_replica_residency_seconds_total'
        '{replica="r#0",role="prefill",state="prefill"}']
    assert c["value"] >= 8.0


def test_migration_and_warmup_windows(pkg):
    """`on_migration` charges the adopting replica's migration residency;
    a warm-up window charges its wall less what the seams inside it
    already charged."""
    an = pkg.anatomy
    sched = SimpleNamespace(anatomy_replica=("w#1", "decode"))
    an.on_migration(sched, 1.0, 1.25, now=10.0)
    tok = an.warmup_begin(sched)
    an.charge_replica("w#1", "decode", "decode", 0.0)
    an.warmup_end(sched, tok)
    res = an.residency_report()["w#1"]
    assert res["role"] == "decode"
    assert res["states"]["migration"] == pytest.approx(0.25)
    assert res["states"]["warmup"] >= 0.0
    assert an._sched_replica(SimpleNamespace(capacity_model="gm")) == \
        ("gm", "both")


def test_real_engine_disagg_anatomy_gate():
    """`tests/test_anatomy.py:430` on the port's gpt_tiny pod."""
    p = PKGS["port"]
    _arm(p)
    net = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0,
                   device="cpu", seed=0)
    reg = tserve.ModelRegistry(total_pages=40)
    reg.add("gpt", net, prefill_replicas=1, decode_replicas=1, max_slots=2,
            max_len=64)
    gw = tserve.Gateway(reg)
    try:
        hs = []
        for i, (n, new) in enumerate([(21, 6), (7, 8)]):
            h = gw.submit("gpt", _prompt(n, seed=1 + i), new)
            gw._drive_until([h], timeout=120.0)
            hs.append(h)
        for h in hs:
            assert h.replica == "gpt#1"
            rec = h._anatomy
            _gate(rec)
            assert "migrated" in rec.flags
            for s in ("handoff_migration", "prefill_compute",
                      "decode_compute"):
                assert rec.states[s] > 0.0, s
        res = tanatomy.residency_report()
        dec = res["gpt#1"]
        assert dec["role"] == "decode"
        active = {s: dec["states"].get(s, 0.0)
                  for s in ("prefill", "decode", "migration", "warmup")}
        assert active["decode"] == max(active.values())
        assert active["prefill"] == 0.0
        assert res["gpt#0"]["states"].get("decode", 0.0) == 0.0
    finally:
        gw.shutdown(drain=False)
        _disarm(p)
