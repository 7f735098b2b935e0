"""The port's serving gateway (`incubator_mxnet_tpu_torch.serve.gateway`,
`tenancy`, `router`) against the JAX package's, on the CPU.

- the tenancy primitives give the same pop order, bucket levels and tier
  parsing in both packages;
- the gateway-logic tests of `tests/test_gateway.py` (:185-470, against a
  stub decoder of pure host arithmetic over each package's own page
  allocator and prefix cache) run as cases of both packages: tier-ordered
  dispatch, preemption that keeps tokens and re-queues the remaining
  work, the deadline-while-preempted classification, quotas that defer,
  the labeled queue-depth gauges, the ``gateway_step`` fault seam, the
  spans of one request joining one trace, the flight recorder's gateway
  context, shutdown;
- two `gpt_tiny` models (the scaled weights of `tests/test_serve.py`,
  carried across with `load_jax_params`) behind both gateways on one
  seeded `tools/loadgen.synth_trace`: greedy tokens equal request by
  request, every request finished, program counts flat after the
  warm-up, and the acceptance test's deterministic preemption episode.
"""
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import fault as jfault
from incubator_mxnet_tpu import np as jnp_
from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.fault import retry as jretry
from incubator_mxnet_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from incubator_mxnet_tpu.serve import scheduler as jsched
from incubator_mxnet_tpu.serve import tenancy as jtenancy
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu.telemetry import tracing as jtracing
from incubator_mxnet_tpu_torch import fault as tfault
from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.fault import retry as tretry
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.serve import router as trouter
from incubator_mxnet_tpu_torch.serve import scheduler as tsched
from incubator_mxnet_tpu_torch.serve import tenancy as ttenancy
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry
from incubator_mxnet_tpu_torch.telemetry import slo as tslo
from incubator_mxnet_tpu_torch.telemetry import tracing as ttracing

VOCAB = 97

PKGS = {
    "ref": SimpleNamespace(serve=jserve, sched=jsched, tenancy=jtenancy,
                           registry=jregistry, tracing=jtracing,
                           fault=jfault, retry=jretry),
    "port": SimpleNamespace(serve=tserve, sched=tsched, tenancy=ttenancy,
                            registry=tregistry, tracing=ttracing,
                            fault=tfault, retry=tretry),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture()
def traced(pkg):
    pkg.tracing.enable()
    yield pkg
    pkg.tracing.disable()
    pkg.tracing.reset()


# ---------------------------------------------------------------------------
# tenancy primitives: both packages, same sequences
# ---------------------------------------------------------------------------

def _pop_order(tenancy, pushes, weights, cost, can=lambda r: True,
               quantum=10):
    q = tenancy.WDRRQueue(quantum=quantum)
    for tenant, item in pushes:
        q.push(tenant, item)
    out = []
    while True:
        got = q.pop_next(weights, cost, can)
        if got is None:
            return out, q.items()
        out.append(got)


@pytest.mark.parametrize("case", ["weighted", "skewed_costs", "deferred",
                                  "three_tenants"])
def test_wdrr_pop_order_equals_reference(case):
    """The same pushes, weights, costs and deferrals pop in the same order
    in both packages (`tests/test_gateway.py:84-130`'s queue, widened)."""
    r = onp.random.RandomState(len(case))
    if case == "weighted":
        pushes = [("a", ("a", i)) for i in range(6)] + \
            [("b", ("b", i)) for i in range(3)]
        args = ({"a": 2.0, "b": 1.0}, lambda it: 40.0)
    elif case == "skewed_costs":
        pushes = [(t, (t, i)) for i in range(8) for t in ("x", "y")]
        costs = {it: float(r.randint(1, 60)) for _, it in pushes}
        args = ({"x": 1.0, "y": 3.0}, costs.__getitem__)
    elif case == "deferred":
        pushes = [(t, (t, i)) for i in range(4) for t in ("p", "q", "s")]
        args = ({"q": 2.0}, lambda it: 12.0,
                lambda it: not (it[0] == "q" and it[1] == 1))
    else:
        pushes = [(t, (t, i)) for i in range(10)
                  for t in ("acme", "beta", "crawl")
                  if r.rand() < 0.7]
        costs = {it: float(r.randint(4, 300)) for _, it in pushes}
        args = ({"acme": 3.0, "beta": 2.0, "crawl": 1.0},
                costs.__getitem__)
    got = _pop_order(ttenancy, pushes, *args)
    ref = _pop_order(jtenancy, pushes, *args)
    assert got == ref
    assert got[0]


def test_tiers_quota_and_bucket_equal_reference():
    for spec in (None, "", "gold, silver ,bronze", "x,y"):
        assert ttenancy.parse_tiers(spec) == jtenancy.parse_tiers(spec)
    for spec in ("a,,b", "a,b,a"):
        for tenancy in (ttenancy, jtenancy):
            with pytest.raises(ValueError):
                tenancy.parse_tiers(spec)
    for spec in (None, "", "0", "100", "100:50", "2.5"):
        assert ttenancy.parse_quota(spec) == jtenancy.parse_quota(spec)
    tb, jb = ttenancy.TokenBucket(10.0, 20.0), jtenancy.TokenBucket(10.0,
                                                                    20.0)
    for now, n in ((0.0, 15.0), (0.0, 10.0), (1.0, 10.0), (1.5, 3.0),
                   (1.6, 30.0), (4.0, 19.0)):
        assert tb.try_debit(n, now) == jb.try_debit(n, now)
        assert tb.level(now) == jb.level(now)
    tb.credit(7.0)
    jb.credit(7.0)
    assert tb.level(4.0) == jb.level(4.0)
    assert ttenancy.TokenBucket(None).level(0.0) is None
    with pytest.raises(ValueError):
        ttenancy.Tenant("t", weight=0.0)


def test_router_scores_and_picks_equal_reference():
    """`ReplicaRouter` host scoring on stub replicas of both packages:
    least-loaded, prefix affinity, tenant hashing, the two disaggregated
    stages; `replica_meshes` carves the same slices as the reference's."""
    def reps(pkg, roles):
        out = []
        for i, role in enumerate(roles):
            slots = _StubSlots(pkg)
            slots.allocator.alloc(i)             # replica i: i pages used
            sched = pkg.sched.Scheduler(slots)
            for j in range(i % 2):               # a queue on odd ones
                sched.submit(_prompt(4, seed=j), 2)
            out.append(SimpleNamespace(slots=slots, sched=sched, role=role,
                                       draining=False))
        return out

    warm = _prompt(40, seed=5)
    for roles in (("both",) * 3, ("prefill", "decode", "decode")):
        picks = []
        for pkg, router_mod in ((PKGS["port"], trouter),
                                (PKGS["ref"], jserve.router)):
            rs = reps(pkg, roles)
            rs[2].slots.prefix_cache.register(
                warm, rs[2].slots.allocator.alloc(2))
            out = []
            for aff in ("prefix", "tenant", "off"):
                rt = router_mod.ReplicaRouter(affinity=aff)
                out.append([round(rt.load_score(r), 9) for r in rs])
                out.append(rs.index(rt.pick(rs, prompt=warm,
                                            tenant="acme")))
                out.append(rs.index(rt.pick_prefill(rs)))
                out.append(rs.index(rt.pick_decode(rs, prompt=warm)))
            picks.append(out)
        assert picks[0] == picks[1]
    # the world's ranks (one here) carved as the reference carves its
    # devices: consecutive disjoint slices, the same error when short
    meshes = trouter.replica_meshes("tp=2", 2, devices=range(4))
    jmeshes = jserve.router.replica_meshes("tp=2", 2)
    assert [m.devices.tolist() for m in meshes] == [[0, 1], [2, 3]]
    assert [[d.id for d in m.devices.flat] for m in jmeshes] == [[0, 1],
                                                                 [2, 3]]
    with pytest.raises(ValueError, match="need 8 devices, have 1"):
        trouter.replica_meshes("tp=4", 2)


# ---------------------------------------------------------------------------
# gateway logic against a stub decoder, both packages
# ---------------------------------------------------------------------------

class _StubSlots:
    """The paged interface in host arithmetic over a package's real
    allocator and prefix cache (`tests/test_gateway.py:137`): the final
    prefill chunk emits the prompt's length, decode increments, so a
    request preempted mid-decode and resumed from ``prompt + tokens``
    continues the same run."""

    def __init__(self, pkg, max_slots=2, max_len=64, page_tokens=16,
                 prefill_chunk=64, n_pages=None):
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_tokens = page_tokens
        self.prefill_chunk = prefill_chunk
        pages_per_slot = -(-max_len // page_tokens)
        self.allocator = pkg.serve.PageAllocator(
            n_pages or max_slots * pages_per_slot + 1, page_tokens)
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


def _stub_gateway(pkg, max_slots=2, **gw_kwargs):
    reg = pkg.serve.ModelRegistry()
    reg.add("m", _StubSlots(pkg, max_slots=max_slots))
    return pkg.serve.Gateway(reg, **gw_kwargs)


def test_gateway_constructor_validation(pkg):
    with pytest.raises(TypeError):
        pkg.serve.Gateway(object())
    with pytest.raises(ValueError):
        pkg.serve.Gateway(pkg.serve.ModelRegistry())
    reg = pkg.serve.ModelRegistry()
    reg.add("m", _StubSlots(pkg))
    with pytest.raises(ValueError):
        reg.add("m", _StubSlots(pkg))
    with pytest.raises(ValueError):
        reg.add("m2", _StubSlots(pkg), share=0.0)
    reg2 = pkg.serve.ModelRegistry()
    reg2.add("m", _StubSlots(pkg), max_slots=4)
    with pytest.raises(ValueError) as ei:
        pkg.serve.Gateway(reg2)
    assert "pre-built" in str(ei.value)


def test_gateway_not_ported_parts_raise_naming_the_roadmap():
    """The parts that once raised naming their `ROADMAP.md` item now run:
    ``mesh=`` is registered and carved into replica meshes at
    construction (refused loudly when the world cannot seat them), and
    the elastic controller and the advisor arm: `enable_elastic` returns the controller, and ``MXNET_ADVISOR`` /
    ``MXNET_ELASTIC_SERVE`` arm the advisor and the controller at
    construction (the reference's knobs)."""
    from incubator_mxnet_tpu_torch.serve.advisor import AutoscaleAdvisor
    from incubator_mxnet_tpu_torch.serve.elastic import ReplicaSetController
    from incubator_mxnet_tpu_torch.telemetry import timeseries

    reg = tserve.ModelRegistry()
    # mesh= is taken, and carved at construction: a world of one rank
    # cannot seat two
    reg.add("mesh", _StubSlots(PKGS["port"]), mesh="tp=2")
    assert reg._specs["mesh"][4] == "tp=2"
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tserve.Gateway(reg)
    reg = tserve.ModelRegistry()
    reg.add("m", _StubSlots(PKGS["port"]))
    gw = tserve.Gateway(reg)
    assert isinstance(gw.enable_elastic(), ReplicaSetController)
    assert gw.advisor_log() == []
    try:
        for knob in ("MXNET_ADVISOR", "MXNET_ELASTIC_SERVE"):
            os.environ[knob] = "1"
            try:
                gw = _stub_gateway(PKGS["port"])
            finally:
                del os.environ[knob]
            if knob == "MXNET_ADVISOR":
                assert isinstance(gw._advisors["m"], AutoscaleAdvisor)
                assert gw._advisor_period == 5.0
            else:
                assert isinstance(gw._elastic, ReplicaSetController)
    finally:
        timeseries.disable()
        timeseries.reset()


def test_registry_builds_engines_from_its_recipe():
    """`ModelRegistry.build_engine`: a fresh `SlotDecoder` from a model's
    registered recipe and a page count; pre-built entries have no recipe;
    a mesh builds a `ShardedSlotDecoder`."""
    reg = tserve.ModelRegistry(total_pages=40)
    reg.add("g", _tiny_port(0), max_slots=2, max_len=64)
    reg.add("s", _StubSlots(PKGS["port"]))
    eng = reg.build_engine("g", n_pages=reg.rebalance_pages("g", 2))
    assert isinstance(eng, tserve.SlotDecoder)
    assert eng.allocator.n_pages == 10 and eng.max_slots == 2   # 40 / 2 / 2
    with pytest.raises(ValueError, match="pre-built"):
        reg.build_engine("s")
    with pytest.raises(ValueError):
        reg.build_engine("nope")
    # a mesh builds the sharded engine: on a mesh of one (the front
    # alone) it serves the recipe's model
    sh = reg.build_engine("g", mesh=tserve.serve_mesh("tp=1"), n_pages=10)
    try:
        assert isinstance(sh, tserve.ShardedSlotDecoder)
        assert sh.allocator.n_pages == 10 and sh.max_slots == 2
        sched = tserve.Scheduler(sh)
        req = sched.submit(_prompt(5), 3)
        while not req.done:
            sched.step()
        assert len(req.result()) == 3
    finally:
        sh.release()


def test_gateway_custom_tiers_and_env_knobs(pkg, monkeypatch):
    gw = _stub_gateway(pkg, tiers="gold,bronze")
    assert gw.tiers == ("gold", "bronze")
    h = gw.submit("m", _prompt(4), 1)
    assert h.priority == "bronze"
    gw._drive_until([h], timeout=10)
    monkeypatch.setenv("MXNET_SERVE_PRIORITY_TIERS", "x,y,z")
    monkeypatch.setenv("MXNET_GATEWAY_PREEMPT", "0")
    gw2 = _stub_gateway(pkg)
    assert gw2.tiers == ("x", "y", "z")
    assert not gw2.preempt_enabled


def test_gateway_submit_validation(pkg):
    gw = _stub_gateway(pkg)
    with pytest.raises(ValueError):
        gw.submit("nope", _prompt(4), 2)
    with pytest.raises(ValueError):
        gw.submit("m", _prompt(4), 2, priority="vip")
    with pytest.raises(ValueError):
        gw.submit("m", onp.zeros((0,), onp.int32), 2)
    with pytest.raises(ValueError):
        gw.submit("m", _prompt(4), 0)
    with pytest.raises(ValueError):
        gw.submit("m", _prompt(60), 10)
    stub = _StubSlots(pkg, max_slots=1, n_pages=3)     # 2 usable pages
    reg = pkg.serve.ModelRegistry()
    reg.add("tiny", stub)
    gw2 = pkg.serve.Gateway(reg)
    with pytest.raises(pkg.serve.PagePoolExhausted):
        gw2.submit("tiny", _prompt(30), 10)


def test_gateway_queue_backpressure_raises(pkg):
    gw = _stub_gateway(pkg, max_queue=2)
    gw.submit("m", _prompt(4), 2)
    gw.submit("m", _prompt(5), 2)
    with pytest.raises(pkg.serve.QueueFull) as ei:
        gw.submit("m", _prompt(6), 2)
    assert "capacity" in str(ei.value)
    assert pkg.retry.classify_exception(ei.value) == "retryable"


def test_gateway_roundtrip_stub(pkg):
    gw = _stub_gateway(pkg)
    c = pkg.registry.counter("mx_gateway_dispatch_total",
                             labels={"model": "m", "priority": "normal"})
    d0 = c.value
    out = gw.generate("m", _prompt(4), 3, tenant="acme")
    assert list(out[-3:]) == [4, 5, 6]
    assert out.dtype == onp.int32 and out.shape == (7,)
    t = gw.tenant("acme")
    assert t.dispatched == 1 and t.tokens_out == 3
    assert c.value == d0 + 1


def test_priority_dispatch_order(pkg):
    gw = _stub_gateway(pkg, max_slots=1, preempt=False)
    a = gw.submit("m", _prompt(4), 4, priority="normal")
    gw.step()
    assert a.state == "dispatched"
    b = gw.submit("m", _prompt(5), 2, priority="low")
    c = gw.submit("m", _prompt(6), 2, priority="high")
    while not a.done:
        gw.step()
    gw.step()
    assert c.state in ("dispatched", "done") and b.state == "queued"
    gw._drive_until([b, c], timeout=10)
    assert b.result() == [5, 6] and c.result() == [6, 7]


def test_preemption_resumes_with_tokens_intact(pkg):
    gw = _stub_gateway(pkg, max_slots=1)
    low = gw.submit("m", _prompt(4), 8, tenant="crawl", priority="low")
    gw.step()
    assert low.state == "dispatched" and low.tokens == [4, 5]
    ev = pkg.registry.counter("mx_serve_evictions_total",
                              labels={"reason": "preempted"})
    ev0 = ev.value
    high = gw.submit("m", _prompt(6, seed=1), 3, tenant="acme",
                     priority="high")
    gw.step()
    assert low.state == "queued" and low.preemptions == 1
    assert low.tokens == [4, 5]
    assert high.state == "dispatched"
    assert gw.preemptions_total == 1
    assert gw.tenant("crawl").preempted == 1
    assert ev.value == ev0 + 1
    gw._drive_until([low, high], timeout=10)
    assert high.result() == [6, 7, 8]
    assert low.result() == list(range(4, 12))
    assert low.state == "done" and len(low.tokens) == low.max_new


def test_preempted_deadline_expiry_classifies_retryable(pkg):
    gw = _stub_gateway(pkg, max_slots=1)
    low = gw.submit("m", _prompt(4), 8, tenant="crawl", priority="low",
                    deadline_s=0.3)
    gw.step()
    high = gw.submit("m", _prompt(6, seed=1), 30, tenant="acme",
                     priority="high")
    gw.step()
    assert low.state == "queued" and low.preemptions == 1
    time.sleep(0.35)
    gw.step()
    assert low.state == "failed"
    assert isinstance(low.error, pkg.serve.DeadlineExceeded)
    assert not isinstance(low.error, pkg.serve.EngineClosed)
    assert low.error_class == "retryable"
    assert "preemption" in str(low.error)
    with pytest.raises(pkg.serve.DeadlineExceeded):
        low.result()
    gw._drive_until([high], timeout=10)
    assert len(high.tokens) == 30


def test_tenant_quota_defers_never_drops(pkg):
    gw = _stub_gateway(pkg, tenants={"q": {"rate": 40.0, "burst": 8.0}})
    r1 = gw.submit("m", _prompt(4), 4, tenant="q")
    r2 = gw.submit("m", _prompt(4), 4, tenant="q")
    free = gw.submit("m", _prompt(5), 2, tenant="free")
    gw.step()
    assert r1.state == "dispatched"
    assert free.state != "queued"
    assert r2.state == "queued"
    while not r1.done:
        gw.step()
    assert r2.state == "queued"
    time.sleep(0.25)
    gw.step()
    assert r2.state == "dispatched"
    gw._drive_until([r2, free], timeout=10)
    assert r2.result() == [4, 5, 6, 7]


def test_gateway_queue_depth_pull_gauge(pkg):
    gw = _stub_gateway(pkg)
    hs = [gw.submit("m", _prompt(4), 1, priority="high"),
          gw.submit("m", _prompt(5), 1, priority="high"),
          gw.submit("m", _prompt(6), 1, priority="low")]
    rep = pkg.registry.report()
    assert rep['mx_gateway_queue_depth{priority="high"}']["value"] == 2.0
    assert rep['mx_gateway_queue_depth{priority="normal"}']["value"] == 0.0
    assert rep['mx_gateway_queue_depth{priority="low"}']["value"] == 1.0
    gw._drive_until(hs, timeout=10)
    rep = pkg.registry.report()
    assert rep['mx_gateway_queue_depth{priority="high"}']["value"] == 0.0


def test_gateway_step_fault_seam(pkg):
    gw = _stub_gateway(pkg)
    gw.submit("m", _prompt(4), 2)
    pkg.fault.configure_injection("gateway_step:1.0:0:1")
    try:
        with pytest.raises(pkg.fault.FaultInjected):
            gw.step()
    finally:
        pkg.fault.clear_injection()
    gw.step()


def test_gateway_shutdown_drains_and_fails_queued(pkg):
    gw = _stub_gateway(pkg, max_slots=1)
    a = gw.submit("m", _prompt(4), 3)
    gw.step()
    b = gw.submit("m", _prompt(5), 3)
    gw.shutdown(drain=True, timeout=10)
    assert a.state == "done" and a.result() == [4, 5, 6]
    assert b.state == "failed" and isinstance(b.error,
                                              pkg.serve.EngineClosed)
    with pytest.raises(pkg.serve.EngineClosed):
        gw.submit("m", _prompt(4), 2)
    assert gw._models["m"].slots.allocator.used_pages == 0


def test_gateway_driver_thread_and_iter_tokens(pkg):
    gw = _stub_gateway(pkg).start()
    try:
        h = gw.submit("m", _prompt(6), 5, tenant="acme")
        assert list(gw.iter_tokens(h, timeout=10)) == [6, 7, 8, 9, 10]
    finally:
        gw.shutdown(drain=True, timeout=10)
    assert gw._driver is None


def test_gateway_spans_join_request_trace(traced):
    pkg = traced
    gw = _stub_gateway(pkg)
    h = gw.submit("m", _prompt(4), 2, tenant="acme", priority="high")
    gw._drive_until([h], timeout=10)
    spans = pkg.tracing.finished_spans(h.trace_id)
    names = [s.name for s in spans]
    assert {"gateway.request", "gateway.admit", "serve.request"} <= set(names)
    groot = next(s for s in spans if s.name == "gateway.request")
    sreq = next(s for s in spans if s.name == "serve.request")
    assert sreq.trace_id == groot.trace_id == h.trace_id
    assert groot.attrs["tenant"] == "acme"
    assert groot.attrs["priority"] == "high"
    assert groot.attrs["preemptions"] == 0


def test_gateway_preempted_trace_has_two_segments(traced):
    pkg = traced
    gw = _stub_gateway(pkg, max_slots=1)
    low = gw.submit("m", _prompt(4), 4, priority="low")
    gw.step()
    high = gw.submit("m", _prompt(6, seed=1), 2, priority="high")
    gw._drive_until([low, high], timeout=10)
    names = [s.name for s in pkg.tracing.finished_spans(low.trace_id)]
    assert names.count("gateway.admit") == 2
    assert names.count("serve.request") == 2
    groot = next(s for s in pkg.tracing.finished_spans(low.trace_id)
                 if s.name == "gateway.request")
    assert groot.attrs["preemptions"] == 1


def test_flight_dump_carries_gateway_context(traced, tmp_path):
    pkg = traced
    gw = _stub_gateway(pkg)
    gw.submit("m", _prompt(4), 2, tenant="acme", priority="high")
    path = pkg.tracing.flight_dump("gwtest", path=str(tmp_path / "f.json"))
    with open(path) as f:
        payload = json.load(f)
    ctx = payload["context"]["gateway"]
    assert ctx["tiers"] == {"high": 1, "normal": 0, "low": 0}
    assert ctx["queued"][0]["tenant"] == "acme"
    assert ctx["queued"][0]["priority"] == "high"
    assert ctx["closed"] is False and ctx["preemptions_total"] == 0


def test_gateway_step_failure_leaves_a_flight_dump(tmp_path, monkeypatch):
    """A step that raises (an injected ``gateway_step`` fault) writes the
    dump with the gateway's queue state and propagates."""
    ttracing.enable()
    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(tmp_path))
    try:
        gw = _stub_gateway(PKGS["port"])
        gw.submit("m", _prompt(4), 2, tenant="acme")
        tfault.configure_injection("gateway_step:1.0:0:1")
        with pytest.raises(tfault.FaultInjected):
            gw.step()
    finally:
        tfault.clear_injection()
        ttracing.disable()
        ttracing.reset()
    dumps = list(tmp_path.glob("flightrec_gateway_step_*.json"))
    assert len(dumps) == 1
    payload = json.loads(dumps[0].read_text())
    assert payload["error"]["type"] == "FaultInjected"
    assert payload["context"]["gateway"]["tiers"]["normal"] == 1


def test_hot_swap_recaptures_only_replaced_weights():
    """`hot_swap` a replica at a time: an in-place update is no change (the
    graphs read weights by address); a replaced weight tensor is, and the
    replica's next step runs over the new weights."""
    import torch

    m = _tiny_port(3)
    reg = tserve.ModelRegistry()
    reg.add("g", m, max_slots=2, max_len=64)
    gw = tserve.Gateway(reg)
    try:
        gw.generate("g", _prompt(5), 3)
        assert gw.hot_swap() == {"g": False}
        with torch.no_grad():
            m.blocks[0].attn.proj.weight.data()._data.mul_(1.0)
        assert gw.hot_swap("g") == {"g": False}
        w = m.blocks[0].attn.proj.weight.data()._data
        m.blocks[0].attn.proj.weight = torch.nn.Parameter(w.detach() * 0.5)
        assert gw.hot_swap("g") == {"g": True}
        with pytest.raises(ValueError):
            gw.hot_swap("nope")
        out = gw.generate("g", _prompt(5), 3)
        ref = tserve.ServeEngine(m, max_slots=2, max_len=64)
        onp.testing.assert_array_equal(out, ref.generate(_prompt(5), 3))
        ref.shutdown()
    finally:
        gw.shutdown(drain=False)


# ---------------------------------------------------------------------------
# real engines: two gpt_tiny models behind both gateways
# ---------------------------------------------------------------------------

def _loadgen():
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    try:
        import loadgen
    finally:
        sys.path.pop(0)
    return loadgen


def _spicy_jax(weight_seed):
    """`tests/test_gateway.py:498`'s model: scaled normal weights."""
    jmx.random.seed(11)
    m = jax_gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0)
    m.initialize()
    r = onp.random.RandomState(weight_seed)
    for _name, p in m.collect_params().items():
        if p.shape and len(p.shape) >= 2:
            p.set_data(jnp_.array(r.normal(0, 0.35, p.shape)
                                  .astype("float32")))
    return m


def _tiny_port(seed):
    return gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0,
                    device="cpu", seed=seed)


@pytest.fixture(scope="module")
def models():
    """{name: (JAX model, port model)} with the same weights."""
    out = {}
    for name, seed in (("gpt-a", 42), ("gpt-b", 43)):
        jm = _spicy_jax(seed)
        tm = _tiny_port(0)
        tm.load_jax_params({n: p.data().asnumpy()
                            for n, p in jm.collect_params().items()})
        out[name] = (jm, tm)
    return out


def _gateways(models, total_pages=40):
    gws = []
    for i, serve_mod in enumerate((tserve, jserve)):
        reg = serve_mod.ModelRegistry(total_pages=total_pages)
        reg.add("gpt-a", models["gpt-a"][1 - i], share=2.0, max_slots=2,
                max_len=64)
        reg.add("gpt-b", models["gpt-b"][1 - i], share=1.0, max_slots=2,
                max_len=64)
        gws.append(serve_mod.Gateway(reg, tenants={
            "acme": {"weight": 3.0}, "beta": {"weight": 2.0},
            "crawl": {"weight": 1.0}}))
    return gws


def test_two_models_on_a_seeded_trace_match_the_jax_gateway(models):
    """The acceptance run of `tests/test_gateway.py:508`, on both
    gateways: the page budget split 2:1, a warm-up of every chunk bucket,
    a seeded three-tenant, three-tier `synth_trace` submitted in arrival
    order, and the deterministic episode (two low requests fill gpt-a's
    slots, a high one preempts one of them, both lows finish their 20
    tokens). Greedy tokens equal request by request; nothing fails; the
    port's program counts stay flat after the warm-up; the high tier's
    TTFT SLO view is fed."""
    loadgen = _loadgen()
    gws = _gateways(models)
    obj = tslo.gateway_ttft("high", threshold_s=30.0, target=0.9,
                            name="gw_port_high")
    try:
        for gw in gws:
            assert (gw._models["gpt-a"].slots.allocator.usable_pages
                    > gw._models["gpt-b"].slots.allocator.usable_pages)
        assert ([gws[0]._models[n].slots.allocator.usable_pages
                 for n in ("gpt-a", "gpt-b")]
                == [gws[1]._models[n].slots.allocator.usable_pages
                    for n in ("gpt-a", "gpt-b")])
        for gw in gws:
            for name in ("gpt-a", "gpt-b"):
                for n in (5, 20, 40):
                    gw.generate(name, _prompt(n, seed=n), 2)
        warm = gws[0].xla_program_counts()
        assert all(c >= 2 for c in warm.values())
        events = loadgen.synth_trace(
            16, models={"gpt-a": 2.0, "gpt-b": 1.0},
            tenants={"acme": (1.5, "high"), "beta": (1.5, "normal"),
                     "crawl": (3.0, "low")},
            seed=7, duration_s=0.6, burst_factor=8.0, prompt_max=40,
            max_new_range=(3, 8))
        toks = []
        for gw in gws:
            hs = [gw.submit(e.model, loadgen._prompt_for(e, VOCAB),
                            e.max_new, tenant=e.tenant, priority=e.priority)
                  for e in events]
            gw._drive_until(hs, timeout=300.0)
            assert all(h.state == "done" for h in hs)
            toks.append([list(h.tokens) for h in hs])
        assert toks[0] == toks[1]
        # the deterministic contention episode
        episode = []
        for gw in gws:
            pre0 = gw.preemptions_total
            lows = [gw.submit("gpt-a", _prompt(6, seed=70 + i), 20,
                              tenant="crawl", priority="low")
                    for i in range(2)]
            while not all(r.tokens for r in lows):
                gw.step()
            high = gw.submit("gpt-a", _prompt(8, seed=99), 4,
                             tenant="acme", priority="high")
            gw.step()
            assert gw.preemptions_total == pre0 + 1
            gw._drive_until(lows + [high], timeout=300.0)
            assert high.state == "done" and len(high.tokens) == 4
            assert [r for r in lows if r.preemptions]
            for r in lows:
                assert r.state == "done" and len(r.tokens) == 20
            episode.append([list(r.tokens) for r in lows + [high]])
        assert episode[0] == episode[1]
        assert gws[0].xla_program_counts() == warm
        res = obj.evaluate()
        assert res["compliance"] is not None
    finally:
        tslo.tracker().remove("gw_port_high")
        for gw in gws:
            gw.shutdown(drain=False)
    for name in ("gpt-a", "gpt-b"):
        assert gws[0]._models[name].slots.allocator.used_pages == 0


def test_replicas_share_the_card_and_route_by_prefix(models):
    """``replicas=2`` on one device: two engines over one model, the page
    cut split evenly, a prompt that warmed one replica routed back to it,
    and tokens equal to the JAX gateway's two-replica run."""
    outs = []
    for i, serve_mod in enumerate((tserve, jserve)):
        reg = serve_mod.ModelRegistry(total_pages=40)
        reg.add("g", models["gpt-a"][1 - i], replicas=2, max_slots=2,
                max_len=64)
        gw = serve_mod.Gateway(reg)
        try:
            m = gw._models["g"]
            assert [r.label for r in m.replicas] == ["g#0", "g#1"]
            assert all(r.slots.allocator.n_pages == 20 for r in m.replicas)
            system = _prompt(32, seed=4)
            first = gw.submit("g", system, 3)
            gw._drive_until([first], timeout=120.0)
            again = gw.submit("g", onp.concatenate([system, _prompt(3)]), 3)
            gw._drive_until([again], timeout=120.0)
            assert again.replica == first.replica
            outs.append((list(first.tokens), list(again.tokens)))
        finally:
            gw.shutdown(drain=False)
    assert outs[0] == outs[1]


def test_scheduler_preempt_takes_the_references_now(models):
    """`Scheduler.preempt(slot, now)`, the call the gateway makes
    (reference `serve/gateway.py:1142`), on both engines."""
    for i, serve_mod in enumerate((tserve, jserve)):
        eng = serve_mod.ServeEngine(models["gpt-b"][1 - i], max_slots=2,
                                    max_len=64)
        try:
            h = eng.submit(_prompt(20), 6)
            sched = eng._sched
            while not h.tokens:
                eng.step()
            req = sched.preempt(h.slot, time.monotonic())
            assert req is h and h.state == "preempted"
            assert sched.n_active == 0
        finally:
            eng.shutdown(drain=False)
