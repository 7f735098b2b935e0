"""The port's span tracing, flight recorder and SLO tracker
(`incubator_mxnet_tpu_torch.telemetry.tracing`, `slo`) against the JAX
package's, on the CPU: `tests/test_tracing.py`'s host-only tests as cases
of both packages (span nesting and ids, spans across threads, explicit
lifecycle and the ring bound, error annotation, the Chrome export's lanes
and clock base, the off path recording nothing, the serve request trace
over a stub scheduler, a deadline failure annotated, the flight recorder
off and on, SLO burn math, throughput windows, presets, retry events),
and the real engines: the port's `gpt_tiny` `ServeEngine` with tracing on
gives the JAX engine's tokens, every request a complete trace, the
program count flat; an injected ``serve_step`` fault leaves a dump with
the in-flight spans and the engine's pages come back.
"""
import json
import threading
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
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu.telemetry import slo as jslo
from incubator_mxnet_tpu.telemetry import tracing as jtracing
from incubator_mxnet_tpu_torch import fault as tfault
from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch import util as tutil
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.fault import retry as tretry
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.serve import scheduler as tsched
from incubator_mxnet_tpu_torch.telemetry import locks as tlocks
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry
from incubator_mxnet_tpu_torch.telemetry import slo as tslo
from incubator_mxnet_tpu_torch.telemetry import tracing as ttracing

VOCAB = 97

PKGS = {
    "ref": SimpleNamespace(tracing=jtracing, slo=jslo, registry=jregistry,
                           serve=jserve, sched=jsched, fault=jfault,
                           retry=jretry),
    "port": SimpleNamespace(tracing=ttracing, slo=tslo, registry=tregistry,
                            serve=tserve, sched=tsched, fault=tfault,
                            retry=tretry),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    yield p
    p.tracing.disable()
    p.tracing.reset()
    p.slo.tracker().clear()
    p.fault.clear_injection()


def _names(pkg, trace_id=None):
    return [s.name for s in pkg.tracing.finished_spans(trace_id)]


def test_span_nesting_and_ids(pkg):
    tr = pkg.tracing
    tr.enable()
    with tr.span("outer", kind="t") as outer:
        assert tr.current_span() is outer
        assert tr.current_trace_id() == outer.trace_id
        with tr.span("inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
            assert inner.span_id != outer.span_id
            inner.event("mark", n=1)
    assert tr.current_span() is None
    spans = tr.finished_spans(outer.trace_id)
    assert [s.name for s in spans] == ["outer", "inner"]
    assert all(s.dur_ns is not None and s.dur_ns >= 0 for s in spans)
    assert spans[1].events and spans[1].events[0][0] == "mark"
    with tr.span("other") as other:
        pass
    assert other.trace_id != outer.trace_id
    tracer = tr.Tracer()
    assert tracer.enabled
    with tracer.start_span("facade", parent=other) as f:
        pass
    assert f.trace_id == other.trace_id and f.parent_id == other.span_id
    g = tracer.open_span("facade.open")
    assert g in tr.open_spans() and g.close() is g


def test_spans_across_threads_join_one_trace(pkg):
    tr = pkg.tracing
    tr.enable()
    root = tr.open_span("request", lane="req 0")

    def worker():
        with tr.span("work", parent=root):
            pass

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    root.close()
    spans = tr.finished_spans(root.trace_id)
    assert len(spans) == 5
    kids = [s for s in spans if s.name == "work"]
    assert all(s.parent_id == root.span_id for s in kids)
    assert len({s.span_id for s in spans}) == 5
    assert all(s.lane == "req 0" for s in kids)


def test_open_span_explicit_lifecycle_and_ring_bound(pkg):
    tr = pkg.tracing
    tr.enable()
    s = tr.open_span("explicit")
    assert s in tr.open_spans()
    assert tr.current_span() is None
    s.close()
    s.close()
    assert s not in tr.open_spans()
    for _ in range(tr.RING_CAPACITY + 50):
        with tr.span("burst"):
            pass
    assert len([x for x in tr.finished_spans()
                if x.name == "burst"]) <= tr.RING_CAPACITY


def test_error_annotation_on_exception(pkg):
    pkg.tracing.enable()
    with pytest.raises(ValueError):
        with pkg.tracing.span("boom") as s:
            raise ValueError("kaput")
    assert s.attrs["error"] == "ValueError"
    assert "kaput" in s.attrs["error_msg"]


def test_chrome_export_lanes_and_clock_base(pkg, tmp_path):
    tr = pkg.tracing
    tr.enable()
    t_before = time.time() * 1e6
    with tr.span("laned", lane="req 7", foo="bar"):
        tr.event("tick")
    ev = tr.chrome_events()
    xs = [e for e in ev if e["ph"] == "X"]
    assert len(xs) == 1 and xs[0]["name"] == "laned"
    assert xs[0]["args"]["foo"] == "bar"
    assert t_before <= xs[0]["ts"] <= time.time() * 1e6
    names = [e for e in ev if e["ph"] == "M" and e["name"] == "thread_name"]
    assert any(m["args"]["name"] == "req 7" for m in names)
    assert any(e["ph"] == "i" and e["name"] == "tick" for e in ev)
    payload = tr.chrome_trace(include_device=True)
    assert {e["name"] for e in payload["traceEvents"]} >= {"laned", "tick"}
    path = tr.dump_chrome(str(tmp_path / "t.json"))
    assert json.loads(open(path).read())["traceEvents"]


def test_port_device_lanes_are_the_empty_list():
    """Before any device trace completes (and always on a machine with
    no CUDA device), the port's device-lane hook, `profiler`'s device
    events, is the list the reference has then: empty, so the export
    with ``include_device=True`` equals the host-only one."""
    ttracing.enable()
    try:
        with ttracing.span("x"):
            pass
        assert ttracing.device_events() == []
        a = ttracing.chrome_trace(include_device=True)["traceEvents"]
        b = ttracing.chrome_trace(include_device=False)["traceEvents"]
        assert [e["name"] for e in a] == [e["name"] for e in b]
    finally:
        ttracing.disable()
        ttracing.reset()


def test_off_path_records_nothing(pkg):
    tr = pkg.tracing
    assert not tr.is_enabled()
    tr.reset()
    with tr.span("ghost", attr=1) as s:
        tr.event("ghost-event")
        tr.annotate(x=2)
    assert not s
    assert s is tr.open_span("ghost")
    assert tr.finished_spans() == []
    assert tr.maybe_flight_dump("nope") is None


class _StubSlots:
    """The paged interface in host arithmetic over a package's allocator
    (`tests/test_tracing.py:196`)."""

    max_slots, max_len = 2, 64
    page_tokens, prefill_chunk = 16, 64

    def __init__(self, pkg):
        pages = -(-self.max_len // self.page_tokens)
        self.allocator = pkg.serve.PageAllocator(
            self.max_slots * pages + 1, self.page_tokens)
        self.prefix_cache = pkg.serve.PrefixCache(self.allocator)

    def set_slot_pages(self, slot, pages):
        pass

    def clear_slot(self, slot):
        pass

    def prefill_chunk_step(self, slot, chunk_tokens, t_start, key,
                           temperature=1.0):
        n = len(chunk_tokens)
        return int(t_start) + n, n, 0

    def decode_step(self, last, pos, active, key, temps):
        return onp.where(active, last + 1, last).astype(onp.int32)

    def xla_program_count(self):
        return 0

    def release(self):
        pass


def _prompt(n, seed=0):
    return onp.random.RandomState(seed).randint(
        0, VOCAB, (n,)).astype(onp.int32)


def test_serve_request_trace_stub(pkg):
    pkg.tracing.enable()
    sched = pkg.sched.Scheduler(_StubSlots(pkg), max_queue=16)
    reqs = [sched.submit(_prompt(4 + i, seed=i), 3) for i in range(5)]
    while not all(r.done for r in reqs):
        sched.step()
    for r in reqs:
        assert r.trace_id is not None
        assert sorted(_names(pkg, r.trace_id)) == [
            "serve.decode", "serve.prefill", "serve.queue", "serve.request"]
        root = [s for s in pkg.tracing.finished_spans(r.trace_id)
                if s.name == "serve.request"][0]
        assert root.attrs["tokens"] == 3
        assert root.attrs["reason"] == "length"
        assert root.lane == f"req {r.id}"
    assert len({r.trace_id for r in reqs}) == len(reqs)
    assert "serve.step" in _names(pkg)
    assert "serve.decode_step" in _names(pkg)


def test_serve_trace_deadline_failure_annotated(pkg):
    pkg.tracing.enable()
    sched = pkg.sched.Scheduler(_StubSlots(pkg), max_queue=8)
    req = sched.submit(_prompt(4), 4, deadline_s=0.0)
    time.sleep(0.005)
    sched.step()
    assert req.state == "failed"
    assert req.error_class == "retryable"
    root = [s for s in pkg.tracing.finished_spans(req.trace_id)
            if s.name == "serve.request"][0]
    assert root.attrs["error"] == pkg.serve.DeadlineExceeded.__name__
    names = _names(pkg, req.trace_id)
    assert "serve.queue" in names and "serve.prefill" not in names


def test_submit_joins_a_parent_span_and_carries_the_tenant(pkg):
    """`Scheduler.submit(parent_span=, tenant=, prefill_only=)`, the
    reference's :343-345: the engine's root joins the caller's trace, the
    tenant rides on the request, a prefill-only request hands off."""
    pkg.tracing.enable()
    sched = pkg.sched.Scheduler(_StubSlots(pkg), max_queue=8)
    parent = pkg.tracing.open_span("caller")
    req = sched.submit(_prompt(20), 5, parent_span=parent, tenant="acme",
                       prefill_only=True)
    assert req.tenant == "acme" and req.trace_id == parent.trace_id
    while not sched.idle:
        sched.step()
    (seg,) = sched.take_prefilled()
    assert seg is req and req.state == "prefilled"
    assert req.tokens == [20] and req.first_token == 20
    assert len(req.pages) == 2
    sched.slots.allocator.decref(req.pages)
    req.pages = None
    sched.finish_handoff(req)
    parent.close()
    assert req.state == "migrated"
    names = _names(pkg, parent.trace_id)
    assert {"caller", "serve.request", "serve.prefill"} <= set(names)


def test_flight_dump_carries_context_and_schedule(pkg, tmp_path):
    tr = pkg.tracing
    tr.enable()
    tr.register_flight_context("t_ctx", lambda: {"queued": 3})
    tr.register_flight_context("t_none", lambda: None)
    pkg.fault.configure_injection("serve_step:0.5:3")
    with tr.span("done"):
        pass
    root = tr.open_span("in.flight", request=9)
    path = tr.flight_dump("t", path=str(tmp_path / "d.json"))
    root.close()
    payload = json.loads(open(path).read())
    assert payload["reason"] == "t"
    assert payload["context"]["t_ctx"] == {"queued": 3}
    assert "t_none" not in payload["context"]
    assert payload["fault_schedule"]["serve_step"]["prob"] == 0.5
    assert [s["name"] for s in payload["open_spans"]] == ["in.flight"]
    assert "done" in [s["name"] for s in payload["spans"]]


def test_slo_latency_burn_math(pkg):
    reg, slo = pkg.registry, pkg.slo
    h = reg.histogram("t_torch_slo_ttft_seconds", buckets=(0.1, 0.5, 1.0))
    for _ in range(96):
        h.observe(0.05)
    for _ in range(4):
        h.observe(0.7)
    r = slo.tracker().latency("lat90", "t_torch_slo_ttft_seconds", 0.1,
                              target=0.90).evaluate()
    assert r["compliance"] == pytest.approx(0.96)
    assert r["burn"] == pytest.approx(0.4)
    assert r["ok"]
    r2 = slo.tracker().latency("lat99", "t_torch_slo_ttft_seconds", 0.1,
                               target=0.99).evaluate()
    assert r2["burn"] == pytest.approx(4.0)
    assert not r2["ok"]
    rep = reg.report()
    assert rep['mx_slo_error_budget_burn{slo="lat99"}']["value"] \
        == pytest.approx(4.0)
    assert rep['mx_slo_ok{slo="lat99"}']["value"] == 0
    assert rep['mx_slo_ok{slo="lat90"}']["value"] == 1
    r3 = slo.tracker().latency("lat_empty", "t_torch_slo_never_seen",
                               0.1).evaluate()
    assert r3["compliance"] is None and r3["ok"]
    with pytest.raises(Exception, match="lat99"):
        slo.check()


def test_slo_throughput_and_gauge_windows(pkg):
    reg, slo = pkg.registry, pkg.slo
    c = reg.counter("t_torch_slo_tokens_total")
    s = slo.tracker().throughput("tput", "t_torch_slo_tokens_total",
                                 min_rate=100.0, target=0.5)
    # The virtual windows precede `_measure`'s own `time.monotonic()` window
    # on any host, however short its uptime.
    now = time.monotonic() - 100.0
    s.observe_window(now)
    c.inc(500)
    now += 1.0
    assert s.observe_window(now) == pytest.approx(500.0)
    c.inc(10)
    now += 1.0
    s.observe_window(now)
    comp, detail = s._measure()
    assert detail["windows"] == 3 and detail["good"] == 1
    assert comp == pytest.approx(1 / 3)
    g = reg.gauge("t_torch_slo_depth")
    gs = slo.tracker().gauge_max("depth", "t_torch_slo_depth", 4.0,
                                 target=0.5)
    for v in (1.0, 9.0, 2.0):
        g.set(v)
        res = gs.evaluate()
    assert res["compliance"] == pytest.approx(2 / 3) and res["ok"]


def test_slo_presets_register(pkg):
    slo = pkg.slo
    a = slo.serve_ttft(threshold_s=0.25)
    b = slo.step_time(threshold_s=1.0)
    c = slo.gateway_ttft("high", threshold_s=0.5)
    assert a.series == "mx_serve_ttft_seconds"
    assert b.series == "mx_step_time_seconds"
    assert c.labels == {"priority": "high"} and c.name == "gateway_ttft_high"
    assert {"serve_ttft", "step_time",
            "gateway_ttft_high"} <= {s.name for s in slo.tracker().slos()}
    with pytest.raises(ValueError):
        slo.serve_ttft()


def test_slo_health_hook_needs_the_monitor():
    """`install_health_check` registers the default tracker with
    `telemetry.monitor` in both packages: `monitor.check()` then raises
    `MXNetError` on a burning objective, as the reference's does."""
    from incubator_mxnet_tpu.telemetry import monitor as jmonitor
    from incubator_mxnet_tpu_torch.telemetry import monitor as tmonitor

    for reg, slo, monitor in ((jregistry, jslo, jmonitor),
                              (tregistry, tslo, tmonitor)):
        assert slo.install_health_check() is slo.tracker()
        assert "slo" in monitor._HEALTH_CHECKS
        h = reg.histogram("t_torch_slo_health_seconds",
                          buckets=(0.1, 0.5, 1.0))
        for _ in range(10):
            h.observe(0.7)
        slo.tracker().latency("health_burn", "t_torch_slo_health_seconds",
                              0.1, target=0.99)
        try:
            with pytest.raises(MXNetError if slo is tslo else jmx.MXNetError,
                               match="health_burn"):
                monitor.check()
        finally:
            monitor.remove_health_check("slo")
            slo.tracker().remove("health_burn")
        assert "slo" not in monitor._HEALTH_CHECKS


def test_retry_events_annotate_span(pkg):
    pkg.tracing.enable()
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise ConnectionError("transient")
        return "ok"

    with pkg.tracing.span("op") as s:
        out = pkg.retry.RetryPolicy(max_retries=3, base_delay=0.0,
                                    jitter=0.0, name="test").call(flaky)
    assert out == "ok"
    retries = [e for e in s.events if e[0] == "retry"]
    assert len(retries) == 2 and retries[0][2]["policy"] == "test"


def test_mxnet_telemetry_env_arms_tracing_and_the_lock_witness(monkeypatch):
    """``MXNET_TELEMETRY=1`` arms span tracing and the lock witness (and,
    since the program ledger, the census and the goodput ledger are
    ported, those three too: the test disarms whatever it armed)."""
    from incubator_mxnet_tpu_torch.telemetry import compiles, goodput, hbm

    assert not ttracing.is_enabled()
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    was = tlocks.is_enabled()
    others = [(m, m.is_enabled()) for m in (compiles, goodput, hbm)]
    tutil._apply_env_config()
    try:
        assert ttracing.is_enabled() and tlocks.is_enabled()
        assert all(m.is_enabled() for m, _ in others)
        lk = tlocks.tracked_lock("t.env_lock", kind="lock")
        assert isinstance(lk, tlocks.TrackedLock)
    finally:
        ttracing.disable()
        if not was:
            tlocks.disable()
        for m, on in others:
            if not on:
                m.disable()


# ---------------------------------------------------------------------------
# the lock witness
# ---------------------------------------------------------------------------

def test_tracked_locks_witness_order_inversion_and_contention():
    """Armed, `tracked_lock` hands out instrumented locks: a pair taken in
    both orders is one RC005 inversion, the order graph holds both edges,
    the contention table counts acquisitions; disarmed it hands out the
    raw primitive (the reference's behaviour, `telemetry/locks.py`)."""
    tlocks.reset()
    raw = tlocks.tracked_lock("t.raw", kind="lock")
    assert not isinstance(raw, tlocks.TrackedLock)
    tlocks.enable()
    try:
        a = tlocks.tracked_lock("t.a", kind="lock")
        b = tlocks.tracked_lock("t.b")
        cond = tlocks.tracked_lock("t.c", kind="condition")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        with cond:
            cond.notify_all()
            assert cond.wait_for(lambda: True, timeout=0.01)
        inv = tlocks.inversions()
        assert len(inv) == 1 and inv[0]["rule"] == "RC005"
        assert {("t.a", "t.b"), ("t.b", "t.a")} <= set(tlocks.order_graph())
        table = tlocks.contention_table()
        assert table["t.a"]["acquisitions"] >= 2
        assert "t.a" in tlocks.known_locks()
        assert tlocks.tracked_lock("t.a").__repr__().startswith(
            "<TrackedLock 't.a#2'")
        with pytest.raises(ValueError):
            tlocks.tracked_lock("t.bad", kind="nope")
    finally:
        tlocks.disable()
        tlocks.reset()


# ---------------------------------------------------------------------------
# real engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
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


def test_traced_engine_tokens_equal_the_jax_engine(pair):
    """`tests/test_tracing.py:300` on the port, against the JAX engine:
    warm up untraced, then 6 requests traced: tokens equal to the JAX
    engine's (also traced), every request the four lifecycle spans with
    the prefill's bucket and chunks annotated, the program count the
    untraced warm-up's."""
    jm, tm = pair
    prompts = [_prompt(int(onp.random.RandomState(i).randint(3, 18)),
                       seed=i) for i in range(6)]
    outs = []
    for pkg, model in ((PKGS["port"], tm), (PKGS["ref"], jm)):
        eng = pkg.serve.ServeEngine(model, max_slots=3, max_len=64,
                                    max_queue=32)
        try:
            eng.generate(_prompt(5, seed=9), 3)
            eng.generate(onp.resize(_prompt(5, seed=9), 40), 3)
            warm = eng.xla_program_count()
            pkg.tracing.enable()
            handles = [eng.submit(p, 4) for p in prompts]
            eng._drive_until(handles)
            for h in handles:
                assert h.error is None
                assert sorted(_names(pkg, h.trace_id)) == [
                    "serve.decode", "serve.prefill", "serve.queue",
                    "serve.request"]
                prefill = [s for s in pkg.tracing.finished_spans(h.trace_id)
                           if s.name == "serve.prefill"][0]
                assert prefill.attrs["bucket"] in (16, 32, 64)
                assert prefill.attrs["chunks"] >= 1
            assert eng.xla_program_count() == warm
            outs.append([list(h.tokens) for h in handles])
        finally:
            pkg.tracing.disable()
            pkg.tracing.reset()
            eng.shutdown(drain=False)
    assert outs[0] == outs[1]


def test_flight_recorder_on_injected_serve_fault(pair, tmp_path,
                                                 monkeypatch):
    """`tests/test_tracing.py:345` on the port: an injected ``serve_step``
    fault raises `FaultInjected` from ``step()``, leaves a dump with the
    queued request's open spans, the fired schedule and the fault event;
    the next clean step serves the request and its pages come back."""
    _, tm = pair
    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(tmp_path))
    ttracing.enable()
    eng = tserve.ServeEngine(tm, max_slots=2, max_len=64, max_queue=8)
    try:
        req = eng.submit(_prompt(6, seed=3), 4)
        tfault.configure_injection("serve_step:1.0:0:1")
        with pytest.raises(tfault.FaultInjected):
            eng.step()
        tfault.clear_injection()
        dumps = list(tmp_path.glob("flightrec_serve_step_*.json"))
        assert len(dumps) == 1
        payload = json.loads(dumps[0].read_text())
        assert payload["error"]["type"] == "FaultInjected"
        assert payload["fault_schedule"]["serve_step"]["fired"] == 1
        open_names = {s["name"] for s in payload["open_spans"]}
        assert {"serve.request", "serve.queue"} <= open_names
        assert any(s["attrs"].get("request") == req.id
                   for s in payload["open_spans"]
                   if s["name"] == "serve.request")
        events = [ev for s in payload["spans"] for ev in s["events"]]
        assert any(ev["name"] == "fault.injected"
                   and ev["attrs"].get("seam") == "serve_step"
                   for ev in events)
        eng._drive_until([req])
        assert req.error is None and len(req.tokens) == 4
    finally:
        tfault.clear_injection()
        ttracing.disable()
        ttracing.reset()
        eng.shutdown(drain=False)
    assert eng._sched.slots.allocator.used_pages == 0
