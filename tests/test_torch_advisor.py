"""The port's autoscale advisor (`incubator_mxnet_tpu_torch.serve.advisor`)
against the JAX package's, on the CPU: the advisor tests of
`tests/test_capacity_observatory.py` (:556-698) and `tests/test_anatomy.py`
(:378) as cases of both packages (fixture `pkg`), and the decision log
equal record by record between the packages on the same virtual-time
history — the seeded diurnal day included.
"""
import os
import sys
from types import SimpleNamespace

import numpy as onp
import pytest

from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.serve import advisor as jadvisor
from incubator_mxnet_tpu.telemetry import anatomy as janatomy
from incubator_mxnet_tpu.telemetry import burnrate as jburnrate
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu.telemetry import timeseries as jtimeseries
from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch.serve import advisor as tadvisor
from incubator_mxnet_tpu_torch.telemetry import anatomy as tanatomy
from incubator_mxnet_tpu_torch.telemetry import burnrate as tburnrate
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry
from incubator_mxnet_tpu_torch.telemetry import timeseries as ttimeseries

VOCAB = 97
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "ref": SimpleNamespace(serve=jserve, advisor=jadvisor,
                           anatomy=janatomy, burnrate=jburnrate,
                           registry=jregistry, timeseries=jtimeseries),
    "port": SimpleNamespace(serve=tserve, advisor=tadvisor,
                            anatomy=tanatomy, burnrate=tburnrate,
                            registry=tregistry, timeseries=ttimeseries),
}


def _clean(p):
    p.timeseries.disable()
    p.timeseries.reset()
    p.burnrate.clear()
    p.anatomy.disable()
    p.anatomy.reset()
    p.registry.reset()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    _clean(p)
    yield p
    _clean(p)


def _loadgen():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import loadgen
    finally:
        sys.path.pop(0)
    return loadgen


def _burn_series(pkg, slo="t"):
    return pkg.registry.gauge("mx_slo_error_budget_burn",
                              "error-budget burn", labels={"slo": slo})


def _drive_signals(pkg, adv, occ, queue, burn_g, burn, t):
    pkg.registry.gauge("mx_serve_slot_occupancy", "occ").set(occ)
    pkg.registry.gauge("mx_gateway_queue_depth", "depth",
                       labels={"priority": "normal"}).set(queue)
    burn_g.set(burn)
    pkg.timeseries.sample_now(now=t)
    pkg.burnrate.evaluate_all(now=t)
    return adv.evaluate(now=t)


def test_advisor_holds_without_history(pkg):
    pkg.timeseries.enable(interval_s=1.0, samples=64, thread=False)
    rec = pkg.advisor.AutoscaleAdvisor("m").evaluate(now=0.0)
    assert rec["action"] == "hold"
    assert "no history" in rec["reason"]


def test_advisor_scale_up_names_evidence(pkg):
    pkg.timeseries.enable(interval_s=1.0, samples=256, thread=False)
    burn_g = _burn_series(pkg)
    adv = pkg.advisor.AutoscaleAdvisor("m", fast_window_s=10.0,
                                       slow_window_s=30.0)
    t = 0.0
    for _ in range(30):
        rec = _drive_signals(pkg, adv, 0.95, 4.0, burn_g, 0.1, t)
        t += 1.0
    assert rec["action"] == "scale_up" and rec["n"] == 1
    assert "mx_serve_slot_occupancy" in rec["reason"]
    assert "mx_gateway_queue_depth" in rec["reason"]
    assert rec["evidence"]["alerts_firing"] == []
    for _ in range(30):              # a flash-burst queue doubles the ask
        rec = _drive_signals(pkg, adv, 0.99, 40.0, burn_g, 0.1, t)
        t += 1.0
    assert rec["action"] == "scale_up" and rec["n"] == 2


def test_advisor_burn_alert_forces_scale_up(pkg):
    pkg.timeseries.enable(interval_s=1.0, samples=256, thread=False)
    burn_g = _burn_series(pkg)
    pkg.burnrate.add("burn_t", "t", windows=((10.0, 5.0),))
    adv = pkg.advisor.AutoscaleAdvisor("m")
    for i in range(20):
        rec = _drive_signals(pkg, adv, 0.1, 0.0, burn_g, 50.0, float(i))
    assert rec["action"] == "scale_up"
    assert "burn_t" in rec["reason"]


def test_advisor_scale_down_respects_cooldown(pkg):
    pkg.timeseries.enable(interval_s=1.0, samples=1024, thread=False)
    burn_g = _burn_series(pkg)
    adv = pkg.advisor.AutoscaleAdvisor("m", fast_window_s=10.0,
                                       slow_window_s=30.0, cooldown_s=100.0,
                                       log_len=2048)
    t = 0.0
    for _ in range(40):
        _drive_signals(pkg, adv, 0.95, 4.0, burn_g, 0.1, t)
        t += 1.0
    for _ in range(60):
        rec = _drive_signals(pkg, adv, 0.05, 0.0, burn_g, 0.1, t)
        t += 1.0
        if t - 40.0 <= 100.0:
            assert rec["action"] != "scale_down", (t, rec)
    for _ in range(60):
        rec = _drive_signals(pkg, adv, 0.05, 0.0, burn_g, 0.1, t)
        t += 1.0
    assert rec["action"] == "scale_down"
    assert "cooldown" not in rec["reason"]
    # the consume surface: the newest non-hold record, strictly newer
    assert adv.pending_action()["action"] == "scale_down"
    assert adv.pending_action(since_t=t) is None


def _diurnal_day(pkg):
    """The seeded diurnal day of `test_advisor_diurnal_trace_sequence_
    deterministic` (`tests/test_capacity_observatory.py:618`) through a
    host-side queue model on a virtual clock. Returns (advisor, per-segment
    actions)."""
    loadgen = _loadgen()
    events, segments = loadgen.diurnal_trace(
        models={"m": 1.0},
        tenants={"acme": (2.0, "normal"), "beta": (1.0, "normal")},
        seed=7, trough_s=300.0, steady_s=300.0, surge_s=300.0,
        burst_s=120.0, trough_rate=0.2, steady_rate=2.0,
        surge_rate=12.0, burst_rate=60.0)
    assert [s[0] for s in segments] == ["trough", "steady", "surge",
                                       "burst"]
    pkg.timeseries.enable(interval_s=5.0, samples=2048, thread=False)
    burn_g = _burn_series(pkg)
    adv = pkg.advisor.AutoscaleAdvisor(
        "m", up_occupancy=0.85, down_occupancy=0.25, fast_window_s=60.0,
        slow_window_s=300.0, cooldown_s=120.0, burst_queue=16, log_len=4096)
    cap_rps, dt = 4.0, 5.0
    arrivals = sorted(e.t for e in events)
    i, backlog, t = 0, 0.0, 0.0
    seg_actions = {name: [] for name, _s, _e in segments}
    end = segments[-1][2]
    while t < end:
        n_arr = 0
        while i < len(arrivals) and arrivals[i] < t + dt:
            n_arr += 1
            i += 1
        served = cap_rps * dt
        demand = backlog + n_arr
        backlog = max(0.0, demand - served)
        occ = min(1.0, demand / served)
        burn = 20.0 if backlog > 30 else (0.5 if occ < 0.9 else 3.0)
        rec = _drive_signals(pkg, adv, occ, backlog, burn_g, burn, t)
        for name, s, e in segments:
            if s <= t < e:
                seg_actions[name].append(rec["action"])
        t += dt
    return adv, seg_actions


def test_advisor_diurnal_trace_sequence_deterministic(pkg):
    adv, seg_actions = _diurnal_day(pkg)
    assert "scale_down" in seg_actions["trough"]
    assert "scale_up" not in seg_actions["trough"]
    steady = seg_actions["steady"]
    first_hold = steady.index("hold")
    assert set(steady[first_hold:]) == {"hold"}, steady
    assert "scale_up" not in steady
    assert "scale_up" in seg_actions["surge"]
    assert "scale_down" not in seg_actions["surge"]
    assert "scale_up" in seg_actions["burst"]
    assert adv.recommendations() in (
        ["hold", "scale_down", "hold", "scale_up"],
        ["scale_down", "hold", "scale_up"]), adv.recommendations()
    rep = pkg.registry.report()
    assert rep['mx_advisor_recommendation{action="scale_up"}'][
        "value"] == 1


def test_advisor_decision_log_equal_record_by_record():
    """The same diurnal day through both packages: the decision logs are
    equal record by record (time, action, n, reason, evidence)."""
    logs = {}
    for name, p in sorted(PKGS.items()):
        _clean(p)
        adv, _ = _diurnal_day(p)
        logs[name] = adv.decision_log()
        _clean(p)
    assert len(logs["port"]) == len(logs["ref"]) > 100
    for a, b in zip(logs["port"], logs["ref"]):
        assert a == b


def test_advisor_scale_up_refined_by_role_residency(pkg):
    rs = "mx_replica_residency_seconds_total"
    assert pkg.advisor.RESIDENCY_SERIES == rs
    pkg.anatomy.enable()         # the residency ledger is armed
    pkg.timeseries.enable(interval_s=1.0, samples=64, thread=False)
    adv = pkg.advisor.AutoscaleAdvisor("m", fast_window_s=8.0)
    pkg.registry.gauge("mx_serve_slot_occupancy", "occ").set(0.95)
    pkg.registry.gauge("mx_gateway_queue_depth", "depth",
                       labels={"priority": "normal"}).set(4)
    for t in range(1, 9):
        pkg.timeseries.sample_now(now=float(t))
    pkg.anatomy.charge_replica("m#0", "prefill", "prefill", 7.0, now=8.0)
    pkg.anatomy.charge_replica("m#1", "decode", "decode", 2.0, now=3.0)
    rec = adv.evaluate(now=8.0)
    assert rec["action"] == "scale_up_prefill"
    assert rs in rec["reason"]
    assert rec["evidence"][f"{rs} busy[prefill]"] == pytest.approx(1.0)
    pkg.anatomy.reset()
    pkg.anatomy.charge_replica("m#0", "both", "decode", 1.0, now=8.0)
    rec = adv.evaluate(now=8.5)
    assert rec["action"] == "scale_up"
    assert rs not in rec["reason"]


class _StubSlots:
    """The paged interface in host arithmetic over a package's allocator
    (`tests/test_capacity_observatory.py:367`)."""

    def __init__(self, pkg, max_slots=2, max_len=64, page_tokens=16,
                 prefill_chunk=64):
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_tokens = page_tokens
        self.prefill_chunk = prefill_chunk
        self.allocator = pkg.serve.PageAllocator(
            max_slots * -(-max_len // page_tokens) + 1, page_tokens)
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


def test_advisor_gateway_arming_via_env(pkg, monkeypatch):
    monkeypatch.setenv("MXNET_ADVISOR", "0.0")   # evaluate every step
    reg = pkg.serve.ModelRegistry()
    reg.add("m", _StubSlots(pkg))
    gw = pkg.serve.Gateway(reg)
    assert set(gw._advisors) == {"m"}
    assert pkg.timeseries.is_enabled()
    h = gw.submit("m", onp.arange(8, dtype=onp.int32), 4, tenant="acme")
    gw._drive_until([h], timeout=30)
    log = gw.advisor_log()
    assert log and all(r["model"] == "m" for r in log)
    assert gw.advisor_log(tail=1)[0] == log[-1]
    gw.shutdown(drain=False)
