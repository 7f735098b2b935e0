"""The port's multi-window burn-rate alerts (`incubator_mxnet_tpu_torch.
telemetry.burnrate`) against the JAX package's, on the CPU: the burn-rate
tests of `tests/test_capacity_observatory.py` (:239-360) as cases of both
packages (fixture `pkg`) — the fast window catching a flash burst, the
slow window a slow leak, hysteresis at the boundary, a steady trace that
never flaps, unknown history freezing the state, the window spec and
`arm_default` — plus the same burn history giving the same transitions
and the same flight-recorder block in both.
"""
from types import SimpleNamespace

import numpy as onp
import pytest

from incubator_mxnet_tpu.telemetry import burnrate as jburnrate
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu.telemetry import slo as jslo
from incubator_mxnet_tpu.telemetry import timeseries as jtimeseries
from incubator_mxnet_tpu_torch.telemetry import burnrate as tburnrate
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry
from incubator_mxnet_tpu_torch.telemetry import slo as tslo
from incubator_mxnet_tpu_torch.telemetry import timeseries as ttimeseries
from incubator_mxnet_tpu_torch.telemetry import tracing as ttracing

PKGS = {
    "ref": SimpleNamespace(registry=jregistry, timeseries=jtimeseries,
                           burnrate=jburnrate, slo=jslo),
    "port": SimpleNamespace(registry=tregistry, timeseries=ttimeseries,
                            burnrate=tburnrate, slo=tslo),
}


def _clean(p):
    p.timeseries.disable()
    p.timeseries.reset()
    p.burnrate.clear()
    p.registry.reset()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    _clean(p)
    yield p
    _clean(p)


def _burn_series(pkg, slo="t"):
    return pkg.registry.gauge("mx_slo_error_budget_burn",
                              "error-budget burn", labels={"slo": slo})


def _feed(pkg, g, value, t):
    g.set(value)
    pkg.timeseries.sample_now(now=t)


def test_burn_alert_fast_window_catches_flash_burst(pkg):
    pkg.timeseries.enable(interval_s=1.0, samples=512, thread=False)
    g = _burn_series(pkg)
    a = pkg.burnrate.BurnRateAlert("a", "t", windows=((60.0, 10.0),
                                                     (600.0, 2.0)))
    t = 0.0
    for _ in range(60):
        _feed(pkg, g, 0.5, t)
        a.evaluate(now=t)
        t += 1.0
    assert not a.firing
    for _ in range(70):
        _feed(pkg, g, 25.0, t)
        a.evaluate(now=t)
        t += 1.0
    assert a.firing
    assert pkg.registry.gauge("mx_alert_firing",
                              labels={"alert": "a"}).value == 1


def test_burn_alert_slow_window_catches_slow_leak(pkg):
    pkg.timeseries.enable(interval_s=1.0, samples=2048, thread=False)
    g = _burn_series(pkg)
    a = pkg.burnrate.BurnRateAlert("a", "t", windows=((60.0, 10.0),
                                                     (600.0, 2.0)))
    t, fired_at = 0.0, None
    for _ in range(700):
        _feed(pkg, g, 3.0, t)
        a.evaluate(now=t)
        if a.firing and fired_at is None:
            fired_at = t
        t += 1.0
    assert a.firing and fired_at is not None


def test_burn_alert_hysteresis_no_flap_at_boundary(pkg):
    pkg.timeseries.enable(interval_s=1.0, samples=512, thread=False)
    g = _burn_series(pkg)
    a = pkg.burnrate.BurnRateAlert("a", "t", windows=((10.0, 10.0),),
                                   clear_ratio=0.9, clear_holds=3)
    t = 0.0
    for _ in range(20):
        _feed(pkg, g, 20.0, t)
        a.evaluate(now=t)
        t += 1.0
    assert a.firing and a.transitions == 1
    for _ in range(30):              # hover under the factor, above 0.9x
        _feed(pkg, g, 9.5, t)
        a.evaluate(now=t)
        t += 1.0
    assert a.firing and a.transitions == 1
    while a.firing and t < 200:
        _feed(pkg, g, 1.0, t)
        a.evaluate(now=t)
        t += 1.0
    assert not a.firing and a.transitions == 2


def test_burn_alert_steady_trace_never_flaps(pkg):
    pkg.timeseries.enable(interval_s=1.0, samples=512, thread=False)
    g = _burn_series(pkg)
    a = pkg.burnrate.BurnRateAlert("a", "t", windows=((60.0, 10.0),
                                                     (600.0, 2.0)))
    for i in range(300):
        _feed(pkg, g, 0.8, float(i))
        a.evaluate(now=float(i))
    assert not a.firing and a.transitions == 0


def test_burn_alert_unknown_history_freezes_state(pkg):
    pkg.timeseries.enable(interval_s=1.0, samples=64, thread=False)
    a = pkg.burnrate.BurnRateAlert("a", "t")
    st = a.evaluate(now=0.0)
    assert not st["firing"] and a.transitions == 0
    # firing, then the history goes away: still firing (an observatory
    # outage is not an all-clear)
    a.firing = True
    pkg.timeseries.reset()
    pkg.timeseries.enable(interval_s=1.0, samples=64, thread=False)
    assert a.evaluate(now=5.0)["firing"]


def test_parse_windows_spec_and_defaults(pkg, monkeypatch):
    br = pkg.burnrate
    assert br.parse_windows("") == br.DEFAULT_WINDOWS
    assert br.parse_windows(None) == br.DEFAULT_WINDOWS
    assert br.parse_windows("120@5,900@1.5") == ((120.0, 5.0), (900.0, 1.5))
    with pytest.raises(ValueError):
        br.parse_windows("120")
    with pytest.raises(ValueError):
        br.parse_windows("a@b")
    monkeypatch.setenv("MXNET_BURN_WINDOWS", "30@3")
    assert br.BurnRateAlert("k", "t").windows == ((30.0, 3.0),)


def test_arm_default_builds_one_alert_per_slo(pkg):
    slo = pkg.slo
    pkg.timeseries.enable(interval_s=1.0, samples=16, thread=False)
    slo.latency("t_lat", "t_rt_seconds", 0.5)
    slo.latency("t_lat2", "t_rt2_seconds", 0.5)
    try:
        added = pkg.burnrate.arm_default()
        names = {f"burn_{s.name}" for s in slo.tracker().slos()}
        assert {a.name for a in pkg.burnrate.alerts()} >= names
        assert {a.name for a in added} == names
        assert pkg.burnrate.arm_default() == []
        with pytest.raises(ValueError):
            pkg.burnrate.add("burn_t_lat", "t_lat")
    finally:
        slo.tracker().remove("t_lat")
        slo.tracker().remove("t_lat2")


def test_same_burn_history_same_transitions_in_both_packages(tmp_path):
    """One seeded burn history (quiet, a flash burst, a slow leak, a
    recovery) through two alerts in both packages: the same state after
    every evaluation, the same `firing()` list, and the port's flight
    dump carries the alerts' states."""
    r = onp.random.RandomState(11)
    burns = onp.concatenate([r.uniform(0, 1, 80), r.uniform(20, 30, 40),
                             r.uniform(0, 1, 60), r.uniform(2.5, 4, 400),
                             r.uniform(0, 0.5, 300)])
    trail = {}
    for name, p in sorted(PKGS.items()):
        _clean(p)
        p.timeseries.enable(interval_s=1.0, samples=1024, thread=False)
        g = _burn_series(p, "x")
        p.burnrate.add("fast", "x", windows=((30.0, 10.0),))
        p.burnrate.add("pair", "x", windows=((60.0, 14.4), (600.0, 2.0)),
                       clear_holds=4)
        out = []
        for i, b in enumerate(burns):
            _feed(p, g, float(b), float(i))
            st = p.burnrate.evaluate_all(now=float(i))
            out.append((tuple(sorted((k, v["firing"], v["transitions"])
                                     for k, v in st.items())),
                        tuple(p.burnrate.firing())))
        trail[name] = out
        if name == "port":
            ttracing.enable()
            try:
                path = ttracing.flight_dump("t_burn",
                                            path=str(tmp_path / "f.json"))
            finally:
                ttracing.disable()
                ttracing.reset()
            import json

            blk = json.load(open(path))["context"]["burnrate"]
            assert {a["alert"] for a in blk["alerts"]} == {"fast", "pair"}
        _clean(p)
    assert trail["port"] == trail["ref"]
    assert any(f for _s, f in trail["port"])       # something fired
