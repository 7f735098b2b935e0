"""The port's training goodput ledger (`incubator_mxnet_tpu_torch.
telemetry.goodput`) against the JAX package's, on the CPU: the ledger
tests of `tests/test_kernels.py` (:217-311 and :411) as cases of both
packages (fixture `pkg`) — the states summing to wall, innermost lease
winning, the series and the pull gauge, off as the shared null context,
the off-path cost, the waterfall over the committed fixture, and the
ledger riding the flight dump.

In the port the ledger stands alone: its producers (the estimator, the
dataloader, preemption, the elastic trainer) are not ported yet, and
`parallel.DataParallel` charges it no state, as the reference's does not.
"""
import json
import os
import time
from types import SimpleNamespace

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import np as jnp_
from incubator_mxnet_tpu.telemetry import goodput as jgoodput
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu.telemetry import tracing as jtracing
from incubator_mxnet_tpu_torch.telemetry import goodput as tgoodput
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry
from incubator_mxnet_tpu_torch.telemetry import tracing as ttracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "benchmark", "kernelscope_demo_trace.json")


def _ref_op():
    a = jnp_.array(onp.random.RandomState(0).uniform(-1, 1, (16, 16))
                   .astype("float32"))
    jnp_.dot(a, a).wait_to_read()

    def op():
        jnp_.dot(a, a)

    return op, jmx.waitall


def _port_op():
    """One small op of the port's own: `npx.layer_norm` through its
    kernel wrapper (the plain version, on the CPU). A bare 16 x 16
    ``torch.mm`` is no framework op: it costs a few microseconds, less
    than the reference's eager ``np.dot`` dispatch it would stand for."""
    from incubator_mxnet_tpu_torch import npx

    r = onp.random.RandomState(0)
    a = torch.from_numpy(r.uniform(-1, 1, (16, 16)).astype("float32"))
    g, b = torch.ones(16), torch.zeros(16)
    npx.layer_norm(a, g, b)

    def op():
        npx.layer_norm(a, g, b)

    return op, lambda: None


PKGS = {
    "ref": SimpleNamespace(goodput=jgoodput, registry=jregistry,
                           tracing=jtracing, op=_ref_op),
    "port": SimpleNamespace(goodput=tgoodput, registry=tregistry,
                            tracing=ttracing, op=_port_op),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    p.goodput.disable()
    p.goodput.reset()
    yield p
    p.goodput.disable()
    p.goodput.reset()


def _counter(pkg, name):
    return pkg.registry.report().get(name, {}).get("value", 0) or 0


def test_goodput_states_sum_to_wall(pkg):
    gp = pkg.goodput
    gp.enable()
    with gp.lease("compute"):
        time.sleep(0.05)
    time.sleep(0.02)                            # unleased -> idle
    with gp.lease("data_wait"):
        time.sleep(0.01)
    rep = gp.report()
    assert rep["enabled"] and rep["active_lease"] is None
    assert sum(rep["states"].values()) == pytest.approx(rep["wall_s"],
                                                        rel=1e-9)
    assert rep["states"]["compute"] >= 0.05
    assert rep["states"]["data_wait"] >= 0.01
    assert rep["states"]["idle"] >= 0.015
    assert rep["accounted_s"] == pytest.approx(
        rep["wall_s"] - rep["states"]["idle"], rel=1e-9)
    assert 0.0 < rep["goodput_frac"] < 1.0


def test_goodput_nesting_innermost_wins(pkg):
    gp = pkg.goodput
    gp.enable()
    with gp.lease("reshard"):
        time.sleep(0.02)
        with gp.lease("checkpoint"):
            time.sleep(0.03)
        time.sleep(0.01)
    rep = gp.report()
    assert rep["states"]["checkpoint"] >= 0.03
    assert rep["states"]["reshard"] >= 0.03
    assert rep["states"]["reshard"] < rep["wall_s"] - 0.025
    assert sum(rep["states"].values()) == pytest.approx(rep["wall_s"],
                                                        rel=1e-9)


def test_goodput_series_and_pull_gauge(pkg):
    gp = pkg.goodput
    gp.enable()
    key = 'mx_goodput_seconds_total{state="compute"}'
    c0 = _counter(pkg, key)
    with gp.lease("compute"):
        time.sleep(0.03)
    rep = pkg.registry.report()
    assert key in rep and rep[key]["value"] >= c0 + 0.03
    assert rep["mx_goodput_frac"]["value"] > 0.0
    gf = gp.goodput_frac()
    assert gf is not None and 0.0 < gf <= 1.0


def test_goodput_off_is_null_and_unknown_state_raises(pkg):
    gp = pkg.goodput
    assert not gp.is_enabled()
    assert gp.lease("compute") is gp.lease("reshard")
    with gp.lease("compute"):
        time.sleep(0.005)
    rep = gp.report()
    assert rep["wall_s"] == 0.0 and not any(rep["states"].values())
    gp.enable()
    with pytest.raises(ValueError, match="unknown goodput state"):
        gp.lease("productive")
    with gp.lease("compute"):
        pass
    gp.reset()
    assert gp.report()["wall_s"] == 0.0
    assert gp.goodput_frac() is None


def test_goodput_off_path_is_cheap(pkg):
    """The disabled lease against one small op of the package (the
    reference's gate, :268: under 3% of the op)."""
    gp = pkg.goodput
    assert not gp.is_enabled()
    op, sync = pkg.op()
    iters = 300

    def best(fn, sync=lambda: None):
        out = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            sync()
            out = min(out, time.perf_counter() - t0)
        return out / iters

    def seam():
        with gp.lease("compute"):
            pass

    per_op = best(op, sync)
    probe = best(seam)
    assert probe < 0.03 * per_op, (probe, per_op)


def test_goodput_waterfall_renders_fixture(pkg):
    with open(FIXTURE, encoding="utf-8") as f:
        rep = json.load(f)["goodput"]
    s = pkg.goodput.format_waterfall(rep)
    assert "goodput waterfall" in s
    assert "goodput 80.8%" in s and "accounted 99.1%" in s
    for state in pkg.goodput.STATES:
        assert state in s


def test_goodput_waterfall_equal_between_packages():
    with open(FIXTURE, encoding="utf-8") as f:
        rep = json.load(f)["goodput"]
    assert tgoodput.format_waterfall(rep, width=60) == \
        jgoodput.format_waterfall(rep, width=60)
    assert tgoodput.STATES == jgoodput.STATES


def test_goodput_rides_flight_records(pkg, tmp_path):
    gp = pkg.goodput
    gp.enable()
    with gp.lease("compute"):
        time.sleep(0.01)
    path = pkg.tracing.flight_dump("test_goodput",
                                   path=str(tmp_path / "flight.json"))
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    blk = payload["context"]["goodput"]
    assert blk["states"]["compute"] >= 0.01
    assert blk["goodput_frac"] > 0.0


def test_data_parallel_charges_no_goodput_state():
    """The port's `DataParallel` step leaves the ledger untouched, as the
    reference's does: the lease seams belong to the estimator and the
    dataloader (not ported)."""
    from incubator_mxnet_tpu_torch.optimizer import Adam
    from incubator_mxnet_tpu_torch.parallel import DataParallel

    tgoodput.reset()
    tgoodput.enable()
    try:
        net = torch.nn.Linear(4, 1)
        dp = DataParallel(net, lambda out, y: ((out - y) ** 2).mean(dim=-1),
                          Adam())
        dp.step(torch.zeros(8, 4), torch.zeros(8, 1))
        assert tgoodput.report()["wall_s"] == 0.0
    finally:
        tgoodput.disable()
        tgoodput.reset()
