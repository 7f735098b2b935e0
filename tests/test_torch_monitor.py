"""The port's health monitor and funnel stages
(`incubator_mxnet_tpu_torch.telemetry.monitor`, `stages`) against the JAX
package's, on the CPU: `default_stats` on the same seeded numpy inputs
within rtol 1e-5; `Monitor` collecting the same (op, stat) rows for the
same program, batched, and skipping cycles by ``interval``; the NaN hook
raising at the same op (an eager ``log``, an eager gluon step with one
injected NaN); the health checks and `check()`; the single-process rank
statistics; the stage probes' report (the reference's stages but the
op-program cache key, which the port has not) and their off path; and
``MXNET_TELEMETRY=raise`` arming the hook at import."""
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.telemetry import monitor as jmonitor
from incubator_mxnet_tpu.telemetry import stages as jstages
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch.ndarray import ndarray as tnd
from incubator_mxnet_tpu_torch.telemetry import monitor as tmonitor
from incubator_mxnet_tpu_torch.telemetry import stages as tstages

PKGS = {"ref": (jmx, jmonitor, jgluon, jautograd),
        "port": (tmx, tmonitor, tgluon, tautograd)}


@pytest.fixture(autouse=True)
def _clean():
    with tmx.cpu():
        yield
    for mon, st in ((jmonitor, jstages), (tmonitor, tstages)):
        mon.uninstall_nan_hook()
        mon.clear_nan_findings()
        mon.remove_health_check("t_torch")
        st.disable()
        st.reset()


@pytest.mark.parametrize("shape,scale", [((3, 5), 1.0), ((64,), 1e3),
                                         ((2, 3, 4), 1e-3)])
def test_default_stats_match_reference(shape, scale):
    import jax.numpy as jnp

    x = onp.random.RandomState(7).randn(*shape).astype("float32") * scale
    x.flat[0] = onp.inf if x.size > 4 else x.flat[0]
    x.flat[-1] = onp.nan if x.size > 4 else x.flat[-1]
    j = {k: float(v) for k, v in jmonitor.default_stats(
        jnp.asarray(x)).items()}
    t = {k: float(v) for k, v in tmonitor.default_stats(
        torch.from_numpy(x)).items()}
    assert set(t) == set(j) == {"norm", "mean", "max_abs", "nan", "inf"}
    for k in j:
        if onp.isnan(j[k]):
            assert onp.isnan(t[k]), k
        else:
            assert t[k] == pytest.approx(j[k], rel=1e-5), k


def _observe(mx, monitor, pattern="dot", interval=1, cycles=1):
    m = monitor.Monitor(pattern=pattern, interval=interval)
    a = mx.np.array([[1.0, 2.0], [3.0, 4.0]])
    out = []
    for _ in range(cycles):
        m.tic()
        mx.np.dot(a, a)
        (a + 1)                           # not matched by the pattern
        out.append(m.toc())
    return out


def test_monitor_collects_the_references_rows():
    rows = {name: _observe(mx, mon)[0]
            for name, (mx, mon, _g, _a) in PKGS.items()}
    assert rows["port"] and {r[1] for r in rows["port"]} == {"dot"}
    key = {name: [(r[0], r[1], r[2]) for r in rs]
           for name, rs in rows.items()}
    assert key["port"] == key["ref"]
    for (_s, _n, stat, vt), (_s2, _n2, _st2, vj) in zip(rows["port"],
                                                        rows["ref"]):
        assert vt == pytest.approx(vj, rel=1e-5), stat
    assert tnd._MONITOR_HOOK is None       # uninstalled after toc


def test_monitor_interval_skips_cycles():
    for mx, mon, _g, _a in PKGS.values():
        first, second, third = _observe(mx, mon, interval=2, cycles=3)
        assert first and not second and third


@pytest.mark.parametrize("name", sorted(PKGS))
def test_nan_hook_eager_raises_with_op_name(name):
    mx, mon, _g, _a = PKGS[name]
    mon.install_nan_hook(mode="raise")
    with pytest.raises(mx.MXNetError, match="'log'"):
        mx.np.log(mx.np.array([-1.0]))
    assert mon.nan_findings()[0]["op"] == "log"


def _nan_step(mx, mon, gluon, autograd):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(6, in_units=4), gluon.nn.LayerNorm(in_channels=6))
    net.initialize()
    x = onp.ones((3, 4), "float32")
    x[1, 2] = onp.nan
    mon.install_nan_hook(mode="raise")
    try:
        with autograd.record():
            out = net(mx.np.array(x))
            (out * out).sum().backward()
    except mx.MXNetError as e:
        return str(e), mon.nan_findings()[0]["op"]
    return None, None


def test_nan_hook_raises_at_the_same_op_on_a_gluon_step():
    got = {name: _nan_step(*pkg) for name, pkg in PKGS.items()}
    assert got["port"][0] is not None
    assert got["port"] == got["ref"]


def test_nan_hook_warn_records_and_check_raises():
    tmonitor.install_nan_hook(mode="warn")
    tmx.np.log(tmx.np.array([-1.0]))              # recorded, not raised
    assert [f["op"] for f in tmonitor.nan_findings()] == ["log"]
    with pytest.raises(tmx.MXNetError, match="'log' \\(eager\\)"):
        tmonitor.check()
    tmonitor.clear_nan_findings()
    tmonitor.check()
    with pytest.raises(ValueError):
        tmonitor.install_nan_hook(mode="loud")


def test_health_checks_run_in_check():
    calls = []

    def probe():
        calls.append(1)
        raise tmx.MXNetError("budget burned")

    tmonitor.add_health_check(probe, name="t_torch")
    with pytest.raises(tmx.MXNetError, match="budget burned"):
        tmonitor.check()
    tmonitor.remove_health_check("t_torch")
    tmonitor.check()
    assert calls == [1]


def test_rank_aggregation_single_process():
    out = {}
    for name, (_mx, mon, _g, _a) in PKGS.items():
        mon.queue_rank_stats({"grad_norm": 2.5, "loss": 0.75})
        out[name] = (mon.sync_rank_stats(), mon.rank_aggregate(),
                     mon.sync_rank_stats())
    assert out["port"] == out["ref"]
    assert out["port"][0]["grad_norm"] == {"min": 2.5, "max": 2.5,
                                           "mean": 2.5, "ranks": 1}


# ---------------------------------------------------------------------------
# the funnel's stages
# ---------------------------------------------------------------------------

def _stage_run(mx, stages, record=False, autograd=None):
    a = mx.np.array(onp.random.RandomState(0).uniform(-1, 1, (16, 16))
                    .astype("float32"))
    if record:
        a.attach_grad()
    stages.reset()
    stages.enable()
    try:
        for _ in range(5):
            if record:
                with autograd.record():
                    mx.np.dot(a, a).sum().backward()
            else:
                mx.np.dot(a, a).wait_to_read()
    finally:
        stages.disable()
    return stages.stage_report()


def test_stage_report_has_the_references_stages_but_cache_key():
    t = _stage_run(tmx, tstages)
    j = _stage_run(jmx, jstages)
    assert tstages.STAGE_ORDER == jstages.STAGE_ORDER
    assert set(j) - set(t) == {"cache_key"}     # absent, not zero
    assert set(t) == {"prologue", "amp_lookup", "dispatch", "wrap", "total"}
    for stage in ("prologue", "amp_lookup", "dispatch", "wrap"):
        assert t[stage]["count"] == j[stage]["count"] >= 5
    assert t["total"]["mean_us"] > 0
    assert "| dispatch |" in tstages.format_report(t)
    assert "tape" in _stage_run(tmx, tstages, record=True,
                                autograd=tautograd)
    assert tnd._STAGE_HOOK is None


def test_seams_are_off_by_default():
    for seam in ("_PROFILER", "_STAGE_HOOK", "_ANALYSIS_HOOK",
                 "_MONITOR_HOOK"):
        assert getattr(tnd, seam) is None, seam


def test_telemetry_raise_installs_the_hook_at_import():
    code = ("import incubator_mxnet_tpu_torch as mx\n"
            "from incubator_mxnet_tpu_torch.telemetry import monitor,"
            " stages\n"
            "print(monitor._NAN_MODE, stages.is_enabled())\n")
    env = dict(os.environ, MXNET_TELEMETRY="raise")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "raise True" in out.stdout


def test_rank_aggregation_over_two_ranks_at_a_kvstore_barrier(tmp_path):
    """Each rank's queued summary is exchanged at a `KVStoreDist.barrier`
    of a 2-rank gloo world (`sync_rank_stats` over `dist.exchange_objs`):
    `rank_aggregate()` gives the min/max/mean over both, on both."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_worlds import world

    res = world.spawn(os.path.join(os.path.dirname(__file__), "torch_worlds",
                                   "kv_commands.py"), 2, tmp_path)
    for out in res:
        assert out["forbidden"] == []
        assert out["aggregate"] == {
            "loss": {"min": 1.0, "max": 2.0, "mean": 1.5, "ranks": 2},
            "rank": {"min": 0.0, "max": 1.0, "mean": 0.5, "ranks": 2}}
