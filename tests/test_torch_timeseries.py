"""The port's time-series history layer (`incubator_mxnet_tpu_torch.
telemetry.timeseries`) against the JAX package's, on the CPU: the
timeseries tests of `tests/test_capacity_observatory.py` (:62-160) as
cases of both packages (fixture `pkg`), plus the same virtual-time history
answering every windowed query the same in both, and the sampler walking
every pull gauge the port's serving plane registers without touching a
device (the probes read host state only).
"""
import time
from types import SimpleNamespace

import numpy as onp
import pytest

from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu.telemetry import timeseries as jtimeseries
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry
from incubator_mxnet_tpu_torch.telemetry import timeseries as ttimeseries

PKGS = {
    "ref": SimpleNamespace(registry=jregistry, timeseries=jtimeseries),
    "port": SimpleNamespace(registry=tregistry, timeseries=ttimeseries),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    p.timeseries.disable()
    p.timeseries.reset()
    yield p
    p.timeseries.disable()
    p.timeseries.reset()
    p.registry.reset()


def _series(pkg, name, values, dt=1.0):
    """Build a history for gauge `name` on a virtual clock; returns the
    series key and the final virtual timestamp."""
    g = pkg.registry.gauge(name, "test series")
    t = 0.0
    for v in values:
        g.set(v)
        pkg.timeseries.sample_now(now=t)
        t += dt
    return name, t - dt


def test_ring_wraparound_keeps_newest(pkg):
    ts = pkg.timeseries
    ts.enable(interval_s=1.0, samples=8, thread=False)
    key, _t = _series(pkg, "t_wrap", range(20))
    hist = ts.history(key)
    assert [v for _t, v in hist] == [12, 13, 14, 15, 16, 17, 18, 19]
    stamps = [t for t, _v in hist]
    assert stamps == sorted(stamps) and len(set(stamps)) == len(stamps)
    assert ts.last(key) == (19.0, 19.0)


def test_rate_counter_reset_aware(pkg):
    ts = pkg.timeseries
    ts.enable(interval_s=1.0, samples=64, thread=False)
    c = pkg.registry.counter("t_rst_total", "test counter")
    t = 0.0
    for v in [0, 10, 20, 5, 15]:     # process restart between 20 and 5
        c._cell()[0] = v
        ts.sample_now(now=t)
        t += 1.0
    # a drop restarts from zero: 10 + 10 + 5 + 10 = 35 over 4 s
    assert ts.rate("t_rst_total", window_s=10.0, now=4.0) == \
        pytest.approx(35.0 / 4.0)
    assert ts.delta("t_rst_total", 10.0, now=4.0) == pytest.approx(15.0)


def test_rate_needs_two_samples_and_known_series(pkg):
    ts = pkg.timeseries
    ts.enable(interval_s=1.0, samples=8, thread=False)
    assert ts.rate("t_nope", 10.0) is None
    _series(pkg, "t_one", [5])
    assert ts.rate("t_one", 10.0, now=0.0) is None
    assert ts.last("t_one") == (0.0, 5.0)


def test_percentile_over_time_matches_numpy(pkg):
    ts = pkg.timeseries
    ts.enable(interval_s=1.0, samples=128, thread=False)
    vals = onp.random.RandomState(7).uniform(-10, 10, 101)
    key, t_end = _series(pkg, "t_pct", vals)
    for q in (0, 10, 25, 50, 75, 90, 99, 100):
        got = ts.percentile_over_time(key, q, 1000.0, now=t_end)
        assert got == pytest.approx(
            float(onp.percentile(vals, q, method="nearest"))), q


def test_window_frac_and_avg(pkg):
    ts = pkg.timeseries
    ts.enable(interval_s=1.0, samples=64, thread=False)
    key, t_end = _series(pkg, "t_frac", [0, 1, 1, 1, 0])
    assert ts.avg_over_time(key, 100.0, now=t_end) == pytest.approx(0.6)
    assert ts.window_frac(key, 100.0, lambda v: v > 0.5, now=t_end) == \
        pytest.approx(0.6)
    assert ts.window_frac(key, 1.5, lambda v: v > 0.5, now=t_end) == \
        pytest.approx(0.5)


def test_histogram_series_expand_to_count_and_sum(pkg):
    ts = pkg.timeseries
    ts.enable(interval_s=1.0, samples=16, thread=False)
    h = pkg.registry.histogram("t_cap_lat_seconds", "test latencies")
    h.observe(0.1)
    ts.sample_now(now=0.0)
    h.observe(0.3)
    h.observe(0.5)
    ts.sample_now(now=1.0)
    assert ts.delta("t_cap_lat_seconds:count", 10.0, now=1.0) == 2
    assert ts.delta("t_cap_lat_seconds:sum", 10.0, now=1.0) == \
        pytest.approx(0.8)


def test_timeseries_sampler_thread_and_knobs(pkg, monkeypatch):
    ts = pkg.timeseries
    monkeypatch.setenv("MXNET_TS_INTERVAL", "0.01")
    monkeypatch.setenv("MXNET_TS_SAMPLES", "32")
    pkg.registry.counter("t_thr_total", "test").inc()
    assert ts.enable() == (0.01, 32)
    assert ts.is_enabled()
    deadline = time.monotonic() + 5.0
    while ts.sample_count() < 3:
        assert time.monotonic() < deadline, "sampler thread never ticked"
        time.sleep(0.01)
    ts.disable()
    assert ts.history("t_thr_total")
    ts.reset()
    assert ts.history("t_thr_total") is None


def test_timeseries_off_by_default_is_inert(pkg):
    ts = pkg.timeseries
    assert not ts.is_enabled()
    assert ts.sample_count() == 0
    assert ts.series_names() == []
    assert ts.sample_now(now=0.0) == 0


def test_same_history_same_answers_in_both_packages():
    """One virtual-time history of a gauge, a counter with a reset and a
    histogram, fed to both packages: every windowed query agrees."""
    r = onp.random.RandomState(3)
    occ = r.uniform(0, 1, 60)
    cnt = onp.cumsum(r.randint(0, 9, 60))
    cnt[30:] -= cnt[29]              # a restart mid-history
    lat = r.exponential(0.2, (60, 3))
    answers = {}
    for name, p in sorted(PKGS.items()):
        ts = p.timeseries
        ts.reset()
        ts.enable(interval_s=1.0, samples=40, thread=False)
        g = p.registry.gauge("t_same_occ", "x")
        c = p.registry.counter("t_same_total", "x")
        h = p.registry.histogram("t_same_seconds", "x")
        for i in range(60):
            g.set(float(occ[i]))
            c._cell()[0] = int(cnt[i])
            for v in lat[i]:
                h.observe(float(v))
            ts.sample_now(now=float(i) * 0.5)
        now = 29.5
        answers[name] = (
            ts.history("t_same_occ", 5.0, now=now),
            ts.rate("t_same_total", 12.0, now=now),
            ts.delta("t_same_total", 3.0, now=now),
            ts.avg_over_time("t_same_occ", 7.0, now=now),
            [ts.percentile_over_time("t_same_occ", q, 20.0, now=now)
             for q in (5, 50, 95)],
            ts.window_frac("t_same_occ", 10.0, lambda v: v > 0.5, now=now),
            ts.rate("t_same_seconds:count", 4.0, now=now),
            ts.delta("t_same_seconds:sum", 4.0, now=now),
            ts.series_names(prefix="t_same"), ts.sample_count())
        ts.reset()
        p.registry.reset()
    assert answers["port"] == answers["ref"]


def test_sampler_reads_the_serving_plane_host_side():
    """The port's sampler thread at 0.05 s while a gateway over a
    `gpt_tiny` engine serves on the CPU, with the device-memory census
    armed: every pull gauge the plane registers (page occupancy, replica
    free pages and count, queue depth, the census) is sampled, and the
    tokens are those of the same gateway with the sampler off."""
    from incubator_mxnet_tpu_torch import serve
    from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
    from incubator_mxnet_tpu_torch.telemetry import hbm

    def run():
        m = gpt_tiny(vocab_size=50, max_length=64, dropout=0.0,
                     device="cpu", seed=0)
        reg = serve.ModelRegistry(total_pages=16)
        reg.add("g", m, max_slots=2, max_len=64)
        gw = serve.Gateway(reg)
        hs = [gw.submit("g", list(range(3 + i, 9 + 2 * i)), 5)
              for i in range(3)]
        gw._drive_until(hs, timeout=60)
        gw.shutdown()
        return [h.tokens for h in hs]

    want = run()
    ttimeseries.reset()
    hbm.enable()
    try:
        ttimeseries.enable(interval_s=0.05, samples=4096)
        got = run()
        deadline = time.monotonic() + 5.0
        while ttimeseries.sample_count() < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        names = ttimeseries.series_names()
    finally:
        hbm.disable()
        ttimeseries.disable()
        ttimeseries.reset()
    assert got == want
    for series in ("mx_serve_page_occupancy", "mx_gateway_queue_depth",
                   'mx_serve_replicas{model="g"}',
                   "mx_hbm_live_bytes_total", "mx_serve_slot_occupancy"):
        assert any(n.startswith(series) for n in names), (series, names)
