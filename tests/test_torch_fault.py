"""The port's fault injection and retry policies (`incubator_mxnet_tpu_
torch.fault`) against the JAX package's, on the CPU: the injection and
retry parts of `tests/test_fault.py` as cases of both packages, and the
``MXNET_FAULT_INJECT`` grammar firing on the same draws in both — the
same spec, seams, seeds, limits and kinds give the same fire pattern,
the same `schedule_info` and the same exception types; the full `SEAMS`
tuple is the reference's; `classify_exception` gives PyTorch's CUDA
out-of-memory and runtime errors the classes the reference gives XLA's
``RESOURCE_EXHAUSTED`` and ``XlaRuntimeError``.
"""
import logging
import multiprocessing as mp
from types import SimpleNamespace

import pytest
import torch

from incubator_mxnet_tpu import fault as jfault
from incubator_mxnet_tpu.fault import injection as jinjection
from incubator_mxnet_tpu.fault import retry as jretry
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu_torch import fault as tfault
from incubator_mxnet_tpu_torch import util as tutil
from incubator_mxnet_tpu_torch.fault import injection as tinjection
from incubator_mxnet_tpu_torch.fault import retry as tretry
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry

PKGS = {
    "ref": SimpleNamespace(fault=jfault, injection=jinjection, retry=jretry,
                           registry=jregistry,
                           logger="incubator_mxnet_tpu.fault"),
    "port": SimpleNamespace(fault=tfault, injection=tinjection,
                            retry=tretry, registry=tregistry,
                            logger="incubator_mxnet_tpu_torch.fault"),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    p.injection.clear_injection()
    yield p
    p.injection.clear_injection()


@pytest.fixture()
def clean():
    for p in PKGS.values():
        p.injection.clear_injection()
    yield
    for p in PKGS.values():
        p.injection.clear_injection()


def _counter(pkg, name):
    return pkg.registry.report().get(name, {}).get("value", 0) or 0


def _fires(inj, seam, n, index=None):
    """(draw index, exception type name) of each fire over ``n`` draws."""
    out = []
    for i in range(n):
        try:
            inj.inject_at(seam, index=index)
        except Exception as e:          # every kind that raises
            out.append((i, type(e).__name__))
    return out


def test_seams_are_the_references():
    assert tinjection.SEAMS == jinjection.SEAMS
    assert len(tinjection.SEAMS) == 16
    assert {"serve_step", "gateway_step", "page_migration"} <= \
        set(tinjection.SEAMS)


@pytest.mark.parametrize("spec,seam,draws", [
    ("serve_step:0.5:42", "serve_step", 200),
    ("serve_step:0.3", "serve_step", 100),
    ("gateway_step:0.7:7:5", "gateway_step", 50),
    ("page_migration:1.0:0:2", "page_migration", 6),
    ("serve_step:0.2:9:3:oom", "serve_step", 200),
    ("kvstore_push:0.5:3, page_migration:0.25:11", "page_migration", 120),
    ("replica_crash@1:0.6:5", "replica_crash", 40),
    ("topology_change:0.4:1:2:shrink=3", "topology_change", 30),
    ("dist_init:0.5:2:4:grow=8", "dist_init", 30),
])
def test_same_spec_fires_on_the_same_draws(clean, spec, seam, draws):
    """The ``MXNET_FAULT_INJECT`` grammar in both packages: one spec, the
    same draws fire with the same exception types, and `schedule_info`
    agrees. ``@N`` seams draw with the index they target."""
    index = 1 if "@" in spec else None
    got, ref = [], []
    for inj, out in ((tinjection, got), (jinjection, ref)):
        armed = inj.configure_injection(spec)
        out.append(armed)
        out.append(_fires(inj, seam, draws, index=index))
        out.append(inj.schedule_info())
    assert got == ref
    assert got[1] or "0.2" in spec


def test_env_spec_arms_both_packages_alike(clean, monkeypatch):
    """`configure_from_env` (the port's arms at import through
    `util._apply_env_config`) reads ``MXNET_FAULT_INJECT`` as the
    reference does."""
    monkeypatch.setenv("MXNET_FAULT_INJECT", "serve_step:0.5:3:4")
    tutil._apply_env_config()
    assert tinjection.injection_enabled("serve_step")
    assert not tinjection.injection_enabled("gateway_step")
    assert jinjection.configure_from_env() == ("serve_step",)
    assert _fires(tinjection, "serve_step", 40) == \
        _fires(jinjection, "serve_step", 40)


def test_dict_spec_and_delay_kind(pkg, monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_DELAY_MS", "1")
    inj = pkg.injection
    assert inj.configure_injection({"serve_step": (1.0, 0, 1),
                                    "collective_delay": 1.0}) == \
        ("serve_step", "collective_delay")
    with pytest.raises(pkg.fault.FaultInjected):
        inj.inject_at("serve_step")
    inj.inject_at("serve_step")                 # limit reached
    inj.inject_at("collective_delay")           # sleeps, does not raise
    info = inj.schedule_info()
    assert info["collective_delay"]["kind"] == "delay"
    assert info["collective_delay"]["fired"] == 1
    assert inj.configure_injection("") == () and not inj.injection_enabled()


def test_injection_limit_caps_fires(pkg):
    pkg.injection.configure_injection("serve_step:1.0:0:2")
    outcomes = []
    for _ in range(5):
        try:
            pkg.injection.inject_at("serve_step")
            outcomes.append("ok")
        except pkg.fault.FaultInjected:
            outcomes.append("boom")
    assert outcomes == ["boom", "boom", "ok", "ok", "ok"]


def test_injection_bad_spec_raises(pkg):
    inj = pkg.injection
    with pytest.raises(ValueError, match="unknown seam"):
        inj.configure_injection("not_a_seam:0.5")
    with pytest.raises(ValueError, match="prob"):
        inj.configure_injection("serve_step:1.5")
    with pytest.raises(ValueError, match="expected"):
        inj.configure_injection("serve_step")
    with pytest.raises(ValueError, match="rank"):
        inj.configure_injection("serve_step@x:0.5")
    with pytest.raises(ValueError, match="kind"):
        inj.configure_injection("serve_step:0.5:0:1:nope")
    assert not inj.injection_enabled()


def test_fired_fault_counts_and_pickles(pkg):
    import pickle

    before = _counter(pkg, 'mx_faults_injected_total{seam="gateway_step"}')
    pkg.injection.configure_injection("gateway_step:1.0:0:1:oom")
    with pytest.raises(pkg.fault.FaultInjected) as ei:
        pkg.injection.inject_at("gateway_step")
    assert "RESOURCE_EXHAUSTED" in str(ei.value)
    assert _counter(pkg, 'mx_faults_injected_total{seam="gateway_step"}') \
        == before + 1
    back = pickle.loads(pickle.dumps(ei.value))
    assert type(back) is type(ei.value) and back.draw == 1


def test_classify_exception(pkg):
    c = pkg.retry.classify_exception
    assert c(ConnectionResetError()) == "retryable"
    assert c(TimeoutError()) == "retryable"
    assert c(pkg.fault.FaultInjected("serve_step", 1)) == "retryable"
    assert c(RuntimeError("fabric")) == "retryable"
    assert c(ValueError("bug")) == "fatal"
    assert c(TypeError("bug")) == "fatal"
    assert c(MemoryError()) == "fatal"
    assert c(mp.TimeoutError()) == "retryable"
    topo = pkg.injection.TopologyChanged("topology_change", 1, shrink=2)
    assert c(topo) == "fatal"


def test_torch_runtime_errors_classify_as_their_xla_counterparts():
    """PyTorch's CUDA out-of-memory error takes the class the reference
    gives XLA's ``RESOURCE_EXHAUSTED`` (an ``XlaRuntimeError``), and a
    CUDA ``RuntimeError`` the class it gives an ``XlaRuntimeError``."""
    class XlaRuntimeError(RuntimeError):
        """The reference runtime's error type, as jaxlib defines it."""

    xla_oom = XlaRuntimeError("RESOURCE_EXHAUSTED: Out of memory while "
                              "trying to allocate 1.00GiB")
    xla_err = XlaRuntimeError("INTERNAL: an illegal memory access")
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 1.00 GiB")
    cuda_err = RuntimeError("CUDA error: an illegal memory access was "
                            "encountered")
    assert tretry.classify_exception(oom) == \
        jretry.classify_exception(xla_oom) == "retryable"
    assert tretry.classify_exception(cuda_err) == \
        jretry.classify_exception(xla_err) == "retryable"
    assert tretry.classify_exception(
        tinjection.InjectedResourceExhausted("serve_step", 1)) == \
        jretry.classify_exception(
            jinjection.InjectedResourceExhausted("serve_step", 1))


def test_retry_policy_backoff_and_success(pkg):
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("transient")
        return "ok"

    pol = pkg.fault.RetryPolicy(max_retries=3, base_delay=0.05,
                                multiplier=2.0, jitter=0.0,
                                sleep=sleeps.append, name="t")
    before = _counter(pkg, "mx_retries_total")
    assert pol.call(flaky) == "ok"
    assert len(calls) == 3
    assert sleeps == [0.05, 0.1]
    assert _counter(pkg, "mx_retries_total") == before + 2


def test_retry_policy_fatal_not_retried(pkg):
    calls = []

    def buggy():
        calls.append(1)
        raise ValueError("deterministic bug")

    pol = pkg.fault.RetryPolicy(max_retries=5, jitter=0.0,
                                sleep=lambda d: None)
    with pytest.raises(ValueError):
        pol.call(buggy)
    assert len(calls) == 1


def test_retry_policy_exhaustion_and_deadline(pkg):
    pol = pkg.fault.RetryPolicy(max_retries=2, base_delay=0.0, jitter=0.0,
                                sleep=lambda d: None, name="x")

    def always():
        raise ConnectionError("down")

    with pytest.raises(pkg.fault.RetryExhausted) as ei:
        pol.call(always)
    assert ei.value.attempts == 3
    assert isinstance(ei.value.last, ConnectionError)
    hard = pkg.fault.RetryPolicy(max_retries=100, base_delay=0.0,
                                 jitter=0.0, deadline=0.0,
                                 sleep=lambda d: None)
    with pytest.raises(pkg.fault.RetryExhausted):
        hard.call(always)


def test_retry_delays_equal_reference():
    """Seeded jitter: the same rng seed gives the same backoff delays in
    both packages."""
    import random

    got = [tretry.RetryPolicy(base_delay=0.05, jitter=0.25,
                              rng=random.Random(3)).delay(a)
           for a in range(1, 8)]
    ref = [jretry.RetryPolicy(base_delay=0.05, jitter=0.25,
                              rng=random.Random(3)).delay(a)
           for a in range(1, 8)]
    assert got == ref


def test_retry_from_env_and_suppressed(pkg, monkeypatch, caplog):
    monkeypatch.setenv("MXNET_RETRY_MAX", "7")
    monkeypatch.setenv("MXNET_RETRY_BASE_DELAY_MS", "125")
    monkeypatch.setenv("MXNET_RETRY_DEADLINE_S", "9")
    pol = pkg.fault.RetryPolicy.from_env("envtest")
    assert pol.max_retries == 7 and pol.base_delay == 0.125
    assert pol.deadline == 9.0
    assert pkg.fault.retry_call(lambda: 5) == 5
    with caplog.at_level(logging.DEBUG, pkg.logger):
        kind = pkg.fault.suppressed("test.site", ConnectionError("noise"))
    assert kind == "retryable"
    assert any("suppressed@test.site" in r.getMessage()
               for r in caplog.records)
