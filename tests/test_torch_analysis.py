"""The port's program auditor (`incubator_mxnet_tpu_torch.analysis`)
against the JAX package's, on the CPU: the same programs (adapted from
`tests/test_analysis.py`: a host sync in a function and in a block's
forward, a Python-scalar argument, an unhashable static, promotion
drift, an in-place rebind, clean programs) give the same finding kinds
and severities; ``MXNET_ANALYSIS`` raises or logs as the reference's;
`Block.audit`; a torch-level sync found by the abstract pass on any
device and, on the card, named at its site (`LossScaler.has_overflow`);
`jit_cache_report`'s recapture churn and its ledger join."""
import logging
import threading

import numpy as onp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import _graphs
from incubator_mxnet_tpu_torch.analysis import auditor as tauditor
from incubator_mxnet_tpu_torch.ndarray import ndarray as tnd
from incubator_mxnet_tpu_torch.ops import _build

PKGS = {"ref": jmx, "port": tmx}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _kinds(rep):
    """(kind, severity) of every finding and note, sorted; jax's weak
    types (a 0-d ``np.array(3.14)`` is one) have no torch counterpart."""
    return sorted({(f.kind, f.severity) for f in rep._all
                   if f.kind != "recompile-weak-type"})


def _sync(mx):
    def f(x):
        if float(x.sum()) > 0:
            return x + 1
        return x
    return f, (mx.np.ones((4, 4)),), {}


def _clean(mx):
    def f(x):
        return (x * 2 + 1).sum()
    return f, (mx.np.ones((4, 4)),), {}


def _scalar(mx):
    def f(x, s):
        return x * s
    return f, (mx.np.ones((2, 2)), 3.14), {}


def _scalar_clean(mx):
    def f(x, s):
        return x * s
    return f, (mx.np.ones((2, 2)), mx.np.array(3.14)), {}


def _unhashable(mx):
    def f(x, cfg=None):
        return x * 2 if cfg else x
    return f, (mx.np.ones((2, 2)),), {"cfg": [1, 2]}


def _drift(mx):
    def f(a, b):
        return a / b
    return f, (mx.np.array([1, 2], dtype="int32"),
               mx.np.array([2, 2], dtype="int32")), {}


def _drift_clean(mx):
    def g(a, b):
        return a + b
    af = mx.np.array([1.0, 2.0], dtype="float32")
    return g, (af, af), {}


def _mutation(mx):
    def f(x):
        x += 1
        return x
    return f, (mx.np.ones((2, 2)),), {}


def _block_sync(mx):
    class Syncy(mx.gluon.HybridBlock):
        def forward(self, x):
            return x * float(x.max())

    net = Syncy()
    net.initialize()
    x = mx.np.ones((2, 3))
    net(x)
    return net, (x,), {}


def _block_clean(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(4, in_units=3), mx.gluon.nn.LayerNorm(
        in_channels=4))
    net.initialize()
    x = mx.np.ones((2, 3))
    net(x)
    return net, (x,), {}


PROGRAMS = {"host_sync": _sync, "clean": _clean, "python_scalar": _scalar,
            "scalar_as_array": _scalar_clean, "unhashable": _unhashable,
            "promotion_drift": _drift, "promotion_clean": _drift_clean,
            "mutation": _mutation, "block_sync": _block_sync,
            "block_clean": _block_clean}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_audit_matches_reference(name):
    got = {}
    for which, mx in PKGS.items():
        target, args, kwargs = PROGRAMS[name](mx)
        rep = (target.audit(*args, **kwargs) if hasattr(target, "audit")
               else mx.analysis.audit(target, *args, **kwargs))
        got[which] = rep
    assert _kinds(got["port"]) == _kinds(got["ref"]), (
        got["port"].summary(), got["ref"].summary())
    assert len(got["port"]) == len(got["ref"].findings) - len(
        got["ref"].by_kind("recompile-weak-type"))
    if name in ("clean", "block_clean", "promotion_clean",
                "scalar_as_array"):
        assert len(got["port"]) == 0 and got["port"].jaxpr


def test_host_sync_site_and_the_abstract_error():
    f, args, _ = _sync(tmx)
    rep = tmx.analysis.audit(f, *args)
    warn = [x for x in rep.by_kind("host-sync") if x.severity == "warn"]
    assert warn and warn[0].op == "__float__"
    assert warn[0].site.endswith(".f") and warn[0].site.startswith(__file__)
    assert any(x.severity == "error" for x in rep.by_kind("host-sync"))


def test_torch_level_sync_found_by_the_abstract_pass():
    """A CPU tensor's read waits for no card: the eager pass keeps quiet;
    the abstract pass, where a tensor has no data, finds it all the
    same."""
    def f(t):
        return t * float(t.sum())

    rep = tmx.analysis.audit(f, torch.ones(3))
    assert [(x.kind, x.severity) for x in rep] == [("host-sync", "error")]


def test_loss_scaler_sync_named_at_its_site(monkeypatch):
    """On the card a torch tensor's read syncs; with the CPU's tensors
    read as the card's, the eager float16 loop's overflow check is named
    at `LossScaler.has_overflow`."""
    monkeypatch.setattr(tauditor, "_device_sync",
                        lambda t: isinstance(t, torch.Tensor))
    net = tmx.gluon.nn.Dense(4, in_units=3)
    net.initialize()
    scaler = tmx.amp.LossScaler()
    params = net.collect_params()

    def step(x):
        with tmx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        return scaler.has_overflow(params)

    rep = tmx.analysis.audit(step, tmx.np.ones((2, 3)))
    sites = [x.site or "" for x in rep.by_kind("host-sync")]
    assert any("LossScaler.has_overflow" in s for s in sites), sites


def test_abstract_pass_takes_the_plain_versions_and_restores():
    seen = []

    def f(x):
        seen.append(isinstance(x._data, FakeTensor))
        return tmx.npx.layer_norm(x, tmx.np.ones((4,)), tmx.np.zeros((4,)))

    rep = tmx.analysis.audit(f, tmx.np.ones((2, 4)))
    assert len(rep) == 0 and seen == [False, True]
    assert tnd._ANALYSIS_HOOK is None
    assert "__bool__" not in torch.Tensor.__dict__
    # the wrappers decide from the tensor: a fake one takes the plain
    # version whatever ``impl`` asks; a real one as it always did
    with FakeTensorMode() as mode:
        fake = mode.from_tensor(torch.ones(2, 4))
    assert _build.use_plain("t", fake, "kernel")
    with pytest.raises(tmx.MXNetError, match="needs CUDA tensors"):
        _build.use_plain("t", torch.ones(2, 4), "kernel")


def test_audit_records_only_its_own_thread():
    """Another thread's host reads and ops during an audit are not the
    audited program's: no finding, no op in the abstract pass's list."""
    other = tmx.np.ones((3,))
    reads = []

    def f(x):
        t = threading.Thread(target=lambda: reads.append(
            (other + 1).asnumpy().tolist()))
        t.start()
        t.join()
        return (x * 2).sum()

    rep = tmx.analysis.audit(f, tmx.np.ones((4, 4)))
    assert reads == [[2.0] * 3] * 2            # ran in both passes
    assert len(rep) == 0 and rep.by_kind("host-sync") == []
    assert "add" not in rep.jaxpr and "multiply" in rep.jaxpr


def test_analysis_knob_raise_and_warn(monkeypatch, caplog):
    f, args, _ = _sync(tmx)
    monkeypatch.setenv("MXNET_ANALYSIS", "raise")
    with pytest.raises(tmx.MXNetError, match="MXNET_ANALYSIS=raise"):
        tmx.analysis.audit(f, *args)
    monkeypatch.setenv("MXNET_ANALYSIS", "warn")
    with caplog.at_level(logging.WARNING, "incubator_mxnet_tpu_torch.analysis"):
        rep = tmx.analysis.audit(f, *args)
    assert len(rep) > 0
    assert any("host-sync" in r.message for r in caplog.records)
    how, doc = tmx.util.env_knobs()["MXNET_ANALYSIS"]
    assert "analysis" in how and "raise" in doc


def test_jit_cache_report_names_recapture_churn(monkeypatch):
    owners = {(0, i): "graph:cached_op:Net" for i in range(9)}
    owners[(0, 99)] = "graph:train.DataParallel.step"
    monkeypatch.setattr(_graphs, "pool_owners", lambda: owners)
    rep = tmx.analysis.jit_cache_report(threshold=8)
    churn = rep.by_kind("recompile-cache-churn")
    assert [x.op for x in churn] == ["graph:cached_op:Net"]
    assert isinstance(rep.ledger, dict)
    assert not tmx.analysis.jit_cache_report(threshold=10).by_kind(
        "recompile-cache-churn")


def test_jit_cache_report_joins_the_ledger():
    from incubator_mxnet_tpu_torch.telemetry import compiles

    compiles.reset()
    compiles.enable()
    try:
        x = torch.zeros(2, 3)
        compiles.record_compile("cached_op:Net", 0.01, args=(x,))
        compiles.record_compile("cached_op:Net", 0.01,
                                args=(torch.zeros(4, 3),))
        rep = tmx.analysis.jit_cache_report()
    finally:
        compiles.disable()
        compiles.reset()
    notes = rep.by_kind("recompile-forensics")
    assert notes and notes[0].op == "cached_op:Net"
    assert "shape" in notes[0].message and notes[0].severity == "warn"


def test_findings_classes_match_reference():
    from incubator_mxnet_tpu.analysis import findings as jf
    from incubator_mxnet_tpu_torch.analysis import findings as tf

    assert tf.HAZARD_KINDS == jf.HAZARD_KINDS
    assert tf.SHARD_RULES == jf.SHARD_RULES and tf.RACE_RULES == jf.RACE_RULES
    for mod in (jf, tf):
        r = mod.ShardReport("t", {"dp": 2})
        r.add_rule("SC002", "x", nbytes=8)
        rr = mod.RaceReport("t")
        rr.add_rule("RC001", "y", state="s")
        assert r.stamp().startswith("shardcheck[t] findings=1 rules=SC002")
        assert rr.stamp().startswith("racecheck[t] findings=1 rules=RC001")
    rep = tf.AuditReport("t")
    rep.note("host-sync", "m")
    rep.note("host-sync", "m")                 # deduplicated
    rep.note("eager-fallback", "n", severity="info")
    assert len(rep) == 1 and len(rep.notes) == 1
    assert onp.array_equal([f.kind for f in rep], ["host-sync"])
