"""`analysis.shardcheck` of the port against the JAX package's
(`tests/test_shardcheck.py`'s spec-tier cases), then the port's census
tier on a small mesh step.

The spec tier is the reference's pure math over (shape, dtype, spec,
mesh), so each case runs on both packages and the findings are the same:
rule, severity, site, byte weight, the per-device estimate and the
budget (the messages' first clause; the reference's SC002 names jit).
The reference's jaxpr and compiled-HLO tiers have no port; its census
tier runs one eager step in a 2-rank gloo world
(`torch_worlds/shardcheck.py`): a net that computes with gathered whole
weights shows SC005 (the step all-gathers every cut weight), BERT's
tensor-parallel path on blocks does not, and the trainer's state is put
back after the census.
"""
import os
import sys

import numpy as onp
import pytest

import jax

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.analysis import SHARD_RULES as JRULES
from incubator_mxnet_tpu.analysis import shardcheck as jcheck
from incubator_mxnet_tpu_torch.analysis import SHARD_RULES as TRULES
from incubator_mxnet_tpu_torch.analysis import shardcheck as tcheck
from incubator_mxnet_tpu_torch.analysis.shardcheck import ShapeDtype

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_worlds import world  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
P = jax.sharding.PartitionSpec
BIG = 1024 * 512 * 4      # a (1024, 512) float32 array: 2 MiB


def _pair(shape, spec, dtype="float32", mesh=None, **kw):
    """The same spec-tier call on both packages: (reference, port)."""
    mesh = mesh if mesh is not None else {"dp": 8}
    ref = jcheck(None, jax.ShapeDtypeStruct(shape, onp.dtype(dtype)),
                 mesh=mesh, specs=(None if spec is None else P(*spec),), **kw)
    port = tcheck(None, ShapeDtype(shape, dtype), mesh=mesh,
                  specs=(None if spec is None else tuple(spec),), **kw)
    return ref, port


def _findings(rep):
    # a spec prints as the package writes it: P('dp', None), ('dp', None)
    return [(f.kind, f.severity, f.site, f.nbytes,
             f.message.split(" — ")[0].replace("PartitionSpec", ""))
            for f in rep.findings]


def _same(ref, port):
    assert _findings(port) == _findings(ref), (ref.summary(), port.summary())
    assert port.per_device_bytes == ref.per_device_bytes
    assert port.budget_bytes == ref.budget_bytes
    assert port.n_leaves == ref.n_leaves


@pytest.mark.parametrize("shape,spec,rules", [
    ((1024, 512), None, ["SC001"]),          # 2 MiB, no spec, 8 ranks
    ((1024, 512), (), []),                   # P(): replicated on purpose
    ((8, 4), None, []),                      # small: noise
    ((10, 4), ("dp", None), ["SC002"]),      # 10 % 8
    ((16,), ("dp", None), ["SC002"]),        # more entries than the rank
    ((16, 4), ("zz", None), ["SC003"]),      # an axis the mesh lacks
    ((1024, 512), ("dp", None), []),         # cut: a block of 1/8
])
def test_spec_tier_rules_match_the_reference(shape, spec, rules):
    ref, port = _pair(shape, spec)
    _same(ref, port)
    assert sorted({f.kind for f in port}) == rules
    if rules == ["SC001"]:
        assert port.per_device_bytes == BIG
        assert "replicated" in port.by_rule("SC001")[0].message
    if rules == ["SC003"]:
        assert port.by_rule("SC003")[0].severity == "error"
        assert "'zz'" in port.by_rule("SC003")[0].message


@pytest.mark.parametrize("budget,rules", [(1e-6, ["SC006"]), (16.0, [])])
def test_sc006_budget_matches_the_reference(budget, rules):
    ref, port = _pair((1024, 512), ("dp", None), hbm_budget_gb=budget)
    _same(ref, port)
    assert sorted({f.kind for f in port}) == rules
    assert port.per_device_bytes == BIG // 8


def test_sc006_env_knob_budget(monkeypatch):
    monkeypatch.setenv("MXNET_SHARDCHECK_HBM_GB", "0.0000001")
    ref, port = _pair((1024, 512), None)
    _same(ref, port)
    assert "SC006" in {f.kind for f in port}


def test_rule_catalogue_and_counter():
    assert TRULES == JRULES
    assert sorted(TRULES) == ["SC001", "SC002", "SC003", "SC004", "SC005",
                              "SC006"]
    from incubator_mxnet_tpu.telemetry import registry as jreg
    from incubator_mxnet_tpu_torch.telemetry import registry as treg

    for reg, pair_index in ((jreg, 0), (treg, 1)):
        c = reg.counter("mx_shardcheck_findings_total",
                        labels={"rule": "SC003"})
        before = c.value
        _pair((16, 4), ("nope",))
        assert c.value == before + 1, pair_index


def _trainer(mx, mesh_axes, make_net, loss, opt, specs):
    """A trainer of package ``mx`` (the port's as rank 0's view of a mesh
    of that many ranks, which the spec tier reads)."""
    from importlib import import_module

    par = import_module(mx.__name__ + ".parallel")
    n = int(onp.prod(list(mesh_axes.values())))
    if mx is jmx:
        jmx.random.seed(0)
        net = make_net(mx)
        net.initialize()
        return par.DataParallel(net, loss(mx), opt(mx),
                                mesh=par.make_mesh(mesh_axes),
                                param_shardings=specs(mx, net))
    with tmx.cpu():
        net = make_net(mx)
        net.initialize()
        return par.DataParallel(
            net, loss(mx), opt(mx),
            mesh=par.make_mesh(mesh_axes, devices=range(n)),
            param_shardings=specs(mx, net))


def test_trainer_dryrun_config_passes_clean():
    """The multichip dry run's BERT (TP specs, dp 2 x tp 4, SP): both
    packages' `DataParallel.shardcheck_report()` are clean, with the same
    leaves and per-device estimate."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")

    def make_net(mx):
        from importlib import import_module

        bert = import_module(mx.__name__ + ".models.bert")
        kw = {} if mx is jmx else {"device": "cpu"}
        return bert.bert_small(vocab_size=256, max_length=32, dropout=0.1,
                               seq_shard_axis="tp", **kw)

    def loss(mx):
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        return lambda out, y: ce(out[0].reshape(-1, 256), y.reshape(-1))

    def specs(mx, net):
        from importlib import import_module

        return import_module(mx.__name__ + ".models.bert") \
            .tp_param_shardings(net)

    jdp, tdp = (_trainer(mx, {"dp": 2, "tp": 4}, make_net, loss,
                         lambda m: m.optimizer.Adam(learning_rate=1e-4),
                         specs) for mx in (jmx, tmx))
    ref, port = jdp.shardcheck_report(), tdp.shardcheck_report()
    assert len(port) == 0 and len(ref) == 0, port.summary()
    assert port.n_leaves == ref.n_leaves
    assert port.per_device_bytes == ref.per_device_bytes
    assert port.stamp().startswith("shardcheck[DataParallel.step]")


def test_trainer_construction_knob_raises_on_seeded_defect(monkeypatch):
    """``MXNET_SHARDCHECK=raise``: a weight of 3 rows cut over 8 ranks is
    refused at construction (SC002) on both packages."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from incubator_mxnet_tpu.base import MXNetError as JErr
    from incubator_mxnet_tpu_torch.base import MXNetError as TErr

    monkeypatch.setenv("MXNET_SHARDCHECK", "raise")
    for mx, err in ((jmx, JErr), (tmx, TErr)):
        with pytest.raises(err, match="SC002"):
            _trainer(mx, {"dp": 8}, lambda m: m.gluon.nn.Dense(3, in_units=4),
                     lambda m: m.gluon.loss.L2Loss(),
                     lambda m: m.optimizer.SGD(),
                     lambda m, net: [
                         P("dp", None) if m is jmx else ("dp", None),
                         P() if m is jmx else ()])


@pytest.fixture(scope="module")
def census(tmp_path_factory):
    return world.spawn(os.path.join(HERE, "torch_worlds", "shardcheck.py"),
                       2, tmp_path_factory.mktemp("shardcheck_world"))


def test_census_tier_counts_a_mesh_step(census):
    """One eager step counted by op: a Dense net with a cut weight and
    bias that it computes with whole all-gathers them every step (SC005:
    one flat all-gather carrying both); BERT's TP path on blocks exchanges its qkv rows
    (all-to-all), its activations (all-gather, reduce-scatter) and its
    shares (all-reduce) with no finding; neither is flagged SC004 (every
    stored tensor is updated in place), and the trainer's state after the
    census is the state before it."""
    for r in census:
        dense, bert = r["dense"], r["bert"]
        assert "census" in dense["tiers"] and "census" in bert["tiers"]
        assert dense["rules"] == ["SC005"], dense["summary"]
        assert dense["collectives"]["all-gather"] == {
            "count": 1, "bytes": (64 * 32 + 64) * 4}
        assert bert["rules"] == [], bert["summary"]
        assert {"all-to-all", "all-gather", "reduce-scatter",
                "all-reduce"} <= set(bert["collectives"])
        assert sum(c["count"] for c in bert["collectives"].values()) \
            == bert["step_exchanges"]
        assert r["restored"]
        assert r["forbidden"] == []
