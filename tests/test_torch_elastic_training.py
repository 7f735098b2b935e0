"""Elastic training of the port (`fault.elastic`, the elastic resume of
`preemption`) against the JAX package's (`tests/test_fault.py`'s
elastic cases).

The reference simulates a fleet in one process over many devices; the
port runs one process per rank. So the cases that need a fleet run in a
4-rank gloo world at a small BERT (`torch_worlds/elastic.py`): dp 2 x
tp 2 loses one dp replica through the ``topology_change`` seam and gets
it back (shrink then grow), against the same run unfaulted, with the
`ElasticSampler` re-strided exactly once; and a 4-rank checkpoint resumed
on 2 ranks. The rest run on both packages in this process: the seam's
parsing and rank targeting, the sampler across shrink then grow, the
pre-flight abort on silent replication, the disabled controller, the
checkpoint-layout sidecar's keys and fingerprints, and `reshard_state`
on the same numpy leaves.
"""
import json
import os
import pickle
import sys

import numpy as onp
import pytest

import jax

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.fault import elastic as jel
from incubator_mxnet_tpu.fault import injection as jinj
from incubator_mxnet_tpu.fault import retry as jretry
from incubator_mxnet_tpu.parallel import dist as jdist
from incubator_mxnet_tpu_torch.fault import elastic as tel
from incubator_mxnet_tpu_torch.fault import injection as tinj
from incubator_mxnet_tpu_torch.fault import retry as tretry
from incubator_mxnet_tpu_torch.parallel import dist as tdist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_worlds import world  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
P = jax.sharding.PartitionSpec
PKGS = {"ref": (jmx, jinj, jretry, jel), "port": (tmx, tinj, tretry, tel)}
DIST = {"ref": jdist, "port": tdist}


@pytest.fixture(autouse=True)
def _pristine():
    for pkg, (_mx, inj, _r, _e) in PKGS.items():
        DIST[pkg]._reset_membership()
        inj.clear_injection()
    yield
    for pkg, (_mx, inj, _r, _e) in PKGS.items():
        DIST[pkg]._reset_membership()
        inj.clear_injection()


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("kind,shrink,grow", [("shrink=4", 4, None),
                                              ("grow=8", None, 8)])
def test_topology_seam_parse_and_classification(pkg, kind, shrink, grow):
    _mx, inj, retry, _el = PKGS[pkg]
    inj.configure_injection(f"topology_change:1.0:3:2:{kind}")
    info = inj.schedule_info()["topology_change"]
    assert info["kind"] == "topology"
    assert info["shrink"] == shrink and info["grow"] == grow
    with pytest.raises(inj.TopologyChanged) as ei:
        inj.inject_at("topology_change")
    assert (ei.value.shrink, ei.value.grow) == (shrink, grow)
    assert ei.value.non_retryable
    assert retry.classify_exception(ei.value) == "fatal"
    e2 = pickle.loads(pickle.dumps(ei.value))
    assert isinstance(e2, inj.TopologyChanged)
    assert (e2.shrink, e2.grow) == (shrink, grow)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_topology_seam_rank_targeting(pkg):
    mx, inj, _r, _e = PKGS[pkg]
    inj.configure_injection("topology_change@0:1.0:0:1")
    with pytest.raises(mx.fault.FaultInjected):
        inj.inject_at("topology_change")
    inj.clear_injection()
    inj.configure_injection("topology_change@5:1.0:0:9")
    for _ in range(16):
        inj.inject_at("topology_change")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_elastic_sampler_exactly_once_across_shrink_then_grow(pkg):
    mx = PKGS[pkg][0]
    ES = mx.gluon.data.ElasticSampler
    s0 = ES(24, num_shards=2, index=0, shuffle=True, seed=7)
    s1 = ES(24, num_shards=2, index=1, shuffle=True, seed=7)
    it0, it1 = iter(s0), iter(s1)
    drawn = [next(it0) for _ in range(3)] + [next(it1) for _ in range(3)]
    s0.reshard(num_shards=1, index=0)
    it0 = iter(s0)
    drawn += [next(it0) for _ in range(4)]
    consumed = 24 - s0.remaining()
    s0.reshard(num_shards=2, index=0)
    s1b = ES(24, num_shards=2, index=1, shuffle=True, seed=7)
    s1b.reshard(num_shards=2, index=1, consumed=consumed)
    rest = list(s0) + list(s1b)
    assert sorted(drawn + rest) == list(range(24))
    assert s0.remaining() == 0 and s1b.remaining() == 0
    drawn_by[pkg] = drawn + rest


drawn_by = {}


def test_elastic_sampler_draws_the_references_order():
    if len(drawn_by) < 2:
        pytest.skip("runs after the sampler case of both packages")
    assert drawn_by["port"] == drawn_by["ref"]


def _dp(mx, mesh_axes, units, in_units, specs):
    """A Dense(units, in_units) trainer on a (dp, tp) mesh (the port's as
    rank 0's view of a mesh of that many ranks, which the layout and the
    pre-flight read)."""
    n = int(onp.prod(list(mesh_axes.values())))
    mx.random.seed(0)
    if mx is jmx:
        net = mx.gluon.nn.Dense(units, in_units=in_units)
        net.initialize()
        mesh = mx.parallel.make_mesh(mesh_axes, devices=jax.devices()[:n])
        return mx.parallel.DataParallel(
            net, lambda o, y: ((o - y) ** 2),
            mx.optimizer.SGD(learning_rate=0.1, momentum=0.9), mesh=mesh,
            param_shardings=[P(*s) for s in specs])
    with tmx.cpu():
        net = mx.gluon.nn.Dense(units, in_units=in_units)
        net.initialize()
        return mx.parallel.DataParallel(
            net, lambda o, y: ((o - y) ** 2),
            mx.optimizer.SGD(learning_rate=0.1, momentum=0.9),
            mesh=mx.parallel.make_mesh(mesh_axes, devices=range(n)),
            param_shardings=[tuple(s) for s in specs])


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_elastic_preflight_aborts_on_silent_replication(pkg):
    """A transition that would replicate a large cut parameter (its axis
    is gone) aborts before the epoch turns, naming SC001."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mx, _inj, retry, el = PKGS[pkg]
    dp = _dp(mx, {"dp": 2, "tp": 4}, 512, 512, [(None, "tp"), ()])
    ctl = el.ElasticController(trainer=dp)
    gen0 = DIST[pkg].generation()
    new_mesh = (mx.parallel.make_mesh({"dp": 2}, devices=jax.devices()[:2])
                if mx is jmx else mx.parallel.make_mesh({"dp": 2},
                                                        devices=[0, 1]))
    with pytest.raises(el.ElasticTransitionAborted) as ei:
        ctl._preflight(new_mesh)
    got = [(f.rule, f.severity, f.nbytes) for f in ei.value.findings]
    assert ("SC001", "warn", 512 * 512 * 4) in got, got
    assert "SC001" in str(ei.value)
    assert retry.classify_exception(ei.value) == "fatal"
    assert DIST[pkg].generation() == gen0
    preflight[pkg] = got


preflight = {}


def test_elastic_preflight_findings_match_the_reference():
    if len(preflight) < 2:
        pytest.skip("runs after the pre-flight case of both packages")
    assert preflight["port"] == preflight["ref"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_elastic_controller_disabled_is_noop(pkg, monkeypatch):
    _mx, inj, _r, el = PKGS[pkg]
    inj.configure_injection("topology_change:1.0:0:9:shrink=4")
    monkeypatch.setenv("MXNET_ELASTIC", "0")
    assert el.ElasticController().poll() == "stable"
    assert inj.schedule_info()["topology_change"]["fired"] == 0


def test_checkpoint_layout_matches_the_references():
    """`checkpoint_layout` of the same trainer (Dense(64, in_units=32) on
    dp 2 x tp 2, its weight cut over tp, momentum SGD): the same keys,
    mesh and per-leaf fingerprints (the device and process counts are
    each runtime's own). The reference's momentum takes the weight's
    layout at its first step; the port's is made on the block at
    construction, so the reference is read after one step."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    specs = [("tp", None), ()]
    jdp = _dp(jmx, {"dp": 2, "tp": 2}, 64, 32, specs)
    ones = onp.ones((8, 32), "float32"), onp.ones((8, 64), "float32")
    jdp.step(*(jmx.np.array(a) for a in ones))
    ref = jel.checkpoint_layout(jdp)
    port = tel.checkpoint_layout(_dp(tmx, {"dp": 2, "tp": 2}, 64, 32, specs))
    assert sorted(port) == sorted(ref)
    for key in ("format", "generation", "mesh", "leaves"):
        assert port[key] == ref[key], key
    assert json.loads(json.dumps(port)) == port
    assert port["leaves"]["param/0"] == ["tp"]


def test_reshard_state_matches_the_reference_bit_for_bit():
    """`reshard_state` on the same numpy leaves and fingerprints: the
    port's rank-0 blocks are the reference's device-0 shards, bit for
    bit (axes the new mesh lacks degrade to replicated on both)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    r = onp.random.RandomState(0)
    tree = {"w": r.normal(size=(8, 6)).astype("float32"),
            "b": r.normal(size=(6,)).astype("float32"),
            "v": r.normal(size=(4, 8)).astype("float32")}
    # leaves in key order: b, v, w
    fps = [["tp"], [None, ["dp", "tp"]], ["zz", "tp"]]
    jmesh = jmx.parallel.make_mesh({"dp": 2, "tp": 2},
                                   devices=jax.devices()[:4])
    tmesh = tmx.parallel.make_mesh({"dp": 2, "tp": 2}, devices=range(4))
    ref = jel.reshard_state(tree, None, jmesh, specs=fps)
    port = tel.reshard_state(tree, None, tmesh, specs=fps)
    dev0 = jax.devices()[0]
    for k in tree:
        shard = [s for s in ref[k].addressable_shards if s.device == dev0]
        want = onp.asarray(shard[0].data)
        got = port[k].numpy()
        assert got.shape == want.shape, k
        assert (got == want).all(), k
    assert tel.reshard_state(tree, None, None) is not None


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_world")
    return world.spawn(os.path.join(HERE, "torch_worlds", "elastic.py"), 4,
                       tmp, env={"MX_CASE_DIR": str(tmp)}, timeout=300)


def test_shrink_then_grow_converges(fleet):
    """Ranks 2 and 3 leave at the first step boundary and come back at
    the second: the survivors' mesh is dp 1 x tp 2, their parameters
    after resharding the pre-transition ones bit for bit, the fleet ends
    on generation 2 back on dp 2 x tp 2 with every rank's final loss the
    unfaulted run's (the global batch is the same), and a collective
    under the old generation fails."""
    for r in fleet:
        assert r["losses_False"][-1] < r["losses_False"][0]
        onp.testing.assert_allclose(r["losses_True"][-1],
                                    r["losses_False"][-1], rtol=1e-4)
        assert r["mesh_True"] == {"dp": 2, "tp": 2}
        assert r["generation_True"] == 2
        assert r["stale"] and "stale membership" in r["stale"]
        if r["rank"] < 2:
            assert r["verdicts_True"][:2] == ["shrunk", "grown"]
            assert r["survivors_mesh"] == {"dp": 1, "tp": 2}
            assert r["resharded_bits"]
        else:
            assert r["verdicts_True"][:2] == ["leave", "grown"]
            assert r["left_at"] == 0
        assert set(r["verdicts_False"]) == {"stable"}
        for n, want in r["unfaulted_whole"].items():
            onp.testing.assert_allclose(r["final_whole"][n].numpy(),
                                        want.numpy(), rtol=1e-4, atol=1e-5,
                                        err_msg=n)


def test_sampler_is_restrided_exactly_once(fleet):
    """The controller re-strides each rank's `ElasticSampler` at both
    transitions: across every rank's draws, each index once."""
    for key in ("drawn_False", "drawn_True"):
        allx = sorted(x for r in fleet for x in r[key])
        assert allx == list(range(64)), key


def test_resume_across_device_count(fleet):
    """A checkpoint of the 4-rank run (layout sidecar: mesh dp 2 x tp 2,
    4 devices) resumed on 2 ranks: refused with MXNET_ELASTIC=0, else
    resharded, the parameters the saved ones bit for bit and the next
    step's loss the 4-rank run's."""
    for r in fleet:
        side = r["side"]
        assert side["format"] == 2 and side["device_count"] == 4
        assert side["mesh"] == {"axes": [["dp", 2], ["tp", 2]]}
        assert any(k.startswith("param/") for k in side["leaves"])
        if r["rank"] < 2:
            assert "MXNET_ELASTIC=0" in r["refused"]
            assert r["resumed_step"] == 3
            assert r["resumed_bits"]
            assert abs(r["loss_b"] - r["loss_ref"]) <= 1e-4
    assert all(r["forbidden"] == [] for r in fleet)


@pytest.mark.parametrize("rel", ["fault/elastic.py", "analysis/shardcheck.py"])
def test_public_signatures_lead_with_the_references(rel):
    """Every public function and method of the two modules takes the
    reference's parameters, in its order and with its defaults, first:
    every call valid in the reference is valid in the port (the port adds
    trailing keywords: the surviving ranks and the joining side of a
    transition)."""
    from test_torch_elastic import _signatures

    ref = _signatures(os.path.join(os.path.dirname(jmx.__file__), rel))
    port = _signatures(os.path.join(os.path.dirname(tmx.__file__), rel))
    for name, sig in ref.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("_") and leaf not in ("__init__", "_preflight"):
            continue
        got = port.get(name)
        assert got is not None, (rel, name)
        if sig == "class":
            assert got == "class", (rel, name)
            continue
        args, defaults, kwonly, var, kw = sig
        assert got[0][:len(args)] == args, (rel, name, got)
        assert got[1][:len(defaults)] == defaults, (rel, name, got)
        assert (got[2], got[3], got[4]) == (kwonly, var, kw), (rel, name)
