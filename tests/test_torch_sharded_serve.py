"""The port's sharded serving (`serve.sharded`: `ServeLayout`,
`ShardedSlotDecoder`, `parse_mesh_spec`, `serve_mesh`;
`router.replica_meshes`; the gateway's ``mesh=``) against the JAX
package's, the cases of `tests/test_sharded_serve.py`.

- The layout, mesh-spec and router cases run on both packages (fixture
  ``pkg``) and must agree: the rule table, every decoder leaf matched by
  exactly one rule (the same leaf paths in both), the unmatched-leaf
  raise, heavy leaves and pools on tp, the grammar, disjoint replica
  meshes and their error, and the router's picks over stub replicas.
- The engine cases run in one 4-rank gloo world on the CPU
  (`torch_worlds/sharded_serve.py`: rank 0 the front, ranks 1-3 its
  shards) at `gpt_tiny` (vocab 97, 2 layers, 4 heads) with the JAX
  package's weights (`tests/test_sharded_serve.py`'s `net`) carried
  across through numpy. Greedy tokens on a mesh of one equal the port's
  unsharded engine bit for bit; on tp = 2 they equal the JAX
  `ShardedSlotDecoder`'s on 2 virtual devices, and the first decode
  step's logits (the front's share, which holds every head's logits
  after the all-reduces) agree with the JAX model's at those positions
  within 1e-4 (f32, two frameworks, tp partial sums). The program count
  stays flat under 3x more traffic; `shardcheck_report` is clean on both
  families, the decode census holds all-reduces (3 a layer) and no
  all-gather, and the pools are written in place (SC004 absent, every
  pool byte donated); int8 KV runs clean; SC006 fires at
  ``hbm_budget_gb=1e-6``; whole pages copied out of the tp mesh equal the
  unsharded engine's within 1e-5; the gateway's ``replicas=2,
  mesh="tp=2"`` routes to both replicas (ranks (0, 1) and (2, 3)), and
  `hot_swap` completes a stream with no failed request, then is a no-op.
"""
import os
import pickle
import sys

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import np as jnp_mx
from incubator_mxnet_tpu.models.decoding import GPTDecoder as JGPTDecoder
from incubator_mxnet_tpu.models.gpt import gpt_tiny as jgpt_tiny
from incubator_mxnet_tpu.serve import router as jrouter
from incubator_mxnet_tpu.serve import sharded as jsharded
from incubator_mxnet_tpu.serve.scheduler import Scheduler as JScheduler

from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.serve import router as trouter
from incubator_mxnet_tpu_torch.serve import sharded as tsharded
from incubator_mxnet_tpu_torch.serve.engine import _param_tree

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_worlds import world  # noqa: E402
from torch_worlds.sharded_serve import VOCAB, prompt  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
PKGS = {"ref": (jsharded, jrouter), "port": (tsharded, trouter)}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return request.param


def _mesh(name, tp):
    sh = PKGS[name][0]
    if name == "ref":
        import jax

        return sh.serve_mesh({"tp": tp}, devices=jax.devices()[:tp])
    return sh.serve_mesh({"tp": tp}, devices=range(tp))


@pytest.fixture(scope="module")
def jnet():
    jmx.random.seed(11)
    m = jgpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0)
    m.initialize()
    r = onp.random.RandomState(42)
    for _name, p in m.collect_params().items():
        if p.shape and len(p.shape) >= 2:
            p.set_data(jnp_mx.array(
                r.normal(0, 0.35, p.shape).astype("float32")))
    return m


@pytest.fixture(scope="module")
def params(jnet):
    return {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}


@pytest.fixture(scope="module")
def front(params, tmp_path_factory):
    """Rank 0's results of the 4-rank world (started before the JAX
    engine below compiles, so the two overlap)."""
    tmp = tmp_path_factory.mktemp("sharded_serve")
    path = os.path.join(str(tmp), "input.pkl")
    with open(path, "wb") as f:
        pickle.dump(params, f)
    w = world.World(os.path.join(HERE, "torch_worlds", "sharded_serve.py"),
                    4, tmp, env={"MX_CASE_INPUT": path})
    yield w
    for p in w.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def ranks(front, jref):  # noqa: ARG001 - the JAX engine first, then wait
    res = front.results()
    for r in res:
        assert r["forbidden"] == [], r["forbidden"]
    return res


def _serve_ref(slots, prompts, max_new=10):
    sched = JScheduler(slots, max_queue=16, seed=0)
    reqs = [sched.submit(p, max_new, temperature=1.0) for p in prompts]
    for _ in range(4000):
        sched.step()
        if all(r.done for r in reqs):
            break
    return [r.result() for r in reqs]


@pytest.fixture(scope="module")
def jref(jnet, front):  # noqa: ARG001 - runs while the world does
    prompts = [prompt(7, seed=1), prompt(11, seed=2)]
    sh = jsharded.ShardedSlotDecoder(jnet, mesh=_mesh("ref", 2), max_slots=2,
                                     max_len=64, n_pages=24)
    try:
        toks = _serve_ref(sh, prompts)
    finally:
        sh.release()
    try:
        jsharded.ShardedSlotDecoder(jnet, mesh=_mesh("ref", 3), max_slots=2,
                                    max_len=64, n_pages=16)
    except ValueError as e:
        divisible = str(e)
    return {"tp2": toks, "divisible": divisible}


# ---------------------------------------------------------------------------
# layout rules, mesh specs, replica meshes — both packages
# ---------------------------------------------------------------------------

def _leaf_paths(name, jnet, params):
    if name == "ref":
        import jax

        flat, _ = jax.tree_util.tree_flatten_with_path(
            JGPTDecoder(jnet)._params)
        return sorted({jsharded._path_str(p) for p, _leaf in flat})
    net = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0,
                   device="cpu", seed=0)
    net.load_jax_params(params)
    return sorted(set(tsharded._leaf_paths(_param_tree(net))))


def test_every_param_leaf_matches_exactly_one_rule(jnet, params):
    paths = {}
    for name in PKGS:
        layout = PKGS[name][0].ServeLayout(_mesh(name, 1))
        paths[name] = _leaf_paths(name, jnet, params)
        assert paths[name]
        for p in paths[name]:
            hits = [rx.pattern for rx, _ in layout._compiled
                    if rx.search(p)]
            assert len(hits) == 1, (name, p, hits)
            layout.spec_for(p)
    assert paths["ref"] == paths["port"]
    assert (tsharded.ServeLayout(_mesh("port", 2)).describe()
            == jsharded.ServeLayout(_mesh("ref", 2)).describe())


def test_placement_gives_rank_zero_the_references_device_zero_block(
        jnet, params):
    """`ServeLayout.place_params`/`place_pools` at tp = 2: rank 0's blocks
    have the shapes of the reference's device-0 shards (its layers
    stacked: their leading axis dropped), and `sharding` strips trailing
    None entries as the reference's does."""
    import jax

    jl = jsharded.ServeLayout(_mesh("ref", 2))
    tl = tsharded.ServeLayout(_mesh("port", 2))
    jp = jl.place_params(JGPTDecoder(jnet)._params)
    net = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0,
                   device="cpu", seed=0)
    net.load_jax_params(params)
    tp = tl.place_params(_param_tree(net))
    for name, leaves in tp["layers"].items():
        want = jp["layers"][name].addressable_shards[0].data.shape[1:]
        assert all(tuple(t.shape) == want for t in leaves), name
    for key in ("embed", "pos", "lnf_g", "lnf_b"):
        assert tuple(tp[key].shape) == \
            jp[key].addressable_shards[0].data.shape, key
    pool = torch.zeros(24, 4, 16, 16)
    pk, _pv, sk, _sv = tl.place_pools((pool,), (pool,),
                                      (torch.zeros(24, 4),),
                                      (torch.zeros(24, 4),))
    assert tuple(pk[0].shape) == (24, 2, 16, 16)
    assert tuple(sk[0].shape) == (24, 2)
    assert tl.sharding(tl.pool_spec()) == (None, "tp")
    assert tuple(jl.sharding(jl.pool_spec()).spec) == (None, "tp")
    assert jax.device_count() >= 2


def test_unmatched_leaf_raises_no_replicated_fallback(pkg):
    layout = PKGS[pkg][0].ServeLayout(_mesh(pkg, 1))
    with pytest.raises(ValueError, match="no partition rule"):
        layout.spec_for("layers/mystery_w")


def test_heavy_leaves_and_pools_land_on_tp(pkg):
    layout = PKGS[pkg][0].ServeLayout(_mesh(pkg, 2))
    for name in ("layers/qkv_w", "layers/proj_w", "layers/ffn1_w",
                 "layers/ffn2_w"):
        assert "tp" in tuple(layout.spec_for(name)), name
    for name in ("layers/ln1_g", "embed", "pos", "lnf_g"):
        assert "tp" not in tuple(layout.spec_for(name)), name
    assert tuple(layout.pool_spec())[1] == "tp"
    assert tuple(layout.scale_spec())[1] == "tp"


def test_parse_mesh_spec_grammar(pkg):
    parse = PKGS[pkg][0].parse_mesh_spec
    assert parse(4) == {"tp": 4}
    assert parse("4") == {"tp": 4}
    assert parse("tp=2") == {"tp": 2}
    assert parse("fsdp=2,tp=4") == {"fsdp": 2, "tp": 4}
    assert parse("") == {"tp": 1}
    with pytest.raises(ValueError, match="mesh spec"):
        parse("tp:4")


def test_replica_meshes_disjoint_slices(pkg):
    rm = PKGS[pkg][1].replica_meshes
    if pkg == "ref":
        import jax

        devices = jax.devices()
    else:
        devices = range(8)
    meshes = rm("tp=2", 2, devices=devices)
    assert len(meshes) == 2
    seen = [d for m in meshes for d in m.devices.flat]
    assert len(seen) == len(set(seen)) == 4
    with pytest.raises(ValueError, match="need"):
        rm("tp=4", 3, devices=devices)


def test_divisibility_check_is_loud(ranks, jref):
    assert "divisible" in ranks[0]["divisible"]
    assert ranks[0]["divisible"] == jref["divisible"]


# ---------------------------------------------------------------------------
# router logic — stub replicas, both packages
# ---------------------------------------------------------------------------

class _StubCache:
    def __init__(self, warm):
        self._warm = warm

    def shared_tokens(self, prompt):  # noqa: ARG002
        return self._warm


class _StubRep:
    class _Alloc:
        def __init__(self, free, usable):
            self.free_pages = free
            self.usable_pages = usable

    class _Sched:
        def __init__(self, depth):
            self.queue_depth = depth

    class _Slots:
        pass

    def __init__(self, free=8, usable=8, depth=0, warm=None, label="r"):
        self.slots = self._Slots()
        self.slots.allocator = self._Alloc(free, usable)
        if warm is not None:
            self.slots.prefix_cache = _StubCache(warm)
        self.sched = self._Sched(depth)
        self.label = label


def test_router_least_loaded_picks_free_pages(pkg):
    r = PKGS[pkg][1].ReplicaRouter(affinity="off")
    a = _StubRep(free=2, usable=8, label="a")
    b = _StubRep(free=7, usable=8, label="b")
    assert r.pick([a, b]) is b
    c = _StubRep(free=8, usable=8, depth=8, label="c")
    assert r.pick([b, c]) is b
    assert r.pick([a, b], viable=lambda rep: rep is a) is a
    assert r.pick([], viable=None) is None
    assert r.pick([a, b], viable=lambda rep: False) is None


def test_router_prefers_warm_prefix_replica(pkg):
    r = PKGS[pkg][1].ReplicaRouter(affinity="prefix")
    cold = _StubRep(free=8, usable=8, warm=0, label="cold")
    warm = _StubRep(free=2, usable=8, warm=32, label="warm")
    assert r.pick([cold, warm], prompt=prompt(40)) is warm
    cold2 = _StubRep(free=5, usable=8, warm=0, label="cold2")
    assert r.pick([cold, cold2], prompt=prompt(40)) is cold
    assert r.pick([cold, warm], prompt=prompt(40),
                  viable=lambda rep: rep is cold) is cold


def test_router_tenant_affinity_stable_and_validated(pkg):
    r = PKGS[pkg][1].ReplicaRouter(affinity="tenant")
    reps = [_StubRep(label=f"r{i}") for i in range(4)]
    picks = {r.pick(reps, tenant="alice").label for _ in range(5)}
    assert len(picks) == 1
    pref = r.pick(reps, tenant="alice")
    other = r.pick(reps, tenant="alice",
                   viable=lambda rep: rep is not pref)
    assert other is not pref
    with pytest.raises(ValueError, match="affinity"):
        PKGS[pkg][1].ReplicaRouter(affinity="bogus")


# ---------------------------------------------------------------------------
# engines in the 4-rank world
# ---------------------------------------------------------------------------

def test_one_device_mesh_greedy_parity(ranks):
    out = ranks[0]
    assert out["one"] == out["base"]       # bit-identical greedy stream
    assert out["one_exchanges"] is False   # tp 1: no group, in any world


def test_tp_mesh_parity_two_families_and_clean_shardcheck(ranks, jref,
                                                          jnet):
    out = ranks[0]
    assert out["tp2"] == jref["tp2"] == out["base"]
    before, after = out["programs"]
    assert before == after > 0             # 3x more traffic, no new one
    for fam in ("prefill", "decode"):
        rep = out["report"][fam]
        assert rep["rules"] == [], (fam, rep["messages"])
        assert rep["tiers"] == ["spec", "census"]
        # the pools are written in place: every pool byte donated
        assert rep["donated"] == out["pool_bytes"] > 0
    coll = out["report"]["decode"]["collectives"]
    assert set(coll) == {"all-reduce"}     # no all-gather on the hot path
    assert coll["all-reduce"]["count"] == 3 * 2        # 3 a layer
    # each rank holds its heads' pages of the whole pool
    assert out["pool_shape"] == (24, 2, 16, 16)
    assert out["whole_cache_bytes"] == 2 * out["pool_bytes"]
    # the first decode step's logits, against the JAX model's
    first = out["first"]
    prompts = {7: prompt(7, seed=1), 11: prompt(11, seed=2)}
    rows = onp.nonzero(first["active"])[0]
    assert len(rows)
    for s in rows:
        pos = int(first["pos"][s])
        seq = onp.concatenate([prompts[pos], [first["last"][s]]])
        ref = jnet(jnp_mx.array(seq[None].astype(onp.int32))).asnumpy()
        onp.testing.assert_allclose(first["logits"][s], ref[0, pos],
                                    atol=1e-4, rtol=0)
    cc = out["crosscheck"]
    assert 0.9 < cc["ratio"] <= 1.0, cc


def test_tp_mesh_int8_kv_runs_with_clean_shardcheck(ranks):
    out = ranks[0]
    assert out["int8"][0] and len(out["int8"][0]) <= 10
    for fam in ("prefill", "decode"):
        assert out["int8_report"][fam]["rules"] == [], (
            fam, out["int8_report"][fam]["messages"])


def test_hbm_budget_gate_fires_sc006(ranks):
    assert "SC006" in ranks[0]["budget"]["decode"]["rules"]


def test_pages_out_of_a_tp_mesh_are_whole(ranks):
    got, want = ranks[0]["pages"]
    assert set(got) == set(want) == {"k", "v"}
    for name in got:
        for g, w in zip(got[name], want[name]):
            assert g.shape == w.shape
            onp.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_gateway_replicas_route_and_hot_swap_drain_free(ranks):
    gw = ranks[0]["gateway"]
    assert gw["done1"] and gw["replicas"] == ["m#0", "m#1"]
    assert gw["meshes"] == [[0, 1], [2, 3]]
    assert gw["swap1"] == {"m#0": True, "m#1": True}
    assert gw["done2"] and all(gw["results"])
    assert gw["swap2"] == {"m#0": False, "m#1": False}


def test_gateway_single_replica_backcompat(params):
    net = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0,
                   device="cpu", seed=0)
    net.load_jax_params(params)
    reg = tserve.ModelRegistry(total_pages=48)
    reg.add("s", net, max_slots=2, max_len=64)
    gw = tserve.Gateway(reg, seed=0)
    try:
        req = gw.submit("s", prompt(6, seed=1), 6)
        for _ in range(2000):
            gw.step()
            if req.done:
                break
        assert req.done
        assert gw._models["s"].replicas[0].label == "s"
        assert isinstance(gw.xla_program_counts()["s"], int)
    finally:
        gw.shutdown()


def test_sharded_engine_refuses_what_it_does_not_serve(params):
    """Made off the front, or with an fsdp axis of more than one rank, the
    port's engine raises before any record leaves."""
    net = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0,
                   device="cpu", seed=0)
    net.load_jax_params(params)
    mesh = tsharded.serve_mesh({"fsdp": 2, "tp": 2}, devices=range(4))
    with pytest.raises(ValueError, match="fsdp"):
        tsharded.ShardedSlotDecoder(net, mesh=mesh, max_slots=2, max_len=64)
    with pytest.raises(ValueError, match="tensor parallelism"):
        tsharded.ShardedSlotDecoder(net, mesh=mesh, max_slots=2, max_len=64)
    with pytest.raises(ValueError, match="world"):
        tsharded.ShardedSlotDecoder(
            net, mesh=tsharded.serve_mesh({"tp": 2}, devices=range(2)),
            max_slots=2, max_len=64)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_spawn_mesh_takes_the_registered_tail_or_refuses(name):
    """`ReplicaSetController._spawn_mesh`: a model registered with a list
    of meshes gives a scale-up its unused tail, raises past it; a model
    whose meshes are carved from a spec raises (re-carving would move the
    live replicas); a model with no mesh gets None. The messages are the
    reference's."""
    from types import SimpleNamespace

    from incubator_mxnet_tpu.serve import elastic as jelastic
    from incubator_mxnet_tpu.serve import gateway as jgateway
    from incubator_mxnet_tpu_torch.serve import elastic as telastic
    from incubator_mxnet_tpu_torch.serve import gateway as tgateway

    el, gw_mod = (jelastic, jgateway) if name == "ref" else \
        (telastic, tgateway)
    meshes = [_mesh(name, 1), _mesh(name, 1)]
    reg = gw_mod.ModelRegistry()
    reg.add("listed", object(), replicas=1, mesh=meshes)
    reg.add("carved", object(), replicas=1, mesh="tp=1")
    reg.add("plain", object(), replicas=1)
    ctl = el.ReplicaSetController.__new__(el.ReplicaSetController)
    ctl._gw = SimpleNamespace(_registry=reg)
    assert ctl._spawn_mesh(SimpleNamespace(name="listed"), 1) is meshes[1]
    assert ctl._spawn_mesh(SimpleNamespace(name="plain"), 3) is None
    msgs = []
    for model, j in (("listed", 2), ("carved", 1)):
        with pytest.raises(el.ReplicaScaleError) as e:
            ctl._spawn_mesh(SimpleNamespace(name=model), j)
        msgs.append(str(e.value))
    assert "only 2 were registered" in msgs[0]
    assert "factories" in msgs[1]
