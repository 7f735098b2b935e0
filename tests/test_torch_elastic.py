"""The port's elastic replica-set controller (`incubator_mxnet_tpu_torch.
serve.elastic`) against the JAX package's, on the CPU.

- the 15 tests of `tests/test_serve_elastic.py` as cases of both packages
  (fixture `pkg`) over each package's own stub decoder (pure host
  arithmetic over the package's allocator and prefix cache): a warmed
  spawn journaled, the ceiling and the drain reuse, indices never reused,
  drains down to the floor, a crash mid-trace replaced with zero failed
  requests, healing after a failed replacement, spawn rollback, the
  funding gate, advice consumed once, the replica gauge, the knobs, the
  missing-factory error;
- the role-aware cases of `tests/test_anatomy.py:405` and
  `tests/test_disagg.py:373,403` on disaggregated stub pods;
- the scale journal (direction, replica, n) equal between the packages
  over one fault schedule;
- one `gpt_tiny` elastic gateway (the weights of `tests/test_serve.py`,
  carried with `load_jax_params`) scaled up, crashed and healed mid-trace:
  its tokens equal the JAX gateway's request by request, and no program
  is built on a replica after it joined the routing set.
"""
from types import SimpleNamespace

import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import np as jnp_
from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.fault import injection as jinjection
from incubator_mxnet_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from incubator_mxnet_tpu.serve import advisor as jadvisor
from incubator_mxnet_tpu.serve import elastic as jelastic
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch.fault import injection as tinjection
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.serve import advisor as tadvisor
from incubator_mxnet_tpu_torch.serve import elastic as telastic
from incubator_mxnet_tpu_torch.telemetry import compiles as tcompiles
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry

VOCAB = 97

PKGS = {
    "ref": SimpleNamespace(serve=jserve, injection=jinjection,
                           elastic=jelastic, advisor=jadvisor,
                           registry=jregistry),
    "port": SimpleNamespace(serve=tserve, injection=tinjection,
                            elastic=telastic, advisor=tadvisor,
                            registry=tregistry),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    p.injection.clear_injection()
    yield p
    p.injection.clear_injection()


class _StubSlots:
    """Paged-interface stand-in over a package's allocator
    (`tests/test_serve_elastic.py:38`): the final prefill chunk emits the
    prompt's length as the first token, decode increments, so a request
    resumed after a replica crash from ``prompt + tokens`` continues the
    same arithmetic run."""

    def __init__(self, pkg, max_slots=2, max_len=64, page_tokens=16,
                 prefill_chunk=64, n_pages=None, page_bytes=2048):
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_tokens = page_tokens
        self.prefill_chunk = prefill_chunk
        self.page_bytes = page_bytes
        pages_per_slot = -(-max_len // page_tokens)
        self.allocator = pkg.serve.PageAllocator(
            n_pages if n_pages is not None
            else max_slots * pages_per_slot + 1, page_tokens)
        self.prefix_cache = pkg.serve.PrefixCache(self.allocator)
        self.released = False
        self.programs = 2          # pretend both families are built

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
        return self.programs

    def release(self):
        self.released = True


def _factory(pkg, cls=_StubSlots):
    return lambda n_pages: cls(pkg, n_pages=n_pages)


def _elastic_gateway(pkg, max_replicas=3, min_replicas=1, **gw_kwargs):
    reg = pkg.serve.ModelRegistry()
    reg.add("m", _StubSlots(pkg))
    gw = pkg.serve.Gateway(reg, **gw_kwargs)
    ctl = gw.enable_elastic(factories={"m": _factory(pkg)},
                            min_replicas=min_replicas,
                            max_replicas=max_replicas)
    return gw, ctl


def _disagg_gateway(pkg, n_prefill=1, n_decode=1):
    stubs = ([_StubSlots(pkg) for _ in range(n_prefill)]
             + [_StubSlots(pkg) for _ in range(n_decode)])
    reg = pkg.serve.ModelRegistry()
    reg.add("m", stubs, prefill_replicas=n_prefill, decode_replicas=n_decode)
    return pkg.serve.Gateway(reg), stubs


def _prompt(n, seed=0):
    return onp.random.RandomState(seed).randint(
        0, VOCAB, (n,)).astype(onp.int32)


def _drive(gw, handles, steps=400):
    for _ in range(steps):
        gw.step()
        if all(h.done for h in handles):
            return
    raise AssertionError(
        f"requests not done: {[h.state for h in handles]}")


def _counter(pkg, name):
    return pkg.registry.report().get(name, {}).get("value", 0) or 0


# ---------------------------------------------------------------------------
# scale-up: spawn, warm, publish
# ---------------------------------------------------------------------------

def test_scale_up_spawns_warmed_replica_and_journals(pkg):
    gw, ctl = _elastic_gateway(pkg)
    try:
        assert ctl.replica_count("m") == 1
        up = 'mx_elastic_scale_events_total{direction="up"}'
        u0 = _counter(pkg, up)
        added = ctl.scale_up("m")
        assert [r.label for r in added] == ["m#1"]
        assert ctl.replica_count("m") == 2
        assert ctl.warm_programs["m#1"] == 2
        assert added[0].sched.idle
        assert _counter(pkg, up) == u0 + 1
        assert [e["direction"] for e in ctl.events] == ["up"]
        hs = [gw.submit("m", _prompt(8, i), 4) for i in range(4)]
        _drive(gw, hs)
        assert {h.state for h in hs} == {"done"}
    finally:
        gw.shutdown(drain=False)


def test_scale_up_respects_ceiling_and_reuses_draining(pkg):
    gw, ctl = _elastic_gateway(pkg, max_replicas=2)
    try:
        ctl.scale_up("m")
        assert ctl.scale_up("m") == []
        assert ctl.replica_count("m") == 2
        ctl.scale_down("m")
        assert ctl.replica_count("m", live_only=True) == 1
        added = ctl.scale_up("m")
        assert len(added) == 1 and not added[0].draining
        assert ctl.replica_count("m") == 2
    finally:
        gw.shutdown(drain=False)


def test_replica_indices_never_reused(pkg):
    gw, ctl = _elastic_gateway(pkg, max_replicas=3)
    try:
        ctl.scale_up("m")
        ctl.scale_down("m")
        gw.step()
        assert ctl.replica_count("m") == 1
        assert [r.label for r in ctl.scale_up("m")] == ["m#2"]
    finally:
        gw.shutdown(drain=False)


# ---------------------------------------------------------------------------
# scale-down: drain, floor
# ---------------------------------------------------------------------------

def test_scale_down_drains_and_never_below_min(pkg):
    gw, ctl = _elastic_gateway(pkg)
    try:
        ctl.scale_up("m", 2)
        assert ctl.replica_count("m") == 3
        assert ctl.scale_down("m", 5) == 2
        assert ctl.replica_count("m", live_only=True) == 1
        assert ctl.scale_down("m") == 0
        gw.step()
        assert ctl.replica_count("m") == 1
        assert _counter(
            pkg, 'mx_elastic_scale_events_total{direction="down"}') >= 2
    finally:
        gw.shutdown(drain=False)


def test_draining_replica_finishes_in_flight_then_retires(pkg):
    gw, ctl = _elastic_gateway(pkg)
    try:
        ctl.scale_up("m")
        hs = [gw.submit("m", _prompt(8, i), 6) for i in range(4)]
        for _ in range(3):
            gw.step()
        victim = next(r for r in gw._models["m"].replicas if r.live)
        ctl.scale_down("m", 1)
        _drive(gw, hs)
        assert {h.state for h in hs} == {"done"}
        gw.step()
        assert ctl.replica_count("m") == 1
        assert victim.sched.idle or not victim.draining
    finally:
        gw.shutdown(drain=False)


# ---------------------------------------------------------------------------
# replica death (chaos): replace + zero failed requests
# ---------------------------------------------------------------------------

def test_replica_crash_mid_trace_replaced_zero_failed(pkg):
    gw, ctl = _elastic_gateway(pkg)
    try:
        ctl.scale_up("m")
        hs = [gw.submit("m", _prompt(8, i), 8) for i in range(6)]
        for _ in range(4):
            gw.step()
        rep = 'mx_elastic_scale_events_total{direction="replace"}'
        r0 = _counter(pkg, rep)
        pkg.injection.configure_injection("replica_crash@1:1.0:0:1")
        gw.step()
        pkg.injection.clear_injection()
        labels = [r.label for r in gw._models["m"].replicas]
        assert "m#1" not in labels and "m#2" in labels
        assert _counter(pkg, rep) == r0 + 1
        _drive(gw, hs)
        assert [h.state for h in hs].count("failed") == 0
        assert {h.state for h in hs} == {"done"}
        for h in hs:
            toks = h.result()
            assert toks == list(range(toks[0], toks[0] + len(toks)))
    finally:
        gw.shutdown(drain=False)


def test_crash_below_min_heals_next_tick_even_if_spawn_fails_once(pkg):
    gw, ctl = _elastic_gateway(pkg)
    try:
        pkg.injection.configure_injection(
            "replica_crash@0:1.0:0:1,replica_spawn:1.0:0:1")
        gw.step()
        pkg.injection.clear_injection()
        assert ctl.replica_count("m") in (0, 1)
        gw.step()
        assert ctl.replica_count("m") == 1
        hs = [gw.submit("m", _prompt(8, i), 4) for i in range(2)]
        _drive(gw, hs)
        assert {h.state for h in hs} == {"done"}
    finally:
        gw.shutdown(drain=False)


# ---------------------------------------------------------------------------
# failed spawn: rollback to N
# ---------------------------------------------------------------------------

def test_spawn_fault_rolls_back_to_n_replicas(pkg):
    gw, ctl = _elastic_gateway(pkg)
    try:
        pkg.injection.configure_injection("replica_spawn:1.0:0:1")
        with pytest.raises(pkg.injection.FaultInjected):
            ctl.scale_up("m")
        pkg.injection.clear_injection()
        assert ctl.replica_count("m") == 1
        assert [r.label for r in gw._models["m"].replicas] == ["m"]
        assert "m#1" not in ctl.warm_programs
        assert [r.label for r in ctl.scale_up("m")] == ["m#1"]
    finally:
        gw.shutdown(drain=False)


def test_warmup_failure_is_rolled_back_and_loud(pkg):
    gw, ctl = _elastic_gateway(pkg)

    class _BadDecode(_StubSlots):
        def decode_step(self, *a, **k):
            raise RuntimeError("device wedged")

    ctl._factories["m"] = _factory(pkg, _BadDecode)
    try:
        with pytest.raises(pkg.elastic.ReplicaScaleError, match="warmup"):
            ctl.scale_up("m")
        assert ctl.replica_count("m") == 1
    finally:
        gw.shutdown(drain=False)


# ---------------------------------------------------------------------------
# page-budget funding gate
# ---------------------------------------------------------------------------

def test_rebalance_pages_funding_gate_is_loud(pkg):
    reg = pkg.serve.ModelRegistry(total_pages=24)
    reg.add("m", _StubSlots(pkg))
    assert reg.rebalance_pages("m", 2) == 12
    assert reg.rebalance_pages("m", 6) == 4
    with pytest.raises(pkg.serve.PagePoolExhausted, match="replica"):
        reg.rebalance_pages("m", 7)
    with pytest.raises(ValueError):
        reg.rebalance_pages("ghost", 2)
    assert pkg.serve.ModelRegistry().rebalance_pages("m", 2) is None


def test_unfunded_scale_up_leaves_fleet_intact(pkg):
    reg = pkg.serve.ModelRegistry(total_pages=16)
    reg.add("m", _StubSlots(pkg, n_pages=8))
    gw = pkg.serve.Gateway(reg)
    ctl = gw.enable_elastic(factories={"m": _factory(pkg)}, max_replicas=8)
    try:
        for _ in range(3):                   # 16/2, 16/3, 16/4 funded
            ctl.scale_up("m")
        with pytest.raises(pkg.serve.PagePoolExhausted):
            ctl.scale_up("m")                # 16/5 < 4: loud, no spawn
        assert ctl.replica_count("m") == 4
    finally:
        gw.shutdown(drain=False)


# ---------------------------------------------------------------------------
# advisor consumption + telemetry
# ---------------------------------------------------------------------------

def _advisor(pkg, gw):
    adv = gw._advisors.get("m")
    if adv is None:
        adv = gw._advisors["m"] = pkg.advisor.AutoscaleAdvisor("m")
    return adv


def test_controller_consumes_each_recommendation_once(pkg):
    gw, ctl = _elastic_gateway(pkg)
    try:
        adv = _advisor(pkg, gw)
        rec = {"t": 10.0, "action": "scale_up", "model": "m", "n": 1,
               "reason": "test", "evidence": {}}
        adv._log.append(rec)
        assert ctl.tick(now=11.0) == 1
        assert ctl.replica_count("m") == 2
        assert ctl.tick(now=12.0) == 0
        assert ctl.replica_count("m") == 2
        adv._log.append(dict(rec, t=20.0, action="scale_down"))
        ctl.tick(now=21.0)
        assert ctl.replica_count("m", live_only=True) == 1
    finally:
        gw.shutdown(drain=False)


def test_mx_serve_replicas_gauge_tracks_fleet(pkg):
    gw, ctl = _elastic_gateway(pkg)
    key = 'mx_serve_replicas{model="m"}'
    try:
        assert _counter(pkg, key) == 1
        ctl.scale_up("m")
        assert _counter(pkg, key) == 2
        ctl.scale_down("m")
        gw.step()
        assert _counter(pkg, key) == 1
    finally:
        gw.shutdown(drain=False)


def test_elastic_serve_knob_arms_controller(pkg, monkeypatch):
    monkeypatch.setenv("MXNET_ELASTIC_SERVE", "1")
    monkeypatch.setenv("MXNET_ELASTIC_MIN_REPLICAS", "1")
    monkeypatch.setenv("MXNET_ELASTIC_MAX_REPLICAS", "4")
    reg = pkg.serve.ModelRegistry()
    reg.add("m", _StubSlots(pkg))
    gw = pkg.serve.Gateway(reg)
    try:
        assert isinstance(gw._elastic, pkg.elastic.ReplicaSetController)
        assert gw._elastic.min_replicas == 1
        assert gw._elastic.max_replicas == 4
    finally:
        gw.shutdown(drain=False)


def test_prebuilt_model_without_factory_raises_clear_error(pkg):
    reg = pkg.serve.ModelRegistry()
    reg.add("m", _StubSlots(pkg))
    gw = pkg.serve.Gateway(reg)
    ctl = gw.enable_elastic()
    try:
        with pytest.raises(ValueError, match="factories"):
            ctl.scale_up("m")
        assert ctl.replica_count("m") == 1
    finally:
        gw.shutdown(drain=False)


# ---------------------------------------------------------------------------
# role awareness on disaggregated pods
# ---------------------------------------------------------------------------

def test_elastic_consumes_role_action_and_pins_role(pkg):
    gw, _stubs = _disagg_gateway(pkg)
    try:
        ctl = gw.enable_elastic(factories={"m": _factory(pkg)},
                                min_replicas=2, max_replicas=4)
        _advisor(pkg, gw)._log.append(
            {"t": 10.0, "action": "scale_up_decode", "model": "m", "n": 1,
             "reason": "test", "evidence": {}})
        assert ctl.tick(now=11.0) == 1
        assert gw._models["m"].replicas[-1].role == "decode"
        assert ctl.tick(now=12.0) == 0
    finally:
        gw.shutdown(drain=False)


def test_elastic_replaces_dead_decode_replica_with_decode_role(pkg):
    gw, _stubs = _disagg_gateway(pkg, n_decode=2)
    ctl = gw.enable_elastic(factories={"m": _factory(pkg)},
                            min_replicas=1, max_replicas=4)
    try:
        m = gw._models["m"]
        assert [r.role for r in m.replicas] == ["prefill", "decode",
                                                "decode"]
        pkg.injection.configure_injection("replica_crash@1:1.0:0:1")
        gw.step()
        pkg.injection.clear_injection()
        assert sorted(r.role for r in m.replicas) == ["decode", "decode",
                                                      "prefill"]
        replaced = [r for r in m.replicas if r.index >= 3]
        assert replaced and replaced[0].role == "decode"
        assert replaced[0].sched.idle
        h = gw.submit("m", _prompt(20), 4)
        _drive(gw, [h])
        assert h.tokens == list(range(20, 24))
    finally:
        pkg.injection.clear_injection()
        gw.shutdown(drain=False)
    assert ctl is not None


def test_elastic_scale_up_adds_decode_and_floor_guards_roles(pkg):
    gw, _stubs = _disagg_gateway(pkg)
    gw.enable_elastic(factories={"m": _factory(pkg)}, min_replicas=1,
                      max_replicas=4)
    ctl = gw._elastic
    try:
        m = gw._models["m"]
        assert [r.role for r in ctl.scale_up("m")] == ["decode"]
        ctl.scale_down("m", n=3)
        alive = [r for r in m.replicas if not r.draining]
        assert sorted(r.role for r in alive) == ["decode", "prefill"]
    finally:
        gw.shutdown(drain=False)


# ---------------------------------------------------------------------------
# the same fault schedule, the same journal
# ---------------------------------------------------------------------------

def _schedule(pkg):
    """Scale up twice, serve, crash replica 1 mid-trace, fail one spawn,
    drain, heal: the journal as (direction, replica, n) and the tokens."""
    gw, ctl = _elastic_gateway(pkg, max_replicas=4)
    try:
        ctl.scale_up("m", 2)
        hs = [gw.submit("m", _prompt(6 + i, i), 5 + i % 3,
                        tenant=("a", "b")[i % 2]) for i in range(8)]
        for _ in range(3):
            gw.step()
        pkg.injection.configure_injection("replica_crash@1:1.0:0:1")
        gw.step()
        pkg.injection.clear_injection()
        _drive(gw, hs)
        ctl.scale_down("m", 2)
        for _ in range(3):
            gw.step()
        pkg.injection.configure_injection(
            "replica_crash@0:1.0:0:1,replica_spawn:1.0:0:1")
        gw.step()
        pkg.injection.clear_injection()
        for _ in range(2):
            gw.step()
        journal = [(e["direction"], e["replica"], e["n"])
                   for e in ctl.scale_log()]
        return journal, [h.result() for h in hs]
    finally:
        pkg.injection.clear_injection()
        gw.shutdown(drain=False)


def test_scale_journal_equal_between_packages():
    ref = _schedule(PKGS["ref"])
    port = _schedule(PKGS["port"])
    assert port == ref
    assert [d for d, _r, _n in port[0]].count("replace") >= 1


# ---------------------------------------------------------------------------
# real engines: gpt_tiny, tokens equal to the JAX gateway's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) with `tests/test_serve.py`'s scaled
    weights carried across."""
    jmx.random.seed(11)
    jm = jax_gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0)
    jm.initialize()
    r = onp.random.RandomState(42)
    for _name, p in jm.collect_params().items():
        if p.shape and len(p.shape) >= 2:
            p.set_data(jnp_.array(r.normal(0, 0.35, p.shape)
                                  .astype("float32")))
    tm = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0, device="cpu",
                  seed=0)
    tm.load_jax_params({n: p.data().asnumpy()
                        for n, p in jm.collect_params().items()})
    return jm, tm


def _real_elastic(serve_mod, injection, model):
    """One elastic gateway over a registry spec (24 x 2 pages, 2 slots of
    64 tokens): scale up with a warmup over the live buckets, serve 6
    requests, crash replica 1 mid-trace (its requests resume on the
    replacement), drive to the end. Returns (tokens, journal, the
    per-replica program counts at publication and at the end)."""
    reg = serve_mod.ModelRegistry(total_pages=48)
    reg.add("gpt", model, max_slots=2, max_len=64)
    gw = serve_mod.Gateway(reg)
    ctl = gw.enable_elastic(min_replicas=1, max_replicas=2,
                            warm_lens=(12, 24, 48), warm_new=2)
    rep0 = gw._models["gpt"].replicas[0]
    for i, n in enumerate((12, 24, 48)):
        seg = rep0.sched.submit(onp.full(n, i + 1, onp.int32), 2)
        while not seg.done:
            rep0.sched.step()
    base = {rep0.label: rep0.slots.xla_program_count()}
    try:
        ctl.scale_up("gpt")
        hs = [gw.submit("gpt", _prompt(9 + 5 * i, 30 + i), 6)
              for i in range(6)]
        for _ in range(4):
            gw.step()
        injection.configure_injection("replica_crash@1:1.0:0:1")
        gw.step()
        injection.clear_injection()
        gw._drive_until(hs, timeout=120.0)
        ends = {r.label: r.slots.xla_program_count()
                for r in gw._models["gpt"].replicas}
        want = {r.label: ctl.warm_programs.get(r.label, base.get(r.label))
                for r in gw._models["gpt"].replicas}
        journal = [(e["direction"], e["replica"], e["n"])
                   for e in ctl.scale_log()]
        return [h.tokens for h in hs], journal, want, ends
    finally:
        injection.clear_injection()
        gw.shutdown(drain=False)


def test_real_engine_elastic_tokens_equal_jax_gateway(pair):
    jm, tm = pair
    tcompiles.reset()
    tcompiles.enable()
    try:
        got, journal, want, ends = _real_elastic(tserve, tinjection, tm)
        led = tcompiles.ledger()
    finally:
        tcompiles.disable()
        tcompiles.reset()
    ref, ref_journal, _, _ = _real_elastic(jserve, jinjection, jm)
    assert journal == ref_journal == [("up", "gpt#1", 2),
                                      ("replace", "gpt#1", 1),
                                      ("up", "gpt#2", 2)]
    assert got == ref
    assert all(len(t) == 6 for t in got)
    # zero programs after publication, by count and by the ledger: every
    # live replica's entries were all made before it served (its warmup)
    assert ends == want
    for label in ends:
        fams = [f for f in led if f.startswith(f"serve:{label}.")]
        assert sum(len(led[f]) for f in fams) == ends[label], label


# ---------------------------------------------------------------------------
# the slice's surface: public signatures as the reference's
# ---------------------------------------------------------------------------

SURFACE = ("telemetry/timeseries.py", "telemetry/burnrate.py",
           "telemetry/goodput.py", "telemetry/hbm.py",
           "telemetry/compiles.py", "serve/advisor.py", "serve/elastic.py",
           "serve/gateway.py", "serve/disagg.py", "serve/api.py",
           # the NDArray slice
           "base.py", "device.py", "autograd.py", "dlpack.py",
           "test_utils.py", "ndarray/ndarray.py", "ndarray/__init__.py",
           "numpy/__init__.py", "numpy/random.py")
# private seams the slice ports (the gateway's advisor tick and arming,
# the census owners' registration)
SEAMS = ("_arm_advisor", "_advise", "_register_hbm_owners")
# the reference's public names the port has no counterpart for, each with
# its reason (ROADMAP.md §1 item 4 lists them): the test fails if the port
# grows one, so the list stays true
NOT_PORTED = {
    "device.py": {"Device.jax_device": "the port has no jax devices "
                                       "(Device.torch_device)"},
    "autograd.py": {"TapeNode": "no second tape: torch's graph is the tape",
                    "TapeNode.__init__": "no second tape",
                    "vjp_cache_info": "no backward-program cache in eager "
                                      "torch"},
    "ndarray/ndarray.py": {"_ShapeDtype.__init__": "the tape node's output "
                                                   "record: no second tape"},
}
# npx ops the slices ported: the reference's parameters, in its order and
# with its defaults, lead the port's (which adds `training=` and `impl=`)
NPX_PORTED = ("gelu", "activation", "fully_connected", "embedding",
              "layer_norm", "dropout", "flash_attention",
              "residual_dropout_ln", "gelu_dropout")


def _signatures(path):
    import ast

    out = {}

    def visit(node, prefix=""):
        for n in node.body:
            if isinstance(n, ast.FunctionDef):
                a = n.args
                out[prefix + n.name] = (
                    [x.arg for x in a.posonlyargs + a.args],
                    [ast.unparse(d) for d in a.defaults],
                    [(x.arg, None if d is None else ast.unparse(d))
                     for x, d in zip(a.kwonlyargs, a.kw_defaults)],
                    a.vararg and a.vararg.arg, a.kwarg and a.kwarg.arg)
            elif isinstance(n, ast.ClassDef):
                out[prefix + n.name] = "class"
                visit(n, prefix + n.name + ".")

    with open(path, encoding="utf-8") as f:
        visit(ast.parse(f.read()))
    return out


@pytest.mark.parametrize("rel", SURFACE)
def test_public_signatures_equal_reference(rel):
    """Every public function and method of the slice's modules (and the
    private seams it ports) takes the reference's parameters with the
    reference's defaults, so every call valid in the reference is valid
    in the port."""
    import os

    import incubator_mxnet_tpu
    import incubator_mxnet_tpu_torch

    ref = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu.__file__), rel))
    port = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu_torch.__file__), rel))
    skip = NOT_PORTED.get(rel, {})
    for name in skip:
        assert name in ref and name not in port, (rel, name)
    for name, sig in ref.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("_") and leaf != "__init__" and leaf not in SEAMS:
            continue
        if name in skip:
            continue
        assert port.get(name) == sig, (rel, name, sig, port.get(name))


@pytest.mark.parametrize("name", NPX_PORTED)
def test_npx_signatures_lead_with_the_references(name):
    """Every call of a ported npx op that is valid in the reference is valid
    in the port: the reference's parameters, their order and defaults lead
    the port's, and its ``**kwargs`` stays."""
    import os

    import incubator_mxnet_tpu
    import incubator_mxnet_tpu_torch

    rel = "numpy_extension/__init__.py"
    ref = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu.__file__), rel))[name]
    port = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu_torch.__file__), rel))[name]

    def defaults(sig):
        args, dflt = sig[0], sig[1]
        return dict(zip(args[len(args) - len(dflt):], dflt))

    assert port[0][:len(ref[0])] == ref[0], (name, ref[0], port[0])
    pd = defaults(port)
    assert all(pd.get(a) == d for a, d in defaults(ref).items()), name
    assert ref[4] is None or port[4] == ref[4], name
