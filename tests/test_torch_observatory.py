"""The port's program ledger and device-memory census
(`incubator_mxnet_tpu_torch.telemetry.compiles` and `.hbm`) against the
JAX package's, on the CPU: the tests of `tests/test_telemetry_observatory.
py` — recompile forensics with one fixture per cause (shape, dtype, static
argument, new bucket; ``weak_type`` is jax's alone), the ledger covering
every program family the port builds, the census's first claim and weak
binding, the growth watchdog, the OOM post-mortem (an injected
``RESOURCE_EXHAUSTED`` and a constructed ``torch.cuda.OutOfMemoryError``),
the post-mortem's env override, the off-path cost, the knob table and the
env arming at import.
"""
import glob
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as onp
import pytest
import torch

import jax.numpy as jnp
from incubator_mxnet_tpu.fault import injection as jinjection
from incubator_mxnet_tpu.telemetry import compiles as jcompiles
from incubator_mxnet_tpu.telemetry import hbm as jhbm
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch import util as tutil
from incubator_mxnet_tpu_torch.fault import injection as tinjection
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.telemetry import compiles as tcompiles
from incubator_mxnet_tpu_torch.telemetry import hbm as thbm
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry
from incubator_mxnet_tpu_torch.telemetry import tracing as ttracing

PKGS = {
    "ref": SimpleNamespace(compiles=jcompiles, hbm=jhbm, registry=jregistry,
                           injection=jinjection,
                           ones=lambda shape, dtype="float32":
                           jnp.ones(shape, dtype)),
    "port": SimpleNamespace(compiles=tcompiles, hbm=thbm, registry=tregistry,
                            injection=tinjection,
                            ones=lambda shape, dtype="float32":
                            torch.ones(shape, dtype=getattr(torch, dtype))),
}


def _clean(p):
    p.compiles.disable()
    p.compiles.reset()
    p.hbm.disable()
    p.hbm.disarm_memwatch()
    p.hbm.reset()
    p.injection.clear_injection()
    p.registry.reset()


@pytest.fixture(params=sorted(PKGS))
def armed(request):
    p = PKGS[request.param]
    _clean(p)
    p.compiles.enable()
    p.hbm.enable()
    yield p
    _clean(p)


@pytest.fixture()
def port_armed():
    p = PKGS["port"]
    _clean(p)
    p.compiles.enable()
    p.hbm.enable()
    yield p
    _clean(p)
    ttracing.disable()
    ttracing.reset()


# ---------------------------------------------------------------------------
# recompile forensics: one fixture per cause, each naming the offender
# ---------------------------------------------------------------------------

def test_recompile_cause_shape(armed):
    f = armed.compiles.ledgered_jit(lambda x: x * 2, family="t.shape")
    f(armed.ones((4,)))
    f(armed.ones((8,)))
    e1, e2 = armed.compiles.ledger("t.shape")
    assert e1["cause"] == "first" and e2["cause"] == "shape"
    assert "arg 0" in e2["detail"]
    assert "(4,)" in e2["detail"] and "(8,)" in e2["detail"]
    c = armed.registry.counter("mx_jit_recompiles_total",
                               labels={"program": "t.shape",
                                       "cause": "shape"})
    assert c.value == 1


def test_recompile_cause_dtype(armed):
    f = armed.compiles.ledgered_jit(lambda x: x + 1, family="t.dtype")
    f(armed.ones((4,), "float32"))
    f(armed.ones((4,), "int32"))
    e2 = armed.compiles.ledger("t.dtype")[-1]
    assert e2["cause"] == "dtype" and "arg 0" in e2["detail"]
    assert "float32" in e2["detail"] and "int32" in e2["detail"]


def test_recompile_cause_static_arg(armed):
    f = armed.compiles.ledgered_jit(lambda x, n: x * n, family="t.static",
                                    static_argnums=(1,))
    x = armed.ones((4,))
    f(x, 3)
    f(x, 4)
    e2 = armed.compiles.ledger("t.static")[-1]
    assert e2["cause"] == "static_arg" and "arg 1" in e2["detail"]
    assert "3" in e2["detail"] and "4" in e2["detail"]


def test_recompile_cause_new_bucket(armed):
    f = armed.compiles.ledgered_jit(
        lambda x: x.sum(), family="t.bucket",
        bucket=lambda args, kwargs: int(args[0].shape[0]))
    f(armed.ones((4,)))
    f(armed.ones((8,)))
    f(armed.ones((4,)))                 # a program it has: no entry
    entries = armed.compiles.ledger("t.bucket")
    assert [e["cause"] for e in entries] == ["first", "new_bucket"]
    assert entries[-1]["bucket"] == 8
    rep = armed.compiles.ledger_report()["t.bucket"]
    assert rep["buckets"] == [4, 8]
    assert rep["causes"] == {"new_bucket": 1}


def test_forensics_arity_and_nested_containers(armed):
    c = armed.compiles
    cause, detail = c.diagnose(
        c.signature_of((armed.ones((2,)),)),
        c.signature_of((armed.ones((2,)), armed.ones((2,)))))
    assert cause == "static_arg" and "arity" in detail
    cause, detail = c.diagnose(
        c.signature_of(((armed.ones((2, 2)), armed.ones((3,))),)),
        c.signature_of(((armed.ones((2, 2)), armed.ones((5,))),)))
    assert cause == "shape" and "arg 0[1]" in detail


def test_signatures_equal_between_packages():
    """A torch tensor and a jax array of the same shape and dtype sign
    alike, and so do the static arguments beside them."""
    for args in ((onp.ones((2, 3), "float32"), 3, "x"),
                 ((onp.zeros(4, "int32"), 1.5), None)):
        def conv(a, ones):
            if isinstance(a, onp.ndarray):
                return ones(a.shape, str(a.dtype))
            if isinstance(a, tuple):
                return tuple(conv(v, ones) for v in a)
            return a
        sigs = [p.compiles.signature_of(tuple(conv(a, p.ones)
                                              for a in args))
                for p in (PKGS["ref"], PKGS["port"])]
        norm = [tuple((e[0],) + tuple(str(v).replace("torch.", "")
                                      for v in e[1:]) for e in s)
                for s in sigs]
        assert norm[0] == norm[1]
    assert tcompiles.CAUSES == jcompiles.CAUSES


# ---------------------------------------------------------------------------
# ledger completeness: every program family the port builds reports in
# ---------------------------------------------------------------------------

VOCAB = 64


@pytest.fixture(scope="module")
def tiny():
    return gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0,
                    device="cpu", seed=7)


def _drive_engine(model, n_req=2, census_name=None, **kw):
    eng = tserve.ServeEngine(model, max_slots=2, max_len=64, max_queue=8,
                             **kw)
    if census_name is not None:
        eng._sched.slots.census_name = census_name
    r = onp.random.RandomState(0)
    reqs = [eng.submit(r.randint(0, VOCAB, (5 + 9 * i,)).astype(onp.int32),
                       4) for i in range(n_req)]
    while not all(q.done for q in reqs):
        eng.step()
    return eng


def test_ledger_covers_every_program_family(port_armed, tiny):
    from incubator_mxnet_tpu_torch.optimizer import Adam
    from incubator_mxnet_tpu_torch.parallel import DataParallel

    eng = _drive_engine(tiny)
    spec = _drive_engine(tiny, census_name="spec", spec_k=2, draft=tiny)
    net = torch.nn.Linear(4, 1)
    dp = DataParallel(net, lambda out, y: ((out - y) ** 2).mean(dim=-1),
                      Adam())
    X = torch.zeros(8, 4)
    dp.step(X, X[:, :1])
    dp.step(X, X[:, :1])                # the same signature: no entry
    dp.step(torch.zeros(4, 4), X[:4, :1])

    rep = tcompiles.ledger_report()
    for fam in ("serve.prefill", "serve.decode", "spec.prefill",
                "spec.draft_prefill", "spec.verify", "spec.draft",
                "train.DataParallel.step"):
        assert fam in rep, (fam, sorted(rep))
        assert rep[fam]["compiles"] >= 1
        # no compiler accounting in the port: the XLA fields are None
        assert rep[fam]["flops"] is None and rep[fam]["peak_bytes"] is None
        assert rep[fam]["last_fingerprint"] is None
    own = thbm.census(top_k=0)["owners"]
    assert own["train.params"] == sum(p.numel() * p.element_size()
                                      for p in net.parameters())
    assert own["train.optimizer"] == sum(
        t.numel() * t.element_size() for st in dp.opt_states
        for t in (st if isinstance(st, (list, tuple)) else (st,))
        if isinstance(t, torch.Tensor)) > 0
    assert rep["train.DataParallel.step"]["compiles"] == 2
    assert rep["train.DataParallel.step"]["causes"] == {"shape": 1}
    assert not rep["serve.decode"]["causes"]
    assert rep["serve.prefill"]["buckets"] == [16]
    # the ledger counts what xla_program_count counts, engine by engine
    for name, e in (("serve", eng), ("spec", spec)):
        assert e.xla_program_count() == sum(
            r["compiles"] for f, r in rep.items()
            if f.startswith(name + ".")), name
    first = tcompiles.ledger("serve.decode")[0]
    assert first["cause"] == "first" and first["seconds"] > 0.0


def test_ledger_entries_equal_program_count(port_armed, tiny):
    eng = _drive_engine(tiny, n_req=3)
    slots = eng._sched.slots
    led = tcompiles.ledger()
    assert sum(len(v) for k, v in led.items()
               if k.startswith("serve.")) == slots.xla_program_count()
    assert {e["bucket"] for e in led["serve.prefill"]} == \
        slots._buckets_seen
    # a second drive builds nothing new
    before = slots.xla_program_count()
    r = onp.random.RandomState(5)
    h = eng.submit(r.randint(0, VOCAB, (6,)).astype(onp.int32), 3)
    eng._drive_until([h])
    assert slots.xla_program_count() == before
    assert sum(len(v) for v in tcompiles.ledger().values()) == before


def test_gateway_models_are_attributed_per_model(port_armed, tiny):
    reg = tserve.ModelRegistry()
    reg.add("gpta", tiny, max_slots=2, max_len=64)
    gw = tserve.Gateway(reg)
    r = onp.random.RandomState(1)
    gw.generate("gpta", r.randint(0, VOCAB, (6,)).astype(onp.int32), 3)
    rep = tcompiles.ledger_report()
    assert "serve:gpta.prefill" in rep and "serve:gpta.decode" in rep
    c = thbm.census(top_k=0)
    slots = gw._models["gpta"].replicas[0].slots
    assert c["owners"]["serve:gpta.kv_pool"] == slots.cache_bytes > 0
    assert c["owners"]["serve:gpta.params"] == sum(
        p.numel() * p.element_size() for p in tiny.parameters())
    assert c["detail"]["serve:gpta.kv_pool"]["n_pages"] == slots.n_pages
    assert "serve:gpta.kv_pool.prefix_cache" in c["derived"]
    gw.shutdown()


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------

def test_census_attribution_first_claim_and_weak_binding(armed):
    a = armed.ones((256,))                        # 1 KiB
    b = armed.ones((512,))                        # 2 KiB
    alive = {"on": True}

    def nbytes(x):
        return int(x.nbytes)

    def probe():
        return {"arrays": [a, b], "detail": {"n": 2},
                "derived": {"half": nbytes(a)}} if alive["on"] else None

    armed.hbm.register_owner("t_owner", probe)
    armed.hbm.register_owner("t_dup", lambda: [a])      # second claim loses
    c = armed.hbm.census()
    assert c["owners"]["t_owner"] == nbytes(a) + nbytes(b)
    assert c["owners"]["t_dup"] == 0
    assert c["derived"]["t_owner.half"] == nbytes(a)
    assert c["detail"]["t_owner"] == {"n": 2}
    assert c["total"] >= c["owners"]["t_owner"]
    assert c["unattributed"] == c["total"] - nbytes(a) - nbytes(b)
    assert any(t["owner"] == "t_owner"
               for t in armed.hbm.census(top_k=4096)["top"])
    alive["on"] = False
    assert "t_owner" not in armed.hbm.census()["owners"]
    text = armed.registry.exposition()
    assert "mx_hbm_live_bytes_total" in text
    assert 'mx_hbm_live_bytes{owner="t_dup"}' in text


def test_census_counts_a_storage_once_across_views(port_armed):
    """Owners claim storages: two views of one pool count once, and the
    first claim on the storage wins even through a view."""
    pool = torch.zeros(1024)
    thbm.register_owner("t_pool", lambda: [pool[:512], pool[512:], pool])
    thbm.register_owner("t_view", lambda: [pool[100:200]])
    c = thbm.census(top_k=4096)
    assert c["owners"]["t_pool"] == 4096 and c["owners"]["t_view"] == 0
    assert sum(1 for t in c["top"] if t["owner"] == "t_pool") == 1


def test_watchdog_warns_once_per_streak(armed):
    hoard = []
    warned = []
    for i in range(4):
        hoard.append(armed.ones((1024 * (i + 1),)))
        warned.append(armed.hbm.watchdog_observe(window=3, min_growth=1))
    assert warned[2] is True or warned[3] is True
    hoard.append(armed.ones((1 << 16,)))
    assert armed.hbm.watchdog_observe(window=3, min_growth=1) is False
    assert armed.registry.counter(
        "mx_hbm_watchdog_warnings_total").value == 1


def test_memwatch_thread_observes(port_armed):
    t = thbm.arm_memwatch(0.01)
    try:
        assert t.is_alive()
        deadline = time.monotonic() + 5.0
        while not thbm._WD_SAMPLES:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        thbm.disarm_memwatch()


def test_hbm_crosscheck_waits_for_shardcheck(tiny):
    """`hbm_crosscheck` runs on shardcheck's SC006 estimate (the
    reference's `test_sc006_crosscheck_within_15_percent`): the census
    owners of the engine against the decode step's per-device estimate,
    within 15 %."""
    eng = _drive_engine(tiny)
    xc = eng._sched.slots.hbm_crosscheck()
    assert xc["sc006_bytes"] > 0 and xc["census_bytes"] > 0
    assert 0.85 <= xc["ratio"] <= 1.15, xc
    assert set(xc["owners"]) == {"serve.kv_pool", "serve.params"}


# ---------------------------------------------------------------------------
# OOM post-mortem at the serve_step seam
# ---------------------------------------------------------------------------

def _postmortem(tmp_path, tiny, raise_in_step):
    eng = _drive_engine(tiny)                     # ledger + owners
    raise_in_step(eng)
    r = onp.random.RandomState(3)
    eng.submit(r.randint(0, VOCAB, (6,)).astype(onp.int32), 3)
    with pytest.raises(Exception) as ei:
        eng.step()
    dumps = glob.glob(str(tmp_path / "flightrec_oom_serve_step_*.json"))
    assert len(dumps) == 1, dumps
    with open(dumps[0]) as f:
        payload = json.load(f)
    census = payload["context"]["hbm_census"]
    assert census["owners"]["serve.kv_pool"] > 0
    assert census["owners"]["serve.params"] > 0
    assert census["top"], "top-K buffers missing from the post-mortem"
    ledger = payload["context"]["compile_ledger"]
    assert "serve.decode" in ledger["report"]
    assert "serve.prefill" in ledger["report"]
    assert ledger["tail"]["serve.decode"][-1]["cause"] == "first"
    assert tregistry.counter("mx_oom_postmortems_total",
                             labels={"where": "serve_step"}).value == 1
    # the generic dump is skipped: one dump, the post-mortem's
    assert not glob.glob(str(tmp_path / "flightrec_serve_step_*.json"))
    return ei.value, payload


def test_oom_postmortem_dumps_census_and_ledger(port_armed, tiny, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(tmp_path))
    ttracing.enable()

    def arm(eng):
        tinjection.configure_injection(
            {"serve_step": (1.0, 0, 1, "oom")})

    exc, payload = _postmortem(tmp_path, tiny, arm)
    assert isinstance(exc, tinjection.InjectedResourceExhausted)
    assert thbm.is_resource_exhausted(exc)
    assert payload["error"]["type"] == "InjectedResourceExhausted"
    assert "RESOURCE_EXHAUSTED" in payload["error"]["message"]


def test_oom_postmortem_on_torch_out_of_memory(port_armed, tiny, tmp_path,
                                               monkeypatch):
    """A constructed ``torch.cuda.OutOfMemoryError`` raised from inside
    the engine's step (its decode) takes the same post-mortem."""
    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(tmp_path))
    ttracing.enable()

    def arm(eng):
        def oom(*a, **k):
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        eng._sched.slots.decode_step = oom
        eng._sched.slots.prefill_chunk_step = oom

    exc, payload = _postmortem(tmp_path, tiny, arm)
    assert isinstance(exc, torch.cuda.OutOfMemoryError)
    assert payload["error"]["type"] == "OutOfMemoryError"


def test_non_oom_faults_skip_the_postmortem(port_armed, tiny, tmp_path,
                                            monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(tmp_path))
    eng = _drive_engine(tiny)
    tinjection.configure_injection({"serve_step": (1.0, 0, 1)})
    r = onp.random.RandomState(4)
    eng.submit(r.randint(0, VOCAB, (6,)).astype(onp.int32), 3)
    with pytest.raises(tinjection.FaultInjected):
        eng.step()
    assert not glob.glob(str(tmp_path / "flightrec_oom_*.json"))
    assert not thbm.is_resource_exhausted(ValueError("boring"))
    assert thbm.is_resource_exhausted(
        RuntimeError("CUDA error: out of memory"))
    assert thbm.is_resource_exhausted(
        RuntimeError("CUDA error: CUDA_ERROR_OUT_OF_MEMORY"))


def test_postmortem_env_overrides(monkeypatch):
    for p in PKGS.values():
        _clean(p)
        exc = p.injection.InjectedResourceExhausted("t", 1)
        monkeypatch.delenv("MXNET_OOM_POSTMORTEM", raising=False)
        assert p.hbm.maybe_oom_postmortem("t", exc) is None
        p.hbm.enable()
        monkeypatch.setenv("MXNET_OOM_POSTMORTEM", "0")
        assert p.hbm.maybe_oom_postmortem("t", exc) is None
        _clean(p)


def test_postmortem_alone_through_the_knob(tmp_path, monkeypatch):
    """``MXNET_OOM_POSTMORTEM=1`` dumps with the census off."""
    _clean(PKGS["port"])
    monkeypatch.setenv("MXNET_OOM_POSTMORTEM", "1")
    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(tmp_path))
    path = thbm.maybe_oom_postmortem(
        "t_knob", torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert path and os.path.exists(path)
    assert "hbm_census" in json.load(open(path))["context"]


# ---------------------------------------------------------------------------
# off-path contract
# ---------------------------------------------------------------------------

def test_off_path_ledger_is_dead_and_cheap():
    """Disarmed, the instrumented wrapper adds under 3% of one small op
    of the port (`npx.layer_norm` at 16 x 16 through its wrapper) over
    the raw callable, best of 3 (the reference's gate, :350)."""
    from incubator_mxnet_tpu_torch import npx

    _clean(PKGS["port"])
    assert not tcompiles.is_enabled() and not thbm.is_enabled()
    x = torch.ones(16, 16)

    def f(a):
        return a * 2.0

    w = tcompiles.instrument_jit(f, "t.off")
    w(x)
    assert tcompiles.ledger() == {}
    g, b = torch.ones(16), torch.zeros(16)
    iters = 300

    def rate(fn, *args):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            best = min(best, time.perf_counter() - t0)
        return best / iters

    per_op = rate(npx.layer_norm, x, g, b)
    overhead = rate(w, x) - rate(f, x)
    assert overhead < 0.03 * per_op, (overhead, per_op)


def test_knobs_are_documented():
    knobs = tutil.env_knobs()
    for k in ("MXNET_MEMWATCH_INTERVAL", "MXNET_OOM_POSTMORTEM",
              "MXNET_TS_INTERVAL", "MXNET_TS_SAMPLES", "MXNET_BURN_WINDOWS",
              "MXNET_ADVISOR", "MXNET_ELASTIC_SERVE",
              "MXNET_ELASTIC_MIN_REPLICAS", "MXNET_ELASTIC_MAX_REPLICAS",
              "MXNET_GOODPUT", "MXNET_GATEWAY_MAX_QUEUE",
              "MXNET_FAULT_INJECT", "MXNET_FLIGHTREC_DIR"):
        assert k in knobs, k


def test_env_knobs_arm_observatory_at_import():
    code = (
        "import incubator_mxnet_tpu_torch as mx\n"
        "from incubator_mxnet_tpu_torch.telemetry import (compiles, goodput,"
        " hbm, timeseries, tracing)\n"
        "print(compiles.is_enabled(), hbm.is_enabled(), goodput.is_enabled(),"
        " tracing.is_enabled(), hbm._MEMWATCH_THREAD is not None,"
        " timeseries.is_enabled())\n")
    env = dict(os.environ, MXNET_TELEMETRY="1", MXNET_MEMWATCH_INTERVAL="5",
               MXNET_TS_INTERVAL="5")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "True True True True True True" in out.stdout, out.stdout
    env = {k: v for k, v in os.environ.items()
           if k not in ("MXNET_TELEMETRY", "MXNET_TS_INTERVAL")}
    env["MXNET_GOODPUT"] = "1"
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "False False True False False False" in out.stdout, out.stdout


class _PodStub:
    """A paged-interface stand-in for a disaggregated stub pod (the
    recipe of `tests/test_disagg.py:41`) over a package's allocator."""

    def __init__(self, serve, max_slots=2, max_len=64, page_tokens=16):
        self.max_slots, self.max_len = max_slots, max_len
        self.page_tokens, self.prefill_chunk = page_tokens, 64
        self.page_bytes = 2048
        self.allocator = serve.PageAllocator(
            max_slots * -(-max_len // page_tokens) + 1, page_tokens)
        self.prefix_cache = serve.PrefixCache(self.allocator)

    def set_slot_pages(self, slot, pages):
        pass

    def clear_slot(self, slot):
        pass

    def prefill_chunk_step(self, slot, chunk_tokens, t_start, key,
                           temperature=1.0):
        return int(t_start) + len(chunk_tokens), len(chunk_tokens), 0

    def decode_step(self, last_tok, pos, active, key, temperature):
        return onp.where(active, last_tok + 1, last_tok).astype(onp.int32)

    def xla_program_count(self):
        return 0

    def release(self):
        pass


@pytest.mark.parametrize("which", ["ref", "port"])
def test_decode_prefill_families_reads_the_ledger(which):
    """`disagg.decode_prefill_families` holds both halves: a prefill
    family in the ledger under a decode-role replica's label is evidence,
    one under the prefill replica's is not (both packages)."""
    import incubator_mxnet_tpu.serve as jserve
    from incubator_mxnet_tpu.serve import disagg as jdisagg
    from incubator_mxnet_tpu_torch.serve import disagg as tdisagg

    serve, disagg = ((jserve, jdisagg) if which == "ref"
                     else (tserve, tdisagg))
    comp = PKGS[which].compiles
    _clean(PKGS[which])
    comp.enable()
    try:
        reg = serve.ModelRegistry()
        reg.add("m", [_PodStub(serve), _PodStub(serve)], prefill_replicas=1,
                decode_replicas=1)
        gw = serve.Gateway(reg)
        comp.record_compile("serve:m#0.prefill", 0.01)
        assert disagg.decode_prefill_families(gw, "m") == {}
        comp.record_compile("serve:m#1.prefill", 0.01)
        assert disagg.decode_prefill_families(gw, "m") == {
            "m#1": ["ledger:serve:m#1.prefill"]}
        gw.shutdown(drain=False)
    finally:
        _clean(PKGS[which])
