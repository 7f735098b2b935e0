"""Cases of `test_torch_sharded_serve.py`, run by each rank of a 4-rank
gloo world (`world.py`). Rank 0 is the front: it runs every case; ranks
1-3 run `serve.sharded._serve_shards` until the front stops them. The
weights (the JAX package's `gpt_tiny`, as numpy) come from the pickle at
``$MX_CASE_INPUT``."""
import os
import pickle

import numpy as onp
import torch

from incubator_mxnet_tpu_torch import serve
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.serve import sharded
from incubator_mxnet_tpu_torch.serve.gateway import Gateway, ModelRegistry
from incubator_mxnet_tpu_torch.serve.scheduler import Scheduler
from incubator_mxnet_tpu_torch.serve.sharded import (ShardedSlotDecoder,
                                                     serve_mesh)

VOCAB = 97


def prompt(n, seed=0):
    return onp.random.RandomState(seed).randint(
        0, VOCAB, (n,)).astype(onp.int32)


def serve_tokens(slots, prompts, max_new=10):
    sched = Scheduler(slots, max_queue=16, seed=0)
    reqs = [sched.submit(p, max_new, temperature=1.0) for p in prompts]
    for _ in range(4000):
        sched.step()
        if all(r.done for r in reqs):
            break
    assert all(r.done for r in reqs)
    return [r.result() for r in reqs]


def _net(params):
    net = gpt_tiny(vocab_size=VOCAB, max_length=64, dropout=0.0,
                   device="cpu", seed=0)
    net.load_jax_params(params)
    return net


def _report(rep):
    return {fam: {"rules": [f.rule for f in r.findings],
                  "messages": [f.message for f in r.findings],
                  "collectives": dict(r.collectives),
                  "donated": int(r.donated_bytes),
                  "per_device": int(r.per_device_bytes),
                  "tiers": list(r.tiers)}
            for fam, r in rep.items()}


def _first_decode(first):
    """Wrap the shard's decode step to keep its first call's inputs and
    logits (the front's own share of a tp mesh)."""
    step, sample = sharded._Shard.decode_step, sharded._Shard._sample_slots

    def decode_step(self, last_tok, pos, active, key, temperature):
        if "pos" not in first:
            first.update(pos=onp.array(pos), last=onp.array(last_tok),
                         active=onp.array(active), armed=True)
        out = step(self, last_tok, pos, active, key, temperature)
        first["armed"] = False
        return out

    def sample_slots(self, logits, key, temperature):
        if first.get("armed"):
            first["logits"] = logits.detach().numpy().copy()
        return sample(self, logits, key, temperature)

    sharded._Shard.decode_step = decode_step
    sharded._Shard._sample_slots = sample_slots


def _front(params):
    out = {}
    net = _net(params)
    prompts = [prompt(7, seed=1), prompt(11, seed=2)]
    kw = dict(max_slots=2, max_len=64, n_pages=24)

    base = serve.SlotDecoder(net, **kw)
    out["base"] = serve_tokens(base, prompts)
    base_pages = _pages_of(base, prompts[1])
    base.release()

    # a mesh of one: the front alone, no record leaves it
    one = ShardedSlotDecoder(net, mesh=serve_mesh({"tp": 1}), **kw)
    out["one"] = serve_tokens(one, prompts)
    out["one_exchanges"] = one._local._group is not None
    one.release()

    try:
        ShardedSlotDecoder(net, mesh=serve_mesh({"tp": 3}), **kw)
    except ValueError as e:
        out["divisible"] = str(e)

    # tp 2 over ranks (0, 1): parity, steady state, the pre-flight
    first = {}
    _first_decode(first)
    sh = ShardedSlotDecoder(net, mesh=serve_mesh({"tp": 2}), **kw)
    out["tp2"] = serve_tokens(sh, prompts)
    out["first"] = {k: v for k, v in first.items() if k != "armed"}
    programs = sh.xla_program_count()
    serve_tokens(sh, [prompt(9, seed=s) for s in range(6)])
    out["programs"] = (programs, sh.xla_program_count())
    out["report"] = _report(sh.shardcheck_report())
    out["pool_bytes"] = sum(t.numel() * t.element_size()
                            for t in sh._local._pool_leaves())
    out["pool_shape"] = tuple(sh._local._pk[0].shape)
    out["whole_cache_bytes"] = sh.cache_bytes
    out["crosscheck"] = sh.hbm_crosscheck()
    # whole pages back from the mesh: the unsharded engine's, head for head
    out["pages"] = (_pages_of(sh, prompts[1]), base_pages)
    sh.release()

    i8 = ShardedSlotDecoder(net, mesh=serve_mesh({"tp": 2}),
                            kv_dtype="int8", **kw)
    out["int8"] = serve_tokens(i8, [prompt(7, seed=1)])
    out["int8_report"] = _report(i8.shardcheck_report())
    i8.release()

    gate = ShardedSlotDecoder(net, mesh=serve_mesh({"tp": 2}),
                              hbm_budget_gb=1e-6, **kw)
    out["budget"] = _report(gate.shardcheck_report())
    gate.release()

    out["gateway"] = _gateway(net)
    return out


def _pages_of(eng, p):
    """The whole K/V pages of one prompt prefilled into slot 0 (f32
    numpy, by plane)."""
    pages = eng.allocator.alloc(-(-len(p) // eng.page_tokens))
    eng.set_slot_pages(0, pages)
    eng.prefill_chunk_step(0, p, 0, onp.zeros(2, onp.int64))
    payload = eng.copy_pages_out(pages)
    eng.clear_slot(0)
    eng.allocator.decref(pages)
    return {k: [t.float().numpy() for t in v] for k, v in payload.items()}


def _gateway(net):
    reg = ModelRegistry(total_pages=96)
    reg.add("m", net, replicas=2, mesh="tp=2", max_slots=2, max_len=64)
    gw = Gateway(reg, seed=0)
    out = {}
    try:
        first = [gw.submit("m", prompt(6, seed=s), 8) for s in range(6)]
        for _ in range(4000):
            gw.step()
            if all(r.done for r in first):
                break
        out["done1"] = all(r.done for r in first)
        out["replicas"] = sorted({r.replica for r in first})
        out["meshes"] = [rep.slots.layout.mesh.devices.tolist()
                         for rep in gw._models["m"].replicas]
        inflight = [gw.submit("m", prompt(6, seed=10 + s), 8)
                    for s in range(4)]
        gw.step()
        r = onp.random.RandomState(5)
        for _name, p in net.collect_params().items():
            if p.shape and len(p.shape) >= 2:
                p.set_data(torch.from_numpy(
                    r.normal(0, 0.3, p.shape).astype("float32")))
        out["swap1"] = gw.hot_swap("m")
        for _ in range(4000):
            gw.step()
            if all(q.done for q in inflight):
                break
        out["done2"] = all(q.done for q in inflight)
        out["results"] = [q.result() for q in inflight]
        out["swap2"] = gw.hot_swap("m")
    finally:
        gw.shutdown()
    return out


def run(rank, world):  # noqa: ARG001
    torch.manual_seed(0)
    if rank != 0:
        sharded._serve_shards()
        return {}
    with open(os.environ["MX_CASE_INPUT"], "rb") as f:
        params = pickle.load(f)
    try:
        return _front(params)
    finally:
        sharded._stop_shards()
