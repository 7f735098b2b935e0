"""The port's ring attention, GPipe pipeline and expert-parallel MoE
(`parallel.ring_attention`, `parallel.pipeline`, `parallel.moe`,
`gluon.contrib.MoEFFN`) against the JAX package's: the cases of
`test_ring_attention.py` and `test_pipeline_moe.py` and the ring,
pipeline and MoE parts of `__graft_entry__.py:222-330`.

One 4-rank gloo world (`torch_worlds/ring_pipeline_moe.py`) runs the
sharded cases; the JAX side runs here, from the same inputs:

- ring attention over sp = 4, causal and not: the output against the
  JAX package's `ring_self_attention` on 4 devices, and dQ, dK, dV of
  sum(O²) against `jax.grad` of full attention, at 1e-3 as the
  reference's own multichip check holds the ring (on the CPU the port's
  hops are K1's and K2's plain versions);
- the pipeline against the sequential stack (2e-5, 1e-6), with the
  earlier stages holding no result; `PipelineParallel`'s losses and
  parameters against one device's SGD on the same math (1e-4, 1e-5);
- MoE over ep = 4 against the JAX package's unsharded layer on each
  token block (2e-4, 2e-5); three SGD steps of the reference's top-2 MoE
  training over ep against the unsharded objective (losses 1e-4) with a
  falling loss;
- the gating functions against the JAX package's on the same logits
  (exact), and the reference's single-process MoE cases on the port.
"""
import os
import sys

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from incubator_mxnet_tpu.parallel import moe as jmoe
from incubator_mxnet_tpu.parallel.ring_attention import (
    ring_self_attention as jring,
)

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon
from incubator_mxnet_tpu_torch import np as mnp
from incubator_mxnet_tpu_torch.parallel import (make_mesh,
                                                ring_self_attention)
from incubator_mxnet_tpu_torch.parallel import moe as tmoe
from incubator_mxnet_tpu_torch.parallel.pipeline import pipeline_stage_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_worlds import world  # noqa: E402
from torch_worlds.ring_pipeline_moe import inputs  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
IN = inputs()


def _full_attention(q, k, v, causal):
    d = q.shape[-1]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / onp.sqrt(d)
    if causal:
        t = q.shape[2]
        s = jnp.where(onp.tril(onp.ones((t, t), bool))[None, None], s,
                      -jnp.inf)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    w = world.World(os.path.join(HERE, "torch_worlds",
                                 "ring_pipeline_moe.py"), 4,
                    tmp_path_factory.mktemp("ring_world"))
    ref = {}
    q, k, v = (jnp.asarray(a) for a in IN["ring"])
    mesh = Mesh(onp.array(jax.devices()[:4]), ("sp",))
    for causal in (False, True):
        ref[f"ring_{causal}"] = onp.asarray(
            jring(q, k, v, mesh=mesh, axis="sp", causal=causal))
        ref[f"grads_{causal}"] = [onp.asarray(g) for g in jax.grad(
            lambda a, b, c, cz=causal: (_full_attention(a, b, c, cz) ** 2)
            .sum(), argnums=(0, 1, 2))(q, k, v)]
    return w.results(), ref


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(run, causal):
    ranks, ref = run
    for r in ranks:
        onp.testing.assert_allclose(r[f"ring_{causal}"].numpy(),
                                    ref[f"ring_{causal}"], rtol=1e-3,
                                    atol=1e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_gradients(run, causal):
    ranks, ref = run
    for i, name in enumerate("qkv"):
        got = onp.concatenate([r[f"ring_grads_{causal}"][i].numpy()
                               for r in ranks], axis=2)
        onp.testing.assert_allclose(got, ref[f"grads_{causal}"][i],
                                    rtol=1e-3, atol=1e-3, err_msg=name)


def test_ring_requires_mesh():
    q = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="needs a mesh"):
        ring_self_attention(q, q, q, mesh=None)


def test_ring_on_a_world_of_one_is_attention():
    """No world: the ring is one hop, one K1 call (its plain version)."""
    from incubator_mxnet_tpu_torch.ops.flash_attention import flash_attention

    q, k, v = (torch.from_numpy(a) for a in IN["ring"])
    for causal in (False, True):
        got = ring_self_attention(q, k, v, mesh=make_mesh({"sp": 1}),
                                  causal=causal)
        torch.testing.assert_close(got, flash_attention(q, k, v,
                                                        causal=causal),
                                   rtol=0, atol=0)


def test_pipeline_matches_sequential(run):
    ranks, _ = run
    ws, xs = IN["pipe"]
    ref = xs
    for s in range(ws.shape[0]):
        ref = onp.tanh(ref @ ws[s])
    out = ranks[0]["pipe"].numpy()           # (S, M, B, D), every stage's
    onp.testing.assert_allclose(out[-1], ref, rtol=2e-5, atol=1e-6)
    assert not onp.allclose(out[0], ref)
    for r in ranks:
        assert onp.array_equal(r["pipe"].numpy(), out)


def test_pipeline_parallel_trains(run):
    ranks, _ = run
    ws0, x, y = (jnp.asarray(a) for a in IN["train"])

    def ref_loss(ws):
        act = x
        for s in range(ws.shape[0]):
            act = jnp.tanh(act @ ws[s])
        return jnp.mean((act - y) ** 2)

    ws, ref_losses = ws0, []
    vg = jax.jit(jax.value_and_grad(ref_loss))
    for _ in range(5):
        loss, g = vg(ws)
        ref_losses.append(float(loss))
        ws = ws - 0.5 * g
    for r in ranks:
        assert r["pipe_losses"][-1] < r["pipe_losses"][0]
        onp.testing.assert_allclose(r["pipe_losses"], ref_losses, rtol=1e-4,
                                    atol=1e-6)
        onp.testing.assert_allclose(r["pipe_params"].numpy(),
                                    onp.asarray(ws), rtol=1e-4, atol=1e-5)


def test_pipeline_stage_params_stacking():
    layers = [{"w": torch.ones(3, 3) * i} for i in range(8)]
    stacked = pipeline_stage_params(layers, 4)
    assert stacked["w"].shape == (4, 2, 3, 3)
    torch.testing.assert_close(stacked["w"][1, 0], torch.full((3, 3), 2.0))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_stage_params(layers, 3)


def test_moe_ep_matches_unsharded(run):
    ranks, _ = run
    m = {k: jnp.asarray(v) for k, v in IN["moe"].items()}
    E = m["w1"].shape[0]
    fn = jmoe.moe_ffn_apply(m["w1"], jnp.zeros((E, 16)), m["w2"],
                            jnp.zeros((E, 8)))
    T = m["x"].shape[0] // 4

    @jax.jit
    def block(xg):
        return jmoe.moe_dispatch_combine(xg, xg @ m["gw"], fn,
                                         capacity_factor=8.0)[0]

    refs = [block(m["x"][g * T:(g + 1) * T]) for g in range(4)]
    got = onp.concatenate([r["moe"].numpy() for r in ranks])
    onp.testing.assert_allclose(got, onp.concatenate(refs), rtol=2e-4,
                                atol=2e-5)


def test_moe_over_ep_trains(run):
    """`__graft_entry__.py:283`'s top-2 MoE training over ep: the losses
    of three SGD steps against the unsharded objective, the mean over
    the token blocks of each block's loss with every expert local."""
    ranks, _ = run
    mt = {k: jnp.asarray(v) for k, v in IN["moe_train"].items()}
    p = {"gw": mt["gw"], "w1": mt["w1"], "b1": jnp.zeros((4, 32)),
         "w2": mt["w2"], "b2": jnp.zeros((4, 16))}
    T = mt["x"].shape[0] // 4

    def objective(p):
        fn = jmoe.moe_ffn_apply(p["w1"], p["b1"], p["w2"], p["b2"])
        losses = []
        for g in range(4):
            x = mt["x"][g * T:(g + 1) * T]
            out, aux = jmoe.moe_dispatch_combine(
                x, x @ p["gw"], fn, capacity_factor=4.0, top_k=2)
            losses.append(jnp.mean((out - mt["y"][g * T:(g + 1) * T]) ** 2)
                          + 0.01 * aux)
        return sum(losses) / 4

    ref = []
    vg = jax.jit(jax.value_and_grad(objective))
    for _ in range(3):
        loss, g = vg(p)
        ref.append(float(loss))
        p = jax.tree.map(lambda w, d: w - 0.2 * d, p, g)
    for r in ranks:
        onp.testing.assert_allclose(r["moe_losses"], ref, rtol=1e-4,
                                    atol=1e-6)
        assert r["moe_losses"][-1] < r["moe_losses"][0]


@pytest.mark.parametrize("top_k,capacity", [(1, 3), (1, 64), (2, 1),
                                            (2, 5), (2, 64)])
def test_gating_matches_jax(top_k, capacity):
    logits = onp.random.RandomState(top_k).normal(0, 1, (32, 4)).astype(
        "float32")
    jf = jmoe.top1_gating if top_k == 1 else jmoe.top2_gating
    tf = tmoe.top1_gating if top_k == 1 else tmoe.top2_gating
    want = jf(jnp.asarray(logits), capacity)
    got = tf(torch.from_numpy(logits), capacity)
    for a, b in zip(got[:2], want[:2]):
        onp.testing.assert_allclose(a.numpy(), onp.asarray(b), rtol=1e-6,
                                    atol=1e-7)
    onp.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


def test_top1_gating_capacity():
    logits = torch.tensor([[5.0, 0.0], [4.0, 0.0], [3.0, 0.0], [0.0, 5.0]])
    combine, dispatch, aux = tmoe.top1_gating(logits, capacity=2)
    assert combine.shape == (4, 2, 2)
    assert dispatch[2].sum() == 0          # third token over capacity
    assert dispatch[:2, 0].sum() == 2 and dispatch[3, 1].sum() == 1
    assert aux.dim() == 0


def test_moe_routes_to_correct_expert():
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    logits = torch.tensor([[10.0, -10.0], [-10.0, 10.0], [10.0, -10.0]])

    def expert_fn(slots):                   # expert 0 doubles, 1 negates
        return torch.stack([slots[0] * 2.0, -slots[1]])

    out, _ = tmoe.moe_dispatch_combine(x, logits, expert_fn,
                                       capacity_factor=2.0)
    g = torch.softmax(logits, -1).max(-1).values
    torch.testing.assert_close(out[0], x[0] * 2.0 * g[0])
    torch.testing.assert_close(out[1], -x[1] * g[1])
    torch.testing.assert_close(out[2], x[2] * 2.0 * g[2])


def test_moe_top2_trains_and_balances():
    r = onp.random.RandomState(2)
    T, D, E, H = 64, 8, 4, 16
    x = torch.from_numpy(r.normal(0, 1, (T, D)).astype("float32"))
    y = torch.from_numpy(r.normal(0, 1, (T, D)).astype("float32"))
    p = {"gw": r.normal(0, 0.3, (E, D)), "w1": r.normal(0, 0.3, (E, D, H)),
         "b1": onp.zeros((E, H)), "w2": r.normal(0, 0.3, (E, H, D)),
         "b2": onp.zeros((E, D))}
    p = {k: torch.from_numpy(v.astype("float32")) for k, v in p.items()}
    hist = []
    for _ in range(30):
        ps = {k: v.clone().requires_grad_() for k, v in p.items()}
        out, aux = tmoe.moe_dispatch_combine(
            x, x @ ps["gw"].T, tmoe.moe_ffn_apply(ps["w1"], ps["b1"],
                                                  ps["w2"], ps["b2"]),
            capacity_factor=2.0, top_k=2)
        task = ((out - y) ** 2).mean()
        (task + 0.01 * aux).backward()
        hist.append((float(task + 0.01 * aux), float(task)))
        p = {k: p[k] - 0.3 * ps[k].grad for k in p}
    assert hist[-1][0] < hist[0][0] and hist[-1][1] < hist[0][1]
    assert float(p["gw"].abs().sum()) > 0


def test_gluon_moe_block_trains():
    """`gluon.contrib.MoEFFN` through autograd, the aux loss in the
    objective, under `gluon.Trainer`: the loss falls."""
    with mx.cpu():
        mx.random.seed(0)
        blk = gluon.contrib.MoEFFN(units=8, hidden_size=16, num_experts=4,
                                   top_k=2, capacity_factor=2.0)
        blk.initialize()
        trainer = gluon.Trainer(blk.collect_params(), "adam",
                                {"learning_rate": 3e-3})
        r = onp.random.RandomState(5)
        x = mnp.array(r.normal(0, 1, (4, 16, 8)).astype("float32"))
        y = mnp.array(r.normal(0, 1, (4, 16, 8)).astype("float32"))
        losses = []
        for _ in range(25):
            with autograd.record():
                out, aux = blk(x)
                loss = mnp.mean((out - y) ** 2) + 0.01 * aux
            loss.backward()
            trainer.step(4)
            losses.append(float(loss.asnumpy()))
        assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])
        out2, aux2 = blk(x)
        assert out2.shape == (4, 16, 8) and aux2.shape == ()
        assert "MoEFFN(8 -> 16, E=4, top2)" == repr(blk)


def test_workers_import_no_jax(run):
    assert all(r["forbidden"] == [] for r in run[0])
