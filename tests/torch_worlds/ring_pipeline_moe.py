"""Cases of `test_torch_ring_pipeline_moe.py`, run by each rank of a
4-rank gloo world (`world.py`): ring attention over sp = 4, the GPipe
pipeline over pp = 4 and expert-parallel MoE over ep = 4, on inputs made
here from seeds (`inputs`), which the test remakes for the JAX side."""
import numpy as onp
import torch

from incubator_mxnet_tpu_torch.optimizer import SGD
from incubator_mxnet_tpu_torch.parallel import (make_mesh, mesh_scope,
                                                ring_attention,
                                                ring_self_attention,
                                                shard_train_step)
from incubator_mxnet_tpu_torch.parallel import collectives as C
from incubator_mxnet_tpu_torch.parallel.moe import (moe_dispatch_combine,
                                                    moe_ffn_apply)
from incubator_mxnet_tpu_torch.parallel.pipeline import (PipelineParallel,
                                                         pipeline_apply)


def inputs():
    r = onp.random.RandomState(5)
    B, H, T, D = 2, 2, 32, 8
    ring = [r.randn(B, H, T, D).astype("float32") for _ in range(3)]
    r = onp.random.RandomState(0)
    S, M, Bp, Dp = 4, 6, 2, 8
    pipe = (r.uniform(-0.5, 0.5, (S, Dp, Dp)).astype("float32"),
            r.uniform(-1, 1, (M, Bp, Dp)).astype("float32"))
    r = onp.random.RandomState(1)
    S2, M2, B2, D2 = 4, 4, 2, 6
    train = (r.uniform(-0.5, 0.5, (S2, D2, D2)).astype("float32"),
             r.uniform(-1, 1, (M2, B2, D2)).astype("float32"),
             r.uniform(-1, 1, (M2, B2, D2)).astype("float32"))
    r = onp.random.RandomState(1)
    G, T, Dm, Hm, E = 4, 32, 8, 16, 4
    moe = {"x": r.uniform(-1, 1, (G * T, Dm)).astype("float32"),
           "gw": r.uniform(-1, 1, (Dm, E)).astype("float32"),
           "w1": r.uniform(-0.5, 0.5, (E, Dm, Hm)).astype("float32"),
           "w2": r.uniform(-0.5, 0.5, (E, Hm, Dm)).astype("float32")}
    r = onp.random.RandomState(7)
    Te, De, He = 8, 16, 32
    moe_train = {"x": r.uniform(-1, 1, (4 * Te, De)).astype("float32"),
                 "y": r.uniform(-1, 1, (4 * Te, De)).astype("float32"),
                 "gw": r.uniform(-1, 1, (De, 4)).astype("float32"),
                 "w1": r.uniform(-0.5, 0.5, (4, De, He)).astype("float32"),
                 "w2": r.uniform(-0.5, 0.5, (4, He, De)).astype("float32")}
    return {"ring": ring, "pipe": pipe, "train": train, "moe": moe,
            "moe_train": moe_train}


def stage_fn(w, act):
    return torch.tanh(act @ w)


def moe_loss(p, x, y, axis):
    out, aux = moe_dispatch_combine(
        x, x @ p["gw"], moe_ffn_apply(p["w1"], p["b1"], p["w2"], p["b2"]),
        capacity_factor=4.0, axis_name=axis, top_k=2)
    return ((out - y) ** 2).mean() + 0.01 * aux


def run(rank, n):
    inp = inputs()
    out = {}
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    # ring attention over sp = 4, causal and not, with gradients
    sp = make_mesh({"sp": 4})
    q, k, v = (t(a) for a in inp["ring"])
    for causal in (False, True):
        out[f"ring_{causal}"] = ring_self_attention(q, k, v, mesh=sp,
                                                    axis="sp", causal=causal)
        c = q.shape[2] // n
        blocks = [a[:, :, rank * c:(rank + 1) * c].clone().requires_grad_()
                  for a in (q, k, v)]
        with mesh_scope(sp):
            o = ring_attention(*blocks, "sp", causal=causal)
        (o ** 2).sum().backward()
        out[f"ring_grads_{causal}"] = [b.grad for b in blocks]
    # the GPipe forward against the sequential run
    pp = make_mesh({"pp": 4})
    ws, xs = (t(a) for a in inp["pipe"])
    f = shard_train_step(
        lambda w, x: pipeline_apply(stage_fn, w[0], x, "pp")[None], pp,
        in_specs=(("pp",), ()), out_specs=("pp",))
    out["pipe"] = f(ws, xs)
    # PipelineParallel trains
    w0, x, y = (t(a) for a in inp["train"])
    trainer = PipelineParallel(stage_fn, w0,
                               lambda o, yy: ((o - yy) ** 2).mean(),
                               SGD(learning_rate=0.5, wd=0.0), pp)
    out["pipe_losses"] = [float(trainer.step(x, y)) for _ in range(5)]
    out["pipe_params"] = trainer.params
    # MoE over ep = 4 against the unsharded layer on each token block
    ep = make_mesh({"ep": 4})
    m = {k_: t(v_) for k_, v_ in inp["moe"].items()}
    T = m["x"].shape[0] // n
    xb = m["x"][rank * T:(rank + 1) * T]
    E = m["w1"].shape[0] // n
    sl = slice(rank * E, (rank + 1) * E)
    with mesh_scope(ep):
        o, aux = moe_dispatch_combine(
            xb, xb @ m["gw"], moe_ffn_apply(
                m["w1"][sl], torch.zeros(E, 16), m["w2"][sl],
                torch.zeros(E, 8)), capacity_factor=8.0, axis_name="ep")
    out["moe"] = o
    # MoE over ep trains: experts and tokens cut over ep, the gate
    # replicated (its gradient averaged over ep)
    mt = {k_: t(v_) for k_, v_ in inp["moe_train"].items()}
    Te = mt["x"].shape[0] // n
    xe, ye = (mt[k_][rank * Te:(rank + 1) * Te] for k_ in ("x", "y"))
    p = {"gw": mt["gw"], "w1": mt["w1"][rank:rank + 1],
         "b1": torch.zeros(1, 32), "w2": mt["w2"][rank:rank + 1],
         "b2": torch.zeros(1, 16)}
    losses = []
    with mesh_scope(ep):
        for _ in range(3):
            ps = {k_: v_.clone().requires_grad_() for k_, v_ in p.items()}
            loss = moe_loss(ps, xe, ye, "ep")
            (loss / n).backward()
            losses.append(float(C.all_reduce(loss.detach(), "ep", "mean")))
            g = {k_: v_.grad for k_, v_ in ps.items()}
            g["gw"] = C.all_reduce(g["gw"], "ep")
            p = {k_: p[k_] - 0.2 * g[k_] for k_ in p}
    out["moe_losses"] = losses
    return out
