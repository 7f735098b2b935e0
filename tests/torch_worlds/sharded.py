"""Cases of `test_torch_sharded.py`, run by each rank of a 4-rank gloo
world (`world.py`). The inputs (weights from the JAX package, as numpy)
come from the pickle at ``$MX_CASE_INPUT``."""
import os
import pickle

import numpy as onp
import torch

from incubator_mxnet_tpu_torch import npx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch import random as mxrandom
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models import sharded_bert as sb
from incubator_mxnet_tpu_torch.models.bert import bert_small, tp_param_shardings
from incubator_mxnet_tpu_torch.optimizer import LAMB, LANS, LARS, SGD, Adam
from incubator_mxnet_tpu_torch.parallel import (DataParallel, make_mesh,
                                                mesh_scope)
from incubator_mxnet_tpu_torch.parallel import _layout

VOCAB = 64


def batch():
    r = onp.random.RandomState(0)
    return (torch.from_numpy(r.randint(0, VOCAB, (8, 16)).astype("int64")),
            torch.from_numpy(r.randint(0, VOCAB, (8, 16)).astype("int64")))


def mlm_loss():
    ce = SoftmaxCrossEntropyLoss()

    def f(out, y):
        return ce(out[0].reshape(-1, out[0].shape[-1]), y.reshape(-1))
    return f


def net_from(params, seq_axis, dropout=0.0, vocab=VOCAB):
    net = bert_small(vocab_size=vocab, max_length=32, dropout=dropout,
                     seq_shard_axis=seq_axis, device="cpu", seed=0)
    if params is not None:
        net.load_jax_params(params)
    return net


def whole(net):
    """Every parameter's whole tensor (a block stored by the spec is
    gathered: every rank calls this)."""
    return {n: p._whole_tensor().clone()
            for n, p in net.collect_params().items()}


def train(params, mesh, specs, seq_axis, opt, steps=3, **kw):
    net = net_from(params, seq_axis, **kw)
    dp = DataParallel(net, mlm_loss(), opt, mesh=mesh,
                      param_shardings=tp_param_shardings(net) if specs
                      else None)
    tok, lab = batch()
    losses = [float(dp.step(tok, lab)) for _ in range(steps)]
    return losses, whole(net), dp


def exchanges(fn):
    """The collectives ``fn()`` makes (every raw exchange of the port goes
    through `collectives._exchange`)."""
    from incubator_mxnet_tpu_torch.parallel import collectives

    real, n = collectives._exchange, [0]

    def counting(*args):
        n[0] += 1
        return real(*args)

    collectives._exchange = counting
    try:
        fn()
    finally:
        collectives._exchange = real
    return n[0]


class Probe(torch.nn.Module):
    """Dropout at a replicated site and at a sequence-parallel site; the
    masks each forward drew are kept."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(8))
        self.masks = []

    def forward(self, x):
        ones = torch.ones(x.shape[0], 6, 8)
        rep = npx.dropout(ones, p=0.5)
        sp = _layout.seq_region(lambda a: npx.dropout(a, p=0.5), (ones,),
                                "tp")
        self.masks.append(((rep != 0).clone(), (sp != 0).clone()))
        return (rep + sp) * self.w


def storage(params, mesh22, out):
    """Each rank's bytes of parameters, gradients and Adam state against
    the no-mesh step's (the whole model's), and the cut parameters'
    stored tensors: blocks only."""
    for key, mesh in (("whole", None), ("spec", mesh22)):
        net = net_from(params, "tp")
        dp = DataParallel(net, mlm_loss(), Adam(learning_rate=1e-3),
                          mesh=mesh,
                          param_shardings=tp_param_shardings(net)
                          if mesh is not None else None)
        tok, lab = batch()
        dp.step(tok, lab)
        out[f"bytes_{key}"] = dp.stored_bytes()
        out[f"bytes_counted_{key}"] = sum(
            t.numel() * t.element_size() for t in net.parameters())
        if mesh is not None:
            out["stored_shapes"] = {
                n_: (tuple(p_._data._data.shape), p_.shape)
                for n_, p_ in net.collect_params().items()}


def head_exchange(mesh22, out):
    """`_layout.head_rows` on the stored block of a fused (3C, C + 1)
    projection against the whole tensor's head rows, and its gradient
    against the whole gradient's block."""
    C, rows = 8, 24
    g = torch.Generator().manual_seed(11)
    whole = torch.randn(rows, C + 1, generator=g)
    dy = torch.randn(rows, C + 1, generator=g)
    j, n = mesh22.coordinate("tp"), 2
    blk = whole.chunk(2, dim=0)[j].clone().requires_grad_(True)
    got = _layout.head_rows(blk, rows, 3, mesh22, "tp")
    cl = C // n
    idx = [s * C + j * cl + i for s in range(3) for i in range(cl)]
    want = whole[idx]
    got.backward(dy[idx])
    # the whole gradient: each rank's heads' rows carry their dy
    whole_g = torch.zeros(rows, C + 1)
    for jj in range(n):
        ii = [s * C + jj * cl + i for s in range(3) for i in range(cl)]
        whole_g[ii] = dy[ii]
    out["heads"] = (torch.equal(got.detach(), want),
                    torch.equal(blk.grad, whole_g.chunk(2, dim=0)[j]))


def norm_rules(mesh22, out):
    """LAMB, LANS and LARS on cut parameters (a Dense stack that does not
    split its compute: its weights are gathered for the step, the blocks
    updated with norms summed over the cut axis) against the no-mesh
    step."""
    from incubator_mxnet_tpu_torch.gluon import nn

    def make():
        net = nn.HybridSequential()
        net.add(nn.Dense(16, in_units=8, activation="tanh"),
                nn.Dense(4, in_units=16))
        net.initialize()
        g = torch.Generator().manual_seed(3)
        for p_ in net.collect_params().values():
            p_.set_data(torch.randn(p_.shape, generator=g) * 0.5)
        return net

    g = torch.Generator().manual_seed(4)
    x = torch.randn(8, 8, generator=g)
    y = torch.randn(8, 4, generator=g)
    specs = [("tp", None), ("tp",), (None, "dp"), ()]
    res = {}
    for name, opt in (("lamb", LAMB), ("lans", LANS), ("lars", LARS)):
        got = []
        for mesh in (None, mesh22):
            net = make()
            dp = DataParallel(net, lambda o, t: ((o - t) ** 2).mean(-1),
                              opt(learning_rate=0.05), mesh=mesh,
                              param_shardings=specs if mesh else None)
            losses = [float(dp.step(x, y)) for _ in range(3)]
            got.append((losses, whole(net)))
        res[name] = got
    out["norm_rules"] = res


def sp_cut(params, mesh22, out):
    """The activation between a TP + SP step's regions: the rank's rows
    of the sequence (what each post-LN site and the FFN see)."""
    seen = []
    real = _layout.seq_region

    def spy(fn, xs, axis, params_=(), dim=1, local=False):
        seen.append((tuple(xs[0].shape), local))
        return real(fn, xs, axis, params_, dim, local)

    _layout.seq_region = spy
    from incubator_mxnet_tpu_torch.models import bert as bert_mod

    bert_mod.seq_region = spy
    try:
        losses, _, _ = train(params, mesh22, True, "tp",
                             SGD(learning_rate=0.1), steps=1)
    finally:
        _layout.seq_region = real
        bert_mod.seq_region = real
    out["sp_cut"] = (seen, losses)


def run(rank, n):
    with open(os.environ["MX_CASE_INPUT"], "rb") as f:
        inp = pickle.load(f)
    params = inp["bert"]
    out = {}
    mesh22 = make_mesh({"dp": 2, "tp": 2})
    mesh4 = make_mesh({"dp": 4})
    # TP + SP over dp x tp, against the replicated run
    out["tp_losses"], out["tp_params"], dp = train(
        params, mesh22, True, "tp", SGD(learning_rate=0.1))
    out["tp_axis"] = dp._plan.tp_axis
    out["blocks"] = {n_: tuple(b.shape) for n_, b in zip(
        [k for k, p in dp.net.collect_params().items()
         if p.grad_req != "null"], dp._plan.shards)}
    out["rep_losses"], out["rep_params"], _ = train(
        params, mesh4, False, None, SGD(learning_rate=0.1))
    # load_jax_params into a net already sharded by DataParallel: the
    # blocks the optimizer owns are views of the loaded weights
    net = net_from(None, "tp")
    dp = DataParallel(net, mlm_loss(), SGD(learning_rate=0.1), mesh=mesh22,
                      param_shardings=tp_param_shardings(net))
    net.load_jax_params(params)
    names = [k for k, p in net.collect_params().items()
             if p.grad_req != "null"]
    out["loaded_blocks"] = {n_: b.clone() for n_, b in zip(names,
                                                           dp._plan.shards)}
    # a vocabulary of 97 over tp = 2: uneven blocks
    l_tp, p_tp, dp = train(None, mesh22, True, "tp", SGD(learning_rate=0.1),
                           vocab=97)
    out["uneven_block"] = tuple(dp._plan.shards[1].shape)
    out["uneven_tp"] = (l_tp, p_tp)
    l_rep, p_rep, _ = train(None, mesh4, False, None, SGD(learning_rate=0.1),
                            vocab=97)
    out["uneven_rep"] = (l_rep, p_rep)
    out["rank"] = rank
    # the ambient mesh_scope
    with mesh_scope(mesh22):
        net = net_from(params, "tp")
        dp = DataParallel(net, mlm_loss(), SGD(learning_rate=0.1),
                          param_shardings=tp_param_shardings(net))
        out["ambient_mesh"] = dp.mesh is mesh22
        tok, lab = batch()
        out["ambient_losses"] = [float(dp.step(tok, lab)) for _ in range(3)]
    # rebuild: 2 momentum-SGD steps replicated over dp=4, then 1 on dp x tp
    net = net_from(params, "tp")
    dp = DataParallel(net, mlm_loss(), SGD(learning_rate=0.1, momentum=0.9),
                      mesh=mesh4)
    tok, lab = batch()
    moved = [float(dp.step(tok, lab)) for _ in range(2)]
    dp.rebuild(mesh22, param_shardings=tp_param_shardings(net))
    moved.append(float(dp.step(tok, lab)))
    out["rebuild_losses"] = moved
    out["rebuild_params"] = whole(net)
    out["rebuild_t"] = int(dp._t_dev)
    out["straight_losses"], out["straight_params"], _ = train(
        params, mesh22, True, "tp", SGD(learning_rate=0.1, momentum=0.9))
    # the pure sharded step
    cfg = sb.BertConfig(**inp["cfg"])
    step, p, st = sb.make_train_step(cfg, mesh22, lr=1e-3, use_sp=True,
                                     params=inp["sb_params"], device="cpu")
    tok, lab = inp["sb_batch"]
    out["sb_losses"] = [float(step(p, st, tok, lab)[0]) for _ in range(3)]
    out["sb_params"] = sb._gather_params(p, cfg, mesh22)
    out["sb_block_qkv"] = tuple(p["layers"][0]["qkv"]["w"].shape)
    # the dropout keys under sharding
    probe = Probe()
    mxrandom.seed(5)
    dpp = DataParallel(probe, lambda o, y: o.mean(), SGD(learning_rate=0.0),
                       mesh=mesh22)
    x = torch.zeros(8, 1)
    for _ in range(2):
        dpp.step(x, x)
    out["probe_masks"] = probe.masks
    # a step's exchanges with SP and without (the second step: the first
    # also takes rank 0's base key)
    out["exchanges"] = {}
    for ax in ("tp", None):
        net = net_from(params, ax)
        dp = DataParallel(net, mlm_loss(), SGD(learning_rate=0.1),
                          mesh=mesh22, param_shardings=tp_param_shardings(net))
        tok, lab = batch()
        dp.step(tok, lab)
        out["exchanges"][str(ax)] = exchanges(lambda: dp.step(tok, lab))
    # SP regions differentiated outside a step that sums their shares
    with mesh_scope(mesh22):
        net = net_from(params, "tp")
        tok, _ = batch()
        try:
            net(tok)
            out["outside_step"] = None
        except MXNetError as e:
            out["outside_step"] = str(e)
        with torch.no_grad():
            out["outside_no_grad"] = tuple(net(tok)[0].shape)
    # p = 0.1 BERT: the tp replicas stay bit-equal
    _, out["p01_params"], _ = train(params, mesh22, True, "tp",
                                    SGD(learning_rate=0.1), steps=2,
                                    dropout=0.1)
    # storage by the spec
    storage(params, mesh22, out)
    head_exchange(mesh22, out)
    norm_rules(mesh22, out)
    sp_cut(params, mesh22, out)
    return out
