"""Cases of `test_torch_elastic_training.py`, run by each rank of a
4-rank gloo world (`world.py`): the shrink and grow of a `bert_small`
training run over dp 2 x tp 2 (ranks 2 and 3, one dp replica, leave at
the first step boundary through the ``topology_change`` seam and come
back at the second), against the same run unfaulted; then a 4-rank
checkpoint resumed on 2 ranks. ``$MX_CASE_DIR`` holds the checkpoints."""
import os

import torch

from incubator_mxnet_tpu_torch import preemption
from incubator_mxnet_tpu_torch.fault import elastic, injection
from incubator_mxnet_tpu_torch.gluon.data import ElasticSampler
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models.bert import (bert_small,
                                                   tp_param_shardings)
from incubator_mxnet_tpu_torch.optimizer import SGD
from incubator_mxnet_tpu_torch.parallel import DataParallel, dist, make_mesh

VOCAB, STEPS = 64, 8


def _batch():
    g = torch.Generator().manual_seed(0)
    return (torch.randint(0, VOCAB, (8, 16), generator=g),
            torch.randint(0, VOCAB, (8, 16), generator=g))


def _trainer(mesh, seed=0):
    net = bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0,
                     seq_shard_axis="tp", device="cpu", seed=seed)
    ce = SoftmaxCrossEntropyLoss()
    dp = DataParallel(net, lambda o, y: ce(o[0].reshape(-1, VOCAB),
                                           y.reshape(-1)),
                      SGD(learning_rate=0.1), mesh=mesh,
                      param_shardings=tp_param_shardings(net))
    return net, dp


def _whole(net):
    return {n: p._whole_tensor().clone()
            for n, p in net.collect_params().items()}


def chaos(rank, out, faulted):
    """STEPS steps with a poll after each; faulted: ranks 2 and 3 leave at
    the first boundary and rejoin at the second. Each rank draws 2
    indices a step from its `ElasticSampler`, which the transitions
    re-stride."""
    dist._reset_membership()
    injection.clear_injection()
    net, dp = _trainer(make_mesh({"dp": 2, "tp": 2}))
    sampler = ElasticSampler(64, num_shards=4, index=rank, shuffle=True,
                             seed=5)
    ctl = elastic.ElasticController(trainer=dp, sampler=sampler,
                                    drain_s=60)
    tok, lab = _batch()
    losses, verdicts, drawn, it = [], [], [], iter(sampler)
    if faulted and rank >= 2:
        injection.configure_injection(f"topology_change@{rank}:1.0:0:1")
    step = 0
    while step < STEPS:
        losses.append(float(dp.step(tok, lab)))
        drawn += [next(it) for _ in range(2)]
        if faulted and step == 0:
            before = _whole(net)       # each replica's pair gathers its own
        verdict = ctl.poll()
        verdicts.append(verdict)
        if verdict == "leave":
            injection.clear_injection()
            out["left_at"] = step
            verdicts.append(ctl.rejoin())
            it = iter(sampler)
            step += 2          # the survivors' step 1 ran without us
            continue
        if verdict == "shrunk":
            out["survivors_mesh"] = dict(dp.mesh.shape)
            out["resharded_bits"] = all(
                torch.equal(a, _whole(net)[n]) for n, a in before.items())
            out["stored_after_shrink"] = sum(
                p.numel() * p.element_size() for p in dp.params)
            it = iter(sampler)
            injection.configure_injection("topology_change:1.0:0:1:grow=4")
        if verdict == "grown":
            injection.clear_injection()
            it = iter(sampler)
        step += 1
    injection.clear_injection()
    drawn += list(it)
    out[f"losses_{faulted}"] = losses
    out[f"verdicts_{faulted}"] = verdicts
    out[f"drawn_{faulted}"] = drawn
    out[f"mesh_{faulted}"] = dict(dp.mesh.shape)
    out[f"generation_{faulted}"] = dist.generation()
    if faulted:
        try:
            dist.allreduce(torch.ones(2), generation=1)
            out["stale"] = None
        except dist.StaleGenerationError as e:
            out["stale"] = str(e)
        out["final_whole"] = _whole(net)
    else:
        out["unfaulted_whole"] = _whole(net)


def resume(rank, out):
    """3 steps on 4 ranks, checkpointed every step with the elastic
    layout; ranks 2 and 3 leave; ranks 0 and 1 resume the checkpoint on a
    dp 1 x tp 2 mesh: refused with MXNET_ELASTIC=0, resharded otherwise,
    and the next step's loss is the 4-rank run's."""
    dist._reset_membership()
    net, dp = _trainer(make_mesh({"dp": 2, "tp": 2}), seed=9)
    prefix = os.path.join(os.environ["MX_CASE_DIR"], f"el{rank}")
    ck = preemption.TrainingCheckpointer(
        prefix, net, every_n=1, register_signal=False,
        layout_fn=lambda: elastic.checkpoint_layout(dp))
    tok, lab = _batch()
    for _ in range(3):
        dp.step(tok, lab)
        ck.step()
    saved = _whole(net)
    out["loss_ref"] = float(dp.step(tok, lab))
    side = preemption.load_layout(ck._mgr.latest())
    out["side"] = side
    if rank >= 2:
        dist.rendezvous(leave=True)
        return
    dist.rendezvous(min_ranks=2, timeout_s=60)
    net_b = bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0,
                       seq_shard_axis="tp", device="cpu", seed=1)
    ck_b = preemption.TrainingCheckpointer(prefix, net_b,
                                           register_signal=False)
    os.environ["MXNET_ELASTIC"] = "0"
    try:
        ck_b.resume()
        out["refused"] = None
    except preemption.LayoutMismatch as e:
        out["refused"] = str(e)
    finally:
        del os.environ["MXNET_ELASTIC"]
    out["resumed_step"] = ck_b.resume()
    out["resumed_bits"] = all(torch.equal(a, _whole(net_b)[n])
                              for n, a in saved.items())
    ce = SoftmaxCrossEntropyLoss()
    dp_b = DataParallel(net_b, lambda o, y: ce(o[0].reshape(-1, VOCAB),
                                               y.reshape(-1)),
                        SGD(learning_rate=0.1),
                        mesh=make_mesh({"dp": 1, "tp": 2}, devices=[0, 1]),
                        param_shardings=tp_param_shardings(net_b))
    out["loss_b"] = float(dp_b.step(tok, lab))


def run(rank, n):  # noqa: ARG001
    out = {"rank": rank}
    chaos(rank, out, faulted=False)
    chaos(rank, out, faulted=True)
    resume(rank, out)
    return out
