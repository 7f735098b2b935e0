"""Cases of `test_torch_shardcheck.py`'s census tier, run by each rank
of a 2-rank gloo world (`world.py`)."""
import torch

from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models.bert import (bert_small,
                                                   tp_param_shardings)
from incubator_mxnet_tpu_torch.optimizer import SGD
from incubator_mxnet_tpu_torch.parallel import DataParallel, make_mesh


def _summary(rep):
    return {"rules": sorted({f.kind for f in rep.findings}),
            "collectives": rep.collectives, "tiers": list(rep.tiers),
            "summary": rep.summary()}


def _state(dp):
    return [p.detach().clone() for p in dp.params] + [dp._t_dev.clone()]


def run(rank, n):  # noqa: ARG001
    out = {}
    mesh = make_mesh({"tp": n})
    g = torch.Generator().manual_seed(0)
    # a net that computes with whole weights: its (64, 32) weight cut
    net = nn.HybridSequential()
    net.add(nn.Dense(64, in_units=32), nn.Dense(4, in_units=64))
    net.initialize()
    dp = DataParallel(net, lambda o, y: ((o - y) ** 2).mean(-1),
                      SGD(learning_rate=0.1), mesh=mesh,
                      param_shardings=[("tp", None), ("tp",), (), ()])
    x, y = torch.randn(8, 32, generator=g), torch.randn(8, 4, generator=g)
    dp.step(x, y)
    before = _state(dp)
    out["dense"] = _summary(dp.shardcheck_report(x, y))
    restored = all(torch.equal(a, b) for a, b in zip(before, _state(dp)))
    # BERT's TP + SP path on blocks
    vocab = 64
    net = bert_small(vocab_size=vocab, max_length=32, dropout=0.0,
                     seq_shard_axis="tp", device="cpu", seed=0)
    ce = SoftmaxCrossEntropyLoss()
    dp = DataParallel(net, lambda o, t: ce(o[0].reshape(-1, vocab),
                                           t.reshape(-1)),
                      SGD(learning_rate=0.1), mesh=mesh,
                      param_shardings=tp_param_shardings(net))
    tok = torch.randint(0, vocab, (4, 16), generator=g)
    dp.step(tok, tok)
    from incubator_mxnet_tpu_torch.parallel import collectives

    real, count = collectives._exchange, [0]

    def counting(*args):
        count[0] += 1
        return real(*args)

    collectives._exchange = counting
    try:
        dp.step(tok, tok)
    finally:
        collectives._exchange = real
    before = _state(dp)
    out["bert"] = _summary(dp.shardcheck_report(tok, tok))
    out["bert"]["step_exchanges"] = count[0]
    out["restored"] = restored and all(
        torch.equal(a, b) for a, b in zip(before, _state(dp)))
    return out
