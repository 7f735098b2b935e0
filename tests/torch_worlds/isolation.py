"""Cases of `test_torch_isolation.py`: each rank of a 2-rank gloo world
imports the distributed modules of the port and runs a mesh step; the
world's runner records the jax or reference modules loaded."""
import importlib

import torch

DIST_MODULES = ("parallel", "parallel.mesh", "parallel.collectives",
                "parallel.dist", "parallel.sharded", "parallel._layout",
                "parallel.ring_attention", "parallel.pipeline",
                "parallel.moe", "kvstore", "kvstore.kvstore",
                "kvstore.horovod", "kvstore.byteps", "kvstore.compression",
                "models.sharded_bert", "gluon.contrib.moe",
                "analysis.shardcheck", "fault.elastic", "serve.sharded",
                "telemetry.fleet")


def run(rank, n):
    for m in DIST_MODULES:
        importlib.import_module("incubator_mxnet_tpu_torch." + m)
    from incubator_mxnet_tpu_torch.models.bert import (bert_small,
                                                       tp_param_shardings)
    from incubator_mxnet_tpu_torch.optimizer import SGD
    from incubator_mxnet_tpu_torch.parallel import DataParallel, make_mesh

    net = bert_small(vocab_size=20, max_length=8, dropout=0.0, device="cpu",
                     seed=1, seq_shard_axis="tp")
    dp = DataParallel(net, lambda o, y: o[0].float().mean(),
                      SGD(learning_rate=0.1), mesh=make_mesh({"tp": 2}),
                      param_shardings=tp_param_shardings(net))
    x = torch.zeros(2, 8, dtype=torch.int64)
    return {"loss": float(dp.step(x, x))}
