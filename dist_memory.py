#!/usr/bin/env python3
"""Per-rank device memory of BERT-base's mesh training step, for this
checkout and, with ``--parent DIR``, another checkout of the port (its
``incubator_mxnet_tpu_torch/`` under DIR): 4 gloo ranks on ``cuda:0``,
dp 2 x tp 2 with `tp_param_shardings` and ``seq_shard_axis="tp"``, f32,
dropout 0, Adam, global batch 16 x 128, 3 steps (the ``[dist 2]`` run of
``chip_smoke.py``). Each rank reports its allocator's peak over the run
(``torch.cuda.max_memory_allocated``, reset before the model is made),
what it held before and after, and its parameters' and Adam state's
bytes counted from its tensors. Runs go in turns (parent, this, this,
parent), one JSON line each, a summary line last.

    python3 dist_memory.py [--parent DIR]

Needs one CUDA card; the ranks share it (NCCL refuses two ranks on one
card, so the world is gloo and its exchanges go through host memory).
"""
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS, B, T, STEPS = 4, 16, 128, 3


def worker(rank, store, out):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import (bert_base,
                                                       tp_param_shardings)
    from incubator_mxnet_tpu_torch.optimizer import Adam
    from incubator_mxnet_tpu_torch.parallel import (DataParallel, dist,
                                                    make_mesh)

    dist.initialize(init_method=f"file://{store}", num_processes=RANKS,
                    process_id=rank, backend="gloo")
    try:
        g = torch.Generator().manual_seed(0)
        tokens, labels = (torch.randint(0, 30522, (B, T), generator=g)
                          .to(dev) for _ in range(2))
        ce = SoftmaxCrossEntropyLoss()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        net = bert_base(max_length=T, dropout=0.0, device=dev, seed=0,
                        seq_shard_axis="tp")
        dp = DataParallel(net, lambda o, y: ce(o[0], y),
                          Adam(learning_rate=1e-4),
                          mesh=make_mesh({"dp": 2, "tp": 2}),
                          param_shardings=tp_param_shardings(net))
        walls = []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dp.step(tokens, labels)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)

        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts
                       if isinstance(t, torch.Tensor))

        def leaves(x):
            if isinstance(x, (list, tuple)):
                return [t for y in x for t in leaves(y)]
            return [x]

        res = dict(rank=rank, before=before,
                   peak=torch.cuda.max_memory_allocated(dev),
                   after=torch.cuda.memory_allocated(dev),
                   params=nbytes(p for p in net.parameters()),
                   optimizer=nbytes(leaves(dp.opt_states)), step_ms=walls)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        torch.distributed.barrier()
    finally:
        dist._shutdown()


def run(root, label):
    """One world of RANKS processes importing the port from ``root``."""
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        env = dict(os.environ, PYTHONPATH=root)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r),
             os.path.join(d, "store"), d], env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(RANKS)]
        outs = [p.communicate(timeout=900)[0] for p in procs]
        if any(p.returncode for p in procs):
            raise SystemExit(f"{label}: ranks failed:\n" + "\n".join(
                o[-3000:] for o in outs))
        ranks = []
        for r in range(RANKS):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    line = dict(run=label, root=root, ranks=ranks)
    print(json.dumps(line), flush=True)
    return line


def main(argv):
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    parent = None
    if argv[:1] == ["--parent"]:
        parent = os.path.abspath(argv[1])
    order = ([("parent", parent), ("this", HERE), ("this", HERE),
              ("parent", parent)] if parent else [("this", HERE)])
    lines = [run(root, label) for label, root in order]
    summary = {}
    for line in lines:
        s = summary.setdefault(line["run"], {"peak_gb": [], "params_gb": [],
                                             "optimizer_gb": []})
        s["peak_gb"].append([r["peak"] / 1e9 for r in line["ranks"]])
        s["params_gb"].append([r["params"] / 1e9 for r in line["ranks"]])
        s["optimizer_gb"].append([r["optimizer"] / 1e9
                                  for r in line["ranks"]])
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.path.insert(0, os.getcwd())
        worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
