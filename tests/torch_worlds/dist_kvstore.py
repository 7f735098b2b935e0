"""A worker of `test_torch_dist_kvstore.py`, started by `tools/launch.py`
(3 processes; ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``
in the environment). It joins the port's world through a "dist_sync"
kvstore, checks the reference's exact cross-process sums, trains with
``Trainer(kvstore="dist_sync")``, walks the membership epochs (a rank
leaves, the survivors settle, stale ranks raise, the rank rejoins, a
rank misses a transition) and saves what it saw to
``$MX_WORLD_OUT/rank<r>.pt``."""
import os
import sys
import time

import numpy as onp
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, np
from incubator_mxnet_tpu_torch.parallel import dist

FORBIDDEN = ("jax", "jaxlib", "incubator_mxnet_tpu")


def trainer_data():
    r = onp.random.RandomState(4)
    return (r.normal(size=(12, 5)).astype("float32"),
            r.normal(size=(12, 3)).astype("float32"),
            r.normal(0, 0.3, (3, 5)).astype("float32"))


def train(x, y, w0, kvstore, batch):
    net = gluon.nn.Dense(3, in_units=5, device="cpu")
    net.initialize(device="cpu")
    net.weight.set_data(np.array(w0))
    net.bias.set_data(np.zeros((3,)))
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore=kvstore)
    for _ in range(3):
        with autograd.record():
            loss = ((net(np.array(x)) - np.array(y)) ** 2).sum()
        loss.backward()
        tr.step(batch)
    return net.weight.data().asnumpy(), net.bias.data().asnumpy()


def wait_for(fn, want, timeout=20.0):
    deadline = time.monotonic() + timeout
    while fn() != want:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{fn.__name__} never gave {want}: {fn()}")
        time.sleep(0.02)


def stale(fn):
    try:
        fn()
    except dist.StaleGenerationError as e:
        return str(e)
    return None


def run():
    out = {}
    kv = mx.kv.create("dist_sync")
    rank, n = kv.rank, kv.num_workers
    out["rank"], out["n"] = rank, n
    out["backend"] = torch.distributed.get_backend()
    # pushpull: the exact sum of the ranks' values
    g = np.full((4,), float(rank + 1))
    o = np.zeros((4,))
    kv.pushpull("grad", g, out=o)
    out["pushpull"] = o.asnumpy()
    # init broadcasts rank 0's value
    kv.init("w", np.full((3,), 7.0) if rank == 0 else np.full((3,), -1.0))
    pulled = np.zeros((3,))
    kv.pull("w", out=pulled)
    out["init"] = pulled.asnumpy()
    # push applies the summed gradient through the updater
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1))
    kv.push("w", np.full((3,), float(rank + 1)))
    kv.pull("w", out=pulled)
    out["push"] = pulled.asnumpy()
    kv.barrier()
    # host-level API
    out["allreduce_max"] = dist.allreduce(torch.tensor([rank]), "max")
    out["broadcast"] = dist.broadcast(torch.tensor([rank + 10.0]), root=1)
    out["exchange"] = dist.exchange_objs({"r": rank})
    # Trainer(kvstore="dist_sync"): each rank its third of the joined
    # batch, against one process on all of it
    x, y, w0 = trainer_data()
    c = x.shape[0] // n
    sl = slice(rank * c, (rank + 1) * c)
    out["trainer_dist"] = train(x[sl], y[sl], w0, "dist_sync", x.shape[0])
    out["trainer_one"] = train(x, y, w0, None, x.shape[0])

    # membership epochs: rank 2 leaves
    if rank == 2:
        out["leave"] = dist.rendezvous(leave=True)
        out["stale_departed"] = stale(lambda: dist.allreduce(
            torch.ones(1)))
    else:
        wait_for(dist.pending_departures, (2,))
        out["departures"] = dist.pending_departures()
        out["settled"] = dist.rendezvous(min_ranks=2, timeout_s=20)
        out["survivors_sum"] = dist.allreduce(torch.tensor([rank + 1.0]))
        if rank == 1:
            out["stale_generation"] = stale(lambda: dist.allreduce(
                torch.ones(1), generation=0))
        wait_for(dist.pending_rejoins, (2,))
        out["rejoins"] = dist.pending_rejoins()
    if rank == 2:
        time.sleep(0.2)
    # the rank rejoins: every rank meets at the wider roster
    out["rejoined"] = dist.rendezvous(min_ranks=3, timeout_s=20)
    out["all_sum"] = dist.allreduce(torch.tensor([rank + 1.0]))
    # rank 2 misses the next transition and raises before the transport
    if rank == 2:
        wait_for(lambda: dist._fleet_generation() or 0,
                 out["rejoined"][0] + 1)
        out["stale_missed"] = stale(lambda: dist.allreduce(torch.ones(1)))
    else:
        out["shrunk"] = dist.rendezvous(min_ranks=2, timeout_s=20)
        out["shrunk_sum"] = dist.allreduce(torch.tensor([rank + 1.0]))
    return out


if __name__ == "__main__":
    with mx.cpu():
        result = run()
    dist._shutdown()
    result["forbidden"] = sorted(
        m for m in sys.modules
        if any(m == f or m.startswith(f + ".") for f in FORBIDDEN))
    torch.save(result, os.path.join(os.environ["MX_WORLD_OUT"],
                                    f"rank{result['rank']}.pt"))
    print(f"worker {result['rank']} ok", flush=True)
