"""A 2-rank gloo world (`world.py`) meeting at one `KVStoreDist.barrier`:
rank 1 queues a ``profile_process="server"`` profiler command, both ranks
queue their rank statistics; the barrier exchanges and applies them
(`profiler.sync_remote_commands`, `monitor.sync_rank_stats`)."""
from incubator_mxnet_tpu_torch import kv, profiler
from incubator_mxnet_tpu_torch.telemetry import monitor


def run(rank, n):  # noqa: ARG001
    store = kv.create("dist_sync")
    before = profiler._CONFIG.get("filename")
    if rank == 1:
        profiler.set_config(profile_process="server",
                            filename="from_rank1.json")
    monitor.queue_rank_stats({"loss": 1.0 + rank, "rank": float(rank)})
    store.barrier()
    return {"before": before,
            "filename": profiler._CONFIG.get("filename"),
            "pending": list(profiler._REMOTE_PENDING),
            "aggregate": monitor.rank_aggregate()}
