"""Cases of `test_torch_fleet.py`'s two-process checks (the reference's
`tests/test_fleet.py` worker), run by each rank of a 2-rank gloo world
(`world.py`): rank 1 is slowed by `fault.injection`'s ``collective_delay``
(``$MXNET_FAULT_INJECT``) and by slow local steps, so every rank's
`fleet_report` must name it the straggler; each rank dumps its spans for
`stitch_traces`. With ``$FLEET_TEST_CRASH=1`` rank 1 then raises, and
rank 0 waits at exit for its crash marker, so that the fleet's atexit
check dumps a ``peer_crash`` flightrec."""
import atexit
import glob
import json
import os
import time

from incubator_mxnet_tpu_torch.fault import injection
from incubator_mxnet_tpu_torch.parallel import dist
from incubator_mxnet_tpu_torch.telemetry import fleet, registry
from incubator_mxnet_tpu_torch.telemetry import tracing


def _wait_for_peer_marker(out_dir):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if glob.glob(os.path.join(out_dir, "fleet_crash_rank001.marker")):
            return
        time.sleep(0.05)


def run(rank, n):
    out_dir = os.environ["FLEET_TEST_DIR"]
    crash = os.environ.get("FLEET_TEST_CRASH") == "1"
    # the launcher's environment (tools/launch.py sets it): the fanout's
    # hooks read the rank from it after the world is torn down
    os.environ["PROCESS_ID"], os.environ["NUM_PROCESSES"] = str(rank), str(n)
    tracing.enable()
    fleet.enable()
    assert n == 2, n
    injection.configure_from_env()

    dist.barrier("warmup")
    fleet.estimate_clock_offsets(rounds=3)
    for i in range(4):
        t0 = time.perf_counter()
        time.sleep(0.25 if rank == 1 else 0.01)
        registry.step(time.perf_counter() - t0, examples=8)
        dist.barrier(f"step{i}")

    info = injection.schedule_info()["collective_delay"]
    rep = fleet.fleet_report()
    bs = fleet.barrier_stats()
    series = registry.report()
    out = {"fired": info["fired"], "n_ranks": rep["n_ranks"],
           "straggler": rep["straggler"], "barrier": bs,
           "clock": rep["clock"],
           "series": sorted(k for k in series
                            if k.startswith("mx_collective_seconds"))}
    fleet.dump_rank_trace(out_dir)

    injection.clear_injection()
    dist.barrier("final")
    with open(os.path.join(out_dir, f"report_rank{rank}.json"), "w") as f:
        json.dump({"straggler": rep["straggler"]["rank"]}, f)
    if crash:
        if rank == 1:
            raise RuntimeError("injected fleet crash (rank 1)")
        # after the world's closing barrier: wait for rank 1's marker
        # before the fleet's own atexit check (atexit runs last in first)
        atexit.register(_wait_for_peer_marker, out_dir)
    return out
