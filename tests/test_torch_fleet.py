"""The port's fleet plane (`telemetry.fleet`) against the JAX package's,
the cases of `tests/test_fleet.py`.

- Host math on both packages (fixture ``pkg``), the same inputs and the
  same answers: `straggler_scores`, `exchange_large` (over a stand-in
  transport that holds the 4 KiB command slot), `stitch_traces` (rebased
  by the clock offsets; a directory with no dumps is loud),
  `merge_flight_dumps` (and `tools/fleetwatch.py`'s rendering of the
  port's merge), the rank-stamped flightrec filename, the single-process
  report and gauges, the straggler health check, zero clock offsets.
- The port alone: the mesh collectives' census (a dead branch while off,
  calls and bytes while on) and `probe_collectives`' series for every op
  (one rank: the ops are the identity, timed all the same).
- Two processes (a gloo world, `torch_worlds/fleet.py`): rank 1 slowed by
  ``collective_delay@1`` and slow steps is every rank's straggler; the
  dist collectives' series exist; the rank dumps stitch into one lane a
  rank. Then a crash on rank 1 leaves its marker
  (the file `fault.elastic` reads) and a ``crash`` flightrec, and rank 0
  a ``peer_crash`` one, merged into one post-mortem.
"""
import json
import os
import sys

import pytest

from incubator_mxnet_tpu.base import MXNetError as JMXNetError
from incubator_mxnet_tpu.telemetry import fleet as jfleet
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu.telemetry import tracing as jtracing

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.parallel import collectives
from incubator_mxnet_tpu_torch.parallel.mesh import make_mesh, mesh_scope
from incubator_mxnet_tpu_torch.telemetry import fleet as tfleet
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry
from incubator_mxnet_tpu_torch.telemetry import tracing as ttracing

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_worlds import world  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKGS = {"ref": (jfleet, jregistry, jtracing, JMXNetError),
        "port": (tfleet, tregistry, ttracing, MXNetError)}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    fleet = PKGS[request.param][0]
    fleet.reset()
    yield PKGS[request.param]
    fleet.disable()
    fleet.reset()


# ---------------------------------------------------------------------------
# host math, both packages
# ---------------------------------------------------------------------------

def test_straggler_scores_slow_rank_wins(pkg):
    samples = {0: {"step_time_mean": 0.10, "barrier_lateness_mean": 0.001},
               1: {"step_time_mean": 0.10, "barrier_lateness_mean": 0.002},
               2: {"step_time_mean": 0.45, "barrier_lateness_mean": 0.300}}
    scores = pkg[0].straggler_scores(samples)
    assert scores == PKGS["ref"][0].straggler_scores(samples)
    assert max(scores, key=scores.get) == 2 and scores[2] > 1.0


def test_straggler_scores_two_ranks_signed(pkg):
    scores = pkg[0].straggler_scores(
        {0: {"step_time_mean": 0.1}, 1: {"step_time_mean": 0.4}})
    assert scores[1] == pytest.approx(1.0)
    assert max(scores, key=scores.get) == 1


def test_straggler_scores_ignores_sparse_and_flat_signals(pkg):
    samples = {0: {"a": None, "flat": 5.0, "lone": 1.0},
               1: {"a": None, "flat": 5.0}}
    assert pkg[0].straggler_scores(samples) == {0: 0.0, 1: 0.0}


def _fake_transport(n_ranks, max_bytes=4096):
    import pickle

    def exchange(obj):
        assert len(pickle.dumps(obj)) <= max_bytes - 4, "slot overflow"
        return [obj for _ in range(n_ranks)]

    return exchange


def test_exchange_large_chunks_past_command_slot(pkg):
    big = {"rank": 0, "blob": "x" * 50_000,
           "nested": {str(i): float(i) for i in range(300)}}
    out = pkg[0].exchange_large(big, chunk=1000,
                                _exchange=_fake_transport(3))
    assert len(out) == 3 and all(o == big for o in out)


def test_exchange_large_small_object_single_round(pkg):
    calls = []

    def exchange(obj):
        calls.append(obj)
        return [obj, obj]

    out = pkg[0].exchange_large({"ok": 1}, chunk=3000, _exchange=exchange)
    assert out == [{"ok": 1}, {"ok": 1}]
    assert len(calls) == 2 and calls[0] == 1


def test_exchange_large_single_process_short_circuit(pkg):
    assert pkg[0].exchange_large({"r": 0}) == [{"r": 0}]


def test_fleet_report_single_process_and_gauges(pkg):
    fleet, registry = pkg[0], pkg[1]
    fleet.enable()
    registry.step(0.02, examples=8)
    rep = fleet.fleet_report()
    assert rep["n_ranks"] == 1 and rep["rank"] == 0
    assert 0 in rep["ranks"] and "registry" in rep["ranks"][0]
    assert rep["straggler"]["rank"] == 0
    g = registry.report()
    assert g["mx_fleet_ranks"]["value"] == 1
    assert g["mx_fleet_straggler_rank"]["value"] == 0


def test_straggler_health_check_raises_past_threshold(pkg):
    fleet, err = pkg[0], pkg[3]
    fleet.enable()
    check = fleet.install_health_check(threshold=2.0)
    fleet._LAST_REPORT = None
    check()
    fleet._LAST_REPORT = {"straggler": {"rank": 3, "score": 2.6,
                                        "signals": {3: {"step": 9.0}}}}
    with pytest.raises(err, match="rank 3"):
        check()
    fleet._LAST_REPORT = {"straggler": {"rank": 1, "score": 0.4,
                                        "signals": {}}}
    check()


def test_clock_offsets_single_process_zero(pkg):
    out = pkg[0].estimate_clock_offsets()
    assert out["offsets"] == [0.0] and out["bound_s"] == 0.0


def _write_rank_dump(d, rank, offset_s, ts0_us, n_ranks=2):
    spans = [{"trace_id": "t" * 32, "span_id": f"s{rank}{i}",
              "parent_id": None, "name": "dist.barrier",
              "ts_us": ts0_us + i * 10_000, "dur_us": 500.0,
              "thread": 1, "lane": "dist",
              "attrs": {"coll_seq": i + 1, "op": "barrier"}, "events": []}
             for i in range(3)]
    with open(os.path.join(d, f"fleet_spans_rank{rank:03d}.json"),
              "w") as fh:
        json.dump({"rank": rank, "n_ranks": n_ranks, "host": f"h{rank}",
                   "pid": 100 + rank, "clock_offset_s": offset_s,
                   "offset_bound_s": 0.002, "fleet_trace": "t" * 32,
                   "barrier": {}, "spans": spans}, fh)


def test_stitch_traces_rebases_by_clock_offset(pkg, tmp_path):
    d = str(tmp_path)
    _write_rank_dump(d, 0, 0.0, ts0_us=1_000_000.0)
    _write_rank_dump(d, 1, 0.005, ts0_us=1_005_000.0)
    out = pkg[0].stitch_traces(d)
    assert out == PKGS["ref"][0].stitch_traces(d)
    assert out["fleet"] == {"n_ranks": 2, "files": 2, "n_spans": 6,
                            "offset_bound_s": 0.002}
    by_seq = {}
    for e in out["traceEvents"]:
        if e["ph"] == "X":
            by_seq.setdefault(e["args"]["coll_seq"], []).append(e["ts"])
    for seq, ts in by_seq.items():
        assert len(ts) == 2 and abs(ts[0] - ts[1]) <= 0.002 * 1e6, (seq, ts)


def test_stitch_traces_empty_dir_is_loud(pkg, tmp_path):
    with pytest.raises(FileNotFoundError):
        pkg[0].stitch_traces(str(tmp_path))


def test_merge_flight_dumps_groups_by_rank(pkg, tmp_path):
    d = str(tmp_path)
    for rank, reason in ((0, "peer_crash"), (1, "crash")):
        with open(os.path.join(
                d, f"flightrec_{reason}_rank{rank:03d}_42.json"), "w") as fh:
            json.dump({"reason": reason, "pid": 100 + rank,
                       "error": {"type": "RuntimeError", "message": "boom"}
                       if reason == "crash" else None,
                       "context": {"fleet": {"rank": rank, "n_ranks": 2}},
                       "spans": [{"name": "dist.barrier"}]}, fh)
    with open(os.path.join(d, "fleet_crash_rank001.marker"), "w") as fh:
        json.dump({"rank": 1, "pid": 101, "error": "RuntimeError: boom"},
                  fh)
    merged = pkg[0].merge_flight_dumps(d)
    assert merged == PKGS["ref"][0].merge_flight_dumps(d)
    assert merged["n_ranks"] == 2 and merged["n_dumps"] == 2
    assert merged["ranks"]["1"][0]["reason"] == "crash"
    assert merged["ranks"]["0"][0]["reason"] == "peer_crash"
    assert merged["markers"][0]["rank"] == 1
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import fleetwatch
    finally:
        sys.path.pop(0)
    text = fleetwatch.format_postmortem(merged)
    assert "rank   1" in text and "peer_crash" in text


def test_rank_stamped_flightrec_filename(pkg, tmp_path, monkeypatch):
    tracing = pkg[2]
    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(tmp_path))
    tracing.enable()
    old = tracing._RANK_STAMP
    tracing._RANK_STAMP = 5
    try:
        with tracing.span("work"):
            pass
        path = tracing.flight_dump("unit")
    finally:
        tracing._RANK_STAMP = old
        tracing.disable()
        tracing.reset()
    assert os.path.basename(path).startswith("flightrec_unit_rank005_")


# ---------------------------------------------------------------------------
# the mesh collectives' census and probe (the port)
# ---------------------------------------------------------------------------

def test_census_off_is_dead_branch_and_on_counts_bytes():
    import torch

    tfleet.disable()
    assert collectives._CENSUS is None
    key = 'mx_collective_trace_calls_total{axis="dp",op="all_reduce"}'
    x = torch.zeros(4, 4)
    with mesh_scope(make_mesh({"dp": 1})):
        collectives.all_reduce(x, "dp")
        assert key not in tregistry.report()
        tfleet.enable()
        assert collectives._CENSUS is not None
        collectives.all_reduce(x, "dp")
    rep = tregistry.report()
    assert rep[key]["value"] >= 1
    nbytes = rep['mx_collective_bytes_total{axis="dp",op="all_reduce"}']
    assert nbytes["value"] >= 64
    tfleet.disable()
    assert collectives._CENSUS is None


def test_probe_collectives_emits_series_for_every_op():
    tfleet.enable()
    try:
        res = tfleet.probe_collectives(nbytes=1 << 12, iters=1)
    finally:
        tfleet.disable()
    ops = [op for op in res if op != "_meta"]
    assert set(ops) == {"all_reduce", "all_gather", "reduce_scatter",
                        "broadcast", "ring_permute", "all_to_all"}
    rep = tregistry.report()
    axis = res["_meta"]["axis"]
    for op in ops:
        assert "error" not in res[op], (op, res[op])
        assert res[op]["seconds"] > 0
        assert f'mx_collective_seconds{{axis="{axis}",op="{op}"}}' in rep
    assert res["_meta"]["peak_gbs"] is None      # nothing measured here


# ---------------------------------------------------------------------------
# two processes
# ---------------------------------------------------------------------------

def _fleet_world(tmp_path, crash):
    share = tmp_path / "share"
    share.mkdir()
    env = {"MXNET_FAULT_INJECT": "collective_delay@1:1.0:0:64",
           "MXNET_FAULT_DELAY_MS": "120",
           "MXNET_FLIGHTREC_DIR": str(share), "FLEET_TEST_DIR": str(share),
           "FLEET_TEST_CRASH": "1" if crash else "0"}
    return world.World(os.path.join(HERE, "torch_worlds", "fleet.py"), 2,
                       tmp_path, env=env), share


def test_fleet_two_process_straggler_and_stitch(tmp_path):
    w, share = _fleet_world(tmp_path, crash=False)
    res = w.results()
    for rank, out in enumerate(res):
        assert out["forbidden"] == []
        assert (out["fired"] > 0) == (rank == 1), (rank, out["fired"])
        assert out["n_ranks"] == 2
        assert out["straggler"]["rank"] == 1, out["straggler"]
        assert out["straggler"]["score"] > 0.5, out["straggler"]
        for op in ("allreduce", "barrier", "exchange_objs"):
            assert ('mx_collective_seconds{axis="host",op="%s"}' % op
                    in out["series"]), (rank, op)
        assert out["clock"]["offsets"] is not None
    assert res[1]["barrier"]["lateness_max"] >= 0.05
    stitched = tfleet.stitch_traces(str(share))
    assert stitched["fleet"]["n_ranks"] == 2
    lanes = {e["pid"] for e in stitched["traceEvents"] if e["ph"] == "X"}
    assert lanes == {3000, 3001}
    barriers = {}
    for e in stitched["traceEvents"]:
        if e.get("ph") == "X" and e["name"] == "dist.barrier":
            barriers.setdefault(e["args"].get("coll_seq"),
                                {})[e["args"]["rank"]] = e["ts"]
    both = {s: t for s, t in barriers.items() if len(t) == 2}
    assert both, barriers
    for seq, ts in both.items():
        assert abs(ts[0] - ts[1]) < 1e6, (seq, ts)


def test_fleet_two_process_crash_fanout(tmp_path, monkeypatch):
    w, share = _fleet_world(tmp_path, crash=True)
    with pytest.raises(RuntimeError, match=r"ranks failed \[\(1, 1\)\]"):
        w.results()
    merged = tfleet.merge_flight_dumps(str(share))
    assert [m["rank"] for m in merged["markers"]] == [1]
    assert any(d["reason"] == "crash" for d in merged["ranks"]["1"])
    assert any(d["reason"] == "peer_crash" for d in merged["ranks"]["0"])
    # the marker is the one fault.elastic's trigger reads
    from incubator_mxnet_tpu_torch.fault.elastic import ElasticController
    from incubator_mxnet_tpu_torch.parallel import dist

    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(share))
    monkeypatch.setattr(dist, "rank", lambda: 0)
    monkeypatch.setattr(dist, "active_ranks", lambda: (0, 1))
    assert ElasticController._crashed_ranks(None) == (1,)
