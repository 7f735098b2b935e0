"""The port's profiler (`incubator_mxnet_tpu_torch.profiler`) against the
JAX package's, on the CPU: the same op sequence through both funnels
gives the same `record_op` names and counts and the same
``dumps(format="json")`` keys; `Scope`, `pause`/`resume`, the device
trace switch and the memory section as the reference's tests hold them.
Without a CUDA device a trace holds the host lanes only and says so.
The device-trace ingest (`_ingest_trace`) on a torch.profiler trace of
the card: the card's lanes kept, their pids remapped past 1000, ts
rebased onto the epoch clock, paused intervals dropped before the join,
and the launch log joined onto the port's kernels in stream order (a
lost record leaves its neighbours' costs right and its own unknown, and
the census over the events says how many launches the trace lost). The
registry's dump and textfile snapshot in the reference's
formats. No test starts the JAX package's device trace."""
import copy
import json
import os

import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import profiler as jprof
from incubator_mxnet_tpu.telemetry import registry as jregistry
from incubator_mxnet_tpu_torch import profiler as tprof
from incubator_mxnet_tpu_torch.ndarray import ndarray as tnd
from incubator_mxnet_tpu_torch.ops import _build
from incubator_mxnet_tpu_torch.telemetry import kernels as tkernels
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry
from incubator_mxnet_tpu_torch.telemetry import tracing as ttracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = os.path.join(REPO, "tests", "fixtures", "torch_card_trace.json")


@pytest.fixture(autouse=True)
def _clean():
    for p in (jprof, tprof):
        p.set_config(profile_device=False)
        p.dumps(reset=True)
    yield
    for p in (jprof, tprof):
        p.stop()
        p.set_config(profile_device=True, profile_memory=False)
        p.dumps(reset=True)
        del p._PAUSED_INTERVALS[:]


def _program(mx):
    a = mx.np.array([[1.0, 2.0], [3.0, 4.0]])
    b = mx.np.array([[5.0, 6.0], [7.0, 8.0]])
    c = mx.np.dot(a, b)
    d = c + a
    e = mx.np.exp(d) * 2.0
    return (e - 1.0).sum()


def _run(mx, prof):
    prof.set_state("run")
    try:
        _program(mx).wait_to_read()
    finally:
        prof.set_state("stop")
    return json.loads(prof.dumps(format="json"))


def test_record_op_names_and_counts_match_reference():
    with tmx.cpu():
        t = _run(tmx, tprof)
    j = _run(jmx, jprof)
    counts = {p: {r["name"]: r["count"] for r in d["host"]}
              for p, d in (("port", t), ("ref", j))}
    assert counts["port"] == counts["ref"] and "dot" in counts["port"]
    assert set(t) == set(j) == {"host", "device"}
    assert {k for r in t["host"] for k in r} == \
        {k for r in j["host"] for k in r} == \
        {"name", "count", "total_ms", "min_ms", "max_ms"}
    mem_t = json.loads(tprof.dumps(format="json", memory=True))
    mem_j = json.loads(jprof.dumps(format="json", memory=True))
    assert set(mem_t["memory"]) == set(mem_j["memory"])
    with pytest.raises(ValueError):
        tprof.dumps(format="csv")


def test_profiler_off_records_nothing_and_the_seam_is_clear():
    with tmx.cpu():
        (tmx.np.array([1.0, 2.0]) * 2).wait_to_read()
    assert json.loads(tprof.dumps(format="json"))["host"] == []
    assert tnd._PROFILER is None
    tprof.start()
    assert tnd._PROFILER is tprof
    tprof.pause()
    assert tnd._PROFILER is None and not tprof.is_running()
    assert tprof._PAUSED_INTERVALS[-1][1] is None
    tprof.resume()
    assert tnd._PROFILER is tprof and tprof.is_running()
    assert tprof._PAUSED_INTERVALS[-1][1] is not None
    tprof.stop()
    assert tnd._PROFILER is None


def test_scope_and_dump(tmp_path):
    tprof.set_config(filename=str(tmp_path / "p.json"))
    tprof.set_state("run")
    try:
        with tprof.Scope("custom_region"):
            with tmx.cpu():
                tmx.np.array([1.0]).wait_to_read()
    finally:
        tprof.set_state("stop")
    assert "custom_region" in tprof.dumps()
    path = tprof.dump()
    with open(path) as f:
        payload = json.load(f)
    names = {e["name"] for e in payload["traceEvents"]}
    assert {"process_name", "custom_region"} <= names


def test_no_cuda_device_means_host_lanes_only():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tprof.set_config(profile_device=True)
    tprof.start()
    assert _build.LAUNCH_LOG is None          # no device trace, no log
    tprof.stop()
    assert tprof.device_events() == []
    meta = tprof.trace_meta()
    assert meta["device_lanes"] == [] and "no CUDA device" in meta["note"]
    assert ttracing.device_events() == []


def test_memory_section_and_peak_op():
    tprof.set_config(profile_memory=True)
    tprof.start()
    try:
        with tmx.cpu():
            big = tmx.np.ones((128, 128)) * 2.0
            (big @ big).sum().wait_to_read()
    finally:
        tprof.stop()
    out = tprof.dumps(memory=True, reset=True)
    for part in ("Memory", "MiB in use", "observed live-bytes peak",
                 "Largest live buffers"):
        assert part in out
    stats = tprof.memory_stats()
    assert all(st["bytes_in_use"] >= 0 for st in stats.values())
    rows = tprof.live_buffer_table(5)
    assert rows and rows[0][2] > 0


def test_memory_snapshot_and_analyze_memory(tmp_path):
    p = tprof.memory_snapshot(str(tmp_path / "mem.prof"))
    assert os.path.getsize(p) > 0
    # no allocator statistics for a CPU tensor
    assert tprof.analyze_memory(lambda a: a * 2, torch.ones(4)) is None


# ---------------------------------------------------------------------------
# the device-trace ingest, on a torch.profiler trace of the card
# ---------------------------------------------------------------------------

def _raw():
    """The raw torch.profiler trace of one profiled decode replay on the
    card (trimmed to its lanes' events), its launch log (one group, the
    replay's) and anchor."""
    with open(CARD, encoding="utf-8") as f:
        doc = json.load(f)
    return (doc["raw"], [[tuple(e) for e in g] for g in doc["log"]],
            doc["anchor_us"])


def _ingest(raw, log, anchor, **kw):
    tprof.dumps(reset=True)
    tprof._ingest_trace(copy.deepcopy(raw), log, anchor_us=anchor, **kw)
    return tprof.device_events()


def _kernels(events):
    return [e for e in events if e.get("ph") == "X"]


def test_ingest_keeps_the_cards_lanes_rebased():
    raw, log, anchor = _raw()
    events = _ingest(raw, log, anchor)
    lanes = {e["args"]["name"] for e in events if e.get("ph") == "M"
             and e["name"] == "process_name"}
    assert lanes and all(n.startswith("GPU ") for n in lanes)
    ks = _kernels(events)
    assert ks and all(e["pid"] >= 1000 for e in events)
    assert all(e["cat"] in tprof._DEVICE_CATS for e in ks)
    # the anchor lands the trace on the epoch clock: the kernels start
    # after the anchor read
    assert min(e["ts"] for e in ks) >= anchor
    meta = tprof.trace_meta()
    (replay,) = log                             # one replay: one group
    assert meta["joined"] == meta["launch_log"] == meta[
        "port_kernel_events"] == len(replay)
    assert meta["unjoined_groups"] == [] and meta["lost_launches"] == 0
    assert tkernels.census(events)["meta"]["lost_launches"] == 0
    ports = [e for e in ks if tprof.PORT_KERNEL.search(e["name"])]
    assert [(tprof.PORT_KERNEL.search(e["name"]).group(1),
             e["args"]["bytes_accessed"], e["args"]["flops"])
            for e in ports] == replay


def test_ingest_drops_paused_intervals():
    raw, log, anchor = _raw()
    ks = _kernels(_ingest(raw, log, anchor))
    mid = sorted(e["ts"] for e in ks)[len(ks) // 2]
    tprof._PAUSED_INTERVALS.append([mid - 0.5, None])
    try:
        kept = _kernels(_ingest(raw, log, anchor))
    finally:
        del tprof._PAUSED_INTERVALS[:]
    assert kept and all(e["ts"] < mid - 0.5 for e in kept)
    assert tprof.trace_meta()["paused_dropped"] == len(ks) - len(kept)


def test_device_lanes_start_after_their_launch_calls():
    """The card's clock, converted to the host's, can read a kernel before
    the call that launched it (by ~0.6 ms in one profiled decode replay on
    the card, which then lay outside its step's host span): the lanes are
    moved on by the largest such lead, keeping their own spacing."""
    def launch(corr, ts):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
                "pid": 7, "tid": 7, "ts": ts, "dur": 2.0,
                "args": {"correlation": corr}}

    def kernel(name, corr, ts):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                "tid": 7, "ts": ts, "dur": 5.0,
                "args": {"correlation": corr}}

    for lead, events in ((0.0, [launch(1, 100.0), kernel("a", 1, 120.0),
                                kernel("b", 1, 130.0)]),
                         (40.0, [launch(1, 100.0), kernel("a", 1, 60.0),
                                 kernel("b", 1, 70.0), launch(2, 90.0),
                                 kernel("c", 2, 80.0)])):
        tprof.dumps(reset=True)
        tprof._ingest_trace({"traceEvents": events}, [])
        got = {e["name"]: e["ts"] for e in _kernels(tprof.device_events())}
        want = {e["name"]: e["ts"] + lead for e in events
                if e["cat"] == "kernel"}
        assert got == want, (lead, got)


def test_device_lanes_end_before_the_calls_that_waited():
    """The converted clock can also read work after the host call that
    waited for it (a copy to pageable memory returns once the copy is
    done; a device synchronisation once all work launched before it is):
    the lanes are moved back by the least that puts it inside. Where the
    two bounds disagree the shift splits the disagreement and the meta
    says how large it is."""
    def call(name, corr, ts, dur):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 7,
                "tid": 7, "ts": ts, "dur": dur,
                "args": {} if corr is None else {"correlation": corr}}

    def work(name, corr, ts, dur=5.0, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
                "ts": ts, "dur": dur, "args": {"correlation": corr}}

    dtoh = "Memcpy DtoH (Device -> Pageable)"
    cases = (
        # the copy ends 30 us after its call returns: back by 30
        (-30.0, 0.0, [call("cudaGraphLaunch", 1, 100.0, 2.0),
                      work("a", 1, 140.0), call("cudaMemcpyAsync", 2, 110.0,
                                                50.0),
                      work(dtoh, 2, 180.0, 10.0, "gpu_memcpy")]),
        # the kernel ends 20 us after a device synchronisation returns
        (-20.0, 0.0, [call("cudaLaunchKernel", 1, 100.0, 2.0),
                      work("a", 1, 150.0, 30.0),
                      call("cudaDeviceSynchronize", None, 110.0, 50.0)]),
        # a synchronisation that began before the launch bounds nothing
        (0.0, 0.0, [call("cudaDeviceSynchronize", None, 90.0, 5.0),
                    call("cudaLaunchKernel", 1, 100.0, 2.0),
                    work("a", 1, 150.0, 30.0)]),
        # the kernel starts 10 us before its launch and the copy ends
        # 5 us after its call: no shift obeys both
        (2.5, 15.0, [call("cudaGraphLaunch", 1, 100.0, 2.0),
                      work("a", 1, 90.0), call("cudaMemcpyAsync", 2, 105.0,
                                               20.0),
                      work(dtoh, 2, 120.0, 10.0, "gpu_memcpy")]))
    for shift, conflict, events in cases:
        tprof.dumps(reset=True)
        tprof._ingest_trace({"traceEvents": events}, [])
        got = {e["name"]: e["ts"] for e in _kernels(tprof.device_events())}
        want = {e["name"]: e["ts"] + shift for e in events
                if e["cat"] != "cuda_runtime"}
        assert got == want, (shift, got)
        meta = tprof.trace_meta()
        assert (meta["device_shift_us"], meta["clock_conflict_us"]) == (
            shift, conflict)


def test_paused_work_is_what_was_launched_while_paused():
    """The pause is on the host's clock, and so is each launch call: work
    launched inside the interval is dropped wherever the card ran it, and
    work launched after it is kept even where the card's clock, rebased,
    puts it inside; an event with no launch call is placed by its own
    ts."""
    def launch(corr, ts):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "pid": 7, "tid": 7, "ts": ts, "dur": 2.0,
                "args": {"correlation": corr}}

    def kernel(name, corr, ts):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                "tid": 7, "ts": ts, "dur": 5.0,
                "args": {"correlation": corr}}

    raw = {"traceEvents": [
        launch(1, 150.0), kernel("ran_after", 1, 250.0),
        launch(2, 210.0), kernel("skewed", 2, 190.0),
        kernel("no_launch_call", 3, 150.0),
        launch(4, 50.0), kernel("before", 4, 60.0)]}
    tprof.dumps(reset=True)
    tprof._PAUSED_INTERVALS.append([100.0, 200.0])
    try:
        tprof._ingest_trace(raw, [])
    finally:
        del tprof._PAUSED_INTERVALS[:]
    kept = sorted(e["name"] for e in _kernels(tprof.device_events()))
    assert kept == ["before", "skewed"]
    assert tprof.trace_meta()["paused_dropped"] == 2


def test_paused_replay_joins_nothing():
    """A replay inside a paused interval (the held cycle's) launched with
    the log off: its events are dropped before the join, so the replay
    after it takes the log's costs and nothing is lost."""
    raw, log, anchor = _raw()
    ks = _kernels(_ingest(raw, log, anchor))
    lo, hi = min(e["ts"] for e in ks), max(e["ts"] + e["dur"] for e in ks)
    gap = hi - lo + 1000.0
    work = [e for e in raw["traceEvents"] if e.get("ph") == "X"
            and e.get("cat") in tprof._DEVICE_CATS]
    early = [dict(e, ts=e["ts"] - gap, args=dict(
        e.get("args") or {}, correlation=(e.get("args") or {}).get(
            "correlation", 0) + 10 ** 9)) for e in work]
    raw = dict(raw, traceEvents=raw["traceEvents"] + early)
    tprof._PAUSED_INTERVALS.append([lo - gap - 1.0, lo - 1.0])
    try:
        events = _ingest(raw, log, anchor)
    finally:
        del tprof._PAUSED_INTERVALS[:]
    meta = tprof.trace_meta()
    assert meta["paused_dropped"] == len(early)
    assert meta["joined"] == meta["port_kernel_events"] == len(log[0])
    assert meta["lost_launches"] == 0 and meta["unjoined_groups"] == []
    ports = [e for e in _kernels(events)
             if tprof.PORT_KERNEL.search(e["name"])]
    assert all("bytes_accessed" in e["args"] for e in ports)


def test_join_lost_records_stay_unknown():
    """A replay that lost its first port kernel's record joins nothing:
    every one of its events reads unknown rather than take a neighbour's
    cost; an eager launch after it still joins."""
    raw, log, anchor = _raw()
    ports = [e for e in raw["traceEvents"] if e.get("ph") == "X"
             and e.get("cat") == "kernel"
             and tprof.PORT_KERNEL.search(e.get("name", ""))]
    first = min(ports, key=lambda e: e["ts"])
    last = max(ports, key=lambda e: e["ts"])
    eager = dict(last, ts=last["ts"] + 100.0,
                 args=dict(last["args"], correlation=-1))
    raw = dict(raw, traceEvents=[e for e in raw["traceEvents"]
                                 if e is not first] + [eager])
    entry = ("ln_fwd_kernel", 7, 11)
    ks = _kernels(_ingest(raw, log + [entry], anchor))
    got = sorted((e for e in ks if tprof.PORT_KERNEL.search(e["name"])),
                 key=lambda e: e["ts"])
    assert len(got) == len(log[0])
    assert all("bytes_accessed" not in e["args"] for e in got[:-1])
    assert (got[-1]["args"]["bytes_accessed"], got[-1]["args"]["flops"]) \
        == (7, 11)
    meta = tprof.trace_meta()
    assert meta["joined"] == 1 and meta["unjoined_groups"] == [0]


def test_census_says_when_the_trace_lost_launches(caplog):
    """The launches the log holds and the trace lost ride with the device
    events: a census of them reports the number and warns, where one of
    a whole trace reports 0 and stays quiet."""
    raw, log, anchor = _raw()
    first = min((e for e in raw["traceEvents"] if e.get("ph") == "X"
                 and tprof.PORT_KERNEL.search(e.get("name", ""))),
                key=lambda e: e["ts"])
    cut = dict(raw, traceEvents=[e for e in raw["traceEvents"]
                                 if e is not first])
    with caplog.at_level("WARNING", "incubator_mxnet_tpu_torch.telemetry"):
        whole = tkernels.census(_ingest(raw, log, anchor))
        assert not caplog.records
        events = _ingest(cut, log, anchor)
        lost = tkernels.census(events)
    assert whole["meta"]["lost_launches"] == 0
    assert tprof.trace_meta()["lost_launches"] == 1
    assert lost["meta"]["lost_launches"] == 1
    assert [r.getMessage() for r in caplog.records if "lost 1 of the "
            f"{len(log[0])} port-kernel launches" in r.getMessage()]
    # the tally row is metadata: no row, no device time
    assert sum(r["count"] for r in lost["rows"]) == \
        sum(r["count"] for r in whole["rows"]) - 1


def test_join_groups_prefix_and_suffix():
    def ev(name, corr=None):
        return {"name": f"void {name}<float>(float*)",
                "args": {} if corr is None else {"correlation": corr}}

    # eager launches: a group each
    events = [ev("ln_fwd_kernel"), ev("dropout_kernel"),
              ev("flash_fwd_kernel"), ev("ln_fwd_kernel")]
    log = [("ln_fwd_kernel", 1, 1), ("gelu_dropout_kernel", 2, 2),
           ("flash_fwd_kernel", 3, 3), ("ln_fwd_kernel", 4, 4)]
    joined, left = tprof.join_launch_log(events, log)
    assert joined == {0: log[0], 2: log[2], 3: log[3]} and left == [1]
    # a replay (one correlation id) is one group: whole or nothing
    replay = [("ln_fwd_kernel", 5, 5), ("dropout_kernel", 6, 6)]
    events = [ev("ln_fwd_kernel", 9), ev("dropout_kernel", 9),
              ev("flash_fwd_kernel")]
    joined, left = tprof.join_launch_log(events, [replay, log[2]])
    assert joined == {0: replay[0], 1: replay[1], 2: log[2]} and left == []
    joined, left = tprof.join_launch_log(events[1:], [replay, log[2]])
    assert joined == {1: log[2]} and left == [0]
    assert tprof.join_launch_log([], log) == ({}, [0, 1, 2, 3])
    # torch's own dropout kernel is not the port's
    assert tprof.PORT_KERNEL.search(
        "void at::native::(anonymous namespace)::fused_dropout_kernel_vec"
        "<float, float, unsigned int, 1, 4, bool>") is None


@pytest.mark.parametrize("pool", ["POOL_KERNEL", "POOL_NHWC_KERNEL"])
def test_join_int8_replay_with_q1_and_q2(pool):
    """A hybridized int8 forward replays as one group holding Q1's launches
    and one of Q2's two kernels (the channels-last one on ResNet's stem):
    every event is a port kernel under the name its wrapper logs, so the
    group joins whole and no launch reads as lost."""
    from incubator_mxnet_tpu_torch.ops import quantized as q

    names = [q.CONV_KERNEL, getattr(q, pool)] + [q.CONV_KERNEL] * 3
    events = [{"name": f"void {n}<signed char, 1>(signed char const*)",
               "args": {"correlation": 7}} for n in names]
    replay = [(n, 10 + i, 20 + i) for i, n in enumerate(names)]
    assert [tprof.PORT_KERNEL.search(e["name"]).group(1)
            for e in events] == names
    joined, left = tprof.join_launch_log(events, [replay])
    assert joined == dict(enumerate(replay)) and left == []


def test_chrome_trace_merges_the_device_lanes():
    raw, log, anchor = _raw()
    events = _ingest(raw, log, anchor)
    payload = ttracing.chrome_trace(include_device=True)
    assert [e for e in payload["traceEvents"] if e.get("pid", 0) >= 1000] \
        == events
    assert ttracing.chrome_trace(include_device=False)["traceEvents"] == \
        ttracing.chrome_events()


# ---------------------------------------------------------------------------
# the registry's dump and textfile snapshot
# ---------------------------------------------------------------------------

def test_registry_dump_matches_reference_format(tmp_path):
    out = {}
    for name, reg in (("ref", jregistry), ("port", tregistry)):
        reg.counter("t_torch_dump_total").inc(3)
        reg.gauge("t_torch_dump_depth").set(7)
        reg.histogram("t_torch_dump_seconds", buckets=(0.1, 1.0)).observe(
            0.5)
        reg.step(0.05, examples=32)
        p = reg.dump(str(tmp_path / f"{name}.json"))
        with open(p) as f:
            text = f.read()
        doc = json.loads(text)
        out[name] = (text, {k: doc[k] for k in ("t_torch_dump_total",
                                                "t_torch_dump_depth",
                                                "t_torch_dump_seconds")})
        assert "mx_step_time_seconds" in doc and "mx_examples_total" in doc
        assert "mx_jit_cache_hits_total" in doc
    assert out["port"][1] == out["ref"][1]
    # the same layout: sorted keys, two-space indent
    for text, _ in out.values():
        assert text.startswith('{\n  "')
    assert tregistry.EXAMPLES.value >= 32
    assert tregistry.STEP_TIME.snapshot()["count"] >= 1


def test_textfile_dump_one_shot_and_interval(tmp_path):
    path = str(tmp_path / "metrics.prom")
    tregistry.counter("t_torch_textfile_total").inc(2)
    try:
        assert tregistry.arm_textfile_dump(path) == (path, None)
        with open(path) as f:
            assert "t_torch_textfile_total 2" in f.read()
        p2, interval = tregistry.arm_textfile_dump(f"{path}:0.05")
        assert (p2, interval) == (path, 0.05)
        assert tregistry._TEXTFILE["thread"].is_alive()
    finally:
        tregistry.stop_textfile_dump()
    assert tregistry._TEXTFILE["thread"] is None


def test_h2d_bytes_counter_counts_host_arrays():
    before = tregistry.H2D_BYTES.value
    with tmx.cpu():
        tmx.np.array([1.0, 2.0, 3.0, 4.0])
    assert tregistry.H2D_BYTES.value - before == 16


def test_server_command_queued_on_one_rank_applies_at_a_kvstore_barrier(
        tmp_path):
    """A ``profile_process="server"`` `set_config` queued on rank 1 of a
    2-rank gloo world applies on rank 0 too at the next
    `KVStoreDist.barrier` (`sync_remote_commands` over
    `dist.exchange_objs`), and nothing stays queued."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_worlds import world

    res = world.spawn(os.path.join(os.path.dirname(__file__), "torch_worlds",
                                   "kv_commands.py"), 2, tmp_path)
    for out in res:
        assert out["forbidden"] == []
        assert out["before"] != "from_rank1.json"
        assert out["filename"] == "from_rank1.json"
        assert out["pending"] == []
