"""The port's kernel census and roofline (`incubator_mxnet_tpu_torch.
telemetry.kernels`, `roofline`) against the JAX package's, on the CPU:
the same trace-event fixtures (the reference's demo trace, its
synthetic roofline trace, and a trimmed device trace of the port on the
card) through both packages' `census`, `diff_census`, `program_mfu` and
`roofline.analyze` give equal rows, meta and verdicts (floats within
rtol 1e-12); the port's phases place CUDA kernel names; each kernel
wrapper's `cost()` against hand-worked shapes; the pieces the costs
travel through (the program ledger's roll-up, a captured graph's launch
log, the graph pools' census)."""
import importlib
import json
import math
import os

import pytest
import torch

from incubator_mxnet_tpu.telemetry import kernels as jkernels
from incubator_mxnet_tpu.telemetry import roofline as jroofline
from incubator_mxnet_tpu_torch import _graphs
from incubator_mxnet_tpu_torch.ops import _build
from incubator_mxnet_tpu_torch.ops import dropout as dp
from incubator_mxnet_tpu_torch.ops import fused_block as fb
from incubator_mxnet_tpu_torch.ops import layer_norm as ln
from incubator_mxnet_tpu_torch.telemetry import compiles as tcompiles
from incubator_mxnet_tpu_torch.telemetry import hbm as thbm
from incubator_mxnet_tpu_torch.telemetry import kernels as tkernels
from incubator_mxnet_tpu_torch.telemetry import roofline as troofline

fa = importlib.import_module("incubator_mxnet_tpu_torch.ops.flash_attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "benchmark", "kernelscope_demo_trace.json")
CARD = os.path.join(REPO, "tests", "fixtures", "torch_card_trace.json")
# the demo trace's roofs, passed explicitly to both packages
ROOFS = dict(peak_gbs=819.0, peak_tflops=197.0)


def _load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _close(a, b):
    """Equal dicts/lists/values, floats within rtol 1e-12."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (a, b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12), (a, b)
    else:
        assert a == b, (a, b)


@pytest.fixture(autouse=True)
def _clean():
    yield
    jkernels.reset()
    tkernels.reset()


def _card_events():
    return _load(CARD)["events"]


FIXTURES = {"demo_before": lambda: _load(DEMO)["before"]["traceEvents"],
            "demo_after": lambda: _load(DEMO)["after"]["traceEvents"],
            "card": _card_events}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_census_matches_reference(name):
    events = FIXTURES[name]()
    ledger = _load(DEMO)["ledger"]
    j = jkernels.census(events, ledger=ledger, **ROOFS)
    t = tkernels.census(events, ledger=ledger, **ROOFS)
    _close(t["rows"], j["rows"])
    _close(t["meta"], j["meta"])
    _close(t["programs"], j["programs"])
    _close(tkernels.last_census(), jkernels.last_census())
    assert [r["name"] for r in tkernels.top_bandwidth_bound(t, 5)] == \
        [r["name"] for r in jkernels.top_bandwidth_bound(j, 5)]


def test_diff_census_matches_reference():
    doc = _load(DEMO)
    out = {}
    for mod in (jkernels, tkernels):
        b = mod.census(doc["before"]["traceEvents"], **ROOFS)
        a = mod.census(doc["after"]["traceEvents"], **ROOFS)
        out[mod] = (mod.diff_census(b, a), mod.format_diff(
            mod.diff_census(b, a)))
    _close(out[tkernels][0], out[jkernels][0])
    assert out[tkernels][0]["verdict"] == "fused"
    assert out[tkernels][1] == out[jkernels][1]
    rows = [{"name": "fusion.1", "time_us": 10.0}]
    two = [{"name": "fusion.1", "time_us": 6.0},
           {"name": "fusion.2", "time_us": 6.0}]
    for before, after in ((rows, two), (rows, rows), (two, rows)):
        _close(tkernels.diff_census(before, after),
               jkernels.diff_census(before, after))


def test_diff_census_names_template_variants_a_split():
    """The port's base name drops a kernel's template arguments, so two
    instantiations of one kernel are a split, not two unrelated names."""
    a = [{"name": "void k<float, 6>(float*)", "time_us": 5.0}]
    b = a + [{"name": "void k<__nv_bfloat16, 3>(float*)", "time_us": 4.0}]
    d = tkernels.diff_census(a, b)
    assert d["split"] == ["void k"] and d["verdict"] == "split"


@pytest.mark.parametrize("args", [
    (2.4e12, 10, 1.0, 197.0), (None, 10, 1.0, 197.0), (2.4e12, 0, 1.0, 197.0),
    (2.4e12, 10, 0.0, 197.0), (2.4e12, 10, 1.0, None),
    (7.5e11, 3, 0.0991, 989.0)])
def test_program_mfu_matches_reference(args):
    f, n, s, peak = args
    j = jkernels.program_mfu(f, n, s, peak_tflops=peak)
    t = tkernels.program_mfu(f, n, s, peak_tflops=peak)
    assert (t is None) == (j is None)
    if t is not None:
        assert t == pytest.approx(j, rel=1e-12)


def test_program_mfu_uses_the_cards_peak():
    assert tkernels.PEAK_TFLOPS["nvidia h100 80gb hbm3"] == 989.0
    assert tkernels.program_mfu(989e12, 1, 1.0,
                                device="NVIDIA H100 80GB HBM3") == 1.0


def _synthetic_trace():
    """tests/test_telemetry.py's synthetic roofline trace."""
    return [
        {"ph": "M", "name": "process_name", "pid": 1001,
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 1002,
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "process_name", "pid": 5,
         "args": {"name": "python"}},
        {"ph": "X", "pid": 1001, "name": "dot.1", "ts": 0, "dur": 1000,
         "args": {"bytes accessed": str(2**20)}},
        {"ph": "X", "pid": 1001, "name": "convolution.2", "ts": 1000,
         "dur": 1000, "args": {"bytes_accessed": 2**20}},
        {"ph": "X", "pid": 1001, "name": "fusion.7", "ts": 2000,
         "dur": 1000, "args": {"bytes": 4 * 2**20}},
        {"ph": "X", "pid": 1001, "name": "transpose.3", "ts": 2000,
         "dur": 500},
        {"ph": "X", "pid": 1002, "name": "$pjit.py:330 cache_miss",
         "ts": 0, "dur": 99999},
        {"ph": "X", "pid": 1002, "name": "ThunkExecutor::Execute",
         "ts": 0, "dur": 99999},
        {"ph": "X", "pid": 5, "name": "dot_python", "ts": 0, "dur": 12345},
    ]


ROOF_FIXTURES = dict(FIXTURES, synthetic=_synthetic_trace)


@pytest.mark.parametrize("name", sorted(ROOF_FIXTURES))
def test_roofline_matches_reference_phases(name):
    """The reference's phases (passed to both) give the same table; the
    port's own DEFAULT_PHASES place the reference's names as its do."""
    events = ROOF_FIXTURES[name]()
    mem = {"argument_size_in_bytes": 100, "output_size_in_bytes": 50,
           "temp_size_in_bytes": 25}
    j = jroofline.analyze(events, mem_analysis=mem, peak_gbs=819.0)
    t = troofline.analyze(events, mem_analysis=mem, peak_gbs=819.0,
                          phases=jroofline.DEFAULT_PHASES)
    _close(t, j)
    if name != "card":
        _close(troofline.analyze(events, peak_gbs=819.0),
               jroofline.analyze(events, peak_gbs=819.0))


def test_roofline_places_cuda_kernel_names():
    phase = []
    for name in (
            "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
            "nvjet_tst_128x256_64x4_2x1_v_bz_coopB_NNT",
            "cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>",
            "void cudnn::cnn::conv2d_grouped_direct_kernel<float>",
            "void (anonymous namespace)::flash_fwd_kernel<float, 64>(...)",
            "void (anonymous namespace)::flash_bwd_dkv_kernel<float, 64>",
            "void ln_fwd_kernel<float, float, float, 6, 0>(...)",
            "void ln_partials_reduce_kernel<float>(float const*, ...)",
            "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<"
            "float, at::native::MulFunctor<float>>>",
            "void (anonymous namespace)::dropout_kernel<float>(...)",
            "void (anonymous namespace)::gelu_dropout_kernel<float, true, "
            "false>(...)",
            "void (anonymous namespace)::fold_keys_kernel(...)",
            "Memcpy DtoD (Device -> Device)", "Memset (Device)",
            "void at::native::elementwise_kernel<128, 4, at::native::"
            "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda("
            "at::TensorIteratorBase&)::{lambda()#3}::operator()>",
            "void at::native::vectorized_elementwise_kernel<4, at::native::"
            "BinaryFunctor<float, float, float, at::native::binary_internal"
            "::MulFunctor<float>>>",
            "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4,"
            " float>"):
        ev = [{"ph": "X", "pid": 1, "name": name, "ts": 0, "dur": 1.0}]
        phase.append(troofline.analyze(ev)["rows"][0]["phase"])
    assert phase == [
        "matmul/conv", "matmul/conv", "matmul/conv", "matmul/conv",
        "attention", "attention", "norm/reduce", "norm/reduce",
        "norm/reduce", "rng/dropout", "rng/dropout", "rng/dropout",
        "copy/layout", "copy/layout", "copy/layout", "fusion/elementwise",
        "attention"], phase


def test_card_fixture_lanes_and_phases_sum():
    """The device trace the port's profiler kept on the card: its lanes
    are what torch.profiler names the card, the port's kernels carry
    their costs, and the phases sum to the census's device time."""
    doc = _load(CARD)
    events = doc["events"]
    lanes = {e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert lanes and all(n.startswith("GPU ") for n in lanes), lanes
    assert troofline._device_lane_pids(events)
    assert not jroofline._device_lane_pids(events)
    cen = tkernels.census(events, device=doc["device"])
    roof = troofline.analyze(events, device=doc["device"])
    assert roof["total"]["time_us"] == pytest.approx(
        cen["meta"]["total_device_us"], rel=1e-12)
    assert roof["meta"]["peak_gbs"] == 3350.0
    port = [r for r in cen["rows"] if r["name"].find("ln_fwd_kernel") >= 0]
    assert port and all(r["bytes_known"] == r["count"] for r in port)
    assert cen["meta"]["peak_tflops"] == 989.0


# ---------------------------------------------------------------------------
# the wrappers' costs, by hand
# ---------------------------------------------------------------------------

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("case", [
    # K4 (rows, C, x, gamma): 2 x rows*C*ix + 8*rows + 2*C*ip, 8*rows*C
    (ln.cost, (2, 8, F32), (2 * 16 * 4 + 16 + 2 * 8 * 4, 128)),
    (ln.cost, (8192, 768, BF16, F32), (2 * 8192 * 768 * 2 + 8 * 8192
                                       + 2 * 768 * 4, 8 * 8192 * 768)),
    # K4b: 3 x rows*C*ix + 8*rows + 3*C*ip, 12*rows*C
    (ln.bwd_cost, (4, 16, F16), (3 * 64 * 2 + 32 + 3 * 16 * 2, 12 * 64)),
    # K3 forward and backward (rows, C, x, h, gamma)
    (fb.cost, (4, 8, F32, BF16, F32), ((2 * 4 + 2) * 32 + 32 + 2 * 8 * 4,
                                       10 * 32)),
    (fb.bwd_cost, (4, 8, F32, BF16, F32), ((3 * 4 + 2 * 2) * 32 + 32
                                           + 3 * 8 * 4, 16 * 32)),
    # K5 and K6: elements x item, operations an element
    (dp.cost, (1000, BF16), (2 * 1000 * 2, 1000)),
    (fb.gd_cost, (10, F32), (80, 200)),
    (lambda n, d: fb.gd_cost(n, d, bwd=True), (10, F16), (60, 400)),
    # the fold: the base key and t read, 8 bytes a site written
    (dp.fold_cost, (64,), (24 + 512, 64 * 240)),
    # K1 (b, h, tq, tk, d, dtype): q, k, v read, o written, lse; 4 x pairs
    # x d a head
    (fa.cost, (2, 3, 4, 4, 8, F32), ((8 + 16 + 8) * 3 * 8 * 4 + 2 * 3 * 4
                                     * 4, 4 * 3 * 8 * 32)),
    (lambda *a: fa.cost(*a, causal=True), (2, 3, 4, 4, 8, BF16),
     ((8 + 16 + 8) * 3 * 8 * 2 + 96, 4 * 3 * 8 * 16)),
    # lengths 1 and 3: 4 live rows and keys, 1 + 9 pairs
    (lambda *a: fa.cost(*a, lengths=[1, 3]), (2, 1, 4, 4, 2, F32),
     ((4 + 8 + 8) * 2 * 4 + 32, 4 * 2 * 10)),
    # K2: 5 reads live, 3 writes, lse + delta; 10 x pairs x d a head
    (fa.bwd_cost, (1, 2, 4, 4, 8, F32), ((5 * 4 + 3 * 4) * 2 * 8 * 4
                                         + 2 * 2 * 4 * 4, 10 * 2 * 8 * 16)),
])
def test_cost_by_hand(case):
    fn, args, want = case
    assert tuple(fn(*args)) == want


@pytest.mark.parametrize("shape", [(8192, 768, F32, F32),
                                   (8192, 768, BF16, F32), (3, 16, F16, F16)])
def test_backward_costs_split_over_their_launches(shape):
    rows = ln.bwd_cost(*shape, kernel="rows")
    red = ln.bwd_cost(*shape, kernel="reduce")
    assert (rows[0] + red[0], rows[1] + red[1]) == ln.bwd_cost(*shape)
    assert red == (2 * shape[1] * _build.item_size(shape[3]), 0)
    x, h = shape[2], BF16
    k3 = [fb.bwd_cost(shape[0], shape[1], x, h, shape[3], kernel=k)
          for k in ("rows", "reduce")]
    assert tuple(map(sum, zip(*k3))) == fb.bwd_cost(shape[0], shape[1], x,
                                                     h, shape[3])
    att = (4, 12, 128, 128, 64, shape[2])
    parts = [fa.bwd_cost(*att, kernel=k) for k in fa.BWD_KERNELS]
    assert tuple(map(sum, zip(*parts))) == fa.bwd_cost(*att)


def test_costs_reproduce_the_perf_bounds():
    """The bounds PERF.md's table keeps, from the cost functions: bytes
    over 3.35 TB/s, operations over 989 TFLOP/s (bf16)."""
    def ms(cost, rate=989e12):
        return max(cost[0] / 3.35e12, cost[1] / rate) * 1e3

    assert round(ms(ln.cost(8192, 768, F32)), 4) == 0.0150
    assert round(ms(fa.cost(64, 12, 128, 128, 64, BF16)), 4) == 0.0151
    assert round(ms(fa.bwd_cost(64, 12, 128, 128, 64, BF16)), 4) == 0.0303
    assert round(ms(fb.bwd_cost(8192, 768, F32, F32, F32), 67e12),
                 4) == 0.0376
    assert round(ms(ln.bwd_cost(8192, 768, BF16)), 4) == 0.0113
    assert round(ms(dp.cost(8192 * 3072, F32), 67e12), 4) == 0.0601


def test_data_dependent_cost_unknown_inside_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)

    class OnCard(torch.Tensor):
        pass

    lens = torch.tensor([1, 3]).as_subclass(OnCard)
    monkeypatch.setattr(OnCard, "device", property(
        lambda self: torch.device("cuda", 0)))
    assert fa.cost(2, 1, 4, 4, 2, F32, lens) == (None, None)
    assert fa.bwd_cost(2, 1, 4, 4, 2, F32, lens, kernel="dq") == (None, None)


# ---------------------------------------------------------------------------
# where the costs travel: the launch log, the ledger, the graph pools
# ---------------------------------------------------------------------------

def test_plain_versions_log_no_launch():
    saved = _build.LAUNCH_LOG
    _build.LAUNCH_LOG = log = []
    try:
        x = torch.randn(4, 8)
        ln.layer_norm_fwd(x, torch.ones(8), torch.zeros(8))
        dp.dropout_fwd(x, (1, 2), 0.5)
    finally:
        _build.LAUNCH_LOG = saved
    assert log == []


def test_capture_log_replaces_the_open_log():
    class G:
        launch_log = []

    outer = []
    saved = _build.LAUNCH_LOG
    _build.LAUNCH_LOG = outer
    g = G()
    try:
        with _graphs.logging_launches(g) as log:
            _build.LAUNCH_LOG.append(("ln_fwd_kernel", 1, 2))
        assert log is g.launch_log and g.launch_log == [
            ("ln_fwd_kernel", 1, 2)]
        assert _build.LAUNCH_LOG is outer and outer == []
    finally:
        _build.LAUNCH_LOG = saved


def test_ledger_entry_carries_flops_and_kernel_bytes():
    tcompiles.reset()
    tcompiles.enable()
    try:
        x = torch.zeros(2, 3)
        log = [("ln_fwd_kernel", 100, 7), ("dropout_kernel", 50, 3)]
        e = tcompiles.record_capture("fam.a", 0.1, args=(x,), flops=1000,
                                     launch_log=log)
        assert (e["flops"], e["bytes_accessed"]) == (1010, 150)
        e = tcompiles.record_capture("fam.b", 0.1, args=(x,),
                                     launch_log=log + [("k", None, None)])
        assert (e["flops"], e["bytes_accessed"]) == (None, None)
        e = tcompiles.record_capture("fam.c", 0.1, args=(x,), flops=5)
        assert (e["flops"], e["bytes_accessed"]) == (5, None)
        rep = tcompiles.ledger_report()
        assert rep["fam.a"]["flops"] == 1010
        assert rep["fam.a"]["bytes_accessed"] == 150
        cen = tkernels.census([], ledger=rep, peak_gbs=3350.0,
                              peak_tflops=989.0)
        assert cen["programs"]["fam.a"]["arith_intensity"] == \
            pytest.approx(1010 / 150)
    finally:
        tcompiles.disable()
        tcompiles.reset()


def test_count_flops_counts_forward_and_backward():
    a = torch.randn(4, 8, requires_grad=True)
    b = torch.randn(8, 3)
    _, flops = _graphs.count_flops(lambda: (a @ b).sum().backward())
    assert flops == 2 * (2 * 4 * 8 * 3)      # a @ b, and da = g @ b.T


def test_graph_pools_go_to_their_owner():
    snap = [
        {"segment_pool_id": (0, 7), "blocks": [
            {"state": "active_allocated", "address": 10, "size": 100},
            {"state": "active_allocated", "address": 20, "size": 50},
            {"state": "inactive", "address": 30, "size": 999}]},
        {"segment_pool_id": (0, 0), "blocks": [
            {"state": "active_allocated", "address": 40, "size": 7}]}]
    got = thbm.graph_pool_bytes(snap, {(0, 7): "graph:train.step"}, {20})
    assert got == {"graph:train.step": 100}
    assert math.isclose(sum(got.values()), 100)
