"""The port's int8 post-training quantization (`contrib.quantization`,
the Q1/Q2 kernels' plain versions) against the JAX package's.

The same weights go into both (the port's net initialised and seeded,
random BatchNorm statistics, saved with ``save_parameters`` and loaded by
the reference's ``load_parameters``), the same numpy-seeded batches
calibrate both. Tolerances:

- the entropy threshold: equal in float64 (the same numpy code);
- a quantized layer with carried weights and one threshold: the int8
  weight codes and the int32 sums exact, the outputs within rtol 1e-6
  (one f32 rounding of the same products in another order of operations
  at most: XLA may contract the epilogue's multiply and add into an FMA);
- whole nets (fold, requantize, residual and boundary chains): the
  rewrite's counts equal, the folded weights within rtol 1e-6, the logits
  within 1e-3 of the largest. A chain of int8 layers rounds every activation
  to a code; where the reference's XLA contracts an epilogue into an FMA,
  a code at a rounding tie moves by one step, and the step moves the
  next layer's sums. The test counts the stem's codes that differ (at
  most 1 in 1000, each by one step; none on these seeds);
- a net quantized and saved by the reference, loaded into the port's
  quantized net: the same logits within the same tolerance, every
  quantized parameter equal;
- the int8 chain's layout (channels-last codes and weights) changes no
  bit: the wrappers' outputs on channels-last and contiguous inputs are
  equal, and the residual add in Q1's epilogue (its plain version) equals
  the block's torch-op glue bit for bit; a residual block through the
  fused path against the reference's block: its int8 codes as the stem's
  (at most 1 in 1000 differs, by one step).
"""
import collections
import logging
from types import SimpleNamespace

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.contrib import quantization as jq
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu_torch.contrib import quantization as tq
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_tpu_torch.ops import quantized as tops
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from test_torch_rnn import _reference
from test_torch_vision_zoo import randomize_stats

NET_TOL = 1e-3
LAYER_RTOL = 1e-6


def _x(shape, seed, lo=-1.0, hi=1.0):
    return onp.random.RandomState(seed).uniform(lo, hi, shape).astype(
        "float32")


def _pair(make, shape, tmp_path, seed=0):
    """(reference net, port net, x) with the port's seeded weights and
    random statistics carried into the reference."""
    x = _x(shape, seed + 1)
    with tmx.cpu():
        tmx.random.seed(seed)
        tnet = make(tvision)
        tnet.initialize()
        tnet(torch.from_numpy(x))
        randomize_stats(tnet, seed + 2)
        path = str(tmp_path / f"net{seed}.params")
        tnet.save_parameters(path)
    jnet = make(jvision)
    jnet.load_parameters(path)
    return jnet, tnet, x


def _walk(net):
    out, stack = [], [net]
    while stack:
        b = stack.pop()
        out.append(b)
        stack.extend(b._children.values())
    return out


def _census(net):
    """The rewrite's counts: quantized layers, residual wrappers, BN
    folds (Identity children), requantize and boundary links."""
    blocks = _walk(net)
    names = [type(b).__name__ for b in blocks]
    links = sum(1 for b in blocks
                if b.__dict__.get("_out_threshold") is not None)
    return {n: names.count(n) for n in ("QuantizedConv2D", "QuantizedDense",
                                       "QuantizedResidualBlock", "Identity",
                                       "BatchNorm")} | {"links": links}


def _rel(got, want):
    return float(onp.abs(got - want).max() / onp.abs(want).max())


def _rewrite_log(name):
    """A logger for ``quantize_net(logger=...)`` and the counts of its
    rewrite messages by their first word ("quantized",
    "requantize-chained", "residual-chained", "boundary-chained")."""
    counts = collections.Counter()

    class Handler(logging.Handler):
        def emit(self, record):
            counts[record.getMessage().split(" ")[0]] += 1

    logger = logging.getLogger(f"test_torch_quantization.{name}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    logger.handlers[:] = [Handler()]
    return logger, counts


def _values(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


# BasicBlockV1's residual chain (resnet18's block) and BottleneckV1's
# (resnet50's), narrow, two stages of one block each: a block with and one
# without a downsample, the stem's boundary through its max pool and a
# stage-to-stage boundary (the reference's eager calibration compiles op
# by op, some 0.4 s a block on the CPU)
BASIC = (lambda v: v.ResNetV1(v.BasicBlockV1, [1, 1], [8, 8, 16],
                              classes=10), (2, 3, 32, 32))
BOTTLENECK = (lambda v: v.ResNetV1(v.BottleneckV1, [1, 1], [8, 16, 32],
                                   classes=10), (2, 3, 32, 32))
BLOCKS = 2


@pytest.fixture(scope="module")
def quantized_pairs(tmp_path_factory):
    """Each net quantized in both packages with the same weights and the
    same naive calibration batch (the port's f32 net is the reference's,
    `test_torch_vision_zoo.py`): {name: namespace of jnet, tnet, x, the f32
    logits, the BN folds' counts and folded values (folded first, as
    quantize_net's first step does), and the rewrite's logged counts}."""
    out = {}
    for i, (name, (make, shape)) in enumerate((("basic", BASIC),
                                               ("bottleneck", BOTTLENECK))):
        jnet, tnet, x = _pair(make, shape, tmp_path_factory.mktemp(name), i)
        with tmx.cpu():
            f32 = tnet(tmx.np.array(x)).asnumpy()
        folds = (jq.fold_conv_bn(jnet), tq.fold_conv_bn(tnet))
        folded = (_values(jnet), _values(tnet))
        jlog, jcounts = _rewrite_log(f"{name}.reference")
        tlog, tcounts = _rewrite_log(f"{name}.port")
        jq.quantize_net(jnet, calib_data=[jmx.np.array(x)],
                        calib_mode="naive", logger=jlog)
        with tmx.cpu():
            tq.quantize_net(tnet, calib_data=[tmx.np.array(x)],
                            calib_mode="naive", logger=tlog)
        out[name] = SimpleNamespace(jnet=jnet, tnet=tnet, x=x, f32=f32,
                                    folds=folds, folded=folded,
                                    logs=(jcounts, tcounts))
    return out


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_entropy_threshold_equals_the_references():
    r = onp.random.RandomState(0)
    a = onp.abs(onp.concatenate([r.normal(0, 1, 20000),
                                 r.normal(0, 8, 30)]))
    hist, edges = onp.histogram(a, bins=2048, range=(0, a.max()))
    want = jq.optimal_threshold_entropy(hist, edges)
    got = tq.optimal_threshold_entropy(hist, edges)
    assert got == want and got < a.max()
    stats = tq._ActivationStats(512)
    stats.update_minmax(a)
    stats.update_hist(a)
    jstats = jq._ActivationStats(512)
    jstats.update_minmax(a)
    jstats.update_hist(a)
    for mode in ("naive", "entropy"):
        assert stats.threshold(mode) == jstats.threshold(mode)


def test_collect_thresholds_entropy_on_a_dense_net():
    x = _x((16, 12), 3, -2.0, 2.0)
    with tmx.cpu():
        tmx.random.seed(1)
        tnet = tmx.gluon.nn.HybridSequential()
        tnet.add(tmx.gluon.nn.Dense(8, activation="relu"),
                 tmx.gluon.nn.Dense(4))
        tnet.initialize()
        tnet(torch.from_numpy(x))
        tnet.hybridize()
        params = {k: v.data().asnumpy()
                  for k, v in tnet.collect_params().items()}
        layers = tq._find_target_layers(tnet)
        got = tq.collect_thresholds(tnet, layers, [tmx.np.array(x)],
                                    "entropy", num_bins=512)
        assert tnet._active
    jnet = jmx.gluon.nn.HybridSequential()
    jnet.add(jmx.gluon.nn.Dense(8, activation="relu", in_units=12),
             jmx.gluon.nn.Dense(4, in_units=8))
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.np.array(params[k]))
    jlayers = jq._find_target_layers(jnet)
    want = jq.collect_thresholds(jnet, jlayers, [jmx.np.array(x)],
                                 "entropy", num_bins=512)
    got = [got[id(layer)] for _, _, layer in layers]
    want = [want[id(layer)] for _, _, layer in jlayers]
    onp.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# one quantized layer
# ---------------------------------------------------------------------------

CONVS = {
    "plain": dict(channels=8, kernel_size=(3, 3), padding=(1, 1)),
    "stride_pad": dict(channels=6, kernel_size=(3, 3), strides=(2, 2),
                       padding=(1, 1)),
    "dilate": dict(channels=5, kernel_size=(3, 3), dilation=(2, 2),
                   padding=(2, 2)),
    "groups_k_ragged": dict(channels=6, kernel_size=(3, 1), groups=3,
                            strides=(1, 2), use_bias=True),
    "stem_k147": dict(channels=4, kernel_size=(7, 7), strides=(2, 2),
                      padding=(3, 3), use_bias=False),
}
CONV_IN = {"groups_k_ragged": (2, 9, 7, 8), "stem_k147": (2, 3, 15, 15)}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_quantized_conv_matches_the_references(case):
    kw = dict(CONVS[case])
    shape = CONV_IN.get(case, (2, 4, 9, 9))
    x = _x(shape, 5)
    thresh = 0.8
    with tmx.cpu():
        tmx.random.seed(2)
        tc = tmx.gluon.nn.Conv2D(**kw)
        tc.initialize()
        tc(torch.from_numpy(x))
        if tc.bias is not None:
            tc.bias.set_data(_x(tc.bias.shape, 6))
        w = tc.weight.data().asnumpy()
        b = None if tc.bias is None else tc.bias.data().asnumpy()
        tqc = tq.QuantizedConv2D(tc, thresh)
        got = tqc(tmx.np.array(x)).asnumpy()
        acc = tops.conv_int8(
            tq._quantize_input(torch.from_numpy(x), torch.tensor(thresh)),
            tqc.qweight.data()._data, torch.tensor(thresh),
            tqc.qscale.data()._data, out_dtype=torch.int32,
            stride=tc._stride, pad=tc._pad, dilate=tc._dilate,
            groups=tc._groups)
    jc = jmx.gluon.nn.Conv2D(in_channels=shape[1], **kw)
    jc.weight.set_data(jmx.np.array(w))
    if b is not None:
        jc.bias.set_data(jmx.np.array(b))
    jqc = jq.QuantizedConv2D(jc, thresh)
    onp.testing.assert_array_equal(tqc.qweight.data().asnumpy(),
                                   jqc.qweight.data().asnumpy())
    import jax

    xq = onp.clip(onp.round(x / onp.float32(thresh / 127.0)), -127,
                  127).astype("int8")

    def reference(xa, xqa):
        # the layer, and its int32 sums as the reference contracts them
        acc = jax.lax.conv_general_dilated(
            xqa._data, jqc.qweight.data()._data,
            window_strides=tc._stride, padding=[(p, p) for p in tc._pad],
            rhs_dilation=tc._dilate, feature_group_count=tc._groups,
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            preferred_element_type=jax.numpy.int32)
        return jqc(xa), NDArray(acc)

    want, want_acc = _reference(reference, x, xq)
    onp.testing.assert_array_equal(acc.numpy(), want_acc)
    onp.testing.assert_allclose(got, want, rtol=LAYER_RTOL,
                                atol=LAYER_RTOL * onp.abs(want).max())


@pytest.mark.parametrize("flatten,act", [(True, None), (False, "relu")])
def test_quantized_dense_matches_the_references(flatten, act):
    x = _x((3, 2, 20), 7)
    with tmx.cpu():
        tmx.random.seed(3)
        td = tmx.gluon.nn.Dense(9, activation=act, flatten=flatten)
        td.initialize()
        td(torch.from_numpy(x))
        td.bias.set_data(_x((9,), 8))
        w, b = td.weight.data().asnumpy(), td.bias.data().asnumpy()
        tqd = tq.QuantizedDense(td, 1.1)
        got = tqd(tmx.np.array(x)).asnumpy()
    jd = jmx.gluon.nn.Dense(9, activation=act, flatten=flatten,
                            in_units=w.shape[1])
    jd.weight.set_data(jmx.np.array(w))
    jd.bias.set_data(jmx.np.array(b))
    want = _reference(jq.QuantizedDense(jd, 1.1), x)
    assert got.shape == want.shape
    onp.testing.assert_allclose(got, want, rtol=LAYER_RTOL,
                                atol=LAYER_RTOL * onp.abs(want).max())


def test_the_epilogue_rounds_as_the_reference_orders_it():
    """int8 emission at the consumer's threshold: codes from the
    reference's formula in float32 numpy, halves to even."""
    acc = torch.tensor([[[[254]], [[-381]], [[1000]], [[7]]]],
                       dtype=torch.int32)
    thresh, wscale = torch.tensor(1.27), torch.tensor([0.5, 0.5, 2.0, 0.1])
    out_t = torch.tensor(2.54)
    got = tops.plain_epilogue(acc, thresh, wscale, None, out_t, torch.int8)
    s_x = onp.float32(1.27) / onp.float32(127.0)
    y = acc.numpy().astype("float32") * (s_x * wscale.numpy())[None, :, None,
                                                                 None]
    want = onp.clip(onp.round(y * (onp.float32(127.0) / onp.float32(2.54))),
                    -127, 127).astype("int8")
    onp.testing.assert_array_equal(got.numpy(), want)


def _channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv_int8_is_the_same_on_channels_last_and_contiguous_codes(case):
    """Q1's plain version on channels-last codes and weight and on NCHW
    contiguous ones: equal codes, sums and floats, the output
    channels-last either way."""
    kw = CONVS[case]
    shape = CONV_IN.get(case, (2, 4, 9, 9))
    r = onp.random.RandomState(21)
    o, groups = kw["channels"], kw.get("groups", 1)
    w_shape = (o, shape[1] // groups) + kw["kernel_size"]
    x = torch.from_numpy(r.randint(-127, 128, shape).astype("int8"))
    w = torch.from_numpy(r.randint(-127, 128, w_shape).astype("int8"))
    th, ot = torch.tensor(2.5), torch.tensor(1.7)
    wsc = torch.from_numpy(r.uniform(1e-3, 2e-3, o).astype("float32"))
    geo = dict(stride=kw.get("strides", (1, 1)),
               pad=kw.get("padding", (0, 0)),
               dilate=kw.get("dilation", (1, 1)), groups=groups)
    for od in (torch.int8, torch.int32, torch.float32):
        got = tops.conv_int8(_channels_last(x), _channels_last(w), th, wsc,
                             None, ot, od, **geo)
        want = tops.conv_int8(x, w, th, wsc, None, ot, od, **geo)
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert want.is_contiguous(memory_format=torch.channels_last)
        assert got.dtype == od and torch.equal(got, want), od


def test_dense_int8_is_the_same_on_strided_and_contiguous_rows():
    r = onp.random.RandomState(22)
    x = torch.from_numpy(r.randint(-127, 128, (40, 6)).astype("int8"))
    w = torch.from_numpy(r.randint(-127, 128, (9, 40)).astype("int8"))
    th, wsc = torch.tensor(0.9), torch.from_numpy(
        r.uniform(1e-3, 2e-3, 9).astype("float32"))
    for od in (torch.int32, torch.float32):
        got = tops.dense_int8(x.t(), w, th, wsc, out_dtype=od)
        want = tops.dense_int8(x.t().contiguous(), w, th, wsc, out_dtype=od)
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", sorted(
    k for k in ("valid", "full", "window_in_padding")))
def test_max_pool_int_is_the_same_on_channels_last_and_contiguous(case):
    """The 2-d cases of POOLS through npx.pooling (Q2's plain version) on
    channels-last and on contiguous int8 and uint8 codes: equal, the
    output channels-last either way."""
    from incubator_mxnet_tpu_torch.ndarray.ndarray import NDArray as TND

    kw = POOLS[case]
    r = onp.random.RandomState(23)
    for dt, lo in ((torch.int8, -128), (torch.uint8, 0)):
        x = torch.from_numpy(r.randint(lo, lo + 256, (2, 32, 9, 10))).to(dt)
        with tmx.cpu():
            got = tmx.npx.pooling(TND(_channels_last(x)), pool_type="max",
                                  **kw)._data
            want = tmx.npx.pooling(TND(x), pool_type="max", **kw)._data
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert want.is_contiguous(memory_format=torch.channels_last)
        assert got.dtype == dt and torch.equal(got, want)


def _glue_case(r, shape, ties):
    """Random int32 sums and thresholds; ``ties`` picks scales at which
    the epilogue's products land on halves (round half to even)."""
    acc = torch.from_numpy(r.randint(-3000, 3000, shape).astype("int32"))
    res = torch.from_numpy(r.randint(-127, 128, shape).astype("int8"))
    c = shape[1]
    if ties:
        # s_x = 1, y = acc / 2; t_add = 127: s_add = 1; t_in = 63.5:
        # s_in = 1 / 2; 127 / 254 = 1 / 2
        th, t_add, t_in, t_out = (torch.tensor(v) for v in
                                  (127.0, 127.0, 63.5, 254.0))
        wsc = torch.full((c,), 0.5)
        bias = torch.from_numpy(r.randint(-4, 5, c).astype("float32"))
    else:
        th, t_add, t_in, t_out = (torch.tensor(onp.float32(v)) for v in
                                  r.uniform(0.5, 4.0, 4))
        wsc = torch.from_numpy(r.uniform(1e-3, 3e-3, c).astype("float32"))
        bias = torch.from_numpy(r.normal(0, 0.3, c).astype("float32"))
    return acc, res, th, wsc, bias, t_add, t_in, t_out


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "random"])
@pytest.mark.parametrize("mode", ["same", "identity"])
@pytest.mark.parametrize("out", ["int8", "float32", "bfloat16"])
def test_fused_residual_epilogue_equals_the_blocks_glue(mode, out, ties):
    """Q1's epilogue with the residual (its plain version, which the
    kernel equals bit for bit on the card) against the block's torch-op
    glue on the same code: the add, relu and requantize bit for bit."""
    r = onp.random.RandomState(24 + ties)
    acc, res, th, wsc, bias, t_add, t_in, t_out = _glue_case(
        r, (3, 16, 5, 7), ties)
    od = getattr(torch, out)
    b_out = t_out if od == torch.int8 else None
    a = tops.plain_epilogue(acc, th, wsc, bias, t_add, torch.int8)
    if ties:
        # the ties are there: halves at the code and at the requantize
        y = acc.float() * 0.5 + bias.reshape(1, -1, 1, 1)
        assert (y.frac().abs() == 0.5).any()
        if mode == "same" and od == torch.int8:
            assert ((a.int() + res.int()) % 2 == 1).any()
    want = tq._residual_add(a, res, t_add, t_in if mode == "identity"
                            else None, b_out, mode == "same", od)
    got = tops.plain_epilogue(acc, th, wsc, bias, t_add, od, residual=res,
                              residual_mode=mode, residual_t=t_in,
                              block_out_t=b_out)
    assert got.dtype == want.dtype == od and torch.equal(got, want)


def _quantized_inputs(net):
    """A forward pre-hook on every quantized layer and residual block of
    ``net``: [(module, its input tensor, the residual it was called
    with)], in forward order."""
    seen, hooks = [], []
    for m in _walk(net):
        if isinstance(m, (tq.QuantizedConv2D, tq.QuantizedDense,
                          tq.QuantizedResidualBlock)):
            def pre(mod, args, kwargs):
                t = getattr(args[0], "_data", args[0])
                r = kwargs.get("residual")
                seen.append((mod, t, getattr(r, "_data", r)))
            hooks.append(m.register_forward_pre_hook(pre, with_kwargs=True))
    return seen, hooks


@pytest.mark.parametrize("name", ["basic", "bottleneck"])
def test_int8_chain_runs_channels_last_through_fused_blocks(quantized_pairs,
                                                            name):
    """Every quantized conv's int8 input and weight are channels-last,
    and every residual block's add runs in its last conv's epilogue (one
    call with the residual a block, the residual channels-last)."""
    q = quantized_pairs[name]
    seen, hooks = _quantized_inputs(q.tnet)
    try:
        with tmx.cpu():
            q.tnet(tmx.np.array(q.x))
    finally:
        for h in hooks:
            h.remove()
    int8_in = [(m, t) for m, t, _ in seen
               if t.dtype == torch.int8 and t.dim() == 4]
    assert len(int8_in) >= 2 * BLOCKS
    for m, t in int8_in:
        assert t.is_contiguous(memory_format=torch.channels_last), m
    for m in _walk(q.tnet):
        if isinstance(m, tq.QuantizedConv2D):
            w = m.qweight.data()._data
            assert w.is_contiguous(memory_format=torch.channels_last)
    fused = [(m, r) for m, _, r in seen if r is not None]
    assert len(fused) == BLOCKS
    assert all(r.dtype == torch.int8 and
               r.is_contiguous(memory_format=torch.channels_last)
               for _, r in fused)


def _blocks(net):
    return [b for b in _walk(net) if isinstance(b, (
        tq.QuantizedResidualBlock, jq.QuantizedResidualBlock))]


@pytest.mark.parametrize("which", ["identity", "downsample"])
def test_fused_residual_block_matches_the_references(quantized_pairs,
                                                     which):
    """One block through the fused path (basic net: stage 1's identity
    block, stage 2's downsample block), on the input the port's net gives
    it, against the reference's QuantizedResidualBlock on the same codes:
    its int8 output within one step at ties (at most 1 code in 1000), as
    the stem's; and against the same block through the torch-op glue
    (the fused site refused) bit for bit."""
    q = quantized_pairs["basic"]
    tblocks, jblocks = _blocks(q.tnet), _blocks(q.jnet)
    # _walk visits children last-first: order the blocks by stage
    tblocks, jblocks = tblocks[::-1], jblocks[::-1]
    k = 0 if which == "identity" else 1
    tb, jb = tblocks[k], jblocks[k]
    assert (tb.downsample is None) == (which == "identity")
    assert tb._fused_site() is not None
    seen, hooks = _quantized_inputs(q.tnet)
    try:
        with tmx.cpu():
            q.tnet(tmx.np.array(q.x))
            xin = next(t for m, t, _ in seen if m is tb)
            calls = []
            real = tops.conv_int8

            def spy(*a, **kw):
                calls.append(kw.get("residual") is not None)
                return real(*a, **kw)

            tops.conv_int8 = spy
            try:
                got = tb(xin)
            finally:
                tops.conv_int8 = real
            site = tb._fused_site
            tb._fused_site = lambda: None
            try:
                glue = tb(xin)
            finally:
                tb._fused_site = site
    finally:
        for h in hooks:
            h.remove()
    assert calls.count(True) == 1
    assert got.dtype == glue.dtype and torch.equal(got, glue)
    want = _reference(jb, xin.numpy())
    got = got.numpy()
    assert got.dtype == want.dtype
    if got.dtype != onp.int8:
        # the last block emits the net's floats: relu((a + r) * s_add),
        # whole steps of s_add; compare them as codes
        s_add = tb.qadd_threshold.data().asnumpy() / onp.float32(127.0)
        got, want = onp.rint(got / s_add), onp.rint(want / s_add)
    diff = onp.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (
        diff.max(), (diff > 0).mean())


# ---------------------------------------------------------------------------
# whole nets: the rewrite, the chains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["basic", "bottleneck"])
def test_quantized_net_matches_the_references(quantized_pairs, name):
    q = quantized_pairs[name]
    jnet, tnet, x, f32 = q.jnet, q.tnet, q.x, q.f32
    assert _census(tnet) == _census(jnet)
    census = _census(tnet)
    assert census["BatchNorm"] == 0 and census["QuantizedDense"] == 1
    assert census["QuantizedResidualBlock"] == BLOCKS
    want = _reference(jnet, x)
    with tmx.cpu():
        got = tnet(tmx.np.array(x)).asnumpy()
    assert _rel(got, want) < NET_TOL, _rel(got, want)
    # and both still track the f32 net
    assert _rel(got, f32) < 0.15
    assert (got.argmax(1) == want.argmax(1)).all()


def test_stem_codes_differ_at_ties_only(quantized_pairs):
    """The stem's int8 emit (the boundary chain through the max pool):
    at most 1 code in 1000 differs from the reference's, by one step."""
    q = quantized_pairs["basic"]
    jnet, tnet, x = q.jnet, q.tnet, q.x
    jstem = jnet.features._children["0"]
    tstem = tnet.features._children["0"]
    assert jstem._out_threshold is not None and tstem._out_threshold is not None
    want = _reference(jstem, x)
    with tmx.cpu():
        got = tstem(tmx.np.array(x)).asnumpy()
    assert got.dtype == want.dtype == onp.int8
    diff = onp.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (
        diff.max(), (diff > 0).mean())


def test_fold_and_chain_counts_match_the_references(quantized_pairs):
    """fold_conv_bn's count and folded weights, then quantize_net's
    logged rewrite (layers quantized, requantize, residual and boundary
    links), on both nets."""
    for name, q in quantized_pairs.items():
        assert q.folds[0] == q.folds[1] > 0, name
        jp, tp = q.folded
        assert sorted(jp) == sorted(tp)
        for k in jp:
            onp.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=1e-7,
                                        err_msg=f"{name}: {k}")
        jcounts, tcounts = q.logs
        assert tcounts == jcounts, name
        assert tcounts["requantize-chained"] > 0
        assert tcounts["residual-chained"] == BLOCKS
        assert tcounts["boundary-chained"] > 0
        assert _census(q.tnet) == _census(q.jnet)


def test_resnet50_census_is_the_one_chip_smoke_checks():
    """quantize_net's rewrite of resnet50_v1 (32 x 32 here), counted from
    its log: the counts chip_smoke.py's [int8] holds the card's rewrite
    to. The reference's quantize_net on the same net logs the same counts
    (its eager calibration of resnet50 takes some 45 s on the CPU, so the
    reference's equality is held here on the two nets above, which have
    every block class and kind of boundary of resnet50_v1)."""
    import chip_smoke

    x = _x((1, 3, 32, 32), 12)
    with tmx.cpu():
        tmx.random.seed(0)
        net = tvision.resnet50_v1()
        net.initialize()
        net(torch.from_numpy(x))
        logger, counts = _rewrite_log("resnet50")
        tq.quantize_net(net, calib_data=[tmx.np.array(x)],
                        calib_mode="naive", logger=logger)
    assert {k: counts.get(k, 0) for k in chip_smoke.INT8_CENSUS} == \
        chip_smoke.INT8_CENSUS


def test_quantize_net_exclusions_and_errors():
    x = _x((4, 12), 9)
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(8, activation="relu"),
                tmx.gluon.nn.Dense(4))
        net.initialize()
        net(torch.from_numpy(x))
        with pytest.raises(ValueError, match="only int8 is supported"):
            tq.quantize_net(net, quantized_dtype="uint8")
        with pytest.raises(ValueError, match="requires calib_data"):
            tq.quantize_net(net, calib_mode="naive")
        tq.quantize_net(net, calib_mode="none", exclude_layers_match=["^1$"])
        assert [type(c).__name__ for c in net._children.values()] == [
            "QuantizedDense", "Dense"]
        assert net._children["0"].qthreshold.data().asnumpy() == 1.0
    for mod in (jq,):
        with pytest.raises(ValueError, match="only int8 is supported"):
            mod.quantize_net(None, quantized_dtype="uint8")


def test_bf16_chain_keeps_the_nets_dtype():
    x = _x((4, 16), 3)
    with tmx.cpu():
        tmx.random.seed(5)
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(16, activation="relu"),
                tmx.gluon.nn.Dense(8))
        net.initialize()
        net.cast("bfloat16")
        xb = tmx.np.array(x).astype("bfloat16")
        net(xb)
        tq.quantize_net(net, calib_data=[xb], calib_mode="naive")
        assert net._children["0"]._out_threshold is not None
        out = net(xb)
    assert out._data.dtype == torch.bfloat16


def test_reference_saved_net_loads_into_the_port(quantized_pairs, tmp_path):
    q = quantized_pairs["bottleneck"]
    jnet, tnet, x = q.jnet, q.tnet, q.x
    path = str(tmp_path / "q.params")
    jnet.save_parameters(path)
    with tmx.cpu():
        # the port's quantized net, its thresholds disturbed first
        for name, p in tnet.collect_params().items():
            if name.endswith("threshold"):
                p.set_data(p.data().asnumpy() * 1.5)
        tnet.load_parameters(path)
        got = tnet(tmx.np.array(x)).asnumpy()
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert sorted(jp) == sorted(tp)
    for name in jp:
        if name.split(".")[-1].startswith("q"):
            onp.testing.assert_array_equal(tp[name].data().asnumpy(),
                                           jp[name].data().asnumpy())
    want = _reference(jnet, x)
    assert _rel(got, want) < NET_TOL


# ---------------------------------------------------------------------------
# integer max pooling (Q2's plain version) through npx.pooling
# ---------------------------------------------------------------------------

POOLS = {
    "valid": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    "full": dict(kernel=(3, 3), stride=(2, 2), pad=(0, 1),
                 pooling_convention="full"),
    "window_in_padding": dict(kernel=(2, 2), stride=(3, 3), pad=(1, 1),
                              pooling_convention="full"),
    "1d": dict(kernel=(3,), stride=(2,), pad=(1,)),
    "3d": dict(kernel=(2, 2, 2), stride=(2, 1, 2), pad=(0, 1, 1)),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_int8_pooling_matches_the_references(case):
    kw = POOLS[case]
    nd = len(kw["kernel"])
    shape = (2, 3) + (7, 8, 6)[:nd] if nd != 2 else (2, 3, 9, 10)
    x = onp.random.RandomState(11).randint(-128, 128, shape).astype("int8")
    want = jmx.npx.pooling(jmx.np.array(x), pool_type="max", **kw).asnumpy()
    with tmx.cpu():
        got = tmx.npx.pooling(tmx.np.array(x), pool_type="max",
                              **kw).asnumpy()
    assert got.dtype == onp.int8
    onp.testing.assert_array_equal(got, want)
