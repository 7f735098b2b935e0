"""AMP's rules for the vision ops, in both packages under
``amp.init("bfloat16")``: ``convolution`` and ``deconvolution`` are
target-dtype ops (float32 data, weight and bias cast to bfloat16; the
output bfloat16), ``batch_norm``, ``group_norm`` and ``instance_norm``
float32 ops (a bfloat16 input cast up; the output float32), on the
port's NDArray funnel and on its tensor path (the gluon layers called
with torch tensors), against the reference's funnel.

Tolerances: bfloat16 outputs within 2^-7 normwise of the reference's
(the port adds the bias inside the product's rounding, the reference
rounds the product and then the sum: a spacing apart at most); float32
outputs of a bfloat16 input 1e-5 (the same input values on both sides);
a small conv net's logits 2^-6 normwise.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from test_torch_vision_ops import _normwise, _x

BF16_TOL = 2.0 ** -7


@pytest.fixture
def amp_on():
    jmx.amp.init("bfloat16")
    tmx.amp.init("bfloat16")
    yield
    jmx.amp.deinit()
    tmx.amp.deinit()


def _name(dt):
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else onp.dtype(dt).name


def _f32(a):
    return onp.asarray(a.astype("float32") if hasattr(a, "astype") else a,
                       onp.float32)


OPS = {
    "convolution": (lambda mx, x, w, b: mx.npx.convolution(
        x, w, b, kernel=(3, 3), pad=1, num_filter=4), "bfloat16"),
    "deconvolution": (lambda mx, x, w, b: mx.npx.deconvolution(
        x, w, b, kernel=(3, 3), stride=2, pad=1, num_filter=4), "bfloat16"),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_target_dtype_ops(amp_on, op):  # noqa: ARG001
    fn, want_dt = OPS[op]
    x, w, b = _x((2, 4, 6, 6), 50), _x((4, 4, 3, 3), 51, 0.3), _x((4,), 52)
    ref = fn(jmx, *(jmx.np.array(a) for a in (x, w, b)))
    assert _name(ref.dtype) == want_dt
    with tmx.cpu():
        nd = fn(tmx, *(tmx.np.array(a) for a in (x, w, b)))
        tt = fn(tmx, *(torch.from_numpy(a) for a in (x, w, b)))
    assert _name(nd.dtype) == want_dt and _name(tt.dtype) == want_dt
    want = _f32(ref.asnumpy())
    if op == "deconvolution":   # the reference reads the weight as (out, in)
        with tmx.cpu():
            tt = fn(tmx, torch.from_numpy(x),
                    torch.from_numpy(onp.ascontiguousarray(
                        w.swapaxes(0, 1))), torch.from_numpy(b))
            nd = tmx.nd.NDArray(tt)
    _normwise(nd.asnumpy().astype("float32"), want, BF16_TOL, op)
    _normwise(tt.float().numpy(), want, BF16_TOL, op)


NORMS = {
    "batch_norm": lambda mx, x, g, b: mx.npx.batch_norm(
        x, g, b, mx.np.zeros(4), mx.np.ones(4), fix_gamma=False),
    "group_norm": lambda mx, x, g, b: mx.npx.group_norm(x, g, b,
                                                        num_groups=2),
    "instance_norm": lambda mx, x, g, b: mx.npx.instance_norm(x, g, b),
}


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
@pytest.mark.parametrize("op", sorted(NORMS))
def test_fp32_ops(amp_on, op, train):  # noqa: ARG001
    x = _x((2, 4, 5, 5), 53)
    g, b = _x((4,), 54) + 1, _x((4,), 55)
    xb = jmx.np.array(x).astype("bfloat16")
    with jmx.autograd.record(train_mode=train):
        ref = NORMS[op](jmx, xb, jmx.np.array(g), jmx.np.array(b))
    assert _name(ref.dtype) == "float32"
    with tmx.cpu():
        xt = tmx.np.array(x).astype("bfloat16")
        scope = tmx.autograd.train_mode() if train \
            else tmx.autograd.predict_mode()
        with scope:
            nd = NORMS[op](tmx, xt, tmx.np.array(g), tmx.np.array(b))
            tt = NORMS[op](tmx, xt._data, torch.from_numpy(g),
                           torch.from_numpy(b)) if op != "batch_norm" else \
                tmx.npx.batch_norm(xt._data, torch.from_numpy(g),
                                   torch.from_numpy(b), torch.zeros(4),
                                   torch.ones(4), fix_gamma=False)
    assert nd.dtype == onp.float32 and tt.dtype == torch.float32
    _normwise(nd.asnumpy(), ref.asnumpy(), 1e-5, op)
    _normwise(tt.numpy(), ref.asnumpy(), 1e-5, op)


def test_conv_net_logits_under_amp(amp_on):  # noqa: ARG001
    """Conv2D -> BatchNorm -> relu -> GlobalAvgPool2D -> Dense under AMP,
    the reference's weights carried in, in predict mode: each site's
    dtype as AMP has it, the logits within 2^-6 normwise."""
    from incubator_mxnet_tpu_torch.models.params import load_params

    def make(mx):
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Conv2D(8, 3, padding=1),
                mx.gluon.nn.BatchNorm(), mx.gluon.nn.Activation("relu"),
                mx.gluon.nn.GlobalAvgPool2D(), mx.gluon.nn.Dense(5))
        return net

    x = _x((2, 3, 8, 8), 56)
    jnet = make(jmx)
    jnet.initialize()
    jmx.amp.deinit()
    jnet(jmx.np.array(x))
    jmx.amp.init("bfloat16")
    want = jnet(jmx.np.array(x))
    with tmx.cpu():
        tnet = make(tmx)
        tnet.initialize()
        load_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
        seen = {}
        for i, blk in enumerate(tnet):
            blk.register_forward_hook(
                lambda m, a, o, i=i: seen.__setitem__(i, o.dtype))
        got = tnet(torch.from_numpy(x))
    assert seen[0] == torch.bfloat16 and seen[1] == torch.float32
    assert got.dtype == torch.bfloat16 and _name(want.dtype) == "bfloat16"
    _normwise(got.detach().float().numpy(), _f32(want.asnumpy()), 2.0 ** -6)
