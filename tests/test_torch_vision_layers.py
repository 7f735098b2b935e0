"""The port's vision layers (`gluon.nn` conv, pooling, norm and extra
layers) against the JAX package's: the reference layer is built and
initialised, its ``collect_params()`` arrays (running statistics
included) are carried into the port's layer by name through
`models.params.load_params` before its first call (its deferred shapes
take the arrays'), and both run the same numpy-seeded input as NDArrays
under ``autograd.record()``; outputs, the gradients of the input and of
every parameter, and the running statistics after the call are compared.

Tolerances (float32), as `test_torch_vision_ops`: outputs 2e-5, gradients
1e-4 normwise, running statistics 1e-6.
"""
import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.models.params import load_params
from test_torch_vision_ops import (FWD_TOL, GRAD_TOL, STAT_TOL, _close,
                                   _normwise, _x)

# name: (constructor args, kwargs, input shape, train mode)
LAYERS = {
    "Conv1D": ((6, 3), dict(strides=2, padding=1, activation="relu"),
               (2, 4, 9), False),
    "Conv2D": ((6, (3, 3)), dict(padding=(1, 1), groups=2, dilation=2),
               (2, 4, 8, 8), False),
    "Conv2D_depthwise": ((4, 3), dict(strides=2, padding=1, groups=4,
                                      use_bias=False), (2, 4, 7, 7), False),
    "Conv3D": ((3, (3, 3, 3)), dict(padding=(1, 1, 1), in_channels=2),
               (1, 2, 4, 5, 5), False),
    "MaxPool1D": ((3,), dict(strides=2, padding=1), (2, 3, 9), False),
    "MaxPool2D": ((3, 2, 1), {}, (2, 3, 9, 9), False),
    "MaxPool2D_ceil": ((3, 2), dict(ceil_mode=True), (2, 3, 10, 10), False),
    "MaxPool3D": (((2, 2, 2),), {}, (1, 2, 4, 6, 6), False),
    "AvgPool1D": ((3,), dict(strides=2, padding=1, count_include_pad=False),
                  (2, 3, 9), False),
    "AvgPool2D": ((3, 2, 1), {}, (2, 3, 9, 9), False),
    "AvgPool2D_ceil": ((3, 2, 1), dict(ceil_mode=True,
                                       count_include_pad=False),
                       (2, 3, 10, 9), False),
    "AvgPool3D": (((2, 2, 2),), {}, (1, 2, 4, 6, 6), False),
    "GlobalMaxPool1D": ((), {}, (2, 3, 7), False),
    "GlobalMaxPool2D": ((), {}, (2, 3, 5, 6), False),
    "GlobalMaxPool3D": ((), {}, (2, 3, 3, 4, 5), False),
    "GlobalAvgPool1D": ((), {}, (2, 3, 7), False),
    "GlobalAvgPool2D": ((), {}, (2, 3, 5, 6), False),
    "GlobalAvgPool3D": ((), {}, (2, 3, 3, 4, 5), False),
    "ReflectionPad2D": ((2,), {}, (2, 3, 5, 6), False),
    "BatchNorm_train": ((), {}, (4, 3, 5, 5), True),
    "BatchNorm_infer": ((), {}, (4, 3, 5, 5), False),
    "BatchNorm_noscale": ((), dict(scale=False, center=False, momentum=0.8),
                          (4, 3, 5, 5), True),
    "BatchNorm_global_stats": ((), dict(use_global_stats=True),
                               (4, 3, 5, 5), True),
    "BatchNorm_axis3": ((), dict(axis=3), (2, 4, 4, 3), True),
    "GroupNorm": ((2,), {}, (2, 4, 5, 5), True),
    "InstanceNorm": ((), dict(scale=True), (2, 3, 5, 6), True),
    "SyncBatchNorm": ((), dict(num_devices=1), (4, 3, 4, 4), True),
    "BatchNormReLU": ((), {}, (4, 3, 4, 4), True),
    "PixelShuffle1D": ((2,), {}, (2, 6, 5), False),
    "PixelShuffle2D": (((2, 3),), {}, (2, 12, 3, 4), False),
    "PixelShuffle3D": ((2,), {}, (1, 16, 2, 3, 2), False),
    "DeformableConvolution": ((5, 3), dict(padding=1), (2, 4, 6, 6), False),
    "ModulatedDeformableConvolution": ((5, 3), dict(padding=1,
                                                    num_deformable_group=2),
                                       (2, 4, 6, 6), False),
}


def _cls(name):
    return name.split("_")[0]


def _rand_params(block, seed):
    """Random values for every parameter of the reference layer (positive
    running variances), so no case rests on an initializer's constants."""
    r = onp.random.RandomState(seed)
    for name, p in sorted(block.collect_params().items()):
        v = r.normal(0, 0.5, p.shape).astype("float32")
        if name.endswith("running_var"):
            v = onp.abs(v) + 0.5
        if name.endswith("gamma"):
            v = v + 1.0
        p.set_data(jmx.np.array(v))


def _run(mx, block, x, dy, train):
    xs = mx.np.array(x)
    xs.attach_grad()
    with mx.autograd.record(train_mode=train):
        y = block(xs)
    y.backward(mx.np.array(dy))
    return y.asnumpy(), xs.grad.asnumpy()


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_reference(name):
    args, kw, shape, train = LAYERS[name]
    x = _x(shape, 40, 1.5)
    jb = getattr(jmx.gluon.nn, _cls(name))(*args, **kw)
    jb.initialize()
    jb(jmx.np.array(x))                      # the reference's deferred shapes
    _rand_params(jb, 41)
    before = {k: p.data().asnumpy().copy()
              for k, p in jb.collect_params().items()}
    with tmx.cpu():
        tb = getattr(tmx.gluon.nn, _cls(name))(*args, **kw)
        tb.initialize()
        load_params(tb, before)
    y_ref = jb(jmx.np.array(x)).asnumpy()
    dy = _x(y_ref.shape, 42)
    want, want_dx = _run(jmx, jb, x, dy, train)
    with tmx.cpu():
        got, got_dx = _run(tmx, tb, x, dy, train)
    _close(got, want, FWD_TOL, name)
    _normwise(got_dx, want_dx, GRAD_TOL, name + " dx")
    jp, tp = jb.collect_params(), tb.collect_params()
    assert list(jp) == list(tp)
    for k in jp:
        if k.endswith(("running_mean", "running_var")):
            _close(tp[k].data().asnumpy(), jp[k].data().asnumpy(), STAT_TOL,
                   f"{name} {k}")
            moved = not (tp[k].data().asnumpy() == before[k]).all()
            assert moved == (train and "global" not in name), (name, k)
        elif jp[k].grad_req != "null":
            _normwise(tp[k].grad().asnumpy(), jp[k].grad().asnumpy(),
                      GRAD_TOL, f"{name} d{k}")
        else:
            assert tp[k].grad_req == "null"


# The reference reads a transposed convolution's weight as (out, in, *k)
# (its layer runs only where in = out); the port reads MXNet's
# (in, out / g, *k): the same layer, with the weight's first two axes
# swapped.
DECONV = {
    "Conv1DTranspose": ((4, 3), dict(strides=2, padding=1), (2, 4, 6)),
    "Conv2DTranspose": ((4, (3, 3)), dict(strides=(2, 2), padding=(1, 1)),
                        (2, 4, 5, 5)),
    "Conv3DTranspose": ((2, (3, 3, 3)), dict(strides=(1, 2, 2),
                                             padding=(1, 1, 1)),
                        (1, 2, 3, 4, 4)),
}


@pytest.mark.parametrize("name", sorted(DECONV))
def test_transposed_conv_layer_matches_reference(name):
    args, kw, shape = DECONV[name]
    x = _x(shape, 43)
    jb = getattr(jmx.gluon.nn, name)(*args, **kw)
    jb.initialize()
    jb(jmx.np.array(x))
    _rand_params(jb, 44)
    params = {k: p.data().asnumpy() for k, p in jb.collect_params().items()}
    params["weight"] = onp.ascontiguousarray(params["weight"].swapaxes(0, 1))
    with tmx.cpu():
        tb = getattr(tmx.gluon.nn, name)(*args, **kw)
        tb.initialize()
        load_params(tb, params)
    dy = _x(jb(jmx.np.array(x)).shape, 45)
    want, want_dx = _run(jmx, jb, x, dy, False)
    with tmx.cpu():
        got, got_dx = _run(tmx, tb, x, dy, False)
    _close(got, want, FWD_TOL, name)
    _normwise(got_dx, want_dx, GRAD_TOL, name + " dx")
    _normwise(tb.weight.grad().asnumpy(),
              jb.weight.grad().asnumpy().swapaxes(0, 1), GRAD_TOL, "dw")
    _normwise(tb.bias.grad().asnumpy(), jb.bias.grad().asnumpy(), GRAD_TOL,
              "db")


def test_transposed_conv_layer_takes_mxnet_weight_layout():
    """in != out and groups: the port's layer weight is (in, out / g, *k)
    and ``output_padding`` extends the output, which the reference's
    layer cannot run (its op reads (out, in))."""
    with tmx.cpu():
        layer = tmx.gluon.nn.Conv2DTranspose(6, 3, strides=2, padding=1,
                                             output_padding=1, groups=2)
        layer.initialize()
        y = layer(tmx.np.array(_x((2, 4, 5, 5), 46)))
    assert layer.weight.shape == (4, 3, 3, 3)
    assert y.shape == (2, 6, 10, 10)


def test_running_stats_are_not_trainable():
    with tmx.cpu():
        bn = tmx.gluon.nn.BatchNorm(in_channels=3)
        bn.initialize()
    trainable = [n for n, t in bn.named_parameters() if t.requires_grad]
    assert trainable == ["gamma", "beta"]
    assert bn.running_mean.grad_req == "null"
    assert bn.running_var.grad_req == "null"


def test_layers_take_torch_tensors_and_infer_in_channels():
    import torch

    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Conv2D(8, 3, padding=1),
                tmx.gluon.nn.BatchNorm(),
                tmx.gluon.nn.Activation("relu"),
                tmx.gluon.nn.MaxPool2D(2, 2),
                tmx.gluon.nn.GlobalAvgPool2D())
        net.initialize()
        with tmx.autograd.train_mode():
            y = net(torch.ones(2, 5, 8, 8))
    assert tuple(y.shape) == (2, 8, 1, 1)
    assert net[0].weight.shape == (8, 5, 3, 3)
    assert net[1].running_mean.shape == (8,)
