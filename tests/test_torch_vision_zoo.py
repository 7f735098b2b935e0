"""The port's vision model zoo against the JAX package's: narrow
configurations built from the reference's own constructors, the same
weights in both (the port's initialised net, random running statistics
included, saved with ``save_parameters`` and loaded by the reference's
``load_parameters``: the parameter names are the same), the same
numpy-seeded batch, logits compared in predict mode; the ResNets also in
training mode (batch statistics; the running statistics after the call
compared too). Every name of ``vision._models`` builds in both packages
with the same parameter names.

Tolerance (float32): logits within 1e-4 of the largest plus 1e-4
relative (a dozen convolutions and norms deep, sums in another order);
running statistics 1e-5.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from test_torch_vision_ops import _close, _x

LOGIT_TOL = 1e-4
STAT_TOL = 1e-5


def randomize_stats(net, seed):
    """Random running statistics (and betas) on the port's net, so that
    predict mode reads more than zeros and ones."""
    r = onp.random.RandomState(seed)
    for name, p in sorted(net.collect_params().items()):
        if name.endswith("running_mean") or name.endswith("beta"):
            p.set_data(r.normal(0, 0.2, p.shape).astype("float32"))
        elif name.endswith("running_var"):
            p.set_data(r.uniform(0.5, 1.5, p.shape).astype("float32"))


def carried_pair(make, shape, tmp_path, seed=0):
    """(reference net, port net, x): the port's net initialised (seeded)
    and called once (deferred shapes), its weights loaded into the
    reference's."""
    x = _x(shape, seed + 1)
    with tmx.cpu():
        tmx.random.seed(seed)
        tnet = make(tvision)
        tnet.initialize()
        tnet(torch.from_numpy(x))
        randomize_stats(tnet, seed + 2)
        path = str(tmp_path / "net.params")
        tnet.save_parameters(path)
    jnet = make(jvision)
    jnet.load_parameters(path)
    assert list(jnet.collect_params()) == list(tnet.collect_params())
    return jnet, tnet, x


def predict_logits(jnet, tnet, x):
    want = jnet(jmx.np.array(x)).asnumpy()
    with tmx.cpu():
        got = tnet(tmx.np.array(x)).asnumpy()
    return got, want


RESNETS = {
    "v1_bottleneck_thumbnail": (
        lambda v: v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                             classes=10, thumbnail=True), (2, 3, 32, 32)),
    "v1_basic": (
        lambda v: v.ResNetV1(v.BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                             classes=10), (2, 3, 32, 32)),
    "v2_bottleneck": (
        lambda v: v.ResNetV2(v.BottleneckV2, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                             classes=10), (2, 3, 32, 32)),
    "v2_basic_thumbnail": (
        lambda v: v.ResNetV2(v.BasicBlockV2, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                             classes=10, thumbnail=True), (2, 3, 32, 32)),
}


@pytest.mark.parametrize("case", sorted(RESNETS))
def test_resnet_matches_reference(case, tmp_path):
    make, shape = RESNETS[case]
    jnet, tnet, x = carried_pair(make, shape, tmp_path)
    got, want = predict_logits(jnet, tnet, x)
    _close(got, want, LOGIT_TOL, case + " predict")
    # training mode: batch statistics, the running ones updated
    with jmx.autograd.train_mode():
        want = jnet(jmx.np.array(x)).asnumpy()
    with tmx.cpu(), tmx.autograd.train_mode():
        got = tnet(tmx.np.array(x)).asnumpy()
    _close(got, want, LOGIT_TOL, case + " train")
    jp, tp = jnet.collect_params(), tnet.collect_params()
    for k in jp:
        if "running" in k:
            _close(tp[k].data().asnumpy(), jp[k].data().asnumpy(), STAT_TOL,
                   k)


def test_every_model_name_builds_with_the_references_parameter_names():
    assert sorted(tvision._models) == sorted(jvision._models)
    with tmx.cpu():
        for name in sorted(jvision._models):
            kw = {"classes": 10}
            jnames = list(jvision.get_model(name, **kw).collect_params())
            tnames = list(tvision.get_model(name, **kw).collect_params())
            assert tnames == jnames, name
    with pytest.raises(ValueError):
        tvision.get_model("resnet7_v1")


def test_resnet50_v1_shapes_are_the_references():
    """bench.py's net: every parameter's shape after the first call."""
    with tmx.cpu():
        tnet = tvision.resnet50_v1()
        tnet.initialize()
        with tmx.autograd.predict_mode():
            y = tnet(torch.zeros(1, 3, 64, 64))
    assert tuple(y.shape) == (1, 1000)
    shapes = {k: p.shape for k, p in tnet.collect_params().items()}
    assert len(shapes) == 315
    assert all(s and min(s) > 0 for s in shapes.values())
    assert shapes["features.0.weight"] == (64, 3, 7, 7)
    assert shapes["features.5.0.body.0.weight"] == (128, 256, 1, 1)
    assert shapes["features.7.2.body.7.running_var"] == (2048,)
    assert shapes["output.weight"] == (1000, 2048)
    n = sum(int(onp.prod(s)) for k, s in shapes.items() if "running" not in k)
    conv_bias = sum(s[0] for k, s in shapes.items()
                    if k.endswith("bias") and not k.startswith("output"))
    # ResNet-50's 25,557,032 weights, and the biases of the blocks' convs
    # (gluon's Conv2D default use_bias=True)
    assert conv_bias == 22656 and n == 25557032 + conv_bias
