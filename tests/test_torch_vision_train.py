"""Training the narrow ResNet-50-v1 shape (`ResNetV1(BottleneckV1,
[1, 1, 1, 1], [8, 8, 16, 32, 64], classes=10, thumbnail=True)`, 2 x 3 x
32 x 32, softmax cross-entropy, SGD with momentum 0.9) in the port
against the JAX package's `parallel.DataParallel`, `bench.py:310`'s
trainer: the reference net's arrays (running statistics included) are
carried into the port's by name (`models.params.load_params`), and three
steps run through the port's `DataParallel`, its gluon loop
(``autograd.record()`` + `Trainer`) eagerly and hybridized. After every
step the loss, and after the last every parameter, are compared; the
running statistics after every step (one update a step, with the biased
batch variance). Predict mode leaves them alone.

Tolerances (float32): the loss within 1e-5 relative; parameters and
running statistics within 1e-4 relative plus 1e-6 absolute (three
updates of a 13-layer net's gradients, summed in another order; a
convolution's bias ahead of a BatchNorm gets only rounding noise as its
gradient, about 1e-7, in both).
"""
import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.parallel import DataParallel as JaxDataParallel
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_tpu_torch.models.params import load_params
from incubator_mxnet_tpu_torch.parallel import DataParallel

STEPS = 3
LR = 0.05
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
PARAM_ATOL = 1e-6


def _make(v):
    return v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                      classes=10, thumbnail=True)


def _batches():
    r = onp.random.RandomState(7)
    return [(r.normal(0, 1, (2, 3, 32, 32)).astype("float32"),
             r.randint(0, 10, (2,)).astype("int32")) for _ in range(STEPS)]


def _arrays(net):
    return {k: p.data().asnumpy().copy()
            for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def reference():
    """The reference net's initial arrays, and after each of the JAX
    DataParallel's steps its loss and arrays."""
    jmx.random.seed(11)
    net = _make(jvision)
    net.initialize(jmx.init.Xavier())
    net(jmx.np.array(onp.zeros((1, 3, 32, 32), "float32")))
    start = _arrays(net)
    dp = JaxDataParallel(net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         jmx.optimizer.SGD(learning_rate=LR, momentum=0.9))
    trace = []
    for x, y in _batches():
        loss = float(dp.step(jmx.np.array(x), jmx.np.array(y)).asnumpy())
        trace.append((loss, _arrays(net)))
    return start, trace


def _port_net(start):
    with tmx.cpu():
        net = _make(tvision)
        net.initialize()
        load_params(net, start)
    return net


def _check_step(i, loss, net, trace, last):
    want_loss, want = trace[i]
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss), (i, loss,
                                                                want_loss)
    got = _arrays(net)
    for k in want:
        if "running" in k or last:
            onp.testing.assert_allclose(got[k], want[k], rtol=PARAM_TOL,
                                        atol=PARAM_ATOL,
                                        err_msg=f"step {i} {k}")


def test_data_parallel_matches_reference(reference):
    start, trace = reference
    net = _port_net(start)
    dp = DataParallel(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                      tmx.optimizer.SGD(learning_rate=LR, momentum=0.9))
    assert len(dp.params) == len([k for k in start if "running" not in k])
    with tmx.cpu():
        for i, (x, y) in enumerate(_batches()):
            loss = dp.step(tmx.np.array(x), tmx.np.array(y))
            assert isinstance(loss, tmx.NDArray)    # NDArrays in and out
            _check_step(i, float(loss.asnumpy()), net, trace,
                        i == STEPS - 1)


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
def test_gluon_loop_matches_reference(reference, hybridize):
    start, trace = reference
    net = _port_net(start)
    if hybridize:
        net.hybridize()
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": LR, "momentum": 0.9})
    with tmx.cpu():
        for i, (x, y) in enumerate(_batches()):
            xs, ys = tmx.np.array(x), tmx.np.array(y)
            with tmx.autograd.record():
                loss = loss_fn(net(xs), ys)
            loss.backward()
            trainer.step(x.shape[0])
            _check_step(i, float(loss.mean().asnumpy()), net, trace,
                        i == STEPS - 1)
        stats = {k: v for k, v in _arrays(net).items() if "running" in k}
        net(tmx.np.array(_batches()[0][0]))          # predict mode
        for k, v in stats.items():
            assert (net.collect_params()[k].data().asnumpy() == v).all(), k
