"""The Estimator (`gluon.contrib.estimator`) of the port against the JAX
package's, on the CPU, and the public signatures of every module the
training loop's ecosystem ports.

`Estimator.fit` of a `bert_small` classifier (2 layers, 64 units, 4
heads; vocab 97, 16 tokens, 2 classes; the reference's scaled random
weights carried across through numpy; dropout 0), fed by each package's
`DataLoader` over the same seeded rows under the same numpy seed, with
`ValidationHandler`, `CheckpointHandler`, `LoggingHandler` and the
telemetry handler, trained with SGD (momentum 0.9) for 7 batches across
an epoch boundary: each batch's loss within 1e-4 relative of the
reference's, every final parameter within 1e-4 of its largest magnitude
(float32, two frameworks, the same arithmetic in another order over two
layers, as `tests/test_torch_dense.py`), the train and validation
metrics within 1e-4, the checkpoint files by name. The handlers fire in
the reference's order (priorities, categories, defaults), hook by hook.
"""
import logging
import os

import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import np as jnp_
from incubator_mxnet_tpu.models.bert import BERTClassifier as JaxClassifier
from incubator_mxnet_tpu.models.bert import bert_small as jax_bert_small
from incubator_mxnet_tpu_torch.models.bert import BERTClassifier, bert_small

VOCAB, T, CLASSES, ROWS, BATCH, BATCHES = 97, 16, 2, 40, 8, 7
REL = 1e-4


def _rows():
    r = onp.random.RandomState(1)
    tok = r.randint(0, VOCAB, (ROWS, T)).astype("int32")
    return tok, (tok[:, 0] % CLASSES).astype("int32")


@pytest.fixture(scope="module")
def weights():
    jmx.random.seed(3)
    jm = jax_bert_small(vocab_size=VOCAB, max_length=T, dropout=0.0)
    jm.initialize()
    r = onp.random.RandomState(0)
    for p in jm.collect_params().values():
        if len(p.shape) >= 2:
            p.set_data(jnp_.array(r.normal(0, 0.2, p.shape)
                                  .astype("float32")))
    clf = JaxClassifier(jm.encoder, CLASSES, dropout=0.0)
    clf.initialize()
    clf(jnp_.array(_rows()[0][:2]))
    clf.classifier.weight.set_data(jnp_.array(
        r.normal(0, 0.2, (CLASSES, 64)).astype("float32")))
    return {n: p.data().asnumpy() for n, p in clf.collect_params().items()}


def _ref_net(weights):
    jm = jax_bert_small(vocab_size=VOCAB, max_length=T, dropout=0.0)
    clf = JaxClassifier(jm.encoder, CLASSES, dropout=0.0)
    clf.initialize()
    clf(jnp_.array(_rows()[0][:2]))
    for n, p in clf.collect_params().items():
        p.set_data(jnp_.array(weights[n]))
    return clf


def _port_net(weights):
    enc = bert_small(vocab_size=VOCAB, max_length=T, dropout=0.0,
                     device="cpu", seed=0).encoder
    clf = BERTClassifier(enc, CLASSES, dropout=0.0, device="cpu", seed=1)
    clf.load_jax_params(weights)
    return clf


def _recorder(eh):
    """A handler class of package ``eh`` recording each batch's loss."""

    class Rec(eh.BatchEnd):
        def __init__(self):
            self.losses = []

        def batch_end(self, estimator, *args, **kwargs):
            self.losses.append(kwargs["loss"].asnumpy().copy())

    return Rec()


def _fit(mx, net, ckdir):
    from importlib import import_module

    gluon = mx.gluon
    est_mod = import_module(mx.__name__ + ".gluon.contrib.estimator")
    monitor = import_module(mx.__name__ + ".telemetry.monitor")
    tok, lab = _rows()
    train = gluon.data.DataLoader(gluon.data.ArrayDataset(tok, lab),
                                  batch_size=BATCH, shuffle=True)
    val = gluon.data.DataLoader(gluon.data.ArrayDataset(tok[:16], lab[:16]),
                                batch_size=BATCH)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    est = est_mod.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                            train_metrics=[gluon.metric.Accuracy()],
                            trainer=trainer)
    rec = _recorder(est_mod.event_handler)
    handlers = [rec, est_mod.LoggingHandler(log_interval=3),
                est_mod.ValidationHandler(val, est.evaluate, batch_period=4),
                est_mod.CheckpointHandler(ckdir, batch_period=3,
                                          max_checkpoints=2),
                monitor.TelemetryHandler()]
    onp.random.seed(11)
    est.fit(train, batches=BATCHES, event_handlers=handlers)
    metrics = {m.name: m.get()[1] for m in est.train_metrics
               + est.val_metrics}
    params = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    return rec.losses, params, metrics, sorted(os.listdir(ckdir))


def test_fit_equals_reference(weights, tmp_path):
    want = _fit(jmx, _ref_net(weights), str(tmp_path / "ref"))
    from incubator_mxnet_tpu_torch.telemetry import registry

    before = registry.counter("mx_examples_total").value
    with tmx.cpu():
        net = _port_net(weights)
        net.hybridize()
        got = _fit(tmx, net, str(tmp_path / "port"))
    assert registry.counter("mx_examples_total").value == \
        before + BATCHES * BATCH
    assert len(got[0]) == len(want[0]) == BATCHES
    for g, w in zip(got[0], want[0]):
        onp.testing.assert_allclose(g, w, rtol=REL, atol=REL)
    assert got[1].keys() == want[1].keys()
    for n, w in want[1].items():
        onp.testing.assert_allclose(got[1][n], w, rtol=0,
                                    atol=REL * float(onp.abs(w).max()),
                                    err_msg=n)
    assert got[2].keys() == want[2].keys()
    for n, w in want[2].items():
        assert abs(float(got[2][n]) - float(w)) <= REL * max(1, abs(w)), n
    assert got[3] == want[3]


def _order_run(mx, log):
    """The hooks each handler fires, in order, over a 3-batch fit of a
    one-layer net with a validation set (a handler per category, with
    and without priorities, beside the defaults)."""
    from importlib import import_module

    gluon = mx.gluon
    est_mod = import_module(mx.__name__ + ".gluon.contrib.estimator")
    eh = est_mod.event_handler

    def make(name, priority=None):
        class H(eh.TrainBegin, eh.TrainEnd, eh.EpochBegin, eh.EpochEnd,
                eh.BatchBegin, eh.BatchEnd):
            pass

        h = H()
        if priority is not None:
            h.priority = priority
        for hook in ("train_begin", "train_end", "epoch_begin", "epoch_end",
                     "batch_begin", "batch_end"):
            setattr(h, hook, lambda *a, _h=hook, **k: log.append((name, _h)))
        return h

    class Spy(eh.MetricHandler):
        def batch_end(self, estimator, *args, **kwargs):
            log.append(("metric", "batch_end"))
            super().batch_end(estimator, *args, **kwargs)

    x = onp.random.RandomState(0).normal(size=(6, 4)).astype("float32")
    y = onp.array([0, 1, 0, 1, 1, 0], "int32")
    net = gluon.nn.Dense(2, in_units=4)
    net.initialize()
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(x, y),
                                   batch_size=2)
    est = est_mod.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                            trainer=gluon.Trainer(net.collect_params(),
                                                  "sgd"))
    handlers = [make("late", 50), make("early", -500), make("plain"),
                Spy(est.train_metrics)]
    est.fit(loader, val_data=loader, batches=3, event_handlers=handlers)
    res = est.evaluate(loader, event_handlers=[make("eval")])
    return res


def test_handlers_fire_in_the_reference_order():
    jlog, tlog = [], []
    jres = _order_run(jmx, jlog)
    with tmx.cpu():
        tres = _order_run(tmx, tlog)
    assert tlog == jlog and len(tlog) > 30
    assert tres.keys() == jres.keys()


def test_estimator_rejects_what_the_reference_rejects():
    from incubator_mxnet_tpu_torch.gluon.contrib.estimator import Estimator

    with tmx.cpu():
        net = tmx.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        loss = tmx.gluon.loss.L2Loss()
        with pytest.raises(ValueError):
            Estimator(net, loss, batch_processor=object())
        with pytest.raises(ValueError):
            Estimator(net, object())
        est = Estimator(net, loss, trainer=tmx.gluon.Trainer(
            net.collect_params(), "sgd"))
        with pytest.raises(ValueError):
            est.fit([], batches=1)
        with pytest.raises(ValueError):
            est.fit([(None, None)])
    assert logging.getLogger("incubator_mxnet_tpu_torch.estimator").handlers


# ---------------------------------------------------------------------------
# every ported module's public signatures lead with the reference's
# ---------------------------------------------------------------------------

SURFACE = ("gluon/data/dataset.py", "gluon/data/sampler.py",
           "gluon/data/batchify.py", "gluon/data/dataloader.py",
           "gluon/data/vision/datasets.py", "gluon/data/vision/transforms.py",
           "gluon/contrib/data/vision/dataloader.py", "gluon/metric.py",
           "gluon/contrib/estimator/event_handler.py",
           "gluon/contrib/estimator/estimator.py", "telemetry/monitor.py",
           "callback.py", "model.py", "preemption.py",
           "fault/resilience.py", "recordio.py", "_native.py", "image.py",
           "io/io.py", "telemetry/goodput.py")


def _leads(ref, port):
    from test_torch_gluon import _leads as leads

    return leads(ref, port)


@pytest.mark.parametrize("rel", SURFACE)
def test_public_signatures_lead_with_the_references(rel):
    """Every public function and method the slice ports takes the
    reference's parameters, in its order and with its defaults (the
    port's extras, ``device=``, come after them)."""
    import incubator_mxnet_tpu
    import incubator_mxnet_tpu_torch
    from test_torch_gluon import _signatures

    ref = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu.__file__), rel))
    port = _signatures(os.path.join(
        os.path.dirname(incubator_mxnet_tpu_torch.__file__), rel))
    bad = []
    for name, sig in ref.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("_") and leaf != "__init__":
            continue
        if name not in port or not _leads(sig, port[name]):
            bad.append((name, sig, port.get(name)))
    assert not bad, (rel, bad)
