"""BERT's dense-mask attention path (``use_flash=False``) and
``BERTClassifier`` against the JAX package's, on the CPU: a `bert_small`
(64 units, 2 layers, 4 heads, FFN 128; vocab 97, max_length 32) with the
JAX model's scaled random weights carried across by `load_jax_params`,
the same seeded tokens, labels and ragged valid lengths, dropout 0.

Tolerances (float32, two frameworks, the same arithmetic in another
order over two layers, as `tests/test_torch_bert.py`): scores and loss
1e-4 abs and rel; each gradient within 1e-4 of its largest magnitude. The
port's dense path against its own flash path on the same weights: scores
1e-5 (one softmax formula in two orders), gradients 1e-4 of the largest
magnitude. Dropout on the probabilities cannot match the reference's bits
(Philox against threefry): it is held to the same seed giving the same
loss, another seed another, and eval dropping nothing.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd, gluon, np
from incubator_mxnet_tpu.models.bert import BERTClassifier as JaxClassifier
from incubator_mxnet_tpu.models.bert import bert_small as jax_bert_small
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import random as tmxrandom
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models.bert import (BERTClassifier,
                                                    _dense_mask_from_valid_length,
                                                    bert_small)

VOCAB, T, CLASSES = 97, 24, 3
GRAD_REL = 1e-4


def _data(seed=1):
    r = onp.random.RandomState(seed)
    tok = r.randint(0, VOCAB, (3, T)).astype("int32")
    lab = r.randint(0, VOCAB, (3, T)).astype("int32")
    return tok, lab, onp.asarray([T, 11, 5], "int32")


def _grad_tol(g):
    return GRAD_REL * max(float(onp.abs(g).max()), 1e-30)


@pytest.fixture(scope="module")
def ref():
    """Scaled random weights; the JAX dense model's scores, loss and
    gradients with and without valid_length; and a JAX BERTClassifier
    over its encoder: class scores and gradients."""
    mx.random.seed(3)
    jm = jax_bert_small(vocab_size=VOCAB, max_length=32, dropout=0.0,
                        use_flash=False)
    jm.initialize()
    r = onp.random.RandomState(0)
    for _name, p in jm.collect_params().items():
        if len(p.shape) >= 2:
            p.set_data(np.array(r.normal(0, 0.2, p.shape).astype("float32")))
    params = {n: p.data().asnumpy() for n, p in jm.collect_params().items()}
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    tok, lab, vl = _data()
    cases = {}
    for with_vl in (False, True):
        with autograd.record():
            mlm, nsp = jm(np.array(tok), None,
                          np.array(vl) if with_vl else None)
            loss = ce(mlm, np.array(lab))
        loss.backward()
        cases[with_vl] = dict(
            mlm=mlm.asnumpy(), nsp=nsp.asnumpy(), loss=loss.asnumpy(),
            grads={n: p.grad().asnumpy().copy() for n, p in
                   jm.collect_params().items() if p.grad() is not None})
        for p in jm.collect_params().values():
            p.zero_grad()
    clf = JaxClassifier(jm.encoder, CLASSES, dropout=0.0)
    clf.initialize()
    clf(np.array(tok), None, np.array(vl))           # the deferred Dense
    clf.classifier.weight.set_data(np.array(
        r.normal(0, 0.2, (CLASSES, 64)).astype("float32")))
    clf_params = {n: p.data().asnumpy()
                  for n, p in clf.collect_params().items()}
    y = np.array(onp.asarray([0, 2, 1], "int32"))
    with autograd.record():
        scores = clf(np.array(tok), None, np.array(vl))
        closs = ce(scores, y)
    closs.backward()
    clf_case = dict(scores=scores.asnumpy(), loss=closs.asnumpy(),
                    grads={n: p.grad().asnumpy() for n, p in
                           clf.collect_params().items()
                           if p.grad() is not None})
    return params, cases, clf_params, clf_case


def _port(params, use_flash=False, dropout=0.0):
    tm = bert_small(vocab_size=VOCAB, max_length=32, dropout=dropout,
                    use_flash=use_flash, device="cpu", seed=0)
    tm.load_jax_params(params)
    return tm


def _step(tm, with_vl):
    tok, lab, vl = _data()
    mlm, nsp = tm(torch.from_numpy(tok).long(),
                  valid_length=torch.from_numpy(vl) if with_vl else None)
    loss = SoftmaxCrossEntropyLoss()(mlm, torch.from_numpy(lab))
    loss.sum().backward()
    return mlm, nsp, loss


@pytest.mark.parametrize("with_vl", [False, True])
def test_dense_path_matches_jax(ref, with_vl):
    """Scores, loss and every gradient of the MLM loss."""
    params, cases, _, _ = ref
    tm = _port(params)
    mlm, nsp, loss = _step(tm, with_vl)
    c = cases[with_vl]
    for got, want in ((mlm, c["mlm"]), (nsp, c["nsp"]), (loss, c["loss"])):
        onp.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                    atol=1e-4)
    for name, p in tm.named_parameters():
        want = c["grads"].get(name)
        if p.grad is None:
            assert want is None or not onp.abs(want).any(), name
            continue
        onp.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                    atol=_grad_tol(want), err_msg=name)


@pytest.mark.parametrize("with_vl", [False, True])
def test_dense_path_equals_the_flash_path(ref, with_vl):
    """On the same weights the dense masked softmax and the flash kernels'
    plain versions compute the same attention: rows past the length are
    zero in both."""
    params = ref[0]
    dense, flash = _port(params), _port(params, use_flash=True)
    a, b = _step(dense, with_vl), _step(flash, with_vl)
    for x, y in zip(a, b):
        onp.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                    rtol=1e-5, atol=1e-5)
    gb = dict(flash.named_parameters())
    for name, p in dense.named_parameters():
        if p.grad is None:
            assert gb[name].grad is None, name
            continue
        want = gb[name].grad.numpy()
        onp.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                    atol=_grad_tol(want), err_msg=name)


def test_dense_mask_matches_jax():
    """(N*H, T, T): pair (i, j) live where both are below the length,
    each sequence's mask repeated once a head."""
    from incubator_mxnet_tpu.models.bert import \
        _dense_mask_from_valid_length as jax_mask

    x = onp.zeros((3, 7, 8), "float32")
    vl = onp.asarray([7, 3, 1], "int32")
    want = jax_mask(np.array(x), np.array(vl), 4).asnumpy()
    got = _dense_mask_from_valid_length(torch.from_numpy(x),
                                        torch.from_numpy(vl), 4)
    assert got.dtype == torch.float32 and got.shape == (12, 7, 7)
    onp.testing.assert_array_equal(got.numpy(), want)


def test_dense_dropout_on_the_probabilities_is_seeded(ref):
    """dropout 0.1 in training: the probabilities' dropout draws a key a
    layer (besides the embedding's and the FFN's), the same seed gives the
    same loss, another seed another; eval drops nothing."""
    params = ref[0]

    def run(seed):
        tm = _port(params, dropout=0.1)
        tmxrandom.seed(seed)
        with tautograd.train_mode():
            return _step(tm, True)[2].detach()

    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8))
    tok, _, vl = _data()
    with torch.no_grad():
        a = _port(params, dropout=0.1)(torch.from_numpy(tok).long(), None,
                                       torch.from_numpy(vl))
        b = _port(params)(torch.from_numpy(tok).long(), None,
                          torch.from_numpy(vl))
    assert torch.equal(a[0], b[0])


def test_classifier_matches_jax(ref):
    """BERTClassifier over the dense encoder: class scores, loss and every
    gradient against the reference's."""
    params, _, clf_params, c = ref
    tm = _port(params)
    clf = BERTClassifier(tm.encoder, CLASSES, dropout=0.0, seed=2)
    assert sorted(dict(clf.collect_params())) == sorted(clf_params)
    clf.load_jax_params(clf_params)
    tok, _, vl = _data()
    scores = clf(torch.from_numpy(tok).long(), None, torch.from_numpy(vl))
    loss = SoftmaxCrossEntropyLoss()(scores, torch.tensor([0, 2, 1]))
    loss.sum().backward()
    assert scores.shape == (3, CLASSES)
    onp.testing.assert_allclose(scores.detach().numpy(), c["scores"],
                                rtol=1e-4, atol=1e-4)
    onp.testing.assert_allclose(loss.detach().numpy(), c["loss"], rtol=1e-4,
                                atol=1e-4)
    for name, p in clf.named_parameters():
        want = c["grads"].get(name)
        if p.grad is None:
            assert want is None or not onp.abs(want).any(), name
            continue
        onp.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                    atol=_grad_tol(want), err_msg=name)


def test_classifier_fine_tunes(ref):
    """Ten Adam steps on one batch through the gluon loop (NDArrays,
    ``record()``, ``Trainer``), dropout 0.1 in training: the loss falls;
    the head's deferred Dense takes its width at the first call."""
    import incubator_mxnet_tpu_torch as tmx

    params = ref[0]
    tok, _, vl = _data()
    with tmx.cpu():
        clf = BERTClassifier(_port(params, dropout=0.1).encoder, CLASSES)
        clf.classifier.initialize()
        trainer = Trainer(clf.collect_params(), "adam",
                          {"learning_rate": 1e-3})
        lossf = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        x, v = tmx.np.array(tok), tmx.np.array(vl)
        y = tmx.np.array(onp.asarray([0, 2, 1], "int32"))
        tmx.random.seed(4)
        losses = []
        for _ in range(10):
            with tmx.autograd.record():
                loss = lossf(clf(x, None, v), y)
            loss.backward()
            trainer.step(3)
            losses.append(float(loss.mean().item()))
    assert clf.classifier.weight.shape == (CLASSES, 64)
    assert all(onp.isfinite(losses))
    assert onp.mean(losses[-3:]) < 0.9 * onp.mean(losses[:3]), losses
