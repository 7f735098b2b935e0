"""`gluon.metric` of the port against the JAX package's, on the CPU: every
metric, `create` (names, aliases, lists, callables) and
`CompositeEvalMetric`, on the same seeded predictions and labels, two
updates each (NDArrays, then torch tensors for the port and numpy for
the reference), then a reset.

Both packages copy to the host and reduce in numpy, so values are equal
to float64 rounding: 1e-12 relative.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon import metric as jm
from incubator_mxnet_tpu_torch.gluon import metric as tm

REL = 1e-12
R = onp.random.RandomState(0)
PROBS = R.dirichlet(onp.ones(4), size=12).astype("float32")
BIN_PROBS = R.dirichlet(onp.ones(2), size=12).astype("float32")
LABELS4 = R.randint(0, 4, 12).astype("int32")
LABELS2 = R.randint(0, 2, 12).astype("int32")
SCORES = R.uniform(size=12).astype("float32")
REG_P = R.normal(size=(12, 3)).astype("float32")
REG_L = R.normal(size=(12, 3)).astype("float32")
LOSSES = R.uniform(size=(12,)).astype("float32")

CASES = {
    "Accuracy": (lambda m: m.Accuracy(), PROBS, LABELS4),
    "TopKAccuracy": (lambda m: m.TopKAccuracy(top_k=2), PROBS, LABELS4),
    "F1_macro": (lambda m: m.F1(), BIN_PROBS, LABELS2),
    "F1_micro": (lambda m: m.F1(average="micro"), SCORES, LABELS2),
    "Fbeta": (lambda m: m.Fbeta(beta=2, average="micro"), BIN_PROBS,
              LABELS2),
    "BinaryAccuracy": (lambda m: m.BinaryAccuracy(threshold=0.3), SCORES,
                       LABELS2),
    "MCC": (lambda m: m.MCC(), BIN_PROBS, LABELS2),
    "MAE": (lambda m: m.MAE(), REG_P, REG_L),
    "MSE": (lambda m: m.MSE(), REG_P, REG_L),
    "RMSE": (lambda m: m.RMSE(), REG_P, REG_L),
    "CrossEntropy": (lambda m: m.CrossEntropy(), PROBS, LABELS4),
    "NegativeLogLikelihood": (lambda m: m.NegativeLogLikelihood(), PROBS,
                              LABELS4),
    "Perplexity": (lambda m: m.Perplexity(ignore_label=1), PROBS, LABELS4),
    "PearsonCorrelation": (lambda m: m.PearsonCorrelation(), REG_P, REG_L),
    "PCC": (lambda m: m.PCC(), PROBS, LABELS4),
    "MeanPairwiseDistance": (lambda m: m.MeanPairwiseDistance(p=3), REG_P,
                             REG_L),
    "MeanCosineSimilarity": (lambda m: m.MeanCosineSimilarity(), REG_P,
                             REG_L),
    "Loss": (lambda m: m.Loss(), LOSSES, LOSSES),
    "CustomMetric": (lambda m: m.CustomMetric(
        lambda l, p: float(onp.abs(l - p.argmax(-1)).sum()), "dist"),
        PROBS, LABELS4),
    "np": (lambda m: m.np(lambda l, p: (float((l == 0).sum()), len(l))),
           PROBS, LABELS4),
    "create_list": (lambda m: m.create(["acc", "ce", "top_k_accuracy"]),
                    PROBS, LABELS4),
    "Composite": (lambda m: m.CompositeEvalMetric(
        [m.Accuracy(), "nll_loss", m.Loss()]), PROBS, LABELS4),
}


def _close(a, b):
    if isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
        return
    if isinstance(b, str):
        assert a == b
        return
    b = float(b)
    if onp.isnan(b):
        assert onp.isnan(float(a))
    else:
        assert abs(float(a) - b) <= REL * max(abs(b), 1.0), (a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_equals_reference(name):
    make, pred, label = CASES[name]
    ref, port = make(jm), make(tm)
    ref.update(jmx.np.array(label[:7]), jmx.np.array(pred[:7]))
    ref.update(label[7:], pred[7:])
    with tmx.cpu():
        port.update(tmx.np.array(label[:7]), tmx.np.array(pred[:7]))
    port.update(torch.from_numpy(label[7:]), torch.from_numpy(pred[7:]))
    (rn, rv), (pn, pv) = ref.get(), port.get()
    _close(pn, rn)
    _close(pv, rv)
    assert port.get_name_value() is not None
    ref.reset()
    port.reset()
    _close(port.get()[1], ref.get()[1])


def test_create_resolves_names_as_the_reference():
    for name in ("acc", "accuracy", "ce", "nll_loss", "pearsonr",
                 "top_k_accuracy", "f1", "mae", "mse", "rmse", "perplexity",
                 "mcc", "pcc", "loss", "fbeta", "binaryaccuracy"):
        assert type(tm.create(name)).__name__ == \
            type(jm.create(name)).__name__
    with pytest.raises(ValueError):
        tm.create("no-such-metric")
    m = tm.Accuracy()
    assert tm.create(m) is m


def test_bfloat16_predictions_reduce_like_their_float32_values():
    """A bf16 prediction (an AMP model's logits) is read as its float32
    values: the metric equals the float32 one on the same values."""
    p = torch.from_numpy(PROBS).to(torch.bfloat16)
    a, b = tm.Accuracy(), tm.Accuracy()
    a.update(torch.from_numpy(LABELS4), p)
    b.update(LABELS4, p.float().numpy())
    assert a.get() == b.get()
