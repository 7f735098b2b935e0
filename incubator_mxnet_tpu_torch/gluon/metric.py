"""Evaluation metrics (port of `incubator_mxnet_tpu/gluon/metric.py`; the
reference's own is `python/mxnet/gluon/metric.py`, 1867 LoC).

Host code, kept as it is: an update copies its predictions and labels to
the host once each (`_to_numpy`: an NDArray's ``asnumpy()``, a torch
tensor's ``.cpu()``), as the reference does, and reduces in numpy. On
the card that copy is the update's one host sync.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..ndarray.ndarray import NDArray

__all__ = [
    "EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy", "F1",
    "Fbeta", "BinaryAccuracy", "MCC", "MAE", "MSE", "RMSE", "CrossEntropy",
    "NegativeLogLikelihood", "Perplexity", "PearsonCorrelation", "PCC",
    "MeanPairwiseDistance", "MeanCosineSimilarity", "Loss", "CustomMetric",
    "create", "np",
]

_REGISTRY: dict = {}


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    key = str(metric).lower()
    aliases = {"acc": "accuracy", "ce": "crossentropy", "nll_loss":
               "negativeloglikelihood", "pearsonr": "pearsoncorrelation",
               "top_k_accuracy": "topkaccuracy"}
    key = aliases.get(key, key)
    if key not in _REGISTRY:
        raise ValueError(f"unknown metric {metric!r}")
    return _REGISTRY[key](*args, **kwargs)


def _to_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return NDArray(x.detach()).asnumpy()
    return onp.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):  # noqa: ARG002
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        self.metrics = [create(m) for m in (metrics or [])]
        super().__init__(name, **kwargs)

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return (names, values)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        self.axis = axis
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype("int32").ravel()
            label = label.astype("int32").ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        self.top_k = top_k
        super().__init__(f"{name}_{top_k}", **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype("int32").ravel()
            argsorted = onp.argsort(pred, axis=1)[:, -self.top_k:]
            self.sum_metric += (argsorted == label[:, None]).any(axis=1).sum()
            self.num_inst += len(label)


def _binarize(pred, threshold=0.5):
    pred = _to_numpy(pred)
    if pred.ndim > 1 and pred.shape[-1] > 1:
        if pred.shape[-1] > 2:
            raise ValueError(
                "F1/Fbeta/BinaryAccuracy currently only support binary "
                "classification (got predictions over "
                f"{pred.shape[-1]} classes)")
        return pred.argmax(axis=-1).ravel()
    return (pred.ravel() > threshold).astype("int32")


@register
class Fbeta(EvalMetric):
    """F-beta score with micro/macro averaging (reference: metric.py:816
    Fbeta over metric.py:551 _ClassificationMetrics). `average='micro'`
    accumulates global tp/fp/fn; `'macro'` averages the per-update score."""

    def __init__(self, name="fbeta", beta=1, average="macro", threshold=0.5,
                 **kwargs):
        self.average = average
        self.beta = beta
        self.threshold = threshold
        super().__init__(name, **kwargs)

    def reset(self):
        self.tp = self.fp = self.fn = 0
        self.num_inst = 0
        self.sum_metric = 0.0

    def _score(self, tp, fp, fn):
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        b2 = self.beta ** 2
        denom = b2 * prec + rec
        return ((1 + b2) * prec * rec / denom) if denom > 0 else 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).ravel().astype("int32")
            pred = _binarize(pred, self.threshold)
            tp = int(((pred == 1) & (label == 1)).sum())
            fp = int(((pred == 1) & (label == 0)).sum())
            fn = int(((pred == 0) & (label == 1)).sum())
            if self.average == "micro":
                self.tp += tp
                self.fp += fp
                self.fn += fn
            else:
                self.sum_metric += self._score(tp, fp, fn)
            self.num_inst += 1

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        if self.average == "micro":
            return (self.name, self._score(self.tp, self.fp, self.fn))
        return (self.name, self.sum_metric / self.num_inst)


@register
class F1(Fbeta):
    def __init__(self, name="f1", average="macro", threshold=0.5, **kwargs):
        super().__init__(name=name, beta=1, average=average,
                         threshold=threshold, **kwargs)


@register
class BinaryAccuracy(EvalMetric):
    """Accuracy of thresholded binary predictions
    (reference: metric.py:877)."""

    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        self.threshold = threshold
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).ravel().astype("int32")
            pred = _binarize(pred, self.threshold)
            self.sum_metric += int((pred == label).sum())
            self.num_inst += len(label)


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        self.tp = self.fp = self.fn = self.tn = 0
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).ravel().astype("int32")
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(axis=-1)
            else:
                pred = (pred.ravel() > 0.5).astype("int32")
            pred = pred.ravel()
            self.tp += int(((pred == 1) & (label == 1)).sum())
            self.fp += int(((pred == 1) & (label == 0)).sum())
            self.fn += int(((pred == 0) & (label == 1)).sum())
            self.tn += int(((pred == 0) & (label == 0)).sum())
            self.num_inst += 1

    def get(self):
        import math

        denom = math.sqrt((self.tp + self.fp) * (self.tp + self.fn)
                          * (self.tn + self.fp) * (self.tn + self.fn))
        mcc = ((self.tp * self.tn - self.fp * self.fn) / denom
               if denom > 0 else 0.0)
        return (self.name, mcc)


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).reshape(pred.shape)
            self.sum_metric += onp.abs(label - pred).mean() * len(label)
            self.num_inst += len(label)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).reshape(pred.shape)
            self.sum_metric += ((label - pred) ** 2).mean() * len(label)
            self.num_inst += len(label)


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, onp.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        self.eps = eps
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).ravel().astype("int32")
            prob = pred[onp.arange(label.shape[0]), label]
            self.sum_metric += (-onp.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):  # noqa: ARG002
        self.ignore_label = ignore_label
        super().__init__(name=name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).ravel().astype("int32")
            prob = pred.reshape(-1, pred.shape[-1])[
                onp.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                keep = label != self.ignore_label
                prob = prob[keep]
            self.sum_metric += (-onp.log(prob + self.eps)).sum()
            self.num_inst += prob.shape[0]

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(onp.exp(self.sum_metric / self.num_inst)))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        self._labels = []
        self._preds = []
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._labels.append(_to_numpy(label).ravel())
            self._preds.append(_to_numpy(pred).ravel())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return (self.name, float("nan"))
        l = onp.concatenate(self._labels)
        p = onp.concatenate(self._preds)
        return (self.name, float(onp.corrcoef(l, p)[0, 1]))


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation (Gorodkin's K-category correlation
    over the running confusion matrix; reference: metric.py:1595)."""

    def __init__(self, name="pcc", **kwargs):
        self.k = 2
        super().__init__(name, **kwargs)

    def reset(self):
        self.cm = onp.zeros((2, 2), dtype=onp.int64)
        self.num_inst = 0
        self.sum_metric = 0.0

    def _grow(self, k):
        if k > self.cm.shape[0]:
            new = onp.zeros((k, k), dtype=onp.int64)
            new[:self.cm.shape[0], :self.cm.shape[1]] = self.cm
            self.cm = new

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).ravel().astype("int64")
            pred = _to_numpy(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.ravel().astype("int64")
            k = int(max(label.max(initial=0), pred.max(initial=0))) + 1
            self._grow(k)
            onp.add.at(self.cm, (label, pred), 1)
            self.num_inst += len(label)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        c = self.cm.astype(onp.float64)
        n = c.sum()
        trace = onp.trace(c)
        row = c.sum(axis=1)
        col = c.sum(axis=0)
        cov_xy = trace * n - row @ col
        cov_xx = n * n - row @ row
        cov_yy = n * n - col @ col
        denom = onp.sqrt(cov_xx * cov_yy)
        return (self.name, float(cov_xy / denom) if denom > 0 else 0.0)


@register
class MeanPairwiseDistance(EvalMetric):
    """Mean p-norm distance between predictions and labels
    (reference: metric.py:1202)."""

    def __init__(self, name="mpd", p=2, **kwargs):
        self.p = p
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).reshape(pred.shape)
            pred = pred.reshape(pred.shape[0], -1)
            label = label.reshape(label.shape[0], -1)
            d = (onp.abs(pred - label) ** self.p).sum(axis=1) ** (1 / self.p)
            self.sum_metric += d.sum()
            self.num_inst += len(d)


@register
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine similarity along the last axis
    (reference: metric.py:1269)."""

    def __init__(self, name="cos_sim", eps=1e-8, **kwargs):
        self.eps = eps
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).reshape(pred.shape)
            num = (pred * label).sum(axis=-1)
            den = (onp.linalg.norm(pred, axis=-1)
                   * onp.linalg.norm(label, axis=-1))
            sim = num / onp.maximum(den, self.eps)
            self.sum_metric += sim.sum()
            self.num_inst += sim.size


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            loss = _to_numpy(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval(label, pred) into a metric
    (reference: metric.py:1807)."""
    return CustomMetric(numpy_feval, name or numpy_feval.__name__,
                        allow_extra_outputs)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False, **kwargs):  # noqa: ARG002
        self._feval = feval
        super().__init__(f"custom({name})", **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            v = self._feval(_to_numpy(label), _to_numpy(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1
