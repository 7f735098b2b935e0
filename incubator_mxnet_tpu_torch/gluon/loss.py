"""Losses (port of `incubator_mxnet_tpu/gluon/loss.py`): `Loss` :35 and
every loss of the reference, as `HybridBlock`s.

Each takes NDArrays (through the funnel, recorded under
``autograd.record()``) or torch tensors (the port's module path), and
computes as the reference does, op for op in float32. A loss returns one
value per sample: the mean over every axis but ``batch_axis`` (the
Triplet, Cosine-embedding and CTC losses reduce as the reference's do,
and PoissonNLL returns the mean over everything). ``loss.backward()``
then gives the gradient of the summed loss, which
``Trainer.step(batch_size)`` rescales by 1/batch_size, as MXNet's do.
"""
from __future__ import annotations

import math

import torch

from .. import numpy_extension as npx
from ..numpy_extension import _op
from .block import HybridBlock

__all__ = [
    "Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss", "SigmoidBCELoss",
    "SoftmaxCrossEntropyLoss", "SoftmaxCELoss", "KLDivLoss", "HuberLoss",
    "HingeLoss", "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
    "PoissonNLLLoss", "CosineEmbeddingLoss", "CTCLoss",
]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label.reshape(pred.shape) if label.shape != pred.shape else label


def _batch_mean(loss, batch_axis):
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis)
    if not axes:
        return loss
    return _op("mean", lambda t: t.mean(dim=axes), loss)


class Loss(HybridBlock):
    def __init__(self, weight=None, batch_axis=0, **kwargs):  # noqa: ARG002
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return f"{type(self).__name__}(batch_axis={self._batch_axis}, w={self._weight})"


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = _op("l2", lambda p, l: (p - l) ** 2, pred, label)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class L1Loss(Loss):
    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = _op("l1", lambda p, l: (p - l).abs(), pred, label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            if pos_weight is None:
                def f(p, l):
                    return (torch.clamp(p, min=0) - p * l
                            + torch.log1p(torch.exp(-p.abs())))

                loss = _op("sigmoid_bce", f, pred, label)
            else:
                def f(p, l, pw):
                    log_wt = (pw - 1) * l + 1
                    return (1 - l) * p + log_wt * (
                        torch.log1p(torch.exp(-p.abs()))
                        + torch.clamp(-p, min=0))

                loss = _op("sigmoid_bce", f, pred, label, pos_weight)
        else:
            eps = 1e-12

            def f(p, l):
                return -(torch.log(p + eps) * l
                         + torch.log(1 - p + eps) * (1 - l))

            loss = _op("sigmoid_bce", f, pred, label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class _SparseSoftmaxCE(torch.autograd.Function):
    """logsumexp(x) - x[label] over ``axis`` in f32, with the reference's
    hand-written backward (`_sparse_softmax_ce` :104): d_logits =
    (softmax(x) - onehot(label)) * g, one elementwise pass that saves no
    softmax. Labels out of range are clamped, so the forward's pick and
    the backward's onehot name the same class."""

    @staticmethod
    def forward(ctx, x, label, axis):
        ax = axis % x.dim()
        li = label.long().clamp(0, x.shape[ax] - 1).unsqueeze(ax)
        lse = torch.logsumexp(x.float(), dim=ax)
        pick = torch.gather(x, ax, li).squeeze(ax).float()
        ctx.save_for_backward(x, li, lse)
        ctx.ax = ax
        return lse - pick

    @staticmethod
    def backward(ctx, g):
        x, li, lse = ctx.saved_tensors
        ax = ctx.ax
        dx = torch.exp(x.float() - lse.unsqueeze(ax))
        dx.scatter_add_(ax, li, torch.full(li.shape, -1.0, device=x.device))
        dx.mul_(g.unsqueeze(ax))
        return dx.to(x.dtype), None, None


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy over ``axis``. ``sparse_label=True`` takes
    integer class labels (the scores' shape without ``axis``);
    ``from_logits=True`` takes log-probabilities."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        axis = self._axis
        sparse = self._sparse_label
        from_logits = self._from_logits

        def f(p, l):
            if sparse and not from_logits:
                return _SparseSoftmaxCE.apply(p, l, axis)
            logp = p if from_logits else torch.log_softmax(p, dim=axis)
            if sparse:
                ax = axis % p.dim()
                li = l.long().unsqueeze(ax)
                return -torch.gather(logp, ax, li).squeeze(ax)
            return -(logp * l).sum(dim=axis)

        loss = _op("softmax_ce", f, pred, label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = npx.log_softmax(pred, axis=self._axis)
        loss = _op("kldiv", lambda p, l: l * (torch.log(l + 1e-12) - p),
                   pred, label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HuberLoss(Loss):
    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        rho = self._rho

        def f(p, l):
            d = (p - l).abs()
            return torch.where(d > rho, d - 0.5 * rho, (0.5 / rho) * d * d)

        loss = _op("huber", f, pred, label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        m = self._margin
        loss = _op("hinge", lambda p, l: torch.clamp(m - p * l, min=0.0),
                   pred, label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(HingeLoss):
    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        m = self._margin
        loss = _op("sq_hinge",
                   lambda p, l: torch.clamp(m - p * l, min=0.0) ** 2,
                   pred, label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed", **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        fmt = self._label_format

        def f(p, l):
            if fmt == "binary":
                l = 2 * l - 1
            return torch.log1p(torch.exp(-p * l))

        loss = _op("logistic", f, pred, label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        m = self._margin

        def f(p, pos, neg):
            axes = tuple(range(1, p.dim()))
            d = ((p - pos) ** 2 - (p - neg) ** 2).sum(dim=axes)
            return torch.clamp(d + m, min=0.0)

        loss = _op("triplet", f, pred, positive, negative)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = _reshape_like(pred, target)
        from_logits = self._from_logits
        full = self._compute_full

        def f(p, t):
            if from_logits:
                loss = torch.exp(p) - t * p
            else:
                loss = p - t * torch.log(p + epsilon)
            if full:
                stirling = t * torch.log(t + 1e-12) - t + 0.5 * torch.log(
                    2 * math.pi * (t + 1e-12))
                loss = loss + torch.where(t > 1, stirling,
                                          torch.zeros_like(stirling))
            return loss

        loss = _op("poisson_nll", f, pred, target)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _op("mean", lambda t: t.mean(), loss)


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        m = self._margin

        def f(a, b, l):
            a2 = a.reshape(a.shape[0], -1)
            b2 = b.reshape(b.shape[0], -1)
            cos = (a2 * b2).sum(dim=1) / (
                torch.linalg.norm(a2, dim=1) * torch.linalg.norm(b2, dim=1)
                + 1e-12)
            lf = l.reshape(-1)
            return torch.where(lf == 1, 1 - cos, torch.clamp(cos - m, min=0.0))

        loss = _op("cosine_embedding", f, input1, input2, label)
        return _apply_weighting(loss, self._weight, sample_weight)


def _ctc(p, l, pl, ll, layout):
    """The reference's forward recursion over time in log space (-1e30 for
    an impossible state, a 1e-38 floor under each log-sum), one step a
    loop iteration; differentiable by autograd."""
    if layout == "TNC":
        p = p.movedim(0, 1)  # -> NTC
    N, T, _ = p.shape
    L = l.shape[1]
    blank = 0
    logp = torch.log_softmax(p, dim=-1)
    S = 2 * L + 1
    dev = p.device
    ext = torch.full((N, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = l.long()
    pl_ = (torch.full((N,), T, dtype=torch.long, device=dev) if pl is None
           else pl.long())
    ll_ = (torch.full((N,), L, dtype=torch.long, device=dev) if ll is None
           else ll.long())
    S_len = 2 * ll_ + 1
    neg_inf = -1e30
    alpha = torch.full((N, S), neg_inf, dtype=logp.dtype, device=dev)
    alpha = torch.cat([logp[:, 0, blank:blank + 1],
                       torch.gather(logp[:, 0, :], 1, ext[:, 1:2]),
                       alpha[:, 2:]], dim=1)
    same = torch.cat([torch.zeros((N, 2), dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    pad1 = torch.full((N, 1), neg_inf, dtype=logp.dtype, device=dev)
    pad2 = torch.full((N, 2), neg_inf, dtype=logp.dtype, device=dev)
    for t in range(1, T):
        lp = torch.gather(logp[:, t, :], 1, ext)
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.cat([pad2, alpha[:, :-2]], dim=1)
        a2 = torch.where(same, torch.full_like(a2, neg_inf), a2)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        new = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                            + torch.exp(a2 - m) + 1e-38) + lp
        alpha = torch.where((t < pl_)[:, None], new, alpha)
    a_last = torch.gather(alpha, 1, (S_len - 1)[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp(S_len - 2, min=0)[:, None])[:, 0]
    m = torch.maximum(a_last, a_prev)
    return -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)
                           + 1e-38))


class CTCLoss(Loss):
    """Connectionist Temporal Classification (reference: loss.py CTCLoss):
    the forward recursion over time, blank 0, ``pred_lengths`` and
    ``label_lengths`` per sample."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None, **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        layout = self._layout
        loss = _op("ctc", lambda p, l, pl, ll: _ctc(p, l, pl, ll, layout),
                   pred, label, pred_lengths, label_lengths)
        return _apply_weighting(loss, self._weight, sample_weight)
