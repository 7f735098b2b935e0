"""Losses of the port (port of `incubator_mxnet_tpu/gluon/loss.py`:
`Loss` :35 and `SoftmaxCrossEntropyLoss` :165, the ones the training
slice calls).

Each loss returns one value per sample: the mean over every axis but the
batch axis, so the loss of (B, T, V) scores against (B, T) labels has
shape (B,). ``loss.backward(torch.ones_like(loss))`` (or
``loss.sum().backward()``) then gives the gradient of the summed loss,
which `Trainer.step(batch_size)` rescales by 1/batch_size, as MXNet's
``loss.backward()`` and ``trainer.step`` do.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(nn.Module):
    """Base of the losses: a scalar ``weight`` and the ``batch_axis`` the
    per-sample mean keeps."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):  # noqa: ARG002
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _batch_mean(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"


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
        if self._sparse_label and not self._from_logits:
            loss = _SparseSoftmaxCE.apply(pred, label, axis)
        else:
            logp = pred if self._from_logits else torch.log_softmax(
                pred.float(), dim=axis)
            if self._sparse_label:
                ax = axis % pred.dim()
                li = label.long().unsqueeze(ax)
                loss = -torch.gather(logp, ax, li).squeeze(ax)
            else:
                loss = -(logp * label).sum(dim=axis)
        return self._batch_mean(_apply_weighting(loss, self._weight,
                                                 sample_weight))


SoftmaxCELoss = SoftmaxCrossEntropyLoss
