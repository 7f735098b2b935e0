"""Optimizers (port of `incubator_mxnet_tpu/optimizer/optimizer.py`:
`Optimizer` :45 and `Adam` :255, the training slice's optimizer).

The reference's update rules are pure functions that return new weights;
the port updates each weight and its state in place under
``torch.no_grad()``, which saves a copy of every parameter per step. The
hyperparameter handling is the reference's: ``rescale_grad`` and
``clip_gradient`` in `_preprocess`, weight decay added to the gradient,
and a per-index update count that drives Adam's bias correction. Learning
rate schedulers, per-parameter lr/wd multipliers, the other optimizers and
the by-name registry (`create`) are ported with the slice that first calls
them.

:meth:`Optimizer.step` takes ``lr``, ``wd`` and ``t`` as Python numbers
(`gluon.Trainer`) or as 0-dim tensors on the weights' device
(`parallel.DataParallel`, whose step is replayed as a CUDA graph: the
bias correction is then computed on the card from the device's ``t``, as
the reference computes it with ``jnp`` from a traced ``t``, :272).
:meth:`Optimizer.step_multi` updates a list of parameters at once: the
small-parameter segment of `parallel.DataParallel`, one multi-tensor
update where the reference concatenates (`parallel/sharded.py:85-113`).
"""
from __future__ import annotations

import math

import torch

__all__ = ["Optimizer", "Adam"]


class Optimizer:
    """Base optimizer (reference: `python/mxnet/optimizer/optimizer.py`)."""

    #: True when `step` is a purely per-element rule: `DataParallel` may
    #: then update its small parameters together (`step_multi`). Rules
    #: taking per-tensor statistics (LARS/LAMB trust ratios) opt out.
    elementwise = True

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=None):
        self.rescale_grad = rescale_grad
        self.lr = 0.01 if learning_rate is None else learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count: dict = {}

    @property
    def learning_rate(self):
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def _update_count(self, index):
        count = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def create_state(self, index, weight):  # noqa: ARG002
        return None

    def _preprocess(self, grad):
        """The rescaled, clipped gradient (a new tensor)."""
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g

    def update(self, index, weight, grad, state):
        """Update one parameter in place (its state too)."""
        self._update_count(index)
        with torch.no_grad():
            self.step(weight, grad, state, self.lr, self.wd,
                      self._index_update_count[index])

    def step(self, weight, grad, state, lr, wd, t):
        """Update ``weight`` and ``state`` in place; ``lr``, ``wd`` and
        ``t`` are numbers or 0-dim tensors on the weight's device."""
        raise NotImplementedError

    def step_multi(self, weights, grads, states, lr, wd, t):
        """:meth:`step` of each parameter of the lists, the same numbers
        (an optimizer may update them together)."""
        for w, g, s in zip(weights, grads, states):
            self.step(w, g, s, lr, wd, t)


class Adam(Optimizer):
    """Adam with the reference's update: g += wd * w,
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    w -= lr sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):  # noqa: ARG002
        return [torch.zeros_like(weight), torch.zeros_like(weight)]

    def _lr_t(self, lr, t):
        """The bias-corrected rate: from a device ``t`` by torch ops in
        float64 (no sync; the value the host's math gives)."""
        if isinstance(t, torch.Tensor):
            t = t.double()
            return (lr * torch.sqrt(1 - torch.pow(self.beta2, t))
                    / (1 - torch.pow(self.beta1, t)))
        return lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)

    def step(self, weight, grad, state, lr, wd, t):
        g = self._preprocess(grad)
        if isinstance(wd, torch.Tensor):  # a device wd: added always
            g.add_(weight * wd)
        elif wd:
            g.add_(weight, alpha=wd)
        m, v = state
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        weight.sub_(self._lr_t(lr, t) * m / (v.sqrt() + self.epsilon))

    def step_multi(self, weights, grads, states, lr, wd, t):
        """:meth:`step` over the lists with ``torch._foreach_*`` ops: each
        element takes the same operations in the same order, so the
        numbers are :meth:`step`'s, and the bias correction is computed
        once."""
        if not weights:
            return
        g = torch._foreach_mul(list(grads), self.rescale_grad)
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(g, -self.clip_gradient)
            torch._foreach_clamp_max_(g, self.clip_gradient)
        if isinstance(wd, torch.Tensor):
            torch._foreach_add_(g, torch._foreach_mul(list(weights), wd))
        elif wd:
            torch._foreach_add_(g, list(weights), alpha=wd)
        m = [s[0] for s in states]
        v = [s[1] for s in states]
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, g, alpha=1 - self.beta1)
        torch._foreach_mul_(v, self.beta2)
        torch._foreach_addcmul_(v, g, g, value=1 - self.beta2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.epsilon)
        lr_t = self._lr_t(lr, t)
        num = torch._foreach_mul(m, lr_t)
        torch._foreach_sub_(list(weights), torch._foreach_div(num, denom))
