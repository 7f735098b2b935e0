"""Gluon Trainer (port of `incubator_mxnet_tpu/gluon/trainer.py`
`Trainer` :15: `step` :83, `update` :113, `_update` :119).

The port runs on one card, so there is no gradient reduction: the
reference's KVStore step is a no-op there too. Gradients live in each
parameter's ``.grad`` and accumulate across backward passes, as PyTorch's
do (MXNet's ``grad_req="add"``); clear them between steps with
``module.zero_grad()``. A parameter whose ``.grad`` is None (one the loss
does not reach, such as BERT's NSP head under an MLM-only loss) is
skipped, as `_update` skips it, with or without ``ignore_stale_grad``
(the reference's `_update` skips it either way too).

``_scale`` (1.0 until `amp.scale_loss` folds 1 / loss scale into it, and
again after `amp.unscale`) multiplies into the optimizer's
``rescale_grad`` at every step, as in the reference (:30, :87, :116).
"""
from __future__ import annotations

from ..optimizer import Optimizer

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a module's parameters.

    ``params``: ``module.named_parameters()`` (or any iterable of
    (name, parameter) pairs, or a dict); ``optimizer``: an
    :class:`~..optimizer.Optimizer` instance, such as ``Adam(...)``. Parameters are indexed in name
    order, as the reference sorts its ``collect_params()`` dict, so the
    per-index optimizer state lines up with the reference's.
    """

    def __init__(self, params, optimizer):
        named = dict(params.items() if isinstance(params, dict) else params)
        self._params = [named[n] for n in sorted(named)]
        if not isinstance(optimizer, Optimizer):
            raise TypeError(f"Trainer takes an Optimizer instance (the port "
                            f"has no optimizer registry yet), got "
                            f"{optimizer!r}")
        self._optimizer = optimizer
        self._scale = 1.0
        self._states = {}  # index -> optimizer state, made at first update

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by 1/batch_size and apply the optimizer (on
        one card there is nothing to reduce first)."""
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):  # noqa: ARG002
        """Apply the optimizer with gradients rescaled by
        ``_scale``/batch_size. A parameter without a gradient is skipped
        whatever ``ignore_stale_grad`` says, as in the reference."""
        self._optimizer.rescale_grad = self._scale / batch_size
        for i, p in enumerate(self._params):
            if not p.requires_grad or p.grad is None:
                continue
            if i not in self._states:
                self._states[i] = self._optimizer.create_state(i, p)
            self._optimizer.update(i, p, p.grad, self._states[i])
