"""Dynamic loss scaler (port of `incubator_mxnet_tpu/amp/loss_scaler.py`
`LossScaler` :7; reference: `python/mxnet/amp/loss_scaler.py:26`)."""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    """The loss scale and its update rule: halve it (down to
    ``min_scale``) on an overflow, double it after ``scale_window`` steps
    without one."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, min_scale=1.0):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._min_scale = min_scale
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any gradient is non-finite. ``params``: tensors (or
        parameters) whose ``.grad`` is checked where it is set. The check
        runs on the gradients' device, one ``isfinite`` reduction a
        gradient gathered into one flag, and syncs the host once."""
        flags = [torch.isfinite(p.grad).all() for p in params
                 if getattr(p, "grad", None) is not None]
        return bool(flags) and not bool(torch.stack(flags).all())

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor,
                                  self._min_scale)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
