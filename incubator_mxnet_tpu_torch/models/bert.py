"""BERT building blocks of the port (port of
`incubator_mxnet_tpu/models/bert.py`). Only `PositionwiseFFN`, which GPT
shares, is ported with the serving slice; the rest of BERT comes with the
training slice."""
from __future__ import annotations

import torch
from torch import nn

from .. import numpy_extension as npx
from ..base import MXNetError
from ..gluon import nn as gnn

__all__ = ["PositionwiseFFN", "check_no_dropout"]


def check_no_dropout(module, rate):
    """Raise when ``module`` would have to apply dropout: training mode,
    gradients recorded, ``rate > 0``. Dropout is not ported yet."""
    if rate and module.training and torch.is_grad_enabled():
        raise MXNetError(
            f"{type(module).__name__}: dropout {rate} in training mode is "
            f"not ported yet; use dropout=0.0, module.eval() or "
            f"torch.no_grad()")


class PositionwiseFFN(nn.Module):
    """``ffn2(act(ffn1(x)))``; ``activation="gelu"`` is the tanh
    approximation, as in the reference. Dropout (the K5 kernel) comes with
    the training slice: with ``dropout > 0`` a training-mode forward that
    records gradients raises instead of skipping it."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 dtype="float32", device=None):
        super().__init__()
        self.ffn1 = gnn.Dense(hidden_size, flatten=False, in_units=units,
                              dtype=dtype, device=device)
        self.ffn2 = gnn.Dense(units, flatten=False, in_units=hidden_size,
                              dtype=dtype, device=device)
        self._activation = activation
        self._drop_rate = dropout

    def forward(self, x):
        check_no_dropout(self, self._drop_rate)
        return self.ffn2(npx.activation(self.ffn1(x),
                                        act_type=self._activation))
