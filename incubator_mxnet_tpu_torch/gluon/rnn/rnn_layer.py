"""Fused RNN layers (port of `incubator_mxnet_tpu/gluon/rnn/rnn_layer.py`:
`RNN`, `LSTM`, `GRU` over `npx.rnn`). The parameters live in one flat
vector in cuDNN's layout (`npx.rnn_param_size`), so checkpoints of either
package load into the other's layer; the input size may be deferred to
the first call. "TNC" or "NTC" layouts; a call with ``states`` returns the
output and the new states, without them the output alone."""
from __future__ import annotations

import torch

from ... import numpy as np
from ... import numpy_extension as npx
from ...ndarray.ndarray import NDArray
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, mode, dtype="float32", i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", **kwargs):  # noqa: ARG002
        super().__init__()
        assert layout in ("TNC", "NTC")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        self.parameters = Parameter(
            shape=(npx.rnn_param_size(mode, num_layers, input_size, hidden_size,
                                      bidirectional) if input_size else 0,),
            dtype=dtype, init=i2h_weight_initializer, allow_deferred_init=True)

    def infer_shape(self, x, *args):
        self._input_size = x.shape[-1]
        self.parameters.shape = (npx.rnn_param_size(
            self._mode, self._num_layers, self._input_size, self._hidden_size,
            self._dir == 2),)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        if self._mode == "lstm":
            return [{"shape": shape}, {"shape": shape}]
        return [{"shape": shape}]

    def begin_state(self, batch_size=0, func=None, **kwargs):  # noqa: ARG002
        """Zero states (f32, as the reference's) on ``device`` (else the
        current device)."""
        dev = kwargs.get("device", kwargs.get("ctx"))
        return [np.zeros(info["shape"], device=dev)
                for info in self.state_info(batch_size)]

    def forward(self, x, states=None):
        explicit_states = states is not None
        if states is None:
            batch = x.shape[0] if self._layout == "NTC" else x.shape[1]
            states = self.begin_state(batch, device=x.device)
            if isinstance(x, torch.Tensor):
                states = [s._data for s in states]
        if isinstance(states, (NDArray, torch.Tensor)):
            states = [states]
        seq = x.swapaxes(0, 1) if self._layout == "NTC" else x
        out = npx.rnn(data=seq, parameters=self.parameters.data(),
                      state=states[0],
                      state_cell=states[1] if self._mode == "lstm" else None,
                      mode=self._mode, state_size=self._hidden_size,
                      num_layers=self._num_layers,
                      bidirectional=self._dir == 2, p=self._dropout,
                      state_outputs=True)
        if self._mode == "lstm":
            y, h, c = out
            new_states = [h, c]
        else:
            y, h = out
            new_states = [h]
        if self._layout == "NTC":
            y = y.swapaxes(0, 1)
        if explicit_states:
            return y, new_states
        return y

    def __repr__(self):
        return (f"{type(self).__name__}({self._hidden_size}, "
                f"num_layers={self._num_layers}, layout={self._layout})")


class RNN(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, mode, **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
