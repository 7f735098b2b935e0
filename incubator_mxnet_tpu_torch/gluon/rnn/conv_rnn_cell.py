"""Convolutional recurrent cells (port of `incubator_mxnet_tpu/gluon/rnn/
conv_rnn_cell.py`: `ConvRNNCell`, `ConvLSTMCell`, `ConvGRUCell` and their
1-, 2- and 3-d variants, Shi et al. "Convolutional LSTM"). The gates are
two same-padded convolutions (input to gates, hidden to gates) through
`npx.convolution` (cuDNN on the card); the state is (B, hidden, *spatial).
"""
from __future__ import annotations

from ... import numpy as np
from ... import numpy_extension as npx
from ..parameter import Parameter
from .rnn_cell import RecurrentCell

__all__ = ["ConvRNNCell", "ConvLSTMCell", "ConvGRUCell"]


class _ConvCellBase(RecurrentCell):
    """Shared conv-gate machinery: state (B, hidden, H, W); input
    (B, C, H, W); i2h and h2h are same-padded convs producing
    ngates*hidden channels."""

    def __init__(self, hidden_channels, ngates, kernel_size=(3, 3),
                 input_shape=None, dtype="float32",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dims=2):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * dims
        self._hidden = hidden_channels
        self._ngates = ngates
        self._kernel = tuple(kernel_size)
        # spatial dims from input_shape=(C, *spatial) if given (1-3D),
        # else learned on the first forward
        self._spatial = (tuple(input_shape[1:])
                         if input_shape is not None and len(input_shape) >= 2
                         else None)
        in_ch = 0 if input_shape is None else input_shape[0]
        k = self._kernel
        self.i2h_weight = Parameter(
            shape=(ngates * hidden_channels, in_ch) + k, dtype=dtype,
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = Parameter(
            shape=(ngates * hidden_channels, hidden_channels) + k,
            dtype=dtype, init=h2h_weight_initializer)
        self.i2h_bias = Parameter(shape=(ngates * hidden_channels,),
                                  dtype=dtype, init=i2h_bias_initializer)
        self.h2h_bias = Parameter(shape=(ngates * hidden_channels,),
                                  dtype=dtype, init=h2h_bias_initializer)

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._ngates * self._hidden,
                                 x.shape[1]) + self._kernel
        self._spatial = tuple(x.shape[2:])

    def state_info(self, batch_size=0):
        spatial = self._spatial or (0,) * len(self._kernel)
        return [{"shape": (batch_size, self._hidden) + spatial}]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        if self._spatial is None:
            raise ValueError(
                "conv cell spatial dims unknown — construct with "
                "input_shape=(C, H, W) or run one forward first")
        return super().begin_state(batch_size, func, **kwargs)

    def _gates(self, x, h):
        pad = tuple(k // 2 for k in self._kernel)
        n = self._ngates * self._hidden
        i2h = npx.convolution(x, self.i2h_weight.data(),
                              self.i2h_bias.data(), kernel=self._kernel,
                              num_filter=n, pad=pad)
        h2h = npx.convolution(h, self.h2h_weight.data(),
                              self.h2h_bias.data(), kernel=self._kernel,
                              num_filter=n, pad=pad)
        return i2h + h2h


class ConvRNNCell(_ConvCellBase):
    """tanh conv-RNN cell (reference: conv_rnn_cell.py ConvRNNCell)."""

    def __init__(self, hidden_channels, kernel_size=(3, 3),
                 activation="tanh", **kwargs):
        super().__init__(hidden_channels, 1, kernel_size, **kwargs)
        self._activation = activation

    def forward(self, x, states):
        if self._spatial is None:
            self._spatial = tuple(x.shape[2:])
        out = npx.activation(self._gates(x, states[0]),
                             act_type=self._activation)
        return out, [out]


class ConvLSTMCell(_ConvCellBase):
    """Convolutional LSTM (reference: conv_rnn_cell.py ConvLSTMCell)."""

    def __init__(self, hidden_channels, kernel_size=(3, 3), **kwargs):
        super().__init__(hidden_channels, 4, kernel_size, **kwargs)

    def state_info(self, batch_size=0):
        spatial = self._spatial or (0,) * len(self._kernel)
        shape = (batch_size, self._hidden) + spatial
        return [{"shape": shape}, {"shape": shape}]

    def forward(self, x, states):
        if self._spatial is None:
            self._spatial = tuple(x.shape[2:])
        h, c = states
        gates = self._gates(x, h)
        hc = self._hidden
        i = npx.sigmoid(gates[:, :hc])
        f = npx.sigmoid(gates[:, hc:2 * hc])
        g = np.tanh(gates[:, 2 * hc:3 * hc])
        o = npx.sigmoid(gates[:, 3 * hc:])
        c_new = f * c + i * g
        h_new = o * np.tanh(c_new)
        return h_new, [h_new, c_new]


class ConvGRUCell(_ConvCellBase):
    """Convolutional GRU (reference: conv_rnn_cell.py ConvGRUCell)."""

    def __init__(self, hidden_channels, kernel_size=(3, 3), **kwargs):
        super().__init__(hidden_channels, 3, kernel_size, **kwargs)

    def forward(self, x, states):
        if self._spatial is None:
            self._spatial = tuple(x.shape[2:])
        h = states[0]
        # GRU needs i2h/h2h separately (reset gate multiplies h2h only),
        # so it can't use _gates; padding generalizes over 1-3D kernels
        pad = tuple(k // 2 for k in self._kernel)
        n = self._ngates * self._hidden
        i2h = npx.convolution(x, self.i2h_weight.data(),
                              self.i2h_bias.data(), kernel=self._kernel,
                              num_filter=n, pad=pad)
        h2h = npx.convolution(h, self.h2h_weight.data(),
                              self.h2h_bias.data(), kernel=self._kernel,
                              num_filter=n, pad=pad)
        hc = self._hidden
        r = npx.sigmoid(i2h[:, :hc] + h2h[:, :hc])
        z = npx.sigmoid(i2h[:, hc:2 * hc] + h2h[:, hc:2 * hc])
        nvl = np.tanh(i2h[:, 2 * hc:] + r * h2h[:, 2 * hc:])
        h_new = (1 - z) * nvl + z * h
        return h_new, [h_new]

# Dimensional variants (reference: conv_rnn_cell.py Conv{1,2,3}D{RNN,LSTM,
# GRU}Cell): the generic cells above are N-d; these fix `dims` and the
# default kernel so signatures match the reference layer-per-rank classes.
def _dim_variant(base, dims, name, default_kernel):
    def __init__(self, hidden_channels, kernel_size=default_kernel,
                 **kwargs):  # noqa: N807
        kwargs.setdefault("dims", dims)
        base.__init__(self, hidden_channels, kernel_size=kernel_size,
                      **kwargs)

    return type(name, (base,), {"__init__": __init__,
                                "__doc__": f"{dims}-D {base.__name__} "
                                           f"(reference conv_rnn_cell.py)"})


Conv1DRNNCell = _dim_variant(ConvRNNCell, 1, "Conv1DRNNCell", (3,))
Conv2DRNNCell = _dim_variant(ConvRNNCell, 2, "Conv2DRNNCell", (3, 3))
Conv3DRNNCell = _dim_variant(ConvRNNCell, 3, "Conv3DRNNCell", (3, 3, 3))
Conv1DLSTMCell = _dim_variant(ConvLSTMCell, 1, "Conv1DLSTMCell", (3,))
Conv2DLSTMCell = _dim_variant(ConvLSTMCell, 2, "Conv2DLSTMCell", (3, 3))
Conv3DLSTMCell = _dim_variant(ConvLSTMCell, 3, "Conv3DLSTMCell", (3, 3, 3))
Conv1DGRUCell = _dim_variant(ConvGRUCell, 1, "Conv1DGRUCell", (3,))
Conv2DGRUCell = _dim_variant(ConvGRUCell, 2, "Conv2DGRUCell", (3, 3))
Conv3DGRUCell = _dim_variant(ConvGRUCell, 3, "Conv3DGRUCell", (3, 3, 3))
