"""Recurrent layers and cells (port of `incubator_mxnet_tpu/gluon/rnn/`):
the fused `RNN`, `LSTM` and `GRU` over `npx.rnn`, the unrolled cells and
their modifiers, and the convolutional cells."""
from .rnn_cell import (  # noqa: F401
    BidirectionalCell, DropoutCell, GRUCell, HybridRecurrentCell,
    HybridSequentialRNNCell, LSTMCell, LSTMPCell, ModifierCell,
    RecurrentCell, ResidualCell, RNNCell, SequentialRNNCell,
    VariationalDropoutCell, ZoneoutCell,
)
from .rnn_layer import GRU, LSTM, RNN  # noqa: F401
from .conv_rnn_cell import (  # noqa: F401
    Conv1DGRUCell, Conv1DLSTMCell, Conv1DRNNCell, Conv2DGRUCell,
    Conv2DLSTMCell, Conv2DRNNCell, Conv3DGRUCell, Conv3DLSTMCell,
    Conv3DRNNCell, ConvGRUCell, ConvLSTMCell, ConvRNNCell,
)
