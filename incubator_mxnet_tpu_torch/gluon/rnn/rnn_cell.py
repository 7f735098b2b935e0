"""Unrolled RNN cells (port of `incubator_mxnet_tpu/gluon/rnn/rnn_cell.py`):
`RNNCell`, `LSTMCell`, `GRUCell`, `LSTMPCell` over `npx.fully_connected`,
the containers and modifiers (`SequentialRNNCell`, `DropoutCell`,
`ZoneoutCell`, `ResidualCell`, `BidirectionalCell`, `ModifierCell`,
`VariationalDropoutCell`), and `RecurrentCell.unroll`'s time loop. The
gates are stacked i f g o (LSTM) and r z n (GRU), as in the fused layers.
Dropout goes through `npx.dropout` (the K5 kernel on the card); the
zoneout and variational masks are drawn with `mx.np.random.uniform`."""
from __future__ import annotations

from ... import autograd
from ... import numpy as np
from ... import numpy_extension as npx
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell", "BidirectionalCell",
           "ModifierCell", "VariationalDropoutCell", "LSTMPCell"]


class RecurrentCell(HybridBlock):
    def __init__(self):
        super().__init__()
        self._modified = False

    def reset(self):
        """Clear per-sequence state, recursing into child cells (so that
        wrapped or stacked modifier cells resample their masks each
        sequence)."""
        self._modified = False
        # base_cell/wrapped cells are Block attributes, so they are all
        # registered children: one walk covers every nesting
        for child in self._children.values():
            if isinstance(child, RecurrentCell):
                child.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):  # noqa: ARG002
        """Zero states (f32) on ``device`` (else the current device)."""
        dev = kwargs.get("device", kwargs.get("ctx"))
        return [np.zeros(info["shape"], device=dev)
                for info in self.state_info(batch_size)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):  # noqa: ARG002
        # resets per-sequence state (e.g. VariationalDropoutCell resamples
        # its masks each sequence), as the reference's unroll does
        self.reset()
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        states = begin_state or self.begin_state(batch,
                                                 device=inputs.device)
        outputs = []
        for t in range(length):
            x_t = inputs[t] if axis == 0 else inputs[:, t]
            out, states = self(x_t, states)
            outputs.append(out)
        if merge_outputs is not False:
            outputs = np.stack(outputs, axis=axis)
        return outputs, states


HybridRecurrentCell = RecurrentCell


class _BaseCell(RecurrentCell):
    def __init__(self, hidden_size, ngates, input_size=0, dtype="float32",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros"):
        super().__init__()
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = Parameter(shape=(ngates * hidden_size, input_size),
                                    dtype=dtype, init=i2h_weight_initializer,
                                    allow_deferred_init=True)
        self.h2h_weight = Parameter(shape=(ngates * hidden_size, hidden_size),
                                    dtype=dtype, init=h2h_weight_initializer)
        self.i2h_bias = Parameter(shape=(ngates * hidden_size,), dtype=dtype,
                                  init=i2h_bias_initializer)
        self.h2h_bias = Parameter(shape=(ngates * hidden_size,), dtype=dtype,
                                  init=h2h_bias_initializer)
        self._ngates = ngates

    def infer_shape(self, x, *args):
        self._input_size = x.shape[-1]
        self.i2h_weight.shape = (self._ngates * self._hidden_size,
                                 self._input_size)

    def _sums(self, x, h, n):
        i2h = npx.fully_connected(x, self.i2h_weight.data(),
                                  self.i2h_bias.data(), num_hidden=n)
        h2h = npx.fully_connected(h, self.h2h_weight.data(),
                                  self.h2h_bias.data(), num_hidden=n)
        return i2h, h2h


class RNNCell(_BaseCell):
    def __init__(self, hidden_size, activation="tanh", input_size=0, **kwargs):
        super().__init__(hidden_size, 1, input_size, **kwargs)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def forward(self, x, states):
        i2h, h2h = self._sums(x, states[0], self._hidden_size)
        out = npx.activation(i2h + h2h, act_type=self._activation)
        return out, [out]


def _lstm_gates(gates, c, hidden):
    i = npx.sigmoid(gates[:, :hidden])
    f = npx.sigmoid(gates[:, hidden:2 * hidden])
    g = np.tanh(gates[:, 2 * hidden:3 * hidden])
    o = npx.sigmoid(gates[:, 3 * hidden:])
    c_new = f * c + i * g
    return o * np.tanh(c_new), c_new


class LSTMCell(_BaseCell):
    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 4, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def forward(self, x, states):
        h, c = states
        i2h, h2h = self._sums(x, h, 4 * self._hidden_size)
        h_new, c_new = _lstm_gates(i2h + h2h, c, self._hidden_size)
        return h_new, [h_new, c_new]


class GRUCell(_BaseCell):
    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 3, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def forward(self, x, states):
        h = states[0]
        H = self._hidden_size
        i2h, h2h = self._sums(x, h, 3 * H)
        r = npx.sigmoid(i2h[:, :H] + h2h[:, :H])
        z = npx.sigmoid(i2h[:, H:2 * H] + h2h[:, H:2 * H])
        n = np.tanh(i2h[:, 2 * H:] + r * h2h[:, 2 * H:])
        h_new = (1 - z) * n + z * h
        return h_new, [h_new]


class SequentialRNNCell(RecurrentCell):
    def __init__(self):
        super().__init__()
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return sum((c.state_info(batch_size) for c in self._cells), [])

    def begin_state(self, batch_size=0, **kwargs):
        return sum((c.begin_state(batch_size, **kwargs) for c in self._cells),
                   [])

    def __len__(self):
        return len(self._cells)

    def __getitem__(self, i):
        return self._cells[i]

    def forward(self, x, states):
        next_states = []
        pos = 0
        for cell in self._cells:
            n = len(cell.state_info())
            x, new_s = cell(x, states[pos:pos + n])
            pos += n
            next_states.extend(new_s)
        return x, next_states


class DropoutCell(RecurrentCell):
    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):  # noqa: ARG002
        return []

    def forward(self, x, states):
        return npx.dropout(x, p=self._rate, axes=self._axes), states


def _zone(p, new, old):
    """``new`` where a draw keeps it (probability 1 - p), else ``old``."""
    keep = (np.random.uniform(0, 1, new.shape, device=new.device)
            < 1 - p).astype(new.dtype)
    return keep * new + (1 - keep) * old


class ZoneoutCell(RecurrentCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__()
        self.base_cell = base_cell
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None  # don't zone out toward a past sequence

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def forward(self, x, states):
        out, next_states = self.base_cell(x, states)
        if autograd.is_training():
            if self._zo:
                prev = self._prev_output if self._prev_output is not None \
                    else out.zeros_like()
                out = _zone(self._zo, out, prev)
            if self._zs:
                next_states = [_zone(self._zs, ns, s)
                               for ns, s in zip(next_states, states)]
        self._prev_output = out
        return out, next_states


class ResidualCell(RecurrentCell):
    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def forward(self, x, states):
        out, next_states = self.base_cell(x, states)
        return out + x, next_states


class BidirectionalCell(RecurrentCell):
    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return (self.l_cell.state_info(batch_size)
                + self.r_cell.state_info(batch_size))

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        states = begin_state or self.begin_state(batch,
                                                 device=inputs.device)
        n_l = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(length, inputs, states[:n_l],
                                             layout, True, valid_length)
        rev = np.flip(inputs, axis=axis)
        r_out, r_states = self.r_cell.unroll(length, rev, states[n_l:],
                                             layout, True, valid_length)
        r_out = np.flip(r_out, axis=axis)
        out = np.concatenate([l_out, r_out], axis=-1)
        return out, l_states + r_states

    def forward(self, x, states):
        raise NotImplementedError("BidirectionalCell supports unroll() only")


class ModifierCell(RecurrentCell):
    """Base for cells wrapping another cell (reference: rnn_cell.py
    ModifierCell — Dropout/Zoneout/Residual modifiers share it)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def forward(self, x, states):
        raise NotImplementedError


class VariationalDropoutCell(ModifierCell):
    """Same dropout mask reused across time steps (reference: rnn_cell.py
    VariationalDropoutCell / Gal & Ghahramani 2016)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self._di = drop_inputs
        self._ds = drop_states
        self._do = drop_outputs
        self._mask_i = None
        self._mask_s = None
        self._mask_o = None

    def reset(self):
        super().reset()
        self._mask_i = self._mask_s = self._mask_o = None

    def _mask(self, cached, like, rate):
        if rate == 0.0 or not autograd.is_training():
            return None
        if cached is None or cached.shape != like.shape:
            keep = 1.0 - rate
            cached = (np.random.uniform(0, 1, like.shape, device=like.device)
                      < keep) / keep
        return cached

    def forward(self, x, states):
        self._mask_i = self._mask(self._mask_i, x, self._di)
        if self._mask_i is not None:
            x = x * self._mask_i
        if self._ds:
            self._mask_s = self._mask(self._mask_s, states[0], self._ds)
            if self._mask_s is not None:
                states = [states[0] * self._mask_s] + list(states[1:])
        out, states = self.base_cell(x, states)
        self._mask_o = self._mask(self._mask_o, out, self._do)
        if self._mask_o is not None:
            out = out * self._mask_o
        return out, states


class LSTMPCell(_BaseCell):
    """LSTM with a hidden-state projection (reference: rnn_cell.py
    LSTMPCell / Sak et al. 2014 — h = r2h(o·tanh(c)), state h is the
    projected vector)."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 h2r_weight_initializer=None, **kwargs):
        super().__init__(hidden_size, 4, input_size, **kwargs)
        self._projection_size = projection_size
        dtype = kwargs.get("dtype", "float32")
        # h2h operates on the PROJECTED state: rebuild the parameter with
        # the projected input width (shape is fixed at Parameter creation)
        self.h2h_weight = Parameter(
            shape=(4 * hidden_size, projection_size), dtype=dtype,
            init=kwargs.get("h2h_weight_initializer"))
        self.h2r_weight = Parameter(
            shape=(projection_size, hidden_size), dtype=dtype,
            init=h2r_weight_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def forward(self, x, states):
        h, c = states
        i2h, h2h = self._sums(x, h, 4 * self._hidden_size)
        h_full, c_new = _lstm_gates(i2h + h2h, c, self._hidden_size)
        h_proj = npx.fully_connected(h_full, self.h2r_weight.data(), None,
                                     num_hidden=self._projection_size,
                                     no_bias=True)
        return h_proj, [h_proj, c_new]


HybridSequentialRNNCell = SequentialRNNCell
