"""BERT (port of `incubator_mxnet_tpu/models/bert.py`): the encoder, the
MLM and NSP heads of pretraining, and the blocks GPT shares.

Every kernel of the reference's training step runs here as a CUDA kernel:

- attention through ``npx.flash_attention`` (K1 forward, K2 backward),
  straight from the fused QKV projection ("bthd", read in place), with
  ``valid_length`` as (B,) lengths instead of a dense mask; dropout is on
  the attention output, as in the reference's flash path. With
  ``use_flash=False`` (or a dense ``mask``) attention is the reference's
  other path, line for line: ``npx.batch_dot`` for the scores (a plain
  product, as the reference leaves it to XLA), ``npx.masked_softmax`` over
  the dense (N*H, T, T) mask of :func:`_dense_mask_from_valid_length`
  (or ``npx.softmax``), dropout on the probabilities (K5) and
  ``npx.batch_dot`` with V;
- both post-LN residual sites of every cell through
  ``npx.residual_dropout_ln`` (K3, forward and backward);
- the embedding LayerNorm and ``mlm_ln`` through ``npx.layer_norm``
  (K4, K4b);
- dropout after the embedding, on the attention output and on the FFN
  hidden through ``npx.dropout`` (K5).

The blocks are the reference's `HybridBlock`s, line for line, so a model
takes NDArrays (the reference's training loop: ``autograd.record()``,
``gluon.Trainer``, ``hybridize()``) or torch tensors (the port's module
path: `parallel.DataParallel`, the tests), and gives the same numbers
either way. Dropout applies where ``autograd.is_training()`` says. The
Dense layers and the MLM decoder stay ``F.linear``, as the reference
leaves them to XLA. ``impl`` ("auto" | "kernel" | "plain") is handed to
every kernel's wrapper, so one model on the card can run its plain
versions, which is what the kernels are held against. Parameter names
are the reference's
``collect_params()`` names (:meth:`BERTModel.load_jax_params`), and
``named_parameters()`` gives the same.

Tensor and sequence parallelism (reference :28-56, :205-220):
:func:`tp_param_shardings` gives the reference's Megatron specs for
`parallel.DataParallel`, which keeps each parameter whole on every rank,
shards its optimizer state by the spec, updates the rank's block and
gathers the updated blocks after each step (`parallel/sharded.py`).
Given them, the step splits the model's compute over their axis as
Megatron does: each rank runs the flash kernels on its heads (the
head-aligned rows of the fused qkv weight, which the spec cuts
contiguously, read from the whole weight) and proj on their columns, the
FFN on its hidden units, the word embedding on its rows of the
vocabulary (the masked ids' lookup) and the MLM decoder on its rows (the
scores gathered whole for the softmax); Megatron's f and g
(`parallel._layout.copy_to`, `reduce_from`) join the regions, and the
dropout inside a split region folds the rank's index into its key.
``seq_shard_axis``
(e.g. "tp") runs the LayerNorm and dropout regions, the embedding's
LayerNorm and dropout and both post-LN residual sites of every cell, on
this rank's rows of the sequence under an active mesh
(`parallel._layout.seq_region`: `npx.sharding_constraint` for the rows,
K3 and K4 on them, the rows gathered back; γ's and β's gradients are
the rank's shares, which the step sums over the axis, and the dropout
keys are folded with the rank's coordinate).
Between the regions the activation is whole on every rank, which is the
reference's layout up to where GSPMD places the gather. With no mesh
the axis is unused.

The port's extras: ``device=`` (parameters are made there; the entry
points build on the card by default and raise when there is none,
unless ``device="cpu"`` is passed), ``dtype=``, ``impl=``, and ``seed=``:
a model made with a seed comes initialised from a `torch.Generator`
seeded by it (the reference's default initializers, drawn in module
order); without one it waits for ``initialize()``, as the reference's
does (seed the draws with ``mx.random.seed``).
"""
from __future__ import annotations

import math

import torch

from .. import numpy_extension as npx
from ..base import MXNetError
from ..device import resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.parameter import Parameter
from ..numpy_extension import _op
from ..parallel import _layout
from ..parallel._layout import seq_region
from ..initializer import generator_scope
from .decoding import make_generator
from .params import init_seeded, load_params

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "BERTEncoder", "BERTModel", "BERTClassifier", "bert_base",
           "bert_small", "tp_param_shardings"]


class _TPSpecs(list):
    """`tp_param_shardings`' list, marked with its axis: `DataParallel`
    splits a model's compute over it when the model supports it."""

    tensor_parallel_axis = None


def tp_param_shardings(net, tp_axis="tp"):
    """Megatron-style tensor-parallel specs for a gluon BERT, aligned with
    `parallel.DataParallel`'s trainable parameters (``collect_params()``
    values whose ``grad_req`` is not "null"): qkv and ffn1 shard their
    output dimension, proj and ffn2 their input dimension, the word
    embedding and the MLM decoder the vocabulary; the rest replicate. A
    spec is a tuple, one entry per dimension (the reference's
    `PartitionSpec`)."""
    specs = _TPSpecs()
    specs.tensor_parallel_axis = tp_axis
    for name, p in net.collect_params().items():
        if p.grad_req == "null":
            continue
        if name.endswith(("qkv.weight", "ffn1.weight")):
            specs.append((tp_axis, None))
        elif name.endswith(("qkv.bias", "ffn1.bias")):
            specs.append((tp_axis,))
        elif name.endswith(("proj.weight", "ffn2.weight")):
            specs.append((None, tp_axis))
        elif name.endswith(("word_embed.weight", "mlm_decoder.weight")):
            specs.append((tp_axis, None))
        elif name.endswith("mlm_decoder.bias"):
            specs.append((tp_axis,))
        else:
            specs.append(())
    return specs


def _dropout(rate, impl):
    return nn.Dropout(rate, impl=impl) if rate else None


# -- tensor parallelism (the TP path of a `DataParallel` step) --------------
def _block(param, tp, dim):
    """This rank's block of dimension ``dim`` of a parameter the TP path
    splits: the block the Parameter stores (`tp_param_shardings` cuts it
    on ``dim`` over the tensor-parallel axis)."""
    pl = param._placement
    if pl is None or pl.dim(tp[1]) != dim:
        raise MXNetError(f"tensor parallelism computes from {param.name}'s "
                         f"block: its spec must cut dimension {dim} over "
                         f"{tp[1]!r} alone (tp_param_shardings)")
    return param._stored()


def _tp_enter(x, tp):
    """Into a tensor-parallel region: Megatron's f, or, on a stream cut by
    rows (SP), the rows gathered whole."""
    mesh, axis = tp[:2]
    size = _layout.stream_len()
    if size is None:
        return _op("tp_copy", lambda t: _layout.copy_to(t, mesh, axis), x)
    return _op("sp_enter", lambda t: _layout.seq_enter(t, mesh, axis, size),
               x)


def _tp_exit(x, tp, bias=None):
    """Out of a tensor-parallel region: the partial results summed
    (Megatron's g), or, on a stream cut by rows, summed into the rank's
    rows; then ``bias`` (a Parameter), whose gradient on the rank's rows
    is its share."""
    mesh, axis = tp[:2]
    if _layout.stream_len() is None:
        y = _op("tp_reduce", lambda t: _layout.reduce_from(t, mesh, axis), x)
        return y if bias is None else y + bias.data()
    y = _op("sp_exit", lambda t: _layout.seq_exit(t, mesh, axis), x)
    return y if bias is None else y + _share(bias.data(), tp)


def _share(t, tp):
    """``t`` (a parameter's tensor) used on the rank's rows of a cut
    stream: its gradient is the rank's share, summed by the step."""
    def note(w):
        _layout.note_partial([w], tp[1])
        return w

    return _op("sp_share", note, t)


def _tp_dropout(drop, x, tp):
    """Dropout of an activation split over the axis: each rank's share
    draws its own mask (keys folded with the rank's index)."""
    if drop is None:
        return x
    from .. import random as _random

    with _random.fold_key_scope(tp[3]):
        return drop(x)


class MultiHeadAttention(HybridBlock):
    """Self-attention: through the flash kernels with dropout on the
    output, or (``use_flash=False``, or a dense ``mask``) as scores,
    masked softmax and dropout on the probabilities."""

    def __init__(self, units, num_heads, dropout=0.0, use_flash=True,
                 dtype="float32", device=None, impl="auto"):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._use_flash = use_flash
        self._impl = impl
        self.qkv = nn.Dense(3 * units, flatten=False, use_bias=True,
                            in_units=units, dtype=dtype, device=device)
        self.proj = nn.Dense(units, flatten=False, use_bias=True,
                             in_units=units, dtype=dtype, device=device)
        self.dropout = _dropout(dropout, impl)

    def _tp_forward(self, x, valid_length, tp):
        """Megatron's split: this rank's heads of q, k and v, flash
        attention on them, and proj on their columns, summed over the
        axis. The fused qkv weight's spec cuts its rows contiguously
        (``[q|k|v]``), so a block stored by it is not the rank's heads:
        the heads' rows of weight and bias come from their owners in one
        all-to-all (`parallel._layout.head_rows`)."""
        mesh, axis, n = tp[:3]
        C = x.shape[-1]
        H = self._num_heads
        if H % n:
            raise MXNetError(f"tensor parallelism: {H} heads do not split "
                             f"over {n} ranks")
        d, cl, hl = C // H, C // n, H // n
        h = _tp_enter(x, tp)
        N, T = h.shape[0], h.shape[1]
        rows = _op("qkv_heads", lambda w, b: _layout.head_rows(
            torch.cat([w, b.unsqueeze(1).to(w.dtype)], 1), 3 * C, 3, mesh,
            axis), _block(self.qkv.weight, tp, 0), _block(self.qkv.bias, tp,
                                                           0))
        w = _op("qkv_heads", lambda t: t[:, :C], rows)
        b = _op("qkv_heads", lambda t: t[:, C], rows)
        qkv = npx.fully_connected(h, w, b, num_hidden=3 * cl, flatten=False)
        q, k, v = _op("qkv_split",
                      lambda t: t.view(N, T, 3, hl, d).unbind(2), qkv)
        out = npx.flash_attention(q, k, v, valid_length=valid_length,
                                  layout="bthd", impl=self._impl)
        out = _tp_dropout(self.dropout, out.reshape(N, T, cl), tp)
        part = npx.fully_connected(out, _block(self.proj.weight, tp, 1),
                                   None, num_hidden=C, no_bias=True,
                                   flatten=False)
        return _tp_exit(part, tp, self.proj.bias)

    def forward(self, x, mask=None, valid_length=None):
        N, T, C = x.shape
        H = self._num_heads
        d = C // H
        tp = _layout.tp()
        if tp is not None:
            if not self._use_flash or mask is not None:
                raise MXNetError("tensor parallelism takes the flash path "
                                 "(use_flash=True, no dense mask)")
            return self._tp_forward(x, valid_length, tp)
        qkv = self.qkv(x)
        if self._use_flash and mask is None:
            # q, k, v stay views of the projection (the reference's
            # qkv[..., :C] etc.), read in place ("bthd")
            q, k, v = _op("qkv_split",
                          lambda t: t.view(N, T, 3, H, d).unbind(2), qkv)
            out = npx.flash_attention(q, k, v, valid_length=valid_length,
                                      layout="bthd", impl=self._impl)
            out = out.reshape(N, T, C)
            if self.dropout is not None:
                out = self.dropout(out)
            return self.proj(out)
        # (N, T, 3, H, d) -> three (N*H, T, d)
        q, k, v = _op("qkv_heads",
                      lambda t: t.reshape(N, T, 3, H, d).permute(2, 0, 3, 1, 4)
                      .reshape(3, N * H, T, d).unbind(0), qkv)
        if mask is None and valid_length is not None:
            mask = _dense_mask_from_valid_length(x, valid_length, H)
        scores = npx.batch_dot(q, k, transpose_b=True) / math.sqrt(d)
        if mask is not None:
            att = npx.masked_softmax(scores, mask)
        else:
            att = npx.softmax(scores, axis=-1)
        if self.dropout is not None:
            att = self.dropout(att)
        out = npx.batch_dot(att, v)  # (N*H, T, d)
        out = _op("heads_merge",
                  lambda t: t.reshape(N, H, T, d).transpose(1, 2)
                  .reshape(N, T, C), out)
        return self.proj(out)


def _dense_mask_from_valid_length(x, valid_length, num_heads):
    """(N*H, T, T) float32 pairwise validity mask from (N,) lengths: pair
    (i, j) is live where both i and j are below the length."""
    steps = npx.arange_like(x, axis=1)

    def f(s, vl):
        vl = vl.reshape(-1, 1, 1).float()
        m = s.reshape(1, -1, 1) < vl
        m2 = s.reshape(1, 1, -1) < vl
        return torch.repeat_interleave((m & m2).float(), num_heads, dim=0)

    return _op("dense_mask", f, steps, valid_length)


class PositionwiseFFN(HybridBlock):
    """``ffn2(dropout(act(ffn1(x))))``; ``activation="gelu"`` is the tanh
    approximation, as in the reference."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 dtype="float32", device=None, impl="auto"):
        super().__init__()
        self.ffn1 = nn.Dense(hidden_size, flatten=False, in_units=units,
                             dtype=dtype, device=device)
        self.ffn2 = nn.Dense(units, flatten=False, in_units=hidden_size,
                             dtype=dtype, device=device)
        self._activation = activation
        self._drop_rate = dropout
        self.dropout = _dropout(dropout, impl)

    def forward(self, x):
        tp = _layout.tp()
        if tp is not None:
            # Megatron's split: this rank's hidden units (ffn1's rows,
            # ffn2's columns), summed over the axis
            w1 = _block(self.ffn1.weight, tp, 0)
            h = npx.fully_connected(_tp_enter(x, tp), w1,
                                    _block(self.ffn1.bias, tp, 0),
                                    num_hidden=w1.shape[0], flatten=False)
            h = _tp_dropout(self.dropout,
                            npx.activation(h, act_type=self._activation), tp)
            part = npx.fully_connected(
                h, _block(self.ffn2.weight, tp, 1), None,
                num_hidden=x.shape[-1], no_bias=True, flatten=False)
            return _tp_exit(part, tp, self.ffn2.bias)
        h = npx.activation(self.ffn1(x), act_type=self._activation)
        if self.dropout is not None:
            h = self.dropout(h)
        return self.ffn2(h)


class TransformerEncoderCell(HybridBlock):
    """Transformer block: post-LN (BERT) through the fused residual +
    dropout + LayerNorm op, or pre-LN with ``pre_norm=True``."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 pre_norm=False, use_flash=True, dtype="float32",
                 device=None, impl="auto"):
        super().__init__()
        self._pre_norm = pre_norm
        self._drop_rate = dropout
        self._impl = impl
        self._seq_shard_axis = None   # set by BERTEncoder(seq_shard_axis=)
        self.attention = MultiHeadAttention(units, num_heads, dropout,
                                            use_flash=use_flash, dtype=dtype,
                                            device=device, impl=impl)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout, dtype=dtype,
                                   device=device, impl=impl)
        self.ln1 = nn.LayerNorm(in_channels=units, dtype=dtype,
                                device=device, impl=impl)
        self.ln2 = nn.LayerNorm(in_channels=units, dtype=dtype,
                                device=device, impl=impl)
        self.dropout = _dropout(dropout, impl)

    def _residual_ln(self, x, h, ln):
        # the post-LN residual site through the fused residual + dropout
        # + LayerNorm op (K3), on this rank's rows under sequence
        # parallelism
        def site(x, h, gamma, beta):
            return npx.residual_dropout_ln(x, h, gamma, beta,
                                           p=self._drop_rate,
                                           eps=ln._epsilon, impl=self._impl)

        return seq_region(site, (x, h), self._seq_shard_axis,
                          (ln.gamma.data(), ln.beta.data()),
                          local=_layout.stream_len() is not None)

    def forward(self, x, mask=None, valid_length=None):
        if self._pre_norm:
            h = self.attention(self.ln1(x), mask, valid_length)
            x = x + (self.dropout(h) if self.dropout else h)
            h = self.ffn(self.ln2(x))
            return x + (self.dropout(h) if self.dropout else h)
        x = self._residual_ln(x, self.attention(x, mask, valid_length),
                              self.ln1)
        return self._residual_ln(x, self.ffn(x), self.ln2)


class BERTEncoder(HybridBlock):
    """Token (+ token type) + position embedding → LayerNorm → dropout →
    N transformer cells."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512, dropout=0.1,
                 type_vocab_size=2, use_flash=True, seq_shard_axis=None,
                 batch_shard_axis="dp", dtype="float32", device=None,
                 impl="auto"):
        super().__init__()
        self._units = units
        self._use_flash = use_flash
        self._seq_shard_axis = seq_shard_axis
        self._batch_shard_axis = batch_shard_axis
        self.word_embed = nn.Embedding(vocab_size, units, dtype=dtype,
                                       device=device)
        self.token_type_embed = nn.Embedding(type_vocab_size, units,
                                             dtype=dtype, device=device)
        self.position_embed = Parameter(shape=(max_length, units),
                                        dtype=dtype, init="normal")
        self.position_embed._device_hint = device
        self.ln = nn.LayerNorm(in_channels=units, dtype=dtype, device=device,
                               impl=impl)
        self.dropout = _dropout(dropout, impl)
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerEncoderCell(
                units, hidden_size, num_heads, dropout, use_flash=use_flash,
                dtype=dtype, device=device, impl=impl))
        for cell in self.layers:
            cell._seq_shard_axis = seq_shard_axis

    def _embed(self, tokens):
        """The word embedding; under tensor parallelism this rank's rows of
        the vocabulary (the masked ids' lookup), summed over the axis
        (into the rank's rows of the sequence on a cut stream)."""
        tp = _layout.tp()
        if tp is None:
            return self.word_embed(tokens)
        p = self.word_embed.weight
        start, stop = _layout.bounds(p.shape[0], tp[3], tp[2])
        local = _op("tp_ids", lambda t: t.long() - start, tokens)
        keep = _op("tp_ids", lambda t: ((t >= 0) & (t < stop - start)),
                   local)
        ids = _op("tp_ids", lambda t, k: torch.where(k, t, 0), local, keep)
        x = npx.embedding(ids, _block(p, tp, 0), input_dim=stop - start,
                          output_dim=p.shape[1])
        x = _op("tp_mask", lambda e, k: e * k.unsqueeze(-1).to(e.dtype), x,
                keep)
        return _tp_exit(x, tp)

    def _embed_ln(self, x):
        # the embedding's LayerNorm (K4) and dropout, on this rank's rows
        # under sequence parallelism
        ln = self.ln

        def site(x, gamma, beta):
            x = npx.layer_norm(x, gamma, beta, axis=ln._axis,
                               eps=ln._epsilon, impl=ln._impl)
            return self.dropout(x) if self.dropout is not None else x

        return seq_region(site, (x,), self._seq_shard_axis,
                          (ln.gamma.data(), ln.beta.data()),
                          local=_layout.stream_len() is not None)

    def forward(self, tokens, token_types=None, valid_length=None):
        T = tokens.shape[1]
        if T > self.position_embed.shape[0]:
            raise ValueError(f"sequence length {T} exceeds max_length "
                             f"{self.position_embed.shape[0]}")
        tp = _layout.tp()
        # Megatron SP: under tensor parallelism over the sequence axis the
        # stream stays cut by rows of the sequence from the embedding's
        # exit to the encoder's output
        cut = (tp is not None and self._use_flash
               and self._seq_shard_axis == tp[1])
        with _layout.cut_stream(T if cut else None):
            x = self._embed(tokens)
            rows = (0, T)
            if cut:
                rows = _layout.bounds(T, tp[3], tp[2])

            def mine(t):
                return _op("sp_rows", lambda a: a.narrow(
                    1, rows[0], rows[1] - rows[0]), t)

            if token_types is not None:
                if cut:
                    _share(self.token_type_embed.weight.data(), tp)
                    token_types = mine(token_types)
                x = x + self.token_type_embed(token_types)
            pos = self.position_embed.data()
            if cut:
                pos = _share(pos, tp)
            x = x + pos[rows[0]:rows[1]]
            x = self._embed_ln(x)
            if self._use_flash:
                # (B,) lengths straight into the kernel, no dense mask
                for cell in self.layers:
                    x = cell(x, None, valid_length)
                if cut:
                    # the whole sequence for the heads (a replicated
                    # computation: the gradient is the rank's rows)
                    mesh, axis = tp[:2]
                    x = _op("sp_gather", lambda t: _layout.gather(
                        t, mesh, (axis,), 1, T), x)
                return x
        mask = None
        if valid_length is not None:
            H = self.layers[0].attention._num_heads
            mask = _dense_mask_from_valid_length(x, valid_length, H)
        for cell in self.layers:
            x = cell(x, mask)
        return x


class BERTModel(HybridBlock):
    """Encoder + MLM and NSP heads (the pretraining objective)."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512, dropout=0.1,
                 use_flash=True, seq_shard_axis=None, batch_shard_axis="dp",
                 dtype="float32", device=None, seed=None, impl="auto"):
        super().__init__()
        self._device = resolve_device(device)
        device = self._device
        self.encoder = BERTEncoder(vocab_size, units, hidden_size, num_layers,
                                   num_heads, max_length, dropout,
                                   use_flash=use_flash,
                                   seq_shard_axis=seq_shard_axis,
                                   batch_shard_axis=batch_shard_axis,
                                   dtype=dtype, device=device, impl=impl)
        self.mlm_dense = nn.Dense(units, flatten=False, activation="tanh",
                                  in_units=units, dtype=dtype, device=device)
        self.mlm_ln = nn.LayerNorm(in_channels=units, dtype=dtype,
                                   device=device, impl=impl)
        self.mlm_decoder = nn.Dense(vocab_size, flatten=False,
                                    in_units=units, dtype=dtype,
                                    device=device)
        self.nsp = nn.Dense(2, in_units=units, dtype=dtype, device=device)
        if seed is not None:
            init_seeded(self, seed)

    @property
    def device(self):
        """The parameters' device (the ``device=`` given until they are
        made)."""
        p = self.position_embed if hasattr(self, "position_embed") \
            else self.encoder.position_embed
        return p._data._data.device if p._data is not None else self._device

    def load_jax_params(self, params):
        """Copy weights from ``{name: numpy array}`` keyed by the
        reference model's ``collect_params()`` names (see
        :func:`params.load_params`)."""
        load_params(self, params)

    @property
    def supports_tensor_parallel(self):
        """`parallel.DataParallel` splits this model's compute over the
        axis of `tp_param_shardings` (the flash path)."""
        return self.encoder._use_flash

    def _decode(self, h):
        """The MLM decoder; under tensor parallelism this rank's rows of
        the vocabulary, the scores gathered whole (the softmax needs the
        whole row)."""
        tp = _layout.tp()
        if tp is None:
            return self.mlm_decoder(h)
        mesh, axis = tp[:2]
        w = _block(self.mlm_decoder.weight, tp, 0)
        local = npx.fully_connected(
            _tp_enter(h, tp), w, _block(self.mlm_decoder.bias, tp, 0),
            num_hidden=w.shape[0], flatten=False)
        vocab = self.mlm_decoder.weight.shape[0]
        return _op("tp_gather", lambda t: _layout.gather(
            t, mesh, (axis,), t.dim() - 1, vocab), local)

    def forward(self, tokens, token_types=None, valid_length=None):
        seq = self.encoder(tokens, token_types, valid_length)
        mlm_scores = self._decode(self.mlm_ln(self.mlm_dense(seq)))
        nsp_scores = self.nsp(seq[:, 0])
        return mlm_scores, nsp_scores


class BERTClassifier(HybridBlock):
    """A classification head over an encoder: dropout, then a Dense of
    ``num_classes`` over the first token's state. The classifier's input
    width is deferred, as in the reference (call ``initialize()``, or pass
    ``seed=`` for the head's weights)."""

    def __init__(self, encoder, num_classes=2, dropout=0.1, dtype="float32",
                 device=None, seed=None, impl="auto"):
        super().__init__()
        self.encoder = encoder
        self.dropout = nn.Dropout(dropout, impl=impl)
        self.classifier = nn.Dense(
            num_classes, dtype=dtype,
            device=self.device if device is None else device)
        if seed is not None:
            self.classifier.weight.shape = (num_classes, encoder._units)
            self.classifier.bias.shape = (num_classes,)
            with generator_scope(make_generator(self.device, seed)):
                for p in (self.classifier.weight, self.classifier.bias):
                    p.initialize(force_reinit=True)

    @property
    def device(self):
        """The encoder's parameters' device."""
        p = self.encoder.position_embed
        return p._data._data.device if p._data is not None else \
            resolve_device(p._device_hint)

    def load_jax_params(self, params):
        """Copy weights from ``{name: numpy array}`` keyed by the
        reference model's ``collect_params()`` names."""
        load_params(self, params)

    def forward(self, tokens, token_types=None, valid_length=None):
        seq = self.encoder(tokens, token_types, valid_length)
        pooled = seq[:, 0]
        return self.classifier(self.dropout(pooled))


def bert_base(vocab_size=30522, max_length=512, dropout=0.1, use_flash=True,
              seq_shard_axis=None, dtype="float32", device=None, seed=None,
              impl="auto"):
    """BERT-base: 768 units, 12 layers, 12 heads, FFN 3072."""
    return BERTModel(vocab_size, 768, 3072, 12, 12, max_length, dropout,
                     use_flash=use_flash, seq_shard_axis=seq_shard_axis,
                     dtype=dtype, device=device, seed=seed, impl=impl)


def bert_small(vocab_size=1000, max_length=128, dropout=0.1, use_flash=True,
               seq_shard_axis=None, dtype="float32", device=None, seed=None,
               impl="auto"):
    """Tiny config for tests: 64 units, 2 layers, 4 heads, FFN 128."""
    return BERTModel(vocab_size, 64, 128, 2, 4, max_length, dropout,
                     use_flash=use_flash, seq_shard_axis=seq_shard_axis,
                     dtype=dtype, device=device, seed=seed, impl=impl)
