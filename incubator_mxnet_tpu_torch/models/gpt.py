"""Decoder-only causal language model (GPT-2 layout), port of
`incubator_mxnet_tpu/models/gpt.py`.

Token + position embedding → dropout → N pre-norm blocks (LayerNorm
kernel, fused QKV projection, causal flash-attention kernel, dropout on
the attention output and on the tanh-gelu FFN's hidden) → final
LayerNorm → LM head tied to the token embedding (GPT-2). The blocks are
the reference's `HybridBlock`s and take NDArrays or torch tensors (see
`models/bert.py`); dropout (the dropout kernel) applies where
``autograd.is_training()`` says, as the reference's does. Parameter
names are the reference's ``collect_params()`` names, so
:meth:`GPTModel.load_jax_params` carries a reference model's weights
across.

The port's extras are `models/bert.py`'s: ``device=`` (the entry points
build on the card by default and raise when there is none, unless
``device="cpu"`` is passed), ``dtype=`` and ``seed=`` (initialised from
a generator seeded by it; without one the model waits for
``initialize()``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import autograd
from .. import numpy_extension as npx
from ..device import resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.parameter import Parameter
from ..numpy_extension import _op
from .bert import PositionwiseFFN
from .decoding import GPTDecoder, make_generator, sample
from .params import init_seeded, load_params

__all__ = ["CausalSelfAttention", "GPTBlock", "GPTModel", "gpt2_small",
           "gpt_tiny"]


class CausalSelfAttention(HybridBlock):
    def __init__(self, units, num_heads, dropout=0.0, dtype="float32",
                 device=None):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        self.qkv = nn.Dense(3 * units, flatten=False, use_bias=True,
                            in_units=units, dtype=dtype, device=device)
        self.proj = nn.Dense(units, flatten=False, use_bias=True,
                             in_units=units, dtype=dtype, device=device)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        N, T, C = x.shape
        H = self._num_heads
        d = C // H
        # q, k, v stay views of the projection, read in place ("bthd")
        q, k, v = _op("qkv_split",
                      lambda t: t.view(N, T, 3, H, d).unbind(2), self.qkv(x))
        out = npx.flash_attention(q, k, v, causal=True,
                                  sm_scale=1.0 / math.sqrt(d), layout="bthd")
        out = out.reshape(N, T, C)
        if self.dropout is not None:
            out = self.dropout(out)
        return self.proj(out)


class GPTBlock(HybridBlock):
    """Pre-norm residual block (the GPT-2 layout)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 dtype="float32", device=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(in_channels=units, dtype=dtype, device=device)
        self.attn = CausalSelfAttention(units, num_heads, dropout,
                                        dtype=dtype, device=device)
        self.ln2 = nn.LayerNorm(in_channels=units, dtype=dtype, device=device)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                   activation="gelu", dtype=dtype,
                                   device=device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.ffn(self.ln2(x))


class GPTModel(HybridBlock):
    """Token+position embed → N pre-norm blocks → final LN → LM head: tied
    to the token embedding (GPT-2), or with ``tie_weights=False`` its own
    ``lm_head``, a bias-free Dense, as in the reference."""

    def __init__(self, vocab_size, units, hidden_size, num_layers,
                 num_heads, max_length, dropout=0.1, tie_weights=True,
                 dtype="float32", device=None, seed=None):
        super().__init__()
        self._device = resolve_device(device)
        device = self._device
        self._tie = tie_weights
        self.word_embed = nn.Embedding(vocab_size, units, dtype=dtype,
                                       device=device)
        self.position_embed = Parameter(shape=(max_length, units),
                                        dtype=dtype, init="normal")
        self.position_embed._device_hint = device
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.blocks = nn.HybridSequential()
        for _ in range(num_layers):
            self.blocks.add(GPTBlock(units, hidden_size, num_heads, dropout,
                                     dtype=dtype, device=device))
        self.ln_f = nn.LayerNorm(in_channels=units, dtype=dtype,
                                 device=device)
        if not tie_weights:
            self.lm_head = nn.Dense(vocab_size, flatten=False,
                                    use_bias=False, in_units=units,
                                    dtype=dtype, device=device)
        if seed is not None:
            init_seeded(self, seed)

    @property
    def device(self):
        """The parameters' device (the ``device=`` given until they are
        made)."""
        p = self.position_embed if hasattr(self, "position_embed") \
            else self.encoder.position_embed
        return p._data._data.device if p._data is not None else self._device

    @property
    def max_length(self):
        return self.position_embed.shape[0]

    def load_jax_params(self, params):
        """Copy weights from ``{name: numpy array}`` keyed by the
        reference model's ``collect_params()`` names (see
        :func:`params.load_params`)."""
        load_params(self, params)

    def forward(self, tokens):
        N, T = tokens.shape
        if T > self.max_length:
            raise ValueError(f"sequence length {T} exceeds max_length "
                             f"{self.max_length}")
        x = self.word_embed(tokens) + self.position_embed.data()[:T]
        if self.dropout is not None:
            x = self.dropout(x)
        x = self.ln_f(self.blocks(x))
        if self._tie:
            # weight tying (GPT-2): logits = h @ E^T
            return _op("tied_head", F.linear, x,
                       self.word_embed.weight.data())
        return self.lm_head(x)

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens, temperature=1.0, top_k=None,
                 do_sample=False, seed=None, use_cache=True):
        """Generate continuations of ``tokens`` (N, T0); returns
        (N, T0 + max_new_tokens) int64 ids.

        ``use_cache=True`` (default) runs the KV-cache decoder
        (`models/decoding.py`): O(T) work per token. ``use_cache=False``
        keeps the full-forward loop (O(T²); the parity reference for
        tests), run under ``autograd.predict_mode()``: generation never
        drops out. Greedy unless ``do_sample=True``, which draws from the
        temperature-scaled, optionally top-k-truncated distribution with
        a `torch.Generator` seeded by ``seed``.
        """
        if use_cache:
            return GPTDecoder(self).generate(
                tokens, max_new_tokens, temperature=temperature,
                top_k=top_k, do_sample=do_sample, seed=seed)
        out = torch.as_tensor(tokens, device=self.device).long()
        if out.shape[1] + max(max_new_tokens, 0) > self.max_length:
            raise ValueError(
                f"prompt ({out.shape[1]}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_length ({self.max_length})")
        gen = make_generator(self.device, seed) if do_sample else None
        with autograd.predict_mode():
            for _ in range(max_new_tokens):
                logits = self(out)[:, -1]
                nxt = sample(logits, gen, temperature, top_k, do_sample)
                out = torch.cat([out, nxt[:, None]], dim=1)
        return out


def gpt2_small(vocab_size=50257, max_length=1024, dropout=0.1,
               dtype="float32", device=None, seed=None, tie_weights=True):
    """GPT-2 124M configuration."""
    return GPTModel(vocab_size, 768, 3072, 12, 12, max_length, dropout,
                    tie_weights=tie_weights, dtype=dtype, device=device,
                    seed=seed)


def gpt_tiny(vocab_size=1000, max_length=128, dropout=0.1, dtype="float32",
             device=None, seed=None, tie_weights=True):
    """Tiny config for tests and compile checks."""
    return GPTModel(vocab_size, 64, 128, 2, 4, max_length, dropout,
                    tie_weights=tie_weights, dtype=dtype, device=device,
                    seed=seed)
