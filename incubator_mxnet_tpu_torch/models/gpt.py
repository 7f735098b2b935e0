"""Decoder-only causal language model (GPT-2 layout), port of
`incubator_mxnet_tpu/models/gpt.py`.

Token + position embedding → N pre-norm blocks (LayerNorm kernel, fused
QKV projection, causal flash-attention kernel, tanh-gelu FFN) → final
LayerNorm → LM head tied to the token embedding (GPT-2). Parameter names match the reference's
``collect_params()`` one to one, so :meth:`GPTModel.load_jax_params`
carries a reference model's weights across.

Entry points (`gpt2_small`, `gpt_tiny`, `GPTModel`) build on the card by
default and raise when there is none, unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import math

import numpy as onp
import torch
import torch.nn.functional as F
from torch import nn

from .. import numpy_extension as npx
from ..base import MXNetError
from ..device import resolve_device
from ..gluon import nn as gnn
from .bert import PositionwiseFFN, check_no_dropout
from .decoding import GPTDecoder, make_generator, sample

__all__ = ["CausalSelfAttention", "GPTBlock", "GPTModel", "gpt2_small",
           "gpt_tiny"]


class CausalSelfAttention(nn.Module):
    def __init__(self, units, num_heads, dtype="float32", device=None):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        self.qkv = gnn.Dense(3 * units, flatten=False, in_units=units,
                             dtype=dtype, device=device)
        self.proj = gnn.Dense(units, flatten=False, in_units=units,
                              dtype=dtype, device=device)

    def forward(self, x):
        N, T, C = x.shape
        H = self._num_heads
        d = C // H
        # q, k, v stay views of the projection, read in place ("bthd")
        q, k, v = self.qkv(x).view(N, T, 3, H, d).unbind(2)
        out = npx.flash_attention(q, k, v, causal=True,
                                  sm_scale=1.0 / math.sqrt(d), layout="bthd")
        return self.proj(out.reshape(N, T, C))


class GPTBlock(nn.Module):
    """Pre-norm residual block (the GPT-2 layout)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 dtype="float32", device=None):
        super().__init__()
        self.ln1 = gnn.LayerNorm(in_channels=units, dtype=dtype,
                                 device=device)
        self.attn = CausalSelfAttention(units, num_heads, dtype=dtype,
                                        device=device)
        self.ln2 = gnn.LayerNorm(in_channels=units, dtype=dtype,
                                 device=device)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                   activation="gelu", dtype=dtype,
                                   device=device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.ffn(self.ln2(x))


class GPTModel(nn.Module):
    """Token+position embed → N pre-norm blocks → final LN → tied LM head.

    Weights are initialised as the reference's defaults (uniform ±0.07,
    position embedding normal with sigma 0.01, LN gamma 1 / beta 0) from a
    `torch.Generator` seeded by ``seed``.
    """

    def __init__(self, vocab_size, units, hidden_size, num_layers,
                 num_heads, max_length, dropout=0.1, dtype="float32",
                 device=None, seed=None):
        super().__init__()
        device = resolve_device(device)
        self._dropout = dropout
        self.word_embed = gnn.Embedding(vocab_size, units, dtype=dtype,
                                        device=device)
        self.position_embed = nn.Parameter(torch.empty(
            (max_length, units), dtype=self.word_embed.weight.dtype,
            device=device))
        self.blocks = gnn.HybridSequential()
        for _ in range(num_layers):
            self.blocks.add(GPTBlock(units, hidden_size, num_heads, dropout,
                                     dtype=dtype, device=device))
        self.ln_f = gnn.LayerNorm(in_channels=units, dtype=dtype,
                                  device=device)
        self.initialize(seed)

    @property
    def device(self):
        return self.position_embed.device

    @property
    def max_length(self):
        return self.position_embed.shape[0]

    def initialize(self, seed=None):
        """(Re)initialise every parameter from a generator seeded by
        ``seed`` (a fresh nondeterministic seed when None)."""
        gen = make_generator(self.device, seed)
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator=gen)
        with torch.no_grad():
            self.position_embed.normal_(0.0, 0.01, generator=gen)

    def load_jax_params(self, params):
        """Copy weights from ``{name: numpy array}`` keyed by the
        reference model's ``collect_params()`` names. Raises, copying
        nothing, on a missing or extra name or a wrong shape."""
        own = dict(self.named_parameters())
        missing = sorted(set(own) - set(params))
        extra = sorted(set(params) - set(own))
        if missing or extra:
            raise MXNetError(f"load_jax_params: missing {missing}, "
                             f"unexpected {extra}")
        arrays = {}
        for name, arr in params.items():
            arr = onp.array(arr, copy=True)
            if tuple(arr.shape) != tuple(own[name].shape):
                raise MXNetError(
                    f"load_jax_params: {name} has shape {arr.shape}, the "
                    f"model expects {tuple(own[name].shape)}")
            arrays[name] = arr
        with torch.no_grad():
            for name, arr in arrays.items():
                own[name].copy_(torch.from_numpy(arr))

    def forward(self, tokens):
        N, T = tokens.shape
        if T > self.max_length:
            raise ValueError(f"sequence length {T} exceeds max_length "
                             f"{self.max_length}")
        check_no_dropout(self, self._dropout)
        x = self.word_embed(tokens) + self.position_embed[:T]
        x = self.ln_f(self.blocks(x))
        return F.linear(x, self.word_embed.weight)  # tied: h @ E^T

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens, temperature=1.0, top_k=None,
                 do_sample=False, seed=None, use_cache=True):
        """Generate continuations of ``tokens`` (N, T0); returns
        (N, T0 + max_new_tokens) int64 ids.

        ``use_cache=True`` (default) runs the KV-cache decoder
        (`models/decoding.py`): O(T) work per token. ``use_cache=False``
        keeps the full-forward loop (O(T²); the parity reference for
        tests). Greedy unless ``do_sample=True``, which draws from the
        temperature-scaled, optionally top-k-truncated distribution with a
        `torch.Generator` seeded by ``seed``.
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
        for _ in range(max_new_tokens):
            logits = self(out)[:, -1]
            nxt = sample(logits, gen, temperature, top_k, do_sample)
            out = torch.cat([out, nxt[:, None]], dim=1)
        return out


def gpt2_small(vocab_size=50257, max_length=1024, dropout=0.1,
               dtype="float32", device=None, seed=None):
    """GPT-2 124M configuration."""
    return GPTModel(vocab_size, 768, 3072, 12, 12, max_length, dropout,
                    dtype=dtype, device=device, seed=seed)


def gpt_tiny(vocab_size=1000, max_length=128, dropout=0.1, dtype="float32",
             device=None, seed=None):
    """Tiny config for tests and compile checks."""
    return GPTModel(vocab_size, 64, 128, 2, 4, max_length, dropout,
                    dtype=dtype, device=device, seed=seed)
