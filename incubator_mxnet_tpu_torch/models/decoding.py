"""KV-cache incremental decoding for causal LMs (the serving path).

Port of `incubator_mxnet_tpu/models/decoding.py` (`bucket_prompt` :45,
`chunk_buckets` :83, `bucket_chunk` :107, `GPTDecoder` :155,
`NgramProposer` :436). The reference compiles the whole decode as one XLA
program; the port runs eagerly on the card:

- a static KV cache ``(L, N, H, S, d)`` allocated once per call and
  written in place (S = bucket-padded prompt + new tokens);
- prefill = per layer, the LayerNorm kernel, the fused QKV projection,
  the flash-attention kernel (causal, reading q/k/v in place from the
  projection's (N, T, 3, H, d) output), and a write of the prompt's K/V
  into the cache; the logits come from the last REAL token (``t0 - 1``);
- decode = a Python loop over steps and layers; each step runs a
  one-token forward against the cache. Its attention is plain torch (a
  masked f32 softmax over the cache), as the reference computes it
  outside any kernel; its LayerNorms are the LayerNorm kernel;
- sampling (greedy, or temperature / top-k) draws from a
  `torch.Generator` seeded by ``seed=``.

The layer math mirrors `GPTModel.forward` (pre-norm blocks, tanh-gelu
FFN, the tied LM head or the model's ``lm_head``), so greedy decode emits the tokens of the full-forward
loop. ``impl`` ("auto" | "kernel" | "plain") is handed to both kernels'
wrappers; "plain" runs the same path on the plain versions, which is
what the kernels are held against on the card.

`NgramProposer` is the host draft source of the serving engine's
speculative decoding (numpy, no device work).
"""
from __future__ import annotations

import math

import numpy as onp
import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from ..ops.layer_norm import layer_norm

__all__ = ["GPTDecoder", "NgramProposer", "bucket_prompt", "PROMPT_BUCKETS",
           "chunk_buckets", "bucket_chunk", "sample", "make_generator"]

#: Default pad-to-bucket prompt lengths (as in the reference): prompts
#: snap to the smallest bucket that holds them, so the cache shapes and
#: kernel launch shapes come from a small set.
PROMPT_BUCKETS = (32, 64, 128, 256, 512)


def bucket_prompt(ids, buckets=PROMPT_BUCKETS, max_len=None, pad_id=0):
    """Pad token ids (N, T) on the right to the smallest bucket >= T.

    Returns ``(padded_ids, t0)`` where ``t0`` is the true prompt length.
    The padded positions' K/V are causally invisible to the last real
    token and are overwritten by decode before the attention mask admits
    them, so any valid id works as filler. Prompts longer than every
    bucket are returned unpadded; ``max_len`` caps the chosen bucket.
    """
    ids = torch.as_tensor(ids)
    if ids.dim() != 2:
        raise ValueError(f"bucket_prompt expects (N, T) ids, got shape "
                         f"{tuple(ids.shape)}")
    t0 = ids.shape[1]
    fits = sorted(b for b in buckets
                  if b >= t0 and (max_len is None or b <= max_len))
    if not fits or fits[0] == t0:
        return ids, t0
    return F.pad(ids, (0, fits[0] - t0), value=pad_id), t0


def chunk_buckets(page_tokens, prefill_chunk):
    """Chunk-length buckets of the paged serving prefill
    (`serve.SlotDecoder`): power-of-two multiples of ``page_tokens`` below
    ``prefill_chunk``, plus ``prefill_chunk`` itself. Every chunk is a
    whole number of pages, so chunk writes land on page boundaries and the
    prefill's launch shapes come from len(buckets) sizes."""
    pt = int(page_tokens)
    chunk = int(prefill_chunk)
    if pt < 1:
        raise ValueError(f"page_tokens must be >= 1, got {pt}")
    if chunk % pt:
        raise ValueError(
            f"prefill_chunk ({chunk}) must be a multiple of page_tokens "
            f"({pt}) so chunks stay page-aligned")
    out = set()
    b = pt
    while b < chunk:
        out.add(b)
        b *= 2
    out.add(chunk)
    return tuple(sorted(out))


def bucket_chunk(n, buckets):
    """Smallest chunk bucket >= n (a prompt's last prefill chunk is padded
    up to it)."""
    fits = [b for b in buckets if b >= n]
    if not fits:
        raise ValueError(f"chunk of {n} tokens exceeds every bucket "
                         f"{tuple(buckets)}")
    return min(fits)


def _t(param):
    """The tensor of a gluon Parameter (the decoder reads the model's
    tensors directly, outside any block call)."""
    return param.data()._data


def make_generator(device, seed=None):
    """A `torch.Generator` on ``device``, seeded by ``seed`` (or from a
    fresh nondeterministic seed when ``seed`` is None)."""
    gen = torch.Generator(device=device)
    if seed is None:
        gen.seed()
    else:
        gen.manual_seed(int(seed))
    return gen


def sample(logits, generator=None, temperature=1.0, top_k=None,
           do_sample=False):
    """Next token ids (N,) from logits (N, V): greedy ``argmax``, or a
    draw from the temperature-scaled, optionally top-k-truncated
    distribution."""
    if not do_sample:
        return logits.argmax(dim=-1)
    logits = logits.float() / max(temperature, 1e-6)
    if top_k is not None:
        vals, idx = torch.topk(logits, int(top_k), dim=-1)
        choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                                   generator=generator)
        return idx.gather(-1, choice)[:, 0]
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


def _gelu(x):
    # the reference's jax.nn.gelu default: tanh approximation
    return F.gelu(x, approximate="tanh")


class GPTDecoder:
    """KV-cache text generation over a `GPTModel`.

    Parameters are read from the model's modules at every call, so
    updates to the model are always seen (`refresh` is kept for API
    parity and does nothing).
    """

    def __init__(self, model, impl="auto"):
        self._model = model
        self._impl = impl
        self._n_heads = model.blocks[0].attn._num_heads
        self._units = model.blocks[0].attn._units
        self._max_length = int(model.position_embed.shape[0])

    def refresh(self):
        """No-op: parameters are read from the model at every call."""

    # -- math ---------------------------------------------------------------

    def _ln(self, x, ln):
        return layer_norm(x, _t(ln.gamma), _t(ln.beta), eps=ln._epsilon,
                          impl=self._impl)

    def _logits(self, x):
        m = self._model
        head = m.word_embed.weight if m._tie else m.lm_head.weight
        return F.linear(self._ln(x, m.ln_f), _t(head))

    def _ffn(self, x, blk):
        f = blk.ffn
        h = self._ln(x, blk.ln2)
        h = _gelu(F.linear(h, _t(f.ffn1.weight), _t(f.ffn1.bias)))
        return x + F.linear(h, _t(f.ffn2.weight), _t(f.ffn2.bias))

    def _qkv(self, x, blk):
        """(N, T, C) -> q, k, v views (N, T, H, d) of the fused
        projection."""
        N, T, C = x.shape
        a = blk.attn
        h = self._ln(x, blk.ln1)
        qkv = F.linear(h, _t(a.qkv.weight), _t(a.qkv.bias))
        return qkv.view(N, T, 3, self._n_heads, C // self._n_heads).unbind(2)

    def _prefill_layer(self, x, blk):
        """Full-prompt causal attention; returns (x', k, v) with k, v
        (N, T, H, d)."""
        N, T, C = x.shape
        q, k, v = self._qkv(x, blk)
        o = flash_attention(q, k, v, causal=True,
                            sm_scale=1.0 / math.sqrt(q.shape[-1]),
                            impl=self._impl, layout="bthd")
        a = blk.attn
        x = x + F.linear(o.reshape(N, T, C), _t(a.proj.weight),
                         _t(a.proj.bias))
        return self._ffn(x, blk), k, v

    def _decode_layer(self, x, blk, ck, cv, pos):
        """One-token forward against the layer's cache (N, H, S, d);
        writes this token's k/v at ``pos``."""
        N, _, C = x.shape
        q, k, v = self._qkv(x, blk)
        ck[:, :, pos] = k[:, 0]
        cv[:, :, pos] = v[:, 0]
        # attend to positions 0..pos; later slots hold zeros or stale
        # values that the mask excludes (f32 scores for a stable softmax)
        s = torch.matmul(q.transpose(1, 2).float(),
                         ck.float().transpose(-1, -2))
        s = s / math.sqrt(q.shape[-1])
        mask = torch.arange(ck.shape[2], device=ck.device) <= pos
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1).to(cv.dtype)
        o = torch.matmul(p, cv).transpose(1, 2).reshape(N, 1, C)
        a = blk.attn
        x = x + F.linear(o, _t(a.proj.weight), _t(a.proj.bias))
        return self._ffn(x, blk)

    def _prefill(self, tokens, t0, ck, cv):
        """Prompt pass over the padded (N, B) ``tokens``; fills the cache
        at positions 0..B-1 and returns the logits (N, V) of the last real
        token."""
        m = self._model
        B = tokens.shape[1]
        x = _t(m.word_embed.weight)[tokens] + _t(m.position_embed)[:B]
        for layer, blk in enumerate(m.blocks):
            x, k, v = self._prefill_layer(x, blk)
            ck[layer, :, :, :B] = k.transpose(1, 2)
            cv[layer, :, :, :B] = v.transpose(1, 2)
        return self._logits(x[:, t0 - 1])

    def _step(self, tok, pos, ck, cv):
        """Feed token ids (N,) at position ``pos``; returns logits (N, V)."""
        m = self._model
        x = (_t(m.word_embed.weight)[tok][:, None]
             + _t(m.position_embed)[pos:pos + 1])
        for layer, blk in enumerate(m.blocks):
            x = self._decode_layer(x, blk, ck[layer], cv[layer], pos)
        return self._logits(x[:, 0])

    # -- entry points -------------------------------------------------------

    def _start(self, tokens, n_new):
        """Validated (N, T0) token ids on the model's device, the padded
        prompt, its true length and a zeroed KV cache for ``n_new`` more
        positions."""
        m = self._model
        toks = torch.as_tensor(tokens, device=m.device).long()
        if toks.dim() != 2:
            raise ValueError(f"tokens must be (N, T), got "
                             f"{tuple(toks.shape)}")
        T0 = toks.shape[1]
        if T0 + n_new > self._max_length:
            raise ValueError(f"prompt ({T0}) + new tokens ({n_new}) exceeds "
                             f"max_length ({self._max_length})")
        padded, t0 = bucket_prompt(toks, max_len=self._max_length)
        N, H = toks.shape[0], self._n_heads
        shape = (len(m.blocks), N, H, padded.shape[1] + n_new,
                 self._units // H)
        ck = torch.zeros(shape, dtype=_t(m.position_embed).dtype,
                         device=m.device)
        return toks, padded, t0, ck, torch.zeros_like(ck)

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens, temperature=1.0, top_k=None,
                 do_sample=False, seed=None):
        """Generate ``max_new_tokens`` continuations of ``tokens`` (N, T0);
        returns (N, T0 + max_new_tokens) int64 ids.

        Greedy by default; ``do_sample=True`` draws from the
        temperature-scaled (optionally top-k-truncated) distribution with a
        `torch.Generator` seeded by ``seed``. The prompt is padded to a
        :data:`PROMPT_BUCKETS` bucket first.
        """
        if max_new_tokens <= 0:
            return torch.as_tensor(tokens, device=self._model.device).long()
        toks, padded, t0, ck, cv = self._start(tokens, max_new_tokens)
        gen = (make_generator(toks.device, seed) if do_sample else None)

        def pick(logits):
            return sample(logits, gen, temperature, top_k, do_sample)

        tok = pick(self._prefill(padded, t0, ck, cv))
        out = [tok]
        for i in range(max_new_tokens - 1):
            tok = pick(self._step(tok, t0 + i, ck, cv))
            out.append(tok)
        return torch.cat([toks, torch.stack(out, dim=1)], dim=1)

    @torch.no_grad()
    def score(self, tokens, continuation):
        """Teacher-forced logits (N, M, V) of a continuation (N, M) through
        the KV-cache path: ``[:, 0]`` from the prompt's prefill, ``[:, i]``
        after feeding ``continuation[:, i - 1]``."""
        cont = torch.as_tensor(continuation, device=self._model.device).long()
        n_new = cont.shape[1]
        _, padded, t0, ck, cv = self._start(tokens, n_new)
        logits = [self._prefill(padded, t0, ck, cv)]
        for i in range(n_new - 1):
            logits.append(self._step(cont[:, i], t0 + i, ck, cv))
        return torch.stack(logits, dim=1)


class NgramProposer:
    """Model-free draft source for speculative decoding.

    Proposes the ``k`` tokens that followed the most recent earlier
    occurrence of the sequence's longest matching suffix n-gram (up to
    ``max_ngram`` tokens): greedy decode of small models, and structured
    output generally, repeats itself, so a host suffix match drafts useful
    continuations with no device work. When nothing matches it proposes
    a repeat of the last token.

    A proposal is only a hint: the target model verifies every drafted
    token (`serve.SlotDecoder.spec_verify_step`), so a bad draft costs
    acceptance rate, never correctness.
    """

    def __init__(self, k, max_ngram=3):
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.max_ngram = int(max_ngram)
        if self.max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")

    def propose(self, seq):
        """Draft ``k`` tokens continuing the 1-D token ids ``seq`` (prompt
        and everything generated so far). Returns ``(k,)`` int32 numpy."""
        seq = onp.asarray(seq, onp.int32).reshape(-1)
        if seq.size == 0:
            return onp.zeros(self.k, onp.int32)
        out = onp.full(self.k, seq[-1], onp.int32)     # fallback: repeat
        for n in range(min(self.max_ngram, seq.size - 1), 0, -1):
            pat = seq[-n:]
            # candidate windows strictly before the suffix itself
            wins = onp.lib.stride_tricks.sliding_window_view(seq, n)[:-1]
            hits = onp.flatnonzero((wins == pat).all(axis=1))
            if hits.size == 0:
                continue
            i = int(hits[-1])                          # most recent match
            cont = seq[i + n:i + n + self.k]
            if cont.size == 0:
                continue
            out[:cont.size] = cont
            out[cont.size:] = cont[-1]
            return out
        return out
