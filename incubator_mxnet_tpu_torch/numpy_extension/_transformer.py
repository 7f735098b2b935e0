"""``npx``'s transformer contrib ops (port of
`incubator_mxnet_tpu/numpy_extension/_transformer.py`): the interleaved
projection products (:38-110), `div_sqrt_dim` :112 and Longformer's
sliding-window attention (:129-202).

Each is a reshape and an einsum (cuBLAS on the card) or a gather, as the
reference's are jnp compositions with no Pallas kernel; autograd gives
the backward the reference takes from ``jax.vjp``. The sliding-window
ops gather the (2w+1)-wide band, O(T·w) memory as in the reference. Under
AMP the two self-attention products take the target dtype (their names
are in AMP's lists, as the reference's are).
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
    "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
    "div_sqrt_dim", "sldwin_atten_score", "sldwin_atten_context",
    "sldwin_atten_mask_like",
]


def _op(name, fn, *args):
    from . import _op as op

    return op(name, fn, *args)


def interleaved_matmul_selfatt_qk(queries_keys_values, heads):
    """``Q @ Kᵀ / sqrt(head_dim)`` over an interleaved projection (seq,
    batch, 3·embed) whose last axis holds per-head [q | k | v] blocks;
    output (batch·heads, seq, seq), batch-major."""
    def fn(qkv):
        t, b, e3 = qkv.shape
        hd = e3 // 3 // heads
        x = qkv.reshape(t, b, heads, 3, hd)
        att = torch.einsum("tbhd,sbhd->bhts", x[..., 0, :], x[..., 1, :])
        return (att / math.sqrt(hd)).reshape(b * heads, t, t)

    return _op("interleaved_matmul_selfatt_qk", fn, queries_keys_values)


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, heads):
    """``attention @ V`` over the interleaved projection: (seq, batch,
    3·embed) and (batch·heads, seq, seq) to (seq, batch, embed)."""
    def fn(qkv, att):
        t, b, e3 = qkv.shape
        hd = e3 // 3 // heads
        v = qkv.reshape(t, b, heads, 3, hd)[..., 2, :]
        a = att.reshape(b, heads, t, t)
        return torch.einsum("bhts,sbhd->tbhd", a, v).reshape(t, b,
                                                             heads * hd)

    return _op("interleaved_matmul_selfatt_valatt", fn, queries_keys_values,
               attention)


def interleaved_matmul_encdec_qk(queries, keys_values, heads):
    """Encoder-decoder scores: queries (seq_q, batch, embed), an
    interleaved per-head [k | v] projection (seq_kv, batch, 2·embed);
    output (batch·heads, seq_q, seq_kv)."""
    def fn(q, kv):
        tq, b, e = q.shape
        hd = e // heads
        qh = q.reshape(tq, b, heads, hd)
        k = kv.reshape(kv.shape[0], b, heads, 2, hd)[..., 0, :]
        att = torch.einsum("tbhd,sbhd->bhts", qh, k) / math.sqrt(hd)
        return att.reshape(b * heads, tq, kv.shape[0])

    return _op("interleaved_matmul_encdec_qk", fn, queries, keys_values)


def interleaved_matmul_encdec_valatt(keys_values, attention, heads):
    """``attention @ V`` for encoder-decoder attention: output (seq_q,
    batch, embed)."""
    def fn(kv, att):
        tk, b, e2 = kv.shape
        hd = e2 // 2 // heads
        v = kv.reshape(tk, b, heads, 2, hd)[..., 1, :]
        tq = att.shape[1]
        a = att.reshape(b, heads, tq, tk)
        return torch.einsum("bhts,sbhd->tbhd", a, v).reshape(tq, b,
                                                             heads * hd)

    return _op("interleaved_matmul_encdec_valatt", fn, keys_values,
               attention)


def div_sqrt_dim(data):
    """``data / sqrt(data.shape[-1])``."""
    return _op("div_sqrt_dim", lambda x: x / math.sqrt(x.shape[-1]), data)


def _band(t, w, w_len, dil, device):
    """(positions, valid): ``pos[i, h, j] = i + (j - w)·dilation[h]``,
    the key that window slot j of query i reads, and whether it lies in
    [0, t)."""
    i = torch.arange(t, device=device)[:, None, None]
    j = torch.arange(w_len, device=device)[None, None, :]
    pos = i + (j - w) * dil.to(torch.int64)[None, :, None]
    return pos.clamp(0, t - 1), (pos >= 0) & (pos < t)


def _gather_band(x, pos):
    """``x[b, pos[i, h, j], h, :]`` as (b, t, h, w_len, d)."""
    b, t, h, d = x.shape
    w_len = pos.shape[-1]
    idx = pos.permute(0, 2, 1).reshape(1, t * w_len, h, 1)
    g = torch.gather(x, 1, idx.expand(b, t * w_len, h, d))
    return g.reshape(b, t, w_len, h, d).permute(0, 1, 3, 2, 4)


def sldwin_atten_score(query, key, dilation, w=None, symmetric=True):
    """Sliding-window scores: query, key (batch, seq, heads, d), dilation
    (heads,); output (batch, seq, heads, 2w+1), or w+1 slots (the left
    half) when not ``symmetric``. Slots outside the sequence are 0."""
    w = int(w)
    w_len = 2 * w + 1 if symmetric else w + 1

    def fn(q, k, dil):
        pos, valid = _band(q.shape[1], w, w_len, dil, q.device)
        score = torch.einsum("bihd,bihjd->bihj", q, _gather_band(k, pos))
        return score * valid[None].to(score.dtype)

    return _op("sldwin_atten_score", fn, query, key, dilation)


def sldwin_atten_context(score, value, dilation, w=None, symmetric=True):
    """Context vectors from sliding-window scores: output (batch, seq,
    heads, d)."""
    w = int(w)
    w_len = 2 * w + 1 if symmetric else w + 1

    def fn(s, v, dil):
        pos, valid = _band(v.shape[1], w, w_len, dil, v.device)
        s = s * valid[None].to(s.dtype)
        return torch.einsum("bihj,bihjd->bihd", s, _gather_band(v, pos))

    return _op("sldwin_atten_context", fn, score, value, dilation)


def sldwin_atten_mask_like(score, dilation, valid_length, w=None,
                           symmetric=True):
    """The 0/1 mask of :func:`sldwin_atten_score`'s output, the
    reference's arithmetic (its integer-division dilation bounds)."""
    w = int(w)
    w_len = 2 * w + 1 if symmetric else w + 1

    def fn(s, dil, vlen):
        t = s.shape[1]
        i = torch.arange(t, device=s.device)[None, :, None, None]
        j = torch.arange(w_len, device=s.device)[None, None, None, :]
        d = dil.to(torch.int64)[None, None, :, None]
        vl = vlen.to(torch.int64)[:, None, None, None]
        is_zero = (j < (w - torch.div(i, d, rounding_mode="floor"))) \
            | (i >= vl)
        if symmetric:
            is_zero = is_zero | ((w_len - j - 1) < (
                w - torch.div(vl - i - 1, d, rounding_mode="floor")))
        mask = torch.where(is_zero, 0.0, 1.0).to(s.dtype)
        return mask * torch.ones_like(s)

    return _op("sldwin_atten_mask_like", fn, score, dilation, valid_length)
