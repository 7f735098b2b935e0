"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain versions (K1, K2).

Port of `incubator_mxnet_tpu/ops/flash_attention.py` (`_fwd_kernel` :57,
`_fwd` :122, `_dq_kernel` :166, `_dkv_kernel` :204, `_bwd` :245, the
`_flash_core` custom vjp :328-358, public `flash_attention` :419,
`mha_flash` :497). The kernels are ``csrc/flash_attention.cu``, bound by
operations on the H100, their products on the tensor cores (`wgmma`;
bf16 and f16 directly, f32 as 3xTF32, f32-accurate; see the source's
notes):

- forward: blockwise online-softmax attention, one warpgroup per
  (batch*head, 64-row query tile), looping over key tiles in shared
  memory; it returns O and the f32 logsumexp;
- backward: a pre-pass for delta = rowsum(dO * O), then a dq kernel (one
  warpgroup per query tile, looping over key tiles) and a dk/dv kernel
  (one per 64-key tile, looping over query tiles), both recomputing
  P = exp(s - lse).

Like the reference, bf16 and f16 inputs round P and dS to their own dtype
before the products that take them; the plain versions do the same.

They mask the ragged edges themselves, so the TPU wrapper's pad-to-block
copies (:470-482) are gone, and they address q, k, v, o, dO and the
gradients through strides, so the ``bthd`` layout needs no transpose.
:func:`flash_attention` is differentiable: an autograd Function pairs the
forward with the backward and saves q, k, v, o and lse, as
`_flash_core_fwd` does.

:func:`plain_attention` mirrors `_xla_attention` (:370) in PyTorch ops and
also returns the logsumexp, with the kernel's conventions: rows at or past
the length (with ``lengths``) are zero with lse = +inf, empty rows get
lse = +inf. :func:`plain_attention_bwd` is the backward kernels'
arithmetic (the explicit formulas, not autograd). A wrapper uses them only
for CPU tensors (or when the caller asks for ``impl="plain"``).

``impl="auto"`` takes the kernel for every CUDA tensor. The TPU package's
``auto`` sent score matrices up to 2 GiB to XLA (`_XLA_ATTN_BYTES_LIMIT`
:367); that threshold was measured on a TPU and is not carried over.

``launches`` counts forward kernel launches and ``bwd_launches`` backward
ones: a backward call that reaches the card launches three kernels, the
delta pre-pass, the dq kernel and the dk/dv kernel (two when there are no
keys). :func:`cost` and :func:`bwd_cost` give a call's ``(bytes, flops)``
(:func:`bwd_cost` also a launch's share of its three kernels), counting
what this call's data needs: with ``lengths``, the live rows and keys.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["MAX_HEAD_DIM", "plain_attention", "plain_attention_bwd",
           "flash_attention_with_lse", "flash_attention_bwd",
           "flash_attention", "mha_flash", "launches", "bwd_launches",
           "cost", "bwd_cost", "BWD_KERNELS"]

#: Largest head size the kernels take (GPT and BERT use 64).
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LAYOUTS = ("bhtd", "bthd")

#: the backward's kernels, in launch order (the dk/dv kernel only when
#: there are keys)
BWD_KERNELS = ("delta", "dq", "dkv")

launches = 0
bwd_launches = 0
_LIB = None


def _live(b, tq, tk, lengths, causal):
    """(live query rows, live keys, live (row, key) pairs), summed over the
    batch: a row or key at or past its length is not needed; a causal
    call needs half the pairs. None when ``lengths`` lies on the card: the
    host would have to wait for the card to read it (and cannot inside a
    CUDA-graph capture), and a cost never costs a sync; pass the lengths
    on the host to reckon such a call."""
    if lengths is None:
        rows, keys, pairs = b * tq, b * tk, b * tq * tk
    else:
        if isinstance(lengths, torch.Tensor) and lengths.device.type \
                != "cpu":
            return None
        lens = [int(n) for n in torch.as_tensor(lengths).reshape(-1).tolist()]
        rows = sum(min(n, tq) for n in lens)
        keys = sum(min(n, tk) for n in lens)
        pairs = sum(min(n, tq) * min(n, tk) for n in lens)
    return rows, keys, pairs / 2 if causal else pairs


def cost(b, h, tq, tk, d, dtype, lengths=None, causal=False):
    """``(bytes, flops)`` of one forward call (K1): q, k and v read where
    live, o written, the f32 lse written; two products (4 operations a
    live (row, key) pair a unit of d). ``(None, None)`` when the lengths
    cannot be read (see :func:`_live`)."""
    live = _live(b, tq, tk, lengths, causal)
    if live is None:
        return None, None
    rows, keys, pairs = live
    item = _build.item_size(dtype)
    nbytes = (rows + 2 * keys + b * tq) * h * d * item + b * h * tq * 4
    return int(nbytes), int(4 * h * d * pairs)


def bwd_cost(b, h, tq, tk, d, dtype, lengths=None, causal=False,
             kernel=None):
    """``(bytes, flops)`` of one backward call (K2): q, o and dO read for
    the live rows, k and v for the live keys, dq, dk and dv written, the
    f32 lse read and delta written; five products (10 operations a live
    pair a unit of d). ``kernel`` (one of :data:`BWD_KERNELS`) gives that
    launch's share: the delta pre-pass reads o and dO and writes delta;
    the dq kernel reads q, k, v and lse, writes dq and makes three of the
    products (s, dP, dq); the dk/dv kernel writes dk and dv and makes the
    other two. ``(None, None)`` as :func:`cost`."""
    live = _live(b, tq, tk, lengths, causal)
    if live is None:
        return None, None
    rows, keys, pairs = live
    item = _build.item_size(dtype)
    stats = b * h * tq * 4
    parts = {"delta": (2 * rows * h * d * item + stats, 0),
             "dq": ((rows + 2 * keys + b * tq) * h * d * item + stats,
                    6 * h * d * pairs),
             "dkv": (2 * b * tk * h * d * item, 4 * h * d * pairs)}
    if kernel is not None:
        nbytes, flops = parts[kernel]
        return int(nbytes), int(flops)
    return (int(sum(p[0] for p in parts.values())),
            int(sum(p[1] for p in parts.values())))


def _dims(q, k, layout):
    """(batch, heads, t_q, t_k, head_dim)."""
    if layout == "bthd":
        b, tq, h, d = q.shape
        return b, h, tq, k.shape[1], d
    b, h, tq, d = q.shape
    return b, h, tq, k.shape[2], d


def _bht_strides(t, layout):
    """Element strides of the (batch, head, time) axes."""
    if layout == "bthd":
        return t.stride(0), t.stride(2), t.stride(1)
    return t.stride(0), t.stride(1), t.stride(2)


def _scores_mask(b, tq, tk, lengths, causal, dev):
    """(mask of live (row, key) pairs, lens or None), broadcastable to
    (b, h, tq, tk)."""
    rows = torch.arange(tq, device=dev)
    cols = torch.arange(tk, device=dev)
    mask = torch.ones((1, 1, tq, tk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (cols[None, :] <= rows[:, None])
    lens = None
    if lengths is not None:
        lens = torch.as_tensor(lengths, device=dev).to(torch.int64).reshape(b)
        mask = mask & (cols[None, None, None, :] < lens[:, None, None, None])
    return mask, lens


def plain_attention(q, k, v, lengths=None, causal=False, sm_scale=None,
                    layout="bhtd"):
    """(o, lse): attention in PyTorch ops with f32 scores, P rounded to
    the input dtype before P V; o in the input dtype and layout, lse f32
    (batch*heads, t_q)."""
    if layout == "bthd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dev = q.device
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    mask, lens = _scores_mask(b, tq, tk, lengths, causal, dev)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741 — the paper's name
    # P in the input dtype before P V, as the reference (:97); l sums the
    # unrounded P
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / torch.where(
        l > 0, l, torch.ones_like(l))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, math.inf))
    if lens is not None:
        rows = torch.arange(tq, device=dev)
        valid = (rows[None, :] < lens[:, None])[:, None, :, None]
        o = torch.where(valid, o, torch.zeros_like(o))
        lse = torch.where(valid, lse, torch.full_like(lse, math.inf))
    o = o.to(q.dtype)
    if layout == "bthd":
        o = o.transpose(1, 2)
    return o, lse.reshape(b * h, tq)


def plain_attention_bwd(q, k, v, o, lse, do, lengths=None, causal=False,
                        sm_scale=None, layout="bhtd"):
    """(dq, dk, dv) in the inputs' dtype and layout, from the forward's o
    and f32 lse (batch*heads, t_q): P = exp(s - lse) on live pairs (0 on
    masked pairs and on rows with lse = +inf), delta = rowsum(dO * O),
    dS = P * (dO V^T - delta) * scale, dq = dS K, dk = dS^T Q, dv = P^T dO,
    in f32 with P and dS rounded to the input dtype before the products
    that take them (no-ops for f32 inputs)."""
    if layout == "bthd":
        q, k, v, o, do = (t.transpose(1, 2) for t in (q, k, v, o, do))
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    mask, _ = _scores_mask(b, tq, tk, lengths, causal, q.device)
    lse4 = lse.reshape(b, h, tq, 1)
    live = torch.isfinite(lse4)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    p = torch.where(mask & live,
                    torch.exp(s - torch.where(live, lse4, 0.0)), 0.0)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * sm_scale
    # P and dS in the input dtype before the second products, as the
    # reference (:196, :234, :236)
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, kf).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof).to(
        v.dtype)
    if layout == "bthd":
        dq, dk, dv = (t.transpose(1, 2) for t in (dq, dk, dv))
    return dq, dk, dv


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        fn = lib.mx_flash_attention_fwd
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.mx_flash_attention_bwd
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_kernel_args(q, k, v, layout, others=()):
    """(b, h, tq, tk, d), raising unless the kernels take these inputs."""
    b, h, tq, tk, d = _dims(q, k, layout)
    if q.dtype not in _DTYPES:
        raise MXNetError(f"flash_attention kernel takes float32/bfloat16/"
                           f"float16, "
                         f"got {q.dtype}")
    if any(t.dtype != q.dtype for t in (k, v, *others)):
        raise MXNetError("flash_attention: q, k, v (and o, dO) must share a "
                         "dtype")
    if any(t.device != q.device for t in (k, v, *others)):
        raise MXNetError("flash_attention: q, k, v must share a device")
    if k.shape != v.shape or _dims(k, k, layout)[:2] != (b, h) \
            or k.shape[-1] != d or any(t.shape != q.shape for t in others):
        raise MXNetError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match in layout {layout!r}")
    if d > MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    return b, h, tq, tk, d


def _lens_arg(lengths, b, dev):
    if lengths is None:
        return None
    return torch.as_tensor(lengths, device=dev).to(
        torch.int32).reshape(b).contiguous()


def _last_contiguous(*ts):
    return [t if t.stride(-1) == 1 else t.contiguous() for t in ts]


def _kernel(q, k, v, lengths, causal, sm_scale, layout):
    global launches
    b, h, tq, tk, d = _check_kernel_args(q, k, v, layout)
    q, k, v = _last_contiguous(q, k, v)
    shape = (b, tq, h, d) if layout == "bthd" else (b, h, tq, d)
    o = torch.empty(shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lens = _lens_arg(lengths, b, q.device)
    lib = _lib()
    stream = _build.stream_of(q.device)
    strides = [s for t in (q, k, v, o) for s in _bht_strides(t, layout)]
    with _build.on_device(q.device):
        err = lib.mx_flash_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(),
            None if lens is None else lens.data_ptr(), *strides,
            b, h, tq, tk, d, float(sm_scale), int(bool(causal)), stream)
    _build.check(lib, err, "flash_attention_fwd")
    launches += 1
    if _build.LAUNCH_LOG is not None:
        _build.LAUNCH_LOG.append(("flash_fwd_kernel", *cost(
            b, h, tq, tk, d, q.dtype, lengths, causal)))
    return o, lse


def _kernel_bwd(q, k, v, o, lse, do, lengths, causal, sm_scale, layout):
    global bwd_launches
    b, h, tq, tk, d = _check_kernel_args(q, k, v, layout, (o, do))
    q, k, v, o, do = _last_contiguous(q, k, v, o, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lse = lse.float().reshape(b * h, tq).contiguous()
    delta = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    lens = _lens_arg(lengths, b, q.device)
    strides = (ctypes.c_longlong * 24)(*[
        s for t in (q, k, v, o, do, dq, dk, dv)
        for s in _bht_strides(t, layout)])
    lib = _lib()
    stream = _build.stream_of(q.device)
    with _build.on_device(q.device):
        err = lib.mx_flash_attention_bwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if lens is None else lens.data_ptr(), strides,
            b, h, tq, tk, d, float(sm_scale), int(bool(causal)), stream)
    _build.check(lib, err, "flash_attention_bwd")
    bwd_launches += 3 if tk else 2  # delta, dq, then dk/dv over the keys
    if _build.LAUNCH_LOG is not None:
        for part in BWD_KERNELS[:3 if tk else 2]:
            _build.LAUNCH_LOG.append((f"flash_bwd_{part}_kernel", *bwd_cost(
                b, h, tq, tk, d, q.dtype, lengths, causal, kernel=part)))
    return dq, dk, dv


def _use_plain(what, q, impl, layout):
    if layout not in _LAYOUTS:
        raise ValueError(f"{what}: unknown layout {layout!r}")
    return _build.use_plain(what, q, impl)


def _fwd(q, k, v, lengths, causal, sm_scale, impl, layout):
    if _use_plain("flash_attention", q, impl, layout):
        return plain_attention(q, k, v, lengths=lengths, causal=causal,
                               sm_scale=sm_scale, layout=layout)
    return _kernel(q, k, v, lengths, causal, sm_scale, layout)


def flash_attention_bwd(q, k, v, o, lse, do, lengths=None, causal=False,
                        sm_scale=None, impl="auto", layout="bhtd"):
    """(dq, dk, dv) of :func:`flash_attention` from its o and lse and the
    output gradient ``do``; ``impl`` as there."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _use_plain("flash_attention_bwd", q, impl, layout):
        return plain_attention_bwd(q, k, v, o, lse, do, lengths=lengths,
                                   causal=causal, sm_scale=sm_scale,
                                   layout=layout)
    return _kernel_bwd(q, k, v, o, lse, do, lengths, bool(causal),
                       float(sm_scale), layout)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, sm_scale, impl, layout):
        o, lse = _fwd(q, k, v, lengths, causal, sm_scale, impl, layout)
        ctx.save_for_backward(q, k, v, o, lse, lengths)
        ctx.args = (causal, sm_scale, impl, layout)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):  # noqa: ARG004 — lse takes no gradient
        q, k, v, o, lse, lengths = ctx.saved_tensors
        causal, sm_scale, impl, layout = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, lengths,
                                         causal, sm_scale, impl, layout)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_with_lse(q, k, v, lengths=None, causal=False,
                             sm_scale=None, impl="auto", layout="bhtd"):
    """(o, lse) of :func:`flash_attention`; lse is f32 (batch*heads, t_q),
    the residual the backward kernels read. Differentiable in q, k, v."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    causal, sm_scale = bool(causal), float(sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=q.device)
        return _FlashAttention.apply(q, k, v, lengths, causal, sm_scale,
                                     impl, layout)
    return _fwd(q, k, v, lengths, causal, sm_scale, impl, layout)


def flash_attention(q, k, v, lengths=None, causal=False, sm_scale=None,
                    block_q=512, block_k=512, interpret=None, impl="auto",  # noqa: ARG001
                    layout="bhtd"):
    """Fused scaled-dot-product attention.

    - ``layout``: "bhtd" (B, H, T, D) or "bthd" (B, T, H, D, the natural
      output of a fused qkv projection, read in place through strides);
      the output comes back in the same layout.
    - ``lengths``: optional (B,) valid sequence lengths, masking keys and
      query rows (self-attention semantics).
    - ``causal``: lower-triangular masking for decoder/LM use.
    - ``impl``: "auto" takes the kernels for CUDA tensors and the plain
      versions for CPU tensors; "kernel" requires CUDA tensors; "plain"
      forces the plain versions (the reference the kernels are held
      against).
    - ``block_q``, ``block_k``, ``interpret``: the reference's TPU tiling
      and Pallas interpret switch, taken and unused (the kernels pick
      their own tiles).

    Differentiable in q, k, v (the backward kernels on the card).
    """
    return flash_attention_with_lse(q, k, v, lengths=lengths, causal=causal,
                                    sm_scale=sm_scale, impl=impl,
                                    layout=layout)[0]


def mha_flash(q, k, v, lengths=None, causal=False, sm_scale=None,
              impl="auto"):
    """(B*H, T, D)-layout convenience wrapper: the caller flattens heads;
    ``lengths`` must already be per (B*H) row or None."""
    o = flash_attention(q[:, None], k[:, None], v[:, None], lengths=lengths,
                        causal=causal, sm_scale=sm_scale, impl=impl)
    return o[:, 0]
