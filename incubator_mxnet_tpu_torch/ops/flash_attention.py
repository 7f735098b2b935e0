"""Flash-attention forward: the hand-written CUDA kernel and its plain
version.

Port of `incubator_mxnet_tpu/ops/flash_attention.py` forward
(`_fwd_kernel` :57, `_fwd` :122, public `flash_attention` :419,
`mha_flash` :497). The kernel is ``csrc/flash_attention.cu``: blockwise
online-softmax attention, one block per (batch*head, 64-row query tile),
looping over 64-key tiles in shared memory, bound by operations on the
H100 (see the source's note). It masks the ragged edges itself, so the
TPU wrapper's pad-to-block copies (:470-482) are gone, and it addresses
q, k, v and o through strides, so the ``bthd`` layout needs no transpose.
The backward kernels (`_dq_kernel` :166, `_dkv_kernel` :204) belong to
the training slice; on CUDA tensors that need a gradient the wrapper
raises.

:func:`plain_attention` mirrors `_xla_attention` (:370) in PyTorch ops and
also returns the logsumexp, with the kernel's conventions: rows at or past
the length (with ``lengths``) are zero with lse = +inf, empty rows get
lse = +inf. A wrapper uses it only for CPU tensors (or when the caller
asks for ``impl="plain"``).

``impl="auto"`` takes the kernel for every CUDA tensor. The TPU package's
``auto`` sent score matrices up to 2 GiB to XLA (`_XLA_ATTN_BYTES_LIMIT`
:367); that threshold was measured on a TPU and is not carried over.

``launches`` counts kernel launches (one per call that reaches the card).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["MAX_HEAD_DIM", "plain_attention", "flash_attention_with_lse",
           "flash_attention", "mha_flash", "launches"]

#: Largest head size the kernel takes (GPT and BERT use 64).
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IMPLS = ("auto", "kernel", "plain")
_LAYOUTS = ("bhtd", "bthd")

launches = 0
_LIB = None


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


def plain_attention(q, k, v, lengths=None, causal=False, sm_scale=None,
                    layout="bhtd"):
    """(o, lse): attention in PyTorch ops with f32 scores; o in the input
    dtype and layout, lse f32 (batch*heads, t_q)."""
    if layout == "bthd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dev = q.device
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    rows = torch.arange(tq, device=dev)
    cols = torch.arange(tk, device=dev)
    mask = torch.ones((1, 1, tq, tk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (cols[None, :] <= rows[:, None])
    if lengths is not None:
        lens = torch.as_tensor(lengths, device=dev).to(torch.int64).reshape(b)
        mask = mask & (cols[None, None, None, :] < lens[:, None, None, None])
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741 — the paper's name
    o = torch.matmul(p, v.float()) / torch.where(l > 0, l, torch.ones_like(l))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, math.inf))
    if lengths is not None:
        valid = (rows[None, :] < lens[:, None])[:, None, :, None]
        o = torch.where(valid, o, torch.zeros_like(o))
        lse = torch.where(valid, lse, torch.full_like(lse, math.inf))
    o = o.to(q.dtype)
    if layout == "bthd":
        o = o.transpose(1, 2)
    return o, lse.reshape(b * h, tq)


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        fn = lib.mx_flash_attention_fwd
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _kernel(q, k, v, lengths, causal, sm_scale, layout):
    global launches
    b, h, tq, tk, d = _dims(q, k, layout)
    if q.dtype not in _DTYPES:
        raise MXNetError(f"flash_attention kernel takes float32/bfloat16, "
                         f"got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError("flash_attention: q, k, v must share a dtype")
    if any(t.device != q.device for t in (k, v)):
        raise MXNetError("flash_attention: q, k, v must share a device")
    if k.shape != v.shape or _dims(k, k, layout)[:2] != (b, h) \
            or k.shape[-1] != d:
        raise MXNetError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match in layout {layout!r}")
    if d > MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise MXNetError("flash_attention: the backward kernels are not "
                         "ported yet; call under torch.no_grad()")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    shape = (b, tq, h, d) if layout == "bthd" else (b, h, tq, d)
    o = torch.empty(shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lens = None
    if lengths is not None:
        lens = torch.as_tensor(lengths, device=q.device).to(
            torch.int32).reshape(b).contiguous()
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v, o) for s in _bht_strides(t, layout)]
    with torch.cuda.device(q.device):
        err = lib.mx_flash_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(),
            None if lens is None else lens.data_ptr(), *strides,
            b, h, tq, tk, d, float(sm_scale), int(bool(causal)), stream)
    _build.check(lib, err, "flash_attention_fwd")
    launches += 1
    return o, lse


def flash_attention_with_lse(q, k, v, lengths=None, causal=False,
                             sm_scale=None, impl="auto", layout="bhtd"):
    """(o, lse) of :func:`flash_attention`; lse is f32 (batch*heads, t_q),
    the residual the backward kernels will read."""
    if layout not in _LAYOUTS:
        raise ValueError(f"flash_attention: unknown layout {layout!r}")
    if impl not in _IMPLS:
        raise ValueError(f"flash_attention: unknown impl {impl!r}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "plain" or (impl == "auto" and q.device.type != "cuda"):
        return plain_attention(q, k, v, lengths=lengths, causal=causal,
                               sm_scale=sm_scale, layout=layout)
    if q.device.type != "cuda":
        raise MXNetError("flash_attention: impl='kernel' needs CUDA tensors")
    return _kernel(q, k, v, lengths, bool(causal), float(sm_scale), layout)


def flash_attention(q, k, v, lengths=None, causal=False, sm_scale=None,
                    impl="auto", layout="bhtd"):
    """Fused scaled-dot-product attention.

    - ``layout``: "bhtd" (B, H, T, D) or "bthd" (B, T, H, D, the natural
      output of a fused qkv projection, read in place through strides);
      the output comes back in the same layout.
    - ``lengths``: optional (B,) valid sequence lengths, masking keys and
      query rows (self-attention semantics).
    - ``causal``: lower-triangular masking for decoder/LM use.
    - ``impl``: "auto" takes the kernel for CUDA tensors and the plain
      version for CPU tensors; "kernel" requires CUDA tensors; "plain"
      forces the plain version (the reference the kernel is held
      against).
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
