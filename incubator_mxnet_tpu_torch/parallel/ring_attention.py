"""Ring attention: exact attention over a sequence sharded along a mesh
axis (port of `incubator_mxnet_tpu/parallel/ring_attention.py`:
`ring_attention` :26, `ring_self_attention` :98).

Each rank holds one block of the sequence of Q, K and V, (B, H, T_local,
D). K and V travel round the ring (`collectives` ``ring_permute``), and
at each hop the rank's queries attend to the block it holds through the
flash-attention kernel (K1), which returns the block's output and
log-sum-exp; the hops merge by log-sum-exp in float32. Under ``causal``
a block before the rank's own is attended in full, its own block
causally and a block after it not at all.

The backward runs the ring again: at each hop the backward kernels (K2)
take the block with the merged log-sum-exp and the final output (from
which they form delta), which gives the block's exact share of dQ, dK
and dV; dK and dV travel with their block and are home after the last
hop. The reference's recurrence is einsums in float32 (its own
blockwise softmax); the port's hops are K1 and K2, whose bf16 inputs
round P as the kernels do, so the ring agrees with one K1 call over the
whole sequence within K1's tolerance. On CPU tensors K1 and K2 are their
plain versions.

``ring_attention`` is called with the mesh active (as the reference's
is inside its shard_map); ``ring_self_attention`` takes the global
(B, H, T, D) on every rank and returns the global output.
"""
from __future__ import annotations

import math

import torch

from ..ops.flash_attention import flash_attention_bwd, flash_attention_with_lse
from . import collectives as _coll

__all__ = ["ring_attention", "ring_self_attention"]


def _hops(n, my, causal):
    """(hop, source block, mode) of each hop: mode None skips the block,
    else it is the block's causal flag."""
    out = []
    for i in range(n):
        src = (my - i) % n
        if causal and src > my:
            out.append((i, src, None))
        else:
            out.append((i, src, bool(causal and src == my)))
    return out


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, sm_scale, impl):
        group = mesh.group(axis)
        n, my = mesh.axis_size(axis), mesh.coordinate(axis)
        b, h, t, _ = q.shape
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((b * h, t), -math.inf, dtype=torch.float32,
                         device=q.device)
        kb, vb = k, v
        for i, _src, mode in _hops(n, my, causal):
            if mode is not None:
                o_i, lse_i = flash_attention_with_lse(
                    q, kb, vb, causal=mode, sm_scale=sm_scale, impl=impl)
                new = torch.logaddexp(lse, lse_i)
                a = torch.exp(lse - new).view(b, h, t, 1)
                c = torch.exp(lse_i - new).view(b, h, t, 1)
                o = o * a + o_i.float() * c
                lse = new
            if i < n - 1:
                kb = _coll._raw_ring_permute(kb, group, 1)
                vb = _coll._raw_ring_permute(vb, group, 1)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis, causal, sm_scale, impl)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal, sm_scale, impl = ctx.args
        group = mesh.group(axis)
        n, my = mesh.axis_size(axis), mesh.coordinate(axis)
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for i, _src, mode in _hops(n, my, causal):
            if mode is not None:
                dq_i, dk_i, dv_i = flash_attention_bwd(
                    q, kb, vb, out, lse, do, causal=mode, sm_scale=sm_scale,
                    impl=impl)
                dq += dq_i.float()
                dk += dk_i.float()
                dv += dv_i.float()
            if i < n - 1:
                kb = _coll._raw_ring_permute(kb, group, 1)
                vb = _coll._raw_ring_permute(vb, group, 1)
            # dK and dV travel with their block: home after the n-th hop
            dk = _coll._raw_ring_permute(dk, group, 1)
            dv = _coll._raw_ring_permute(dv, group, 1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def _unwrap(x):
    from ..ndarray.ndarray import NDArray

    return x._data if isinstance(x, NDArray) else x


def ring_attention(q, k, v, axis_name, causal=False, sm_scale=None,
                   impl="auto"):
    """Exact attention of this rank's query block against the whole
    sequence, sharded on mesh axis ``axis_name`` of the active mesh.

    q, k, v: (B, H, T_local, D), this rank's block; returns (B, H,
    T_local, D). Differentiable in q, k and v. ``impl`` is handed to the
    kernels' wrappers ("plain" runs their plain versions)."""
    from .collectives import _mesh

    mesh = _mesh()
    qv, kv, vv = (_unwrap(t) for t in (q, k, v))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(qv.shape[-1])
    for name, t in (("k", kv), ("v", vv)):
        if t.shape != qv.shape:
            raise ValueError(f"ring_attention: {name} {tuple(t.shape)} "
                             f"differs from q {tuple(qv.shape)}")
    _coll._census("ring_permute", axis_name, kv)
    out = _Ring.apply(qv, kv, vv, mesh, axis_name, bool(causal),
                      float(sm_scale), impl)
    from ..ndarray.ndarray import NDArray

    return NDArray(out) if isinstance(q, NDArray) else out


def ring_self_attention(q, k, v, mesh=None, axis="sp", causal=False,
                        sm_scale=None, impl="auto"):
    """Ring attention over global (B, H, T, D) inputs (the same on every
    rank): the sequence is cut along ``axis`` of ``mesh`` (or the active
    mesh), each rank runs :func:`ring_attention` on its block, and the
    global output is gathered on every rank."""
    from ..ndarray.ndarray import NDArray
    from .mesh import current_mesh, mesh_scope

    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError("ring_self_attention needs a mesh (pass mesh= or "
                         "enter a mesh_scope)")
    qv, kv, vv = (_unwrap(t) for t in (q, k, v))
    n, my = mesh.axis_size(axis), mesh.coordinate(axis)
    t = qv.shape[2]
    if t % n:
        raise ValueError(f"ring_self_attention: sequence of {t} does not "
                         f"divide over the {n} ranks of axis {axis!r}")
    c = t // n
    blocks = [x.narrow(2, my * c, c) for x in (qv, kv, vv)]
    with mesh_scope(mesh):
        out = ring_attention(*blocks, axis, causal=causal, sm_scale=sm_scale,
                             impl=impl)
        out = _coll.all_gather(out, axis, axis=2)
    return NDArray(out) if isinstance(q, NDArray) else out
