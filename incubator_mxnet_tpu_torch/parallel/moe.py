"""Mixture-of-Experts with expert parallelism over an ``ep`` mesh axis
(port of `incubator_mxnet_tpu/parallel/moe.py`: `top1_gating` :25,
`top2_gating` :56, `moe_dispatch_combine` :105, `moe_ffn_apply` :151).

Capacity-factor dispatch with static shapes: each token goes to its
top-1 (or top-2) experts, a token's slot in an expert is its rank among
the expert's tokens counted with a cumsum (first choices before second
choices), and tokens beyond an expert's capacity are dropped. A one-hot
(tokens × experts × capacity) matrix contracts the tokens into the
experts' slots; under ``axis_name`` two ``all_to_all`` exchanges
(`collectives`) carry the slots to the rank that holds their expert and
back. Every step is an einsum or an exchange, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import collectives as _coll

__all__ = ["moe_dispatch_combine", "moe_ffn_apply", "top1_gating",
           "top2_gating"]


def _slots(kept, rank, capacity):
    slot = (rank * kept).sum(dim=-1).to(torch.int64)
    slot_oh = F.one_hot(slot, capacity).to(torch.float32)
    return kept[:, :, None] * slot_oh[:, None, :]              # (T, E, C)


def top1_gating(logits, capacity):
    """Top-1 gating with capacity: ``(combine, dispatch, aux)``.

    logits: (T, E). combine: (T, E, C) float32, the gate probability at
    the token's (expert, slot), zero elsewhere; dispatch: 1 at the same
    places; aux: the Switch load-balancing loss, E · Σ_e frac_e ·
    mean_prob_e."""
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    expert = probs.argmax(dim=-1)                              # (T,)
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, e).to(torch.float32)            # (T, E)
    rank = (onehot.cumsum(dim=0) - onehot) * onehot
    kept = (rank < capacity).to(torch.float32) * onehot
    dispatch = _slots(kept, rank, capacity)
    combine = dispatch * gate[:, None, None]
    frac = onehot.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = e * (frac * mean_prob).sum()
    return combine, dispatch, aux


def top2_gating(logits, capacity):
    """Top-2 gating with capacity (GShard): each token goes to its two
    most probable experts, the two gates renormalised over the pair;
    first choices take slots before any second choice. Returns
    ``(combine, dispatch, aux)``, aux on the first choices."""
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    e1 = probs.argmax(dim=-1)
    oh1 = F.one_hot(e1, e).to(torch.float32)
    e2 = (probs * (1.0 - oh1)).argmax(dim=-1)
    oh2 = F.one_hot(e2, e).to(torch.float32)
    g1 = probs.gather(1, e1[:, None])[:, 0]
    g2 = probs.gather(1, e2[:, None])[:, 0]
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom
    rank1 = (oh1.cumsum(dim=0) - oh1) * oh1
    used1 = oh1.sum(dim=0, keepdim=True)
    rank2 = ((oh2.cumsum(dim=0) - oh2) + used1) * oh2
    kept1 = (rank1 < capacity).to(torch.float32) * oh1
    kept2 = (rank2 < capacity).to(torch.float32) * oh2
    d1 = _slots(kept1, rank1, capacity)
    d2 = _slots(kept2, rank2, capacity)
    dispatch = d1 + d2
    combine = d1 * g1[:, None, None] + d2 * g2[:, None, None]
    frac = oh1.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = e * (frac * mean_prob).sum()
    return combine, dispatch, aux


def moe_dispatch_combine(x, gate_logits, expert_fn, capacity_factor=1.25,
                         axis_name=None, top_k=1):
    """The MoE layer's body: dispatch → ``expert_fn`` → combine.

    x: (T_local, D), this rank's tokens; gate_logits: (T_local, E).
    ``expert_fn(slots)``, slots (E_local, C_total, D) → the same shape,
    runs after the dispatch exchange: under ``axis_name`` it sees this
    rank's experts and every rank's tokens for them. Returns
    ``(out (T_local, D), aux_loss)``."""
    t, e = gate_logits.shape
    n_groups = 1 if axis_name is None else _coll.axis_size(axis_name)
    if e % n_groups:
        raise ValueError(f"{e} experts not divisible over {n_groups} "
                         "expert-parallel groups")
    capacity = max(1, int(capacity_factor * top_k * t / e))
    if top_k == 1:
        combine, dispatch, aux = top1_gating(gate_logits, capacity)
    elif top_k == 2:
        combine, dispatch, aux = top2_gating(gate_logits, capacity)
    else:
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    # the layer's activation dtype: f32 one-hots would widen bf16 tokens
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    slots = torch.einsum("td,tec->ecd", x, dispatch)           # (E, C, D)
    if axis_name is not None:
        # each rank keeps the slots of its experts and receives the
        # matching slots of every peer: (E/G, G*C, D)
        slots = _coll.all_to_all(slots, axis_name, split_axis=0,
                                 concat_axis=1)
    out_slots = expert_fn(slots)
    if axis_name is not None:
        out_slots = _coll.all_to_all(out_slots, axis_name, split_axis=1,
                                     concat_axis=0)            # (E, C, D)
    out = torch.einsum("ecd,tec->td", out_slots, combine)
    return out, aux


def moe_ffn_apply(w1, b1, w2, b2):
    """The per-expert FFN as an ``expert_fn``: w1 (E_local, D, H), w2
    (E_local, H, D); gelu is the tanh form, as `jax.nn.gelu`'s
    default."""
    def expert_fn(slots):                                      # (E, C, D)
        h = torch.einsum("ecd,edh->ech", slots, w1) + b1[:, None, :]
        h = F.gelu(h, approximate="tanh")
        return torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]

    return expert_fn
