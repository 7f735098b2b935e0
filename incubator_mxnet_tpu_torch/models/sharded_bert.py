"""The sharded BERT training step (port of `incubator_mxnet_tpu/models/
sharded_bert.py`: `BertConfig` :28, `init_params` :40, `param_specs` :72,
`forward` :107, `loss_fn` :148, `make_train_step` :158).

A functional BERT (MLM head, Adam) over a mesh with axes ``dp`` and
``tp``: the batch is split over dp, and each rank stores only its blocks
of the parameters as the reference's Megatron specs cut them over tp (qkv
and ffn1 by output column, proj and ffn2 by input row, the word
embedding and the MLM head by vocabulary). The compute is split as
Megatron splits it, from the blocks: each tp rank computes its heads,
its rows of proj, its FFN hidden units and its columns of the vocabulary
(the masked ids' lookup; the scores gathered whole for the softmax),
with Megatron's f and g around each region (`_layout.copy_to`,
`reduce_from`). The fused qkv weight's spec cuts its columns
contiguously (``[q|k|v]``), so the rank's heads' columns come from their
owners in one all-to-all (`_layout.head_rows`), and their gradient goes
back the same way. With ``use_sp`` the residual stream stays cut by rows
of the sequence between the regions (Megatron SP: `_layout.seq_enter`,
`seq_exit` in place of f and g), and the LayerNorms, the position
embedding and the biases added on the rank's rows get the rank's shares
of their gradients, which the step sums over tp in one all-reduce. The
cut parameters' gradients are the blocks' already; every gradient is
averaged over dp, and each rank updates its blocks with the reference's
Adam. The arithmetic is the reference's, in torch operations (its
attention is an einsum softmax, not the flash kernel).

The parameters are a tree: ``{"word_embed", "pos_embed", "ln_g",
"ln_b", "layers": [{"qkv": {"w", "b"}, "proj", "ffn1", "ffn2", "ln1_g",
"ln1_b", "ln2_g", "ln2_b"}], "mlm": {"w", "b"}}`` with weights (in,
out), as the reference's. The reference draws them with JAX's
generator; :func:`init_params` takes the reference's drawn values (as
numpy) to start from the same weights, or draws its own at the same
scales.
"""
from __future__ import annotations

import math

import numpy as onp
import torch
import torch.nn.functional as F

from ..parallel import _layout

__all__ = ["BertConfig", "init_params", "forward", "loss_fn",
           "make_train_step", "param_specs"]


class BertConfig:
    def __init__(self, vocab_size=1000, units=64, hidden_size=128,
                 num_layers=2, num_heads=4, max_length=128, dtype="bfloat16"):
        self.vocab_size = vocab_size
        self.units = units
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_length = max_length
        self.dtype = dtype


def init_params(cfg: BertConfig, seed: int = 0, params=None, device=None):
    """The parameter tree in float32 on ``device`` (default the card,
    "cpu" for the CPU). ``params``: a tree of arrays to take (the
    reference's `init_params`, converted with numpy); without it the
    values are drawn from a `torch.Generator` seeded with ``seed``, at
    the reference's scales (normal / sqrt(fan_in) weights, zero biases,
    normal · 0.02 embeddings, unit norms)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if params is not None:
        return _layout.tree_map(
            lambda a: torch.as_tensor(onp.asarray(a, dtype="float32"),
                                      device=dev).clone(), params)
    gen = torch.Generator().manual_seed(int(seed))
    U, H = cfg.units, cfg.hidden_size

    def normal(*shape):
        return torch.randn(shape, generator=gen)

    def dense(i, o):
        return {"w": normal(i, o) / math.sqrt(i), "b": torch.zeros(o)}

    tree = {
        "word_embed": normal(cfg.vocab_size, U) * 0.02,
        "pos_embed": normal(cfg.max_length, U) * 0.02,
        "ln_g": torch.ones(U), "ln_b": torch.zeros(U),
        "layers": [],
        "mlm": dense(U, cfg.vocab_size),
    }
    for _ in range(cfg.num_layers):
        tree["layers"].append({
            "qkv": dense(U, 3 * U), "proj": dense(U, U),
            "ffn1": dense(U, H), "ffn2": dense(H, U),
            "ln1_g": torch.ones(U), "ln1_b": torch.zeros(U),
            "ln2_g": torch.ones(U), "ln2_b": torch.zeros(U),
        })
    return _layout.tree_map(lambda a: a.to(dev), tree)


def param_specs(cfg: BertConfig):
    """The spec tree: Megatron tensor parallelism over the 'tp' axis (a
    spec per leaf, one entry per dimension)."""
    col = (None, "tp")    # column parallel: the output dimension cut
    row = ("tp", None)    # row parallel: the input dimension cut
    repl = ()
    specs = {
        "word_embed": ("tp", None),   # cut by vocabulary
        "pos_embed": repl,
        "ln_g": repl, "ln_b": repl,
        "layers": [],
        "mlm": {"w": (None, "tp"), "b": ("tp",)},
    }
    for _ in range(cfg.num_layers):
        specs["layers"].append({
            "qkv": {"w": col, "b": ("tp",)},
            "proj": {"w": row, "b": repl},
            "ffn1": {"w": col, "b": ("tp",)},
            "ffn2": {"w": row, "b": repl},
            "ln1_g": repl, "ln1_b": repl,
            "ln2_g": repl, "ln2_b": repl,
        })
    return specs


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def forward(params, tokens, cfg: BertConfig, sp_constraint=None,
            sp_axis=None):
    """tokens (N, T) int → MLM logits (N, T, vocab), float32.

    ``sp_constraint(x, kind)`` is the reference's layout hook, called
    where the reference calls it ('seq' before a LayerNorm region, 'full'
    before attention and the FFN); the port's step passes none. Under an
    active tensor-parallel step ``params`` holds this rank's blocks by
    :func:`param_specs` (`make_train_step`), and ``sp_axis`` (the
    tensor-parallel axis) keeps the stream cut by rows of the sequence
    between the regions; with none, the whole tensors."""
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    cst = sp_constraint or (lambda x, kind: x)
    N, T = tokens.shape
    U, H = cfg.units, cfg.num_heads
    d = U // H

    tp = _layout.tp()
    n, j = (tp[2], tp[3]) if tp is not None else (1, 0)
    if H % n:
        raise ValueError(f"{H} heads do not split over {n} ranks")
    ul, hl = U // n, H // n
    cut = tp is not None and sp_axis is not None and sp_axis == tp[1]

    def lin(x, p):
        return x @ p["w"].to(dt) + p["b"].to(dt)

    def enter(x):
        if tp is None:
            return x
        if cut:
            return _layout.seq_enter(x, tp[0], tp[1], T)
        return _layout.copy_to(x, *tp[:2])

    def leave(x, b):
        if tp is None:
            return x + b.to(dt)
        if cut:
            _layout.note_partial([b], tp[1])
            return _layout.seq_exit(x, *tp[:2]) + b.to(dt)
        return _layout.reduce_from(x, *tp[:2]) + b.to(dt)

    def res_ln(x, h, g, b):
        return _ln(x + h, g.to(dt), b.to(dt))

    def qkv_heads(p):
        """The rank's heads' columns of the fused qkv weight and bias."""
        if tp is None:
            return p
        rows = _layout.head_rows(torch.cat([p["w"], p["b"][None]], 0).t(),
                                 3 * U, 3, tp[0], tp[1])
        return {"w": rows[:, :U].t(), "b": rows[:, U]}

    rows = _layout.bounds(T, j, n) if cut else (0, T)
    x = _embed(params["word_embed"], tokens, tp, cfg.vocab_size, cut)
    pos = params["pos_embed"]
    if cut:
        _layout.note_partial([pos], tp[1])
    x = x + pos[rows[0]:rows[1]]
    x = _layout.seq_region(lambda a, g, b: _ln(a, g, b).to(dt), (x,),
                           sp_axis if cut else None,
                           (params["ln_g"], params["ln_b"]), local=True)
    x = cst(x, "seq")
    for lp in params["layers"]:
        # attention: this rank's heads, proj on their rows, summed over tp
        h = enter(cst(x, "full"))
        qkv = lin(h, qkv_heads(lp["qkv"]))
        qkv = qkv.reshape(N, T, 3, hl, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]      # (N,T,H,d)
        scores = torch.einsum("nthd,nshd->nhts", q, k) / math.sqrt(d)
        att = torch.softmax(scores.float(), dim=-1).to(dt)
        ctx = torch.einsum("nhts,nshd->nthd", att, v).reshape(N, T, ul)
        ctx = leave(ctx @ lp["proj"]["w"].to(dt), lp["proj"]["b"])
        x = _layout.seq_region(res_ln, (x, ctx), sp_axis,
                               (lp["ln1_g"], lp["ln1_b"]), local=cut)
        x = cst(x, "seq")
        # the FFN: this rank's hidden units, summed over tp
        h = enter(cst(x, "full"))
        h = F.gelu(lin(h, lp["ffn1"]), approximate="tanh")
        h = leave(h @ lp["ffn2"]["w"].to(dt), lp["ffn2"]["b"])
        x = _layout.seq_region(res_ln, (x, h), sp_axis,
                               (lp["ln2_g"], lp["ln2_b"]), local=cut)
        x = cst(x, "seq")
    if tp is None:
        return lin(x, params["mlm"]).float()
    if cut:
        # the whole sequence for the head (a replicated computation: the
        # gradient is the rank's rows)
        x = _layout.gather(x, tp[0], (tp[1],), 1, T)
    # the MLM head: this rank's columns of the vocabulary, gathered whole
    local = lin(_layout.copy_to(x, *tp[:2]), params["mlm"])
    vocab = cfg.vocab_size
    return _layout.gather(local, tp[0], (tp[1],), 2, vocab).float()


def _embed(table, tokens, tp, vocab, cut=False):
    """The word embedding of a ``vocab``-row table; under tensor
    parallelism ``table`` is this rank's block of the vocabulary (the
    masked ids' lookup), summed over tp (into the rank's rows of the
    sequence when the stream is ``cut``)."""
    if tp is None:
        return table[tokens.long()]
    mesh, axis, n, j = tp
    start, stop = _layout.bounds(vocab, j, n)
    local = tokens.long() - start
    keep = (local >= 0) & (local < stop - start)
    rows = table[torch.where(keep, local, 0)] * keep.unsqueeze(-1).to(
        table.dtype)
    if cut:
        return _layout.seq_exit(rows, mesh, axis)
    return _layout.reduce_from(rows, mesh, axis)


def loss_fn(params, tokens, labels, cfg, sp_constraint=None, sp_axis=None):
    """The mean MLM cross-entropy."""
    logits = forward(params, tokens, cfg, sp_constraint, sp_axis)
    lp = torch.log_softmax(logits, dim=-1)
    ll = lp.gather(-1, labels.long()[..., None])[..., 0]
    return -ll.mean()


def make_train_step(cfg: BertConfig, mesh, lr=1e-3, use_sp=True, params=None,
                    device=None):
    """The sharded training step (Adam) over ``mesh`` (axes 'dp' and
    'tp'): ``(step, params, opt_state)``.

    ``params`` and ``opt_state`` ("m", "v" and the step count "t") hold
    this rank's blocks, and the rank keeps no whole copy; ``step(params,
    opt_state, tokens, labels) -> (loss, params, opt_state)`` takes the
    global batch (the same on every rank), computes from the blocks,
    updates them in place and returns the global mean loss. ``params``:
    the whole starting tree (see :func:`init_params`, which makes it from
    ``seed`` 0 without one); ``device`` as there."""
    specs = param_specs(cfg)
    whole = init_params(cfg, params=params, device=device)
    w_leaves = _layout.tree_leaves(whole)
    cspecs = [_layout.live_spec(_layout.clean_spec(s, w.dim(), mesh), mesh)
              for s, w in zip(_spec_leaves(specs), w_leaves)]
    blocks = [_layout.local_slice(w, c, mesh).clone()
              for w, c in zip(w_leaves, cspecs)]
    params = _layout.tree_rebuild(_layout.tree_map(lambda a: None, whole),
                                  iter(blocks))
    del whole, w_leaves
    opt_state = {"m": _layout.tree_map(torch.zeros_like, params),
                 "v": _layout.tree_map(torch.zeros_like, params),
                 "t": torch.zeros((), dtype=torch.int64,
                                  device=blocks[0].device)}
    dp_axis = "dp" if "dp" in mesh.shape else None
    tp_axis = "tp" if "tp" in mesh.shape else None
    sp_axis = "tp" if use_sp else None
    b1, b2, eps = 0.9, 0.999, 1e-8

    def step(params, opt_state, tokens, labels):
        from ..parallel.mesh import mesh_scope

        dev = blocks[0].device
        tokens = torch.as_tensor(tokens, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        if dp_axis is not None:
            tokens = _layout.split_batch(tokens, mesh, dp_axis)
            labels = _layout.split_batch(labels, mesh, dp_axis)
        p_blocks = _layout.tree_leaves(params)
        leaves = [b.detach().requires_grad_(True) for b in p_blocks]
        tree = _layout.tree_rebuild(params, iter(leaves))
        found = {}
        with mesh_scope(mesh), _layout.tensor_parallel(mesh, tp_axis), \
                _layout.partial_grads(found), torch.enable_grad():
            loss = loss_fn(tree, tokens, labels, cfg, sp_axis=sp_axis)
            grads = torch.autograd.grad(loss, leaves)
        vals = list(grads) + [loss.detach().reshape(1)]
        partial = [i for i, f in enumerate(leaves) if id(f) in found]
        if partial:
            # the shares the rank's rows of the sequence left (SP)
            _layout.flat_all_reduce(vals, partial,
                                    mesh.group(found[id(leaves[partial[0]])]),
                                    "sum")
        if dp_axis is not None and mesh.group(dp_axis) is not None:
            _layout.flat_all_reduce(vals, range(len(vals)),
                                    mesh.group(dp_axis), "mean")
        loss = vals[-1].reshape(())
        opt_state["t"] += 1
        tf = opt_state["t"].to(torch.float32)
        with torch.no_grad():
            for p, g, m, v in zip(
                    p_blocks, vals[:-1], _layout.tree_leaves(opt_state["m"]),
                    _layout.tree_leaves(opt_state["v"])):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                mhat = m / (1 - torch.pow(b1, tf))
                vhat = v / (1 - torch.pow(b2, tf))
                p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
        return loss, params, opt_state

    return step, params, opt_state


def _spec_leaves(specs):
    """The spec tree's leaves, in the parameter tree's order (a spec is a
    tuple, so it is a leaf here, not a branch)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for t in specs for s in _spec_leaves(t)]
    return [specs]


def _gather_params(params, cfg: BertConfig, mesh):
    """The whole parameter tree from this rank's blocks (every rank calls
    it)."""
    whole_shapes = _layout.tree_leaves(init_params(
        cfg, device=_layout.tree_leaves(params)[0].device))
    cspecs = [_layout.live_spec(_layout.clean_spec(s, w.dim(), mesh), mesh)
              for s, w in zip(_spec_leaves(param_specs(cfg)), whole_shapes)]
    full = [_layout.gather_full(b, c, w.shape, mesh)
            for b, c, w in zip(_layout.tree_leaves(params), cspecs,
                               whole_shapes)]
    return _layout.tree_rebuild(params, iter(full))
