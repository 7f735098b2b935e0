"""Pipeline parallelism: the GPipe schedule over a ``pp`` mesh axis (port
of `incubator_mxnet_tpu/parallel/pipeline.py`: `pipeline_stage_params`
:27, `pipeline_apply` :44, `PipelineParallel` :106).

Each rank holds one stage's parameters. For S stages and M microbatches
the schedule runs S + M - 1 ticks; at tick t stage s works on
microbatch t - s, and each tick's activations go to the next stage with
``ring_permute`` (`collectives`). The reference differentiates its
`lax.scan` and gets the reversed schedule from the transposes; with one
process per rank the backward is written out: the ticks run in reverse,
each stage backpropagates its tick through the graph it kept, and the
activation gradients go back one stage with the inverse permute, so
every rank makes the same exchanges in the same order and the
microbatches' parameter gradients add up. A tick with no microbatch on a
stage (the fill and the drain) computes nothing.

Parameters are trees (dicts, lists and tuples) of tensors.
"""
from __future__ import annotations

import torch

from . import collectives as _coll
from ._layout import tree_leaves as _leaves
from ._layout import tree_map as _map
from ._layout import tree_rebuild as _rebuild
from .mesh import mesh_scope

__all__ = ["PipelineParallel", "pipeline_apply", "pipeline_stage_params"]


def pipeline_stage_params(params_per_layer, n_stages):
    """Per-layer parameter trees stacked into per-stage stacks: the layers
    are split in order into ``n_stages`` groups of L/S, and each leaf
    gains a leading (S, L/S) pair of axes."""
    n_layers = len(params_per_layer)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{n_stages} stages")
    per = n_layers // n_stages
    stacked = _map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                   *params_per_layer)
    return _map(lambda x: x.reshape((n_stages, per) + tuple(x.shape[1:])),
                stacked)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, tree, mesh, axis, x, *leaves):
        group = mesh.group(axis)
        n_stages, stage = mesh.axis_size(axis), mesh.coordinate(axis)
        n_micro = x.shape[0]
        ticks = n_stages + n_micro - 1
        kept = []           # (tick, act_in, act_out) of each live tick
        outputs = torch.zeros_like(x)
        recv = torch.zeros_like(x[0])
        with torch.enable_grad():
            ps = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
            params = _rebuild(tree, iter(ps))
            for t in range(ticks):
                mb = t - stage
                if 0 <= mb < n_micro:
                    act_in = (x[mb] if stage == 0 else recv).detach()
                    act_in.requires_grad_(True)
                    act_out = stage_fn(params, act_in)
                    kept.append((t, act_in, act_out))
                    sent = act_out.detach()
                    if stage == n_stages - 1:
                        outputs[mb] = sent
                else:
                    sent = torch.zeros_like(recv)
                if t < ticks - 1:
                    recv = _coll._raw_ring_permute(sent, group, 1)
        ctx.state = (kept, ps, group, n_stages, stage, n_micro, ticks)
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        kept, ps, group, n_stages, stage, n_micro, ticks = ctx.state
        by_tick = {t: (a_in, a_out) for t, a_in, a_out in kept}
        grads = [torch.zeros_like(p) for p in ps]
        g_next = None       # the next stage's gradient of what we sent
        for t in reversed(range(ticks)):
            mb = t - stage
            g_in = None
            if t in by_tick:
                a_in, a_out = by_tick[t]
                g = g_out[mb] if stage == n_stages - 1 else None
                if g_next is not None:
                    g = g_next if g is None else g + g_next
                if g is not None:
                    want = [a_in] + [p for p in ps if p.requires_grad]
                    got = torch.autograd.grad(a_out, want, g,
                                              allow_unused=True)
                    g_in = got[0]
                    it = iter(got[1:])
                    for i, p in enumerate(ps):
                        if p.requires_grad:
                            gp = next(it)
                            if gp is not None:
                                grads[i] += gp
            if t > 0:
                back = (g_in if (g_in is not None and stage > 0)
                        else torch.zeros_like(g_out[0]))
                g_next = _coll._raw_ring_permute(back, group, -1)
        ctx.state = None
        return (None, None, None, None, None) + tuple(grads)


def pipeline_apply(stage_fn, stage_params, x, axis_name="pp"):
    """Run the GPipe schedule over ``axis_name`` of the active mesh.

    - ``stage_fn(params, act) -> act``: one stage's forward of one
      microbatch (shape-preserving), with this rank's stage parameters.
    - ``stage_params``: this rank's stage parameters (a tree of tensors).
    - ``x``: (n_micro, micro_batch, ...), the same on every rank.

    Returns the (n_micro, micro_batch, ...) outputs, valid on the last
    stage (zeros elsewhere). Differentiable in the stage parameters."""
    from .collectives import _mesh

    mesh = _mesh()
    leaves = _leaves(stage_params)
    _coll._census("ring_permute", axis_name, x[0])
    return _GPipe.apply(stage_fn, stage_params, mesh, axis_name, x, *leaves)


class PipelineParallel:
    """The GPipe trainer over a ``pp`` mesh axis: forward, backward and
    the optimizer through the pipeline schedule.

    Usage::

        stage_params = pipeline_stage_params(layer_params, n_stages)
        pp = PipelineParallel(stage_fn, stage_params, loss_fn,
                              optimizer.SGD(learning_rate=0.1), mesh)
        loss = pp.step(x_micro, y)    # x_micro: (n_micro, micro_b, ...)

    ``stage_params`` holds every stage (leading axis S, the same on every
    rank); each rank keeps its stage's slice and its optimizer state.
    ``loss_fn(outs, y)`` maps the (n_micro, ...) outputs to a scalar; the
    last stage's is the loss, and the microbatches' gradients are summed
    into each stage's parameters. ``params`` is the whole stacked tree,
    gathered from the stages."""

    def __init__(self, stage_fn, stage_params, loss_fn, optimizer, mesh,
                 axis_name="pp"):
        self.mesh = mesh
        self.axis_name = axis_name
        self.optimizer = optimizer
        self._stage_fn = stage_fn
        self._loss_fn = loss_fn
        self._t = 0
        stage = mesh.coordinate(axis_name)
        self._tree = stage_params
        self._local = [torch.as_tensor(a)[stage].detach().clone()
                       for a in _leaves(stage_params)]
        self.opt_states = [optimizer.create_state(i, a)
                           for i, a in enumerate(self._local)]

    @property
    def params(self):
        """The whole (S, ...) stacked parameter tree."""
        group = self.mesh.group(self.axis_name)
        whole = [_coll._raw_all_gather(a.unsqueeze(0), group, 0)
                 for a in self._local]
        return _rebuild(self._tree, iter(whole))

    def step(self, x, y):
        """One GPipe training step; returns the loss (the last stage's,
        on every rank)."""
        from ..ndarray.ndarray import NDArray

        nd = isinstance(x, NDArray)
        x = x._data if nd else torch.as_tensor(x)
        y = y._data if isinstance(y, NDArray) else torch.as_tensor(y)
        self._t += 1
        ps = [a.detach().requires_grad_(True) for a in self._local]
        tree = _rebuild(self._tree, iter(ps))
        last = self.mesh.coordinate(self.axis_name) == \
            self.mesh.axis_size(self.axis_name) - 1
        with mesh_scope(self.mesh), torch.enable_grad():
            outs = pipeline_apply(self._stage_fn, tree, x, self.axis_name)
            loss = self._loss_fn(outs, y) * (1.0 if last else 0.0)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
            loss = _coll.all_reduce(loss.detach(), self.axis_name)
        opt = self.optimizer
        with torch.no_grad():
            for i, (w, g) in enumerate(zip(self._local, grads)):
                opt.step(w, torch.zeros_like(w) if g is None else g,
                         self.opt_states[i], opt.learning_rate, opt.wd,
                         self._t)
        return NDArray(loss) if nd else loss
