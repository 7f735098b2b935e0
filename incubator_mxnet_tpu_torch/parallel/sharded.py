"""The compiled training step (port of `incubator_mxnet_tpu/parallel/
sharded.py`: `_build_pure_step` :19, `DataParallel` :194), on one card.

The reference compiles the whole step, forward, backward and the
optimizer over every parameter, into one XLA program and calls it once a
step. The port's counterpart of that program is a CUDA graph: the first call
of an input signature runs the step eagerly (a real step, on a side
stream, so that everything a kernel wrapper does once has happened), the
second captures it and replays the capture, and every later call of the
signature copies its batch into the capture's input buffers and replays
it. A capture that fails raises
:class:`MXNetError`; nothing falls back to the eager loop.

What the reference passes into its program as traced values lives here in
device buffers the graph reads when it replays: the step counter ``t``
(Adam's bias correction and the dropout keys), ``lr`` and ``wd``
(uploaded only when they change, so `set_learning_rate` takes effect with
no new capture) and the base key. The dropout keys are folded on the
card from the base key and ``t`` (`random.trace_key_scope`,
`ops._philox.fold`), as the reference folds ``t`` into its base key
(:123), so each replay drops other elements. Parameters and optimizer
states are updated in place (the reference donates them, :287), so the
``nn.Module`` is current between steps.

Every trainable parameter is updated: one the loss does not reach (BERT's
NSP head under an MLM loss) gets a zero gradient, and moves where
``wd > 0``, as in the reference. Small parameters (float32, at most 2^14
elements, at least two of them, an ``elementwise`` optimizer) are updated
together by `Optimizer.step_multi`, the reference's concatenated segment
(:85-113); the rule is elementwise, so the numbers are those of the
per-parameter update.

On a CPU net the same step function runs eagerly on the plain versions
(the tests). ``mesh``, ``param_shardings``, ``remat``, `rebuild` and
`shardcheck_report` are not ported yet (`ROADMAP.md` §1 items 7 and 10).
"""
from __future__ import annotations

import os

import torch

from .. import amp
from .. import random as _random
from ..base import MXNetError

__all__ = ["DataParallel"]

_SMALL = 1 << 14
_EAGER_STEPS = 1  # a signature's eager steps before its capture
_NOT_PORTED = "is not ported yet (ROADMAP.md §1 item 7: the mesh paths)"


def _fusion_off():
    # MXNET_OPTIMIZER_AGGREGATION_SIZE <= 1 disables the small-parameter
    # segment, as in the reference
    agg = os.environ.get("MXNET_OPTIMIZER_AGGREGATION_SIZE")
    return agg is not None and agg.isdigit() and int(agg) <= 1


def _fused_indices(params, states, optimizer):
    """Indices of the small-parameter segment (the reference's `_fusable`),
    or [] when fewer than two qualify."""
    if _fusion_off() or not getattr(optimizer, "elementwise", False):
        return []
    idx = [i for i, (p, s) in enumerate(zip(params, states))
           if p.numel() <= _SMALL and p.dtype == torch.float32
           and isinstance(s, list)
           and all(isinstance(x, torch.Tensor) and x.shape == p.shape
                   for x in s)]
    return idx if len(idx) >= 2 else []


class _TrainMode:
    """Every module of ``net`` in training mode for the step, as the
    reference's ``autograd.pause(train_mode=True)``; each mode restored
    after."""

    def __init__(self, net):
        self._net = net

    def __enter__(self):
        self._modes = [(m, m.training) for m in self._net.modules()]
        self._net.train(True)

    def __exit__(self, *exc):
        for m, mode in self._modes:
            m.training = mode
        return False


def _build_pure_step(net, loss_fn, optimizer, states):
    """``(step, update, params, fused)``. ``step(t, lr, wd, base_key, x, y)
    -> loss`` is the reference's pure step with the parameters and
    ``states`` updated in place and ``t`` incremented in place; ``t``
    (int64), ``lr``, ``wd`` (float64) and ``base_key`` (two int64 words)
    are tensors on the net's device. ``update(grads, t, lr, wd)`` is its
    optimizer part; ``fused`` the small-parameter segment's indices."""
    params = [p for p in net.parameters() if p.requires_grad]
    fused = _fused_indices(params, states, optimizer)
    rest = sorted(set(range(len(params))) - set(fused))

    @torch.no_grad()
    def update(grads, t, lr, wd):
        optimizer.step_multi([params[i] for i in fused],
                             [grads[i] for i in fused],
                             [states[i] for i in fused], lr, wd, t)
        for i in rest:
            optimizer.step(params[i], grads[i], states[i], lr, wd, t)

    def step(t, lr, wd, base_key, x, y):
        # the step differentiates whatever autograd mode its caller is in
        with torch.enable_grad(), _TrainMode(net), \
                _random.trace_key_scope(base_key, t):
            loss = loss_fn(net(x), y).mean()
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        update([torch.zeros_like(p) if g is None else g
                for p, g in zip(params, grads)], t, lr, wd)
        with torch.no_grad():
            t.add_(1)
        return loss.detach()

    return step, update, params, fused


class _Capture:
    """One input signature's graph and its static buffers."""

    def __init__(self, x, y):
        self.x, self.y = x.clone(), y.clone()
        self.calls = 0
        self.graph = None
        self.loss = None


class DataParallel:
    """The compiled training step of a net on one card.

    Usage::

        dp = DataParallel(net, loss_fn, optimizer.Adam(1e-4))
        loss = dp.step(x_batch, y_batch)   # updates net's parameters

    ``step`` differentiates ``loss_fn(net(x), y).mean()`` and applies the
    optimizer to every trainable parameter. On the card there is one graph
    for each input signature (shape and dtype of x and y, AMP on or off);
    ``captures`` counts them."""

    def __init__(self, net, loss_fn, optimizer, mesh=None,
                 param_shardings=None, remat=None):
        if mesh is not None:
            raise MXNetError(f"DataParallel: mesh {_NOT_PORTED}")
        if param_shardings is not None:
            raise MXNetError(f"DataParallel: param_shardings {_NOT_PORTED}")
        if remat is not None:
            raise MXNetError("DataParallel: remat is not ported yet "
                             "(ROADMAP.md §1 item 10)")
        params = [p for p in net.parameters() if p.requires_grad]
        if not params:
            raise MXNetError("DataParallel: the net has no trainable "
                             "parameters")
        self.net = net
        self.optimizer = optimizer
        self.device = params[0].device
        self.opt_states = [optimizer.create_state(i, p)
                           for i, p in enumerate(params)]
        (self._step_fn, self._update_fn, self.params,
         self._fused) = _build_pure_step(net, loss_fn, optimizer,
                                         self.opt_states)
        dev = self.device
        self._t_dev = torch.ones((), dtype=torch.int64, device=dev)
        self._lr_dev = torch.zeros((), dtype=torch.float64, device=dev)
        self._wd_dev = torch.zeros((), dtype=torch.float64, device=dev)
        self._base_key = torch.zeros(2, dtype=torch.int64, device=dev)
        self._host = {"lr": None, "wd": None}
        self._key_epoch = None
        self._captures: dict = {}
        self.captures = 0
        self._side = None

    def _set_scalar(self, name, value):
        """Upload ``lr`` or ``wd`` only when it changed since the last step
        (into the same buffer, which the graphs read)."""
        if self._host[name] != value:
            getattr(self, f"_{name}_dev").fill_(value)
            self._host[name] = value

    def _prepare(self):
        """The step's device arguments, refreshed from the host's values."""
        self._set_scalar("lr", float(self.optimizer.learning_rate))
        self._set_scalar("wd", float(self.optimizer.wd))
        if self._key_epoch != _random.seed_epoch():
            # a new base key after mx.random.seed(), so a re-seed changes
            # the dropout streams (reference semantics)
            self._base_key.copy_(torch.tensor(_random.next_key()))
            self._key_epoch = _random.seed_epoch()
        return self._t_dev, self._lr_dev, self._wd_dev, self._base_key

    def step(self, x, y):
        """One training step on the batch ``(x, y)``; returns the mean loss
        (a 0-dim tensor of its own)."""
        self.optimizer.num_update += 1
        args = self._prepare()
        x = torch.as_tensor(x, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        if self.device.type != "cuda":
            return self._step_fn(*args, x, y)
        sig = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               amp.amp_active(), amp.amp_active() and amp.amp_dtype())
        cap = self._captures.get(sig)
        if cap is None:
            cap = self._captures[sig] = _Capture(x, y)
        else:
            cap.x.copy_(x)
            cap.y.copy_(y)
        cap.calls += 1
        if cap.calls <= _EAGER_STEPS:
            return self._eager(cap, args)
        if cap.graph is None:
            self._capture(cap, args)
        cap.graph.replay()
        return cap.loss.clone()

    def _eager(self, cap, args):
        """A warm-up step: the step function on a side stream."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            loss = self._step_fn(*args, cap.x, cap.y).clone()
        main.wait_stream(self._side)
        return loss

    def _capture(self, cap, args):
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                cap.loss = self._step_fn(*args, cap.x, cap.y)
        except Exception as e:
            self.optimizer.num_update -= 1
            cap.calls -= 1
            raise MXNetError(f"DataParallel: capturing the step as a CUDA "
                             f"graph failed: {e}") from e
        cap.graph = graph
        self.captures += 1

    def rebuild(self, *args, **kwargs):  # noqa: ARG002
        raise MXNetError(f"DataParallel.rebuild {_NOT_PORTED}")

    def shardcheck_report(self, *args, **kwargs):  # noqa: ARG002
        raise MXNetError(f"DataParallel.shardcheck_report {_NOT_PORTED}")
