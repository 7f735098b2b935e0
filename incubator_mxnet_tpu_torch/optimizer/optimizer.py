"""Optimizers (port of `incubator_mxnet_tpu/optimizer/optimizer.py`:
`Optimizer` :45, the rules :219-680, `Updater` :616).

The reference's rules are pure functions that return new weights and
states; the port updates each weight and its state in place under
``torch.no_grad()``, because the captured CUDA graphs of the port read
parameters by address (and it saves a copy of every parameter a step).
The arithmetic is the reference's, op for op: ``rescale_grad`` and
``clip_gradient`` in `_preprocess`, weight decay as the rule takes it,
per-index update counts (from ``begin_num_update``) for the bias
corrections, ``lr_scheduler``, and the per-parameter multipliers
(``Parameter.lr_mult``/``wd_mult`` through ``param_dict``, and
`set_lr_mult`/`set_wd_mult` by name).

:meth:`Optimizer.step` takes ``lr``, ``wd`` and ``t`` as Python numbers
(`gluon.Trainer`, `update`) or as 0-dim tensors on the weights' device
(`parallel.DataParallel`, whose step is replayed as a CUDA graph: the
bias corrections are then computed on the card from the device's ``t``,
as the reference computes them with ``jnp`` from a traced ``t``). Nadam's
momentum schedule (a product over every step so far) and SGLD's noise
are not replayable and raise for a device ``t``. Rules that take
per-tensor statistics (LAMB, LANS, LARS, GroupAdaGrad) set
``elementwise = False``. Those whose statistics are 2-norms (LAMB, LANS,
LARS) declare ``norm_combine = "sum_of_squares"``: on a parameter stored
as its block on a mesh (`parallel.DataParallel`), `block_norms` sums each
norm's squares over the cut axes, so every rank's trust ratio is the
whole tensor's. :meth:`Optimizer.step_multi` updates a list of
parameters at once: `DataParallel`'s small-parameter segment.

``multi_precision`` keeps an f32 master copy of each float16 weight, as
the reference does (:133-137, :190-200): the state is ``(master,
inner_state)``, the rule runs on the master with the gradient in f32,
and the weight's tensor takes the master's cast to float16, in place.
The lazy row-sparse update raises: ROADMAP.md §1 item 11b.
"""
from __future__ import annotations

import math
import pickle
import threading

import numpy as onp
import torch

from .. import random as _random


class _Norms(threading.local):
    def __init__(self):
        self.groups = None   # process groups of a block's cut axes


_NORMS = _Norms()


class block_norms:
    """The per-tensor norms of the rule at hand are those of a whole
    tensor whose block this rank holds: each sum of squares is summed over
    ``groups`` (the cut axes' process groups; None members are axes of one
    rank)."""

    def __init__(self, groups):
        self.groups = [g for g in groups if g is not None]

    def __enter__(self):
        self.saved = _NORMS.groups
        _NORMS.groups = self.groups or None
        return self

    def __exit__(self, *exc):
        _NORMS.groups = self.saved
        return False


def _norm(x):
    """The 2-norm of ``x``, or under `block_norms` of the whole tensor
    ``x`` is this rank's block of."""
    groups = _NORMS.groups
    if groups is None:
        return torch.linalg.vector_norm(x)
    from ..parallel import collectives as _coll

    sq = torch.sum(x * x)
    for g in groups:
        sq = _coll._raw_all_reduce(sq, g, "sum")
    return torch.sqrt(sq)
from ..base import MXNetError

__all__ = [
    "Optimizer", "create", "register", "SGD", "NAG", "Adam", "AdamW",
    "AdaBelief", "AdaDelta", "AdaGrad", "Adamax", "DCASGD", "FTML", "FTRL",
    "LAMB", "LANS", "LARS", "Nadam", "RMSProp", "SGLD", "Signum",
    "GroupAdaGrad", "Ftrl", "Updater", "get_updater",
]


def _tensor(x):
    """The tensor of an NDArray (or the tensor itself)."""
    return getattr(x, "_data", x) if not isinstance(x, torch.Tensor) else x


def _pow(base, t):
    """``base ** t`` for a host ``t``, or as a float64 tensor for a device
    ``t`` (no sync)."""
    if isinstance(t, torch.Tensor):
        return torch.pow(base, t.double())
    return base ** t


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


class Optimizer:
    """Base optimizer (reference: `python/mxnet/optimizer/optimizer.py:29`)."""

    #: how a per-tensor statistic combines over a parameter's blocks (None:
    #: the rule has none, or cannot combine them)
    norm_combine = None

    #: True when `step` is a purely per-element rule: `DataParallel` may
    #: then update its small parameters together (`step_multi`). Rules
    #: taking per-tensor statistics (LARS/LAMB trust ratios) opt out.
    elementwise = True

    opt_registry: dict = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None,
                 aggregate_num=0, use_fused_step=True, **kwargs):  # noqa: ARG002
        self.rescale_grad = rescale_grad
        self.lr = 0.01 if learning_rate is None else learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: dict = {}
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num
        self.param_dict = param_dict or {}
        self.idx2name = param_idx2name or {}
        self.lr_mult: dict = {}
        self.wd_mult: dict = {}

    # -- registry -----------------------------------------------------------
    @staticmethod
    def register(cls):
        Optimizer.opt_registry[cls.__name__.lower()] = cls
        return cls

    @staticmethod
    def create_optimizer(name, **kwargs):
        key = name.lower()
        if key not in Optimizer.opt_registry:
            raise ValueError(f"unknown optimizer {name!r}")
        return Optimizer.opt_registry[key](**kwargs)

    # -- lr / wd ------------------------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been defined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _get_lr(self, index):
        lr = self.learning_rate
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            lr *= self.param_dict[name].lr_mult
        return lr * self.lr_mult.get(name, 1.0)

    def _get_wd(self, index):
        wd = self.wd
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            wd *= self.param_dict[name].wd_mult
        return wd * self.wd_mult.get(name, 1.0)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    # -- state --------------------------------------------------------------
    def create_state(self, index, weight):  # noqa: ARG002
        return None

    def create_state_multi_precision(self, index, weight):
        """``(master, inner_state)`` for a float16 weight under
        ``multi_precision``: the master an f32 copy, the inner state made
        for it; else :meth:`create_state`."""
        w = _tensor(weight)
        if self.multi_precision and w.dtype == torch.float16:
            master = w.detach().float()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # -- update -------------------------------------------------------------
    def _preprocess(self, grad):
        """The rescaled, clipped gradient (a new tensor)."""
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g

    def update(self, index, weight, grad, state):
        """Update one parameter in place (its state too); ``weight`` and
        ``grad`` are NDArrays or tensors."""
        if isinstance(index, (list, tuple)):
            for i, w, g, s in zip(index, weight, grad, state):
                self.update(i, w, g, s)
            return
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        with torch.no_grad():
            self.step(_tensor(weight), _tensor(grad), state, lr, wd, t)
        if not isinstance(weight, torch.Tensor):
            weight._version += 1

    def _sparse_update(self, weight, grad, state, lr, wd, t):  # noqa: ARG002
        raise MXNetError("the lazy row-sparse update is not ported "
                         "(ROADMAP.md §1 item 11b, ndarray/sparse.py)")

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update` on the f32 master of a float16 weight (a state
        from :meth:`create_state_multi_precision`) with the gradient in
        f32, then the weight's tensor set to the master's cast, in place;
        any other weight and state take :meth:`update`."""
        w = _tensor(weight)
        if self.multi_precision and isinstance(state, tuple) \
                and len(state) == 2 and isinstance(state[0], torch.Tensor) \
                and state[0].dtype == torch.float32 \
                and w.dtype == torch.float16:
            master, inner = state
            self.update(index, master, _tensor(grad).float(), inner)
            with torch.no_grad():
                w.copy_(master)
            if not isinstance(weight, torch.Tensor):
                weight._version += 1
            return state
        return self.update(index, weight, grad, state)

    def step(self, w, g, state, lr, wd, t):
        """Update ``w`` and ``state`` in place; ``lr``, ``wd`` and ``t``
        are numbers or 0-dim tensors on the weight's device."""
        raise NotImplementedError

    def step_multi(self, weights, grads, states, lr, wd, t):
        """:meth:`step` of each parameter of the lists, the same numbers
        (an optimizer may update them together)."""
        for w, g, s in zip(weights, grads, states):
            self.step(w, g, s, lr, wd, t)

    def __repr__(self):
        return f"{type(self).__name__}(learning_rate={self.learning_rate})"


register = Optimizer.register
create = Optimizer.create_optimizer


def _zeros_like(w):
    return torch.zeros_like(_tensor(w))


def _add_wd(g, w, wd):
    """``g + wd * w`` in place of ``g`` (a device ``wd`` always adds)."""
    if isinstance(wd, torch.Tensor):
        g.add_(w * wd)
    elif wd:
        g.add_(w * wd)
    return g


@register
class SGD(Optimizer):
    """SGD with momentum (reference: optimizer/sgd.py; kernel optimizer_op.cc)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False, **kwargs):  # noqa: ARG002
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return [_zeros_like(weight)] if self.momentum != 0.0 else []

    def step(self, w, g, state, lr, wd, t):  # noqa: ARG002
        g = _add_wd(self._preprocess(g), w, wd)
        if self.momentum != 0.0:
            mom = state[0]
            mom.mul_(self.momentum).sub_(lr * g)
            w.add_(mom)
            return
        w.sub_(lr * g)


@register
class NAG(SGD):
    """Nesterov accelerated SGD."""

    def step(self, w, g, state, lr, wd, t):  # noqa: ARG002
        g = _add_wd(self._preprocess(g), w, wd)
        if self.momentum != 0.0:
            mom = state[0]
            mom.mul_(self.momentum).add_(g)
            w.sub_(lr * (g + self.momentum * mom))
            return
        w.sub_(lr * g)


@register
class Adam(Optimizer):
    """Adam with the reference's update: g += wd * w,
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    w -= lr sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=False, **kwargs):  # noqa: ARG002
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return [_zeros_like(weight), _zeros_like(weight)]

    def _lr_t(self, lr, t):
        """The bias-corrected rate: from a device ``t`` by torch ops in
        float64 (no sync; the value the host's math gives)."""
        if isinstance(t, torch.Tensor):
            t = t.double()
            return (lr * torch.sqrt(1 - torch.pow(self.beta2, t))
                    / (1 - torch.pow(self.beta1, t)))
        return lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)

    def step(self, w, g, state, lr, wd, t):
        g = _add_wd(self._preprocess(g), w, wd)
        m, v = state
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        w.sub_(self._lr_t(lr, t) * m / (v.sqrt() + self.epsilon))

    def step_multi(self, weights, grads, states, lr, wd, t):
        """:meth:`step` over the lists with ``torch._foreach_*`` ops: each
        element takes the same operations in the same order, so the
        numbers are :meth:`step`'s, and the bias correction is computed
        once. A subclass with a rule of its own updates one parameter at
        a time."""
        if type(self).step is not Adam.step:
            Optimizer.step_multi(self, weights, grads, states, lr, wd, t)
            return
        if not weights:
            return
        g = torch._foreach_mul(list(grads), self.rescale_grad)
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(g, -self.clip_gradient)
            torch._foreach_clamp_max_(g, self.clip_gradient)
        if isinstance(wd, torch.Tensor) or wd:
            torch._foreach_add_(g, torch._foreach_mul(list(weights), wd))
        m = [s[0] for s in states]
        v = [s[1] for s in states]
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, g, alpha=1 - self.beta1)
        torch._foreach_mul_(v, self.beta2)
        torch._foreach_addcmul_(v, g, g, value=1 - self.beta2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.epsilon)
        lr_t = self._lr_t(lr, t)
        num = torch._foreach_mul(m, lr_t)
        torch._foreach_sub_(list(weights), torch._foreach_div(num, denom))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (reference: contrib adamw op)."""

    def step(self, w, g, state, lr, wd, t):
        g = self._preprocess(g)
        m, v = state
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        mhat = m / (1 - _pow(self.beta1, t))
        vhat = v / (1 - _pow(self.beta2, t))
        w.sub_(lr * (mhat / (torch.sqrt(vhat) + self.epsilon) + wd * w))


@register
class AdaBelief(Adam):
    def step(self, w, g, state, lr, wd, t):
        g = _add_wd(self._preprocess(g), w, wd)
        m, s = state
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        s.mul_(self.beta2).add_((1 - self.beta2) * (g - m) ** 2) \
            .add_(self.epsilon)
        w.sub_(self._lr_t(lr, t) * m / (torch.sqrt(s) + self.epsilon))


@register
class AdaDelta(Optimizer):
    def __init__(self, learning_rate=1.0, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return [_zeros_like(weight), _zeros_like(weight)]

    def step(self, w, g, state, lr, wd, t):  # noqa: ARG002
        g = _add_wd(self._preprocess(g), w, wd)
        acc_g, acc_d = state
        acc_g.mul_(self.rho).add_((1 - self.rho) * g * g)
        delta = torch.sqrt(acc_d + self.epsilon) \
            / torch.sqrt(acc_g + self.epsilon) * g
        acc_d.mul_(self.rho).add_((1 - self.rho) * delta * delta)
        w.sub_(lr * delta)


@register
class AdaGrad(Optimizer):
    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return [_zeros_like(weight)]

    def step(self, w, g, state, lr, wd, t):  # noqa: ARG002
        g = _add_wd(self._preprocess(g), w, wd)
        hist = state[0]
        hist.add_(g * g)
        w.sub_(lr * g / (torch.sqrt(hist) + self.epsilon))


@register
class Adamax(Adam):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1, beta2=beta2,
                         **kwargs)

    def step(self, w, g, state, lr, wd, t):
        g = _add_wd(self._preprocess(g), w, wd)
        m, u = state
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        torch.maximum(self.beta2 * u, g.abs(), out=u)
        w.sub_(lr / (1 - _pow(self.beta1, t)) * m / (u + self.epsilon))


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (reference: optimizer/dcasgd.py)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return [_zeros_like(weight), _tensor(weight).detach().clone()]

    def step(self, w, g, state, lr, wd, t):  # noqa: ARG002
        g = self._preprocess(g)
        mom, prev_w = state
        g = g + wd * w + self.lamda * g * g * (w - prev_w)
        mom.mul_(self.momentum).sub_(lr * g)
        w.add_(mom)
        prev_w.copy_(w)


@register
class FTML(Optimizer):
    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return [_zeros_like(weight), _zeros_like(weight), _zeros_like(weight)]

    def step(self, w, g, state, lr, wd, t):
        g = _add_wd(self._preprocess(g), w, wd)
        d_prev, v, z = state
        v.mul_(self.beta2).add_((1 - self.beta2) * g * g)
        d = (1 - _pow(self.beta1, t)) / lr * (
            torch.sqrt(v / (1 - _pow(self.beta2, t))) + self.epsilon)
        sigma = d - self.beta1 * d_prev
        z.mul_(self.beta1).add_((1 - self.beta1) * g).sub_(sigma * w)
        w.copy_(-z / d)
        d_prev.copy_(d)


@register
class FTRL(Optimizer):
    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return [_zeros_like(weight), _zeros_like(weight)]

    def step(self, w, g, state, lr, wd, t):  # noqa: ARG002
        g = self._preprocess(g)
        z, n = state
        n_new = n + g * g
        sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
        z.add_(g - sigma * w)
        new_w = torch.where(
            z.abs() > self.lamda1,
            -(z - torch.sign(z) * self.lamda1)
            / ((self.beta + torch.sqrt(n_new)) / lr + wd),
            torch.zeros_like(z))
        w.copy_(new_w)
        n.copy_(n_new)


@register
class LAMB(Optimizer):
    elementwise = False   # per-tensor trust ratio
    norm_combine = "sum_of_squares"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return [_zeros_like(weight), _zeros_like(weight)]

    def step(self, w, g, state, lr, wd, t):
        g = self._preprocess(g)
        m, v = state
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        if self.bias_correction:
            mhat = m / (1 - _pow(self.beta1, t))
            vhat = v / (1 - _pow(self.beta2, t))
        else:
            mhat, vhat = m, v
        update = mhat / (torch.sqrt(vhat) + self.epsilon) + wd * w
        wnorm = _norm(w)
        unorm = _norm(update)
        one = torch.ones_like(wnorm)
        ratio = torch.where(unorm > 0,
                            torch.where(wnorm > 0, wnorm / unorm, one), one)
        if self.lower_bound is not None:
            ratio = torch.clamp(ratio, min=self.lower_bound)
        if self.upper_bound is not None:
            ratio = torch.clamp(ratio, max=self.upper_bound)
        w.sub_(lr * ratio * update)


@register
class LANS(LAMB):
    """LAMB with per-layer gradient normalization (reference: lans.py)."""

    def step(self, w, g, state, lr, wd, t):
        gnorm = _norm(g * self.rescale_grad)
        g = g / torch.clamp(gnorm, min=1e-12) / max(self.rescale_grad, 1e-30)
        LAMB.step(self, w, g, state, lr, wd, t)


@register
class LARS(Optimizer):
    elementwise = False   # per-tensor trust ratio
    norm_combine = "sum_of_squares"

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        return [_zeros_like(weight)]

    def step(self, w, g, state, lr, wd, t):  # noqa: ARG002
        g = self._preprocess(g)
        wnorm = _norm(w)
        gnorm = _norm(g)
        trust = torch.where(
            (wnorm > 0) & (gnorm > 0),
            self.eta * wnorm / (gnorm + wd * wnorm + self.epsilon),
            torch.ones_like(wnorm))
        mom = state[0]
        mom.mul_(self.momentum).add_(trust * lr * (g + wd * w))
        w.sub_(mom)


@register
class Nadam(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kwargs)
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def _mu(self, i):
        return self.beta1 * (1 - 0.5 * 0.96 ** (i * self.schedule_decay))

    def step(self, w, g, state, lr, wd, t):
        if isinstance(t, torch.Tensor):
            raise MXNetError("Nadam: the momentum schedule is a product over "
                             "every step so far; a replayed step (a device "
                             "t) cannot take it")
        g = _add_wd(self._preprocess(g), w, wd)
        m, v = state
        momentum_t = self._mu(t)
        momentum_t1 = self._mu(t + 1)
        # m_schedule(t) = prod_{i<=t} mu_i, in the weight's dtype as the
        # reference's loop accumulates it
        m_schedule = torch.ones((), dtype=w.dtype, device=w.device)
        for i in range(1, t + 1):
            m_schedule = m_schedule * self._mu(i)
        m_schedule_next = m_schedule * momentum_t1
        ghat = g / (1 - m_schedule)
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        mhat = m / (1 - m_schedule_next)
        vhat = v / (1 - self.beta2 ** t)
        mbar = (1 - momentum_t) * ghat + momentum_t1 * mhat
        w.sub_(lr * mbar / (torch.sqrt(vhat) + self.epsilon))


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum, self.epsilon = rho, momentum, epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return [_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight)]
        return [_zeros_like(weight)]

    def step(self, w, g, state, lr, wd, t):  # noqa: ARG002
        g = _add_wd(self._preprocess(g), w, wd)
        if self.centered:
            n, gbar, delta = state
            n.mul_(self.rho).add_((1 - self.rho) * g * g)
            gbar.mul_(self.rho).add_((1 - self.rho) * g)
            delta.mul_(self.momentum).sub_(
                lr * g / torch.sqrt(n - gbar * gbar + self.epsilon))
            w.add_(delta)
        else:
            n = state[0]
            n.mul_(self.rho).add_((1 - self.rho) * g * g)
            w.sub_(lr * g / (torch.sqrt(n) + self.epsilon))
        if self.clip_weights:
            w.clamp_(-self.clip_weights, self.clip_weights)


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics; the noise is drawn from a
    generator seeded by the framework's key stream."""

    def __init__(self, learning_rate=0.1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def step(self, w, g, state, lr, wd, t):  # noqa: ARG002
        if isinstance(t, torch.Tensor):
            raise MXNetError("SGLD: a replayed step (a device t) would "
                             "replay the captured noise")
        g = _add_wd(self._preprocess(g), w, wd)
        gen = torch.Generator(device=w.device)
        gen.manual_seed(_random.host_seed())
        noise = torch.randn(w.shape, dtype=w.dtype, device=w.device,
                            generator=gen) * _sqrt(lr)
        w.sub_(lr / 2 * g).add_(noise)


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return [_zeros_like(weight)] if self.momentum != 0.0 else []

    def step(self, w, g, state, lr, wd, t):  # noqa: ARG002
        g = self._preprocess(g)
        if self.momentum != 0.0:
            mom = state[0]
            mom.mul_(self.momentum).sub_((1 - self.momentum) * (g + wd * w))
            w.copy_((1 - lr * self.wd_lh) * w + lr * torch.sign(mom))
            return
        w.copy_((1 - lr * self.wd_lh) * w - lr * torch.sign(g + wd * w))


# aliases matching reference casing
sgd = SGD
adam = Adam


class Updater:
    """KVStore-side updater (reference: `python/mxnet/optimizer/updater.py`)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states: dict = {}
        self.states_synced: dict = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):  # noqa: ARG002
        serializable = {
            k: ([s.detach().cpu().numpy() for s in v]
                if isinstance(v, list) else v)
            for k, v in self.states.items()
        }
        return pickle.dumps(serializable)

    def set_states(self, states):
        loaded = pickle.loads(states)
        dev = None
        for v in self.states.values():
            if isinstance(v, list) and v:
                dev = v[0].device
                break
        self.states = {
            k: ([torch.from_numpy(onp.array(s)).to(dev or "cpu") for s in v]
                if isinstance(v, list) else v)
            for k, v in loaded.items()
        }


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with ONE accumulated scalar history per output row
    (reference: `python/mxnet/optimizer/contrib.py` GroupAdaGrad, for
    embedding tables: history (V, 1) instead of (V, D))."""

    elementwise = False   # a history per row

    def __init__(self, learning_rate=0.01, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        w = _tensor(weight)
        if w.dim() < 2:
            return [torch.zeros_like(w)]
        return [torch.zeros(w.shape[:1] + (1,) * (w.dim() - 1),
                            dtype=w.dtype, device=w.device)]

    def step(self, w, g, state, lr, wd, t):  # noqa: ARG002
        g = _add_wd(self._preprocess(g), w, wd)
        hist = state[0]
        if w.dim() < 2:
            hist.add_(g * g)
        else:
            hist.add_((g * g).mean(dim=tuple(range(1, g.dim())),
                                   keepdim=True))
        w.sub_(lr * g / (torch.sqrt(hist) + self.epsilon))


# reference 2.0 class name (optimizer/ftrl.py); @register on FTRL already
# mapped the "ftrl" key
Ftrl = FTRL


def get_updater(optimizer):
    return Updater(optimizer)
