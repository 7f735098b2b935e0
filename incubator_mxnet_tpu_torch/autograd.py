"""Autograd (port of `incubator_mxnet_tpu/autograd.py`): the
``record``/``pause`` scopes, ``backward``, ``grad`` with
``create_graph``, and the custom :class:`Function`.

The reference keeps its own tape of `TapeNode`s and differentiates it
with ``jax.vjp``. The port keeps no second tape: an op that runs through
the NDArray funnel under :func:`record` runs with torch's grad mode on,
so torch's autograd graph is the tape, and :func:`backward` and
:func:`grad` call ``torch.autograd.grad``. What the reference does and
torch does not do by itself is done here:

- ``grad_req``: "write" (the default) overwrites ``.grad``, "add"
  accumulates into it, "null" leaves it alone, where torch always
  accumulates;
- a non-scalar head gets an all-ones head gradient;
- a head that was not computed under :func:`record` raises
  ``ValueError``;
- the graph lives as long as its arrays, as the reference's tape does,
  so a second ``backward`` over it works (``retain_graph`` is always
  given to torch); the kernels' autograd Functions give the same
  gradient each time (the dropout masks come again from the saved key);
- :func:`grad` gives zeros for a variable the heads do not reach, as
  ``jax.grad`` does.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = [
    "record",
    "pause",
    "train_mode",
    "predict_mode",
    "is_recording",
    "is_training",
    "set_recording",
    "set_training",
    "mark_variables",
    "backward",
    "grad",
    "get_symbol",
    "Function",
]


class _TLS(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _TLS()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(is_record: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(is_record)
    return prev


def set_training(train_mode: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(train_mode)
    return prev


class _Scope:
    def __init__(self, recording=None, training=None):
        self._recording = recording
        self._training = training

    def __enter__(self):
        if self._recording is not None:
            self._prev_rec = set_recording(self._recording)
        if self._training is not None:
            self._prev_train = set_training(self._training)
        return self

    def __exit__(self, *exc):
        if self._recording is not None:
            set_recording(self._prev_rec)
        if self._training is not None:
            set_training(self._prev_train)
        return False


def record(train_mode: bool = True) -> _Scope:
    """Scope in which executed ops are recorded for differentiation."""
    return _Scope(recording=True, training=train_mode)


def pause(train_mode: bool = False) -> _Scope:
    """Scope in which recording is suspended."""
    return _Scope(recording=False, training=train_mode)


def train_mode() -> _Scope:
    return _Scope(training=True)


def predict_mode() -> _Scope:
    return _Scope(training=False)


# The arrays with a gradient buffer (attach_grad / mark_variables), by id:
# the candidates a backward deposits into. Weak, so a dropped array leaves.
_ATTACHED: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _add_leaf(arr, t):
    """Record ``t`` as a leaf of ``arr``. An array rebound outside the
    graph (``x[:] = v``) gets a new leaf, while a graph recorded before
    still holds the old one; the reference deposits into the array either
    way (its tape knows the array, not the buffer), so a backward asks
    torch for the gradient of every leaf the array has held that a graph
    still keeps alive (weak references: a dropped graph frees them)."""
    leaves = [r for r in arr._leaves if r() is not None and r() is not t] \
        if arr._leaves else []
    leaves.append(weakref.ref(t))
    arr._leaves = leaves


def _require_grad(arr):
    """Make ``arr``'s tensor a leaf that torch records from (the
    reference's leaf: an array with a gradient buffer and no node)."""
    t = arr._data
    if t.grad_fn is None and not t.requires_grad:
        if not (t.is_floating_point() or t.is_complex()):
            raise MXNetError(f"cannot attach a gradient to an array of "
                             f"dtype {t.dtype}")
        arr._data = t.detach().requires_grad_(True)
    arr._leaves = None
    _add_leaf(arr, arr._data)
    _ATTACHED[id(arr)] = arr


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to arrays (reference: autograd.py:131)."""
    if not isinstance(variables, (list, tuple)):
        variables = [variables]
        gradients = [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        var._grad = g
        var._grad_req = req
        _require_grad(var)


_HEAD_ERROR = ("cannot differentiate: the head array was not computed "
               "inside an autograd.record() scope")


def _heads_and_grads(heads, head_grads):
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    outs, cots = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            continue
        if hg is None:
            # MXNet semantics: implicit all-ones head gradient
            cot = torch.ones_like(t)
        else:
            cot = hg._data if isinstance(hg, NDArray) else torch.as_tensor(
                hg, device=t.device)
            cot = cot.to(t.dtype).expand(t.shape)
        outs.append(t)
        cots.append(cot)
    return list(heads), outs, cots


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):  # noqa: ARG001
    """Compute gradients of heads w.r.t. every array with a gradient buffer
    and deposit them by its ``grad_req`` (reference: autograd.py:217)."""
    heads, outs, cots = _heads_and_grads(heads, head_grads)
    if all(h._data.grad_fn is None and h._grad is None for h in heads):
        raise ValueError(_HEAD_ERROR)
    # each array's leaves (`_add_leaf`): an in-place op recorded on an
    # array since leaves the gradient with its value before the op
    targets, inputs = [], []
    for a in list(_ATTACHED.values()):
        if a._grad_req == "null" or not a._leaves:
            continue
        for ref in a._leaves:
            t = ref()
            if t is not None and t.requires_grad:
                targets.append(a)
                inputs.append(t)
    if not outs or not targets:
        return
    with torch.enable_grad():
        grads = torch.autograd.grad(outs, inputs, cots, retain_graph=True,
                                    allow_unused=True)
    summed = {}
    for arr, g in zip(targets, grads):
        if g is not None:
            prev = summed.get(id(arr))
            summed[id(arr)] = (arr, g if prev is None else prev[1] + g)
    for arr, g in summed.values():
        buf = arr._grad
        g = g.detach().to(buf._data.dtype)
        if arr._grad_req == "add":
            buf._data = buf._data + g
        else:
            buf._data = g
        buf._version += 1


def grad(heads, variables, head_grads=None, retain_graph=None, create_graph=False,
         train_mode=True):  # noqa: ARG001
    """Gradients of heads w.r.t. variables (reference: autograd.py:363).
    With ``create_graph=True`` the gradients are on the graph themselves,
    so they can be differentiated again. A variable the heads do not
    reach gets zeros."""
    from .ndarray.ndarray import NDArray

    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("autograd.grad: a variable has no gradient "
                             "buffer; call attach_grad() on it before "
                             "recording")
    _, outs, cots = _heads_and_grads(heads, head_grads)
    if outs:
        with torch.enable_grad():
            grads = torch.autograd.grad(
                outs, [v._data for v in variables], cots, retain_graph=True,
                create_graph=create_graph, allow_unused=True)
    else:
        grads = [None] * len(variables)
    out = []
    for v, g in zip(variables, grads):
        if g is None:
            g = torch.zeros_like(v._data.detach())
        elif not create_graph:
            g = g.detach()
        out.append(NDArray(g))
    return out[0] if single else out


def get_symbol(x):  # pragma: no cover - debugging aid
    """Reference parity stub: a description of the recorded graph."""
    fn = x._data.grad_fn
    return repr(type(fn).__name__) if fn is not None else "var"


class _Bridge(torch.autograd.Function):
    """Links a custom :class:`Function`'s outputs to its inputs on torch's
    graph: forward hands back the outputs it already computed, backward
    calls the Function's ``backward``."""

    @staticmethod
    def forward(ctx, func, n_in, *tensors):
        ctx.func, ctx.n_in = func, n_in
        ctx.in_meta = [(t.dtype, t.device) for t in tensors[:n_in]]
        return tuple(t.detach() for t in tensors[n_in:])

    @staticmethod
    def backward(ctx, *dys):
        from .ndarray.ndarray import NDArray

        with pause():
            grads = ctx.func.backward(*[NDArray(d) for d in dys])
        if not isinstance(grads, (list, tuple)):
            grads = [grads]
        out = []
        for g, (dt, dev) in zip(grads, ctx.in_meta):
            g = g._data if isinstance(g, NDArray) else torch.as_tensor(
                g, device=dev)
            out.append(g.to(dt))
        # func, n_in, then one gradient a parent; the outputs take none
        return (None, None) + tuple(out) + (None,) * len(dys)


class Function:
    """Custom differentiable function (reference: autograd.py:453).

    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` operating on NDArrays.
    """

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        # stop recording but PRESERVE the training flag: custom forwards
        # (dropout-bearing Functions) must see is_training()
        with pause(train_mode=is_training()):
            outputs = self.forward(*inputs)
        single = not isinstance(outputs, (list, tuple))
        outs = [outputs] if single else list(outputs)
        parents = [a for a in inputs if isinstance(a, NDArray)]
        if is_recording() and any(p._data.requires_grad for p in parents):
            with torch.enable_grad():
                linked = _Bridge.apply(self, len(parents),
                                       *[p._data for p in parents],
                                       *[o._data for o in outs])
            for o, t in zip(outs, linked):
                o._data = t
        return outs[0] if single else tuple(outs)
