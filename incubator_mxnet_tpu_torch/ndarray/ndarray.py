"""NDArray: the imperative array over a torch tensor, and the op funnel
(port of `incubator_mxnet_tpu/ndarray/ndarray.py`).

Every op goes through :func:`apply_op` (or :func:`apply_op_flat`): it
unwraps the NDArrays, casts the inputs as AMP has the op take them
(`amp.op_cast_mode`, inside the op's function so that autograd sees the
casts), runs the op with torch's grad mode on under
``autograd.record()`` and off otherwise, and wraps the outputs. torch's
autograd graph is the reference's tape (`autograd.py`).

The reference's arrays never alias: its buffers are immutable, and a
mutation (``x[:] = v``, ``x += y``, ``copyto``) rebinds the array to a
new buffer. The port keeps that discipline over torch tensors: no op of
the port writes into a tensor an NDArray holds; ``__setitem__``, the
in-place operators and ``copyto`` rebind ``_data`` to a new tensor. So a
slice taken before a write keeps its values, although torch's slices are
views, and a tensor saved for backward is never changed under autograd.

The reference runs with x64 off: an array made from host data, and every
op's output, holds float32 for float64, int32 for int64 (and uint32,
complex64 for uint64, complex128); ``argmax``/``argmin`` give int32
except over an axis past 2**31 elements.
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import _tnp
from .. import autograd
from ..base import MXNetError, _X64_OFF, canonical_dtype, np_dtype
from ..device import Device, resolve_device

__all__ = ["NDArray", "apply_op", "apply_op_flat", "array", "from_jax",
           "waitall", "unwrap_arrays"]

# host->device byte accounting (`telemetry` installs
# `registry.add_h2d_bytes` here at import; None = off, one is-None check
# per inlet)
_H2D_HOOK = None

# fault-injection probe for the same inlet (`fault.injection` arms it only
# when the MXNET_FAULT_INJECT schedule names the 'h2d' seam; None = off)
_FAULT_HOOK = None

_AG = autograd._STATE


def _canon(t):
    """``t`` with the x64-off dtype (a cast only for a 64-bit dtype)."""
    d = _X64_OFF.get(t.dtype)
    return t if d is None else t.to(d)


def _host_tensor(data, dtype):
    """A fresh CPU tensor from host data with the x64-off dtype."""
    a = onp.array(data, copy=True)
    if dtype is None:
        t = torch.as_tensor(a)
        return _canon(t)
    if dtype == torch.bfloat16:
        return torch.as_tensor(a.astype(onp.float32)).to(torch.bfloat16)
    return torch.as_tensor(a).to(dtype)


class NDArray:
    """Imperative array with the reference's mutation semantics over a torch
    tensor."""

    __slots__ = ("_data", "_version", "_grad", "_grad_req", "_leaves",
                 "__weakref__")

    # make NDArray win against numpy broadcasting in mixed expressions
    __array_priority__ = 1000.0

    def __init__(self, data, device=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        dt = None if dtype is None else canonical_dtype(dtype)
        if isinstance(data, torch.Tensor):
            data = _canon(data) if dt is None else data.to(dt)
            if device is not None:
                data = data.to(resolve_device(device))
        else:
            dev = resolve_device(device)
            data = _host_tensor(data, dt)
            if _H2D_HOOK is not None:
                # host->device inlet: telemetry mx_h2d_bytes_total
                _H2D_HOOK(data.numel() * data.element_size())
            if _FAULT_HOOK is not None:
                _FAULT_HOOK(data.numel() * data.element_size())  # seam 'h2d'
            data = data.to(dev)
        self._data = data
        self._version = 0
        self._grad = None
        self._grad_req = "write"
        self._leaves = None

    # ------------------------------------------------------------------ core
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def itemsize(self):
        return self._data.element_size()

    @property
    def stype(self):
        return "default"

    @property
    def device(self):
        return Device(self._data.device)

    ctx = device
    context = device

    @property
    def T(self):
        return self.transpose()

    @property
    def grad(self):
        return self._grad

    @property
    def version(self):
        return self._version

    def _restore_leaf(self):
        """After a rebind outside the graph, an array with a gradient buffer
        stays a leaf that torch records from."""
        t = self._data
        if self._grad is not None and t.grad_fn is None and (
                t.is_floating_point() or t.is_complex()):
            if not t.requires_grad:
                t = t.detach().requires_grad_(True)
                self._data = t
            autograd._add_leaf(self, t)

    def _set_data(self, value):
        """Rebind the tensor (the mutation primitive). Bumps the version."""
        self._data = value
        self._version += 1
        self._restore_leaf()

    # ------------------------------------------------------------- conversion
    def asnumpy(self) -> onp.ndarray:
        """Synchronize and copy to host."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type == "cpu":
            return t.numpy().copy()
        return t.cpu().numpy()

    def item(self):
        return self.asnumpy().item()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.item()

    def tolist(self):
        return self.asnumpy().tolist()

    def astype(self, dtype, copy=True):
        dt = canonical_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return apply_op("astype", lambda x: x.to(dt), (self,))

    def copy(self):
        return apply_op("copy", torch.clone, (self,))

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(
                device=other._data.device, dtype=other._data.dtype,
                copy=True))
            return other
        if isinstance(other, (Device, torch.device, str)):
            return self.to_device(other)
        raise TypeError(f"copyto does not support type {type(other)}")

    def to_device(self, device):
        dev = resolve_device(device)
        if dev.type == "cuda" and self._data.device.type == "cpu":
            n = self._data.numel() * self._data.element_size()
            if _H2D_HOOK is not None:
                _H2D_HOOK(n)
            if _FAULT_HOOK is not None:
                _FAULT_HOOK(n)    # chaos seam 'h2d'
        return NDArray(self._data.detach().to(dev))

    as_in_ctx = to_device
    as_in_context = to_device
    as_nd_ndarray = lambda self: self  # noqa: E731
    as_np_ndarray = lambda self: self  # noqa: E731

    def wait_to_read(self):
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)

    def wait_to_write(self):
        self.wait_to_read()

    # ---------------------------------------------------------------- autograd
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a gradient buffer that ``backward`` writes (MXNet
        parity); the array becomes a leaf of the graph."""
        if stype not in (None, "default"):
            raise MXNetError(f"attach_grad(stype={stype!r}): sparse "
                             f"gradients are not ported")
        self._grad = NDArray(torch.zeros_like(self._data.detach()))
        self._grad_req = grad_req
        self._data = self._data.detach()
        autograd._require_grad(self)

    def drop_grad(self):
        self._grad = None
        self._leaves = None
        self._data = self._data.detach()
        autograd._ATTACHED.pop(id(self), None)

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None else None,
                          retain_graph=retain_graph, train_mode=train_mode)

    # ------------------------------------------------------------- reshaping
    def reshape(self, *shape, **kwargs):  # noqa: ARG002
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = tuple(int(s) for s in shape)
        return apply_op("reshape", lambda x: x.reshape(shape), (self,))

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        ax = axes if axes else None
        return apply_op("transpose", lambda x: _tnp.transpose(x, ax), (self,))

    def flatten(self):
        return self.reshape(self.shape[0] if self.ndim > 0 else 1, -1)

    def squeeze(self, axis=None):
        return apply_op("squeeze", lambda x: _tnp.squeeze(x, axis), (self,))

    def expand_dims(self, axis):
        return apply_op("expand_dims", lambda x: _tnp.expand_dims(x, axis),
                        (self,))

    def broadcast_to(self, shape):
        return apply_op("broadcast_to", lambda x: _tnp.broadcast_to(x, shape),
                        (self,))

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def repeat(self, repeats, axis=None):
        return apply_op("repeat", lambda x: _tnp.repeat(x, repeats, axis),
                        (self,))

    def tile(self, reps):
        return apply_op("tile", lambda x: _tnp.tile(x, reps), (self,))

    def swapaxes(self, a1, a2):
        return apply_op("swapaxes", lambda x: _tnp.swapaxes(x, a1, a2),
                        (self,))

    def split(self, indices_or_sections, axis=0):
        n = len(_tnp.split(self._data.detach(), indices_or_sections, axis))
        return apply_op("split",
                        lambda x: tuple(_tnp.split(x, indices_or_sections,
                                                   axis)),
                        (self,), n_outputs=n)

    # ------------------------------------------------------------- reductions
    def _reduce(self, name, fn, axis=None, keepdims=False):
        return apply_op(name, lambda x: fn(x, axis=axis, keepdims=keepdims),
                        (self,))

    def sum(self, axis=None, keepdims=False, **kw):  # noqa: ARG002
        return self._reduce("sum", _tnp.sum, axis, keepdims)

    def mean(self, axis=None, keepdims=False, **kw):  # noqa: ARG002
        return self._reduce("mean", _tnp.mean, axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", _tnp.max, axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", _tnp.min, axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", _tnp.prod, axis, keepdims)

    def std(self, axis=None, keepdims=False, ddof=0):
        return apply_op("std", lambda x: _tnp.std(x, axis=axis,
                                                  keepdims=keepdims,
                                                  ddof=ddof), (self,))

    def var(self, axis=None, keepdims=False, ddof=0):
        return apply_op("var", lambda x: _tnp.var(x, axis=axis,
                                                  keepdims=keepdims,
                                                  ddof=ddof), (self,))

    def _arg_reduce_method(self, name, axis, keepdims):
        return _arg_reduce(name, self, axis, keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._arg_reduce_method("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._arg_reduce_method("argmin", axis, keepdims)

    def argsort(self, axis=-1):
        return apply_op("argsort", lambda x: _tnp.argsort(x, axis=axis),
                        (self,))

    def square(self):
        return apply_op("square", lambda x: x * x, (self,))

    def slice_axis(self, axis=0, begin=0, end=None):
        """Slice along ONE axis (reference `mx.nd.slice_axis`)."""
        def f(x):
            idx = [slice(None)] * x.ndim
            idx[axis] = slice(begin, end)
            return x[tuple(idx)]

        return apply_op("slice_axis", f, (self,))

    def sort(self, axis=-1):
        return apply_op("sort", lambda x: _tnp.sort(x, axis=axis), (self,))

    def cumsum(self, axis=None, dtype=None):
        return apply_op("cumsum", lambda x: _tnp.cumsum(x, axis=axis,
                                                        dtype=dtype), (self,))

    def clip(self, a_min=None, a_max=None):
        return apply_op("clip", lambda x: _tnp.clip(x, a_min, a_max), (self,))

    def abs(self):
        return apply_op("abs", torch.abs, (self,))

    def round(self, decimals=0):
        return apply_op("round", lambda x: _tnp.round(x, decimals), (self,))

    def dot(self, other):
        return apply_op("dot", _tnp.dot, (self, other))

    def norm(self, ord=None, axis=None, keepdims=False):  # noqa: A002
        return apply_op("norm", lambda x: _tnp.norm(x, ord=ord, axis=axis,
                                                    keepdims=keepdims),
                        (self,))

    def take(self, indices, axis=None, mode="clip"):
        # legacy surface: index arrays may be float (reference mx.nd
        # semantics); take casts them to integers for the gather
        return apply_op("take", lambda x, i: _tnp.take(x, i, axis=axis,
                                                       mode=mode),
                        (self, indices))

    def zeros_like(self):
        return NDArray(torch.zeros_like(self._data.detach()))

    def ones_like(self):
        return NDArray(torch.ones_like(self._data.detach()))

    def full_like(self, fill_value):
        return NDArray(torch.full_like(self._data.detach(), fill_value))

    def tostype(self, stype):
        if stype == "default":
            return self
        if stype in ("row_sparse", "csr"):
            raise MXNetError(f"tostype({stype!r}): sparse storage is not "
                             f"ported")
        raise ValueError(f"unknown storage type {stype!r}")

    # ------------------------------------------------------------- indexing
    def __getitem__(self, key):
        key = _unwrap_index(key)
        return apply_op("getitem", lambda x: x[key], (self,))

    def __setitem__(self, key, value):
        key = _unwrap_index(key)
        if isinstance(value, NDArray):
            if autograd.is_recording() and (value._data.requires_grad
                                            or self._data.requires_grad):
                self._adopt(apply_op("setitem",
                                     lambda x, v: _setitem(x, key, v),
                                     (self, value)))
                return
            value = value._data.detach()
        with torch.no_grad():
            self._set_data(_setitem(self._data.detach(), key, value))

    def _adopt(self, other: "NDArray"):
        """Take over another array's tensor (an in-place op's result)."""
        self._data = other._data
        self._version += 1
        self._restore_leaf()

    # -------------------------------------------------------------- dlpack
    def __dlpack__(self, *args, **kwargs):
        """DLPack protocol export; delegates to the tensor."""
        return self._data.detach().__dlpack__(*args, **kwargs)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    # ------------------------------------------- numpy interop protocols
    # (NEP-18 __array_function__ + NEP-13 __array_ufunc__, so
    # `onp.mean(mx_arr)` dispatches into the framework and returns an
    # NDArray)

    def __array__(self, dtype=None, copy=None):
        if copy is False:
            raise ValueError(
                "NDArray cannot be converted to numpy without a copy")
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        from .. import numpy as mxnp

        fn = getattr(mxnp, ufunc.__name__, None)
        dispatchable = set(kwargs) <= {"dtype", "where"} \
            and kwargs.get("where", True) is True
        if (method == "__call__" and dispatchable
                and fn is not None and callable(fn)):
            kwargs.pop("where", None)
            return fn(*inputs, **kwargs)

        # anything the framework cannot dispatch (ufunc methods like
        # .reduce, out=, where=, unmapped ufuncs) runs on host copies
        def conv(o):
            return o.asnumpy() if isinstance(o, NDArray) else o

        return getattr(ufunc, method)(*[conv(i) for i in inputs],
                                      **{k: conv(v)
                                         for k, v in kwargs.items()})

    def __array_function__(self, func, types, args, kwargs):  # noqa: ARG002
        from .. import numpy as mxnp

        fn = getattr(mxnp, func.__name__, None)
        if fn is not None and callable(fn):
            return fn(*args, **kwargs)

        def conv(o):
            if isinstance(o, NDArray):
                return o.asnumpy()
            if isinstance(o, (list, tuple)):
                return type(o)(conv(x) for x in o)
            return o

        return func(*[conv(a) for a in args],
                    **{k: conv(v) for k, v in kwargs.items()})

    # ------------------------------------------------------------- operators
    def _binop(self, name, fn, other, reverse=False):
        a, b = (other, self) if reverse else (self, other)
        return apply_op(name, fn, (a, b))

    def __add__(self, o):
        return self._binop("add", _tnp.add, o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop("subtract", _tnp.subtract, o)

    def __rsub__(self, o):
        return self._binop("subtract", _tnp.subtract, o, reverse=True)

    def __mul__(self, o):
        return self._binop("multiply", _tnp.multiply, o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop("true_divide", _tnp.true_divide, o)

    def __rtruediv__(self, o):
        return self._binop("true_divide", _tnp.true_divide, o, reverse=True)

    def __floordiv__(self, o):
        return self._binop("floor_divide", _tnp.floor_divide, o)

    def __rfloordiv__(self, o):
        return self._binop("floor_divide", _tnp.floor_divide, o, reverse=True)

    def __mod__(self, o):
        return self._binop("mod", _tnp.mod, o)

    def __rmod__(self, o):
        return self._binop("mod", _tnp.mod, o, reverse=True)

    def __pow__(self, o):
        return self._binop("power", _tnp.power, o)

    def __rpow__(self, o):
        return self._binop("power", _tnp.power, o, reverse=True)

    def __matmul__(self, o):
        return self._binop("matmul", _tnp.matmul, o)

    def __rmatmul__(self, o):
        return self._binop("matmul", _tnp.matmul, o, reverse=True)

    def __neg__(self):
        return apply_op("negative", torch.negative, (self,))

    def __abs__(self):
        return self.abs()

    def _inplace(self, name, fn, other):
        self._adopt(self._binop(name, fn, other))
        return self

    def __iadd__(self, o):
        return self._inplace("add", _tnp.add, o)

    def __isub__(self, o):
        return self._inplace("subtract", _tnp.subtract, o)

    def __imul__(self, o):
        return self._inplace("multiply", _tnp.multiply, o)

    def __itruediv__(self, o):
        return self._inplace("true_divide", _tnp.true_divide, o)

    def __imod__(self, o):
        return self._inplace("mod", _tnp.mod, o)

    # comparisons (not differentiable; no tape)
    def _cmp(self, fn, other):
        b = other._data.detach() if isinstance(other, NDArray) else other
        return NDArray(fn(self._data.detach(), b))

    def __eq__(self, o):  # noqa: D105
        return self._cmp(_tnp.equal, o)

    def __ne__(self, o):
        return self._cmp(_tnp.not_equal, o)

    def __lt__(self, o):
        return self._cmp(_tnp.less, o)

    def __le__(self, o):
        return self._cmp(_tnp.less_equal, o)

    def __gt__(self, o):
        return self._cmp(_tnp.greater, o)

    def __ge__(self, o):
        return self._cmp(_tnp.greater_equal, o)

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------- protocol
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous")
        return bool(self.item())

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __index__(self):
        if self.size == 1 and not (self._data.is_floating_point()
                                   or self._data.is_complex()
                                   or self._data.dtype == torch.bool):
            return int(self.item())
        raise TypeError("only integer scalar arrays can be converted to an "
                        "index")

    def __repr__(self):
        from ..base import dtype_name

        return (f"{self.asnumpy()}\n<NDArray {self.shape} @{self.device}, "
                f"dtype={dtype_name(self._data.dtype)}>")

    def __getstate__(self):
        return {"data": self.asnumpy(), "device": None}

    def __setstate__(self, state):
        self._data = _host_tensor(state["data"], None).to(resolve_device())
        self._version = 0
        self._grad = None
        self._grad_req = "write"
        self._leaves = None


def _setitem(x, key, v):
    """``x`` with ``x[key] = v``, as a new tensor (differentiable in both
    under autograd)."""
    y = x.clone()
    if isinstance(v, torch.Tensor):
        v = v.to(device=y.device, dtype=y.dtype)
    elif not isinstance(v, (int, float, bool)):
        v = torch.as_tensor(onp.asarray(v), device=y.device, dtype=y.dtype)
    y[key] = v
    return y


def _index_tensor(k):
    t = k._data.detach() if isinstance(k, NDArray) else k
    if isinstance(t, torch.Tensor) and not (t.is_floating_point()
                                            or t.dtype == torch.bool):
        return t.long()
    return t


def _unwrap_index(key):
    if isinstance(key, tuple):
        return tuple(_index_tensor(k) for k in key)
    return _index_tensor(key)


_INT32_MAX = 2 ** 31 - 1


def _arg_reduce(name, a, axis, keepdims=False):
    """argmax/argmin as the reference gives them: int32, or int64 over an
    axis past 2**31 elements (where int32 would wrap)."""
    data = a._data
    n = data.numel() if axis is None else data.shape[axis]
    if n - 1 > _INT32_MAX:
        with torch.no_grad():
            return _wrap(getattr(_tnp, name)(data.detach(), axis,
                                             keepdims=keepdims), keep64=True)
    return apply_op(name, lambda x: getattr(_tnp, name)(
        x, axis, keepdims=keepdims), (a,))


# ---------------------------------------------------------------------------
# Op invocation: the single funnel every op goes through (the analogue of
# the reference's Imperative::Invoke).
# ---------------------------------------------------------------------------

_AMP_STATE = None


def _amp_mode(name):
    """AMP participation for op `name` (None when AMP is off)."""
    global _AMP_STATE
    state = _AMP_STATE
    if state is None:
        from .. import amp

        state = _AMP_STATE = amp._STATE
    if not state.active:
        return None
    from ..amp import op_cast_mode

    return op_cast_mode(name)


def _wrap(t, keep64=False):
    """An op output as an NDArray: a tensor with the x64-off dtype."""
    a = NDArray.__new__(NDArray)
    a._data = t if keep64 else _canon(t)
    a._version = 0
    a._grad = None
    a._grad_req = "write"
    a._leaves = None
    return a


def _wrap_out(o, device):
    if isinstance(o, NDArray):
        return o
    if isinstance(o, torch.Tensor):
        return _wrap(o)
    return NDArray(o, device=device)


def _run(fn, vals):
    """``fn()`` with torch's grad mode as the reference records: on under
    ``autograd.record()``, off otherwise (so an array with a gradient
    buffer is not recorded from outside it)."""
    if _AG.recording:
        if torch.is_grad_enabled():
            return fn()
        with torch.enable_grad():
            return fn()
    if torch.is_grad_enabled():
        for v in vals:
            if v.requires_grad:
                with torch.no_grad():
                    return fn()
    return fn()


def _finish(outs, vals, out=None, as_list=False):
    """An op's outputs as NDArrays: one, or a tuple (a list with
    ``as_list``) for a tuple or list of outputs; or taken over by ``out``.
    A non-tensor output lands on the first input's device."""
    if isinstance(outs, list):
        outs = tuple(outs)
    tuple_out = isinstance(outs, tuple)
    out_list = list(outs) if tuple_out else [outs]
    dev = vals[0].device if vals else None
    wrapped = [_wrap_out(o, dev) for o in out_list]
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        for t, w in zip(targets, wrapped):
            t._adopt(w)
        return out
    if tuple_out:
        return list(wrapped) if as_list else tuple(wrapped)
    return wrapped[0]


def _apply(name, jfn, args, kwargs, nested, out=None, as_list=False):
    """The funnel: `jfn` over the unwrapped tensors of `args` (and, with
    ``nested``, of the lists and tuples among them, one level deep), cast
    once inside the call under AMP so that autograd sees the cast, run in
    the grad mode of `_run`, outputs wrapped by `_finish`."""
    paths = []       # (i,) or (i, j) positions of NDArray leaves
    vals = []
    for i, a in enumerate(args):
        if isinstance(a, NDArray):
            paths.append((i,))
            vals.append(a._data)
        elif nested and isinstance(a, (list, tuple)):
            for j, b in enumerate(a):
                if isinstance(b, NDArray):
                    paths.append((i, j))
                    vals.append(b._data)
    amp_mode = _amp_mode(name)

    def call():
        tvals = vals
        if amp_mode is not None:
            from ..amp import cast_vals

            tvals = cast_vals(amp_mode, tvals)
        c = [list(a) if nested and isinstance(a, (list, tuple)) else a
             for a in args]
        for path, v in zip(paths, tvals):
            if len(path) == 1:
                c[path[0]] = v
            else:
                c[path[0]][path[1]] = v
        return jfn(*c, **(kwargs or {}))

    return _finish(_run(call, vals), vals, out, as_list)


def apply_op(name, jfn, args, kwargs=None, n_outputs=1, out=None,
             static_info=None):  # noqa: ARG001
    """Execute `jfn` over the unwrapped tensors; wrap outputs; record on
    torch's graph under ``autograd.record()``.

    - args: mixed NDArray / Python scalars / other values. Only NDArray
      positions participate in autograd; the rest pass as they are.
    - kwargs: static (non-differentiable) parameters.
    - n_outputs: number of outputs if jfn returns a tuple.
    """
    return _apply(name, jfn, args, kwargs, nested=False, out=out)


def unwrap_arrays(args):
    """Varargs-or-single-list unwrap shared by the list-consuming ops
    (`add_n(a, b)` == `add_n([a, b])`)."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        return list(args[0])
    return list(args)


def apply_op_flat(name, jfn, args, kwargs=None, n_outputs=None,
                  cacheable=False):  # noqa: ARG001
    """Like apply_op, but NDArrays nested one level inside list/tuple
    positional args take part too (e.g. ``concatenate([a, b], axis=0)``).
    ``cacheable`` is the reference's op-program cache flag; eager torch
    has no op programs to cache."""
    return _apply(name, jfn, args, kwargs, nested=True,
                  as_list=n_outputs is not None)


def array(source, dtype=None, device=None, ctx=None):
    """A new array on ``device`` (or ``ctx``), else on the current device,
    whatever ``source`` is: a tensor or an NDArray elsewhere is copied
    over."""
    return NDArray(source, device=resolve_device(device or ctx), dtype=dtype)


def from_jax(value):  # noqa: ARG001
    """The reference wraps a jax array; the port holds torch tensors (see
    `dlpack.from_dlpack` to take one from another framework)."""
    raise MXNetError("from_jax: the port holds torch tensors; use "
                     "NDArray(tensor) or dlpack.from_dlpack")


def jit_cache_info():
    """The reference's op-program cache; eager torch has none."""
    raise MXNetError("jit_cache_info: eager torch has no op-program cache "
                     "(ROADMAP §1 item 6: hybridize)")


def waitall():
    """Block until all queued work on every card in use has finished
    (reference: Engine::WaitForAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _arm_from_schedule():
    """Arm the 'h2d' fault seam from a schedule set before this import."""
    import sys

    inj = sys.modules.get("incubator_mxnet_tpu_torch.fault.injection")
    if inj is not None:
        inj._arm_hot_hooks()


_arm_from_schedule()
