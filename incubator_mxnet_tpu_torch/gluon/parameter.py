"""Gluon Parameter (port of `incubator_mxnet_tpu/gluon/parameter.py`:
deferred shape inference, ``grad_req``, lr/wd multipliers).

A Parameter holds one NDArray whose tensor is a `torch.nn.Parameter`
(a leaf). Once the Parameter is initialised, every `Block` that owns it
registers that tensor under the Parameter's attribute name, so a block's
``named_parameters()`` and ``collect_params()`` give the same names and
torch code (`parallel.DataParallel`, the serving engines, an optimizer
over ``parameters()``) sees the same tensors.

**Two calling conventions.** A block called with NDArrays runs op by op
through the NDArray funnel, recorded under ``autograd.record()``; a block
called with torch tensors runs on tensors under torch's grad mode
(`block.Block.__call__`). Inside a call, :meth:`Parameter.data` answers
in the call's convention: the NDArray, or its tensor.

**One gradient.** The gradient is the tensor's ``.grad``: a torch
``backward()`` accumulates into it, and the NDArray ``backward()``
deposits into it by ``grad_req`` ("write" overwrites, "add" adds,
"null" leaves the parameter out), through the NDArray :meth:`grad`
returns, whose tensor *is* ``.grad``. ``.grad`` stays None until a
backward reaches the parameter, and `Trainer` skips a parameter whose
gradient is None.

**Updated in place.** The captured CUDA graphs of the port (the serving
engines', `DataParallel`'s, `HybridBlock.hybridize`'s) read a parameter by
address. So the optimizers update the tensor in place, and
:meth:`set_data` copies into it when shape and dtype match; it rebinds
only when they differ (a new tensor, registered with every owner anew).
The reference rebinds on every write (its arrays never alias); this is
the port's accepted divergence (ROADMAP §3).

**Stored by the spec.** Under a mesh plan (`parallel.DataParallel`'s
``param_shardings``) a Parameter cut by its spec holds the rank's block
(``_placement``, a `parallel._layout.Placement`): its tensor, what
``named_parameters()`` yields and the optimizer updates in place, is the
block, and :attr:`shape` stays the whole shape. :meth:`data` outside a
tensor-parallel model's own reads gives the whole tensor, gathered on
demand and not kept (every rank of the cut axes reads it together);
:meth:`set_data` of a whole value writes the rank's block.
"""
from __future__ import annotations

import copy
import threading
import weakref

import numpy as onp
import torch

from .. import initializer as init_mod
from ..base import MXNetError, dtype_name, np_dtype, torch_dtype
from ..device import resolve_device
from ..ndarray.ndarray import NDArray

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(Exception):
    """Accessing a parameter whose shape is not yet known."""


def _shape_complete(shape):
    return shape is not None and all(isinstance(s, int) and s > 0 for s in shape)


class _Convention(threading.local):
    def __init__(self):
        self.torch = False  # inside a block call made with torch tensors


_CONV = _Convention()


class _GradBuffer(NDArray):
    """The NDArray a Parameter's gradient is read and written through: its
    tensor is the parameter tensor's ``.grad`` (zeros are made at the
    first read of a gradient that no backward has written)."""

    def __init__(self, leaf):
        self._leaf = leaf
        self._version = 0
        self._grad = None
        self._grad_req = "write"
        self._leaves = None

    @property
    def _data(self):
        t = self._leaf
        if t.grad is None:
            t.grad = torch.zeros_like(t.detach())
        return t.grad

    @_data.setter
    def _data(self, value):
        self._leaf.grad = value.detach()


class Parameter:
    #: how many times an initialised Parameter took a new tensor (a
    #: hybridized block's graphs read the old one and are dropped)
    _rebinds = 0

    def __init__(self, shape=None, dtype="float32", init=None,
                 grad_req="write", lr_mult=1.0, wd_mult=1.0,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default", name=None):
        if stype != "default" or grad_stype != "default":
            raise MXNetError(f"Parameter(stype={stype!r}, grad_stype="
                             f"{grad_stype!r}): sparse storage is not ported "
                             f"(ROADMAP.md §1 item 11b, ndarray/sparse.py)")
        self._name = name or "param"
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self._dtype = np_dtype(dtype)
        self.init = init
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self._grad_req = grad_req if differentiable else "null"
        self._stype = stype
        self._grad_stype = grad_stype
        self._allow_deferred_init = allow_deferred_init
        self._data: NDArray | None = None
        self._deferred_init = None  # (initializer, device)
        # the device initialize() uses when it is given none (a layer's
        # `device=`); None: the current device
        self._device_hint = None
        # (weakref to a Block, attribute name): where the tensor is
        # registered
        self._owners = []
        # parallel._layout.Placement: the tensor is this rank's block
        self._placement = None

    # -- identity -----------------------------------------------------------
    @property
    def name(self):
        return self._name

    @name.setter
    def name(self, v):
        self._name = v

    @property
    def dtype(self):
        return np_dtype(self._data._data.dtype) if self._data is not None \
            else self._dtype

    @dtype.setter
    def dtype(self, v):
        self._dtype = np_dtype(v)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is not None and _shape_complete(self._shape):
            if tuple(new_shape) != self._shape:
                raise ValueError(
                    f"cannot reset shape of initialized Parameter {self._name} "
                    f"from {self._shape} to {tuple(new_shape)}")
        self._shape = tuple(new_shape)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        """Changing grad_req after init takes effect at once: "null" drops
        the gradient and takes the tensor off the graph; "write"/"add"
        bring it back."""
        if req not in ("write", "add", "null"):
            raise ValueError(f"invalid grad_req {req!r}")
        self._grad_req = req
        if self._data is not None:
            self._attach()

    # -- owners -------------------------------------------------------------
    # The owners are weak references: a copy or an unpickled Parameter
    # takes its owners from the blocks that hold it (Block.__setstate__).
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_owners"] = []
        # the tensor itself (the one the blocks register), on its device;
        # a block is gathered whole (every rank of its axes pickles)
        state["_data"] = None if self._data is None else self._whole_tensor()
        state["_placement"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._owners = []
        t, self._data = self._data, None
        if t is not None:
            self._bind(t)

    def __deepcopy__(self, memo):
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k not in ("_owners", "_data", "_placement"):
                new.__dict__[k] = copy.deepcopy(v, memo)
        new._owners = []
        new._data = None
        # the copy holds its own block, placed as the original's
        new._placement = getattr(self, "_placement", None)
        if self._data is not None:
            # the copied tensor, the one the copied block registers
            new._bind(copy.deepcopy(self._data._data, memo))
        return new

    def _add_owner(self, block, attr):
        self._owners = [(r, a) for r, a in self._owners
                        if r() is not None and not (r() is block and a == attr)]
        self._owners.append((weakref.ref(block), attr))
        if self._data is not None:
            block._register_tensor(attr, self._data._data)

    def _publish(self):
        """Register the tensor with every block that owns the Parameter."""
        for ref, attr in self._owners:
            block = ref()
            if block is not None and block._reg_params.get(attr) is self:
                block._register_tensor(attr, self._data._data)

    def _attach(self):
        """The tensor's autograd state and gradient by ``grad_req``."""
        arr, t = self._data, self._data._data
        if self._grad_req == "null":
            t.requires_grad_(False)
            t.grad = None
            arr._grad = None
            arr._leaves = None
            from .. import autograd

            autograd._ATTACHED.pop(id(arr), None)
            return
        if not (t.is_floating_point() or t.is_complex()):
            raise MXNetError(f"Parameter {self._name}: a {t.dtype} parameter "
                             f"cannot take a gradient; use grad_req='null'")
        t.requires_grad_(True)
        arr._grad = _GradBuffer(t)
        arr._grad_req = self._grad_req
        from .. import autograd

        autograd._require_grad(arr)

    def _bind(self, tensor):
        """Make ``tensor`` the Parameter's data (a new leaf over its
        storage, or the tensor itself when it is one), registered with
        every owner."""
        if self._data is not None:
            Parameter._rebinds += 1
        leaf = tensor if isinstance(tensor, torch.nn.Parameter) \
            and tensor.grad_fn is None \
            else torch.nn.Parameter(tensor.detach(), requires_grad=False)
        arr = NDArray.__new__(NDArray)
        arr._data = leaf
        arr._version = 0
        arr._grad = None
        arr._grad_req = "write"
        arr._leaves = None
        self._data = arr
        pl = getattr(self, "_placement", None)
        self._shape = tuple(leaf.shape) if pl is None else pl.shape
        self._attach()
        self._publish()

    # -- storage by the spec ----------------------------------------------
    def _place(self, placement):
        """Keep only this rank's block of the whole tensor (a new tensor,
        registered with every owner)."""
        self._check_initialized()
        if getattr(self, "_placement", None) is not None:
            self._unplace()
        block = placement.block_of(self._data._data.detach()).clone()
        self._placement = placement
        self._bind(block)

    def _unplace(self):
        """Hold the whole tensor again, gathered from the blocks (every
        rank of the placement's axes calls it)."""
        pl = getattr(self, "_placement", None)
        if pl is None or self._data is None:
            self._placement = None
            return
        whole = pl.gather(self._data._data)
        self._placement = None
        self._bind(whole)

    def _whole_tensor(self):
        """The whole tensor, detached: the stored one, or gathered from
        the blocks."""
        t = self._data._data.detach()
        pl = getattr(self, "_placement", None)
        return t if pl is None else pl.gather(t)

    def _stored(self):
        """What the Parameter holds in the call's convention: under a
        placement, this rank's block (a tensor-parallel model reads it
        directly)."""
        self._check_initialized()
        return self._data._data if _CONV.torch else self._data

    # -- init ---------------------------------------------------------------
    def initialize(self, init=None, device=None, ctx=None,
                   default_init=init_mod.Uniform, force_reinit=False):
        device = device or ctx
        if self._data is not None and not force_reinit:
            return
        initializer = init_mod.create(init) if init is not None else (
            init_mod.create(self.init) if self.init is not None
            else default_init())
        if not _shape_complete(self._shape):
            if not self._allow_deferred_init:
                raise ValueError(
                    f"Parameter {self._name} has unknown shape {self._shape} and "
                    "allow_deferred_init=False")
            self._deferred_init = (initializer, device)
            return
        self._init_impl(initializer, device)

    def _init_impl(self, initializer, device):
        if self._data is not None:
            # force_reinit: refill the tensor in place (graphs keep it)
            initializer(self._name, self._data)
            self._deferred_init = None
            return
        dev = resolve_device(device if device is not None
                             else self._device_hint)
        t = torch.zeros(self._shape, dtype=torch_dtype(self._dtype),
                        device=dev)
        arr = NDArray.__new__(NDArray)
        arr._data = t
        initializer(self._name, arr)
        self._deferred_init = None
        self._bind(arr._data)

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not _shape_complete(self._shape):
            raise DeferredInitializationError(self._name)
        initializer, device = self._deferred_init
        self._init_impl(initializer, device)

    # -- access -------------------------------------------------------------
    def _check_initialized(self):
        if self._data is None:
            if self._deferred_init is not None:
                if _shape_complete(self._shape):
                    self._finish_deferred_init()
                    return
                raise DeferredInitializationError(
                    f"Parameter {self._name} has not been initialized yet: "
                    "unknown shape")
            raise RuntimeError(
                f"Parameter {self._name} has not been initialized. "
                "Call .initialize() first")

    def data(self, device=None, ctx=None):  # noqa: ARG002
        """The NDArray; inside a block call made with torch tensors, its
        tensor. A Parameter stored as a block gives the whole tensor,
        gathered on demand (a transient whose gradient reaches the
        block)."""
        self._check_initialized()
        pl = getattr(self, "_placement", None)
        if pl is not None:
            if _CONV.torch:
                return pl.whole(self._data._data)
            from ..numpy_extension import _op

            return _op("param_whole", pl.whole, self._data)
        return self._data._data if _CONV.torch else self._data

    def list_data(self):
        return [self.data()]

    @property
    def grad_or_none(self):
        if self._data is None or self._data._grad is None:
            return None
        return self._data._grad if self._data._data.grad is not None \
            else None

    def grad(self, device=None, ctx=None):  # noqa: ARG002
        self._check_initialized()
        g = self._data._grad
        if g is None:
            raise RuntimeError(
                f"Parameter {self._name} does not have gradient (grad_req="
                f"{self.grad_req!r})")
        return g._data if _CONV.torch else g

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        """Zero the gradient in place (a gradient no backward has written
        stays None)."""
        if self._data is not None and self._data._data.grad is not None:
            with torch.no_grad():
                self._data._data.grad.zero_()

    def set_data(self, data):
        """Copy ``data`` into the parameter's tensor when its shape and
        dtype match (in place: graphs that read the tensor see the new
        value), else bind a new tensor. An uninitialised Parameter takes
        ``data`` as its data."""
        value = data._data if isinstance(data, NDArray) else data
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(onp.array(value, copy=True))
        if self._data is None:
            dt = torch_dtype(self._dtype) if value.is_floating_point() \
                else value.dtype
            dev = value.device if self._device_hint is None \
                else resolve_device(self._device_hint)
            self._deferred_init = None
            self._bind(value.detach().to(device=dev, dtype=dt, copy=True))
            return
        t = self._data._data
        pl = getattr(self, "_placement", None)
        if pl is not None:
            # a whole value: the rank's block of it
            if tuple(value.shape) != pl.shape:
                raise MXNetError(
                    f"Parameter {self._name} is stored as its block of "
                    f"{pl.shape}; set_data takes the whole tensor, got "
                    f"{tuple(value.shape)}")
            value = pl.block_of(value.to(t.device))
        if tuple(value.shape) == tuple(t.shape):
            with torch.no_grad():
                t.copy_(value)
            self._data._version += 1
            return
        self._bind(value.detach().to(device=t.device, dtype=t.dtype,
                                     copy=True))

    def reset_device(self, device):
        """Move the data to ``device`` (a new tensor, registered anew)."""
        if self._data is not None:
            dev = resolve_device(device)
            if self._data._data.device != dev:
                self._bind(self._data._data.detach().to(dev))
        else:
            self._device_hint = device

    reset_ctx = reset_device

    def cast(self, dtype):
        self._dtype = np_dtype(dtype)
        if self._data is not None:
            t = self._data._data
            dt = torch_dtype(dtype)
            if t.dtype != dt:
                self._bind(t.detach().to(dt))

    def var(self):
        raise MXNetError("Parameter.var: the symbol API is not ported "
                         "(ROADMAP.md §1 item 11b); use hybridize()")

    def __repr__(self):
        return (f"Parameter {self._name} (shape={self._shape}, "
                f"dtype={dtype_name(self.dtype)})")


class Constant(Parameter):
    """Non-learnable parameter holding a constant (reference:
    parameter.py), ready to use without `initialize()`."""

    def __init__(self, value, name=None):
        if not isinstance(value, NDArray):
            value = NDArray(value)
        self.value = value
        super().__init__(shape=value.shape, dtype=value.dtype,
                         init=init_mod.Constant(value),
                         grad_req="null", name=name)
        self._bind(value._data.detach().clone())


class ParameterDict(dict):
    """dict of name → Parameter with the reference ParameterDict's bulk
    helpers (`collect_params()` returns one)."""

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_device(ctx)

    reset_device = reset_ctx

