"""NumPy's functions over torch tensors: the port's counterpart of the
``jax.numpy`` functions that the reference's `mx.np` maps its names onto.

Each function takes numpy's parameters (``axis``/``keepdims``, not
``dim``/``keepdim``) and returns what numpy returns, computed by torch;
array arguments may be tensors, Python scalars, lists or numpy arrays.
Results keep torch's dtypes here; the NDArray funnel then applies the
reference's x64-off rule (`base.canonical_dtype`). A name that numpy has
and torch cannot compute faithfully is not defined here (see
`numpy/__init__.py`, which raises for it).
"""
from __future__ import annotations

import builtins
import math

import numpy as onp
import torch
import torch.nn.functional as F

from .base import MXNetError, canonical_dtype

_FLOAT = torch.float32


def _dev():
    from .device import resolve_device

    return resolve_device(None)


def _arr(x, device=None):
    """A tensor for an array-like argument (scalars, lists and numpy
    arrays land on ``device``, else the current device, with the x64-off
    dtype)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (list, tuple)) and builtins.any(
            isinstance(v, torch.Tensor) for v in x):
        dev = next(v.device for v in x if isinstance(v, torch.Tensor))
        return torch.stack([_arr(v, dev) for v in x])
    a = onp.asarray(x)
    t = torch.as_tensor(a)
    t = t.to(canonical_dtype(t.dtype))
    return t.to(device if device is not None else _dev())


def _pair(x1, x2):
    """Two operands as tensors on one device; a Python scalar becomes a
    0-d tensor, which torch promotes as numpy promotes a scalar."""
    if isinstance(x1, torch.Tensor):
        return x1, _arr(x2, x1.device)
    if isinstance(x2, torch.Tensor):
        return _arr(x1, x2.device), x2
    x1 = _arr(x1)
    return x1, _arr(x2, x1.device)


def _float(t):
    return t if (t.is_floating_point() or t.is_complex()) else t.to(_FLOAT)


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(a % ndim if ndim else a for a in axis)


def _td(dtype):
    return None if dtype is None else canonical_dtype(dtype)


def _multi(fn, a, axis, keepdims, **kw):
    """A one-axis torch reduction ``fn(t, dim=, keepdim=)`` over numpy's
    ``axis`` (None, an int or a tuple)."""
    if a.ndim == 0:
        return fn(a.reshape(1), dim=0, keepdim=False, **kw)
    axes = _axes(axis, a.ndim)
    if len(axes) == 1:
        return fn(a, dim=axes[0], keepdim=keepdims, **kw)
    rest = [d for d in range(a.ndim) if d not in axes]
    moved = a.permute(*rest, *axes).reshape(
        [a.shape[d] for d in rest] + [-1])
    r = fn(moved, dim=-1, keepdim=False, **kw)
    if keepdims:
        shape = [1 if d in axes else a.shape[d] for d in range(a.ndim)]
        r = r.reshape(shape)
    return r


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

def _unary(fn, floating=False):
    def op(x, dtype=None, **kwargs):  # noqa: ARG001 — out/where/casting
        x = _arr(x)
        r = fn(_float(x) if floating else x)
        return r if dtype is None else r.to(_td(dtype))

    return op


def _binary(fn):
    def op(x1, x2, dtype=None, **kwargs):  # noqa: ARG001
        r = fn(*_pair(x1, x2))
        return r if dtype is None else r.to(_td(dtype))

    return op


abs = absolute = _unary(torch.abs)  # noqa: A001
fabs = _unary(torch.abs, floating=True)
sqrt = _unary(torch.sqrt)
square = _unary(torch.square)
exp = _unary(torch.exp)
expm1 = _unary(torch.expm1)
exp2 = _unary(torch.exp2)
log = _unary(torch.log)
log2 = _unary(torch.log2)
log10 = _unary(torch.log10)
log1p = _unary(torch.log1p)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
arcsin = _unary(torch.asin)
arccos = _unary(torch.acos)
arctan = _unary(torch.atan)
sinh = _unary(torch.sinh)
cosh = _unary(torch.cosh)
tanh = _unary(torch.tanh)
arcsinh = _unary(torch.asinh)
arccosh = _unary(torch.acosh)
arctanh = _unary(torch.atanh)
floor = _unary(torch.floor)
ceil = _unary(torch.ceil)
trunc = fix = _unary(torch.trunc)
rint = _unary(torch.round, floating=True)
sign = _unary(torch.sign)
signbit = _unary(torch.signbit)
negative = _unary(torch.negative)
positive = _unary(torch.positive)
deg2rad = radians = _unary(torch.deg2rad, floating=True)
rad2deg = degrees = _unary(torch.rad2deg, floating=True)
sinc = _unary(torch.sinc, floating=True)
real = _unary(torch.real)
conj = conjugate = _unary(lambda x: torch.conj(x).resolve_conj())
angle = _unary(torch.angle, floating=True)
invert = bitwise_not = _unary(torch.bitwise_not)
logical_not = _unary(torch.logical_not)
isnan = _unary(torch.isnan)
isinf = _unary(torch.isinf)
isfinite = _unary(torch.isfinite)
isposinf = _unary(torch.isposinf)
isneginf = _unary(torch.isneginf)


def cbrt(x, **kwargs):  # noqa: ARG001
    x = _float(_arr(x))
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def reciprocal(x, **kwargs):  # noqa: ARG001
    x = _arr(x)
    if not (x.is_floating_point() or x.is_complex()):
        # numpy's integer reciprocal: 1 // x
        return torch.div(torch.ones_like(x), x, rounding_mode="trunc")
    return torch.reciprocal(x)


def imag(val):
    val = _arr(val)
    return torch.imag(val) if val.is_complex() else torch.zeros_like(val)


def around(a, decimals=0, out=None):  # noqa: ARG001
    a = _arr(a)
    if not a.is_floating_point():
        return a
    return torch.round(a, decimals=decimals)


round = around  # noqa: A001


def spacing(x, **kwargs):  # noqa: ARG001
    x = _float(_arr(x))
    inf = torch.full_like(x, math.inf)
    return torch.nextafter(x, torch.copysign(inf, x)) - x


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):  # noqa: ARG001
    return torch.nan_to_num(_arr(x), nan=nan, posinf=posinf, neginf=neginf)


def frexp(x, **kwargs):  # noqa: ARG001
    return torch.frexp(_float(_arr(x)))


def ldexp(x1, x2, **kwargs):  # noqa: ARG001
    x1, x2 = _pair(x1, x2)
    return torch.ldexp(_float(x1), x2)


add = _binary(torch.add)
subtract = _binary(torch.subtract)
multiply = _binary(torch.multiply)
divide = true_divide = _binary(torch.true_divide)
floor_divide = _binary(torch.floor_divide)
mod = remainder = _binary(torch.remainder)
fmod = _binary(torch.fmod)
power = _binary(torch.pow)
arctan2 = _binary(torch.atan2)
maximum = _binary(torch.maximum)
minimum = _binary(torch.minimum)
fmax = _binary(torch.fmax)
fmin = _binary(torch.fmin)
hypot = _binary(lambda a, b: torch.hypot(_float(a), _float(b)))
copysign = _binary(lambda a, b: torch.copysign(_float(a), b))
gcd = _binary(torch.gcd)
lcm = _binary(torch.lcm)
logaddexp = _binary(lambda a, b: torch.logaddexp(_float(a), _float(b)))
logaddexp2 = _binary(lambda a, b: torch.logaddexp2(_float(a), _float(b)))
bitwise_and = _binary(torch.bitwise_and)
bitwise_or = _binary(torch.bitwise_or)
bitwise_xor = _binary(torch.bitwise_xor)
left_shift = _binary(torch.bitwise_left_shift)
right_shift = _binary(torch.bitwise_right_shift)
nextafter = _binary(torch.nextafter)
equal = _binary(torch.eq)
not_equal = _binary(torch.ne)
greater = _binary(torch.gt)
greater_equal = _binary(torch.ge)
less = _binary(torch.lt)
less_equal = _binary(torch.le)
logical_and = _binary(torch.logical_and)
logical_or = _binary(torch.logical_or)
logical_xor = _binary(torch.logical_xor)


def float_power(x1, x2, **kwargs):  # noqa: ARG001
    x1, x2 = _pair(x1, x2)
    return torch.float_power(x1, x2)


def heaviside(x1, x2, **kwargs):  # noqa: ARG001
    x1, x2 = _pair(x1, x2)
    x1 = _float(x1)
    return torch.heaviside(x1, x2.to(x1.dtype))


def clip(a, a_min=None, a_max=None, out=None, **kwargs):  # noqa: ARG001
    a = _arr(a)
    lo = a_min if not isinstance(a_min, (list, onp.ndarray)) else _arr(
        a_min, a.device)
    hi = a_max if not isinstance(a_max, (list, onp.ndarray)) else _arr(
        a_max, a.device)
    return torch.clamp(a, lo, hi)


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _pair(a, b)
    return torch.isclose(a, b.to(a.dtype) if b.dtype != a.dtype else b,
                         rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return isclose(a, b, rtol, atol, equal_nan).all()


def array_equal(a1, a2, equal_nan=False):
    a1, a2 = _pair(a1, a2)
    if a1.shape != a2.shape:
        return torch.tensor(False, device=a1.device)
    eq = a1 == a2
    if equal_nan and a1.is_floating_point():
        eq = eq | (torch.isnan(a1) & torch.isnan(a2))
    return eq.all()


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def matmul(x1, x2, **kwargs):  # noqa: ARG001
    return torch.matmul(*_pair(x1, x2))


def dot(a, b, out=None):  # noqa: ARG001
    a, b = _pair(a, b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1 or a.ndim <= 2 and b.ndim == 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [b.ndim - 2]))


def vdot(a, b):
    a, b = _pair(a, b)
    return torch.sum(torch.conj(a.reshape(-1)) * b.reshape(-1))


def inner(a, b):
    return torch.inner(*_pair(a, b))


def outer(a, b, out=None):  # noqa: ARG001
    a, b = _pair(a, b)
    return torch.outer(a.reshape(-1), b.reshape(-1))


def tensordot(a, b, axes=2):
    a, b = _pair(a, b)
    if isinstance(axes, (list, tuple)):
        axes = [list(x) if isinstance(x, (list, tuple)) else [x]
                for x in axes]
    return torch.tensordot(a, b, dims=axes)


def kron(a, b):
    return torch.kron(*_pair(a, b))


def cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    a, b = _pair(a, b)
    if axis is not None:
        axisa = axisb = axisc = axis
    a, b = torch.movedim(a, axisa, -1), torch.movedim(b, axisb, -1)
    if a.shape[-1] != 3 or b.shape[-1] != 3:
        raise MXNetError("np.cross: only 3-vectors are ported")
    a, b = torch.broadcast_tensors(a, b)
    return torch.movedim(torch.linalg.cross(a, b, dim=-1), -1, axisc)


def trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):  # noqa: ARG001
    r = torch.diagonal(_arr(a), offset, axis1, axis2).sum(-1)
    return r if dtype is None else r.to(_td(dtype))


def diag(v, k=0):
    return torch.diag(_arr(v), k)


def diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_arr(a), offset, axis1, axis2)


def diagflat(v, k=0):
    return torch.diagflat(_arr(v), k)


def tril(m, k=0):
    return torch.tril(_arr(m), k)


def triu(m, k=0):
    return torch.triu(_arr(m), k)


def vander(x, N=None, increasing=False):
    return torch.linalg.vander(_arr(x), N=N).flip(-1) if not increasing \
        else torch.linalg.vander(_arr(x), N=N)


def einsum(subscripts, *operands, **kwargs):  # noqa: ARG001 — optimize=
    dev = next((o.device for o in operands if isinstance(o, torch.Tensor)),
               None)
    return torch.einsum(subscripts, *[_arr(o, dev) for o in operands])


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _sum_like(fn):
    def op(a, axis=None, dtype=None, out=None, keepdims=False,  # noqa: ARG001
           initial=None, where=None):
        a = _arr(a)
        if where is not None:
            a = torch.where(_arr(where, a.device), a,
                            torch.zeros((), dtype=a.dtype, device=a.device)
                            if fn is torch.sum else
                            torch.ones((), dtype=a.dtype, device=a.device))
        dt = _td(dtype)
        if a.dtype == torch.bool and dt is None:
            dt = torch.int32
        if axis == ():
            r = a if dt is None else a.to(dt)
        elif fn is torch.sum:
            r = torch.sum(a, dim=None if axis is None else _axes(axis, a.ndim),
                          keepdim=keepdims, dtype=dt)
        else:
            r = _multi(torch.prod, a if dt is None else a.to(dt), axis,
                       keepdims)
        if initial is not None:
            r = r + initial if fn is torch.sum else r * initial
        return r

    return op


sum = _sum_like(torch.sum)  # noqa: A001
prod = product = _sum_like(torch.prod)


def mean(a, axis=None, dtype=None, out=None, keepdims=False, where=None):  # noqa: ARG001
    a = _float(_arr(a))
    if dtype is not None:
        a = a.to(_td(dtype))
    if where is not None:
        w = _arr(where, a.device).to(a.dtype)
        return (a * w).sum(dim=_axes(axis, a.ndim), keepdim=keepdims) / \
            w.expand(a.shape).sum(dim=_axes(axis, a.ndim), keepdim=keepdims)
    if axis == ():
        return a
    return torch.mean(a, dim=None if axis is None else _axes(axis, a.ndim),
                      keepdim=keepdims)


def _moment(fn):
    def op(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,  # noqa: ARG001
           where=None, correction=None):  # noqa: ARG001
        a = _float(_arr(a))
        if dtype is not None:
            a = a.to(_td(dtype))
        c = ddof if correction is None else correction
        return fn(a, dim=None if axis is None else _axes(axis, a.ndim),
                  correction=c, keepdim=keepdims)

    return op


std = _moment(torch.std)
var = _moment(torch.var)


def _minmax(fn):
    def op(a, axis=None, out=None, keepdims=False, initial=None,  # noqa: ARG001
           where=None):  # noqa: ARG001
        a = _arr(a)
        if a.ndim == 0:
            r = a
        else:
            r = fn(a, dim=_axes(axis, a.ndim), keepdim=keepdims)
        if initial is not None:
            r = (torch.maximum if fn is torch.amax else torch.minimum)(
                r, torch.as_tensor(initial, dtype=r.dtype, device=r.device))
        return r

    return op


max = amax = _minmax(torch.amax)  # noqa: A001
min = amin = _minmax(torch.amin)  # noqa: A001


def ptp(a, axis=None, out=None, keepdims=False):  # noqa: ARG001
    return max(a, axis, keepdims=keepdims) - min(a, axis, keepdims=keepdims)


def _arg(fn, a, axis, keepdims):
    a = _arr(a)
    if axis is None:
        r = fn(a.reshape(-1), dim=0)
        return r.reshape((1,) * a.ndim) if keepdims else r
    return fn(a, dim=axis, keepdim=keepdims)


def argmax(a, axis=None, out=None, keepdims=False):  # noqa: ARG001
    return _arg(torch.argmax, a, axis, keepdims)


def argmin(a, axis=None, out=None, keepdims=False):  # noqa: ARG001
    return _arg(torch.argmin, a, axis, keepdims)


def nanargmax(a, axis=None, out=None, keepdims=False):  # noqa: ARG001
    a = _arr(a)
    return argmax(torch.where(torch.isnan(a), -math.inf, a), axis,
                  keepdims=keepdims)


def nanargmin(a, axis=None, out=None, keepdims=False):  # noqa: ARG001
    a = _arr(a)
    return argmin(torch.where(torch.isnan(a), math.inf, a), axis,
                  keepdims=keepdims)


def nansum(a, axis=None, dtype=None, out=None, keepdims=False, **kw):  # noqa: ARG001
    a = _arr(a)
    if not a.is_floating_point():
        return sum(a, axis, dtype, keepdims=keepdims)
    return torch.nansum(a, dim=None if axis is None else _axes(axis, a.ndim),
                        keepdim=keepdims, dtype=_td(dtype))


def nanprod(a, axis=None, dtype=None, out=None, keepdims=False, **kw):  # noqa: ARG001
    a = _arr(a)
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), 1.0, a)
    return prod(a, axis, dtype, keepdims=keepdims)


def nanmean(a, axis=None, dtype=None, out=None, keepdims=False, **kw):  # noqa: ARG001
    a = _float(_arr(a))
    return torch.nanmean(a, dim=None if axis is None else _axes(axis, a.ndim),
                         keepdim=keepdims, dtype=_td(dtype))


def _nanmoment(square_root):
    def op(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,  # noqa: ARG001
           **kw):  # noqa: ARG001
        a = _float(_arr(a))
        ok = ~torch.isnan(a)
        dims = _axes(axis, a.ndim)
        n = ok.sum(dim=dims, keepdim=True)
        m = torch.where(ok, a, 0).sum(dim=dims, keepdim=True) / n
        d = torch.where(ok, a - m, 0)
        v = (d * d).sum(dim=dims, keepdim=keepdims) / (
            ok.sum(dim=dims, keepdim=keepdims) - ddof)
        return torch.sqrt(v) if square_root else v

    return op


nanstd = _nanmoment(True)
nanvar = _nanmoment(False)


def nanmax(a, axis=None, out=None, keepdims=False, **kw):  # noqa: ARG001
    a = _arr(a)
    if not a.is_floating_point():
        return max(a, axis, keepdims=keepdims)
    r = max(torch.where(torch.isnan(a), -math.inf, a), axis,
            keepdims=keepdims)
    allnan = torch.isnan(a).all(dim=_axes(axis, a.ndim), keepdim=keepdims)
    return torch.where(allnan, math.nan, r)


def nanmin(a, axis=None, out=None, keepdims=False, **kw):  # noqa: ARG001
    a = _arr(a)
    if not a.is_floating_point():
        return min(a, axis, keepdims=keepdims)
    r = min(torch.where(torch.isnan(a), math.inf, a), axis,
            keepdims=keepdims)
    allnan = torch.isnan(a).all(dim=_axes(axis, a.ndim), keepdim=keepdims)
    return torch.where(allnan, math.nan, r)


def all(a, axis=None, out=None, keepdims=False, **kw):  # noqa: A001,ARG001
    a = _arr(a)
    if a.ndim == 0:
        return a.bool()
    return torch.all(a, dim=_axes(axis, a.ndim), keepdim=keepdims)


def any(a, axis=None, out=None, keepdims=False, **kw):  # noqa: A001,ARG001
    a = _arr(a)
    if a.ndim == 0:
        return a.bool()
    return torch.any(a, dim=_axes(axis, a.ndim), keepdim=keepdims)


sometrue = any


def count_nonzero(a, axis=None, keepdims=False):
    a = _arr(a)
    r = torch.count_nonzero(a, dim=None if axis is None
                            else _axes(axis, a.ndim))
    if keepdims:
        shape = [1 if d in _axes(axis, a.ndim) else s
                 for d, s in enumerate(a.shape)]
        r = r.reshape(shape)
    return r


def _cum(fn, nan_fill=None):
    def op(a, axis=None, dtype=None, out=None):  # noqa: ARG001
        a = _arr(a)
        if nan_fill is not None and a.is_floating_point():
            a = torch.where(torch.isnan(a), nan_fill, a)
        if a.dtype == torch.bool:
            a = a.to(torch.int32)
        if axis is None:
            a, axis = a.reshape(-1), 0
        return fn(a, dim=axis, dtype=_td(dtype))

    return op


cumsum = _cum(torch.cumsum)
cumprod = _cum(torch.cumprod)
nancumsum = _cum(torch.cumsum, 0.0)
nancumprod = _cum(torch.cumprod, 1.0)


def average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _float(_arr(a))
    if weights is None:
        avg = mean(a, axis, keepdims=keepdims)
        wsum = torch.full_like(avg, a.numel() / avg.numel())
    else:
        w = _float(_arr(weights, a.device))
        if w.ndim == 1 and a.ndim > 1 and axis is not None:
            shape = [1] * a.ndim
            shape[axis] = -1
            w = w.reshape(shape)
        dims = _axes(axis, a.ndim)
        wsum = torch.broadcast_to(w, a.shape).sum(dim=dims, keepdim=keepdims)
        avg = (a * w).sum(dim=dims, keepdim=keepdims) / wsum
    return (avg, wsum) if returned else avg


_METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def _quantile(a, q, axis, method, keepdims, nan):
    a = _float(_arr(a))
    if method not in _METHODS:
        raise MXNetError(f"np.quantile: method {method!r} is not ported; "
                         f"the port has {_METHODS}")
    qt = _arr(q, a.device).to(a.dtype)
    fn = torch.nanquantile if nan else torch.quantile
    if axis is None or isinstance(axis, int):
        return fn(a, qt, dim=axis, keepdim=keepdims, interpolation=method)
    axes = _axes(axis, a.ndim)
    rest = [d for d in range(a.ndim) if d not in axes]
    moved = a.permute(*rest, *axes).reshape([a.shape[d] for d in rest] + [-1])
    r = fn(moved, qt, dim=-1, keepdim=False, interpolation=method)
    if keepdims:
        shape = [1 if d in axes else a.shape[d] for d in range(a.ndim)]
        r = r.reshape(tuple(qt.shape) + tuple(shape))
    return r


def quantile(a, q, axis=None, out=None, overwrite_input=False,  # noqa: ARG001
             method="linear", keepdims=False, **kw):  # noqa: ARG001
    return _quantile(a, q, axis, method, keepdims, False)


def percentile(a, q, axis=None, out=None, overwrite_input=False,  # noqa: ARG001
               method="linear", keepdims=False, **kw):  # noqa: ARG001
    return _quantile(a, _arr(q).to(_FLOAT) / 100.0, axis, method, keepdims,
                     False)


def nanquantile(a, q, axis=None, out=None, overwrite_input=False,  # noqa: ARG001
                method="linear", keepdims=False, **kw):  # noqa: ARG001
    return _quantile(a, q, axis, method, keepdims, True)


def nanpercentile(a, q, axis=None, out=None, overwrite_input=False,  # noqa: ARG001
                  method="linear", keepdims=False, **kw):  # noqa: ARG001
    return _quantile(a, _arr(q).to(_FLOAT) / 100.0, axis, method, keepdims,
                     True)


def median(a, axis=None, out=None, overwrite_input=False, keepdims=False):  # noqa: ARG001
    return _quantile(a, 0.5, axis, "linear", keepdims, False)


def nanmedian(a, axis=None, out=None, overwrite_input=False, keepdims=False):  # noqa: ARG001
    return _quantile(a, 0.5, axis, "linear", keepdims, True)


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------

def reshape(a, *args, newshape=None, shape=None, order="C", **kw):  # noqa: ARG001
    if args:
        shape = args[0]
    shape = shape if shape is not None else newshape
    if isinstance(shape, int):
        shape = (shape,)
    return torch.reshape(_arr(a), tuple(shape))


def ravel(a, order="C"):  # noqa: ARG001
    return torch.reshape(_arr(a), (-1,))


def transpose(a, axes=None):
    a = _arr(a)
    if axes is None:
        axes = tuple(range(a.ndim))[::-1]
    return a.permute(*axes)


def swapaxes(a, axis1, axis2):
    return torch.swapaxes(_arr(a), axis1, axis2)


def moveaxis(a, source, destination):
    return torch.movedim(_arr(a), source, destination)


def rollaxis(a, axis, start=0):
    a = _arr(a)
    n = a.ndim
    axis %= n
    start = start + n if start < 0 else start
    if axis < start:
        start -= 1
    if axis == start:
        return a
    return torch.movedim(a, axis, start)


def squeeze(a, axis=None):
    a = _arr(a)
    if axis is None:
        return torch.squeeze(a)
    axes = _axes(axis, a.ndim)
    for ax in axes:
        if a.shape[ax] != 1:
            raise ValueError("cannot select an axis to squeeze out which "
                             "has size not equal to one")
    return torch.squeeze(a, axes)


def expand_dims(a, axis):
    a = _arr(a)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    n = a.ndim + len(axes)
    for ax in sorted(x % n for x in axes):
        a = a.unsqueeze(ax)
    return a


def broadcast_to(array, shape):
    if isinstance(shape, int):
        shape = (shape,)
    return torch.broadcast_to(_arr(array), tuple(shape))


def broadcast_arrays(*args):
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               None)
    return tuple(torch.broadcast_tensors(*[_arr(a, dev) for a in args]))


def _list(arrays):
    arrays = list(arrays)
    dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
               None)
    return [_arr(a, dev) for a in arrays]


def concatenate(arrays, axis=0, out=None, dtype=None, **kw):  # noqa: ARG001
    arrays = _list(arrays)
    if axis is None:
        arrays, axis = [a.reshape(-1) for a in arrays], 0
    r = torch.cat(arrays, dim=axis)
    return r if dtype is None else r.to(_td(dtype))


def stack(arrays, axis=0, out=None, dtype=None):  # noqa: ARG001
    r = torch.stack(_list(arrays), dim=axis)
    return r if dtype is None else r.to(_td(dtype))


def vstack(tup, dtype=None):
    r = torch.vstack(_list(tup))
    return r if dtype is None else r.to(_td(dtype))


def hstack(tup, dtype=None):
    r = torch.hstack(_list(tup))
    return r if dtype is None else r.to(_td(dtype))


def dstack(tup, dtype=None):
    r = torch.dstack(_list(tup))
    return r if dtype is None else r.to(_td(dtype))


def column_stack(tup):
    return torch.column_stack(_list(tup))


def tile(A, reps):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return torch.tile(_arr(A), reps)


def repeat(a, repeats, axis=None, **kw):  # noqa: ARG001
    a = _arr(a)
    if isinstance(repeats, (list, tuple, onp.ndarray)):
        repeats = _arr(repeats, a.device).long()
    elif isinstance(repeats, torch.Tensor):
        repeats = repeats.long()
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.repeat_interleave(a, repeats, dim=axis)


def flip(m, axis=None):
    m = _arr(m)
    return torch.flip(m, _axes(axis, m.ndim))


def flipud(m):
    return torch.flipud(_arr(m))


def fliplr(m):
    return torch.fliplr(_arr(m))


def roll(a, shift, axis=None):
    a = _arr(a)
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


def rot90(m, k=1, axes=(0, 1)):
    return torch.rot90(_arr(m), k, list(axes))


def atleast_1d(*arys):
    r = [torch.atleast_1d(_arr(a)) for a in arys]
    return r[0] if len(r) == 1 else r


def atleast_2d(*arys):
    r = [torch.atleast_2d(_arr(a)) for a in arys]
    return r[0] if len(r) == 1 else r


def atleast_3d(*arys):
    r = [torch.atleast_3d(_arr(a)) for a in arys]
    return r[0] if len(r) == 1 else r


def append(arr, values, axis=None):
    arr = _arr(arr)
    values = _arr(values, arr.device)
    if axis is None:
        return torch.cat([arr.reshape(-1), values.reshape(-1)])
    return torch.cat([arr, values], dim=axis)


def resize(a, new_shape):
    a = _arr(a).reshape(-1)
    new_shape = (new_shape,) if isinstance(new_shape, int) else tuple(
        new_shape)
    n = int(onp.prod(new_shape))
    if a.numel() == 0:
        return torch.zeros(new_shape, dtype=a.dtype, device=a.device)
    reps = -(-n // a.numel())
    return a.repeat(reps)[:n].reshape(new_shape)


def _pad_index(n, lo, hi, mode, device):
    """Source indices of one axis padded by (lo, hi) in ``mode``."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        p = 2 * (n - 1)
        j = i % p
        return torch.where(j >= n, p - j, j)
    if mode == "symmetric":
        p = 2 * n
        j = i % p
        return torch.where(j >= n, p - 1 - j, j)
    raise MXNetError(f"np.pad: mode {mode!r} is not ported")


def pad(array, pad_width, mode="constant", **kwargs):
    a = _arr(array)
    pw = onp.broadcast_to(onp.asarray(pad_width, dtype=onp.int64),
                          (a.ndim, 2))
    if mode == "constant":
        value = kwargs.get("constant_values", 0)
        if not isinstance(value, (int, float, bool)):
            raise MXNetError("np.pad: per-axis constant_values are not "
                             "ported")
        flat = []
        for lo, hi in pw[::-1]:
            flat += [int(lo), int(hi)]
        return F.pad(a, flat, value=value)
    for ax in range(a.ndim):
        lo, hi = int(pw[ax][0]), int(pw[ax][1])
        if lo or hi:
            a = torch.index_select(
                a, ax, _pad_index(a.shape[ax], lo, hi, mode, a.device))
    return a


# ---------------------------------------------------------------------------
# indexing, search, sort
# ---------------------------------------------------------------------------

def where(condition, x=None, y=None):
    c = _arr(condition)
    if x is None and y is None:
        return nonzero(c)
    x, y = _pair(x, y)
    return torch.where(c.bool(), x, y)


def _norm_index(idx, n, mode):
    if mode == "clip":
        return idx.clamp(0, n - 1)
    if mode == "wrap":
        return idx % n
    return torch.where(idx < 0, idx + n, idx)


def take(a, indices, axis=None, out=None, mode=None, **kw):  # noqa: ARG001
    a = _arr(a)
    idx = _arr(indices, a.device).long()
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis %= a.ndim
    idx = _norm_index(idx, a.shape[axis], mode)
    r = torch.index_select(a, axis, idx.reshape(-1))
    return r.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def take_along_axis(arr, indices, axis, **kw):  # noqa: ARG001
    arr = _arr(arr)
    idx = _arr(indices, arr.device).long()
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    idx = _norm_index(idx, arr.shape[axis], None)
    return torch.take_along_dim(arr, idx, dim=axis)


def choose(a, choices, out=None, mode="raise"):  # noqa: ARG001
    a = _arr(a).long()
    ch = _list(choices)
    n = len(ch)
    a = _norm_index(a, n, mode if mode in ("clip", "wrap") else None)
    stacked = torch.stack(torch.broadcast_tensors(a, *ch)[1:])
    a = torch.broadcast_to(a, stacked.shape[1:])
    return torch.gather(stacked, 0, a.unsqueeze(0))[0]


def compress(condition, a, axis=None, out=None):  # noqa: ARG001
    a = _arr(a)
    c = _arr(condition, a.device).bool().reshape(-1)
    if axis is None:
        a, axis = a.reshape(-1), 0
    idx = torch.nonzero(c[:a.shape[axis]]).reshape(-1)
    return torch.index_select(a, axis, idx)


def extract(condition, arr):
    arr = _arr(arr)
    return arr.reshape(-1)[_arr(condition, arr.device).reshape(-1).bool()]


def searchsorted(a, v, side="left", sorter=None):
    a = _arr(a)
    v = _arr(v, a.device)
    if sorter is not None:
        a = a[_arr(sorter, a.device).long()]
    return torch.searchsorted(a, v.to(a.dtype) if v.dtype != a.dtype else v,
                              right=side == "right")


def argsort(a, axis=-1, kind=None, order=None, stable=True, descending=False):  # noqa: ARG001
    a = _arr(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.argsort(a, dim=axis, stable=True, descending=descending)


def sort(a, axis=-1, kind=None, order=None, stable=True, descending=False):  # noqa: ARG001
    a = _arr(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.sort(a, dim=axis, stable=True, descending=descending).values


def lexsort(keys, axis=-1):
    keys = _list(keys)
    idx = torch.argsort(keys[0], dim=axis, stable=True)
    for k in keys[1:]:
        k = torch.take_along_dim(k, idx, dim=axis)
        step = torch.argsort(k, dim=axis, stable=True)
        idx = torch.take_along_dim(idx, step, dim=axis)
    return idx


def partition(a, kth, axis=-1, kind="introselect", order=None):  # noqa: ARG001
    # a sorted array is a partition for every kth
    return sort(a, axis)


def argpartition(a, kth, axis=-1, kind="introselect", order=None):  # noqa: ARG001
    return argsort(a, axis)


def nonzero(a):
    return torch.nonzero(_arr(a), as_tuple=True)


def argwhere(a):
    return torch.argwhere(_arr(a))


def flatnonzero(a):
    return torch.nonzero(_arr(a).reshape(-1)).reshape(-1)


def unravel_index(indices, shape, order="C"):  # noqa: ARG001
    return tuple(torch.unravel_index(_arr(indices).long(), tuple(shape)))


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):  # noqa: ARG001
    idx = _list(multi_index)
    out = torch.zeros_like(idx[0]).long()
    for i, n in zip(idx, dims):
        i = i.long()
        if mode == "clip":
            i = i.clamp(0, n - 1)
        elif mode == "wrap":
            i = i % n
        out = out * n + i
    return out


def diag_indices(n, ndim=2):
    i = torch.arange(n, device=_dev())
    return (i,) * ndim


def diag_indices_from(arr):
    arr = _arr(arr)
    i = torch.arange(arr.shape[0], device=arr.device)
    return (i,) * arr.ndim


def tril_indices(n, k=0, m=None):
    r = torch.tril_indices(n, n if m is None else m, k, device=_dev())
    return r[0], r[1]


def triu_indices(n, k=0, m=None):
    r = torch.triu_indices(n, n if m is None else m, k, device=_dev())
    return r[0], r[1]


def indices(dimensions, dtype=None, sparse=False):
    dev = _dev()
    grids = [torch.arange(n, device=dev) for n in dimensions]
    if sparse:
        out = []
        for i, g in enumerate(grids):
            shape = [1] * len(grids)
            shape[i] = -1
            out.append(g.reshape(shape))
        return tuple(out)
    r = torch.stack(torch.meshgrid(*grids, indexing="ij"))
    return r if dtype is None else r.to(_td(dtype))


# ---------------------------------------------------------------------------
# sets and statistics
# ---------------------------------------------------------------------------

def unique(ar, return_index=False, return_inverse=False, return_counts=False,
           axis=None, **kw):  # noqa: ARG001
    ar = _arr(ar)
    if axis is None:
        u, inv, cnt = torch.unique(ar.reshape(-1), sorted=True, return_inverse=True,
                                   return_counts=True)
    else:
        u, inv, cnt = torch.unique(ar, sorted=True, return_inverse=True,
                                   return_counts=True, dim=axis)
    out = [u]
    if return_index:
        n = inv.numel()
        first = torch.full((cnt.numel(),), n, dtype=torch.long,
                           device=ar.device)
        first = first.scatter_reduce(0, inv.reshape(-1),
                                     torch.arange(n, device=ar.device),
                                     "amin")
        out.append(first)
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(cnt)
    return out[0] if len(out) == 1 else tuple(out)


def isin(element, test_elements, assume_unique=False, invert=False):
    element = _arr(element)
    return torch.isin(element, _arr(test_elements, element.device),
                      assume_unique=assume_unique, invert=invert)


def intersect1d(ar1, ar2, assume_unique=False, return_indices=False):  # noqa: ARG001
    if return_indices:
        raise MXNetError("np.intersect1d: return_indices is not ported")
    a = torch.unique(_arr(ar1))
    b = torch.unique(_arr(ar2, a.device))
    return a[torch.isin(a, b)]


def union1d(ar1, ar2):
    a = _arr(ar1)
    return torch.unique(torch.cat([a.reshape(-1),
                                   _arr(ar2, a.device).reshape(-1)]))


def setdiff1d(ar1, ar2, assume_unique=False):  # noqa: ARG001
    a = torch.unique(_arr(ar1))
    return a[~torch.isin(a, _arr(ar2, a.device))]


def setxor1d(ar1, ar2, assume_unique=False):  # noqa: ARG001
    a = torch.unique(_arr(ar1))
    b = torch.unique(_arr(ar2, a.device))
    return torch.unique(torch.cat([a[~torch.isin(a, b)],
                                   b[~torch.isin(b, a)]]))


def bincount(x, weights=None, minlength=0, **kw):  # noqa: ARG001
    x = _arr(x)
    w = None if weights is None else _arr(weights, x.device)
    return torch.bincount(x.reshape(-1).long(), weights=w,
                          minlength=minlength)


def histogram(a, bins=10, range=None, density=None, weights=None):  # noqa: A002
    a = _float(_arr(a)).reshape(-1)
    if isinstance(bins, int):
        lo, hi = (a.min(), a.max()) if range is None else (
            torch.tensor(range[0], dtype=a.dtype, device=a.device),
            torch.tensor(range[1], dtype=a.dtype, device=a.device))
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = linspace(float(lo), float(hi), bins + 1, dtype=a.dtype,
                         device=a.device)
    else:
        edges = _float(_arr(bins, a.device))
    nb = edges.numel() - 1
    idx = torch.bucketize(a, edges, right=True) - 1
    idx = torch.where(a == edges[-1], nb - 1, idx)
    ok = (idx >= 0) & (idx < nb)
    w = torch.ones_like(a) if weights is None else _float(
        _arr(weights, a.device)).reshape(-1)
    counts = torch.zeros(nb, dtype=w.dtype, device=a.device).index_add_(
        0, idx[ok], w[ok])
    if density:
        counts = counts / counts.sum() / torch.diff(edges)
    return counts, edges


def digitize(x, bins, right=False):
    x = _arr(x)
    b = _arr(bins, x.device)
    if b.numel() > 1 and b[0] > b[-1]:
        n = b.numel()
        return n - torch.bucketize(x, b.flip(0), right=not right)
    return torch.bucketize(x, b, right=not right)


def corrcoef(x, y=None, rowvar=True, **kw):  # noqa: ARG001
    x = _float(_arr(x))
    if x.ndim == 1:
        x = x[None]
    if y is not None:
        y = _float(_arr(y, x.device))
        x = torch.cat([x, y[None] if y.ndim == 1 else y])
    if not rowvar:
        x = x.T
    return torch.corrcoef(x)


def cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
        aweights=None, **kw):  # noqa: ARG001
    m = _float(_arr(m))
    if m.ndim == 1:
        m = m[None]
    if y is not None:
        y = _float(_arr(y, m.device))
        y = y[None] if y.ndim == 1 else y
        m = torch.cat([m, y if rowvar else y.T]) if rowvar else torch.cat(
            [m, y], dim=1)
    if not rowvar:
        m = m.T
    c = (0 if bias else 1) if ddof is None else ddof
    fw = None if fweights is None else _arr(fweights, m.device).long()
    aw = None if aweights is None else _float(_arr(aweights, m.device))
    r = torch.cov(m, correction=c, fweights=fw, aweights=aw)
    return r


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def diff(a, n=1, axis=-1, prepend=None, append=None):
    a = _arr(a)
    pre = None if prepend is None else torch.broadcast_to(
        _arr(prepend, a.device), a.shape[:axis % a.ndim] + (1,)
        + a.shape[axis % a.ndim + 1:]) if _arr(prepend, a.device).ndim == 0 \
        else _arr(prepend, a.device)
    app = None if append is None else torch.broadcast_to(
        _arr(append, a.device), a.shape[:axis % a.ndim] + (1,)
        + a.shape[axis % a.ndim + 1:]) if _arr(append, a.device).ndim == 0 \
        else _arr(append, a.device)
    return torch.diff(a, n=n, dim=axis, prepend=pre, append=app)


def ediff1d(ary, to_end=None, to_begin=None):
    a = _arr(ary).reshape(-1)
    parts = []
    if to_begin is not None:
        parts.append(_arr(to_begin, a.device).reshape(-1).to(a.dtype))
    parts.append(torch.diff(a))
    if to_end is not None:
        parts.append(_arr(to_end, a.device).reshape(-1).to(a.dtype))
    return torch.cat(parts)


def gradient(f, *varargs, axis=None, edge_order=1):
    f = _float(_arr(f))
    dims = list(_axes(axis, f.ndim))
    spacing = [float(v) if not isinstance(v, torch.Tensor) else v
               for v in varargs] if varargs else 1.0
    r = torch.gradient(f, spacing=spacing, dim=dims, edge_order=edge_order)
    return r[0] if len(r) == 1 else tuple(r)


def convolve(a, v, mode="full"):
    a, v = _pair(a, v)
    if a.numel() < v.numel():
        a, v = v, a
    a, v = _float(a), _float(v)
    n, m = a.numel(), v.numel()
    full = F.conv1d(a.reshape(1, 1, n), v.flip(0).reshape(1, 1, m),
                    padding=m - 1).reshape(-1)
    if mode == "full":
        return full
    if mode == "same":
        start = (m - 1) // 2
        return full[start:start + n]
    if mode == "valid":
        return full[m - 1:n]
    raise ValueError(f"mode {mode!r} not understood")


def correlate(a, v, mode="valid"):
    a, v = _pair(a, v)
    a, v = _float(a), _float(v)
    n, m = a.numel(), v.numel()
    if n < m:
        raise MXNetError("np.correlate: len(v) > len(a) is not ported")
    full = F.conv1d(a.reshape(1, 1, n), v.reshape(1, 1, m),
                    padding=m - 1).reshape(-1)
    if mode == "full":
        return full
    if mode == "same":
        start = (m - 1) // 2
        return full[start:start + n]
    if mode == "valid":
        return full[m - 1:n]
    raise ValueError(f"mode {mode!r} not understood")


def polyval(p, x):
    p = _arr(p)
    x = _arr(x, p.device)
    y = torch.zeros_like(x, dtype=torch.result_type(p, x))
    for c in p:
        y = y * x + c
    return y


def meshgrid(*xi, copy=True, sparse=False, indexing="xy"):  # noqa: ARG001
    xi = _list(xi)
    if sparse:
        n = len(xi)
        out = []
        for i, x in enumerate(xi):
            shape = [1] * n
            shape[i] = -1
            out.append(x.reshape(shape))
        if indexing == "xy" and n > 1:
            out[0] = out[0].reshape([1, -1] + [1] * (n - 2))
            out[1] = out[1].reshape([-1, 1] + [1] * (n - 2))
        return out
    return list(torch.meshgrid(*xi, indexing=indexing))


def array_split(ary, indices_or_sections, axis=0):
    a = _arr(ary)
    ios = indices_or_sections
    if not isinstance(ios, int):
        ios = [int(i) for i in ios]
    return list(torch.tensor_split(a, ios, dim=axis))


def split(ary, indices_or_sections, axis=0):
    a = _arr(ary)
    if isinstance(indices_or_sections, int) and \
            a.shape[axis] % indices_or_sections:
        raise ValueError("array split does not result in an equal division")
    return array_split(a, indices_or_sections, axis)


def hsplit(ary, indices_or_sections):
    a = _arr(ary)
    return split(a, indices_or_sections, 1 if a.ndim > 1 else 0)


def vsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, 0)


def dsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, 2)


def delete(arr, obj, axis=None):
    arr = _arr(arr)
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    n = arr.shape[axis]
    keep = torch.ones(n, dtype=torch.bool, device=arr.device)
    if isinstance(obj, slice):
        keep[obj] = False
    else:
        idx = _arr(obj, arr.device).long().reshape(-1)
        keep[torch.where(idx < 0, idx + n, idx)] = False
    return torch.index_select(arr, axis, torch.nonzero(keep).reshape(-1))


def insert(arr, obj, values, axis=None):
    arr = _arr(arr)
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    axis %= arr.ndim
    n = arr.shape[axis]
    if not isinstance(obj, int):
        raise MXNetError("np.insert: only a single integer index is ported")
    i = obj + n if obj < 0 else obj
    # numpy: values at least arr's rank, their first axis moved to `axis`
    vals = _arr(values, arr.device).to(arr.dtype)
    vals = vals.reshape([1] * (arr.ndim - vals.ndim) + list(vals.shape))
    vals = torch.movedim(vals, 0, axis)
    shape = list(arr.shape)
    shape[axis] = vals.shape[axis]
    vals = torch.broadcast_to(vals, shape)
    lo = torch.narrow(arr, axis, 0, i)
    hi = torch.narrow(arr, axis, i, n - i)
    return torch.cat([lo, vals, hi], dim=axis)


def trim_zeros(filt, trim="fb"):
    f = _arr(filt)
    nz = torch.nonzero(f).reshape(-1)
    if nz.numel() == 0:
        return f[:0]
    lo = int(nz[0]) if "f" in trim.lower() else 0
    hi = int(nz[-1]) + 1 if "b" in trim.lower() else f.numel()
    return f[lo:hi]


def ndim(a):
    return _arr(a).ndim


def shape(a):
    return tuple(_arr(a).shape)


def size(a, axis=None):
    a = _arr(a)
    return a.numel() if axis is None else a.shape[axis]


def isscalar(element):
    return isinstance(element, (int, float, complex, bool, onp.generic))


def can_cast(from_, to, casting="safe"):
    return bool(onp.can_cast(from_, to, casting))


def iscomplexobj(x):
    return _arr(x).is_complex()


def isrealobj(x):
    return not _arr(x).is_complex()


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

def _window(fn):
    def op(M, *args):
        return fn(int(M), *args, sym=True, dtype=_FLOAT, device=_dev())

    return op


blackman = _window(torch.signal.windows.blackman)
hamming = _window(torch.signal.windows.hamming)
hanning = _window(torch.signal.windows.hann)
bartlett = _window(torch.signal.windows.bartlett)


def kaiser(M, beta):
    return torch.signal.windows.kaiser(int(M), beta=float(beta), sym=True,
                                       dtype=_FLOAT, device=_dev())


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def zeros(shape, dtype=None, device=None):
    return torch.zeros(shape, dtype=_td(dtype) or _FLOAT, device=device)


def ones(shape, dtype=None, device=None):
    return torch.ones(shape, dtype=_td(dtype) or _FLOAT, device=device)


empty = zeros


def full(shape, fill_value, dtype=None, device=None):
    if isinstance(fill_value, torch.Tensor):
        return torch.broadcast_to(fill_value.to(_td(dtype) or
                                                fill_value.dtype),
                                  shape).clone()
    dt = _td(dtype)
    if dt is None:
        dt = canonical_dtype(torch.as_tensor(fill_value).dtype)
    return torch.full(shape if not isinstance(shape, int) else (shape,),
                      fill_value, dtype=dt, device=device)


def eye(N, M=None, k=0, dtype=None, device=None):
    M = N if M is None else M
    i = torch.arange(N, device=device)[:, None]
    j = torch.arange(M, device=device)[None, :]
    return (j - i == k).to(_td(dtype) or _FLOAT)


def identity(n, dtype=None, device=None):
    return torch.eye(n, dtype=_td(dtype) or _FLOAT, device=device)


def arange(start, stop=None, step=None, dtype=None, device=None):
    if stop is None:
        start, stop = 0, start
    step = 1 if step is None else step
    return torch.arange(start, stop, step, dtype=_td(dtype), device=device)


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, device=None):  # noqa: ARG001
    dt = _td(dtype) or _FLOAT
    if isinstance(start, torch.Tensor) or isinstance(stop, torch.Tensor):
        device = (start if isinstance(start, torch.Tensor) else stop).device
    start = torch.as_tensor(start, dtype=torch.float64, device=device)
    stop = torch.as_tensor(stop, dtype=torch.float64, device=device)
    start, stop = torch.broadcast_tensors(start, stop)
    div = (num - 1) if endpoint else num
    step = (stop - start) / div if div > 0 else torch.full_like(start,
                                                                math.nan)
    i = torch.arange(num, dtype=torch.float64, device=device).reshape(
        (-1,) + (1,) * start.dim())
    r = start + i * step if div > 0 else start.expand((num,) + start.shape)
    if endpoint and num > 1:
        r[-1] = stop
    r = torch.movedim(r.to(dt), 0, axis)
    if retstep:
        return r, step.item() if step.dim() == 0 else step.to(dt)
    return r


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, device=None):  # noqa: ARG001
    r = linspace(start, stop, num, endpoint, dtype=torch.float64,
                 device=device)
    return torch.pow(base, r).to(_td(dtype) or _FLOAT)


def tri(N, M=None, k=0, dtype=None, device=None):
    M = N if M is None else M
    return torch.tril(torch.ones((N, M), dtype=_td(dtype) or _FLOAT,
                                 device=device), k)


def norm(x, ord=None, axis=None, keepdims=False):  # noqa: A002
    x = _float(_arr(x))
    return torch.linalg.norm(x, ord=ord, dim=axis, keepdim=keepdims)
