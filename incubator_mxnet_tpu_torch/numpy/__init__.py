"""NumPy-compatible `np` namespace over torch (port of
`incubator_mxnet_tpu/numpy/__init__.py`).

The reference maps each name onto the `jax.numpy` function of the same
name through the autograd-aware funnel (`apply_op_flat`). The port maps
each onto its counterpart in `_tnp` (numpy's signature over torch
tensors) through the port's funnel, so every op is differentiable under
``autograd.record()`` and runs on the array's device. A name the
reference maps whose reference call itself raises (``result_type``,
``promote_types``) raises :class:`MXNetError` naming it. ``linalg`` is
`numpy/linalg.py`, ``random`` `numpy/random.py`.

Creation ops make arrays on the current device (``with mx.cpu():``, or
``device=``), which is the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as _onp
import torch as _torch

from .. import _tnp
from ..base import MXNetError, canonical_dtype, register_op_meta
from ..device import Device, current_device, resolve_device  # noqa: F401
from ..ndarray.ndarray import NDArray, _arg_reduce, apply_op_flat, waitall  # noqa: F401

ndarray = NDArray

# dtype aliases for parity with `mx.np.float32` style usage
float16 = _onp.float16
float32 = _onp.float32
float64 = _onp.float64
int8 = _onp.int8
int16 = _onp.int16
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
uint16 = _onp.uint16
uint32 = _onp.uint32
uint64 = _onp.uint64
bool_ = _onp.bool_
pi = _onp.pi
e = _onp.e
euler_gamma = _onp.euler_gamma
inf = _onp.inf
nan = _onp.nan
newaxis = None
integer = _onp.integer
floating = _onp.floating


def _device_of(device=None, ctx=None):
    return resolve_device(device or ctx)


# ---------------------------------------------------------------------------
# creation ops
# ---------------------------------------------------------------------------

def array(obj, dtype=None, device=None, ctx=None, copy=True):  # noqa: ARG001
    return NDArray(obj, device=_device_of(device, ctx), dtype=dtype)


def asarray(obj, dtype=None, device=None):
    if isinstance(obj, NDArray) and dtype is None and device is None:
        return obj
    return array(obj, dtype=dtype, device=device)


def _creation(fn_name):
    fn = getattr(_tnp, fn_name)

    def op(*args, dtype=None, device=None, ctx=None, **kwargs):
        args = [a._data.detach() if isinstance(a, NDArray) else a
                for a in args]
        out = fn(*args, dtype=dtype, device=_device_of(device, ctx), **kwargs)
        if isinstance(out, tuple):       # linspace(retstep=True)
            return NDArray(out[0]), out[1]
        return NDArray(out)

    op.__name__ = fn_name
    register_op_meta(fn_name, "np", op)
    return op


zeros = _creation("zeros")
ones = _creation("ones")
empty = _creation("empty")
eye = _creation("eye")
identity = _creation("identity")
arange = _creation("arange")
linspace = _creation("linspace")
logspace = _creation("logspace")
tri = _creation("tri")


def full(shape, fill_value, dtype=None, device=None, ctx=None):
    fv = fill_value._data if isinstance(fill_value, NDArray) else fill_value
    return NDArray(_tnp.full(shape, fv, dtype=dtype,
                             device=_device_of(device, ctx)))


def zeros_like(a, dtype=None):
    return apply_op_flat("zeros_like", lambda x: _torch.zeros_like(
        x, dtype=canonical_dtype(dtype) if dtype else None), (a,))


def ones_like(a, dtype=None):
    return apply_op_flat("ones_like", lambda x: _torch.ones_like(
        x, dtype=canonical_dtype(dtype) if dtype else None), (a,))


def full_like(a, fill_value, dtype=None):
    return apply_op_flat("full_like", lambda x: _torch.full_like(
        x, fill_value, dtype=canonical_dtype(dtype) if dtype else None), (a,))


def empty_like(a, dtype=None):
    return zeros_like(a, dtype)


# ---------------------------------------------------------------------------
# generated ops: one autograd-aware wrapper a `_tnp` function
# ---------------------------------------------------------------------------

def _make(name, fn):
    def op(*args, **kwargs):
        kwargs.pop("out", None)
        kwargs.pop("where", None)
        kwargs = {k: (v._data if isinstance(v, NDArray) else v)
                  for k, v in kwargs.items()}
        return apply_op_flat(name, fn, args, kwargs, cacheable=True)

    op.__name__ = name
    register_op_meta(name, "np", op)
    return op


def _not_ported(name, why):
    def op(*args, **kwargs):  # noqa: ARG001
        raise MXNetError(f"mx.np.{name} is not ported: {why}")

    op.__name__ = name
    return op


_ELEMWISE_AND_FRIENDS = [
    # ufuncs
    "abs", "absolute", "fabs", "add", "subtract", "multiply", "divide",
    "true_divide",
    "floor_divide", "mod", "remainder", "fmod", "power", "float_power", "sqrt",
    "cbrt", "square", "exp", "expm1", "exp2", "log", "log2", "log10", "log1p",
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "arctan2", "sinh",
    "cosh", "tanh", "arcsinh", "arccosh", "arctanh", "floor", "ceil", "trunc",
    "rint", "fix", "around", "round", "sign", "signbit", "reciprocal", "negative",
    "positive", "maximum", "minimum", "fmax", "fmin", "clip", "hypot", "copysign",
    "deg2rad", "rad2deg", "degrees", "radians", "ldexp", "frexp", "gcd", "lcm",
    "logaddexp", "logaddexp2", "sinc", "heaviside", "nan_to_num", "real", "imag",
    "conj", "conjugate", "angle", "invert", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "left_shift", "right_shift", "matmul", "dot",
    "vdot", "inner", "outer", "tensordot", "kron", "cross", "trace", "diag",
    "diagonal", "diagflat", "tril", "triu", "vander",
    # comparisons / logic
    "equal", "not_equal", "greater", "greater_equal", "less", "less_equal",
    "nextafter", "spacing",
    "logical_and", "logical_or", "logical_not", "logical_xor", "isnan", "isinf",
    "isfinite", "isposinf", "isneginf", "isclose", "array_equal", "allclose",
    # reductions
    "sum", "prod", "mean", "std", "var", "min", "max", "amin", "amax", "ptp",
    "argmin", "argmax", "nanargmin", "nanargmax", "nansum", "nanprod", "nanmean",
    "nanstd", "nanvar", "nanmin", "nanmax", "all", "any", "count_nonzero",
    "cumsum", "cumprod", "nancumsum", "nancumprod", "average", "median",
    "quantile", "percentile", "nanmedian", "nanquantile", "nanpercentile",
    # shape manipulation
    "reshape", "ravel", "transpose", "swapaxes", "moveaxis", "rollaxis",
    "squeeze", "expand_dims", "broadcast_to", "concatenate", "stack", "vstack",
    "hstack", "dstack", "column_stack", "row_stack", "tile", "repeat", "flip",
    "flipud", "fliplr", "roll", "rot90", "atleast_1d", "atleast_2d",
    "atleast_3d", "append", "resize", "pad",
    # indexing / search / sort
    "where", "take", "take_along_axis", "choose", "compress", "extract",
    "searchsorted", "argsort", "sort", "lexsort", "partition", "argpartition",
    "nonzero", "argwhere", "flatnonzero", "unravel_index", "ravel_multi_index",
    "diag_indices", "tril_indices", "triu_indices", "indices",
    # sets / statistics
    "unique", "intersect1d", "union1d", "setdiff1d", "setxor1d", "in1d", "isin",
    "bincount", "histogram", "histogram2d", "digitize", "corrcoef", "cov",
    # misc
    "einsum", "diff", "ediff1d", "gradient", "interp", "convolve", "correlate",
    "polyval", "polyfit", "meshgrid", "broadcast_arrays", "array_split", "split",
    "hsplit", "vsplit", "dsplit", "delete", "insert", "trim_zeros", "flat",
    "may_share_memory", "shares_memory", "result_type", "promote_types",
    "can_cast", "iscomplexobj", "isrealobj", "isscalar", "ndim", "shape", "size",
    # window functions (reference: _npi_blackman/_npi_hamming/_npi_hanning)
    "blackman", "hamming", "hanning", "bartlett", "kaiser",
    "diag_indices_from",
]

# Names of the reference's table that the port does not compute, each with
# the reason; every one raises MXNetError naming it.
NOT_PORTED = {
    "result_type": "the reference's call raises TypeError (a dtype is "
                   "not an array)",
    "promote_types": "the reference's call raises TypeError (a dtype is "
                     "not an array)",
}

_g = globals()
for _name in _ELEMWISE_AND_FRIENDS:
    if _name in _g:          # hand-written below or above: keep it
        continue
    if _name in NOT_PORTED:
        _g[_name] = _not_ported(_name, NOT_PORTED[_name])
    elif hasattr(_tnp, _name):
        _g[_name] = _make(_name, getattr(_tnp, _name))

# deprecated numpy spellings the reference still registers
_g["product"] = _g["prod"]
_g["sometrue"] = _g["any"]
# array-API shift spellings
_g["bitwise_left_shift"] = _g["left_shift"]
_g["bitwise_right_shift"] = _g["right_shift"]

del _g, _name


def argmax(a, axis=None, out=None):  # noqa: ARG001
    return _arg_reduce("argmax", a, axis)


def argmin(a, axis=None, out=None):  # noqa: ARG001
    return _arg_reduce("argmin", a, axis)


def nanargmax(a, axis=None, out=None):  # noqa: ARG001
    return _arg_reduce("nanargmax", a, axis)


def nanargmin(a, axis=None, out=None):  # noqa: ARG001
    return _arg_reduce("nanargmin", a, axis)


def astype(a, dtype):
    return a.astype(dtype)


def copy(a):
    return a.copy()


def expand_dims(a, axis):  # hand version: axis required positional
    return apply_op_flat("expand_dims", lambda x: _tnp.expand_dims(x, axis),
                         (a,))


def may_share_memory(a, b):  # noqa: ARG001 - arrays never alias (ndarray.py)
    return False


def shares_memory(a, b):  # noqa: ARG001
    return False


def fill_diagonal(a, val, wrap=False):
    """In-place diagonal fill: rebinds `a` (numpy semantics: returns
    None). `val` may be a scalar or an array (cycled)."""
    def f(x, v=val):
        # numpy's flat stride: a.flat[:end:step] = val
        if x.ndim == 2:
            step = x.shape[1] + 1
            end = x.numel() if wrap else x.shape[1] * x.shape[1]
        else:
            step = 1 + int(_onp.cumprod(x.shape[:-1]).sum())
            end = x.numel()
        y = x.clone()
        idx = _torch.arange(0, end, step, device=y.device)
        idx = idx[idx < y.numel()]
        vals = _tnp._arr(v, y.device).to(y.dtype).reshape(-1)
        vals = vals.repeat(-(-idx.numel() // vals.numel()))[:idx.numel()]
        y.view(-1)[idx] = vals
        return y

    if isinstance(val, NDArray):
        out = apply_op_flat("fill_diagonal", lambda x, v: f(x, v), (a, val))
    else:
        out = apply_op_flat("fill_diagonal", f, (a,))
    a._adopt(out)


def put_along_axis(arr, indices, values, axis):
    """In-place scatter along `axis`: rebinds `arr` (numpy semantics:
    returns None)."""
    def f(x, idx, v=values):
        v = _tnp._arr(v, x.device).to(x.dtype)
        idx = idx.long()
        return x.scatter(axis, idx, _torch.broadcast_to(v, idx.shape)
                         .contiguous())

    args = [arr, indices]
    if isinstance(values, NDArray):
        args.append(values)
        out = apply_op_flat("put_along_axis", lambda x, i, v: f(x, i, v),
                            tuple(args))
    else:
        out = apply_op_flat("put_along_axis", f, tuple(args))
    arr._adopt(out)


def bfloat16(x=None):
    return _torch.bfloat16 if x is None else NDArray(x, dtype="bfloat16")


from . import linalg, random  # noqa: E402,F401
