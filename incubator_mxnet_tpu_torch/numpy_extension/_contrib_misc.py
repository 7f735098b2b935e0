"""``npx`` ops of the reference's contrib corpus (port of
`incubator_mxnet_tpu/numpy_extension/_contrib_misc.py`): the vision
path's `adaptive_avg_pooling2d` :305, `batch_norm_with_relu` :360,
`softsign` :384, `pad` :389, and `quadratic` :37, `index_copy` :45,
`index_array` :55, `gradientmultiplier` :72, `dynamic_reshape` :87,
`round_ste`/`sign_ste` :164-188, `all_finite`/`multi_all_finite`
:190-212, `norm` :408, `slice` :434, `slice_channel` :448, `add_n` :464.
Plain torch: the reference composes them in jnp, with no kernel. The
straight-through and gradient-scaling ops are `torch.autograd.Function`s
with the reference's backward (its ``jax.custom_vjp``)."""
from __future__ import annotations

import builtins

import torch
import torch.nn.functional as F

from ..ndarray.ndarray import NDArray, apply_op, apply_op_flat, unwrap_arrays

__all__ = ["adaptive_avg_pooling2d", "batch_norm_with_relu", "softsign",
           "pad", "quadratic", "index_copy", "index_array",
           "gradientmultiplier", "dynamic_reshape", "round_ste", "sign_ste",
           "all_finite", "multi_all_finite", "norm", "slice",
           "slice_channel", "add_n"]


def adaptive_avg_pooling2d(data, output_size=1):
    """NCHW adaptive average pooling: bin i covers
    [floor(i·H/out), ceil((i+1)·H/out)), the reference's binning (and
    ``F.adaptive_avg_pool2d``'s)."""
    from . import _op

    if isinstance(output_size, int):
        oh = ow = int(output_size)
    else:
        oh, ow = (int(v) for v in output_size)
    return _op("adaptive_avg_pooling2d",
               lambda x: F.adaptive_avg_pool2d(x, (oh, ow)), data)


def batch_norm_with_relu(x, gamma, beta, running_mean, running_var,
                         **kwargs):
    """``relu(batch_norm(...))``, the running statistics updated as
    `npx.batch_norm` updates them."""
    from . import batch_norm, relu

    return relu(batch_norm(x, gamma, beta, running_mean, running_var,
                           **kwargs))


def softsign(data):
    """``x / (1 + |x|)``."""
    from . import _op

    return _op("softsign", lambda x: x / (1 + x.abs()), data)


def _pad_index(n, lo, hi, mode, device):
    """Source indices of an axis of length ``n`` padded by (lo, hi):
    "edge" repeats the border, "reflect" mirrors about it (numpy's
    modes)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def pad(data, mode="constant", pad_width=None, constant_value=0.0):
    """Pad by ``pad_width``, a flat 2·ndim tuple (before, after a axis),
    in mode "constant" (``constant_value``), "edge" or "reflect"."""
    from . import _op

    pw = tuple(int(v) for v in pad_width)
    pairs = tuple((pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2))
    if mode not in ("constant", "edge", "reflect"):
        raise ValueError(f"pad: unknown mode {mode!r}")

    def fn(x):
        if mode == "constant":
            flat = [q for lo_hi in reversed(pairs) for q in lo_hi]
            return F.pad(x, flat, value=constant_value)
        for ax, (lo, hi) in enumerate(pairs):
            if lo or hi:
                x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                                  x.device))
        return x

    return _op("pad", fn, data)


def quadratic(data, a=0.0, b=0.0, c=0.0):
    """``a·x² + b·x + c``."""
    from . import _op

    return _op("quadratic", lambda x: a * x * x + b * x + c, data)


def index_copy(old_tensor, index_vector, new_tensor):
    """``old_tensor`` with its rows at ``index_vector`` replaced by
    ``new_tensor``'s (differentiable in both)."""
    from . import _op

    return _op("index_copy",
               lambda old, idx, new: old.index_copy(0, idx.to(torch.int64),
                                                    new.to(old.dtype)),
               old_tensor, index_vector, new_tensor)


def index_array(data, axes=None):
    """Each position's coordinates: shape ``data.shape + (len(axes),)``,
    int32 (the reference's int64 with x64 off). Static: it reads no value
    of ``data``."""
    from . import _op

    axes_t = None if axes is None else tuple(int(a) for a in axes)

    def fn(x):
        sel = axes_t if axes_t is not None else tuple(range(x.dim()))
        grids = torch.meshgrid(*[torch.arange(n, device=x.device)
                                 for n in x.shape], indexing="ij")
        return torch.stack([grids[a] for a in sel], dim=-1).to(torch.int32)

    return _op("index_array", fn, data)


class _Scaled(torch.autograd.Function):
    """Identity forward, the incoming gradient times ``scale`` back."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _StraightThrough(torch.autograd.Function):
    """``fn(x)`` forward, the incoming gradient unchanged back."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gradientmultiplier(data, scalar=1.0):
    """Identity forward, gradient scaled by ``scalar`` (a gradient
    reversal layer at -1)."""
    from . import _op

    s = float(scalar)
    return _op("gradientmultiplier", lambda x: _Scaled.apply(x, s), data)


def dynamic_reshape(data, shape_like):
    """Reshape ``data`` to the values held in ``shape_like``: read on the
    host (a synchronisation; inside a CUDA-graph capture it raises
    :class:`MXNetError`)."""
    from . import _no_capture, _op

    _no_capture("dynamic_reshape")
    t = shape_like._data if isinstance(shape_like, NDArray) else shape_like
    target = tuple(int(v) for v in torch.as_tensor(t).detach().cpu()
                   .to(torch.int64).tolist())
    return _op("dynamic_reshape", lambda x: x.reshape(target), data)


def round_ste(data):
    """``round(x)`` (half to even) with a straight-through gradient."""
    from . import _op

    return _op("round_ste",
               lambda x: _StraightThrough.apply(x, torch.round), data)


def sign_ste(data):
    """``sign(x)`` with a straight-through gradient."""
    from . import _op

    return _op("sign_ste", lambda x: _StraightThrough.apply(x, torch.sign),
               data)


def all_finite(data, init_output=True):  # noqa: ARG001
    """``[1.0]`` if every element is finite, else ``[0.0]``: a device
    array, read on the host by nobody here."""
    from . import _op

    return _op("all_finite",
               lambda x: torch.isfinite(x).all().float().reshape(1), data)


def multi_all_finite(*arrays, num_arrays=None, init_output=True):  # noqa: ARG001
    """:func:`all_finite` over every array, one device array."""
    arrs = unwrap_arrays(arrays)

    def fn(xs):
        ok = torch.ones((), dtype=torch.bool, device=xs[0].device)
        for x in xs:
            ok = ok & torch.isfinite(x).all()
        return ok.float().reshape(1)

    if any(isinstance(a, NDArray) for a in arrs):
        return apply_op_flat("multi_all_finite", fn, (arrs,))
    return fn(arrs)


def norm(data, ord=2, axis=None, keepdims=False, out=None):  # noqa: A002
    """The entrywise L1 or L2 norm over ``axis``; under
    ``MXNET_SAFE_ACCUMULATION=1`` a bf16 or f16 input reduces in f32 and
    the result takes the input's dtype back."""
    from . import _safe_accumulation

    if ord not in (1, 2):
        raise ValueError(f"npx.norm supports ord 1 or 2, got {ord!r}")
    ax = axis if axis is None or isinstance(axis, int) \
        else tuple(int(a) for a in axis)
    safe = _safe_accumulation()

    def fn(x):
        in_dt = x.dtype
        if safe and in_dt in (torch.float16, torch.bfloat16):
            x = x.float()
        dims = tuple(range(x.dim())) if ax is None else ax
        terms = x.abs() if ord == 1 else x * x
        r = terms.sum(dim=dims, keepdim=keepdims)
        r = r if ord == 1 else torch.sqrt(r)
        return r.to(in_dt) if safe else r

    if isinstance(data, NDArray):
        return apply_op("norm", fn, (data,), out=out)
    return fn(data)


def _slice_axis(x, ax, sl):
    """``x[..., sl, ...]`` on axis ``ax``; a negative step (which torch's
    slicing does not take) gathers the same positions."""
    if sl.step is None or sl.step > 0:
        return x[(builtins.slice(None),) * ax + (sl,)]
    idx = torch.arange(*sl.indices(x.shape[ax]), device=x.device)
    return x.index_select(ax, idx)


def slice(data, begin, end, step=None):  # noqa: A001
    """``data[begin[0]:end[0]:step[0], ...]``; None in ``begin`` or
    ``end`` is the edge, a negative step walks backwards."""
    from . import _op

    begin, end = tuple(begin), tuple(end)
    step = tuple(step) if step is not None else (None,) * len(begin)
    keys = tuple(builtins.slice(b, e, s) for b, e, s in zip(begin, end, step))

    def fn(x):
        for ax, k in enumerate(keys):
            x = _slice_axis(x, ax, k)
        return x

    return _op("slice", fn, data)


def slice_channel(data, num_outputs, axis=1, squeeze_axis=False):
    """``data`` split into ``num_outputs`` equal parts along ``axis`` (a
    list), the axis squeezed away with ``squeeze_axis``."""
    from . import _op

    n = int(num_outputs)

    def fn(x):
        if x.shape[axis] % n:
            raise ValueError(f"slice_channel: axis {axis} of size "
                             f"{x.shape[axis]} does not split into {n}")
        parts = x.split(x.shape[axis] // n, dim=axis)
        if squeeze_axis:
            parts = [p.squeeze(axis) for p in parts]
        return tuple(parts)

    return list(_op("slice_channel", fn, data))


def add_n(*args):
    """The sum of every input, in one funnel call."""
    arrs = unwrap_arrays(args)

    def fn(xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    if any(isinstance(a, NDArray) for a in arrs):
        return apply_op_flat("add_n", fn, (arrs,))
    return fn(arrs)
