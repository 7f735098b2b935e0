"""Legacy `mx.nd` namespace (port of `incubator_mxnet_tpu/ndarray/`).

The modern `np`/`npx` namespaces are the primary API (as in MXNet 2.0);
this module re-exports the NDArray type plus legacy-named ops, the
functional optimizer updates (`optim_ops`: ``nd.sgd_update``,
``nd.adam_update``, ...) and the legacy op long tail (`legacy_ops`).
Unknown attributes forward to the numpy namespace (``nd.linalg`` is
``np.linalg``, as in the reference), and the legacy CamelCase names to
the `npx` ops. ``nd.contrib`` forwards the contrib spellings; ``save``
and ``load`` also speak the reference's binary container
(`legacy_io`). Sparse storage (`sparse`) and the npx families of
`ROADMAP.md` §1 item 11b raise :class:`MXNetError` naming it.
"""
from __future__ import annotations

import os

import numpy as onp
import torch

from ..base import MXNetError, canonical_dtype
from . import contrib, legacy_io, legacy_ops, optim_ops  # noqa: F401
from .legacy_ops import *  # noqa: F401,F403  (the legacy op long tail)
from .ndarray import (NDArray, apply_op, apply_op_flat, array, from_jax,  # noqa: F401
                      unwrap_arrays, waitall)
from .optim_ops import *  # noqa: F401,F403  (functional optimizer updates)

# legacy CamelCase op names -> the ported npx equivalents
_LEGACY_TO_NPX = {
    "FullyConnected": "fully_connected",
    "LayerNorm": "layer_norm",
    "Activation": "activation",
    "Dropout": "dropout",
    "Embedding": "embedding",
    "LeakyReLU": "leaky_relu",
    "softmax": "softmax",
    "log_softmax": "log_softmax",
    "batch_dot": "batch_dot",
    "softsign": "softsign",
    "Convolution": "convolution",
    "Deconvolution": "deconvolution",
    "BatchNorm": "batch_norm",
    "InstanceNorm": "instance_norm",
    "GroupNorm": "group_norm",
    "Pooling": "pooling",
    "AdaptiveAvgPooling2D": "adaptive_avg_pooling2d",
    "Pad": "pad",
    "pad": "pad",
    "SoftmaxOutput": "softmax",
    "SequenceMask": "sequence_mask",
    "SequenceLast": "sequence_last",
    "SequenceReverse": "sequence_reverse",
    "one_hot": "one_hot",
    "pick": "pick",
    "topk": "topk",
    "gather_nd": "gather_nd",
    "scatter_nd": "scatter_nd",
    "L2Normalization": "l2_normalization",
    "Cast": "cast",
    "cast": "cast",
    "slice_like": "slice_like",
    "broadcast_like": "broadcast_like",
    "sequence_mask": "sequence_mask",
    "erfinv": "erfinv",
    "gamma": "gamma",          # the Γ function, not a draw
    "gammaln": "gammaln",
    "digamma": "digamma",
    "slice": "slice",
    "SliceChannel": "slice_channel",
    "slice_channel": "slice_channel",
    "ElementWiseSum": "add_n",
    "boolean_mask": "boolean_mask",
    "RNN": "rnn",
}

# the reference's other legacy npx names: ROADMAP.md §1 item 11b's
_LEGACY_NPX_QUEUED = (
    "BilinearSampler", "GridGenerator", "SpatialTransformer",
    "ROIPooling", "Correlation", "ROIAlign", "box_nms", "box_iou", "CTCLoss",
    "ctc_loss", "BilinearResize2D", "Custom", "sparse",
)

# legacy names resolving to np-namespace ops under a different name
_LEGACY_TO_NP = {
    "Reshape": "reshape",
    "flip": "flip",
    "sum_axis": "sum",
    "max_axis": "max",
    "min_axis": "min",
    "broadcast_add": "add",
    "broadcast_sub": "subtract",
    "broadcast_mul": "multiply",
    "broadcast_div": "true_divide",
    "broadcast_maximum": "maximum",
    "broadcast_minimum": "minimum",
    "elemwise_add": "add",
    "elemwise_sub": "subtract",
    "elemwise_mul": "multiply",
    "elemwise_div": "true_divide",
    "broadcast_plus": "add",
    "broadcast_minus": "subtract",
    "broadcast_mod": "mod",
    "broadcast_power": "power",
    "broadcast_equal": "equal",
    "broadcast_not_equal": "not_equal",
    "broadcast_greater": "greater",
    "broadcast_greater_equal": "greater_equal",
    "broadcast_lesser": "less",
    "broadcast_lesser_equal": "less_equal",
    "broadcast_logical_and": "logical_and",
    "broadcast_logical_or": "logical_or",
    "broadcast_logical_xor": "logical_xor",
    "broadcast_hypot": "hypot",
}


def add_n(*args):
    """Sum of all inputs in one funnel call: `npx.add_n` (reference:
    `src/operator/tensor/elemwise_sum.cc`)."""
    from ..numpy_extension import add_n as _add_n

    return _add_n(*args)


def concat(*args, dim=None, axis=None, **kwargs):  # noqa: ARG001
    """Legacy varargs Concat (reference `mx.nd.Concat(*arrays, dim=)`);
    numpy-style axis= accepted as an alias. Default dim=1 as the
    reference's ConcatParam."""
    from .. import numpy as _np

    arrays = args[0] if len(args) == 1 and isinstance(args[0],
                                                      (list, tuple)) else args
    ax = dim if dim is not None else (axis if axis is not None else 1)
    return _np.concatenate(list(arrays), axis=ax)


Concat = concat


def stack(*args, axis=0, **kwargs):  # noqa: ARG001
    """Legacy varargs stack (reference `mx.nd.stack(*arrays, axis=)`)."""
    from .. import numpy as _np

    arrays = args[0] if len(args) == 1 and isinstance(args[0],
                                                      (list, tuple)) else args
    return _np.stack(list(arrays), axis=axis)


def SwapAxis(data, dim1=None, dim2=None, axis1=None, axis2=None,
             **kwargs):  # noqa: N802, ARG001
    """Legacy SwapAxis with dim1/dim2 kwargs; numpy-style axis1/axis2
    accepted."""
    from .. import numpy as _np

    a1 = dim1 if dim1 is not None else (axis1 if axis1 is not None else 0)
    a2 = dim2 if dim2 is not None else (axis2 if axis2 is not None else 0)
    return _np.swapaxes(data, a1, a2)


def swapaxes(data, axis1=None, axis2=None, dim1=None, dim2=None, **kwargs):
    return SwapAxis(data, dim1=dim1, dim2=dim2, axis1=axis1, axis2=axis2,
                    **kwargs)


def take(a, indices, axis=0, mode="clip", **kwargs):  # noqa: ARG001
    """Legacy nd.take: axis defaults to 0 (row gather), unlike numpy's
    flattening default."""
    arr = a if isinstance(a, NDArray) else NDArray(a)
    return arr.take(indices if isinstance(indices, NDArray)
                    else NDArray(indices, device=arr._data.device),
                    axis=axis, mode=mode)


def norm(data, ord=2, axis=None, keepdims=False, **kwargs):  # noqa: A002, ARG001
    """Legacy nd.norm: the ENTRYWISE L-p reduction (never the
    matrix/operator norms)."""
    from .. import numpy as _np

    if ord == 1:
        return _np.sum(_np.abs(data), axis=axis, keepdims=keepdims)
    if ord == 2:
        return _np.sqrt(_np.sum(_np.square(data), axis=axis,
                                keepdims=keepdims))
    raise ValueError(f"nd.norm supports ord 1 or 2, got {ord!r}")


def sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """Category indices drawn from probability rows ``data`` ((k,) or
    (batch, k)): ``shape`` draws a row (one without it), the draw axes
    last; with ``get_prob`` also each draw's log-probability. One key
    from the framework's key source (``torch.multinomial`` on the
    array's device)."""
    from ..numpy.random import _gen
    from ..numpy.random import _shape as _size

    pv = data._data if isinstance(data, NDArray) else array(data)._data
    n = _size(shape)
    count = int(onp.prod(n)) if n else 1
    rows = pv.float().reshape(-1, pv.shape[-1])
    draws = torch.multinomial(rows, count, replacement=True,
                              generator=_gen(pv.device))
    out_shape = tuple(pv.shape[:-1]) + n
    picked = torch.log(rows.clamp_min(1e-38)).gather(1, draws)
    out = NDArray(draws.reshape(out_shape).to(canonical_dtype(dtype)))
    if get_prob:
        return out, NDArray(picked.reshape(out_shape))
    return out


def Flatten(data):  # noqa: N802
    """Collapse all non-batch dims: output is 2-D (batch, -1)."""
    return data.reshape((data.shape[0], -1))


flatten = Flatten


class _NotPortedAttribute(MXNetError, AttributeError):
    """An MXNetError that ``hasattr`` reads as a missing attribute."""


def __getattr__(name):
    if name in _LEGACY_TO_NPX:
        from .. import numpy_extension as npx

        return getattr(npx, _LEGACY_TO_NPX[name])
    if name in _LEGACY_TO_NP:
        from .. import numpy as _np

        return getattr(_np, _LEGACY_TO_NP[name])
    if name in _LEGACY_NPX_QUEUED:
        raise _NotPortedAttribute(f"mx.nd.{name} is not ported yet "
                                  f"(ROADMAP.md §1 item 11b)")
    from .. import numpy as _np

    if hasattr(_np, name):
        return getattr(_np, name)
    raise AttributeError(f"module 'nd' has no attribute {name!r}")


def __dir__():
    from .. import numpy as _np

    return sorted(set(globals()) | set(_LEGACY_TO_NPX) | set(_LEGACY_TO_NP)
                  | {n for n in dir(_np) if not n.startswith("_")})


def save(fname, data, format="npz"):  # noqa: A002
    """Save NDArrays (a list, or a dict by name) to a numpy ``.npz``
    container, or with ``format="legacy"`` to the reference's binary
    container (`legacy_io`); :func:`load` tells them apart."""
    if format == "legacy":
        return legacy_io.save(fname, data)
    if format != "npz":
        raise MXNetError(f"nd.save(format={format!r}): npz or legacy")
    if isinstance(data, NDArray):
        data = [data]
    payload: dict = {}
    if isinstance(data, (list, tuple)):
        for i, d in enumerate(data):
            payload[f"arr:{i}"] = d.asnumpy()
    elif isinstance(data, dict):
        for k, v in data.items():
            payload[f"named:{k}"] = v.asnumpy()
    else:
        raise TypeError("save expects NDArray, list of NDArray, or dict")
    onp.savez(fname, **payload)
    if not fname.endswith(".npz") and os.path.exists(fname + ".npz"):
        os.replace(fname + ".npz", fname)


def load(fname):
    """Load what :func:`save` wrote, in either container: a list, or a
    dict by name."""
    if legacy_io.is_legacy_file(fname):
        return legacy_io.load(fname)
    with onp.load(fname, allow_pickle=False) as z:
        entries = {k: z[k] for k in z.keys()}
    keys = list(entries)
    if keys and keys[0].startswith("named:"):
        return {k[len("named:"):]: array(entries[k]) for k in keys}
    if keys and keys[0].startswith("arr:"):
        return [array(entries[k])
                for k in sorted(keys, key=lambda s: int(s.split(":")[1]))]
    return {k: array(v) for k, v in entries.items()}


__all__ = ["NDArray", "apply_op", "apply_op_flat", "array", "waitall",
           "add_n", "concat", "Concat", "stack", "swapaxes", "SwapAxis",
           "take", "norm", "Flatten", "flatten", "save", "load",
           "sample_multinomial", "optim_ops", "legacy_ops", "legacy_io",
           "contrib"] + list(optim_ops.__all__) + list(legacy_ops.__all__)
