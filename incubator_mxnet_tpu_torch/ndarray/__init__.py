"""Legacy `mx.nd` namespace (port of `incubator_mxnet_tpu/ndarray/`).

The modern `np`/`npx` namespaces are the primary API (as in MXNet 2.0);
this module re-exports the NDArray type plus legacy-named ops. Unknown
attributes forward to the numpy namespace, and the legacy CamelCase
names to the `npx` ops that are ported. The reference's legacy op long
tail (`legacy_ops`), functional optimizer updates (`optim_ops`), sparse
storage (`sparse`) and `contrib` are not ported yet (`ROADMAP.md`).
"""
from __future__ import annotations

import os

import numpy as onp

from ..base import MXNetError
from .ndarray import (NDArray, apply_op, apply_op_flat, array, from_jax,  # noqa: F401
                      unwrap_arrays, waitall)

# legacy CamelCase op names -> the ported npx equivalents
_LEGACY_TO_NPX = {
    "FullyConnected": "fully_connected",
    "LayerNorm": "layer_norm",
    "Activation": "activation",
    "Dropout": "dropout",
    "Embedding": "embedding",
}

# the reference's other legacy npx names: each waits for its npx op
_LEGACY_NPX_QUEUED = (
    "Convolution", "Deconvolution", "BatchNorm", "InstanceNorm", "GroupNorm",
    "LeakyReLU", "Pooling", "SoftmaxOutput", "softmax", "log_softmax",
    "SequenceMask", "SequenceLast", "SequenceReverse", "RNN", "one_hot",
    "pick", "topk", "batch_dot", "gather_nd", "scatter_nd",
    "L2Normalization", "Cast", "cast", "BilinearSampler", "GridGenerator",
    "SpatialTransformer", "ROIPooling", "Correlation", "ROIAlign", "box_nms",
    "box_iou", "slice_like", "broadcast_like", "sequence_mask", "erfinv",
    "gamma", "gammaln", "digamma", "slice", "SliceChannel", "slice_channel",
    "softsign", "Pad", "pad", "ElementWiseSum", "CTCLoss", "ctc_loss",
    "boolean_mask", "AdaptiveAvgPooling2D", "BilinearResize2D", "Custom",
    "contrib", "sparse",
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
    """Sum of all inputs in ONE funnel call (reference:
    `src/operator/tensor/elemwise_sum.cc`)."""
    arrays = unwrap_arrays(args)

    def f(*vals):
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    return apply_op_flat("add_n", f, tuple(arrays))


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


def sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):  # noqa: ARG001
    raise MXNetError("nd.sample_multinomial is not ported yet (ROADMAP.md "
                     "§1 item 4: the legacy op long tail)")


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
                                  f"(ROADMAP.md §1 item 4)")
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
    container. The reference's ``format="legacy"`` binary container is
    not ported."""
    if format != "npz":
        raise MXNetError(f"nd.save(format={format!r}): only npz is ported")
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
    """Load what :func:`save` wrote: a list, or a dict by name."""
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
           "take", "norm", "Flatten", "flatten", "save", "load"]
