"""Base utilities (port of `incubator_mxnet_tpu/base.py`): the error
types, dtype handling and the op registry.

The reference runs with JAX's x64 mode off, so an array made from host
data never holds a 64-bit type: float64 becomes float32, int64 int32,
uint64 uint32 and complex128 complex64. :func:`canonical_dtype` is that
rule over torch dtypes; the NDArray layer applies it to every array it
makes and to every op's output.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = [
    "MXNetError",
    "NotSupportedForSparseNDArray",
    "np_dtype",
    "dtype_name",
    "torch_dtype",
    "canonical_dtype",
    "string_types",
    "numeric_types",
    "integer_types",
    "_OP_REGISTRY",
    "register_op_meta",
    "list_ops",
]


class MXNetError(RuntimeError):
    """Framework-level error (parity with mxnet.base.MXNetError)."""


class NotSupportedForSparseNDArray(MXNetError):
    def __init__(self, function, alias, *args):  # noqa: ARG002
        super().__init__(f"Function {function.__name__} is not supported for "
                         f"sparse NDArray")


string_types = (str,)
numeric_types = (float, int, onp.generic)
integer_types = (int, onp.integer)

_TORCH_TO_NP = {
    torch.float32: onp.dtype("float32"), torch.float64: onp.dtype("float64"),
    torch.float16: onp.dtype("float16"), torch.uint8: onp.dtype("uint8"),
    torch.int8: onp.dtype("int8"), torch.int16: onp.dtype("int16"),
    torch.int32: onp.dtype("int32"), torch.int64: onp.dtype("int64"),
    torch.bool: onp.dtype("bool"), torch.complex64: onp.dtype("complex64"),
    torch.complex128: onp.dtype("complex128"),
}
for _name in ("uint16", "uint32", "uint64"):
    if hasattr(torch, _name):
        _TORCH_TO_NP[getattr(torch, _name)] = onp.dtype(_name)
_NP_TO_TORCH = {v: k for k, v in _TORCH_TO_NP.items()}

# x64 off: the 64-bit types an array never holds, and what it holds instead
_X64_OFF = {torch.float64: torch.float32, torch.int64: torch.int32,
            torch.complex128: torch.complex64}
if hasattr(torch, "uint64"):
    _X64_OFF[torch.uint64] = torch.uint32


def np_dtype(dtype):
    """Normalize a dtype-like object (a name, a numpy dtype or type, a torch
    dtype, ``float``/``int``/``bool``) to a numpy dtype; "bfloat16" (which
    numpy has no type for) to ``torch.bfloat16``."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype if dtype == torch.bfloat16 else _TORCH_TO_NP[dtype]
    if isinstance(dtype, str):
        return torch.bfloat16 if dtype == "bfloat16" else onp.dtype(dtype)
    if dtype is float:
        return onp.dtype("float32")
    if dtype is int:
        return onp.dtype("int32")
    if dtype is bool:
        return onp.dtype("bool")
    return onp.dtype(dtype)


def torch_dtype(dtype):
    """The torch dtype of a dtype-like object (see :func:`np_dtype`)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    d = np_dtype(dtype)
    return d if isinstance(d, torch.dtype) else _NP_TO_TORCH[d]


def canonical_dtype(dtype):
    """The dtype an array holds for ``dtype`` with x64 off (a torch dtype)."""
    d = torch_dtype(dtype)
    return _X64_OFF.get(d, d)


def dtype_name(dtype) -> str:
    if dtype is None:
        return "None"
    if dtype == torch.bfloat16 or dtype == "bfloat16":
        return "bfloat16"
    return onp.dtype(np_dtype(dtype)).name


# ---------------------------------------------------------------------------
# Op registry: (namespace.name -> fn), so `list_ops` can introspect, as the
# reference's NNVM registry does.
# ---------------------------------------------------------------------------
_OP_REGISTRY: dict = {}


def register_op_meta(name: str, namespace: str, fn) -> None:
    _OP_REGISTRY[f"{namespace}.{name}"] = fn


def list_ops(namespace: str | None = None):
    if namespace is None:
        return sorted(_OP_REGISTRY)
    prefix = namespace + "."
    return sorted(k[len(prefix):] for k in _OP_REGISTRY if k.startswith(prefix))
