"""Contributed extensions (port of `incubator_mxnet_tpu/contrib/`): so far
only the symmetric int8 quantization helpers that the serving engine's
int8 KV pool uses (`quantization`)."""
from . import quantization

__all__ = ["quantization"]
