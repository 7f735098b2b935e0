"""Contributed extensions (port of `incubator_mxnet_tpu/contrib/`): int8
post-training quantization (`quantization`: calibration, the quantized
Dense/Conv2D and residual blocks on the Q1/Q2 kernels, `quantize_net`).
`text` and `tensorboard` are ROADMAP.md §1 item 11b's."""
from . import quantization

__all__ = ["quantization"]
