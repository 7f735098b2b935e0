"""PyTorch/CUDA port of the MXNet-parity framework, for NVIDIA Hopper.

A second package beside the JAX reference (`incubator_mxnet_tpu`), with
the same public names and semantics over torch tensors. Every kernel the
reference wrote in Pallas for the TPU is written here by hand in CUDA C++
for ``sm_90a`` (``csrc/``, built with ``nvcc`` at first use, bound with
ctypes; see `ops/_build.py`). Each kernel's wrapper launches it for CUDA
tensors and runs a plain PyTorch version of the same arithmetic for CPU
tensors.

Ported so far (the serving slice): GPT-2 KV-cache generation through the
flash-attention-forward and LayerNorm-forward kernels. Entry points run
on ``cuda:0`` unless the caller passes ``device="cpu"``. This package
imports neither jax nor the reference package.
"""
from . import base, device, gluon, models, ops
from . import numpy_extension as npx
from .base import MXNetError
from .device import cpu, default_device, gpu, num_gpus

__all__ = ["base", "device", "gluon", "models", "ops", "npx", "MXNetError",
           "cpu", "gpu", "num_gpus", "default_device"]
