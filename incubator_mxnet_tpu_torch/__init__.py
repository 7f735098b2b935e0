"""PyTorch/CUDA port of the MXNet-parity framework, for NVIDIA Hopper.

A second package beside the JAX reference (`incubator_mxnet_tpu`), with
the same public names and semantics over torch tensors. Every kernel the
reference wrote in Pallas for the TPU is written here by hand in CUDA C++
for ``sm_90a`` (``csrc/``, built with ``nvcc`` at first use, bound with
ctypes; see `ops/_build.py`). Each kernel's wrapper launches it for CUDA
tensors and runs a plain PyTorch version of the same arithmetic for CPU
tensors.

Ported so far: GPT-2 KV-cache generation (the serving slice) through the
flash-attention-forward and LayerNorm-forward kernels; BERT MLM training
(the training slice) through those and the flash-attention-backward,
LayerNorm-backward, fused residual + dropout + LayerNorm and dropout
kernels, with `gluon.Trainer` and Adam; `npx.gelu_dropout` through the
fused exact-erf GELU + dropout kernel, forward and backward. With it
every Pallas kernel of the reference has its CUDA counterpart. `amp`
trains those models in bfloat16 mixed precision through the same
kernels. `parallel.DataParallel` is the reference's compiled training
step on one card: forward, backward and the optimizer replayed as one
CUDA graph a step, its dropout keys folded on the card. Entry
points run on ``cuda:0`` unless the caller passes ``device="cpu"``. This
package imports neither jax nor the reference package.
"""
from . import (amp, base, device, gluon, models, ops, optimizer, parallel,
               random)
from . import numpy_extension as npx
from .base import MXNetError
from .device import cpu, default_device, gpu, num_gpus

__all__ = ["amp", "base", "device", "gluon", "models", "ops", "optimizer",
           "parallel", "random",
           "npx", "MXNetError",
           "cpu", "gpu", "num_gpus", "default_device"]
