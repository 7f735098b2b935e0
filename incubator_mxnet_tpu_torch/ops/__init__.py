"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each module holds one ported TPU kernel: the wrapper launches the kernel
for CUDA tensors and runs the plain version for CPU tensors, counts its
launches in ``launches``, and builds the kernel from ``csrc/`` at first
use (see :mod:`._build`).
"""
from . import flash_attention, layer_norm

__all__ = ["flash_attention", "layer_norm"]
