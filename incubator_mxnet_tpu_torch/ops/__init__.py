"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each module holds one ported TPU kernel, forward and backward where the
reference has both: the wrapper launches the kernel for CUDA tensors and
runs the plain version for CPU tensors, counts its launches in
``launches`` (backward ones in ``bwd_launches``), and builds the kernel
from ``csrc/`` at first use (see :mod:`._build`). `_philox` holds the
plain version of the dropout kernels' random stream.
"""
from . import dropout, flash_attention, fused_block, layer_norm

__all__ = ["dropout", "flash_attention", "fused_block", "layer_norm"]
