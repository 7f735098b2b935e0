"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each module holds the ported TPU kernels of the reference module of its
name (`fused_block` two: K3 and K6), forward and backward where the
reference has both: the wrapper launches the kernel for CUDA tensors and
runs the plain version for CPU tensors, counts its launches in
``launches`` (backward ones in ``bwd_launches``; K6's in ``gd_launches``
and ``gd_bwd_launches``), and builds the kernel
from ``csrc/`` at first use (see :mod:`._build`). `_philox` holds the
plain version of the dropout kernels' random stream. `quantized` holds
the int8 path's two kernels (Q1, Q2), which replace no Pallas kernel:
PyTorch has no int8 convolution or integer max pooling on CUDA.

As in the reference, the package's ``flash_attention`` and ``mha_flash``
are the functions; the module of that name (its counters, its plain
versions) is ``importlib.import_module(__name__ + ".flash_attention")``.
"""
from . import dropout, fused_block, layer_norm
from .flash_attention import flash_attention, mha_flash

__all__ = ["dropout", "flash_attention", "mha_flash", "fused_block",
           "layer_norm"]
