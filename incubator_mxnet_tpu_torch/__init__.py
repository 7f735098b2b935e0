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
CUDA graph a step, its dropout keys folded on the card. `serve` is the
reference's serving engine (continuous batching over a paged KV pool,
prefix reuse, chunked prefill, speculative decoding, an int8 KV pool),
its decode, verify and draft steps each replayed as one CUDA graph,
and its serving plane: `serve.Gateway` over co-resident models (priority
tiers, tenants, quotas, preemption, replicas sharing the card) and
disaggregated prefill and decode replicas whose KV pages migrate on the
card; the autoscale advisor and the elastic replica controller resize a
model's replica set on the card. `telemetry` holds its metrics, spans,
cost and latency ledgers, SLOs, the timeseries history, burn-rate
alerts, the goodput ledger, the device-memory census and the program
ledger; `fault` its chaos seams and retry policies. `NDArray` and its op
funnel, `np` (`mx.np`), `nd`, `npx` and `autograd` are the reference's
imperative front door over torch tensors, recorded on torch's autograd
graph; `npx`'s kernel-bearing ops take NDArrays to the same kernels.
Entry points run on ``cuda:0`` unless the caller asks for the CPU (``with
mx.cpu():``, or ``device="cpu"``). This package imports neither jax nor
the reference package.
"""
from . import (amp, autograd, base, contrib, device, dlpack, fault, gluon,
               models, ops, optimizer, parallel, random, serve, telemetry,
               test_utils, util)
from . import ndarray as nd
from . import numpy as np
from . import numpy_extension as npx
from .base import MXNetError
from .device import (Context, Device, cpu, current_device, default_device,
                     gpu, num_gpus)
from .ndarray import NDArray, waitall

__all__ = ["amp", "autograd", "base", "contrib", "device", "dlpack",
           "fault", "gluon", "models", "ops", "optimizer", "parallel",
           "random", "serve", "telemetry", "test_utils", "util", "nd", "np",
           "npx", "MXNetError", "NDArray", "waitall", "Device", "Context",
           "current_device", "cpu", "gpu", "num_gpus", "default_device"]

util._apply_env_config()
