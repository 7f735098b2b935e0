"""Device helpers: `mx.gpu(i)` / `mx.cpu()` as `torch.device` values.

The port computes on the card. `default_device()` is `cuda:0` and has no
CPU fallback: code that wants the CPU (the tests) asks for it by passing
`device="cpu"`, and code that asks for nothing on a machine without a
card gets an error instead of a silent CPU run.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["gpu", "cpu", "num_gpus", "default_device", "resolve_device"]


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", device_id)


def cpu(device_id: int = 0) -> torch.device:  # noqa: ARG001 — MXNet signature
    return torch.device("cpu")


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_device() -> torch.device:
    """`cuda:0`; raises when no card is present."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return gpu(0)


def resolve_device(device=None) -> torch.device:
    """`None` → :func:`default_device`; anything else → `torch.device`."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(f"device {device} requested but no CUDA device is "
                         f"available")
    return device
