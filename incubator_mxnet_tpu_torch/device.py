"""Devices (port of `incubator_mxnet_tpu/device.py`): `Device`, the
``with mx.cpu():`` scope, `mx.gpu(i)` / `mx.cpu()`.

The port computes on the card. With no scope open, :func:`current_device`
is ``gpu(0)`` (``cuda:0``), and making an array or a model there raises
:class:`MXNetError` when no card is present: nothing falls back to the
CPU. Code that wants the CPU (the tests) asks for it, with ``with
mx.cpu():`` or by passing ``device="cpu"`` (a `torch.device`, a string
or a `Device`) to an entry point, which hands it to
:func:`resolve_device`. ``gpu`` is the card, as the reference's ``gpu``
is its accelerator; ``tpu`` names the same card.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = [
    "Device",
    "Context",
    "cpu",
    "gpu",
    "tpu",
    "num_gpus",
    "num_tpus",
    "current_device",
    "default_device",
    "resolve_device",
    "memory_stats",
    "live_array_bytes",
    "gpu_memory_info",
]

_TYPES = {"cpu": "cpu", "cpu_pinned": "cpu", "cpu_shared": "cpu",
          "gpu": "gpu", "cuda": "gpu", "tpu": "gpu"}


class Device:
    """A compute device: ``Device('gpu', 0)`` (the card ``cuda:0``),
    ``Device('cpu')``. A context manager sets the device that arrays and
    models are made on (``with mx.cpu():``), as the reference's."""

    _tls = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Device):
            device_id = device_type.device_id
            device_type = device_type.device_type
        elif isinstance(device_type, torch.device):
            device_id = device_type.index or 0
            device_type = device_type.type
        elif isinstance(device_type, str) and ":" in device_type:
            device_type, idx = device_type.split(":", 1)
            device_id = int(idx)
        if device_type not in _TYPES:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = _TYPES[device_type]
        self.device_id = 0 if self.device_type == "cpu" else int(device_id)

    @property
    def torch_device(self) -> torch.device:
        """The `torch.device` (``cpu`` or ``cuda:<id>``)."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    # -- protocol -----------------------------------------------------------
    def __eq__(self, other):
        return (
            isinstance(other, Device)
            and self.device_type == other.device_type
            and self.device_id == other.device_id
        )

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        if not hasattr(Device._tls, "stack"):
            Device._tls.stack = []
        Device._tls.stack.append(self)
        return self

    def __exit__(self, *exc):
        Device._tls.stack.pop()
        return False


# Back-compat alias, as the reference keeps `Context`.
Context = Device


def cpu(device_id: int = 0) -> Device:
    return Device("cpu", device_id)


def gpu(device_id: int = 0) -> Device:
    """The card ``cuda:<device_id>``."""
    return Device("gpu", device_id)


def tpu(device_id: int = 0) -> Device:
    """The reference's accelerator name: the same card as :func:`gpu`."""
    return Device("gpu", device_id)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_tpus() -> int:
    """The reference's accelerator count: the cards, as :func:`num_gpus`."""
    return num_gpus()


def current_device() -> Device:
    """The innermost open ``with Device:`` scope; ``gpu(0)`` with none."""
    stack = getattr(Device._tls, "stack", None)
    if stack:
        return stack[-1]
    return gpu(0)


def default_device() -> torch.device:
    """`cuda:0`; raises when no card is present."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; use `with mx.cpu():` or pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """The `torch.device` to make something on: ``device`` (a `Device`, a
    `torch.device` or a string), else :func:`current_device`. A card that
    is not present raises :class:`MXNetError`."""
    if device is None:
        device = current_device()
    if isinstance(device, Device):
        device = device.torch_device
    elif isinstance(device, str) and device.split(":")[0] in ("gpu", "tpu"):
        device = Device(device).torch_device
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(f"device {device} requested but no CUDA device is "
                         f"available; use `with mx.cpu():` or pass "
                         f"device='cpu' to run on the CPU")
    return device


def gpu_memory_info(device_id: int = 0):
    """(free, total) bytes of the card (reference: device.py:249);
    ``(0, 0)`` without one."""
    if device_id >= num_gpus():
        return (0, 0)
    return torch.cuda.mem_get_info(device_id)


def memory_stats(device_id: int | None = None):
    """The caching allocator's statistics of one card
    (`torch.cuda.memory_stats`): the current device's by default. ``{}``
    on the CPU or without a card."""
    if device_id is None:
        dev = current_device()
        if dev.device_type == "cpu":
            return {}
        device_id = dev.device_id
    if device_id >= num_gpus():
        return {}
    return dict(torch.cuda.memory_stats(device_id))


def live_array_bytes():
    """Bytes the card's caching allocator holds for live tensors (the
    reference sums its live arrays); 0 without a card."""
    if not num_gpus():
        return 0
    return sum(torch.cuda.memory_allocated(i) for i in range(num_gpus()))
