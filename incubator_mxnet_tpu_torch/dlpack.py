"""DLPack interop (port of `incubator_mxnet_tpu/dlpack.py`):
`to_dlpack_for_read/write`, `from_dlpack`, over `torch.utils.dlpack`.

An export shares the array's memory with the consumer. A read export must
not be written. A write export first gives the array a tensor of its own
(the port's arrays may share storage with the slices taken from them, see
`ndarray/ndarray.py`), so what the consumer writes reaches this array and
no other.
"""
from __future__ import annotations

import torch
import torch.utils.dlpack

from .ndarray.ndarray import NDArray

__all__ = ["to_dlpack_for_read", "to_dlpack_for_write", "from_dlpack",
           "DLDeviceType"]


class DLDeviceType:
    """Device-type enum parity (`dlpack.py:35`)."""

    DLCPU = 1
    DLGPU = 2
    DLCPUPINNED = 3


class _DLPackExport:
    """Protocol-object export (``__dlpack__``/``__dlpack_device__``), as
    modern consumers (torch.from_dlpack, np.from_dlpack) take it. Pins the
    source tensor for its lifetime."""

    def __init__(self, buf):
        self._buf = buf

    def __dlpack__(self, *args, **kwargs):
        return self._buf.__dlpack__(*args, **kwargs)

    def __dlpack_device__(self):
        return self._buf.__dlpack_device__()


def to_dlpack_for_read(data: NDArray):
    """Export for zero-copy reading by another framework (`dlpack.py:63`);
    the consumer must not write it."""
    data.wait_to_read()
    return _DLPackExport(data._data.detach())


def to_dlpack_for_write(data: NDArray):
    """Export whose writes land in ``data`` (`dlpack.py:85`)."""
    data.wait_to_read()
    data._set_data(data._data.detach().clone())
    return _DLPackExport(data._data.detach())


def from_dlpack(dlpack) -> NDArray:
    """Wrap a DLPack protocol object or capsule into an NDArray
    (`dlpack.py:107`); it shares the producer's memory."""
    if isinstance(dlpack, NDArray):
        return NDArray(dlpack._data.detach())
    return NDArray(torch.utils.dlpack.from_dlpack(dlpack))
