"""Batchify functions (port of `incubator_mxnet_tpu/gluon/data/batchify.py`).

A batch is made on the host: numpy samples stack into a numpy array, as
the reference's workers hand numpy to the main process, and the
`DataLoader` uploads it. Samples that are NDArrays stack on their own
device into an NDArray, as the reference stacks its device arrays.
"""
from __future__ import annotations

import numpy as onp
import torch

from ...ndarray.ndarray import NDArray

__all__ = ["Stack", "Pad", "Group", "default_batchify_fn"]


def _stack_arrs(arrs):
    if isinstance(arrs[0], NDArray):
        return NDArray(torch.stack([a._data for a in arrs]))
    return onp.stack([onp.asarray(a) for a in arrs])


def default_batchify_fn(data):
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn([d[i] for d in data])
                     for i in range(len(data[0])))
    return _stack_arrs(data)


class Stack:
    def __call__(self, data):
        return _stack_arrs(data)


class Pad:
    def __init__(self, axis=0, val=0, dtype=None):
        self._axis = axis
        self._val = val
        self._dtype = dtype

    def __call__(self, data):
        arrs = [d.asnumpy() if isinstance(d, NDArray) else onp.asarray(d)
                for d in data]
        max_len = max(a.shape[self._axis] for a in arrs)
        padded = []
        for a in arrs:
            pad_width = [(0, 0)] * a.ndim
            pad_width[self._axis] = (0, max_len - a.shape[self._axis])
            padded.append(onp.pad(a, pad_width, constant_values=self._val))
        out = onp.stack(padded)
        if self._dtype is not None:
            out = out.astype(self._dtype)
        return out


class Group:
    def __init__(self, *fns):
        self._fns = fns

    def __call__(self, data):
        return tuple(fn([d[i] for d in data])
                     for i, fn in enumerate(self._fns))
