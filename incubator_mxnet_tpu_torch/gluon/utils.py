"""Gluon utilities (port of `incubator_mxnet_tpu/gluon/utils.py`:
`split_data`, `split_and_load`, `clip_global_norm`, `check_sha1`,
`download`, `shape_is_known`, `split_rnn_params`)."""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "download",
           "check_sha1", "shape_is_known", "split_rnn_params"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(begin, end)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list=None, device_list=None, batch_axis=0,
                   even_split=True):
    """Split a batch across devices and copy each slice to its device (on
    one card: the batch, on it)."""
    devices = device_list or ctx_list
    if not isinstance(data, NDArray):
        data = NDArray(data)
    if len(devices) == 1:
        return [data.to_device(devices[0])]
    slices = split_data(data, len(devices), batch_axis, even_split)
    return [s.to_device(d) for s, d in zip(slices, devices)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale the arrays (NDArrays or tensors) in place so that their
    global L2 norm is at most ``max_norm``; returns the norm before (a
    float, read from the card)."""
    tensors = [a._data if isinstance(a, NDArray) else a for a in arrays]
    with torch.no_grad():
        total = sum(float(torch.sum(t.float() ** 2)) for t in tensors)
    total_norm = math.sqrt(total)
    if check_isfinite and not math.isfinite(total_norm):
        raise ValueError("global norm is not finite")
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for a, t in zip(arrays, tensors):
            if isinstance(a, NDArray):
                a._set_data((t * scale).detach())
            else:
                with torch.no_grad():
                    t.mul_(scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    import hashlib

    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):  # noqa: ARG001
    raise RuntimeError(
        "download() is unavailable: this environment has no network egress. "
        "Place files locally and pass their path instead.")


def shape_is_known(shape):
    """True when a shape tuple has no unknown (0/-1/None) dims
    (reference: gluon/utils.py shape_is_known)."""
    if shape is None:
        return False
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return all(s is not None and s > 0 for s in shape)


def split_rnn_params(params, mode, num_layers, input_size, hidden_size,
                     bidirectional=False):
    """Split a packed fused-RNN parameter vector into the per-layer
    i2h/h2h weight/bias dict (reference: gluon/utils.py
    split_rnn_params over the fused RNN op's packed layout: every weight,
    then every bias; ``_r`` names the reverse direction)."""
    gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
    dirs = 2 if bidirectional else 1
    flat = (params._data if isinstance(params, NDArray)
            else torch.as_tensor(params)).detach().reshape(-1)
    gh = gates * hidden_size
    need = sum(dirs * gh * ((input_size if layer == 0 else hidden_size * dirs)
                            + hidden_size + 2) for layer in range(num_layers))
    if need != flat.numel():
        raise ValueError(
            f"split_rnn_params: packed vector has {flat.numel()} elements "
            f"but the {mode} layout consumes {need}; check mode/num_layers/"
            f"input_size/hidden_size")
    out, pos = {}, 0

    def take(n, shape):
        nonlocal pos
        v = flat[pos:pos + n].reshape(shape).clone()
        pos += n
        return NDArray(v)

    for layer in range(num_layers):
        for d in range(dirs):
            suffix = "_r" if d else ""
            in_sz = input_size if layer == 0 else hidden_size * dirs
            out[f"l{layer}{suffix}_i2h_weight"] = take(gh * in_sz,
                                                       (gh, in_sz))
            out[f"l{layer}{suffix}_h2h_weight"] = take(gh * hidden_size,
                                                       (gh, hidden_size))
    for layer in range(num_layers):
        for d in range(dirs):
            suffix = "_r" if d else ""
            out[f"l{layer}{suffix}_i2h_bias"] = take(gh, (gh,))
            out[f"l{layer}{suffix}_h2h_bias"] = take(gh, (gh,))
    return out
