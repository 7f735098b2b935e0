"""The reference's binary ``.params``/``.ndarray`` container (the port's
own copy of `incubator_mxnet_tpu/ndarray/legacy_io.py`: ``struct`` and
numpy only; the layout of MXNet's `src/ndarray/ndarray.cc:1862-2155`):

    file   := uint64 0x112 | uint64 0 | vec<blob> data | vec<string> names
    vec<T> := uint64 count | T...
    string := uint64 length | bytes
    blob   := uint32 magic (V3 0xF993faca np-shape / V2 0xF993fac9)
            | int32 stype (0 dense, 1 row_sparse, 2 csr)
            | [storage_shape: tshape]            (sparse only)
            | shape: tshape
            | int32 dev_type=1 (cpu) | int32 dev_id=0
            | int32 type_flag (mshadow enum)
            | [per-aux: int32 aux_type | tshape aux_shape]  (sparse only)
            | raw row-major data bytes
            | [raw aux data bytes...]            (sparse only)
    tshape := int32 ndim | int64[ndim]

A file either package writes loads in the other, byte for byte the same
for the same dense arrays. Sparse blobs (row_sparse, csr) raise
:class:`MXNetError`: sparse storage is `ROADMAP.md` §1 item 11b. Loaded
arrays land on the current device (the card unless the caller asks for
the CPU). bfloat16 is written and read as its raw 16-bit words (numpy has
no bfloat16).
"""
from __future__ import annotations

import struct

import numpy as onp
import torch

from ..base import MXNetError

NDARRAY_FILE_MAGIC = 0x112
NDARRAY_V2_MAGIC = 0xF993FAC9
NDARRAY_V3_MAGIC = 0xF993FACA

# mshadow type flags (3rdparty/mshadow/mshadow/base.h:352)
_FLAG_TO_DTYPE = {
    0: "float32", 1: "float64", 2: "float16", 3: "uint8", 4: "int32",
    5: "int8", 6: "int64", 7: "bool", 8: "int16", 9: "uint16",
    10: "uint32", 11: "uint64", 12: "bfloat16",
}
_DTYPE_TO_FLAG = {v: k for k, v in _FLAG_TO_DTYPE.items()}
_STYPES = {1: "row_sparse", 2: "csr"}
_11B = "ROADMAP.md §1 item 11b"


def _np_dtype(name):
    """The numpy dtype a blob's bytes are read as (bfloat16's raw words as
    uint16)."""
    return onp.dtype("uint16" if name == "bfloat16" else name)


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def u32(self, v):
        self.parts.append(struct.pack("<I", v))

    def i32(self, v):
        self.parts.append(struct.pack("<i", v))

    def u64(self, v):
        self.parts.append(struct.pack("<Q", v))

    def raw(self, b):
        self.parts.append(bytes(b))

    def tshape(self, shape):
        self.i32(len(shape))
        for d in shape:
            self.parts.append(struct.pack("<q", int(d)))

    def string(self, s):
        b = s.encode("utf-8")
        self.u64(len(b))
        self.raw(b)

    def getvalue(self):
        return b"".join(self.parts)


class _Reader:
    def __init__(self, data):
        self.data = data
        self.pos = 0

    def _take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated NDArray file")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self._take(4))[0]

    def i32(self):
        return struct.unpack("<i", self._take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self._take(8))[0]

    def tshape(self):
        ndim = self.i32()
        if ndim < 0:
            return None
        return tuple(struct.unpack(f"<{ndim}q", self._take(8 * ndim)))

    def string(self):
        return self._take(self.u64()).decode("utf-8")


def _host(a):
    """(dtype name, contiguous bytes, shape) of an NDArray, tensor or
    array-like."""
    from .ndarray import NDArray

    t = a._data if isinstance(a, NDArray) else a
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().tobytes(), \
                tuple(t.shape)
        arr = t.numpy()
    else:
        arr = onp.ascontiguousarray(onp.asarray(t))
    return str(arr.dtype), onp.ascontiguousarray(arr).tobytes(), arr.shape


def _write_dense_blob(w: _Writer, a):
    name, data, shape = _host(a)
    if name not in _DTYPE_TO_FLAG:
        raise ValueError(f"dtype {name} has no reference type flag")
    w.u32(NDARRAY_V3_MAGIC)
    w.i32(0)  # kDefaultStorage
    w.tshape(shape)
    w.i32(1)  # dev_type cpu
    w.i32(0)  # dev_id
    w.i32(_DTYPE_TO_FLAG[name])
    w.raw(data)


def _read_blob(r: _Reader):
    from .ndarray import array

    magic = r.u32()
    if magic not in (NDARRAY_V2_MAGIC, NDARRAY_V3_MAGIC):
        raise ValueError(f"unsupported NDArray blob magic {magic:#x} "
                         "(V1/legacy formats not implemented)")
    stype = r.i32()
    if stype in _STYPES:
        raise MXNetError(f"a {_STYPES[stype]} blob: sparse storage is not "
                         f"ported ({_11B})")
    if stype != 0:
        raise ValueError(f"unknown storage type {stype}")
    shape = r.tshape()
    if shape is None:
        return array(onp.zeros((0,), onp.float32))
    r.i32()  # dev_type
    r.i32()  # dev_id
    name = _FLAG_TO_DTYPE[r.i32()]
    dtype = _np_dtype(name)
    count = int(onp.prod(shape)) if shape else 1
    data = onp.frombuffer(r._take(count * dtype.itemsize),
                          dtype=dtype).reshape(shape).copy()
    if name == "bfloat16":
        t = torch.from_numpy(data.view(onp.int16)).view(torch.bfloat16)
        return array(t)
    return array(data)


def save(fname, data):
    """Write NDArrays (one, a list, or a dict by name) in the reference's
    binary container (MXNet's ``NDArray::Save``)."""
    from .ndarray import NDArray

    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    w = _Writer()
    w.u64(NDARRAY_FILE_MAGIC)
    w.u64(0)
    w.u64(len(arrays))
    for a in arrays:
        if getattr(a, "stype", "default") != "default":
            raise MXNetError(f"legacy save of a {a.stype} array: sparse "
                             f"storage is not ported ({_11B})")
        _write_dense_blob(w, a)
    w.u64(len(names))
    for n in names:
        w.string(n)
    with open(fname, "wb") as f:
        f.write(w.getvalue())


def load(fname):
    """Read the reference's binary container (MXNet's ``NDArray::Load``):
    a dict by name when the file carries names, else a list."""
    with open(fname, "rb") as f:
        r = _Reader(f.read())
    if r.u64() != NDARRAY_FILE_MAGIC:
        raise ValueError(f"{fname} is not a reference NDArray file")
    r.u64()  # reserved
    arrays = [_read_blob(r) for _ in range(r.u64())]
    n_names = r.u64()
    if n_names == 0:
        return arrays
    if n_names != len(arrays):
        raise ValueError("corrupt NDArray file: name/array count mismatch")
    names = [r.string() for _ in range(n_names)]
    return dict(zip(names, arrays))


def is_legacy_file(fname):
    """Whether ``fname`` starts with the container's magic."""
    try:
        with open(fname, "rb") as f:
            head = f.read(8)
        return len(head) == 8 and struct.unpack("<Q", head)[0] == \
            NDARRAY_FILE_MAGIC
    except OSError:
        return False
