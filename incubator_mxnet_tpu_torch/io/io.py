"""Legacy data iterators (port of `incubator_mxnet_tpu/io/io.py`; reference:
`python/mxnet/io/io.py` — `DataIter`, `NDArrayIter`, `DataBatch`; MXNet's
C++ iterators under `src/io/` are replaced by host pipelines here:
`ImageRecordIter` is `image.ImageIter` over the native record reader,
uploading each uint8 batch and casting and transposing it to NCHW on
the card). Arrays live on the current device (the card unless the
caller asks for the CPU); `NDArrayIter` gathers each batch on the
arrays' device."""
from __future__ import annotations

from collections import namedtuple

import numpy as onp
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ImageRecordIter", "MNISTIter",
           "ResizeIter", "CSVIter", "LibSVMIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise TypeError("data must be a list of NDArrays")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    __next__ = next

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    if data is None:
        return []
    if isinstance(data, (NDArray, onp.ndarray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    return [(k, NDArray(v) if not isinstance(v, NDArray) else v)
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference: io.py NDArrayIter)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.cursor = -batch_size
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = onp.arange(self.num_data)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:],
                         str(v.dtype)) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:],
                         str(v.dtype)) for k, v in self.label]

    def reset(self):
        if self.shuffle:
            onp.random.shuffle(self.idx)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "roll_over":
            return self.cursor < self.num_data
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _batch(self, arrays):
        out = []
        for _, v in arrays:
            end = self.cursor + self.batch_size
            sel = self.idx[self.cursor:end]
            if len(sel) < self.batch_size and self.last_batch_handle == "pad":
                pad = self.batch_size - len(sel)
                sel = onp.concatenate([sel, self.idx[:pad]])
            t = v._data
            out.append(NDArray(t[torch.as_tensor(sel, device=t.device)]))
        return out

    def getdata(self):
        return self._batch(self.data)

    def getlabel(self):
        return self._batch(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return end - self.num_data
        return 0


class ResizeIter(DataIter):
    """Resize the epoch length of an iterator (reference: io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


class CSVIter(NDArrayIter):
    """Iterate rows of CSV files (reference: `src/io/iter_csv.cc:217` —
    the C++ threaded CSV parser; here the file is parsed once on host and
    batches stream from memory, since the device wants whole batches
    anyway).

    `data_csv`/`label_csv` are paths; `data_shape`/`label_shape` give the
    per-row shapes (rows are reshaped accordingly)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True, **kwargs):
        data = onp.loadtxt(data_csv, delimiter=",", dtype=onp.float32,
                           ndmin=2)
        data = data.reshape((data.shape[0],) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = onp.loadtxt(label_csv, delimiter=",",
                                dtype=onp.float32, ndmin=2)
            label = label.reshape((label.shape[0],) + tuple(label_shape))
        super().__init__(NDArray(data),
                         None if label is None else NDArray(label),
                         batch_size=batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard", **kwargs)


class LibSVMIter(NDArrayIter):
    """Iterate rows of a LibSVM file (reference: `src/io/iter_libsvm.cc:201`).
    Batches are served as dense slices; the sparse view (`to_csr()`,
    `nd.sparse`) is `ROADMAP.md` §1 item 11b's."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 batch_size=1, round_batch=True, **kwargs):
        n_cols = int(onp.prod(data_shape))
        rows, labels = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = onp.zeros(n_cols, onp.float32)
                for tok in parts[1:]:
                    k, v = tok.split(":")
                    row[int(k)] = float(v)
                rows.append(row)
        data = onp.stack(rows).reshape((len(rows),) + tuple(data_shape))
        if label_libsvm is not None:
            # separate label file (reference: label_libsvm param): one
            # label (or label vector) per line, same LibSVM framing
            ext_labels = []
            with open(label_libsvm) as f:
                for line in f:
                    parts = line.strip().split()
                    if parts:
                        ext_labels.append(float(parts[0]))
            if len(ext_labels) != len(rows):
                raise ValueError(
                    f"label_libsvm has {len(ext_labels)} rows but "
                    f"data_libsvm has {len(rows)}")
            label = onp.asarray(ext_labels, onp.float32).reshape(-1, 1)
        else:
            label = onp.asarray(labels, onp.float32).reshape(-1, 1)
        super().__init__(NDArray(data), NDArray(label),
                         batch_size=batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard", **kwargs)

    def to_csr(self):
        """CSR view of the full feature matrix: `nd.sparse` is
        `ROADMAP.md` §1 item 11b's."""
        raise MXNetError("LibSVMIter.to_csr: the sparse storage types "
                         "(nd.sparse) are ROADMAP.md §1 item 11b")


def ImageRecordIter(path_imgrec=None, data_shape=None, batch_size=1,  # noqa: N802
                    shuffle=False, rand_crop=False, rand_mirror=False,
                    mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0,
                    std_g=1.0, std_b=1.0, resize=-1, label_width=1,
                    preprocess_threads=4, prefetch_buffer=2,
                    part_index=0, num_parts=1, **kwargs):
    """Reference C++ registered iterator facade (reference:
    `src/io/iter_image_recordio_2.cc:890` `MXNET_REGISTER_IO_ITER(
    ImageRecordIter)`): builds the equivalent `image.ImageIter` with the
    matching augmenters over the host decode pool + prefetcher."""
    from ..image import CreateAugmenter, ImageIter

    if data_shape is None:
        raise ValueError("ImageRecordIter: data_shape required")
    mean = None
    if mean_r or mean_g or mean_b:
        mean = onp.array([mean_r, mean_g, mean_b], onp.float32)
    std = None
    if (std_r, std_g, std_b) != (1.0, 1.0, 1.0):
        std = onp.array([std_r, std_g, std_b], onp.float32)
    aug = CreateAugmenter(
        data_shape, resize=resize if resize > 0 else 0,
        rand_crop=rand_crop, rand_mirror=rand_mirror, mean=mean, std=std)
    del preprocess_threads  # ImageIter sizes its decode pool internally
    return ImageIter(batch_size=batch_size, data_shape=data_shape,
                     label_width=label_width, path_imgrec=path_imgrec,
                     shuffle=shuffle, aug_list=aug,
                     part_index=part_index, num_parts=num_parts,
                     prefetch=prefetch_buffer, **kwargs)


def MNISTIter(image=None, label=None, batch_size=1, shuffle=False,  # noqa: N802
              flat=False, seed=0, **kwargs):  # noqa: ARG001
    """Reference MNISTIter facade (reference: `src/io/iter_mnist.cc:257`):
    reads the idx-format files into one NDArrayIter."""
    import gzip
    import struct as _struct

    def read_idx(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            magic = _struct.unpack(">HBB", f.read(4))
            ndim = magic[2]
            dims = _struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return onp.frombuffer(f.read(), onp.uint8).reshape(dims)

    if image is None or label is None:
        raise ValueError("MNISTIter: image and label paths required")
    x = read_idx(image).astype(onp.float32) / 255.0
    y = read_idx(label).astype(onp.float32)
    x = x.reshape(x.shape[0], -1) if flat else x[:, None]
    if shuffle:
        perm = onp.random.RandomState(seed).permutation(len(x))
        x, y = x[perm], y[perm]
    return NDArrayIter(data=x, label=y, batch_size=batch_size)
