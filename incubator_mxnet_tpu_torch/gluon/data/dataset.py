"""Datasets (port of `incubator_mxnet_tpu/gluon/data/dataset.py`; host
code, kept as it is)."""
from __future__ import annotations

import os
import struct

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([s for s in self if fn(s)])

    def shard(self, num_shards, index):
        assert 0 <= index < num_shards
        items = list(range(index, len(self), num_shards))
        return _SubsetDataset(self, items)

    def take(self, count):
        return _SubsetDataset(self, list(range(min(count, len(self)))))

    def sample(self, sampler):
        return _SubsetDataset(self, list(sampler))

    def transform(self, fn, lazy=True):  # noqa: ARG002
        return _LazyTransformDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        return self.transform(_First(fn), lazy)


class _First:
    """``fn`` on a sample's first item (a class, not a closure, so that a
    transformed dataset pickles into the DataLoader's workers)."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, *items):
        if len(items) == 1:
            return self._fn(items[0])
        return (self._fn(items[0]),) + items[1:]


class _SubsetDataset(Dataset):
    def __init__(self, dataset, indices):
        self._dataset = dataset
        self._indices = indices

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]

    def __len__(self):
        return len(self._indices)


class _LazyTransformDataset(Dataset):
    def __init__(self, dataset, fn):
        self._dataset = dataset
        self._fn = fn

    def __getitem__(self, idx):
        item = self._dataset[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)

    def __len__(self):
        return len(self._dataset)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __getitem__(self, idx):
        return self._data[idx]

    def __len__(self):
        return len(self._data)


class ArrayDataset(Dataset):
    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for a in args:
            assert len(a) == self._length, "all arrays must have the same length"
            self._data.append(a)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over a dmlc RecordIO file (reference: `recordio.py` +
    `gluon/data/dataset.py RecordFileDataset`), read through the port's
    `recordio` (an index is built beside the file when it has none)."""

    def __init__(self, filename):
        from ...recordio import IndexCreator, MXIndexedRecordIO

        self._filename = filename
        idx_file = os.path.splitext(filename)[0] + ".idx"
        if not os.path.exists(idx_file):
            creator = IndexCreator(filename, idx_file)
            creator.create_index()
            creator.close()
        self._record = MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
