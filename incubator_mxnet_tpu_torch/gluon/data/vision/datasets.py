"""Vision datasets (port of `incubator_mxnet_tpu/gluon/data/vision/
datasets.py`).

Nothing downloads: when the on-disk dataset files are absent, the
reference's deterministic synthetic stand-in with the right shapes and
classes is generated (seeded per dataset, the same draws), and real data
is used when present under `root`. Samples are NDArrays on the host
(``cpu``): a transform runs there, and the `DataLoader` uploads the
batch, so a worker process never touches the card.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as onp

from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        from ....ndarray.ndarray import NDArray

        x = NDArray(self._data[idx], device="cpu")
        y = int(self._label[idx])
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST (28×28×1, 10 classes). Reads idx-format files when present."""

    _seed = 101
    _shape = (28, 28, 1)
    _classes = 10
    _files = {True: ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
              False: ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")}

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        img_f, lbl_f = self._files[self._train]
        img_path = os.path.join(self._root, img_f)
        lbl_path = os.path.join(self._root, lbl_f)
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            with gzip.open(lbl_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                label = onp.frombuffer(f.read(), dtype=onp.uint8)
            with gzip.open(img_path, "rb") as f:
                _, n, rows, cols = struct.unpack(">IIII", f.read(16))
                data = onp.frombuffer(f.read(), dtype=onp.uint8).reshape(
                    n, rows, cols, 1)
            self._data, self._label = data, label.astype(onp.int32)
            return
        # deterministic synthetic fallback (no network egress available)
        n = 6000 if self._train else 1000
        rng = onp.random.RandomState(self._seed + (0 if self._train else 1))
        self._data = rng.randint(0, 256, size=(n,) + self._shape,
                                 dtype=onp.uint8)
        self._label = rng.randint(0, self._classes, size=(n,)).astype(onp.int32)


class FashionMNIST(MNIST):
    _seed = 202

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    _seed = 303
    _shape = (32, 32, 3)
    _classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        batches = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                   if self._train else ["test_batch.bin"])
        paths = [os.path.join(self._root, "cifar-10-batches-bin", b)
                 for b in batches]
        if all(os.path.exists(p) for p in paths):
            data, labels = [], []
            for p in paths:
                raw = onp.fromfile(p, dtype=onp.uint8).reshape(-1, 3073)
                labels.append(raw[:, 0])
                data.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                            .transpose(0, 2, 3, 1))
            self._data = onp.concatenate(data)
            self._label = onp.concatenate(labels).astype(onp.int32)
            return
        n = 5000 if self._train else 1000
        rng = onp.random.RandomState(self._seed + (0 if self._train else 1))
        self._data = rng.randint(0, 256, size=(n,) + self._shape,
                                 dtype=onp.uint8)
        self._label = rng.randint(0, self._classes, size=(n,)).astype(onp.int32)


class CIFAR100(CIFAR10):
    _seed = 404
    _classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=True, train=True, transform=None):  # noqa: ARG002
        super().__init__(root, train, transform)


class ImageFolderDataset(Dataset):
    """class-per-subfolder image dataset (reference: datasets.py)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png", ".npy")):
                    self.items.append((os.path.join(path, fname), label))

    def __getitem__(self, idx):
        from ....image import _imread_np
        from ....ndarray.ndarray import NDArray

        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = NDArray(onp.load(path), device="cpu")
        else:
            img = NDArray(_imread_np(path, self._flag), device="cpu")
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class ImageRecordDataset(Dataset):
    """Images packed in a RecordIO file by im2rec (reference:
    `gluon/data/vision/datasets.py` ImageRecordDataset over
    `RecordFileDataset` + `recordio.unpack_img`)."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset

        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....image import imdecode_np
        from ....ndarray.ndarray import NDArray
        from ....recordio import unpack

        record = self._record[idx]
        header, img_bytes = unpack(record)
        img = NDArray(imdecode_np(img_bytes, self._flag), device="cpu")
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._record)
