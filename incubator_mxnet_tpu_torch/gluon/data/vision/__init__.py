from . import transforms  # noqa: F401
from .datasets import (  # noqa: F401
    CIFAR10, CIFAR100, MNIST, FashionMNIST, ImageFolderDataset,
    ImageRecordDataset,
)
