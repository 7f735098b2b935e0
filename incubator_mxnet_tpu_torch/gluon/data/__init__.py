from .dataset import ArrayDataset, Dataset, SimpleDataset, RecordFileDataset  # noqa: F401
from .sampler import (  # noqa: F401
    BatchSampler, ElasticSampler, RandomSampler, Sampler, SequentialSampler,
    FilterSampler,
)
from .dataloader import DataLoader  # noqa: F401
from . import batchify  # noqa: F401
from . import vision  # noqa: F401
