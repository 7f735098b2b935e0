"""Composable vision data loading (reference:
`python/mxnet/gluon/contrib/data/vision/dataloader.py`)."""
from .dataloader import (  # noqa: F401
    ImageDataLoader,
    create_image_augment,
)
