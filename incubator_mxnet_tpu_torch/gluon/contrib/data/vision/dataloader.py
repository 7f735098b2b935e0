"""Preset image-augmentation pipelines + DataLoader facade (port of
`incubator_mxnet_tpu/gluon/contrib/data/vision/dataloader.py`; reference:
`python/mxnet/gluon/contrib/data/vision/dataloader.py:34`
create_image_augment and `:140` ImageDataLoader).

The augmentation composes the gluon transforms (host numpy); the loader
is the ordinary multiprocess DataLoader over an ImageRecordDataset or
ImageFolderDataset, so the whole pipeline uploads each batch as
gluon.data.DataLoader does."""
from __future__ import annotations

from .... import data as gdata
from ....data.vision import transforms

__all__ = ["create_image_augment", "ImageDataLoader"]


def create_image_augment(data_shape, resize=0, rand_crop=False,
                         rand_resize=False, rand_mirror=False, mean=None,
                         std=None, brightness=0, contrast=0, saturation=0,
                         hue=0, pca_noise=0, rand_gray=0,  # noqa: ARG001
                         inter_method=1, dtype="float32"):  # noqa: ARG001
    """Compose a standard augmentation stack (`dataloader.py:34`).

    Returns a `transforms.Compose`-style HybridSequential. `pca_noise`,
    `rand_gray` and custom interpolation methods are not supported on the
    host pipeline and must be 0/default (a ValueError points this out)."""
    if pca_noise or rand_gray or hue:
        raise ValueError("create_image_augment: pca_noise/rand_gray/hue "
                         "are not supported in the host pipeline")
    aug = transforms.Compose()
    size = (data_shape[2], data_shape[1])  # (W, H)
    if rand_resize:
        if resize > 0:  # reference: pre-resize before the random crop
            aug.add(transforms.Resize(resize, keep_ratio=True))
        aug.add(transforms.RandomResizedCrop(size))
    elif rand_crop:
        aug.add(transforms.Resize(resize, keep_ratio=True) if resize > 0
                else transforms.Resize((size[0] * 9 // 8,
                                        size[1] * 9 // 8)))
        aug.add(transforms.RandomCrop(size))
    elif resize > 0:
        # reference semantics: shorter-edge resize then center crop
        aug.add(transforms.Resize(resize, keep_ratio=True))
        aug.add(transforms.CenterCrop(size))
    else:
        aug.add(transforms.Resize(size))
    if rand_mirror:
        aug.add(transforms.RandomFlipLeftRight())
    if brightness:
        aug.add(transforms.RandomBrightness(brightness))
    if contrast:
        aug.add(transforms.RandomContrast(contrast))
    if saturation:
        aug.add(transforms.RandomSaturation(saturation))
    aug.add(transforms.ToTensor())
    if mean is not None or std is not None:
        aug.add(transforms.Normalize(mean if mean is not None else 0.0,
                                     std if std is not None else 1.0))
    return aug


class ImageDataLoader:
    """Ready-made augmenting loader over an image RecordIO file or image
    folder (`dataloader.py:140`). Iterates (data, label) batches."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imgidx=None, root=None, shuffle=False,
                 num_workers=0, aug_list=None, last_batch="discard",
                 **augment_kwargs):
        if path_imgrec is not None:
            # path_imgidx accepted for API parity; the record index is
            # rebuilt/derived automatically by RecordFileDataset
            del path_imgidx
            dataset = gdata.vision.ImageRecordDataset(path_imgrec)
        elif root is not None:
            dataset = gdata.vision.ImageFolderDataset(root)
        else:
            raise ValueError("ImageDataLoader: pass path_imgrec or root")
        if aug_list is None:
            aug_list = create_image_augment(data_shape, **augment_kwargs)
        self._dataset = dataset.transform_first(aug_list)
        self._loader = gdata.DataLoader(
            self._dataset, batch_size=batch_size, shuffle=shuffle,
            num_workers=num_workers, last_batch=last_batch)

    def __iter__(self):
        return iter(self._loader)

    def __len__(self):
        return len(self._loader)
