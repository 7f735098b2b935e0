"""Imperative image API (port of `incubator_mxnet_tpu/image.py`; reference:
`python/mxnet/image/image.py` — imread, imresize, Augmenter classes
:761-1170, CreateAugmenter :1171, ImageIter :1285).

Codecs, in the reference's order: decoding takes cv2, then PIL, and the
raw `.npy` container always; encoding takes PIL, else the `.npy`
container. `decode_counts` counts the images each codec decoded.

Augmenters run on HOST numpy (the augmentation hot path must not
round-trip each image through the device), and `ImageIter` emits whole
batches NCHW on its device: under the uint8 fast path the batch is
uploaded as uint8 and cast and transposed on the card. Resizing is the
reference's bilinear (`jax.image.resize(method="bilinear")`, antialiased
when shrinking) in its host form (`_resize_weights`): `imresize` casts
the float32 result back to the input's dtype as the reference does,
`_resize_np` (the augmenters') rounds an integer image first.

`ImageIter` over an indexed ``.rec`` reads each batch's records in one
call through the native runtime (`recordio.MXIndexedRecordIO.
read_batch`: librtio when it can be built, else the Python reader).
"""
from __future__ import annotations

import numpy as onp

from .ndarray.ndarray import NDArray

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "random_size_crop", "scale_down",
           "copyMakeBorder", "color_normalize",
           "Augmenter", "SequentialAug", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
           "RandomOrderAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "ColorJitterAug",
           "LightingAug", "ColorNormalizeAug", "RandomGrayAug",
           "HorizontalFlipAug", "CastAug", "CreateAugmenter", "ImageIter"]


def _pil():
    try:
        from PIL import Image

        return Image
    except ImportError:
        return None


def _cv2():
    global _CV2
    if _CV2 is None:
        try:
            import cv2

            _CV2 = cv2
        except ImportError:
            _CV2 = False
    return _CV2 or None


_CV2 = None

#: images decoded by each codec ("cv2", "PIL", "npy")
decode_counts = {"cv2": 0, "PIL": 0, "npy": 0}


def imdecode_np(buf, flag=1, to_rgb=True):
    """Host-side decode to a numpy HWC array. The input-pipeline hot path:
    keeps JPEG decode entirely on the CPU (wrapping every decoded image in
    an NDArray would upload it to the device and back, two transfers per
    image).

    Decoder preference mirrors MXNet (`src/io/image_io.cc` uses OpenCV):
    cv2 when importable (it releases the GIL, so the iterator's thread
    pool scales), else PIL (GIL-bound)."""
    if isinstance(buf, (bytes, bytearray)) and bytes(buf[:6]) == b"\x93NUMPY":
        import io as _io

        arr = onp.load(_io.BytesIO(bytes(buf)))
        decode_counts["npy"] += 1
        if flag == 0 and arr.ndim == 3 and arr.shape[2] >= 3:
            # honor the grayscale flag on the .npy path too (ITU-R 601)
            arr = (arr[..., 0] * 0.299 + arr[..., 1] * 0.587
                   + arr[..., 2] * 0.114).astype(arr.dtype)[..., None]
        return arr
    cv2 = _cv2()
    if cv2 is not None:
        mode = cv2.IMREAD_COLOR if flag == 1 else cv2.IMREAD_GRAYSCALE
        arr = cv2.imdecode(onp.frombuffer(bytes(buf), onp.uint8), mode)
        if arr is not None:
            decode_counts["cv2"] += 1
            if arr.ndim == 2:
                return arr[:, :, None]
            if flag == 1 and to_rgb:
                arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
            return arr
        # fall through to PIL on formats cv2 rejects
    Image = _pil()
    if Image is None:
        raise RuntimeError("JPEG/PNG decode requires cv2 or PIL, neither "
                           "is installed; use .npy images")
    import io as _io

    img = Image.open(_io.BytesIO(bytes(buf)))
    if flag == 1:
        img = img.convert("RGB")
    else:
        img = img.convert("L")
    arr = onp.asarray(img)
    decode_counts["PIL"] += 1
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if flag == 1 and not to_rgb:
        arr = arr[:, :, ::-1]   # BGR contract, same as the cv2 path
    return arr


def imdecode(buf, flag=1, to_rgb=True):
    return NDArray(imdecode_np(buf, flag, to_rgb))


def imencode(img, img_fmt=".jpg", quality=95):
    """Encode an HWC uint8 image to JPEG/PNG bytes (reference role:
    cv2.imencode in `python/mxnet/image/image.py`); falls back to the
    `.npy` container when PIL is unavailable (imdecode reads both)."""
    arr = img.asnumpy() if hasattr(img, "asnumpy") else onp.asarray(img)
    arr = arr.astype(onp.uint8)
    Image = _pil()
    import io as _io

    buf = _io.BytesIO()
    if Image is None:
        onp.save(buf, arr)
        return buf.getvalue()
    channels = arr.shape[2] if arr.ndim == 3 else 1
    mode = {1: "L", 3: "RGB", 4: "RGBA"}.get(channels)
    if mode is None:
        raise ValueError(f"imencode: unsupported channel count {channels}")
    pimg = Image.fromarray(arr.squeeze(-1) if (arr.ndim == 3 and mode == "L")
                           else arr, mode)
    fmt = {"jpg": "JPEG", "jpeg": "JPEG", "png": "PNG"}.get(
        img_fmt.lstrip(".").lower())
    if fmt is None:
        raise ValueError(f"imencode: unsupported format {img_fmt!r} "
                         f"(jpg/jpeg/png)")
    if fmt == "JPEG" and mode == "RGBA":
        pimg = pimg.convert("RGB")  # JPEG has no alpha
    if fmt == "JPEG":
        pimg.save(buf, format=fmt, quality=quality)
    else:
        pimg.save(buf, format=fmt)
    return buf.getvalue()


def imread(filename, flag=1, to_rgb=True):
    # both paths route through imdecode so flag semantics (grayscale
    # conversion) are identical for .npy and JPEG/PNG inputs
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def _imread_np(filename, flag=1):
    """Host-only imread for the data-pipeline workers (no device upload)."""
    with open(filename, "rb") as f:
        return imdecode_np(f.read(), flag)


def imresize(src, w, h, interp=1):  # noqa: ARG001
    """Bilinear resize of an HWC image to (w, h), computed in float32 and
    cast back to the input's dtype, as the reference's
    ``jax.image.resize(...).astype(dtype)``; an NDArray on the input's
    device (the current device for a numpy input)."""
    v = _np_img(src)
    out = _resize_f32(v, w, h).astype(v.dtype)
    return NDArray(out, device=src.device if isinstance(src, NDArray)
                   else None)


def _resize_weights(in_size, out_size):
    """Separable anti-aliased bilinear weight matrix (out_size, in_size) —
    the triangle kernel jax.image.resize uses, with the kernel widened by
    the downscale factor so decimation is moiré-free."""
    scale = out_size / in_size
    span = max(1.0, 1.0 / scale)
    centers = (onp.arange(out_size) + 0.5) / scale - 0.5
    x = onp.arange(in_size)
    w = 1.0 - onp.abs(x[None, :] - centers[:, None]) / span
    w = onp.clip(w, 0.0, None)
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(onp.float32)


def _resize_f32(src, w, h):
    """The float32 bilinear resize of an HWC image (both einsums of the
    separable weights)."""
    sh, sw = src.shape[:2]
    wh = _resize_weights(sh, h)
    ww = _resize_weights(sw, w)
    out = onp.einsum("ij,jkc->ikc", wh, src.astype(onp.float32))
    return onp.einsum("kj,ijc->ikc", ww, out)


def _resize_np(src, w, h):
    """Host-side bilinear resize of an HWC numpy image, numerically matching
    jax.image.resize(method='bilinear'). The augmentation hot path must not
    round-trip each image through the device."""
    sh, sw = src.shape[:2]
    if (sh, sw) == (h, w):
        return src
    out = _resize_f32(src, w, h)
    if src.dtype.kind in "ui":
        # round, don't truncate: truncation biases integer images a full
        # level darker vs the float pipeline
        out = onp.rint(out)
    return out.astype(src.dtype)


def _resize_short_np(src, size):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return _resize_np(src, new_w, new_h)


def resize_short(src, size, interp=1):
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=1):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, None, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=1):
    import random as pyrandom

    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    x0 = pyrandom.randint(0, max(w - new_w, 0))
    y0 = pyrandom.randint(0, max(h - new_h, 0))
    out = fixed_crop(src, x0, y0, new_w, new_h, None, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src - mean
    if std is not None:
        src = src / std
    return src


def scale_down(src_size, size):
    """Scale `size` down to fit inside `src_size`, keeping aspect ratio
    (reference: image.py:214)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def copyMakeBorder(src, top, bot, left, right, _type=0, values=0):  # noqa: N802, ARG001
    """Pad an HWC image with a constant border (reference: image.py:249)."""
    arr = _np_img(src)
    out = onp.pad(arr, ((top, bot), (left, right), (0, 0)),
                  constant_values=values)
    return NDArray(out, device=src.device if isinstance(src, NDArray)
                   else None)


def _sample_size_crop_rect(h, w, area, ratio):
    """Sample (x0, y0, new_w, new_h) for a random area/aspect-ratio crop, or
    None after 10 failed attempts (reference: image.py:563 retry loop).
    Single source of truth for `random_size_crop` and RandomSizedCropAug."""
    import random as pyrandom

    if isinstance(area, (int, float)):
        area = (area, 1.0)
    src_area = h * w
    for _ in range(10):
        target_area = pyrandom.uniform(area[0], area[1]) * src_area
        log_ratio = (onp.log(ratio[0]), onp.log(ratio[1]))
        new_ratio = onp.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(onp.sqrt(target_area * new_ratio)))
        new_h = int(round(onp.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            return x0, y0, new_w, new_h
    return None


def random_size_crop(src, size, area, ratio, interp=1, **kwargs):  # noqa: ARG001
    """Random crop of random area/aspect-ratio, resized to `size`
    (reference: image.py:563)."""
    rect = _sample_size_crop_rect(src.shape[0], src.shape[1], area, ratio)
    if rect is None:
        return center_crop(src, size, interp)
    x0, y0, new_w, new_h = rect
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, rect


# -- augmenters (reference: image.py:761-1170) --------------------------------
# Augmenters transform HOST numpy HWC images; `__call__` additionally accepts
# and returns NDArray for reference API parity. `apply_np` is the iterator
# hot path (no device round-trips per image).

def _np_img(src):
    if isinstance(src, NDArray):
        return src.asnumpy()
    return onp.asarray(src)


class Augmenter:
    """Image augmenter base (reference: image.py:761)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json

        return json.dumps([type(self).__name__, self._kwargs])

    def apply_np(self, src: onp.ndarray) -> onp.ndarray:
        raise NotImplementedError

    def __call__(self, src):
        return NDArray(self.apply_np(_np_img(src)),
                       device=src.device if isinstance(src, NDArray)
                       else None)


class SequentialAug(Augmenter):
    """Compose augmenters in order (reference: image.py:787)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [type(self).__name__, [t.dumps() for t in self.ts]]

    def apply_np(self, src):
        for t in self.ts:
            src = t.apply_np(src)
        return src


class ResizeAug(Augmenter):
    """Resize shorter edge to `size` (reference: image.py:810)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def apply_np(self, src):
        return _resize_short_np(src, self.size)


class ForceResizeAug(Augmenter):
    """Resize to exact (w, h) ignoring aspect (reference: image.py:830)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def apply_np(self, src):
        return _resize_np(src, self.size[0], self.size[1])


class RandomCropAug(Augmenter):
    """Random crop to (w, h) (reference: image.py:851)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def apply_np(self, src):
        import random as pyrandom

        h, w = src.shape[:2]
        new_w, new_h = self.size
        x0 = pyrandom.randint(0, max(w - new_w, 0))
        y0 = pyrandom.randint(0, max(h - new_h, 0))
        out = src[y0:y0 + new_h, x0:x0 + new_w]
        if out.shape[:2] != (new_h, new_w):
            out = _resize_np(out, new_w, new_h)
        return out


class RandomSizedCropAug(Augmenter):
    """Random area/aspect crop resized to (w, h) (reference: image.py:871)."""

    def __init__(self, size, area, ratio, interp=2, **kwargs):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp,
                         **kwargs)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def apply_np(self, src):
        rect = _sample_size_crop_rect(src.shape[0], src.shape[1],
                                      self.area, self.ratio)
        if rect is None:
            return CenterCropAug(self.size, self.interp).apply_np(src)
        x0, y0, new_w, new_h = rect
        return _resize_np(src[y0:y0 + new_h, x0:x0 + new_w],
                          self.size[0], self.size[1])


class CenterCropAug(Augmenter):
    """Center crop to (w, h) (reference: image.py:905)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def apply_np(self, src):
        h, w = src.shape[:2]
        new_w, new_h = self.size
        x0 = max((w - new_w) // 2, 0)
        y0 = max((h - new_h) // 2, 0)
        out = src[y0:y0 + new_h, x0:x0 + new_w]
        if out.shape[:2] != (new_h, new_w):
            out = _resize_np(out, new_w, new_h)
        return out


class RandomOrderAug(Augmenter):
    """Apply child augmenters in random order (reference: image.py:925)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [type(self).__name__, [t.dumps() for t in self.ts]]

    def apply_np(self, src):
        import random as pyrandom

        order = list(self.ts)
        pyrandom.shuffle(order)
        for t in order:
            src = t.apply_np(src)
        return src


class BrightnessJitterAug(Augmenter):
    """Random brightness scale in ±brightness (reference: image.py:949)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def apply_np(self, src):
        import random as pyrandom

        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    """Random contrast jitter (reference: image.py:968)."""

    _coef = onp.array([[[0.299, 0.587, 0.114]]], onp.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def apply_np(self, src):
        import random as pyrandom

        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        gray = (src * self._coef).sum()
        gray_mean = 3.0 * (1.0 - alpha) / src.size * gray
        return src * alpha + gray_mean


class SaturationJitterAug(Augmenter):
    """Random saturation jitter (reference: image.py:991)."""

    _coef = onp.array([[[0.299, 0.587, 0.114]]], onp.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def apply_np(self, src):
        import random as pyrandom

        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        gray = (src * self._coef).sum(axis=2, keepdims=True)
        return src * alpha + gray * (1.0 - alpha)


class HueJitterAug(Augmenter):
    """Random hue rotation via the YIQ transform (reference: image.py:1015)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = onp.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]])
        self.ityiq = onp.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]])

    def apply_np(self, src):
        import random as pyrandom

        alpha = pyrandom.uniform(-self.hue, self.hue)
        u = onp.cos(alpha * onp.pi)
        w = onp.sin(alpha * onp.pi)
        bt = onp.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]])
        t = onp.dot(onp.dot(self.ityiq, bt), self.tyiq).T
        return onp.dot(src, t).astype(src.dtype)


class ColorJitterAug(RandomOrderAug):
    """Random-order brightness/contrast/saturation (reference: image.py:1049)."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise (reference: image.py:1072)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np_img(eigval)
        self.eigvec = _np_img(eigvec)

    def apply_np(self, src):
        alpha = onp.random.normal(0, self.alphastd, size=(3,))
        rgb = onp.dot(self.eigvec * alpha, self.eigval)
        return (src + rgb).astype(src.dtype)


class ColorNormalizeAug(Augmenter):
    """Subtract mean, divide std (reference: image.py:1098)."""

    def __init__(self, mean, std):
        super().__init__()
        self.mean = (_np_img(mean).astype(onp.float32)
                     if mean is not None else None)
        self.std = (_np_img(std).astype(onp.float32)
                    if std is not None else None)

    def apply_np(self, src):
        if self.mean is not None:
            src = src - self.mean
        if self.std is not None:
            src = src / self.std
        return src


class RandomGrayAug(Augmenter):
    """Convert to 3-channel grayscale with probability p
    (reference: image.py:1118)."""

    _mat = onp.array([[0.21, 0.21, 0.21],
                      [0.72, 0.72, 0.72],
                      [0.07, 0.07, 0.07]], onp.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def apply_np(self, src):
        import random as pyrandom

        if pyrandom.random() < self.p:
            src = onp.dot(src, self._mat).astype(src.dtype)
        return src


class HorizontalFlipAug(Augmenter):
    """Horizontal flip with probability p (reference: image.py:1140)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def apply_np(self, src):
        import random as pyrandom

        if pyrandom.random() < self.p:
            src = src[:, ::-1]
        return src


class CastAug(Augmenter):
    """Cast to dtype (reference: image.py:1159)."""

    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def apply_np(self, src):
        return src.astype(self.typ)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,  # noqa: N802
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """Standard augmenter list (reference: image.py:1171). Semantics match
    the reference: resize-short → crop → mirror → cast → color jitters →
    hue → pca lighting → gray → normalize."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))

    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        if not rand_crop:
            raise ValueError("rand_resize requires rand_crop")
        auglist.append(RandomSizedCropAug(crop_size, 0.08, (3. / 4., 4. / 3.),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))

    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())

    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = onp.array([55.46, 4.794, 1.148])
        eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))

    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Image iterator over .rec (recordio) or an image list, with augmenters
    and background batch prefetch (reference: image.py:1285 ImageIter over
    C++ `src/io/iter_image_recordio_2.cc:890`).

    The pipeline: record IO is sequential on one builder thread (the
    recordio file handle is shared: concurrent seeks corrupt reads; an
    indexed file reads a batch's records in one native call), decode +
    augmentation fan out over a persistent host thread pool, and up to
    `prefetch` whole NCHW batches are built ahead of the consumer so the
    device never waits on the host. Batches land on the current device
    of the iterator's construction (the card unless the caller asks for
    the CPU)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, dtype="float32", last_batch_handle="pad",
                 prefetch=2, **kwargs):  # noqa: ARG002
        from .device import resolve_device

        if len(data_shape) != 3 or data_shape[0] not in (1, 3):
            raise ValueError("data_shape must be (C, H, W) with C in {1,3}")
        # the builder thread sees no device scope: resolve it here
        self._device = resolve_device(None)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.dtype = dtype
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.auglist = (aug_list if aug_list is not None
                        else CreateAugmenter(data_shape))
        self._prefetch = max(int(prefetch), 0)
        # uint8 fast path: when every augmenter is geometric (crop/resize/
        # flip) and the only dtype change is a trailing CastAug, keep the
        # host pipeline in uint8 and cast ON DEVICE after the (4x smaller)
        # batch upload. On a host with few cores the f32 stack+upload is a
        # large share of the per-batch budget.
        geometric = (ResizeAug, ForceResizeAug, RandomCropAug,
                     CenterCropAug, HorizontalFlipAug)
        self._host_augs = list(self.auglist)
        self._device_cast = None
        if self._host_augs and isinstance(self._host_augs[-1], CastAug) \
                and all(isinstance(a, geometric)
                        for a in self._host_augs[:-1]):
            self._device_cast = getattr(self._host_augs[-1], "typ",
                                        "float32")
            self._host_augs = self._host_augs[:-1]

        # each record: (label-or-None, io_fn -> bytes|ndarray, decode_fn,
        # key in the indexed file or None)
        self._records = []
        self._rec = None
        if path_imgrec is not None:
            from .recordio import MXIndexedRecordIO, MXRecordIO, unpack_img

            self._unpack_img = unpack_img
            idx_path = path_imgrec[:-4] + ".idx"
            import os

            if os.path.exists(idx_path):
                rec = self._rec = MXIndexedRecordIO(idx_path, path_imgrec,
                                                    "r")
                for k in rec.keys:
                    self._records.append(
                        (None, lambda k=k: rec.read_idx(k), self._decode_rec,
                         k))
            else:
                # No .idx: one sequential scan storing RAW record bytes
                # (memory ~ file size, not decoded size); decode runs on the
                # worker pool per batch.
                rec = MXRecordIO(path_imgrec, "r")
                while True:
                    s = rec.read()
                    if s is None:
                        break
                    self._records.append((None, lambda b=s: b,
                                          self._decode_rec, None))
        elif imglist is not None or path_imglist is not None:
            if path_imglist is not None:
                imglist = []
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        labels = [float(x) for x in parts[1:-1]]
                        imglist.append((labels if len(labels) > 1
                                        else labels[0], parts[-1]))
            root = path_root or "."
            import os

            for label, fname in imglist:
                path = os.path.join(root, fname)
                self._records.append(
                    (onp.asarray(label, onp.float32),
                     lambda p=path: _imread_np(p), None, None))
        else:
            raise ValueError("pass path_imgrec, path_imglist, or imglist")

        # partition for distributed loading (reference: part_index/num_parts)
        if num_parts > 1:
            self._records = self._records[part_index::num_parts]

        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        self._aug_pool = ThreadPoolExecutor(
            max_workers=max(1, min(8, batch_size)))
        self._builder = ThreadPoolExecutor(max_workers=1)  # sequential IO
        self._pending: deque = deque()
        self.reset()

    def _decode_rec(self, item):
        header, img = self._unpack_img(item)
        return onp.asarray(header.label, onp.float32), img

    def close(self):
        for f in self._pending:
            f.cancel()
        self._pending.clear()
        self._aug_pool.shutdown(wait=False)
        self._builder.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: FL006 — interpreter teardown: nothing left to log to
            pass

    def reset(self):
        for f in self._pending:
            f.cancel()
        self._pending.clear()
        self._cursor = 0
        self._order = onp.arange(len(self._records))
        if self.shuffle:
            onp.random.shuffle(self._order)

    def hard_reset(self):
        self.reset()

    def __iter__(self):
        return self

    def _advance(self):
        """Claim the next batch's positions (caller thread only).
        Returns (idxs, pad) or None at end of epoch."""
        n = len(self._records)
        if self._cursor >= n:
            return None
        idxs = list(range(self._cursor, min(self._cursor + self.batch_size,
                                            n)))
        pad = self.batch_size - len(idxs)
        if pad and self.last_batch_handle == "discard":
            self._cursor = n
            return None
        self._cursor += len(idxs)
        if pad:  # wrap around (reference pad semantics); modulo handles
            idxs += [i % n for i in range(pad)]  # datasets < batch_size
        return idxs, pad

    def _load(self, idxs):
        """Sequential IO leg (builder thread only): (label, raw item,
        decode_fn) for each position; an indexed file's records in one
        batch read."""
        recs = [self._records[self._order[i]] for i in idxs]
        if self._rec is not None:
            raws = self._rec.read_batch([r[3] for r in recs])
            return [(r[0], raw, r[2]) for r, raw in zip(recs, raws)]
        return [(r[0], r[1](), r[2]) for r in recs]

    def _process_one(self, rec):
        """CPU leg: decode/augment; safe to thread."""
        label, item, decode = rec
        if decode is not None:
            dec_label, item = decode(item)
            if label is None:
                label = dec_label
        if self._device_cast is not None:
            img = onp.asarray(item)          # stay uint8 on the host
        else:
            img = onp.asarray(item, onp.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        for aug in self._host_augs:
            img = aug.apply_np(img)
        c, h, w = self.data_shape
        if img.shape[:2] != (h, w):
            img = _resize_np(img, w, h)
        if self._device_cast is not None:
            # keep HWC: stacking contiguous crops is a straight memcpy;
            # the NCHW transpose fuses into the device-side cast
            return onp.ascontiguousarray(img), label
        return img.transpose(2, 0, 1), label

    def _build_batch(self, idxs, pad):
        """Runs on the single builder thread: sequential record IO, then
        threaded decode/augment, then batch assembly. Under the uint8 fast
        path the host batch stays uint8 and the trailing cast happens on
        device after upload (4x less host memory traffic + transfer)."""
        from .io.io import DataBatch

        raw = self._load(idxs)
        if len(raw) > 1:
            results = list(self._aug_pool.map(self._process_one, raw))
        else:
            results = [self._process_one(r) for r in raw]
        dev = self._device
        if self._device_cast is not None:
            data = NDArray(onp.stack([r[0] for r in results]), device=dev) \
                .astype(self._device_cast).transpose(0, 3, 1, 2)
            if str(self.dtype) != str(self._device_cast):
                # honor the iterator's dtype contract (the host path ends
                # with .astype(self.dtype)); both casts run on the device
                data = data.astype(self.dtype)
        else:
            data = NDArray(onp.stack([r[0] for r in results])
                           .astype(self.dtype), device=dev)
        label = onp.stack([onp.atleast_1d(r[1]) for r in results])
        if self.label_width == 1:
            label = label.reshape(len(idxs), -1)[:, 0]
        return DataBatch(data=[data], label=[NDArray(label, device=dev)],
                         pad=pad)

    def __next__(self):
        return self.next()

    def next(self):
        # keep up to `prefetch` batches building ahead of the consumer
        while len(self._pending) < max(1, self._prefetch):
            adv = self._advance()
            if adv is None:
                break
            self._pending.append(self._builder.submit(self._build_batch,
                                                      *adv))
        if not self._pending:
            raise StopIteration
        return self._pending.popleft().result()
