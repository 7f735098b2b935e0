"""`recordio`, `image`, `io`, `callback` and `model` of the port against the
JAX package's, on the CPU.

- RecordIO: files (records, image records, the index) written by either
  package are byte for byte the same; the native reader (the port's own
  ``librtio`` build) returns the Python reader's bytes, and its index is
  the Python index; the ``.npy`` codec, forced by making PIL and cv2
  unavailable in both packages, packs and decodes the same bytes.
- image: `_resize_np` bit for bit; `imresize` (the reference's
  ``jax.image.resize``) within 1e-5 of the largest magnitude for float32
  and one level for uint8 (the same float32 value, truncated, may sit on
  either side of an integer); every augmenter and crop helper bit for
  bit under the same Python and numpy seeds (host numpy on both sides);
  `ImageIter` and `ImageRecordIter` batches equal (uint8 pixels cast and
  transposed on the device; a random crop and mirror with one image a
  batch, whose draws then run in order on the builder thread).
- io: `NDArrayIter` (every last-batch mode, shuffled), `ResizeIter`,
  `CSVIter`, `LibSVMIter` and `MNISTIter` batches bit for bit.
"""
import gzip
import os
import random
import struct

import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import image as jim
from incubator_mxnet_tpu import io as jio
from incubator_mxnet_tpu import recordio as jrec
from incubator_mxnet_tpu_torch import _native
from incubator_mxnet_tpu_torch import image as tim
from incubator_mxnet_tpu_torch import io as tio
from incubator_mxnet_tpu_torch import recordio as trec

FLOAT_REL = 1e-5


def _images(n=6, h=20, w=24, seed=0):
    r = onp.random.RandomState(seed)
    return [r.randint(0, 256, (h, w, 3)).astype("uint8") for _ in range(n)]


def _write_rec(rec, idx, path, imgs, quality=90, mixed=False):
    """Image records labelled i (with ``mixed``, every other label a
    2-vector)."""
    w = rec.MXIndexedRecordIO(idx, path, "w")
    for i, img in enumerate(imgs):
        label = [float(i), 0.5] if mixed and i % 2 == 0 else float(i)
        w.write_idx(i, rec.pack_img(rec.IRHeader(0, label, i, 0), img,
                                    quality=quality))
    w.close()


@pytest.fixture
def npy_codec(monkeypatch):
    """Both packages without PIL or cv2: the .npy container is the codec."""
    for mod in (tim, jim):
        monkeypatch.setattr(mod, "_pil", lambda: None)
        monkeypatch.setattr(mod, "_CV2", False)


@pytest.mark.parametrize("codec", ["pil", "npy"])
def test_record_files_are_byte_for_byte_the_references(codec, tmp_path,
                                                        request):
    if codec == "npy":
        request.getfixturevalue("npy_codec")
    imgs = _images()
    for pkg, name in ((trec, "port"), (jrec, "ref")):
        _write_rec(pkg, str(tmp_path / f"{name}.idx"),
                   str(tmp_path / f"{name}.rec"), imgs, mixed=True)
        w = pkg.MXRecordIO(str(tmp_path / f"{name}.raw"), "w")
        for i in range(5):
            w.write(pkg.pack(pkg.IRHeader(0, [i, 2.5], i, 7), b"x" * i))
        w.close()
    for ext in ("rec", "idx", "raw"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"ref.{ext}").read_bytes(), ext
    before = dict(tim.decode_counts)
    r = trec.MXIndexedRecordIO(str(tmp_path / "port.idx"),
                               str(tmp_path / "port.rec"), "r")
    j = jrec.MXIndexedRecordIO(str(tmp_path / "ref.idx"),
                               str(tmp_path / "ref.rec"), "r")
    for k in r.keys:
        (th, timg), (jh, jimg) = (trec.unpack_img(r.read_idx(k)),
                                  jrec.unpack_img(j.read_idx(k)))
        onp.testing.assert_array_equal(timg, jimg)
        onp.testing.assert_array_equal(th.label, jh.label)
        assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    used = {c for c in tim.decode_counts
            if tim.decode_counts[c] > before[c]}
    assert used == ({"npy"} if codec == "npy" else {"cv2", "PIL"} & used)
    if codec == "npy":
        onp.testing.assert_array_equal(timg, imgs[-1])


def test_native_reader_equals_the_python_reader(tmp_path, monkeypatch):
    imgs = _images(9)
    rec, idx = str(tmp_path / "a.rec"), str(tmp_path / "a.idx")
    _write_rec(trec, idx, rec, imgs)
    assert _native.rtio() is not None, "g++ could not build librtio"
    r = trec.MXIndexedRecordIO(idx, rec, "r")
    calls = _native.native_calls
    keys = [4, 0, 8, 3]
    got = r.read_batch(keys)
    assert _native.native_calls == calls + 1
    assert got == [r.read_idx(k) for k in keys]
    # the native index equals the Python one and the reference's
    for name, native in (("n", True), ("p", False)):
        if not native:
            monkeypatch.setattr(_native, "rtio", lambda: None)
        c = trec.IndexCreator(rec, str(tmp_path / f"{name}.idx"))
        c.create_index()
        c.close()
    c = jrec.IndexCreator(rec, str(tmp_path / "j.idx"))
    c.create_index()
    c.close()
    assert (tmp_path / "n.idx").read_text() == \
        (tmp_path / "p.idx").read_text() == (tmp_path / "a.idx").read_text()
    lib = _native.library_path()
    assert lib is not None and "build" in lib.parts \
        and lib.parent.name == "torch_native"


def test_record_file_dataset_and_image_record_dataset(tmp_path):
    imgs = _images(5)
    rec = str(tmp_path / "d.rec")
    _write_rec(trec, str(tmp_path / "d.idx"), rec, imgs)
    os.remove(tmp_path / "d.idx")              # rebuilt by the dataset
    ds = tmx.gluon.data.vision.ImageRecordDataset(rec)
    jds = jmx.gluon.data.vision.ImageRecordDataset(rec)
    assert len(ds) == len(jds) == 5
    for i in range(5):
        (ti, tl), (ji, jl) = ds[i], jds[i]
        assert ti.device.device_type == "cpu"
        onp.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy())
        onp.testing.assert_array_equal(onp.asarray(tl), onp.asarray(jl))


# ---------------------------------------------------------------------------
# image
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [(7, 5), (30, 41), (24, 20)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_resize_equals_reference(size, dtype):
    src = onp.random.RandomState(2).uniform(0, 255, (20, 24, 3)) \
        .astype(dtype)
    w, h = size
    onp.testing.assert_array_equal(tim._resize_np(src, w, h),
                                   jim._resize_np(src, w, h))
    want = jim.imresize(jmx.np.array(src), w, h).asnumpy()
    with tmx.cpu():
        got = tim.imresize(tmx.np.array(src), w, h)
    assert got.device.device_type == "cpu" and got.shape == (h, w, 3)
    got = got.asnumpy()
    assert got.dtype == want.dtype
    if dtype == "uint8":
        assert onp.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        onp.testing.assert_allclose(got, want, rtol=0,
                                    atol=FLOAT_REL * onp.abs(want).max())


def _augs(m):
    eigval = onp.array([55.46, 4.794, 1.148])
    eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]])
    return {
        "ResizeAug": m.ResizeAug(14),
        "ForceResizeAug": m.ForceResizeAug((9, 13)),
        "RandomCropAug": m.RandomCropAug((10, 8)),
        "RandomSizedCropAug": m.RandomSizedCropAug((10, 8), 0.2,
                                                   (0.75, 1.33)),
        "CenterCropAug": m.CenterCropAug((10, 30)),
        "RandomOrderAug": m.RandomOrderAug([m.BrightnessJitterAug(0.2),
                                            m.ContrastJitterAug(0.2)]),
        "BrightnessJitterAug": m.BrightnessJitterAug(0.3),
        "ContrastJitterAug": m.ContrastJitterAug(0.3),
        "SaturationJitterAug": m.SaturationJitterAug(0.3),
        "HueJitterAug": m.HueJitterAug(0.2),
        "ColorJitterAug": m.ColorJitterAug(0.1, 0.2, 0.3),
        "LightingAug": m.LightingAug(0.1, eigval, eigvec),
        "ColorNormalizeAug": m.ColorNormalizeAug(
            onp.array([123.7, 116.3, 103.5]), onp.array([58.4, 57.1, 57.4])),
        "RandomGrayAug": m.RandomGrayAug(0.5),
        "HorizontalFlipAug": m.HorizontalFlipAug(0.5),
        "CastAug": m.CastAug("float16"),
        "SequentialAug": m.SequentialAug([m.ResizeAug(12),
                                          m.RandomCropAug((8, 8)),
                                          m.HorizontalFlipAug(0.5),
                                          m.CastAug()]),
    }


@pytest.mark.parametrize("name", sorted(_augs(tim)))
def test_augmenter_equals_reference(name):
    src = onp.random.RandomState(3).randint(0, 256, (20, 24, 3)) \
        .astype("float32")
    for seed in range(3):
        random.seed(seed)
        onp.random.seed(seed)
        want = _augs(jim)[name].apply_np(src)
        random.seed(seed)
        onp.random.seed(seed)
        aug = _augs(tim)[name]
        got = aug.apply_np(src)
        assert got.dtype == want.dtype
        onp.testing.assert_array_equal(got, want)
    assert aug.dumps() == _augs(jim)[name].dumps()
    random.seed(7)
    with tmx.cpu():
        out = aug(tmx.np.array(src))
    assert out.device.device_type == "cpu"


def test_crop_helpers_and_create_augmenter_equal_reference():
    src = onp.random.RandomState(4).randint(0, 256, (20, 24, 3)) \
        .astype("uint8")
    with tmx.cpu():
        t = tmx.np.array(src)
        for fn, args in (("fixed_crop", (2, 3, 10, 8)),
                         ("fixed_crop", (2, 3, 10, 8, (6, 5))),
                         ("center_crop", ((10, 8),)),
                         ("random_crop", ((10, 8),)),
                         ("random_size_crop", ((10, 8), 0.3, (0.75, 1.3))),
                         ("resize_short", (12,)),
                         ("copyMakeBorder", (1, 2, 3, 4))):
            random.seed(1)
            want = getattr(jim, fn)(jmx.np.array(src), *args)
            random.seed(1)
            got = getattr(tim, fn)(t, *args)
            if isinstance(want, tuple):
                assert got[1] == want[1], fn
                want, got = want[0], got[0]
            d = onp.abs(got.asnumpy().astype(int) - want.asnumpy()
                        .astype(int))
            assert got.shape == want.shape and d.max() <= 1, fn
    assert tim.scale_down((20, 10), (30, 15)) == \
        jim.scale_down((20, 10), (30, 15))
    for kw in (dict(rand_crop=True, rand_mirror=True, resize=16),
               dict(rand_resize=True, rand_crop=True, brightness=0.1,
                    contrast=0.1, saturation=0.1, hue=0.1, pca_noise=0.1,
                    rand_gray=0.2, mean=True, std=True)):
        assert [a.dumps() for a in tim.CreateAugmenter((3, 8, 8), **kw)] \
            == [a.dumps() for a in jim.CreateAugmenter((3, 8, 8), **kw)]


def _iter_batches(it):
    """An epoch's batches, to its end: a batch still building on the
    iterator's thread would draw from `random` during the next run."""
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


@pytest.mark.parametrize("case", ["center", "random_one_a_batch",
                                  "record_iter", "imglist"])
def test_image_iter_equals_reference(case, tmp_path):
    imgs = _images(7, 16, 18)
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    _write_rec(trec, idx, rec, imgs)
    if case == "imglist":
        lst = []
        for i, img in enumerate(imgs):
            onp.save(tmp_path / f"{i}.npy", img)
            with open(tmp_path / f"{i}.npy", "rb") as f:
                (tmp_path / f"{i}.img").write_bytes(f.read())
            lst.append((float(i), f"{i}.img"))

    def make(pkg_io, pkg_img, **kw):
        if case == "record_iter":
            return pkg_io.ImageRecordIter(path_imgrec=rec,
                                          data_shape=(3, 12, 12),
                                          batch_size=1, shuffle=True,
                                          rand_crop=True, resize=14,
                                          prefetch_buffer=2, **kw)
        if case == "imglist":
            return pkg_img.ImageIter(3, (3, 12, 12), imglist=lst,
                                     path_root=str(tmp_path),
                                     last_batch_handle="discard", **kw)
        rand = case == "random_one_a_batch"
        augs = pkg_img.CreateAugmenter((3, 12, 12), rand_crop=rand,
                                       rand_mirror=rand)
        return pkg_img.ImageIter(1 if rand else 3, (3, 12, 12),
                                 path_imgrec=rec, shuffle=True,
                                 aug_list=augs, **kw)

    def run(pkg_io, pkg_img, **kw):
        random.seed(0)
        onp.random.seed(0)
        it = make(pkg_io, pkg_img, **kw)
        out = _iter_batches(it)
        it.reset()
        return out + _iter_batches(it)

    want = run(jio, jim)
    calls = _native.native_calls
    with tmx.cpu():
        got = run(tio, tim)
    assert (_native.native_calls > calls) == (case != "imglist")
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gd.dtype == wd.dtype and gd.shape == wd.shape
        onp.testing.assert_array_equal(gd, wd)
        onp.testing.assert_array_equal(gl, wl)
        assert gp == wp


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

def _io_batches(it):
    return [([d.asnumpy() for d in b.data], [l.asnumpy() for l in b.label],
             b.pad) for b in it]


def _same_io(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            assert a.dtype == b.dtype
            onp.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_equals_reference(handle):
    r = onp.random.RandomState(0)
    x = r.normal(size=(10, 3)).astype("float32")
    y = r.randint(0, 4, 10).astype("float32")

    def run(pkg, mk):
        onp.random.seed(2)
        it = pkg.NDArrayIter(mk(x), mk(y), batch_size=4, shuffle=True,
                             last_batch_handle=handle)
        out = _io_batches(it)
        it.reset()
        descs = [(d.name, d.shape, d.dtype) for d in it.provide_data]
        return out + _io_batches(pkg.ResizeIter(it, 5)), descs

    want = run(jio, jmx.np.array)
    with tmx.cpu():
        got = run(tio, tmx.np.array)
    _same_io(got[0], want[0])
    assert got[1] == want[1]


def test_csv_libsvm_and_mnist_iters_equal_reference(tmp_path):
    r = onp.random.RandomState(0)
    x = r.normal(size=(7, 6)).astype("float32")
    onp.savetxt(tmp_path / "d.csv", x, delimiter=",")
    onp.savetxt(tmp_path / "l.csv", r.randint(0, 3, (7, 1)), delimiter=",")
    with open(tmp_path / "s.libsvm", "w") as f:
        for i in range(7):
            f.write(f"{i % 2} 0:{x[i, 0]} 3:{x[i, 3]} 5:1.5\n")
    imgs = r.randint(0, 256, (9, 4, 4)).astype("uint8")
    with gzip.open(tmp_path / "img.gz", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 3) + struct.pack(">III", 9, 4, 4)
                + imgs.tobytes())
    with gzip.open(tmp_path / "lab.gz", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 1) + struct.pack(">I", 9)
                + r.randint(0, 10, 9).astype("uint8").tobytes())

    def run(pkg):
        out = _io_batches(pkg.CSVIter(str(tmp_path / "d.csv"), (2, 3),
                                      label_csv=str(tmp_path / "l.csv"),
                                      batch_size=3))
        out += _io_batches(pkg.LibSVMIter(str(tmp_path / "s.libsvm"), (6,),
                                          batch_size=4, round_batch=False))
        out += _io_batches(pkg.MNISTIter(str(tmp_path / "img.gz"),
                                         str(tmp_path / "lab.gz"),
                                         batch_size=4, shuffle=True, seed=3,
                                         flat=True))
        return out

    want = run(jio)
    with tmx.cpu():
        got = run(tio)
    _same_io(got, want)
    from incubator_mxnet_tpu_torch.base import MXNetError

    with tmx.cpu(), pytest.raises(MXNetError, match="11b"):
        tio.LibSVMIter(str(tmp_path / "s.libsvm"), (6,)).to_csr()


# ---------------------------------------------------------------------------
# callback and model
# ---------------------------------------------------------------------------

def test_model_checkpoint_and_callbacks(tmp_path, caplog):
    import logging

    from incubator_mxnet_tpu_torch import callback, model
    from incubator_mxnet_tpu_torch.base import MXNetError

    prefix = str(tmp_path / "m")
    w = onp.arange(6, dtype="float32").reshape(2, 3)
    with tmx.cpu():
        cb = callback.do_checkpoint(prefix, period=2)
        cb(0, None, {"w": tmx.np.array(w)}, {"s": tmx.np.ones(2)})
        assert not os.path.exists(prefix + "-0001.params")
        cb(1, None, {"w": tmx.np.array(w)}, {"s": tmx.np.ones(2)})
        sym, arg, aux = model.load_checkpoint(prefix, 2)
        assert sym is None
        onp.testing.assert_array_equal(arg["w"].asnumpy(), w)
        onp.testing.assert_array_equal(aux["s"].asnumpy(), onp.ones(2))
        with pytest.raises(MXNetError, match="11b"):
            model.save_checkpoint(prefix, 3, object(), {})
    metric = tmx.gluon.metric.Accuracy()
    metric.update([onp.array([1, 0])], [onp.array([[0.1, 0.9], [0.3, 0.2]])])
    caplog.set_level(logging.INFO)
    speed = callback.Speedometer(batch_size=4, frequent=2)
    for nb in range(5):
        speed(model.BatchEndParam(0, nb, metric, None))
    callback.log_train_metric(2)(model.BatchEndParam(0, 2, metric, None))
    callback.ProgressBar(10)(model.BatchEndParam(0, 5, metric, None))
    assert "samples/sec" in caplog.text and "Train-accuracy" in caplog.text
    assert model.BatchEndParam._fields == \
        jmx.model.BatchEndParam._fields
