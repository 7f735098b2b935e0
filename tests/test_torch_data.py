"""`gluon.data` of the port against the JAX package's, on the CPU: the
samplers' orders, the DataLoader's batches (no workers, two worker
processes, the ``thread_pool=True`` variant, every ``last_batch`` mode,
leaves large enough to cross in shared memory), its worker-task retry,
the synthetic vision datasets, every vision transform, and the
composable vision loader.

The reference is the oracle under the same numpy seed (the samplers draw
``numpy.random``) and the same Python ``random`` seed (the random
transforms). Tolerances: samplers, loader batches and datasets bit for
bit (host code on the same arrays); a float transform 1e-5 relative of
its largest magnitude (float32, the reference's XLA reductions and
resize contractions against numpy's); a resized uint8 image one level
(the same float32 value, truncated, may sit either side of an integer).
"""
import random

import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon import data as jdata
from incubator_mxnet_tpu.gluon.data.vision import transforms as jtf
from incubator_mxnet_tpu_torch.gluon import data as tdata
from incubator_mxnet_tpu_torch.gluon.data.vision import transforms as ttf

N = 23
FLOAT_REL = 1e-5


def _arrays(rows=N, width=5):
    r = onp.random.RandomState(0)
    x = r.normal(size=(rows, width)).astype("float32")
    y = r.randint(0, 7, rows).astype("int32")
    return x, y


def _host(batch):
    if isinstance(batch, (tuple, list)):
        return tuple(_host(b) for b in batch)
    return batch.asnumpy()


def _epoch(loader, seed):
    onp.random.seed(seed)
    return [_host(b) for b in loader]


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            onp.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_batch_sampler_orders_equal_reference(last_batch):
    def run(pkg):
        onp.random.seed(5)
        s = pkg.BatchSampler(pkg.RandomSampler(N), 4, last_batch)
        return [list(map(list, s)) for _ in range(3)], len(s)

    assert run(tdata) == run(jdata)


def test_sequential_filter_and_elastic_samplers_equal_reference():
    ds = list(range(N))
    got = [(list(pkg.SequentialSampler(7, start=3)),
            list(pkg.FilterSampler(lambda v: v % 3 == 0, ds)))
           for pkg in (tdata, jdata)]
    assert got[0] == got[1]

    def elastic(pkg):
        s = pkg.ElasticSampler(N, num_shards=3, index=1, shuffle=True,
                               seed=11)
        it = iter(s)
        head = [next(it) for _ in range(3)]
        s.reshard(2, 0)
        rest = list(s)
        return head, rest, s.remaining(), len(s)

    assert elastic(tdata) == elastic(jdata)


# ---------------------------------------------------------------------------
# DataLoader
# ---------------------------------------------------------------------------

def _loaders(pkg, x, y, **kw):
    return pkg.DataLoader(pkg.ArrayDataset(x, y), **kw)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_without_workers_equals_reference(last_batch, shuffle):
    x, y = _arrays()
    kw = dict(batch_size=4, shuffle=shuffle, last_batch=last_batch,
              num_workers=0)
    with tmx.cpu():
        got = _epoch(_loaders(tdata, x, y, **kw), 3)
    _same_batches(got, _epoch(_loaders(jdata, x, y, **kw), 3))


@pytest.mark.parametrize("case", ["workers", "thread_pool", "shm"])
def test_loader_with_workers_equals_reference(case):
    """Two worker processes (or two threads) produce the same batches in
    the same order as the reference's loader; with rows of 64 KiB a
    16-row batch (1 MiB) crosses in shared memory; the epoch runs twice
    through one pool."""
    width = 16384 if case == "shm" else 5
    x, y = _arrays(width=width)
    kw = dict(batch_size=16 if case == "shm" else 4, shuffle=True,
              last_batch="keep")
    want = [_epoch(_loaders(jdata, x, y, num_workers=0, **kw), s)
            for s in (7, 8)]
    with tmx.cpu():
        loader = _loaders(tdata, x, y, num_workers=2,
                          thread_pool=case == "thread_pool", **kw)
        got = [_epoch(loader, s) for s in (7, 8)]
    for g, w in zip(got, want):
        _same_batches(g, w)
    if case == "shm":
        assert x[:16].nbytes >= tdata.dataloader._SHM_MIN_BYTES


def test_loader_batchify_dtypes_and_pad_equal_reference():
    """Float64 and int64 leaves land in the reference's x64-off dtypes;
    `Pad` and `Group` batchify ragged samples alike."""
    seqs = [onp.arange(n, dtype="int64") for n in (3, 1, 4, 2)]
    labels = onp.linspace(0, 1, 4)              # float64
    fn = (tdata.batchify.Group(tdata.batchify.Pad(val=-1),
                               tdata.batchify.Stack()),
          jdata.batchify.Group(jdata.batchify.Pad(val=-1),
                               jdata.batchify.Stack()))
    with tmx.cpu():
        got = [_host(b) for b in tdata.DataLoader(
            tdata.ArrayDataset(seqs, labels), batch_size=2,
            batchify_fn=fn[0])]
    want = [_host(b) for b in jdata.DataLoader(
        jdata.ArrayDataset(seqs, labels), batch_size=2, batchify_fn=fn[1])]
    _same_batches(got, want)


def test_loader_retries_a_failed_task_and_keeps_the_order():
    """A worker task that raises (the ``dataloader_worker`` chaos seam,
    armed for one firing) is resubmitted at the front of the queue: the
    batches and their order are the reference's, and the retry is
    counted."""
    from incubator_mxnet_tpu_torch.fault import injection
    from incubator_mxnet_tpu_torch.telemetry import registry

    x, y = _arrays()
    before = registry.counter("mx_retries_total").value
    injection.configure_injection("dataloader_worker:1.0:0:1")
    try:
        with tmx.cpu():
            got = _epoch(_loaders(tdata, x, y, batch_size=4, shuffle=True,
                                  num_workers=2, thread_pool=True), 9)
    finally:
        injection.clear_injection()
    _same_batches(got, _epoch(_loaders(jdata, x, y, batch_size=4,
                                       shuffle=True), 9))
    assert registry.counter("mx_retries_total").value == before + 1


def test_loader_uploads_to_the_current_device_and_pins_only_for_the_card():
    x, y = _arrays()
    with tmx.cpu():
        b = next(iter(_loaders(tdata, x, y, batch_size=4, pin_memory=True)))
    assert all(a.device.device_type == "cpu" for a in b)
    assert str(b[0].dtype) == "float32" and str(b[1].dtype) == "int32"


# ---------------------------------------------------------------------------
# vision datasets and transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10",
                                  "CIFAR100"])
def test_synthetic_vision_datasets_equal_reference(name, tmp_path):
    t = getattr(tdata.vision, name)(root=str(tmp_path), train=False)
    j = getattr(jdata.vision, name)(root=str(tmp_path), train=False)
    assert len(t) == len(j)
    for i in (0, 17, len(j) - 1):
        (tx, ty), (jx, jy) = t[i], j[i]
        assert ty == jy and tx.device.device_type == "cpu"
        onp.testing.assert_array_equal(tx.asnumpy(), jx.asnumpy())


def _image(dtype, shape=(12, 16, 3), seed=1):
    r = onp.random.RandomState(seed)
    if dtype == "uint8":
        return r.randint(0, 256, shape).astype("uint8")
    return r.uniform(0, 255, shape).astype("float32")


TRANSFORMS = [
    ("ToTensor", lambda m: m.ToTensor(), "uint8"),
    ("ToTensor_batch", lambda m: m.ToTensor(), "uint8_batch"),
    ("Normalize", lambda m: m.Normalize((0.5, 0.4, 0.3), (0.2, 0.25, 0.3)),
     "chw"),
    ("Cast", lambda m: m.Cast("float16"), "float32"),
    ("Resize_down", lambda m: m.Resize((7, 5)), "float32"),
    ("Resize_up", lambda m: m.Resize((24, 20)), "float32"),
    ("Resize_keep_ratio", lambda m: m.Resize(6, keep_ratio=True), "float32"),
    ("Resize_uint8", lambda m: m.Resize((9, 7)), "uint8"),
    ("CenterCrop", lambda m: m.CenterCrop((8, 6)), "float32"),
    ("CenterCrop_resize", lambda m: m.CenterCrop(20), "float32"),
    ("CropResize", lambda m: m.CropResize(2, 3, 8, 6, size=(5, 4)),
     "float32"),
    ("RandomResizedCrop", lambda m: m.RandomResizedCrop(6), "float32"),
    ("RandomFlipLeftRight", lambda m: m.RandomFlipLeftRight(), "float32"),
    ("RandomFlipTopBottom", lambda m: m.RandomFlipTopBottom(), "float32"),
    ("RandomBrightness", lambda m: m.RandomBrightness(0.3), "uint8"),
    ("RandomContrast", lambda m: m.RandomContrast(0.3), "float32"),
    ("RandomSaturation", lambda m: m.RandomSaturation(0.3), "uint8"),
    ("RandomCrop", lambda m: m.RandomCrop((9, 7)), "float32"),
    ("RandomCrop_pad", lambda m: m.RandomCrop(14, pad=(1, 2, 3, 1)),
     "float32"),
    ("Compose", lambda m: m.Compose([m.Resize((10, 8)),
                                     m.RandomFlipLeftRight(),
                                     m.ToTensor(),
                                     m.Normalize(0.5, 0.25)]), "uint8"),
]


def _transform_input(kind):
    if kind == "uint8_batch":
        return _image("uint8", (2, 12, 16, 3))
    if kind == "chw":
        return _image("float32", (3, 12, 16)) / 255.0
    return _image(kind)


@pytest.mark.parametrize("name,make,kind", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_transform_equals_reference(name, make, kind):
    src = _transform_input(kind)
    for seed in (0, 1, 2):
        random.seed(seed)
        want = make(jtf)(jmx.np.array(src)).asnumpy()
        random.seed(seed)
        with tmx.cpu():
            out = make(ttf)(tmx.np.array(src))
        got = out.asnumpy()
        assert out.device.device_type == "cpu"
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if got.dtype == onp.uint8:
            assert onp.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            tol = FLOAT_REL * max(float(onp.abs(want).max()), 1e-30)
            onp.testing.assert_allclose(got.astype("float64"),
                                        want.astype("float64"), rtol=0,
                                        atol=tol, err_msg=name)


def test_dataset_transform_first_through_the_loader_equals_reference():
    """A uint8 image dataset through `transform_first(ToTensor)` and a
    two-worker loader: the uploaded batch is the reference's."""
    imgs = _image("uint8", (10, 8, 6, 3))
    labels = onp.arange(10, dtype="int32")
    want = [_host(b) for b in jdata.DataLoader(
        jdata.ArrayDataset(imgs, labels).transform_first(jtf.ToTensor()),
        batch_size=5)]
    with tmx.cpu():
        ds = tdata.ArrayDataset(imgs, labels).transform_first(ttf.ToTensor())
        got = [_host(b) for b in tdata.DataLoader(ds, batch_size=5,
                                                   num_workers=2)]
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-7)
        onp.testing.assert_array_equal(g[1], w[1])


def test_create_image_augment_composes_as_the_reference():
    from incubator_mxnet_tpu.gluon.contrib.data.vision import \
        create_image_augment as jaug
    from incubator_mxnet_tpu_torch.gluon.contrib.data.vision import \
        create_image_augment as taug

    src = _image("uint8", (20, 24, 3))
    for kw in (dict(rand_crop=True, rand_mirror=True),
               dict(resize=16), dict(rand_resize=True, brightness=0.2,
                                     mean=(0.5, 0.5, 0.5),
                                     std=(0.2, 0.2, 0.2))):
        ja, ta = jaug((3, 10, 12), **kw), taug((3, 10, 12), **kw)
        assert [type(b).__name__ for b in ta._children.values()] == \
            [type(b).__name__ for b in ja._children.values()]
        random.seed(4)
        want = ja(jmx.np.array(src)).asnumpy()
        random.seed(4)
        with tmx.cpu():
            got = ta(tmx.np.array(src)).asnumpy()
        # a resize of the uint8 image may land one level apart (see the
        # module docstring), which ToTensor makes 1/255
        onp.testing.assert_allclose(got, want, rtol=0, atol=1 / 255 + 1e-6)
        assert (onp.abs(got - want) > 1e-6).mean() < 0.01
