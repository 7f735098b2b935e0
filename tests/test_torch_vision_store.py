"""The port's model store and its packaged trained weights: the
``mobilenet0.25_digits`` and ``mobilenetv2_0.25_digits`` files are the
reference's own (the same sha1 as its registry's), they load into both
packages' nets, ``mobilenet0.25_digits``'s logits on the first 32
held-out digits agree (1e-4 of the largest, as `test_torch_vision_zoo`),
and the port classifies
the whole held-out split (`tools/train_store_artifacts.py` `_digits`) at
0.90 or better. Nothing downloads: a name with no file raises, as in
the reference, and a corrupted file fails its checksum."""
import importlib.util
import os
import shutil

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon.model_zoo import model_store as jstore
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu_torch.gluon.model_zoo import model_store as tstore
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from test_torch_vision_ops import _close

ARTIFACTS = {"mobilenet0.25_digits": "mobilenet0_25",
             "mobilenetv2_0.25_digits": "mobilenet_v2_0_25"}


def _held_out():
    pytest.importorskip("sklearn.datasets")
    tool = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "train_store_artifacts.py")
    spec = importlib.util.spec_from_file_location("_train_artifacts", tool)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    (_, _), (xte, yte) = mod._digits()
    return xte, yte


def test_packaged_files_are_the_references():
    for name in ARTIFACTS:
        path = tstore.get_model_file(name)
        assert os.path.dirname(path).endswith(os.path.join("model_zoo",
                                                           "_store"))
        ref = jstore.get_model_file(name)
        assert tstore._sha1(path) == jstore._sha1(ref)  # noqa: SLF001
        assert tstore.short_hash(name) == jstore.short_hash(name)


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_trained_weights_classify_digits(name):
    """The port's accuracy on the whole held-out split; for
    ``mobilenet0.25_digits`` also the reference's logits on the first 32
    (MobileNet V2's logits are held in `test_torch_vision_zoo_more`)."""
    xte, yte = _held_out()
    make = ARTIFACTS[name]
    with tmx.cpu():
        tnet = getattr(tvision, make)(classes=10)
        tnet.load_parameters(tstore.get_model_file(name))
        with torch.no_grad():
            logits = tnet(torch.from_numpy(xte)).numpy()
    if name == "mobilenet0.25_digits":
        jnet = getattr(jvision, make)(classes=10)
        jnet.load_parameters(jstore.get_model_file(name))
        want = jnet(jmx.np.array(xte[:32])).asnumpy()
        _close(logits[:32], want, 1e-4, name)
    acc = float((onp.argmax(logits, axis=1) == yte).mean())
    assert acc >= 0.90, (name, acc)


def test_pretrained_resolves_through_get_model(tmp_path, monkeypatch):
    """``pretrained=True`` loads from a store root (the packaged file
    copied under the name the constructor asks for), onto ``device``."""
    src = tstore.get_model_file("mobilenet0.25_digits")
    shutil.copy(src, tmp_path / "mobilenet0.25.params")
    monkeypatch.setenv("MXNET_HOME", str(tmp_path / "home"))
    net = tvision.get_model("mobilenet0.25", pretrained=True, classes=10,
                            root=str(tmp_path), device=tmx.cpu())
    w = net.collect_params()["output.weight"].data().asnumpy()
    assert w.shape == (10, 256)
    with onp.load(src) as z:
        onp.testing.assert_array_equal(w, z["output.weight"])


def test_missing_and_corrupt_files_raise(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_HOME", str(tmp_path / "home"))
    with pytest.raises(FileNotFoundError):
        tstore.get_model_file("resnet50_v1")
    with pytest.raises(FileNotFoundError):
        tvision.resnet18_v1(pretrained=True)
    charlm = tstore.get_model_file("lstm_charlm_tiny")   # gluon.rnn's
    assert tstore._sha1(charlm) == \
        "1d0bb79f9ecf77a0c759803ff9fc83d7522d0b2f"  # noqa: SLF001
    src = tstore.get_model_file("mobilenet0.25_digits")
    root = str(tmp_path / "root")
    os.makedirs(root)
    dst = os.path.join(root, os.path.basename(src))
    shutil.copy(src, dst)
    tstore.register_sha1("mobilenet0.25_digits", tstore._sha1(src),  # noqa: SLF001
                         root=root)
    with open(dst, "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(ValueError, match="checksum"):
        tstore.get_model_file("mobilenet0.25_digits", root=root)
