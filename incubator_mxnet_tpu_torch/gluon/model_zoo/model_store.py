"""Pretrained-weight store (port of `incubator_mxnet_tpu/gluon/model_zoo/
model_store.py`; reference: `python/mxnet/gluon/model_zoo/model_store.py`).

Local only, as the reference's: nothing downloads. A name resolves in
``MXNET_GLUON_REPO`` (a local directory), ``$MXNET_HOME/models`` (or
``~/.incubator_mxnet_tpu/models``), each directory on
``INCUBATOR_MXNET_TPU_MODEL_PATH``, then the packaged ``_store`` (the two
trained vision artifacts, ``mobilenet0.25_digits`` and
``mobilenetv2_0.25_digits``, and the character LM ``lstm_charlm_tiny``
for `gluon.rnn`: the reference's own files). Each root's
``registry.json`` holds the sha1 of its files, checked at lookup; a
missing file raises ``FileNotFoundError`` as in the reference. The files
are npz, which `Block.load_parameters` reads.
"""
from __future__ import annotations

import hashlib
import json
import os

__all__ = ["get_model_file", "purge", "data_dir", "register_sha1",
           "export_to_store", "short_hash"]

# Each store root carries its own registry.json mapping name -> sha1 of the
# .params payload. Registries are root-scoped on disk AND in use — a sha
# registered in one root must not constrain lookups in another. (The
# reference ships a hardcoded table for its S3 assets.)


def data_dir():
    return os.environ.get(
        "MXNET_HOME",
        os.path.join(os.path.expanduser("~"), ".incubator_mxnet_tpu"))


def _registry_path(root):
    return os.path.join(root, "registry.json")


def _load_registry(root) -> dict:
    path = _registry_path(root)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save_registry(root, registry):
    os.makedirs(root, exist_ok=True)
    with open(_registry_path(root), "w") as f:
        json.dump(registry, f, indent=2, sort_keys=True)


def short_hash(name, root=None):
    for r in _search_roots(root):
        reg = _load_registry(r)
        if name in reg:
            return reg[name][:8]
    raise ValueError(f"pretrained model for {name} is not available")


def _sha1(path):
    h = hashlib.sha1()  # noqa: S324 — content checksum, not security
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _search_roots(root=None):
    roots = [root] if root else []
    # MXNET_GLUON_REPO (env_var.md): override the artifact root — here a
    # local directory (no egress) searched before the default caches
    repo = os.environ.get("MXNET_GLUON_REPO", "")
    if repo and "://" not in repo:
        roots.append(repo)
    roots.append(os.path.join(data_dir(), "models"))
    extra = os.environ.get("INCUBATOR_MXNET_TPU_MODEL_PATH", "")
    roots += [p for p in extra.split(os.pathsep) if p]
    # packaged store: small trained artifacts committed WITH the framework
    # (the no-egress stand-in for the reference's S3 model repo; also the
    # cross-version load-compatibility anchor,
    # `tests/nightly/model_backwards_compatibility_check/`)
    roots.append(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "_store"))
    return roots


def get_model_file(name, root=None):
    """Locate (and checksum-verify) `<name>.params` in the local store
    (reference: model_store.py:75 downloads+verifies; here: local-only,
    no egress). Checksums apply per root: a file is verified only against
    the registry of the root it was found in."""
    for r in _search_roots(root):
        reg = _load_registry(r)
        want = reg.get(name)
        candidates = []
        if want:
            candidates.append(f"{name}-{want[:8]}.params")
        candidates.append(f"{name}.params")
        for fname in candidates:
            path = os.path.join(r, fname)
            if os.path.exists(path):
                if want and _sha1(path) != want:
                    raise ValueError(
                        f"checksum mismatch for {path}; delete the file and "
                        "re-export it")
                return path
    raise FileNotFoundError(
        f"pretrained weights for {name!r} not found in "
        f"{_search_roots(root)}; this build has no network egress — place "
        f"{name}.params there or train locally and call export_to_store")


def register_sha1(name, sha1_hash, root=None):
    """Register a checksum for `name` in `root`'s registry."""
    root = root or os.path.join(data_dir(), "models")
    registry = _load_registry(root)
    registry[name] = sha1_hash
    _save_registry(root, registry)


def export_to_store(net, name, root=None):
    """Save a trained net's parameters into the store under `name` and
    register the checksum, making `pretrained=True` loads work offline."""
    root = root or os.path.join(data_dir(), "models")
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f"{name}.params.tmp")
    net.save_parameters(tmp)
    sha = _sha1(tmp)
    final = os.path.join(root, f"{name}-{sha[:8]}.params")
    os.replace(tmp, final)
    register_sha1(name, sha, root)
    return final


def purge(root=None):
    """Delete cached model files (reference: model_store.py:129)."""
    root = root or os.path.join(data_dir(), "models")
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
