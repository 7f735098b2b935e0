"""Parameter helpers the port's models share: seeded initialisation and
loading weights named as the reference model's ``collect_params()``."""
from __future__ import annotations

import numpy as onp
import torch

from ..base import MXNetError
from .decoding import make_generator

__all__ = ["initialize", "load_params"]


def initialize(model, device, seed=None, normal=()):
    """(Re)initialise every parameter of ``model`` from a generator on
    ``device`` seeded by ``seed`` (a fresh nondeterministic seed when
    None): each submodule's ``reset_parameters``, then the parameters in
    ``normal`` (the position embeddings) from N(0, 0.01), as the
    reference's ``init="normal"``."""
    gen = make_generator(device, seed)
    for mod in model.modules():
        if mod is not model and hasattr(mod, "reset_parameters"):
            mod.reset_parameters(generator=gen)
    with torch.no_grad():
        for p in normal:
            p.normal_(0.0, 0.01, generator=gen)


def load_params(model, params):
    """Copy weights into ``model`` from ``{name: numpy array}`` keyed by
    the reference model's ``collect_params()`` names, which the port's
    ``named_parameters()`` match one to one. Raises, copying nothing, on a
    missing or extra name or a wrong shape."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise MXNetError(f"load_jax_params: missing {missing}, "
                         f"unexpected {extra}")
    arrays = {}
    for name, arr in params.items():
        arr = onp.array(arr, copy=True)
        if tuple(arr.shape) != tuple(own[name].shape):
            raise MXNetError(
                f"load_jax_params: {name} has shape {arr.shape}, the "
                f"model expects {tuple(own[name].shape)}")
        arrays[name] = arr
    with torch.no_grad():
        for name, arr in arrays.items():
            own[name].copy_(torch.from_numpy(arr))
