"""Parameter helpers the port's models share: initialisation from a seed
and loading weights named as the reference model's ``collect_params()``."""
from __future__ import annotations

import numpy as onp

from ..base import MXNetError
from ..initializer import generator_scope
from .decoding import make_generator

__all__ = ["init_seeded", "load_params"]


def init_seeded(model, seed):
    """(Re)initialise every parameter of ``model`` by its initializer from
    one generator on the model's device seeded by ``seed``: the modules in
    order, each one's parameters in order, the ``init="normal"`` ones (the
    position embeddings) last. The draws (and so the weights a seed gives)
    are those of the port's models before they were gluon Blocks."""
    names = {id(p): n for n, p in model.collect_params().items()}
    first, last = [], []
    for mod in model.modules():
        for p in getattr(mod, "_reg_params", {}).values():
            (last if p.init == "normal" else first).append(p)
    with generator_scope(make_generator(model.device, seed)):
        for p in first + last:
            p.name = names[id(p)]
            p.initialize(force_reinit=True)


def _fits(shape, want):
    """Whether an array of ``shape`` fits a parameter of shape ``want``,
    whose unknown (deferred, 0) sizes take any size."""
    return want is not None and len(shape) == len(want) and all(
        w in (0, s) for s, w in zip(shape, want))


def load_params(model, params):
    """Copy weights into ``model`` from ``{name: numpy array}`` keyed by
    the reference model's ``collect_params()`` names (`set_data`: into
    the existing tensors), running statistics included. A parameter whose
    shape is still deferred (a vision net before its first call) takes
    the array's. Raises, copying nothing, on a missing or extra name or
    a wrong shape."""
    own = model.collect_params()
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise MXNetError(f"load_jax_params: missing {missing}, "
                         f"unexpected {extra}")
    arrays = {}
    for name, arr in params.items():
        arr = onp.array(arr, copy=True)
        if not _fits(tuple(arr.shape), own[name].shape):
            raise MXNetError(
                f"load_jax_params: {name} has shape {arr.shape}, the "
                f"model expects {tuple(own[name].shape)}")
        arrays[name] = arr
    for name, arr in arrays.items():
        own[name].set_data(arr)
