"""Legacy model checkpoint helpers (port of `incubator_mxnet_tpu/model.py`;
reference: `python/mxnet/model.py:189` `save_checkpoint` / `:238`
`load_checkpoint` — symbol json + `.params` epoch files).

File layout matches the reference convention:
  <prefix>-symbol.json           the architecture (mx.sym JSON)
  <prefix>-%04d.params           arg/aux parameters for one epoch
Parameter names are prefixed "arg:"/"aux:" exactly as the reference does, so
`load_checkpoint` can split them back. The parameter files are
`nd.save`'s npz container, which either package reads. The symbol
(`mx.sym`) is `ROADMAP.md` §1 item 11b's: a call that has to write or
read one raises `MXNetError`; `symbol=None` saves the parameters alone,
and `load_checkpoint` of a prefix with no symbol file returns None for
it.
"""
from __future__ import annotations

import collections
import os

from .base import MXNetError
from .ndarray import load as nd_load
from .ndarray import save as nd_save
from .ndarray.ndarray import NDArray

__all__ = ["save_checkpoint", "load_params", "load_checkpoint",
           "BatchEndParam"]

BatchEndParam = collections.namedtuple(
    "BatchEndParam", ["epoch", "nbatch", "eval_metric", "locals"])

_SYMBOL = "the symbol graph (mx.sym) is ROADMAP.md §1 item 11b"


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params=None,
                    remove_amp_cast=True):  # noqa: ARG001
    """Save symbol + params for `epoch` (`model.py:189`)."""
    if symbol is not None:
        raise MXNetError(f"save_checkpoint(symbol=...): {_SYMBOL}; pass "
                         f"symbol=None to save the parameters alone")
    payload = {f"arg:{k}": v if isinstance(v, NDArray) else NDArray(v)
               for k, v in (arg_params or {}).items()}
    payload.update({f"aux:{k}": v if isinstance(v, NDArray) else NDArray(v)
                    for k, v in (aux_params or {}).items()})
    nd_save(f"{prefix}-{epoch:04d}.params", payload)


def load_params(prefix, epoch):
    """(arg_params, aux_params) from an epoch file (`model.py:221`)."""
    loaded = nd_load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        kind, _, name = k.partition(":")
        if kind == "arg":
            arg_params[name] = v
        elif kind == "aux":
            aux_params[name] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) (`model.py:238`)."""
    if os.path.exists(f"{prefix}-symbol.json"):
        raise MXNetError(f"load_checkpoint: {prefix}-symbol.json holds a "
                         f"symbol: {_SYMBOL}")
    arg_params, aux_params = load_params(prefix, epoch)
    return None, arg_params, aux_params
