"""Gluon Trainer (port of `incubator_mxnet_tpu/gluon/trainer.py`
`Trainer` :15: `step` :83, `allreduce_grads` :91, `update` :113,
`_update` :119, `save_states`/`load_states` :137).

``kvstore`` is the reference's (a type string for `kvstore.create`, a
store, or None), made at the first step: `allreduce_grads` pushpulls each
gradient through it, so "dist_sync" sums the gradients across the
processes of a `torch.distributed` world (`parallel.dist`), and
``compression_params`` compress the push leg (`kvstore.compression`).
On a one-process store ("device", "local") without compression the
pushpull is the identity, and the step skips it. Parameters are indexed in
name order, as the reference sorts its dict, so the per-index optimizer
state lines up with the reference's. A parameter's gradient is its
tensor's ``.grad`` (`gluon.parameter`): one a backward never reached is
None and the parameter is skipped, with or without
``ignore_stale_grad`` (the reference's `_update` skips a parameter
without a gradient either way too). ``_scale`` (1.0 until
`amp.scale_loss` folds 1 / loss scale into it, and again after
`amp.unscale`) multiplies into the optimizer's ``rescale_grad`` at every
step, as in the reference (:30, :87, :116). The optimizer updates each
parameter's tensor in place. With ``multi_precision`` a float16
parameter's state is ``(f32 master, inner state)`` (`Optimizer.
create_state_multi_precision`), and `save_states`/`load_states` write
and read it in the reference's layout, ``("mp", master, [inner...])``,
so either package reads the other's file.
"""
from __future__ import annotations

import pickle

import numpy as onp
import torch

from .. import optimizer as opt_mod
from ..base import MXNetError

__all__ = ["Trainer"]



class Trainer:
    """Applies an optimizer to a set of Parameters.

    ``params``: ``block.collect_params()`` (a dict of name → Parameter) or
    a list of Parameters; ``optimizer``: an :class:`~..optimizer.Optimizer`
    or its registered name, made with ``optimizer_params``."""

    def __init__(self, params, optimizer, optimizer_params=None, kvstore="device",
                 compression_params=None, update_on_kvstore=None):
        from .parameter import Parameter

        if isinstance(params, dict):
            param_dict = dict(params)
        else:
            params = list(params)
            if params and not all(isinstance(p, Parameter) for p in params):
                raise TypeError("Trainer takes collect_params() or a list of "
                                "gluon Parameters")
            param_dict = {getattr(p, "name", str(i)): p
                          for i, p in enumerate(params)}
        self._params = []
        self._params_by_name = {}
        for name, p in sorted(param_dict.items()):
            p.name = name
            self._params.append(p)
            self._params_by_name[name] = p
        self._scale = 1.0
        optimizer_params = optimizer_params or {}
        if isinstance(optimizer, opt_mod.Optimizer):
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = {p.name: p for p in self._params}
        self._states = [None] * len(self._params)
        self._states_initialized = [False] * len(self._params)
        self._compression_params = compression_params
        self._kvstore = None
        self._kvstore_type = kvstore
        self._update_on_kvstore = bool(update_on_kvstore)
        self._kv_initialized = False

    # -- kvstore (reference: trainer.py:54) ----------------------------------
    def _init_kvstore(self):
        from .. import kvstore as kv_mod

        if self._kvstore_type is None:
            self._kvstore = None
        elif isinstance(self._kvstore_type, str):
            self._kvstore = kv_mod.create(self._kvstore_type)
        else:
            self._kvstore = self._kvstore_type
        if self._kvstore is not None and self._compression_params:
            if not hasattr(self._kvstore, "set_gradient_compression"):
                raise ValueError(
                    f"kvstore {type(self._kvstore).__name__} does not "
                    "support gradient compression")
            self._kvstore.set_gradient_compression(self._compression_params)
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # -- step ---------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by ``_scale``/batch_size, reduce them through
        the kvstore and apply the optimizer."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        from ..kvstore.horovod import Horovod
        from ..kvstore.kvstore import KVStoreDevice, KVStoreLocal
        from ..ndarray.ndarray import NDArray

        kv = self._kvstore
        if kv is None or (isinstance(kv, (KVStoreDevice, KVStoreLocal))
                          and not isinstance(kv, Horovod)
                          and getattr(kv, "_compression", None) is None):
            return   # the identity reduce
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None:
                continue
            t = p._data._data
            if t.grad is None:
                continue
            g = NDArray(t.grad.detach())
            kv.pushpull(i, g, out=g)
            t.grad.copy_(g._data)

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):  # noqa: ARG002
        opt = self._optimizer
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None:
                continue
            t = p._data._data
            if t.grad is None:
                continue
            if not self._states_initialized[i]:
                self._states[i] = opt.create_state_multi_precision(i, t)
                self._states_initialized[i] = True
            opt.idx2name[i] = p.name
            opt.update_multi_precision(i, p._data, t.grad, self._states[i])

    # -- checkpointing (reference: trainer.py:137,170) ----------------------
    def save_states(self, fname):
        """The optimizer states (and the update counts that drive the bias
        corrections) in the reference's pickle layout, written crash-safe
        with a checksum sidecar."""
        from .. import preemption

        def host(x):
            return x.detach().cpu().numpy()

        payload = []
        for s in self._states:
            if s is None:
                payload.append(None)
            elif isinstance(s, list):
                payload.append([host(x) for x in s])
            elif isinstance(s, tuple):
                payload.append(("mp", host(s[0]),
                                [host(x) for x in (s[1] or [])]))
            else:
                payload.append(host(s))
        blob = {"states": payload,
                "num_update": self._optimizer.num_update,
                "index_update_count":
                    dict(self._optimizer._index_update_count)}

        def _write(tmp):
            with open(tmp, "wb") as f:
                pickle.dump(blob, f)

        preemption.atomic_save(fname, _write)

    def load_states(self, fname):
        from .. import preemption

        if preemption.verify_checkpoint(fname) is False:
            raise MXNetError(
                f"trainer state file {fname} failed checksum validation "
                "(truncated or corrupt)")
        with open(fname, "rb") as f:
            payload = pickle.load(f)

        def load(x, i):
            p = self._params[i] if i < len(self._params) else None
            dev = p._data._data.device if p is not None and \
                p._data is not None else torch.device("cpu")
            return torch.from_numpy(onp.array(x)).to(dev)

        states = []
        for i, s in enumerate(payload["states"]):
            if s is None:
                states.append(None)
            elif isinstance(s, list):
                states.append([load(x, i) for x in s])
            elif isinstance(s, tuple) and len(s) == 3 and s[0] == "mp":
                states.append((load(s[1], i), [load(x, i) for x in s[2]]))
            else:
                states.append(load(s, i))
        self._states = states
        self._states_initialized = [s is not None for s in states]
        self._optimizer.num_update = payload.get("num_update", 0)
        self._optimizer._index_update_count = dict(
            payload.get("index_update_count", {}))
