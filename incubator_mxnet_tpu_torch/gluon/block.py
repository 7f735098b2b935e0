"""Gluon Block / HybridBlock (port of `incubator_mxnet_tpu/gluon/block.py`:
`Block` :35, `_CachedGraph` :279, `HybridBlock` :403).

A `Block` is a `torch.nn.Module`: its children are its submodules, and
each initialised `Parameter` registers its tensor under its attribute
name, so ``named_parameters()`` and ``collect_params()`` name the same
tensors the same way. A call takes the convention of its inputs (see
`gluon.parameter`): NDArrays in, NDArrays out, op by op through the
funnel; torch tensors in, tensors out, under torch's grad mode.

**hybridize.** The reference traces the forward into one jitted program a
(training mode, input signature). The port's program is a CUDA graph
(`_graphs`, the pattern `parallel.DataParallel` uses): a hybridized
block called with NDArrays runs the first call of a signature eagerly
(completing deferred initialisation), captures the second and replays
it, and later calls copy their inputs into the capture's buffers and
replay. Graphs are keyed by training mode x recording x AMP x input
signature. Under ``autograd.record()`` the call is one node of the graph,
as the reference records one tape node for the compiled call: the
forward and the backward are captured together, and the node's backward
replays the backward graph, giving the gradients of the inputs and of
every parameter (by its ``grad_req``). Each call draws a fresh key from
the key stream and writes it, with the call count, into the capture's
key buffer, which the dropout sites fold on the card
(`random.trace_key_scope`), as the reference hands a fresh ``next_key()``
to every compiled call (:344). A capture that fails raises
:class:`MXNetError`; nothing runs eagerly in its place. Outputs are the
call's own tensors (copies of the graph's output buffers). A call with
torch tensors (the port's own module path) runs eagerly. On a CPU block
a hybridized call runs eagerly with the same per-signature bookkeeping.
Auxiliary state (BatchNorm's running statistics) is written in place
inside the forward graph, so each call in training mode moves it once:
the eager calls, and each replay (the capture's warm-up puts back what
it wrote; the capture itself runs no kernel), where the reference
carries the functional updates out of its program (:380-397).
Each capture (on the CPU: each first call of a signature) is a
program-ledger entry ``cached_op:<BlockName>`` (`telemetry.compiles`,
`telemetry.registry.observe_compile`), as in the reference (:356-369).
"""
from __future__ import annotations

import re
import sys
import time
import zipfile
from collections import OrderedDict

import numpy as onp
import torch

from .. import _graphs
from .. import autograd
from .. import random as _random
from ..base import MXNetError
from ..ndarray.ndarray import NDArray, _wrap
from .parameter import (_CONV, DeferredInitializationError, Parameter,
                        ParameterDict)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

_ITEM11 = "is not ported (ROADMAP.md §1 item 11b)"


def _convention(args, kwargs):
    """True for a call with torch tensors, False with NDArrays, None with
    neither (the caller's convention holds)."""
    vals = list(args) + list(kwargs.values())
    flat = []
    for v in vals:
        if isinstance(v, (list, tuple)):
            flat.extend(v)
        else:
            flat.append(v)
    if any(isinstance(v, NDArray) for v in flat):
        return False
    if any(isinstance(v, torch.Tensor) for v in flat):
        return True
    return None


class Block(torch.nn.Module):
    """Base building block (reference: gluon/block.py:202)."""

    def __init__(self):
        super().__init__()
        self._reg_params: OrderedDict[str, Parameter] = OrderedDict()

    # -- attribute magic: registering children/params on assignment ---------
    def __setattr__(self, name, value):
        regs = self.__dict__.get("_reg_params")
        if isinstance(value, Parameter) and regs is not None:
            value.name = name
            regs[name] = value
            object.__setattr__(self, name, value)
            self._parameters.pop(name, None)
            value._add_owner(self, name)
            return
        if isinstance(value, torch.Tensor) and regs is not None \
                and name in regs:
            # a tensor given for a parameter becomes its data, as it is
            # (a new address: graphs reading the old one are stale)
            regs[name]._bind(value)
            return
        if regs is not None and name in regs:
            del regs[name]
            self._parameters.pop(name, None)
        super().__setattr__(name, value)

    def __setstate__(self, state):
        # a copy (copy.deepcopy) or an unpickled block owns its Parameters
        super().__setstate__(state)
        for name, p in self._reg_params.items():
            p._add_owner(self, name)

    def _register_tensor(self, name, tensor):
        """Register a Parameter's tensor under its attribute name, in the
        order the Parameters were assigned."""
        self._parameters[name] = tensor
        order = [n for n in self._reg_params if n in self._parameters]
        rest = [n for n in self._parameters if n not in self._reg_params]
        items = [(n, self._parameters[n]) for n in order + rest]
        self._parameters.clear()
        self._parameters.update(items)

    @property
    def _children(self):
        return OrderedDict((n, m) for n, m in self._modules.items()
                           if isinstance(m, Block))

    # -- params -------------------------------------------------------------
    def collect_params(self, select=None) -> dict:
        """name → Parameter for self and descendants (reference: block.py
        :56), a ParameterDict."""
        out = ParameterDict()

        def walk(block, prefix):
            for n, p in block._reg_params.items():
                out[prefix + n] = p
            for n, c in block._children.items():
                walk(c, f"{prefix}{n}.")

        walk(self, "")
        if select is not None:
            pat = re.compile(select)
            return ParameterDict({k: v for k, v in out.items()
                                  if pat.match(k)})
        return out

    def share_parameters(self, shared):
        """Rebind this block's parameters to `shared` (the dict another
        block's collect_params() returned), matching by structured name.
        Missing names keep their own parameters."""
        if shared is None:
            return self

        def walk(block, prefix):
            for n in list(block._reg_params):
                full = prefix + n
                if full in shared:
                    setattr(block, n, shared[full])
            for n, c in block._children.items():
                walk(c, f"{prefix}{n}.")

        walk(self, "")
        return self

    @property
    def params(self):
        return dict(self._reg_params)

    def initialize(self, init=None, device=None, ctx=None, verbose=False,  # noqa: ARG002
                   force_reinit=False):
        for name, p in self.collect_params().items():
            p.name = name
            p.initialize(init=None if p.init is not None else init,
                         device=device or ctx, force_reinit=force_reinit)

    def setattr(self, name, value):
        for p in self.collect_params().values():
            setattr(p, name, value)

    def register_child(self, block, name=None):
        name = name or str(len(self._children))
        self.add_module(name, block)

    def register_block(self, name, block):
        self.add_module(name, block)

    def apply(self, fn):
        for c in self._children.values():
            c.apply(fn)
        fn(self)
        return self

    # -- lifecycle ----------------------------------------------------------
    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)
        for c in self._children.values():
            c.cast(dtype)

    def reset_device(self, device):
        for p in self.collect_params().values():
            p.reset_device(device)

    reset_ctx = reset_device

    def hybridize(self, active=True, **kwargs):
        for c in self._children.values():
            c.hybridize(active, **kwargs)

    def zero_grad(self):
        for p in self.collect_params().values():
            p.zero_grad()

    def audit(self, *args, train_mode=None, **kwargs):
        """Audit this block's forward on ``args`` for capture hazards
        (`analysis.audit`): returns an `AuditReport`."""
        from ..analysis import audit

        return audit(self, *args, train_mode=train_mode, **kwargs)

    # -- checkpointing (reference: block.py:160 save_parameters / :177) -----
    def save_parameters(self, filename, deduplicate=False):  # noqa: ARG002
        """An npz file of every initialised parameter by its structured
        name, written through a temporary file and a rename, with a
        ``.crc32`` sidecar (`preemption.atomic_save`). A parameter stored
        as its block on a mesh is written whole: every rank of its axes
        calls this."""
        from .. import preemption

        payload = {}
        for name, p in self.collect_params().items():
            if p._data is not None:
                # a block stored by the spec is gathered whole (every rank
                # of its axes saves)
                payload[name] = (
                    p._data if getattr(p, "_placement", None) is None
                    else NDArray(p._whole_tensor())).asnumpy()

        def _write(tmp):
            with open(tmp, "wb") as f:
                onp.savez(f, **payload)

        preemption.atomic_save(filename, _write)

    def load_parameters(self, filename, device=None, ctx=None,  # noqa: ARG002
                        allow_missing=False, ignore_extra=False,
                        cast_dtype=False, dtype_source="current"):  # noqa: ARG002
        """Load an npz file written by `save_parameters` (of either
        package), or the reference's binary ``.params`` container
        (detected by its magic; `ndarray/legacy_io.py`), whose ``arg:`` /
        ``aux:`` name prefixes are dropped. A ``.crc32`` sidecar that does
        not match raises :class:`MXNetError` before any parameter is
        touched, as does a binary file without names or a file of
        neither format. Values are copied into the parameters' tensors
        (`Parameter.set_data`)."""
        from .. import preemption
        from ..ndarray import legacy_io

        if preemption.verify_checkpoint(filename) is False:
            raise MXNetError(
                f"parameter file {filename} failed checksum validation "
                "(truncated or corrupt) — restore a previous checkpoint "
                "generation")
        if legacy_io.is_legacy_file(filename):
            try:
                raw = legacy_io.load(filename)
            except ValueError as e:
                raise MXNetError(f"{filename}: {e}") from e
            if not isinstance(raw, dict):
                raise MXNetError(f"{filename} carries no parameter names")
            loaded = {(k[4:] if k.startswith(("arg:", "aux:")) else k):
                      v._data for k, v in raw.items()}
        elif not zipfile.is_zipfile(filename):
            raise MXNetError(f"{filename} is neither an npz file nor the "
                             f"reference's binary .params container")
        else:
            with onp.load(filename, allow_pickle=False) as z:
                loaded = {k: z[k] for k in z.keys()}
        params = self.collect_params()
        for name, p in params.items():
            if name in loaded:
                p.set_data(loaded[name])
            elif not allow_missing:
                raise KeyError(f"Parameter {name} missing in file {filename}")
        extra = set(loaded) - set(params)
        if extra and not ignore_extra:
            raise KeyError(f"file {filename} contains extra parameters: "
                           f"{sorted(extra)}")

    def load_dict(self, param_dict, device=None, allow_missing=False,  # noqa: ARG002
                  ignore_extra=False):  # noqa: ARG002
        """Copy ``{name: array}`` (NDArrays, numpy arrays or tensors) into
        the parameters of the same structured names."""
        params = self.collect_params()
        for name, p in params.items():
            if name in param_dict:
                p.set_data(param_dict[name])
            elif not allow_missing:
                raise KeyError(f"Parameter {name} missing in dict")

    # -- call ---------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        conv = _convention(args, kwargs)
        if conv is None:
            return self._call(args, kwargs)
        prev = _CONV.torch
        _CONV.torch = conv
        try:
            return self._call(args, kwargs)
        finally:
            _CONV.torch = prev

    def _call(self, args, kwargs):
        try:
            return torch.nn.Module.__call__(self, *args, **kwargs)
        except DeferredInitializationError:
            self._deferred_infer_shape(*args, **kwargs)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            return torch.nn.Module.__call__(self, *args, **kwargs)

    def _deferred_infer_shape(self, *args, **kwargs):
        if not hasattr(self, "infer_shape"):
            raise DeferredInitializationError(
                f"{type(self).__name__} cannot infer parameter shapes")
        self.infer_shape(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def summary(self, *inputs):  # noqa: ARG002
        """Print a per-layer summary (reference: block.py summary)."""
        rows = []

        def count(params):
            return sum(int(onp.prod(p.shape)) for p in params
                       if p.shape is not None and all(s > 0 for s in p.shape))

        def hook(block, indent):
            rows.append(("  " * indent + type(block).__name__,
                         count(block._reg_params.values())))
            for c in block._children.values():
                hook(c, indent + 1)

        hook(self, 0)
        total = count(self.collect_params().values())
        lines = [f"{'Layer':<48}{'Params':>12}", "-" * 60]
        lines += [f"{n:<48}{p:>12}" for n, p in rows]
        lines += ["-" * 60, f"{'Total params':<48}{total:>12}"]
        out = "\n".join(lines)
        print(out)
        return out

    def __repr__(self):
        s = f"{type(self).__name__}(\n"
        for name, c in self._children.items():
            s += f"  ({name}): {type(c).__name__}\n"
        return s + ")"


# ---------------------------------------------------------------------------
# hybridize: the cached graphs
# ---------------------------------------------------------------------------

def _flatten(out):
    """Outputs (an NDArray, or nested tuples/lists of them) as a flat list
    and the structure to rebuild them."""
    if isinstance(out, (tuple, list)):
        flat, trees = [], []
        for o in out:
            f, t = _flatten(o)
            flat.extend(f)
            trees.append(t)
        return flat, (type(out), trees)
    return [out], None


def _unflatten(tree, flat, pos=0):
    if tree is None:
        return flat[pos], pos + 1
    kind, trees = tree
    items = []
    for t in trees:
        item, pos = _unflatten(t, flat, pos)
        items.append(item)
    return kind(items), pos


def _ledger(block, seconds, args, entry=None):
    """A program-ledger entry ``cached_op:<BlockName>``, as the
    reference's (when the telemetry modules are loaded), with a capture's
    FLOPs and kernel costs (``entry``'s)."""
    family = f"cached_op:{type(block).__name__}"
    reg = sys.modules.get("incubator_mxnet_tpu_torch.telemetry.registry")
    if reg is not None:
        reg.observe_compile(family, seconds)
    comp = sys.modules.get("incubator_mxnet_tpu_torch.telemetry.compiles")
    if comp is not None:
        log = None
        if entry is not None and entry.fwd is not None:
            log = entry.fwd.launch_log + (
                entry.bwd.launch_log if entry.bwd is not None else [])
        comp.record_capture(family, seconds,
                            args=tuple(a._data if isinstance(a, NDArray)
                                       else a for a in args), observe=False,
                            flops=None if entry is None else entry.flops,
                            launch_log=log)


class _Entry:
    """One signature's graphs and static buffers."""

    def __init__(self):
        self.calls = 0
        self.fwd = self.bwd = None
        self.inputs = []       # static input tensors (None for None)
        self.outs = []         # the forward graph's output tensors
        self.tree = None
        self.params = []       # the parameters' leaves the node is over
        self.diff = []         # what the backward graph differentiates
        self.diff_inputs = []  # positions of the inputs among the args
        self.grad_outs = []    # the backward graph's output-gradient buffers
        self.grad_ins = []     # its gradients of `diff`
        self.key = None        # int64 [w0, w1, t] read by the dropout sites
        self.gen = 0           # forward replays so far
        self.flops = None      # the warm-up's torch FLOPs (ledger on)


class _Replay(torch.autograd.Function):
    """One recorded call of a hybridized block: the forward graph's replay,
    whose backward is the backward graph's replay."""

    @staticmethod
    def forward(ctx, entry, *tensors):  # noqa: ARG004
        entry.fwd.replay()
        entry.gen += 1
        ctx.entry, ctx.gen = entry, entry.gen
        outs = tuple(o.detach().clone() for o in entry.outs)
        ctx.mark_non_differentiable(*[o for o, s in zip(outs, entry.outs)
                                      if not s.requires_grad])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        entry = ctx.entry
        if ctx.gen != entry.gen:
            raise MXNetError("hybridize: the block's graph was replayed "
                             "again before the backward of an earlier call "
                             "of the same signature; call backward first")
        bufs = iter(entry.grad_outs)
        for s, g in zip(entry.outs, grads):
            if s.requires_grad:
                buf = next(bufs)
                if g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)
        entry.bwd.replay()
        return (None,) + tuple(None if g is None else g.clone()
                               for g in entry.grad_ins)


class _CachedGraph:
    """The hybridized block's graphs, one per (training mode, recording,
    AMP, input signature) (the reference's `_CachedGraph` :279)."""

    def __init__(self, block):
        self.block = block
        self.entries = {}
        self.captures = 0
        self._side = _graphs.SideStream()
        self._epoch = Parameter._rebinds

    def signature(self, args):
        from .. import amp

        sig = []
        for a in args:
            if a is None:
                sig.append(None)
            else:
                t = a._data
                sig.append((tuple(t.shape), t.dtype, t.device,
                            t.requires_grad))
        return (autograd.is_training(), autograd.is_recording(),
                amp.amp_active() and amp.amp_dtype(), tuple(sig))

    def __call__(self, args):
        if self._epoch != Parameter._rebinds:
            # a parameter took a new tensor: the graphs read the old one
            self.entries.clear()
            self._epoch = Parameter._rebinds
        sig = self.signature(args)
        entry = self.entries.get(sig)
        dev = next(a._data.device for a in args if a is not None)
        if entry is None:
            entry = self.entries[sig] = _Entry()
        entry.calls += 1
        if dev.type != "cuda" or entry.calls <= _graphs.EAGER_CALLS:
            t0 = time.perf_counter()
            out = Block.__call__(self.block, *args)
            if dev.type != "cuda" and entry.calls == 1:
                _ledger(self.block, time.perf_counter() - t0, args)
            return out
        if entry.fwd is None:
            t0 = time.perf_counter()
            self._capture(entry, args, sig, dev)
            self.captures += 1
            _ledger(self.block, time.perf_counter() - t0, args, entry)
        return self._replay(entry, args)

    def _run(self, entry, sig, inputs, aliases=None):
        """The forward over ``inputs`` (tensors) with the capture's key
        buffer, in the signature's modes: the function captured, and the
        eager step it is held against. ``aliases``: {parameter NDArray:
        tensor} read in place of the parameters' own leaves for the call
        (the capture differentiates new leaves over the same memory, so
        no autograd node made before the capture, on another stream,
        takes part in it)."""
        training, recording = sig[0], sig[1]
        nds = [None if t is None else _wrap(t) for t in inputs]
        saved = [(a, a._data) for a in (aliases or ())]
        for a, t in (aliases or {}).items():
            a._data = t
        try:
            with autograd._Scope(recording=recording, training=training), \
                    _random.trace_key_scope(entry.key[:2], entry.key[2]):
                out = Block.__call__(self.block, *nds)
        finally:
            for a, t in saved:
                a._data = t
        flat, tree = _flatten(out)
        return [o._data for o in flat], tree

    def _capture(self, entry, args, sig, dev):
        recording = sig[1]
        name = type(self.block).__name__
        entry.inputs = []
        for a in args:
            if a is None:
                entry.inputs.append(None)
                continue
            s = a._data.detach().clone()
            if a._data.requires_grad:
                s.requires_grad_(True)
            entry.inputs.append(s)
        entry.diff_inputs = [i for i, s in enumerate(entry.inputs)
                             if s is not None and s.requires_grad]
        arrays = [p._data for p in self.block.collect_params().values()
                  if p._data is not None]
        entry.params = [a._data for a in arrays if a._data.requires_grad] \
            if recording else []
        entry.key = torch.zeros(3, dtype=torch.int64, device=dev)
        self._write_key(entry)
        diff_in = [entry.inputs[i] for i in entry.diff_inputs]

        def aliases():
            return {a: a._data.detach().requires_grad_(a._data.requires_grad)
                    for a in arrays}

        # auxiliary state (BatchNorm's running statistics) is updated in
        # place by the forward: the warm-up leaves it as it found it, so
        # that the call moves it once, by the replay that follows
        aux = [a._data for a in arrays if not a._data.requires_grad]

        def warm():
            saved = [t.detach().clone() for t in aux]
            al = aliases()
            outs, _ = self._run(entry, sig, entry.inputs, al)
            if recording:
                fl = [o for o in outs if o.requires_grad]
                if fl:
                    torch.autograd.grad(fl, [al[a] for a in arrays
                                             if a._data.requires_grad]
                                        + diff_in,
                                        [torch.ones_like(o) for o in fl],
                                        allow_unused=True)
            with torch.no_grad():
                for t, s in zip(aux, saved):
                    t.copy_(s)

        comp = sys.modules.get("incubator_mxnet_tpu_torch.telemetry.compiles")
        if comp is not None and comp.is_enabled():
            _, entry.flops = self._side.run(
                dev, lambda: _graphs.count_flops(warm))
        else:
            self._side.run(dev, warm)
        torch.cuda.synchronize(dev)
        al = aliases()
        entry.fwd, (entry.outs, entry.tree) = _graphs.capture(
            lambda: self._run(entry, sig, entry.inputs, al),
            f"hybridize: {name}'s forward", owner=f"graph:cached_op:{name}")
        if not recording:
            return
        entry.diff = [al[a] for a in arrays if a._data.requires_grad] \
            + diff_in
        fl = [o for o in entry.outs if o.requires_grad]
        entry.grad_outs = [torch.zeros_like(o) for o in fl]

        def bwd():
            if not fl:
                return [None] * len(entry.diff)
            return list(torch.autograd.grad(fl, entry.diff, entry.grad_outs,
                                            allow_unused=True))

        entry.bwd, entry.grad_ins = _graphs.capture(
            bwd, f"hybridize: {name}'s backward", pool=entry.fwd.pool())

    @staticmethod
    def _write_key(entry):
        w0, w1 = _random._host_words()
        entry.key.copy_(torch.tensor([w0, w1, entry.calls],
                                     dtype=torch.int64))

    def _replay(self, entry, args):
        with torch.no_grad():
            for s, a in zip(entry.inputs, args):
                if s is not None:
                    s.copy_(a._data)
        self._write_key(entry)
        if entry.bwd is not None:
            diff = entry.params + [args[i]._data for i in entry.diff_inputs]
            with torch.enable_grad():
                outs = _Replay.apply(entry, *diff)
        else:
            entry.fwd.replay()
            entry.gen += 1
            outs = [o.detach().clone() for o in entry.outs]
        return _unflatten(entry.tree, [_wrap(o) for o in outs])[0]

    def eager(self, args, key, t):
        """The captured function of ``args``' signature run eagerly with
        the key buffer ``[key[0], key[1], t]`` (the step a replay with
        that key is held against), in the current modes."""
        sig = self.signature(args)
        dev = next(a._data.device for a in args if a is not None)
        entry = _Entry()
        entry.key = torch.tensor([int(key[0]), int(key[1]), int(t)],
                                 dtype=torch.int64, device=dev)
        outs, tree = self._run(entry, sig, [None if a is None else a._data
                                            for a in args])
        return _unflatten(tree, [_wrap(o) for o in outs])[0]


class HybridBlock(Block):
    """Block whose calls with NDArrays replay CUDA graphs once hybridized
    (reference: block.py:403)."""

    def __init__(self):
        super().__init__()
        self._active = False
        self._cached_graph: _CachedGraph | None = None
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  backend=None, backend_opts=None, remat=None, **kwargs):
        """``static_alloc``, ``static_shape`` and ``backend_opts`` are
        accepted (a CUDA graph is static in both); ``backend`` and
        ``remat`` raise."""
        if backend is not None:
            raise MXNetError(f"hybridize(backend=...): partition backends "
                             f"{_ITEM11}")
        if remat is not None:
            raise MXNetError(f"hybridize(remat=...): rematerialization "
                             f"{_ITEM11}")
        self._active = active
        self._flags = dict(static_alloc=static_alloc, static_shape=static_shape,
                           backend=backend, backend_opts=backend_opts,
                           remat=remat, **kwargs)
        self._cached_graph = None
        for c in self._children.values():
            if not isinstance(c, HybridBlock):
                c.hybridize(active, **kwargs)
        # children of a hybridized block run inside the parent's graph

    def optimize_for(self, x, *args, backend=None, backend_opts=None,  # noqa: ARG002
                     **kwargs):  # noqa: ARG002
        raise MXNetError(f"HybridBlock.optimize_for: partition backends "
                         f"{_ITEM11}")

    @property
    def captures(self):
        """CUDA graphs captured for this block (one a signature)."""
        return 0 if self._cached_graph is None else self._cached_graph.captures

    def __call__(self, *args, **kwargs):
        if not self._active or kwargs or not args \
                or not all(a is None or isinstance(a, NDArray) for a in args) \
                or all(a is None for a in args):
            return super().__call__(*args, **kwargs)
        if self._cached_graph is None:
            self._cached_graph = _CachedGraph(self)
        prev = _CONV.torch
        _CONV.torch = False
        try:
            return self._cached_graph(args)
        finally:
            _CONV.torch = prev

    def export(self, path, epoch=0, remove_amp_cast=True):  # noqa: ARG002
        raise MXNetError(f"HybridBlock.export: the deployment artifact "
                         f"{_ITEM11}")

    def infer_shape(self, *args):
        """Subclasses with deferred params override this."""
        raise DeferredInitializationError(
            f"{type(self).__name__} cannot infer parameter shapes")

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """The reference runs an exported model or a symbol graph without its
    Python class; the port has neither artifact."""

    def __init__(self, outputs, inputs=None, params=None):  # noqa: ARG002
        raise MXNetError(f"SymbolBlock {_ITEM11}")

    @staticmethod
    def imports(symbol_file, input_names=None, param_file=None, device=None):  # noqa: ARG004
        raise MXNetError(f"SymbolBlock.imports {_ITEM11}")
