"""Program auditor: hazard detection over eager and captured programs (port
of `incubator_mxnet_tpu/analysis/auditor.py`: `audit` :300, `_run_eager`
:238, `_run_trace` :262, `jit_cache_report` :381).

`audit(fn_or_block, *args)` runs the target twice:

1. an **instrumented eager pass** with the real inputs: the host-sync
   entry points are patched to record their call sites, NDArray's
   (`asnumpy`/`item`/`__bool__`/`__int__`/`__float__`/`__index__`...) on
   any device and torch's (`Tensor.__bool__`/`item`/`tolist`/`cpu`...) on
   a CUDA tensor, where they wait for the card (``LossScaler.has_overflow``
   is one); the op funnel feeds every executed op through the
   ``_ANALYSIS_HOOK`` seam for dtype-promotion drift; and the input and
   parameter NDArrays' ``_version`` is compared before and after to catch
   in-place rebinds;
2. an **abstract pass** of the same program under
   ``torch._subclasses.FakeTensorMode``, the port's counterpart of the
   reference's ``jax.make_jaxpr``: tensors carry shapes and dtypes but no
   data, as inside a CUDA-graph capture, where a host sync cannot
   produce a value. The kernel wrappers take their plain versions on a
   fake tensor (`ops._build.use_plain`), which launch nothing. A host
   sync that
   reaches the pass is a ``host-sync`` finding at ``error`` severity. It
   works the same on the CPU and on the card. When the pass runs clean,
   ``report.jaxpr`` holds the names of the ops it ran, in order.

Both passes record only the auditing thread: the patched entry points
and the funnel hook are process-wide, so another thread's host reads and
ops go through them unrecorded, and its launches run as they would
without the audit.

Call-signature hazards (Python scalars the signature of a capture would
key on, unhashable statics) are scanned from the arguments.

`jit_cache_report` is the report on recaptures: a hybridized block or a
`DataParallel` signature set holding ``threshold`` or more live graphs
gets ``recompile-cache-churn``, joined to the program ledger
(`telemetry.compiles`) for the forensic causes.

The ``MXNET_ANALYSIS`` knob escalates findings: ``warn`` logs each,
``raise`` raises `MXNetError` when any warn- or error-severity finding
survives. Unset or empty returns the report silently.
"""
from __future__ import annotations

import logging
import os
import sys
import threading
from collections import Counter

import torch

from ..base import MXNetError
from .findings import AuditReport, Finding  # noqa: F401  (re-exported)

__all__ = ["audit", "jit_cache_report"]

_LOG = logging.getLogger("incubator_mxnet_tpu_torch.analysis")

# NDArray entry points that force a device->host round trip; the depth
# counter attributes a sync to the OUTERMOST entry point, so one
# user-level sync yields one finding
_SYNC_METHODS = ("asnumpy", "item", "asscalar", "tolist",
                 "__bool__", "__int__", "__float__", "__index__")
# torch.Tensor's, counted on a CUDA tensor (a CPU tensor's waits for no
# device)
_TORCH_SYNC_METHODS = ("__bool__", "item", "tolist", "cpu", "numpy",
                       "__int__", "__float__", "__index__")

# Binary ops checked against the reference promotion table: the expected
# dtype is what numpy gives on 1-element operands (numpy is the
# reference's table)
_PROMO_OPS = frozenset({
    "add", "subtract", "multiply", "divide", "true_divide", "floor_divide",
    "mod", "remainder", "power", "maximum", "minimum", "hypot", "arctan2",
    "logaddexp", "logaddexp2", "matmul", "dot",
})

_EXPECTED_DTYPE_CACHE: dict = {}
_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))


def _expected_dtype(name, dt_a, dt_b):
    """Reference promotion result for `name(dt_a, dt_b)`, or None when the
    table has no opinion (exotic dtypes, numpy lacks the op)."""
    import numpy as onp

    key = (name, str(dt_a), str(dt_b))
    if key in _EXPECTED_DTYPE_CACHE:
        return _EXPECTED_DTYPE_CACHE[key]
    fn = getattr(onp, name, None)
    expected = None
    if fn is not None:
        try:
            if name in ("matmul", "dot"):
                a, b = onp.ones((1, 1), dt_a), onp.ones((1, 1), dt_b)
            else:
                a, b = onp.ones(1, dt_a), onp.ones(1, dt_b)
            with onp.errstate(all="ignore"):
                expected = fn(a, b).dtype
        except Exception:
            expected = None
    _EXPECTED_DTYPE_CACHE[key] = expected
    return expected


def _np_dtype(dt):
    """numpy dtype of a torch dtype, or None (bfloat16 and other dtypes
    numpy has no analogue for)."""
    from ..base import np_dtype

    try:
        d = np_dtype(dt)
    except (KeyError, TypeError):
        return None
    import numpy as onp

    if not isinstance(d, onp.dtype) or d.kind not in "biuf":
        return None
    return d


def _user_site(skip_torch=False):
    """``file:line in qualname`` of the first frame outside the auditor,
    the NDArray funnel and autograd (and torch's own files with
    ``skip_torch``): where the audited program, or the framework code it
    called, asked for the sync."""
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename).replace("\\", "/")
        internal = (path.startswith(_HERE)
                    or path.startswith(_PKG + "/ndarray/")
                    or path.endswith("/autograd.py")
                    or (skip_torch and path.startswith(_TORCH_DIR)))
        if not internal:
            qual = getattr(f.f_code, "co_qualname", f.f_code.co_name)
            return f"{f.f_code.co_filename}:{f.f_lineno} in {qual}"
        f = f.f_back
    return None


class _Recorder:
    """Collects findings during one audited run (sync hooks + op funnel)."""

    def __init__(self, report: AuditReport):
        self.report = report
        self._tls = threading.local()
        self.ops = []
        self.thread = threading.get_ident()     # the auditing thread's

    def enter_sync(self, method, skip_torch=False):
        depth = getattr(self._tls, "depth", 0)
        if depth == 0:
            site = _user_site(skip_torch)
            self.report.note(
                "host-sync",
                f"`{method}` forces a device->host sync inside the audited "
                f"program{f' at {site}' if site else ''}; inside a "
                "CUDA-graph capture (hybridize, DataParallel) it either "
                "fails or silently fences the stream",
                severity="warn", op=method, site=site)
        self._tls.depth = depth + 1

    def exit_sync(self):
        self._tls.depth = getattr(self._tls, "depth", 1) - 1

    def observe_op(self, name, in_vals, out_vals, meta):  # noqa: ARG002
        if threading.get_ident() != self.thread:
            return
        self.ops.append(name)
        if name in _PROMO_OPS and len(in_vals) >= 2 and out_vals:
            dt_a, dt_b = _np_dtype(in_vals[0].dtype), \
                _np_dtype(in_vals[1].dtype)
            out_dt = _np_dtype(out_vals[0].dtype)
            if dt_a is not None and dt_b is not None and out_dt is not None:
                expected = _expected_dtype(name, dt_a, dt_b)
                if expected is not None and expected != out_dt:
                    self.report.note(
                        "dtype-promotion-drift",
                        f"`{name}({dt_a}, {dt_b})` produced {out_dt} but "
                        f"the reference promotion table gives {expected} "
                        "(x64-off rules drifting from the reference's "
                        "numpy semantics)", op=name)


def _device_sync(t):
    """Whether a torch method call on ``t`` waits for the card."""
    return isinstance(t, torch.Tensor) and t.device.type == "cuda"


class _Instrumented:
    """Scope that patches the host-sync entry points and installs the op
    funnel hook; the hot paths carry one `is not None` test otherwise."""

    def __init__(self, recorder):
        self.recorder = recorder
        self._saved = []

    def _patch(self, cls, meth, record_if=None, skip_torch=False):
        orig = getattr(cls, meth, None)
        if orig is None:
            return
        own = cls.__dict__.get(meth)
        self._saved.append((cls, meth, own))
        rec = self.recorder

        def wrapper(self_, *a, _orig=orig, _meth=meth, **kw):
            if threading.get_ident() != rec.thread or (
                    record_if is not None and not record_if(self_)):
                return _orig(self_, *a, **kw)
            rec.enter_sync(_meth, skip_torch)
            try:
                return _orig(self_, *a, **kw)
            finally:
                rec.exit_sync()

        wrapper.__name__ = meth
        setattr(cls, meth, wrapper)

    def __enter__(self):
        from ..ndarray import ndarray as nd_mod

        for meth in _SYNC_METHODS:
            if meth in nd_mod.NDArray.__dict__:
                self._patch(nd_mod.NDArray, meth)
        for meth in _TORCH_SYNC_METHODS:
            self._patch(torch.Tensor, meth, record_if=_device_sync,
                        skip_torch=True)
        self._prev_hook = nd_mod._ANALYSIS_HOOK
        nd_mod._ANALYSIS_HOOK = self.recorder.observe_op
        return self

    def __exit__(self, *exc):
        from ..ndarray import ndarray as nd_mod

        for cls, meth, own in reversed(self._saved):
            if own is None:
                delattr(cls, meth)
            else:
                setattr(cls, meth, own)
        nd_mod._ANALYSIS_HOOK = self._prev_hook
        return False


def _scan_signature(report, args, kwargs):
    """Static hazards visible from the call signature alone: the values a
    capture's signature would key on."""
    from ..ndarray.ndarray import NDArray

    def scan_one(label, a):
        if isinstance(a, bool):
            return              # mode flags: static by design
        if isinstance(a, (int, float)):
            report.note(
                "recompile-python-scalar",
                f"{label} is a python scalar ({a!r}); it is baked into the "
                "captured program as a static value, so every distinct "
                "value captures a separate graph — pass a 0-d array for "
                "values that change per step")
            return
        if isinstance(a, (NDArray, torch.Tensor)):
            return              # torch tensors carry no weak type
        try:
            hash(a)
        except TypeError:
            report.note(
                "recompile-unhashable-static",
                f"{label} ({type(a).__name__}) is unhashable; it cannot key "
                "a program cache and forces an eager run every call — pass "
                "a tuple or a hashable config object")

    for i, a in enumerate(args):
        scan_one(f"positional arg {i}", a)
    for k, v in kwargs.items():
        scan_one(f"keyword arg {k!r}", v)


def _run_eager(report, call, watched):
    """Instrumented eager pass; returns True when the program executed."""
    versions = [(label, arr, arr._version) for label, arr in watched]
    rec = _Recorder(report)
    try:
        with _Instrumented(rec):
            call()
    except Exception as e:  # noqa: BLE001 — auditing must not mask the error
        report.note(
            "not-jittable",
            f"audited program raised {type(e).__name__}: {e}",
            severity="error")
        return False
    for label, arr, v0 in versions:
        if arr._version != v0:
            report.note(
                "aliased-buffer-mutation",
                f"{label} was mutated in place during the audited call "
                f"(buffer rebind, version {v0} -> {arr._version}); a "
                "captured program would replay the stale buffer — return "
                "new arrays instead")
    return True


def _sync_errors():
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)

    return (DataDependentOutputException, DynamicOutputShapeException)


def _run_abstract(report, run, tensors):
    """The abstract pass: ``run(fakes)`` under FakeTensorMode, ``fakes``
    the fake counterparts of ``tensors``: the definitive in-capture
    host-sync check."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rec = _Recorder(report)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    synced = [False]
    enter = rec.enter_sync

    def enter_sync(method, skip_torch=False):
        synced[0] = True
        enter(method, skip_torch)

    rec.enter_sync = enter_sync
    try:
        with _Instrumented(rec), mode:
            fakes = [mode.from_tensor(t) for t in tensors]
            run(fakes)
        report.jaxpr = list(rec.ops)
    except _sync_errors() as e:
        report.note(
            "host-sync",
            "definite in-capture host sync: the abstract pass stopped with "
            f"{type(e).__name__} — this program cannot be captured as "
            "written", severity="error")
    except Exception as e:  # noqa: BLE001
        if synced[0]:
            report.note(
                "host-sync",
                "definite in-capture host sync: the abstract pass stopped "
                f"at a host read with {type(e).__name__}: {e}",
                severity="error")
        else:
            report.note(
                "not-jittable",
                f"abstract pass failed with {type(e).__name__}: {e}",
                severity="info")


def _is_block(target):
    try:
        from ..gluon.block import Block

        return isinstance(target, Block)
    except Exception:
        return False


def audit(fn_or_block, *args, train_mode=None, **kwargs):
    """Audit a callable or gluon Block for capture-time hazards.

    Runs the target eagerly with instrumentation, then abstractly, and
    returns an :class:`AuditReport`. ``train_mode`` pins the autograd
    training flag for both passes (default: the current mode). Remaining
    positional/keyword args are forwarded to the target; NDArrays and
    torch tensors among them become fake tensors in the abstract pass.
    """
    from .. import autograd
    from ..ndarray.ndarray import NDArray, _wrap

    is_block = _is_block(fn_or_block)
    name = (type(fn_or_block).__name__ if is_block
            else getattr(fn_or_block, "__name__", repr(fn_or_block)))
    report = AuditReport(name)
    training = autograd.is_training() if train_mode is None \
        else bool(train_mode)

    _scan_signature(report, args, kwargs)

    pos = [i for i, a in enumerate(args)
           if isinstance(a, (NDArray, torch.Tensor))]
    tensors = [args[i]._data if isinstance(args[i], NDArray) else args[i]
               for i in pos]
    watched = [(f"positional arg {i}", args[i]) for i in pos
               if isinstance(args[i], NDArray)]

    if is_block:
        from ..gluon.block import Block

        for pname, p in fn_or_block.collect_params().items():
            if p._data is not None:
                watched.append((f"parameter {pname!r}", p.data()))

        def invoke(call_args):
            return Block.__call__(fn_or_block, *call_args, **kwargs)
    else:
        def invoke(call_args):
            return fn_or_block(*call_args, **kwargs)

    def call():
        with autograd._Scope(training=training):
            invoke(args)

    def run(fakes):
        call_args = list(args)
        for i, f in zip(pos, fakes):
            call_args[i] = _wrap(f) if isinstance(args[i], NDArray) else f
        with autograd._Scope(training=training):
            invoke(call_args)

    if _run_eager(report, call, watched):
        _run_abstract(report, run, tensors)

    _apply_mode(report, os.environ.get("MXNET_ANALYSIS"))
    return report


def jit_cache_report(threshold=8):
    """The report on recaptures: a hybridized block or a `DataParallel`
    step holding ``threshold`` or more live CUDA graphs (one an input
    signature and mode) keeps meeting new signatures: a shape or a static
    argument changes per call. The program ledger's rollup
    (`telemetry.compiles.ledger_report()`) rides as ``report.ledger``,
    and a family rebuilt past its first build gets a
    ``recompile-forensics`` note naming the dominant cause. Returns an
    AuditReport."""
    from .. import _graphs

    report = AuditReport("jit-cache")
    report.ledger = {}
    try:
        from ..telemetry import compiles as _compiles

        report.ledger = _compiles.ledger_report()
    except Exception:  # noqa: FL006 — the ledger join is best-effort
        report.note("recompile-forensics",
                    "program ledger unavailable (telemetry.compiles "
                    "failed to import or report)", severity="info")
    for fam, row in sorted(report.ledger.items()):
        if row["compiles"] <= 1 or not row["causes"]:
            continue
        cause = max(row["causes"].items(), key=lambda kv: kv[1])[0]
        report.note(
            "recompile-forensics",
            f"program `{fam}` built {row['compiles']}x "
            f"({row['seconds']:.2f}s total); dominant cause: {cause} "
            f"({row['causes']})",
            severity="info" if cause == "new_bucket" else "warn", op=fam)
    graphs = Counter(_graphs.pool_owners().values())
    for owner, n in sorted(graphs.items()):
        if n >= threshold:
            report.note(
                "recompile-cache-churn",
                f"`{owner}` holds {n} captured CUDA graphs; its input "
                "signature (a shape, a dtype or a mode) changes per call "
                "— pad to a few shapes or hoist the changing value into a "
                "tensor", op=owner)
    return report


def _apply_mode(report, mode):
    mode = (mode or "").strip().lower()
    if mode == "warn":
        for f in report.findings:
            _LOG.warning("MXNET_ANALYSIS: %r", f)
    elif mode == "raise" and report.findings:
        raise MXNetError("MXNET_ANALYSIS=raise\n" + report.summary())
