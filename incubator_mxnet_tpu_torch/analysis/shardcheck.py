"""Static sharding / partition-spec analyzer (port of
`incubator_mxnet_tpu/analysis/shardcheck.py`: `shardcheck` :310).

A wrong or missing spec fails only at run time, as a silent full
replication, a per-rank OOM or an all-gather in the hot loop.
`shardcheck` is the pre-flight: it checks a program's layout against a
mesh (a `parallel.Mesh` or a plain ``{"axis": size}`` dict) and reports
typed findings SC001-SC006 (`findings.SHARD_RULES`) before anything
runs on the card.

Two tiers:

1. **spec tier** (always), the reference's as it is: pure host math over
   ``(shape, dtype, spec, mesh)`` leaves. SC001 an unconstrained large
   parameter, SC002 a dimension the axes do not divide (or a spec longer
   than the rank), SC003 an axis the mesh lacks, and the per-rank byte
   estimate behind SC006 (``MXNET_SHARDCHECK_HBM_GB``).
2. **census tier** (needs ``fn``, real inputs where it reads them, and,
   for exchanges, a `parallel.Mesh` of the live world): the program runs
   once, eagerly, inside the mesh's scope, and every exchange it makes is
   counted by op with the bytes of its result
   (`parallel.collectives._STEP_CENSUS`). This stands for the reference's
   jaxpr and compiled-HLO tiers, which have no counterpart on torch: it
   gives SC005's collectives and bytes a step. SC005 flags an all-gather
   or all-to-all that carries a whole cut parameter (the reference
   matches result bytes against the cut leaves' whole bytes; the port's
   flat exchanges name the parameters they carry, so an activation of
   the same size is not mistaken for one). SC004 becomes a donated
   argument the program does not update **in place by address** (its
   tensor's version does not move): a captured step reads the old one.
   Its outputs that are new tensors add to the per-rank estimate.

Env knobs (`util.env_knobs()`): ``MXNET_SHARDCHECK=warn|raise`` runs the
spec tier when a `DataParallel` is made (off by default);
``MXNET_SHARDCHECK_HBM_GB`` is the per-rank budget of SC006.

A spec is the port's: a tuple with one entry per dimension (an axis
name, a tuple of names, or None) or None (unconstrained); ``()`` is the
reference's ``P()``, replicated on purpose. A spec tree is a dict or list
of specs matching the argument's tree. :class:`ShapeDtype` stands for an
array by its shape and dtype.
"""
from __future__ import annotations

import logging
import math

from .. import util
from ..base import MXNetError
from .findings import SHARD_RULES, ShardReport  # noqa: F401

__all__ = ["shardcheck", "SHARD_RULES", "ShardReport", "ShapeDtype"]

_LOG = logging.getLogger("incubator_mxnet_tpu_torch.analysis")

# Default SC001 threshold: replicating anything under 1 MiB is noise.
_REPLICATED_MIN_BYTES = 1 << 20


class ShapeDtype:
    """An array by its shape and dtype alone (the reference's
    ``jax.ShapeDtypeStruct``): a torch or numpy dtype, or its name.
    ``block`` is this rank's tensor of a whole array the spec cuts (a
    sharded serving engine's weight or pool block): the spec tier reads
    the whole shape, the census tier's in-place check (SC004) the
    block."""

    def __init__(self, shape, dtype="float32", block=None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.block = block

    def __repr__(self):
        return f"ShapeDtype({self.shape}, {self.dtype})"


def _itemsize(dtype):
    size = getattr(dtype, "itemsize", None)
    if isinstance(size, int):
        return size
    import numpy as onp
    import torch

    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    try:
        return onp.dtype(dtype).itemsize
    except TypeError:
        return 4


class _MeshView:
    """The accepted mesh forms: a `parallel.Mesh` (its axes; the census
    tier runs inside its scope) or a plain ``{"axis": size}`` dict."""

    def __init__(self, mesh):
        self.real = None
        if mesh is None:
            self.sizes = {}
        elif isinstance(mesh, dict):
            self.sizes = {str(k): int(v) for k, v in mesh.items()}
        else:
            self.sizes = {str(k): int(v) for k, v in dict(mesh.shape).items()}
            self.real = mesh

    @property
    def n_devices(self):
        return math.prod(self.sizes.values()) if self.sizes else 1


def _is_spec_leaf(x):
    """None or a spec tuple (entries None, a name, or a tuple of names);
    a dict or a list is a tree of specs."""
    if x is None:
        return True
    if not isinstance(x, tuple):
        return False
    return all(e is None or isinstance(e, str)
               or (isinstance(e, tuple) and all(isinstance(a, str)
                                                for a in e))
               for e in x)


def _as_aval(leaf):
    """Any array-like leaf as a :class:`ShapeDtype` (NDArray unwrapped)."""
    import numpy as onp

    if hasattr(leaf, "_data") and hasattr(leaf._data, "shape"):  # NDArray
        leaf = leaf._data
    if isinstance(leaf, ShapeDtype):
        return leaf
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return ShapeDtype(tuple(leaf.shape), leaf.dtype)
    arr = onp.asarray(leaf)
    return ShapeDtype(arr.shape, arr.dtype)


def _tensor_of(leaf):
    """The tensor behind an argument leaf: itself, or a
    :class:`ShapeDtype`'s block (None for neither)."""
    import torch

    if isinstance(leaf, ShapeDtype):
        leaf = leaf.block
    return leaf if isinstance(leaf, torch.Tensor) else None


def _nbytes(aval):
    item = _itemsize(aval.dtype)
    return math.prod(aval.shape) * item if aval.shape else item


def _norm_entries(spec, rank):
    """Spec -> per-dim tuple-of-axis-names, padded with () to `rank`.
    None (unconstrained) and () (replicated) both normalize to all-();
    they differ only for SC001, handled by the caller."""
    entries = []
    for e in tuple(spec or ()):
        if e is None:
            entries.append(())
        elif isinstance(e, tuple):
            entries.append(tuple(e))
        else:
            entries.append((e,))
    while len(entries) < rank:
        entries.append(())
    return tuple(entries)


def _flatten_with_path(tree, path=""):
    """[(keystr path, leaf)] of a tree of dicts (key order), lists and
    tuples, as `jax.tree_util.keystr` writes the paths."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _flatten_with_path(t, f"{path}[{i}]")]
    return [(path, tree)]


def _spec_leaves(specs):
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list) or (isinstance(specs, tuple)
                                   and not _is_spec_leaf(specs)):
        return [s for t in specs for s in _spec_leaves(t)]
    return [specs]


def _spec_leaves_for(arg, spec, where):
    """Broadcast one spec over an arg subtree, or zip a matching spec
    tree; returns one spec per array leaf of `arg`."""
    n = len(_flatten_with_path(arg))
    if _is_spec_leaf(spec):
        return [spec] * n
    leaves = _spec_leaves(spec)
    if len(leaves) != n:
        raise ValueError(
            f"shardcheck: spec tree for {where} does not match the "
            f"argument structure ({len(leaves)} specs for {n} leaves)")
    return leaves


def _flatten_with_specs(args, specs, name, prefix="arg"):
    """(label, aval, spec, arg_index, leaf) per array leaf, broadcasting a
    single spec over an arg subtree or zipping a matching spec tree."""
    if specs is None:
        specs = (None,) * len(args)
    if len(specs) != len(args):
        raise ValueError(
            f"shardcheck({name}): got {len(args)} abstract args but "
            f"{len(specs)} spec entries — pass one spec (or spec tree, or "
            f"None) per argument")
    out = []
    for i, (arg, spec) in enumerate(zip(args, specs)):
        leaves = _flatten_with_path(arg)
        spec_leaves = _spec_leaves_for(arg, spec, f"{prefix} {i}")
        for (path, leaf), sp in zip(leaves, spec_leaves):
            out.append((f"{prefix}{i}{path}", _as_aval(leaf), sp, i, leaf))
    return out


def _check_leaf(report, label, aval, spec, mv, replicated_min_bytes):
    """Spec-tier checks for one leaf; returns (per_device_bytes,
    shard_factor)."""
    nbytes = _nbytes(aval)
    rank = len(aval.shape)
    raw = spec
    if raw is not None and len(tuple(raw)) > rank:
        report.add_rule(
            "SC002",
            f"{label}: spec {raw} has {len(tuple(raw))} entries but the "
            f"array has rank {rank}", severity="error", site=label,
            nbytes=nbytes)
        return nbytes, 1
    entries = _norm_entries(raw, rank)
    shard_factor = 1
    for dim, axes in enumerate(entries):
        factor = 1
        for ax in axes:
            if ax not in mv.sizes:
                report.add_rule(
                    "SC003",
                    f"{label}: spec names mesh axis {ax!r} but the mesh "
                    f"only has axes {tuple(mv.sizes) or '()'}",
                    severity="error", site=label, nbytes=nbytes)
                factor = None
                break
            factor *= mv.sizes[ax]
        if not factor or factor == 1:
            continue
        if aval.shape[dim] % factor:
            report.add_rule(
                "SC002",
                f"{label}: dim {dim} has size {aval.shape[dim]}, not "
                f"divisible by mesh axis {'x'.join(axes)} (size {factor}) "
                f"— the layout cannot cut it evenly", severity="error",
                site=label, nbytes=nbytes)
        else:
            shard_factor *= factor
    if (raw is None and shard_factor == 1 and mv.n_devices > 1
            and nbytes >= replicated_min_bytes):
        report.add_rule(
            "SC001",
            f"{label}: no sharding constraint — {nbytes / 2**20:.1f} MiB "
            f"silently replicated on each of {mv.n_devices} devices",
            severity="warn", site=label, nbytes=nbytes)
    return -(-nbytes // shard_factor), shard_factor


def _census_tier(report, fn, args, leaves, donate_argnums, mv):
    """Run ``fn(*args)`` once, eagerly, counting its exchanges by op
    (count and result bytes); returns its output. Donated tensor leaves
    whose version did not move raise SC004."""
    import contextlib

    import torch

    from ..parallel import collectives as _coll
    from ..parallel.mesh import mesh_scope

    donate = set(donate_argnums or ())
    before = [(label, t, t._version, t.data_ptr())
              for label, _aval, _sp, argi, leaf in leaves
              if argi in donate and (t := _tensor_of(leaf)) is not None]

    def count(op, group, in_bytes, out_bytes, carried):  # noqa: ARG001
        rec = report.collectives.setdefault(op, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += out_bytes
        if carried:
            operands.setdefault(op, []).extend(carried)

    operands = report.operands = {}
    scope = (mesh_scope(mv.real) if mv.real is not None
             else contextlib.nullcontext())
    saved = _coll._STEP_CENSUS
    _coll._STEP_CENSUS = count
    try:
        with scope:
            out = fn(*args)
    finally:
        _coll._STEP_CENSUS = saved
    report.tiers.append("census")
    for label, leaf, version, ptr in before:
        if leaf._version == version:
            report.add_rule(
                "SC004",
                f"{label} is donated but the program did not update it in "
                f"place by address (its version did not move) — a "
                f"captured step reads the old tensor",
                severity="warn", site=label,
                nbytes=leaf.numel() * leaf.element_size())
        elif leaf.data_ptr() == ptr:
            report.donated_bytes += leaf.numel() * leaf.element_size()
    return out


def shardcheck(fn_or_step, *abstract_args, mesh=None, specs=None,
               out_specs=None, donate_argnums=(), hbm_budget_gb=None,
               hot_path=False, replicated_min_bytes=_REPLICATED_MIN_BYTES,
               name=None, mode=None, compile=True):  # noqa: A002
    """Pre-flight a program's sharding layout against a mesh.

    Parameters
    ----------
    fn_or_step : callable or None
        The step. ``None`` restricts the analysis to the spec tier
        (construction-time use, before batch shapes exist).
    *abstract_args
        One entry per fn argument: tensors, arrays, NDArrays,
        :class:`ShapeDtype`\\ s, or trees of them. The spec tier reads
        shapes and dtypes only; the census tier calls ``fn`` on them.
    mesh : parallel.Mesh | dict | None
        A mesh (the census tier runs inside its scope), or an ``{"axis":
        size}`` dict for the spec tier alone; None means one rank (specs
        naming axes raise SC003).
    specs / out_specs
        Per-argument (per-output) specs or matching trees; ``None``
        entries mean unconstrained.
    donate_argnums : tuple
        Arguments the program must update in place (SC004).
    hbm_budget_gb : float, optional
        Per-rank budget for SC006; defaults to the
        ``MXNET_SHARDCHECK_HBM_GB`` env knob (unset = no budget check).
    hot_path : bool
        Mark the program as a latency hot path: any sizeable exchange is
        flagged SC005, not just full-operand ones.
    mode : "warn" | "raise" | None
        Escalation applied before returning (trainers pass the
        ``MXNET_SHARDCHECK`` knob value).
    compile : bool
        ``False`` skips the census tier (it runs the program once).

    Returns
    -------
    ShardReport
    """
    fn = fn_or_step
    name = name or getattr(fn, "__name__", None) or "<specs>"
    mv = _MeshView(mesh)
    report = ShardReport(name, mesh_axes=mv.sizes)
    report.tiers.append("spec")

    leaves = _flatten_with_specs(abstract_args, specs, name)
    report.n_leaves = len(leaves)
    per_device = 0
    full_sharded_bytes = set()     # whole sizes of leaves that ARE cut
    for label, aval, spec, _argi, _leaf in leaves:
        pd, factor = _check_leaf(report, label, aval, spec, mv,
                                 replicated_min_bytes)
        per_device += pd
        if factor > 1:
            full_sharded_bytes.add(_nbytes(aval))

    spec_errors = [f for f in report.findings if f.severity == "error"]

    # ---- the census tier: one eager run, its exchanges counted
    if compile and fn is not None and not spec_errors:
        try:
            out = _census_tier(report, fn, abstract_args, leaves,
                               donate_argnums, mv)
        except Exception as e:  # analysis must never crash the caller
            report.note("census-failed",
                        f"the census run failed ({type(e).__name__}: {e}); "
                        f"spec-tier results only", severity="info")
        else:
            per_device += _output_bytes(out, abstract_args, out_specs, mv)

    # SC005: exchanges that re-materialize a whole cut operand, or, on a
    # declared hot path, any exchange moving >= the SC001 floor.
    carried = getattr(report, "operands", {})
    for op, rec in report.collectives.items():
        # a flat exchange of parameters names the whole bytes it carries:
        # a whole cut operand among them is re-materialized
        hits_full = (op in ("all-gather", "all-to-all")
                     and any(b in full_sharded_bytes
                             for b in carried.get(op, ())))
        if hits_full or (hot_path and rec["bytes"] >= replicated_min_bytes):
            where = "decode/step hot path" if hot_path else "step"
            report.add_rule(
                "SC005",
                f"{op} x{rec['count']} moves ~{rec['bytes'] / 2**20:.2f} "
                f"MiB per {where}"
                + (" — re-materializes a full sharded operand on every "
                   "device" if hits_full else ""),
                severity="warn", nbytes=rec["bytes"])

    # ---- SC006: per-rank estimate vs budget
    report.per_device_bytes = int(per_device)
    if hbm_budget_gb is None:
        hbm_budget_gb = util.env_float("MXNET_SHARDCHECK_HBM_GB", 0.0)
    if hbm_budget_gb:
        report.budget_bytes = int(hbm_budget_gb * 2**30)
        if report.per_device_bytes > report.budget_bytes:
            report.add_rule(
                "SC006",
                f"per-device estimate {report.per_device_bytes / 2**20:.1f}"
                f" MiB exceeds the {hbm_budget_gb:g} GiB budget "
                f"(MXNET_SHARDCHECK_HBM_GB) — this job OOMs before the "
                f"first step completes", severity="error",
                nbytes=report.per_device_bytes)

    _count_findings(report)
    _apply_mode(report, mode)
    return report


def _output_bytes(out, args, out_specs, mv):
    """Per-rank bytes of the census run's outputs that are new tensors
    (not an argument's storage), cut by ``out_specs`` where they divide."""
    import torch

    if out is None:
        return 0
    taken = {t.data_ptr() for _p, leaf in _flatten_with_path(args)
             if (t := _tensor_of(leaf)) is not None}
    outs = _flatten_with_path(out)
    o_specs = _spec_leaves_for(out, out_specs, "output")
    total = 0
    for (_path, leaf), sp in zip(outs, o_specs):
        if not isinstance(leaf, torch.Tensor) or leaf.data_ptr() in taken:
            continue
        aval = _as_aval(leaf)
        factor = 1
        for dim, axes in enumerate(_norm_entries(sp, len(aval.shape))):
            f = math.prod(mv.sizes.get(a, 1) for a in axes)
            if f > 1 and aval.shape[dim] % f == 0:
                factor *= f
        total += -(-_nbytes(aval) // factor)
    return total


def _count_findings(report):
    from ..telemetry import registry

    for f in report.findings:
        registry.counter("mx_shardcheck_findings_total",
                         "shardcheck findings by rule",
                         labels={"rule": f.kind}).inc()


def _apply_mode(report, mode):
    mode = (mode or "").strip().lower()
    if mode == "warn":
        for f in report.findings:
            _LOG.warning("MXNET_SHARDCHECK: %r", f)
    elif mode == "raise" and report.findings:
        raise MXNetError("MXNET_SHARDCHECK=raise\n" + report.summary())
