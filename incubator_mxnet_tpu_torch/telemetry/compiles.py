"""Program observatory: a per-family ledger of every program the port
builds — a CUDA-graph capture or the first run of a new shape — with
recompile forensics that name the offending argument (port of
`incubator_mxnet_tpu/telemetry/compiles.py`).

The reference records one entry per XLA compile. The port compiles no
XLA programs: its "programs" are exactly what
`serve.SlotDecoder.xla_program_count` counts, and each gets one ledger
entry where it is built:

- a CUDA-graph capture of the serving engine's decode, verify or draft
  step (`SlotDecoder._capture`; on a CPU model, where nothing is
  captured, the step's first eager call under a new weight fingerprint);
- the first eager run of a prefill chunk bucket (target and model
  draft), the bucket recorded;
- a `parallel.DataParallel` capture of the whole train step (on a CPU
  model, the first eager step of each input signature).

Families are ``"{census_name}.prefill"``, ``.draft_prefill``, ``.decode``,
``.verify``, ``.draft`` and ``"train.DataParallel.step"``; each entry holds
the family, the bucket, the per-argument signature (shape, dtype |
static repr), the forensic cause and the build's wall seconds (the whole
triggering call: the eager run or the capture). Past the first entry of a
family, forensics diff the new signature against the previous one and
count ``mx_jit_recompiles_total{program=,cause=}`` with cause one of
``shape | dtype | weak_type | static_arg | new_bucket`` (``unknown`` when
the signature is the same: new weights, a new pool), plus a span
annotation and a trace event. ``weak_type`` is a jax notion; torch
tensors never carry it.

XLA's own accounting has no torch counterpart: an entry's ``flops``,
``bytes_accessed``, ``memory`` (argument/output/temp bytes, the
input/output alias map) and ``hlo_fingerprint`` are None, and so are the
rollup's ``flops``, ``bytes_accessed``, ``peak_bytes`` and
``last_fingerprint``. ``donate`` is kept when a caller passes it.

`instrument_jit` and `ledgered_jit` keep their names as thin wrappers over
the same seam: they record the first call of each distinct signature of a
callable (as a jit cache would build one program per signature). The
flight probe puts the ledger's rollup and each family's tail in every
crash dump.

Off-path contract: disabled (the default) `record_compile` and the wrapper
are one module-global bool check. Armed by ``MXNET_TELEMETRY`` via
`util._apply_env_config`, or `enable()`.
"""
from __future__ import annotations

import time

from . import registry, tracing
from .locks import tracked_lock

__all__ = ["enable", "disable", "is_enabled", "reset", "ledger",
           "ledger_report", "record_compile", "signature_of",
           "instrument_jit", "ledgered_jit", "diagnose",
           "OBSERVATORY_ENTRY_POINTS", "CAUSES"]

# The modules that record programs into the ledger directly; every other
# family goes through `ledgered_jit` / `instrument_jit`.
OBSERVATORY_ENTRY_POINTS = (
    "serve/engine.py",         # prefill buckets, decode/verify/draft graphs
    "parallel/sharded.py",     # DataParallel step capture
    "telemetry/compiles.py",   # ledgered_jit itself
)

CAUSES = ("first", "shape", "dtype", "weak_type", "static_arg",
          "new_bucket", "unknown")

_ENABLED = False
_LOCK = tracked_lock("telemetry.compiles", kind="lock")
_LEDGER: dict = {}            # family -> [entry dict, ...] (append order)
_BUCKETS: dict = {}           # family -> set of seen bucket values
_MAX_PER_FAMILY = 64          # bounded forensic history per family


# --------------------------------------------------------------------------
# signatures + forensics
# --------------------------------------------------------------------------

def _is_arraylike(x):
    return hasattr(x, "shape") and hasattr(x, "dtype") \
        and not isinstance(x, type)


def _sig_one(x, depth=0):
    if _is_arraylike(x):
        weak = bool(getattr(x, "weak_type", False))
        return ("array", tuple(x.shape), str(x.dtype), weak)
    if isinstance(x, (tuple, list)) and depth < 3:
        return ("static", type(x).__name__,
                tuple(_sig_one(v, depth + 1) for v in x[:32]))
    if isinstance(x, (int, float, bool, complex, str, bytes, type(None))):
        return ("static", repr(x)[:80])
    # never repr arbitrary objects here — repr of a device tensor (or a
    # container of them) syncs and formats the data
    return ("static", f"<{type(x).__name__}>")


def signature_of(args, kwargs=None):
    """Per-argument signature tuple: tensors become
    ``('array', shape, dtype, weak_type)``, everything else
    ``('static', repr)``. Kwargs are appended sorted by name so the diff
    is positionally stable."""
    sig = [(str(i),) + _sig_one(a) for i, a in enumerate(args)]
    for k in sorted(kwargs or ()):
        sig.append((str(k),) + _sig_one(kwargs[k]))
    return tuple(sig)


def _diff_elem(old, new, name):
    """Diff two _sig_one values; (cause, detail) or None. Recurses into
    container signatures so a shape change nested in a params tuple is
    still classified `shape` and names the leaf."""
    if old == new:
        return None
    if old[0] == "array" and new[0] == "array":
        if old[1] != new[1]:
            return "shape", f"arg {name}: shape {old[1]} -> {new[1]}"
        if old[2] != new[2]:
            return "dtype", f"arg {name}: dtype {old[2]} -> {new[2]}"
        if old[3] != new[3]:
            return "weak_type", (f"arg {name}: weak_type "
                                 f"{old[3]} -> {new[3]}")
        return None
    if (old[0] == "static" and new[0] == "static"
            and len(old) == 3 and len(new) == 3
            and isinstance(old[2], tuple) and isinstance(new[2], tuple)
            and old[1] == new[1] and len(old[2]) == len(new[2])):
        for i, (o, n) in enumerate(zip(old[2], new[2])):
            hit = _diff_elem(o, n, f"{name}[{i}]")
            if hit is not None:
                return hit
        return None
    return "static_arg", f"arg {name}: {old[1:]} -> {new[1:]}"


def diagnose(prev_sig, new_sig, new_bucket=False):
    """Root-cause a rebuild: diff two signatures and return
    ``(cause, detail)`` where detail names the offending argument.
    ``new_bucket`` short-circuits (a bucketed family growing a new bucket
    is expected growth, not shape churn)."""
    if new_bucket:
        return "new_bucket", "first compile for this bucket"
    if len(prev_sig) != len(new_sig):
        return "static_arg", (f"arity changed "
                              f"({len(prev_sig)} -> {len(new_sig)} args)")
    for old, new in zip(prev_sig, new_sig):
        hit = _diff_elem(tuple(old[1:]), tuple(new[1:]), new[0])
        if hit is not None:
            return hit
    return "unknown", "python-visible signature unchanged"


# --------------------------------------------------------------------------
# the ledger
# --------------------------------------------------------------------------

def record_compile(family, seconds, args=(), kwargs=None, fn=None,
                   bucket=None, cache_key=None, donate=None, observe=True):
    """Append one ledger entry for a program build of `family` and, past
    the first entry, run forensics against the previous one. Returns the
    entry dict (None when the observatory is disabled). Never raises.
    ``fn`` is accepted for the reference's signature; the port has no
    compiler accounting to pull from it."""
    if not _ENABLED:
        return None
    try:
        return _record(family, seconds, args, kwargs, bucket, cache_key,
                       donate, observe)
    except Exception:
        return None


def _record(family, seconds, args, kwargs, bucket, cache_key, donate,
            observe):
    family = str(family)
    sig = signature_of(args, kwargs)
    with _LOCK:
        entries = _LEDGER.setdefault(family, [])
        seen_buckets = _BUCKETS.setdefault(family, set())
        prev = entries[-1] if entries else None
        if prev is None:
            cause, detail = "first", None
        else:
            fresh_bucket = bucket is not None and bucket not in seen_buckets
            cause, detail = diagnose(prev["signature"], sig,
                                     new_bucket=fresh_bucket)
        if bucket is not None:
            seen_buckets.add(bucket)
        entry = {
            "program": family,
            "seq": len(entries) + 1,
            "ts": time.time(),
            "seconds": float(seconds),
            "cache_key": None if cache_key is None else str(cache_key)[:120],
            "bucket": bucket,
            "signature": sig,
            "donate": donate,
            "flops": None,
            "bytes_accessed": None,
            "memory": None,
            "hlo_fingerprint": None,
            "cause": cause,
            "detail": detail,
        }
        entries.append(entry)
        if len(entries) > _MAX_PER_FAMILY:
            del entries[:len(entries) - _MAX_PER_FAMILY]
    if observe:
        registry.observe_compile(family, seconds)
    if cause != "first":
        registry.counter("mx_jit_recompiles_total",
                         "jit recompiles past the first per program "
                         "family, by forensic root cause").inc()
        registry.counter("mx_jit_recompiles_total",
                         "jit recompiles past the first per program "
                         "family, by forensic root cause",
                         labels={"program": family, "cause": cause}).inc()
        tracing.annotate(recompile=family, recompile_cause=cause)
        tracing.event("jit.recompile", program=family, cause=cause,
                      detail=detail, seq=entry["seq"])
    return entry


def ledger(family=None):
    """Copy of the ledger: ``{family: [entry, ...]}`` (or one family's
    entry list)."""
    with _LOCK:
        if family is not None:
            return list(_LEDGER.get(str(family), ()))
        return {f: list(es) for f, es in _LEDGER.items()}


def ledger_report():
    """Per-family rollup: build count, total build seconds, the
    recompile-cause histogram and the buckets seen; ``flops``,
    ``bytes_accessed``, ``peak_bytes`` and ``last_fingerprint`` are None
    (no compiler accounting in the port)."""
    with _LOCK:
        out = {}
        for fam, entries in _LEDGER.items():
            causes: dict = {}
            for e in entries:
                if e["cause"] != "first":
                    causes[e["cause"]] = causes.get(e["cause"], 0) + 1
            out[fam] = {
                "compiles": len(entries),
                "seconds": sum(e["seconds"] for e in entries),
                "flops": None,
                "bytes_accessed": None,
                "peak_bytes": None,
                "causes": causes,
                "buckets": sorted(_BUCKETS.get(fam, ()),
                                  key=lambda b: (str(type(b)), str(b))),
                "last_fingerprint": None,
            }
        return out


def _flight_probe():
    """Flight-recorder context: the rollup plus the tail of each family's
    history (an OOM/crash dump should name the programs on device)."""
    if not _LEDGER:
        return None
    report = ledger_report()
    with _LOCK:
        tail = {f: [{k: e[k] for k in ("seq", "seconds", "bucket", "cause",
                                       "detail", "hlo_fingerprint")}
                    for e in es[-5:]]
                for f, es in _LEDGER.items()}
    return {"report": report, "tail": tail}


# --------------------------------------------------------------------------
# instrumented wrappers
# --------------------------------------------------------------------------

class _LedgeredJit:
    """Transparent wrapper over a callable: the first call of each
    distinct argument signature is a program build and feeds the ledger
    (a jit cache keys its programs the same way). Attribute access passes
    through to the wrapped callable."""

    __slots__ = ("_fn", "_family", "_bucket_fn", "_donate", "_seen",
                 "__weakref__")

    def __init__(self, fn, family, bucket_fn=None, donate=None):
        self._fn = fn
        self._family = str(family)
        self._bucket_fn = bucket_fn
        self._donate = donate
        self._seen = set()

    def __call__(self, *args, **kwargs):
        if not _ENABLED:            # the dead branch
            return self._fn(*args, **kwargs)
        sig = signature_of(args, kwargs)
        if sig in self._seen:
            return self._fn(*args, **kwargs)
        self._seen.add(sig)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        bucket = None
        if self._bucket_fn is not None:
            try:
                bucket = self._bucket_fn(args, kwargs)
            except Exception:
                bucket = None
        record_compile(self._family, time.perf_counter() - t0,
                       args=args, kwargs=kwargs, fn=self._fn,
                       bucket=bucket, donate=self._donate)
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __repr__(self):
        return f"<ledgered_jit {self._family} of {self._fn!r}>"


def instrument_jit(fn, family, bucket=None, donate=None):
    """Wrap a callable for the observatory. `bucket` is an optional
    ``(args, kwargs) -> value`` probe for bucketed families (chunked
    prefill) so bucket growth is classified ``new_bucket`` rather than
    shape churn. The recorded wall time is the whole triggering call."""
    return _LedgeredJit(fn, family, bucket_fn=bucket, donate=donate)


def ledgered_jit(fn, *, family, bucket=None, **jit_kwargs):
    """The reference's ``jax.jit`` drop-in, as a thin wrapper: the port
    builds no program of its own, so ``fn`` runs as it is and its first
    call at each signature is ledgered. ``jit_kwargs`` (``static_argnums``,
    ``donate_argnums``, ...) are accepted; static arguments are told apart
    by their repr in the signature, and ``donate_argnums`` is recorded."""
    return instrument_jit(fn, family, bucket=bucket,
                          donate=jit_kwargs.get("donate_argnums"))


# --------------------------------------------------------------------------
# arming
# --------------------------------------------------------------------------

def enable():
    """Arm the observatory (idempotent). Armed automatically with
    ``MXNET_TELEMETRY`` (see util._apply_env_config)."""
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def is_enabled():
    return _ENABLED


def reset():
    """Drop all ledger state (tests)."""
    with _LOCK:
        _LEDGER.clear()
        _BUCKETS.clear()


# crash dumps always carry the program history (probe returns None while
# the ledger is empty — the weakly-bound-source idiom)
tracing.register_flight_context("compile_ledger", _flight_probe)
