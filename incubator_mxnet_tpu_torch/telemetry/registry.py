"""Process-wide structured-metrics registry (port of
`incubator_mxnet_tpu/telemetry/registry.py`: `Counter`, `Gauge`,
`Histogram`, `counter`/`gauge`/`histogram` :228-238, `register_collector`,
`register_pull_gauge` :248, `report`, `exposition`, `reset`).

Host-only code, ported nearly verbatim. Every metric keeps one mutable
cell per writer thread (`threading.local`), appended to the metric's
cell list under the registry lock once per (metric, thread); `inc()` and
`observe()` touch only the calling thread's cell, and readers merge the
cells on demand. Series whose source of truth lives elsewhere (the
serving pool's page occupancy) are pull gauges: a probe read at every
`report()` / `exposition()`.

Built-in series (reference :283-365): ``mx_step_time_seconds``
(`STEP_TIME`, fed by `step()`), ``mx_examples_total`` (`EXAMPLES`),
``mx_h2d_bytes_total`` (`H2D_BYTES`, fed by the NDArray inlet's
``_H2D_HOOK``), ``mx_jit_compile_seconds`` (`JIT_COMPILE`) and the pull
pair ``mx_jit_cache_hits_total`` / ``mx_jit_cache_misses_total``: the
port's programs are CUDA graphs, so a hit is a graph replay and a miss a
program build the ledger counted (a capture or a new prefill bucket,
`telemetry.compiles`). `dump(path)` writes `report()` as JSON;
``MXNET_TELEMETRY_DUMP=<path>[:interval_s]`` (`arm_textfile_dump`) keeps
an `exposition()` snapshot in a file for a textfile scraper.

The serving engine (`serve/`) owns ``mx_serve_ttft_seconds``,
``mx_serve_tokens_total``, ``mx_serve_queue_depth``,
``mx_serve_slot_occupancy``, ``mx_serve_page_occupancy``,
``mx_serve_prefix_hits_total``, ``mx_serve_prefill_chunks_total``,
``mx_serve_evictions_total`` and ``mx_decode_bucket_pad_tokens_total``.
`observe_compile` (reference :293) feeds ``mx_jit_compile_seconds`` from
the program ledger (`telemetry.compiles`: a graph capture or a new
prefill bucket's first run).
"""
from __future__ import annotations

import json
import logging
import os
import re
import sys
import threading

__all__ = ["counter", "gauge", "histogram", "register_collector",
           "register_pull_gauge", "report", "dump", "exposition", "reset",
           "step", "observe_compile", "add_h2d_bytes", "Counter", "Gauge",
           "Histogram", "arm_textfile_dump", "stop_textfile_dump",
           "STEP_TIME", "EXAMPLES", "JIT_COMPILE", "H2D_BYTES"]

_LOCK = threading.Lock()
_METRICS: dict = {}          # (name, labels tuple) -> metric
_COLLECTORS: list = []       # callables returning {series name: value}
_PULL_HELP: dict = {}        # pull-gauge base name -> HELP text

# latency buckets: 100 µs .. ~2 min in roughly-log steps (seconds)
_DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0, 30.0, 120.0)


def _series_key(name, labels):
    return (name, tuple(sorted(labels.items())) if labels else ())


def _label_str(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


# parses the label suffix a collector bakes into its series keys
_PULL_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


class _Metric:
    """Shared per-thread-cell machinery. Subclasses define the cell layout
    (`_new_cell`) and the merge (`_merge`)."""

    kind = "untyped"

    def __init__(self, name, help="", labels=()):
        self.name = name
        self.help = help
        self.labels = labels
        self._cells: list = []            # one cell per writer thread
        self._local = threading.local()

    def _cell(self):
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = self._new_cell()
            self._local.cell = cell
            with _LOCK:
                self._cells.append(cell)
        return cell

    def snapshot(self):
        with _LOCK:
            cells = list(self._cells)
        return self._merge(cells)


class Counter(_Metric):
    kind = "counter"

    def _new_cell(self):
        return [0]

    def inc(self, n=1):
        self._cell()[0] += n

    def _merge(self, cells):
        return sum(c[0] for c in cells)

    @property
    def value(self):
        return self.snapshot()


class Gauge(_Metric):
    """Last-write-wins gauge. Writes stamp a process-wide sequence number
    so the merged value is the most recent write across threads."""

    kind = "gauge"
    _seq = [0]

    def _new_cell(self):
        return [None, -1]                 # value, seq

    def set(self, v):
        cell = self._cell()
        with _LOCK:
            Gauge._seq[0] += 1
            seq = Gauge._seq[0]
        cell[0] = v
        cell[1] = seq

    def _merge(self, cells):
        best, best_seq = None, -1
        for v, seq in cells:
            if seq > best_seq:
                best, best_seq = v, seq
        return best

    @property
    def value(self):
        return self.snapshot()


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labels=(), buckets=None):
        self.buckets = tuple(buckets) if buckets else _DEFAULT_BUCKETS
        super().__init__(name, help, labels)

    def _new_cell(self):
        # bucket counts (+inf last), sum, count, min, max
        return [[0] * (len(self.buckets) + 1), 0.0, 0,
                float("inf"), float("-inf")]

    def observe(self, v):
        cell = self._cell()
        counts = cell[0]
        for i, b in enumerate(self.buckets):
            if v <= b:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        cell[1] += v
        cell[2] += 1
        if v < cell[3]:
            cell[3] = v
        if v > cell[4]:
            cell[4] = v

    def _merge(self, cells):
        counts = [0] * (len(self.buckets) + 1)
        total, n = 0.0, 0
        mn, mx = float("inf"), float("-inf")
        for c_counts, c_sum, c_n, c_mn, c_mx in cells:
            for i, c in enumerate(c_counts):
                counts[i] += c
            total += c_sum
            n += c_n
            mn = min(mn, c_mn)
            mx = max(mx, c_mx)
        return {"buckets": dict(zip(self.buckets, counts[:-1])),
                "inf": counts[-1], "sum": total, "count": n,
                "min": (None if n == 0 else mn),
                "max": (None if n == 0 else mx)}


def _get_or_make(cls, name, help, labels, **kwargs):
    labels = labels or {}
    key = _series_key(name, labels)
    with _LOCK:
        m = _METRICS.get(key)
        if m is None:
            m = cls(name, help=help,
                    labels=tuple(sorted(labels.items())), **kwargs)
            _METRICS[key] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}")
        elif kwargs.get("buckets") is not None \
                and tuple(kwargs["buckets"]) != m.buckets:
            # an explicit spec that silently loses to an earlier
            # registration corrupts every downstream bucket read
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{m.buckets}, conflicting with {tuple(kwargs['buckets'])}")
    return m


def counter(name, help="", labels=None):
    return _get_or_make(Counter, name, help, labels)


def gauge(name, help="", labels=None):
    return _get_or_make(Gauge, name, help, labels)


def histogram(name, help="", labels=None, buckets=None):
    return _get_or_make(Histogram, name, help, labels, buckets=buckets)


STEP_TIME = histogram("mx_step_time_seconds", "train-step wall time")
EXAMPLES = counter("mx_examples_total", "examples processed")
H2D_BYTES = counter("mx_h2d_bytes_total",
                    "host->device transfer bytes at the NDArray inlet")
# JIT_COMPILE is the unlabeled aggregate; per-program series are created
# on demand by observe_compile()
JIT_COMPILE = histogram("mx_jit_compile_seconds",
                        "trace+compile wall time per program")


def observe_compile(program, seconds):
    """Feed the program-build series: the unlabeled aggregate and a
    per-program one (called by `telemetry.compiles` at each ledger
    entry)."""
    JIT_COMPILE.observe(seconds)
    histogram("mx_jit_compile_seconds", "trace+compile wall time",
              labels={"program": str(program)[:80]}).observe(seconds)


def add_h2d_bytes(n):
    """Count ``n`` host->device bytes at the NDArray inlet (armed by the
    `telemetry` package's import)."""
    H2D_BYTES.inc(n)


def step(seconds, examples=0):
    """Record one train step: latency and examples (examples/s is
    rate(mx_examples_total) or the step histogram's sum over count)."""
    STEP_TIME.observe(seconds)
    if examples:
        EXAMPLES.inc(examples)


def register_collector(fn):
    """Register a pull-mode callback returning {series name: number}."""
    with _LOCK:
        _COLLECTORS.append(fn)
    return fn


def register_pull_gauge(name, probe, help="", labels=None):
    """A gauge-typed series whose value is pulled from ``probe()`` at
    every `report()` / `exposition()` (occupancy-style series whose source
    of truth is live host state elsewhere, e.g. ``mx_serve_page_occupancy``
    over the serving pool's page allocator). ``labels`` attaches a fixed
    label set; ``probe`` returns a number, or None to omit the series this
    round (the idiom for weakly bound sources that may be gone). ``help``
    becomes the family's ``# HELP`` line in `exposition()`."""
    series = name + _label_str(tuple(sorted(labels.items()))
                               if labels else ())
    if help:
        with _LOCK:
            _PULL_HELP.setdefault(name, str(help))

    def _pull():
        v = probe()
        if v is None:
            return {}
        return {series: float(v)}

    _pull.__name__ = f"pull_gauge[{series}]"
    register_collector(_pull)
    return _pull


@register_collector
def _jit_cache_collector():
    """The port's program cache: hits are CUDA-graph replays (`_graphs`),
    misses the program builds the ledger counted (captures and new
    prefill buckets, `telemetry.compiles`)."""
    out = {}
    graphs = sys.modules.get("incubator_mxnet_tpu_torch._graphs")
    if graphs is not None:
        out["mx_jit_cache_hits_total"] = graphs.Graph.replays
    comp = sys.modules.get("incubator_mxnet_tpu_torch.telemetry.compiles")
    out["mx_jit_cache_misses_total"] = 0 if comp is None else sum(
        r["compiles"] for r in comp.ledger_report().values())
    return out


def _log_collector_failure(fn, exc):
    """A broken pull collector drops its series from reports; that is
    logged, not skipped silently."""
    logging.getLogger("incubator_mxnet_tpu_torch.telemetry").warning(
        "registry collector %r failed: %s: %s",
        getattr(fn, "__name__", fn), type(exc).__name__, exc)


def report():
    """Merged view of every series: {series name: {type, value, ...}}."""
    with _LOCK:
        metrics = list(_METRICS.values())
        collectors = list(_COLLECTORS)
    out = {}
    for m in metrics:
        key = m.name + _label_str(m.labels)
        snap = m.snapshot()
        if m.kind == "histogram":
            mean = snap["sum"] / snap["count"] if snap["count"] else None
            out[key] = {"type": "histogram", "count": snap["count"],
                        "sum": snap["sum"], "mean": mean,
                        "min": snap["min"], "max": snap["max"]}
        else:
            out[key] = {"type": m.kind, "value": snap}
    for fn in collectors:
        try:
            for name, v in (fn() or {}).items():
                out[name] = {"type": "gauge", "value": v}
        except Exception as e:  # a broken probe must not hide the rest
            _log_collector_failure(fn, e)
    return out


def _escape_help(text):
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _escaped_label_str(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labels)
    return "{" + inner + "}"


def exposition():
    """Prometheus text exposition (format v0.0.4) of every series: one
    contiguous family per base name (``# HELP``, ``# TYPE``, its samples),
    label values escaped, histograms expanded to cumulative
    ``_bucket{le=}`` rows (closing ``le="+Inf"``) plus ``_sum`` and
    ``_count``."""
    with _LOCK:
        metrics = list(_METRICS.values())
        collectors = list(_COLLECTORS)
        pull_help = dict(_PULL_HELP)
    families = {}                  # base -> {"kind", "help", "rows": []}

    def family(base, kind, help=""):
        fam = families.get(base)
        if fam is None:
            fam = {"kind": kind, "help": help, "rows": []}
            families[base] = fam
        elif help and not fam["help"]:
            fam["help"] = help
        return fam

    for m in metrics:
        fam = family(m.name, m.kind, m.help)
        ls = _escaped_label_str(m.labels)
        snap = m.snapshot()
        if m.kind == "histogram":
            cum = 0
            base_labels = list(m.labels)
            for b, c in snap["buckets"].items():
                cum += c
                bl = _escaped_label_str(tuple(sorted(
                    base_labels + [("le", repr(float(b)))])))
                fam["rows"].append((f"{m.name}_bucket", bl, cum))
            bl = _escaped_label_str(tuple(sorted(
                base_labels + [("le", "+Inf")])))
            fam["rows"].append((f"{m.name}_bucket", bl,
                                cum + snap["inf"]))
            fam["rows"].append((f"{m.name}_sum", ls, snap["sum"]))
            fam["rows"].append((f"{m.name}_count", ls, snap["count"]))
        else:
            fam["rows"].append((m.name, ls, 0 if snap is None else snap))
    for fn in collectors:
        try:
            out = fn() or {}
        except Exception as e:  # a broken probe must not hide the rest
            _log_collector_failure(fn, e)
            continue
        for name, v in out.items():
            # collector keys may carry a baked-in label suffix; the family
            # is the base name
            base, sep, label_part = name.partition("{")
            fam = family(base, "gauge", pull_help.get(base, ""))
            if sep:
                pairs = tuple(_PULL_LABEL_RE.findall(
                    label_part[:-1] if label_part.endswith("}")
                    else label_part))
                ls = _escaped_label_str(pairs)
            else:
                ls = ""
            fam["rows"].append((base, ls, v))
    lines = []
    for base, fam in families.items():
        if fam["help"]:
            lines.append(f"# HELP {base} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {base} {fam['kind']}")
        for name, ls, v in fam["rows"]:
            lines.append(f"{name}{ls} {v}")
    return "\n".join(lines) + "\n"


def dump(path):
    """Write `report()` as JSON; returns the path."""
    with open(path, "w") as f:
        json.dump(report(), f, indent=2, sort_keys=True)
    return path


# ---------------------------------------------------------------------------
# MXNET_TELEMETRY_DUMP: periodic Prometheus-textfile snapshots
# ---------------------------------------------------------------------------

_TEXTFILE = {"path": None, "interval": None, "thread": None,
             "stop": None}


def _write_textfile(path):
    """One atomic exposition() snapshot (tmp + os.replace, so a scraper
    never reads a half-written file)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(exposition())
    os.replace(tmp, path)
    return path


def arm_textfile_dump(spec):
    """Arm ``MXNET_TELEMETRY_DUMP=<path>[:interval_s]``: write
    `exposition()` to `path` now and, when an interval is given, keep
    refreshing it from a daemon thread (the node-exporter textfile
    collector's pattern). Returns (path, interval). Re-arming replaces
    the previous schedule."""
    spec = str(spec)
    path, interval = spec, None
    if ":" in spec:
        head, _, tail = spec.rpartition(":")
        try:
            interval = float(tail)
            path = head
        except ValueError:
            path, interval = spec, None   # a colon inside the path itself
    if interval is not None and interval <= 0:
        interval = None
    stop_textfile_dump()
    _write_textfile(path)
    log = logging.getLogger("incubator_mxnet_tpu_torch.telemetry")
    if interval is None:
        log.info("telemetry dump: one-shot exposition snapshot at %s", path)
        _TEXTFILE.update(path=path, interval=None)
        return path, None
    stop = threading.Event()

    def _loop():
        while not stop.wait(interval):
            try:
                _write_textfile(path)
            except OSError as e:
                log.warning("telemetry dump to %s failed: %s", path, e)

    t = threading.Thread(target=_loop, name="mx-telemetry-dump",
                         daemon=True)
    t.start()
    _TEXTFILE.update(path=path, interval=interval, thread=t, stop=stop)
    log.info("telemetry dump: exposition snapshots at %s every %.3gs",
             path, interval)
    return path, interval


def stop_textfile_dump():
    """Stop the periodic dump thread (tests / re-arming)."""
    stop = _TEXTFILE.get("stop")
    if stop is not None:
        stop.set()
        t = _TEXTFILE.get("thread")
        if t is not None:
            t.join(timeout=2.0)
    _TEXTFILE.update(path=None, interval=None, thread=None, stop=None)


def reset():
    """Zero every registered series (tests). Built-ins stay registered;
    pull collectors are not reset (their values live elsewhere)."""
    with _LOCK:
        metrics = list(_METRICS.values())
    for m in metrics:
        with _LOCK:
            cells = list(m._cells)
        for c in cells:
            fresh = m._new_cell()
            for i in range(len(c)):
                c[i] = fresh[i]
