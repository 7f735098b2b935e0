"""Environment knobs and the numpy-mode switches (port of
`incubator_mxnet_tpu/util.py`: `is_np_array` ... `default_array`
:12-76, `env_int` :94, `env_float` :100, the knob table :110-507, the
telemetry, fault-injection, goodput, memory-watch and post-mortem arming
of `_apply_env_config` :571, and the data loader's worker defaults
`default_num_workers` :656, `default_worker_retries` :670).

NumPy semantics are always on in the port, as in the reference: the
switches answer True and change nothing.

The table holds every knob the port reads, with the reference's texts
(where the port's behaviour differs, the port's).
"""
from __future__ import annotations

import functools
import logging
import os

__all__ = ["is_np_array", "is_np_shape", "set_np", "reset_np", "use_np",
           "np_shape", "np_array", "getenv", "setenv", "default_array",
           "env_int", "env_float", "env_knobs", "default_num_workers",
           "default_worker_retries"]


def is_np_array():
    return True


def is_np_shape():
    return True


def set_np(shape=True, array=True, dtype=False):  # noqa: ARG001
    return True


def reset_np():
    return True


def use_np(func):
    """A decorator for a function or a class: a class comes back as it is,
    a function wrapped unchanged (numpy semantics are always on)."""
    if isinstance(func, type):
        return func

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        return func(*args, **kwargs)

    return wrapper


class _AlwaysOnScope:
    def __init__(self, active=True):
        self._active = active

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def np_shape(active=True):
    """A scope that changes nothing (the np shape mode is always on)."""
    return _AlwaysOnScope(active)


def np_array(active=True):
    """A scope that changes nothing (the np array mode is always on)."""
    return _AlwaysOnScope(active)


def getenv(name):
    return os.environ.get(name)


def setenv(name, value):
    os.environ[name] = str(value)


def default_array(source_array, ctx=None, dtype=None):
    """An NDArray of ``source_array`` on ``ctx`` (the current device by
    default: the card unless the caller asks for the CPU)."""
    from .ndarray.ndarray import NDArray

    return NDArray(source_array, device=ctx, dtype=dtype)


def default_num_workers():
    """The data loader's default worker count: MXNET_CPU_WORKER_NTHREADS,
    or its alias MXNET_MP_WORKER_NTHREADS; 0 when unset or junk."""
    v = os.environ.get("MXNET_CPU_WORKER_NTHREADS") \
        or os.environ.get("MXNET_MP_WORKER_NTHREADS")
    try:
        return max(0, int(v)) if v else 0
    except ValueError:
        return 0


def default_worker_retries():
    """The data loader's retries of a worker task (MXNET_WORKER_RETRIES,
    default 2)."""
    v = os.environ.get("MXNET_WORKER_RETRIES")
    try:
        return max(0, int(v)) if v else 2
    except ValueError:
        return 2


def _env_number(name, default, parse):
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return parse(v)
    except ValueError:
        logging.getLogger("incubator_mxnet_tpu_torch").warning(
            "%s=%r is not a number; using %r", name, v, default)
        return default


def env_int(name, default):
    """Integer env knob with a logged fallback on junk values (the shared
    reader behind the MXNET_SERVE_* numeric knobs)."""
    return _env_number(name, default, int)


def env_float(name, default):
    """Float env knob with a logged fallback on junk values."""
    return _env_number(name, default, float)


_ENV_KNOBS = {
    "MXNET_CPU_WORKER_NTHREADS": (
        "util.default_num_workers", "the data loader's default worker "
        "count (gluon.data.DataLoader with num_workers=None)"),
    "MXNET_MP_WORKER_NTHREADS": (
        "util.default_num_workers", "alias consulted after "
        "MXNET_CPU_WORKER_NTHREADS for the default worker count"),
    "MXNET_WORKER_RETRIES": (
        "util.default_worker_retries", "the data loader's worker-task "
        "retry budget (default 2)"),
    "MXNET_MP_OPENCV_NUM_THREADS": (
        "gluon.data.DataLoader workers", "cv2.setNumThreads in each "
        "worker (keeps P workers from P x N decode threads)"),
    "MXNET_MP_START_METHOD": (
        "gluon.data.DataLoader", "the workers' multiprocessing start "
        "method; default forkserver, else spawn (a forked child of a "
        "process with a CUDA context cannot use CUDA)"),
    "MXNET_TELEMETRY_INTERVAL": (
        "telemetry.monitor.TelemetryHandler", "batches between registry "
        "log lines in the estimator loop; 0/unset = epoch-end only"),
    "MXNET_GLUON_REPO": (
        "gluon.model_zoo model_store", "override the pretrained-artifact "
        "root (a local directory; nothing downloads)"),
    "MXNET_HOME": (
        "gluon.model_zoo model_store", "data/artifact cache root: "
        "pretrained weights resolve in $MXNET_HOME/models"),
    "MXNET_SAFE_ACCUMULATION": (
        "npx.softmax", "1 -> a float16 or bfloat16 input reduces in f32 "
        "and the output takes the input's dtype back (products "
        "accumulate in f32 regardless)"),
    "MXNET_SERVE_MAX_QUEUE": (
        "serve.ServeEngine", "admission-queue depth before submit() "
        "raises QueueFull (default 128)"),
    "MXNET_SERVE_POLICY": (
        "serve.ServeEngine", "admission order: fifo (default) or sjf "
        "(fewest remaining prefill chunks first)"),
    "MXNET_SERVE_DEADLINE_S": (
        "serve.ServeEngine", "default per-request deadline in seconds; "
        "expiry fails the request with DeadlineExceeded; unset = none"),
    "MXNET_SERVE_PAGE_TOKENS": (
        "serve.SlotDecoder", "tokens per KV-cache page of the paged pool "
        "(default 16)"),
    "MXNET_SERVE_PREFILL_CHUNK": (
        "serve.SlotDecoder", "prefill chunk ceiling in tokens (default 64, "
        "rounded up to a page multiple)"),
    "MXNET_SERVE_KV_DTYPE": (
        "serve.SlotDecoder", "fp (default) or int8: int8 stores the KV "
        "pool quantized with one scale per (layer, page, head) — half "
        "the resident KV bytes per slot, parity within tolerance "
        "(honored, this build's addition)"),
    "MXNET_SERVE_SPEC_K": (
        "serve.SlotDecoder", "speculative-decoding draft length "
        "(default 0 = off): each decode round drafts k tokens and "
        "verifies all k+1 rows in one batched target program; greedy "
        "output stays token-for-token identical (honored, this "
        "build's addition — see SERVING.md)"),
    "MXNET_SERVE_SPEC_DRAFT": (
        "serve.SlotDecoder", "draft source when SPEC_K > 0: ngram "
        "(default, host n-gram proposer — zero extra device programs); "
        "a draft *model* is passed programmatically via "
        "ServeEngine(draft=...) or Gateway registry.add(..., draft=...) "
        "(honored, this build's addition — see SERVING.md)"),
    "MXNET_TELEMETRY": (
        "telemetry", "1 = the funnel's stage probes, span tracing, the lock "
        "witness, the program ledger, the device-memory census and the "
        "goodput ledger on (the capacity and anatomy ledgers arm "
        "themselves from it); raise / warn = the same plus the NaN guard "
        "in that mode; 0/unset = off with zero per-op cost (honored, this "
        "build's addition)"),
    "MXNET_TELEMETRY_DUMP": (
        "telemetry.registry.arm_textfile_dump", "<path>[:interval_s] — "
        "atomic Prometheus exposition() snapshots to a textfile for "
        "node-exporter scraping, refreshed every interval_s when given "
        "(honored, this build's addition)"),
    "MXNET_ANALYSIS": (
        "analysis.audit", "warn|raise: program-auditor findings are logged "
        "as warnings or raised as MXNetError; unset returns reports "
        "silently (honored, this build's addition)"),
    "MXNET_PROFILER_AUTOSTART": (
        "profiler", "start the profiler at import (honored)"),
    "MXNET_PROFILER_MODE": (
        "profiler.set_config", "0 = device only (imperative op timing "
        "off), 1 = all (honored at autostart)"),
    "MXNET_MEMWATCH_INTERVAL": (
        "telemetry.hbm.arm_memwatch", "seconds between HBM growth-watchdog "
        "census samples (daemon thread); warns on sustained unattributed "
        "live-buffer growth; 0/unset = no sampler (honored, this build's "
        "addition — see TELEMETRY.md)"),
    "MXNET_OOM_POSTMORTEM": (
        "telemetry.hbm.maybe_oom_postmortem", "1 = flight-dump census + top "
        "buffers + program ledger when an out-of-memory error crosses the "
        "serving engine's or the gateway's step, even with MXNET_TELEMETRY "
        "off; 0 = force off; unset = follows MXNET_TELEMETRY (honored, "
        "this build's addition)"),
    "MXNET_FLIGHTREC_DIR": (
        "telemetry.tracing.flight_dump", "directory for crash flight-recorder"
        " dumps (default: cwd) (honored, this build's addition)"),
    "MXNET_FAULT_INJECT": (
        "fault.injection", "seeded chaos schedule "
        "'seam[@rank]:prob[:seed[:limit[:kind]]],...' (kind: fault | oom | "
        "delay | topology, or shrink=N for a sized topology shrink; @rank "
        "targets one process of a multi-rank launch) armed at import; unset "
        "= every probe a dead branch "
        "(honored, this build's addition — see RESILIENCE.md)"),
    "MXNET_FAULT_DELAY_MS": (
        "fault.injection", "milliseconds a delay-kind injected fault sleeps "
        "(default 50) — the deterministic-straggler magnitude for the "
        "collective_delay seam (honored, this build's addition — see "
        "TELEMETRY.md)"),
    "MXNET_SHARDCHECK": (
        "analysis.shardcheck / parallel.sharded.DataParallel",
        "warn|raise: trainers run the static sharding pre-flight (rules "
        "SC001-SC006) at construction and log or raise on findings; "
        "unset = off (honored, this build's addition — see ANALYSIS.md)"),
    "MXNET_SHARDCHECK_HBM_GB": (
        "analysis.shardcheck", "per-device HBM budget in GiB for the "
        "SC006 static OOM check; unset/0 disables the budget comparison "
        "(honored, this build's addition)"),
    "MXNET_ELASTIC": (
        "fault.elastic + preemption", "elastic-topology master switch "
        "(default ON): 0 = ElasticController.poll() is a dead branch "
        "and a checkpoint whose layout sidecar disagrees with the live "
        "topology raises LayoutMismatch instead of resharding (honored, "
        "this build's addition — see RESILIENCE.md)"),
    "MXNET_ELASTIC_MIN_RANKS": (
        "fault.elastic.ElasticController", "smallest membership a "
        "re-rendezvous may commit (default 1); a roster below this "
        "fails the transition instead of limping (honored, this "
        "build's addition — see RESILIENCE.md)"),
    "MXNET_ELASTIC_DRAIN_S": (
        "parallel.dist.rendezvous", "seconds the membership-epoch "
        "rendezvous waits for the roster to settle before committing "
        "the survivor set (default 20) (honored, this build's addition "
        "— see RESILIENCE.md)"),
    "MXNET_ELASTIC_SERVE": (
        "serve.Gateway", "1 = arm a serve.elastic.ReplicaSetController on the"
        " gateway step loop: AutoscaleAdvisor recommendations are ACTED on "
        "(spawn/drain replicas), crashed replicas are replaced with their "
        "queued work re-dispatched (default off — the advisor stays "
        "observe-only) (honored, this build's addition — see SERVING.md)"),
    "MXNET_ELASTIC_MIN_REPLICAS": (
        "serve.elastic.ReplicaSetController", "smallest per-model replica "
        "count the controller may drain to, and the floor it heals back up to"
        " after a crash (default 1) (honored, this build's addition — see "
        "SERVING.md)"),
    "MXNET_ELASTIC_MAX_REPLICAS": (
        "serve.elastic.ReplicaSetController", "largest per-model replica "
        "count a scale-up may commit — the page budget is rebalanced "
        "against this ceiling before any engine is built (default 8) "
        "(honored, this build's addition — see SERVING.md)"),
    "MXNET_RACECHECK_HOLD_S": (
        "telemetry.locks", "armed tracked-lock hold time in seconds above "
        "which a one-shot long-hold warning names the lock (default 1.0) "
        "(honored, this build's addition — see TELEMETRY.md)"),
    "MXNET_GOODPUT": (
        "telemetry.goodput", "1 = arm the training goodput ledger alone "
        "(lease(), mx_goodput_seconds_total{state=} + mx_goodput_frac; "
        "its producers are not ported yet); also armed by MXNET_TELEMETRY "
        "(honored, this build's addition)"),
    "MXNET_RETRY_MAX": (
        "fault.RetryPolicy.from_env", "default max retries for the "
        "kvstore/dist_init/checkpoint policies (default 3) (honored, this "
        "build's addition)"),
    "MXNET_RETRY_BASE_DELAY_MS": (
        "fault.RetryPolicy.from_env", "first backoff delay in ms (default 50;"
        " doubles per retry, jittered) (honored, this build's addition)"),
    "MXNET_RETRY_DEADLINE_S": (
        "fault.RetryPolicy.from_env", "optional wall-clock retry budget per "
        "call (honored, this build's addition)"),
    "MXNET_OPTIMIZER_AGGREGATION_SIZE": (
        "parallel.sharded fused updates", "0/1 disables the multi-tensor "
        "small-parameter fusion; >1 keeps it (honored; grouping is one "
        "concatenated segment, not count-sized batches)"),
    "MXNET_SERVE_PRIORITY_TIERS": (
        "serve.Gateway", "comma-separated priority tier names, highest first "
        "(default high,normal,low); the gateway keeps one WDRR queue per tier"
        " and higher tiers may preempt lower ones (honored, this build's "
        "addition — see SERVING.md)"),
    "MXNET_SERVE_TENANT_QUOTA": (
        "serve.Gateway", "default per-tenant token-rate quota as rate[:burst]"
        " tokens/s (burst defaults to 4x rate); unset/0 = unmetered — "
        "over-quota tenants are deferred, never dropped (honored, this "
        "build's addition)"),
    "MXNET_SERVE_REPLICAS": (
        "serve.ModelRegistry", "decode replicas per registered model behind "
        "the gateway router (default 1); each replica owns its own mesh "
        "slice, KV pool, and prefix cache (honored, this build's addition — "
        "see SERVING.md)"),
    "MXNET_DISAGG": (
        "serve.ModelRegistry", "1 = every freshly-built gateway model "
        "defaults to a DISAGGREGATED pod: dedicated prefill replicas hand "
        "finished prompts' KV pages to dedicated decode replicas through the "
        "serve/disagg.py migration plane (default off; explicit "
        "prefill_replicas=/decode_replicas= per model wins) (honored, this "
        "build's addition — see SERVING.md)"),
    "MXNET_SERVE_PREFILL_REPLICAS": (
        "serve.ModelRegistry", "prefill-role replicas per model under "
        "MXNET_DISAGG=1 (default 1): chunked-prefill only, ~25% of the "
        "model's page cut, slots turn over per prompt (honored, this build's "
        "addition — see SERVING.md)"),
    "MXNET_SERVE_DECODE_REPLICAS": (
        "serve.ModelRegistry", "decode-role replicas per model under "
        "MXNET_DISAGG=1 (default 1): adopt-only gather-by-table decode — "
        "never compile a prefill program (compile-ledger gated) and carry the"
        " decode side's page budget (honored, this build's addition — see "
        "SERVING.md)"),
    "MXNET_SERVE_AFFINITY": (
        "serve.ReplicaRouter", "replica-routing affinity: prefix (default, "
        "route to the replica whose prefix cache scores the warmest match), "
        "tenant (stable hash of the tenant id), or off (pure least-loaded) "
        "(honored, this build's addition — see SERVING.md)"),
    "MXNET_GATEWAY_MAX_QUEUE": (
        "serve.Gateway", "gateway admission bound across all priority tiers "
        "before submit() raises QueueFull (default 256) (honored, this "
        "build's addition)"),
    "MXNET_GATEWAY_QUANTUM": (
        "serve.Gateway", "WDRR quantum in tokens granted per tenant visit "
        "(default 256): larger = coarser fairness granularity, lower rotation"
        " overhead (honored, this build's addition)"),
    "MXNET_GATEWAY_PREEMPT": (
        "serve.Gateway", "1 (default) lets higher-tier arrivals preempt "
        "lower-tier running slots (page-aligned KV kept warm in the prefix "
        "cache for the resume); 0 disables preemption (honored, this build's "
        "addition)"),
    "MXNET_TS_INTERVAL": (
        "telemetry.timeseries", "sampling interval in seconds for the "
        "registry time-series history layer; any value but ''/0 also "
        "self-arms the sampler at import (default 1.0 once enabled) (honored,"
        " this build's addition — see TELEMETRY.md)"),
    "MXNET_TS_SAMPLES": (
        "telemetry.timeseries", "ring-buffer capacity per series for the "
        "time-series history layer (default 512 samples; memory is bounded at"
        " ~16 bytes x samples x series) (honored, this build's addition)"),
    "MXNET_BURN_WINDOWS": (
        "telemetry.burnrate", "multi-window burn-rate alert spec as "
        "'<window_s>@<factor>[,...]' (default '300@14.4,3600@6' — the SRE "
        "fast-5m/slow-1h pair) consumed by burnrate.arm_default() (honored, "
        "this build's addition)"),
    "MXNET_ADVISOR": (
        "serve.Gateway", "arm one observe-only AutoscaleAdvisor per gateway "
        "model: 1 = evaluate every 5 s on the step loop, a float = that "
        "period in seconds; recommendations land in Gateway.advisor_log() and"
        " mx_advisor_recommendation{action=} (honored, this build's "
        "addition)"),
    "MXNET_ANATOMY_SAMPLE": (
        "telemetry.anatomy", "fraction of NORMAL request completions archived"
        " in the sampled ring (default 0.05, clamped to [0,1]); flagged "
        "requests (SLO violation / preempted / migrated / crash resume) are "
        "always retained regardless (honored, this build's addition)"),
    "MXNET_SERVE_MESH": (
        "serve.sharded.serve_mesh", "default serving mesh spec of a "
        "ShardedSlotDecoder built without mesh=: 'tp=4', '4' or "
        "'fsdp=1,tp=4' (default tp=1); its ranks are the world's first "
        "prod(sizes) (honored, this build's addition)"),
    "MXNET_FLEET": (
        "telemetry.fleet", "1 = arm the cross-rank fleet plane alone "
        "(collective profiler, barrier skew, flightrec rank stamp + crash "
        "fanout); also armed by MXNET_TELEMETRY; enable on EVERY rank or "
        "none (honored, this build's addition)"),
    "MXNET_FLEET_SKEW_EVERY": (
        "telemetry.fleet", "sample the barrier arrival-skew exchange every "
        "Nth barrier (default 1 = every barrier; 0 = off — the exchange adds"
        " one collective per sampled barrier) (honored, this build's "
        "addition)"),
    "MXNET_FLEET_CHUNK_BYTES": (
        "telemetry.fleet.exchange_large", "chunk size for the registry-"
        "snapshot exchange past the 4 KiB exchange_objs slot (default 3000)"
        " (honored, this build's addition)"),
    "MXNET_FLEET_STRAGGLER_Z": (
        "telemetry.fleet.install_health_check", "straggler z-score above "
        "which monitor.check() raises (default 2.5) (honored, this build's "
        "addition)"),
    "MXNET_FLEET_TRACE_DIR": (
        "telemetry.fleet.dump_rank_trace", "directory for per-rank fleet "
        "span dumps (default: the flightrec dir) (honored, this build's "
        "addition)"),
    "MXNET_ANATOMY_RING": (
        "telemetry.anatomy", "depth of EACH request-archive ring (tail + "
        "sampled; default 256, min 1) — bounds the goodput observatory's "
        "memory (honored, this build's addition)"),
}


def env_knobs():
    """The knob table: name -> (reader, description)."""
    return dict(_ENV_KNOBS)


def _apply_env_config():
    """Honor the arming knobs at the package's import, as the reference's
    `_apply_env_config` does for the modules the port has: a truthy
    ``MXNET_TELEMETRY`` arms the funnel's stage probes, span tracing, the
    lock witness, the program ledger, the device-memory census, the fleet
    plane and the goodput ledger (the capacity and anatomy ledgers arm themselves from
    it at import), and ``raise`` or ``warn`` the NaN guard in that mode;
    ``MXNET_TELEMETRY_DUMP=<path>[:interval_s]`` the registry's textfile
    snapshots;
    ``MXNET_GOODPUT`` arms the goodput ledger alone, ``MXNET_FLEET`` the
    fleet plane alone,
    ``MXNET_MEMWATCH_INTERVAL`` the memory watchdog's thread, and
    ``MXNET_FAULT_INJECT`` the chaos schedule. ``MXNET_OOM_POSTMORTEM`` is
    read at each failure; ``MXNET_TS_INTERVAL`` arms the timeseries
    sampler at that module's import."""
    telem = os.environ.get("MXNET_TELEMETRY", "0")
    if telem and telem != "0":
        from .telemetry import (compiles, fleet, goodput, hbm, locks,
                                monitor, stages, tracing)

        stages.enable()
        tracing.enable()
        locks.enable()
        compiles.enable()       # program ledger + recompile forensics
        hbm.enable()            # device-memory census gauges + OOM seams
        fleet.enable()          # cross-rank collective profiler + fanout
        goodput.enable()        # training goodput ledger (lease seams)
        if telem in ("raise", "warn"):
            monitor.install_nan_hook(mode=telem)
    if os.environ.get("MXNET_FLEET", "0") not in ("0", ""):
        # the fleet plane alone; set on EVERY rank or none: the barrier
        # skew exchange is itself a collective
        from .telemetry import fleet as _fleet

        _fleet.enable()
    if os.environ.get("MXNET_GOODPUT", "0") not in ("0", ""):
        from .telemetry import goodput as _goodput

        _goodput.enable()
    watch = os.environ.get("MXNET_MEMWATCH_INTERVAL")
    if watch:
        try:
            interval = float(watch)
        except ValueError:
            interval = 0.0
        if interval > 0:
            from .telemetry import hbm as _hbm

            _hbm.arm_memwatch(interval)
    if os.environ.get("MXNET_FAULT_INJECT"):
        from .fault import injection

        injection.configure_from_env()
    dump_spec = os.environ.get("MXNET_TELEMETRY_DUMP")
    if dump_spec:
        from .telemetry import registry as _registry

        try:
            _registry.arm_textfile_dump(dump_spec)
        except OSError as e:
            import logging

            logging.getLogger("incubator_mxnet_tpu_torch.telemetry").warning(
                "MXNET_TELEMETRY_DUMP=%s: cannot write the snapshot: %s",
                dump_spec, e)
