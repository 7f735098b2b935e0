"""Environment knobs (port of `incubator_mxnet_tpu/util.py`: `env_int` :94,
`env_float` :100, the knob table :110-507, and the telemetry,
fault-injection, goodput, memory-watch and post-mortem arming of
`_apply_env_config` :571).

The table holds every knob the port reads, with the reference's texts
(where the port's behaviour differs, the port's).
"""
from __future__ import annotations

import logging
import os

__all__ = ["env_int", "env_float", "env_knobs"]


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
        "telemetry", "1 = span tracing, the lock witness, the program "
        "ledger, the device-memory census and the goodput ledger on (the "
        "capacity and anatomy ledgers arm themselves from it); 0/unset = "
        "off with zero per-op cost (honored, this build's addition)"),
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
    ``MXNET_TELEMETRY`` arms span tracing, the lock witness, the program
    ledger, the device-memory census and the goodput ledger (the capacity
    and anatomy ledgers arm themselves from it at import);
    ``MXNET_GOODPUT`` arms the goodput ledger alone,
    ``MXNET_MEMWATCH_INTERVAL`` the memory watchdog's thread, and
    ``MXNET_FAULT_INJECT`` the chaos schedule. ``MXNET_OOM_POSTMORTEM`` is
    read at each failure; ``MXNET_TS_INTERVAL`` arms the timeseries
    sampler at that module's import."""
    telem = os.environ.get("MXNET_TELEMETRY", "0")
    if telem and telem != "0":
        from .telemetry import compiles, goodput, hbm, locks, tracing

        tracing.enable()
        locks.enable()
        compiles.enable()       # program ledger + recompile forensics
        hbm.enable()            # device-memory census gauges + OOM seams
        goodput.enable()        # training goodput ledger (lease seams)
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
