"""Environment knobs (port of `incubator_mxnet_tpu/util.py`: `env_int` :94,
`env_float` :100, the serving rows of the knob table :371-408, and the
telemetry and fault-injection arming of `_apply_env_config` :571).

Only the ``MXNET_SERVE_*`` knobs that the ported serving engine reads are
in the table, with the reference's texts.
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
}


def env_knobs():
    """The knob table: name -> (reader, description)."""
    return dict(_ENV_KNOBS)


def _apply_env_config():
    """Honor the arming knobs at the package's import, as the reference's
    `_apply_env_config` does for the modules the port has: a truthy
    ``MXNET_TELEMETRY`` arms span tracing and the lock witness (the
    capacity and anatomy ledgers arm themselves from it at import), and
    ``MXNET_FAULT_INJECT`` arms the chaos schedule."""
    telem = os.environ.get("MXNET_TELEMETRY", "0")
    if telem and telem != "0":
        from .telemetry import locks, tracing

        tracing.enable()
        locks.enable()
    if os.environ.get("MXNET_FAULT_INJECT"):
        from .fault import injection

        injection.configure_from_env()
