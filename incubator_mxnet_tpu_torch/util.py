"""Environment knobs (port of `incubator_mxnet_tpu/util.py`: `env_int` :94,
`env_float` :100, and the serving rows of the knob table :371-408).

Only the ``MXNET_SERVE_*`` knobs that the ported serving engine reads are
here. Two of the reference's knobs select paths the port does not have
yet: ``MXNET_SERVE_KV_DTYPE=int8`` and ``MXNET_SERVE_SPEC_K`` > 0 raise
`MXNetError` in `serve.SlotDecoder` rather than being ignored.
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
        "serve.SlotDecoder", "fp (default); int8 is not ported yet and "
        "raises MXNetError (ROADMAP.md)"),
    "MXNET_SERVE_SPEC_K": (
        "serve.SlotDecoder", "0 (default); speculative decoding (> 0) is "
        "not ported yet and raises MXNetError (ROADMAP.md)"),
}


def env_knobs():
    """The knob table: name -> (reader, description)."""
    return dict(_ENV_KNOBS)
