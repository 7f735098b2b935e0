"""Fault tolerance, its host-side half (port of
`incubator_mxnet_tpu/fault/__init__.py`, `injection.py` and `retry.py`):

- `injection` — seeded chaos schedules (``MXNET_FAULT_INJECT=
  "seam[@rank]:prob[:seed[:limit[:kind]]]"``) firing :class:`FaultInjected`
  at probe points threaded through the real seams. The port's probes so
  far: the serving engine's step loop (``serve_step``), the gateway's
  (``gateway_step``) and the disaggregation hand-off (``page_migration``);
  every name of the reference's `SEAMS` is a valid seam, its probe coming
  with the module that owns it. Off = dead branches;
- `retry` — :class:`RetryPolicy` (jittered exponential backoff, deadline,
  retryable-vs-fatal classification) and `suppressed()`, the logged
  replacement for a silent ``except Exception: pass``.

The reference's `resilience` (the Estimator's handler) and `elastic` (the
topology controller) are not ported yet (`ROADMAP.md` §1 item 10).
Recoveries are counted in the registry: ``mx_faults_injected_total``,
``mx_retries_total``.
"""
from __future__ import annotations

from . import injection, retry
from .injection import (SEAMS, FaultInjected, clear_injection,
                        configure_from_env, configure_injection, inject_at,
                        injection_enabled, schedule_info)
from .retry import (RetryExhausted, RetryPolicy, classify_exception,
                    retry_call, suppressed)

__all__ = ["injection", "retry", "FaultInjected", "SEAMS", "inject_at",
           "injection_enabled", "configure_injection", "configure_from_env",
           "clear_injection", "schedule_info", "RetryPolicy",
           "RetryExhausted", "classify_exception", "retry_call",
           "suppressed"]
