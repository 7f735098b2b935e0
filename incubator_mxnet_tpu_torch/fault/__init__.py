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
  replacement for a silent ``except Exception: pass``;
- `resilience` — :class:`ResilienceHandler` for the Estimator: skip
  non-finite-loss steps (with AMP loss-scale backoff), auto-resume from
  the last good checkpoint after a mid-step crash, checkpoint cadence,
  and the elastic controller polled at every drained step boundary;
- `elastic` — :class:`~.elastic.ElasticController`: survive a rank
  leaving or joining the fleet (a vote through the store, a shardcheck
  pre-flight, a drain checkpoint, `dist.rendezvous` and the trainer
  resharded onto the survivors' mesh), and the checkpoint-layout sidecar
  that reshards a checkpoint onto another rank count.

Recoveries are counted in the registry: ``mx_faults_injected_total``,
``mx_retries_total``, ``mx_steps_skipped_nonfinite_total``,
``mx_resumes_total``, ``mx_checkpoint_fallbacks_total``,
``mx_dataloader_fallbacks_total``.
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
           "suppressed", "resilience", "ResilienceHandler", "elastic",
           "ElasticController"]


def __getattr__(name):
    # `resilience` imports gluon's estimator handlers; gluon is mid-import
    # when the package first imports `fault`, so the handler half loads
    # lazily (PEP 562) on first touch
    if name in ("ResilienceHandler", "resilience"):
        import importlib

        mod = importlib.import_module(".resilience", __name__)
        if name == "resilience":
            return mod
        return mod.ResilienceHandler
    if name in ("ElasticController", "elastic"):
        # the same late binding: `elastic` pulls in parallel/ and
        # analysis/, which are mid-import on first package touch
        import importlib

        mod = importlib.import_module(".elastic", __name__)
        if name == "elastic":
            return mod
        return mod.ElasticController
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
