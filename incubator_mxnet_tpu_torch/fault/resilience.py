"""Graceful degradation + the self-healing training loop (port of
`incubator_mxnet_tpu/fault/resilience.py`).

:class:`ResilienceHandler` is an Estimator event handler (a
`event_handler.StepGuard`) closing the recovery loops of elastic
training:

1. **non-finite-loss steps are skipped** — the optimizer update is vetoed
   (`pre_step` → True), the AMP dynamic loss scale backs off when AMP is
   active (the `amp.LossScaler`), any pending NaN-hook finding from
   `telemetry.monitor` is cleared so a ``MXNET_TELEMETRY=raise`` run
   doesn't die on the step it just recovered from, and
   ``mx_steps_skipped_nonfinite_total`` counts the skip. A bounded run of
   consecutive skips (`max_consecutive_skips`) fails LOUDLY — an
   always-NaN model must not spin forever;
2. **mid-step crashes auto-resume** — any retryable exception escaping the
   step body (`on_crash`) reloads the last good checkpoint generation
   through `preemption.TrainingCheckpointer.resume()` (which itself
   checksum-validates and falls back past corrupt generations), counts
   ``mx_resumes_total``, and training continues with the next batch.
   Before the resume, an out-of-memory error writes its post-mortem
   (`telemetry.hbm.maybe_oom_postmortem`) and any other crash a flight
   record (`telemetry.tracing.maybe_flight_dump`). Fatal-class errors
   (see `retry.classify_exception`) and exhausted resume budgets
   re-raise;
3. **checkpoint cadence** — with a `checkpointer`, every `batch_end`
   advances `TrainingCheckpointer.step()` (periodic + SIGTERM-triggered
   saves), so there is always a recent generation to resume from;
4. **topology changes** — with an ``elastic=`` controller
   (`fault.elastic.ElasticController`), every `batch_end` (a drained
   step boundary) polls it; a ``"leave"`` verdict ends the fit cleanly.
"""
from __future__ import annotations

import numpy as onp

from ..gluon.contrib.estimator.event_handler import (BatchEnd, StepGuard,
                                                     TrainBegin)
from .retry import classify_exception

__all__ = ["ResilienceHandler"]


def _registry():
    from ..telemetry import registry

    return registry


def _tracing():
    from ..telemetry import tracing

    return tracing


class ResilienceHandler(StepGuard, TrainBegin, BatchEnd):
    """Self-healing Estimator handler (see module docstring).

    Parameters
    ----------
    checkpointer : preemption.TrainingCheckpointer, optional
        Save cadence + the resume source for crash recovery. Without one,
        `on_crash` declines (crashes propagate) and only non-finite-step
        skipping is active.
    skip_nonfinite : bool
        Veto the optimizer update when the batch loss is non-finite.
    max_resumes : int
        Crash-resume budget per `fit` call; the next crash re-raises.
    max_consecutive_skips : int
        Loud-failure bound on back-to-back non-finite steps.
    elastic : fault.elastic.ElasticController, optional
        Polled at every `batch_end` — the drained step boundary an
        elastic topology transition needs. A ``"leave"`` verdict stops
        the fit loop cleanly (this rank departed the fleet).
    """

    def __init__(self, checkpointer=None, skip_nonfinite=True,
                 max_resumes=2, max_consecutive_skips=50, priority=-90,
                 elastic=None):
        self.checkpointer = checkpointer
        self.skip_nonfinite = skip_nonfinite
        self.max_resumes = int(max_resumes)
        self.max_consecutive_skips = int(max_consecutive_skips)
        self.priority = priority
        self.elastic = elastic
        self._resumes = 0
        self._consecutive_skips = 0

    # -- lifecycle ----------------------------------------------------------
    def train_begin(self, estimator, *args, **kwargs):
        self._resumes = 0
        self._consecutive_skips = 0

    def batch_end(self, estimator, *args, **kwargs):
        if self.checkpointer is not None:
            self.checkpointer.step()
        if self.elastic is not None:
            if self.elastic.poll() == "leave":
                # departed: stop feeding steps; the process should exit 0
                # (tools.launcher kills the fleet on a non-zero exit)
                estimator.logger.warning(
                    "resilience: this rank left the fleet (elastic "
                    "departure) — ending fit")
                estimator.stop_training = True

    # -- step guard ---------------------------------------------------------
    def pre_step(self, estimator, loss, batch):  # noqa: ARG002
        if not self.skip_nonfinite or loss is None:
            return False
        finite = bool(onp.isfinite(onp.asarray(loss.asnumpy())).all())
        if finite:
            self._consecutive_skips = 0
            return False
        self._consecutive_skips += 1
        _registry().counter(
            "mx_steps_skipped_nonfinite_total",
            "optimizer steps vetoed on a non-finite loss").inc()
        _tracing().event("resilience.skip_nonfinite",
                         consecutive=self._consecutive_skips)
        self._amp_backoff(estimator)
        self._clear_nan_findings()
        estimator.logger.warning(
            "resilience: non-finite loss — skipping optimizer step "
            "(%d consecutive)", self._consecutive_skips)
        if self._consecutive_skips > self.max_consecutive_skips:
            from ..base import MXNetError

            raise MXNetError(
                f"resilience: {self._consecutive_skips} consecutive "
                "non-finite-loss steps — the model is diverged, not "
                "transiently unstable; aborting (raise "
                "max_consecutive_skips to override)")
        return True

    @staticmethod
    def _amp_backoff(estimator):
        """Halve the AMP dynamic loss scale when a scaler is live — the
        reference's LossScaler overflow reaction, triggered from the loop
        instead of a per-grad isfinite sweep."""
        from .. import amp

        scaler = amp.scale_loss._scaler
        if scaler is not None and amp._STATE.active:  # noqa: SLF001
            old = scaler.loss_scale
            scaler.update_scale(True)
            estimator.logger.warning(
                "resilience: AMP loss scale backoff %.3g -> %.3g",
                old, scaler.loss_scale)

    @staticmethod
    def _clear_nan_findings():
        import sys

        mon = sys.modules.get("incubator_mxnet_tpu_torch.telemetry.monitor")
        if mon is not None:
            mon.clear_nan_findings()

    # -- crash recovery -----------------------------------------------------
    def on_crash(self, estimator, exc):
        from ..base import MXNetError

        if self.checkpointer is None:
            return False
        if isinstance(exc, MXNetError):
            # framework-raised invariants (the NaN guard, the divergence
            # abort above) are verdicts, not transient faults — a resume
            # would replay them forever
            return False
        if classify_exception(exc) == "fatal":
            estimator.logger.error(
                "resilience: fatal %s — not resuming: %s",
                type(exc).__name__, exc)
            return False
        if self._resumes >= self.max_resumes:
            estimator.logger.error(
                "resilience: resume budget (%d) exhausted; re-raising %s",
                self.max_resumes, type(exc).__name__)
            return False
        # postmortem context BEFORE the resume rewinds state: the dump
        # carries the crashed step's spans and the fault that fired
        # (an out-of-memory error upgrades to the OOM post-mortem with
        # the device-memory census + program ledger in the payload)
        from ..telemetry import goodput
        from ..telemetry import hbm as _hbm

        # the whole crash-recovery tail is goodput `recovery` time (the
        # checkpointer.resume() below holds its own recovery lease too —
        # same state, so nesting is a no-op attribution-wise)
        with goodput.lease("recovery"):
            if _hbm.maybe_oom_postmortem("estimator_step", exc) is None:
                _tracing().maybe_flight_dump("estimator_crash", exc)
            step = self.checkpointer.resume()
        self._resumes += 1
        _registry().counter(
            "mx_resumes_total",
            "auto-resumes from the last good checkpoint").inc()
        _tracing().event("resilience.resume", step=step,
                         resume=self._resumes,
                         error=type(exc).__name__)
        estimator.logger.warning(
            "resilience: %s mid-step (%s) — resumed from checkpoint step "
            "%d (resume %d/%d)", type(exc).__name__, exc, step,
            self._resumes, self.max_resumes)
        return True
