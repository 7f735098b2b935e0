"""Estimator event handlers (port of
`incubator_mxnet_tpu/gluon/contrib/estimator/event_handler.py`; reference:
`python/mxnet/gluon/contrib/estimator/event_handler.py:37-746`).

Handlers are mixin classes keyed by lifecycle hook; the Estimator sorts
them by priority and invokes each hook across the train/eval loop.
Checkpoints go through `Block.save_parameters` (npz) and
`Trainer.save_states`, both crash-safe with a checksum sidecar
(`preemption.atomic_save`), and a preemption (SIGTERM, or
`preemption.trigger()`) saves at once.
"""
from __future__ import annotations

import logging
import os
import time
import warnings

import numpy as onp

__all__ = ["EventHandler", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StepGuard", "StoppingHandler",
           "MetricHandler", "ValidationHandler", "LoggingHandler",
           "CheckpointHandler", "EarlyStoppingHandler"]


class EventHandler:
    pass


def _check_event_handlers(handlers):
    if isinstance(handlers, EventHandler):
        handlers = [handlers]
    else:
        handlers = handlers or []
        if not all(isinstance(h, EventHandler) for h in handlers):
            raise ValueError("event_handlers must be EventHandler instances")
    return handlers


class TrainBegin(EventHandler):
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd(EventHandler):
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin(EventHandler):
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd(EventHandler):
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin(EventHandler):
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd(EventHandler):
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StepGuard(EventHandler):
    """Handlers that sit INSIDE the train-step body (the fault-tolerance
    seam; MXNet's own loop has no recovery story beyond
    checkpoint-restart). `pre_step` runs between
    backward and `trainer.step` and may veto the parameter update (return
    True to SKIP — e.g. a non-finite loss); `on_crash` sees any exception
    the step body raised and may absorb it (return True after restoring a
    consistent training state — e.g. `fault.ResilienceHandler` reloading
    the last good checkpoint)."""

    def pre_step(self, estimator, loss, batch):  # noqa: ARG002
        return False

    def on_crash(self, estimator, exc):  # noqa: ARG002
        return False


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after max_epoch epochs or max_batch batches
    (reference: event_handler.py:82)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.max_epoch = estimator.max_epoch
        self.max_batch = estimator.max_batch
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch == self.max_batch:
            estimator.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch == self.max_epoch:
            estimator.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Reset metrics at epoch begin, update at batch end
    (reference: event_handler.py:122)."""

    def __init__(self, metrics, priority=-1000):
        self.metrics = metrics
        self.priority = priority

    def epoch_begin(self, estimator, *args, **kwargs):
        for metric in self.metrics:
            metric.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs["pred"]
        label = kwargs["label"]
        loss = kwargs["loss"]
        from ....gluon.metric import Loss

        for metric in self.metrics:
            if isinstance(metric, Loss):
                metric.update(0, loss)
            else:
                metric.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation every `epoch_period` epochs / `batch_period` batches
    (reference: event_handler.py:160)."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000, event_handlers=None):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.priority = priority
        self.event_handlers = event_handlers
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data,
                         event_handlers=self.event_handlers)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data,
                         event_handlers=self.event_handlers)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Log training progress (reference: event_handler.py:226)."""

    def __init__(self, log_interval="epoch", metrics=None, priority=-1000):
        self.metrics = metrics or []
        self.priority = priority
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0
        # log_interval: "epoch" → epoch-level logs only; int N ≥ 1 → a log
        # line every N batches (N=1 logs every batch)
        if log_interval == "epoch":
            self.log_interval = None
        elif isinstance(log_interval, int) and log_interval >= 1:
            self.log_interval = log_interval
        else:
            raise ValueError("log_interval must be 'epoch' or a positive int")
        self.log_interval_time = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        estimator.logger.info(
            "Training begin: using optimizer %s with current learning rate"
            " %.4f", type(estimator.trainer.optimizer).__name__,
            estimator.trainer.learning_rate)
        if estimator.max_epoch:
            estimator.logger.info("Train for %d epochs.", estimator.max_epoch)
        else:
            estimator.logger.info("Train for %d batches.", estimator.max_batch)

    def train_end(self, estimator, *args, **kwargs):
        train_time = time.time() - self.train_start
        msg = f"Train finished using total {train_time:.0f}s at epoch " \
              f"{self.current_epoch}. "
        for m in self.metrics:
            name, value = m.get()
            msg += f"{name}: {_fmt(value)}, "
        estimator.logger.info(msg.rstrip(", "))

    def batch_begin(self, estimator, *args, **kwargs):
        if self.log_interval is not None:
            self.batch_start = time.time()

    def batch_end(self, estimator, *args, **kwargs):
        if self.log_interval is None:
            return
        batch_time = time.time() - self.batch_start
        batch = kwargs["batch"]
        self.batch_index += 1
        self.processed_samples += len(batch[0]) if isinstance(
            batch, (list, tuple)) else len(batch)
        self.log_interval_time += batch_time
        if self.batch_index % self.log_interval == 0:
            msg = f"[Epoch {self.current_epoch}][Batch {self.batch_index}]" \
                  f"[Samples {self.processed_samples}] " \
                  f"time/interval: {self.log_interval_time:.3f}s "
            self.log_interval_time = 0
            for m in self.metrics:
                name, value = m.get()
                msg += f"{name}: {_fmt(value)}, "
            estimator.logger.info(msg.rstrip(", "))

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()
        estimator.logger.info("[Epoch %d] Begin, current learning rate: "
                              "%.4f", self.current_epoch,
                              estimator.trainer.learning_rate)

    def epoch_end(self, estimator, *args, **kwargs):
        epoch_time = time.time() - self.epoch_start
        msg = f"[Epoch {self.current_epoch}] Finished in {epoch_time:.3f}s, "
        for m in self.metrics:
            name, value = m.get()
            msg += f"{name}: {_fmt(value)}, "
        estimator.logger.info(msg.rstrip(", "))
        self.current_epoch += 1
        self.batch_index = 0


def _fmt(value):
    return f"{value:.4f}" if isinstance(value, float) else str(value)


class CheckpointHandler(TrainBegin, TrainEnd, BatchEnd, EpochEnd):
    """Save params (+trainer states) periodically; keep best by monitored
    metric (reference: event_handler.py:336)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5, resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.verbose = verbose
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.max_checkpoints = max_checkpoints
        self.resume_from_checkpoint = resume_from_checkpoint
        self.saved_checkpoints: list[str] = []
        if self.save_best and monitor is None:
            raise ValueError("save_best requires a monitor metric")
        self.current_batch = 0
        self.current_epoch = 0
        if mode not in ("auto", "min", "max"):
            warnings.warn(f"unknown mode {mode}; fallback to auto")
            mode = "auto"
        if mode == "min":
            self.monitor_op = onp.less
        elif mode == "max":
            self.monitor_op = onp.greater
        else:
            name = monitor.get()[0] if monitor is not None else ""
            self.monitor_op = (onp.greater if "acc" in name or "f1" in name
                               else onp.less)
        self.best = (onp.inf if self.monitor_op == onp.less else -onp.inf)

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0
        os.makedirs(self.model_dir, exist_ok=True)
        if self.resume_from_checkpoint:
            self._resume_from_checkpoint(estimator)
        # SIGTERM (maintenance / preemption) saves immediately, so a
        # `resume_from_checkpoint=True` restart loses at most one batch
        from .... import preemption

        self._preemption_hook = lambda: self._save_checkpoint(estimator)
        preemption.on_preemption(self._preemption_hook)

    def train_end(self, estimator, *args, **kwargs):
        from .... import preemption

        hook = getattr(self, "_preemption_hook", None)
        if hook is not None:
            preemption.remove_preemption_hook(hook)
            self._preemption_hook = None

    def _resume_from_checkpoint(self, estimator):
        """Reload the newest matching checkpoint's params (+trainer states),
        continue the epoch/batch counters, re-seed the rotation window with
        ALL on-disk checkpoints, and restore the best-monitor value
        (reference: event_handler.py:542)."""
        import json
        import re

        pat = re.compile(
            rf"^{re.escape(self.model_prefix)}-epoch(\d+)batch(\d+)\.params$")
        found = []
        for f in os.listdir(self.model_dir):
            m = pat.match(f)
            if m:
                found.append(((int(m.group(1)), int(m.group(2))), f))
        if not found:
            estimator.logger.info(
                "CheckpointHandler: no checkpoint found in %s to resume from",
                self.model_dir)
            return
        found.sort()
        (epoch, batch), fname = found[-1]
        estimator.net.load_parameters(os.path.join(self.model_dir, fname))
        states = os.path.join(self.model_dir, fname[:-7] + ".states")
        if estimator.trainer is not None and os.path.exists(states):
            estimator.trainer.load_states(states)
        self.current_epoch = epoch
        self.current_batch = batch
        # oldest-first so the max_checkpoints rotation keeps deleting the
        # right files across crash/resume cycles
        for _, f in found:
            prefix = f[:-7]
            if prefix not in self.saved_checkpoints:
                self.saved_checkpoints.append(prefix)
        best_info = os.path.join(self.model_dir,
                                 f"{self.model_prefix}-best.info")
        if self.save_best and os.path.exists(best_info):
            with open(best_info) as f:
                self.best = json.load(f)["best"]
        estimator.logger.info(
            "CheckpointHandler: resumed from %s (epoch %d, batch %d)",
            fname, epoch, batch)

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self._save_checkpoint(estimator)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save_checkpoint(estimator)

    def _save_checkpoint(self, estimator):
        prefix = (f"{self.model_prefix}-epoch{self.current_epoch}"
                  f"batch{self.current_batch}")
        self._save_params_and_trainer(estimator, prefix)
        self.saved_checkpoints.append(prefix)
        while len(self.saved_checkpoints) > self.max_checkpoints:
            old = self.saved_checkpoints.pop(0)
            for suffix in (".params", ".states"):
                p = os.path.join(self.model_dir, old + suffix)
                if os.path.exists(p):
                    os.remove(p)
        if self.save_best:
            name, value = self.monitor.get()
            if self.monitor_op(value, self.best):
                self.best = value
                self._save_params_and_trainer(
                    estimator, f"{self.model_prefix}-best")
                import json

                with open(os.path.join(self.model_dir,
                                       f"{self.model_prefix}-best.info"),
                          "w") as f:
                    json.dump({"best": float(value), "metric": name}, f)
                if self.verbose > 0:
                    estimator.logger.info(
                        "[Epoch %d] %s improved to %.5f; saving best model",
                        self.current_epoch, name, value)

    def _save_params_and_trainer(self, estimator, file_prefix):
        param_file = os.path.join(self.model_dir, file_prefix + ".params")
        estimator.net.save_parameters(param_file)
        if estimator.trainer is not None:
            estimator.trainer.save_states(
                os.path.join(self.model_dir, file_prefix + ".states"))


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop training when the monitored metric stops improving
    (reference: event_handler.py:614)."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        if mode not in ("auto", "min", "max"):
            warnings.warn(f"unknown mode {mode}; fallback to auto")
            mode = "auto"
        if mode == "min":
            self.monitor_op = onp.less
        elif mode == "max":
            self.monitor_op = onp.greater
        else:
            name = monitor.get()[0]
            self.monitor_op = (onp.greater if "acc" in name or "f1" in name
                               else onp.less)
        if self.monitor_op == onp.greater:
            self.min_delta *= 1
        else:
            self.min_delta *= -1

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        if self.baseline is not None:
            self.best = self.baseline
        else:
            self.best = (onp.inf if self.monitor_op == onp.less else -onp.inf)

    def epoch_end(self, estimator, *args, **kwargs):
        _, current = self.monitor.get()
        if current is None or (isinstance(current, float)
                               and onp.isnan(current)):
            return
        if self.monitor_op(current - self.min_delta, self.best):
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                estimator.stop_training = True
        self.current_epoch += 1

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch > 0:
            estimator.logger.info(
                "[Epoch %d] EarlyStoppingHandler: early stopping due to %s "
                "not improving", self.stopped_epoch, self.monitor.get()[0])


_DEFAULT_LOGGER = logging.getLogger("incubator_mxnet_tpu_torch.estimator")
