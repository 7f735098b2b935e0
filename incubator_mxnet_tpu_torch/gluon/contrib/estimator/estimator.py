"""Gluon Estimator, a batteries-included fit/evaluate loop (port of
`incubator_mxnet_tpu/gluon/contrib/estimator/estimator.py`; reference:
`python/mxnet/gluon/contrib/estimator/estimator.py:42-517`).

The train step is the framework's standard ``autograd.record()`` →
``backward`` → ``Trainer.step`` path, so everything the funnel provides
(the profiler's hooks, AMP, a hybridized net's CUDA graphs) applies
here too. `fit`'s step body carries the reference's seams: the
``estimator.epoch`` and ``estimator.step`` spans, the goodput ledger's
``compute`` lease, the ``estimator_step`` chaos seam, the step guards'
veto and their crash handling (`event_handler.StepGuard`).
"""
from __future__ import annotations

import logging

from ... import loss as gluon_loss
from ... import metric as metric_mod
from ...trainer import Trainer
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler, StepGuard,
                            StoppingHandler, TrainBegin, TrainEnd,
                            ValidationHandler, _check_event_handlers)

__all__ = ["Estimator"]


class Estimator:
    """Train and evaluate a gluon net with event handlers
    (reference: estimator.py:42)."""

    def __init__(self, net, loss, train_metrics=None, val_metrics=None,
                 initializer=None, trainer=None, context=None, device=None,
                 evaluation_loss=None, val_loss=None, val_net=None,
                 batch_processor=None):
        if batch_processor is not None:
            # the reference splits the train/eval step into a swappable
            # BatchProcessor, a seam this package does not have: fail
            # loudly rather than silently ignoring the argument (a script
            # relying on a custom processor would otherwise train with
            # the default step and look like it worked)
            raise ValueError(
                "batch_processor is not supported by this build: override "
                "Estimator.fit_batch/evaluate_batch or use event handlers "
                "(gluon.contrib.estimator.event_handler) to customize the "
                "train/eval step")
        self.net = net
        self.loss = self._check_loss(loss)
        self._train_metrics = _as_list(train_metrics)
        self._val_metrics = _as_list(val_metrics)
        self.evaluation_loss = self._check_loss(
            evaluation_loss or val_loss or loss)
        self.val_net = val_net or net
        self.logger = logging.getLogger("incubator_mxnet_tpu_torch.estimator")
        if not self.logger.handlers:
            self.logger.addHandler(logging.StreamHandler())
            self.logger.setLevel(logging.INFO)
        self.device = device or context
        self._initialize(initializer)
        self.trainer = self._check_trainer(trainer)
        self.stop_training = False
        self.max_epoch = None
        self.max_batch = None
        self._add_default_training_metrics()
        self._add_validation_metrics()

    # -- setup ---------------------------------------------------------------
    def _check_loss(self, loss):
        if loss is None:
            return None
        if not isinstance(loss, gluon_loss.Loss):
            raise ValueError("loss must be a gluon.loss.Loss instance")
        return loss

    def _initialize(self, initializer):
        params = self.net.collect_params()
        uninitialized = any(p._data is None and p._deferred_init is None
                            for p in params.values())
        if uninitialized:
            self.net.initialize(init=initializer, device=self.device)
        elif initializer is not None:
            self.logger.warning(
                "Network already initialized; ignoring initializer")

    def _check_trainer(self, trainer):
        if trainer is None:
            self.logger.warning(
                "No trainer specified; using sgd with learning_rate=0.001")
            trainer = Trainer(self.net.collect_params(), "sgd",
                              {"learning_rate": 1e-3})
        elif not isinstance(trainer, Trainer):
            raise ValueError("trainer must be a gluon.Trainer instance")
        return trainer

    def _add_default_training_metrics(self):
        import copy

        if not self._train_metrics:
            self._train_metrics = [metric_mod.Accuracy()]
        # deep-copy so caller-owned metric objects are not renamed in place
        # (and reuse across Estimators doesn't double-prefix)
        self._train_metrics = [copy.deepcopy(m) for m in self._train_metrics]
        for m in self._train_metrics:
            m.name = "training " + m.name
        self._train_metrics.append(
            metric_mod.Loss("training " + type(self.loss).__name__.lower()))

    def _add_validation_metrics(self):
        import copy

        if not self._val_metrics:
            # deep-copy (not type(m)()) so metric config — top_k, feval,
            # thresholds — carries over to validation
            self._val_metrics = [copy.deepcopy(m)
                                 for m in self._train_metrics[:-1]]
            for m in self._val_metrics:
                m.name = m.name.removeprefix("training ")
                m.reset()
        else:
            self._val_metrics = [copy.deepcopy(m) for m in self._val_metrics]
        for m in self._val_metrics:
            m.name = "validation " + m.name
        self._val_metrics.append(metric_mod.Loss(
            "validation " + type(self.evaluation_loss).__name__.lower()))

    @property
    def train_metrics(self):
        return self._train_metrics

    @property
    def val_metrics(self):
        return self._val_metrics

    # -- data ----------------------------------------------------------------
    @staticmethod
    def _get_data_and_label(batch, batch_axis=0):  # noqa: ARG004
        return batch[0], batch[1]

    # -- evaluate ------------------------------------------------------------
    def evaluate_batch(self, val_batch, val_metrics, batch_axis=0):
        data, label = self._get_data_and_label(val_batch, batch_axis)
        pred = self.val_net(data)
        loss = self.evaluation_loss(pred, label)
        from ...metric import Loss as LossMetric

        for m in val_metrics:
            if isinstance(m, LossMetric):
                m.update(0, loss)
            else:
                m.update(label, pred)

    def evaluate(self, val_data, val_metrics=None, batch_axis=0,
                 event_handlers=None):
        """Run one pass over val_data updating val_metrics; fires
        epoch/batch hooks on any handlers passed
        (reference: estimator.py:279)."""
        val_metrics = val_metrics or self._val_metrics
        for m in val_metrics:
            m.reset()
        event_handlers = _check_event_handlers(event_handlers)
        _, epoch_begin, batch_begin, batch_end, epoch_end, _ = \
            self._categorize_handlers(event_handlers)
        for handler in epoch_begin:
            handler.epoch_begin(self)
        for batch in val_data:
            for handler in batch_begin:
                handler.batch_begin(self, batch=batch)
            self.evaluate_batch(batch, val_metrics, batch_axis)
            for handler in batch_end:
                handler.batch_end(self, batch=batch)
        for handler in epoch_end:
            handler.epoch_end(self)
        return {name: value
                for name, value in (m.get() for m in val_metrics)}

    # -- fit -----------------------------------------------------------------
    def fit_batch(self, train_batch, batch_axis=0):
        from .... import autograd

        data, label = self._get_data_and_label(train_batch, batch_axis)
        with autograd.record():
            pred = self.net(data)
            loss = self.loss(pred, label)
        loss.backward()
        return data, label, pred, loss

    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None, batch_axis=0):
        """Train the net (reference: estimator.py:333). Pass `epochs` or
        `batches` (mutually exclusive semantics: whichever hits first)."""
        if not epochs and not batches:
            raise ValueError("pass `epochs` and/or `batches`")
        self.max_epoch = epochs
        self.max_batch = batches
        self.stop_training = False

        event_handlers = self._prepare_default_handlers(
            val_data, event_handlers)
        train_begin, epoch_begin, batch_begin, batch_end, epoch_end, \
            train_end = self._categorize_handlers(event_handlers)
        step_guards = [h for h in event_handlers if isinstance(h, StepGuard)]
        from ....fault.injection import inject_at
        from ....telemetry import goodput, tracing

        for handler in train_begin:
            handler.train_begin(self)

        epoch = 0
        while not self.stop_training:
            with tracing.span("estimator.epoch", epoch=epoch):
                for handler in epoch_begin:
                    handler.epoch_begin(self)
                n_batches = 0
                for batch in train_data:
                    n_batches += 1
                    for handler in batch_begin:
                        handler.batch_begin(self, batch=batch)
                    # the step body is the self-healing boundary (fault
                    # subsystem): StepGuards may veto the optimizer update
                    # (non-finite loss) or absorb a mid-step crash after
                    # restoring a consistent state (ResilienceHandler
                    # resumes from the last good checkpoint); without a
                    # guard, every exception propagates exactly as before
                    try:
                        with tracing.span("estimator.step",
                                          batch=n_batches), \
                                goodput.lease("compute"):
                            inject_at("estimator_step")   # chaos seam
                            data, label, pred, loss = self.fit_batch(
                                batch, batch_axis)
                            n = data.shape[batch_axis] \
                                if hasattr(data, "shape") else 1
                            if any(g.pre_step(self, loss, batch)
                                   for g in step_guards):
                                # vetoed (e.g. non-finite loss): neither
                                # the update nor the batch_end metrics see
                                # the poisoned batch
                                continue
                            self.trainer.step(n)
                    except Exception as e:
                        if not any(g.on_crash(self, e)
                                   for g in step_guards):
                            raise
                        continue            # recovered: next batch
                    for handler in batch_end:
                        handler.batch_end(self, batch=batch, pred=pred,
                                          label=label, loss=loss)
                    if self.stop_training:
                        break
                if n_batches == 0:
                    raise ValueError(
                        "Estimator.fit: train_data yielded no batches "
                        "(an empty loader would loop forever)")
                for handler in epoch_end:
                    handler.epoch_end(self)
            epoch += 1

        for handler in train_end:
            handler.train_end(self)

    # -- handler plumbing ----------------------------------------------------
    def _prepare_default_handlers(self, val_data, event_handlers):
        event_handlers = _check_event_handlers(event_handlers)
        added_default = []
        if not any(isinstance(h, StoppingHandler) for h in event_handlers):
            event_handlers.append(StoppingHandler(self.max_epoch,
                                                  self.max_batch))
            added_default.append("StoppingHandler")
        if not any(isinstance(h, MetricHandler) for h in event_handlers):
            event_handlers.append(MetricHandler(self._train_metrics))
            added_default.append("MetricHandler")
        if val_data is not None and not any(
                isinstance(h, ValidationHandler) for h in event_handlers):
            event_handlers.append(ValidationHandler(
                val_data=val_data, eval_fn=self.evaluate))
            added_default.append("ValidationHandler")
        if not any(isinstance(h, LoggingHandler) for h in event_handlers):
            event_handlers.append(LoggingHandler(
                metrics=self._train_metrics + self._val_metrics))
            added_default.append("LoggingHandler")
        if added_default:
            self.logger.info("added default handlers: %s",
                             ", ".join(added_default))
        event_handlers.sort(key=lambda h: getattr(h, "priority", 0))
        return event_handlers

    @staticmethod
    def _categorize_handlers(event_handlers):
        train_begin, epoch_begin, batch_begin = [], [], []
        batch_end, epoch_end, train_end = [], [], []
        for h in event_handlers:
            if isinstance(h, TrainBegin):
                train_begin.append(h)
            if isinstance(h, EpochBegin):
                epoch_begin.append(h)
            if isinstance(h, BatchBegin):
                batch_begin.append(h)
            if isinstance(h, BatchEnd):
                batch_end.append(h)
            if isinstance(h, EpochEnd):
                epoch_end.append(h)
            if isinstance(h, TrainEnd):
                train_end.append(h)
        return (train_begin, epoch_begin, batch_begin, batch_end, epoch_end,
                train_end)


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]
