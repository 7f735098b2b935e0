"""Retry/backoff policies + exception classification (port of
`incubator_mxnet_tpu/fault/retry.py`: `classify_exception` :48,
`RetryPolicy`, `retry_call`, `suppressed`), host-only code ported nearly
verbatim.

Reference role: ps-lite's ``Resender`` retries timed-out messages with a
bounded budget (`ps-lite/include/ps/internal/resender.h`); with no message
layer, retries live at the Python seams instead, all through one
:class:`RetryPolicy`.

Policy shape: jittered exponential backoff (``base_delay ·
multiplier^attempt``, capped at ``max_delay``, ±``jitter`` fraction), a
bounded attempt count, an optional wall-clock ``deadline``, and a
retryable-exception filter (default: :func:`classify_exception`). Every
retry increments ``mx_retries_total`` (plus a ``policy=<name>`` labeled
series) in the telemetry registry, so resilience is *measured*: a healthy
run dumps zero, a flaky fabric shows exactly where the budget went.

Env knobs:

- ``MXNET_RETRY_MAX``            — default max retry count (default 3)
- ``MXNET_RETRY_BASE_DELAY_MS``  — first backoff delay (default 50 ms)
- ``MXNET_RETRY_DEADLINE_S``     — optional wall-clock budget per call

Classification: :func:`classify_exception` splits the world into
``'retryable'`` (transient: connection/timeout/OS errors, injected
faults, runtime-fabric errors) and ``'fatal'`` (programming/config
errors: Type/Value/Key/Index/Attribute/Assertion, MemoryError). On the
card the runtime's errors are torch's: ``torch.cuda.OutOfMemoryError``
(the allocator's failure, where the reference sees XLA's
``RESOURCE_EXHAUSTED``) and a CUDA ``RuntimeError`` (where it sees an
``XlaRuntimeError``) are both ``RuntimeError`` subclasses, so both are
``'retryable'``, as their XLA counterparts are in the reference.
:func:`suppressed` is the logged replacement for bare
``except Exception: pass`` swallows.
"""
from __future__ import annotations

import logging
import os
import time

__all__ = ["RetryPolicy", "RetryExhausted", "classify_exception",
           "retry_call", "suppressed"]

_LOG = logging.getLogger("incubator_mxnet_tpu_torch.fault")

_FATAL_TYPES = (MemoryError, AssertionError, TypeError, ValueError,
                KeyError, IndexError, AttributeError, NotImplementedError,
                SyntaxError, ImportError)
_TRANSIENT_TYPES = (ConnectionError, TimeoutError, InterruptedError,
                    BrokenPipeError, OSError)


def classify_exception(exc):
    """``'retryable'`` (transient — a retry can plausibly succeed) or
    ``'fatal'`` (deterministic — retrying replays the same bug)."""
    from .injection import FaultInjected

    if getattr(exc, "non_retryable", False):
        # explicit opt-out (dist.StaleGenerationError: a rank that missed
        # a membership epoch replays the same stale view forever;
        # TopologyChanged: a signal to transition, not a transient)
        return "fatal"
    if isinstance(exc, FaultInjected):
        return "retryable"
    if isinstance(exc, _FATAL_TYPES):
        return "fatal"
    if isinstance(exc, _TRANSIENT_TYPES):
        return "retryable"
    import multiprocessing as mp

    if isinstance(exc, mp.TimeoutError):     # not a builtin TimeoutError
        return "retryable"
    if isinstance(exc, RuntimeError):
        # the runtime surfaces device and transport failures as
        # RuntimeError: torch.cuda.OutOfMemoryError and a CUDA error
        # subclass it, as the reference's XlaRuntimeError (its
        # RESOURCE_EXHAUSTED included) does; policies that must be
        # stricter pass an explicit `retryable` filter
        return "retryable"
    return "fatal"


class RetryExhausted(RuntimeError):
    """The retry budget (attempts or deadline) ran out. Carries the last
    underlying exception as `.last` (and as ``__cause__``)."""

    def __init__(self, name, attempts, elapsed, last):
        super().__init__(
            f"retry policy '{name}' exhausted after {attempts} attempt(s) "
            f"in {elapsed:.3f}s; last error: {type(last).__name__}: {last}")
        self.policy = name
        self.attempts = attempts
        self.last = last


class RetryPolicy:
    """Bounded jittered-exponential-backoff retry.

    `retryable` is a tuple of exception types or a ``callable(exc)->bool``
    (default: ``classify_exception(exc) == 'retryable'``). `jitter` is the
    ± fraction applied to each delay (0 ⇒ deterministic delays — what the
    tests use). `sleep` is injectable for tests."""

    def __init__(self, max_retries=3, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.25, deadline=None, retryable=None,
                 name="default", sleep=time.sleep, rng=None):
        self.max_retries = max(0, int(max_retries))
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = deadline
        self.retryable = retryable
        self.name = name
        self._sleep = sleep
        if rng is None:
            import random

            rng = random.Random()
        self._rng = rng

    @classmethod
    def from_env(cls, name="default", **overrides):
        """Policy with env-configured defaults (``MXNET_RETRY_*``);
        explicit `overrides` win."""
        cfg = {}
        v = os.environ.get("MXNET_RETRY_MAX")
        if v is not None:
            try:
                cfg["max_retries"] = int(v)
            except ValueError:
                _LOG.warning("MXNET_RETRY_MAX=%r is not an int; ignored", v)
        v = os.environ.get("MXNET_RETRY_BASE_DELAY_MS")
        if v is not None:
            try:
                cfg["base_delay"] = float(v) / 1e3
            except ValueError:
                _LOG.warning("MXNET_RETRY_BASE_DELAY_MS=%r is not a "
                             "number; ignored", v)
        v = os.environ.get("MXNET_RETRY_DEADLINE_S")
        if v is not None:
            try:
                cfg["deadline"] = float(v)
            except ValueError:
                _LOG.warning("MXNET_RETRY_DEADLINE_S=%r is not a number; "
                             "ignored", v)
        cfg.update(overrides)
        return cls(name=name, **cfg)

    def is_retryable(self, exc):
        if self.retryable is None:
            return classify_exception(exc) == "retryable"
        if callable(self.retryable):
            return bool(self.retryable(exc))
        return isinstance(exc, tuple(self.retryable))

    def delay(self, attempt):
        """Backoff before retry #`attempt` (1-based), jittered."""
        d = min(self.base_delay * self.multiplier ** (attempt - 1),
                self.max_delay)
        if self.jitter:
            d *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, d)

    def call(self, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under the policy. Non-retryable
        errors re-raise immediately (logged with their classification);
        an exhausted budget raises :class:`RetryExhausted` from the last
        underlying error."""
        start = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                attempt += 1
                if not self.is_retryable(e):
                    _LOG.error(
                        "fault[%s]: fatal %s on attempt %d (not retried): "
                        "%s", self.name, type(e).__name__, attempt, e)
                    raise
                elapsed = time.monotonic() - start
                out_of_budget = attempt > self.max_retries or (
                    self.deadline is not None and elapsed >= self.deadline)
                if out_of_budget:
                    _LOG.error(
                        "fault[%s]: retry budget exhausted (%d attempts, "
                        "%.3fs): %s: %s", self.name, attempt, elapsed,
                        type(e).__name__, e)
                    raise RetryExhausted(self.name, attempt, elapsed,
                                         e) from e
                d = self.delay(attempt)
                if self.deadline is not None:
                    d = min(d, max(0.0, self.deadline - elapsed))
                from ..telemetry import registry, tracing

                registry.counter(
                    "mx_retries_total",
                    "retries taken by fault.RetryPolicy").inc()
                registry.counter(
                    "mx_retries_total",
                    "retries taken by fault.RetryPolicy",
                    labels={"policy": self.name}).inc()
                tracing.event("retry", policy=self.name, attempt=attempt,
                              error=type(e).__name__,
                              backoff_ms=round(d * 1e3, 1))
                _LOG.warning(
                    "fault[%s]: retryable %s (attempt %d/%d), backing off "
                    "%.0f ms: %s", self.name, type(e).__name__, attempt,
                    self.max_retries, d * 1e3, e)
                self._sleep(d)


def retry_call(fn, *args, name="default", **kwargs):
    """One-shot convenience: ``RetryPolicy.from_env(name).call(fn, ...)``."""
    return RetryPolicy.from_env(name).call(fn, *args, **kwargs)


def suppressed(where, exc, level=None):
    """Log a *deliberately* swallowed exception with its classification —
    the replacement for bare ``except Exception: pass``.
    Fatal-class errors log at WARNING (someone should look), transient
    ones at DEBUG (expected noise: teardown races, best-effort cleanup)."""
    kind = classify_exception(exc)
    if level is None:
        level = logging.WARNING if kind == "fatal" else logging.DEBUG
    _LOG.log(level, "fault[suppressed@%s]: %s: %s (%s)", where,
             type(exc).__name__, exc, kind)
    return kind
