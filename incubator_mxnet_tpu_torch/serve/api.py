"""`serve.ServeEngine`, the thread-safe front door of the serving engine
(port of `incubator_mxnet_tpu/serve/api.py`, `ServeEngine` :41, with its
speculative-decoding arguments and `spec_stats` :84-151, the tracked lock
:108, the anatomy record at submit :176 and the OOM post-mortem or flight
dump of a failed step :190-203).

Three ways in, one engine:

- ``generate(prompt_ids, max_new_tokens)``: blocking; returns the full
  sequence (prompt + generated) as int32 numpy;
- ``submit(...)`` -> handle, and ``iter_tokens(handle)``: streaming;
  tokens are yielded as each step lands them;
- ``generate_many([...])``: batch convenience over submit and drive.

Threading: one lock (``tracked_lock("serve.engine")``, a plain
``threading`` lock unless the lock witness is armed) guards the
scheduler; `step()` holds it for a whole iteration, `submit()` only for
admission. A background driver
(``start()``) can own the step loop while client threads submit and
stream; with no driver, whichever thread waits on a result steps the
engine itself. On the card the decode, verify and draft graphs are
captured in the thread that steps (``"thread_local"`` capture mode,
`engine.SlotDecoder`).
``shutdown(drain=True)`` stops admission, finishes the requests already in
slots and fails the never-admitted queue. A step that raises (an injected
``serve_step`` fault among others) propagates; one that ran out of device
memory gets the OOM post-mortem (`telemetry.hbm.maybe_oom_postmortem`: a
flight dump carrying the memory census and the program ledger) when it
is armed, any other leaves a flight-recorder dump while tracing is armed.
"""
from __future__ import annotations

import logging
import os
import queue as _queue
import threading
import time

import numpy as onp

from ..telemetry import anatomy, tracing
from ..telemetry.locks import tracked_lock
from ..util import env_float, env_int
from .engine import SlotDecoder
from .scheduler import Request, Scheduler, _DONE

__all__ = ["ServeEngine"]

_IDLE_SLEEP_S = 0.002     # driver backoff when there is nothing to do
_DRIVER_MAX_CONSECUTIVE_FAILURES = 3


class ServeEngine:
    """Continuous-batching inference engine over a `GPTModel` (or a
    prebuilt `GPTDecoder`).

    Parameters
    ----------
    block_or_decoder : GPTModel | GPTDecoder
        The model to serve.
    max_slots : int
        In-flight request capacity (the decode step's batch width).
    max_len : int, optional
        Per-slot sequence capacity; defaults to the model's position
        table length.
    page_tokens / prefill_chunk / n_pages / kv_dtype / prefix_reuse
        Paged-KV knobs, forwarded to `SlotDecoder` (defaults from
        ``MXNET_SERVE_PAGE_TOKENS``, ``MXNET_SERVE_PREFILL_CHUNK``,
        ``MXNET_SERVE_KV_DTYPE``; ``kv_dtype="int8"`` stores the pool as
        int8 with one scale per page and head).
    policy : "fifo" | "sjf", optional
        Admission order (default ``MXNET_SERVE_POLICY`` or fifo).
    max_queue : int, optional
        Admission queue depth (default ``MXNET_SERVE_MAX_QUEUE`` or 128);
        a full queue raises `QueueFull` at submit.
    deadline_s : float, optional
        Default per-request deadline (``MXNET_SERVE_DEADLINE_S``; unset =
        none). A submit may override it.
    eos_id : int, optional
        Token id that retires a request early (a submit may override it).
    do_sample / top_k
        Sampling mode, fixed per engine; ``temperature`` stays
        per-request.
    seed : int
        Seed of the step keys of sampled decoding (greedy ignores it).
    spec_k : int, optional
        Speculative-decoding draft length (default ``MXNET_SERVE_SPEC_K``
        or 0 = off). Requires greedy decoding; the output stays token for
        token that of ``spec_k=0``.
    draft : str | GPTModel | GPTDecoder, optional
        Draft source when ``spec_k > 0``: ``"ngram"`` (the host n-gram
        proposer, no device work; the default, also by
        ``MXNET_SERVE_SPEC_DRAFT``) or a small model that shares the
        target's vocabulary.
    """

    def __init__(self, block_or_decoder, max_slots=8, max_len=None,
                 page_tokens=None, prefill_chunk=None, n_pages=None,
                 kv_dtype=None, prefix_reuse=True, policy=None,
                 max_queue=None, deadline_s=None, eos_id=None,
                 do_sample=False, top_k=None, temperature=1.0, seed=0,
                 spec_k=None, draft=None):
        slots = SlotDecoder(block_or_decoder, max_slots=max_slots,
                            max_len=max_len, page_tokens=page_tokens,
                            prefill_chunk=prefill_chunk, n_pages=n_pages,
                            kv_dtype=kv_dtype, prefix_reuse=prefix_reuse,
                            do_sample=do_sample, top_k=top_k, spec_k=spec_k,
                            draft=draft)
        if policy is None:
            policy = os.environ.get("MXNET_SERVE_POLICY", "fifo")
        if max_queue is None:
            max_queue = env_int("MXNET_SERVE_MAX_QUEUE", 128)
        if deadline_s is None:
            deadline_s = env_float("MXNET_SERVE_DEADLINE_S", None)
        self._sched = Scheduler(slots, max_queue=max_queue, policy=policy,
                                default_deadline=deadline_s, eos_id=eos_id,
                                seed=seed)
        self._default_temperature = float(temperature)
        self._lock = tracked_lock("serve.engine")
        self._driver = None
        self._stop = threading.Event()

    # -- introspection ------------------------------------------------------

    @property
    def max_slots(self):
        return self._sched.slots.max_slots

    @property
    def max_len(self):
        return self._sched.slots.max_len

    @property
    def queue_depth(self):
        with self._lock:
            return self._sched.queue_depth

    @property
    def n_active(self):
        with self._lock:
            return self._sched.n_active

    @property
    def closed(self):
        return self._sched.closed

    @property
    def page_occupancy(self):
        """Fraction of usable KV pool pages referenced (shared pages
        counted once)."""
        a = self._sched.slots.allocator
        return a.used_pages / a.usable_pages if a.usable_pages else 0.0

    @property
    def kv_bytes_per_slot(self):
        """Resident KV pool bytes per decode slot (0 before first use)."""
        return self._sched.slots.kv_bytes_per_slot

    def spec_stats(self):
        """Speculative-decoding counters: ``{"k", "draft", "drafted",
        "accepted", "accept_rate"}`` (zeros and None when ``spec_k=0``)."""
        return self._sched.slots.spec_stats()

    def xla_program_count(self):
        """Programs built: prefill chunk buckets seen plus the decode,
        verify and draft steps' builds (`SlotDecoder.xla_program_count`);
        flat in steady state."""
        return self._sched.slots.xla_program_count()

    # -- submission ---------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens, temperature=None,
               eos_id=None, deadline_s=None):
        """Enqueue one request; returns its handle (a `Request`).

        Raises `QueueFull` when the admission queue is at capacity and
        `EngineClosed` after shutdown: backpressure is the caller's
        signal, never a silent drop."""
        if temperature is None:
            temperature = self._default_temperature
        with self._lock:
            req = self._sched.submit(prompt_ids, max_new_tokens,
                                     temperature=temperature,
                                     eos_id=eos_id, deadline_s=deadline_s)
            # a standalone engine owns its requests' anatomy records end
            # to end (the gateway attaches its own to the segments it
            # dispatches)
            rec = anatomy.begin(
                req.id, req.tenant, self._sched.capacity_model,
                "normal", req.submit_t, deadline=req.deadline)
            if rec is not None:
                rec.owner = "engine"
                req.anatomy = rec
            return req

    # -- driving ------------------------------------------------------------

    def step(self):
        """One scheduling iteration (admit, prefill chunks, one decode
        step for every decoding slot). Returns True if progress was
        made. A step that raises leaves a flight-recorder dump (the open
        spans of the requests in flight): the OOM post-mortem's, with the
        memory census and the program ledger, when it ran out of device
        memory and the post-mortem is armed, else the generic one while
        tracing is armed; the error propagates unchanged."""
        try:
            with self._lock:
                return self._sched.step()
        except Exception as e:
            from ..telemetry import hbm

            # RESOURCE_EXHAUSTED gets the OOM post-mortem (census +
            # program ledger); everything else the generic flight dump
            if hbm.maybe_oom_postmortem("serve_step", e) is None:
                tracing.maybe_flight_dump("serve_step", e)
            raise

    def _driver_running(self):
        d = self._driver
        return d is not None and d.is_alive()

    def _drive_until(self, reqs, timeout=None):
        """Make ``reqs`` finish: wait on the driver if one is running,
        otherwise step the engine from this thread."""
        t_end = None if timeout is None else time.monotonic() + timeout
        for req in reqs:
            while not req.done:
                if t_end is not None and time.monotonic() > t_end:
                    raise TimeoutError(
                        f"request {req.id} still {req.state} after "
                        f"{timeout}s")
                if self._driver_running():
                    req.wait(0.05)
                else:
                    progressed = self.step()
                    if not progressed and not req.done:
                        raise RuntimeError(
                            f"serve engine stalled: request {req.id} is "
                            f"{req.state} but the scheduler is idle")

    def generate(self, prompt_ids, max_new_tokens, temperature=None,
                 eos_id=None, deadline_s=None, timeout=None):
        """Blocking single-request generation. Returns the full sequence
        (prompt + generated tokens) as a 1D int32 numpy array."""
        req = self.submit(prompt_ids, max_new_tokens,
                          temperature=temperature, eos_id=eos_id,
                          deadline_s=deadline_s)
        self._drive_until([req], timeout=timeout)
        toks = req.result()               # raises on failure
        return onp.concatenate([onp.asarray(req.prompt, onp.int32),
                                onp.asarray(toks, onp.int32)])

    def generate_many(self, prompts, max_new_tokens, temperature=None,
                      eos_id=None, deadline_s=None, timeout=None):
        """Submit every prompt, drive to completion and return the full
        sequences in prompt order (completion may be out of order)."""
        reqs = [self.submit(p, max_new_tokens, temperature=temperature,
                            eos_id=eos_id, deadline_s=deadline_s)
                for p in prompts]
        self._drive_until(reqs, timeout=timeout)
        return [onp.concatenate([onp.asarray(r.prompt, onp.int32),
                                 onp.asarray(r.result(), onp.int32)])
                for r in reqs]

    def iter_tokens(self, handle: Request, timeout=30.0):
        """Stream ``handle``'s tokens as the engine produces them.

        With a background driver running this blocks on the stream;
        without one, the consuming thread steps the engine itself. Raises
        the request's error (deadline, shutdown) where it fails;
        ``timeout`` bounds the wait for any single token."""
        while True:
            try:
                item = handle._stream.get_nowait()
            except _queue.Empty:
                if self._driver_running() or handle.done:
                    try:
                        item = handle._stream.get(timeout=timeout)
                    except _queue.Empty:
                        raise TimeoutError(
                            f"no token from request {handle.id} in "
                            f"{timeout}s (state={handle.state})") from None
                else:
                    self.step()
                    continue
            if item is _DONE:
                if handle.error is not None:
                    raise handle.error
                return
            yield item

    # -- driver thread ------------------------------------------------------

    def start(self):
        """Start the background driver thread, which owns the step loop so
        client threads only submit and stream. Idempotent."""
        if self._driver_running():
            return self
        self._stop.clear()

        def _loop():
            log = logging.getLogger("incubator_mxnet_tpu_torch.serve")
            failures = 0
            while not self._stop.is_set():
                try:
                    progressed = self.step()
                    failures = 0
                except Exception as e:  # the driver must report, not die
                    # a transient fault must not silently kill the driver,
                    # nor a deterministic bug spin it forever
                    failures += 1
                    log.error(
                        "serve driver: step failed (%d consecutive): "
                        "%s: %s", failures, type(e).__name__, e)
                    if failures >= _DRIVER_MAX_CONSECUTIVE_FAILURES:
                        log.error(
                            "serve driver: stopping after %d consecutive "
                            "step failures — in-flight requests need a "
                            "manual step()/start() after the cause is "
                            "fixed", failures)
                        break
                    time.sleep(_IDLE_SLEEP_S)
                    continue
                if not progressed:
                    time.sleep(_IDLE_SLEEP_S)

        self._driver = threading.Thread(target=_loop, name="mx-serve-driver",
                                        daemon=True)
        self._driver.start()
        return self

    def stop(self):
        """Stop the driver thread (requests stay queued or running; call
        `step()` or `start()` again to resume)."""
        self._stop.set()
        d = self._driver
        if d is not None:
            d.join(timeout=5.0)
        self._driver = None

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self, drain=True, timeout=None):
        """Stop the engine. ``drain=True`` finishes the requests already in
        slots (new work and the never-admitted queue are rejected with
        `EngineClosed`); ``drain=False`` fails everything at once.
        Releases the device KV pools and the graphs."""
        with self._lock:
            self._sched.close(drain=drain)
            running = [r for r in self._sched._in_slot if r is not None]
        if drain and running:
            t_end = None if timeout is None else time.monotonic() + timeout
            while True:
                with self._lock:
                    if self._sched.n_active == 0:
                        break
                if t_end is not None and time.monotonic() > t_end:
                    raise TimeoutError(
                        f"drain did not finish in {timeout}s "
                        f"({self._sched.n_active} slots still busy)")
                if not self._driver_running():
                    self.step()
                else:
                    time.sleep(0.01)
        self.stop()
        with self._lock:
            # the prefix cache's page references go before the pool, so a
            # clean shutdown leaves the allocator empty
            self._sched.slots.prefix_cache.clear()
            self._sched.slots.release()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)
