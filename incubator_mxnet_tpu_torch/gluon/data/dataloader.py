"""DataLoader (port of `incubator_mxnet_tpu/gluon/data/dataloader.py`;
the reference's own is `python/mxnet/gluon/data/dataloader.py`, 816 LoC
of multiprocessing workers with POSIX-shm NDArray transfer).

The reference's design, kept: worker processes produce *numpy* batches
(host memory); large batch arrays cross the process boundary through
POSIX shared memory (the reference's CPUSharedStorage role) instead of
being serialized through the pool's result pipe, and small leaves keep
the plain pickle path; a failed or timed-out worker task is retried
(``MXNET_WORKER_RETRIES``) and, past the budget, computed in this
process; ``thread_pool=True`` runs the same tasks on threads of this
process.

The upload is the only device step: the main process copies each batch
onto the current device when the iteration starts (the card unless the
caller asks for the CPU). With ``pin_memory=True`` a batch bound for the
card is copied from a pinned host buffer with ``non_blocking=True``.

Workers never touch the card. They are started with ``forkserver`` (or
``spawn``), so each one imports the package afresh, and their
environment hides every CUDA device (``CUDA_VISIBLE_DEVICES=""``, the
reference pins its workers to jax's CPU the same way): a dataset whose
leaves are CUDA tensors fails in the worker instead of initialising a
context there. The package's import touches no CUDA.
"""
from __future__ import annotations

import logging
import multiprocessing as mp

from .batchify import default_batchify_fn
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader"]

_LOG = logging.getLogger("incubator_mxnet_tpu_torch.gluon.data")


def _suppressed(where, exc):
    """Classified, logged swallow (replaces bare `except: pass`)."""
    from ...fault.retry import suppressed

    suppressed("dataloader." + where, exc)


_worker_dataset = None
_worker_batchify = None
_worker_use_shm = True
_SHM_MIN_BYTES = 1 << 20   # leaves below 1 MB ship by pickle
_SHM_TAG = "__mxshm__"


def _worker_init(dataset, batchify_fn, use_shm=True):
    global _worker_dataset, _worker_batchify, _worker_use_shm
    _worker_dataset = dataset
    _worker_batchify = batchify_fn
    _worker_use_shm = use_shm
    # MXNET_MP_OPENCV_NUM_THREADS: cap cv2's internal pool per worker so P
    # workers don't spawn P x ncores decode threads
    import os

    v = os.environ.get("MXNET_MP_OPENCV_NUM_THREADS")
    if v:
        try:
            import cv2

            cv2.setNumThreads(max(0, int(v)))
        except (ImportError, ValueError):
            pass


def _export_shm(arr):
    """Worker side: copy `arr` into a fresh POSIX shm segment; ownership
    (unlink) transfers to the consumer."""
    import numpy as onp
    from multiprocessing import resource_tracker, shared_memory

    shm = shared_memory.SharedMemory(create=True, size=arr.nbytes)
    onp.ndarray(arr.shape, arr.dtype, buffer=shm.buf)[...] = arr
    name = shm.name
    shm.close()
    # the CONSUMER unlinks; stop this process's resource_tracker from
    # reporting the segment as leaked at pool shutdown
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception as e:
        _suppressed("shm.unregister", e)   # cosmetic tracker noise only
    return (_SHM_TAG, name, arr.shape, str(arr.dtype))


def _import_shm(desc):
    """Consumer side: attach, copy out, unlink."""
    import numpy as onp
    from multiprocessing import resource_tracker, shared_memory

    _tag, name, shape, dtype = desc
    shm = shared_memory.SharedMemory(name=name)
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception as e:
        _suppressed("shm.unregister", e)   # cosmetic tracker noise only
    try:
        arr = onp.array(onp.ndarray(shape, dtype, buffer=shm.buf))
    finally:
        shm.close()
        shm.unlink()
    return arr


def _unlink_shm_tree(b):
    """Release shm segments referenced by an un-imported result tree
    (consumer abandoned the iterator before wrapping the batch)."""
    if isinstance(b, tuple) and len(b) == 4 and b[0] == _SHM_TAG:
        from multiprocessing import resource_tracker, shared_memory

        try:
            shm = shared_memory.SharedMemory(name=b[1])
        except FileNotFoundError:
            return
        try:
            resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
        except Exception as e:
            _suppressed("shm.unregister", e)
        shm.close()
        shm.unlink()
    elif isinstance(b, (tuple, list)):
        for x in b:
            _unlink_shm_tree(x)


def _probe_seams():
    """The chaos seams of a worker task (armed from the inherited
    MXNET_FAULT_INJECT env by the worker's own package import):
    'dataloader_worker' raises, and the consumer's bounded retry and
    fallback handle it; '..._exit' kills the process outright (an
    OOM-kill or segfault stand-in), the pool respawns the worker and the
    consumer times the lost task out."""
    from ...fault import injection

    injection.inject_at("dataloader_worker")
    if injection.injection_enabled("dataloader_worker_exit"):
        try:
            injection.inject_at("dataloader_worker_exit")
        except injection.FaultInjected:
            import os

            os._exit(3)


def _host_tree(b, use_shm):
    """A batchify result as numpy leaves (large ones as shm descriptors
    when ``use_shm``)."""
    import numpy as onp

    if isinstance(b, (tuple, list)):
        return tuple(_host_tree(x, use_shm) for x in b)
    if hasattr(b, "asnumpy"):
        b = b.asnumpy()
    arr = onp.ascontiguousarray(b)
    if use_shm and arr.nbytes >= _SHM_MIN_BYTES:
        return _export_shm(arr)
    return arr


def _worker_fn(samples):
    _probe_seams()
    batch = _worker_batchify([_worker_dataset[i] for i in samples])
    return _host_tree(batch, _worker_use_shm)


def _thread_fn(dataset, batchify_fn, samples):
    """A task of the ``thread_pool=True`` loader: the worker's task on a
    thread of this process (numpy leaves, no shm)."""
    _probe_seams()
    return _host_tree(batchify_fn([dataset[i] for i in samples]), False)


def _mp_context():
    """Worker start method. The parent is multithreaded (torch's pools,
    CUDA's) by the time a DataLoader is built, and a forked child of a
    process with a CUDA context cannot use CUDA, so `fork` is never the
    default: `forkserver` forks workers from a clean single-threaded
    server process; `spawn` is the portable fallback. Both re-import
    ``__main__`` from its file as ``__mp_main__``: a script that builds a
    loader with workers keeps its work under ``if __name__ ==
    "__main__":``."""
    import os

    method = os.environ.get("MXNET_MP_START_METHOD")
    if not method:
        methods = mp.get_all_start_methods()
        method = "forkserver" if "forkserver" in methods else "spawn"
    return mp.get_context(method)


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=None, pin_memory=False, pin_device_id=0,  # noqa: ARG002
                 prefetch=None, thread_pool=False, timeout=120,
                 try_nopython=None, use_shared_memory=True):  # noqa: ARG002
        self._dataset = dataset
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with explicit sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._pin_memory = bool(pin_memory)
        self._thread_pool = bool(thread_pool)
        from ...util import default_worker_retries

        self._worker_retries = default_worker_retries()
        if num_workers is None:
            # env-config default ONLY when the caller didn't choose:
            # explicit num_workers=0 must stay worker-free (reference
            # MXNET_CPU_WORKER_NTHREADS semantics)
            from ...util import default_num_workers

            num_workers = default_num_workers()
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch or 2 * self._num_workers)
        self._pool = None
        if self._num_workers > 0:
            import weakref

            if self._thread_pool:
                from multiprocessing.pool import ThreadPool

                self._pool = ThreadPool(self._num_workers)
            else:
                self._pool = self._start_pool(_mp_context(), dataset,
                                              use_shared_memory)
            # finalizers run at atexit, BEFORE interpreter teardown strips
            # the mp module globals a late __del__ would trip over
            self._finalizer = weakref.finalize(
                self, DataLoader._terminate_pool, self._pool)

    @staticmethod
    def _terminate_pool(pool):
        try:
            pool.terminate()
            pool.join()
        except Exception as e:
            _suppressed("pool.terminate", e)   # best-effort atexit teardown

    def _start_pool(self, ctx, dataset, use_shared_memory):
        import os
        import sys

        # spawn/forkserver workers re-run __main__ from its __file__; a
        # heredoc/REPL parent reports "<stdin>", which the worker bootstrap
        # tries to open as a real path and dies. Drop the phantom path for
        # good: the pool respawns dead workers long after __init__ returns,
        # so restoring it would re-arm the crash for them (workers only need
        # importable modules, not the interactive main).
        main_mod = sys.modules.get("__main__")
        main_file = getattr(main_mod, "__file__", None)
        if (main_mod is not None and main_file is not None
                and getattr(main_mod, "__spec__", None) is None
                and not os.path.exists(main_file)):
            del main_mod.__file__

        # workers do host-side decode/augment only: pin them to the host.
        # Children inherit the environment at creation.
        override = {"CUDA_VISIBLE_DEVICES": ""}
        saved = {k: os.environ.get(k) for k in override}
        os.environ.update(override)
        try:
            return ctx.Pool(self._num_workers, initializer=_worker_init,
                            initargs=(dataset, self._batchify_fn,
                                      use_shared_memory))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def _uploader(self):
        """The batch leaves' upload onto the current device."""
        import numpy as onp
        import torch

        from ...base import _X64_OFF
        from ...device import resolve_device
        from ...ndarray import ndarray as nd_mod

        NDArray = nd_mod.NDArray
        dev = resolve_device(None)
        pin = self._pin_memory and dev.type == "cuda"

        def up(arr):
            t = torch.from_numpy(onp.ascontiguousarray(arr))
            d = _X64_OFF.get(t.dtype)
            if d is not None:
                t = t.to(d)                # the reference runs x64 off
            nbytes = t.numel() * t.element_size()
            if nd_mod._H2D_HOOK is not None:
                nd_mod._H2D_HOOK(nbytes)   # telemetry mx_h2d_bytes_total
            if nd_mod._FAULT_HOOK is not None:
                nd_mod._FAULT_HOOK(nbytes)  # seam 'h2d'
            if pin:
                t = t.pin_memory()
            return NDArray(t.to(dev, non_blocking=pin))

        def wrap(b):
            if isinstance(b, tuple) and len(b) == 4 and b[0] == _SHM_TAG:
                return up(_import_shm(b))
            if isinstance(b, (tuple, list)):
                return tuple(wrap(x) for x in b)
            if isinstance(b, NDArray):
                return b if b._data.device == dev else NDArray(b, device=dev)
            return up(onp.asarray(b))

        return wrap

    def __iter__(self):
        from ...telemetry import goodput, tracing

        wrap = self._uploader()

        if self._pool is None:
            for n, batch_idx in enumerate(self._batch_sampler):
                with tracing.span("dataloader.batch", batch=n, workers=0), \
                        goodput.lease("data_wait"):
                    out = wrap(self._batchify_fn([self._dataset[i]
                                                  for i in batch_idx]))
                yield out
            return

        # pipelined: keep `prefetch` batches in flight in the pool.
        # Self-healing (fault subsystem): a failed/timed-out task is
        # retried `_worker_retries` times (the pool respawns dead worker
        # processes on its own; the resubmit is what re-schedules the lost
        # work), then falls back, LOUDLY, to computing that one batch in
        # this process. Fatal-class errors (a dataset bug raising the same
        # ValueError on every attempt would burn the budget silently)
        # propagate immediately with their classification logged.
        batches = iter(self._batch_sampler)
        in_flight = []       # entries: [samples, AsyncResult, attempts]
        abandoned = []       # timed-out futures: drain their shm at close

        def submit(samples, attempts=0, front=False):
            if self._thread_pool:
                fut = self._pool.apply_async(
                    _thread_fn, (self._dataset, self._batchify_fn, samples))
            else:
                fut = self._pool.apply_async(_worker_fn, (samples,))
            entry = [samples, fut, attempts]
            if front:
                in_flight.insert(0, entry)
            else:
                in_flight.append(entry)

        try:
            for _ in range(self._prefetch):
                b = next(batches, None)
                if b is None:
                    break
                submit(b)
            n_yielded = 0
            while in_flight:
                # the batch-fetch segment of the trace: wait on the
                # worker's future (+ any retries) through the upload
                with tracing.span("dataloader.batch", batch=n_yielded,
                                  workers=self._num_workers), \
                        goodput.lease("data_wait"):
                    samples, fut, attempts = in_flight[0]
                    try:
                        result = fut.get(self._timeout)
                    except Exception as e:
                        in_flight.pop(0)
                        if isinstance(e, mp.TimeoutError):
                            # the task may still complete later (stuck
                            # worker): keep the future so its shm gets
                            # drained at close
                            abandoned.append([samples, fut, attempts])
                        result = self._recover_batch(samples, attempts, e)
                        if result is None:   # resubmitted (ordered: front)
                            submit(samples, attempts + 1, front=True)
                            continue
                    else:
                        in_flight.pop(0)
                    b = next(batches, None)
                    if b is not None:
                        submit(b)
                    out = wrap(result)
                n_yielded += 1
                yield out
        finally:
            # consumer abandoned the iterator (generator close / exception /
            # timeout) with batches still in flight: import-and-unlink their
            # shm segments so nothing leaks in /dev/shm until reboot. One
            # deadline across ALL futures: a stuck worker must not stall
            # generator close by 5s per prefetched batch.
            import time

            deadline = time.monotonic() + 5.0
            for _samples, fut, _attempts in in_flight + abandoned:
                try:
                    _unlink_shm_tree(
                        fut.get(max(0.0, deadline - time.monotonic())))
                except Exception as e:
                    _suppressed("shm.drain", e)   # abandoned-iterator sweep

    def _recover_batch(self, samples, attempts, exc):
        """Worker-task failure policy: classify, then retry (return None:
        the caller resubmits at the queue front to preserve batch order)
        or compute the batch in-process as the loud last resort. Fatal
        errors re-raise: a deterministic dataset bug must not be laundered
        through the retry budget."""
        from ...fault.retry import classify_exception
        from ...telemetry import registry

        kind = classify_exception(exc)
        if kind == "fatal":
            _LOG.error(
                "DataLoader worker task failed with fatal %s (samples "
                "%s..): %s — propagating, not retrying",
                type(exc).__name__, list(samples)[:4], exc)
            raise exc
        if attempts < self._worker_retries:
            registry.counter("mx_retries_total",
                             "retries taken by fault.RetryPolicy").inc()
            registry.counter("mx_retries_total",
                             "retries taken by fault.RetryPolicy",
                             labels={"policy": "dataloader"}).inc()
            _LOG.warning(
                "DataLoader worker task failed with retryable %s (attempt "
                "%d/%d): %s — resubmitting to the (respawned) pool",
                type(exc).__name__, attempts + 1, self._worker_retries, exc)
            return None
        registry.counter(
            "mx_dataloader_fallbacks_total",
            "batches recomputed in-process after worker retries").inc()
        _LOG.error(
            "DataLoader worker retries exhausted (%d) for %s: %s — "
            "falling back to single-process batchify for this batch "
            "(slow but correct)", self._worker_retries,
            type(exc).__name__, exc)
        return self._batchify_fn([self._dataset[i] for i in samples])

    def __len__(self):
        return len(self._batch_sampler)

    def __del__(self):
        if getattr(self, "_finalizer", None) is not None:
            self._finalizer()
