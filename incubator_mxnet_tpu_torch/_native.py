"""The native RecordIO runtime (port of `incubator_mxnet_tpu/_native.py`: a
thin ctypes bridge to ``src/rtio/rtio.cc`` and ``src/rtio/pipeline.cc``).

The port builds its own ``librtio`` from those sources, unedited, at first
use: one ``g++`` call into ``build/torch_native/librtio-<hash>.so`` at the
root of the checkout (the hash covers the sources and the flags, so an
edited source is rebuilt and an unchanged one is reused; the build writes
a temporary file and renames it, so processes building at once do not
clash). Nothing is built at import, and nothing is written into
``src/``. Everything degrades as in the reference: `rtio()` returns None
when the library cannot be built or loaded, and callers take the
pure-Python reader. `native_calls` counts the calls that read records
through the library (`NativeRecordFile.read_batch` and `read`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["repo_root", "rtio", "library_path", "NativeRecordFile",
           "NativePrefetchPipeline", "build_index", "native_calls"]

_LOCK = threading.Lock()
_RTIO = None
_RTIO_TRIED = False
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

#: record reads served by the library (a batch read counts once)
native_calls = 0


def repo_root():
    return str(Path(__file__).resolve().parent.parent)


def _sources():
    src = Path(repo_root()) / "src" / "rtio"
    return [src / "rtio.cc", src / "pipeline.cc"]


def library_path():
    """Where this checkout's library lives (built or not), or None when
    the sources are absent."""
    srcs = _sources()
    if not all(p.exists() for p in srcs):
        return None
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return Path(repo_root()) / "build" / "torch_native" / \
        f"librtio-{h.hexdigest()[:16]}.so"


def _build(out):
    """``g++`` the sources into ``out``; True on success."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, _sources()),
           "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return False
    if res.returncode != 0:
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def rtio():
    """ctypes handle to librtio, or None when unavailable."""
    global _RTIO, _RTIO_TRIED
    with _LOCK:
        if _RTIO_TRIED:
            return _RTIO
        _RTIO_TRIED = True
        lib = library_path()
        if lib is None or (not lib.exists() and not _build(lib)):
            return None
        _RTIO = _load_and_bind(str(lib))
        return _RTIO


def _load_and_bind(path):
    try:
        lib = ctypes.CDLL(path)
        lib.rtio_open.restype = ctypes.c_void_p
        lib.rtio_open.argtypes = [ctypes.c_char_p]
        lib.rtio_close.argtypes = [ctypes.c_void_p]
        lib.rtio_num_records.restype = ctypes.c_int64
        lib.rtio_num_records.argtypes = [ctypes.c_void_p]
        lib.rtio_record.restype = ctypes.c_int
        lib.rtio_record.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64)]
        lib.rtio_record_start.restype = ctypes.c_int64
        lib.rtio_record_start.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.rtio_record_starts.restype = ctypes.c_int64
        lib.rtio_record_starts.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int64),
                                           ctypes.c_int64]
        lib.rtio_batch_bytes.restype = ctypes.c_int64
        lib.rtio_batch_bytes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.rtio_read_batch.restype = ctypes.c_int
        lib.rtio_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.rtio_build_index.restype = ctypes.c_int64
        lib.rtio_build_index.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        # threaded prefetch pipeline (src/rtio/pipeline.cc)
        lib.rtio_pipeline_create.restype = ctypes.c_void_p
        lib.rtio_pipeline_create.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int]
        lib.rtio_pipeline_num_batches.restype = ctypes.c_int64
        lib.rtio_pipeline_num_batches.argtypes = [ctypes.c_void_p]
        lib.rtio_pipeline_pop.restype = ctypes.c_void_p
        lib.rtio_pipeline_pop.argtypes = [ctypes.c_void_p]
        lib.rtio_pipeline_close.argtypes = [ctypes.c_void_p]
        lib.rtio_batch_count.restype = ctypes.c_int64
        lib.rtio_batch_count.argtypes = [ctypes.c_void_p]
        lib.rtio_batch_total_bytes.restype = ctypes.c_int64
        lib.rtio_batch_total_bytes.argtypes = [ctypes.c_void_p]
        lib.rtio_batch_record.restype = ctypes.c_int
        lib.rtio_batch_record.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64)]
        lib.rtio_batch_release.argtypes = [ctypes.c_void_p]
        return lib
    except (OSError, AttributeError):
        # unloadable, or a library missing a symbol
        return None


class NativeRecordFile:
    """mmap-backed random-access RecordIO reader over librtio
    (reference: dmlc::RecordIOReader + iter_image_recordio_2.cc's
    prefetching reader)."""

    def __init__(self, rec_path):
        lib = rtio()
        if lib is None:
            raise RuntimeError("librtio unavailable (g++ missing?)")
        self._lib = lib
        self._h = lib.rtio_open(rec_path.encode())
        if not self._h:
            raise IOError(f"rtio_open failed for {rec_path}")

    def __len__(self):
        return int(self._lib.rtio_num_records(self._h))

    def read(self, i) -> bytes:
        global native_calls
        data = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_int64()
        if self._lib.rtio_record(self._h, i, ctypes.byref(data),
                                 ctypes.byref(ln)) != 0:
            raise IndexError(i)
        native_calls += 1
        return ctypes.string_at(data, ln.value)

    def record_starts(self):
        """All record header offsets in one native call."""
        n = len(self)
        out = (ctypes.c_int64 * n)()
        got = self._lib.rtio_record_starts(self._h, out, n)
        if got != n:
            raise IOError("rtio_record_starts failed")
        return list(out)

    def read_batch(self, idxs) -> list[bytes]:
        """One C call for the whole batch (single copy out of page cache)."""
        global native_calls
        n = len(idxs)
        idx_arr = (ctypes.c_int64 * n)(*idxs)
        total = self._lib.rtio_batch_bytes(self._h, idx_arr, n)
        if total < 0:
            raise IndexError(list(idxs))
        buf = (ctypes.c_uint8 * total)()
        offs = (ctypes.c_int64 * n)()
        lens = (ctypes.c_int64 * n)()
        rc = self._lib.rtio_read_batch(self._h, idx_arr, n, buf, total,
                                       offs, lens)
        if rc != 0:
            raise IOError(f"rtio_read_batch rc={rc}")
        native_calls += 1
        raw = bytes(buf)
        return [raw[offs[j]:offs[j] + lens[j]] for j in range(n)]

    def close(self):
        if getattr(self, "_h", None):
            self._lib.rtio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: FL006 — interpreter teardown: nothing left to log to
            pass


class NativePrefetchPipeline:
    """Threaded C++ prefetch pipeline over a NativeRecordFile (reference:
    `src/io/iter_prefetcher.h` PrefetcherIter + `src/io/dataloader.cc`
    ThreadedDataLoader). Worker threads batch records off the mmap into a
    bounded queue; `__iter__` yields `list[bytes]` batches. The pipeline
    must be closed (or exhausted) before the underlying file is closed."""

    def __init__(self, rec_file: "NativeRecordFile", batch_size: int,
                 indices=None, num_threads: int = 2, queue_cap: int = 4,
                 shuffle_seed: int | None = None, drop_last: bool = True):
        self._lib = rec_file._lib
        self._file = rec_file  # keep alive: pipeline borrows its handle
        idx_arr, n = None, 0
        if indices is not None:
            indices = list(indices)
            n = len(indices)
            idx_arr = (ctypes.c_int64 * n)(*indices)
        self._p = self._lib.rtio_pipeline_create(
            rec_file._h, idx_arr, n, int(batch_size), int(num_threads),
            int(queue_cap),
            -1 if shuffle_seed is None else int(shuffle_seed),
            1 if drop_last else 0)
        if not self._p:
            raise RuntimeError("rtio_pipeline_create failed")

    def __len__(self):
        if not self._p:
            return 0  # closed
        return int(self._lib.rtio_pipeline_num_batches(self._p))

    def __iter__(self):
        while True:
            if not self._p:
                return
            bp = self._lib.rtio_pipeline_pop(self._p)
            if not bp:
                return
            try:
                cnt = int(self._lib.rtio_batch_count(bp))
                out = []
                data = ctypes.POINTER(ctypes.c_uint8)()
                ln = ctypes.c_int64()
                for j in range(cnt):
                    self._lib.rtio_batch_record(bp, j, ctypes.byref(data),
                                                ctypes.byref(ln))
                    out.append(ctypes.string_at(data, ln.value))
            finally:
                self._lib.rtio_batch_release(bp)
            yield out

    def close(self):
        if getattr(self, "_p", None):
            self._lib.rtio_pipeline_close(self._p)
            self._p = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: FL006 — interpreter teardown: nothing left to log to
            pass


def build_index(rec_path, idx_path):
    """Native .idx builder; returns record count or None if unavailable."""
    lib = rtio()
    if lib is None:
        return None
    n = lib.rtio_build_index(rec_path.encode(), idx_path.encode())
    return None if n < 0 else int(n)
