"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``*.cu`` under ``incubator_mxnet_tpu_torch/csrc/`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, ``build/torch_kernels/<stem>-<hash>.so`` at the root of the
checkout. The hash covers the source, the headers beside it and the flags,
so an edited source is rebuilt and an unchanged one is reused. Stale
sources are compiled in parallel, one ``nvcc`` process each, all started
together. The compiler's output (``-Xptxas=-v``: registers, shared memory,
spills per kernel) is kept beside each library as ``<stem>-<hash>.log``.

Nothing here runs at import: the first wrapper that launches a kernel on
a CUDA tensor calls :func:`load`. The wrappers bind each entry point with
``argtypes`` (``c_void_p`` for every pointer and the stream) and raise
when the entry returns a non-zero ``cudaError_t``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..base import MXNetError

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "sources", "build_all",
           "load", "check", "build_logs"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise MXNetError("nvcc not found (set CUDA_HOME); the port's kernels are "
                     "built from source at first use")


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing or stale; return
    ``{stem: library path}`` for all sources."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        targets = {src: _target(src) for src in sources()}
        todo = [(s, t) for s, t in targets.items() if not t.exists()]
        procs = []
        try:
            for src, out in todo:
                tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for src, out, tmp, proc in procs:
                log, _ = proc.communicate()
                out.with_suffix(".log").write_text(log)
                if proc.returncode:
                    tmp.unlink(missing_ok=True)
                    failed.append(f"{src.name} (exit {proc.returncode}):\n"
                                  f"{log}")
                else:
                    os.replace(tmp, out)
        finally:
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise MXNetError("nvcc failed for " + "\n".join(failed))
        return {s.stem: t for s, t in targets.items()}


def build_logs() -> dict[str, str]:
    """The compiler's report for each built source (after `build_all`)."""
    out = {}
    for src in sources():
        log = _target(src).with_suffix(".log")
        out[src.stem] = log.read_text() if log.exists() else ""
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first
    use)."""
    lib = _LIBS.get(stem)
    if lib is None:
        paths = build_all()
        if stem not in paths:
            raise MXNetError(f"no CUDA source csrc/{stem}.cu")
        with _LOCK:
            lib = _LIBS.get(stem)
            if lib is None:
                lib = ctypes.CDLL(str(paths[stem]))
                lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
                lib.mx_cuda_error_string.restype = ctypes.c_char_p
                _LIBS[stem] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if err:
        msg = lib.mx_cuda_error_string(err).decode()
        raise MXNetError(f"{what}: CUDA error {err} ({msg})")
