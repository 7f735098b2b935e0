"""Crash-safe checkpoint writes (the part of
`incubator_mxnet_tpu/preemption.py` the port's `save_parameters` and
`Trainer.save_states` use: `atomic_save` :194, `verify_checkpoint` :151,
`checkpoint_checksum`).

A file is written to a temporary path and renamed over the target, then a
``<path>.crc32`` sidecar holding ``"<crc32 hex> <size>"`` is written the
same way, so a kill mid-write leaves the previous file intact and a
truncated file is caught at load. The files are byte for byte the
reference's, so either package checks the other's. The reference's retry
policy, chaos seam, tracing span and goodput lease around the write, the
``layout`` sidecar and the checkpoint managers are not ported yet.
"""
from __future__ import annotations

import os
import zlib

__all__ = ["atomic_save", "verify_checkpoint", "checkpoint_checksum"]

_CRC_SUFFIX = ".crc32"


def checkpoint_checksum(path):
    """CRC32 of a file's bytes (streamed, 1 MiB chunks)."""
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _write_checksum(path):
    crc = checkpoint_checksum(path)
    size = os.path.getsize(path)
    tmp = f"{path}{_CRC_SUFFIX}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{crc:08x} {size}\n")
    os.replace(tmp, path + _CRC_SUFFIX)


def verify_checkpoint(path):
    """True (verified), False (mismatch: truncated or corrupt) or None (no
    sidecar)."""
    side = path + _CRC_SUFFIX
    if not os.path.exists(side):
        return None
    try:
        with open(side) as f:
            crc_hex, size = f.read().split()
        return (os.path.getsize(path) == int(size)
                and checkpoint_checksum(path) == int(crc_hex, 16))
    except (OSError, ValueError):
        return False


def atomic_save(path, write_fn, checksum=True, layout=None):
    """``write_fn(tmp_path)``, then an atomic rename onto ``path`` and the
    checksum sidecar. ``layout`` (the elastic topology sidecar) is not
    ported and must be None."""
    if layout is not None:
        from .base import MXNetError

        raise MXNetError("atomic_save(layout=...): the topology sidecar is "
                         "not ported (ROADMAP.md §1 item 9)")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write_fn(tmp)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)
    if checksum:
        _write_checksum(path)
    return path
