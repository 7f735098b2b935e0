"""Preemption-aware checkpointing (port of
`incubator_mxnet_tpu/preemption.py`).

MXNet's own failure story is checkpoint-restart
(`example/image-classification/common/fit.py` --model-prefix resume flow):
orchestration just kills workers. Cloud machines are preempted routinely
(maintenance events send SIGTERM with a grace window), so the package
makes the save-on-preemption hook a first-class subsystem.

Design:
- `on_preemption(save_fn)` registers `save_fn` to run when SIGTERM/SIGINT
  arrives (chainable with any previously-installed handler) or when
  `trigger()` is called programmatically (tests, custom watchdogs).
- `atomic_save(path, write_fn)` writes through a temp file + `os.replace`
  so a checkpoint killed mid-write never corrupts the last good one, then
  a ``<path>.crc32`` sidecar (``"<crc32 hex> <size>"``) and, when asked, a
  ``<path>.layout.json`` topology sidecar. The write runs under the
  ``checkpoint`` retry policy, the ``checkpoint_write`` chaos seam, a
  ``checkpoint.write`` span and the goodput ledger's ``checkpoint``
  lease. The files are byte for byte the reference's, so either package
  checks the other's.
- `CheckpointManager` composes both: `manager.step(...)` saves every
  `every_n` steps AND immediately on preemption, keeping `keep` rotated
  checkpoint files; `latest()` resumes. `TrainingCheckpointer` writes a
  net's parameters, its Trainer's states and the step into one
  checksummed file, and resumes from the newest generation that
  validates.

The runtime layout (`_runtime_layout`) is the minimal one: the format,
the device count (the membership's ranks, one card a rank), the process
count, the membership generation and the ambient mesh's axes; elastic
trainers install `fault.elastic.checkpoint_layout`, which adds each
leaf's spec. A resume across a device-count change reshards the loaded
parameters onto the live mesh (`fault.elastic.reshard_net`), or raises
`LayoutMismatch` with ``MXNET_ELASTIC=0``.
"""
from __future__ import annotations

import os
import signal
import threading

__all__ = ["on_preemption", "remove_preemption_hook",
           "clear_preemption_hooks", "trigger", "preempted", "atomic_save",
           "checkpoint_checksum", "verify_checkpoint", "CheckpointCorrupt",
           "LayoutMismatch", "load_layout", "CheckpointManager",
           "TrainingCheckpointer"]

_HOOKS: list = []
_LOCK = threading.Lock()
_STATE = {"installed": False, "preempted": False, "prev": {}}


def _run_hooks(signum=None, frame=None):  # noqa: ARG001
    _STATE["preempted"] = True
    with _LOCK:
        hooks = list(_HOOKS)
    for fn in hooks:
        try:
            fn()
        except Exception as e:
            # a failing hook must not mask the shutdown path — but it
            # must be SEEN (the checkpoint it was saving did not happen)
            import logging

            logging.getLogger("incubator_mxnet_tpu_torch.fault").error(
                "preemption hook %r failed: %s: %s", fn,
                type(e).__name__, e)
    # chain to the previously-installed handler (graceful frameworks
    # layering on top of us keep working); if the previous disposition was
    # the DEFAULT terminating action, re-deliver so the process actually
    # dies inside its grace window instead of looping on
    prev = _STATE["prev"].get(signum)
    if callable(prev):
        prev(signum, frame)
    elif signum is not None and prev == signal.SIG_DFL:
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)


def _install():
    if _STATE["installed"] or threading.current_thread() is not \
            threading.main_thread():
        return
    for sig in (signal.SIGTERM, signal.SIGINT):
        prev = signal.getsignal(sig)
        if prev not in (_run_hooks,):
            _STATE["prev"][sig] = prev
            signal.signal(sig, _run_hooks)
    _STATE["installed"] = True


def on_preemption(save_fn):
    """Register `save_fn()` to run on SIGTERM/SIGINT (or `trigger()`).
    Returns `save_fn` so it stacks as a decorator."""
    _install()
    with _LOCK:
        _HOOKS.append(save_fn)
    return save_fn


def remove_preemption_hook(save_fn):
    """Unregister a hook added by `on_preemption` (no-op if absent)."""
    with _LOCK:
        if save_fn in _HOOKS:
            _HOOKS.remove(save_fn)


def clear_preemption_hooks():
    with _LOCK:
        _HOOKS.clear()
    _STATE["preempted"] = False


def trigger():
    """Programmatic preemption (tests / external watchdogs)."""
    _run_hooks(None, None)


def preempted() -> bool:
    return _STATE["preempted"]


_CRC_SUFFIX = ".crc32"
_LAYOUT_SUFFIX = ".layout.json"


class CheckpointCorrupt(OSError):
    """A checkpoint file failed checksum validation (truncated or
    corrupt). Retryable-classified: loaders fall back to the previous
    generation (`TrainingCheckpointer.resume`)."""


class LayoutMismatch(RuntimeError):
    """A checkpoint's layout sidecar names a different device topology
    than the resuming runtime while elastic resharding is off
    (``MXNET_ELASTIC=0``). NON-retryable, and deliberately NOT a
    generation-fallback trigger: every older generation was written under
    the same dead topology, so `resume` raises instead of walking the
    rotation."""

    non_retryable = True


def checkpoint_checksum(path):
    """CRC32 of a file's bytes (streamed, 1 MiB chunks)."""
    import zlib

    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _write_checksum(path):
    """Sidecar `<path>.crc32` holding 'crc_hex size' — written through the
    same tmp+rename dance so the pair can never half-update."""
    crc = checkpoint_checksum(path)
    size = os.path.getsize(path)
    tmp = f"{path}{_CRC_SUFFIX}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{crc:08x} {size}\n")
    os.replace(tmp, path + _CRC_SUFFIX)


def verify_checkpoint(path):
    """Validate `path` against its checksum sidecar. Returns True
    (verified), False (MISMATCH — truncated/corrupt), or None (no sidecar
    — unverifiable legacy file, callers decide)."""
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


def _write_layout(path, layout):
    """Sidecar `<path>.layout.json` recording the device topology the
    checkpoint was written under (device/process count, mesh axes,
    per-leaf PartitionSpec fingerprints — see `fault.elastic`), written
    through the same tmp+rename dance as the checksum so the pair can
    never half-update. Resume compares it against the live runtime to
    detect a topology change."""
    import json

    tmp = f"{path}{_LAYOUT_SUFFIX}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(layout, f, sort_keys=True)
    os.replace(tmp, path + _LAYOUT_SUFFIX)


def load_layout(path):
    """The layout sidecar written next to checkpoint `path` (None when
    absent or unreadable — a pre-elastic legacy checkpoint)."""
    import json

    try:
        with open(path + _LAYOUT_SUFFIX) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def atomic_save(path, write_fn, checksum=True, layout=None):
    """Crash-safe write: `write_fn(tmp_path)` then atomic rename, plus a
    `<path>.crc32` sidecar for load-time validation (and, when `layout`
    is given, a `<path>.layout.json` topology sidecar for elastic
    resume). A kill mid-write leaves the previous checkpoint intact. The
    write body carries the 'checkpoint_write' chaos seam and runs under
    the 'checkpoint' retry policy (MXNET_RETRY_*): a transient I/O
    failure re-runs `write_fn` from scratch on the same tmp path —
    idempotent by construction."""
    tmp = f"{path}.tmp.{os.getpid()}"

    def _write():
        from .fault import injection

        injection.inject_at("checkpoint_write")
        write_fn(tmp)

    from .fault.retry import RetryExhausted, RetryPolicy
    from .telemetry import goodput, tracing

    with tracing.span("checkpoint.write", path=str(path)), \
            goodput.lease("checkpoint"):
        try:
            RetryPolicy.from_env("checkpoint").call(_write)
        except Exception as e:
            try:
                os.remove(tmp)                # no orphaned partial tmp
            except OSError:
                pass
            if isinstance(e, RetryExhausted):
                raise e.last from e   # callers keep seeing the writer's
            raise                     # error
        os.replace(tmp, path)
        if checksum:
            _write_checksum(path)
        if layout is not None:
            _write_layout(path, layout)
    return path


class CheckpointManager:
    """Periodic + preemption-triggered checkpointing with rotation.

    save_state(path) must serialize everything needed to resume (e.g.
    `net.save_parameters` + `trainer.save_states` into one file or a
    directory)."""

    def __init__(self, prefix, save_state, every_n=100, keep=3,
                 register_signal=True, layout_fn=None):
        self._prefix = prefix
        self._save_state = save_state
        self._every_n = max(1, int(every_n))
        self._keep = max(1, int(keep))
        self._step = 0
        self._saved: list = []
        self._last_saved_step = None
        self._saving = False
        # layout_fn() -> the topology sidecar dict written next to every
        # checkpoint (e.g. fault.elastic.checkpoint_layout(trainer))
        self._layout_fn = layout_fn
        if register_signal:
            on_preemption(self.save_now)

    def path_for(self, step):
        return f"{self._prefix}-{step:07d}.ckpt"

    def step(self, n=1):
        """Advance the step counter; save when the cadence hits."""
        self._step += n
        if self._step % self._every_n == 0:
            self.save_now()
        return self._step

    def save_now(self):
        if self._last_saved_step == self._step:
            return None  # idempotent (signal during periodic save)
        if self._saving:
            # a signal landed MID-save (signal handlers run on the main
            # thread between bytecodes): re-entering atomic_save would
            # interleave writes on the same tmp path and corrupt the
            # checkpoint being written — skip; the in-progress save is
            # already persisting this step's state
            return None
        self._saving = True
        try:
            path = self.path_for(self._step)
            layout = self._layout_fn() if self._layout_fn is not None \
                else None
            atomic_save(path, self._save_state, layout=layout)
            self._last_saved_step = self._step
            self._saved.append(path)
            while len(self._saved) > self._keep:
                old = self._saved.pop(0)
                for p in (old, old + _CRC_SUFFIX, old + _LAYOUT_SUFFIX):
                    try:
                        os.remove(p)
                    except OSError:
                        pass
            return path
        finally:
            self._saving = False

    def generations(self):
        """Every on-disk checkpoint generation, oldest first."""
        import glob

        return sorted(glob.glob(f"{self._prefix}-*.ckpt"))

    def latest(self):
        """Most recent checkpoint path on disk (None if none)."""
        found = self.generations()
        return found[-1] if found else None


def _runtime_layout():
    """Minimal topology fingerprint of the live runtime, the default
    layout sidecar: the format, the device count (the membership's ranks,
    one card a rank), the process count, the membership generation and
    the ambient mesh's axes (`fault.elastic.checkpoint_layout` is the
    rich per-leaf-spec version elastic trainers install instead)."""
    from .parallel import dist
    from .parallel.mesh import current_mesh

    layout = {"format": 1, "device_count": int(dist.world_size()),
              "process_count": int(dist.num_processes()),
              "generation": dist.generation()}
    m = current_mesh()
    if m is not None:
        layout["mesh"] = {"axes": [[str(n), int(s)] for n, s in
                                   zip(m.axis_names, m.devices.shape)]}
    return layout


class TrainingCheckpointer:
    """Preemption-safe train-state checkpointing wired to Gluon.

    One file per checkpoint holding net parameters, Trainer/optimizer
    states (momenta, num_update), and the step counter — everything a
    restarted process needs to continue the exact loss trajectory
    (reference role: `--model-prefix` resume in
    `example/image-classification/common/fit.py`, plus the estimator's
    CheckpointHandler; here resume survives SIGTERM preemption).

    Usage::

        ckpt = TrainingCheckpointer(prefix, net, trainer, every_n=50)
        start = ckpt.resume()            # 0 on a fresh run
        for step in range(start, total):
            ...train...
            ckpt.step()                  # periodic + SIGTERM-triggered
    """

    def __init__(self, prefix, net, trainer=None, every_n=100, keep=3,
                 register_signal=True, layout_fn=None):
        self._net = net
        self._trainer = trainer
        # every checkpoint gets at least the minimal topology sidecar so
        # resume can detect a device-count change; elastic trainers pass
        # fault.elastic.checkpoint_layout for the per-leaf spec version
        self._mgr = CheckpointManager(prefix, self._write, every_n=every_n,
                                      keep=keep,
                                      register_signal=register_signal,
                                      layout_fn=layout_fn or _runtime_layout)
        self._reshard_layout = None

    def _write(self, path):
        import pickle
        import tempfile

        blob = {"step": self._mgr._step}  # noqa: SLF001
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "net.params")
            self._net.save_parameters(p)
            with open(p, "rb") as f:
                blob["params"] = f.read()
            if self._trainer is not None:
                t = os.path.join(d, "trainer.states")
                self._trainer.save_states(t)
                with open(t, "rb") as f:
                    blob["trainer"] = f.read()
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    def step(self, n=1):
        return self._mgr.step(n)

    def save_now(self):
        return self._mgr.save_now()

    def _load_blob(self, path):
        """Checksum-validated unpickle: CheckpointCorrupt on a truncated
        or bit-flipped file (the sidecar catches corruption pickle can't),
        so `resume` can fall back to the previous generation."""
        import pickle

        if verify_checkpoint(path) is False:
            raise CheckpointCorrupt(
                f"checkpoint {path} failed checksum validation "
                "(truncated or corrupt)")
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except (EOFError, pickle.UnpicklingError, OSError) as e:
            raise CheckpointCorrupt(
                f"checkpoint {path} is unreadable: "
                f"{type(e).__name__}: {e}") from e

    def resume(self):
        """Load the most recent VALID checkpoint; returns the step to
        continue from (0 when starting fresh). A corrupted or truncated
        newest generation raises a clear error internally, is logged, and
        resume automatically falls back to the previous generation
        (counted in ``mx_checkpoint_fallbacks_total``); only when every
        generation fails does resume raise."""
        import logging
        import tempfile

        from .telemetry import goodput, tracing

        log = logging.getLogger("incubator_mxnet_tpu_torch.fault")
        with tracing.span("checkpoint.resume",
                          prefix=self._mgr._prefix), \
                goodput.lease("recovery"):   # noqa: SLF001 (mgr prefix)
            return self._resume_impl(log, tempfile)

    def _check_layout(self, side, path, log):
        """Layout-sidecar guard: a checkpoint written under a different
        device count (the membership's ranks) either routes through
        elastic resharding (default) or raises a clear
        :class:`LayoutMismatch` (``MXNET_ELASTIC=0``), never a shape
        error deep inside a load."""
        if side is None:            # pre-elastic legacy checkpoint
            return
        from .parallel import dist

        saved = side.get("device_count")
        live = int(dist.world_size())
        if saved is None or int(saved) == live:
            return
        from .fault.elastic import elastic_enabled

        if not elastic_enabled():
            raise LayoutMismatch(
                f"checkpoint {path} was written on {saved} device(s) but "
                f"the runtime has {live}, and elastic resharding is "
                "disabled (MXNET_ELASTIC=0) — restore the original "
                "topology or re-enable MXNET_ELASTIC to reshard on "
                "resume")
        from .telemetry import registry

        registry.counter(
            "mx_elastic_layout_resumes_total",
            "checkpoint resumes that crossed a device-count change "
            "(resharded via fault.elastic)").inc()
        log.warning(
            "checkpoint resume: device count changed %s -> %s — params "
            "will be resharded onto the live topology (fault.elastic)",
            saved, live)
        self._reshard_layout = side

    def _resume_impl(self, log, tempfile):
        paths = self._mgr.generations()
        blob, path, errors = None, None, []
        for candidate in reversed(paths):
            try:
                blob = self._load_blob(candidate)
                path = candidate
                break
            except Exception as e:
                errors.append(f"{candidate}: {e}")
                log.error(
                    "checkpoint resume: %s — falling back to the previous "
                    "generation", e)
                from .telemetry import registry

                registry.counter(
                    "mx_checkpoint_fallbacks_total",
                    "corrupt checkpoint generations skipped at "
                    "resume").inc()
        if blob is None:
            if paths:
                from .base import MXNetError

                raise MXNetError(
                    "checkpoint resume: all %d generation(s) under prefix "
                    "%r failed validation:\n  %s" % (
                        len(paths), self._mgr._prefix,  # noqa: SLF001
                        "\n  ".join(errors)))
            return 0
        self._check_layout(load_layout(path), path, log)
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "net.params")
            with open(p, "wb") as f:
                f.write(blob["params"])
            self._net.load_parameters(p)
            if self._trainer is not None and "trainer" in blob:
                t = os.path.join(d, "trainer.states")
                with open(t, "wb") as f:
                    f.write(blob["trainer"])
                self._trainer.load_states(t)
        if self._reshard_layout is not None:
            # the checkpoint crossed a device-count change: cut the
            # freshly loaded whole parameters onto the live mesh
            from .fault import elastic

            elastic.reshard_net(self._net, self._reshard_layout)
            self._reshard_layout = None
        import glob

        step = int(blob["step"])
        self._mgr._step = step              # noqa: SLF001
        self._mgr._last_saved_step = step   # noqa: SLF001 — no resave
        # seed rotation with EVERY on-disk checkpoint (oldest first) so the
        # previous incarnation's files stay inside the `keep` bound instead
        # of leaking across preemption/restart cycles
        self._mgr._saved = sorted(          # noqa: SLF001
            glob.glob(f"{self._mgr._prefix}-*.ckpt"))  # noqa: SLF001
        return step
