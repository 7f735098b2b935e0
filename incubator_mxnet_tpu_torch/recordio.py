"""RecordIO container (port of `incubator_mxnet_tpu/recordio.py`; reference:
`python/mxnet/recordio.py` + dmlc recordio `src/io/image_recordio.h`).

A pure-Python implementation of the on-disk format: [magic u32][cflag:3|
len:29 u32][payload][pad to 4B], so record files packed by MXNet's
tools/im2rec, by the reference or by this package are the same bytes.
`MXIndexedRecordIO.read_batch` and `IndexCreator` read through the
native runtime (`_native`: librtio, mmap-backed) when it can be built,
and fall back to the Python reader when it cannot."""
from __future__ import annotations

import os
import struct

import numpy as onp

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "IndexCreator"]

_MAGIC = 0xCED7230A
_HEADER_FMT = "IfQQ"  # flag, label, id, id2
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)


class IRHeader:
    __slots__ = ("flag", "label", "id", "id2")

    def __init__(self, flag, label, id, id2=0):  # noqa: A002
        self.flag = flag
        self.label = label
        self.id = id
        self.id2 = id2


def pack(header, s):
    """Serialize header + payload into a record string."""
    label = header.label
    if isinstance(label, (int, float)):
        hdr = struct.pack(_HEADER_FMT, 0, float(label), header.id, header.id2)
        return hdr + s
    label = onp.asarray(label, dtype=onp.float32)
    hdr = struct.pack(_HEADER_FMT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    flag, label, id_, id2 = struct.unpack(_HEADER_FMT, s[:_HEADER_SIZE])
    s = s[_HEADER_SIZE:]
    if flag > 0:
        label = onp.frombuffer(s[:flag * 4], dtype=onp.float32)
        s = s[flag * 4:]
    header = IRHeader(flag, label, id_, id2)
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack a HWC uint8 image as JPEG/PNG (reference: recordio.py pack_img
    over cv2.imencode). Uses `image.imencode` (PIL), falling back to a raw
    .npy payload only when PIL is unavailable; `unpack_img` reads both."""
    from .image import imencode

    return pack(header, imencode(img, img_fmt=img_fmt, quality=quality))


def unpack_img(s, iscolor=-1):  # noqa: ARG001
    from .image import imdecode_np

    header, payload = unpack(s)
    # host decode (no device round trip); a .npy payload loads as it is
    return header, imdecode_np(payload)


class MXRecordIO:
    """Sequential reader/writer (reference: recordio.py MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.open()

    def open(self):
        if self.flag == "w":
            self._fp = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self._fp = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("flag must be 'r' or 'w'")
        self.is_open = True

    def close(self):
        if self.is_open:
            self._fp.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: FL006 — interpreter teardown: nothing left to log to
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_fp", None)
        # native handles (ctypes CDLL + raw pointers) cannot pickle;
        # they re-materialize lazily after unpickling
        d.pop("_native_file", None)
        d.pop("_native_ord", None)
        d["is_open"] = False
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self._fp.tell()

    def write(self, buf):
        assert self.writable
        self._fp.write(struct.pack("<I", _MAGIC))
        self._fp.write(struct.pack("<I", len(buf) & ((1 << 29) - 1)))
        self._fp.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self._fp.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        magic_raw = self._fp.read(4)
        if len(magic_raw) < 4:
            return None
        magic = struct.unpack("<I", magic_raw)[0]
        if magic != _MAGIC:
            raise IOError(f"invalid magic {magic:#x} in {self.uri}")
        lrec = struct.unpack("<I", self._fp.read(4))[0]
        length = lrec & ((1 << 29) - 1)
        buf = self._fp.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self._fp.read(pad)
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """Random-access reader via .idx file (reference: MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        super().__init__(uri, flag)
        if not self.writable and os.path.isfile(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        key = int(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)

    def close(self):
        if self.writable and getattr(self, "is_open", False):
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def seek(self, idx):
        self._fp.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def _native(self):
        """Lazy mmap-backed native reader (librtio) with a key→ordinal map;
        None when the native runtime is unavailable."""
        nat = getattr(self, "_native_file", False)
        if nat is not False:
            return nat
        self._native_file = None
        if not self.writable:
            try:
                from ._native import NativeRecordFile

                f = NativeRecordFile(self.uri)
                start_to_ord = {off: i
                                for i, off in enumerate(f.record_starts())}
                self._native_ord = {k: start_to_ord[off]
                                    for k, off in self.idx.items()
                                    if off in start_to_ord}
                if len(self._native_ord) == len(self.idx):
                    self._native_file = f
                else:
                    f.close()
            except Exception:
                self._native_file = None
        return self._native_file

    def read_batch(self, keys):
        """Read many records in one call. Uses the native mmap runtime
        (`src/rtio/rtio.cc`) when available — one C call, one copy out of
        the page cache — else falls back to per-key Python reads."""
        nat = self._native()
        if nat is not None:
            return nat.read_batch([self._native_ord[k] for k in keys])
        return [self.read_idx(k) for k in keys]

    def write_idx(self, idx, buf):
        pos = self.tell()
        self.write(buf)
        self.idx[idx] = pos
        self.keys.append(idx)


class IndexCreator:
    """Build a .idx for an existing .rec (reference: tools/rec2idx)."""

    def __init__(self, uri, idx_path):
        self.reader = MXRecordIO(uri, "r")
        self.idx_path = idx_path

    def create_index(self):
        # native fast path: one mmap scan in C (src/rtio/rtio.cc)
        try:
            from ._native import build_index

            n = build_index(self.reader.uri, self.idx_path)
            if n is not None:
                return
        except Exception as e:
            from .fault.retry import suppressed

            suppressed("recordio.native_index", e)  # python-index fallback
        entries = []
        i = 0
        while True:
            pos = self.reader.tell()
            buf = self.reader.read()
            if buf is None:
                break
            entries.append((i, pos))
            i += 1
        with open(self.idx_path, "w") as f:
            for k, pos in entries:
                f.write(f"{k}\t{pos}\n")

    def close(self):
        self.reader.close()


class MXRecordIOPrefetcher:
    """Threaded native prefetch iterator over a .rec file (reference:
    `src/io/iter_prefetcher.h` + `src/io/dataloader.cc` — C++ worker
    threads batch raw records into a bounded queue ahead of the consumer).

    Yields `list[bytes]` record payloads per batch; decode/augment on the
    Python side (or feed `unpack`/`unpack_img`). Requires librtio (built on
    demand); raises RuntimeError when the native runtime is unavailable.
    """

    def __init__(self, uri, batch_size, num_threads=2, queue_cap=4,
                 shuffle=False, seed=0, drop_last=True, indices=None):
        from ._native import NativePrefetchPipeline, NativeRecordFile

        self._file = NativeRecordFile(uri)
        self._pipe_args = dict(batch_size=batch_size,
                               num_threads=num_threads, queue_cap=queue_cap,
                               drop_last=drop_last, indices=indices)
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._make = NativePrefetchPipeline
        self._pipe = self._new_pipe()  # eagerly warm the first epoch

    def _new_pipe(self):
        seed = (self._seed + self._epoch) if self._shuffle else None
        return self._make(self._file, shuffle_seed=seed, **self._pipe_args)

    def __len__(self):
        if self._pipe is not None:
            return len(self._pipe)
        if self._file is None:
            return 0  # closed
        n = len(self._file)
        bs = self._pipe_args["batch_size"]
        if self._pipe_args.get("indices") is not None:
            n = len(self._pipe_args["indices"])
        return n // bs if self._pipe_args.get("drop_last", True) \
            else (n + bs - 1) // bs

    def __iter__(self):
        if self._file is None:
            return  # closed
        if self._pipe is None:
            self._pipe = self._new_pipe()  # lazy: built at epoch start
        try:
            yield from self._pipe
        finally:
            # epoch boundary — reached on full consumption AND on early
            # break (GeneratorExit lands here). Tear down only; the next
            # epoch's pipeline is built lazily so the final epoch doesn't
            # waste a prefetch round. Guarded: close() during iteration
            # already cleared the fields.
            if self._pipe is not None:
                self._pipe.close()
                self._pipe = None
            self._epoch += 1

    def close(self):
        if getattr(self, "_pipe", None) is not None:
            self._pipe.close()
            self._pipe = None
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None
