"""recordio: chunked record files with per-chunk crc32 + compression
(counterpart of paddle_tpu/runtime/recordio.py; reference:
paddle/fluid/recordio/* and python/paddle/fluid/recordio_writer.py).

ctypes bindings over the C++ runtime (runtime.cc, built by build.py on
first use), with a pure-Python implementation of the SAME on-disk format:
the branch that runs where no compiler is found, and the cross-check of
the format in the tests. Where the library is built, every call goes to
it, and a native call that fails raises; nothing gives way to the Python
branch then. Also here: the bounded byte ``Channel``, the
``StagingArena``, the zero-copy array-frame codec the DataLoader's
shared-memory ring uses, and ``batch_assemble``, the threaded gather.
"""
from __future__ import annotations

import ctypes
import os
import pickle
import struct
import time
import zlib
from typing import Iterator, Optional

from .build import lib_path

__all__ = [
    "RecordIOWriter",
    "RecordIOReader",
    "PrefetchReader",
    "Channel",
    "StagingArena",
    "RecordIOError",
    "native_available",
    "batch_assemble",
    "recordio_convert",
    "recordio_sample_reader",
    "frame_encodable",
    "frame_nbytes",
    "frame_tag",
    "encode_frame",
    "encode_frame_into",
    "encode_frame_pickle",
    "decode_frame",
]

_MAGIC = 0x50445452
_HDR = struct.Struct("<IIIQQI")  # magic, comp, nrec, rawlen, complen, crc


class RecordIOError(IOError):
    pass


_lib = None
# set (by a test) to run the Python branch where the library builds
_load_failed = False


def _load():
    """The runtime library, bound; None where it cannot be built (the
    Python branch). A library that was built but does not load raises."""
    global _lib
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    path = lib_path()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise RecordIOError("the runtime library %s does not load: %s"
                            % (path, e)) from e
    lib.ptrt_rio_writer_open.restype = ctypes.c_void_p
    lib.ptrt_rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.ptrt_rio_writer_write.restype = ctypes.c_int
    lib.ptrt_rio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.ptrt_rio_writer_close.restype = ctypes.c_int
    lib.ptrt_rio_writer_close.argtypes = [ctypes.c_void_p]
    lib.ptrt_rio_reader_open.restype = ctypes.c_void_p
    lib.ptrt_rio_reader_open.argtypes = [ctypes.c_char_p]
    lib.ptrt_rio_reader_next.restype = ctypes.c_int64
    lib.ptrt_rio_reader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char))]
    lib.ptrt_rio_reader_close.argtypes = [ctypes.c_void_p]
    lib.ptrt_prefetch_open.restype = ctypes.c_void_p
    lib.ptrt_prefetch_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.ptrt_prefetch_next.restype = ctypes.c_int64
    lib.ptrt_prefetch_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char))]
    lib.ptrt_prefetch_close.argtypes = [ctypes.c_void_p]
    lib.ptrt_chan_create.restype = ctypes.c_void_p
    lib.ptrt_chan_create.argtypes = [ctypes.c_int64]
    lib.ptrt_chan_send.restype = ctypes.c_int
    lib.ptrt_chan_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.ptrt_chan_recv.restype = ctypes.c_int64
    lib.ptrt_chan_recv.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char))]
    lib.ptrt_chan_recv_batch.restype = ctypes.c_int64
    lib.ptrt_chan_recv_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ctypes.POINTER(ctypes.c_int64)]
    lib.ptrt_chan_size.restype = ctypes.c_int64
    lib.ptrt_chan_size.argtypes = [ctypes.c_void_p]
    lib.ptrt_chan_close.argtypes = [ctypes.c_void_p]
    lib.ptrt_chan_destroy.argtypes = [ctypes.c_void_p]
    lib.ptrt_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.ptrt_arena_create.restype = ctypes.c_void_p
    lib.ptrt_arena_create.argtypes = [ctypes.c_int64]
    lib.ptrt_arena_alloc.restype = ctypes.c_void_p
    lib.ptrt_arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.ptrt_arena_reset.argtypes = [ctypes.c_void_p]
    lib.ptrt_arena_used.restype = ctypes.c_int64
    lib.ptrt_arena_used.argtypes = [ctypes.c_void_p]
    lib.ptrt_arena_destroy.argtypes = [ctypes.c_void_p]
    lib.ptrt_batch_assemble.restype = None
    lib.ptrt_batch_assemble.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _take(lib, buf_ptr, length: int) -> bytes:
    data = ctypes.string_at(buf_ptr, length)
    lib.ptrt_free(buf_ptr)
    return data


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class RecordIOWriter:
    """with RecordIOWriter(path) as w: w.write(b"...")"""

    def __init__(self, path: str, compressor: int = 1, max_chunk_records: int = 1000):
        self._path = path
        self._compressor = compressor
        self._max = max_chunk_records
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.ptrt_rio_writer_open(
                path.encode(), compressor, max_chunk_records)
            if not self._h:
                raise RecordIOError("cannot open %s for writing" % path)
        else:  # the Python branch, same format
            self._f = open(path, "wb")
            self._pending = []

    def write(self, record: bytes):
        if self._lib is not None:
            rc = self._lib.ptrt_rio_writer_write(self._h, record, len(record))
            if rc != 0:
                raise RecordIOError("write failed on %s" % self._path)
            return
        self._pending.append(bytes(record))
        if len(self._pending) >= self._max:
            self._flush_py()

    def _flush_py(self):
        if not self._pending:
            return
        raw = b"".join(struct.pack("<I", len(r)) + r for r in self._pending)
        stored = zlib.compress(raw, 6) if self._compressor == 1 else raw
        crc = zlib.crc32(stored) & 0xFFFFFFFF
        self._f.write(_HDR.pack(_MAGIC, self._compressor, len(self._pending),
                                len(raw), len(stored), crc))
        self._f.write(stored)
        self._pending = []

    def close(self):
        if self._lib is not None:
            if self._h:
                rc = self._lib.ptrt_rio_writer_close(self._h)
                self._h = None
                if rc != 0:
                    raise RecordIOError("flush failed on %s" % self._path)
        else:
            self._flush_py()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class RecordIOReader:
    """Iterates records; raises RecordIOError on checksum/format corruption.

    ``tolerant=True`` turns corruption from a crash into a SKIP: a chunk
    whose header/magic/crc/decompress fails is dropped, the reader
    resynchronizes on the next chunk magic, and iteration continues with
    whatever survives (``skipped_chunks`` counts the losses, and each
    skip ticks ``paddle_tpu_train_skipped_batches_total{reason=
    "corrupt_chunk"}``). Chunk-level recovery needs byte-level seeks the
    frozen C ABI does not expose, so tolerant mode always runs the
    pure-Python implementation of the same on-disk format."""

    def __init__(self, path: str, tolerant: bool = False):
        if not os.path.exists(path):
            raise RecordIOError("no such recordio file: %s" % path)
        self._path = path
        self.tolerant = bool(tolerant)
        self.skipped_chunks = 0
        self._lib = None if self.tolerant else _load()
        if self._lib is not None:
            self._h = self._lib.ptrt_rio_reader_open(path.encode())
            if not self._h:
                raise RecordIOError("cannot open %s" % path)
        else:
            self._f = open(path, "rb")
            self._chunk: list = []

    def _corrupt(self, why: str):
        """One corrupt chunk: raise (strict) or count + resync
        (tolerant). Returns True when iteration can continue."""
        if not self.tolerant:
            raise RecordIOError("%s in %s" % (why, self._path))
        self.skipped_chunks += 1
        from .. import observability as obs

        obs.TRAIN_SKIPPED_BATCHES.inc(reason="corrupt_chunk")
        return self._resync()

    def _resync(self) -> bool:
        """Scan forward for the next chunk magic (the header of the
        chunk AFTER the torn one); positions the file AT it. False at
        EOF — the tail is lost, iteration ends cleanly."""
        needle = struct.pack("<I", _MAGIC)
        tail = b""
        while True:
            block = self._f.read(1 << 16)
            if not block:
                return False
            window = tail + block
            # the torn chunk's own magic is already behind the file
            # position (the caller seeks to start+1 before resyncing),
            # so any match here is strictly forward progress
            idx = window.find(needle)
            if idx >= 0:
                # rewind to the magic: current pos - bytes past it
                self._f.seek(-(len(window) - idx), os.SEEK_CUR)
                return True
            tail = window[-(len(needle) - 1):]

    def __iter__(self) -> Iterator[bytes]:
        if self._lib is not None:
            buf = ctypes.POINTER(ctypes.c_char)()
            while True:
                n = self._lib.ptrt_rio_reader_next(self._h, ctypes.byref(buf))
                if n == -1:
                    return
                if n < 0:
                    raise RecordIOError(
                        "corrupt recordio chunk in %s" % self._path)
                yield _take(self._lib, buf, n)
        else:
            while True:
                start = self._f.tell()
                hdr = self._f.read(_HDR.size)
                if not hdr:
                    return
                if len(hdr) < _HDR.size:
                    if not self._corrupt("truncated recordio header"):
                        return
                    continue
                magic, comp, nrec, rawlen, complen, crc = _HDR.unpack(hdr)
                if magic != _MAGIC:
                    # a desynced read: restart the scan just past the
                    # bad header position, not past complen garbage
                    self._f.seek(start + 1)
                    if not self._corrupt("bad magic"):
                        return
                    continue
                stored = self._f.read(complen)
                if len(stored) != complen or \
                        (zlib.crc32(stored) & 0xFFFFFFFF) != crc:
                    # complen itself may be garbage: rescan from just
                    # past this chunk's magic
                    self._f.seek(start + 1)
                    if not self._corrupt("corrupt recordio chunk"):
                        return
                    continue
                try:
                    raw = zlib.decompress(stored) if comp == 1 else stored
                    recs = []
                    pos = 0
                    for _ in range(nrec):
                        (ln,) = struct.unpack_from("<I", raw, pos)
                        pos += 4
                        recs.append(raw[pos:pos + ln])
                        pos += ln
                except Exception:
                    self._f.seek(start + 1)
                    if not self._corrupt("undecodable recordio chunk"):
                        return
                    continue
                yield from recs

    def close(self):
        if self._lib is not None:
            if getattr(self, "_h", None):
                self._lib.ptrt_rio_reader_close(self._h)
                self._h = None
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PrefetchReader:
    """Background-thread record reader: disk + crc + decompress run on a
    C++ thread into a bounded channel (reference double_buffer /
    open_recordio_file pipeline). Python branch: plain iteration."""

    def __init__(self, path: str, capacity: int = 256):
        self._lib = _load()
        self._path = path
        if self._lib is not None:
            if not os.path.exists(path):
                raise RecordIOError("no such recordio file: %s" % path)
            self._h = self._lib.ptrt_prefetch_open(path.encode(), capacity)
        else:
            self._inner = RecordIOReader(path)

    def __iter__(self) -> Iterator[bytes]:
        if self._lib is None:
            yield from self._inner
            return
        buf = ctypes.POINTER(ctypes.c_char)()
        while True:
            n = self._lib.ptrt_prefetch_next(self._h, ctypes.byref(buf))
            if n == -1:
                return
            if n < 0:
                raise RecordIOError("corrupt recordio chunk in %s" % self._path)
            yield _take(self._lib, buf, n)

    def close(self):
        if self._lib is not None:
            if getattr(self, "_h", None):
                self._lib.ptrt_prefetch_close(self._h)
                self._h = None
        else:
            self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# channel + arena bindings
# ---------------------------------------------------------------------------


class Channel:
    """Bounded blocking byte channel (framework/channel.h equivalent)."""

    def __init__(self, capacity: int = 64):
        self._lib = _load()
        # close() mirror for the native path: the frozen C ABI has no
        # is-closed probe, and the deadline poll must stop waiting for
        # records that can no longer arrive
        self._py_closed = False
        if self._lib is None:
            import collections
            import threading

            # native semantics: send blocks when full (False once closed),
            # recv blocks when empty (None once closed AND drained), and
            # close() wakes every blocked sender/receiver.
            self._dq = collections.deque()
            self._cap = capacity
            self._closed = False
            self._cv = threading.Condition()
        else:
            self._h = self._lib.ptrt_chan_create(capacity)

    def send(self, data: bytes) -> bool:
        if self._lib is None:
            with self._cv:
                while len(self._dq) >= self._cap and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return False
                self._dq.append(bytes(data))
                self._cv.notify_all()
                return True
        return self._lib.ptrt_chan_send(self._h, data, len(data)) == 0

    def recv(self) -> Optional[bytes]:
        if self._lib is None:
            with self._cv:
                while not self._dq and not self._closed:
                    self._cv.wait()
                if not self._dq:
                    return None  # closed and drained
                item = self._dq.popleft()
                self._cv.notify_all()
                return item
        buf = ctypes.POINTER(ctypes.c_char)()
        n = self._lib.ptrt_chan_recv(self._h, ctypes.byref(buf))
        if n < 0:
            return None
        return _take(self._lib, buf, n)

    def recv_batch(self, max_n: int,
                   max_wait_s: Optional[float] = None) -> Optional[list]:
        """Block for the first record, then drain whatever else is queued
        (up to max_n) — the C++ dynamic-batching pull
        (ptrt_chan_recv_batch) behind the predictor serving loop. With
        ``max_wait_s`` set (> 0), keep collecting for up to that many
        seconds after the first record arrives (the serving batching
        deadline): the call returns as soon as the batch is FULL, so the
        deadline only costs latency when traffic cannot fill max_n
        anyway.

        ``max_wait_s=0`` means "drain what's ready, don't wait": return
        whatever is queued RIGHT NOW without blocking — ``[]`` when the
        channel is open but empty (the fleet router's opportunistic
        drain), None when it is closed and drained. Only ``None``
        (the default) blocks for the first record. (PredictorServer's
        stacking stage passes None explicitly for ``max_wait_ms=0`` — it
        WANTS block-for-first — so the old coercion of 0 to None there
        is now a documented contract, not an accident.)

        Returns None once closed and drained."""
        if max_wait_s is not None and max_wait_s <= 0:
            return self._recv_batch_nowait(max_n)
        if self._lib is None:
            out = self._recv_batch_py(max_n)
            if out is None:
                return None
        else:
            bufs = (ctypes.POINTER(ctypes.c_char) * max_n)()
            lens = (ctypes.c_int64 * max_n)()
            n = self._lib.ptrt_chan_recv_batch(self._h, max_n, bufs, lens)
            if n <= 0:
                return None
            out = [_take(self._lib, bufs[i], lens[i]) for i in range(n)]
        if not max_wait_s or len(out) >= max_n:
            return out
        deadline = time.monotonic() + max_wait_s
        while len(out) < max_n:
            if self._lib is None:
                more = self._recv_batch_py(max_n - len(out),
                                           deadline=deadline)
            else:
                more = self._recv_batch_native_nb(max_n - len(out),
                                                  deadline=deadline)
            if more is None:
                break  # closed (already holding records) or deadline hit
            out.extend(more)
        return out

    def _recv_batch_nowait(self, max_n: int):
        """The max_wait_s=0 branch: non-blocking drain of up to max_n
        queued records. [] = open but empty; None = closed and drained."""
        if self._lib is None:
            with self._cv:
                if not self._dq:
                    return None if self._closed else []
                out = []
                while self._dq and len(out) < max_n:
                    out.append(self._dq.popleft())
                self._cv.notify_all()
                return out
        if self._lib.ptrt_chan_size(self._h) > 0:
            bufs = (ctypes.POINTER(ctypes.c_char) * max_n)()
            lens = (ctypes.c_int64 * max_n)()
            n = self._lib.ptrt_chan_recv_batch(self._h, max_n, bufs, lens)
            if n <= 0:
                return None  # lost the race to close()
            return [_take(self._lib, bufs[i], lens[i]) for i in range(n)]
        return None if self._py_closed else []

    def _recv_batch_py(self, max_n: int, deadline: Optional[float] = None):
        """Fallback batch pull: block for the first record (bounded by
        `deadline` when given), drain up to max_n. None = closed+drained
        or deadline expired empty-handed."""
        with self._cv:
            while not self._dq and not self._closed:
                if deadline is None:
                    self._cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cv.wait(remaining)
            if not self._dq:
                return None
            out = []
            while self._dq and len(out) < max_n:
                out.append(self._dq.popleft())
            self._cv.notify_all()
            return out

    def _recv_batch_native_nb(self, max_n: int, deadline: float):
        """Deadline-bounded pull over the native channel. The C ABI's
        recv_batch blocks indefinitely for the first record, so this
        polls qsize and only calls it when records are visibly queued —
        a closed empty channel or an expired deadline returns None
        instead of blocking the stacking stage forever."""
        while True:
            if self._lib.ptrt_chan_size(self._h) > 0:
                bufs = (ctypes.POINTER(ctypes.c_char) * max_n)()
                lens = (ctypes.c_int64 * max_n)()
                n = self._lib.ptrt_chan_recv_batch(self._h, max_n, bufs,
                                                   lens)
                if n <= 0:
                    return None  # lost the race to close()
                return [_take(self._lib, bufs[i], lens[i])
                        for i in range(n)]
            if self._py_closed:
                return None  # closed and (per the check above) drained
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            # sub-ms poll: the deadline trades exactly this much timing
            # slop for not adding a timed variant to the frozen C ABI
            time.sleep(min(remaining, 5e-4))

    def qsize(self) -> int:
        if self._lib is None:
            with self._cv:
                return len(self._dq)
        return self._lib.ptrt_chan_size(self._h)

    def close(self):
        if self._lib is None:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
        else:
            self._lib.ptrt_chan_close(self._h)
        # flag set AFTER the native close: a record sent concurrently is
        # either drained by the deadline poll's qsize check or picked up
        # by the caller's next recv_batch — never dropped
        self._py_closed = True

    def destroy(self):
        if self._lib is not None and getattr(self, "_h", None):
            self._lib.ptrt_chan_destroy(self._h)
            self._h = None


class StagingArena:
    """Page-aligned bump allocator for host-side batch assembly: numpy
    batches built in arena memory transfer to device without an extra
    staging copy. reset() per step reuses the pages."""

    def __init__(self, nbytes: int = 64 << 20):
        self._lib = _load()
        self.nbytes = nbytes
        if self._lib is None:
            self._h = None
        else:
            self._h = self._lib.ptrt_arena_create(nbytes)

    def alloc_array(self, shape, dtype, align: int = 4096):
        import numpy as np

        dtype = np.dtype(dtype)
        n = int(np.prod(shape)) * dtype.itemsize
        if self._h is None:
            return np.empty(shape, dtype)  # fallback: ordinary numpy
        ptr = self._lib.ptrt_arena_alloc(self._h, n, align)
        if not ptr:
            return np.empty(shape, dtype)  # arena full: degrade gracefully
        buf = (ctypes.c_char * n).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def used(self) -> int:
        return 0 if self._h is None else self._lib.ptrt_arena_used(self._h)

    def reset(self):
        if self._h is not None:
            self._lib.ptrt_arena_reset(self._h)

    def destroy(self):
        if self._h is not None:
            self._lib.ptrt_arena_destroy(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# sample-level helpers (pickled tuples, like the reference's convert())
# ---------------------------------------------------------------------------


def recordio_convert(sample_reader, path: str, compressor: int = 1,
                     max_chunk_records: int = 1000):
    """Serialize a sample reader into a recordio file (reference:
    python/paddle/fluid/recordio_writer.py:convert_reader_to_recordio_file)."""
    with RecordIOWriter(path, compressor, max_chunk_records) as w:
        n = 0
        for sample in sample_reader():
            w.write(pickle.dumps(sample, protocol=4))
            n += 1
    return n


def recordio_sample_reader(path: str, prefetch: bool = True,
                           capacity: int = 256,
                           skip_corrupt: bool = False):
    """Reader creator yielding the original samples back (C++ prefetch
    thread keeps the channel full while the device computes).

    ``skip_corrupt=True`` is the streaming-ingest hardening: corrupt
    CHUNKS are dropped with chunk-magic resync
    (``RecordIOReader(tolerant=True)``, which implies the pure-Python
    read path — no C++ prefetch) and a RECORD whose pickle payload no
    longer loads is skipped and counted
    (``paddle_tpu_train_skipped_batches_total{reason="corrupt_record"}``)
    instead of crashing the DataLoader worker that owns this reader."""

    def reader():
        if skip_corrupt:
            src = RecordIOReader(path, tolerant=True)
        elif prefetch:
            src = PrefetchReader(path, capacity)
        else:
            src = RecordIOReader(path)
        try:
            for rec in src:
                if skip_corrupt:
                    try:
                        sample = pickle.loads(rec)
                    except Exception:
                        from .. import observability as obs

                        obs.TRAIN_SKIPPED_BATCHES.inc(
                            reason="corrupt_record")
                        continue
                    yield sample
                else:
                    yield pickle.loads(rec)
        finally:
            src.close()

    return reader


# ---------------------------------------------------------------------------
# zero-copy array frames (shared wire/shm layout)
# ---------------------------------------------------------------------------
#
# One frame carries an ordered list of ndarrays plus a u64 tag (a request
# id on the serving channel, a batch sequence number in the DataLoader's
# shared-memory ring):
#
#   b"Z" (0x5A u8) | tag u64 | nslots u32 | per slot:
#     dtype-str len u8 | numpy dtype.str (endianness included) |
#     ndim u8 | shape i64 x ndim | nbytes i64 | raw array bytes
#
# decode_frame over a memoryview reconstructs each slot as an
# ``np.frombuffer`` VIEW — no pickle object graph and no payload copy on
# the reading side. Arrays a frame cannot carry (object / record dtypes,
# datetimes) use the pickled form, prefixed b"P".

_FRAME_HDR = struct.Struct("<BQI")
_FRAME_U8 = struct.Struct("<B")
_FRAME_I64 = struct.Struct("<q")
_FRAME_MAGIC = 0x5A


def frame_encodable(rows) -> bool:
    """True when every row can ride the zero-copy frame (numeric/bytes
    dtypes with buffer export; object/void/datetime kinds cannot)."""
    for a in rows:
        dt = getattr(a, "dtype", None)
        if dt is None or dt.kind in "OVMm":
            return False
    return True


def _frame_meta_nbytes(a) -> int:
    return 1 + len(a.dtype.str) + 1 + 8 * a.ndim + 8


def frame_nbytes(rows) -> int:
    """Exact encoded size of the zero-copy frame for `rows`."""
    return _FRAME_HDR.size + sum(_frame_meta_nbytes(a) + a.nbytes
                                 for a in rows)


def _write_frame(buf, off: int, tag: int, rows) -> int:
    _FRAME_HDR.pack_into(buf, off, _FRAME_MAGIC, tag, len(rows))
    off += _FRAME_HDR.size
    for a in rows:
        ds = a.dtype.str.encode("ascii")
        _FRAME_U8.pack_into(buf, off, len(ds))
        off += 1
        buf[off:off + len(ds)] = ds
        off += len(ds)
        _FRAME_U8.pack_into(buf, off, a.ndim)
        off += 1
        struct.pack_into("<%dq" % a.ndim, buf, off, *a.shape)
        off += 8 * a.ndim
        _FRAME_I64.pack_into(buf, off, a.nbytes)
        off += 8
        if a.nbytes:
            # memoryview slice assignment is one C memcpy; 0-d and
            # zero-size views can't be cast, tobytes copies <= 1 scalar
            if a.ndim and a.size:
                buf[off:off + a.nbytes] = memoryview(a).cast("B")
            else:
                buf[off:off + a.nbytes] = a.tobytes()
            off += a.nbytes
    return off


def encode_frame(tag: int, rows) -> bytes:
    """Zero-copy frame as a fresh bytes object (the serving channel's
    wire form). `rows` must already be C-contiguous ndarrays of
    frame-encodable dtypes (see frame_encodable)."""
    out = bytearray(frame_nbytes(rows))
    _write_frame(out, 0, tag, rows)
    return bytes(out)


def encode_frame_into(buf, tag: int, rows) -> int:
    """Write the frame IN PLACE into a writable buffer (a shared-memory
    slot): returns the encoded size, or -1 when `rows` cannot ride the
    frame or `buf` is too small (caller falls back to pickle transport).
    Rows are made contiguous here if needed (one copy, in the writer)."""
    if not frame_encodable(rows):
        return -1
    import numpy as _np

    rows = [_np.ascontiguousarray(a) for a in rows]
    need = frame_nbytes(rows)
    if need > len(buf):
        return -1
    _write_frame(buf, 0, tag, rows)
    return need


def encode_frame_pickle(tag: int, rows) -> bytes:
    """The fallback form decode_frame also understands."""
    return b"P" + pickle.dumps((tag, list(rows)), protocol=4)


def frame_tag(msg) -> int:
    """The frame's u64 tag WITHOUT decoding the payload: a header peek
    on the zero-copy form (the router/worker request-id path), a full
    unpickle only on the rare ``b"P"`` fallback form. Raises ValueError
    on a frame that carries neither magic — a malformed/corrupt message
    must be rejectable, never misread as tag garbage."""
    if bytes(msg[:1]) == b"P":
        return pickle.loads(memoryview(msg)[1:])[0]
    mv = memoryview(msg)
    if len(mv) < _FRAME_HDR.size:
        raise ValueError(
            "truncated array frame: %d byte(s), header needs %d"
            % (len(mv), _FRAME_HDR.size))
    magic, tag, _nslots = _FRAME_HDR.unpack_from(mv, 0)
    if magic != _FRAME_MAGIC:
        raise ValueError(
            "not an array frame (magic 0x%02X, want 0x%02X)"
            % (magic, _FRAME_MAGIC))
    return tag


def decode_frame(msg):
    """(tag, [row arrays]) back from either form. Zero-copy rows are
    ``np.frombuffer`` views over ``msg`` — they stay valid (and alias)
    exactly as long as the underlying buffer does."""
    import numpy as np

    if bytes(msg[:1]) == b"P":
        return pickle.loads(memoryview(msg)[1:])
    mv = memoryview(msg)
    if len(mv) < _FRAME_HDR.size:
        raise ValueError(
            "truncated array frame: %d byte(s), header needs %d"
            % (len(mv), _FRAME_HDR.size))
    magic, tag, nslots = _FRAME_HDR.unpack_from(mv, 0)
    if magic != _FRAME_MAGIC:
        raise ValueError(
            "not an array frame (magic 0x%02X, want 0x%02X)"
            % (magic, _FRAME_MAGIC))
    off = _FRAME_HDR.size
    rows = []
    for _ in range(nslots):
        (dlen,) = _FRAME_U8.unpack_from(mv, off)
        off += 1
        dt = np.dtype(bytes(mv[off:off + dlen]).decode("ascii"))
        off += dlen
        (ndim,) = _FRAME_U8.unpack_from(mv, off)
        off += 1
        shape = struct.unpack_from("<%dq" % ndim, mv, off) if ndim else ()
        off += 8 * ndim
        (nbytes,) = _FRAME_I64.unpack_from(mv, off)
        off += 8
        count = nbytes // dt.itemsize if dt.itemsize else 0
        rows.append(np.frombuffer(mv, dt, count, off).reshape(shape))
        off += nbytes
    return tag, rows


def batch_assemble(rows, dst, min_bytes: int = 1 << 20):
    """Gather equal-shape contiguous sample arrays into dst[i] = rows[i]
    with the C++ threaded memcpy (ptrt_batch_assemble); returns False
    when the native library is unavailable, a row is non-contiguous /
    mismatched, or the payload is under `min_bytes` — measured on small
    batches the ctypes pointer-array setup costs more than the copy, so
    tiny batches stay on the caller's Python loop."""
    lib = _load()
    if lib is None or not rows:
        return False
    if dst.nbytes < min_bytes:
        return False
    if dst.shape[0] != len(rows) or not dst.flags["C_CONTIGUOUS"]:
        return False
    row_bytes = dst[0].nbytes
    row_shape = dst.shape[1:]
    ptrs = (ctypes.c_char_p * len(rows))()
    for i, r in enumerate(rows):
        # shape (not just nbytes) must match: same-size transposed rows
        # would memcpy into a silently scrambled batch
        if (not r.flags["C_CONTIGUOUS"] or r.dtype != dst.dtype
                or r.shape != row_shape):
            return False
        ptrs[i] = ctypes.cast(r.ctypes.data, ctypes.c_char_p)
    lib.ptrt_batch_assemble(ptrs, len(rows), row_bytes,
                            dst.ctypes.data)
    return True
