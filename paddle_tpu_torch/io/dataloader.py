"""Multiprocess DataLoader: worker PROCESSES + a shared-memory batch ring
(counterpart of paddle_tpu/io/dataloader.py).

The reader decorators in paddle_tpu_torch.reader and the io.PyReader pump
run worker THREADS: decode-heavy sources (PIL/cv2-style per-sample
transforms) serialize on the GIL and the step ends up waiting on Python.
The DataLoader moves decode + batch assembly into `num_workers` OS
processes and returns assembled batches through a ring of preallocated
shared-memory slots:

- each worker writes the finished batch's ndarrays IN PLACE into a free
  slot of its own, in the zero-copy array-frame layout shared with the
  serving channel (runtime/recordio.py: encode_frame_into);
- the consumer maps the slot with ``np.frombuffer``: no per-sample
  pickle, no payload copy, one small control message per batch. Batches
  that cannot ride a frame (object dtypes) or outgrow the slot go by
  pickle (the `transport` label on ``paddle_tpu_loader_batches_total``
  shows which path ran);
- a slot goes back to its worker only once every array of its batch,
  and every view of one, has been garbage-collected: the batch's arrays
  all hang off one lease object per slot, and a weakref finalizer on
  the lease frees the slot. So batches the executor or a caller holds
  (run_loop pushback, the prefetched next window, a list of batches) are
  never written over by a worker;
- a worker waits for a free slot for as long as it takes; it ships a
  batch by pickle instead only when the consumer tells it to, and the
  consumer does so exactly when it waits for that worker's next batch
  while its own live batches hold every slot of that worker (the ring
  could then never free one). The transport of each batch therefore
  follows from what the consumer holds, never from timing: a consumer
  that keeps at most one batch while it asks for the next stays on the
  shared-memory path whatever the load. (The JAX package's worker gives
  up on a slot after a grace period of 0.2 s and pickles, so its
  transport counts depend on load.)

The loader is a ReaderBase holder: `layers.data_loader(...)` wires it to
a `read` op exactly like py_reader (Executor.run / run_loop window
prefetch + device staging consume it unchanged), and iterating the
loader directly yields feed dicts for `Executor.run(feed=...)` loops.
Epoch semantics match io/reader.py: `start()` begins an epoch,
exhaustion raises EOFException on every subsequent `next()` until
`reset()`, and `ordered=True` (default) replays batches in exact source
order each epoch; `ordered=False` trades order for latency (a slow batch
never blocks finished siblings). `state_dict()`/`load_state_dict()`
capture/restore the epoch + batch-offset position for sample-exact
resume after preemption: the resumed epoch's already-trained batches are
skipped inside the workers without paying decode.

Worker sharding is deterministic: global batch index i belongs to worker
i % num_workers, each worker iterating its own copy of the source
reader. The raw source should therefore be CHEAP to iterate (file names,
raw bytes, indices) with the expensive work in `mapper` /
decorate_paddle_reader's per-sample decode — the same contract as
xmap_readers, minus the GIL. A worker touches numpy and shared memory
only; it never touches torch or CUDA.

Worker failures propagate: an exception in the source/mapper is pickled
back and re-raised in the consumer (never a hang), and a worker that
dies without a message (segfault, OOM-kill) raises RuntimeError with its
exit code. `close()` (or GC) tears down processes and unlinks the
shared-memory segment.
"""
from __future__ import annotations

import ctypes
import itertools
import pickle
import queue as _pyqueue
import threading
import time
import traceback
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import observability as obs
from ..runtime import recordio as _rio
from .reader import EOFException, ReaderBase

__all__ = ["DataLoader"]

_LOADER_IDS = itertools.count()

# message kinds on the result queue (worker -> consumer)
_SHM, _PKL, _EOF, _ERR = "shm", "pkl", "eof", "err"

# segments whose close() was deferred because live batch views still map
# them: the strong ref keeps SharedMemory.__del__ from firing (and
# complaining about exported buffers) before the last view dies
_DEFERRED_SHM: set = set()


def _close_shm_soon(shm):
    """Close a segment whose last batch view is mid-deallocation: the
    weakref finalizer fires BEFORE the dying array releases its buffer
    export, so an inline close() hits BufferError. A one-shot timer
    retries after the dealloc settles; until then the strong ref in
    _DEFERRED_SHM keeps SharedMemory.__del__ (which would raise the same
    BufferError as unraisable noise) from running."""
    _DEFERRED_SHM.add(shm)

    def _try():
        try:
            shm.close()
        except BufferError:
            return  # genuinely still exported: stays parked, no noise
        except Exception:
            pass
        _DEFERRED_SHM.discard(shm)

    t = threading.Timer(0.05, _try)
    t.daemon = True
    t.start()


def _pickle_token(seq: int) -> int:
    """What the consumer puts in a worker's slot pool to have batch
    ``seq`` shipped by pickle (slots are >= 0, tokens < 0)."""
    return -seq - 1


def _take_slot(free_q, seq: int, stop):
    """A free slot for batch ``seq``, or None when the consumer asked for
    ``seq`` by pickle (or the loader is stopping). Waits as long as it
    takes: the consumer frees slots or sends the token. A token for an
    earlier batch (that batch went by pickle anyway, too big or not a
    frame) is stale and dropped."""
    while not stop.is_set():
        try:
            item = free_q.get(timeout=0.1)
        except _pyqueue.Empty:
            continue
        if item >= 0:
            return item
        if item == _pickle_token(seq):
            return None
    return None


def _assemble_rows(item, nslots: int, shapes, dtypes) -> List[np.ndarray]:
    """paddle.batch convention: `item` is a list of per-sample tuples;
    stack each slot into one contiguous batch array, cast to the declared
    dtype, reshape to the declared sample shape when sizes agree (the
    same rules as io.reader.PyReader._assemble)."""
    rows = []
    for j in range(nslots):
        arr = np.stack([np.asarray(sample[j]) for sample in item])
        if dtypes:
            arr = arr.astype(dtypes[j], copy=False)
        want = [s for s in (shapes[j] if shapes else []) if s and s > 0]
        if want and list(arr.shape[1:]) != want and \
                arr.size == len(item) * int(np.prod(want)):
            arr = arr.reshape([len(item)] + want)
        rows.append(np.ascontiguousarray(arr))
    return rows


class _Task:
    """Picklable description of what one worker runs (spawn-safe as long
    as the source creator and mapper are module-level callables)."""

    def __init__(self, source: Callable, mode: str, nslots: int, shapes,
                 dtypes, batch_size: int = 0, drop_last: bool = True,
                 mapper: Optional[Callable] = None):
        self.source = source
        self.mode = mode  # "paddle" | "tensor" | "sample"
        self.nslots = nslots
        self.shapes = shapes
        self.dtypes = dtypes
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.mapper = mapper

    def batches(self, wid: int, nworkers: int, start_seq: int = 0):
        """Yield (global_seq, rows) for the batches this worker owns.
        Every worker iterates the same source; batch i belongs to worker
        i % nworkers — deterministic composition identical to serial.
        ``start_seq`` resumes an epoch mid-way (sample-exact restart):
        earlier batches are stepped over WITHOUT paying mapper/assembly
        — only the raw source iteration replays, which the DataLoader
        contract already requires to be cheap."""
        if self.mode == "sample":
            it = self.source()
            seq = 0
            while True:
                chunk = list(itertools.islice(it, self.batch_size))
                if not chunk:
                    return
                if len(chunk) < self.batch_size and self.drop_last:
                    return
                if seq % nworkers == wid and seq >= start_seq:
                    if self.mapper is not None:
                        chunk = [self.mapper(s) for s in chunk]
                    chunk = [s if isinstance(s, tuple) else (s,)
                             for s in chunk]
                    yield seq, _assemble_rows(chunk, self.nslots,
                                              self.shapes, self.dtypes)
                if len(chunk) < self.batch_size:
                    return  # partial tail emitted (drop_last=False): done
                seq += 1
        else:
            for seq, item in enumerate(self.source()):
                if seq % nworkers != wid or seq < start_seq:
                    continue
                if self.mode == "tensor":
                    rows = [np.ascontiguousarray(np.asarray(a))
                            for a in item]
                else:  # "paddle": list of per-sample tuples
                    if self.mapper is not None:
                        item = [self.mapper(s) for s in item]
                    yield seq, _assemble_rows(item, self.nslots,
                                              self.shapes, self.dtypes)
                    continue
                yield seq, rows


def _attach_shm(name: str):
    """Attach to the parent's segment. Workers inherit the parent's
    resource tracker (fork shares it; spawn passes the fd), and the
    tracker's registry is a set — the attach-time re-register collapses
    into the parent's entry and the parent's unlink() retires it once.
    Workers must therefore NOT unregister (that would strip the parent's
    registration out from under its unlink)."""
    from multiprocessing import shared_memory

    return shared_memory.SharedMemory(name=name)


def _worker_main(wid: int, nworkers: int, task: _Task, shm_name: str,
                 slot_bytes: int, free_q, result_q, stop,
                 start_seq: int = 0):
    """Worker process body: iterate owned batches, write each into a free
    shared-memory slot (pickle fallback when it cannot ride a frame),
    send one small control message per batch. `busy` seconds (decode +
    assemble, NOT queue waits) ride each message so the consumer can
    account worker utilization.

    `free_q` is this worker's OWN slot pool (slots are statically
    partitioned slot % num_workers): a fast worker can never starve a
    slow sibling of slots, which in ordered mode would deadlock the
    consumer (waiting on the slow worker's batch) against the fast
    worker (waiting for a slot only the consumer can free)."""
    import os as _os
    if _os.environ.get("PADDLE_TPU_LOADER_DEBUG"):
        import faulthandler
        faulthandler.dump_traceback_later(30, exit=False, repeat=True)
    shm = _attach_shm(shm_name)

    def put(msg):
        while not stop.is_set():
            try:
                result_q.put(msg, timeout=0.2)
                return True
            except _pyqueue.Full:
                continue
        return False

    try:
        # cumulative clocks; each message carries the delta since the
        # previous one, so the consumer can aggregate worker utilization
        # (busy) and pipeline backpressure (stall = slot + send waits)
        busy_t = stall_t = rep_busy = rep_stall = 0.0

        def message(kind, seq, a, b):
            nonlocal rep_busy, rep_stall, stall_t
            msg = (kind, wid, seq, a, b,
                   (busy_t - rep_busy, stall_t - rep_stall))
            rep_busy, rep_stall = busy_t, stall_t
            t1 = time.perf_counter()
            ok = put(msg)
            stall_t += time.perf_counter() - t1  # send backpressure
            return ok

        t0 = time.perf_counter()
        for seq, rows in task.batches(wid, nworkers, start_seq):
            busy_t += time.perf_counter() - t0
            if stop.is_set():
                return
            sent = False
            if _rio.frame_encodable(rows) and \
                    _rio.frame_nbytes(rows) <= slot_bytes:
                t1 = time.perf_counter()
                slot = _take_slot(free_q, seq, stop)
                stall_t += time.perf_counter() - t1  # slot starvation
                if stop.is_set():
                    return
                if slot is not None:
                    off = slot * slot_bytes
                    n = _rio.encode_frame_into(
                        shm.buf[off:off + slot_bytes], seq, rows)
                    if n >= 0:
                        if not message(_SHM, seq, slot, n):
                            return
                        sent = True
                    else:  # lost a size race (can't happen): give back
                        free_q.put(slot)
            if not sent:
                blob = pickle.dumps(rows, protocol=4)
                if not message(_PKL, seq, blob, None):
                    return
            t0 = time.perf_counter()
        message(_EOF, None, None, None)
    except BaseException as exc:  # noqa: B036 — must reach the consumer
        try:
            blob = pickle.dumps(exc, protocol=4)
        except Exception:
            blob = pickle.dumps(
                RuntimeError("DataLoader worker %d failed: %s\n%s"
                             % (wid, exc, traceback.format_exc())),
                protocol=4)
        put((_ERR, wid, None, blob, None, (0.0, 0.0)))
    finally:
        shm.close()


def _gc_cleanup(state):
    """Last-resort teardown when a DataLoader is garbage-collected
    without close(): stop + kill workers, unlink the segment. Must not
    reference the loader (it is being finalized)."""
    try:
        ev = state.get("stop")
        if ev is not None:
            ev.set()
        for p in state.get("procs") or []:
            if p.is_alive():
                p.terminate()
        shm = state.get("shm")
        if shm is not None:
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
            try:
                shm.close()
            except BufferError:
                _close_shm_soon(shm)  # live views still map the segment
    except Exception:
        pass


class DataLoader(ReaderBase):
    """See the module docstring. Constructor arguments:

    var_names/shapes/dtypes — the feed slots, like py_reader.
    num_workers — worker processes (0 = in-process synchronous mode, the
        debugging escape hatch).
    capacity — shared-memory ring slots (ready-batch buffer depth).
    slot_bytes — bytes per slot; a batch that doesn't fit falls back to
        pickle transport (default 4 MiB).
    ordered — exact source order (default) vs arrival order.
    start_method — multiprocessing start method. Default "forkserver":
        workers fork from a CLEAN server process, never from the trainer
        — a "fork" of a process whose CUDA is live (or whose library
        threads hold locks) gives children a broken copy of both, and
        "spawn" pays a full interpreter + import per worker per epoch.
        The server preloads this module once (which imports torch into
        the server but never initialises CUDA there), so per-epoch worker
        respawns stay at fork cost. Source/mapper callables must be
        picklable (module-level, not closures) under forkserver/spawn;
        pass start_method="fork" to trade safety for closure support in
        processes that never touched CUDA.
    """

    _eof_msg = "data loader exhausted"

    def __init__(self, var_names: Sequence[str], shapes=None, dtypes=None,
                 *, num_workers: int = 2, capacity: int = 8,
                 slot_bytes: int = 4 << 20, ordered: bool = True,
                 start_method: Optional[str] = None):
        super().__init__(var_names)
        import multiprocessing as mp

        self.shapes = [list(s) for s in shapes] if shapes else None
        self.dtypes = list(dtypes) if dtypes else None
        self.num_workers = int(num_workers)
        # >= 2 slots per worker: one being consumed, one being filled
        self.capacity = max(int(capacity), 2 * max(self.num_workers, 1))
        self.slot_bytes = int(slot_bytes)
        self.ordered = ordered
        if start_method is None:
            start_method = ("forkserver"
                            if "forkserver" in mp.get_all_start_methods()
                            else "spawn")
        self._ctx = mp.get_context(start_method)
        if start_method == "forkserver":
            # warm the server with this module (numpy + the frame codec)
            # so every per-epoch worker respawn is one fork, not a cold
            # interpreter + import
            try:
                self._ctx.set_forkserver_preload(
                    ["paddle_tpu_torch.io.dataloader"])
            except Exception:
                pass
        self._task: Optional[_Task] = None
        self._obs_name = "loader%d" % next(_LOADER_IDS)

        # sample-exact resume state (state_dict/load_state_dict):
        # finished epochs, batches emitted THIS epoch, and a pending
        # offset the next start() applies as a worker-side skip
        self._epochs_done = 0
        self._epoch_batches = 0
        self._pending_offset = 0

        self._shm = None  # created lazily on first start()
        self._procs: Optional[List] = None
        self._free_qs: Optional[List] = None  # per-worker slot pools
        self._result_q = None
        self._stop = None
        self._buffer: Dict[int, tuple] = {}
        self._next_seq = 0
        self._done: set = set()
        self._exhausted = False
        self._errored: Optional[BaseException] = None
        self._inline_iter = None  # num_workers == 0 mode

        # slots whose batch is still alive in the consumer (its lease not
        # yet collected); a slot re-enters its worker's pool only when
        # the LAST view of its batch is collected
        self._holds: set = set()
        # reentrant: a finalizer that a collection runs inside a locked
        # section of this thread takes it again
        self._hold_lock = threading.RLock()
        self._closed = False
        # per worker: the seq of the next batch it sends, and the last
        # seq the consumer asked it to pickle (_grant_pickles)
        self._expect: List[int] = []
        self._token_for: List[Optional[int]] = []

        # python-side counters (stats(); the registry carries the same
        # numbers as labeled series)
        self._n_batches = 0
        self._n_shm = 0
        self._n_pickle = 0
        self._blocked_s = 0.0
        self._busy_s = 0.0
        self._stall_s = 0.0
        self._started_at = None

        self._state = {"procs": [], "stop": None, "shm": None}
        self._finalizer = weakref.finalize(self, _gc_cleanup, self._state)

    # -- decoration ------------------------------------------------------
    def decorate_paddle_reader(self, reader: Callable,
                               mapper: Optional[Callable] = None):
        """`reader()` yields batches as lists of per-sample tuples (the
        paddle.batch convention); optional `mapper` runs per sample in
        the worker (the expensive decode belongs there)."""
        self._task = _Task(reader, "paddle", len(self.var_names),
                           self.shapes, self.dtypes, mapper=mapper)

    def decorate_sample_reader(self, reader: Callable, batch_size: int,
                               drop_last: bool = True,
                               mapper: Optional[Callable] = None):
        """`reader()` yields individual samples (tuples of array-likes);
        workers group `batch_size` consecutive samples into batches and
        apply `mapper` per sample. Batch composition is identical to the
        serial paddle.batch(reader, batch_size) pipeline."""
        self._task = _Task(reader, "sample", len(self.var_names),
                           self.shapes, self.dtypes,
                           batch_size=int(batch_size), drop_last=drop_last,
                           mapper=mapper)

    def decorate_tensor_provider(self, reader: Callable):
        """`reader()` yields tuples of ready batch arrays per slot."""
        self._task = _Task(reader, "tensor", len(self.var_names),
                           self.shapes, self.dtypes)

    # -- slot lifetime ---------------------------------------------------
    def _release_slot_ref(self, slot: int):
        # runs from GC (weakref.finalize on the batch's lease): must
        # never raise. The put happens under the lock, so a slot freed
        # and a pickle token sent (_grant_pickles) reach the worker in
        # the order the consumer decided them.
        try:
            with self._hold_lock:
                self._holds.discard(slot)
                fqs = self._free_qs
                closed = self._closed
                drained = closed and not self._holds
                if not closed and fqs is not None:
                    fqs[slot % len(fqs)].put(slot)
            if drained and self._shm is not None:
                _close_shm_soon(self._shm)  # deferred from close()
        except Exception:
            pass

    def _grant_pickles(self):
        """Called while the consumer waits for a batch: a worker whose
        every slot is held by the consumer's live batches can never write
        its next batch into the ring, so it is told (a token in its slot
        pool) to ship that batch by pickle. Ordered: only the worker
        whose batch is due; unordered: each unfinished worker, once all
        of them are so blocked. Decided from the consumer's own holds,
        so the transport never depends on timing."""
        nw = self.num_workers
        if self._free_qs is None:
            return
        if self.ordered:
            due = [self._next_seq % nw]
        else:
            due = [w for w in range(nw) if w not in self._done]
        with self._hold_lock:
            held = [0] * nw
            for slot in tuple(self._holds):
                held[slot % nw] += 1
            blocked = [w for w in due if w not in self._done
                       and held[w] >= len(range(w, self.capacity, nw))]
            if not blocked or (not self.ordered and len(blocked) < len(due)):
                return
            for w in blocked:
                seq = self._expect[w]
                if self._token_for[w] != seq:
                    self._token_for[w] = seq
                    self._free_qs[w].put(_pickle_token(seq))

    def _decode(self, msg):
        kind, _wid, seq, a, b, _busy = msg
        if kind == _SHM:
            slot, n = a, b
            off = slot * self.slot_bytes
            # every array of the batch is a view over this lease: the slot
            # is free again when the last of them (and of their views) dies
            lease = (ctypes.c_char * n).from_buffer(
                self._shm.buf[off:off + n])
            _tag, rows = _rio.decode_frame(lease)
            with self._hold_lock:
                self._holds.add(slot)
            weakref.finalize(lease, self._release_slot_ref, slot)
            del lease
            self._n_shm += 1
            transport = "shm"
        else:
            rows = pickle.loads(a)
            self._n_pickle += 1
            transport = "pickle"
        self._n_batches += 1
        self._epoch_batches += 1
        obs.LOADER_BATCHES.inc(loader=self._obs_name, transport=transport)
        return dict(zip(self.var_names, rows))

    # -- epoch lifecycle -------------------------------------------------
    def start(self):
        """Idempotent epoch start: spawns workers if none are running.
        After EOF, a fresh start() begins the next epoch (py_reader's
        per-epoch reader.start() contract)."""
        if self._task is None:
            raise RuntimeError(
                "data loader has no source; call decorate_paddle_reader / "
                "decorate_sample_reader / decorate_tensor_provider first")
        if self._closed:
            raise RuntimeError("data loader is closed")
        if self.num_workers <= 0:
            if self._inline_iter is None:
                # post-EOF start() begins the next epoch, exactly like
                # the worker mode's respawn
                self._exhausted = False
                self._errored = None
                offset, self._pending_offset = self._pending_offset, 0
                self._epoch_batches = offset
                self._inline_iter = self._task.batches(0, 1, offset)
            return
        if self._procs is not None:
            if self._exhausted or self._errored is not None:
                self._teardown()  # epoch over: respawn below
            else:
                return  # already running
        if self._shm is None:
            from multiprocessing import shared_memory

            self._shm = shared_memory.SharedMemory(
                create=True, size=self.capacity * self.slot_bytes)
            self._state["shm"] = self._shm
        self._errored = None
        self._exhausted = False
        self._buffer = {}
        offset, self._pending_offset = self._pending_offset, 0
        self._next_seq = offset
        self._epoch_batches = offset
        self._done = set()
        nw = self.num_workers
        self._expect = [offset + (w - offset) % nw for w in range(nw)]
        self._token_for = [None] * nw
        self._stop = self._ctx.Event()
        self._result_q = self._ctx.Queue(2 * self.capacity)
        with self._hold_lock:
            free_qs = [self._ctx.Queue() for _ in range(self.num_workers)]
            for s in range(self.capacity):
                if s not in self._holds:
                    free_qs[s % self.num_workers].put(s)
            self._free_qs = free_qs
        self._procs = [
            self._ctx.Process(
                target=_worker_main,
                args=(w, self.num_workers, self._task, self._shm.name,
                      self.slot_bytes, self._free_qs[w], self._result_q,
                      self._stop, offset),
                daemon=True, name="ptpu-loader-%s-w%d" % (self._obs_name, w))
            for w in range(self.num_workers)]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self._teardown()  # kill whatever did start; re-raise the cause
            raise
        self._state["procs"] = self._procs
        self._state["stop"] = self._stop
        if self._started_at is None:  # stats() wall = lifetime clock
            self._started_at = time.perf_counter()
        obs.LOADER_WORKERS.set(self.num_workers, loader=self._obs_name)

    def reset(self):
        """Rewind after (or during) an epoch so the next start() replays
        the source from the beginning (a pending resume offset is
        discarded — replay-from-start contradicts mid-epoch resume)."""
        self._teardown()
        self._exhausted = False
        self._errored = None
        self._inline_iter = None
        self._epoch_batches = 0
        self._pending_offset = 0

    # -- sample-exact resume ----------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        """Position of the NEXT batch to deliver: finished epochs +
        batches already emitted this epoch. Capture it at a checkpoint
        boundary; hand it to ``load_state_dict`` on a fresh loader to
        continue mid-epoch without replaying or skipping a sample.
        Meaningful for ``ordered=True`` loaders (arrival order is not
        replayable)."""
        return {"v": 1, "epoch": self._epochs_done,
                "offset": self._epoch_batches,
                "ordered": bool(self.ordered)}

    def load_state_dict(self, state: Dict[str, int]):
        """Arm the next ``start()`` to resume at ``state``: the first
        ``offset`` batches of the epoch are skipped INSIDE the workers
        (mapper/assembly never run for them; only the cheap raw source
        iteration replays). Call before the epoch starts — a loader
        mid-epoch must ``reset()`` first."""
        if not isinstance(state, dict) or "offset" not in state:
            raise ValueError(
                "expected a DataLoader state_dict with an 'offset' "
                "field, got %r" % (state,))
        offset = int(state.get("offset", 0))
        if offset < 0:
            raise ValueError("offset must be >= 0, got %d" % offset)
        if offset and not self.ordered:
            raise ValueError(
                "sample-exact resume requires ordered=True (arrival "
                "order is not replayable across a restart)")
        running = ((self._procs is not None
                    or self._inline_iter is not None)
                   and not self._exhausted)
        if running:
            # a started loader is already delivering the CURRENT epoch
            # from offset 0 — applying the offset to the NEXT start()
            # would both retrain this epoch's head and skip the next
            # epoch's, silently
            raise RuntimeError(
                "cannot load state into a running loader; reset() first")
        self._epochs_done = int(state.get("epoch", 0))
        self._pending_offset = offset

    def close(self):
        """Tear down workers and unlink the shared-memory segment. Live
        batch views keep their pages mapped until collected."""
        if self._closed:
            return
        self._teardown()
        self._closed = True
        if self._shm is not None:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
            with self._hold_lock:
                drained = not self._holds
            if drained:
                try:
                    self._shm.close()
                except BufferError:
                    _close_shm_soon(self._shm)  # dealloc race: retry
            else:
                _DEFERRED_SHM.add(self._shm)  # closed when the last
                # outstanding batch view is collected
        self._finalizer.detach()
        # retire EVERY per-instance series, counters included: each
        # loader gets a unique label, so a loader-per-job server (or the
        # bench sweep's hundreds of instances) would otherwise grow the
        # registry and every exposition payload without bound
        for metric in (obs.LOADER_QUEUE_DEPTH, obs.LOADER_WORKERS,
                       obs.LOADER_BLOCKED_MS, obs.LOADER_WORKER_BUSY_MS):
            metric.remove(loader=self._obs_name)
        for transport in ("shm", "pickle", "inline"):
            obs.LOADER_BATCHES.remove(loader=self._obs_name,
                                      transport=transport)

    def _teardown(self):
        procs, self._procs = self._procs, None
        self._state["procs"] = []
        if self._stop is not None:
            self._stop.set()
        # a spawn that failed mid-way (unpicklable source, forkserver
        # refusing the main module) leaves never-started Process objects:
        # join/terminate on those raises, and the real error must win
        procs = [p for p in procs or [] if getattr(p, "_popen", None)]
        if procs:
            deadline = time.monotonic() + 5.0
            while (any(p.is_alive() for p in procs)
                   and time.monotonic() < deadline):
                self._drain_nowait()  # unblock workers stuck on a full put
                for p in procs:
                    p.join(timeout=0.05)
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=1.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=1.0)
        for q in [self._result_q] + list(self._free_qs or []):
            if q is not None:
                try:
                    q.close()
                    q.cancel_join_thread()
                except Exception:
                    pass
        self._result_q = None
        self._free_qs = None
        self._stop = None
        self._buffer = {}
        self._done = set()
        self._next_seq = 0
        # slots taken by dead workers but never reported are recovered at
        # the next start(): the free pool is recomputed as every slot not
        # held by a live consumer-side view

    def _drain_nowait(self):
        q = self._result_q
        while q is not None:
            try:
                q.get_nowait()
            except (_pyqueue.Empty, OSError, ValueError):
                return

    # -- consuming -------------------------------------------------------
    def next(self) -> Dict[str, np.ndarray]:
        if self._errored is not None:
            # reset the traceback per raise: re-raising the same object
            # would chain every caller's frames onto it forever
            raise self._errored.with_traceback(None)
        if self._exhausted:
            raise EOFException(self._eof_msg)
        if self.num_workers <= 0:
            if self._inline_iter is None:
                raise RuntimeError(
                    "data loader not started; call reader.start()")
            try:
                _seq, rows = next(self._inline_iter)
            except StopIteration:
                self._exhausted = True
                self._inline_iter = None
                self._epochs_done += 1
                self._epoch_batches = 0
                raise EOFException(self._eof_msg) from None
            self._n_batches += 1
            self._epoch_batches += 1
            obs.LOADER_BATCHES.inc(loader=self._obs_name, transport="inline")
            return dict(zip(self.var_names, rows))
        if self._procs is None:
            raise RuntimeError("data loader not started; call reader.start()")
        t0 = time.perf_counter()
        try:
            return self._pull()
        finally:
            waited = time.perf_counter() - t0
            self._blocked_s += waited
            obs.LOADER_BLOCKED_MS.inc(waited * 1e3, loader=self._obs_name)
            obs.LOADER_QUEUE_DEPTH.set(len(self._buffer),
                                       loader=self._obs_name)

    def _emit_ready(self):
        """The buffered batch to emit now, or None. mp.Queue is FIFO per
        producer, so once worker w's EOF message has arrived, every batch
        w produced has arrived too — a missing expected seq whose owner
        is done therefore proves the stream ended (the stream is
        contiguous: batch k exists iff the source had > k batches)."""
        if self.ordered:
            if self._next_seq in self._buffer:
                msg = self._buffer.pop(self._next_seq)
                self._next_seq += 1
                return msg
            if self._next_seq % self.num_workers in self._done:
                self._exhausted = True
                self._epochs_done += 1
                self._epoch_batches = 0
                raise EOFException(self._eof_msg)
            return None
        if self._buffer:
            return self._buffer.pop(next(iter(self._buffer)))
        if len(self._done) == self.num_workers:
            self._exhausted = True
            self._epochs_done += 1
            self._epoch_batches = 0
            raise EOFException(self._eof_msg)
        return None

    def _handle_msg(self, msg):
        """Single dispatch point for worker messages (accounting, EOF
        tracking, error raise, reorder buffering) — _pull and
        _check_workers both route here."""
        kind, wid, seq, a, _b, times = msg
        if times:
            d_busy, d_stall = times
            self._busy_s += d_busy
            self._stall_s += d_stall
            if d_busy:
                obs.LOADER_WORKER_BUSY_MS.inc(d_busy * 1e3,
                                              loader=self._obs_name)
        if kind == _EOF:
            self._done.add(wid)
        elif kind == _ERR:
            exc = pickle.loads(a)
            self._errored = exc
            self._teardown()
            raise exc
        else:
            self._buffer[seq] = msg
            self._expect[wid] = seq + self.num_workers

    def _pull(self):
        while True:
            msg = self._emit_ready()
            if msg is not None:
                return self._decode(msg)
            self._grant_pickles()
            q = self._result_q
            if q is None:  # torn down (reset/close) by another thread
                raise EOFException(self._eof_msg)
            try:
                msg = q.get(timeout=0.1)
            except _pyqueue.Empty:
                self._check_workers()
                continue
            self._handle_msg(msg)

    def _check_workers(self):
        """A worker that died without a message (segfault, OOM-kill) must
        surface as an error, not an eternal poll."""
        for wid, p in enumerate(self._procs or []):
            if wid in self._done or p.is_alive():
                continue
            # drain once more: its last words may still be in flight
            try:
                while True:
                    self._handle_msg(self._result_q.get_nowait())
            except _pyqueue.Empty:
                pass
            if wid in self._done:
                continue
            err = RuntimeError(
                "DataLoader worker %d died unexpectedly (exit code %s)"
                % (wid, p.exitcode))
            self._errored = err
            self._teardown()
            raise err

    def __iter__(self):
        """Plain-iterator mode: one epoch of feed dicts for
        `Executor.run(feed=...)` loops; the loader resets itself at the
        end so the next `for` replays the source."""
        self.start()
        while True:
            try:
                yield self.next()
            except EOFException:
                self.reset()
                return

    def stats(self) -> Dict[str, float]:
        """Consumer-side accounting since start(): batches by transport,
        seconds the consumer blocked (starvation), summed worker busy
        seconds (utilization = busy / (workers × wall))."""
        wall = (time.perf_counter() - self._started_at
                if self._started_at else 0.0)
        return {
            "batches": self._n_batches,
            "shm_batches": self._n_shm,
            "pickle_batches": self._n_pickle,
            "blocked_s": self._blocked_s,
            "worker_busy_s": self._busy_s,
            "worker_stall_s": self._stall_s,
            "wall_s": wall,
            "workers": self.num_workers,
        }
