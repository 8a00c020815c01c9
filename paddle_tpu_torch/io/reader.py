"""Reader-op data pipeline: Program-pulled batches (counterpart of
paddle_tpu/io/reader.py; reference: python/paddle/fluid/layers/io.py
py_reader, double_buffer, open_files, open_recordio_file, and
paddle/fluid/operators/reader/*).

- A *reader* is a host-side pipeline stage (``ReaderBase.next()`` ->
  ``{var_name: array}``). ``RecordIOFilesReader`` reads pickled samples
  from recordio files through the C++ ``PrefetchReader`` (runtime/);
  ``BatchReader`` gathers samples into batches with the C++ threaded
  ``batch_assemble`` into memory of the batch's own, so a batch that is
  held is never written again; ``DoubleBufferReader`` stages the next
  batches onto the device of the Executor that pulls it, from a
  background thread. The multiprocess ``DataLoader`` is io/dataloader.py.
- In the Program a reader appears as a reader Variable and a ``read`` op
  whose outputs are the data Variables. ``Executor.run`` pulls the next
  batch and feeds it to the step; ``run_loop`` pulls a window of them.
  Exhaustion raises ``EOFException``, the reference's
  ``fluid.core.EOFException`` protocol (catch, then ``reader.reset()``).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..runtime.recordio import batch_assemble as _batch_assemble

__all__ = ["EOFException", "ReaderBase", "PyReader", "BatchReader",
           "RecordIOFilesReader", "DoubleBufferReader", "ShuffleReader",
           "RandomDataGenerator", "PreprocessReader"]


class EOFException(Exception):
    """Raised by Executor.run / reader.next() when the pipeline is
    exhausted (reference: fluid.core.EOFException)."""


_EOF = object()


class ReaderBase:
    """A pull stage: next() -> {var_name: np.ndarray | torch.Tensor}."""

    def __init__(self, var_names: Sequence[str]):
        self.var_names = list(var_names)
        self.shapes: Optional[List] = None
        self.dtypes: Optional[List] = None

    def next(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def start(self):
        """Idempotent pipeline (re)start."""

    def reset(self):
        """Rewind after EOF so the next epoch can start."""

    def close(self):
        pass

    def bind_device(self, device: torch.device):
        """Told by the Executor that pulls this reader which device it runs
        on; a stage that stages onto a device (``DoubleBufferReader``
        without a place) stages there. Passed down the pipeline."""
        inner = getattr(self, "inner", None)
        if inner is not None:
            inner.bind_device(device)


class _PumpedReader(ReaderBase):
    """Shared queue-pump machinery: a daemon thread runs `_produce(gen)`
    (a generator of feed dicts) into a bounded queue. Items are tagged
    with an epoch *generation* so a batch or EOF left over from a previous
    epoch's pump can never be mistaken for the current epoch's (races
    otherwise arise when a pump respawns while an old _EOF is queued).
    The consumer polls with a short timeout instead of blocking, so a
    mid-epoch reset() can never strand it on an empty queue."""

    _eof_msg = "reader exhausted"

    def __init__(self, var_names, capacity: int):
        super().__init__(var_names)
        self.capacity = capacity
        self._queue: queue.Queue = queue.Queue(capacity)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._gen = 0

    def _produce(self, gen):
        raise NotImplementedError

    def _pump(self, gen):
        try:
            for feed in self._produce(gen):
                if self._stop.is_set() or gen != self._gen:
                    return
                self._queue.put((gen, feed))
        finally:
            self._queue.put((gen, _EOF))

    def _spawn(self):
        if self._thread is not None:
            if self._thread.is_alive():
                return
            self._thread.join()
        self._stop.clear()
        self._gen += 1
        self._thread = threading.Thread(target=self._pump,
                                        args=(self._gen,), daemon=True)
        self._thread.start()

    def _next_item(self):
        while True:
            t = self._thread  # may be nulled by a concurrent reset()
            dead = t is None or not t.is_alive()
            try:
                gen, item = self._queue.get(timeout=0.1)
            except queue.Empty:
                if dead:
                    # pump finished and everything it produced was
                    # consumed: repeated next() without reset() re-raises
                    # EOF instead of blocking forever
                    raise EOFException(self._eof_msg)
                continue
            if gen != self._gen:
                continue  # stale leftover from a previous epoch's pump
            if item is _EOF:
                raise EOFException(self._eof_msg)
            return item

    def _teardown(self):
        self._stop.set()
        self._gen += 1  # everything queued or in flight is now stale
        t = self._thread
        while t is not None and t.is_alive():
            # drain so a producer blocked on put() can observe the stop flag
            try:
                self._queue.get_nowait()
            except queue.Empty:
                t.join(timeout=0.05)
        self._thread = None
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break


class PyReader(_PumpedReader):
    """Capacity-bounded queue fed from a decorated python reader in a
    background thread (reference py_reader + its BlockingQueue)."""

    _eof_msg = "py_reader exhausted"

    def __init__(self, var_names, shapes, dtypes, capacity: int = 64,
                 feeder=None):
        super().__init__(var_names, capacity)
        self.shapes = shapes
        self.dtypes = dtypes
        self._feeder = feeder  # DataFeeder for sample-tuple assembly
        self._source: Optional[Callable] = None
        self._tensor_source = False

    # -- decoration (reference py_reader API) ---------------------------
    def decorate_paddle_reader(self, reader: Callable):
        """`reader()` yields batches as lists of per-sample tuples (the
        paddle.batch convention)."""
        self._source = reader
        self._tensor_source = False

    def decorate_tensor_provider(self, reader: Callable):
        """`reader()` yields tuples of ready batch arrays per slot."""
        self._source = reader
        self._tensor_source = True

    def _assemble(self, item):
        if self._tensor_source:
            return {n: np.asarray(a) for n, a in zip(self.var_names, item)}
        if self._feeder is not None:
            return self._feeder.feed(item)
        # paddle.batch convention: item is a list of per-sample tuples;
        # stack each slot into one batch array, cast to the declared dtype
        feed = {}
        for j, n in enumerate(self.var_names):
            arr = np.stack([np.asarray(sample[j]) for sample in item])
            if self.dtypes:
                arr = arr.astype(self.dtypes[j], copy=False)
            want = [s for s in (self.shapes[j] if self.shapes else [])
                    if s and s > 0]
            if want and list(arr.shape[1:]) != want and \
                    arr.size == len(item) * int(np.prod(want)):
                arr = arr.reshape([len(item)] + want)
            feed[n] = arr
        return feed

    def _produce(self, gen):
        for item in self._source():
            yield self._assemble(item)

    def start(self):
        if self._source is None:
            raise RuntimeError(
                "py_reader has no source; call decorate_paddle_reader or "
                "decorate_tensor_provider first")
        self._spawn()

    def next(self):
        if self._thread is None:
            raise RuntimeError("py_reader not started; call reader.start()")
        return self._next_item()

    def reset(self):
        self._teardown()


class RecordIOFilesReader(ReaderBase):
    """Sample-level reader over recordio files through the C++
    PrefetchReader, one per file in turn (reference open_recordio_file /
    open_files + operators/reader/create_recordio_file_reader_op.cc).
    Each record is one pickled sample tuple (``recordio_convert``)."""

    def __init__(self, filenames, var_names, shapes, dtypes,
                 prefetch_capacity: int = 256):
        super().__init__(var_names)
        self.shapes = [list(s) for s in shapes]
        self.dtypes = list(dtypes)
        from ..runtime import recordio as rio

        self._rio = rio
        self.filenames = ([filenames] if isinstance(filenames, str)
                          else list(filenames))
        self.capacity = prefetch_capacity
        self._iter = None
        # after EOF the reader stays exhausted until reset() — next() must
        # NOT silently begin a new pass (the executor polls next() per
        # step; auto-restart would turn one epoch into an endless stream)
        self._exhausted = False

    def _make_iter(self):
        import pickle

        def it():
            for path in self.filenames:
                src = self._rio.PrefetchReader(path, self.capacity)
                try:
                    for rec in src:
                        yield pickle.loads(rec)
                finally:
                    src.close()

        return it()

    def start(self):
        if self._iter is None and not self._exhausted:
            self._iter = self._make_iter()

    def next(self):
        if self._exhausted:
            raise EOFException("recordio files exhausted (call reset())")
        if self._iter is None:
            self.start()
        try:
            sample = next(self._iter)
        except StopIteration:
            self._iter = None
            self._exhausted = True
            raise EOFException("recordio files exhausted") from None
        return {n: np.asarray(a) for n, a in zip(self.var_names, sample)}

    def reset(self):
        self._iter = None
        self._exhausted = False


class BatchReader(ReaderBase):
    """Assemble per-sample dicts from an inner reader into batches
    (reference layers/io.py:batch -> create_batch_reader op). Each batch
    array is allocated for that batch and filled by the C++ threaded
    gather (``batch_assemble``; a Python row loop for payloads under its
    1 MiB threshold or where the runtime is not built), so a batch stays
    as it was handed out for as long as anyone holds it. (The JAX
    package's native branch assembles into 4 rotating staging arenas, so
    there a batch held past 4 more is overwritten.)"""

    def __init__(self, inner: ReaderBase, batch_size: int, drop_last=True):
        super().__init__(inner.var_names)
        self.inner = inner
        self.batch_size = batch_size
        self.drop_last = drop_last
        if inner.shapes is not None:
            # sample-level shapes gain a leading (dynamic) batch dim
            self.shapes = [[-1] + list(s) for s in inner.shapes]
        self.dtypes = inner.dtypes

    @staticmethod
    def _stack(rows: List[Dict[str, np.ndarray]]):
        out = {}
        for name in rows[0]:
            cols = [np.asarray(r[name]) for r in rows]
            first = cols[0]
            dst = np.empty((len(rows),) + first.shape, first.dtype)
            if not _batch_assemble(cols, dst):
                for i, c in enumerate(cols):
                    dst[i] = c
            out[name] = dst
        return out

    def start(self):
        self.inner.start()

    def next(self):
        rows = []
        for _ in range(self.batch_size):
            try:
                rows.append(self.inner.next())
            except EOFException:
                if rows and not self.drop_last:
                    return self._stack(rows)
                raise
        return self._stack(rows)

    def reset(self):
        self.inner.reset()


class DoubleBufferReader(_PumpedReader):
    """Device-staging stage (reference double_buffer ->
    operators/reader/buffered_reader): a background thread pulls the
    upcoming batches from the inner reader and puts them on the device, so
    the executor receives device tensors and the host->device copy hides
    behind the step.

    On the card each array is copied into pinned host memory and from
    there onto the card on a side stream, without blocking the host. A
    pinned buffer goes back into use only once its copy has completed
    (its event), and ``next()`` makes the caller's current stream wait for
    the batch's copies before it hands the batch over. On the CPU the
    batch becomes CPU tensors (copies). Either way the inner reader's
    arrays are dropped once copied, so a DataLoader's shared-memory slot
    goes back to its ring at once. ``place`` None stages on the device of
    the Executor that pulls the reader (``bind_device``); the staging
    thread starts once that device is known."""

    _eof_msg = "double_buffer inner reader exhausted"

    def __init__(self, inner: ReaderBase, place=None, capacity: int = 2):
        super().__init__(inner.var_names, capacity)
        self.inner = inner
        self.place = place
        self.shapes = inner.shapes
        self.dtypes = inner.dtypes
        self._bound: Optional[torch.device] = None
        # name -> ring of [pinned tensor, event after its copy]: one more
        # than the batches that can be queued, handed over and in flight
        self._pinned: Dict[str, List] = {}

    def bind_device(self, device: torch.device):
        if self.place is None:
            self._bound = torch.device(device)
        self.inner.bind_device(device)

    def _device(self) -> torch.device:
        if self.place is not None:
            return self.place.torch_device()
        if self._bound is None:
            raise RuntimeError(
                "double_buffer has no place and no Executor has pulled it "
                "yet: it stages on the device of the Executor that pulls "
                "it, or on the place given to layers.double_buffer")
        return self._bound

    def _pin(self, name, arr, turn):
        """The pinned buffer of ``name`` for this turn, holding ``arr``."""
        src = torch.from_numpy(arr)
        ring = self._pinned.setdefault(name, [None] * (self.capacity + 3))
        slot = ring[turn % len(ring)]
        if slot is None or slot[0].shape != src.shape or \
                slot[0].dtype != src.dtype:
            slot = ring[turn % len(ring)] = [
                torch.empty(src.shape, dtype=src.dtype, pin_memory=True),
                None]
        elif slot[1] is not None:
            slot[1].synchronize()   # its last copy must have read it
        slot[0].copy_(src)
        return slot

    def _stage(self, feed, dev, side, turn):
        """``feed`` copied onto ``dev``: (staged tensors, the event after
        their copies or None). ``feed`` is not referenced after."""
        if side is None:
            return {k: torch.tensor(np.asarray(v))
                    for k, v in feed.items()}, None
        staged, slots = {}, []
        with torch.cuda.stream(side):
            for k, v in feed.items():
                if isinstance(v, torch.Tensor) and v.device == dev:
                    staged[k] = v
                    continue
                slot = self._pin(k, np.ascontiguousarray(np.asarray(v)),
                                 turn)
                staged[k] = slot[0].to(dev, non_blocking=True)
                slots.append(slot)
            ready = torch.cuda.Event()
            ready.record(side)
        for slot in slots:
            slot[1] = ready
        return staged, ready

    def _produce(self, gen):
        dev = self._device()
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        turn = 0
        while True:
            try:
                staged = self._stage(self.inner.next(), dev, side, turn)
            except EOFException:
                return
            turn += 1
            yield staged

    def start(self):
        self.inner.start()
        if self.place is not None or self._bound is not None:
            self._device()  # a place without its device raises here
            self._spawn()

    def next(self):
        if self._thread is None:
            self.start()
            if self._thread is None:
                self._device()  # unbound and no place: raises
        staged, ready = self._next_item()
        if ready is not None:
            cur = torch.cuda.current_stream(self._device())
            cur.wait_event(ready)
            for t in staged.values():
                t.record_stream(cur)
        return staged

    def reset(self):
        # reset the inner stage FIRST: if the pump thread is blocked inside
        # inner.next() (e.g. a stalled py_reader source), the inner reset
        # unblocks it so the teardown join below can complete
        self.inner.reset()
        self._teardown()


class ShuffleReader(ReaderBase):
    """Buffered shuffling stage (reference layers/io.py:shuffle ->
    create_shuffle_reader op): fills a buffer_size window from the inner
    reader and emits it in random order; deterministic per (seed, epoch)."""

    def __init__(self, inner: ReaderBase, buffer_size: int, seed: int = 0):
        super().__init__(inner.var_names)
        self.inner = inner
        self.buffer_size = max(int(buffer_size), 1)
        self.seed = seed
        self.shapes = inner.shapes
        self.dtypes = inner.dtypes
        self._epoch = 0
        self._buf: List = []
        self._rng = None

    def start(self):
        self.inner.start()
        if self._rng is None:
            import random

            self._rng = random.Random(self.seed * 1000003 + self._epoch)

    def next(self):
        if self._rng is None:
            self.start()
        if not self._buf:
            try:
                while len(self._buf) < self.buffer_size:
                    self._buf.append(self.inner.next())
            except EOFException:
                if not self._buf:
                    # epoch bookkeeping belongs to reset(): repeated
                    # post-EOF polls must not perturb the shuffle stream
                    raise
            self._rng.shuffle(self._buf)
        return self._buf.pop()

    def reset(self):
        self._buf = []
        self._rng = None
        self._epoch += 1
        self.inner.reset()


class RandomDataGenerator(ReaderBase):
    """Uniform random batches (reference layers/io.py:
    random_data_generator -> create_random_data_generator_op): an infinite
    source of float32 uniforms in [low, high) with the given shapes."""

    def __init__(self, low, high, shapes, var_names, seed: int = 0):
        super().__init__(var_names)
        self.low = float(low)
        self.high = float(high)
        self.shapes = [list(s) for s in shapes]
        self.dtypes = ["float32"] * len(shapes)
        self.seed = seed
        self._rng = np.random.RandomState(seed)

    def next(self):
        return {
            n: self._rng.uniform(self.low, self.high,
                                 [1 if d in (-1, None) else d
                                  for d in shape]).astype(np.float32)
            for n, shape in zip(self.var_names, self.shapes)}

    def reset(self):
        self._rng = np.random.RandomState(self.seed)


class PreprocessReader(ReaderBase):
    """Applies a preprocessing sub-Program to every batch the inner reader
    yields (reference layers/io.py:Preprocessor): the block's ops run on
    the host through an Executor of their own before the batch reaches
    the training step."""

    def __init__(self, inner: ReaderBase, program, in_names, out_names,
                 startup_program=None):
        super().__init__(list(out_names))
        self.inner = inner
        self._program = program
        self._startup = startup_program
        self._in_names = list(in_names)
        self._out_names = list(out_names)
        self._exe = None

    def start(self):
        self.inner.start()

    def next(self):
        from ..executor import Executor
        from ..framework.scope import CPUPlace, Scope

        feed = self.inner.next()
        if self._exe is None:
            self._exe = Executor(CPUPlace())
            self._scope = Scope()
            if self._startup is not None:
                # parameters created inside the Preprocessor block get
                # their init ops here
                self._exe.run(self._startup, scope=self._scope)
        outs = self._exe.run(
            self._program,
            feed={n: feed[src] for n, src in
                  zip(self._in_names, self.inner.var_names)},
            fetch_list=self._out_names, scope=self._scope)
        return dict(zip(self._out_names, outs))

    def reset(self):
        self.inner.reset()
