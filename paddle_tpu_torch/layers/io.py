"""layers.io (reference: python/paddle/fluid/layers/io.py; counterpart of
paddle_tpu/layers/io.py).

`data` declares feed variables. The reader-op pipeline — py_reader
(reference io.py:474), data_loader (its multiprocess twin),
open_recordio_file (:345), open_files (:724), double_buffer (:891),
batch, shuffle, read_file, random_data_generator and Preprocessor — is
backed by paddle_tpu_torch.io.reader and io.dataloader (the C++ runtime
underneath): a reader is a Variable carrying a host-side pipeline stage,
the `read` op marks where its batches enter the Program, and the
Executor pulls and feeds them per step, so no Python feed dict is
needed. `load` reads a saved tensor into a variable.
"""
from __future__ import annotations

from ..framework import unique_name
from ..framework.core import default_main_program
from ..framework.dtypes import convert_dtype
from ..io import dataloader as dataloader_mod
from ..io import reader as reader_mod

__all__ = ["data", "py_reader", "data_loader", "read_file",
           "open_recordio_file", "open_files", "batch", "double_buffer",
           "shuffle", "random_data_generator", "Preprocessor", "load"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0, type=None, stop_gradient=True):
    """Declare a feed variable (reference io.py:data). With lod_level>0 a
    companion `<name>.lens` int32 vector is declared for sequence lengths."""
    helper_block = default_main_program().current_block()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    var = helper_block.create_var(
        name=name,
        shape=tuple(shape),
        dtype=convert_dtype(dtype),
        lod_level=lod_level,
        stop_gradient=stop_gradient,
        is_data=True,
    )
    if lod_level > 0:
        helper_block.create_var(
            name=name + ".lens",
            shape=(-1,),
            dtype="int32",
            stop_gradient=True,
            is_data=True,
        )
    return var


# ---------------------------------------------------------------------------
# reader ops
# ---------------------------------------------------------------------------


def _make_reader_var(holder, name=None):
    """A reader Variable carrying its host-side pipeline stage, with the
    reference's start()/reset() methods attached (reference py_reader
    returns a Variable patched the same way)."""
    block = default_main_program().current_block()
    var = block.create_var(
        name=name or unique_name.generate("_reader"),
        shape=(),
        dtype="float32",
        stop_gradient=True,
    )
    var._reader_holder = holder

    # start()/reset() begin a fresh epoch: any batch a run_loop window
    # pushed back (partial-shape boundary) belongs to the OLD epoch and
    # must not replay into the new one. The epoch counter lets the
    # executor's prefetched windows (which hold already-pulled batches)
    # detect the same staleness and drop instead of pushing back.
    def _fresh_epoch(fn):
        def wrapped():
            holder._ptpu_pushback = []
            holder._ptpu_epoch = getattr(holder, "_ptpu_epoch", 0) + 1
            return fn()
        return wrapped

    var.start = _fresh_epoch(holder.start)
    var.reset = _fresh_epoch(holder.reset)
    return var


def _slot_names(base, n):
    return ["%s.slot%d" % (base, i) for i in range(n)]


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """reference io.py:474. Returns a reader Variable; feed it with
    reader.decorate_paddle_reader(batched_reader) or
    reader.decorate_tensor_provider(gen), then reader.start(); get the data
    Variables with layers.read_file(reader)."""
    if lod_levels and any(l > 0 for l in lod_levels):
        raise NotImplementedError(
            "py_reader with lod_levels>0: feed dense padded arrays + a "
            "lengths slot instead (dense+lengths convention)")
    base = name or unique_name.generate("py_reader")
    names = _slot_names(base, len(shapes))
    holder = reader_mod.PyReader(names, [list(s) for s in shapes],
                                 [convert_dtype(d) for d in dtypes],
                                 capacity=capacity)
    var = _make_reader_var(holder, name=base)
    var.decorate_paddle_reader = holder.decorate_paddle_reader
    var.decorate_tensor_provider = holder.decorate_tensor_provider
    if use_double_buffer:
        return double_buffer(var, keep_decoration=True)
    return var


def data_loader(capacity, shapes, dtypes, num_workers=2, ordered=True,
                slot_bytes=4 << 20, start_method=None, name=None,
                use_double_buffer=False):
    """py_reader's multiprocess twin: `num_workers` worker PROCESSES
    decode/assemble batches into a shared-memory slot ring (zero-copy,
    GIL-free — see io/dataloader.py). Same wiring: decorate with
    decorate_paddle_reader / decorate_sample_reader /
    decorate_tensor_provider, then reader.start() per epoch; get the
    data Variables with layers.read_file(reader); exhaustion raises
    EOFException. `capacity` is the ring depth in batches. Call
    reader.close() (or let it be GC'd) to release the workers and the
    shared-memory segment."""
    base = name or unique_name.generate("data_loader")
    names = _slot_names(base, len(shapes))
    holder = dataloader_mod.DataLoader(
        names, [list(s) for s in shapes],
        [convert_dtype(d) for d in dtypes], num_workers=num_workers,
        capacity=capacity, slot_bytes=slot_bytes, ordered=ordered,
        start_method=start_method)

    def _wire(var):
        var.decorate_paddle_reader = holder.decorate_paddle_reader
        var.decorate_sample_reader = holder.decorate_sample_reader
        var.decorate_tensor_provider = holder.decorate_tensor_provider
        var.close = holder.close
        return var

    var = _wire(_make_reader_var(holder, name=base))
    if use_double_buffer:
        outer = _wire(double_buffer(var))
        staging = outer._reader_holder

        def close():
            staging.reset()  # the staging thread stops before the workers
            holder.close()

        outer.close = close
        return outer
    return var


def open_recordio_file(filename, shapes, dtypes, lod_levels=None,
                       pass_num=1):
    """reference io.py:345 — a sample-level reader over a recordio file
    written by recordio_convert (pickled sample tuples). Chain with
    layers.batch(...) + read_file."""
    base = unique_name.generate("recordio_reader")
    names = _slot_names(base, len(shapes))
    files = [filename] * pass_num
    holder = reader_mod.RecordIOFilesReader(
        files, names, [list(s) for s in shapes],
        [convert_dtype(d) for d in dtypes])
    return _make_reader_var(holder, name=base)


def open_files(filenames, shapes, dtypes, lod_levels=None, pass_num=1,
               thread_num=None, buffer_size=None):
    """reference io.py:724 — like open_recordio_file over a file list.
    thread_num is accepted for parity (the C++ PrefetchReader runs one
    prefetch thread per file, in turn, with a bounded channel of
    buffer_size records)."""
    base = unique_name.generate("files_reader")
    names = _slot_names(base, len(shapes))
    files = list(filenames) * pass_num
    holder = reader_mod.RecordIOFilesReader(
        files, names, [list(s) for s in shapes],
        [convert_dtype(d) for d in dtypes],
        prefetch_capacity=buffer_size or 256)
    return _make_reader_var(holder, name=base)


def batch(reader, batch_size, drop_last=True):
    """reference io.py:batch — batch a sample-level reader."""
    holder = reader_mod.BatchReader(reader._reader_holder, batch_size,
                                    drop_last=drop_last)
    return _make_reader_var(holder)


def double_buffer(reader, place=None, name=None, keep_decoration=False):
    """reference io.py:891 — stage upcoming batches on the device from a
    background thread so the host->device copy hides behind compute."""
    inner = reader._reader_holder
    holder = reader_mod.DoubleBufferReader(inner, place=place)
    var = _make_reader_var(holder, name=name)
    if keep_decoration:
        # decorating the outer reader decorates the wrapped py_reader
        var.decorate_paddle_reader = inner.decorate_paddle_reader
        var.decorate_tensor_provider = inner.decorate_tensor_provider
    return var


def read_file(reader):
    """reference io.py:read_file — materialize the reader's slots as data
    Variables via a `read` op (the Executor pulls a batch per step)."""
    block = default_main_program().current_block()
    holder = reader._reader_holder
    outs = []
    for name, shape, dtype in zip(holder.var_names,
                                  getattr(holder, "shapes", None)
                                  or [()] * len(holder.var_names),
                                  getattr(holder, "dtypes", None)
                                  or ["float32"] * len(holder.var_names)):
        outs.append(block.create_var(
            name=name, shape=tuple(shape), dtype=dtype,
            stop_gradient=True, is_data=True))
    block.append_op(
        type="read",
        inputs={"Reader": [reader]},
        outputs={"Out": outs},
    )
    return outs


def shuffle(reader, buffer_size):
    """reference io.py:shuffle — buffered shuffling reader transform."""
    holder = reader_mod.ShuffleReader(reader._reader_holder, buffer_size)
    return _make_reader_var(holder)


def random_data_generator(low, high, shapes, lod_levels=None,
                          for_parallel=False):
    """reference io.py:random_data_generator — an infinite uniform-random
    source (float32), mostly for pipeline benchmarking."""
    base = unique_name.generate("random_reader")
    names = _slot_names(base, len(shapes))
    holder = reader_mod.RandomDataGenerator(low, high, shapes, names)
    return _make_reader_var(holder, name=base)


class Preprocessor:
    """reference io.py:Preprocessor — build a preprocessing sub-Program
    applied to every batch a reader yields (on the host, before the batch
    enters the step)::

        p = layers.Preprocessor(reader)
        with p.block():
            img, lbl = p.inputs()
            p.outputs(img, lbl)
        img, lbl = layers.read_file(p.reader)
    """

    def __init__(self, reader, name=None):
        from ..framework.core import Program

        self._source = reader
        self._program = Program()
        self.reader = None
        self._in_vars = None
        self._out_names = None

    def block(self):
        import contextlib

        from ..framework.core import program_guard

        @contextlib.contextmanager
        def _ctx():
            from ..framework.core import Program

            self._startup = Program()
            with program_guard(self._program, self._startup):
                yield
            self._finalize()

        return _ctx()

    def inputs(self):
        inner = self._source._reader_holder
        if inner.shapes is None or inner.dtypes is None:
            raise RuntimeError(
                "Preprocessor needs the source reader's shapes/dtypes")
        block = self._program.current_block()
        self._in_vars = [
            block.create_var(name="_pp_in_%d" % i, shape=tuple(s),
                             dtype=d, is_data=True)
            for i, (s, d) in enumerate(zip(inner.shapes, inner.dtypes))]
        return list(self._in_vars)

    def outputs(self, *outs):
        self._out_names = [o.name for o in outs]
        self._out_shapes = [tuple(o.shape) for o in outs]
        self._out_dtypes = [o.dtype for o in outs]

    def _finalize(self):
        if self._in_vars is None or self._out_names is None:
            raise RuntimeError(
                "Preprocessor.block() needs inputs() and outputs() calls")
        holder = reader_mod.PreprocessReader(
            self._source._reader_holder, self._program,
            [v.name for v in self._in_vars], self._out_names,
            startup_program=self._startup)
        holder.shapes = [list(s) for s in self._out_shapes]
        holder.dtypes = [str(d) for d in self._out_dtypes]
        self.reader = _make_reader_var(holder)


def load(out, file_path, load_as_fp16=None):
    """reference io.py:load (load_op.cc) — load a saved tensor from disk
    into `out`: the `.npy` file that save_vars writes. The `load_file`
    op reads it on the host on its first run on a device and reuses the
    tensor after (ops/math.py), so a captured step never reads the
    file."""
    block = default_main_program().current_block()
    block.append_op(
        type="load_file",
        inputs={},
        outputs={"Out": [out]},
        attrs={"file_path": str(file_path),
               "load_as_fp16": bool(load_as_fp16)},
    )
    return out
