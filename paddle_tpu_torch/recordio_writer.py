"""Convert Python readers into recordio files (counterpart of
paddle_tpu/recordio_writer.py; reference:
python/paddle/fluid/recordio_writer.py).

One record = one (pickled) tuple of the feeder-converted arrays in
``feed_order`` — i.e. a batch when ``reader_creator`` is a batched reader,
matching the reference where each ``complete_append_tensor()`` seals the
batch the feeder produced. Files written here are read back by
``layers.open_recordio_file(...)`` (each record surfaces as one
step's slot arrays) or by ``runtime.recordio_sample_reader``.

The chunked container itself is the C++ runtime writer
(runtime/runtime.cc: crc32 + deflate), not the reference's snappy
format — ``Compressor`` maps Snappy/NoCompress onto deflate/raw.
"""
from __future__ import annotations

import contextlib
import os
import pickle

from .runtime.recordio import RecordIOWriter

__all__ = [
    "convert_reader_to_recordio_file",
    "convert_reader_to_recordio_files",
]


class Compressor:
    """Reference core.RecordIOWriter.Compressor enum shim: Snappy is not
    in this runtime; it maps to deflate (same role: cheap block
    compression), NoCompress to raw chunks."""

    NoCompress = 0
    Snappy = 1
    Deflate = 1


@contextlib.contextmanager
def create_recordio_writer(filename, compressor=Compressor.Snappy,
                           max_num_records=1000):
    writer = RecordIOWriter(filename, int(compressor), max_num_records)
    try:
        yield writer
    finally:
        writer.close()


def _feed_records(reader_creator, feeder, feed_order):
    for batch in reader_creator():
        res = feeder.feed(batch)
        # default order: everything the feeder emitted, in feed_list order
        # (sequence slots insert their `.lens` companion right after the
        # padded data, so lengths round-trip too)
        names = feed_order or list(res.keys())
        yield tuple(res[name] for name in names)


def convert_reader_to_recordio_file(filename, reader_creator, feeder,
                                    compressor=Compressor.Snappy,
                                    max_num_records=1000, feed_order=None):
    """Serialize every batch of ``reader_creator`` (converted to arrays by
    ``feeder``) into one recordio file; returns the record count."""
    counter = 0
    with create_recordio_writer(filename, compressor, max_num_records) as w:
        for rec in _feed_records(reader_creator, feeder, feed_order):
            w.write(pickle.dumps(rec, protocol=4))
            counter += 1
    return counter


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, feeder,
                                     compressor=Compressor.Snappy,
                                     max_num_records=1000, feed_order=None):
    """Like :func:`convert_reader_to_recordio_file` but rolls to a new
    ``name-NNNNN.recordio`` file every ``batch_per_file`` records."""
    f_name, f_ext = os.path.splitext(filename)
    if f_ext != ".recordio":
        raise ValueError("filename must end with .recordio, got %r" % filename)
    counter, f_idx, writer = 0, 0, None
    try:
        for rec in _feed_records(reader_creator, feeder, feed_order):
            if writer is None:
                writer = RecordIOWriter("%s-%05d%s" % (f_name, f_idx, f_ext),
                                        int(compressor), max_num_records)
                f_idx += 1
            writer.write(pickle.dumps(rec, protocol=4))
            counter += 1
            if counter % batch_per_file == 0:
                writer.close()
                writer = None
    finally:
        if writer is not None:
            writer.close()
    return counter
