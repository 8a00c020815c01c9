"""The port's host runtime (paddle_tpu_torch/runtime: runtime.cc built by
g++, recordio.py) against the JAX package's (paddle_tpu/runtime), on the
CPU, from seeded numpy samples:

- the recordio format: for the same records both packages' writers give
  byte-identical files, with each compressor, in the native branch and in
  the Python branch; each package reads the other's files; corruption
  raises in strict mode, and ``tolerant=True`` skips what the JAX
  package's reader skips; ``recordio_convert`` / ``recordio_writer`` give
  the JAX package's files;
- the array-frame codec (``encode_frame``, ``encode_frame_into``,
  ``decode_frame``, ``frame_tag``) gives the JAX package's bytes;
- ``Channel``: the JAX package's close, deadline and zero-wait results;
- ``batch_assemble`` equals ``np.stack`` (and declines what the JAX
  package's declines); ``StagingArena`` and ``PrefetchReader``;
- the runtime library builds into build/paddle_tpu_torch/.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.recordio_writer as ref_writer  # noqa: E402
import paddle_tpu.runtime.recordio as ref_rio  # noqa: E402
from paddle_tpu import data_feeder as ref_feeder  # noqa: E402
from paddle_tpu import layers as ref_layers  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
import paddle_tpu_torch.recordio_writer as pt_writer  # noqa: E402
import paddle_tpu_torch.runtime.recordio as pt_rio  # noqa: E402
from paddle_tpu_torch import layers as pt_layers  # noqa: E402
from paddle_tpu_torch.kernels import BUILD_DIR  # noqa: E402
from paddle_tpu_torch.runtime import build as pt_build  # noqa: E402


def _records(n=40, seed=0):
    """Seeded records of varied lengths (0 to ~3 KB), some repeated so
    deflate has something to find."""
    r = np.random.RandomState(seed)
    out = []
    for i in range(n):
        size = int(r.randint(0, 3000)) if i % 7 else 0
        blob = r.randint(0, 8 if i % 3 else 256, size).astype(np.uint8)
        out.append(blob.tobytes())
    return out


@pytest.fixture(params=["native", "python"])
def branch(request, monkeypatch):
    """Both packages on their native library, or both on their Python
    branch of the same format."""
    if request.param == "python":
        for mod in (pt_rio, ref_rio):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_load_failed", True)
    else:
        assert pt_rio.native_available() and ref_rio.native_available()
    return request.param


def _write(mod, path, records, comp, max_chunk):
    with mod.RecordIOWriter(str(path), comp, max_chunk) as w:
        for rec in records:
            w.write(rec)


@pytest.mark.parametrize("comp", [0, 1], ids=["raw", "deflate"])
def test_files_are_byte_identical_and_cross_readable(tmp_path, branch, comp):
    records = _records()
    ours, theirs = tmp_path / "port.rio", tmp_path / "ref.rio"
    _write(pt_rio, ours, records, comp, 6)
    _write(ref_rio, theirs, records, comp, 6)
    assert ours.read_bytes() == theirs.read_bytes()
    with pt_rio.RecordIOReader(str(theirs)) as r:
        assert list(r) == records
    with ref_rio.RecordIOReader(str(ours)) as r:
        assert list(r) == records
    # the prefetch thread reads the same records, and a missing file raises
    src = pt_rio.PrefetchReader(str(theirs), capacity=4)
    assert list(src) == records
    src.close()
    with pytest.raises(pt_rio.RecordIOError):
        pt_rio.RecordIOReader(str(tmp_path / "missing.rio"))


def _chunk_offsets(data):
    """Byte offsets of each chunk header in a recordio file."""
    hdr = pt_rio._HDR
    offs, pos = [], 0
    while pos < len(data):
        offs.append(pos)
        complen = hdr.unpack_from(data, pos)[4]
        pos += hdr.size + complen
    return offs


@pytest.mark.parametrize("damage", ["payload", "magic", "truncated"])
def test_corruption_raises_and_tolerant_skips_like_the_reference(
        tmp_path, branch, damage):
    records = _records(30, seed=1)
    path = tmp_path / "bad.rio"
    _write(pt_rio, path, records, 1, 5)
    data = bytearray(path.read_bytes())
    offs = _chunk_offsets(bytes(data))
    assert len(offs) == 6
    if damage == "payload":
        data[offs[2] + pt_rio._HDR.size + 3] ^= 0xFF
    elif damage == "magic":
        data[offs[4]] ^= 0x01
    else:
        data = data[:offs[5] + 10]
    path.write_bytes(bytes(data))
    for mod in (pt_rio, ref_rio):
        with pytest.raises(mod.RecordIOError):
            with mod.RecordIOReader(str(path)) as r:
                list(r)
    got, want = (mod.RecordIOReader(str(path), tolerant=True)
                 for mod in (pt_rio, ref_rio))
    got_recs, want_recs = list(got), list(want)
    assert got_recs == want_recs
    assert got.skipped_chunks == want.skipped_chunks == 1
    lost = {"payload": 2, "magic": 4, "truncated": 5}[damage]
    assert got_recs == records[:5 * lost] + records[5 * (lost + 1):]
    got.close()
    want.close()


class _Samples:
    def __init__(self, n):
        r = np.random.RandomState(3)
        self.data = [(r.randn(4).astype(np.float32), np.int64(i))
                     for i in range(n)]

    def __call__(self):
        return iter(self.data)


def test_recordio_convert_and_sample_reader_match_the_reference(tmp_path):
    src = _Samples(11)
    ours, theirs = str(tmp_path / "p.rio"), str(tmp_path / "r.rio")
    assert pt.recordio_convert(src, ours, max_chunk_records=4) == 11
    assert ref_rio.recordio_convert(src, theirs, max_chunk_records=4) == 11
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for prefetch in (True, False):
        got = list(pt.recordio_sample_reader(theirs, prefetch=prefetch)())
        want = list(ref_rio.recordio_sample_reader(ours, prefetch=prefetch)())
        assert len(got) == len(want) == 11
        for (ga, gb), (wa, wb) in zip(got, want):
            np.testing.assert_array_equal(ga, wa)
            assert gb == wb
    # a record whose payload no longer unpickles is skipped and counted
    with pt_rio.RecordIOWriter(str(tmp_path / "junk.rio")) as w:
        w.write(pickle.dumps((1,)))
        w.write(b"not a pickle")
        w.write(pickle.dumps((2,)))
    from paddle_tpu_torch import observability as obs

    before = obs.TRAIN_SKIPPED_BATCHES.value(reason="corrupt_record")
    got = list(pt.recordio_sample_reader(str(tmp_path / "junk.rio"),
                                         skip_corrupt=True)())
    assert got == [(1,), (2,)]
    assert obs.TRAIN_SKIPPED_BATCHES.value(
        reason="corrupt_record") == before + 1


def _feeder_records(pkg, layers, mod_feeder, path, multi):
    """convert_reader_to_recordio_file(s) through a DataFeeder with a
    dense and a sequence slot, in package ``pkg``."""
    prog = pkg.Program()
    with pkg.program_guard(prog, pkg.Program()):
        x = layers.data(name="x", shape=[3], dtype="float32")
        s = layers.data(name="s", shape=[1], dtype="int64", lod_level=1)
    feeder = mod_feeder.DataFeeder([x, s], program=prog)
    r = np.random.RandomState(5)
    batches = [[(r.randn(3).astype(np.float32),
                 r.randint(0, 9, (int(r.randint(1, 5)), 1)))
                for _ in range(4)] for _ in range(5)]
    writer = pt_writer if pkg is pt else ref_writer
    if multi:
        return writer.convert_reader_to_recordio_files(
            path, 2, lambda: iter(batches), feeder, max_num_records=3)
    return writer.convert_reader_to_recordio_file(
        path, lambda: iter(batches), feeder, max_num_records=3)


@pytest.mark.parametrize("multi", [False, True], ids=["file", "files"])
def test_recordio_writer_matches_the_reference(tmp_path, multi):
    import paddle_tpu as fluid

    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    n_pt = _feeder_records(pt, pt_layers, pt.data_feeder,
                           str(tmp_path / "p" / "d.recordio"), multi)
    n_ref = _feeder_records(fluid, ref_layers, ref_feeder,
                            str(tmp_path / "r" / "d.recordio"), multi)
    assert n_pt == n_ref == 5
    names = sorted(os.listdir(tmp_path / "r"))
    assert sorted(os.listdir(tmp_path / "p")) == names
    assert len(names) == (3 if multi else 1)
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "r" / name).read_bytes()
    with pytest.raises(ValueError, match="recordio"):
        pt_writer.convert_reader_to_recordio_files(
            str(tmp_path / "x.rio"), 2, lambda: iter([]), None)
    assert pt_writer.Compressor.NoCompress == 0
    assert pt_writer.Compressor.Snappy == 1


def _frame_rows():
    r = np.random.RandomState(7)
    return [r.randn(3, 5).astype(np.float32),
            np.arange(12, dtype=np.int64).reshape(2, 2, 3),
            np.array(2.5, dtype=np.float16),
            np.zeros((0, 4), np.int32),
            np.array([True, False, True]),
            np.array([b"ab", b"cde"], dtype="S3"),
            r.randn(4, 6).astype(np.float64)[:, ::2]]  # not contiguous


def test_frame_codec_gives_the_reference_bytes():
    rows = _frame_rows()
    contiguous = [np.ascontiguousarray(a) for a in rows]
    want = ref_rio.encode_frame(42, contiguous)
    assert pt_rio.encode_frame(42, contiguous) == want
    assert pt_rio.frame_nbytes(contiguous) == len(want)
    buf = bytearray(len(want) + 16)
    assert pt_rio.encode_frame_into(buf, 42, rows) == len(want)
    assert bytes(buf[:len(want)]) == want
    assert pt_rio.encode_frame_into(bytearray(len(want) - 1), 42, rows) == -1
    tag, got = pt_rio.decode_frame(want)
    assert tag == 42 == pt_rio.frame_tag(want)
    _, ref_got = ref_rio.decode_frame(want)
    for g, w, r in zip(got, contiguous, ref_got):
        # (np.ascontiguousarray makes a 0-d row 1-d, in both packages)
        assert g.dtype == w.dtype == r.dtype and g.shape == w.shape == r.shape
        np.testing.assert_array_equal(g, w)
    # object rows cannot ride a frame: the pickled form, both ways
    objs = [np.array(["s", None], dtype=object)]
    assert not pt_rio.frame_encodable(objs)
    assert pt_rio.encode_frame_into(bytearray(1 << 10), 1, objs) == -1
    pk = pt_rio.encode_frame_pickle(9, objs)
    assert pk == ref_rio.encode_frame_pickle(9, objs)
    tag, got = pt_rio.decode_frame(pk)
    assert tag == 9 == pt_rio.frame_tag(pk) and got[0][0] == "s"
    for bad in (b"Zab", b"Q" + bytes(20)):
        with pytest.raises(ValueError):
            pt_rio.decode_frame(bad)
        with pytest.raises(ValueError):
            pt_rio.frame_tag(bad)


def _channel_script(mod):
    """The same operations on a channel of ``mod``: what each returned."""
    ch = mod.Channel(capacity=4)
    out = [ch.send(b"a"), ch.send(b""), ch.send(b"ccc"), ch.qsize()]
    out.append(ch.recv())
    out.append(ch.recv_batch(8))                  # drains what is queued
    out.append(ch.recv_batch(8, max_wait_s=0))    # open and empty: []
    ch.send(b"d")
    out.append(ch.recv_batch(3, max_wait_s=0.02))  # deadline: what came
    ch.send(b"e")
    ch.send(b"f")
    out.append(ch.recv_batch(2, max_wait_s=30.0))  # full: no wait
    ch.send(b"g")
    ch.close()
    out += [ch.send(b"h"), ch.recv(), ch.recv(),
            ch.recv_batch(4), ch.recv_batch(4, max_wait_s=0),
            ch.recv_batch(4, max_wait_s=0.01)]
    ch.destroy()
    return out


def test_channel_follows_the_reference(branch):
    want = [True, True, True, 3, b"a", [b"", b"ccc"], [], [b"d"],
            [b"e", b"f"], False, b"g", None, None, None, None]
    assert _channel_script(pt_rio) == _channel_script(ref_rio) == want


def test_batch_assemble_equals_stack():
    r = np.random.RandomState(2)
    rows = [r.randn(128, 160).astype(np.float32) for _ in range(16)]
    dst = np.empty((16, 128, 160), np.float32)       # 1.25 MiB: threaded
    assert pt_rio.batch_assemble(rows, dst)
    np.testing.assert_array_equal(dst, np.stack(rows))
    small = np.empty((16, 8), np.float32)
    cases = [([a[:8, 0].copy() for a in rows], small),      # under 1 MiB
             (rows[:15] + [rows[0].T.copy().T], dst),       # not C order
             (rows[:15] + [rows[0][:100]], dst),            # wrong shape
             (rows, np.empty((16, 128, 160), np.float64))]  # wrong dtype
    for src, out in cases:
        assert pt_rio.batch_assemble(src, out) is False
        assert ref_rio.batch_assemble(src, out) is False


def test_staging_arena_aligns_and_resets():
    arena = pt_rio.StagingArena(1 << 16)
    a = arena.alloc_array((3, 5), np.float32)
    b = arena.alloc_array((7,), np.int64)
    for arr in (a, b):
        assert arr.ctypes.data % 4096 == 0 and arr.flags.writeable
    assert arena.used() == 4096 + 7 * 8
    a[:] = 1.0
    b[:] = 2
    assert a.sum() == 15.0 and b.sum() == 14
    big = arena.alloc_array((1 << 16,), np.uint8)  # arena full: numpy's
    assert big.shape == (1 << 16,)
    arena.reset()
    assert arena.used() == 0
    arena.destroy()


def test_runtime_library_builds_into_the_port_build_dir():
    path = pt_build.lib_path()
    assert path is not None, pt_build.build_error()
    assert os.path.dirname(path) == BUILD_DIR
    assert os.path.basename(path).startswith("_ptrt_")
    assert pt_build.build_error() is None
    with open(os.path.join(os.path.dirname(pt_build.__file__),
                           "runtime.cc")) as f:
        ours = f.read()
    with open(os.path.join(os.path.dirname(ref_rio.__file__),
                           "runtime.cc")) as f:
        theirs = f.read()
    # the same C ABI and code below each file's header comment
    assert ours[ours.index("#include <atomic>"):] == \
        theirs[theirs.index("#include <atomic>"):]
