"""The port's file input path on the CPU, against the JAX package and
against the port's own ``per_step_feeds``:

- ``open_recordio_file`` and ``open_files`` -> ``batch`` give the JAX
  package's batches in order, with ``drop_last`` both ways and
  ``pass_num`` 2; 12 batches held at once keep their contents (the JAX
  package's native ``BatchReader`` reuses 4 staging arenas, so there a
  held batch is overwritten 4 batches later: its batches are copied as
  they come here, and the true batches are the truth);
- a tiny LM (2 layers, d_model 64, Adam) trained by ``run_loop`` over
  ``open_files -> batch -> double_buffer -> read_file`` and over a
  ``data_loader`` (2 workers, double-buffered) equals the port's
  ``run_loop`` with the same batches as ``per_step_feeds`` (bitwise) and
  the JAX package's (fp32: each window's loss within rtol 2e-5 + atol
  1e-6, tests/test_torch_run_loop.py's gate; the state after the first
  window within rtol 2e-5 + atol lr/10, see JAX_STATE_ATOL); the call
  after the last window raises ``EOFException``;
- ``DataFeeder.feed`` equals the JAX package's, and feeds a ``PyReader``;
  ``layers.load`` loads what ``save_vars`` wrote, read from disk once;
- ``double_buffer`` stages on the device of the Executor that pulls it,
  and an explicit ``CUDAPlace`` without a card raises.
"""
import os

import numpy as np
import pytest
from _torch_forkserver import start_with_both_loaders

torch = pytest.importorskip("torch")

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import io as pt_io  # noqa: E402
from paddle_tpu_torch import layers as pt_layers  # noqa: E402
from paddle_tpu_torch import optimizer as pt_optimizer  # noqa: E402
from paddle_tpu_torch.framework.interpreter import run_block  # noqa: E402
from paddle_tpu_torch.models import transformer as pt_T  # noqa: E402

V, L, NH, D, DI, B, T, LR, K = 128, 2, 4, 64, 128, 2, 16, 1e-3, 3
FP32_RTOL, FP32_ATOL = 2e-5, 1e-6
# the state against the JAX package's after the first window (3 Adam
# steps over 3 different batches): every element within lr/10,
# chip_smoke.py's parameter gate between two runs of the same steps. The
# token embedding table holds elements whose summed gradient is near
# zero, and the two packages add a token's per-position gradients in
# another order; Adam divides each by its own RMS, so such an element
# moves by a fraction of lr that those last bits set (2 of 8192 elements
# here by up to 5.2e-5; every other parameter within 3.1e-6 of the JAX
# package's). tests/test_torch_run_loop.py's lr/100 holds for 3 steps of
# one batch repeated.
JAX_STATE_ATOL = LR / 10


@pytest.fixture(scope="module", autouse=True)
def forkserver():
    start_with_both_loaders()


class Samples:
    """(x float32[3], y int64) samples, x filled with the sample's index."""

    def __init__(self, n):
        self.n = n

    def __call__(self):
        for i in range(self.n):
            yield (np.full((3,), i, np.float32), np.int64(i))


class TokenSamples:
    """Seeded (ids int64[T], labels int64[T]) samples of the tiny LM."""

    def __init__(self, n, seed=0):
        r = np.random.RandomState(seed)
        self.data = [(r.randint(0, V, T).astype(np.int64),
                      r.randint(0, V, T).astype(np.int64))
                     for _ in range(n)]

    def __call__(self):
        return iter(self.data)


def _next_all(holder, eof):
    out = []
    while True:
        try:
            b = holder.next()
        except eof:
            return out
        out.append({k: np.array(v) for k, v in b.items()})


def _batches(pkg, layers, files, bs, drop_last, pass_num, single):
    prog = pkg.Program()
    with pkg.program_guard(prog, pkg.Program()), pkg.unique_name.guard():
        if single:
            r = layers.open_recordio_file(files[0], [(3,), ()],
                                          ["float32", "int64"],
                                          pass_num=pass_num)
        else:
            r = layers.open_files(files, [(3,), ()], ["float32", "int64"],
                                  pass_num=pass_num)
        r = layers.batch(r, bs, drop_last=drop_last)
    holder = r._reader_holder
    holder.start()
    return [[b[n] for n in holder.var_names]
            for b in _next_all(holder, pkg.EOFException)]


@pytest.mark.parametrize("single, drop_last, pass_num", [
    (True, True, 1), (True, False, 2), (False, True, 2), (False, False, 1)])
def test_recordio_readers_give_the_reference_batches(tmp_path, single,
                                                     drop_last, pass_num):
    import paddle_tpu as fluid
    from paddle_tpu import layers as ref_layers

    files = [str(tmp_path / "a.rio"), str(tmp_path / "b.rio")]
    pt.recordio_convert(Samples(10), files[0], max_chunk_records=3)
    pt.recordio_convert(Samples(7), files[1], max_chunk_records=4)
    got = _batches(pt, pt_layers, files, 4, drop_last, pass_num, single)
    want = _batches(fluid, ref_layers, files, 4, drop_last, pass_num,
                    single)
    n = (10 if single else 17) * pass_num
    assert len(got) == (n // 4 if drop_last else -(-n // 4)) == len(want)
    for g, w in zip(got, want):
        for ga, wa in zip(g, w):
            assert ga.dtype == wa.dtype
            np.testing.assert_array_equal(ga, wa)


def _held_firsts(pkg, layers, path):
    """12 batches of 4 from ``path`` through open_files -> batch, all held
    at once: the first label of each, read after the 12th was pulled."""
    prog = pkg.Program()
    with pkg.program_guard(prog, pkg.Program()):
        r = layers.batch(layers.open_files(
            [path], [(3,), ()], ["float32", "int64"]), 4)
    holder = r._reader_holder
    holder.start()
    held = [holder.next() for _ in range(12)]
    x, y = holder.var_names
    for b in held:
        np.testing.assert_array_equal(np.asarray(b[x])[:, 0],
                                      np.asarray(b[y]))
    return [int(np.asarray(b[y])[0]) for b in held]


def test_held_batches_keep_their_contents(tmp_path):
    """The port's batches stay as handed out. The JAX package's native
    BatchReader (paddle_tpu/io/reader.py:268-316) assembles into 4
    rotating staging arenas and resets one when its turn comes again, so
    there batch i held reads batch 8 + i % 4 (a fault of the reference,
    not edited; ROADMAP queue 3)."""
    import paddle_tpu as fluid
    from paddle_tpu import layers as ref_layers
    from paddle_tpu.runtime.recordio import native_available

    path = str(tmp_path / "s.rio")
    pt.recordio_convert(Samples(64), path)
    assert _held_firsts(pt, pt_layers, path) == list(range(0, 48, 4))
    assert native_available()
    assert _held_firsts(fluid, ref_layers, path) == [32, 36, 40, 44] * 3


# ---------------------------------------------------------------------------
# through the executor: the tiny LM
# ---------------------------------------------------------------------------


def _lm(pkg, layers, optimizer, T_mod, reader_fn=None):
    prog, startup = pkg.Program(), pkg.Program()
    prog.random_seed = startup.random_seed = 3
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        if reader_fn is None:
            ids = layers.data(name="ids", shape=[B, T], dtype="int64",
                              append_batch_size=False)
            labels = layers.data(name="labels", shape=[B, T],
                                 dtype="int64", append_batch_size=False)
            reader = None
        else:
            reader = reader_fn()
            ids, labels = layers.read_file(reader)
        loss, _ = T_mod.transformer_lm(ids, labels, V, n_layer=L, n_head=NH,
                                       d_model=D, d_inner=DI, max_len=32)
        optimizer.Adam(learning_rate=LR).minimize(loss)
    return prog, startup, loss, reader


@pytest.fixture(scope="module")
def lm_state():
    """The port's startup state of the tiny LM, as numpy arrays."""
    prog, startup, _, _ = _lm(pt, pt_layers, pt_optimizer, pt_T)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    return {v.name: scope.find_var(v.name).numpy().copy()
            for v in prog.list_vars() if v.persistable}


def _port_scope(state):
    scope = pt.Scope()
    for n, v in pt_io.state_from_numpy(state, pt.CPUPlace()).items():
        scope.set_var(n, v)
    return scope


def _windows(samples):
    """The true batches, stacked into 2 windows of K steps each."""
    data = samples.data
    out = []
    for w in range(2):
        steps = [data[(w * K + s) * B:(w * K + s + 1) * B]
                 for s in range(K)]
        out.append({"ids": np.stack([[a for a, _ in st] for st in steps]),
                    "labels": np.stack([[b for _, b in st]
                                        for st in steps])})
    return out


def _per_step_run(state, windows):
    """The port's plain program over the windows as per_step_feeds:
    [(loss, {name: state})] after each window."""
    prog, _, loss, _ = _lm(pt, pt_layers, pt_optimizer, pt_T)
    scope = _port_scope(state)
    exe = pt.Executor(pt.CPUPlace())
    out = []
    for win in windows:
        got = exe.run_loop(prog, feed=win, fetch_list=[loss], steps=K,
                           scope=scope, per_step_feeds=["ids", "labels"])
        out.append((got[0], {n: scope.find_var(n).numpy().copy()
                             for n in state}))
    return out


@pytest.fixture(scope="module")
def references(lm_state):
    """The port's per_step_feeds run and the JAX package's, both over the
    true batches of TokenSamples(12)."""
    import jax

    import paddle_tpu as fluid
    from paddle_tpu import layers as ref_layers
    from paddle_tpu import optimizer as ref_optimizer
    from paddle_tpu.models import transformer as ref_T

    windows = _windows(TokenSamples(2 * K * B))
    prog, _, loss, _ = _lm(fluid, ref_layers, ref_optimizer, ref_T)
    scope = fluid.Scope()
    for n, v in lm_state.items():
        scope.set_var(n, jax.numpy.asarray(v))
    exe = fluid.Executor(fluid.CPUPlace())
    jax_out = []
    with fluid.scope_guard(scope):
        for win in windows:
            got = exe.run_loop(prog, feed=win, fetch_list=[loss], steps=K,
                               per_step_feeds=["ids", "labels"])
            jax_out.append((np.asarray(got[0]),
                            {n: np.asarray(scope.find_var(n))
                             for n in lm_state}))
    return {"port": _per_step_run(lm_state, windows), "jax": jax_out}


def _files_reader(files):
    def make():
        r = pt_layers.open_files(files, [(T,), (T,)], ["int64", "int64"])
        return pt_layers.double_buffer(pt_layers.batch(r, B))
    return make


def _loader_reader():
    r = pt_layers.data_loader(capacity=4, shapes=[(-1, T), (-1, T)],
                              dtypes=["int64", "int64"], num_workers=2,
                              use_double_buffer=True)
    r.decorate_sample_reader(TokenSamples(2 * K * B), batch_size=B)
    return r


@pytest.mark.parametrize("source", ["open_files", "data_loader"])
def test_run_loop_from_files_and_loader_equals_per_step_feeds(
        tmp_path, lm_state, references, source):
    if source == "open_files":
        files = [str(tmp_path / "a.rio"), str(tmp_path / "b.rio")]
        data = TokenSamples(2 * K * B).data
        pt.recordio_convert(lambda: iter(data[:5]), files[0],
                            max_chunk_records=2)
        pt.recordio_convert(lambda: iter(data[5:]), files[1])
        reader_fn = _files_reader(files)
    else:
        reader_fn = _loader_reader
    prog, _, loss, reader = _lm(pt, pt_layers, pt_optimizer, pt_T,
                                reader_fn)
    scope = _port_scope(lm_state)
    exe = pt.Executor(pt.CPUPlace())
    try:
        reader.start()
        got = []
        for _ in range(2):
            out = exe.run_loop(prog, fetch_list=[loss], steps=K, scope=scope)
            got.append((out[0], {n: scope.find_var(n).numpy().copy()
                                 for n in lm_state}))
        with pytest.raises(pt.EOFException):
            exe.run_loop(prog, fetch_list=[loss], steps=K, scope=scope)
        # the double buffer staged on this executor's device, the CPU
        assert reader._reader_holder._device() == torch.device("cpu")
    finally:
        if source == "data_loader":
            reader.close()
    for w, ((loss_g, st_g), (loss_p, st_p), (loss_j, st_j)) in enumerate(
            zip(got, references["port"], references["jax"])):
        np.testing.assert_array_equal(loss_g, loss_p)
        np.testing.assert_allclose(loss_g, loss_j, rtol=FP32_RTOL,
                                   atol=FP32_ATOL)
        for n in lm_state:
            np.testing.assert_array_equal(st_g[n], st_p[n], err_msg=n)
            if w == 0:
                np.testing.assert_allclose(st_g[n], st_j[n], rtol=FP32_RTOL,
                                           atol=JAX_STATE_ATOL, err_msg=n)


def test_run_loop_releases_loader_slots_once_stacked():
    """A data_loader read op without double_buffer: run_loop(3) windows
    with the prefetch on, over a ring of 2 slots a worker. The executor
    keeps no pulled batch once it has stacked the window, and the
    prefetched window only its stacked copy, so every batch rides the
    ring (a window held on through the next one's pull would fill a
    worker's slots, and its next batch would go by pickle)."""
    prog = pt.Program()
    with pt.program_guard(prog, pt.Program()):
        r = pt_layers.data_loader(capacity=4, shapes=[(-1, 3), (-1,)],
                                  dtypes=["float32", "int64"],
                                  num_workers=2)
        r.decorate_sample_reader(Samples(24), batch_size=2)
        x, _ = pt_layers.read_file(r)
        out = pt_layers.mean(x)
    exe = pt.Executor(pt.CPUPlace())
    try:
        r.start()
        got = [float(exe.run_loop(prog, fetch_list=[out], steps=3)[0])
               for _ in range(4)]
        with pytest.raises(pt.EOFException):
            exe.run_loop(prog, fetch_list=[out], steps=3)
        st = r._reader_holder.stats()
    finally:
        r.close()
    assert got == [4.5, 10.5, 16.5, 22.5]   # the last batch of each window
    assert (st["shm_batches"], st["pickle_batches"]) == (12, 0)


# ---------------------------------------------------------------------------
# DataFeeder, layers.load, double_buffer's device
# ---------------------------------------------------------------------------


def _feeder(pkg, layers, mod, pad_to=None):
    prog = pkg.Program()
    with pkg.program_guard(prog, pkg.Program()):
        x = layers.data(name="x", shape=[1], dtype="float32")
        s = layers.data(name="s", shape=[2], dtype="int64", lod_level=1)
    return mod.DataFeeder([x, s], program=prog, pad_to=pad_to)


@pytest.mark.parametrize("pad_to", [None, 6])
def test_data_feeder_equals_the_reference(pad_to):
    import paddle_tpu as fluid
    from paddle_tpu import data_feeder as ref_feeder
    from paddle_tpu import layers as ref_layers

    r = np.random.RandomState(4)
    minibatch = [(float(r.randn()), r.randint(0, 9, (int(n), 2)))
                 for n in (3, 1, 5, 2)]
    got = _feeder(pt, pt_layers, pt.data_feeder, pad_to).feed(minibatch)
    want = _feeder(fluid, ref_layers, ref_feeder, pad_to).feed(minibatch)
    assert sorted(got) == sorted(want) == ["s", "s.lens", "x"]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    feeder = _feeder(pt, pt_layers, pt.data_feeder, pad_to)
    with pytest.raises(ValueError, match="2 slots"):
        feeder.feed([(1.0,)])
    # decorate_reader: one feed per batch; split over the places
    feeder.place = pt.CPUPlace()
    feeds = list(feeder.decorate_reader(lambda: iter([minibatch] * 2),
                                        multi_devices=True)())
    assert len(feeds) == 2 and feeds[0]["x"].shape == (4, 1)
    feeds = list(feeder.decorate_reader(lambda: iter([minibatch]),
                                        multi_devices=True,
                                        num_places=3)())
    assert feeds[0]["x"].shape == (3, 1)
    # a PyReader whose batches the feeder assembles
    holder = pt.io.reader.PyReader(["x", "s"], None, None, feeder=feeder)
    holder.decorate_paddle_reader(lambda: iter([minibatch]))
    holder.start()
    b = holder.next()
    for k in want:
        np.testing.assert_array_equal(b[k], want[k])
    holder.reset()


@pytest.mark.parametrize("fp16", [False, True])
def test_layers_load_reads_what_save_vars_wrote(tmp_path, fp16):
    """layers.load gives what save_vars wrote, reads the file on its first
    run only, and gives the file's values again after a program wrote the
    loaded variable in place (a restore after training steps)."""
    import jax

    import paddle_tpu as fluid
    from paddle_tpu.io import save_vars

    value = np.random.RandomState(6).randn(3, 4).astype(np.float32)
    scope = fluid.Scope()
    scope.set_var("w", jax.numpy.asarray(value))
    save_vars(fluid.Executor(fluid.CPUPlace()), str(tmp_path), vars=["w"],
              scope=scope)
    path = str(tmp_path / "w.npy")
    dtype = "float16" if fp16 else "float32"
    prog, overwrite = pt.Program(), pt.Program()
    with pt.program_guard(prog, pt.Program()):
        out = prog.global_block().create_var(
            name="w", shape=(3, 4), dtype="float32", persistable=True)
        pt_layers.load(out, path, load_as_fp16=fp16)
    with pt.program_guard(overwrite, pt.Program()):
        w = overwrite.global_block().create_var(
            name="w", shape=(3, 4), dtype=dtype, persistable=True)
        pt_layers.fill_constant((3, 4), dtype, 7.0, out=w)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    got, = exe.run(prog, fetch_list=[out], scope=scope)
    want = value.astype(np.float16) if fp16 else value
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    os.remove(path)  # read once, on the op's first run: no file needed now
    exe.run(overwrite, scope=scope)
    np.testing.assert_array_equal(scope.find_var("w").numpy(),
                                  np.full((3, 4), 7.0, want.dtype))
    again, = exe.run(prog, fetch_list=[out], scope=scope)
    np.testing.assert_array_equal(again, want)
    np.testing.assert_array_equal(scope.find_var("w").numpy(), want)
    # the op's own output, written in place, leaves the next run's alone
    cpu = torch.device("cpu")
    run_block(prog.global_block(), {}, cpu)["w"].fill_(7.0)
    np.testing.assert_array_equal(
        run_block(prog.global_block(), {}, cpu)["w"].numpy(), want)


def test_double_buffer_stages_on_the_pulling_executors_device(
        monkeypatch):
    def source():
        for i in range(3):
            yield (np.full((2, 3), i, np.float32),)

    def staged_reader(place=None):
        prog = pt.Program()
        with pt.program_guard(prog, pt.Program()):
            r = pt_layers.py_reader(capacity=2, shapes=[(2, 3)],
                                    dtypes=["float32"],
                                    use_double_buffer=False)
            r.decorate_tensor_provider(source)
            db = pt_layers.double_buffer(r, place=place)
            x, = pt_layers.read_file(db)
            out = pt_layers.mean(x)
        return prog, db, out

    prog, db, out = staged_reader()
    db.start()
    with pytest.raises(RuntimeError, match="no place"):
        db._reader_holder.next()   # no executor has pulled it yet
    exe = pt.Executor(pt.CPUPlace())
    got = [float(exe.run(prog, fetch_list=[out])[0]) for _ in range(3)]
    assert got == [0.0, 1.0, 2.0]
    assert db._reader_holder._device() == torch.device("cpu")
    with pytest.raises(pt.EOFException):
        exe.run(prog, fetch_list=[out])
    # an explicit CUDAPlace without a card raises, and never stages on
    # the CPU instead
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, db, _ = staged_reader(place=pt.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        db.start()
    with pytest.raises(RuntimeError, match="CUDA"):
        db._reader_holder.next()
