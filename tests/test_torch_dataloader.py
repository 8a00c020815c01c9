"""The port's multiprocess DataLoader (paddle_tpu_torch/io/dataloader.py)
against the JAX package's, on the CPU: the cases of
tests/test_dataloader.py, merged as parametrised cases where they repeat
each other, plus the port's own guarantees.

- Batches equal the JAX package's DataLoader's (its inline mode, which
  composes batches exactly as its workers do) in order across 3 epochs,
  for sample, paddle-batch and tensor sources; unordered delivery gives
  every batch; ``state_dict`` resume lands on the same sample.
- Transport is decided by what the consumer holds, never by timing: a
  consumer that keeps one batch while it asks for the next gets every
  batch through shared memory; one that holds every batch it got (12,
  over a ring of 4) keeps their contents, 4 in shared memory and 8 by
  pickle, on any load. No sleep, no retry.
- A mapper error is re-raised (sticky until reset), a dead worker is
  named with its exit code, ``close()`` ends the workers and unlinks the
  shared memory.

Sources and mappers are module-level classes: the forkserver start
method pickles them into the workers.
"""
import os

import numpy as np
import pytest
from _torch_forkserver import start_with_both_loaders

torch = pytest.importorskip("torch")

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.io.dataloader import DataLoader  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def forkserver():
    start_with_both_loaders()


class SampleSrc:
    """Yields (feature, label) samples with deterministic contents."""

    def __init__(self, n, d=3):
        self.n, self.d = n, d

    def __call__(self):
        for i in range(self.n):
            yield (np.full((self.d,), i, np.float32), np.int64(i))


class TensorSrc:
    def __init__(self, n, shape=(2, 3)):
        self.n, self.shape = n, shape

    def __call__(self):
        for i in range(self.n):
            yield (np.full(self.shape, i, np.float32),)


class PaddleBatchSrc:
    """paddle.batch convention: yields lists of per-sample tuples."""

    def __init__(self, n_batches, bs=4):
        self.n_batches, self.bs = n_batches, bs

    def __call__(self):
        for b in range(self.n_batches):
            yield [(np.full((2,), b * self.bs + i, np.float64), int(i))
                   for i in range(self.bs)]


class ObjectSrc:
    def __call__(self):
        for i in range(3):
            yield (np.array(["s%d" % i, None], dtype=object),)


class RaisingSrc:
    """Yields a few good samples, then raises."""

    def __init__(self, good=4):
        self.good = good

    def __call__(self):
        for i in range(self.good):
            yield (np.full((3,), i, np.float32),)
        raise ValueError("decode exploded mid-epoch")


class DyingSrc:
    """A worker that dies hard, with no message."""

    def __call__(self):
        yield (np.ones(3, np.float32),)
        os._exit(23)


class SlowFirstMapper:
    """Delays the FIRST batch's samples so ordered mode must reorder."""

    def __call__(self, s):
        import time

        if float(s[0][0]) < 4:  # first batch of 4
            time.sleep(0.05)
        return s


def _drain(dl):
    from paddle_tpu.io.reader import EOFException as RefEOF

    out = []
    while True:
        try:
            out.append(dl.next())
        except (pt.EOFException, RefEOF):
            return out


def _copies(batches):
    return [{k: np.array(v) for k, v in b.items()} for b in batches]


SOURCES = {
    "sample": (["x", "y"], [[-1, 3], [-1]], ["float32", "int64"],
               "decorate_sample_reader", (SampleSrc(23),),
               {"batch_size": 4, "drop_last": False}),
    "paddle": (["a", "b"], [[-1, 2], [-1]], ["float32", "int64"],
               "decorate_paddle_reader", (PaddleBatchSrc(5),), {}),
    "tensor": (["x"], None, None, "decorate_tensor_provider",
               (TensorSrc(7),), {}),
}


def _loader(cls, kind, **kw):
    names, shapes, dtypes, deco, args, dkw = SOURCES[kind]
    dl = cls(names, shapes, dtypes, **kw)
    getattr(dl, deco)(*args, **dkw)
    return dl


def _reference_epochs(kind, epochs):
    """The JAX package's DataLoader, inline (its workers' composition)."""
    from paddle_tpu.io.dataloader import DataLoader as RefLoader

    ref = _loader(RefLoader, kind, num_workers=0)
    try:
        out = []
        for _ in range(epochs):
            ref.start()
            out.append(_copies(_drain(ref)))
        return out
    finally:
        ref.close()


@pytest.mark.parametrize("kind", ["sample", "paddle", "tensor"])
def test_ordered_batches_equal_the_reference_across_epochs(kind):
    want = _reference_epochs(kind, 3)
    dl = _loader(DataLoader, kind, num_workers=2, capacity=4)
    try:
        for epoch in range(3):
            dl.start()
            got = []
            while True:  # one batch held while the next is asked for
                try:
                    b = dl.next()
                except pt.EOFException:
                    break
                got.append({k: np.array(v) for k, v in b.items()})
            assert len(got) == len(want[epoch])
            for g, w in zip(got, want[epoch]):
                assert sorted(g) == sorted(w)
                for k in w:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k])
        # the design's guarantee, on any load: the ring never ran dry
        st = dl.stats()
        assert st["shm_batches"] == st["batches"] and \
            st["pickle_batches"] == 0
    finally:
        dl.close()


def test_held_batches_keep_their_contents_on_any_load():
    dl = DataLoader(["x", "y"], None, None, num_workers=2, capacity=4)
    dl.decorate_sample_reader(SampleSrc(48), batch_size=4)
    try:
        dl.start()
        held = _drain(dl)
        assert len(held) == 12
        for i, b in enumerate(held):
            np.testing.assert_array_equal(b["y"], np.arange(4 * i,
                                                            4 * i + 4))
            np.testing.assert_array_equal(b["x"][:, 0], b["y"])
        # every slot of a worker held when its next batch is due: that
        # batch goes by pickle, the first 4 (the ring) by shared memory
        st = dl.stats()
        assert (st["shm_batches"], st["pickle_batches"]) == (4, 8)
        del held, b
        # the slots came back: the next epoch runs in the ring again
        dl.start()
        assert len(_drain(dl)) == 12
        assert dl.stats()["shm_batches"] == 8
    finally:
        dl.close()


def test_ordered_reorders_skewed_workers():
    dl = DataLoader(["x", "y"], None, None, num_workers=2)
    dl.decorate_sample_reader(SampleSrc(24), batch_size=4,
                              mapper=SlowFirstMapper())
    try:
        dl.start()
        got = [b["x"][0, 0] for b in _drain(dl)]
        assert got == [0.0, 4.0, 8.0, 12.0, 16.0, 20.0]
    finally:
        dl.close()


def test_unordered_delivers_every_batch():
    dl = DataLoader(["x"], None, None, num_workers=3, ordered=False)
    dl.decorate_tensor_provider(TensorSrc(9))
    try:
        dl.start()
        vals = sorted(float(b["x"][0, 0]) for b in _drain(dl))
        assert vals == [float(i) for i in range(9)]
    finally:
        dl.close()


@pytest.mark.parametrize("case", ["view", "object", "outgrown"])
def test_zero_copy_and_pickle_transport(case):
    if case == "view":
        dl = DataLoader(["x"], None, None, num_workers=2)
        dl.decorate_tensor_provider(TensorSrc(4))
    elif case == "object":
        dl = DataLoader(["s"], None, None, num_workers=2)
        dl.decorate_tensor_provider(ObjectSrc())
    else:
        dl = DataLoader(["x"], None, None, num_workers=2, slot_bytes=64)
        dl.decorate_tensor_provider(TensorSrc(4, shape=(32, 32)))
    before = obs.LOADER_BATCHES.value(loader=dl._obs_name,
                                      transport="pickle")
    try:
        dl.start()
        got = _drain(dl)
        st = dl.stats()
        if case == "view":
            assert st["shm_batches"] == 4 and st["pickle_batches"] == 0
            # a view over the shared-memory ring, no copy
            x = got[0]["x"]
            lo = np.frombuffer(dl._shm.buf, np.uint8).ctypes.data
            assert lo <= x.ctypes.data < lo + dl.capacity * dl.slot_bytes
            assert not x.flags.owndata
            np.testing.assert_array_equal(torch.from_numpy(x).numpy(), x)
        elif case == "object":
            assert len(got) == 3 and got[0]["s"][0] == "s0"
            assert st["pickle_batches"] == 3
        else:
            assert len(got) == 4 and st["pickle_batches"] == 4
        assert obs.LOADER_BATCHES.value(
            loader=dl._obs_name, transport="pickle") - before == \
            st["pickle_batches"]
    finally:
        dl.close()


def test_worker_exception_propagates_not_hangs():
    dl = DataLoader(["x"], None, None, num_workers=2)
    dl.decorate_sample_reader(RaisingSrc(), batch_size=2)
    try:
        dl.start()
        with pytest.raises(ValueError, match="decode exploded"):
            for _ in range(100):
                dl.next()
        with pytest.raises(ValueError):  # sticky until reset()
            dl.next()
        dl.reset()
        dl.decorate_sample_reader(SampleSrc(4), batch_size=2)
        dl.start()
        assert len(_drain(dl)) == 2  # recovered after reset
    finally:
        dl.close()


def test_worker_hard_death_raises_runtime_error():
    dl = DataLoader(["x"], None, None, num_workers=2)
    dl.decorate_sample_reader(DyingSrc(), batch_size=1)
    try:
        dl.start()
        with pytest.raises(RuntimeError, match=r"died unexpectedly "
                                                r"\(exit code 23\)"):
            for _ in range(100):
                dl.next()
    finally:
        dl.close()


def test_inline_mode_num_workers_zero():
    dl = DataLoader(["x", "y"], None, None, num_workers=0)
    dl.decorate_sample_reader(SampleSrc(8), batch_size=4)
    try:
        dl.start()
        assert [b["x"][0, 0] for b in _drain(dl)] == [0.0, 4.0]
        with pytest.raises(pt.EOFException):
            dl.next()  # stays exhausted until start()/reset()
        for _epoch in range(2):
            dl.start()
            assert [b["x"][0, 0] for b in _drain(dl)] == [0.0, 4.0]
        assert dl.stats()["batches"] == 6
    finally:
        dl.close()


def test_iterator_mode_feeds_executor_run():
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        x = pt.layers.data(name="x", shape=[3])
        out = pt.layers.mean(x)
    exe = pt.Executor(pt.CPUPlace())
    dl = DataLoader(["x", "y"], [[-1, 3], [-1, 1]], ["float32", "int64"],
                    num_workers=2)
    dl.decorate_sample_reader(SampleSrc(12), batch_size=4)
    try:
        for _epoch in range(2):  # __iter__ resets itself between epochs
            firsts = []
            for feed in dl:
                ov, = exe.run(prog, feed={"x": feed["x"]},
                              fetch_list=[out])
                firsts.append(float(ov))
            assert firsts == [1.5, 5.5, 9.5]
    finally:
        dl.close()


def test_close_releases_children_and_unlinks_shared_memory():
    import multiprocessing as mp
    from multiprocessing import shared_memory

    before = {p.pid for p in mp.active_children()}
    dl = DataLoader(["x"], None, None, num_workers=2)
    dl.decorate_tensor_provider(TensorSrc(64))
    dl.start()
    first = dl.next()
    name = dl._shm.name
    dl.close()
    dl.close()
    assert {p.pid for p in mp.active_children()} - before == set()
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)
    np.testing.assert_array_equal(first["x"], np.zeros((2, 3)))  # mapped
    with pytest.raises(RuntimeError):
        dl.start()  # closed loaders refuse to restart


def _make_resumable(num_workers, n=20, bs=4):
    dl = DataLoader(["x", "y"], shapes=[[3], []],
                    dtypes=["float32", "int64"], num_workers=num_workers)
    dl.decorate_sample_reader(SampleSrc(n), batch_size=bs)
    return dl


def _flat(batches):
    return [int(v) for b in batches for v in np.asarray(b["y"]).ravel()]


@pytest.mark.parametrize("workers", [0, 2])
def test_state_dict_resume_is_sample_exact(workers):
    """Consume part of an epoch, capture state, resume a FRESH loader:
    the remainder and the next epoch equal an uninterrupted run."""
    full = _flat(_reference_epochs("sample", 1)[0][:5])  # 20 samples
    assert full == list(range(20))
    part = _make_resumable(workers)
    try:
        part.start()
        consumed = [part.next() for _ in range(2)]
        state = part.state_dict()
        assert state == {"v": 1, "epoch": 0, "offset": 2, "ordered": True}
        consumed = _flat(consumed)
    finally:
        part.close()
    resumed = _make_resumable(workers)
    try:
        resumed.load_state_dict(state)
        resumed.start()
        rest = _flat(_drain(resumed))
        resumed.start()  # the next epoch after a resume is a FULL epoch
        nxt = _flat(_drain(resumed))
        assert resumed.state_dict()["epoch"] == 2
    finally:
        resumed.close()
    assert consumed + rest == full and nxt == full


def test_state_dict_epoch_boundary_and_guards():
    dl = _make_resumable(0)
    try:
        dl.start()
        _drain(dl)
        st = dl.state_dict()
        assert st["epoch"] == 1 and st["offset"] == 0
        dl.start()
        with pytest.raises(RuntimeError, match="running"):
            dl.load_state_dict({"v": 1, "epoch": 0, "offset": 1})
        dl.next()
        with pytest.raises(RuntimeError, match="running"):
            dl.load_state_dict({"v": 1, "epoch": 0, "offset": 1})
        dl.reset()
        dl.load_state_dict({"v": 1, "epoch": 0, "offset": 1})  # ok now
        with pytest.raises(ValueError):
            dl.load_state_dict({"bogus": True})
    finally:
        dl.close()
    dl2 = DataLoader(["x"], None, None, num_workers=0, ordered=False)
    dl2.decorate_tensor_provider(TensorSrc(8))
    with pytest.raises(ValueError, match="ordered=True"):
        dl2.load_state_dict({"v": 1, "epoch": 0, "offset": 3})
    dl2.load_state_dict({"v": 1, "epoch": 0, "offset": 0})  # 0 is fine
    dl2.close()
