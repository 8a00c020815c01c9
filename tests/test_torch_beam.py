"""Beam search in the port (paddle_tpu_torch/ops/decode.py,
``cache_gather``, DecodePredictor.generate_beam) against the JAX package,
on the CPU.

- the beam ops at 1e-5 abs / 2e-5 rel (ids and parents exactly), through
  the layer functions and the registry: ``beam_search`` (finished beams
  propose only end_id), ``beam_search_decode`` (with and without
  scores), ``beam_gather`` (both row layouts) and ``cache_gather``;
- ``generate_beam``: ids, lengths and scores (1e-5) equal to the JAX
  package's, with and without ``eos_id``, at a beam batch padded to a
  power of two; ``beam_size=1`` equals greedy; the slabs are reordered in
  the decode step's own buffers.

Inputs are drawn without exact ties: ``lax.top_k`` keeps the lower index
on a tie and ``torch.topk`` promises no order on the card.

Model: 2 layers, d_model 64, 4 heads of 16, vocab 128, max_len 64,
weights drawn with numpy."""
import numpy as np
import pytest
from _jax_metrics import jax_metrics_untouched

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import paddle_tpu as fluid  # noqa: E402
from paddle_tpu.ops import decode as jax_dec  # noqa: E402
from paddle_tpu.ops.registry import get_kernel as jax_kernel  # noqa: E402
from paddle_tpu.serving import decode as jax_decode  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.ops import decode as pt_dec  # noqa: E402
from paddle_tpu_torch.ops.registry import get_kernel  # noqa: E402
from paddle_tpu_torch.serving import decode as pt_decode  # noqa: E402

TOL = dict(atol=1e-5, rtol=2e-5)
V, L, NH, D, DI, ML = 128, 2, 4, 64, 128, 64


def _run(pkg, build, feeds):
    """Build one program with ``build(layers, data)`` in ``pkg`` (either
    package's module) and run it on ``feeds`` on the CPU."""
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup):
        with pkg.unique_name.guard():
            def data(name):
                a = feeds[name]
                return pkg.layers.data(name=name, shape=list(a.shape),
                                       dtype=str(a.dtype),
                                       append_batch_size=False)
            outs = build(pkg.layers, data)
    exe = pkg.Executor(pkg.CPUPlace())
    got = exe.run(prog, feed={k: v.copy() for k, v in feeds.items()},
                  fetch_list=list(outs))
    return [np.asarray(g) for g in got]


def _both(build, feeds):
    with jax_metrics_untouched():
        want = _run(fluid, build, feeds)
    return _run(pt, build, feeds), want


def _beam_feeds(with_ids):
    rng = np.random.default_rng(0)
    b, k, v = 2, 3, 10
    feeds = {"pre_ids": np.array([[4, 2, 7], [2, 5, 1]], np.int32),
             "pre_scores": rng.standard_normal((b, k)).astype(np.float32),
             "scores": rng.standard_normal((b, k, v)).astype(np.float32)}
    if with_ids:
        feeds["ids"] = rng.permutation(b * k * v).reshape(b, k, v).astype(
            np.int32)
    return feeds


@pytest.mark.parametrize("with_ids", [False, True])
def test_beam_search_matches_jax(with_ids):
    """Beams whose last id is end_id (2 here) only propose end_id again,
    with their score."""
    feeds = _beam_feeds(with_ids)
    got, want = _both(lambda lay, data: list(lay.beam_search(
        data("pre_ids"), data("pre_scores"),
        data("ids") if with_ids else None, data("scores"), 3, 2)), feeds)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **TOL)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("with_scores", [False, True])
def test_beam_search_decode_matches_jax(with_scores):
    rng = np.random.default_rng(1)
    s, b, k = 6, 2, 3
    ids = rng.integers(0, 9, (s, b, k)).astype(np.int32)
    ids[3, 0, 1] = 8                                  # an end_id mid-way
    feeds = {"ids": ids,
             "parents": rng.integers(0, k, (s, b, k)).astype(np.int32),
             "scores": rng.standard_normal((s, b, k)).astype(np.float32)}
    got, want = _both(lambda lay, data: list(lay.beam_search_decode(
        data("ids"), data("scores") if with_scores else None, end_id=8,
        parent_idx=data("parents"))), feeds)
    np.testing.assert_array_equal(got[0], want[0])
    if with_scores:
        np.testing.assert_allclose(got[1], want[1], **TOL)
    else:
        np.testing.assert_array_equal(got[1], want[1])


class _Ctx:
    """What a kernel reads of its op: inputs by slot, attrs."""

    def __init__(self, inputs, attrs=None):
        self.inputs, self.attrs = inputs, attrs or {}

    def input(self, slot, default=None):
        return self.inputs.get(slot, default)

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


@pytest.mark.parametrize("flat", [True, False])
def test_beam_gather_and_cache_gather_match_jax(flat):
    rng = np.random.default_rng(2)
    b, k = 2, 3
    x = rng.standard_normal((b * k, 4, 5) if flat else (b, k, 4, 5)).astype(
        np.float32)
    parent = np.array([[2, 2, 0], [1, 0, 1]], np.int32)
    got = get_kernel("beam_gather")(_Ctx({
        "X": torch.from_numpy(x), "Parent": torch.from_numpy(parent)}))
    want = jax_kernel("beam_gather")(_Ctx({
        "X": jnp.asarray(x), "Parent": jnp.asarray(parent)}))
    np.testing.assert_array_equal(got["Out"].numpy(), np.asarray(want["Out"]))
    feeds = {"cache": rng.standard_normal((4, 6, 2, 8)).astype(np.float32),
             "index": np.array([3, 3, 0, 1, 2, 2], np.int32)}
    got, want = _both(lambda lay, data: [lay.cache_gather(
        data("cache"), data("index"))], feeds)
    np.testing.assert_array_equal(got[0], want[0])


def test_beam_search_step_matches_jax_with_finished_beams():
    rng = np.random.default_rng(3)
    b, k, v = 3, 4, 16
    pre_ids = rng.integers(0, v, (b, k)).astype(np.int32)
    pre_ids[0, 2] = pre_ids[2, :] = 5                 # end_id 5
    pre_scores = rng.standard_normal((b, k)).astype(np.float32)
    scores = rng.standard_normal((b, k, v)).astype(np.float32)
    got = pt_dec.beam_search_step(torch.from_numpy(pre_ids),
                                  torch.from_numpy(pre_scores),
                                  torch.from_numpy(scores), None, k, 5)
    want = jax_dec.beam_search_step(jnp.asarray(pre_ids),
                                    jnp.asarray(pre_scores),
                                    jnp.asarray(scores), None, k, 5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # a row of finished beams keeps them, scores unchanged
    np.testing.assert_array_equal(got[0][2].numpy(), [5] * k)


# -- generate_beam ------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("beam_lm"))
    cfg = pt_decode.DecodeConfig(vocab_size=V, n_layer=L, n_head=NH,
                                 d_model=D, d_inner=DI, max_len=ML)
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        with pt.unique_name.guard():
            pt_decode._prefill_graph(cfg, 1, 16)
    rng = np.random.default_rng(11)
    scope = pt.Scope()
    for op in startup.global_block().ops:
        name, shape = op.output("Out")[0], tuple(op.attr("shape"))
        if op.type == "gaussian_random":
            val = rng.standard_normal(shape).astype(np.float32) * 0.1
        else:
            val = np.full(shape, op.attr("value"), np.float32)
        scope.set_var(name, val)
    pt_decode.save_decode_model(d, cfg, None, scope=scope)
    return d


@pytest.fixture(scope="module")
def preds(model_dir):
    return (pt_decode.DecodePredictor(model_dir, place=pt.CPUPlace()),
            jax_decode.DecodePredictor(model_dir, aot_cache=False))


PROMPTS = [np.array([5, 17, 99, 3, 42], np.int64),
           np.array([64, 8, 120, 33, 7, 90, 11, 2, 71], np.int64)]


def test_generate_beam_matches_jax(preds):
    """Two prompts, beam 3: a beam batch of 6 padded to 8; then with an
    eos_id taken from the first run's beams, so some beams finish."""
    pred, jpred = preds
    n = 8
    got = pred.generate_beam(PROMPTS, n, beam_size=3, return_all=True)
    with jax_metrics_untouched():
        want = jpred.generate_beam(PROMPTS, n, beam_size=3,
                                   return_all=True)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), **TOL)
    # scores best first
    assert np.all(np.diff(got[2], axis=1) <= 0)
    eos = int(got[0][0, 1, 3])
    best = pred.generate(PROMPTS, n, strategy="beam", beam_size=3,
                         eos_id=eos)
    eos_all = pred.generate_beam(PROMPTS, n, beam_size=3, eos_id=eos,
                                 return_all=True)
    with jax_metrics_untouched():
        jbest = jpred.generate(PROMPTS, n, strategy="beam", beam_size=3,
                               eos_id=eos)
        jall = jpred.generate_beam(PROMPTS, n, beam_size=3, eos_id=eos,
                                   return_all=True)
    for g, w in zip(best, jbest):
        np.testing.assert_array_equal(g, np.asarray(w, np.int64))
    np.testing.assert_array_equal(eos_all[0], np.asarray(jall[0]))
    np.testing.assert_array_equal(eos_all[1], np.asarray(jall[1]))
    np.testing.assert_allclose(eos_all[2], np.asarray(jall[2]), **TOL)
    assert (eos_all[1] < eos_all[0].shape[2]).any()


def test_beam_size_one_is_greedy(preds):
    pred, _jpred = preds
    got = pred.generate(PROMPTS, 10, strategy="beam", beam_size=1)
    for g, w in zip(got, pred.generate(PROMPTS, 10)):
        np.testing.assert_array_equal(g, w)


def test_beam_reorders_the_decode_steps_own_slabs(preds):
    """The beam's decode step ("logits", batch 8) keeps its slab tensors
    across a call: reordering copies into them, never replaces them."""
    pred, _jpred = preds
    pred.generate_beam(PROMPTS, 3, beam_size=3)
    step, _ = pred.acquire("decode", 8, 16, "logits")
    ptrs = [t.data_ptr() for t in pred._slabs(step)]
    pred.generate_beam(PROMPTS, 3, beam_size=3)
    assert [t.data_ptr() for t in pred._slabs(step)] == ptrs
