"""Speculative decoding in the port (paddle_tpu_torch/ops/speculative.py,
models/transformer.py's verify window, DecodePredictor.generate_speculative
and DecodeServer(speculative=True)) against the JAX package, on the CPU,
where every kernel runs its plain version.

- the three window ops at 1e-5 abs / 2e-5 rel (the JAX package's gate for
  its padded path), through the layer functions and the registry:
  ``cache_append_window`` with rows past the slab's end (dropped, never
  clipped), ``decode_attention_window`` (T = 1 equal to
  ``decode_attention``), ``spec_accept``;
- ``transformer_lm_verify`` as a program: the port's verify step and the
  JAX package's executable on the same feeds and slabs;
- ``generate_speculative`` equal token for token to the JAX package's
  and to plain greedy, with and without ``eos_id``, on a random export
  and on one whose second layer is an identity (its ``out`` and ``fc2``
  zeroed: the one-layer draft then agrees with the target, so rounds
  accept several proposals);
- the draft and verify steps capture over the decode step's own slabs
  (same ``data_ptr``), and the speculative server is lossless.

Model: 2 layers, d_model 64, 4 heads of 16, vocab 128, max_len 64,
weights drawn with numpy."""
import json

import numpy as np
import pytest
from _jax_metrics import jax_metrics_untouched

torch = pytest.importorskip("torch")

import paddle_tpu as fluid  # noqa: E402
from paddle_tpu.ops import kv_cache as jax_kv  # noqa: E402
from paddle_tpu.serving import decode as jax_decode  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.ops import kv_cache as pt_kv  # noqa: E402
from paddle_tpu_torch.serving import decode as pt_decode  # noqa: E402

TOL = dict(atol=1e-5, rtol=2e-5)
V, L, NH, D, DI, ML = 128, 2, 4, 64, 128, 64
SPEC_K = 3


def _export(d, identity_layer1=False):
    cfg = pt_decode.DecodeConfig(vocab_size=V, n_layer=L, n_head=NH,
                                 d_model=D, d_inner=DI, max_len=ML)
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        with pt.unique_name.guard():
            pt_decode._prefill_graph(cfg, 1, 16)
    rng = np.random.default_rng(3)
    scope = pt.Scope()
    for op in startup.global_block().ops:
        name, shape = op.output("Out")[0], tuple(op.attr("shape"))
        if op.type == "gaussian_random":
            val = rng.standard_normal(shape).astype(np.float32) * 0.1
        else:
            val = np.full(shape, op.attr("value"), np.float32)
        if identity_layer1 and name.startswith(("lm.l1.self.out.",
                                                "lm.l1.ffn.fc2.")):
            val = np.zeros(shape, np.float32)
        scope.set_var(name, val)
    pt_decode.save_decode_model(d, cfg, None, scope=scope)
    return d


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {"random": _export(str(tmp_path_factory.mktemp("spec_rand"))),
            "identity": _export(str(tmp_path_factory.mktemp("spec_id")),
                                identity_layer1=True)}


@pytest.fixture(scope="module")
def preds(dirs):
    return {k: pt_decode.DecodePredictor(d, place=pt.CPUPlace(),
                                         draft_n_layer=1)
            for k, d in dirs.items()}


@pytest.fixture(scope="module")
def jax_preds(dirs):
    return {k: jax_decode.DecodePredictor(d, aot_cache=False,
                                          draft_n_layer=1)
            for k, d in dirs.items()}


def _prompts(n, seed, lo=3, hi=12):
    r = np.random.RandomState(seed)
    return [r.randint(1, V, r.randint(lo, hi + 1)).astype(np.int64)
            for _ in range(n)]


# -- the ops, through their layer functions and the registry ----------------

def _run(pkg, build, feeds):
    """Build one program with ``build(layers, data)`` in ``pkg`` (either
    package's module) and run it on ``feeds`` on the CPU; returns the
    fetches as numpy arrays."""
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


def _slab(rng, b, s):
    return rng.standard_normal((b, s, 2, 8)).astype(np.float32)


def test_cache_append_window_drops_rows_past_the_slab():
    """Rows past S-1 are dropped, never clipped onto row S-1: a slot at
    S-2 keeps its row S-1 from the window's second row, a slot at S has
    nothing written, one in the middle gets all T rows."""
    rng = np.random.default_rng(0)
    s, t = 12, 4
    feeds = {"cache": _slab(rng, 4, s),
             "new": rng.standard_normal((4, t, 2, 8)).astype(np.float32),
             "pos": np.array([0, 5, s - 2, s], np.int32)}
    got, want = _both(lambda lay, data: [lay.cache_append_window(
        data("cache"), data("new"), data("pos"))], feeds)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0][2, s - 1], feeds["new"][2, 1])
    np.testing.assert_array_equal(got[0][3], feeds["cache"][3])
    # the port writes the slab in place: the op returns the same tensor
    cache = torch.from_numpy(feeds["cache"].copy())
    from paddle_tpu_torch.ops.speculative import cache_append_window

    out = cache_append_window(cache, torch.from_numpy(feeds["new"]),
                              torch.from_numpy(feeds["pos"]))
    assert out.data_ptr() == cache.data_ptr()
    np.testing.assert_array_equal(out.numpy(), want[0])


@pytest.mark.parametrize("t", [1, 4])
def test_decode_attention_window_matches_jax(t):
    rng = np.random.default_rng(1)
    feeds = {"q": rng.standard_normal((3, t, 2, 8)).astype(np.float32),
             "k": _slab(rng, 3, 16), "v": _slab(rng, 3, 16),
             "lens": np.array([0, 7, 16 - t], np.int32)}
    got, want = _both(lambda lay, data: [lay.decode_attention_window(
        data("q"), data("k"), data("v"), data("lens"))], feeds)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    if t == 1:
        # the window of one query is decode_attention over lengths + 1
        one = pt_kv.decode_attention_plain(
            *(torch.from_numpy(feeds[n]) for n in ("q", "k", "v")),
            torch.from_numpy(feeds["lens"] + 1))
        np.testing.assert_allclose(got[0], one.numpy(), **TOL)
        ref = np.asarray(jax_kv.decode_attention_reference(
            feeds["q"], feeds["k"], feeds["v"], feeds["lens"] + 1))
        np.testing.assert_allclose(got[0], ref, **TOL)


def test_spec_accept_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 5, 11)).astype(np.float32)
    arg = logits.argmax(-1)
    proposed = rng.integers(0, 11, (4, 5)).astype(np.int64)
    proposed[0, 1:] = arg[0, :-1]            # all accepted
    proposed[1, 1:3] = arg[1, :2]            # two, then a miss
    proposed[1, 3] = (arg[1, 2] + 1) % 11
    proposed[2, 1] = (arg[2, 0] + 1) % 11    # none
    feeds = {"proposed": proposed, "logits": logits}
    got, want = _both(lambda lay, data: list(lay.spec_accept(
        data("proposed"), data("logits"))), feeds)
    np.testing.assert_array_equal(got[0], np.asarray(want[0], np.int64))
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1][0] == 4 and got[1][1] == 2 and got[1][2] == 0


# -- the verify window as a program -----------------------------------------

def test_verify_step_matches_jax(preds, jax_preds):
    """The port's verify step (eager on the CPU) and the JAX package's
    executable on the same feeds: next ids, accept, last logits and every
    updated slab."""
    pred, jpred = preds["random"], jax_preds["random"]
    b, s, t = 2, 32, SPEC_K + 1
    rng = np.random.default_rng(4)
    feeds = {"tokens": rng.integers(0, V, (b, t)).astype(np.int64),
             "positions": np.array([[5, 6, 7, 8], [29, 30, 31, 32]],
                                   np.int64),
             "lengths": np.array([5, 29], np.int32),
             "last_idx": np.array([3, 1], np.int32)}
    for i in range(L):
        for kv in ("kcache", "vcache"):
            feeds["%s_%d" % (kv, i)] = rng.standard_normal(
                (b, s, NH, D // NH)).astype(np.float32)
    with jax_metrics_untouched():
        jexe, names = jpred.acquire("verify", b, s, window=t)
        want = [np.asarray(o) for o in jexe(dict(feeds), jpred._state)]
    step, pnames = pred.acquire("verify", b, s, window=t)
    assert pnames[:3] == names[:3]
    got = step.run_eager({k: v.copy() for k, v in feeds.items()},
                         read=lambda outs: [o.numpy().copy() for o in outs])
    np.testing.assert_array_equal(got[0], want[0].astype(np.int64))
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("kind", ["draft", "verify"])
def test_draft_and_verify_programs_serialize_like_jax(preds, jax_preds,
                                                      kind):
    """Same op descs, parameter names, feeds and fetches: one loaded
    state drives every step kind in both packages."""
    args = dict(window=SPEC_K + 1) if kind == "verify" else {}
    jp, jfeeds, jfetch = jax_preds["random"]._build(kind, 2, 16, "greedy",
                                                    **args)
    pp, pfeeds, pfetch = preds["random"]._build(kind, 2, 16, "greedy",
                                                **args)
    assert (pfeeds, pfetch) == (jfeeds, jfetch)
    assert json.dumps(pp.to_dict(), sort_keys=True) == \
        json.dumps(jp.to_dict(), sort_keys=True)


# -- generate_speculative ---------------------------------------------------

@pytest.mark.parametrize("export", ["random", "identity"])
@pytest.mark.parametrize("eos", [None, 7])
def test_generate_speculative_matches_jax_and_greedy(preds, jax_preds,
                                                     export, eos):
    pred, jpred = preds[export], jax_preds[export]
    prompts = _prompts(3, seed=5 if eos is None else 6)
    n = 20
    got = pred.generate(prompts, n, speculative=True, spec_k=SPEC_K,
                        eos_id=eos)
    rounds = len(pred.timings["verify"])
    assert rounds == len(pred.timings["draft"]) > 0
    plain = pred.generate(prompts, n, eos_id=eos)
    with jax_metrics_untouched():
        want = jpred.generate(prompts, n, speculative=True, spec_k=SPEC_K,
                              eos_id=eos)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, np.asarray(w, np.int64))
    if export == "identity" and eos is None:
        # the draft agrees with the target: rounds accept every proposal
        assert rounds <= -(-n // (SPEC_K + 1)) + 1


def test_draft_and_verify_capture_over_the_decode_slabs(preds):
    """The draft and verify steps borrow the decode step's slab tensors
    (same data_ptr: nothing is copied per call), are keyed by it (a
    second decode step's borrowers are other steps) and leave the cache
    with it."""
    pred = preds["random"]
    dstep, _ = pred.acquire("decode", 2, 32, "greedy")
    draft, _ = pred.acquire("draft", 2, 32, lender=dstep)
    verify, _ = pred.acquire("verify", 2, 32, window=SPEC_K + 1,
                             lender=dstep)
    for step, n_layer in ((draft, 1), (verify, L)):
        for i in range(n_layer):
            for kv in ("kcache", "vcache"):
                name = "%s_%d" % (kv, i)
                assert step.static[name].data_ptr() == \
                    dstep.static[name].data_ptr()
        assert step.lender is dstep
    assert "kcache_1" not in draft.static
    # borrowed slabs are the lender's bytes, not the borrower's
    assert verify.nbytes < dstep.nbytes
    other, _ = pred.acquire("decode", 2, 32, "greedy", owner="elsewhere")
    assert pred.acquire("draft", 2, 32, lender=other)[0] is not draft
    assert pred.acquire("draft", 2, 32, lender=dstep)[0] is draft
    pred.release(other)
    pred.release(dstep)
    steps = pred._steps.steps()
    assert not any(s is draft or s is verify for s in steps)


# -- the speculative server -------------------------------------------------

@pytest.mark.parametrize("export", ["random", "identity"])
def test_speculative_server_is_lossless(preds, jax_preds, export):
    """DecodeServer(speculative=True), more requests than slots, mixed
    budgets: every output equals plain greedy generate's and the JAX
    package's speculative server's; the server's draft and verify steps
    borrow its own decode step's slabs."""
    pred, jpred = preds[export], jax_preds[export]
    prompts = _prompts(5, seed=8)
    budgets = [9, 4, 12, 7, 10]
    srv = pt_decode.DecodeServer(pred, slots=2, max_seq=32,
                                 max_new_tokens=12, speculative=True,
                                 spec_k=SPEC_K)
    srv.start()
    assert srv._draft.static["kcache_0"].data_ptr() == \
        srv._step.static["kcache_0"].data_ptr()
    assert srv._verify.lender is srv._step
    futs = [srv.submit((p, np.array([b], np.int64)))
            for p, b in zip(prompts, budgets)]
    got = [f.result(timeout=120)[0] for f in futs]
    owned = srv._step
    srv.stop()
    with jax_metrics_untouched():
        jsrv = jax_decode.DecodeServer(jpred, slots=2, max_seq=32,
                                       max_new_tokens=12, speculative=True,
                                       spec_k=SPEC_K, prewarm=False)
        jsrv.start()
        want = [f.result(timeout=120)[0] for f in [
            jsrv.submit((p, np.array([b], np.int64)))
            for p, b in zip(prompts, budgets)]]
        jsrv.stop()
    for g, w, p, b in zip(got, want, prompts, budgets):
        assert len(g) == b
        np.testing.assert_array_equal(g, np.asarray(w, np.int64))
        np.testing.assert_array_equal(g, pred.generate([p], b)[0])
    # the owned steps left the cache at stop()
    assert not any(s is owned or s.lender is owned
                   for s in pred._steps.steps())
