"""The port's DecodeServer (paddle_tpu_torch/serving/decode.py) against the
JAX package's, on the CPU: one small LM export (parameters drawn with
numpy), served by both packages.

Greedy tokens are compared exactly: the port's server against the JAX
package's server and the port's own ``generate``, in continuous mode
(per-request budgets, mixed prompt lengths) and static mode, each with
more requests than slots. Then the port's own contracts: zero-drop stop, an
injected step failure, an oversized prompt, the decode series at
/metrics, the server's OWN decode step (pinned in the step cache while a
concurrent generate at the same bucket runs, released at stop), and the
arguments of the later slices (served now; ring prefill still raises)."""
import threading
import urllib.request

import numpy as np
import pytest
from _jax_metrics import jax_metrics_untouched

torch = pytest.importorskip("torch")

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.serving import decode as pt_decode  # noqa: E402

V, L, NH, D, DI, ML = 61, 2, 4, 64, 128, 64
SLOTS, SEQ, MAX_NEW = 2, 32, 8


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("server_lm"))
    cfg = pt_decode.DecodeConfig(vocab_size=V, n_layer=L, n_head=NH,
                                 d_model=D, d_inner=DI, max_len=ML)
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        with pt.unique_name.guard():
            pt_decode._prefill_graph(cfg, 1, 16)
    rng = np.random.default_rng(1)
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
def pred(model_dir):
    return pt_decode.DecodePredictor(model_dir, place=pt.CPUPlace())


def _prompts(n, seed=1, lo=3, hi=9):
    r = np.random.RandomState(seed)
    return [r.randint(1, V, r.randint(lo, hi + 1)).astype(np.int64)
            for _ in range(n)]


# the traffic: (prompts, per-request budgets or None: the server's,
# continuous); both have more requests than slots
TRAFFIC = {
    "continuous": (_prompts(6, seed=8, lo=2, hi=14), [2, 7, 3, 5, 8, 4],
                   True),
    "static": (_prompts(5, seed=7), None, False),
}


def _sample(prompt, budget):
    return (prompt,) if budget is None else (prompt,
                                             np.array([budget], np.int64))


def _serve(pred, prompts, budgets, continuous):
    srv = pt_decode.DecodeServer(pred, slots=SLOTS, max_seq=SEQ,
                                 max_new_tokens=MAX_NEW,
                                 continuous=continuous)
    srv.start()
    futs = [srv.submit(_sample(p, mn))
            for p, mn in zip(prompts, budgets or [None] * len(prompts))]
    got = [f.result(timeout=120)[0] for f in futs]
    srv.stop()
    return got, srv


@pytest.fixture(scope="module")
def jax_pred(model_dir):
    from paddle_tpu.serving import decode as jax_decode

    return jax_decode.DecodePredictor(model_dir, aot_cache=False)


@pytest.fixture(scope="module")
def jax_served(jax_pred):
    """The JAX package's DecodeServer over the same export, each traffic
    once (one predictor: its executables are shared)."""
    from paddle_tpu.serving import decode as jax_decode

    out = {}
    with jax_metrics_untouched():
        for name, (prompts, budgets, continuous) in TRAFFIC.items():
            srv = jax_decode.DecodeServer(
                jax_pred, slots=SLOTS, max_seq=SEQ, max_new_tokens=MAX_NEW,
                continuous=continuous, prewarm=False)
            srv.start()
            out[name] = [f.result(timeout=120)[0] for f in [
                srv.submit(_sample(p, mn)) for p, mn in zip(
                    prompts, budgets or [None] * len(prompts))]]
            srv.stop()
    return out


@pytest.mark.parametrize("name", sorted(TRAFFIC))
def test_server_matches_jax_server_and_generate(name, pred, jax_served):
    prompts, budgets, continuous = TRAFFIC[name]
    got, srv = _serve(pred, prompts, budgets, continuous)
    want = pred.generate(prompts, max_new_tokens=MAX_NEW)
    for i, (g, j, w) in enumerate(zip(got, jax_served[name], want)):
        mn = MAX_NEW if budgets is None else budgets[i]
        assert g.dtype == np.int64 and len(g) == mn
        np.testing.assert_array_equal(g, np.asarray(j, np.int64))
        np.testing.assert_array_equal(g, w[:mn])
    # more requests than slots: admission happened mid-flight or in gangs
    assert max(srv.step_active_counts) <= SLOTS
    assert srv.prefill_executions >= -(-len(prompts) // SLOTS)
    if not continuous:
        # gang scheduling: a batch is admitted only into an empty slab
        assert srv.prefill_executions == -(-len(prompts) // SLOTS)


def test_prefill_on_zero_feeds_matches_jax(pred, jax_pred, jax_served):
    """A server's prewarm captures its prefill steps on zero-valued feeds:
    lengths 0 make the last-position gather index -1 for row 0, which the
    JAX package's gather (jnp.take) reads as the last row; the port's
    reads the same (before this, index_select raised on the CPU and
    asserted on the card)."""
    feeds = {"tokens": np.zeros((2, 16), np.int64),
             "lengths": np.zeros((2,), np.int32)}
    with jax_metrics_untouched():
        jexe, _ = jax_pred.acquire("prefill", 2, 16)
        want = np.asarray(jexe(feeds, jax_pred._state)[0])
    pexe, _ = pred.acquire("prefill", 2, 16)
    got = pexe.run_eager(feeds, read=lambda outs: outs[0].numpy().copy())
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_server_stop_is_zero_drop(pred):
    """stop() right after a submit burst: every request still completes
    (queued ones admitted as slots free, in-flight ones finished), and
    the owned decode step leaves the cache."""
    prompts = _prompts(8, seed=9)
    srv = pt_decode.DecodeServer(pred, slots=SLOTS, max_seq=SEQ,
                                 max_new_tokens=4)
    srv.start()
    owned = srv._step
    assert any(s is owned for s in pred._steps.steps())
    futs = [srv.submit((p,)) for p in prompts]
    stopper = threading.Thread(target=srv.stop)
    stopper.start()
    got = [f.result(timeout=120)[0] for f in futs]
    stopper.join(timeout=120)
    want = pred.generate(prompts, max_new_tokens=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not any(s is owned for s in pred._steps.steps())
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit((prompts[0],))


class _Flaky:
    """The owned decode step, raising on its first call (the JAX
    package's flaky_acquire pattern; its slabs stay the step's)."""

    def __init__(self, step):
        self.step, self.armed = step, True
        self.static = step.static

    def capture(self):
        self.step.capture()

    def __call__(self, feeds, read=None):
        if self.armed:
            self.armed = False
            raise RuntimeError("injected device failure")
        return self.step(feeds, read=read)


def test_server_survives_step_failure(model_dir):
    p = pt_decode.DecodePredictor(model_dir, place=pt.CPUPlace())
    real_acquire = p.acquire

    def flaky_acquire(kind, batch, seq, strategy=None, **kw):
        step, fetch = real_acquire(kind, batch, seq, strategy, **kw)
        return (_Flaky(step) if kind == "decode" else step), fetch

    p.acquire = flaky_acquire
    srv = pt_decode.DecodeServer(p, slots=SLOTS, max_seq=SEQ,
                                 max_new_tokens=4, prewarm=False)
    srv.start()
    prompts = _prompts(2, seed=14)
    futs = [srv.submit((pr,)) for pr in prompts]
    with pytest.raises(RuntimeError, match="injected device failure"):
        futs[0].result(timeout=60)
    # the loop serves on, on the same (zeroed in place) slabs
    out, = srv.submit((prompts[0],)).result(timeout=60)
    srv.stop()
    want = pt_decode.DecodePredictor(
        model_dir, place=pt.CPUPlace()).generate([prompts[0]], 4)[0]
    np.testing.assert_array_equal(out, want)


class _Held(_Flaky):
    """The owned decode step, holding its first call until released."""

    def __init__(self, step):
        super().__init__(step)
        self.entered, self.go = threading.Event(), threading.Event()

    def __call__(self, feeds, read=None):
        self.entered.set()
        self.go.wait(timeout=120)
        return self.step(feeds, read=read)


def test_stop_keeps_the_step_pinned_while_the_loop_drains(model_dir):
    """A stop() whose drain outlives its timeout raises and leaves the
    owned step pinned (the loop still replays it); a second stop() waits
    for the drain, then releases the step."""
    p = pt_decode.DecodePredictor(model_dir, place=pt.CPUPlace())
    real_acquire = p.acquire
    held = []

    def holding_acquire(kind, batch, seq, strategy=None, **kw):
        step, fetch = real_acquire(kind, batch, seq, strategy, **kw)
        if kind == "decode" and kw.get("owner") is not None:
            held.append(_Held(step))
            return held[-1], fetch
        return step, fetch

    real_release = p.release
    p.acquire = holding_acquire
    p.release = lambda step: real_release(getattr(step, "step", step))
    srv = pt_decode.DecodeServer(p, slots=SLOTS, max_seq=SEQ,
                                 max_new_tokens=4, prewarm=False)
    srv.start()
    prompt = _prompts(1, seed=15)[0]
    fut = srv.submit((prompt,))
    assert held[0].entered.wait(timeout=60)
    with pytest.raises(RuntimeError, match="still draining"):
        srv.stop(timeout=0.2)
    assert any(s is held[0].step for s in p._steps.steps())
    assert srv._step is held[0]
    held[0].go.set()
    srv.stop()
    assert not any(s is held[0].step for s in p._steps.steps())
    want = pt_decode.DecodePredictor(
        model_dir, place=pt.CPUPlace()).generate([prompt], 4)[0]
    np.testing.assert_array_equal(fut.result(timeout=60)[0], want)


def test_server_rejects_oversized_prompt(pred):
    srv = pt_decode.DecodeServer(pred, slots=1, max_seq=16,
                                 max_new_tokens=8)
    srv.start()
    fut = srv.submit((np.arange(1, 20, dtype=np.int64),))  # 19 + 8 > 16
    with pytest.raises(ValueError, match="slab"):
        fut.result(timeout=60)
    # and a well-sized one still serves
    assert len(srv.submit((np.arange(1, 5, dtype=np.int64),))
               .result(timeout=60)[0]) == 8
    srv.stop()


def test_decode_metrics_exported(pred):
    """The decode series this slice writes reach /metrics under the JAX
    package's names, and /metrics.json carries the same registry."""
    srv = pt_decode.DecodeServer(pred, slots=SLOTS, max_seq=SEQ,
                                 max_new_tokens=4)
    srv.start()
    for f in [srv.submit((p,)) for p in _prompts(3, seed=10)]:
        f.result(timeout=60)
    port = srv.start_http(0)
    text = urllib.request.urlopen(
        "http://127.0.0.1:%d/metrics" % port, timeout=30).read().decode()
    js = urllib.request.urlopen(
        "http://127.0.0.1:%d/metrics.json" % port, timeout=30).read()
    srv.stop()
    for series in ("paddle_tpu_decode_tokens_total",
                   "paddle_tpu_decode_slots",
                   "paddle_tpu_decode_step_ms_bucket",
                   "paddle_tpu_decode_requests_total",
                   'paddle_tpu_predict_requests_total{path="decode"}',
                   "paddle_tpu_compile_total"):
        assert series in text, series
    assert b"paddle_tpu_decode_requests_total" in js


def test_owned_step_survives_eviction_and_concurrent_generate(model_dir):
    """Point a: the server's (SLOTS, SEQ) decode step has the key of a
    generate at batch SLOTS and slab SEQ, but is its own. With the cache
    bounded to nothing every new step evicts the others, yet the owned
    step stays pinned; a generate on the same predictor at that bucket,
    from another thread while the server serves, gives its own tokens."""
    p = pt_decode.DecodePredictor(model_dir, place=pt.CPUPlace())
    prompts = _prompts(2, seed=11, lo=8, hi=9)     # s = 32 at 10 new
    want = p.generate(prompts, max_new_tokens=10)
    traffic = _prompts(6, seed=12)
    want_srv = p.generate(traffic, max_new_tokens=MAX_NEW)
    p._steps.max_bytes = 1
    srv = pt_decode.DecodeServer(p, slots=SLOTS, max_seq=SEQ,
                                 max_new_tokens=MAX_NEW)
    srv.start()
    owned = srv._step
    futs = [srv.submit((t,)) for t in traffic]
    got = {}

    def concurrent():
        got["gen"] = [p.generate(prompts, max_new_tokens=10)
                      for _ in range(3)]

    th = threading.Thread(target=concurrent)
    th.start()
    served = [f.result(timeout=120)[0] for f in futs]
    th.join(timeout=120)
    assert any(s is owned for s in p._steps.steps())
    srv.stop()
    assert p._steps.evictions > 0
    for g, w in zip(served, want_srv):
        np.testing.assert_array_equal(g, w)
    for run in got["gen"]:
        for g, w in zip(run, want):
            np.testing.assert_array_equal(g, w)
    gen_step, _ = p.acquire("decode", SLOTS, SEQ)
    assert gen_step is not owned


def test_seeded_topk_server_round(pred):
    """A topk server completes its requests, ids in range, each request's
    first token drawn from its own seed when it carries one."""
    srv = pt_decode.DecodeServer(pred, slots=SLOTS, max_seq=SEQ,
                                 max_new_tokens=6, strategy="topk")
    srv.start()
    prompts = _prompts(4, seed=13)
    futs = [srv.submit((p, np.array([5, 100 + i], np.int64)))
            for i, p in enumerate(prompts)]
    outs = [f.result(timeout=60)[0] for f in futs]
    srv.stop()
    for i, (p, out) in enumerate(zip(prompts, outs)):
        assert len(out) == 5 and out.min() >= 0 and out.max() < V
        logits = pred._prefill(*pred._bucketed([p], 5)[:2], 16)
        assert out[0] == pred._sample_host(logits, "topk", 100 + i)[0]


@pytest.mark.parametrize("kwargs, what", [
    ({"speculative": True}, "speculative"),
    ({"prefix_cache": True}, "prefix"),
    ({"prefix_store": object()}, "prefix"),
    ({"kv_dtype": "int8"}, "int8")])
def test_later_slice_arguments_raise(pred, kwargs, what):
    """Speculative decoding, prefix sharing and int8 slabs are served
    now (tests/test_torch_speculative.py, test_torch_prefix.py,
    test_torch_quant_kv.py): each argument builds a server, and each
    raises the JAX package's ValueError beside an option it does not
    combine with."""
    pt_decode.DecodeServer(pred, **kwargs)
    clash = {"speculative": {"strategy": "topk"},
             "prefix": {"kv_dtype": "int8"},
             "int8": {"speculative": True}}[what]
    with pytest.raises(ValueError, match=what):
        pt_decode.DecodeServer(pred, **kwargs, **clash)


def test_later_slice_strategies_raise(pred):
    """Beam search and speculative decoding run now; what is still a
    later slice raises: ring prefill (multi-device, queue 1 item 7). A
    speculative generate is greedy only, and a server streams one token
    a step."""
    from paddle_tpu_torch.models import transformer as pt_T

    assert len(pred.generate(_prompts(1), 4, strategy="beam")[0]) == 4
    assert len(pred.generate(_prompts(1), 4, speculative=True)[0]) == 4
    with pytest.raises(ValueError, match="greedy only"):
        pred.generate(_prompts(1), 4, strategy="topk", speculative=True)
    with pytest.raises(ValueError, match="one token per step"):
        pt_decode.DecodeServer(pred, strategy="logits")
    with pt.program_guard(pt.Program(), pt.Program()):
        tokens = pt.layers.data(name="tokens", shape=[1, 16],
                                dtype="int64", append_batch_size=False)
        lengths = pt.layers.data(name="lengths", shape=[1], dtype="int32",
                                 append_batch_size=False)
        with pytest.raises(NotImplementedError, match="item 7"):
            pt_T.transformer_lm_prefill(tokens, lengths, V,
                                        use_ring_attention=True)
