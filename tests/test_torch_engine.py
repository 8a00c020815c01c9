"""The port's Engine (paddle_tpu_torch.serving.engine), its graph steps and
inference.Predictor, against the JAX package on the CPU, where a
GraphStep runs its eager function on its static buffers (the capture is
the card's: tests/test_torch_gpu_kernels.py).

Models: one fc/softmax model (built and initialized by the JAX package,
exported by its save_inference_model, once more with a bucketize stamp)
and one tiny decoder LM (2 layers, d_model 64, random weights from a
seed, exported by the port's save_decode_model).

Tolerance: outputs within 1e-5 abs (fp32 on both sides; XLA and PyTorch
sum in different orders); token ids exactly, after a cast to int64 (the
JAX package computes ids in int32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as fluid  # noqa: E402
from paddle_tpu import inference as jax_inference  # noqa: E402
from paddle_tpu import layers  # noqa: E402
from paddle_tpu.serving import decode as jax_decode  # noqa: E402
from paddle_tpu.serving import engine as jax_engine  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import inference as pt_inference  # noqa: E402
from paddle_tpu_torch.serving import decode as pt_decode  # noqa: E402
from paddle_tpu_torch.serving import engine as pt_engine  # noqa: E402

V, L, NH, D, DI, ML = 61, 2, 2, 64, 128, 64
ATOL = 1e-5


def _fc_model(d, stamp):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 3
    with fluid.program_guard(prog, startup):
        with fluid.unique_name.guard():
            x = layers.data(name="x", shape=[8])
            h = layers.fc(x, 16, act="relu")
            out = layers.fc(h, 5, act="softmax")
    if stamp:
        prog._bucketize = {"feeds": ["x"], "fetches": [out.name]}
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(d, ["x"], [out], exe,
                                      main_program=prog)
    return d


@pytest.fixture(scope="module")
def fc_dir(tmp_path_factory):
    return _fc_model(str(tmp_path_factory.mktemp("fc")), stamp=False)


@pytest.fixture(scope="module")
def fc_bucketized_dir(tmp_path_factory):
    return _fc_model(str(tmp_path_factory.mktemp("fc_bkt")), stamp=True)


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    """The tiny LM's decode export (its prefill program at batch 4, seq
    16), parameters drawn with numpy by the startup initializers."""
    d = str(tmp_path_factory.mktemp("lm"))
    cfg = pt_decode.DecodeConfig(vocab_size=V, n_layer=L, n_head=NH,
                                 d_model=D, d_inner=DI, max_len=ML)
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        with pt.unique_name.guard():
            pt_decode._prefill_graph(cfg, 1, 16)
    rng = np.random.default_rng(0)
    scope = pt.Scope()
    for op in startup.global_block().ops:
        name, shape = op.output("Out")[0], tuple(op.attr("shape"))
        if op.type == "gaussian_random":
            val = rng.standard_normal(shape).astype(np.float32) * 0.1
        else:
            val = np.full(shape, op.attr("value"), np.float32)
        scope.set_var(name, val)
    pt_decode.save_decode_model(d, cfg, None, scope=scope, export_batch=4,
                                export_seq=16)
    return d


@pytest.fixture(scope="module")
def port_lm(lm_dir):
    return pt_decode.DecodePredictor(lm_dir, place=pt.CPUPlace())


def _lm_feed(seed=1):
    r = np.random.RandomState(seed)
    return {"tokens": r.randint(0, V, (4, 16)).astype(np.int64),
            "lengths": np.array([16, 3, 9, 1], np.int32)}


def _prompts(seed=4):
    r = np.random.RandomState(seed)
    return [r.randint(1, V, n).astype(np.int64) for n in (7, 3, 12)]


@pytest.mark.parametrize("model", ["fc", "fc_bucketized", "lm_prefill"])
def test_predictor_matches_jax(request, model, fc_dir, fc_bucketized_dir,
                               lm_dir):
    d = {"fc": fc_dir, "fc_bucketized": fc_bucketized_dir,
         "lm_prefill": lm_dir}[model]
    if model == "lm_prefill":
        feed = _lm_feed()
    else:
        feed = {"x": np.random.RandomState(2).standard_normal(
            (3, 8)).astype(np.float32)}
    want = jax_inference.Predictor(d, aot_cache=False).run(feed)
    port = pt_inference.Predictor(d, place=pt.CPUPlace())
    got = port.run(dict(feed))
    positional = port.run([feed[n] for n in port.feed_names],
                          return_numpy=False)
    assert len(got) == len(want) == len(positional)
    for g, p, w in zip(got, positional, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)
        assert isinstance(p, torch.Tensor)
        np.testing.assert_array_equal(p.numpy(), g)
    steps = port._steps.steps()
    assert len(steps) == 1 and port.traces == 1
    assert steps[0].meta["kind"] == "predict"
    if model == "fc_bucketized":
        # a batch of 3 ran at the bucket of 4 and was sliced back
        assert tuple(steps[0].static["x"].shape) == (4, 8)
        assert steps[0].meta["tier"] == "O2"
        assert got[0].shape == (3, 5)


def test_predictor_refuses_what_is_not_ported(fc_dir, monkeypatch):
    with pytest.raises(NotImplementedError, match="transpiler"):
        pt_inference.Predictor(fc_dir, place=pt.CPUPlace(), opt_level=2)
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "1")
    with pytest.raises(NotImplementedError, match="analysis/"):
        pt_inference.Predictor(fc_dir, place=pt.CPUPlace())


def test_feed_plan_and_keys_match_jax_engine(lm_dir):
    """Feed plans and conversions agree with the JAX package's Engine,
    the missing-feed error too; the key moves with each of its fields and
    with nothing else."""
    import json
    import os

    with open(os.path.join(lm_dir, "__model__")) as f:
        meta = json.load(f)
    feeds, fetches = meta["feed_names"], meta["fetch_names"]
    jeng = jax_engine.Engine(fluid.Program.from_dict(meta["program"]),
                             feed_names=feeds, fetch_names=fetches)
    peng = pt_engine.Engine(pt.Program.from_dict(meta["program"]),
                            feed_names=feeds, fetch_names=fetches)
    assert [(n, w) for n, _, w in peng.feed_plan()] == \
        [(n, w) for n, _, w in jeng.feed_plan()]
    raw = {"tokens": [[1] * 16] * 4, "lengths": [3.0] * 4}
    got, want = peng.convert_feeds(raw), jeng.convert_feeds(raw)
    for name in feeds:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    errors = []
    for eng in (peng, jeng):
        with pytest.raises(KeyError) as e:
            eng.convert_feeds({"tokens": raw["tokens"]})
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert peng.fingerprint() == peng.program.fingerprint()[:8]
    assert peng.tier() == "raw"

    sig = pt_engine.feed_signature(
        [(n, np.shape(raw[n]), got[n].dtype) for n in feeds])
    base = peng.key("predict", sig, fetches)
    made = peng.meta("predict", sig, fetches)
    assert (made["program"], made["tier"], made["feed_sig"]) == \
        (peng.fingerprint(), "raw", sig)
    again = pt_engine.Engine(pt.Program.from_dict(meta["program"]))
    assert again.key("predict", sig, fetches) == base
    changed = pt.Program.from_dict(meta["program"])
    changed.global_block().ops[-1].attrs["x_num_col_dims"] = 2
    other = [
        peng.key("decode", sig, fetches),
        peng.key("predict", sig[:1], fetches),
        peng.key("predict", sig, list(reversed(fetches)) + ["x"]),
        peng.key("predict", sig, fetches, "extra"),
        pt_engine.Engine(changed).key("predict", sig, fetches),
    ]
    assert base not in other and len(set(other)) == len(other)


def _eager_generate(pred, prompts, max_new):
    """The port's generate as it ran before the Engine: fresh tensors,
    the prefill's K/V zero-padded to the slab, every step's program run
    by its eager function."""
    tokens, lens, b, s = pred._bucketed(prompts, max_new)
    bb = tokens.shape[0]
    sp = pt_decode._pow2_bucket(int(lens.max()), floor=16)
    pstep, _ = pred.acquire("prefill", bb, sp)
    outs = pstep.eager({"tokens": torch.from_numpy(tokens[:, :sp].copy()),
                        "lengths": torch.from_numpy(lens)})
    caches = [torch.nn.functional.pad(c, (0, 0, 0, 0, 0, s - sp))
              for c in outs[1:]]
    cur = outs[0].argmax(-1).numpy()
    gen = [[int(cur[i])] for i in range(b)]
    dstep, _ = pred.acquire("decode", bb, s)
    lens = lens.copy()
    for t in range(1, max_new):
        feeds = {"tokens": torch.from_numpy(cur.reshape(bb, 1)),
                 "positions": torch.from_numpy(
                     lens.reshape(bb, 1).astype(np.int64)),
                 "lengths": torch.from_numpy(lens.copy()),
                 "seed": torch.tensor([t], dtype=torch.int64)}
        for i in range(L):
            feeds["kcache_%d" % i] = caches[2 * i]
            feeds["vcache_%d" % i] = caches[2 * i + 1]
        outs = dstep.eager(feeds)
        cur = outs[0].numpy().copy()
        caches = list(outs[2:])
        lens += 1
        for i in range(b):
            gen[i].append(int(cur[i]))
    return [np.asarray(g, np.int64) for g in gen]


def test_generate_through_graph_steps(lm_dir, port_lm, monkeypatch):
    """generate through the graph-step objects gives the eager path's
    tokens and the JAX package's; a second generate at the same buckets
    builds nothing; a slab fed as the step's own buffer is not copied."""
    prompts, max_new = _prompts(), 6
    got = port_lm.generate(prompts, max_new_tokens=max_new)
    traces = port_lm.traces
    assert traces == 2   # the prefill and decode steps, nothing captured
    again = port_lm.generate(prompts, max_new_tokens=max_new)
    assert port_lm.traces == traces
    want_jax = jax_decode.DecodePredictor(lm_dir, aot_cache=False).generate(
        prompts, max_new_tokens=max_new)
    eager = _eager_generate(port_lm, prompts, max_new)
    for g, a, w, e in zip(got, again, want_jax, eager):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, np.asarray(w).astype(np.int64))
        np.testing.assert_array_equal(g, e)

    tokens, lens, _b, s = port_lm._bucketed(prompts, max_new)
    dstep, _ = port_lm.acquire("decode", tokens.shape[0], s)
    slabs = port_lm._slabs(dstep)
    copied = []
    real_copy = torch.Tensor.copy_

    def spy(self, src, *args, **kwargs):
        copied.append(self)
        return real_copy(self, src, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "copy_", spy)
    bb = tokens.shape[0]
    feeds = {"tokens": tokens[:, :1], "positions": lens.reshape(bb, 1)
             .astype(np.int64), "lengths": lens,
             "seed": np.array([1], np.int64)}
    for i in range(L):
        feeds["kcache_%d" % i] = slabs[2 * i]
        feeds["vcache_%d" % i] = slabs[2 * i + 1].clone()
    dstep(feeds)
    hit = [any(c is slab for c in copied) for slab in slabs]
    assert hit == [False, True] * L   # the k slabs were the buffers


def test_steps_are_found_by_key(lm_dir, fc_dir, monkeypatch):
    """Every acquire looks its step up by key: the same signature finds
    the same step, and a knob the port reads while a step runs gives
    another key and another step."""
    port = pt_inference.Predictor(fc_dir, place=pt.CPUPlace())
    x = np.ones((2, 8), np.float32)
    port.run({"x": x})
    first = port._steps.steps()
    port.run({"x": x})
    assert port._steps.steps() == first and port.traces == 1
    monkeypatch.setenv("PADDLE_TPU_FLASH_FUSED_BWD", "1")
    port.run({"x": x})
    assert len(port._steps) == 2 and port.traces == 2
    pred = pt_decode.DecodePredictor(lm_dir, place=pt.CPUPlace())
    a, _ = pred.acquire("decode", 4, 32)
    b, _ = pred.acquire("decode", 4, 32)
    monkeypatch.delenv("PADDLE_TPU_FLASH_FUSED_BWD")
    c, _ = pred.acquire("decode", 4, 32)
    assert a is b and c is not a and pred.traces == 2


def test_step_cache_evicts_the_least_recently_used(lm_dir, port_lm):
    """A predictor bounded to about one bucket's steps evicts the other
    buckets' steps, slabs included; an evicted bucket is built again and
    gives the same tokens; traces count every build."""
    prompts, max_new = _prompts(), 6
    want = port_lm.generate(prompts, max_new_tokens=max_new)
    short = [p[:3] for p in prompts[:2]]
    want_short = port_lm.generate(short, max_new_tokens=3)
    one = sum(s.nbytes for s in port_lm._steps.steps()[:2])
    pred = pt_decode.DecodePredictor(lm_dir, place=pt.CPUPlace(),
                                     max_step_bytes=one)
    got = pred.generate(prompts, max_new_tokens=max_new)
    assert len(pred._steps) == 2 and pred._steps.evictions == 0
    got_short = pred.generate(short, max_new_tokens=3)
    assert pred._steps.evictions >= 1 and pred._steps.nbytes <= one
    again = pred.generate(prompts, max_new_tokens=max_new)
    assert pred._steps.nbytes <= one
    assert pred.traces == pred._steps.builds > 4   # a bucket built again
    for g, a, w in zip(got, again, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(a, w)
    for g, w in zip(got_short, want_short):
        np.testing.assert_array_equal(g, w)


def test_prefill_writes_the_slabs_and_zeroes_their_tail(port_lm):
    tokens, lens, _b, s = port_lm._bucketed(_prompts(), 6)
    bb = tokens.shape[0]
    sp = pt_decode._pow2_bucket(int(lens.max()), floor=16)
    assert sp < s
    dstep, _ = port_lm.acquire("decode", bb, s)
    slabs = port_lm._slabs(dstep)
    for slab in slabs:
        slab.fill_(7.0)
    logits = port_lm._prefill(tokens, lens, s, slabs)
    pstep, _ = port_lm.acquire("prefill", bb, sp)
    outs = pstep.eager({"tokens": torch.from_numpy(tokens[:, :sp].copy()),
                        "lengths": torch.from_numpy(lens)})
    assert torch.equal(logits, outs[0])
    for slab, cache in zip(slabs, outs[1:]):
        assert tuple(slab.shape) == (bb, s, NH, D // NH)
        assert torch.equal(slab[:, :sp], cache)
        assert bool((slab[:, sp:] == 0).all())


def test_graph_step_checks_its_feeds():
    step = pt_engine.GraphStep(lambda f: (f["x"] * 2,),
                               [("x", (2, 3), torch.float32)], "cpu",
                               name="double")
    x = np.arange(6, dtype=np.float64).reshape(2, 3)
    out, = step({"x": x})
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), 2 * x)
    assert step.run_eager({"x": x}, read=lambda o: o[0].sum().item()) == 30
    with pytest.raises(KeyError, match="missing feed 'x'"):
        step({})
    with pytest.raises(ValueError, match=r"built for \(2, 3\)"):
        step({"x": np.zeros((3, 2), np.float32)})
    step.capture()   # a no-op off the card
    assert step.captures == 0 and not step.captured


def test_own_counters_give_a_store_of_its_own(monkeypatch):
    """Inside ``own_counters`` K3's counters come from the given store,
    keyed by (device, B*H), never from the per-stream table; outside, a
    call is back on that table. (No stream is captured here: this torch
    has no CUDA to ask.)"""
    from paddle_tpu_torch.ops import kv_cache as pt_kv

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    store, before = {}, dict(pt_kv._COUNTERS)
    with pt_kv.own_counters(store) as got:
        buf = pt_kv._counters(torch.device("cpu"), 6)
        assert pt_kv._counters(torch.device("cpu"), 6) is buf
    assert got is store and list(store) == [(None, 6)]
    assert store[(None, 6)] is buf and not buf.any()
    assert pt_kv._COUNTERS == before and pt_kv._OWNED.get() is None


def test_eager_step_drops_intermediates(port_lm):
    """run_block with ``keep`` (the Engine's eager functions) drops every
    other variable after its last reader or writer and computes the
    same fetches as a run that keeps them all."""
    from paddle_tpu_torch.framework.interpreter import run_block

    program, feeds, fetches = port_lm._build("prefill", 4, 16, "greedy")
    block = program.global_block()
    feed = {n: torch.from_numpy(a) for n, a in _lm_feed().items()}
    full = dict(port_lm._state, **feed)
    lean = dict(full)
    with torch.inference_mode():
        run_block(block, full, torch.device("cpu"))
        run_block(block, lean, torch.device("cpu"), keep=fetches)
    assert set(lean) == set(fetches)   # every state var and feed is read
    assert len(full) > 10 * len(lean)
    for name in fetches:
        assert torch.equal(lean[name], full[name]), name
