"""Int8 KV slabs in the port (paddle_tpu_torch/ops/quant.py, the int8
decode step, DecodeServer(kv_dtype="int8")) against the JAX package, on
the CPU, where K3 runs its plain version on the dequantized slabs.

- ``quantize_kv_rows`` and ``cache_append_quant``: int8 rows and scales
  BITWISE the JAX package's (division then round half to even, as it
  does), positions past the slab clipped to its last row;
  ``decode_attention_quant`` and the int8 decode step at 1e-5 abs / 2e-5
  rel, through the layer functions and the registry;
- the int8 server's tokens equal to the JAX package's int8 server's;
- ``kv_slab_slots`` and the ``PADDLE_TPU_QUANT`` knob as in the JAX
  package, and the option rules (no int8 with speculative decoding or
  prefix sharing).

Model: 2 layers, d_model 64, 4 heads of 16, vocab 128, max_len 64,
weights drawn with numpy."""
import json

import numpy as np
import pytest
from _jax_metrics import jax_metrics_untouched

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import paddle_tpu as fluid  # noqa: E402
from paddle_tpu.ops import quant as jax_quant  # noqa: E402
from paddle_tpu.serving import decode as jax_decode  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.ops import quant as pt_quant  # noqa: E402
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


def _rows(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x[0] = 0.0                       # an all-zero row: the scale floor
    # values on a rounding boundary: amax 127 makes the scale 1, so
    # these are x.5 exactly (half to even)
    x[1] = 0.5
    head = x[1].reshape((-1,) + shape[-2:])[0, 0]   # the first row's head 0
    head[0], head[1], head[2] = 127.0, 2.5, -3.5
    return x


def test_quantize_kv_rows_is_bitwise_jax():
    rng = np.random.default_rng(0)
    rows = _rows(rng, 5, 3, NH, 16)
    q, sc = pt_quant.quantize_kv_rows(torch.from_numpy(rows))
    jq, jsc = jax_quant.quantize_kv_rows(jnp.asarray(rows))
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert (q[1, 0, 0, 1], q[1, 0, 0, 2], q[1, 0, 0, 3]) == (2, -4, 0)
    # (5, 3) rows of (H, Dh) are a slab of 5 slots x 3 positions
    np.testing.assert_array_equal(
        pt_quant.dequantize_slab(q, sc).numpy(),
        np.asarray(jax_quant.dequantize_slab(jq, jsc)))


@pytest.mark.parametrize("new_ndim", [3, 4])
def test_cache_append_quant_is_bitwise_jax(new_ndim):
    """Into int8 slabs in place, through the layer function: rows and
    scales equal the JAX package's bit for bit; a position past the slab
    lands on its last row (clipped, as cache_append clips)."""
    rng = np.random.default_rng(1)
    b, s = 4, 12
    new = _rows(rng, b, NH, 16)
    if new_ndim == 4:
        new = new[:, None]
    feeds = {"cache": rng.integers(-127, 128, (b, s, NH, 16)).astype(
                 np.int8),
             "scales": rng.random((b, s)).astype(np.float32),
             "new": new, "pos": np.array([0, 5, s, s + 3], np.int32)}
    got, want = _both(lambda lay, data: list(lay.cache_append_quant(
        data("cache"), data("scales"), data("new"), data("pos"))), feeds)
    assert got[0].dtype == np.int8
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][:2, 6:], feeds["cache"][:2, 6:])
    # the port writes both in place
    cache = torch.from_numpy(feeds["cache"].copy())
    scales = torch.from_numpy(feeds["scales"].copy())
    out, out_s = pt_quant.cache_append_quant(
        cache, scales, torch.from_numpy(new), torch.from_numpy(feeds["pos"]))
    assert out.data_ptr() == cache.data_ptr()
    assert out_s.data_ptr() == scales.data_ptr()


def test_decode_attention_quant_matches_jax():
    rng = np.random.default_rng(2)
    b, s = 3, 16
    feeds = {"q": rng.standard_normal((b, 1, NH, 16)).astype(np.float32),
             "k": rng.integers(-127, 128, (b, s, NH, 16)).astype(np.int8),
             "ks": (rng.random((b, s)) * 0.02).astype(np.float32),
             "v": rng.integers(-127, 128, (b, s, NH, 16)).astype(np.int8),
             "vs": (rng.random((b, s)) * 0.02).astype(np.float32),
             "lens": np.array([0, 9, 16], np.int32)}
    got, want = _both(lambda lay, data: [lay.decode_attention_quant(
        data("q"), data("k"), data("ks"), data("v"), data("vs"),
        data("lens"))], feeds)
    np.testing.assert_allclose(got[0], want[0], **TOL)


# -- the int8 decode step and the int8 server --------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("int8_lm"))
    cfg = pt_decode.DecodeConfig(vocab_size=V, n_layer=L, n_head=NH,
                                 d_model=D, d_inner=DI, max_len=ML)
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        with pt.unique_name.guard():
            pt_decode._prefill_graph(cfg, 1, 16)
    rng = np.random.default_rng(7)
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


@pytest.fixture(scope="module")
def jax_pred(model_dir):
    return jax_decode.DecodePredictor(model_dir, aot_cache=False)


def test_int8_decode_step_matches_jax(pred, jax_pred):
    """The int8 decode step (eager on the CPU) and the JAX package's
    executable on the same int8 slabs and scales: next ids, logits and
    scales at the tolerance, the int8 slabs within one code. The fresh
    row comes out of an fp32 projection whose last bits differ between
    the two (sums in another order), so its scale may differ by an ulp
    and a value on a rounding boundary by a code; the quantization of one
    input is bitwise (the op tests above)."""
    b, s = 2, 16
    rng = np.random.default_rng(3)
    feeds = {"tokens": rng.integers(0, V, (b, 1)).astype(np.int64),
             "positions": np.array([[4], [15]], np.int64),
             "lengths": np.array([4, 15], np.int32),
             "seed": np.zeros((1,), np.int64)}
    for i in range(L):
        for kv in ("k", "v"):
            feeds["%scache_%d" % (kv, i)] = rng.integers(
                -127, 128, (b, s, NH, D // NH)).astype(np.int8)
            feeds["%sscale_%d" % (kv, i)] = (
                rng.random((b, s)) * 0.02).astype(np.float32)
    with jax_metrics_untouched():
        jexe, names = jax_pred.acquire("decode", b, s, "greedy",
                                       kv_dtype="int8")
        want = [np.asarray(o) for o in jexe(dict(feeds), jax_pred._state)]
    step, pnames = pred.acquire("decode", b, s, "greedy", kv_dtype="int8")
    assert len(pnames) == len(names) == 2 + 4 * L
    got = step.run_eager({k: v.copy() for k, v in feeds.items()},
                         read=lambda outs: [o.numpy().copy() for o in outs])
    np.testing.assert_array_equal(got[0], want[0].astype(np.int64))
    np.testing.assert_allclose(got[1], want[1], **TOL)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == w.dtype
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w).max() <= 1
            assert (g != w).sum() <= 2 * NH * (D // NH)
        else:
            np.testing.assert_allclose(g, w, **TOL)


def test_int8_decode_program_serializes_like_jax(pred, jax_pred):
    jp, jfeeds, jfetch = jax_pred._build("decode", 2, 16, "greedy",
                                         kv_dtype="int8")
    pp, pfeeds, pfetch = pred._build("decode", 2, 16, "greedy",
                                     kv_dtype="int8")
    assert (pfeeds, pfetch) == (jfeeds, jfetch)
    assert json.dumps(pp.to_dict(), sort_keys=True) == \
        json.dumps(jp.to_dict(), sort_keys=True)


def _prompts(n, seed, lo=3, hi=12):
    r = np.random.RandomState(seed)
    return [r.randint(1, V, r.randint(lo, hi + 1)).astype(np.int64)
            for _ in range(n)]


def test_int8_server_matches_jax_int8_server(pred, jax_pred):
    """More requests than slots, mixed budgets: the port's int8 server
    gives the JAX package's int8 server's tokens; its slabs are int8 with
    fp32 scales, a quarter of the fp32 slab's bytes and one float a
    row."""
    prompts = _prompts(5, seed=9)
    budgets = [8, 3, 10, 6, 9]
    srv = pt_decode.DecodeServer(pred, slots=2, max_seq=32,
                                 max_new_tokens=10, kv_dtype="int8")
    srv.start()
    slab = dict(zip(srv._cache_feed_names, srv._slabs))
    assert slab["kcache_0"].dtype == torch.int8
    assert tuple(slab["kscale_0"].shape) == (2, 32)
    futs = [srv.submit((p, np.array([b], np.int64)))
            for p, b in zip(prompts, budgets)]
    got = [f.result(timeout=120)[0] for f in futs]
    srv.stop()
    with jax_metrics_untouched():
        jsrv = jax_decode.DecodeServer(jax_pred, slots=2, max_seq=32,
                                       max_new_tokens=10, kv_dtype="int8",
                                       prewarm=False)
        jsrv.start()
        want = [f.result(timeout=120)[0] for f in [
            jsrv.submit((p, np.array([b], np.int64)))
            for p, b in zip(prompts, budgets)]]
        jsrv.stop()
    for g, w, b in zip(got, want, budgets):
        assert len(g) == b
        np.testing.assert_array_equal(g, np.asarray(w, np.int64))


def test_kv_slab_slots_and_the_quant_knob(pred, monkeypatch):
    cfg = pred.config
    jcfg = jax_decode.DecodeConfig(**cfg.to_dict())
    for dt in ("float32", "bfloat16", "int8"):
        for budget in (0, 10_000, 1 << 22):
            assert pt_decode.kv_slab_slots(budget, cfg, 32, dt) == \
                jax_decode.kv_slab_slots(budget, jcfg, 32, dt)
    with pytest.raises(ValueError, match="kv_dtype"):
        pt_decode.kv_slab_slots(1 << 20, cfg, 32, "int4")
    for raw, want in ((None, "float32"), ("kv8", "int8"), (" INT8 ", "int8"),
                      ("fp8", "float32")):
        if raw is None:
            monkeypatch.delenv("PADDLE_TPU_QUANT", raising=False)
        else:
            monkeypatch.setenv("PADDLE_TPU_QUANT", raw)
        assert pt_decode._kv_dtype_from_env() == want == \
            jax_decode._kv_dtype_from_env()
        assert pt_decode.DecodeServer(pred).kv_dtype == want
    # an explicit kv_dtype wins over the knob
    assert pt_decode.DecodeServer(pred, kv_dtype="float32").kv_dtype == \
        "float32"


@pytest.mark.parametrize("kwargs", [{"speculative": True},
                                    {"prefix_cache": True}])
def test_int8_refuses_speculative_and_prefix(pred, kwargs):
    with pytest.raises(ValueError, match="int8"):
        pt_decode.DecodeServer(pred, kv_dtype="int8", **kwargs)
