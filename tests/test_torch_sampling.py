"""The port's sampling ops (paddle_tpu_torch/ops/sampling.py) on the CPU:
the JAX package's test_sampling_ops.py properties on the port's ops, the
decode programs that hold them against the JAX package's, and the
sampling strategies of DecodePredictor.generate.

The draws are a hash of (seed, row, vocabulary id) made into Gumbel noise,
not JAX's PRNG, so they are compared statistically (the reference's
tolerance: frequencies within 0.08 at its sample counts); greedy ids and
logits are compared exactly (logits within 1e-5)."""
import json

import numpy as np
import pytest
from _jax_metrics import jax_metrics_untouched

torch = pytest.importorskip("torch")

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import layers  # noqa: E402
from paddle_tpu_torch.framework.interpreter import run_block  # noqa: E402
from paddle_tpu_torch.ops import sampling as S  # noqa: E402
from paddle_tpu_torch.ops.registry import RANDOM_OPS  # noqa: E402
from paddle_tpu_torch.serving import decode as pt_decode  # noqa: E402

V = 50
CPU = torch.device("cpu")
FREQ_ATOL = 0.08


def _logits(b=4, v=V, seed=0):
    return np.random.RandomState(seed).randn(b, v).astype(np.float32) * 2


def _run_op(op_type, inputs, attrs=None):
    """Build one sampling op through its layer and run it: returns (the
    op's output as numpy, its declared Variable)."""
    prog = pt.Program()
    with pt.program_guard(prog, pt.Program()):
        with pt.unique_name.guard():
            lg = layers.data(name="logits", shape=list(inputs["Logits"].shape),
                             dtype="float32", append_batch_size=False)
            seed = None
            if "Seed" in inputs:
                seed = layers.data(name="seed", shape=[1], dtype="int64",
                                   append_batch_size=False)
            fn = {"greedy_sample": lambda: layers.greedy_sample(lg),
                  "top_k_sample": lambda: layers.top_k_sample(
                      lg, seed=seed, **(attrs or {})),
                  "top_p_sample": lambda: layers.top_p_sample(
                      lg, seed=seed, **(attrs or {}))}[op_type]
            out = fn()
    env = {"logits": torch.from_numpy(inputs["Logits"])}
    if "Seed" in inputs:
        env["seed"] = torch.from_numpy(inputs["Seed"])
    run_block(prog.global_block(), env, CPU)
    return env[out.name].numpy(), out


def _seed(s):
    return np.array([s], np.int64)


def test_greedy_sample_is_argmax():
    lg = _logits()
    out, _ = _run_op("greedy_sample", {"Logits": lg})
    np.testing.assert_array_equal(out, lg.argmax(axis=1))
    # the singleton time axis of the decode step's head output
    got = S.greedy_sample(torch.from_numpy(lg[:, None, :])).numpy()
    np.testing.assert_array_equal(got, lg.argmax(axis=1))


def test_top_k_support_constraint():
    lg = _logits(b=8)
    topk = np.argsort(-lg, axis=1)[:, :5]
    for seed in range(5):
        out, _ = _run_op("top_k_sample", {"Logits": lg, "Seed": _seed(seed)},
                         {"k": 5})
        for i in range(8):
            assert out[i] in topk[i], (i, out[i], topk[i])


def test_top_k_one_is_greedy():
    lg = _logits()
    out, _ = _run_op("top_k_sample", {"Logits": lg, "Seed": _seed(3)},
                     {"k": 1})
    np.testing.assert_array_equal(out, lg.argmax(axis=1))


def test_top_k_seed_determinism():
    lg = _logits(b=16)
    a, _ = _run_op("top_k_sample", {"Logits": lg, "Seed": _seed(7)},
                   {"k": 10})
    b, _ = _run_op("top_k_sample", {"Logits": lg, "Seed": _seed(7)},
                   {"k": 10})
    c, _ = _run_op("top_k_sample", {"Logits": lg, "Seed": _seed(8)},
                   {"k": 10})
    np.testing.assert_array_equal(a, b)  # same seed -> same draw
    assert (a != c).any()                # different seed -> different draw
    # the seed's value decides, not its tensor: an int gives the same
    got = S.top_k_sample(torch.from_numpy(lg), 7, 10).numpy()
    np.testing.assert_array_equal(got, a)


def test_rows_sample_independently():
    """Rows with EQUAL logits draw apart (the row index is hashed in)."""
    n = 64
    lg = np.tile(np.zeros((1, 8), np.float32), (n, 1))
    out = S.top_k_sample(torch.from_numpy(lg), 0, 8).numpy()
    assert len(np.unique(out)) == 8
    out = S.top_p_sample(torch.from_numpy(lg), 0, 1.0).numpy()
    assert len(np.unique(out)) == 8


@pytest.mark.parametrize("seed", [123, -5, 2 ** 40 + 3])
def test_top_k_distribution_shape(seed):
    n = 600
    lg = np.tile(np.log(np.array([[0.7, 0.2, 0.1]], np.float32)), (n, 1))
    out = S.top_k_sample(torch.from_numpy(lg), torch.tensor([seed]),
                         3).numpy()
    freq = np.bincount(out, minlength=3) / n
    assert freq[0] > freq[1] > freq[2], freq
    np.testing.assert_allclose(freq, [0.7, 0.2, 0.1], atol=FREQ_ATOL)


def test_top_k_temperature_sharpens():
    n = 300
    lg = np.tile(np.log(np.array([[0.5, 0.3, 0.2]], np.float32)), (n, 1))
    out = S.top_k_sample(torch.from_numpy(lg), torch.tensor([5]), 3,
                         temperature=0.05).numpy()
    assert (out == 0).mean() > 0.99


def test_top_p_small_p_is_greedy():
    lg = _logits()
    out, _ = _run_op("top_p_sample", {"Logits": lg, "Seed": _seed(1)},
                     {"p": 1e-9})
    np.testing.assert_array_equal(out, lg.argmax(axis=1))


def test_top_p_nucleus_support():
    """p=0.75 over (0.6, 0.3, 0.1) keeps exactly the 2-token nucleus."""
    n = 400
    lg = np.tile(np.log(np.array([[0.6, 0.3, 0.1]], np.float32)), (n, 1))
    out = S.top_p_sample(torch.from_numpy(lg), torch.tensor([9]),
                         0.75).numpy()
    assert set(np.unique(out)) <= {0, 1}, np.unique(out)
    freq = np.bincount(out, minlength=2) / n
    np.testing.assert_allclose(freq[:2], [2 / 3, 1 / 3], atol=FREQ_ATOL)


def test_top_p_full_p_matches_softmax():
    n = 900
    lg = np.tile(np.log(np.array([[0.5, 0.25, 0.25]], np.float32)),
                 (n, 1))
    out = S.top_p_sample(torch.from_numpy(lg), torch.tensor([11]),
                         1.0).numpy()
    freq = np.bincount(out, minlength=3) / n
    np.testing.assert_allclose(freq, [0.5, 0.25, 0.25], atol=FREQ_ATOL)


def test_sampling_without_seed_uses_the_ops_fixed_seed():
    """No Seed input: the op draws with a fixed seed of its own, the same
    on every run (as the JAX package's trace-time stream is fixed per
    executable); decode serving always feeds Seed."""
    lg = _logits()
    topk = np.argsort(-lg, axis=1)[:, :5]
    a, _ = _run_op("top_k_sample", {"Logits": lg}, {"k": 5})
    b, _ = _run_op("top_k_sample", {"Logits": lg}, {"k": 5})
    np.testing.assert_array_equal(a, b)
    for i in range(len(a)):
        assert a[i] in topk[i]


@pytest.mark.parametrize("op_type, attrs", [
    ("greedy_sample", {}), ("top_k_sample", {"k": 5}),
    ("top_p_sample", {"p": 0.9})])
def test_sampling_infer_rules(op_type, attrs):
    """Each layer declares its output as the op gives it: (B,) int64."""
    lg = _logits()
    inputs = {"Logits": lg}
    if op_type != "greedy_sample":
        inputs["Seed"] = _seed(1)
    out, var = _run_op(op_type, inputs, attrs)
    assert tuple(var.shape) == out.shape == (lg.shape[0],)
    assert var.dtype in ("int64", np.int64) or "int64" in str(var.dtype)
    assert out.dtype == np.int64


def test_sampling_ops_are_not_random_ops():
    """A random op makes its program run op by op (no graph): the
    sampling ops draw from their Seed input's value instead."""
    assert not {"greedy_sample", "top_k_sample", "top_p_sample"} \
        & RANDOM_OPS


# -- the decode programs and generate ---------------------------------------

Vm, Lm, NHm, Dm, DIm, MLm = 61, 2, 4, 64, 128, 64


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The small LM's decode export, parameters drawn with numpy."""
    d = str(tmp_path_factory.mktemp("sampling_lm"))
    cfg = pt_decode.DecodeConfig(vocab_size=Vm, n_layer=Lm, n_head=NHm,
                                 d_model=Dm, d_inner=DIm, max_len=MLm)
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
    pt_decode.save_decode_model(d, cfg, None, scope=scope)
    return d


@pytest.fixture(scope="module")
def port_pred(model_dir):
    return pt_decode.DecodePredictor(model_dir, place=pt.CPUPlace())


@pytest.fixture(scope="module")
def jax_pred(model_dir):
    from paddle_tpu.serving import decode as jax_decode

    return jax_decode.DecodePredictor(model_dir, aot_cache=False)


def _prompts(n, seed=3):
    r = np.random.RandomState(seed)
    return [r.randint(1, Vm, r.randint(3, 10)).astype(np.int64)
            for _ in range(n)]


@pytest.mark.parametrize("strategy", ["greedy", "topk", "topp", "logits"])
def test_decode_programs_serialize_like_jax(jax_pred, port_pred, strategy):
    """The decode step of each strategy: same op descs (top_k_sample's
    k and temperature, top_p_sample's p), feeds and fetches as the JAX
    package's; none of its ops is a random op."""
    jp, jfeeds, jfetch = jax_pred._build("decode", 2, 16, strategy)
    pp, pfeeds, pfetch = port_pred._build("decode", 2, 16, strategy)
    assert (pfeeds, pfetch) == (jfeeds, jfetch)
    assert json.dumps(pp.to_dict(), sort_keys=True) == \
        json.dumps(jp.to_dict(), sort_keys=True)
    assert not {op.type for op in pp.global_block().ops} & RANDOM_OPS


@pytest.mark.parametrize("strategy", ["greedy", "logits"])
def test_greedy_and_logits_steps_match_jax(jax_pred, port_pred, strategy):
    """One decode step from the same prefill slabs: the logits agree
    within 1e-5 and the greedy ids exactly."""
    tokens, lens, b, s = port_pred._bucketed(_prompts(2), 4)
    bb = tokens.shape[0]
    with jax_metrics_untouched():
        jpre, _ = jax_pred.acquire("prefill", bb, s)
        jouts = jpre({"tokens": tokens, "lengths": lens}, jax_pred._state)
    feeds = {"tokens": np.asarray(jouts[0]).argmax(1).reshape(bb, 1),
             "positions": lens.reshape(bb, 1).astype(np.int64),
             "lengths": lens, "seed": np.array([1], np.int64)}
    for i in range(Lm):
        feeds["kcache_%d" % i] = np.asarray(jouts[1 + 2 * i])
        feeds["vcache_%d" % i] = np.asarray(jouts[2 + 2 * i])
    with jax_metrics_untouched():
        jdec, jnames = jax_pred.acquire("decode", bb, s, strategy)
        want = jdec(feeds, jax_pred._state)
    pdec, pnames = port_pred.acquire("decode", bb, s, strategy)
    assert jnames == pnames
    got = pdec(feeds, read=lambda outs: [o.clone() for o in outs])
    k = 1 if strategy == "greedy" else 0
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               atol=1e-5, rtol=1e-5)
    if strategy == "greedy":
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(want[0]).astype(np.int64))


@pytest.mark.parametrize("strategy", ["topk", "topp"])
def test_generate_sampling_is_seeded(port_pred, strategy):
    """generate with topk/topp: the same seed gives the same ids, another
    seed other ids, every id in range; the first token is drawn by
    _sample_host with the seed, each decode step with seed + t."""
    prompts = _prompts(4, seed=5)
    a = port_pred.generate(prompts, 8, strategy=strategy, seed=5)
    b = port_pred.generate(prompts, 8, strategy=strategy, seed=5)
    c = port_pred.generate(prompts, 8, strategy=strategy, seed=6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    for row in a + c:
        assert len(row) == 8 and row.min() >= 0 and row.max() < Vm


def test_generate_top_k_one_is_greedy(model_dir, port_pred):
    prompts = _prompts(3, seed=7)
    greedy = port_pred.generate(prompts, 6)
    k1 = pt_decode.DecodePredictor(model_dir, place=pt.CPUPlace(),
                                   sample_k=1)
    for x, y in zip(k1.generate(prompts, 6, strategy="topk", seed=9),
                    greedy):
        np.testing.assert_array_equal(x, y)
    tiny_p = pt_decode.DecodePredictor(model_dir, place=pt.CPUPlace(),
                                       sample_p=1e-9)
    for x, y in zip(tiny_p.generate(prompts, 6, strategy="topp", seed=9),
                    greedy):
        np.testing.assert_array_equal(x, y)
