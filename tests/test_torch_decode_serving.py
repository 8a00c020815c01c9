"""The port's decode serving (paddle_tpu_torch.serving.decode) against the
JAX package's, on the CPU: one tiny transformer_lm trained and exported
by the JAX package, served by both.

Tolerance: prefill logits and K/V slabs agree within 1e-5 abs / 1e-5 rel
(fp32 on both sides; XLA and PyTorch sum in different orders). Greedy
tokens agree exactly. Programs serialize identically."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as fluid  # noqa: E402
from paddle_tpu import layers, optimizer  # noqa: E402
from paddle_tpu.models import transformer as T  # noqa: E402
from paddle_tpu.serving import decode as jax_decode  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import io as pt_io  # noqa: E402
from paddle_tpu_torch.serving import decode as pt_decode  # noqa: E402

V, L, NH, D, DI, ML = 37, 2, 2, 16, 32, 64
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny LM trained a few steps by the JAX package and exported with
    its save_decode_model (the recipe of tests/test_decode_serving.py)."""
    d = str(tmp_path_factory.mktemp("torch_decode_model"))
    B, S = 2, 16
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 7
    with fluid.program_guard(prog, startup):
        with fluid.unique_name.guard():
            ids = layers.data(name="ids", shape=[B, S], dtype="int64",
                              append_batch_size=False)
            lbl = layers.data(name="lbl", shape=[B, S], dtype="int64",
                              append_batch_size=False)
            loss, _ = T.transformer_lm(
                ids, lbl, V, n_layer=L, n_head=NH, d_model=D, d_inner=DI,
                dropout_rate=0.0, max_len=ML, fused_head=False)
            optimizer.Adam(learning_rate=1e-2).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    r = np.random.RandomState(0)
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(3):
            x = r.randint(0, V, (B, S)).astype(np.int64)
            exe.run(prog, feed={"ids": x, "lbl": x})
        jax_decode.save_decode_model(d, jax_decode.DecodeConfig(
            vocab_size=V, n_layer=L, n_head=NH, d_model=D, d_inner=DI,
            max_len=ML), exe, scope=scope)
    return d


@pytest.fixture(scope="module")
def jax_pred(model_dir):
    return jax_decode.DecodePredictor(model_dir, aot_cache=False)


@pytest.fixture(scope="module")
def port_pred(model_dir):
    return pt_decode.DecodePredictor(model_dir, place=pt.CPUPlace())


def _prompts(n, seed=1, lo=3, hi=9):
    r = np.random.RandomState(seed)
    return [r.randint(1, V, r.randint(lo, hi + 1)).astype(np.int64)
            for _ in range(n)]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_prefill_logits_and_slabs_match_jax(jax_pred, port_pred):
    tokens, lens, _b, s = port_pred._bucketed(_prompts(3), 6)
    jexe, jnames = jax_pred.acquire("prefill", tokens.shape[0], s)
    pexe, pnames = port_pred.acquire("prefill", tokens.shape[0], s)
    assert jnames == pnames and len(pnames) == 1 + 2 * L
    want = jexe({"tokens": tokens, "lengths": lens}, jax_pred._state)
    got = pexe({"tokens": tokens, "lengths": lens})
    for name, g, w in zip(pnames, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name,
                                   **TOL)


def test_greedy_generate_matches_jax(jax_pred, port_pred):
    prompts = _prompts(3, seed=4)
    want = jax_pred.generate(prompts, max_new_tokens=10)
    got = port_pred.generate(prompts, max_new_tokens=10)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


def test_incremental_decode_matches_full_forward(port_pred):
    """N decode steps against the cache give the tokens N full-prefix
    forwards give (greedy both sides), within the port."""
    prompts = _prompts(3)
    steps = 8
    got = port_pred.generate(prompts, max_new_tokens=steps)
    b = len(prompts)
    bb = pt_decode._pow2_bucket(b)
    s = pt_decode._pow2_bucket(max(len(p) for p in prompts) + steps,
                               floor=16)
    tokens = np.zeros((bb, s), np.int64)
    lens = np.ones((bb,), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        lens[i] = len(p)
    pexe, _ = port_pred.acquire("prefill", bb, s)
    rows = np.arange(bb)
    want = [[] for _ in range(b)]
    for _ in range(steps):
        outs = pexe({"tokens": tokens, "lengths": lens})
        nxt = outs[0].numpy().argmax(axis=1)
        for i in range(b):
            want[i].append(int(nxt[i]))
        tokens[rows, np.minimum(lens, s - 1)] = nxt
        lens = np.minimum(lens + 1, s - 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w, np.int64))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_programs_serialize_like_jax(jax_pred, port_pred, kind):
    """Same op descs, same parameter names, same feeds and fetches."""
    jp, jfeeds, jfetch = jax_pred._build(kind, 2, 16, "greedy")
    pp, pfeeds, pfetch = port_pred._build(kind, 2, 16, "greedy")
    assert (pfeeds, pfetch) == (jfeeds, jfetch)
    assert json.dumps(pp.to_dict(), sort_keys=True) == \
        json.dumps(jp.to_dict(), sort_keys=True)


def test_export_round_trips_between_packages(model_dir, port_pred, tmp_path):
    """The JAX-written __model__ reads back unchanged, and the port's own
    save_decode_model writes the same program, manifest and parameters."""
    with open(os.path.join(model_dir, "__model__")) as f:
        meta = json.load(f)
    prog = pt.Program.from_dict(meta["program"])
    assert json.dumps(prog.to_dict(), sort_keys=True) == \
        json.dumps(meta["program"], sort_keys=True)

    scope = pt.Scope()
    for name, val in port_pred._state.items():
        scope.set_var(name, val)
    out = str(tmp_path / "port_export")
    pt_decode.save_decode_model(out, port_pred.config, None, scope=scope)
    for fname in ("__model__", "__decode__.json"):
        with open(os.path.join(out, fname)) as f, \
                open(os.path.join(model_dir, fname)) as g:
            assert json.load(f) == json.load(g), fname
    with np.load(os.path.join(out, "__params__.npz")) as a, \
            np.load(os.path.join(model_dir, "__params__.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


def test_state_from_numpy_round_trips_jax_state(jax_pred, port_pred):
    arrays = {n: np.asarray(v) for n, v in jax_pred._state.items()}
    state = pt_io.state_from_numpy(arrays, pt.CPUPlace())
    assert sorted(state) == sorted(port_pred._state)
    for name, arr in arrays.items():
        t = state[name]
        assert t.device.type == "cpu" and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), arr)
        np.testing.assert_array_equal(port_pred._state[name].numpy(), arr)
    # a copy the port owns: writing it leaves the numpy source alone
    name = sorted(state)[0]
    state[name].add_(1.0)
    np.testing.assert_array_equal(np.asarray(jax_pred._state[name]),
                                  arrays[name])
