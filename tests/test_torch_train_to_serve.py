"""Train with the port, serve with both packages, on the CPU: a tiny
``transformer_lm`` trained three Adam steps by ``paddle_tpu_torch``
(startup drawn by the port's own gaussian_random), exported with the
port's ``save_decode_model``, gives the same greedy tokens from the port's
``DecodePredictor`` and from the JAX package's on the same directory."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.serving import decode as jax_decode  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import layers, optimizer  # noqa: E402
from paddle_tpu_torch.models import transformer as T  # noqa: E402
from paddle_tpu_torch.serving import decode as pt_decode  # noqa: E402

V, L, NH, D, DI, ML, B, S = 61, 2, 2, 32, 64, 64, 2, 16


def test_port_trained_model_serves_the_same_tokens_in_both_packages(
        tmp_path):
    prog, startup = pt.Program(), pt.Program()
    prog.random_seed = startup.random_seed = 5
    with pt.program_guard(prog, startup):
        with pt.unique_name.guard():
            ids = layers.data(name="ids", shape=[B, S], dtype="int64",
                              append_batch_size=False)
            lbl = layers.data(name="lbl", shape=[B, S], dtype="int64",
                              append_batch_size=False)
            loss, _ = T.transformer_lm(ids, lbl, V, n_layer=L, n_head=NH,
                                       d_model=D, d_inner=DI, max_len=ML)
            optimizer.Adam(learning_rate=1e-2).minimize(loss)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    r = np.random.RandomState(0)
    losses = []
    for _ in range(3):
        x = r.randint(0, V, (B, S)).astype(np.int64)
        losses.append(float(exe.run(prog, feed={"ids": x, "lbl": x},
                                    fetch_list=[loss], scope=scope)[0]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]

    model_dir = str(tmp_path / "model")
    cfg = pt_decode.DecodeConfig(vocab_size=V, n_layer=L, n_head=NH,
                                 d_model=D, d_inner=DI, max_len=ML)
    pt_decode.save_decode_model(model_dir, cfg, exe, scope=scope)
    prompts = [r.randint(1, V, n).astype(np.int64) for n in (5, 9, 3)]
    got = pt_decode.DecodePredictor(model_dir, place=pt.CPUPlace()).generate(
        prompts, max_new_tokens=6)
    want = jax_decode.DecodePredictor(model_dir, aot_cache=False).generate(
        prompts, max_new_tokens=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
