"""The dense Transformer's remaining paths in the port against the JAX
package, on the CPU.

Each model is built by both packages under ``unique_name.guard()`` (their
program JSON equal), the port's startup state is handed to both (to the
port's scope through ``io.state_from_numpy``, to the JAX package's as
arrays), and both take 2 Adam steps on the same seeded feeds, in fp32,
through ``Executor.run``:

- ``get_model``'s encoder-decoder ``transformer_nmt`` at dropout 0 (1
  layer each side, d_model 32, 4 heads), with source and target lengths that
  include 0, 1 and full (the reference's XLA attention and the port's K1
  plain version give a row with no valid key 0);
- ``transformer_lm(fused_qkv=True)`` (one (D, 3D) projection, the 5-D
  transpose and ``unstack``), in BTHD and BHTD;
- ``multi_head_attention(use_fused=False)``, causal with lengths and
  not: scale, matmul, the -1e9 additive mask, softmax, matmul (and, in
  the port alone, the same under bf16 O2 against fp32: the mask holds
  through a bf16 add);
- ``transformer_lm(fused_head=False)``, tied and untied (the logits and
  ``softmax_with_cross_entropy``).

Tolerances (fp32 sums in another order): every step's loss within 1e-5
abs; every first-step ``@GRAD`` within 1e-4 rel + 1e-6 abs; every
persistable after the second step within 1e-4 rel + lr/10 abs (Adam turns
a near-zero gradient's last bits into a different fraction of lr).
Besides: the builders raise only for ring attention, naming its queue
item (mixture of experts builds); fused q/k/v refuses cross-attention as
the reference does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as fluid  # noqa: E402
from paddle_tpu import layers as jax_layers  # noqa: E402
from paddle_tpu import optimizer as jax_optimizer  # noqa: E402
from paddle_tpu.models import transformer as jax_T  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import io as pt_io  # noqa: E402
from paddle_tpu_torch import layers as pt_layers  # noqa: E402
from paddle_tpu_torch import optimizer as pt_optimizer  # noqa: E402
from paddle_tpu_torch.models import transformer as pt_T  # noqa: E402

LR, STEPS = 1e-3, 2
JAX = (fluid, jax_layers, jax_optimizer, jax_T)
PORT = (pt, pt_layers, pt_optimizer, pt_T)


def _build(pkg, model):
    """``model(layers, T)`` -> (loss, feed names) under a fresh program
    pair; Adam(LR).minimize on it."""
    fw, layers, optimizer, T_mod = pkg
    prog, startup = fw.Program(), fw.Program()
    prog.random_seed = startup.random_seed = 5
    with fw.program_guard(prog, startup), fw.unique_name.guard():
        loss = model(layers, T_mod)
        optimizer.Adam(learning_rate=LR).minimize(loss)
    return prog, startup, loss


def run_parity(model, feeds):
    """Both packages' 2 steps of ``model`` on ``feeds`` (a list, one feed
    dict per step), held to the module's tolerances."""
    jprog, jstart, jloss = _build(JAX, model)
    pprog, pstart, ploss = _build(PORT, model)
    assert pprog.to_json() == jprog.to_json()
    assert pstart.to_json() == jstart.to_json()
    pexe, init = pt.Executor(pt.CPUPlace()), pt.Scope()
    pexe.run(pstart, scope=init)
    names = [v.name for v in jprog.list_vars() if v.persistable]
    state = {n: init.find_var(n).numpy().copy() for n in names}
    exe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    pscope = pt.Scope()
    for name, val in pt_io.state_from_numpy(state, pt.CPUPlace()).items():
        pscope.set_var(name, val)
        jscope.set_var(name, jnp.asarray(state[name]))
    grads = [p.name + "@GRAD" for p in jprog.all_parameters()]
    for step, feed in enumerate(feeds):
        with fluid.scope_guard(jscope):
            want = exe.run(jprog, feed=feed, fetch_list=[jloss.name] + grads)
        got = pexe.run(pprog, feed=feed, fetch_list=[ploss.name] + grads,
                       scope=pscope)
        assert np.isfinite(got[0]) and abs(float(got[0]) - float(want[0])) \
            <= 1e-5, (step, got[0], want[0])
        for name, g, w in zip(grads, got[1:] if step == 0 else [], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    for name in names:
        np.testing.assert_allclose(pscope.find_var(name).numpy(),
                                   np.asarray(jscope.find_var(name)),
                                   rtol=1e-4, atol=LR / 10, err_msg=name)
    return pprog


# -- the encoder-decoder model -------------------------------------------

NB, NT, NV = 4, 16, 64
NMT = dict(batch_size=NB, seq_len=NT, src_vocab_size=NV, tgt_vocab_size=NV,
           n_layer=1, n_head=4, d_model=32, d_inner=64, dropout_rate=0.0)


def _nmt(layers, T_mod):
    return T_mod.get_model(**NMT)[0]


def _nmt_feeds(seed, lens):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        out.append({
            "src_ids": r.randint(0, NV, (NB, NT)).astype(np.int64),
            "src_len": np.array(lens[0], np.int32),
            "tgt_ids": r.randint(0, NV, (NB, NT)).astype(np.int64),
            "tgt_len": np.array(lens[1], np.int32),
            "lbl_ids": r.randint(0, NV, (NB, NT)).astype(np.int64)})
    return out


def test_nmt_get_model_matches_jax_with_lengths_0_1_full():
    prog = run_parity(_nmt, _nmt_feeds(0, ([0, 1, NT, 7], [NT, 0, 1, 9])))
    types = [op.type for op in prog.global_block().ops]
    # an encoder self-, a decoder self- and a cross-attention
    assert types.count("fused_attention") == 3
    assert "dropout" not in types


# -- the LM's variants ----------------------------------------------------

LV, LB, LT = 64, 2, 16


def _lm(**kw):
    def model(layers, T_mod):
        ids = layers.data(name="ids", shape=[LB, LT], dtype="int64",
                          append_batch_size=False)
        labels = layers.data(name="labels", shape=[LB, LT], dtype="int64",
                             append_batch_size=False)
        return T_mod.transformer_lm(ids, labels, LV, n_layer=1, n_head=4,
                                    d_model=32, d_inner=64, max_len=32,
                                    **kw)[0]
    return model


def _lm_feeds(seed):
    r = np.random.RandomState(seed)
    return [{"ids": r.randint(0, LV, (LB, LT)).astype(np.int64),
             "labels": r.randint(0, LV, (LB, LT)).astype(np.int64)}
            for _ in range(STEPS)]


@pytest.mark.parametrize("bthd", ["1", "0"], ids=["bthd", "bhtd"])
def test_fused_qkv_lm_matches_jax(bthd, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ATTN_BTHD", bthd)
    prog = run_parity(_lm(fused_qkv=True), _lm_feeds(1))
    types = [op.type for op in prog.global_block().ops]
    assert types.count("unstack") == 1
    assert "lm.l0.self.qkv.w" in {p.name for p in prog.all_parameters()}


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_unfused_head_lm_matches_jax(tie):
    prog = run_parity(_lm(fused_head=False, tie_embeddings=tie),
                      _lm_feeds(2))
    types = [op.type for op in prog.global_block().ops]
    assert "softmax_with_cross_entropy" in types
    assert "fused_lm_head_loss" not in types


AB, AT, AD = 3, 8, 32


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "padded"])
def test_unfused_attention_matches_jax(causal):
    def model(layers, T_mod):
        x = layers.data(name="x", shape=[AB, AT, AD], dtype="float32",
                        append_batch_size=False)
        lens = layers.data(name="lens", shape=[AB], dtype="int32",
                           append_batch_size=False)
        h = T_mod.multi_head_attention(
            x, x, 4, AD, causal=causal, kv_lengths=lens, name="att",
            use_fused=False)
        return layers.mean(layers.elementwise_mul(h, h))

    r = np.random.RandomState(3)
    feeds = [{"x": r.standard_normal((AB, AT, AD)).astype(np.float32),
              "lens": np.array([AT, 1, 5], np.int32)}
             for _ in range(STEPS)]
    prog = run_parity(model, feeds)
    types = [op.type for op in prog.global_block().ops]
    assert "fused_attention" not in types
    assert {"scale", "softmax", "sequence_mask", "matmul"} <= set(types)


def test_unfused_attention_masks_under_o2():
    """The unfused attention under bf16 O2: the -1e9 additive mask goes
    through an O2 (bf16) add, where -1e9 + x rounds to -1e9, and the fp32
    softmax still gives the masked keys 0: the O2 step's loss and
    gradients stay within bf16's reach (2e-2 of the largest gradient
    element) of the fp32 step's from the same state."""
    def build(amp):
        prog, startup = pt.Program(), pt.Program()
        with pt.program_guard(prog, startup), pt.unique_name.guard():
            x = pt_layers.data(name="x", shape=[AB, AT, AD], dtype="float32",
                               append_batch_size=False)
            lens = pt_layers.data(name="lens", shape=[AB], dtype="int32",
                                  append_batch_size=False)
            h = pt_T.multi_head_attention(x, x, 4, AD, causal=True,
                                          kv_lengths=lens, name="att",
                                          use_fused=False)
            loss = pt_layers.mean(pt_layers.elementwise_mul(h, h))
            pt_optimizer.Adam(learning_rate=LR).minimize(loss)
            if amp:
                prog.enable_mixed_precision(level="O2")
        return prog, startup, loss

    r = np.random.RandomState(6)
    feed = {"x": r.standard_normal((AB, AT, AD)).astype(np.float32),
            "lens": np.array([AT, 1, 5], np.int32)}
    out = {}
    for amp in (False, True):
        prog, startup, loss = build(amp)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        grads = [p.name + "@GRAD" for p in prog.all_parameters()]
        out[amp] = exe.run(prog, feed=feed, fetch_list=[loss] + grads,
                           scope=scope)
    assert abs(float(out[True][0]) - float(out[False][0])) <= \
        2e-2 * abs(float(out[False][0]))
    # every gradient within 2e-2 of the largest (a key bias's gradient is
    # zero up to rounding: softmax ignores a per-query constant)
    big = max(np.abs(g).max() for g in out[False][1:])
    for g16, g32 in zip(out[True][1:], out[False][1:]):
        assert np.all(np.isfinite(g16))
        assert np.abs(g16 - g32).max() <= 2e-2 * big


def test_builders_raise_only_for_ring_and_moe():
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup), pt.unique_name.guard():
        ids = pt_layers.data(name="ids", shape=[2, 8], dtype="int64",
                             append_batch_size=False)
        x = pt_layers.data(name="x", shape=[2, 8, 32], dtype="float32",
                           append_batch_size=False)
        with pytest.raises(NotImplementedError, match="item 7"):
            pt_T.transformer_lm(ids, ids, 16, n_layer=1, n_head=4,
                                d_model=32, d_inner=64, max_len=8,
                                use_ring_attention=True)
        # mixture of experts builds now (tests/test_torch_moe.py trains it)
        pt_T.transformer_lm(ids, ids, 16, n_layer=1, n_head=4, d_model=32,
                            d_inner=64, max_len=8, moe_experts=4)
        with pytest.raises(ValueError, match="SELF-attention"):
            pt_T.multi_head_attention(x, pt_layers.scale(x), 4, 32,
                                      fused_qkv=True)
        # everything else builds: dropout in the FFN and in attention,
        # cross-attention, the unfused paths
        enc = pt_T.transformer_encoder(ids, None, 16, 1, 4, 32, 64, 0.1, 8)
        pt_T.decoder_layer(x, enc, 4, 32, 64, 0.1, None, None, "d",
                           fused_qkv=True)
        pt_T.multi_head_attention(x, x, 4, 32, dropout_rate=0.1,
                                  use_fused=False, causal=True)
        pt_T.transformer_lm(ids, ids, 16, n_layer=1, n_head=4, d_model=32,
                            d_inner=64, max_len=8, dropout_rate=0.1,
                            fused_head=False)
