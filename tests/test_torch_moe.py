"""The port's mixture-of-experts FFN against the JAX package's, on the CPU.

- ``moe_ffn_local`` (routed by index in the port, by one-hot einsums in
  the JAX package) at E 4, D 8, F 16, 16 tokens, k 1 and 2, capacity
  factor 2.0 and 0.5 (0.5 drops tokens): fp32 outputs and the gradients
  of x and of all five weights (``jax.vjp``) within 1e-5; the kept
  (token, choice) count equal to the JAX package's ``dispatch.sum()``;
  bf16 x (fp32 weights, as under O2): the port's distance from the fp32
  output on the same bf16-valued x within 2x the JAX package's bf16
  distance plus 2 bf16 ulps of the output's scale.
- ``transformer_lm(moe_experts=4)`` built as tests/test_moe.py builds it
  (vocab 32, 1 layer, d_model 8, d_inner 16, batch 2 x 8) + SGD(0.1) by
  both packages (program JSON equal), the JAX startup's state carried
  over by name (the MoE block's ``*.moe.gate_w/w1/b1/w2/b2`` among it),
  3 steps: every loss and every parameter after them within rtol 1e-4.
- The port's own startup of that LM: the MoE block's weights, which
  have no initializer of their own, draw Xavier-uniform
  (``uniform_random``) within the startup op's bounds, with the mean and
  spread of U(min, max), the biases zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as fluid  # noqa: E402
from paddle_tpu import layers as jax_layers  # noqa: E402
from paddle_tpu import optimizer as jax_optimizer  # noqa: E402
from paddle_tpu.models import transformer as jax_T  # noqa: E402
from paddle_tpu.parallel import moe as jax_moe  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import io as pt_io  # noqa: E402
from paddle_tpu_torch import layers as pt_layers  # noqa: E402
from paddle_tpu_torch import optimizer as pt_optimizer  # noqa: E402
from paddle_tpu_torch.models import transformer as pt_T  # noqa: E402
from paddle_tpu_torch.parallel import moe as pt_moe  # noqa: E402

E, D, F, N = 4, 8, 16, 16
NAMES = ("gate_w", "w1", "b1", "w2", "b2")


def _inputs(seed):
    r = np.random.RandomState(seed)
    x = r.standard_normal((2, N // 2, D)).astype(np.float32)
    ws = [r.standard_normal((D, E)), r.standard_normal((E, D, F)) * 0.3,
          r.standard_normal((E, F)) * 0.1, r.standard_normal((E, F, D)) * 0.3,
          r.standard_normal((E, D)) * 0.1]
    return x, [w.astype(np.float32) for w in ws]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_ffn_matches_jax(k, cf):
    x, ws = _inputs(10 * k + int(cf * 2))
    g = np.random.RandomState(99).standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def jfn(x, ws, g):
        """The JAX package's output and its vjp of ``g``, in one jit."""
        out, vjp = jax.vjp(lambda x, *ws: jax_moe.moe_ffn_local(
            x, jax_moe.MoEParams(*ws), capacity_factor=cf, k=k), x, *ws)
        return out, vjp(g.astype(out.dtype))

    jws = list(map(jnp.asarray, ws))
    want, want_grads = jfn(jnp.asarray(x), jws, jnp.asarray(g))
    tx, *tws = (torch.from_numpy(a).requires_grad_() for a in [x] + ws)
    got = pt_moe.moe_ffn_local(tx, pt_moe.MoEParams(*tws),
                               capacity_factor=cf, k=k)
    got_grads = torch.autograd.grad(got, [tx] + tws, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for name, a, b in zip(("x",) + NAMES, got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)

    # the kept (token, choice) pairs: the JAX package's dispatch.sum()
    tokens = x.reshape(-1, D)
    cap = pt_moe.moe_capacity(N, E, cf)
    dispatch, _ = jax.jit(jax_moe._dispatch_tensors, static_argnums=(1, 2, 3))(
        jnp.asarray(tokens) @ jnp.asarray(ws[0]), E, cap, k)
    probs = torch.softmax(torch.from_numpy(tokens) @ torch.from_numpy(ws[0]),
                          dim=-1)
    _, keep = pt_moe.dispatch_slots(pt_moe.route_choices(probs, k), E, cap)
    assert int(keep.sum()) == int(np.asarray(dispatch).sum())
    if cf < 1:
        assert int(keep.sum()) < k * N   # tokens were dropped

    # bf16 x, fp32 weights: as far from fp32 as the JAX package's bf16
    xb = x.astype(jnp.bfloat16)
    xb32 = np.asarray(xb, np.float32)
    ref = np.asarray(jfn(jnp.asarray(xb32), jws, jnp.asarray(g))[0])
    jax_bf16 = np.asarray(jfn(jnp.asarray(xb), jws, jnp.asarray(g))[0],
                          np.float32)
    port_bf16 = pt_moe.moe_ffn_local(
        torch.from_numpy(xb32).to(torch.bfloat16),
        pt_moe.MoEParams(*map(torch.from_numpy, ws)), capacity_factor=cf,
        k=k)
    assert port_bf16.dtype == torch.bfloat16
    ulp = 2.0 ** -8 * float(np.abs(ref).max())
    port_err = float(np.abs(port_bf16.float().numpy() - ref).max())
    jax_err = float(np.abs(jax_bf16 - ref).max())
    assert port_err <= 2 * jax_err + 2 * ulp, (port_err, jax_err, ulp)


def _build_lm(pkg, layers, optimizer, T_mod, seed=21):
    """tests/test_moe.py's MoE LM + SGD(0.1), built by ``pkg``."""
    mp, sp = pkg.Program(), pkg.Program()
    mp.random_seed = sp.random_seed = seed
    with pkg.program_guard(mp, sp), pkg.unique_name.guard():
        ids = layers.data(name="ids", shape=[2, 8], dtype="int64",
                          append_batch_size=False)
        lbl = layers.data(name="labels", shape=[2, 8], dtype="int64",
                          append_batch_size=False)
        loss, _ = T_mod.transformer_lm(
            ids, lbl, vocab_size=32, n_layer=1, n_head=2, d_model=8,
            d_inner=16, max_len=8, moe_experts=4)
        optimizer.SGD(0.1).minimize(loss)
    return mp, sp, loss


def test_moe_lm_trains_as_the_jax_package_does():
    jmp, jsp, jloss = _build_lm(fluid, jax_layers, jax_optimizer, jax_T)
    pmp, psp, ploss = _build_lm(pt, pt_layers, pt_optimizer, pt_T)
    assert pmp.to_json() == jmp.to_json()
    assert psp.to_json() == jsp.to_json()
    assert [op.type for op in pmp.global_block().ops].count("moe_ffn") == 1
    exe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(jsp)
    names = [v.name for v in jmp.list_vars() if v.persistable]
    assert {n for n in names if ".moe." in n} == {
        "lm.l0.moe." + s for s in NAMES}
    pscope = pt.Scope()
    for name, val in pt_io.state_from_numpy(
            {n: np.asarray(jscope.find_var(n)) for n in names},
            pt.CPUPlace()).items():
        pscope.set_var(name, val)
    pexe = pt.Executor(pt.CPUPlace())
    r = np.random.RandomState(9)
    feed = {"ids": r.randint(0, 32, (2, 8)).astype(np.int64),
            "labels": np.random.RandomState(10).randint(0, 32, (2, 8))
            .astype(np.int64)}
    losses = []
    for _ in range(3):
        with fluid.scope_guard(jscope):
            (want,) = exe.run(jmp, feed=feed, fetch_list=[jloss.name])
        (got,) = pexe.run(pmp, feed=feed, fetch_list=[ploss.name],
                          scope=pscope)
        np.testing.assert_allclose(got, want, rtol=1e-4)
        losses.append(float(got))
    assert losses[2] < losses[0]
    for name in names:
        np.testing.assert_allclose(pscope.find_var(name).numpy(),
                                   np.asarray(jscope.find_var(name)),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


def test_moe_lm_startup_draws_its_xavier_uniform_weights():
    pmp, psp, _ = _build_lm(pt, pt_layers, pt_optimizer, pt_T)
    bounds = {op.output("Out")[0]: (op.attr("min"), op.attr("max"))
              for op in psp.global_block().ops
              if op.type == "uniform_random"}
    assert {"lm.l0.moe." + s for s in ("gate_w", "w1", "w2")} <= set(bounds)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(psp, scope=scope)
    for name, (lo, hi) in bounds.items():
        w = scope.find_var(name).numpy()
        assert w.dtype == np.float32
        assert lo <= w.min() and w.max() < hi, name
        half = (hi - lo) / 2
        assert abs(float(w.mean())) < 0.25 * half, name
        assert abs(float(w.std()) - half / np.sqrt(3)) < 0.25 * half, name
    for s in ("b1", "b2"):
        assert not scope.find_var("lm.l0.moe." + s).numpy().any()
