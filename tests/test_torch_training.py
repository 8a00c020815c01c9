"""The port's training slice against the JAX package, on the CPU.

- ``fused_lm_head_loss``: loss, dx, dw and db against the vjp of the JAX
  package's ``lm_head_loss``, at a vocab (300) that block_v (128) does not
  divide, so the -1e30 bias padding runs; both weight layouts.
  Tolerance 1e-5 abs / 1e-5 rel (fp32, chunked sums in another order).
- ``adam``: the op's five outputs against the JAX op's on the same numpy
  inputs. Tolerance 1e-6 rel (the same fp32 formula).
- A whole training step: ``transformer_lm`` (2 layers, d_model 256, 4
  heads, vocab 512, T 64) + ``Adam.minimize`` built by both packages under
  ``unique_name.guard()``, untied and tied heads. The programs serialize
  identically; the JAX startup's state is copied into the port's scope;
  3 steps run in each package. The loss of every step agrees within 1e-5
  abs, every step-1 ``@GRAD`` within 1e-4 rel + 1e-6 abs (the gradient of
  a key bias is zero up to rounding on both sides), and every parameter
  and accumulator after step 3 within 1e-4 rel + lr/10 abs: Adam divides
  each gradient by its own running RMS, so an element whose gradient is
  near zero, where the two packages' fp32 sums differ in their last bits,
  moves by a different fraction of lr.
- The port's startup: gaussian_random draws N(0, 0.02) (mean within
  5e-4, std within 2%% on 1M draws), the same values under the same seed,
  other values for another op, and running startup does not move the
  main program's random stream."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as fluid  # noqa: E402
from paddle_tpu import layers as jax_layers  # noqa: E402
from paddle_tpu import optimizer as jax_optimizer  # noqa: E402
from paddle_tpu.models import transformer as jax_T  # noqa: E402
from paddle_tpu.ops import fused_loss as jax_fused_loss  # noqa: E402
from paddle_tpu.ops import registry as jax_registry  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import io as pt_io  # noqa: E402
from paddle_tpu_torch import layers as pt_layers  # noqa: E402
from paddle_tpu_torch import optimizer as pt_optimizer  # noqa: E402
from paddle_tpu_torch.models import transformer as pt_T  # noqa: E402
from paddle_tpu_torch.ops import fused_loss as pt_fused_loss  # noqa: E402
from paddle_tpu_torch.ops import registry as pt_registry  # noqa: E402

V, L, NH, D, DI, B, T, LR = 512, 2, 4, 256, 512, 2, 64, 1e-3


@pytest.mark.parametrize("transpose_w", [False, True])
def test_fused_lm_head_loss_matches_jax_with_vocab_padding(transpose_w):
    n, d, v, block_v = 24, 32, 300, 128
    r = np.random.RandomState(1 + transpose_w)
    x = r.standard_normal((n, d)).astype(np.float32)
    w = (r.standard_normal((v, d) if transpose_w else (d, v)) * 0.3
         ).astype(np.float32)
    b = r.standard_normal(v).astype(np.float32)
    labels = r.randint(0, v, n).astype(np.int32)
    labels[0] = v - 1  # a label in the padded last chunk
    g = r.standard_normal((n, 1)).astype(np.float32)

    def fn(x, w, b):
        return jax_fused_loss.lm_head_loss(block_v, x, w, b,
                                           jnp.asarray(labels), transpose_w)

    want, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want_grads = vjp(jnp.asarray(g))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    got = pt_fused_loss.lm_head_loss(block_v, tx, tw, tb,
                                     torch.from_numpy(labels), transpose_w)
    got_grads = torch.autograd.grad(got, (tx, tw, tb), torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for name, a, e in zip(("dx", "dw", "db"), got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


class _Ctx:
    """The smallest op context both registries' adam kernels read."""

    def __init__(self, inputs, attrs):
        self._inputs, self._attrs = inputs, attrs

    def input(self, slot, default=None):
        return self._inputs.get(slot, default)

    def attr(self, name, default=None):
        return self._attrs.get(name, default)


def test_adam_op_matches_jax():
    r = np.random.RandomState(4)
    shape = (7, 5)
    arrays = {
        "Param": r.standard_normal(shape).astype(np.float32),
        "Grad": r.standard_normal(shape).astype(np.float32) * 1e-2,
        "Moment1": r.standard_normal(shape).astype(np.float32) * 1e-3,
        "Moment2": np.abs(r.standard_normal(shape)).astype(np.float32) * 1e-4,
        "Beta1Pow": np.array([0.9 ** 3], np.float32),
        "Beta2Pow": np.array([0.999 ** 3], np.float32),
        "LearningRate": np.array([1e-3], np.float32),
    }
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    want = jax_registry.get_kernel("adam")(
        _Ctx({k: jnp.asarray(a) for k, a in arrays.items()}, attrs))
    got = pt_registry.get_kernel("adam")(
        _Ctx({k: torch.from_numpy(a) for k, a in arrays.items()}, attrs))
    assert set(got) == set(want)
    for slot in want:
        assert tuple(got[slot].shape) == tuple(np.shape(want[slot])), slot
        np.testing.assert_allclose(got[slot].numpy(), np.asarray(want[slot]),
                                   rtol=1e-6, atol=0, err_msg=slot)


def _build(pkg, layers, optimizer, T_mod, tie):
    prog, startup = pkg.Program(), pkg.Program()
    prog.random_seed = startup.random_seed = 3
    with pkg.program_guard(prog, startup):
        with pkg.unique_name.guard():
            ids = layers.data(name="ids", shape=[B, T], dtype="int64",
                              append_batch_size=False)
            labels = layers.data(name="labels", shape=[B, T], dtype="int64",
                                 append_batch_size=False)
            loss, _ = T_mod.transformer_lm(
                ids, labels, V, n_layer=L, n_head=NH, d_model=D, d_inner=DI,
                max_len=128, tie_embeddings=tie)
            optimizer.Adam(learning_rate=LR).minimize(loss)
    return prog, startup, loss


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_training_steps_match_jax(tie):
    jprog, jstart, jloss = _build(fluid, jax_layers, jax_optimizer, jax_T, tie)
    pprog, pstart, ploss = _build(pt, pt_layers, pt_optimizer, pt_T, tie)
    assert pprog.to_json() == jprog.to_json()
    assert pstart.to_json() == jstart.to_json()

    exe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(jstart)
    names = [v.name for v in jprog.list_vars() if v.persistable]
    pscope = pt.Scope()
    for name, val in pt_io.state_from_numpy(
            {n: np.asarray(jscope.find_var(n)) for n in names},
            pt.CPUPlace()).items():
        pscope.set_var(name, val)
    pexe = pt.Executor(pt.CPUPlace())
    grads = [p.name + "@GRAD" for p in jprog.all_parameters()]
    r = np.random.RandomState(0)
    for step in range(3):
        feed = {"ids": r.randint(0, V, (B, T)).astype(np.int64),
                "labels": r.randint(0, V, (B, T)).astype(np.int64)}
        # one fetch list for every step: the JAX package compiles once
        with fluid.scope_guard(jscope):
            want = exe.run(jprog, feed=feed, fetch_list=[jloss.name] + grads)
        got = pexe.run(pprog, feed=feed, fetch_list=[jloss.name] + grads,
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


def _random_program(n_ops):
    """A program whose ops draw N(0, 0.02) tensors of 1M elements."""
    prog = pt.Program()
    prog.random_seed = 11
    block = prog.global_block()
    for i in range(n_ops):
        block.create_var(name="w%d" % i, shape=(1000, 1000),
                         dtype="float32", persistable=True)
        block.append_op("gaussian_random", outputs={"Out": ["w%d" % i]},
                        attrs={"shape": [1000, 1000], "dtype": "float32",
                               "mean": 0.0, "std": 0.02, "seed": 0})
    return prog


def test_startup_gaussian_random_statistics_and_streams():
    startup, scope = _random_program(2), pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    w0, w1 = scope.find_var("w0").numpy(), scope.find_var("w1").numpy()
    assert w0.dtype == np.float32 and w0.shape == (1000, 1000)
    assert abs(float(w0.mean())) < 5e-4
    assert abs(float(w0.std()) - 0.02) < 0.02 * 0.02
    assert not np.array_equal(w0, w1)  # another op, another stream
    # the same seed and step give the same values in a fresh executor
    scope2 = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope2)
    np.testing.assert_array_equal(scope2.find_var("w0").numpy(), w0)
    # a program's step moves its own stream only: running startup before
    # the main program does not change what the main program draws
    main = _random_program(1)
    exe.run(startup, scope=scope)
    assert exe.program_steps(main) == 0
    exe.run(main, scope=scope)
    fresh = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(main, scope=fresh)
    np.testing.assert_array_equal(scope.find_var("w0").numpy(),
                                  fresh.find_var("w0").numpy())
    exe.run(main, scope=scope)  # step 1 of main draws anew
    assert not np.array_equal(scope.find_var("w0").numpy(),
                              fresh.find_var("w0").numpy())
