"""Dropout and the ops of the encoder-decoder Transformer in the port
against the JAX package, on the CPU.

- Op kernels on the same seeded numpy inputs, each package's registered
  kernel: ``softmax_with_cross_entropy`` (hard labels, soft labels,
  ``ignore_index``; Loss and Softmax, and the logits' gradient by
  ``jax.vjp`` and ``torch.autograd``), ``sequence_mask``, ``reduce_sum``,
  ``scale`` (both ``bias_after_scale``), ``unstack`` and
  ``elementwise_mul``/``_div`` with the axis broadcast rule. Tolerance
  1e-6 rel + 1e-6 abs (fp32, the same formulas).
- ``dropout`` at ``is_test`` (and at p 0) for both implementations: equal
  to the JAX kernel's Out and Mask (1e-7).
- ``dropout`` in training, statistically (its bits are not JAX's): the
  kept share of 1M draws within 5 binomial standard deviations of 1 - p;
  ``upscale_in_train`` keeps the mean within 5 standard errors; the
  gradient is the mask times the scale; the same (seed, step) gives the
  same mask in a fresh executor, another step, another program seed or
  another op gives another; a fixed op ``seed`` gives the same mask every
  step; the Mask output is the keep mask in x's dtype.
- The hash behind the masks (ops/rng.py) equals the same murmur3
  finalizer in numpy's uint32 arithmetic, so its int32 products wrap as
  uint32 ones do.
- Attention dropout (``fused_attention`` with ``dropout_rate``): the
  blockwise function equals the dense formula of the reference's
  ``flash_attention`` (``p * bits / (1 - rate)`` against the undropped
  row sum) on the same bits, over several KV blocks, causal, with a
  length-0 row giving 0; at rate 0 it equals the JAX package's
  ``flash_attention`` (1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops import attention as jax_attention  # noqa: E402
from paddle_tpu.ops import registry as jax_registry  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import layers as pt_layers  # noqa: E402
from paddle_tpu_torch.ops import attention as pt_attention  # noqa: E402
from paddle_tpu_torch.ops import registry as pt_registry  # noqa: E402
from paddle_tpu_torch.ops import rng  # noqa: E402


class _Ctx:
    """The smallest op context both registries' kernels read."""

    def __init__(self, inputs, attrs):
        self._inputs, self._attrs = inputs, attrs
        self.is_test = bool(attrs.get("is_test", False))

    def input(self, slot, default=None):
        return self._inputs.get(slot, default)

    def has_input(self, slot):
        return slot in self._inputs

    def attr(self, name, default=None):
        return self._attrs.get(name, default)


def _both(op, arrays, attrs):
    """The op's outputs from both registries on the same numpy inputs."""
    want = jax_registry.get_kernel(op)(
        _Ctx({k: jnp.asarray(a) for k, a in arrays.items()}, attrs))
    got = pt_registry.get_kernel(op)(
        _Ctx({k: torch.from_numpy(np.asarray(a)) for k, a in arrays.items()},
             attrs))
    return got, want


def _close(got, want, tol=1e-6, err=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (err, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=err)


@pytest.mark.parametrize("case", ["hard", "soft", "ignore"])
def test_softmax_with_cross_entropy_matches_jax(case):
    r = np.random.RandomState(0)
    n, v = 6, 11
    logits = (r.standard_normal((n, v)) * 3).astype(np.float32)
    attrs = {"soft_label": case == "soft", "ignore_index": -100}
    if case == "soft":
        label = r.random_sample((n, v)).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    else:
        label = r.randint(0, v, (n, 1)).astype(np.int64)
        if case == "ignore":
            attrs["ignore_index"] = 3
            label[[0, 4]] = 3
    got, want = _both("softmax_with_cross_entropy",
                      {"Logits": logits, "Label": label}, attrs)
    for slot in ("Loss", "Softmax"):
        _close(got[slot], want[slot], err=slot)
    if case == "ignore":
        assert np.all(got["Loss"].numpy()[[0, 4]] == 0)
    g = r.standard_normal((n, 1)).astype(np.float32)

    def jloss(x):
        return jax_registry.get_kernel("softmax_with_cross_entropy")(
            _Ctx({"Logits": x, "Label": jnp.asarray(label)}, attrs))["Loss"]

    _, vjp = jax.vjp(jloss, jnp.asarray(logits))
    tx = torch.from_numpy(logits).requires_grad_()
    tl = pt_registry.get_kernel("softmax_with_cross_entropy")(
        _Ctx({"Logits": tx, "Label": torch.from_numpy(label)}, attrs))["Loss"]
    (dx,) = torch.autograd.grad(tl, tx, torch.from_numpy(g))
    _close(dx, vjp(jnp.asarray(g))[0], err="dlogits")


def test_shape_and_elementwise_ops_match_jax():
    r = np.random.RandomState(1)
    x = r.standard_normal((2, 3, 4, 5)).astype(np.float32)
    lens = np.array([0, 1, 5, 3], np.int32)
    for dtype in ("float32", "int64"):
        got, want = _both("sequence_mask", {"X": lens},
                          {"maxlen": 5, "out_dtype": dtype})
        assert got["Y"].dtype == {"float32": torch.float32,
                                  "int64": torch.int64}[dtype]
        _close(got["Y"], want["Y"], err="sequence_mask " + dtype)
    for attrs in ({"reduce_all": True, "keep_dim": False},
                  {"dim": [1, -1], "keep_dim": True, "reduce_all": False},
                  {"dim": [2], "keep_dim": False, "reduce_all": False}):
        got, want = _both("reduce_sum", {"X": x}, attrs)
        _close(got["Out"], want["Out"], 1e-5, err=str(attrs))
    for after in (True, False):
        got, want = _both("scale", {"X": x}, {"scale": 1e9, "bias": -1e9,
                                              "bias_after_scale": after})
        _close(got["Out"], want["Out"], err="scale %s" % after)
    for axis in (0, 2):
        got, want = _both("unstack", {"X": x}, {"axis": axis})
        assert len(got["Y"]) == len(want["Y"]) == x.shape[axis]
        for a, b in zip(got["Y"], want["Y"]):
            _close(a, b, err="unstack %d" % axis)
    y = r.standard_normal((3, 4)).astype(np.float32) + 3.0
    for op in ("elementwise_mul", "elementwise_div"):
        for yy, axis in ((y, 1), (y[:, :1].reshape(3, 1), 1),
                         (r.standard_normal(5).astype(np.float32), -1),
                         (r.standard_normal(x.shape).astype(np.float32), -1)):
            got, want = _both(op, {"X": x, "Y": yy}, {"axis": axis})
            _close(got["Out"], want["Out"], err="%s %s" % (op, yy.shape))


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
@pytest.mark.parametrize("p", [0.0, 0.3])
def test_dropout_at_test_matches_jax(impl, p):
    x = np.random.RandomState(2).standard_normal((4, 7)).astype(np.float32)
    attrs = {"dropout_prob": p, "is_test": True,
             "dropout_implementation": impl}
    got, want = _both("dropout", {"X": x}, attrs)
    for slot in ("Out", "Mask"):
        _close(got[slot], want[slot], 1e-7, err=slot)


def test_mask_hash_is_uint32_murmur3():
    key = torch.tensor([0xDEADBEEF], dtype=torch.int64)
    got = rng.uniform24(key, (1000,)).numpy()
    with np.errstate(over="ignore"):
        x = (np.arange(1000, dtype=np.uint32) * np.uint32(0x9E3779B1)
             + np.uint32(0xDEADBEEF))
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    np.testing.assert_array_equal(got, (x >> np.uint32(8)).astype(np.int64))


N = 1 << 20


def _dropout_program(p, impl="downgrade_in_infer", n_ops=1, seed=None,
                     random_seed=7):
    prog, startup = pt.Program(), pt.Program()
    prog.random_seed = random_seed
    with pt.program_guard(prog, startup), pt.unique_name.guard():
        x = pt_layers.data(name="x", shape=[N], dtype="float32",
                           append_batch_size=False)
        x.stop_gradient = False
        outs = [pt_layers.dropout(x, p, seed=seed,
                                  dropout_implementation=impl)
                for _ in range(n_ops)]
    masks = [op.output("Mask")[0] for op in prog.global_block().ops
             if op.type == "dropout"]
    return prog, [o.name for o in outs], masks


def _kept_within(keep, p):
    n = keep.size
    sd = (n * p * (1 - p)) ** 0.5
    assert abs(int(keep.sum()) - n * (1 - p)) < 5 * sd, (keep.sum(), n, p)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_training_statistics_and_gradient(impl):
    p = 0.1
    x = np.random.RandomState(3).standard_normal(N).astype(np.float32) + 1.0
    tx = torch.from_numpy(x).requires_grad_()

    class Ctx(_Ctx):
        op = None

        def rng_key(self):
            return torch.tensor([12345], dtype=torch.int64)

    ctx = Ctx({"X": tx}, {"dropout_prob": p, "dropout_implementation": impl})
    ctx.op = type("Op", (), {"attr": staticmethod(
        lambda name, default=None: default)})()
    out = pt_registry.get_kernel("dropout")(ctx)
    keep = out["Mask"].numpy()
    assert out["Mask"].dtype == torch.float32
    assert set(np.unique(keep)) == {0.0, 1.0}
    _kept_within(keep, p)
    up = impl == "upscale_in_train"
    scale = 1.0 / (1 - p) if up else 1.0
    np.testing.assert_array_equal(out["Out"].detach().numpy(),
                                  np.where(keep > 0, x / np.float32(1 - p)
                                           if up else x, 0))
    if up:
        got = out["Out"].detach().double().mean()
        sem = x.std() / (1 - p) ** 0.5 / N ** 0.5
        assert abs(got - x.mean()) < 5 * sem
    g = np.random.RandomState(4).standard_normal(N).astype(np.float32)
    (dx,) = torch.autograd.grad(out["Out"], tx, torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), g * keep * np.float32(scale),
                               rtol=1e-6)


def test_dropout_masks_by_seed_step_and_op():
    x = np.ones(N, np.float32)
    prog, outs, masks = _dropout_program(0.5, n_ops=2)

    def run(exe, program=prog, fetch=None):
        return exe.run(program, feed={"x": x},
                       fetch_list=fetch or [masks[0], masks[1]],
                       scope=pt.Scope())

    exe = pt.Executor(pt.CPUPlace())
    m0a, m0b = run(exe)
    m1a, _ = run(exe)
    _kept_within(m0a, 0.5)
    # the same (seed, step) in a fresh executor: the same masks
    f0a, f0b = run(pt.Executor(pt.CPUPlace()))
    np.testing.assert_array_equal(f0a, m0a)
    np.testing.assert_array_equal(f0b, m0b)
    # another step, another op: other masks, independent (agreement near
    # one half, as two independent p = 0.5 masks)
    for other in (m1a, m0b):
        agree = float((other == m0a).mean())
        assert abs(agree - 0.5) < 5 * 0.5 / N ** 0.5, agree
    # another program seed
    prog2, _, masks2 = _dropout_program(0.5, n_ops=2, random_seed=8)
    s2, _ = pt.Executor(pt.CPUPlace()).run(
        prog2, feed={"x": x}, fetch_list=masks2, scope=pt.Scope())
    assert not np.array_equal(s2, m0a)
    # a fixed op seed: the same mask every step
    prog3, _, masks3 = _dropout_program(0.5, seed=99)
    exe3 = pt.Executor(pt.CPUPlace())
    a = exe3.run(prog3, feed={"x": x}, fetch_list=masks3, scope=pt.Scope())
    b = exe3.run(prog3, feed={"x": x}, fetch_list=masks3, scope=pt.Scope())
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], m0a)
    # run_loop(2) draws what two runs draw
    exe4 = pt.Executor(pt.CPUPlace())
    (last,) = exe4.run_loop(prog, feed={"x": x}, fetch_list=[masks[0]],
                            steps=2, scope=pt.Scope())
    np.testing.assert_array_equal(last, m1a)
    # a clone for test draws nothing
    test_prog = prog.clone(for_test=True)
    (o,) = pt.Executor(pt.CPUPlace()).run(
        test_prog, feed={"x": x}, fetch_list=[outs[0]], scope=pt.Scope())
    np.testing.assert_allclose(o, x * 0.5)


def _dense_dropout_attention(q, k, v, bits, rate, causal, lengths):
    """The reference's flash_attention with dropout in one block: softmax
    weights over the valid keys, dropped as p * bits / (1 - rate), the row
    sum from the undropped p; (B, H, T, D) fp32."""
    s = np.einsum("bhtd,bhsd->bhts", q / np.sqrt(q.shape[-1]), k)
    t, tk = s.shape[2], s.shape[3]
    mask = np.ones((t, tk), bool)
    if causal:
        mask &= np.arange(tk)[None, :] <= np.arange(t)[:, None]
    mask = mask[None, None] & (np.arange(tk)[None, None, None, :]
                               < lengths[:, None, None, None])
    s = np.where(mask, s, -np.inf)
    m = np.max(s, axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0)
    p = np.where(mask, np.exp(s - m), 0)
    l = p.sum(-1, keepdims=True)
    out = np.einsum("bhts,bhsd->bhtd", p * bits / (1 - rate), v)
    return out / np.maximum(l, 1e-30)


def test_attention_dropout_is_the_reference_formula():
    r = np.random.RandomState(5)
    b, h, t, d, rate, bk = 3, 2, 150, 16, 0.2, 64
    q, k, v = (r.standard_normal((b, h, t, d)).astype(np.float32)
               for _ in range(3))
    lengths = np.array([t, 0, 70], np.int32)
    key = torch.tensor([777], dtype=torch.int64)
    tq, tk_, tv = (torch.from_numpy(a) for a in (q, k, v))
    # block_k 64 over T 150: three KV blocks, the last one padded
    got = pt_attention.flash_attention_dropout(
        tq, tk_, tv, key, rate, causal=True,
        lengths=torch.from_numpy(lengths), block_k=bk, layout="bhtd")
    bits = np.concatenate([rng.keep_mask(rng.fold(key, j), (b, h, t, bk),
                                         rate).numpy() for j in range(3)],
                          axis=-1)[..., :t]
    want = _dense_dropout_attention(q.astype(np.float64), k, v, bits, rate,
                                    True, lengths)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert not got[1].any()                      # length 0: zeros
    _kept_within(bits[0, :, :, :t], rate)
    # rate 0 against the JAX package's XLA flash attention, in BTHD
    got0 = pt_attention.flash_attention_dropout(
        tq.transpose(1, 2), tk_.transpose(1, 2), tv.transpose(1, 2), key,
        0.0, causal=False, lengths=torch.from_numpy(lengths), block_k=bk,
        layout="bthd")
    want0 = jax_attention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        lengths=jnp.asarray(lengths), block_k=bk)
    np.testing.assert_allclose(got0.transpose(1, 2).numpy(),
                               np.asarray(want0), rtol=1e-5, atol=1e-5)
