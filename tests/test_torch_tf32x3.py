"""The numerical design of K2 (paddle_tpu_torch/csrc/flash_bwd.cu), on the
CPU: the kernels compute every fp32 product on the tensor cores as three
TF32 products (3xTF32). Here that arithmetic is emulated in PyTorch and
pushed through the port's plain backward (every one of its five products),
and the gradients are held against the JAX package's XLA vjp, as
tests/test_torch_attention_bwd.py holds the plain fp32 backward (2e-5 abs /
1e-4 rel). One TF32 product instead of three is shown to miss 1e-4 of the
largest gradient element on the same inputs: that is why the kernels split.

The emulation follows the kernels: an fp32 operand x is split into
big = x rounded to TF32 (round to nearest, ties away from zero: add 0x1000
to the bits and clear the low 13, which is cvt.rna.tf32.f32 for finite x)
and small = x - big, which the tensor core reads truncated to TF32; each
8-deep step of a product adds small*big, then big*small, then big*big to
an fp32 accumulator. Rounding small as well (cvt.rna) is checked too.

How that accumulator adds is a second model. Rounding each step's sum to
nearest (torch's fp32 add) gives errors 2-5x under those K2 shows on an
H100; a tensor core that aligns an 8-deep step's products and the
accumulator to 24 bits below the largest of them, truncating, and
truncates the sum to fp32 (round toward zero) gives errors of the card's
size. Both models are held to the same tolerance here. Run as a script,

    PYTHONPATH=. python tests/test_torch_tf32x3.py

the module prints, for chip_smoke.py's small backward cases, each model's
error against the plain fp32 backward, as chip_smoke.py measures K2's.

The emulation is many small products: the tests run torch on one thread,
which is faster than many threads and leaves the other cores to other
test processes."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops import attention as jax_attn  # noqa: E402
from paddle_tpu_torch.ops import attention as pt_attn  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-4)
_MATMUL = torch.matmul
_LOW13 = ~0x1FFF


def tf32_round(x):
    """fp32 -> TF32 values, to nearest, ties away from zero (cvt.rna)."""
    return ((x.view(torch.int32) + 0x1000) & _LOW13).view(torch.float32)


def tf32_truncate(x):
    """fp32 -> TF32 values toward zero: what the tensor core reads of an
    fp32 register."""
    return (x.view(torch.int32) & _LOW13).view(torch.float32)


def split(x, small_rounding):
    big = tf32_round(x)
    small = x - big
    return big, (tf32_round(small) if small_rounding == "rna"
                 else tf32_truncate(small))


def _toward_zero(x, bits):
    """x (float64) truncated to ``bits`` significant bits of its own."""
    _, e = torch.frexp(x)
    ulp = torch.ldexp(torch.ones_like(x), e - bits)
    return torch.trunc(x / ulp) * ulp


def hmma_truncating(acc, a, b):
    """acc + a @ b for one 8-deep step (float64 holding fp32 and TF32
    values): the products are exact, each addend is truncated to 24 bits
    below the largest addend's leading bit, and the sum to fp32's 24."""
    terms = a.unsqueeze(-1) * b.unsqueeze(-3)
    top = torch.maximum(terms.abs().amax(-2), acc.abs())
    _, e = torch.frexp(torch.where(top == 0, 1.0, top))
    # powers of two: scaling by them is exact
    inv_ulp = torch.ldexp(torch.ones_like(top), 24 - e)
    total = (terms.mul_(inv_ulp.unsqueeze(-2)).trunc_().sum(-2)
             + (acc * inv_ulp).trunc_())
    return _toward_zero(total / inv_ulp, 24)


def hmma_nearest(acc, a, b):
    """acc + a @ b for one 8-deep step, rounded to nearest in fp32."""
    return acc + _MATMUL(a, b)


def matmul_3xtf32(a, b, small_rounding="truncate", hmma=hmma_nearest):
    """a @ b (fp32, batched) as the kernels' HMMA chain computes it, each
    8-deep step added to the accumulator by ``hmma``."""
    (ab, asm), (bb, bsm) = split(a, small_rounding), split(b, small_rounding)
    wide = hmma is not hmma_nearest
    if wide:
        ab, asm, bb, bsm = (x.double() for x in (ab, asm, bb, bsm))
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=ab.dtype)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        acc = hmma(acc, asm[..., ks], bb[..., ks, :])
        acc = hmma(acc, ab[..., ks], bsm[..., ks, :])
        acc = hmma(acc, ab[..., ks], bb[..., ks, :])
    return acc.float() if wide else acc


def matmul_1xtf32(a, b):
    """a @ b with both operands rounded to TF32 once."""
    return _MATMUL(tf32_round(a), tf32_round(b))


# (T, lengths): a q tile and a KV tile or two; and three rows of T 200 with
# a length-0 row and a partial last tile
CASES = [(64, None), (200, [0, 77, 200])]


def _inputs(t, d, lengths):
    b = 2 if lengths is None else len(lengths)
    r = np.random.RandomState(t + d)
    return [r.standard_normal((b, 2, t, d)).astype(np.float32)
            for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _xla_case(t, d, lengths):
    """Inputs (B, H=2, T, Dh, BHTD, causal) and the XLA vjp's grads."""
    q, k, v, do = _inputs(t, d, lengths)
    lens = None if lengths is None else jnp.asarray(lengths, jnp.int32)

    def fn(q, k, v):
        return jax_attn.flash_attention(q, k, v, causal=True, lengths=lens,
                                        block_k=64)

    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return (q, k, v, do), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _emulated_grads(monkeypatch, matmul, t, d, lengths):
    """The port's plain backward with torch.matmul replaced by ``matmul``,
    from the plain fp32 forward's out and lse (K1 is fp32 on CUDA cores)."""
    (q, k, v, do), want = _xla_case(t, d, lengths)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    lens = None if lengths is None else torch.tensor(lengths,
                                                     dtype=torch.int32)
    out, lse = pt_attn.flash_attention_plain(tq, tk, tv, True, None, lens,
                                             "bhtd")
    with monkeypatch.context() as m:
        m.setattr(torch, "matmul", matmul)
        got = pt_attn.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                                True, None, lens, "bhtd")
    return [g.numpy() for g in got], want


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0 ** -10           # TF32's 10 mantissa bits, at 1
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2),
                      1 + 3 * ulp / 4, 3.0], dtype=torch.float32)
    np.testing.assert_array_equal(
        tf32_round(x).numpy(),
        np.array([1 + ulp, 1, -(1 + ulp), 1 + ulp, 3.0], np.float32))
    np.testing.assert_array_equal(
        tf32_truncate(x).numpy(),
        np.array([1, 1, -1, 1, 3.0], np.float32))
    # big + small is x exactly
    x = torch.tensor([1 + ulp / 3], dtype=torch.float32)
    big, small = split(x, "rna")
    assert float(big + (x - big)) == float(x)
    assert float(big) == 1.0 and float(small) != 0.0


@pytest.mark.parametrize("small_rounding", ["truncate", "rna"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t, lengths", CASES)
def test_3xtf32_backward_matches_xla(monkeypatch, t, lengths, d,
                                     small_rounding):
    lens = None if lengths is None else tuple(lengths)
    got, want = _emulated_grads(
        monkeypatch,
        functools.partial(matmul_3xtf32, small_rounding=small_rounding),
        t, d, lens)
    for name, g, w in zip("qkv", got, want):
        assert np.isfinite(g).all(), "d" + name
        np.testing.assert_allclose(g, w, err_msg="d" + name, **TOL)
    if lengths is not None:
        assert all(np.all(g[0] == 0) for g in got)  # the length-0 row


@pytest.mark.parametrize("d", [64, 128])
def test_3xtf32_truncating_accumulator_backward_matches_xla(monkeypatch, d):
    t, lengths = CASES[1]
    got, want = _emulated_grads(
        monkeypatch, functools.partial(matmul_3xtf32, hmma=hmma_truncating),
        t, d, tuple(lengths))
    for name, g, w in zip("qkv", got, want):
        assert np.isfinite(g).all(), "d" + name
        np.testing.assert_allclose(g, w, err_msg="d" + name, **TOL)
    assert all(np.all(g[0] == 0) for g in got)


def test_truncating_step_rounds_toward_zero():
    one = torch.ones((1, 1), dtype=torch.float64)
    ulp = 2.0 ** -23          # fp32's, at 1
    a = torch.tensor([[1.0, ulp / 2] + [0.0] * 6], dtype=torch.float64)
    b = torch.ones((8, 1), dtype=torch.float64)
    # 1 + 1 + ulp/2 keeps 24 bits below 2: the half ulp at 1 is cut off
    assert float(hmma_truncating(one, a, b)) == 2.0
    assert float(hmma_truncating(-one, -a, b)) == -2.0
    assert float(hmma_nearest(one.float(), a.float(), b.float())) == 2.0


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t, lengths", CASES)
def test_1xtf32_backward_misses_1e4_of_the_largest_gradient(
        monkeypatch, t, lengths, d):
    lens = None if lengths is None else tuple(lengths)
    got, want = _emulated_grads(monkeypatch, matmul_1xtf32, t, d, lens)
    worst = max(float(np.abs(g - w).max() / np.abs(w).max())
                for g, w in zip(got, want))
    assert worst > 1e-4


def _errors_against_plain(b, t, h, d, causal, lengths, matmul, seed):
    """chip_smoke.py's K2 measure for an emulated backward: each gradient's
    max abs error against the plain fp32 backward over max(1, its largest
    element); q, k, v, dO ~ N(0, 1), BHTD."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, t, d), generator=gen)
                   for _ in range(4))
    lens = None if lengths is None else torch.tensor(lengths,
                                                     dtype=torch.int32)
    out, lse = pt_attn.flash_attention_plain(q, k, v, causal, None, lens,
                                             "bhtd")
    args = (q, k, v, out, lse, do, causal, None, lens, "bhtd")
    ref = pt_attn.flash_attention_bwd_plain(*args)
    torch.matmul = matmul
    try:
        got = pt_attn.flash_attention_bwd_plain(*args)
    finally:
        torch.matmul = _MATMUL
    return [float((g - r).abs().max()) / max(1.0, float(r.abs().max()))
            for g, r in zip(got, ref)]


def main():
    models = {"nearest": matmul_3xtf32,
              "truncating": functools.partial(matmul_3xtf32,
                                              hmma=hmma_truncating)}
    # (B, T, H, Dh, causal, lengths): chip_smoke.py's backward cases at
    # T 129 and 200
    cases = [(3, 129, 2, 128, False, [0, 1, 129]),
             (3, 129, 2, 64, True, [0, 1, 129]),
             (2, 129, 2, 128, False, None),
             (2, 200, 2, 128, True, None),
             (3, 200, 2, 128, False, [0, 77, 200])]
    print("case (B, T, H, Dh, causal, lengths); accumulator; worst of seeds "
          "0 and 1 of dq dk dv error / max(1, largest element)")
    for case in cases:
        for name, matmul in models.items():
            errs = np.max([_errors_against_plain(*case, matmul, seed)
                           for seed in (0, 1)], axis=0)
            print(case, name, " ".join("%.2e" % e for e in errs), flush=True)


if __name__ == "__main__":
    main()
