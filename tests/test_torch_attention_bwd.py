"""The backward of the port's differentiable flash attention
(paddle_tpu_torch.ops.attention.FlashAttention, whose CPU path is the
plain version of kernels K2 and K4) against the JAX package's, on the CPU:
``jax.vjp`` of the Pallas kernels run in interpret mode — the split dq/dkv
kernels (K2) and, with PADDLE_TPU_FLASH_FUSED_BWD=1, the single-pass
kernel (K4) — in the BTHD layout (Dh 128) and the BHTD layout (Dh 64) at
T=256, causal and not; and the vjp of the XLA ``flash_attention`` with KV
lengths, a length-0 row included (zero gradients, no NaN).

Tolerance: 2e-5 abs / 1e-4 rel on dq, dk, dv (fp32 on both sides; the
gradients sum T terms in another order). The CUDA kernels themselves are
held against this plain version on the card (tests/test_torch_gpu_
kernels.py, chip_smoke.py)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops import attention as jax_attn  # noqa: E402
from paddle_tpu_torch.ops import attention as pt_attn  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(shape, seed):
    r = np.random.RandomState(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _port_grads(q, k, v, do, causal, layout, lengths=None):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    lens = None if lengths is None else torch.from_numpy(lengths)
    out = pt_attn.FlashAttention.apply(tq, tk, tv, lens, causal, None, layout)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("fused", [False, True], ids=["K2", "K4"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
def test_backward_matches_pallas_kernels_interpret(monkeypatch, layout,
                                                   causal, fused):
    """BTHD: pallas_flash_attention_bthd (B=1, T=256, H=2, Dh=128); BHTD:
    pallas_flash_attention (B=1, H=2, T=256, Dh=64); blocks of 128, so
    the kernels loop over two q and two KV blocks."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_FUSED_BWD", "1" if fused else "0")
    if layout == "bthd":
        shape, entry = (1, 256, 2, 128), jax_attn.pallas_flash_attention_bthd
    else:
        shape, entry = (1, 2, 256, 64), jax_attn.pallas_flash_attention
    q, k, v, do = _inputs(shape, seed=7 + causal + 2 * fused)

    def fn(q, k, v):
        return entry(q, k, v, causal=causal, block_q=128, block_k=128,
                     interpret=True)

    want_out, want = _jax_grads(fn, q, k, v, do)
    got_out, got = _port_grads(q, k, v, do, causal, layout)
    np.testing.assert_allclose(got_out, want_out, atol=1e-5, rtol=1e-5)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg="d" + name, **TOL)


_LENS = np.array([40, 17, 0], np.int32)


@functools.lru_cache(maxsize=None)
def _xla_lengths_case():
    """Inputs (B=3, H=2, T=40, Dh=16, BHTD) and the XLA vjp's grads."""
    q, k, v, do = _inputs((3, 2, 40, 16), seed=5)

    def fn(q, k, v):
        return jax_attn.flash_attention(q, k, v, causal=True,
                                        lengths=jnp.asarray(_LENS),
                                        block_k=16)

    return (q, k, v, do), _jax_grads(fn, q, k, v, do)[1]


@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
def test_backward_with_lengths_matches_xla_and_empty_rows_are_zero(layout):
    """Keys at or past a row's length get no gradient; a row of length 0
    (every key masked, lse -inf) gets zero gradients everywhere."""
    (q, k, v, do), want = _xla_lengths_case()
    lens = _LENS
    if layout == "bthd":
        q, k, v, do = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v, do))
    _out, got = _port_grads(q, k, v, do, True, layout, lens)
    if layout == "bthd":
        got = [g.transpose(0, 2, 1, 3) for g in got]
    for name, g, w in zip("qkv", got, want):
        assert np.isfinite(g).all(), "d" + name
        np.testing.assert_allclose(g, w, err_msg="d" + name, **TOL)
        assert np.all(g[2] == 0), "d%s of the length-0 row" % name
    # keys past the length of row 1 have no gradient
    assert np.all(got[1][1, :, 17:] == 0) and np.all(got[2][1, :, 17:] == 0)


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs((2, 33, 2, 64), 3))
    out, lse = pt_attn.flash_attention_fwd(q, k, v, causal=True)
    before = [f.launches for f in (pt_attn.flash_attention_bwd_dq,
                                   pt_attn.flash_attention_bwd_dkv,
                                   pt_attn.flash_attention_bwd_fused)]
    ref = pt_attn.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    delta = pt_attn.attention_delta(out, do)
    args = (q, k, v, lse, delta, do, True)
    split = (pt_attn.flash_attention_bwd_dq(*args),) + \
        pt_attn.flash_attention_bwd_dkv(*args)
    for got in (split, pt_attn.flash_attention_bwd_fused(*args),
                pt_attn.flash_attention_bwd(q, k, v, out, lse, do, True)):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert before == [f.launches for f in (pt_attn.flash_attention_bwd_dq,
                                           pt_attn.flash_attention_bwd_dkv,
                                           pt_attn.flash_attention_bwd_fused)]
