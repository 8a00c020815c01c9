"""Kernel K3's plain PyTorch version (paddle_tpu_torch.ops.kv_cache)
against the JAX package's ``decode_attention_reference`` and its Pallas
kernel in interpret mode, on the CPU, with slot lengths 0, 1, a partial
block and the full slab; the arithmetic of the CUDA kernel's partition
(``_k3_schedule`` below) against the same two; and cache_append /
cache_gather parity.

Tolerance: 1e-5 abs / 1e-5 rel (fp32 both sides, sums in another order).
The CUDA kernel itself is held against this plain version on the card
(tests/test_torch_gpu_kernels.py, chip_smoke.py)."""
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops import kv_cache as jax_kv  # noqa: E402
from paddle_tpu_torch.ops import kv_cache as pt_kv  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "paddle_tpu_torch", "csrc", "decode_attn.cu")


def _k3_constant(name):
    """The kernel's default SPLIT or WARPS (its ``DECODE_ATTN_*`` macro;
    on the card, ``decode_attn_split()`` and ``decode_attn_warps()``)."""
    with open(_CU) as f:
        return int(re.search(r"#define DECODE_ATTN_%s (\d+)" % name,
                             f.read()).group(1))


def _merge(part, mp, lp, ap):
    """The kernel's online merge of partial (mp, lp, ap) into ``part``, in
    log2 units; an empty partial changes nothing."""
    m, l, acc = part
    mn = torch.maximum(m, mp)
    if mn == -math.inf:
        return part
    a, c = torch.exp2(m - mn), torch.exp2(mp - mn)
    return mn, lp * c + l * a, ap * c + acc * a


def _k3_schedule(q, k, v, lengths):
    """csrc/decode_attn.cu's partition in fp32 PyTorch: SPLIT keys a block,
    KW = SPLIT / WARPS a warp; a warp's partial, the block's in warp order,
    a slot's one live block written at once, else its live blocks'
    partials merged in split order (warp w taking partials w, w + WARPS,
    ..., then the warps in order); blocks past the length skipped, a
    slot of length 0 zeros. Test-only: nothing in the package uses it."""
    split, warps = _k3_constant("SPLIT"), _k3_constant("WARPS")
    kw = split // warps
    b, _one, h, d = q.shape
    s = k.shape[1]
    empty = (torch.tensor(-math.inf), torch.tensor(0.0), torch.zeros(d))
    out = torch.zeros(b, 1, h, d)
    for bi in range(b):
        n = max(0, min(int(lengths[bi]), s))
        n_live = -(-n // split)
        for hi in range(h):
            qs = q[bi, 0, hi] * (1.0 / math.sqrt(d)) * math.log2(math.e)
            parts = []
            for sp in range(n_live):
                blk = []
                for w in range(warps):
                    j0 = sp * split + w * kw
                    j1 = min(j0 + kw, n)
                    if j1 <= j0:
                        blk.append(empty)
                        continue
                    sc = k[bi, j0:j1, hi] @ qs
                    m = sc.max()
                    p = torch.exp2(sc - m)
                    blk.append((m, p.sum(), p @ v[bi, j0:j1, hi]))
                part = empty
                for w in range(warps):
                    part = _merge(part, *blk[w])
                parts.append(part)
            if n_live == 1:
                m, l, acc = parts[0]
            elif n_live > 1:
                per_warp = []
                for w in range(warps):
                    part = empty
                    for p in parts[w::warps]:
                        part = _merge(part, *p)
                    per_warp.append(part)
                part = empty
                for w in range(warps):
                    part = _merge(part, *per_warp[w])
                m, l, acc = part
            if n_live:
                out[bi, 0, hi] = acc / l
    return out


def _inputs(b, s, h, d, seed):
    r = np.random.RandomState(seed)
    q = r.standard_normal((b, 1, h, d)).astype(np.float32)
    k = r.standard_normal((b, s, h, d)).astype(np.float32)
    v = r.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("d", [16, 128])
def test_plain_matches_reference_and_pallas(d):
    b, s, h = 4, 256, 2
    q, k, v = _inputs(b, s, h, d, seed=d)
    lens = np.array([0, 1, 100, s], np.int32)   # empty, one, partial, full
    jq, jk, jv, jl = (jnp.asarray(x) for x in (q, k, v, lens))
    want = np.asarray(jax_kv.decode_attention_reference(jq, jk, jv, jl))
    got = pt_kv.decode_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v, lens))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[0] == 0)
    if d == 128:
        kern = np.asarray(jax_kv.pallas_decode_attention(
            jq, jk, jv, jl, block_s=128, interpret=True))
        np.testing.assert_allclose(got, kern, **TOL)
    # on CPU tensors the wrapper is the plain version, and counts nothing
    before = pt_kv.decode_attention.launches
    wrapped = pt_kv.decode_attention(
        *(torch.from_numpy(x) for x in (q, k, v, lens)))
    assert pt_kv.decode_attention.launches == before
    np.testing.assert_array_equal(wrapped.numpy(), got)


def test_k3_partition_matches_reference_and_pallas():
    """The kernel's split-and-merge arithmetic at slot lengths around its
    split size and the slab's end, against the XLA reference and the
    Pallas kernel (interpret mode), at the shapes of the test above."""
    split = _k3_constant("SPLIT")
    b, s, h, d = 4, 256, 2, 128
    q, k, v = _inputs(b, s, h, d, seed=7)
    for lens in ([0, 1, split - 1, split + 1], [split, s, 2 * split + 1,
                                               s - 1]):
        lens = np.array(lens, np.int32)
        jq, jk, jv, jl = (jnp.asarray(x) for x in (q, k, v, lens))
        got = _k3_schedule(*(torch.from_numpy(x) for x in (q, k, v)),
                           lens).numpy()
        np.testing.assert_allclose(got, np.asarray(
            jax_kv.decode_attention_reference(jq, jk, jv, jl)), **TOL)
        np.testing.assert_allclose(got, np.asarray(
            jax_kv.pallas_decode_attention(jq, jk, jv, jl, block_s=128,
                                           interpret=True)), **TOL)
        assert np.all(got[lens == 0] == 0)


@pytest.mark.parametrize("new_ndim", [3, 4])
def test_cache_append_matches_jax_in_place(new_ndim):
    r = np.random.RandomState(5)
    b, s, h, d = 3, 8, 2, 4
    cache = r.standard_normal((b, s, h, d)).astype(np.float32)
    new = r.standard_normal((b, 1, h, d) if new_ndim == 4
                            else (b, h, d)).astype(np.float32)
    pos = np.array([0, 5, 9], np.int32)          # 9 clips to the last row
    want = np.asarray(jax_kv.cache_append(jnp.asarray(cache),
                                          jnp.asarray(new),
                                          jnp.asarray(pos)))
    slab = torch.from_numpy(cache.copy())
    out = pt_kv.cache_append(slab, torch.from_numpy(new),
                             torch.from_numpy(pos))
    assert out is slab                           # written in place
    np.testing.assert_array_equal(out.numpy(), want)
    with pytest.raises(ValueError, match="ONE row"):
        pt_kv.cache_append(slab, torch.zeros(b, 2, h, d),
                           torch.from_numpy(pos))


def test_cache_gather_matches_jax():
    r = np.random.RandomState(6)
    cache = r.standard_normal((4, 5, 2, 3)).astype(np.float32)
    idx = np.array([2, 2, 0], np.int32)
    want = np.asarray(jax_kv.cache_gather(jnp.asarray(cache),
                                          jnp.asarray(idx)))
    got = pt_kv.cache_gather(torch.from_numpy(cache), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
