"""The port's CUDA kernels (K1 flash attention forward, K2 and K4 its
backward, K3 decode attention) against their plain PyTorch versions, on
the card. These tests
need a CUDA device and skip without one. This file imports neither JAX
nor the JAX package, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_kernels.py

Tolerance: 1e-4 abs at unit-scale inputs (fp32 sums in another order;
the products of K1, K2 and K4 in 3xTF32 on the tensor cores); for the
gradients, 1e-4 of each one's largest element (at least 1): they grow
with T, and K4 adds dq with atomics in an order that changes."""
import itertools

import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.ops import attention as pt_attn  # noqa: E402
from paddle_tpu_torch.ops import kv_cache as pt_kv  # noqa: E402

TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("b, t, h, d, causal, layout, lengths", [
    (2, 1024, 4, 128, True, "bthd", None),
    (3, 200, 2, 128, False, "bthd", None),
    (2, 333, 3, 64, True, "bhtd", None),
    (3, 130, 2, 64, False, "bthd", [0, 1, 129]),
] + [
    # one row past a 128-row tile, and a single row (chip_smoke.py's cases)
    (2, t, 2, d, causal, layout, None) for t, d, causal, layout in
    itertools.product((129, 1), (64, 128), (True, False), ("bthd", "bhtd"))
] + [
    (3, 129, 2, 128, True, "bthd", [0, 1, 129]),
    (3, 129, 2, 128, False, "bhtd", [0, 1, 129]),
])
def test_flash_kernel_matches_plain(card, b, t, h, d, causal, layout,
                                    lengths):
    g = torch.Generator(device=card).manual_seed(t)
    shape = (b, t, h, d) if layout == "bthd" else (b, h, t, d)
    q, k, v = (torch.randn(shape, generator=g, device=card)
               for _ in range(3))
    lens = None if lengths is None else torch.tensor(
        lengths, dtype=torch.int32, device=card)
    before = pt_attn.flash_attention_fwd.launches
    out, lse = pt_attn.flash_attention_fwd(q, k, v, causal=causal,
                                           lengths=lens, layout=layout)
    assert pt_attn.flash_attention_fwd.launches == before + 1
    ref, ref_lse = pt_attn.flash_attention_plain(q, k, v, causal=causal,
                                                 lengths=lens, layout=layout)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= TOL
    for i, n in enumerate(lengths or []):
        if n == 0:
            assert bool((out[i] == 0).all())
    live = torch.isfinite(ref_lse)
    assert bool((torch.isfinite(lse) == live).all())
    assert float((lse[live] - ref_lse[live]).abs().max()) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("b, s, h, d, lengths", [
    (4, 2048, 8, 128, [0, 1, 1000, 2048]),
    (3, 300, 2, 64, [7, 256, 300]),
])
def test_decode_kernel_matches_plain(card, b, s, h, d, lengths):
    g = torch.Generator(device=card).manual_seed(s)
    q = torch.randn((b, 1, h, d), generator=g, device=card)
    kc, vc = (torch.randn((b, s, h, d), generator=g, device=card)
              for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = pt_kv.decode_attention.launches
    out = pt_kv.decode_attention(q, kc, vc, lens)
    assert pt_kv.decode_attention.launches == before + 1
    ref = pt_kv.decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= TOL
    for i, n in enumerate(lengths):
        if n == 0:
            assert bool((out[i] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b, t, h, d, causal, layout, lengths", [
    (2, 200, 4, 64, False, "bthd", None),
    (2, 200, 2, 128, True, "bthd", None),
    (3, 200, 4, 64, True, "bhtd", [0, 77, 200]),
    (3, 200, 2, 128, False, "bthd", [0, 77, 200]),
    (2, 1024, 4, 64, True, "bhtd", None),
] + [
    # one row past a 128-row tile, and a single row (chip_smoke.py's cases)
    (2, t, 2, d, causal, layout, None) for t, d, causal, layout in
    itertools.product((129, 1), (64, 128), (True, False), ("bthd", "bhtd"))
] + [
    (3, 129, 2, 64, True, "bthd", [0, 1, 129]),
    (3, 129, 2, 128, False, "bhtd", [0, 1, 129]),
])
def test_flash_backward_kernels_match_plain(card, b, t, h, d, causal, layout,
                                            lengths):
    g = torch.Generator(device=card).manual_seed(t + d)
    shape = (b, t, h, d) if layout == "bthd" else (b, h, t, d)
    q, k, v, do = (torch.randn(shape, generator=g, device=card)
                   for _ in range(4))
    lens = None if lengths is None else torch.tensor(
        lengths, dtype=torch.int32, device=card)
    out, lse = pt_attn.flash_attention_fwd(q, k, v, causal=causal,
                                           lengths=lens, layout=layout)
    ref = pt_attn.flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                            None, lens, layout)
    delta = pt_attn.attention_delta(out, do, layout)
    args = (q, k, v, lse, delta, do, causal, None, lens, layout)
    counts = [f.launches for f in (pt_attn.flash_attention_bwd_dq,
                                   pt_attn.flash_attention_bwd_dkv,
                                   pt_attn.flash_attention_bwd_fused)]
    split = (pt_attn.flash_attention_bwd_dq(*args),) + \
        pt_attn.flash_attention_bwd_dkv(*args)
    fused = pt_attn.flash_attention_bwd_fused(*args)
    assert [f.launches for f in (pt_attn.flash_attention_bwd_dq,
                                 pt_attn.flash_attention_bwd_dkv,
                                 pt_attn.flash_attention_bwd_fused)] == \
        [n + 1 for n in counts]
    torch.cuda.synchronize()
    for got in (split, fused):
        for gr, r in zip(got, ref):
            assert bool(torch.isfinite(gr).all())
            scale = max(1.0, float(r.abs().max()))
            assert float((gr - r).abs().max()) <= TOL * scale
        for i, n in enumerate(lengths or []):
            if n == 0:
                assert all(bool((gr[i] == 0).all()) for gr in got)
