"""The port's CUDA kernels (K1 flash attention forward, K2 and K4 its
backward, K3 decode attention, and the bf16 twins K1-bf16, K2-bf16 and
K4-bf16) against their plain PyTorch versions, on the card. These tests
need a CUDA device and skip without one. This file imports neither JAX
nor the JAX package, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_kernels.py

Tolerance: 1e-4 abs at unit-scale inputs (fp32 sums in another order;
the products of K1, K2 and K4 in 3xTF32 on the tensor cores); for the
gradients, 1e-4 of each one's largest element (at least 1): they grow
with T, and K4 adds dq with atomics in an order that changes (K4-bf16
with TMA reductions, in an order that changes too). The bf16
kernels and their plain bf16 versions round at the same points, so both
are held to fp32 attention on the same bf16-valued inputs: the kernel's
error at most twice the plain version's and at most 8 bf16 ulps of the
largest element (below TOL of it, at least 1, both are fp32 sums in
another order), as chip_smoke.py holds them."""
import itertools
import math

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
    # around the kernel's split size and the slab's end (chip_smoke.py's
    # cases; "edges" is filled in with the split once the kernel is built)
    (8, 2048, 8, 128, "edges"),
    (8, 2048, 8, 64, "edges"),
])
def test_decode_kernel_matches_plain(card, b, s, h, d, lengths):
    if lengths == "edges":
        split = pt_kv.decode_kernel_split()
        lengths = [0, 1, split - 1, split, split + 1, s - 1, s, s + 1]
    g = torch.Generator(device=card).manual_seed(s)
    q = torch.randn((b, 1, h, d), generator=g, device=card)
    kc, vc = (torch.randn((b, s, h, d), generator=g, device=card)
              for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = pt_kv.decode_attention.launches
    out = pt_kv.decode_attention(q, kc, vc, lens)
    assert pt_kv.decode_attention.launches == before + 1
    again = pt_kv.decode_attention(q, kc, vc, lens)
    ref = pt_kv.decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= TOL
    assert torch.equal(out, again)  # whichever block merges
    for i, n in enumerate(lengths):
        if n == 0:
            assert bool((out[i] == 0).all())


def _decode_inputs(card, seed, b, s, h, d, lengths):
    g = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn((b, 1, h, d), generator=g, device=card),
            torch.randn((b, s, h, d), generator=g, device=card),
            torch.randn((b, s, h, d), generator=g, device=card),
            torch.tensor(lengths, dtype=torch.int32, device=card))


@pytest.mark.gpu
def test_decode_kernel_on_two_streams(card):
    """K3 keeps its per-(b, h) counters per stream: calls queued on two
    streams at once (same B*H) both match the plain version, and every
    counter ends at zero."""
    b, s, h, d = 8, 2048, 8, 128
    ins = [_decode_inputs(card, seed, b, s, h, d, lengths)
           for seed, lengths in (
               (1, [2048, 1, 700, 64, 65, 0, 1500, 129]),
               (2, [1000, 2048, 3, 640, 128, 0, 63, 2047]))]
    streams = [torch.cuda.Stream(card) for _ in ins]
    assert streams[0].cuda_stream != streams[1].cuda_stream
    outs = [[], []]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(card))
    for _ in range(20):
        for st, args, got in zip(streams, ins, outs):
            with torch.cuda.stream(st):
                got.append(pt_kv.decode_attention(*args))
    torch.cuda.synchronize()
    for args, got in zip(ins, outs):
        ref = pt_kv.decode_attention_plain(*args)
        for out in got:
            assert float((out - ref).abs().max()) <= TOL
    for st in streams:
        assert not pt_kv._COUNTERS[(card.index, st.cuda_stream, b * h)].any()


@pytest.mark.gpu
def test_decode_kernel_in_cuda_graph(card, monkeypatch):
    """A stream K3 has run on can be captured: the replays match the
    plain version. Counters are never made while a stream is captured
    (they would come from the graph's memory, zeroed only by a replay)."""
    args = _decode_inputs(card, 3, 4, 512, 2, 64, [0, 1, 300, 512])
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        pt_kv.decode_attention(*args)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = pt_kv.decode_attention(*args)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    ref = pt_kv.decode_attention_plain(*args)
    assert float((out - ref).abs().max()) <= TOL
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="before capturing"):
        pt_kv._counters(card, 7919)  # a B*H no call has used


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


def _bf16_ok(got, plain, ref):
    """bf16 kernel output ``got`` and its plain version ``plain`` against
    the fp32 ``ref`` (see the module note)."""
    err = float((got.float() - ref).abs().max())
    plain_err = float((plain.float() - ref).abs().max())
    big = float(ref.abs().max())
    floor = TOL * max(1.0, big)
    ulp = 2.0 ** (math.floor(math.log2(max(big, 1e-30))) - 7)
    return (bool(torch.isfinite(got).all()) and err <= max(8 * ulp, floor)
            and err <= max(2 * plain_err, floor))


def _bf16_case(card, seed, b, t, h, d, causal, layout, lengths):
    g = torch.Generator(device=card).manual_seed(seed)
    shape = (b, t, h, d) if layout == "bthd" else (b, h, t, d)
    q, k, v, do = (torch.randn(shape, generator=g, device=card).bfloat16()
                   for _ in range(4))
    lens = None if lengths is None else torch.tensor(
        lengths, dtype=torch.int32, device=card)
    return q, k, v, do, lens


def _bf16_refs(q, k, v, do, causal, lens, layout):
    """The plain bf16 forward and backward, and fp32 attention's, on the
    same inputs: ((out, dq, dk, dv) plain, (...) fp32)."""
    out, lse = pt_attn.flash_attention_plain(q, k, v, causal, None, lens,
                                             layout)
    plain = (out,) + pt_attn.flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal, None, lens, layout)
    f = [x.float() for x in (q, k, v, do)]
    out32, lse32 = pt_attn.flash_attention_plain(*f[:3], causal, None, lens,
                                                 layout)
    ref = (out32,) + pt_attn.flash_attention_bwd_plain(
        *f[:3], out32, lse32, f[3], causal, None, lens, layout)
    return plain, ref


_BF16_WRAPPERS = ("flash_attention_fwd_bf16", "flash_attention_bwd_dq_bf16",
                  "flash_attention_bwd_dkv_bf16",
                  "flash_attention_bwd_fused_bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("b, t, h, d, causal, layout, lengths", [
    (2, 1024, 4, 64, True, "bthd", None),
    (2, 1024, 2, 128, True, "bthd", None),
    (3, 200, 2, 128, False, "bthd", None),
    (2, 333, 3, 64, True, "bhtd", None),
    (3, 200, 4, 64, True, "bhtd", [0, 77, 200]),
] + [
    (2, t, 2, d, causal, layout, None) for t, d, causal, layout in
    itertools.product((129, 1), (64, 128), (True, False), ("bthd", "bhtd"))
] + [
    (3, 129, 2, 128, True, "bthd", [0, 1, 129]),
    (3, 129, 2, 64, False, "bhtd", [0, 1, 129]),
] + [
    # T at the edges of the kernels' 64- and 128-row tiles
    (2, t, 2, d, causal, layout, None) for t, d, causal, layout in
    itertools.product((63, 64, 65, 127, 128, 191, 193), (64, 128),
                      (True, False), ("bthd", "bhtd"))
] + [
    # KV lengths one key before and one after a 64- and a 128-key edge
    (4, 193, 2, d, causal, "bthd" if causal else "bhtd", [63, 65, 127, 129])
    for d, causal in itertools.product((64, 128), (True, False))
] + [
    # one batch or one head: a tensor map's axis of size 1
    (b, 129, h, d, causal, layout, None) for (b, h), d, causal, layout in
    itertools.product(((1, 3), (3, 1)), (64, 128), (True, False),
                      ("bthd", "bhtd"))
] + [
    (1, 193, 2, 64, True, "bthd", [65]),
    (1, 193, 1, 128, False, "bhtd", [129]),
])
def test_bf16_flash_kernels_match_plain(card, b, t, h, d, causal, layout,
                                        lengths):
    """K1-bf16, then K2-bf16 (dq, dk/dv) and K4-bf16 on its out and lse,
    each launched once through the dtype-dispatching wrappers."""
    q, k, v, do, lens = _bf16_case(card, t + d, b, t, h, d, causal, layout,
                                   lengths)
    counts = [getattr(pt_attn, n).launches for n in _BF16_WRAPPERS]
    out, lse = pt_attn.flash_attention_fwd(q, k, v, causal, None, lens,
                                           layout)
    delta = pt_attn.attention_delta(out, do, layout)
    args = (q, k, v, lse, delta, do, causal, None, lens, layout)
    split = (pt_attn.flash_attention_bwd_dq(*args),) + \
        pt_attn.flash_attention_bwd_dkv(*args)
    fused = pt_attn.flash_attention_bwd_fused(*args)
    assert [getattr(pt_attn, n).launches for n in _BF16_WRAPPERS] == \
        [n + 1 for n in counts]
    plain, ref = _bf16_refs(q, k, v, do, causal, lens, layout)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _bf16_ok(out, plain[0], ref[0])
    for got in (split, fused):
        for gr, p, r in zip(got, plain[1:], ref[1:]):
            assert gr.dtype == torch.bfloat16 and _bf16_ok(gr, p, r)
    for i, n in enumerate(lengths or []):
        if n == 0:
            assert bool((out[i] == 0).all())
            assert all(bool((gr[i] == 0).all()) for gr in split + fused)


@pytest.mark.gpu
@pytest.mark.parametrize("b, t, h, d, causal, layout, lengths", [
    (2, 300, 4, 64, True, "bthd", None),
    (2, 193, 2, 128, False, "bhtd", [193, 65]),
    (3, 1024, 2, 64, True, "bhtd", None),
])
def test_bf16_kernels_repeat_bitwise(card, b, t, h, d, causal, layout,
                                     lengths):
    """K1-bf16 and K2-bf16 (dq, dk/dv) sum in a fixed order, without
    atomics, and K4-bf16 sums dk and dv in registers per block: two calls
    on the same inputs give the same bits (K4-bf16's dq is added across
    blocks in an order that changes)."""
    q, k, v, do, lens = _bf16_case(card, 7, b, t, h, d, causal, layout,
                                   lengths)

    def run():
        out, lse = pt_attn.flash_attention_fwd(q, k, v, causal, None, lens,
                                               layout)
        delta = pt_attn.attention_delta(out, do, layout)
        args = (q, k, v, lse, delta, do, causal, None, lens, layout)
        return (out, lse, pt_attn.flash_attention_bwd_dq(*args)) + \
            pt_attn.flash_attention_bwd_dkv(*args) + \
            pt_attn.flash_attention_bwd_fused(*args)[1:]

    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def _bf16_step(q, k, v, do, causal, lens, layout):
    out, lse = pt_attn.flash_attention_fwd(q, k, v, causal, None, lens,
                                           layout)
    return (out,) + pt_attn.flash_attention_bwd(q, k, v, out, lse, do,
                                                causal, None, lens, layout)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True], ids=["K2", "K4"])
def test_bf16_kernels_on_two_streams(card, monkeypatch, fused):
    """The bf16 forward and backward queued on two streams at once, 10
    times each, other inputs on each: every result matches its plain
    version."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_FUSED_BWD", "1" if fused else "0")
    ins = [_bf16_case(card, seed, 2, 300, 4, 64, True, "bthd", lengths)
           for seed, lengths in ((1, None), (2, [300, 77]))]
    streams = [torch.cuda.Stream(card) for _ in ins]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(card))
    outs = [[], []]
    for _ in range(10):
        for st, (q, k, v, do, lens), got in zip(streams, ins, outs):
            with torch.cuda.stream(st):
                got.append(_bf16_step(q, k, v, do, True, lens, "bthd"))
    torch.cuda.synchronize()
    for (q, k, v, do, lens), got in zip(ins, outs):
        plain, ref = _bf16_refs(q, k, v, do, True, lens, "bthd")
        for res in got:
            assert all(_bf16_ok(g, p, r)
                       for g, p, r in zip(res, plain, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True], ids=["K2", "K4"])
def test_bf16_kernels_in_cuda_graph(card, monkeypatch, fused):
    """The bf16 forward and backward captured in a CUDA graph after a
    warm-up on the capturing stream: two replays match the plain
    version."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_FUSED_BWD", "1" if fused else "0")
    q, k, v, do, lens = _bf16_case(card, 5, 2, 256, 2, 128, True, "bhtd",
                                   None)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        _bf16_step(q, k, v, do, True, lens, "bhtd")
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = _bf16_step(q, k, v, do, True, lens, "bhtd")
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    plain, ref = _bf16_refs(q, k, v, do, True, lens, "bhtd")
    assert all(_bf16_ok(g, p, r) for g, p, r in zip(got, plain, ref))
