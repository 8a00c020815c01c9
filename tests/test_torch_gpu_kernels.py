"""The port's CUDA kernels (K1 flash attention forward, K2 and K4 its
backward, K3 decode attention, and the bf16 twins K1-bf16, K2-bf16 and
K4-bf16) against their plain PyTorch versions, on the card, and the
Engine's graph steps (serving/engine.py) and the executor's captured
training step against their eager functions.
These tests need a CUDA device and skip without one. This file imports neither JAX
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


# each attention wrapper's kernel: its library and its counter's place there
_COUNTERS = {"flash_attention_fwd": ("flash_fwd", 0),
             "flash_attention_bwd_dq": ("flash_bwd", 0),
             "flash_attention_bwd_dkv": ("flash_bwd", 1),
             "flash_attention_bwd_fused": ("flash_bwd_fused", 0),
             "flash_attention_fwd_bf16": ("flash_fwd_bf16", 0),
             "flash_attention_bwd_dq_bf16": ("flash_bwd_bf16", 0),
             "flash_attention_bwd_dkv_bf16": ("flash_bwd_bf16", 1),
             "flash_attention_bwd_fused_bf16": ("flash_bwd_fused_bf16", 0)}


def _counts():
    """(host, device) launch counts of every attention kernel, by wrapper."""
    from paddle_tpu_torch.kernels import launch_counts

    torch.cuda.synchronize()
    dev = {src: launch_counts(src)
           for src in {src for src, _ in _COUNTERS.values()}}
    return ({w: getattr(pt_attn, w).launches for w in _COUNTERS},
            {w: dev[src][i] for w, (src, i) in _COUNTERS.items()})


def _minus(a, b):
    return {w: a[w] - b[w] for w in a}


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True], ids=["K2", "K4"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_device_counts_each_launch_and_each_replay(card, monkeypatch, bf16,
                                                   fused):
    """A kernel's counter on the device (csrc/launch_count.cuh) adds one
    per launch: on an eager forward and backward, what the wrappers' host
    counts add; a capture adds nothing; each replay adds one per kernel
    of the step, where the host counts nothing."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_FUSED_BWD", "1" if fused else "0")
    q, k, v, do, lens = _bf16_case(card, 3, 2, 256, 2, 64, True, "bthd",
                                   None)
    if not bf16:
        q, k, v, do = (x.float() for x in (q, k, v, do))
    names = ["flash_attention_fwd"] + (
        ["flash_attention_bwd_fused"] if fused else
        ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"])
    one = {w: int(w in [n + "_bf16" if bf16 else n for n in names])
           for w in _COUNTERS}
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    host0, dev0 = _counts()
    with torch.cuda.stream(side):
        _bf16_step(q, k, v, do, True, lens, "bthd")
    torch.cuda.current_stream(card).wait_stream(side)
    host1, dev1 = _counts()
    assert _minus(dev1, dev0) == _minus(host1, host0) == one
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        _bf16_step(q, k, v, do, True, lens, "bthd")
    host2, dev2 = _counts()
    assert dev2 == dev1
    for _ in range(3):
        graph.replay()
    host3, dev3 = _counts()
    assert host3 == host2
    assert _minus(dev3, dev2) == {w: 3 * n for w, n in one.items()}


@pytest.mark.gpu
def test_device_counts_decode_replays(card):
    """K3's counter on the device adds one per eager launch, as its
    wrapper's host count does, and one per replay of a captured launch."""
    from paddle_tpu_torch.kernels import launch_counts

    args = _decode_inputs(card, 5, 3, 256, 2, 64, [0, 1, 256])
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    torch.cuda.synchronize()
    host0, dev0 = pt_kv.decode_attention.launches, launch_counts(
        "decode_attn")[0]
    with torch.cuda.stream(side):
        pt_kv.decode_attention(*args)
    torch.cuda.current_stream(card).wait_stream(side)
    torch.cuda.synchronize()
    assert launch_counts("decode_attn")[0] - dev0 == 1
    assert pt_kv.decode_attention.launches - host0 == 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        pt_kv.decode_attention(*args)
    host1 = pt_kv.decode_attention.launches
    for _ in range(4):
        graph.replay()
    torch.cuda.synchronize()
    assert launch_counts("decode_attn")[0] - dev0 == 5
    assert pt_kv.decode_attention.launches == host1


# ---------------------------------------------------------------------------
# the Engine's graph steps (serving/engine.py) on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_lm(card, tmp_path):
    """A DecodePredictor on the card over a 2-layer LM (2 heads of 64)
    with random weights from a seed, exported by the port."""
    import numpy as np
    from paddle_tpu_torch import (CUDAPlace, Program, Scope, program_guard,
                                  unique_name)
    from paddle_tpu_torch.serving import decode as D

    cfg = D.DecodeConfig(vocab_size=97, n_layer=2, n_head=2, d_model=128,
                         d_inner=256, max_len=128)
    prog, startup = Program(), Program()
    with program_guard(prog, startup):
        with unique_name.guard():
            D._prefill_graph(cfg, 1, 16)
    rng = np.random.default_rng(0)
    scope = Scope()
    for op in startup.global_block().ops:
        name, shape = op.output("Out")[0], tuple(op.attr("shape"))
        if op.type == "gaussian_random":
            val = rng.standard_normal(shape).astype(np.float32) * 0.1
        else:
            val = np.full(shape, op.attr("value"), np.float32)
        scope.set_var(name, val)
    D.save_decode_model(str(tmp_path), cfg, None, scope=scope)
    return D.DecodePredictor(str(tmp_path), place=CUDAPlace(0))


def _clone(outs):
    return [o.clone() for o in outs]


def _decode_step_feeds(pred, slabs, tokens, lens, seed):
    import numpy as np

    bb = tokens.shape[0]
    feeds = {"tokens": tokens.reshape(bb, 1).astype(np.int64),
             "positions": lens.reshape(bb, 1).astype(np.int64),
             "lengths": lens, "seed": np.array([seed], np.int64)}
    for i in range(pred.config.n_layer):
        feeds["kcache_%d" % i] = slabs[2 * i]
        feeds["vcache_%d" % i] = slabs[2 * i + 1]
    return feeds


@pytest.mark.gpu
def test_captured_steps_match_their_eager_functions(tiny_lm):
    """The prefill and decode steps replayed from their CUDA graphs give
    their eager functions' outputs bitwise (K1 and K3 repeat bitwise, and
    cuBLAS picks the same kernels under capture); a replay after the feeds
    change gives the new answer."""
    import numpy as np

    pred = tiny_lm
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 97, n) for n in (20, 9, 13)]
    tokens, lens, _b, s = pred._bucketed(prompts, 6)
    bb, sp = tokens.shape[0], 32
    pstep, _ = pred.acquire("prefill", bb, sp)
    feeds = {"tokens": tokens[:, :sp], "lengths": lens}
    graph = pstep(feeds, read=_clone)
    eager = pstep.run_eager(feeds, read=_clone)
    assert pstep.captures == 1 and pstep.captured
    for g, e in zip(graph, eager):
        assert torch.equal(g, e)

    dstep, _ = pred.acquire("decode", bb, s)
    slabs = pred._slabs(dstep)
    pred._prefill(tokens, lens, s, slabs)
    saved = [x.clone() for x in slabs]
    results = []
    for first in (tokens[:, 0].copy(), tokens[:, 1].copy()):
        step_feeds = _decode_step_feeds(pred, slabs, first, lens.copy(), 1)
        got = dstep(step_feeds, read=_clone)
        for x, y in zip(slabs, saved):
            x.copy_(y)
        want = dstep.run_eager(step_feeds, read=_clone)
        for x, y in zip(slabs, saved):
            x.copy_(y)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        results.append(got)
    assert dstep.captures == 1 and dstep.replays == 2
    assert not torch.equal(results[0][1], results[1][1])   # new logits
    assert pred.traces == 4   # two steps built, two graphs captured


@pytest.mark.gpu
def test_draft_verify_and_int8_steps_match_their_eager_functions(tiny_lm):
    """The draft and verify steps, captured over their decode step's own
    slabs (same data_ptr), and the int8 decode step: each replay equals
    its eager function on the same buffers bitwise (each step writes the
    same rows each call); speculative and beam generates run on the card,
    speculative equal to greedy."""
    import numpy as np

    pred = tiny_lm
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 97, n) for n in (20, 9, 13)]
    tokens, lens, _b, s = pred._bucketed(prompts, 8)
    bb, t = tokens.shape[0], 5
    dstep, _ = pred.acquire("decode", bb, s)
    pred._prefill(tokens, lens, s, pred._slabs(dstep))
    draft, _ = pred.acquire("draft", bb, s, lender=dstep)
    verify, _ = pred.acquire("verify", bb, s, window=t, lender=dstep)
    for step in (draft, verify):
        assert step.lender is dstep
        assert all(step.static[n].data_ptr() == dstep.static[n].data_ptr()
                   for n in step.static if "cache_" in n)
    common = {"lengths": lens, "tokens": tokens[:, :1]}
    draft_feeds = dict(common, positions=lens.reshape(bb, 1).astype(
        np.int64), seed=np.zeros((1,), np.int64))
    verify_feeds = {"tokens": tokens[:, :t], "lengths": lens,
                    "positions": (lens[:, None] + np.arange(t)).astype(
                        np.int64),
                    "last_idx": np.full((bb,), t - 1, np.int32)}
    q8, _ = pred.acquire("decode", bb, s, kv_dtype="int8")
    q8_feeds = {"tokens": tokens[:, :1], "lengths": lens,
                "positions": lens.reshape(bb, 1).astype(np.int64),
                "seed": np.zeros((1,), np.int64)}
    for name in q8.static:
        if "cache_" in name or "scale_" in name:
            q8.static[name].copy_(torch.randint(
                -127, 128, q8.static[name].shape, device="cuda")
                if "cache_" in name else torch.rand(
                    q8.static[name].shape, device="cuda") * 0.02)
    for step, feeds in ((draft, draft_feeds), (verify, verify_feeds),
                        (q8, q8_feeds)):
        feeds = dict(feeds)
        feeds.update({n: b for n, b in step.static.items()
                      if "cache_" in n or "scale_" in n})
        got = step(feeds, read=_clone)
        want = step.run_eager(feeds, read=_clone)
        assert step.captured
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    spec = pred.generate(prompts, 8, speculative=True, spec_k=4)
    for g, w in zip(spec, pred.generate(prompts, 8)):
        assert np.array_equal(g, w)
    assert len(pred.generate(prompts[:2], 4, strategy="beam",
                             beam_size=3)[0]) == 4


@pytest.mark.gpu
def test_decode_graphs_replayed_on_two_streams(tiny_lm):
    """Two captured decode steps of one bucket (two predictors: the same
    B*H), replayed at once on two streams, give their eager functions'
    outputs: each graph keeps K3's counters of its own, and every counter
    ends at zero."""
    import numpy as np
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.serving import decode as D

    preds = [tiny_lm, D.DecodePredictor(tiny_lm.model_dir,
                                        place=CUDAPlace(0))]
    rng = np.random.default_rng(2)
    runs = []
    for pred in preds:
        prompts = [rng.integers(1, 97, n) for n in (20, 9, 13)]
        tokens, lens, _b, s = pred._bucketed(prompts, 6)
        dstep, _ = pred.acquire("decode", tokens.shape[0], s)
        slabs = pred._slabs(dstep)
        pred._prefill(tokens, lens, s, slabs)
        feeds = _decode_step_feeds(pred, slabs, tokens[:, 0].copy(),
                                   lens.copy(), 1)
        # the step appends the same row each call: its outputs repeat
        want = dstep.run_eager(feeds, read=_clone)
        dstep.capture()
        runs.append((dstep, feeds, want))
    assert runs[0][0] is not runs[1][0]
    streams = [torch.cuda.Stream() for _ in runs]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for st, (dstep, feeds, _want), out in zip(streams, runs, got):
            with torch.cuda.stream(st):
                out.append(dstep(feeds, read=_clone))
    torch.cuda.synchronize()
    for (dstep, _feeds, want), outs in zip(runs, got):
        assert dstep.captures == 1 and dstep.replays == 20
        for out in outs:
            assert all(torch.equal(g, w) for g, w in zip(out, want))
        assert dstep._counters and not any(
            c.any() for c in dstep._counters.values())
    ptrs = [c.data_ptr() for dstep, _f, _w in runs
            for c in dstep._counters.values()]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["topk", "topp"])
def test_sampling_graph_equals_eager_and_cpu(tiny_lm, monkeypatch,
                                             strategy):
    """A top-k/top-p generate through the captured steps gives the eager
    steps' ids for the same seed (the draw is a function of the seed
    feed, computed on the card), and the op on the card draws what it
    draws on the CPU for the same logits and seed."""
    import numpy as np
    from paddle_tpu_torch.ops import sampling as S
    from paddle_tpu_torch.serving.engine import GraphStep

    pred = tiny_lm
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 97, n) for n in (20, 9, 13)]
    graph = pred.generate(prompts, 8, strategy=strategy, seed=11)
    again = pred.generate(prompts, 8, strategy=strategy, seed=11)
    monkeypatch.setattr(GraphStep, "__call__", GraphStep.run_eager)
    eager = pred.generate(prompts, 8, strategy=strategy, seed=11)
    for g, a, e in zip(graph, again, eager):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, e)
    logits = torch.randn(8, 97, generator=torch.Generator().manual_seed(4))
    fn = S.top_k_sample if strategy == "topk" else S.top_p_sample
    arg = 40 if strategy == "topk" else 0.9
    seed = torch.tensor([77])
    assert torch.equal(fn(logits.to(pred.device), seed.to(pred.device),
                          arg).cpu(), fn(logits, seed, arg))


@pytest.mark.gpu
def test_server_captures_while_a_generate_runs(tiny_lm):
    """A DecodeServer without prewarm captures its own decode step and its
    admission prefills on its loop's thread while a generate on the same
    predictor runs on another (captures are thread_local); both give the
    tokens they give alone."""
    import threading

    import numpy as np
    from paddle_tpu_torch.serving import decode as D

    pred = tiny_lm
    rng = np.random.default_rng(5)
    traffic = [rng.integers(1, 97, int(n)) for n in rng.integers(3, 60, 12)]
    gen_prompts = [rng.integers(1, 97, n) for n in (20, 9, 13)]
    want_gen = pred.generate(gen_prompts, 16)
    want_srv = [pred.generate([p], 8)[0] for p in traffic]
    srv = D.DecodeServer(pred, slots=4, max_seq=128, max_new_tokens=8,
                         prewarm=False)
    srv.start()
    got_gen = []
    stop = threading.Event()

    def generating():
        while not stop.is_set():
            got_gen.append(pred.generate(gen_prompts, 16))

    th = threading.Thread(target=generating)
    th.start()
    got = [f.result(timeout=300)[0]
           for f in [srv.submit((p,)) for p in traffic]]
    stop.set()
    th.join()
    assert srv._step.captures == 1
    srv.stop()
    for g, w in zip(got, want_srv):
        np.testing.assert_array_equal(g, w)
    assert got_gen
    for run in got_gen:
        for g, w in zip(run, want_gen):
            np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_failed_capture_raises_and_never_runs_eagerly(card, monkeypatch):
    """A step whose program cannot be captured (an op reads a value back
    to the host) raises, naming the op, after its warm-up runs; it never
    runs the program eagerly in the graph's place."""
    import numpy as np
    from paddle_tpu_torch import Program, layers, program_guard
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.serving.engine import Engine, GraphStep

    prog = Program()
    with program_guard(prog, Program()):
        x = layers.data(name="x", shape=[4], dtype="float32",
                        append_batch_size=False)
        out = layers.elementwise_add(x, x, act="relu")
    runs = []
    relu = registry.KERNELS["relu"]

    def syncing_relu(ctx):
        runs.append(ctx.op.type)
        float(ctx.input("X").sum())   # a device-to-host read
        return relu(ctx)

    monkeypatch.setitem(registry.KERNELS, "relu", syncing_relu)
    engine = Engine(prog, feed_names=["x"], fetch_names=[out.name])
    step = engine.graph_step("predict", [("x", (4,), torch.float32)], {},
                             card)
    feeds = {"x": np.arange(4, dtype=np.float32) - 1}
    with pytest.raises(RuntimeError, match="capture failed.*relu"):
        step(feeds)
    assert len(runs) == GraphStep.WARMUP + 1 and not step.captured
    with pytest.raises(RuntimeError, match="failed earlier"):
        step(feeds)
    assert len(runs) == GraphStep.WARMUP + 1
    assert step.run_eager(feeds, read=lambda o: o[0].cpu().tolist()) == \
        [0.0, 0.0, 2.0, 4.0]
    assert len(runs) == GraphStep.WARMUP + 2


@pytest.mark.gpu
@pytest.mark.parametrize("level", [None, "O2"], ids=["fp32", "O2"])
def test_training_step_graph_equals_its_eager_step_and_run_loop(card,
                                                                level):
    """Executor.run's captured training step (K1, K2 or their bf16 twins,
    the fused LM head's backward, Adam) from one state gives the same
    loss and parameters as the same step op by op, bitwise, and its first
    call trains exactly one step (the warm-ups before the capture move no
    state); run_loop(3) equals three run calls bitwise; the scope holds
    the step's state buffers, updated in place."""
    import numpy as np
    from paddle_tpu_torch import (CUDAPlace, Executor, Program, Scope,
                                  layers, optimizer, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.serving.engine import GraphStep

    prog, startup = Program(), Program()
    prog.random_seed = startup.random_seed = 5
    with program_guard(prog, startup), unique_name.guard():
        ids = layers.data(name="ids", shape=[2, 128], dtype="int64",
                          append_batch_size=False)
        labels = layers.data(name="labels", shape=[2, 128], dtype="int64",
                             append_batch_size=False)
        loss, _ = transformer.transformer_lm(
            ids, labels, 97, n_layer=2, n_head=2, d_model=128, d_inner=256,
            max_len=128)
        optimizer.Adam(learning_rate=1e-3).minimize(loss)
        if level:
            prog.enable_mixed_precision(level=level)
    exe, scope = Executor(CUDAPlace(0)), Scope()
    exe.run(startup, scope=scope)
    assert len(exe.step_cache) == 0       # startup: the random-op rule
    rng = np.random.default_rng(3)
    feed = {k: rng.integers(0, 97, (2, 128)) for k in ("ids", "labels")}
    names = [v.name for v in prog.list_vars() if v.persistable]
    saved = {n: scope.find_var(n).clone() for n in names}

    def steps(k, eager=False, loop=False):
        for n, v in saved.items():
            scope.set_var(n, v.clone())
        if loop:
            out = exe.run_loop(prog, feed, [loss], steps=k, scope=scope)
        else:
            for _ in range(k):
                if eager:
                    with _eager_steps(GraphStep):
                        out = exe.run(prog, feed, [loss], scope=scope)
                else:
                    out = exe.run(prog, feed, [loss], scope=scope)
        return out[0], {n: scope.find_var(n).clone() for n in names}

    graph = steps(1)                      # build, warm-ups, capture, replay
    assert exe.step_cache.steps()[0].captured
    eager = steps(1, eager=True)
    assert graph[0] == eager[0]
    for n in names:
        assert torch.equal(graph[1][n], eager[1][n]), n
    looped, ran = steps(3, loop=True), steps(3)
    assert looped[0] == ran[0]
    for n in names:
        assert torch.equal(looped[1][n], ran[1][n]), n
    step = exe.step_cache.steps()[0]
    assert all(scope.find_var(n) is step.static[n] for n in step.state)
    assert step.captures == 1


class _eager_steps:
    """Run GraphStep calls through their eager functions (chip_smoke's
    eager_steps, which this file does not import)."""

    def __init__(self, cls):
        self.cls = cls

    def __enter__(self):
        self.saved = self.cls.__call__
        self.cls.__call__ = self.cls.run_eager

    def __exit__(self, *exc):
        self.cls.__call__ = self.saved
