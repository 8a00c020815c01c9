"""Shared-prefix admission in the port (paddle_tpu_torch/serving/prefix.py
and DecodeServer(prefix_cache=True | prefix_store=...)) against the JAX
package, on the CPU.

- The port's PrefixStore through the JAX package's own store cases
  (tests/test_speculative.py: block-aligned partial hits, an aligned
  prefix of a longer entry demoted, rows copied not viewed, LRU byte
  bound, a shared header surviving one owner's eviction, refcount pins,
  an oversized entry refused), and ``prefix_hash`` equal to the JAX
  package's.
- A prefix-sharing server: full hits (no model call), partial hits (the
  cached header's rows, the suffix extended through the verify window)
  and misses deduped within an admission; every output equal to a
  private server's, to ``generate`` of the prompt alone and to the JAX
  package's prefix server's; the store's hits counted under the JAX
  package's series.

Model: 2 layers, d_model 64, 4 heads of 16, vocab 128, max_len 64,
weights drawn with numpy."""
import numpy as np
import pytest
from _jax_metrics import jax_metrics_untouched

torch = pytest.importorskip("torch")

from paddle_tpu.serving import decode as jax_decode  # noqa: E402
from paddle_tpu.serving import prefix as jax_prefix  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.serving import decode as pt_decode  # noqa: E402
from paddle_tpu_torch.serving.prefix import (  # noqa: E402
    PrefixStore, aligned_prefix_hashes, prefix_hash)

V, L, NH, D, DI, ML = 128, 2, 4, 64, 128, 64
DH = D // NH


def _rows(p, scale=1.0):
    """Fake per-layer K/V rows for a length-p prompt."""
    return [np.full((p, NH, DH), scale, np.float32) for _ in range(2 * L)]


# -- the store (the JAX package's cases, against the port's copy) -----------

def test_store_block_aligned_partial_hits():
    store = PrefixStore(max_bytes=1 << 20, block=4)
    prompt = np.arange(1, 11, dtype=np.int64)  # length 10
    assert store.lookup(prompt) == (None, 0, None, None)
    eid = store.insert(prompt, _rows(10), np.zeros((V,), np.float32))
    assert eid is not None
    got_eid, length, rows, logits = store.lookup(prompt)
    assert (got_eid, length) == (eid, 10) and logits is not None
    assert len(rows) == 2 * L and rows[0].shape[0] == 10
    longer = np.concatenate([prompt[:8], np.array([30, 31, 32], np.int64)])
    got_eid, length, rows, logits = store.lookup(longer)
    assert (got_eid, length) == (eid, 8) and logits is None
    assert rows[0].shape[0] == 8
    odd = np.concatenate([prompt[:6], np.array([33, 34], np.int64)])
    got_eid, length, rows, logits = store.lookup(odd)
    assert (got_eid, length) == (eid, 4) and logits is None
    assert store.lookup(np.array([90, 91, 92, 93, 94, 95],
                                 np.int64))[0] is None


def test_store_aligned_prefix_of_longer_entry_is_not_a_full_hit():
    store = PrefixStore(max_bytes=1 << 20, block=4)
    long_prompt = np.arange(1, 13, dtype=np.int64)
    store.insert(long_prompt, _rows(12), np.full((V,), 7.0, np.float32))
    short = long_prompt[:8].copy()
    eid, length, rows, logits = store.lookup(short)
    assert logits is None
    assert length == 4 and rows[0].shape[0] == 4
    assert store.lookup(long_prompt[:4].copy()) == (None, 0, None, None)
    short_logits = np.full((V,), 3.0, np.float32)
    own = store.insert(short, _rows(8), short_logits)
    eid2, length2, _rows2, logits2 = store.lookup(short)
    assert eid2 == own and length2 == 8
    np.testing.assert_array_equal(logits2, short_logits)


def test_store_insert_copies_rows_not_views():
    store = PrefixStore(max_bytes=1 << 20, block=4)
    parent = np.ones((4, 64, NH, DH), np.float32)
    prompt = np.arange(1, 9, dtype=np.int64)
    store.insert(prompt, [parent[0, :8] for _ in range(2 * L)],
                 np.zeros((V,), np.float32))
    parent[:] = -1.0
    _eid, _l, rows, _lg = store.lookup(prompt)
    assert float(rows[0][0, 0, 0]) == 1.0
    assert not any(r.base is parent for r in rows)


def test_store_eviction_is_lru_and_byte_bounded():
    one = sum(r.nbytes for r in _rows(8)) + V * 4
    store = PrefixStore(max_bytes=int(one * 2.5), block=4)
    prompts = [np.arange(1, 9, dtype=np.int64) + 100 * i for i in range(3)]
    for p in prompts:
        store.insert(p, _rows(8), np.zeros((V,), np.float32))
    assert store.bytes <= store.max_bytes and len(store) == 2
    assert store.lookup(prompts[0])[0] is None
    assert store.lookup(prompts[1])[0] is not None
    assert store.lookup(prompts[2])[0] is not None


def test_store_shared_header_survives_one_owners_eviction():
    header = np.arange(1, 9, dtype=np.int64)
    a = np.concatenate([header, np.array([50, 51, 52, 53], np.int64)])
    b = np.concatenate([header, np.array([60, 61, 62, 63], np.int64)])
    one = sum(r.nbytes for r in _rows(12)) + V * 4
    store = PrefixStore(max_bytes=int(one * 2.5), block=4)
    store.insert(a, _rows(12), np.zeros((V,), np.float32))
    eb = store.insert(b, _rows(12), np.zeros((V,), np.float32))
    store.insert(np.arange(100, 112, dtype=np.int64), _rows(12),
                 np.zeros((V,), np.float32))
    eid_a, len_a = store.lookup(a)[:2]
    assert eid_a == eb and len_a == 8
    probe = np.concatenate([header, np.array([70, 71], np.int64)])
    eid, length, rows, _lg = store.lookup(probe)
    assert eid == eb and length == 8 and rows[0].shape[0] == 8


def test_store_refcounted_entries_survive_eviction_pressure():
    one = sum(r.nbytes for r in _rows(8)) + V * 4
    store = PrefixStore(max_bytes=int(one * 1.5), block=4)
    hot = np.arange(1, 9, dtype=np.int64)
    eid = store.insert(hot, _rows(8), np.zeros((V,), np.float32))
    store.acquire(eid)
    for i in (1, 2):
        store.insert(hot + 100 * i, _rows(8), np.zeros((V,), np.float32))
    assert store.lookup(hot)[0] == eid
    assert store.refs(eid) == 1
    store.release(eid)
    store.insert(hot + 300, _rows(8), np.zeros((V,), np.float32))
    assert store.bytes <= store.max_bytes


def test_store_oversized_entry_is_refused():
    store = PrefixStore(max_bytes=64, block=4)
    assert store.insert(np.arange(1, 9, dtype=np.int64), _rows(8),
                        np.zeros((V,), np.float32)) is None
    assert store.bytes == 0


def test_prefix_hash_matches_jax():
    rng = np.random.default_rng(0)
    for n in (1, 16, 37):
        toks = rng.integers(0, 1 << 40, n)
        assert prefix_hash(toks) == jax_prefix.prefix_hash(toks)
        lens = list(range(4, n + 1, 4)) or [n]
        assert aligned_prefix_hashes(toks, lens) == \
            jax_prefix.aligned_prefix_hashes(toks, lens)


# -- the prefix-sharing server ----------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("prefix_lm"))
    cfg = pt_decode.DecodeConfig(vocab_size=V, n_layer=L, n_head=NH,
                                 d_model=D, d_inner=DI, max_len=ML)
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        with pt.unique_name.guard():
            pt_decode._prefill_graph(cfg, 1, 16)
    rng = np.random.default_rng(5)
    scope = pt.Scope()
    for op in startup.global_block().ops:
        name, shape = op.output("Out")[0], tuple(op.attr("shape"))
        if op.type == "gaussian_random":
            val = rng.standard_normal(shape).astype(np.float32) * 0.1
        else:
            val = np.full(shape, op.attr("value"), np.float32)
        scope.set_var(name, val)
    pt_decode.save_decode_model(d, cfg, None, scope=scope)
    return d


def _traffic():
    """Two 16-token headers (one block at the server's block 8, twice):
    header + suffix prompts. Rounds: the full prompts first (misses: one
    admission, deduped), then a mix of exact repeats (full hits) and
    fresh suffixes after a header (partial hits: 1..9 suffix tokens, so
    one to three extension windows of 4)."""
    rng = np.random.default_rng(6)
    headers = [rng.integers(1, V, 16) for _ in range(2)]
    full = [np.concatenate([h, rng.integers(1, V, 5)]) for h in headers]
    first = [full[0], full[1], full[0]]
    mixed = [full[1], np.concatenate([headers[0], rng.integers(1, V, 9)]),
             full[0], np.concatenate([headers[1], rng.integers(1, V, 1)]),
             np.concatenate([headers[0], rng.integers(1, V, 4)])]
    return [p.astype(np.int64) for p in first], \
        [p.astype(np.int64) for p in mixed]


def _serve(srv, rounds, budget):
    """Each round's requests sent, then waited for; the first round is
    queued before the loop starts, so its first admission holds it all."""
    outs = []
    for r, prompts in enumerate(rounds):
        futs = [srv.submit((p, np.array([budget], np.int64)))
                for p in prompts]
        if r == 0:
            srv.start()
        outs.append([f.result(timeout=120)[0] for f in futs])
    srv.stop()
    return outs


def _hits():
    return {kind: obs.DECODE_PREFIX_HITS.value(kind=kind)
            for kind in ("full", "partial", "batch")}


def test_prefix_server_matches_private_generate_and_jax(model_dir):
    first, mixed = _traffic()
    budget = 6
    pred = pt_decode.DecodePredictor(model_dir, place=pt.CPUPlace())
    hits0 = _hits()
    queries0 = obs.DECODE_PREFIX_QUERIES.value()
    shared = pt_decode.DecodeServer(pred, slots=3, max_seq=32,
                                    max_new_tokens=budget, spec_k=3,
                                    prefix_cache=True, prefix_block=8)
    got = _serve(shared, [first, mixed], budget)
    hits = {k: v - hits0[k] for k, v in _hits().items()}
    # round 1: two distinct prompts in one admission of three, deduped
    # into one prefill; round 2: full hits need none, partial hits extend
    assert shared.prefill_executions == 1
    assert hits == {"full": 2, "partial": 3, "batch": 1}
    assert obs.DECODE_PREFIX_QUERIES.value() - queries0 == 8
    assert len(shared._prefix) == 2
    private = pt_decode.DecodeServer(pred, slots=3, max_seq=32,
                                     max_new_tokens=budget)
    want = _serve(private, [first, mixed], budget)
    with jax_metrics_untouched():
        jpred = jax_decode.DecodePredictor(model_dir, aot_cache=False)
        jsrv = jax_decode.DecodeServer(jpred, slots=3, max_seq=32,
                                       max_new_tokens=budget, spec_k=3,
                                       prefix_cache=True, prefix_block=8,
                                       prewarm=False)
        jgot = _serve(jsrv, [first, mixed], budget)
    for rnd, prompts in enumerate([first, mixed]):
        for i, p in enumerate(prompts):
            g = got[rnd][i]
            assert len(g) == budget
            np.testing.assert_array_equal(g, want[rnd][i])
            np.testing.assert_array_equal(
                g, np.asarray(jgot[rnd][i], np.int64))
            np.testing.assert_array_equal(g, pred.generate([p], budget)[0])
    # every reference went back when its sequence retired
    assert all(shared._prefix.refs(e) == 0
               for e in list(shared._prefix._entries))


def test_prefix_store_is_shared_between_servers(model_dir):
    """A ``prefix_store`` handed to a second server serves its first
    request from the first server's entry: a full hit, no prefill."""
    first, _mixed = _traffic()
    pred = pt_decode.DecodePredictor(model_dir, place=pt.CPUPlace())
    store = PrefixStore(block=8)
    a = pt_decode.DecodeServer(pred, slots=2, max_seq=32, max_new_tokens=4,
                               prefix_store=store)
    out_a = _serve(a, [[first[0]]], 4)[0][0]
    b = pt_decode.DecodeServer(pred, slots=2, max_seq=32, max_new_tokens=4,
                               prefix_store=store)
    out_b = _serve(b, [[first[0]]], 4)[0][0]
    assert (a.prefill_executions, b.prefill_executions) == (1, 0)
    np.testing.assert_array_equal(out_a, out_b)
