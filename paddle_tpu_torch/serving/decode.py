"""KV-cache autoregressive decode serving: DecodePredictor and DecodeServer
(counterpart of paddle_tpu/serving/decode.py).

- ``save_decode_model`` exports a transformer_lm parameter set as a
  decode-servable directory: the canonical prefill graph through
  ``save_inference_model``, plus a ``__decode__.json`` manifest with the
  architecture config the decode-side builders need. The layout is the
  JAX package's, so an export from either package serves in either.

- ``DecodePredictor`` loads that directory and builds TWO kinds of
  programs: a PREFILL step (the flash-attention forward over the padded
  prompt, emitting last-position logits plus per-layer K/V slabs) and a
  per-token DECODE step (``cache_append`` of the fresh K/V row into the
  slabs, in place; single-query ``decode_attention``; in-graph greedy,
  top-k or top-p sampling, so only token ids cross to the host; a draw is
  a function of the step's ``seed`` feed, ops/sampling.py). Batch and slab length
  bucket to powers of two exactly as in the JAX package, so the two
  packages run the same programs on the same padded inputs. Each
  (kind, batch, seq, strategy) program is built once and wrapped by the
  Engine (serving/engine.py) in a GraphStep: on the card it is captured
  into one CUDA graph on its first call and replayed by every later one,
  as the JAX package compiles each bucket once and replays the
  executable. The decode step's K/V slabs are its static feed buffers:
  the prefill writes into them and every decode step appends to them in
  place. The steps live in one StepCache, bounded in bytes: a bucket
  least recently used is evicted with its graph, pool and slabs.

- ``DecodeServer`` is the continuous-batching serving loop (Orca-style
  iteration-level scheduling): requests enter the runtime's bounded
  channel as frames, queued prompts are admitted into FREE slab rows
  between decode steps (prefilled as a pow2 sub-batch at their own pow2
  length, the rows written into the resident slabs in place) and
  finished rows retire eagerly. The server OWNS its (slots, S) decode
  step: a key of its own and a pin in the step cache for its lifetime,
  so a ``generate`` at the same bucket never shares its slabs and no
  capture evicts them. ``continuous=False`` is gang scheduling (admit a
  batch, run it to completion) for A/B runs.

On the card the prefill's attention is kernel K1 and each decode step's
is kernel K3 (ops/attention.py, ops/kv_cache.py), inside the steps'
CUDA graphs.

Not ported yet (each raises NotImplementedError): beam search,
speculative decoding, prefix sharing, int8 slabs and ring prefill.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import observability as obs
from ..executor import analyze_state
from ..observability import tracing as _tracing
from ..runtime import recordio as _rio

__all__ = ["DecodeConfig", "save_decode_model", "DecodePredictor",
           "DecodeServer", "analyze_state"]

_DECODE_MANIFEST = "__decode__.json"


def _pow2_bucket(n: int, floor: int = 1) -> int:
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


class DecodeConfig:
    """Architecture manifest for the decode-side graph builders — the
    arguments ``models.transformer.transformer_lm`` was trained with.
    Everything else (batch, slab length, strategy) is a serving-time
    choice and deliberately NOT part of the manifest."""

    FIELDS = ("vocab_size", "n_layer", "n_head", "d_model", "d_inner",
              "max_len", "tie_embeddings", "prefix", "eos_id")

    def __init__(self, vocab_size, n_layer=4, n_head=8, d_model=512,
                 d_inner=2048, max_len=2048, tie_embeddings=False,
                 prefix="lm", eos_id=None):
        self.vocab_size = int(vocab_size)
        self.n_layer = int(n_layer)
        self.n_head = int(n_head)
        self.d_model = int(d_model)
        self.d_inner = int(d_inner)
        self.max_len = int(max_len)
        self.tie_embeddings = bool(tie_embeddings)
        self.prefix = str(prefix)
        self.eos_id = None if eos_id is None else int(eos_id)

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head

    def to_dict(self) -> Dict:
        return {f: getattr(self, f) for f in self.FIELDS}

    @classmethod
    def from_dict(cls, d: Dict) -> "DecodeConfig":
        return cls(**{f: d[f] for f in cls.FIELDS if f in d})


def _prefill_graph(config: DecodeConfig, batch: int, seq: int):
    """Declare the prefill feeds and build the prefill graph into the
    current program; returns (last_logits, caches)."""
    from .. import layers
    from ..models import transformer as _T

    tokens = layers.data(name="tokens", shape=[batch, seq], dtype="int64",
                         append_batch_size=False)
    lengths = layers.data(name="lengths", shape=[batch], dtype="int32",
                          append_batch_size=False)
    return _T.transformer_lm_prefill(
        tokens, lengths, config.vocab_size, n_layer=config.n_layer,
        n_head=config.n_head, d_model=config.d_model,
        d_inner=config.d_inner, max_len=config.max_len,
        tie_embeddings=config.tie_embeddings, prefix=config.prefix)


def save_decode_model(dirname: str, config: DecodeConfig, executor=None,
                      scope=None, export_batch: int = 1,
                      export_seq: Optional[int] = None) -> None:
    """Export a transformer_lm parameter set for decode serving.

    Builds the canonical prefill graph (full causal forward, last-position
    logits as the fetch target) and writes it through
    ``save_inference_model`` plus the ``__decode__.json`` manifest.
    Parameters come from ``scope`` (or the global scope), as tensors or
    numpy arrays; one the decode builders expect but the scope lacks
    fails HERE, not at first request."""
    from .. import io as fluid_io
    from ..framework import Program, program_guard, unique_name

    export_seq = int(export_seq or min(config.max_len, 128))
    prog, startup = Program(), Program()
    with program_guard(prog, startup):
        with unique_name.guard():
            last_logits, _caches = _prefill_graph(config, export_batch,
                                                  export_seq)
    fluid_io.save_inference_model(
        dirname, ["tokens", "lengths"], [last_logits], executor,
        main_program=prog, scope=scope)
    with open(os.path.join(dirname, _DECODE_MANIFEST), "w") as f:
        json.dump(config.to_dict(), f, indent=2, sort_keys=True)


class DecodePredictor:
    """Incremental-decode predictor over an exported decode model.

    pred = DecodePredictor(model_dir)                 # on the card
    pred = DecodePredictor(model_dir, place=CPUPlace())
    outs = pred.generate([np.array([5, 3, 9])], max_new_tokens=16)

    ``place=None`` means ``CUDAPlace(0)``; with no CUDA device that
    raises — the predictor never moves to the CPU unasked. ``generate``
    is the static-batch surface (one call, one bucketed batch, run to
    completion); ``DecodeServer`` drives the same steps with continuous
    batching. ``sample_k``, ``sample_p`` and ``temperature`` are built
    into the "topk" and "topp" decode programs. After a call, ``timings`` holds its prefill and
    per-step host times in ms (each ends in a device-to-host read of the
    sampled ids, so it covers the device work). ``max_step_bytes`` bounds
    the device memory of the cached steps (slabs, buffers and graph
    pools; None: ``engine.default_step_bytes``, half the card).
    """

    def __init__(self, model_dir: str, place=None, strategy: str = "greedy",
                 sample_k: int = 40, sample_p: float = 0.9,
                 temperature: float = 1.0, eos_id: Optional[int] = None,
                 max_step_bytes: Optional[int] = None):
        from .. import io as fluid_io
        from ..framework.scope import CUDAPlace, Scope, fp32_sums
        from .engine import StepCache, default_step_bytes

        self.place = CUDAPlace(0) if place is None else place
        self.device = self.place.torch_device()
        # the JAX reference is fp32: TF32 products would make parity an
        # accident of rounding
        fp32_sums()
        with open(os.path.join(model_dir, _DECODE_MANIFEST)) as f:
            self.config = DecodeConfig.from_dict(json.load(f))
        self.model_dir = model_dir
        self.strategy = strategy
        self.sample_k = int(sample_k)
        self.sample_p = float(sample_p)
        self.temperature = float(temperature)
        self.eos_id = eos_id if eos_id is not None else self.config.eos_id
        self._scope = Scope()
        # the canonical prefill program: parameter loading
        self._program, self._feed_names, _fetch = (
            fluid_io.load_inference_model(model_dir, scope=self._scope,
                                          place=self.place))
        state_in, _ = analyze_state(self._program, set(self._feed_names))
        self._state = {}
        for n in state_in:
            val = self._scope.find_var(n)
            if val is None:
                raise RuntimeError(
                    "decode model is missing persistable %r" % n)
            self._state[n] = val
        self._engines: Dict = {}   # the built programs, by signature
        self._steps = StepCache(default_step_bytes(self.device)
                                if max_step_bytes is None
                                else max_step_bytes)
        self._lock = threading.Lock()
        # one generate at a time: a decode bucket's slabs are its step's
        # static buffers, shared by every call at that bucket
        self._generating = threading.Lock()
        self.timings: Dict[str, List[float]] = {"prefill": [], "step": []}

    # -- graph building ---------------------------------------------------
    def _build(self, kind: str, batch: int, seq: int, strategy: str):
        """Build the (batch, seq) Program for one kind ("prefill" |
        "decode"); returns (program, feed_names, fetch_names). The same
        arguments build the same program as the JAX package's
        ``DecodePredictor._build``."""
        from .. import layers
        from ..framework import Program, program_guard, unique_name
        from ..models import transformer as _T

        cfg = self.config
        prog, startup = Program(), Program()
        with program_guard(prog, startup):
            with unique_name.guard():
                if kind == "prefill":
                    logits, caches = _prefill_graph(cfg, batch, seq)
                    feeds = ["tokens", "lengths"]
                    fetches = [logits.name] + [
                        c.name for pair in caches for c in pair]
                elif kind == "decode":
                    tokens = layers.data(name="tokens", shape=[batch, 1],
                                         dtype="int64",
                                         append_batch_size=False)
                    positions = layers.data(name="positions",
                                            shape=[batch, 1], dtype="int64",
                                            append_batch_size=False)
                    lengths = layers.data(name="lengths", shape=[batch],
                                          dtype="int32",
                                          append_batch_size=False)
                    seed = layers.data(name="seed", shape=[1],
                                       dtype="int64",
                                       append_batch_size=False)
                    kc, vc = [], []
                    for i in range(cfg.n_layer):
                        kc.append(layers.data(
                            name="kcache_%d" % i,
                            shape=[batch, seq, cfg.n_head, cfg.d_head],
                            dtype="float32", append_batch_size=False))
                        vc.append(layers.data(
                            name="vcache_%d" % i,
                            shape=[batch, seq, cfg.n_head, cfg.d_head],
                            dtype="float32", append_batch_size=False))
                    next_ids, logits, ncaches = _T.transformer_lm_decode(
                        tokens, positions, lengths, kc, vc, cfg.vocab_size,
                        n_layer=cfg.n_layer, n_head=cfg.n_head,
                        d_model=cfg.d_model, d_inner=cfg.d_inner,
                        max_len=cfg.max_len,
                        tie_embeddings=cfg.tie_embeddings,
                        prefix=cfg.prefix, strategy=strategy, seed=seed,
                        sample_k=self.sample_k, sample_p=self.sample_p,
                        temperature=self.temperature)
                    feeds = (["tokens", "positions", "lengths", "seed"]
                             + [v.name for v in kc]
                             + [v.name for v in vc])
                    fetches = [logits.name] + [
                        c.name for tup in ncaches for c in tup]
                    if next_ids is not None:
                        fetches = [next_ids.name] + fetches
                else:
                    raise NotImplementedError(
                        "program kind %r is a later slice of the port "
                        "(prefill | decode)" % (kind,))
        return prog, feeds, fetches

    def acquire(self, kind: str, batch: int, seq: int,
                strategy: Optional[str] = None, owner=None):
        """The step for one (kind, batch, seq, strategy) signature, looked
        up by its key in the Engine's memory tier (serving/engine.py),
        built there on a miss; the program is built once. Returns (step,
        fetch_names); ``step(feeds, read=None)`` is a GraphStep: it copies
        the feeds into its static buffers and, on the card, replays the
        program's CUDA graph (captured on its first call). Its outputs are
        valid until its next call. With ``owner`` (any hashable) the step
        is that owner's own: ``owner`` completes its key, so its buffers
        are no one else's, and it is pinned in the cache until
        ``release``."""
        from ..framework.dtypes import as_torch_dtype
        from .engine import Engine

        strategy = strategy or self.strategy
        ck = (kind, batch, seq, strategy if kind == "decode" else "")
        with self._lock:
            engine = self._engines.get(ck)
            if engine is None:
                program, feed_names, fetch_names = self._build(
                    kind, batch, seq, strategy)
                engine = self._engines[ck] = Engine(
                    program, memory=self._steps, feed_names=feed_names,
                    fetch_names=fetch_names)
        specs = [(n, tuple(var.shape), as_torch_dtype(var.dtype))
                 for n, var, _ in engine.feed_plan()]
        extra = () if owner is None else ("owner", owner)
        step = engine.graph_step(kind, specs, self._state, self.device,
                                 *extra, pin=owner is not None)
        return step, list(engine.fetch_names)

    def release(self, step) -> None:
        """Hand back an owned step (``acquire(..., owner=...)``): it leaves
        the cache, with its buffers and graph."""
        self._steps.release(step)

    @property
    def traces(self) -> int:
        """Steps built plus graphs captured: a second ``generate`` at the
        same buckets adds none."""
        return self._steps.traces

    # -- batching ---------------------------------------------------------
    def _bucketed(self, prompts: Sequence[np.ndarray], max_new: int,
                  batch_floor: int = 1, seq: Optional[int] = None):
        """Pad a prompt list into bucketed (tokens, lengths) arrays.
        Pad rows (beyond the real batch) carry one dummy token so the
        prefill's last-position gather stays in range."""
        b = len(prompts)
        plens = [int(len(p)) for p in prompts]
        if min(plens) < 1:
            raise ValueError("empty prompt (decode needs >= 1 token)")
        need = max(plens) + max_new
        if need > self.config.max_len:
            raise ValueError(
                "prompt %d + max_new_tokens %d exceeds the model's "
                "max_len %d" % (max(plens), max_new, self.config.max_len))
        s = seq if seq is not None else _pow2_bucket(need, floor=16)
        s = min(s, _pow2_bucket(self.config.max_len))
        if s > self.config.max_len:
            s = self.config.max_len  # max_len itself may not be pow2
        bb = _pow2_bucket(b, floor=batch_floor)
        tokens = np.zeros((bb, s), np.int64)
        lens = np.ones((bb,), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :plens[i]] = np.asarray(p, np.int64).reshape(-1)
            lens[i] = plens[i]
        return tokens, lens, b, s

    def _prefill(self, tokens, lens, slab_seq, slabs=None):
        """Run prefill at the PROMPTS' own pow2 sequence bucket (prompt
        cost scales with the prompt, not with the decode budget) and
        return its last-position logits (B, V). With ``slabs``, the decode
        bucket's K/V slabs ([k_0, v_0, k_1, ...], ``slab_seq`` rows), its
        K/V land in their rows [0:sp] and rows [sp:] are zeroed, as the
        JAX package's zero pad leaves them."""
        bb = tokens.shape[0]
        sp = min(_pow2_bucket(int(lens.max()), floor=16), slab_seq)
        pexe, _ = self.acquire("prefill", bb, sp)

        def read(outs):
            if slabs is not None:
                with torch.inference_mode():
                    for slab, cache in zip(slabs, outs[1:]):
                        slab[:, :sp].copy_(cache)
                        slab[:, sp:].zero_()
            return outs[0].clone()

        t0 = time.perf_counter()
        logits = pexe({"tokens": tokens[:, :sp], "lengths": lens}, read=read)
        obs.DECODE_STEP_MS.observe((time.perf_counter() - t0) * 1e3,
                                   stage="prefill")
        return logits

    def _slabs(self, dstep) -> list:
        """A decode step's K/V slab buffers, [k_0, v_0, k_1, ...]."""
        return [dstep.static["%s_%d" % (kv, i)]
                for i in range(self.config.n_layer)
                for kv in ("kcache", "vcache")]

    # -- host-side sampling (first token, from prefill logits) ------------
    def _sample_host(self, logits, strategy: str, seed: int) -> np.ndarray:
        """Sample one id per row of ``logits`` (B, V), a tensor on the
        predictor's device, with the decode program's sampler and
        parameters and ``seed``; returns them on the host (one read)."""
        from ..ops import sampling as _S

        if strategy in ("greedy", "logits", "beam"):
            ids = _S.greedy_sample(logits)
        elif strategy == "topk":
            ids = _S.top_k_sample(logits, int(seed), self.sample_k,
                                  self.temperature)
        elif strategy == "topp":
            ids = _S.top_p_sample(logits, int(seed), self.sample_p,
                                  self.temperature)
        else:
            raise ValueError("unknown decode strategy %r" % strategy)
        return ids.cpu().numpy()

    # -- generation (static batch, run to completion) ----------------------
    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens: int = 32, strategy: Optional[str] = None,
                 seed: int = 0, eos_id: Optional[int] = None,
                 speculative: bool = False) -> List[np.ndarray]:
        """Generate up to ``max_new_tokens`` per prompt (stopping a row
        early at ``eos_id``). Returns one int64 array of generated ids
        per prompt. ``strategy`` overrides the constructor's ("greedy" |
        "topk" | "topp"); the first token is drawn with ``seed``, decode
        step t with ``seed + t``, so the same seed gives the same ids.
        Beam search and speculative decoding are a later slice. Calls
        from several threads run one at a time."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1, got %d"
                             % max_new_tokens)
        strategy = strategy or self.strategy
        if speculative or strategy == "beam":
            raise NotImplementedError(
                "%s is a later slice of the port (greedy | topk | topp)"
                % ("speculative decoding" if speculative
                   else "beam search"))
        if strategy not in ("greedy", "topk", "topp"):
            # "logits" builds a sampler-less step whose fetch layout (no
            # next_ids) this loop cannot drive
            raise ValueError(
                "unknown decode strategy %r (greedy | topk | topp | "
                "beam)" % (strategy,))
        eos = eos_id if eos_id is not None else self.eos_id
        with self._generating:
            return self._generate(prompts, max_new_tokens, strategy, seed,
                                  eos)

    def _generate(self, prompts, max_new_tokens, strategy, seed, eos):
        self.timings = {"prefill": [], "step": []}
        tokens, lens, b, s = self._bucketed(prompts, max_new_tokens)
        bb = tokens.shape[0]
        dexe = slabs = None
        if max_new_tokens > 1:
            dexe, _fetch_names = self.acquire("decode", bb, s, strategy)
            slabs = self._slabs(dexe)
        t0 = time.perf_counter()
        logits = self._prefill(tokens, lens, s, slabs)
        obs.DECODE_TOKENS.inc(int(lens[:b].sum()), kind="prefill")
        cur = np.array(self._sample_host(logits, strategy, seed))
        self.timings["prefill"].append((time.perf_counter() - t0) * 1e3)
        generated = [[int(cur[i])] for i in range(b)]
        finished = np.array([eos is not None and int(cur[i]) == eos
                             for i in range(b)])
        obs.DECODE_TOKENS.inc(b, kind="decode")
        if dexe is not None and not finished.all():
            self._plain_decode_steps(dexe, slabs, cur, lens.copy(),
                                     generated, finished, b, s, eos,
                                     max_new_tokens, seed)
        return [np.asarray(g, np.int64) for g in generated]

    def _plain_decode_steps(self, dexe, caches, cur, lens, generated,
                            finished, b, s, eos, max_new_tokens,
                            seed) -> list:
        """The one-token-per-iteration step loop. Mutates ``cur`` /
        ``lens`` / ``generated`` / ``finished`` per ROW — a finished row's
        slot state freezes (its re-fed token and parked length only touch
        its own slab row, masked from every live row) — and returns the
        final caches. A row stops at eos, at its token budget, or when its
        slab row is full."""
        bb = cur.shape[0]
        step = 0
        while not finished.all():
            step += 1
            feeds = {"tokens": cur.reshape(bb, 1).astype(np.int64),
                     "positions": lens.reshape(bb, 1).astype(np.int64),
                     "lengths": lens,
                     "seed": np.array([seed + step], np.int64)}
            for i in range(self.config.n_layer):
                feeds["kcache_%d" % i] = caches[2 * i]
                feeds["vcache_%d" % i] = caches[2 * i + 1]
            t0 = time.perf_counter()
            nxt = dexe(feeds, read=lambda outs: outs[0].cpu().numpy())
            nxt = nxt.astype(np.int64)
            ms = (time.perf_counter() - t0) * 1e3
            self.timings["step"].append(ms)
            obs.DECODE_STEP_MS.observe(ms, stage="step")
            emitted = 0
            for i in range(b):
                if finished[i]:
                    continue
                tok = int(nxt[i])
                generated[i].append(tok)
                cur[i] = tok
                lens[i] += 1
                emitted += 1
                if (eos is not None and tok == eos) \
                        or len(generated[i]) >= max_new_tokens \
                        or lens[i] + 1 >= s:
                    finished[i] = True
            obs.DECODE_TOKENS.inc(emitted, kind="decode")
        return caches


class DecodeServer:
    """Continuous-batching decode serving loop.

    server = DecodeServer(DecodePredictor(model_dir), slots=8)
    server.start()
    fut = server.submit((prompt_ids,))            # or (ids, [max_new])
    (generated,) = fut.result()
    server.stop()

    One resident K/V slab of ``slots`` rows serves every request: the
    loop admits queued prompts into free rows BETWEEN decode steps (a
    bucketed prefill sub-batch whose rows are written into the slabs in
    place), steps every active row one token per iteration through ONE
    (slots, S) decode step, and retires finished rows eagerly: a long
    sequence never holds short ones hostage, and a fresh request starts
    decoding mid-flight instead of waiting for the batch to drain
    (``continuous=False`` restores gang scheduling for A/B runs).

    The decode step is the server's own (``DecodePredictor.acquire(...,
    owner=...)``): its slabs are that step's static buffers, which the
    captured graph reads by address, so they are written in place and
    never reallocated; the step is pinned in the predictor's step cache
    from ``start()`` to ``stop()``, so a prefill bucket captured on its
    first arrival cannot evict it, and a ``generate`` on the same
    predictor at the same bucket runs on a step of its own. Admission
    writes the prefill's rows inside the prefill step's ``read`` (its
    outputs alias its graph's memory until its next call), on the
    thread's stream, in order with the decode replays. A failed step
    fails the requests it holds (their slab rows are zeroed) and the
    loop serves on; nothing runs the plain version in a kernel's place.

    Requests ride the same frames as PredictorServer (slot 0: int prompt
    ids; optional slot 1: [max_new_tokens] or [max_new_tokens, seed]
    int64), and the response is one int64 array of generated ids.
    ``stop()`` is zero-drop: everything admitted OR still queued finishes
    before the loop exits. A per-request ``seed`` seeds that request's
    FIRST sampled token; later steps draw from the server's stream (a
    step is shared by every slot), so fully seeded reproducible sampling
    is ``DecodePredictor.generate``'s surface; greedy traffic is
    deterministic either way. Each future's ``_t_first`` is the host
    clock at its first token (time to first token: ``_t_first - _t0``).

    Not ported yet (NotImplementedError): ``speculative=True``,
    ``prefix_cache``/``prefix_store`` and ``kv_dtype="int8"``.
    """

    _owners = itertools.count()

    def __init__(self, predictor: DecodePredictor, slots: int = 4,
                 max_seq: Optional[int] = None, max_new_tokens: int = 32,
                 strategy: Optional[str] = None, capacity: int = 256,
                 eos_id: Optional[int] = None, continuous: bool = True,
                 prewarm: bool = True, kv_dtype: str = "float32",
                 speculative: bool = False, prefix_cache: bool = False,
                 prefix_store=None):
        from ..runtime.recordio import Channel

        if slots < 1:
            raise ValueError("slots must be >= 1, got %d" % slots)
        self.kv_dtype = kv_dtype
        if self.kv_dtype not in ("float32", "int8"):
            raise ValueError(
                "kv_dtype must be 'float32' or 'int8', got %r"
                % (self.kv_dtype,))
        for asked, what in ((self.kv_dtype == "int8", "int8 KV slabs"),
                            (speculative, "speculative decoding"),
                            (prefix_cache or prefix_store is not None,
                             "prefix sharing")):
            if asked:
                raise NotImplementedError(
                    "DecodeServer: %s is a later slice of the port" % what)
        self.predictor = predictor
        self.slots = int(slots)
        cfg = predictor.config
        want = max_seq or cfg.max_len
        self.seq = min(_pow2_bucket(want, floor=16),
                       _pow2_bucket(cfg.max_len))
        if self.seq > cfg.max_len:
            self.seq = cfg.max_len
        self.max_new_tokens = int(max_new_tokens)
        self.strategy = strategy or predictor.strategy
        if self.strategy in ("beam", "logits"):
            raise ValueError(
                "DecodeServer streams one token per step; strategy %r "
                "is a DecodePredictor.generate-only mode" % self.strategy)
        self.eos_id = eos_id if eos_id is not None else predictor.eos_id
        self.continuous = bool(continuous)
        self._prewarm = prewarm
        # the owned decode step's key part, unique in the process
        self._owner = ("decode_server", next(DecodeServer._owners))
        self._step = None      # the owned decode step, from start()
        self._slabs: List[torch.Tensor] = []
        self.prefill_executions = 0
        self._chan = Channel(capacity)
        self._results: Dict[int, object] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._http = None
        self._http_thread = None
        self._seed_ctr = 0
        # diagnostics, bounded: per-iteration active-slot counts and host
        # ms of each decode step (each ends in the read of its ids)
        self.step_active_counts: "collections.deque" = collections.deque(
            maxlen=100_000)
        self.step_ms: "collections.deque" = collections.deque(
            maxlen=100_000)
        # the slab feeds, in the order the decode step's fetches flatten
        # its updated slabs: (k, v) per layer (== predictor._slabs order)
        self._cache_feed_names = [
            "%s_%d" % (kv, i) for i in range(cfg.n_layer)
            for kv in ("kcache", "vcache")]

    # -- submission (PredictorServer-compatible surface) -------------------
    def submit(self, sample: Sequence[np.ndarray]):
        from ..inference import _Future, _encode_sample

        fut = _Future()
        fut._t0 = time.perf_counter()
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._results[rid] = fut
        fut._bind(self, rid)
        tid = _tracing.maybe_start()
        if tid is not None:
            _tracing.bind_rid(rid, tid)
            _tracing.record_span(tid, "client.submit", rid=rid)
        try:
            sent = self._chan.send(_encode_sample(rid, sample))
        except BaseException:
            with self._lock:
                self._results.pop(rid, None)
            _tracing.pop_rid(rid)
            raise
        if not sent:
            with self._lock:
                self._results.pop(rid, None)
            _tracing.pop_rid(rid)
            raise RuntimeError("decode server is stopped")
        return fut

    def submit_frame(self, msg):
        """An already-encoded frame, tag = request id (the fleet's fan-in
        path: the caller owns the tag namespace)."""
        from ..inference import _Future

        rid = _rio.frame_tag(msg)
        fut = _Future()
        fut._t0 = time.perf_counter()
        with self._lock:
            if rid in self._results:
                raise ValueError("request tag %d is already in flight"
                                 % rid)
            self._results[rid] = fut
        fut._bind(self, rid)
        if not self._chan.send(msg):
            with self._lock:
                self._results.pop(rid, None)
            raise RuntimeError("decode server is stopped")
        return fut

    def _pop(self, rid):
        # every future exit path funnels here: the trace binding a traced
        # request carried can never leak
        _tracing.pop_rid(rid)
        with self._lock:
            return self._results.pop(rid, None)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Acquire (and pin) the server's own decode step, then start the
        loop. With ``prewarm`` the steady-state steps are made before the
        first request (on the card: captured): the (slots, S) decode step
        and the single-request and full-burst admission prefills at the
        floor prompt bucket; a longer prompt captures its own bucket on
        its first arrival."""
        if self._thread is not None and self._thread.is_alive():
            return
        if self._step is None:
            self._step, _ = self.predictor.acquire(
                "decode", self.slots, self.seq, self.strategy,
                owner=self._owner)
            self._slabs = self.predictor._slabs(self._step)
        if self._prewarm:
            t0 = time.perf_counter()
            steps = [self._step]
            sp = min(16, self.seq)
            for batch in sorted({1, _pow2_bucket(self.slots)}):
                steps.append(self.predictor.acquire("prefill", batch, sp)[0])
            for step in steps:
                step.capture()
            obs.SERVER_STAGE_MS.observe(
                (time.perf_counter() - t0) * 1e3, stage="prewarm")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ptpu-decode-loop")
        self._thread.start()

    def stop(self, timeout: float = 300.0):
        """Zero-drop stop: close the intake, then the loop admits
        everything still queued (as slots free) and finishes every
        in-flight generation before exiting. Then the owned decode step
        goes back to the predictor (its slabs are freed). A loop still
        draining after ``timeout`` seconds keeps its step pinned and
        raises: call ``stop()`` again to wait on."""
        self.stop_http()
        self._chan.close()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    "DecodeServer.stop: the loop is still draining after "
                    "%g s; its decode step stays pinned" % timeout)
            self._thread = None
        if self._step is not None:
            self.predictor.release(self._step)
            self._step, self._slabs = None, []

    # metrics endpoint: the PredictorServer's (self._http/self._http_thread
    # are the only state it touches)
    from ..inference import PredictorServer as _PS

    start_http = _PS.start_http
    stop_http = _PS.stop_http
    del _PS

    # -- serving loop ------------------------------------------------------
    def _decode_request(self, msg):
        from ..inference import _decode_request

        rid, rows = _decode_request(msg)
        prompt = np.asarray(rows[0]).reshape(-1).astype(np.int64)
        max_new = self.max_new_tokens
        seed = None
        if len(rows) > 1:
            opts = np.asarray(rows[1]).reshape(-1)
            if opts.size >= 1:
                if int(opts[0]) < 1:
                    raise ValueError(
                        "max_new_tokens must be >= 1, got %d"
                        % int(opts[0]))
                max_new = min(int(opts[0]), self.max_new_tokens)
            if opts.size >= 2:
                seed = int(opts[1])
        return rid, prompt, max_new, seed

    def _set_slot_gauges(self, n_active: int):
        obs.DECODE_SLOTS.set(n_active, state="active")
        obs.DECODE_SLOTS.set(self.slots - n_active, state="free")

    def _fail(self, rid, exc):
        fut = self._pop(rid)
        if fut is not None:
            obs.PREDICT_FAILURES.inc(path="decode")
            fut.set_exception(exc)

    def _retire(self, slot_state):
        rid = slot_state["rid"]
        # span BEFORE _pop: _pop drops the trace binding
        _tracing.rid_span(rid, "decode.retire",
                          tokens=int(slot_state["count"]))
        fut = self._pop(rid)
        obs.DECODE_REQUESTS.inc(kind="retired")
        if fut is not None:  # abandoned via cancel/timeout otherwise
            fut.set_result([np.asarray(slot_state["generated"], np.int64)])
            obs.PREDICT_LATENCY_MS.observe(
                (time.perf_counter() - fut._t0) * 1e3, path="decode")
            obs.PREDICT_REQUESTS.inc(path="decode")

    def _prefill_prompts(self, prompts, slots):
        """The admission prefill: bucket the prompts to a pow2 batch and
        their OWN pow2 sequence length (not the slab's: a 16-token prompt
        admitted into a 1024-row slab costs a 16-token forward), run the
        prefill step, and write each prompt's K/V rows into its slot's
        slab rows [0:sp] in place, inside the step's ``read`` (rows past
        sp keep old values, masked by length). Returns the prompts'
        last-position logits (n, V) on the device. Raises what the
        acquire or the step raises: the caller fails the requests."""
        n = len(prompts)
        bb = _pow2_bucket(n)
        sp = min(_pow2_bucket(max(len(p) for p in prompts), floor=16),
                 self.seq)
        tokens = np.zeros((bb, sp), np.int64)
        plens = np.ones((bb,), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
            plens[i] = len(p)
        pexe, _ = self.predictor.acquire("prefill", bb, sp)
        slabs, device = self._slabs, self.predictor.device

        def read(outs):
            idx = torch.tensor(slots, dtype=torch.int64, device=device)
            with torch.inference_mode():
                for slab, rows in zip(slabs, outs[1:]):
                    slab[:, :sp].index_copy_(0, idx, rows[:n])
            return outs[0][:n].clone()

        t0 = time.perf_counter()
        logits = pexe({"tokens": tokens, "lengths": plens}, read=read)
        self.prefill_executions += 1
        obs.DECODE_STEP_MS.observe((time.perf_counter() - t0) * 1e3,
                                   stage="prefill")
        obs.DECODE_TOKENS.inc(int(plens[:n].sum()), kind="prefill")
        return logits

    def _admit(self, pending, lens, active):
        """Prefill a sub-batch of queued requests into free slots.
        ``pending`` entries are (rid, prompt, max_new, seed). A failed
        prefill fails ITS requests and leaves the server serving: the
        active slots' rows are untouched (the write is the read's last
        act, after the step ran)."""
        free = [i for i in range(self.slots) if active[i] is None]
        batch = pending[:len(free)]
        del pending[:len(batch)]
        slots = free[:len(batch)]
        try:
            t_pf = time.perf_counter()
            logits = self._prefill_prompts([b[1] for b in batch], slots)
            pf_ms = (time.perf_counter() - t_pf) * 1e3
        except Exception as e:
            for rid, _p, _mn, _seed in batch:
                self._fail(rid, e)
            return
        for i, (rid, prompt, max_new, seed) in enumerate(batch):
            _tracing.rid_span(rid, "decode.admit", kind="fresh",
                              prompt_len=len(prompt),
                              prefill_ms=round(pf_ms, 3))
            self._activate(slots[i], rid, prompt, max_new,
                           self._first_token(logits[i], seed), lens,
                           active)

    def _first_token(self, logits_row, seed):
        """First sampled token for one admitted sequence: from the
        server's stream, or from the request's own ``seed`` when it
        carried one (a greedy draw ignores both)."""
        first = int(self.predictor._sample_host(
            logits_row.reshape(1, -1), self.strategy, self._seed_ctr)[0])
        self._seed_ctr += 1
        if seed is not None and self.strategy != "greedy":
            first = int(self.predictor._sample_host(
                logits_row.reshape(1, -1), self.strategy, seed)[0])
        return first

    def _activate(self, slot, rid, prompt, max_new, first, lens, active):
        """Mark one slot live after its rows are resident."""
        st = {"rid": rid, "generated": [first], "max_new": max_new,
              "cur": first, "count": 1}
        with self._lock:
            fut = self._results.get(rid)
        if fut is not None:
            fut._t_first = time.perf_counter()
        lens[slot] = len(prompt)
        active[slot] = st
        obs.DECODE_REQUESTS.inc(kind="admitted")
        obs.DECODE_TOKENS.inc(kind="decode")
        if (self.eos_id is not None and first == self.eos_id) \
                or max_new <= 1:
            self._retire(st)
            active[slot] = None
            lens[slot] = 0

    def _fail_all_active(self, active, lens, exc):
        """Step-failure recovery: a decode step that dies must not kill
        the loop and strand every future. Fail the ACTIVE sequences
        (their slab rows are no longer trustworthy), free their slots and
        zero the slabs in place (the captured graph holds their
        addresses; with every length 0, zeros are correct)."""
        for i, st in enumerate(active):
            if st is not None:
                self._fail(st["rid"], exc)
                obs.DECODE_REQUESTS.inc(kind="retired")
                active[i] = None
                lens[i] = 0
        with torch.inference_mode():
            for slab in self._slabs:
                slab.zero_()

    def _loop(self):
        slabs = self._slabs
        dexe = self._step
        lens = np.zeros((self.slots,), np.int32)
        active: List[Optional[dict]] = [None] * self.slots
        pending: List[tuple] = []
        closed = False
        while True:
            n_active = sum(1 for a in active if a is not None)
            free = self.slots - n_active
            if not closed:
                if n_active == 0 and not pending:
                    # idle: park on the channel until work (or close)
                    batch = self._chan.recv_batch(self.slots, None)
                elif free > 0 and (self.continuous or n_active == 0):
                    # mid-flight admission: non-blocking drain, bounded
                    # by the free slots (the rest stay in the channel,
                    # keeping submit()'s backpressure intact)
                    batch = self._chan.recv_batch(free, 0)
                else:
                    batch = []
                if batch is None:
                    closed = True
                    batch = []
            else:
                batch = []
            for msg in batch:
                try:
                    rid, prompt, max_new, seed = self._decode_request(msg)
                    if len(prompt) + max_new > self.seq:
                        raise ValueError(
                            "prompt %d + max_new %d exceeds the server's "
                            "%d-token slab" % (len(prompt), max_new,
                                               self.seq))
                    if len(prompt) < 1:
                        raise ValueError("empty prompt")
                    pending.append((rid, prompt, max_new, seed))
                except Exception as e:
                    try:
                        self._fail(_rio.frame_tag(bytes(msg)), e)
                    except Exception:
                        pass
            if free > 0 and pending and (self.continuous or n_active == 0):
                self._admit(pending, lens, active)
                n_active = sum(1 for a in active if a is not None)
            self._set_slot_gauges(n_active)
            if n_active == 0:
                if closed and not pending:
                    return
                continue
            # one token across every active slot
            cur = np.zeros((self.slots,), np.int64)
            for i, st in enumerate(active):
                if st is not None:
                    cur[i] = st["cur"]
            feeds = {"tokens": cur.reshape(self.slots, 1),
                     "positions": lens.reshape(self.slots, 1).astype(
                         np.int64),
                     "lengths": lens.copy(),
                     "seed": np.array([self._seed_ctr], np.int64)}
            self._seed_ctr += 1
            feeds.update(zip(self._cache_feed_names, slabs))
            try:
                t0 = time.perf_counter()
                nxt = dexe(feeds, read=lambda outs: outs[0].cpu().numpy())
                nxt = nxt.astype(np.int64)
            except Exception as e:
                self._fail_all_active(active, lens, e)
                self._set_slot_gauges(0)
                continue
            step_ms = (time.perf_counter() - t0) * 1e3
            obs.DECODE_STEP_MS.observe(step_ms, stage="step")
            self.step_active_counts.append(n_active)
            self.step_ms.append(step_ms)
            emitted = 0
            for i, st in enumerate(active):
                if st is None:
                    continue
                lens[i] += 1
                tok = int(nxt[i])
                st["generated"].append(tok)
                st["cur"] = tok
                st["count"] += 1
                emitted += 1
                if (self.eos_id is not None and tok == self.eos_id) \
                        or st["count"] >= st["max_new"] \
                        or lens[i] + 1 >= self.seq:
                    self._retire(st)
                    active[i] = None
                    lens[i] = 0
            obs.DECODE_TOKENS.inc(emitted, kind="decode")
            # occupancy AFTER retirements: an idle server scrapes as 0
            # active (the next iteration may park before updating)
            self._set_slot_gauges(
                sum(1 for a in active if a is not None))
