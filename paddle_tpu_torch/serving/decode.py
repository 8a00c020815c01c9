"""KV-cache autoregressive decode serving: DecodePredictor and DecodeServer
(counterpart of paddle_tpu/serving/decode.py).

- ``save_decode_model`` exports a transformer_lm parameter set as a
  decode-servable directory: the canonical prefill graph through
  ``save_inference_model``, plus a ``__decode__.json`` manifest with the
  architecture config the decode-side builders need. The layout is the
  JAX package's, so an export from either package serves in either.

- ``DecodePredictor`` loads that directory and builds four kinds of step
  programs: a PREFILL step (the flash-attention forward over the padded
  prompt, emitting last-position logits plus per-layer K/V slabs), a
  per-token DECODE step (``cache_append`` of the fresh K/V row into the
  slabs, in place; single-query ``decode_attention``; in-graph greedy,
  top-k or top-p sampling, so only token ids cross to the host; a draw is
  a function of the step's ``seed`` feed, ops/sampling.py; fp32 slabs or,
  with ``kv_dtype="int8"``, int8 slabs with per-row scales), a DRAFT step
  (the decode step at ``draft_n_layer`` depth: the speculative proposer,
  driven by the same loaded state) and a VERIFY step (a window of T
  tokens appended and attended in one step, with the in-graph
  accept/reject: speculative verification, and the prefix store's suffix
  extension). Batch and slab length bucket to powers of two exactly as in
  the JAX package, so the two packages run the same programs on the same
  padded inputs. Each program is built once and wrapped by the Engine
  (serving/engine.py) in a GraphStep: on the card it is captured into one
  CUDA graph on its first call and replayed by every later one, as the
  JAX package compiles each bucket once and replays the executable. The
  decode step's K/V slabs are its static feed buffers: the prefill
  writes into them and every decode step appends to them in place. A
  draft or verify step captures over its decode step's OWN slabs (the
  decode step lends them, ``GraphStep.lender``): no slab is copied per
  call, and such a step is keyed by its lender, so it serves that decode
  step only. The steps live in one StepCache, bounded in bytes: a bucket
  least recently used is evicted with its graph, pool and slabs (and the
  steps that borrow them).

- ``generate`` decodes greedy, top-k or top-p, speculatively (greedy,
  draft-verify rounds, lossless) or by beam search (the decode step at
  strategy "logits" and ``ops.decode.beam_search_step`` on the device
  between steps, the slabs reordered by parent after each).

- ``DecodeServer`` is the continuous-batching serving loop (Orca-style
  iteration-level scheduling): requests enter the runtime's bounded
  channel as frames, queued prompts are admitted into FREE slab rows
  between decode steps (prefilled as a pow2 sub-batch at their own pow2
  length, the rows written into the resident slabs in place) and
  finished rows retire eagerly. The server OWNS its (slots, S) decode
  step: a key of its own and a pin in the step cache for its lifetime,
  so a ``generate`` at the same bucket never shares its slabs and no
  capture evicts them; its draft and verify steps borrow those slabs.
  Options: speculative rounds, a shared-prefix store at admission
  (serving/prefix.py) and int8 slabs. ``continuous=False`` is gang
  scheduling (admit a batch, run it to completion) for A/B runs.

On the card the prefill's attention is kernel K1 and each decode step's
(also a draft step's, and an int8 step's on its dequantized slabs) is
kernel K3 (ops/attention.py, ops/kv_cache.py), inside the steps' CUDA
graphs. The verify window's attention is plain PyTorch, as the JAX
package's is plain lax (ops/speculative.py).

Not ported yet: ring prefill (queue 1 item 7, multi-device).
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
           "DecodeServer", "analyze_state", "kv_slab_slots"]

_DECODE_MANIFEST = "__decode__.json"


def _pow2_bucket(n: int, floor: int = 1) -> int:
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


# bytes per slab element by kv dtype (int8 also pays a float32 scale per
# (slot, position): 4 bytes per position per K or V slab)
_KV_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def kv_slab_slots(budget_bytes: int, config: "DecodeConfig", seq: int,
                  kv_dtype: str = "float32") -> int:
    """How many cache slots one KV slab byte budget holds at ``seq``
    positions: per slot, 2 * n_layer slabs of seq * n_head * d_head
    elements (plus the per-position scales when int8)."""
    if kv_dtype not in _KV_ITEMSIZE:
        raise ValueError("kv_dtype must be one of %s, got %r"
                         % (sorted(_KV_ITEMSIZE), kv_dtype))
    per_pos = config.n_head * config.d_head * _KV_ITEMSIZE[kv_dtype]
    if kv_dtype == "int8":
        per_pos += 4  # the (slot, position) float32 scale
    per_slot = 2 * config.n_layer * int(seq) * per_pos
    return max(int(budget_bytes) // per_slot, 0)


def _kv_dtype_from_env() -> str:
    """PADDLE_TPU_QUANT=kv8|int8 opts DecodeServer slabs into int8."""
    raw = (os.environ.get("PADDLE_TPU_QUANT") or "").strip().lower()
    return "int8" if raw in ("kv8", "int8") else "float32"


def _slab_names(n_layer: int, kv_dtype: str = "float32") -> List[str]:
    """The K/V slab feeds of a decode step, per layer (k, v) and, for
    int8 slabs, (k scales, v scales): the order of the step's fetches."""
    kinds = ("kcache", "vcache") + (("kscale", "vscale")
                                    if kv_dtype == "int8" else ())
    return ["%s_%d" % (kind, i) for i in range(n_layer) for kind in kinds]


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
    outs = pred.generate(prompts, 16, speculative=True, spec_k=4)
    outs = pred.generate(prompts, 16, strategy="beam", beam_size=4)

    ``place=None`` means ``CUDAPlace(0)``; with no CUDA device that
    raises — the predictor never moves to the CPU unasked. ``generate``
    is the static-batch surface (one call, one bucketed batch, run to
    completion); ``DecodeServer`` drives the same steps with continuous
    batching. ``sample_k``, ``sample_p`` and ``temperature`` are built
    into the "topk" and "topp" decode programs. ``draft_n_layer`` is the
    speculative draft's depth: the target's first layers, driven by the
    same loaded state (default half the depth, at least 1). After a
    call, ``timings`` holds its prefill and per-step host times in ms
    (each ends in a device-to-host read of the sampled ids, so it covers
    the device work; a speculative call's "draft" and "verify" times are
    the device's, by CUDA events on the card). ``max_step_bytes`` bounds
    the device memory of the cached steps (slabs, buffers and graph
    pools; None: ``engine.default_step_bytes``, half the card).
    """

    def __init__(self, model_dir: str, place=None, strategy: str = "greedy",
                 sample_k: int = 40, sample_p: float = 0.9,
                 temperature: float = 1.0, eos_id: Optional[int] = None,
                 draft_n_layer: Optional[int] = None,
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
        self.draft_n_layer = (int(draft_n_layer)
                              if draft_n_layer is not None
                              else max(1, self.config.n_layer // 2))
        if not 1 <= self.draft_n_layer <= self.config.n_layer:
            raise ValueError(
                "draft_n_layer must be in [1, %d], got %d"
                % (self.config.n_layer, self.draft_n_layer))
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
    def _build(self, kind: str, batch: int, seq: int, strategy: str,
               kv_dtype: str = "float32", window: int = 0):
        """Build the (batch, seq) Program for one kind; returns (program,
        feed_names, fetch_names). The same arguments build the same
        program as the JAX package's ``DecodePredictor._build``.

        Kinds: "prefill" (full causal forward), "decode" (one token per
        step; ``kv_dtype="int8"`` builds the int8-slab variant with
        per-layer scale feeds), "draft" (the decode step at
        ``draft_n_layer`` depth) and "verify" (the ``window``-token
        verify / suffix-extension step: window appends, staircase
        attention, in-graph accept)."""
        from .. import layers
        from ..framework import Program, program_guard, unique_name
        from ..models import transformer as _T

        cfg = self.config
        prog, startup = Program(), Program()

        def slabs(n_layer, dtype="float32", scales=False):
            """The slab feeds, declared layer by layer as the JAX package
            declares them: (k, v[, k scales, v scales]) lists."""
            out = ([], [], [], [])
            for i in range(n_layer):
                for j, kind in enumerate(("kcache", "vcache")):
                    out[j].append(layers.data(
                        name="%s_%d" % (kind, i),
                        shape=[batch, seq, cfg.n_head, cfg.d_head],
                        dtype=dtype, append_batch_size=False))
                if scales:
                    for j, kind in enumerate(("kscale", "vscale")):
                        out[2 + j].append(layers.data(
                            name="%s_%d" % (kind, i), shape=[batch, seq],
                            dtype="float32", append_batch_size=False))
            return out

        with program_guard(prog, startup):
            with unique_name.guard():
                if kind == "prefill":
                    logits, caches = _prefill_graph(cfg, batch, seq)
                    feeds = ["tokens", "lengths"]
                    fetches = [logits.name] + [
                        c.name for pair in caches for c in pair]
                elif kind == "verify":
                    tokens = layers.data(name="tokens",
                                         shape=[batch, window],
                                         dtype="int64",
                                         append_batch_size=False)
                    positions = layers.data(name="positions",
                                            shape=[batch, window],
                                            dtype="int64",
                                            append_batch_size=False)
                    lengths = layers.data(name="lengths", shape=[batch],
                                          dtype="int32",
                                          append_batch_size=False)
                    last_idx = layers.data(name="last_idx", shape=[batch],
                                           dtype="int32",
                                           append_batch_size=False)
                    kc, vc, _ks, _vs = slabs(cfg.n_layer)
                    next_ids, accept, last_logits, ncaches = (
                        _T.transformer_lm_verify(
                            tokens, positions, lengths, last_idx, kc, vc,
                            cfg.vocab_size, n_layer=cfg.n_layer,
                            n_head=cfg.n_head, d_model=cfg.d_model,
                            d_inner=cfg.d_inner, max_len=cfg.max_len,
                            tie_embeddings=cfg.tie_embeddings,
                            prefix=cfg.prefix))
                    feeds = (["tokens", "positions", "lengths", "last_idx"]
                             + [v.name for v in kc] + [v.name for v in vc])
                    fetches = ([next_ids.name, accept.name,
                                last_logits.name]
                               + [c.name for pair in ncaches for c in pair])
                elif kind in ("decode", "draft"):
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
                    n_layer = (self.draft_n_layer if kind == "draft"
                               else cfg.n_layer)
                    int8 = kv_dtype == "int8"
                    kc, vc, ks, vs = slabs(
                        n_layer, "int8" if int8 else "float32", int8)
                    next_ids, logits, ncaches = _T.transformer_lm_decode(
                        tokens, positions, lengths, kc, vc, cfg.vocab_size,
                        n_layer=n_layer, n_head=cfg.n_head,
                        d_model=cfg.d_model, d_inner=cfg.d_inner,
                        max_len=cfg.max_len,
                        tie_embeddings=cfg.tie_embeddings,
                        prefix=cfg.prefix, strategy=strategy, seed=seed,
                        sample_k=self.sample_k, sample_p=self.sample_p,
                        temperature=self.temperature,
                        k_scales=ks or None, v_scales=vs or None)
                    feeds = (["tokens", "positions", "lengths", "seed"]
                             + [v.name for v in kc + vc + ks + vs])
                    fetches = [logits.name] + [
                        c.name for tup in ncaches for c in tup]
                    if next_ids is not None:
                        fetches = [next_ids.name] + fetches
                else:
                    raise ValueError(
                        "unknown step kind %r (prefill | decode | draft | "
                        "verify)" % (kind,))
        return prog, feeds, fetches

    def acquire(self, kind: str, batch: int, seq: int,
                strategy: Optional[str] = None, owner=None,
                kv_dtype: str = "float32", window: int = 0, lender=None):
        """The step for one (kind, batch, seq, strategy, kv_dtype, window)
        signature, looked up by its key in the Engine's memory tier
        (serving/engine.py), built there on a miss; the program is built
        once. Returns (step, fetch_names); ``step(feeds, read=None)`` is a
        GraphStep: it copies the feeds into its static buffers and, on the
        card, replays the program's CUDA graph (captured on its first
        call). Its outputs are valid until its next call. ``kv_dtype``
        shapes decode steps only; "draft" is the decode step at
        ``draft_n_layer`` depth, always greedy; ``window`` is the verify
        kind's token width. With ``owner`` (any hashable) the step is that
        owner's own: ``owner`` completes its key, so its buffers are no
        one else's, and it is pinned in the cache until ``release``. With
        ``lender`` (a decode step) the step's K/V slab feeds are the
        lender's own slab tensors: its graph reads and writes them in
        place, and the step serves that lender only; a lender whose slabs
        do not fit the step raises."""
        from ..framework.dtypes import as_torch_dtype
        from .engine import Engine

        strategy = strategy or self.strategy
        if kind not in ("decode", "draft"):
            kv_dtype = "float32"
        if kind == "draft":
            strategy = "greedy"  # proposals are always argmax
        ck = (kind, batch, seq,
              strategy if kind in ("decode", "draft") else "", kv_dtype,
              int(window), self.draft_n_layer if kind == "draft" else 0)
        with self._lock:
            engine = self._engines.get(ck)
            if engine is None:
                program, feed_names, fetch_names = self._build(
                    kind, batch, seq, strategy, kv_dtype=kv_dtype,
                    window=window)
                engine = self._engines[ck] = Engine(
                    program, memory=self._steps, feed_names=feed_names,
                    fetch_names=fetch_names)
        specs = [(n, tuple(var.shape), as_torch_dtype(var.dtype))
                 for n, var, _ in engine.feed_plan()]
        extra = () if owner is None else ("owner", owner)
        lent = () if lender is None else [
            n for n, _shape, _dt in specs
            if n.startswith(("kcache_", "vcache_", "kscale_", "vscale_"))]
        step = engine.graph_step(kind, specs, self._state, self.device,
                                 *extra, pin=owner is not None,
                                 lender=lender, lent=lent)
        return step, list(engine.fetch_names)

    def release(self, step) -> None:
        """Hand back an owned step (``acquire(..., owner=...)``): it leaves
        the cache, with its buffers and graph (and the steps it lends its
        slabs to)."""
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

    def _prefill(self, tokens, lens, slab_seq, slabs=None, rows=None):
        """Run prefill at the PROMPTS' own pow2 sequence bucket (prompt
        cost scales with the prompt, not with the decode budget) and
        return its last-position logits (B, V). With ``slabs``, the decode
        bucket's K/V slabs ([k_0, v_0, k_1, ...], ``slab_seq`` rows), its
        K/V land in their rows [0:sp] and rows [sp:] are zeroed, as the
        JAX package's zero pad leaves them; slab row i takes prefill row
        ``rows[i]`` (a device index tensor) when given, else row i."""
        bb = tokens.shape[0]
        sp = min(_pow2_bucket(int(lens.max()), floor=16), slab_seq)
        pexe, _ = self.acquire("prefill", bb, sp)

        def read(outs):
            if slabs is not None:
                with torch.inference_mode():
                    for slab, cache in zip(slabs, outs[1:]):
                        if rows is not None:
                            cache = cache.index_select(0, rows)
                        slab[:, :sp].copy_(cache)
                        slab[:, sp:].zero_()
            return outs[0].clone()

        t0 = time.perf_counter()
        logits = pexe({"tokens": tokens[:, :sp], "lengths": lens}, read=read)
        obs.DECODE_STEP_MS.observe((time.perf_counter() - t0) * 1e3,
                                   stage="prefill")
        return logits

    def _slabs(self, dstep) -> list:
        """A decode (or draft) step's K/V slab buffers in the order its
        fetches flatten them: (k, v) per layer, and (k scales, v scales)
        for int8 slabs."""
        return [dstep.static[n]
                for n in _slab_names(self.config.n_layer, "int8")
                if n in dstep.static]

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
                 beam_size: int = 4, speculative: bool = False,
                 spec_k: int = 4) -> List[np.ndarray]:
        """Generate up to ``max_new_tokens`` per prompt (stopping a row
        early at ``eos_id``). Returns one int64 array of generated ids
        per prompt. ``strategy`` overrides the constructor's ("greedy" |
        "topk" | "topp" | "beam"); the first token is drawn with ``seed``,
        decode step t with ``seed + t``, so the same seed gives the same
        ids. ``strategy="beam"`` is ``generate_beam`` at ``beam_size``.
        ``speculative=True`` (greedy only) is ``generate_speculative``:
        token for token plain greedy's output, up to ``spec_k + 1``
        tokens per target step. Calls from several threads run one at a
        time."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1, got %d"
                             % max_new_tokens)
        strategy = strategy or self.strategy
        eos = eos_id if eos_id is not None else self.eos_id
        if speculative:
            if strategy != "greedy":
                raise ValueError(
                    "speculative decoding is lossless for greedy only; "
                    "got strategy %r" % (strategy,))
            return self.generate_speculative(
                prompts, max_new_tokens, spec_k=spec_k, eos_id=eos)
        if strategy == "beam":
            return self.generate_beam(prompts, max_new_tokens,
                                      beam_size=beam_size, eos_id=eos)
        if strategy not in ("greedy", "topk", "topp"):
            # "logits" builds a sampler-less step whose fetch layout (no
            # next_ids) this loop cannot drive
            raise ValueError(
                "unknown decode strategy %r (greedy | topk | topp | "
                "beam)" % (strategy,))
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
            self._plain_decode_steps(dexe, cur, lens.copy(), generated,
                                     finished, b, s, eos, max_new_tokens,
                                     seed)
        return [np.asarray(g, np.int64) for g in generated]

    def _plain_decode_steps(self, dexe, cur, lens, generated, finished, b,
                            s, eos, max_new_tokens, seed) -> None:
        """The one-token-per-iteration step loop, shared by ``generate``
        and ``generate_speculative`` (the tail once a verify window no
        longer fits the slab). Mutates ``cur`` / ``lens`` /
        ``generated`` / ``finished`` per ROW — a finished row's slot
        state freezes (its re-fed token and parked length only touch
        its own slab row, masked from every live row). A row stops at
        eos, at its token budget, or when its slab row is full."""
        bb = cur.shape[0]
        slab_feeds = {n: dexe.static[n]
                      for n in _slab_names(self.config.n_layer)}
        step = 0
        while not finished.all():
            step += 1
            feeds = {"tokens": cur.reshape(bb, 1).astype(np.int64),
                     "positions": lens.reshape(bb, 1).astype(np.int64),
                     "lengths": lens,
                     "seed": np.array([seed + step], np.int64)}
            feeds.update(slab_feeds)
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

    # -- speculative decoding (draft-verify rounds, greedy, lossless) ------
    def draft_window(self, drexe, cur, lens, spec_k):
        """One speculative round's DRAFT half, shared by
        ``generate_speculative`` and ``DecodeServer._spec_round``:
        ``spec_k`` steps of the ``draft_n_layer``-deep draft step
        ``drexe`` over its lender's slabs, each proposing one token per
        row, chained on the device (no read to the host). The draft
        writes its rows into the target's first layers' slabs at rows
        lens..lens+spec_k-1; the verify window then appends all its rows
        over them before any attention reads them. Returns (window
        tokens (B, spec_k+1) int64 on the device, positions (B, spec_k+1)
        on the host, clipped to max_len-1 so window slots past a row's
        reach still embed in range)."""
        bb = cur.shape[0]
        max_len = self.config.max_len
        slab_feeds = {n: drexe.static[n]
                      for n in _slab_names(self.draft_n_layer)}
        toks = [torch.as_tensor(np.asarray(cur, np.int64)).to(self.device)]
        zeros_seed = np.zeros((1,), np.int64)
        for j in range(spec_k):
            dlens = (lens + j).astype(np.int32)
            feeds = {"tokens": toks[-1].reshape(bb, 1),
                     "positions": np.minimum(dlens, max_len - 1).reshape(
                         bb, 1).astype(np.int64),
                     "lengths": dlens, "seed": zeros_seed}
            feeds.update(slab_feeds)
            toks.append(drexe(feeds, read=lambda outs: outs[0].clone()))
        window = torch.stack(toks, dim=1)
        positions = np.minimum(
            lens[:, None].astype(np.int64)
            + np.arange(spec_k + 1, dtype=np.int64)[None, :], max_len - 1)
        return window, positions

    def generate_speculative(self, prompts: Sequence[np.ndarray],
                             max_new_tokens: int = 32, spec_k: int = 4,
                             eos_id: Optional[int] = None
                             ) -> List[np.ndarray]:
        """Greedy speculative decode: per round, ``spec_k`` draft steps
        (the target's first ``draft_n_layer`` layers, same loaded state)
        propose tokens, then ONE verify window step checks them all
        against the full target and emits accept+1 tokens per row. Token
        for token ``generate(strategy="greedy")``'s output; when the
        window would overrun the slab, the tail finishes on plain decode
        steps. The draft and verify steps capture over the decode step's
        slabs (no slab copied per call). Calls run one at a time."""
        if spec_k < 1:
            raise ValueError("spec_k must be >= 1, got %d" % spec_k)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1, got %d"
                             % max_new_tokens)
        eos = eos_id if eos_id is not None else self.eos_id
        with self._generating:
            return self._generate_speculative(prompts, max_new_tokens,
                                              spec_k, eos)

    def _generate_speculative(self, prompts, max_new_tokens, spec_k, eos):
        self.timings = {"prefill": [], "step": [], "draft": [],
                        "verify": []}
        tokens, lens, b, s = self._bucketed(prompts, max_new_tokens)
        bb = tokens.shape[0]
        T = spec_k + 1
        dexe, _ = self.acquire("decode", bb, s, "greedy")
        t0 = time.perf_counter()
        logits = self._prefill(tokens, lens, s, self._slabs(dexe))
        obs.DECODE_TOKENS.inc(int(lens[:b].sum()), kind="prefill")
        cur = np.array(self._sample_host(logits, "greedy", 0))  # writable
        self.timings["prefill"].append((time.perf_counter() - t0) * 1e3)
        generated = [[int(cur[i])] for i in range(b)]
        finished = np.array([(eos is not None and int(cur[i]) == eos)
                             or max_new_tokens <= 1 for i in range(b)])
        obs.DECODE_TOKENS.inc(b, kind="decode")
        lens = lens.copy().astype(np.int32)
        if not finished.all():
            drexe, _ = self.acquire("draft", bb, s, lender=dexe)
            vexe, _ = self.acquire("verify", bb, s, window=T, lender=dexe)
            slab_feeds = {n: dexe.static[n]
                          for n in _slab_names(self.config.n_layer)}
        zeros_idx = np.zeros((bb,), np.int32)
        marks = []   # per round: (before draft, after draft, after verify)
        while not finished.all() and int(lens.max()) + T <= s:
            m0 = _mark(self.device)
            window, positions = self.draft_window(drexe, cur, lens, spec_k)
            m1 = _mark(self.device)
            feeds = {"tokens": window, "positions": positions,
                     "lengths": lens, "last_idx": zeros_idx}
            feeds.update(slab_feeds)
            next_ids, accept = vexe(feeds, read=lambda outs: (
                outs[0].cpu().numpy(), outs[1].cpu().numpy()))
            marks.append((m0, m1, _mark(self.device)))
            next_ids = next_ids.astype(np.int64)
            accept = accept.astype(np.int64)
            live = int((~finished[:b]).sum()) if b else 0
            obs.DECODE_SPEC_PROPOSED.inc(spec_k * live)
            emitted = 0
            for i in range(b):
                if finished[i]:
                    continue
                a = int(accept[i])
                obs.DECODE_SPEC_ACCEPTED.inc(a)
                take = min(a + 1, max_new_tokens - len(generated[i]))
                for j in range(take):
                    tok = int(next_ids[i, j])
                    generated[i].append(tok)
                    emitted += 1
                    if eos is not None and tok == eos:
                        finished[i] = True
                        break
                if len(generated[i]) >= max_new_tokens:
                    finished[i] = True
                if not finished[i]:
                    # rollback by truncation: rows past lens+a are
                    # rejected-window garbage, masked by length and
                    # overwritten by later appends
                    lens[i] += a + 1
                    cur[i] = next_ids[i, a]
            obs.DECODE_TOKENS.inc(emitted, kind="decode")
        for m0, m1, m2 in marks:
            for stage, a, z in (("draft", m0, m1), ("verify", m1, m2)):
                ms = _elapsed_ms(a, z)
                self.timings[stage].append(ms)
                obs.DECODE_STEP_MS.observe(ms, stage=stage)
        if not finished.all():
            # slab headroom exhausted: finish the tail on the same plain
            # step loop generate() runs (greedy ignores the seed feed)
            self._plain_decode_steps(dexe, cur, lens, generated, finished,
                                     b, s, eos, max_new_tokens, seed=0)
        return [np.asarray(g, np.int64) for g in generated]

    # -- beam search (ops.decode's beam step between decode steps) ---------
    def generate_beam(self, prompts: Sequence[np.ndarray],
                      max_new_tokens: int = 32, beam_size: int = 4,
                      eos_id: Optional[int] = None,
                      return_all: bool = False):
        """Beam-search decode: the decode step runs with strategy
        "logits" (no sampler) at batch pow2(B * beam_size), and
        ``ops.decode.beam_search_step`` picks the continuations on the
        device between steps; after each step every slab is reordered by
        parent (``cache_gather``, out of place, then copied back into the
        step's slab: an in-place gather with repeated parents would read
        rows it has already overwritten). Returns the best beam's ids per
        prompt, or with ``return_all`` (ids (B, K, T), lengths (B, K),
        scores (B, K)) as numpy arrays. Calls run one at a time."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1, got %d"
                             % max_new_tokens)
        eos = eos_id if eos_id is not None else self.eos_id
        with self._generating:
            return self._generate_beam(prompts, max_new_tokens,
                                       int(beam_size), eos, return_all)

    def _generate_beam(self, prompts, max_new_tokens, k, eos, return_all):
        from ..ops.decode import beam_search_backtrack, beam_search_step
        from ..ops.kv_cache import cache_gather

        self.timings = {"prefill": [], "step": []}
        dev = self.device
        end_id = -1 if eos is None else int(eos)
        tokens, lens, b, s = self._bucketed(prompts, max_new_tokens)
        bk = _pow2_bucket(b * k)
        dexe, _ = self.acquire("decode", bk, s, "logits")
        slabs = self._slabs(dexe)
        # beam-expand the prefill's rows: slab row b*K+j starts as prompt
        # b's (pad rows take prompt 0's)
        pad = torch.zeros(bk - b * k, dtype=torch.int64, device=dev)
        expand = torch.cat([torch.arange(b, device=dev).repeat_interleave(k),
                            pad])
        t0 = time.perf_counter()
        logits = self._prefill(tokens, lens, s, slabs, rows=expand)
        obs.DECODE_TOKENS.inc(int(lens[:b].sum()), kind="prefill")
        lp = torch.log_softmax(logits[:b].float(), dim=-1)
        pre_scores, pre_ids = torch.topk(lp, k, dim=-1)          # (B, K)
        pre_ids = pre_ids.to(torch.int32)
        self.timings["prefill"].append((time.perf_counter() - t0) * 1e3)
        lens_k = np.concatenate(
            [np.repeat(lens[:b], k), np.ones(bk - b * k, np.int32)]
        ).astype(np.int32)
        step_ids = [pre_ids]
        step_parents = [torch.arange(k, dtype=torch.int32, device=dev)[
            None, :].expand(b, k)]
        slab_feeds = {n: dexe.static[n]
                      for n in _slab_names(self.config.n_layer)}
        base = (torch.arange(b, device=dev) * k)[:, None]
        for _step in range(1, max_new_tokens):
            cur = torch.cat([pre_ids.reshape(-1).to(torch.int64), pad])
            feeds = {"tokens": cur.reshape(bk, 1),
                     "positions": lens_k.reshape(bk, 1).astype(np.int64),
                     "lengths": lens_k, "seed": np.zeros((1,), np.int64)}
            feeds.update(slab_feeds)
            t0 = time.perf_counter()
            logits = dexe(feeds, read=lambda outs: outs[0][:b * k].float()
                          .clone())
            lp = torch.log_softmax(logits, dim=-1).reshape(
                b, k, self.config.vocab_size)
            total = pre_scores[:, :, None] + lp
            sel_ids, sel_scores, parents = beam_search_step(
                pre_ids, pre_scores, total, None, k, end_id)
            # reorder the APPENDED slabs by parent so each surviving beam
            # carries its parent's full lineage
            flat_parent = torch.cat([(base + parents).reshape(-1), pad])
            with torch.inference_mode():
                for slab in slabs:
                    slab.copy_(cache_gather(slab, flat_parent))
            ms = (time.perf_counter() - t0) * 1e3
            self.timings["step"].append(ms)
            obs.DECODE_STEP_MS.observe(ms, stage="step")
            pre_ids, pre_scores = sel_ids, sel_scores
            step_ids.append(sel_ids)
            step_parents.append(parents)
            lens_k = lens_k + 1
            obs.DECODE_TOKENS.inc(b * k, kind="decode")
            if eos is not None and bool((sel_ids == end_id).all()):
                break
        sent, slens = beam_search_backtrack(
            torch.stack(step_ids), torch.stack(step_parents), end_id)
        sent, slens = sent.cpu().numpy(), slens.cpu().numpy()
        if return_all:
            return sent, slens, pre_scores.cpu().numpy()
        return [np.asarray(sent[i, 0, :slens[i, 0]], np.int64)
                for i in range(b)]


def _mark(device):
    """A point in time on ``device``'s current stream: a recorded CUDA
    event on the card (it completes when the work before it has), else
    the host clock."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _elapsed_ms(a, b) -> float:
    """Milliseconds between two ``_mark`` points (events: once both have
    completed)."""
    if isinstance(a, float):
        return (b - a) * 1e3
    b.synchronize()
    return a.elapsed_time(b)


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
    fails the requests it holds (the slabs are zeroed) and the loop
    serves on; nothing runs the plain version in a kernel's place.

    Options, as in the JAX package:

    - ``speculative=True`` (greedy only): each iteration is a round of
      ``spec_k`` draft steps (the predictor's ``draft_n_layer`` layers)
      and one verify window step of ``spec_k + 1`` tokens; each active
      slot advances by its accepted proposals plus one, token for token
      the plain loop's output. The draft and verify steps are the
      server's own too and capture over its decode step's slabs.
    - ``prefix_cache=True`` (or a ``prefix_store`` to share): admission
      looks each prompt up in a refcounted store of prefilled rows
      (serving/prefix.py, host arrays; ``prefix_block`` aligns its index,
      ``prefix_max_bytes`` bounds it). A full hit admits with no model
      call, a partial hit seeds the cached header's rows and extends the
      rest through the verify window step (``spec_k + 1`` tokens a call),
      and the misses of one admission share one prefill, which fills the
      store.
    - ``kv_dtype="int8"`` (None reads ``PADDLE_TPU_QUANT``: kv8 or int8):
      int8 slabs with one fp32 scale per (slot, position); admission
      quantizes the prefill's rows, each decode step its own row, and
      attention dequantizes the slabs, then runs K3. Not with the two
      options above (the JAX package's rule).

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
    """

    _owners = itertools.count()

    def __init__(self, predictor: DecodePredictor, slots: int = 4,
                 max_seq: Optional[int] = None, max_new_tokens: int = 32,
                 strategy: Optional[str] = None, capacity: int = 256,
                 eos_id: Optional[int] = None, continuous: bool = True,
                 prewarm: bool = True, kv_dtype: Optional[str] = None,
                 speculative: bool = False, spec_k: int = 4,
                 prefix_cache: bool = False, prefix_block: int = 16,
                 prefix_max_bytes: Optional[int] = None,
                 prefix_store=None):
        from ..runtime.recordio import Channel

        if slots < 1:
            raise ValueError("slots must be >= 1, got %d" % slots)
        self.predictor = predictor
        self.slots = int(slots)
        self.kv_dtype = kv_dtype if kv_dtype is not None \
            else _kv_dtype_from_env()
        if self.kv_dtype not in ("float32", "int8"):
            raise ValueError(
                "kv_dtype must be 'float32' or 'int8', got %r"
                % (self.kv_dtype,))
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
        self.speculative = bool(speculative)
        self.spec_k = int(spec_k)
        if self.speculative and self.strategy != "greedy":
            raise ValueError(
                "speculative decoding is lossless for greedy only; the "
                "server strategy is %r" % (self.strategy,))
        if (self.speculative or prefix_cache or prefix_store is not None) \
                and self.spec_k < 1:
            # a prefix-only server sizes its suffix-extension window off
            # spec_k too
            raise ValueError("spec_k must be >= 1, got %d" % self.spec_k)
        if prefix_store is not None:
            self._prefix = prefix_store
        elif prefix_cache:
            from .prefix import PrefixStore

            self._prefix = PrefixStore(max_bytes=prefix_max_bytes,
                                       block=prefix_block)
        else:
            self._prefix = None
        if (self.speculative or self._prefix is not None) \
                and self.kv_dtype == "int8":
            raise ValueError(
                "speculative decoding / prefix sharing run float32 "
                "slabs; drop kv_dtype='int8' or the lever")
        # the verify window's width: speculative rounds and suffix
        # extension share one (slots, S, T) step
        self._win = self.spec_k + 1
        # the owned steps' key part, unique in the process
        self._owner = ("decode_server", next(DecodeServer._owners))
        self._step = None      # the owned decode step, from start()
        self._draft = None     # its draft and verify steps, which
        self._verify = None    # borrow its slabs
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
        # ms of each decode step or speculative round (each ends in the
        # read of its ids)
        self.step_active_counts: "collections.deque" = collections.deque(
            maxlen=100_000)
        self.step_ms: "collections.deque" = collections.deque(
            maxlen=100_000)
        # the slab feeds, in the order the decode step's fetches flatten
        # its updated slabs: (k, v) per layer, and (k scales, v scales)
        # when int8 (== predictor._slabs order)
        self._cache_feed_names = _slab_names(cfg.n_layer, self.kv_dtype)

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
        """Acquire (and pin) the server's own decode step, and its draft
        and verify steps over the same slabs when speculative or
        prefix-sharing, then start the loop. With ``prewarm`` the
        steady-state steps are made before the first request (on the
        card: captured): those steps and the single-request and
        full-burst admission prefills at the floor prompt bucket; a
        longer prompt captures its own bucket on its first arrival."""
        if self._thread is not None and self._thread.is_alive():
            return
        pred = self.predictor
        if self._step is None:
            self._step, _ = pred.acquire(
                "decode", self.slots, self.seq, self.strategy,
                owner=self._owner, kv_dtype=self.kv_dtype)
            self._slabs = [self._step.static[n]
                           for n in self._cache_feed_names]
            if self.speculative:
                self._draft, _ = pred.acquire(
                    "draft", self.slots, self.seq, owner=self._owner,
                    lender=self._step)
            if self.speculative or self._prefix is not None:
                self._verify, _ = pred.acquire(
                    "verify", self.slots, self.seq, window=self._win,
                    owner=self._owner, lender=self._step)
        if self._prewarm:
            t0 = time.perf_counter()
            steps = [s for s in (self._step, self._draft, self._verify)
                     if s is not None]
            sp = min(16, self.seq)
            for batch in sorted({1, _pow2_bucket(self.slots)}):
                steps.append(pred.acquire("prefill", batch, sp)[0])
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
        in-flight generation before exiting. Then the owned steps go back
        to the predictor (the slabs are freed). A loop still draining
        after ``timeout`` seconds keeps its steps pinned and raises: call
        ``stop()`` again to wait on."""
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
            # the draft and verify steps leave with the decode step that
            # lends them its slabs
            self.predictor.release(self._step)
            self._step, self._draft, self._verify = None, None, None
            self._slabs = []

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
        if self._prefix is not None:
            # the retired sequence no longer pins its prefix entry
            self._prefix.release(slot_state.get("prefix_entry"))
        if fut is not None:  # abandoned via cancel/timeout otherwise
            fut.set_result([np.asarray(slot_state["generated"], np.int64)])
            obs.PREDICT_LATENCY_MS.observe(
                (time.perf_counter() - fut._t0) * 1e3, path="decode")
            obs.PREDICT_REQUESTS.inc(path="decode")

    def _prefill_prompts(self, prompts, slots, host_rows=None):
        """The admission prefill: bucket the prompts to a pow2 batch and
        their OWN pow2 sequence length (not the slab's: a 16-token prompt
        admitted into a 1024-row slab costs a 16-token forward) and run
        the prefill step. Each prompt's K/V rows are written into its
        slot's slab rows [0:sp] in place (quantized for int8 slabs),
        inside the step's ``read`` (rows past sp keep old values, masked
        by length); with a ``host_rows`` list (the prefix store's
        misses), each prompt's rows are also appended to it as host
        arrays [k_0, v_0, k_1, ...] of (len, H, Dh). Returns the prompts'
        last-position logits (n, V) on the device. Raises what the
        acquire or the step raises: the caller fails the requests."""
        from ..ops.quant import quantize_kv_rows

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
        slab = dict(zip(self._cache_feed_names, self._slabs))
        n_layer, device = self.predictor.config.n_layer, \
            self.predictor.device

        def write(outs):
            idx = torch.tensor(slots, dtype=torch.int64, device=device)
            with torch.inference_mode():
                for li in range(n_layer):
                    for j, kind in enumerate(("k", "v")):
                        rows = outs[1 + 2 * li + j][:n]
                        cache = slab["%scache_%d" % (kind, li)]
                        if self.kv_dtype == "int8":
                            rows, scales = quantize_kv_rows(rows)
                            slab["%sscale_%d" % (kind, li)][:, :sp] \
                                .index_copy_(0, idx, scales)
                        cache[:, :sp].index_copy_(0, idx, rows)
            if host_rows is not None:
                rows = [c[:n].cpu().numpy() for c in outs[1:]]
                host_rows.extend([r[i, :len(p)] for r in rows]
                                 for i, p in enumerate(prompts))
            return outs[0][:n].clone()

        t0 = time.perf_counter()
        got = pexe({"tokens": tokens, "lengths": plens}, read=write)
        self.prefill_executions += 1
        obs.DECODE_STEP_MS.observe((time.perf_counter() - t0) * 1e3,
                                   stage="prefill")
        obs.DECODE_TOKENS.inc(int(plens[:n].sum()), kind="prefill")
        return got

    def _admit(self, pending, lens, active):
        """Prefill a sub-batch of queued requests into free slots.
        ``pending`` entries are (rid, prompt, max_new, seed). With a
        prefix store, admission goes through ``_admit_prefix``. A failed
        prefill fails ITS requests and leaves the server serving: the
        active slots' rows are untouched (the write is the read's last
        act, after the step ran)."""
        free = [i for i in range(self.slots) if active[i] is None]
        batch = pending[:len(free)]
        del pending[:len(batch)]
        if self._prefix is not None:
            self._admit_prefix(batch, free, lens, active)
            return
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
        row = torch.as_tensor(logits_row, device=self.predictor.device)
        first = int(self.predictor._sample_host(
            row.reshape(1, -1), self.strategy, self._seed_ctr)[0])
        self._seed_ctr += 1
        if seed is not None and self.strategy != "greedy":
            first = int(self.predictor._sample_host(
                row.reshape(1, -1), self.strategy, seed)[0])
        return first

    def _activate(self, slot, rid, prompt, max_new, first, lens, active,
                  entry_id=None):
        """Mark one slot live after its rows are resident (the common tail
        of every admission); ``entry_id`` is the prefix entry it holds a
        reference to until it retires."""
        st = {"rid": rid, "generated": [first], "max_new": max_new,
              "cur": first, "count": 1, "prefix_entry": entry_id}
        if entry_id is not None:
            self._prefix.acquire(entry_id)
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

    def _admit_prefix(self, batch, free, lens, active):
        """Prefix-aware admission: hash each prompt against the store;
        full hits admit with NO model call, partial hits seed the cached
        header rows and extend only their suffix through the verify
        window, misses (deduped within the sub-batch) prefill once and
        fill the store. A failure before the extension fails THIS batch
        and leaves the server serving; a failed extension is a step
        failure (every active sequence fails, the slabs are zeroed)."""
        from .prefix import prefix_hash

        if not batch:
            return
        plan: List[dict] = []
        uniq_prompts: List[np.ndarray] = []
        uniq_slots: List[int] = []   # each miss prefills into its slot
        uniq_map: Dict[str, int] = {}
        for (rid, prompt, _mn, _seed), slot in zip(batch, free):
            eid, L, rows, logits = self._prefix.lookup(prompt)
            if eid is not None and L == len(prompt):
                plan.append({"kind": "full", "eid": eid, "L": L,
                             "rows": rows, "logits": logits})
            elif eid is not None:
                plan.append({"kind": "partial", "eid": eid, "L": L,
                             "rows": rows})
            else:
                h = prefix_hash(prompt)
                if h in uniq_map:
                    obs.DECODE_PREFIX_HITS.inc(kind="batch")
                    plan.append({"kind": "dup", "uniq": uniq_map[h]})
                else:
                    uniq_map[h] = len(uniq_prompts)
                    uniq_prompts.append(prompt)
                    uniq_slots.append(slot)
                    plan.append({"kind": "miss", "uniq": uniq_map[h]})
        try:
            # ONE prefill over the deduped misses, written into their
            # slots in place; their rows go to the host for the store
            uniq_rows: List[List[np.ndarray]] = []
            uniq_logits = None
            uniq_eids: List[Optional[int]] = []
            pf_ms = 0.0
            if uniq_prompts:
                t_pf = time.perf_counter()
                uniq_logits = self._prefill_prompts(
                    uniq_prompts, uniq_slots, host_rows=uniq_rows)
                host_logits = uniq_logits.cpu().numpy()
                pf_ms = (time.perf_counter() - t_pf) * 1e3
                for i, p in enumerate(uniq_prompts):
                    uniq_eids.append(self._prefix.insert(
                        p, uniq_rows[i], host_logits[i]))
            ext_jobs = []    # (idx-in-batch, slot, suffix, eid)
            seeds_rows = []  # (slot, rows, L) for the batched write
            for i, ((rid, prompt, max_new, seed), p) in enumerate(
                    zip(batch, plan)):
                slot = free[i]
                _tracing.rid_span(
                    rid, "decode.admit", kind="prefix_" + p["kind"],
                    prompt_len=len(prompt),
                    prefill_ms=(round(pf_ms, 3)
                                if p["kind"] in ("miss", "dup") else 0.0))
                if p["kind"] in ("miss", "dup"):
                    rows = uniq_rows[p["uniq"]]
                    logits = uniq_logits[p["uniq"]]
                    eid = uniq_eids[p["uniq"]]
                    L = len(prompt)
                elif p["kind"] == "full":
                    rows, logits, eid, L = (p["rows"], p["logits"],
                                            p["eid"], p["L"])
                else:
                    rows, logits, eid, L = p["rows"], None, p["eid"], \
                        p["L"]
                if p["kind"] != "miss":
                    seeds_rows.append((slot, rows, L))
                if p["kind"] == "partial":
                    lens[slot] = L  # the extension advances it
                    ext_jobs.append((i, slot, np.asarray(
                        prompt[L:], np.int64), eid))
                else:
                    first = self._first_token(logits, seed)
                    self._activate(slot, rid, prompt, max_new, first,
                                   lens, active, eid)
            # the hits' and dups' rows (the misses' are resident)
            if seeds_rows:
                self._write_rows(seeds_rows)
        except Exception as e:
            # admission failed before the extension: fail THIS batch,
            # free its slots, release any refs it took; active slots keep
            # serving (their rows were not written)
            for (rid, _p, _mn, _seed), slot in zip(batch,
                                                   free[:len(batch)]):
                st = active[slot]
                if st is not None and st["rid"] == rid:
                    self._prefix.release(st.get("prefix_entry"))
                    active[slot] = None
                self._fail(rid, e)
                lens[slot] = 0
            return
        if ext_jobs:
            try:
                self._extend_suffixes(ext_jobs, batch, lens, active)
            except Exception as e:
                # the verify step wrote every slot's window rows: the
                # step-failure contract. No ref release for the jobs: they
                # acquire only in _activate, after a successful extension
                for i, slot, _suf, _eid in ext_jobs:
                    self._fail(batch[i][0], e)
                    lens[slot] = 0
                self._fail_all_active(active, lens, e)

    def _write_rows(self, seeds_rows):
        """Host rows into their slots' slab rows, ``seeds_rows`` entries
        (slot, [k_0, v_0, ...], L), in ONE write per slab (rows shorter
        than the longest are zero-padded: past each slot's valid length,
        masked and later overwritten)."""
        device = self.predictor.device
        lmax = max(L for _s, _r, L in seeds_rows)
        slot_idx = torch.tensor([s for s, _r, _l in seeds_rows],
                                dtype=torch.int64, device=device)
        with torch.inference_mode():
            for j, cache in enumerate(self._slabs):
                stacked = np.zeros(
                    (len(seeds_rows), lmax) + tuple(cache.shape[2:]),
                    np.float32)
                for i, (_s, rows, L) in enumerate(seeds_rows):
                    stacked[i, :L] = rows[j]
                cache[:, :lmax].index_copy_(
                    0, slot_idx, torch.from_numpy(stacked).to(device))

    def _extend_suffixes(self, ext_jobs, batch, lens, active):
        """Drive partial-hit suffixes through the verify window step,
        chunk by chunk: multi-token cached prefill on the RESIDENT slabs.
        Slots not extending ride along untouched: their window rows land
        past their valid lengths (masked, then overwritten by their own
        later appends; rows past the slab's end are dropped)."""
        cfg = self.predictor.config
        T = self._win
        remaining = {slot: suf for _i, slot, suf, _e in ext_jobs}
        offset = {slot: 0 for _i, slot, _s, _e in ext_jobs}
        final_logits: Dict[int, torch.Tensor] = {}
        while remaining:
            tokens = np.zeros((self.slots, T), np.int64)
            positions = np.zeros((self.slots, T), np.int64)
            last_idx = np.zeros((self.slots,), np.int32)
            chunk_lens = {}
            for slot, suf in remaining.items():
                off = offset[slot]
                chunk = suf[off:off + T]
                cl = len(chunk)
                tokens[slot, :cl] = chunk
                positions[slot] = np.minimum(
                    lens[slot] + np.arange(T), cfg.max_len - 1)
                last_idx[slot] = cl - 1
                chunk_lens[slot] = cl
            feeds = {"tokens": tokens, "positions": positions,
                     "lengths": lens.copy(), "last_idx": last_idx}
            feeds.update(zip(self._cache_feed_names, self._slabs))
            t0 = time.perf_counter()
            last_logits = self._verify(
                feeds, read=lambda outs: outs[2].clone())
            obs.DECODE_STEP_MS.observe(
                (time.perf_counter() - t0) * 1e3, stage="extend")
            done = []
            for slot, cl in chunk_lens.items():
                lens[slot] += cl
                offset[slot] += cl
                obs.DECODE_TOKENS.inc(cl, kind="prefill")
                if offset[slot] >= len(remaining[slot]):
                    final_logits[slot] = last_logits[slot]
                    done.append(slot)
            for slot in done:
                del remaining[slot]
        for i, slot, _suf, eid in ext_jobs:
            rid, prompt, max_new, seed = batch[i]
            first = self._first_token(final_logits[slot], seed)
            self._activate(slot, rid, prompt, max_new, first, lens,
                           active, eid)

    def _fail_all_active(self, active, lens, exc):
        """Step-failure recovery: a decode, draft or verify step that dies
        must not kill the loop and strand every future. Fail the ACTIVE
        sequences (their slab rows are no longer trustworthy), release
        their prefix references, free their slots and zero the slabs in
        place (the captured graphs hold their addresses; with every
        length 0, zeros are correct)."""
        for i, st in enumerate(active):
            if st is not None:
                if self._prefix is not None:
                    self._prefix.release(st.get("prefix_entry"))
                self._fail(st["rid"], exc)
                obs.DECODE_REQUESTS.inc(kind="retired")
                active[i] = None
                lens[i] = 0
        with torch.inference_mode():
            for slab in self._slabs:
                slab.zero_()

    def _spec_round(self, lens, active, n_active):
        """One speculative round across every active slot: spec_k draft
        steps propose, ONE verify window step checks, each slot advances
        by its accept+1 tokens (capped by budget and slab room). The
        emitted tokens are the target's own argmaxes, token for token
        what the plain loop would emit."""
        k = self.spec_k
        cur = np.zeros((self.slots,), np.int64)
        for i, st in enumerate(active):
            if st is not None:
                cur[i] = st["cur"]
        try:
            t0 = time.perf_counter()
            window, positions = self.predictor.draft_window(
                self._draft, cur, lens, k)
            feeds = {"tokens": window, "positions": positions,
                     "lengths": lens.copy(),
                     "last_idx": np.zeros((self.slots,), np.int32)}
            feeds.update(zip(self._cache_feed_names, self._slabs))
            next_ids, accept = self._verify(feeds, read=lambda outs: (
                outs[0].cpu().numpy(), outs[1].cpu().numpy()))
            next_ids = next_ids.astype(np.int64)
            accept = accept.astype(np.int64)
        except Exception as e:
            self._fail_all_active(active, lens, e)
            return
        round_ms = (time.perf_counter() - t0) * 1e3
        obs.DECODE_STEP_MS.observe(round_ms, stage="verify")
        self.step_active_counts.append(n_active)
        self.step_ms.append(round_ms)
        obs.DECODE_SPEC_PROPOSED.inc(k * n_active)
        emitted = 0
        traced = _tracing.bound()
        for i, st in enumerate(active):
            if st is None:
                continue
            a = int(accept[i])
            obs.DECODE_SPEC_ACCEPTED.inc(a)
            if traced:
                _tracing.rid_span(st["rid"], "decode.spec_round",
                                  accepted=a, proposed=k)
            # cap by budget and slab room: window position j needs rows
            # lens..lens+j resident, so at most seq - lens tokens
            take = min(a + 1, st["max_new"] - st["count"],
                       self.seq - int(lens[i]))
            consumed = take
            stopped = False
            for j in range(take):
                tok = int(next_ids[i, j])
                st["generated"].append(tok)
                st["cur"] = tok
                st["count"] += 1
                emitted += 1
                if self.eos_id is not None and tok == self.eos_id:
                    stopped = True
                    consumed = j + 1
                    break
            lens[i] += consumed
            if stopped or st["count"] >= st["max_new"] \
                    or lens[i] + 1 >= self.seq:
                self._retire(st)
                active[i] = None
                lens[i] = 0
        obs.DECODE_TOKENS.inc(emitted, kind="decode")

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
            if self.speculative:
                self._spec_round(lens, active, n_active)
                self._set_slot_gauges(
                    sum(1 for a in active if a is not None))
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
