"""KV-cache autoregressive decode serving: DecodePredictor (counterpart of
paddle_tpu/serving/decode.py).

- ``save_decode_model`` exports a transformer_lm parameter set as a
  decode-servable directory: the canonical prefill graph through
  ``save_inference_model``, plus a ``__decode__.json`` manifest with the
  architecture config the decode-side builders need. The layout is the
  JAX package's, so an export from either package serves in either.

- ``DecodePredictor`` loads that directory and builds TWO kinds of
  programs: a PREFILL step (the flash-attention forward over the padded
  prompt, emitting last-position logits plus per-layer K/V slabs) and a
  per-token DECODE step (``cache_append`` of the fresh K/V row into the
  slabs, in place; single-query ``decode_attention``; in-graph greedy
  sampling, so only token ids cross to the host). Batch and slab length
  bucket to powers of two exactly as in the JAX package, so the two
  packages run the same programs on the same padded inputs. PyTorch runs
  eagerly: a built program is cached per (kind, batch, seq) signature and
  run op by op by the interpreter; there is no compiled-executable cache.

On the card the prefill's attention is kernel K1 and each decode step's
is kernel K3 (ops/attention.py, ops/kv_cache.py).

Not ported yet: the continuous-batching DecodeServer, top-k / top-p
sampling, beam search, speculative decoding, prefix sharing, int8 slabs,
ring prefill and the observability counters.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..executor import analyze_state

__all__ = ["DecodeConfig", "save_decode_model", "DecodePredictor",
           "analyze_state"]

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
    completion). After a call, ``timings`` holds its prefill and
    per-step host times in ms (each ends in a device-to-host read of the
    sampled ids, so it covers the device work).
    """

    def __init__(self, model_dir: str, place=None, strategy: str = "greedy",
                 eos_id: Optional[int] = None):
        from .. import io as fluid_io
        from ..framework.scope import CUDAPlace, Scope

        self.place = CUDAPlace(0) if place is None else place
        self.device = self.place.torch_device()
        # the JAX reference is fp32: TF32 products would make parity an
        # accident of rounding
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with open(os.path.join(model_dir, _DECODE_MANIFEST)) as f:
            self.config = DecodeConfig.from_dict(json.load(f))
        self.model_dir = model_dir
        self.strategy = strategy
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
        self._built: Dict = {}
        self._lock = threading.Lock()
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
                        prefix=cfg.prefix, strategy=strategy, seed=seed)
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
                strategy: Optional[str] = None):
        """The step function for one (kind, batch, seq, strategy)
        signature, built once and cached. Returns (step, fetch_names);
        ``step(feeds, state)`` runs the program on the predictor's device
        and returns the fetched tensors in order."""
        from ..framework.interpreter import run_block

        strategy = strategy or self.strategy
        ck = (kind, batch, seq, strategy if kind == "decode" else "")
        with self._lock:
            hit = self._built.get(ck)
        if hit is not None:
            return hit
        program, feed_names, fetch_names = self._build(kind, batch, seq,
                                                       strategy)
        block = program.global_block()
        device = self.device

        def step(feeds, state):
            env = dict(state)
            for name in feed_names:
                val = feeds[name]
                env[name] = (val.to(device) if isinstance(val, torch.Tensor)
                             else torch.from_numpy(np.asarray(val)).to(device))
            with torch.inference_mode():
                run_block(block, env, device)
            return tuple(env[n] for n in fetch_names)

        with self._lock:
            self._built[ck] = (step, fetch_names)
        return step, fetch_names

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

    def _prefill(self, tokens, lens, slab_seq):
        """Run prefill at the PROMPTS' own pow2 sequence bucket, then
        zero-pad the returned K/V rows out to the slab length — prompt
        cost scales with the prompt, not with the decode budget. Returns
        (fetches, caches)."""
        bb = tokens.shape[0]
        sp = min(_pow2_bucket(int(lens.max()), floor=16), slab_seq)
        pexe, _ = self.acquire("prefill", bb, sp)
        outs = pexe({"tokens": tokens[:, :sp], "lengths": lens},
                    self._state)
        caches = list(outs[1:])
        if sp < slab_seq:
            caches = [torch.nn.functional.pad(c, (0, 0, 0, 0, 0, slab_seq - sp))
                      for c in caches]
        return outs, caches

    # -- generation (static batch, run to completion) ----------------------
    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens: int = 32, strategy: Optional[str] = None,
                 seed: int = 0, eos_id: Optional[int] = None
                 ) -> List[np.ndarray]:
        """Generate up to ``max_new_tokens`` per prompt (stopping a row
        early at ``eos_id``). Returns one int64 array of generated ids
        per prompt. Only ``strategy="greedy"`` is ported."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1, got %d"
                             % max_new_tokens)
        strategy = strategy or self.strategy
        if strategy != "greedy":
            raise NotImplementedError(
                "decode strategy %r is a later slice of the port (greedy)"
                % (strategy,))
        eos = eos_id if eos_id is not None else self.eos_id
        self.timings = {"prefill": [], "step": []}
        tokens, lens, b, s = self._bucketed(prompts, max_new_tokens)
        bb = tokens.shape[0]
        t0 = time.perf_counter()
        outs, caches = self._prefill(tokens, lens, s)
        from ..ops.sampling import greedy_sample

        cur = greedy_sample(outs[0]).cpu().numpy()
        self.timings["prefill"].append((time.perf_counter() - t0) * 1e3)
        generated = [[int(cur[i])] for i in range(b)]
        finished = np.array([eos is not None and int(cur[i]) == eos
                             for i in range(b)])
        if max_new_tokens > 1 and not finished.all():
            dexe, _fetch_names = self.acquire("decode", bb, s, strategy)
            self._plain_decode_steps(dexe, caches, cur, lens.copy(),
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
            outs = dexe(feeds, self._state)
            nxt = outs[0].cpu().numpy().astype(np.int64)
            self.timings["step"].append((time.perf_counter() - t0) * 1e3)
            caches = list(outs[2:])
            for i in range(b):
                if finished[i]:
                    continue
                tok = int(nxt[i])
                generated[i].append(tok)
                cur[i] = tok
                lens[i] += 1
                if (eos is not None and tok == eos) \
                        or len(generated[i]) >= max_new_tokens \
                        or lens[i] + 1 >= s:
                    finished[i] = True
        return caches
