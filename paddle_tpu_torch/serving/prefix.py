"""Refcounted shared-prefix KV store for decode serving (a copy of
paddle_tpu/serving/prefix.py; numpy only, so the port keeps its own copy
and imports nothing of the JAX package).

Serving traffic is dominated by SHARED prompt prefixes: one system
prompt or few-shot header fanned out to many users. Without sharing,
every admission pays a full private prefill over tokens already
prefilled many times. This is the admission-side cache that removes
that cost:

- Entries hold the prefilled per-layer K/V rows of one prompt (host
  arrays in the (P, H, Dh) slab row layout, what ``DecodeServer``
  writes into a slot's slab rows) plus the last-position logits (so a
  full-prompt hit samples its first token without a model call).

- The index is BLOCK-ALIGNED: inserting a prompt of length P indexes the
  hash of every ``block``-aligned prefix AND the full length, all
  pointing into the same entry (causal attention: the K/V rows of a
  prefix are the first L rows of the longer prefill). ``lookup`` returns
  the LONGEST indexed prefix; a partial hit (L < P) seeds the slot with
  the cached rows and the server extends the rest through the verify
  window step instead of a full private prefill.

- Entries are REFCOUNTED: each live sequence admitted from an entry
  holds a reference until it retires (or fails); eviction (LRU, bounded
  by ``max_bytes``) skips entries with live references.

The store is an ADMISSION cache, not a source of truth: rows are COPIED
into the slabs at admission, so eviction never invalidates a running
sequence.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import observability as obs

__all__ = ["PrefixStore", "prefix_hash"]

_DEFAULT_MAX_BYTES = 256 * 1024 * 1024


def prefix_hash(tokens: np.ndarray) -> str:
    """Stable content hash of a token sequence (int64 canonical form)."""
    arr = np.ascontiguousarray(np.asarray(tokens, np.int64).reshape(-1))
    return hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest()


def aligned_prefix_hashes(tokens: np.ndarray, lengths) -> List[str]:
    """``prefix_hash(tokens[:L])`` for each L in ASCENDING ``lengths``,
    in ONE streaming pass: blake2b ingests each inter-boundary span
    once and a digest snapshot (`copy()`) marks every boundary —
    O(p) bytes hashed total, vs O(p^2/block) for per-prefix rehashing
    (at the 8k-32k shared prompts the long-context path targets, the
    quadratic form hashes hundreds of MB per admission, inside the
    store lock)."""
    arr = np.ascontiguousarray(np.asarray(tokens, np.int64).reshape(-1))
    h = hashlib.blake2b(digest_size=16)
    out, prev = [], 0
    for L in lengths:
        h.update(arr[prev:L].tobytes())
        prev = L
        out.append(h.copy().hexdigest())
    return out


class _Entry:
    __slots__ = ("rows", "length", "logits", "nbytes", "refs", "tick",
                 "keys")

    def __init__(self, rows, length, logits, nbytes, tick, keys):
        self.rows = rows          # [2 * n_layer] arrays, (P, H, Dh)
        self.length = length
        self.logits = logits      # (V,) last-position logits
        self.nbytes = nbytes
        self.refs = 0
        self.tick = tick
        self.keys = keys          # the aligned index keys this entry owns


class PrefixStore:
    """Byte-bounded, refcounted, block-aligned prefix cache."""

    def __init__(self, max_bytes: Optional[int] = None, block: int = 16):
        self.max_bytes = int(_DEFAULT_MAX_BYTES if max_bytes is None
                             else max_bytes)
        self.block = max(int(block), 1)
        self._entries: Dict[int, _Entry] = {}
        # hash -> (L, {entry ids whose rows serve this prefix}): the
        # MULTI-owner set keeps a shared header reachable after any one
        # owner's eviction — the surviving entries' rows still serve it
        self._index: Dict[str, Tuple[int, set]] = {}
        self._next_id = 0
        self._tick = 0
        self._bytes = 0
        self._lock = threading.Lock()

    # -- introspection -----------------------------------------------------
    @property
    def bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def refs(self, entry_id: int) -> int:
        with self._lock:
            e = self._entries.get(entry_id)
            return e.refs if e is not None else 0

    # -- lookup / insert ---------------------------------------------------
    def _aligned_lengths(self, p: int) -> List[int]:
        lens = list(range(self.block, p + 1, self.block))
        if not lens or lens[-1] != p:
            lens.append(p)
        return lens

    def lookup(self, prompt: np.ndarray):
        """Longest indexed prefix of ``prompt``. Returns (entry_id, L,
        rows, logits) — ``logits`` only on a FULL hit (the entry IS
        this exact prompt, so its stored last-position logits sample
        the first token store-side); partial hits return the first L
        rows and None logits (the caller extends the suffix). Misses
        return (None, 0, None, None). Every call counts one query; hits
        count by kind=full|partial.

        A prompt that equals a block-aligned PREFIX of a longer entry
        is NOT a full hit: the entry's logits belong to the longer
        prompt's last position, not this one's — the hit demotes to a
        partial at the previous aligned boundary (suffix >= 1 token),
        so the first token comes from a genuine forward over this
        prompt's own final position."""
        obs.DECODE_PREFIX_QUERIES.inc()
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        p = len(prompt)
        lengths = self._aligned_lengths(p)
        keys = aligned_prefix_hashes(prompt, lengths)
        with self._lock:
            for L, key in zip(reversed(lengths), reversed(keys)):
                hit = self._index.get(key)
                if hit is None:
                    continue
                stored_l, eids = hit
                if stored_l != L:
                    continue
                owners = [(i, self._entries[i]) for i in eids
                          if i in self._entries]
                if not owners:
                    continue
                # prefer the exact-length owner: only ITS logits are
                # this prompt's last-position logits
                exact = [(i, o) for i, o in owners if o.length == p]
                if exact:
                    eid, e = exact[0]
                else:
                    eid, e = owners[0]
                    if L == p:
                        # exact length match against LONGER entries
                        # only: their logits are not ours — demote to
                        # the previous aligned boundary (none -> keep
                        # searching / miss)
                        L -= self.block if L % self.block == 0 \
                            else L % self.block
                        if L <= 0:
                            continue
                self._tick += 1
                e.tick = self._tick
                if L == p and e.length == p:
                    obs.DECODE_PREFIX_HITS.inc(kind="full")
                    return eid, L, [r[:L] for r in e.rows], e.logits
                obs.DECODE_PREFIX_HITS.inc(kind="partial")
                return eid, L, [r[:L] for r in e.rows], None
        return None, 0, None, None

    def insert(self, prompt: np.ndarray, rows, logits) -> Optional[int]:
        """Insert one prefilled prompt: ``rows`` are the per-layer K/V
        row arrays (P, H, Dh) in the flat [k0, v0, k1, v1, ...] order,
        ``logits`` the last-position logits row. Indexes every aligned
        prefix; returns the entry id (None when the entry alone exceeds
        the byte bound). Every aligned key records this entry as an
        ADDITIONAL owner (rows are identical across owners by the
        causal-prefix property) — a shared header stays serveable
        after any one owner's eviction."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        p = len(prompt)
        # COPY the rows (np.array, not ascontiguousarray — the latter
        # returns a contiguous VIEW uncopied): callers pass views
        # sliced out of the batched prefill outputs, and storing the
        # view would pin the whole (bb, sp, H, Dh) parent array while
        # nbytes accounts only the P sliced rows, silently blowing the
        # byte bound
        rows = [np.array(r) for r in rows]
        logits = np.array(logits)
        nbytes = sum(r.nbytes for r in rows) + logits.nbytes
        if nbytes > self.max_bytes:
            return None
        lengths = self._aligned_lengths(p)
        keys = aligned_prefix_hashes(prompt, lengths)
        with self._lock:
            hit = self._index.get(keys[-1])
            if hit is not None and hit[0] == p:
                for i in hit[1]:
                    e = self._entries.get(i)
                    if e is not None and e.length == p:
                        return i  # this EXACT prompt already resident
                        # (a longer entry sharing the aligned key must
                        # not block its own logits-bearing entry)
            self._tick += 1
            eid = self._next_id
            self._next_id += 1
            self._entries[eid] = _Entry(rows, p, logits, nbytes,
                                        self._tick, list(keys))
            self._bytes += nbytes
            for L, key in zip(lengths, keys):
                ent = self._index.get(key)
                if ent is None:
                    self._index[key] = (L, {eid})
                else:
                    ent[1].add(eid)
            self._evict_locked()
            obs.DECODE_PREFIX_BYTES.set(self._bytes)
        return eid

    # -- refcounting -------------------------------------------------------
    def acquire(self, entry_id: Optional[int]):
        if entry_id is None:
            return
        with self._lock:
            e = self._entries.get(entry_id)
            if e is not None:
                e.refs += 1

    def release(self, entry_id: Optional[int]):
        if entry_id is None:
            return
        with self._lock:
            e = self._entries.get(entry_id)
            if e is not None and e.refs > 0:
                e.refs -= 1
            self._evict_locked()
            obs.DECODE_PREFIX_BYTES.set(self._bytes)

    # -- eviction ----------------------------------------------------------
    def _evict_locked(self):
        if self._bytes <= self.max_bytes:
            return
        victims = sorted(
            (e.tick, eid) for eid, e in self._entries.items()
            if e.refs == 0)
        for _tick, eid in victims:
            if self._bytes <= self.max_bytes:
                break
            e = self._entries.pop(eid)
            self._bytes -= e.nbytes
            # surgical index update: drop THIS entry from each of its
            # keys; a key another entry also owns stays serveable (a
            # shared header must survive one owner's eviction)
            for key in e.keys:
                ent = self._index.get(key)
                if ent is None:
                    continue
                ent[1].discard(eid)
                if not ent[1]:
                    del self._index[key]
