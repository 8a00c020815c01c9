"""KV-cache primitives for autoregressive decode serving, and kernel K3.

Counterpart of paddle_tpu/ops/kv_cache.py. K/V live in a preallocated
(B, S, H, Dh) slab (the BTHD layout the head-split projection produces);
each decode step appends one row per sequence at its current length and
attends the slab with a single query. Three ops:

- ``decode_attention``: Q (B, 1, H, Dh) x cache K/V (B, S, H, Dh) with
  Lengths (B,) -> (B, 1, H, Dh). On the card it runs K3, the hand-written
  CUDA kernel (csrc/decode_attn.cu) that replaces the Pallas TPU kernel
  ``_decode_attn_kernel``; ``decode_attention_plain`` is its plain PyTorch
  version (the CPU path, and the reference the kernel is held against).
  The wrapper ``decode_attention`` launches K3 for CUDA tensors or raises;
  its launch count is ``decode_attention.launches``.
- ``cache_append``: write one new K or V row per sequence at its current
  length. The JAX op is functional (XLA updates in place under donation);
  the port writes the row into the slab IN PLACE and returns the same
  tensor, so a decode step never copies a slab.
- ``cache_gather``: reorder slab rows along the slot axis.
"""
from __future__ import annotations

import contextvars
import ctypes
import math

import torch

from .registry import register_op

_NEG = -1e30
_HEAD_DIMS = (64, 128)
_FN = None
# K3's per-(b, h) counters, zeroed once per (device, stream, B*H) and left
# zeroed by every launch (see csrc/decode_attn.cu); calls on one stream
# never overlap, so they may share a buffer. Inside ``own_counters(store)``
# the buffers come from ``store`` instead, by (device, B*H)
_COUNTERS = {}
_OWNED = contextvars.ContextVar("decode_attention_counters", default=None)


class own_counters:
    """``with own_counters(store):`` K3 calls inside take their counters
    from ``store`` (a dict the caller keeps alive), not from their
    stream's. A CUDA graph whose warm-up and capture run inside keeps
    counters of its own: a replay runs on its caller's stream, so counters
    keyed by the capture stream could be shared with other graphs
    replayed on other streams at once."""

    def __init__(self, store):
        self.store = store
        self._token = None

    def __enter__(self):
        self._token = _OWNED.set(self.store)
        return self.store

    def __exit__(self, *exc):
        _OWNED.reset(self._token)
        return False


def _bind(lib):
    """K3's C entry points in a loaded ``decode_attn`` library: (launch,
    scratch floats, error string). ``_launch`` calls them."""
    fn = lib.decode_attn_f32
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.decode_attn_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.decode_attn_scratch_floats.restype = ctypes.c_longlong
    lib.decode_attn_error_string.restype = ctypes.c_char_p
    lib.decode_attn_error_string.argtypes = [ctypes.c_int]
    return fn, lib.decode_attn_scratch_floats, lib.decode_attn_error_string


def _kernel():
    """K3's C entry points, built and bound on first use."""
    global _FN
    if _FN is None:
        from ..kernels import load

        _FN = _bind(load("decode_attn"))
    return _FN


def _launch(fns, q, k_cache, v_cache, lengths, out, part, counters, scale):
    """One launch of K3 (the entry points ``fns`` of ``_bind``) on the
    current stream; the tensors already checked, ``part`` and ``counters``
    as the C interface asks."""
    fn, _scratch_floats, err_str = fns
    b, _one, h, d = q.shape
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
             counters.data_ptr(), b, h, k_cache.shape[1], d, float(scale),
             q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("decode attention kernel launch failed: %s"
                           % err_str(err).decode())


def decode_kernel_split():
    """Keys per block of K3 (the unit its grid splits the slab into)."""
    from ..kernels import load

    return int(load("decode_attn").decode_attn_split())


def _counters(device, n):
    store = _OWNED.get()
    if store is None:
        store = _COUNTERS
        key = (device.index, torch.cuda.current_stream(device).cuda_stream,
               n)
    else:
        key = (device.index, n)
    buf = store.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            # made here, the buffer would come from the graph's memory and
            # be zeroed only when the graph replays
            raise RuntimeError(
                "decode attention: call it once on this stream before "
                "capturing the stream into a CUDA graph")
        buf = store[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf


def decode_attention_plain(q, k_cache, v_cache, lengths, scale=None):
    """Plain PyTorch decode attention: q (B, 1, H, Dh), caches
    (B, S, H, Dh), lengths (B,) valid rows per slot -> (B, 1, H, Dh).
    The arithmetic of the JAX package's ``decode_attention_reference``;
    rows with length 0 give zeros."""
    b, _one, h, d = q.shape
    s = k_cache.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q[:, 0].float() * scale                                  # (B, H, D)
    scores = torch.einsum("bhd,bshd->bhs", qf, k_cache.float())   # (B, H, S)
    valid = (torch.arange(s, device=q.device)[None, None, :]
             < lengths.reshape(-1, 1, 1).to(q.device))
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhs,bshd->bhd", p / l.clamp_min(1e-30),
                       v_cache.float())
    return out[:, None].to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, scale=None):
    """Single-query attention against BTHD slabs; see
    decode_attention_plain for the contract. CPU tensors run the plain
    version. CUDA tensors launch K3 (fp32, Dh 64 or 128, contiguous
    tensors that start on 16-byte boundaries: its row loads are 16-byte
    copies) or raise. One launch, on the current stream; it allocates its
    output and one scratch buffer, and shares the per-(b, h) counters of
    its (device, stream, B*H) with the calls before it on that stream
    (inside ``own_counters``, of its (device, B*H) in that store). A
    stream is captured into a CUDA graph only after one call on it."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths, scale)
    b, one, h, d = q.shape
    s = k_cache.shape[1]
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != torch.float32:
            raise TypeError("decode attention kernel takes float32, got "
                            "%s %s" % (name, x.dtype))
        if not x.is_contiguous():
            raise ValueError("decode attention: %s must be contiguous" % name)
        if x.data_ptr() % 16:
            raise ValueError("decode attention: %s is not 16-byte aligned"
                             % name)
    if one != 1 or tuple(k_cache.shape) != (b, s, h, d) \
            or tuple(v_cache.shape) != (b, s, h, d):
        raise ValueError("decode attention: q %s and slabs %s, %s do not "
                         "agree" % (tuple(q.shape), tuple(k_cache.shape),
                                    tuple(v_cache.shape)))
    if d not in _HEAD_DIMS:
        raise ValueError("decode attention kernel takes head dim %s, got %d"
                         % (_HEAD_DIMS, d))
    if lengths.numel() != b:
        raise ValueError("decode attention: lengths has %d entries for "
                         "batch %d" % (lengths.numel(), b))
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("q", q)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError("decode attention: %s is on %s, q on %s"
                             % (name, x.device, q.device))
    # no copy and no kernel when lengths is int32 on q's device already
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    fns = _kernel()
    counters = _counters(q.device, b * h)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    part = torch.empty((fns[1](b, h, s, d),), dtype=torch.float32,
                       device=q.device)
    _launch(fns, q, k_cache, v_cache, lengths, out, part, counters, scale)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


@register_op("decode_attention")
def _decode_attention_op(ctx):
    """Single-query attention against a KV slab. Inputs Q (B, 1, H, Dh),
    KCache/VCache (B, S, H, Dh), Lengths (B,) valid rows per slot
    (INCLUDING the current token's freshly appended row); attr scale
    (block_s rides the desc; the kernel picks its own split)."""
    return {"Out": decode_attention(
        ctx.input("Q"), ctx.input("KCache"), ctx.input("VCache"),
        ctx.input("Lengths"), scale=ctx.attr("scale", None))}


# ---------------------------------------------------------------------------
# cache slab updates
# ---------------------------------------------------------------------------


def cache_append(cache, new, pos):
    """Write ``new`` (B, 1, ...) or (B, ...) into ``cache`` (B, S, ...) at
    row pos[b] per sequence, IN PLACE; returns ``cache`` itself."""
    b, s = cache.shape[0], cache.shape[1]
    if new.ndim == cache.ndim:
        if new.shape[1] != 1:
            raise ValueError(
                "cache_append appends ONE row per sequence; New has "
                "time dim %d (append rows one step at a time)"
                % new.shape[1])
        new = new[:, 0]
    pos = pos.reshape(-1).to(device=cache.device, dtype=torch.int64)
    pos = pos.clamp(0, s - 1)
    cache[torch.arange(b, device=cache.device), pos] = new.to(cache.dtype)
    return cache


def cache_gather(cache, index):
    """Reorder slab rows along axis 0: out[i] = cache[index[i]]."""
    return cache.index_select(0, index.reshape(-1).to(cache.device).long())


@register_op("cache_append")
def _cache_append_op(ctx):
    """Inputs Cache (B, S, ...), New (B, 1, ...) or (B, ...), Pos (B,)
    int32 write positions (the slot's CURRENT length) -> Out: the slab,
    updated in place."""
    return {"Out": cache_append(ctx.input("Cache"), ctx.input("New"),
                                ctx.input("Pos"))}


@register_op("cache_gather")
def _cache_gather_op(ctx):
    """Inputs Cache (B, S, ...), Index (N,) int32 slot indices -> Out
    (N, S, ...): slab rows reordered/duplicated by slot."""
    return {"Out": cache_gather(ctx.input("Cache"), ctx.input("Index"))}
