"""Speculative-decoding window ops (counterpart of
paddle_tpu/ops/speculative.py): the draft-verify serving path.

A plain decode step advances one token per call of the target model. In
speculative decoding a cheap draft proposes k tokens and the target
checks all of them in ONE window step. These are that step's
window-shaped ops:

- ``cache_append_window``: T fresh K/V rows per sequence land at rows
  pos[b]..pos[b]+T-1 (``cache_append`` widened along the time axis),
  written into the slab IN PLACE, as the port's ``cache_append`` is.
  Rows whose index passes S-1 are DROPPED, as the JAX package's
  ``mode="drop"`` scatter drops them: neither clipped (that would
  overwrite a valid row at S-1) nor indexed out of range (on the card an
  out-of-range index is a device-side assert).
- ``decode_attention_window``: T queries per sequence attend the slab
  with a STAIRCASE mask: query i sees ``lengths[b] + i + 1`` rows.
  With T == 1 this is ``decode_attention``. Plain PyTorch, as the JAX
  package's is plain lax (no Pallas kernel): the (B, H, T, S) scores
  are small at a verify window's T.
- ``spec_accept``: the in-graph accept/reject. The target's argmax after
  each window position, and per slot the count of proposals that match
  it (the longest matching prefix).

Rollback: the verify step appends all T window rows, then the caller
advances each slot's length by ``accept + 1``; rejected rows stay as
garbage past the valid length, masked by every later read and
overwritten by later appends. Everything here runs on the device with
no read to the host, so a verify step is one CUDA graph replay.
"""
from __future__ import annotations

import math

import torch

from .registry import register_op

_NEG = -1e30


def cache_append_window(cache, new, pos):
    """Write ``new`` (B, T, ...) into ``cache`` (B, S, ...) at rows
    pos[b]..pos[b]+T-1, IN PLACE; rows past S-1 are dropped. Returns
    ``cache`` itself.

    Without a read to the host: every window row is written, the rows
    past the slab's end onto row S-1 carrying the value row S-1 gets
    anyway (the slot's last in-range window row, or, when the whole
    window is past the end, the slab's own row S-1), so the duplicate
    writes all carry the same value and their order does not matter."""
    b, s = cache.shape[0], cache.shape[1]
    t = new.shape[1]
    dev = cache.device
    pos = pos.reshape(-1).to(device=dev, dtype=torch.int64)
    idx = pos[:, None] + torch.arange(t, device=dev)[None, :]     # (B, T)
    row = idx.clamp(max=s - 1)
    slots = torch.arange(b, device=dev)[:, None].expand(b, t)
    # the window row whose value lands on ``row``
    src = (row - pos[:, None]).clamp(min=0)
    vals = new.to(cache.dtype)[slots, src]                       # (B, T, ...)
    inside = (pos <= s - 1).reshape((b, 1) + (1,) * (vals.ndim - 2))
    vals = torch.where(inside, vals, cache[:, s - 1:s])
    cache[slots, row] = vals
    return cache


def decode_attention_window(q, k_cache, v_cache, lengths, scale=None):
    """Window decode attention: q (B, T, H, Dh) x caches (B, S, H, Dh),
    lengths (B,) valid rows BEFORE the window -> (B, T, H, Dh). Query i
    keeps rows < lengths[b] + i + 1. The arithmetic of the JAX package's
    ``decode_attention_window``."""
    b, t, h, d = q.shape
    s = k_cache.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.float() * scale
    scores = torch.einsum("bthd,bshd->bhts", qf, k_cache.float())
    limit = (lengths.reshape(-1).to(device=dev, dtype=torch.int64)[:, None]
             + torch.arange(1, t + 1, device=dev)[None, :])       # (B, T)
    valid = (torch.arange(s, device=dev)[None, None, :]
             < limit[:, :, None])[:, None]                        # (B,1,T,S)
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhts,bshd->bthd", p / l.clamp_min(1e-30),
                       v_cache.float())
    return out.to(q.dtype)


def spec_accept(proposed, logits):
    """proposed (B, T) window tokens (slot 0 the committed token, 1..T-1
    the draft's proposals), logits (B, T, V) the target's at each window
    position -> (next_ids (B, T) int64: the target's argmax after each
    position, the first maximum on a tie; accept (B,) int32: proposals
    accepted while proposed[b, i+1] == next_ids[b, i])."""
    next_ids = torch.argmax(logits, dim=-1).to(torch.int64)
    t = proposed.shape[1]
    if t <= 1:
        return next_ids, torch.zeros((proposed.shape[0],), dtype=torch.int32,
                                     device=logits.device)
    matches = (proposed[:, 1:].to(device=logits.device, dtype=torch.int64)
               == next_ids[:, :-1]).to(torch.int32)
    accept = torch.cumprod(matches, dim=1).sum(dim=1).to(torch.int32)
    return next_ids, accept


@register_op("cache_append_window")
def _cache_append_window_op(ctx):
    """Inputs Cache (B, S, ...), New (B, T, ...), Pos (B,) write bases
    (each slot's CURRENT length) -> Out: the slab, T rows appended per
    slot in place."""
    return {"Out": cache_append_window(ctx.input("Cache"), ctx.input("New"),
                                       ctx.input("Pos"))}


@register_op("decode_attention_window")
def _decode_attention_window_op(ctx):
    """T-query decode attention with the staircase window mask. Inputs
    Q (B, T, H, Dh), KCache/VCache (B, S, H, Dh), Lengths (B,) valid
    rows BEFORE the window; attr scale."""
    return {"Out": decode_attention_window(
        ctx.input("Q"), ctx.input("KCache"), ctx.input("VCache"),
        ctx.input("Lengths"), scale=ctx.attr("scale", None))}


@register_op("spec_accept")
def _spec_accept_op(ctx):
    """Inputs Proposed (B, T) window tokens, Logits (B, T, V) -> NextIds
    (B, T) int64, Accept (B,) int32."""
    next_ids, accept = spec_accept(ctx.input("Proposed"),
                                   ctx.input("Logits"))
    return {"NextIds": next_ids, "Accept": accept}
