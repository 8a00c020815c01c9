"""Beam search (counterpart of the beam-search part of
paddle_tpu/ops/decode.py, :491-600; its CRF, CTC and NCE ops are a later
slice of the port).

Dense beams: (B, K) live beams, (B, K, V) accumulated scores. A step
keeps the top K of the K * V continuations; finished beams (last id ==
end_id) propose only end_id, keeping their score (the reference's
beam_search_op.cc). ``beam_search_step`` and ``beam_search_backtrack``
are the ops' math, which ``DecodePredictor.generate_beam`` calls on the
device between decode steps.

Ties: ``lax.top_k`` keeps the lower index on a tie; ``torch.topk``
promises no order among equal values on the card. Beams are compared
with the JAX package's on inputs without exact ties.
"""
from __future__ import annotations

import torch

from .registry import register_op

_NEG = -1e30


def beam_search_step(pre_ids, pre_scores, scores, ids, beam_size, end_id):
    """One beam-search step: (B, K) beams (``pre_ids``, ``pre_scores``)
    x (B, K, V) ACCUMULATED ``scores`` -> (sel_ids int32, sel_scores,
    parents int32), each (B, beam_size), best first. ``ids`` (B, K, V),
    when given, maps each continuation to its token id."""
    if pre_ids.ndim == 3:
        pre_ids = pre_ids[..., 0]
    if pre_scores.ndim == 3:
        pre_scores = pre_scores[..., 0]
    b, k, v = scores.shape
    finished = pre_ids.to(torch.int32) == end_id                 # (B, K)
    end_col = (torch.arange(v, device=scores.device) == end_id)[None, None]
    neg = torch.full_like(scores, _NEG)
    cand = torch.where(finished[:, :, None],
                       torch.where(end_col, pre_scores[:, :, None], neg),
                       scores)
    top_scores, top_idx = torch.topk(cand.reshape(b, k * v), beam_size,
                                     dim=1)
    parent = torch.div(top_idx, v, rounding_mode="floor").to(torch.int32)
    if ids is None:
        sel_ids = (top_idx % v).to(torch.int32)
    else:
        sel_ids = torch.gather(ids.reshape(b, k * v).to(torch.int32), 1,
                               top_idx)
    return sel_ids, top_scores, parent


def beam_search_backtrack(ids, parents, end_id):
    """Stacked per-step selections (S, B, K) and their parent pointers ->
    (sentences (B, K, S) int32, lengths (B, K) int32: up to the first
    end_id, inclusive; S when there is none)."""
    ids = ids.to(torch.int64)
    parents = parents.to(torch.int64)
    s, b, k = ids.shape
    beam = torch.arange(k, device=ids.device)[None, :].expand(b, k)
    toks = []
    for t in range(s - 1, -1, -1):
        toks.append(torch.gather(ids[t], 1, beam))
        beam = torch.gather(parents[t], 1, beam)
    sent = torch.stack(toks[::-1], dim=2).to(torch.int32)          # (B, K, S)
    ended = sent == end_id
    first_end = torch.argmax(ended.to(torch.int32), dim=2)
    lengths = torch.where(ended.any(dim=2), first_end + 1,
                          torch.full_like(first_end, s)).to(torch.int32)
    return sent, lengths


@register_op("beam_search")
def _beam_search(ctx):
    """One decode step: (B, K) beams x (B, K, V) accumulated scores ->
    top-K continuations (math: beam_search_step)."""
    sel_ids, top_scores, parent = beam_search_step(
        ctx.input("pre_ids"), ctx.input("pre_scores"), ctx.input("scores"),
        ctx.input("ids"), int(ctx.attr("beam_size")),
        int(ctx.attr("end_id")))
    return {"selected_ids": sel_ids, "selected_scores": top_scores,
            "parent_idx": parent}


@register_op("beam_search_decode")
def _beam_search_decode(ctx):
    """Backtrack stacked (S, B, K) selections through their parent
    pointers to sentences (B, K, S) and lengths (math:
    beam_search_backtrack); with Scores (S, B, K), the last step's as
    SentenceScores."""
    scores = ctx.input("Scores")
    sent, lengths = beam_search_backtrack(
        ctx.input("Ids"), ctx.input("ParentIdx"), int(ctx.attr("end_id")))
    out = {"SentenceIds": sent, "SentenceLengths": lengths}
    if scores is not None:
        out["SentenceScores"] = scores[-1]
    return out


@register_op("beam_gather")
def _beam_gather(ctx):
    """Reorder per-beam rows by one step's parent pointers: X (B*K, ...)
    or (B, K, ...), Parent (B, K) -> X's shape, row (b, k) =
    X[b, Parent[b, k]]."""
    x = ctx.input("X")
    parent = ctx.input("Parent").to(device=x.device, dtype=torch.int64)
    b, k = parent.shape
    if x.shape[0] == b * k:
        xs = x.reshape((b, k) + tuple(x.shape[1:]))
    elif tuple(x.shape[:2]) == (b, k):
        xs = x
    else:
        raise ValueError(
            "beam_gather: X shape %s matches neither (B*K, ...) nor "
            "(B, K, ...) for Parent %s" % (tuple(x.shape),
                                           tuple(parent.shape)))
    idx = parent.reshape((b, k) + (1,) * (xs.ndim - 2)).expand(
        (b, k) + tuple(xs.shape[2:]))
    return {"Out": torch.gather(xs, 1, idx).reshape(x.shape)}
