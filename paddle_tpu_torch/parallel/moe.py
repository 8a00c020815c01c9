"""Mixture-of-experts FFN (counterpart of paddle_tpu/parallel/moe.py): top-k
routing with a per-expert capacity, GShard/Switch style, on one device.

The routing is the JAX package's ``_dispatch_tensors`` step for step: the
router in fp32 (``x.float() @ gate_w``, softmax), k rounds of first-index
argmax over the probabilities left (``torch.argmax`` returns the first
maximum, as ``jnp.argmax`` does), each token's position in its expert's
buffer by a cumulative sum in token order that continues after the slots
the earlier rounds filled, capacity ``ceil(N / E * cf)``, tokens past it
dropped with combine weight 0, and the next round over ``probs * (1 -
onehot)``, so the gradient reaches the router through the gate
probabilities only.

What differs is how the tokens move. The JAX package builds (N, E, C)
one-hot dispatch and combine tensors and moves tokens by einsum, which at
16,384 tokens, 8 experts and capacity 4,096 is 537M elements and ~1.1
PFLOP per layer's forward. Here the same function is computed by index:
each kept (token, choice) is written into row (e, pos) of an (E, C + 1, D)
buffer whose last row per expert takes the dropped tokens and is sliced
off (the reference's ``one_hot(capacity + 1)[:, :C]``), two batched expert
products run on the (E, C, D) view, and each token gathers its k rows
from the outputs (padded with a zero row per expert, which the dropped
tokens read) and sums them weighted by gate, in fp32. Every shape is
static and nothing is read by the host, so a step holding it is one CUDA
graph. In the backward a token's gradient gathers its k rows (k terms,
exact in either order) and an expert row's gradient is one token's.

Under bf16 the expert products take bf16 operands, sum in fp32 and round
to bf16 (``ops.math.matmul_f32acc``); the biases are added in fp32 after
that rounding (the reference adds them to the fp32 sums), then ReLU in
fp32, and the expert outputs are rounded to bf16 before the fp32 combine,
as in the reference. ``expert_parallel_ffn`` waits for the port's
multi-device slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.math import matmul_f32acc

__all__ = ["MoEParams", "moe_capacity", "route_choices", "dispatch_slots",
           "moe_ffn_local"]


class MoEParams(NamedTuple):
    gate_w: torch.Tensor   # (D, E)
    w1: torch.Tensor       # (E, D, F)
    b1: torch.Tensor       # (E, F)
    w2: torch.Tensor       # (E, F, D)
    b2: torch.Tensor       # (E, D)


def moe_capacity(n_tokens: int, num_experts: int,
                 capacity_factor: float) -> int:
    return max(int(math.ceil(n_tokens / num_experts * capacity_factor)), 1)


def first_max(remaining):
    """The expert each token picks this round: the first index of its
    largest remaining probability."""
    return torch.argmax(remaining, dim=-1)


def route_choices(probs, k: int):
    """k rounds of top-1 over the probabilities not yet taken: a list of
    (expert index (N,), gate probability (N,)), one per round."""
    experts = torch.arange(probs.shape[-1], device=probs.device)
    remaining, out = probs, []
    for _ in range(k):
        e_idx = first_max(remaining)
        gate = remaining.gather(1, e_idx[:, None])[:, 0]
        out.append((e_idx, gate))
        remaining = remaining * (e_idx[:, None] != experts).to(
            remaining.dtype)
    return out


def dispatch_slots(choices, num_experts: int, capacity: int):
    """Each (round, token)'s row in the flat (E * (C + 1)) expert buffer and
    whether it was kept: ((k, N) int64 rows, (k, N) bool). A token's
    position is its rank among the tokens that picked the same expert in
    this round, after the slots the earlier rounds filled; a position past
    the capacity goes to its expert's last row (dropped)."""
    e_idx0 = choices[0][0]
    experts = torch.arange(num_experts, device=e_idx0.device)
    filled = torch.zeros(num_experts, dtype=torch.int64,
                         device=e_idx0.device)
    rows, keeps = [], []
    for e_idx, _ in choices:
        # (E, N): the scan runs along the contiguous token axis (the
        # card's scan along the outer axis of an (N, E) tensor walks each
        # of the E columns serially)
        onehot = e_idx[None, :] == experts[:, None]
        pos = (torch.cumsum(onehot, dim=1) - 1 + filled[:, None]).gather(
            0, e_idx[None, :])[0]
        keep = pos < capacity
        rows.append(e_idx * (capacity + 1)
                    + torch.where(keep, pos, torch.full_like(pos, capacity)))
        keeps.append(keep)
        filled = filled + (onehot & keep[None, :]).sum(1)
    return torch.stack(rows), torch.stack(keeps)


def moe_ffn_local(x, params: MoEParams, capacity_factor: float = 1.25,
                  k: int = 2, activation=torch.relu):
    """Single-device MoE FFN: x (..., D) -> (..., D), in x's dtype."""
    lead, d = tuple(x.shape[:-1]), x.shape[-1]
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]
    e = params.gate_w.shape[-1]
    cap = moe_capacity(n, e, capacity_factor)
    # the router runs in fp32: a bf16 logit could flip a choice near a tie
    probs = torch.softmax(tokens.float() @ params.gate_w.float(), dim=-1)
    choices = route_choices(probs, k)
    rows, keep = dispatch_slots(choices, e, cap)
    xdt = tokens.dtype
    buf = tokens.new_zeros(e * (cap + 1), d).index_put(
        (rows.reshape(-1),), tokens.repeat(k, 1))
    expert_in = buf.view(e, cap + 1, d)[:, :cap]
    h = activation(matmul_f32acc(expert_in, params.w1.to(xdt)).float()
                   + params.b1[:, None, :])
    expert_out = (matmul_f32acc(h.to(xdt), params.w2.to(xdt)).float()
                  + params.b2[:, None, :]).to(xdt)
    # one zero row per expert, read by the dropped tokens
    padded = torch.cat([expert_out, expert_out.new_zeros(e, 1, d)], dim=1)
    picked = padded.reshape(e * (cap + 1), d).index_select(
        0, rows.reshape(-1)).view(k, n, d)
    gates = torch.stack([g for _, g in choices])
    gates = torch.where(keep, gates, torch.zeros_like(gates))
    out = (gates[..., None] * picked.float()).sum(0)
    return out.to(x.dtype).reshape(lead + (d,))
