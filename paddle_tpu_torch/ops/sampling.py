"""Token sampling kernels for the decode serving path (counterpart of
paddle_tpu/ops/sampling.py).

Greedy, top-k and top-p (nucleus) sampling over a (B, V) logits row: the
last op of a decode step (serving/decode.py), so the sampled ids come off
the device as (B,) int64 and the logits never cross to the host.

Randomness contract: a decode step is captured once as a CUDA graph and
replayed many times, so the draw cannot come from a host-seeded
``torch.Generator`` (a replay would repeat its capture's bits), and the
ops are NOT registered as random (``ops/registry.py``: a random op makes
its program run op by op). The draw is instead a pure function of the
``Seed`` tensor's VALUE, computed on the device: a counter-based 32-bit
hash of (seed, row, vocabulary id), the hash's uniform turned into Gumbel
noise, and the Gumbel-max trick over the kept candidates (the argmax of
``logits / T + g`` is a draw from the renormalized softmax). The caller
feeds a fresh per-step seed, as the JAX package's callers do; a graph
replay and the eager step give the same ids for the same seed. With no
``Seed`` input an op uses a fixed seed of its own (a hash of its output's
name), as the JAX package's trace-time stream is fixed per executable.
The bits differ from JAX's PRNG: compare statistically. Rows sample
independently (the row index is hashed in).

All three ops accept logits as (B, V) or (B, 1, V) (the decode step's
natural head output) and flatten the singleton.
"""
from __future__ import annotations

import zlib

import torch

from .registry import register_op

_NEG = -1e30
_M32 = 0xFFFFFFFF


def _flat_logits(x):
    if x.ndim == 3:
        x = x[:, 0] if x.shape[1] == 1 else x.reshape(-1, x.shape[-1])
    return x


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 tensors holding uint32 values, in
    products that never leave int64: c split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """murmur3's 32-bit finalizer (a bijection with full avalanche) on
    int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _gumbel(seed, rows, ids):
    """Gumbel(0, 1) noise, float32, one value per (row, id) pair of the
    broadcast ``rows`` (B, 1) and ``ids`` (B, N) int64 tensors, as a pure
    function of ``seed`` (an int, or a tensor's first element)."""
    if isinstance(seed, int):   # a fill kernel: capturable, no copy
        s = torch.full((1,), seed, dtype=torch.int64, device=ids.device)
    else:
        s = seed.reshape(-1)[:1].to(device=ids.device, dtype=torch.int64)
    key = _mix32(_mix32(s & _M32) ^ ((s >> 32) & _M32))
    h = _mix32(_mix32(key ^ (rows & _M32)) ^ (ids & _M32))
    # the top 24 bits, centred in their cell: u in (0, 1), never 0 or 1
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _scaled(logits, temperature):
    logits = _flat_logits(logits).float()
    return logits / max(float(temperature), 1e-6)


def greedy_sample(logits):
    """argmax over the vocab axis -> (B,) int64 (the first maximum on a
    tie, as jnp.argmax)."""
    return torch.argmax(_flat_logits(logits), dim=-1).to(torch.int64)


def top_k_sample(logits, seed, k, temperature=1.0):
    """Sample from the renormalized top-k slice of each row.

    k=1 degenerates to greedy (one candidate); temperature rescales the
    logits BEFORE the cut, so k and temperature compose predictably."""
    scaled = _scaled(logits, temperature)
    b, v = scaled.shape
    k = max(1, min(int(k), v))
    top, idx = torch.topk(scaled, k, dim=-1)                # (B, k) each
    rows = torch.arange(b, device=scaled.device).reshape(b, 1)
    choice = torch.argmax(top + _gumbel(seed, rows, idx), dim=-1)
    return torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int64)


def top_p_sample(logits, seed, p, temperature=1.0):
    """Nucleus sampling: keep the smallest descending-probability prefix
    whose mass reaches ``p`` (the first token is always kept, so p -> 0
    degenerates to greedy), renormalize, sample."""
    scaled = _scaled(logits, temperature)
    b = scaled.shape[0]
    sorted_logits, sort_idx = torch.sort(scaled, dim=-1, descending=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # token i is kept while the mass BEFORE it is < p (first always kept)
    keep = (cum - probs) < float(p)
    masked = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, _NEG))
    rows = torch.arange(b, device=scaled.device).reshape(b, 1)
    choice = torch.argmax(masked + _gumbel(seed, rows, sort_idx), dim=-1)
    return torch.gather(sort_idx, 1, choice[:, None])[:, 0].to(torch.int64)


def _op_seed(ctx):
    """The Seed input, or the op's own fixed seed when it has none."""
    seed = ctx.input("Seed")
    if seed is None:
        return zlib.crc32(ctx.op.output("Out")[0].encode())
    return seed


@register_op("greedy_sample")
def _greedy_sample_op(ctx):
    """Inputs Logits (B, V) or (B, 1, V) -> Out (B,) int64 argmax ids."""
    return {"Out": greedy_sample(ctx.input("Logits"))}


@register_op("top_k_sample")
def _top_k_sample_op(ctx):
    """Inputs Logits (B, V) or (B, 1, V), Seed (int tensor, first element
    used; omitted: the op's fixed seed); attrs k, temperature -> Out (B,)
    int64 sampled ids."""
    return {"Out": top_k_sample(
        ctx.input("Logits"), _op_seed(ctx), int(ctx.attr("k", 40)),
        float(ctx.attr("temperature", 1.0) or 1.0))}


@register_op("top_p_sample")
def _top_p_sample_op(ctx):
    """Inputs Logits (B, V) or (B, 1, V), Seed (see top_k_sample); attrs
    p, temperature -> Out (B,) int64 sampled ids."""
    return {"Out": top_p_sample(
        ctx.input("Logits"), _op_seed(ctx), float(ctx.attr("p", 0.9)),
        float(ctx.attr("temperature", 1.0) or 1.0))}
