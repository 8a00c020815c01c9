"""Int8 KV slabs (counterpart of the int8-KV part of
paddle_tpu/ops/quant.py; its weight and activation quantization ops are
a later slice of the port).

Symmetric quantization: ``q = clip(round(x / scale), -127, 127)``,
``x ~ q * scale``, with one scale per (slot, position) row of a K or V
slab (the amax over the row's heads and head dims). Each appended row
quantizes against its own fresh scale, and attention dequantizes the
slab on read: a slab costs 1 byte an element plus 4 bytes a row, a
quarter of the fp32 slab's bytes.

- ``cache_append_quant``: the int8 twin of ``cache_append``, writing the
  quantized row and its scale IN PLACE (positions clipped to S-1, as
  ``cache_append`` clips).
- ``decode_attention_quant``: dequantize the whole K and V slab to fp32,
  then call ``decode_attention``, the same dispatch as the fp32 slab
  (on the card kernel K3, which raises on what it does not take; on the
  CPU its plain version), as the JAX package does
  (paddle_tpu/ops/quant.py:243-254). The dequantized slabs are written
  and read again on every step: fusing the dequantization into K3 is
  later work.

``quantize_symmetric`` divides by the scale and rounds half to even, as
the JAX package does, so int8 rows and scales are bitwise the JAX
package's on the CPU.
"""
from __future__ import annotations

import torch

from .kv_cache import decode_attention
from .registry import register_op

# symmetric int8 range: +-127 (the -128 code is never produced)
Q_MAX = 127.0
# scale floor: an all-zero row quantizes to zeros with a tiny scale
# instead of dividing by zero
SCALE_EPS = 1e-8


def quantize_symmetric(x, scale):
    """``clip(round(x / scale), -127, 127)`` as int8; ``scale`` is a
    scalar or broadcasts against ``x``. Rounds half to even."""
    q = torch.round(x / scale)
    return q.clamp(-Q_MAX, Q_MAX).to(torch.int8)


def quantize_kv_rows(rows):
    """(..., H, Dh) float rows -> (int8 rows, fp32 scales over the
    leading dims): one symmetric scale per row, its amax over the
    trailing two dims."""
    rows = rows.float()
    amax = rows.abs().amax(dim=(-2, -1))
    scale = (amax / Q_MAX).clamp_min(SCALE_EPS)
    return quantize_symmetric(rows, scale[..., None, None]), scale


def cache_append_quant(cache, scales, new, pos):
    """Quantize ``new`` (B, 1, H, Dh) or (B, H, Dh) and write it into the
    int8 slab ``cache`` (B, S, H, Dh) at row pos[b] (clipped to S-1),
    its scale into ``scales`` (B, S), both IN PLACE; returns (cache,
    scales)."""
    b, s = cache.shape[0], cache.shape[1]
    if new.ndim == cache.ndim:
        if new.shape[1] != 1:
            raise ValueError(
                "cache_append_quant appends ONE row per sequence; New "
                "has time dim %d" % new.shape[1])
        new = new[:, 0]
    pos = pos.reshape(-1).to(device=cache.device, dtype=torch.int64)
    pos = pos.clamp(0, s - 1)
    q, scale = quantize_kv_rows(new)
    rows = torch.arange(b, device=cache.device)
    cache[rows, pos] = q
    scales[rows, pos] = scale.to(scales.dtype)
    return cache, scales


def dequantize_slab(cache, scales, dtype=torch.float32):
    """int8 slab (B, S, H, Dh) x per-(slot, position) scales (B, S) ->
    a new float slab: one elementwise product (int8 times fp32 promotes
    to fp32), so the slab is read once as int8 and written once."""
    return (cache * scales[:, :, None, None]).to(dtype)


def decode_attention_quant(q, k_cache, k_scales, v_cache, v_scales,
                           lengths, scale=None):
    """Single-query attention against int8 K/V slabs: both slabs
    dequantize, then ``decode_attention`` runs on them (K3 on the card)."""
    kf = dequantize_slab(k_cache, k_scales, q.dtype)
    vf = dequantize_slab(v_cache, v_scales, q.dtype)
    return decode_attention(q, kf, vf, lengths, scale=scale)


@register_op("cache_append_quant")
def _cache_append_quant_op(ctx):
    """Inputs Cache (B, S, H, Dh) int8, Scales (B, S) float32, New
    (B, 1, H, Dh) or (B, H, Dh) float, Pos (B,) -> Out (the int8 slab),
    OutScales (the scales), both updated in place."""
    out, out_scales = cache_append_quant(
        ctx.input("Cache"), ctx.input("Scales"), ctx.input("New"),
        ctx.input("Pos"))
    return {"Out": out, "OutScales": out_scales}


@register_op("decode_attention_quant")
def _decode_attention_quant_op(ctx):
    """Inputs Q (B, 1, H, Dh) float, KCache/VCache (B, S, H, Dh) int8,
    KScales/VScales (B, S) float32, Lengths (B,) -> Out like Q; attr
    scale (block_s rides the desc; K3 picks its own split)."""
    return {"Out": decode_attention_quant(
        ctx.input("Q"), ctx.input("KCache"), ctx.input("KScales"),
        ctx.input("VCache"), ctx.input("VScales"), ctx.input("Lengths"),
        scale=ctx.attr("scale", None))}
