"""Sequence op kernels (counterpart of paddle_tpu/ops/sequence.py): the
Transformer's ``sequence_mask``. The reference's LoD sequences are dense
(B, T) tensors with a lengths vector here, as in the JAX package."""
from __future__ import annotations

import torch

from ..framework.dtypes import as_torch_dtype
from .registry import register_op


@register_op("sequence_mask")
def _sequence_mask(ctx):
    """Lengths X (B,) -> Y (B, maxlen): 1 where the position is below the
    row's length, in ``out_dtype``. ``maxlen`` must be static (a
    non-negative attr), as in the JAX package."""
    x = ctx.input("X")
    maxlen = int(ctx.attr("maxlen", -1))
    if maxlen < 0:
        raise ValueError("sequence_mask requires a static maxlen")
    pos = torch.arange(maxlen, device=x.device)
    mask = pos[None, :] < x.reshape(-1)[:, None]
    return {"Y": mask.to(as_torch_dtype(ctx.attr("out_dtype", "int64")))}
