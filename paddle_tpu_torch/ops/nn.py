"""Neural-net op kernels (counterpart of paddle_tpu/ops/nn.py): the
decoder LM's layer_norm, and gaussian_random, the random initializer of
its startup program."""
from __future__ import annotations

import torch

from ..framework.dtypes import as_torch_dtype
from .registry import register_op


@register_op("layer_norm")
def _layer_norm(ctx):
    x = ctx.input("X")
    eps = ctx.attr("epsilon", 1e-5)
    begin = ctx.attr("begin_norm_axis", 1)
    dims = tuple(range(begin, x.ndim))
    # statistics always in fp32; the activation keeps its dtype
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = tuple(x.shape[begin:])
    if ctx.has_input("Scale"):
        y = y * ctx.input("Scale").reshape(norm_shape).float()
    if ctx.has_input("Bias"):
        y = y + ctx.input("Bias").reshape(norm_shape).float()
    lead = tuple(x.shape[:begin])
    return {"Y": y.to(x.dtype),
            "Mean": mean.reshape(lead).to(ctx.out_dtype("Mean")),
            "Variance": var.reshape(lead).to(ctx.out_dtype("Variance"))}


@register_op("gaussian_random")
def _gaussian_random(ctx):
    """N(mean, std) of the attr shape on the program's device, drawn from
    the op's own generator (ctx.rng()). The op's ``seed`` attr is ignored,
    as in the JAX package: the stream derives from the program seed."""
    gen = ctx.rng()
    out = torch.randn(list(ctx.attr("shape")), generator=gen,
                      device=ctx.device, dtype=torch.float32)
    out = out * float(ctx.attr("std", 1.0)) + float(ctx.attr("mean", 0.0))
    return {"Out": out.to(as_torch_dtype(ctx.attr("dtype", "float32")))}

