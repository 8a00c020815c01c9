"""Neural-net op kernels (counterpart of paddle_tpu/ops/nn.py): the
Transformer's layer_norm and dropout, and gaussian_random, the random
initializer of its startup program."""
from __future__ import annotations

import torch

from ..framework.dtypes import as_torch_dtype
from . import rng
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


@register_op("gaussian_random", random=True)
def _gaussian_random(ctx):
    """N(mean, std) of the attr shape on the program's device, drawn from
    the op's own generator (ctx.rng()). The op's ``seed`` attr is ignored,
    as in the JAX package: the stream derives from the program seed."""
    gen = ctx.rng()
    out = torch.randn(list(ctx.attr("shape")), generator=gen,
                      device=ctx.device, dtype=torch.float32)
    out = out * float(ctx.attr("std", 1.0)) + float(ctx.attr("mean", 0.0))
    return {"Out": out.to(as_torch_dtype(ctx.attr("dtype", "float32")))}


@register_op("uniform_random", random=True)
def _uniform_random(ctx):
    """U[min, max) of the attr shape on the program's device, drawn from the
    op's own generator (the Xavier initializer's op, which the parameters
    with no initializer of their own, the MoE block's among them, draw
    from at startup). The ``seed`` attr is ignored, as in the JAX
    package."""
    gen = ctx.rng()
    lo, hi = float(ctx.attr("min", -1.0)), float(ctx.attr("max", 1.0))
    out = torch.rand(list(ctx.attr("shape")), generator=gen,
                     device=ctx.device, dtype=torch.float32)
    out = out * (hi - lo) + lo
    return {"Out": out.to(as_torch_dtype(ctx.attr("dtype", "float32")))}



def _fixed_key(op, device):
    """The key of an op whose own seed is fixed (``fix_seed``, or a
    nonzero ``seed`` attr as layers.dropout sets it): the same mask every
    step, the reference Paddle's fixed-seed dropout; None otherwise."""
    seed = int(op.attr("seed", 0) or 0)
    if not (op.attr("fix_seed", False) or seed):
        return None
    return rng.op_key(rng.counter_key(rng.make_counter(seed, 0, device)),
                      rng.mix(seed))


@register_op("dropout", keyed=True)
def _dropout(ctx):
    """reference dropout_op.h. ``downgrade_in_infer`` (the default) masks
    in training and scales by (1 - p) at is_test; ``upscale_in_train``
    divides the kept values by (1 - p) in training and is the identity at
    is_test. ``Mask`` is the keep mask in x's dtype (ones when nothing is
    drawn); the backward multiplies by the forward's own mask. The mask is
    a counter-based hash of the op's key (ops/rng.py), so a training step
    that holds dropout stays one CUDA graph replay and draws anew each
    step; its bits differ from JAX's."""
    x = ctx.input("X")
    p = float(ctx.attr("dropout_prob", 0.5))
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.is_test or p == 0.0:
        if p != 0.0 and impl == "downgrade_in_infer":
            return {"Out": x * (1.0 - p), "Mask": torch.ones_like(x)}
        return {"Out": x, "Mask": torch.ones_like(x)}
    key = _fixed_key(ctx.op, x.device)
    if key is None:
        key = ctx.rng_key()
    keep = rng.keep_mask(key.to(x.device), x.shape, p)
    kept = x / (1.0 - p) if impl == "upscale_in_train" else x
    return {"Out": torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                                       device=x.device)),
            "Mask": keep.to(x.dtype)}
