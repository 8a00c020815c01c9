"""Optimizer op kernels (counterpart of paddle_tpu/ops/optim.py; reference
kernels: paddle/fluid/operators/adam_op.cc). The training slice runs Adam;
the other optimizers' ops are a later slice.

Each kernel returns NEW tensors and updates nothing in place: the old
parameter is a leaf the backward may have saved, and the executor writes
the outputs back into the Scope, which is how the reference's in-place
``ParamOut = Param`` updates land.
"""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("adam")
def _adam(ctx):
    """The reference's formula: lr_t = lr * sqrt(1 - beta2^t) /
    (1 - beta1^t), p -= lr_t * m / (sqrt(v) + epsilon), epsilon outside the
    square root; the beta-power accumulators keep their (1,) shape."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    lr = ctx.input("LearningRate").reshape(())
    b1p_in, b2p_in = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    b1p, b2p = b1p_in.reshape(()), b2p_in.reshape(())
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    g = g.to(p.dtype)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return {
        "ParamOut": p_new,
        "Moment1Out": m_new,
        "Moment2Out": v_new,
        "Beta1PowOut": (b1p * b1).reshape(b1p_in.shape),
        "Beta2PowOut": (b2p * b2).reshape(b2p_in.shape),
    }
