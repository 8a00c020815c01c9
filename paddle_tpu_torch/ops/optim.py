"""Optimizer op kernels (counterpart of paddle_tpu/ops/optim.py; reference
kernels: paddle/fluid/operators/{sgd,momentum,adam,adamax,adagrad,
adadelta,decayed_adagrad,rmsprop,ftrl,proximal_gd,proximal_adagrad,
average_accumulates}_op.cc), each the JAX package's formula.

Each kernel returns NEW tensors and updates nothing in place: the old
parameter is a leaf the backward may have saved, and the executor writes
the outputs back into the Scope (in a captured step, into the scope's own
state buffers), which is how the reference's in-place ``ParamOut = Param``
updates land. Every branch is a select on the device, so a step holding
any of them stays one CUDA graph.
"""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("sgd")
def _sgd(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    lr = ctx.input("LearningRate").reshape(())
    return {"ParamOut": p - lr * g.to(p.dtype)}


@register_op("momentum")
def _momentum(ctx):
    """v' = mu v + g; p' = p - lr v', or with Nesterov p - (g + mu v') lr."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    v = ctx.input("Velocity")
    lr = ctx.input("LearningRate").reshape(())
    mu = ctx.attr("mu")
    v_new = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": p_new, "VelocityOut": v_new}


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


@register_op("adamax")
def _adamax(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m, inf = ctx.input("Moment"), ctx.input("InfNorm")
    lr = ctx.input("LearningRate").reshape(())
    b1p_in = ctx.input("Beta1Pow")
    b1p = b1p_in.reshape(())
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g))
    lr_t = lr / (1 - b1p)
    p_new = p - lr_t * m_new / (inf_new + eps)
    return {
        "ParamOut": p_new,
        "MomentOut": m_new,
        "InfNormOut": inf_new,
        "Beta1PowOut": (b1p * b1).reshape(b1p_in.shape),
    }


@register_op("adagrad")
def _adagrad(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m = ctx.input("Moment")
    lr = ctx.input("LearningRate").reshape(())
    eps = ctx.attr("epsilon", 1e-6)
    m_new = m + torch.square(g)
    p_new = p - lr * g / (torch.sqrt(m_new) + eps)
    return {"ParamOut": p_new, "MomentOut": m_new}


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m = ctx.input("Moment")
    lr = ctx.input("LearningRate").reshape(())
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * torch.square(g)
    p_new = p - lr * g / (torch.sqrt(m_new) + eps)
    return {"ParamOut": p_new, "MomentOut": m_new}


@register_op("adadelta")
def _adadelta(ctx):
    """No learning rate: the update is -sqrt((E[dx^2] + eps) / (E[g^2] +
    eps)) g."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    avg_sq_grad = ctx.input("AvgSquaredGrad")
    avg_sq_upd = ctx.input("AvgSquaredUpdate")
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    asg_new = rho * avg_sq_grad + (1 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_upd + eps) / (asg_new + eps)) * g
    asu_new = rho * avg_sq_upd + (1 - rho) * torch.square(update)
    return {
        "ParamOut": p + update,
        "AvgSquaredGradOut": asg_new,
        "AvgSquaredUpdateOut": asu_new,
    }


@register_op("rmsprop")
def _rmsprop(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    ms = ctx.input("MeanSquare")
    mom = ctx.input("Moment")
    lr = ctx.input("LearningRate").reshape(())
    rho = ctx.attr("decay", 0.9)
    mu = ctx.attr("momentum", 0.0)
    eps = ctx.attr("epsilon", 1e-10)
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    mom_new = mu * mom + lr * g / torch.sqrt(ms_new + eps)
    return {"ParamOut": p - mom_new, "MeanSquareOut": ms_new,
            "MomentOut": mom_new}


@register_op("ftrl")
def _ftrl(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    sq_accum = ctx.input("SquaredAccumulator")
    lin_accum = ctx.input("LinearAccumulator")
    lr = ctx.input("LearningRate").reshape(())
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    power = ctx.attr("lr_power", -0.5)
    new_accum = sq_accum + torch.square(g)
    if power == -0.5:
        lin_new = lin_accum + g - (torch.sqrt(new_accum)
                                   - torch.sqrt(sq_accum)) / lr * p
        y = torch.sqrt(new_accum) / lr + 2 * l2
    else:
        lin_new = lin_accum + g - (torch.pow(new_accum, -power)
                                   - torch.pow(sq_accum, -power)) / lr * p
        y = torch.pow(new_accum, -power) / lr + 2 * l2
    x = l1 * torch.sign(lin_new) - lin_new
    p_new = torch.where(torch.abs(lin_new) > l1, x / y, torch.zeros_like(p))
    return {"ParamOut": p_new, "SquaredAccumOut": new_accum,
            "LinearAccumOut": lin_new}


def _l1_l2_prox(prox, lr, l1, l2):
    """sign(prox) max(|prox| - lr l1, 0) / (1 + lr l2)."""
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1, min=0.0)
            / (1.0 + lr * l2))


@register_op("proximal_gd")
def _proximal_gd(ctx):
    """A gradient step, then the proximal operator of l1 + l2
    (reference: proximal_gd_op.cc)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    lr = ctx.input("LearningRate").reshape(())
    return {"ParamOut": _l1_l2_prox(p - lr * g, lr,
                                    float(ctx.attr("l1", 0.0)),
                                    float(ctx.attr("l2", 0.0)))}


@register_op("proximal_adagrad")
def _proximal_adagrad(ctx):
    """The gradient step scaled by lr / sqrt(moment) per element; the l1
    shrinkage and l2 factor with the plain lr (reference:
    proximal_adagrad_op.h)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m = ctx.input("Moment")
    lr = ctx.input("LearningRate").reshape(())
    m_new = m + torch.square(g)
    prox = p - lr * g / torch.sqrt(m_new)
    return {"ParamOut": _l1_l2_prox(prox, lr, float(ctx.attr("l1", 0.0)),
                                    float(ctx.attr("l2", 0.0))),
            "MomentOut": m_new}


@register_op("average_accumulates")
def _average_accumulates(ctx):
    """ModelAverage's accumulator (reference: average_accumulates_op.h):
    sum_1 += param each step; every 16384 updates sum_1 spills into sum_2;
    when the window fills everything rolls into sum_3 and the window
    restarts. Every branch a select. The counters are int64 (the JAX
    package runs them in int32, x64 off); the window's float product is
    fp32, as it is there."""
    k_max = 16384
    p = ctx.input("param")
    s1, s2, s3 = (ctx.input("in_sum_1"), ctx.input("in_sum_2"),
                  ctx.input("in_sum_3"))
    num_acc = ctx.input("in_num_accumulates").reshape(()).long()
    old_acc = ctx.input("in_old_num_accumulates").reshape(()).long()
    num_upd = ctx.input("in_num_updates").reshape(()).long()
    avg_window = float(ctx.attr("average_window", 0.0))
    max_w = min(int(ctx.attr("max_average_window", 2 ** 31 - 1)),
                2 ** 31 - 1)
    min_w = int(ctx.attr("min_average_window", 10000))
    if min_w > max_w:
        raise ValueError("min_average_window must be <= max_average_window")

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + p
    spill = num_upd % k_max == 0
    s2 = torch.where(spill, s2 + s1, s2)
    s1 = torch.where(spill, torch.zeros_like(s1), s1)

    window = (num_upd.float() * avg_window).long().clamp(max=max_w)
    window_full = (num_acc >= min_w) & (num_acc >= window)
    s3 = torch.where(window_full, s1 + s2, s3)
    s1 = torch.where(window_full, torch.zeros_like(s1), s1)
    s2 = torch.where(window_full, torch.zeros_like(s2), s2)
    old_acc = torch.where(window_full, num_acc, old_acc)
    num_acc = torch.where(window_full, torch.zeros_like(num_acc), num_acc)
    return {"out_sum_1": s1, "out_sum_2": s2, "out_sum_3": s3,
            "out_num_accumulates": num_acc.reshape(1),
            "out_old_num_accumulates": old_acc.reshape(1),
            "out_num_updates": num_upd.reshape(1)}
