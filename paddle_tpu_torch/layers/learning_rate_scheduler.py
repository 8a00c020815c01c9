"""Learning-rate schedules (reference:
python/paddle/fluid/layers/learning_rate_scheduler.py); a copy of
paddle_tpu/layers/learning_rate_scheduler.py.

Each schedule composes ordinary ops over the auto-incremented global step
counter (an int64 persistable, state of the step), so the lr computation
lives inside the training step: a step with a schedule is still one CUDA
graph replay, and ``run_loop(k)`` advances the counter k times.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import autoincreased_step_counter
from . import ops, tensor

__all__ = [
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "noam_decay",
    "append_LARS",
]


def _global_step_f32(begin: int = 0):
    """The decay step counter. The reference's _decay_step_counter starts
    at 0 (the first step trains at the undecayed learning_rate);
    noam_decay starts at 1 (step^-0.5 needs step >= 1), and
    piecewise_decay's step>boundary comparison pairs with begin=1 to
    reproduce the reference's begin-0 step<boundary banding."""
    counter = autoincreased_step_counter(begin=begin)
    return tensor.cast(counter, "float32")


def _binary(op_type, x, y, out_shape=(1,)):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference("float32", shape=out_shape)
    helper.append_op(
        type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]}, attrs={"axis": -1}
    )
    return out


def _const(value, shape=(1,)):
    return tensor.fill_constant(shape=list(shape), dtype="float32", value=value)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step_f32()
    div = ops.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops.floor(div)
    rate = _const(decay_rate)
    decayed = _binary("elementwise_pow", rate, div)
    return ops.scale(decayed, scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step_f32()
    div = ops.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops.floor(div)
    exponent = ops.scale(div, scale=-float(decay_rate))
    decayed = ops.exp(exponent)
    return ops.scale(decayed, scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step_f32()
    div = ops.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops.floor(div)
    denom = ops.scale(div, scale=float(decay_rate), bias=1.0)
    lr = _const(float(learning_rate))
    return _binary("elementwise_div", lr, denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001, power=1.0, cycle=False):
    step = _global_step_f32()
    if cycle:
        div = ops.scale(step, scale=1.0 / decay_steps)
        ceil_div = ops.ceil(div)
        one = _const(1.0)
        # when step == 0 keep multiplier at 1
        ceil_div = _binary("elementwise_max", ceil_div, one)
        decay_steps_var = _binary("elementwise_mul", ceil_div, _const(float(decay_steps)))
        ratio = _binary("elementwise_div", step, decay_steps_var)
    else:
        capped = _binary("elementwise_min", step, _const(float(decay_steps)))
        ratio = ops.scale(capped, scale=1.0 / decay_steps)
    one_minus = ops.scale(ratio, scale=-1.0, bias=1.0)
    poly = _binary("elementwise_pow", one_minus, _const(float(power)))
    span = ops.scale(poly, scale=float(learning_rate) - float(end_learning_rate))
    return ops.scale(span, scale=1.0, bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """lr = values[i] for step in (boundaries[i-1], boundaries[i]]."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    step = _global_step_f32(begin=1)
    lr = _const(float(values[0]))
    for b, v in zip(boundaries, values[1:]):
        past = _binary("greater_than", step, _const(float(b)))
        past_f = tensor.cast(past, "float32")
        not_past = ops.scale(past_f, scale=-1.0, bias=1.0)
        lr = _binary(
            "elementwise_add",
            _binary("elementwise_mul", lr, not_past),
            _binary("elementwise_mul", _const(float(v)), past_f),
        )
    return lr


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5) (reference
    learning_rate_scheduler.py:noam_decay; used by Transformer)."""
    step = _global_step_f32(begin=1)
    a = _binary("elementwise_pow", step, _const(-0.5))
    b = ops.scale(step, scale=float(warmup_steps) ** -1.5)
    m = _binary("elementwise_min", a, b)
    return ops.scale(m, scale=float(d_model) ** -0.5)


def append_LARS(params_grads, learning_rate, weight_decay):
    """reference learning_rate_scheduler.py:append_LARS — layer-wise
    adaptive rate scaling: per-param lr = global_lr * ||w|| /
    (||g|| + weight_decay * ||w||). Mutates each param's optimize_attr so
    the optimizer picks up the decayed lr variable."""
    from . import nn, ops

    def _balanced_weight(param_norm, grad_norm):
        if weight_decay == 1.0:
            return ops.elementwise_add(grad_norm, param_norm)
        return ops.elementwise_add(
            grad_norm, ops.scale(param_norm, scale=float(weight_decay)))

    for param, grad in params_grads:
        param_lr = param.optimize_attr.get("learning_rate", 1.0)
        param_norm = ops.sqrt(nn.reduce_sum(ops.square(param)))
        grad_norm = ops.sqrt(nn.reduce_sum(ops.square(grad)))
        ratio = ops.elementwise_div(
            param_norm, _balanced_weight(param_norm, grad_norm))
        decayed_lr = ops.elementwise_mul(learning_rate, ratio)
        if not (isinstance(param_lr, float) and param_lr == 1.0):
            decayed_lr = ops.scale(decayed_lr, scale=float(param_lr))
        param.optimize_attr["learning_rate"] = decayed_lr
