"""Math / tensor op kernels (counterpart of paddle_tpu/ops/math.py).

The ops of the Transformer's programs and of the training surface around
them: the JAX package's three table-driven families whole (elementwise
binary ops with the reference's axis-broadcast rule; activations and
other unary maps; comparisons and logical ops, giving bool), clip,
clip_by_norm, scale, sum, mean, reduce_sum, softmax,
softmax_with_cross_entropy, mul/matmul, reshape/transpose, unstack,
gather, lookup_table, cast, assign/assign_value, increment and
fill_constant. They are plain PyTorch on whatever device their inputs lie
on; the 2-D products go to ``torch.matmul``, as the JAX package left them
to XLA. Under bf16 AMP a product takes bf16 operands, sums in fp32 and
rounds its result to bf16, as the reference's ``_mm2d`` does with
``preferred_element_type=f32`` (``matmul_f32acc``).
"""
from __future__ import annotations

import math as _math
import weakref

import numpy as np
import torch

from ..framework.dtypes import as_numpy_dtype, as_torch_dtype
from .registry import register_op

# ---------------------------------------------------------------------------
# elementwise binary ops with the reference's axis-broadcast rule
# (reference: paddle/fluid/operators/elementwise_op_function.h:46 - Y's shape
# must match a contiguous span of X's dims beginning at `axis`).
# ---------------------------------------------------------------------------


def _broadcast_y(x, y, axis):
    if x.ndim == y.ndim:
        return y
    if axis is None or axis == -1:
        axis = x.ndim - y.ndim
    shape = [1] * x.ndim
    for i, s in enumerate(y.shape):
        shape[axis + i] = s
    return y.reshape(shape)


def _promote(x, y):
    """x and y in one dtype as jnp promotes program variables (never weak
    types): bf16 with fp32 gives fp32 whatever the ranks, where torch
    would keep bf16 beside a 0-d fp32 tensor."""
    if x.dtype != y.dtype and x.is_floating_point() and \
            y.is_floating_point():
        dtype = torch.promote_types(x.dtype, y.dtype)
        return x.to(dtype), y.to(dtype)
    return x, y


def _elementwise(fn):
    def kern(ctx):
        x = ctx.input("X")
        y = _broadcast_y(x, ctx.input("Y"), ctx.attr("axis", -1))
        return {"Out": fn(*_promote(x, y))}

    return kern


register_op("elementwise_add")(_elementwise(torch.add))
register_op("elementwise_sub")(_elementwise(torch.sub))
register_op("elementwise_mul")(_elementwise(torch.mul))
register_op("elementwise_div")(_elementwise(torch.div))
register_op("elementwise_max")(_elementwise(torch.maximum))
register_op("elementwise_min")(_elementwise(torch.minimum))
register_op("elementwise_pow")(_elementwise(torch.pow))
# jnp.mod: the remainder takes the divisor's sign, as torch.remainder's does
register_op("elementwise_mod")(_elementwise(torch.remainder))


# ---------------------------------------------------------------------------
# activations and other unary maps (reference: activation_op.cc), the JAX
# package's table
# ---------------------------------------------------------------------------


def _unary(fn):
    def kern(ctx):
        return {"Out": fn(ctx.input("X"))}

    return kern


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0) everywhere; torch's softplus turns
    # linear past its threshold
    return torch.logaddexp(x, torch.zeros_like(x))


register_op("sigmoid")(_unary(torch.sigmoid))
register_op("logsigmoid")(_unary(torch.nn.functional.logsigmoid))
register_op("exp")(_unary(torch.exp))
register_op("relu")(_unary(torch.relu))
register_op("tanh")(_unary(torch.tanh))
register_op("tanh_shrink")(_unary(lambda x: x - torch.tanh(x)))
register_op("sqrt")(_unary(torch.sqrt))
register_op("abs")(_unary(torch.abs))
register_op("ceil")(_unary(torch.ceil))
register_op("floor")(_unary(torch.floor))
register_op("cos")(_unary(torch.cos))
register_op("sin")(_unary(torch.sin))
# half to even, as jnp.round
register_op("round")(_unary(torch.round))
register_op("reciprocal")(_unary(lambda x: 1.0 / x))
register_op("square")(_unary(torch.square))
register_op("softplus")(_unary(_softplus))
register_op("softsign")(_unary(lambda x: x / (1 + torch.abs(x))))
register_op("log")(_unary(torch.log))
register_op("sign")(_unary(torch.sign))


@register_op("clip")
def _clip(ctx):
    return {"Out": torch.clamp(ctx.input("X"), ctx.attr("min"),
                               ctx.attr("max"))}


@register_op("clip_by_norm")
def _clip_by_norm(ctx):
    """X scaled by max_norm / ||X|| where its norm exceeds max_norm, all on
    the device (no host read of the norm)."""
    x = ctx.input("X")
    max_norm = ctx.attr("max_norm")
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return {"Out": x * scale}


# ---------------------------------------------------------------------------
# comparisons and logical ops: bool outputs, as jnp gives
# ---------------------------------------------------------------------------


def _compare(fn):
    def kern(ctx):
        return {"Out": fn(ctx.input("X"), ctx.input("Y"))}

    return kern


register_op("less_than")(_compare(torch.lt))
register_op("less_equal")(_compare(torch.le))
register_op("greater_than")(_compare(torch.gt))
register_op("greater_equal")(_compare(torch.ge))
register_op("equal")(_compare(torch.eq))
register_op("not_equal")(_compare(torch.ne))
register_op("logical_and")(_compare(torch.logical_and))
register_op("logical_or")(_compare(torch.logical_or))
register_op("logical_xor")(_compare(torch.logical_xor))
register_op("logical_not")(_unary(torch.logical_not))
register_op("isfinite")(_unary(lambda x: torch.all(torch.isfinite(x))))


@register_op("scale")
def _scale(ctx):
    """x * scale + bias, or (x + bias) * scale with bias_after_scale off
    (reference: scale_op.cc); the attrs are weak scalars, so x keeps its
    dtype."""
    s = float(ctx.attr("scale", 1.0))
    b = float(ctx.attr("bias", 0.0))
    x = ctx.input("X")
    out = x * s + b if ctx.attr("bias_after_scale", True) else (x + b) * s
    return {"Out": out}


@register_op("sum")
def _sum(ctx):
    """The sum of every X, added left to right (reference: sum_op.cc)."""
    xs = ctx.inputs("X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("mean")
def _mean(ctx):
    """Mean of every element, a 0-d tensor (reference: mean_op.cc)."""
    return {"Out": torch.mean(ctx.input("X"))}


@register_op("reduce_sum")
def _reduce_sum(ctx):
    """Sum over ``dim`` (every axis with reduce_all), keep_dim as the
    reference's reduce_op.cc."""
    x = ctx.input("X")
    keep = bool(ctx.attr("keep_dim", False))
    if ctx.attr("reduce_all", False):
        out = torch.sum(x)
        return {"Out": out.reshape((1,) * x.ndim) if keep else out}
    dim = ctx.attr("dim", [0])
    dims = dim if isinstance(dim, (list, tuple)) else [dim]
    axes = tuple(sorted({int(d) % x.ndim for d in dims}))
    return {"Out": torch.sum(x, dim=axes, keepdim=keep)}


@register_op("softmax")
def _softmax(ctx):
    """Softmax over the last axis (reference: softmax_op.cc)."""
    return {"Out": torch.softmax(ctx.input("X"), dim=-1)}


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx):
    """Fused softmax + cross entropy over the last axis (reference:
    softmax_with_cross_entropy_op.cc): Loss (..., 1) and Softmax. Hard
    labels (..., 1) or (...,) int ids, a position whose label is
    ``ignore_index`` contributing 0; soft labels a distribution of the
    logits' shape."""
    logits = ctx.input("Logits")
    label = ctx.input("Label")
    logp = torch.log_softmax(logits, dim=-1)
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
            else label
        lbl = lbl.long()
        ignore = ctx.attr("ignore_index", -100)
        hit = lbl == ignore
        # an ignored (or any out-of-range) id picks column 0, then counts 0
        safe = torch.where((lbl >= 0) & (lbl < logp.shape[-1]), lbl,
                           torch.zeros_like(lbl))
        loss = -torch.gather(logp, -1, safe[..., None])
        loss = torch.where(hit[..., None], torch.zeros_like(loss), loss)
    return {"Loss": loss, "Softmax": torch.exp(logp)}


# ---------------------------------------------------------------------------
# matmul family (reference: matmul_op.cc, mul_op.cc)
# ---------------------------------------------------------------------------


def matmul_f32acc(x, y):
    """torch.matmul, with bf16 operands summed in fp32 and the result
    rounded to bf16 (the reference's bf16 x bf16 -> f32 -> bf16). On the
    card that is cuBLAS's bf16 product (the executor turns off its
    reduced-precision reduction); on the CPU the operands are upcast:
    products of bf16 values are exact in fp32, so the result is the
    same, and its gradients are rounded to bf16 by the casts' own
    backward."""
    if x.dtype == torch.bfloat16 and y.dtype == torch.bfloat16 and \
            x.device.type == "cpu":
        return torch.matmul(x.float(), y.float()).to(torch.bfloat16)
    return torch.matmul(x, y)


def _mul_compute(x, y, xnc, ync):
    """The reference's `mul` computation: flatten X to 2-D by
    x_num_col_dims then matmul (reference: paddle/fluid/operators/
    mul_op.cc:36)."""
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(_math.prod(xs[:xnc]) if xnc else 1, -1)
    y2 = y.reshape(_math.prod(ys[:ync]), -1)
    return matmul_f32acc(x2, y2).reshape(xs[:xnc] + ys[ync:])


@register_op("mul")
def _mul(ctx):
    return {"Out": _mul_compute(ctx.input("X"), ctx.input("Y"),
                                ctx.attr("x_num_col_dims", 1),
                                ctx.attr("y_num_col_dims", 1))}


@register_op("matmul")
def _matmul(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    if ctx.attr("transpose_X", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = matmul_f32acc(x, y)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


@register_op("reshape")
def _reshape(ctx):
    x = ctx.input("X")
    shape = list(ctx.attr("shape"))
    # paddle semantics: 0 means copy dim from input
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return {"Out": x.reshape(shape)}


@register_op("transpose")
def _transpose(ctx):
    return {"Out": ctx.input("X").permute(*ctx.attr("axis"))}


@register_op("unstack")
def _unstack(ctx):
    """The slices of X along ``axis``, each without that axis (views)."""
    x = ctx.input("X")
    return {"Y": list(torch.unbind(x, dim=int(ctx.attr("axis", 0)) % x.ndim))}


# ---------------------------------------------------------------------------
# indexing / selection
# ---------------------------------------------------------------------------


@register_op("gather")
def _gather(ctx):
    """jnp.take's semantics, as the JAX package's op has them: a negative
    index counts from the end, and a row out of range reads the fill value
    (NaN for floats, the least value of an integer dtype) instead of
    failing; all on the device, so a graph may hold it."""
    x = ctx.input("X")
    index = ctx.input("Index").reshape(-1).long()
    n = x.shape[0]
    valid = (index >= -n) & (index < n)
    out = x.index_select(0, torch.where(index < 0, index + n, index)
                         .clamp(0, max(n - 1, 0)))
    fill = (float("nan") if x.is_floating_point()
            else torch.iinfo(x.dtype).min)
    mask = valid.reshape((-1,) + (1,) * (x.ndim - 1))
    return {"Out": torch.where(mask, out, torch.full_like(out, fill))}


@register_op("lookup_table")
def _lookup_table(ctx):
    """Embedding lookup (reference: lookup_table_op.cc)."""
    w = ctx.input("W")
    ids = ctx.input("Ids").long()
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    padding_idx = ctx.attr("padding_idx", -1)
    out = w[ids]
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return {"Out": out}


# ---------------------------------------------------------------------------
# misc tensor ops
# ---------------------------------------------------------------------------


@register_op("cast")
def _cast(ctx):
    return {"Out": ctx.input("X").to(as_torch_dtype(ctx.attr("out_dtype")))}


@register_op("assign")
def _assign(ctx):
    return {"Out": ctx.input("X")}


# assign_value's and load_file's tensors, made once per (op, device): a
# host-to-device copy on every run would block a CUDA graph capture, and
# bake a host address into the graph if it did not
_CONSTANTS = weakref.WeakKeyDictionary()


def _host_constant(ctx, make):
    """A copy of this op's tensor on ``ctx.device``, which ``make()``
    gives as a numpy array on the op's first run there. Each run hands
    out a fresh device-to-device copy: the executor writes outputs into
    the scope's tensors in place (a later step or startup run), and that
    must never reach the kept tensor."""
    made = _CONSTANTS.setdefault(ctx.op, {})
    kept = made.get(ctx.device)
    if kept is None:
        # a normal tensor even when first made under inference mode, so a
        # training run of the same op may use it
        with torch.inference_mode(False):
            kept = made[ctx.device] = torch.from_numpy(
                np.ascontiguousarray(make())).to(ctx.device)
    return kept.clone()


@register_op("assign_value")
def _assign_value(ctx):
    """Attr-embedded data (a numpy array once the program is built or
    read back from JSON) as a tensor on the program's device, copied from
    the host on the op's first run there only."""
    return {"Out": _host_constant(ctx, lambda: np.asarray(
        ctx.attr("values"), dtype=as_numpy_dtype(ctx.attr(
            "dtype", "float32"))).reshape(ctx.attr("shape")))}


@register_op("load_file")
def _load_file(ctx):
    """reference: load_op.cc — a saved tensor (the ``.npy`` file that
    io.save_vars writes) as the op's output, in float16 with
    ``load_as_fp16``. Read on the host on the op's first run on a device
    only, as assign_value's data is: a captured step never reads the
    file (the JAX package reads it once, at trace time)."""
    def read():
        arr = np.load(ctx.attr("file_path"))
        return arr.astype(np.float16) if ctx.attr("load_as_fp16",
                                                  False) else arr
    return {"Out": _host_constant(ctx, read)}


@register_op("increment")
def _increment(ctx):
    """X + step in X's dtype (a counter stays an integer)."""
    x = ctx.input("X")
    step = ctx.attr("step", 1.0)
    # a Python scalar, not a tensor made from it: a host-to-device copy
    # could not be captured
    return {"Out": x + (step if x.is_floating_point() else int(step))}


@register_op("fill_constant")
def _fill_constant(ctx):
    return {"Out": torch.full(list(ctx.attr("shape")),
                              ctx.attr("value", 0.0),
                              dtype=as_torch_dtype(ctx.attr("dtype",
                                                            "float32")),
                              device=ctx.device)}
