"""Math / tensor op kernels (counterpart of paddle_tpu/ops/math.py).

The ops of the decoder LM's programs: elementwise_add with the
reference's axis-broadcast rule, mean, relu, softmax, mul/matmul,
reshape/transpose, gather, lookup_table, cast, assign/assign_value and
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


@register_op("elementwise_add")
def _elementwise_add(ctx):
    x = ctx.input("X")
    y = _broadcast_y(x, ctx.input("Y"), ctx.attr("axis", -1))
    return {"Out": torch.add(*_promote(x, y))}


@register_op("mean")
def _mean(ctx):
    """Mean of every element, a 0-d tensor (reference: mean_op.cc)."""
    return {"Out": torch.mean(ctx.input("X"))}


@register_op("relu")
def _relu(ctx):
    return {"Out": torch.relu(ctx.input("X"))}


@register_op("softmax")
def _softmax(ctx):
    """Softmax over the last axis (reference: softmax_op.cc)."""
    return {"Out": torch.softmax(ctx.input("X"), dim=-1)}


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


# ---------------------------------------------------------------------------
# indexing / selection
# ---------------------------------------------------------------------------


@register_op("gather")
def _gather(ctx):
    x = ctx.input("X")
    index = ctx.input("Index").reshape(-1).long()
    return {"Out": x.index_select(0, index)}


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


# assign_value's tensors, made once per (op, device): a host-to-device copy
# on every run would block a CUDA graph capture, and bake a host address
# into the graph if it did not
_CONSTANTS = weakref.WeakKeyDictionary()


@register_op("assign_value")
def _assign_value(ctx):
    """Attr-embedded data (a numpy array once the program is built or
    read back from JSON) as a tensor on the program's device, copied from
    the host on the op's first run there and reused after (callers never
    write into it)."""
    made = _CONSTANTS.setdefault(ctx.op, {})
    out = made.get(ctx.device)
    if out is None:
        dtype = ctx.attr("dtype", "float32")
        arr = np.asarray(ctx.attr("values"), dtype=as_numpy_dtype(
            dtype)).reshape(ctx.attr("shape"))
        # a normal tensor even when first made under inference mode, so a
        # training run of the same op may use it
        with torch.inference_mode(False):
            out = made[ctx.device] = torch.from_numpy(arr).to(ctx.device)
    return {"Out": out}


@register_op("fill_constant")
def _fill_constant(ctx):
    return {"Out": torch.full(list(ctx.attr("shape")),
                              ctx.attr("value", 0.0),
                              dtype=as_torch_dtype(ctx.attr("dtype",
                                                            "float32")),
                              device=ctx.device)}
