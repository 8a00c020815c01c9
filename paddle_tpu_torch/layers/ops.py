"""layers.ops (reference: python/paddle/fluid/layers/ops.py +
layer_function_generator.py): the generated unary layers whose kernels the
port has, the binary elementwise builders, ``scale``, ``clip`` and
``clip_by_norm``, and the logical builders (bool outputs)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

# the JAX package's _UNARY_OPS that the port registers a kernel for
_UNARY_OPS = [
    "sigmoid",
    "logsigmoid",
    "exp",
    "relu",
    "tanh",
    "tanh_shrink",
    "sqrt",
    "abs",
    "ceil",
    "floor",
    "cos",
    "sin",
    "round",
    "reciprocal",
    "square",
    "softplus",
    "softsign",
    "logical_not",
]

__all__ = list(_UNARY_OPS) + [
    "scale",
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_max",
    "elementwise_min",
    "elementwise_pow",
    "clip",
    "clip_by_norm",
    "logical_and",
    "logical_or",
    "logical_xor",
]


def _make_unary(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                        shape=x.shape)
        helper.append_op(
            type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
            attrs=attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = ("Elementwise %s (generated; reference layers/ops.py)."
                     % op_type)
    return layer


_g = globals()
for _op in _UNARY_OPS:
    _g[_op] = _make_unary(_op)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    helper.append_op(
        type="scale",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


def _make_binary(op_type, out_dtype=None):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_variable_for_type_inference(
            dtype=out_dtype or x.dtype,
            shape=y.shape if len(y.shape) > len(x.shape) else x.shape)
        helper.append_op(
            type=op_type,
            inputs={"X": [x], "Y": [y]},
            outputs={"Out": [out]},
            attrs={"axis": axis},
        )
        return helper.append_activation(out)

    layer.__name__ = op_type
    layer.__doc__ = ("Elementwise %s with the reference's axis-broadcast "
                     "rule (kernel: ops/math.py)." % op_type)
    return layer


elementwise_add = _make_binary("elementwise_add")
elementwise_sub = _make_binary("elementwise_sub")
elementwise_mul = _make_binary("elementwise_mul")
elementwise_div = _make_binary("elementwise_div")
elementwise_max = _make_binary("elementwise_max")
elementwise_min = _make_binary("elementwise_min")
elementwise_pow = _make_binary("elementwise_pow")
logical_and = _make_binary("logical_and", out_dtype="bool")
logical_or = _make_binary("logical_or", out_dtype="bool")
logical_xor = _make_binary("logical_xor", out_dtype="bool")


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    helper.append_op(
        type="clip",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"min": float(min), "max": float(max)},
    )
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    helper.append_op(
        type="clip_by_norm",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"max_norm": float(max_norm)},
    )
    return out
