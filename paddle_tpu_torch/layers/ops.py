"""layers.ops (reference: python/paddle/fluid/layers/ops.py): the binary
elementwise builders and ``scale``."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["elementwise_add", "elementwise_mul", "elementwise_div",
           "scale"]


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


def _make_binary(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_variable_for_type_inference(
            dtype=x.dtype,
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
                     "rule (kernel: ops/math.py)." % op_type[12:])
    return layer


elementwise_add = _make_binary("elementwise_add")
elementwise_mul = _make_binary("elementwise_mul")
elementwise_div = _make_binary("elementwise_div")
