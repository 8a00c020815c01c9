"""layers.tensor (reference: python/paddle/fluid/layers/tensor.py): the
tensor builders the serving and training programs use."""
from __future__ import annotations

import numpy as np

from ..framework.core import Variable
from ..framework.dtypes import convert_dtype
from ..layer_helper import LayerHelper

__all__ = ["create_parameter", "cast", "sums", "assign", "fill_constant"]


def create_parameter(
    shape, dtype, name=None, attr=None, is_bias=False, default_initializer=None
):
    helper = LayerHelper("create_parameter", name=name)
    from ..param_attr import ParamAttr

    attr = attr if attr is not None else ParamAttr(name=name)
    return helper.create_parameter(attr, shape, convert_dtype(dtype), is_bias, default_initializer)


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype, shape=x.shape)
    helper.append_op(
        type="cast",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"in_dtype": x.dtype, "out_dtype": dtype},
    )
    return out


def sums(input, out=None):
    helper = LayerHelper("sums")
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=helper.input_dtype(), shape=input[0].shape
        )
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype, shape=input.shape
            )
        helper.append_op(type="assign", inputs={"X": [input]}, outputs={"Out": [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=convert_dtype(input.dtype), shape=input.shape
            )
        helper.append_op(
            type="assign_value",
            outputs={"Out": [output]},
            attrs={
                "shape": list(input.shape),
                "dtype": convert_dtype(input.dtype),
                "values": input,
            },
        )
    else:
        raise TypeError("assign expects Variable or ndarray")
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    dtype = convert_dtype(dtype)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype, shape=tuple(shape))
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value)},
    )
    out.stop_gradient = True
    return out
