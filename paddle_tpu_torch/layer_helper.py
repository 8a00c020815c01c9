"""LayerHelper (reference: python/paddle/fluid/layer_helper.py).

Shared machinery for all `layers.*` functions: creates parameters in both
the main program (as Parameter vars) and the startup program (with their
init ops), creates temp output variables, and appends bias/activation ops.
"""
from __future__ import annotations

from .framework import unique_name
from .framework.core import default_main_program, default_startup_program
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name")
        if name is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    # -- parameters ------------------------------------------------------
    def create_parameter(self, attr, shape, dtype, is_bias=False, default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if default_initializer is None:
            if is_bias:
                attr.set_default_bias_initializer()
            else:
                attr.set_default_param_initializer()
        else:
            attr.set_default_initializer(default_initializer)
        if attr.name is None:
            suffix = "b" if is_bias else "w"
            attr.name = unique_name.generate(".".join([self.name, suffix]))

        shape = [int(s) for s in shape]
        main_block = self.main_program.current_block()
        param = main_block.create_parameter(
            name=attr.name, shape=shape, dtype=dtype, **{
                k: v for k, v in attr._to_kwargs().items() if k != "name"
            }
        )
        # mirrored in the startup program with its init op
        startup_block = self.startup_program.global_block()
        if attr.name not in startup_block.vars:
            svar = startup_block.create_parameter(
                name=attr.name, shape=shape, dtype=dtype, trainable=attr.trainable
            )
            attr.initializer(svar, startup_block)
        return param

    def create_variable_for_type_inference(self, dtype, shape=(), stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype,
            shape=shape,
            stop_gradient=stop_gradient,
        )

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs
        )

    def set_variable_initializer(self, var, initializer):
        """Create the same var in startup program and init it there."""
        startup_block = self.startup_program.global_block()
        if var.name not in startup_block.vars:
            svar = startup_block.create_var(
                name=var.name, shape=var.shape, dtype=var.dtype, persistable=True
            )
            initializer(svar, startup_block)
        return var

    def append_op(self, **kwargs):
        return self.main_program.current_block().append_op(**kwargs)

    # -- common input handling -------------------------------------------
    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr", None))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr", None))

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError("mismatched input dtypes for %s" % self.layer_type)
        return dtype

    # -- bias & activation ------------------------------------------------
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if bias_attr is False:
            return input_var
        b = self.create_parameter(attr=bias_attr, shape=size, dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(
            dtype=input_var.dtype, shape=input_var.shape
        )
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act", None)
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(
            dtype=input_var.dtype, shape=input_var.shape
        )
        self.append_op(
            type=act_type, inputs={"X": [input_var]}, outputs={"Out": [tmp]}, attrs=act
        )
        return tmp
