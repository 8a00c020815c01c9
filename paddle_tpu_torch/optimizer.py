"""Optimizers (reference: python/paddle/fluid/optimizer.py); the port's copy
of paddle_tpu/optimizer.py's ``Optimizer`` and ``AdamOptimizer``.

`minimize(loss)` appends backward (one symbolic autodiff op), regularization
/ clipping ops, then one optimizer op per parameter, with accumulators
created as persistable vars initialized in the startup program. The op
descs, names and startup initializers are the JAX package's, so both
packages build the same programs. The other optimizers are a later slice.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

from .backward import append_backward
from .clip import append_gradient_clip_ops
from .framework.core import Variable, default_main_program
from .framework import unique_name
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["Adam", "AdamOptimizer", "Optimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, LARS_weight_decay=0.0, name=None):
        if not isinstance(learning_rate, (float, int, Variable)):
            raise TypeError("learning_rate must be float or Variable")
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map: Dict[int, Variable] = {}
        self._accumulators: Dict[str, Dict[str, Variable]] = defaultdict(dict)
        self.helper: Optional[LayerHelper] = None
        self._name = name

    # -- learning rate ----------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[id(program)] = self._learning_rate
            return
        if id(program) in self._learning_rate_map:
            return
        helper = LayerHelper("learning_rate")
        lr = helper.create_global_variable(
            name=unique_name.generate("learning_rate"),
            dtype="float32",
            shape=(1,),
            persistable=True,
        )
        helper.set_variable_initializer(lr, ConstantInitializer(float(self._learning_rate)))
        self._learning_rate_map[id(program)] = lr

    def _global_learning_rate(self, program=None) -> Variable:
        if program is None:
            program = default_main_program()
        return self._learning_rate_map[id(program)]

    def _create_param_lr(self, param_and_grad) -> Variable:
        param = param_and_grad[0]
        param_lr = (param.optimize_attr or {}).get("learning_rate", 1.0)
        if isinstance(param_lr, Variable):
            # append_LARS-style schedulers store a per-param lr VARIABLE
            # (already scaled from the global lr)
            return param_lr
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        block = param.block.program.global_block()
        out = block.create_var(
            name=unique_name.generate(param.name + ".lr"), dtype=base.dtype, shape=base.shape
        )
        block.append_op(
            type="scale",
            inputs={"X": [base]},
            outputs={"Out": [out]},
            attrs={"scale": float(param_lr)},
        )
        return out

    # -- accumulators -----------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0, shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper(name)
        var = helper.create_global_variable(
            name=unique_name.generate("%s_%s_acc" % (param.name, name)),
            dtype=dtype or param.dtype,
            shape=tuple(shape if shape is not None else param.shape),
            persistable=True,
        )
        helper.set_variable_initializer(var, ConstantInitializer(float(fill_value)))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- main entry points ------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads, self.regularization)
        block = default_main_program().global_block()
        self._create_global_learning_rate()
        self._create_accumulators(block, [p for p, _ in params_grads])
        optimize_ops = []
        for param_and_grad in params_grads:
            if param_and_grad[1] is None:
                continue
            optimize_ops.append(self._append_optimize_op(block, param_and_grad))
        self._finish_update(block)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            type="adam",
            inputs={
                "Param": [p],
                "Grad": [g],
                "Moment1": [m1],
                "Moment2": [m2],
                "Beta1Pow": [b1p],
                "Beta2Pow": [b2p],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [p],
                "Moment1Out": [m1],
                "Moment2Out": [m2],
                "Beta1PowOut": [b1p],
                "Beta2PowOut": [b2p],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
        )


# short alias matching `fluid.optimizer.*`
Adam = AdamOptimizer
