"""Optimizers (reference: python/paddle/fluid/optimizer.py); the port's copy
of paddle_tpu/optimizer.py: every optimizer class, its alias, and
``ModelAverage``.

`minimize(loss)` appends backward (one symbolic autodiff op), regularization
/ clipping ops, then one optimizer op per parameter, with accumulators
created as persistable vars initialized in the startup program. The op
descs, names and startup initializers are the JAX package's, so both
packages build the same programs; the ops' kernels are ops/optim.py's.

``ModelAverage.apply``/``restore`` differ in how they touch the scope: the
JAX package rebinds each parameter to a numpy array; here a parameter's
scope tensor is a captured step's own state buffer, so the averages are
written into it in place (``copy_``) and the values are restored in place,
and the next step (a replay too) reads what is there.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import torch

from .backward import append_backward
from .clip import append_gradient_clip_ops
from .framework.core import Variable, default_main_program
from .framework import unique_name
from .framework.scope import global_scope
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = [
    "SGD",
    "Momentum",
    "Adagrad",
    "Adam",
    "Adamax",
    "DecayedAdagrad",
    "Adadelta",
    "RMSProp",
    "Ftrl",
    "SGDOptimizer",
    "MomentumOptimizer",
    "AdagradOptimizer",
    "AdamOptimizer",
    "AdamaxOptimizer",
    "DecayedAdagradOptimizer",
    "AdadeltaOptimizer",
    "RMSPropOptimizer",
    "FtrlOptimizer",
    "Optimizer",
    "ModelAverage",
]


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


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g], "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p]},
        )


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={
                "Param": [p],
                "Grad": [g],
                "Velocity": [velocity],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [p], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={
                "Param": [p],
                "Grad": [g],
                "Moment": [moment],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [p], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon},
        )


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


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="adamax",
            inputs={
                "Param": [p],
                "Grad": [g],
                "Moment": [self._get_accumulator("moment", p)],
                "InfNorm": [self._get_accumulator("inf_norm", p)],
                "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [p],
                "MomentOut": [self._get_accumulator("moment", p)],
                "InfNormOut": [self._get_accumulator("inf_norm", p)],
                "Beta1PowOut": [self._get_accumulator("beta1_pow_acc", p)],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
        )


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={
                "Param": [p],
                "Grad": [g],
                "Moment": [moment],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [p], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("__avg_squared_grad", p)
        asu = self._get_accumulator("__avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [asg], "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [asg], "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
        )


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        return block.append_op(
            type="rmsprop",
            inputs={
                "Param": [p],
                "Grad": [g],
                "Moment": [mom],
                "MeanSquare": [ms],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [p], "MomentOut": [mom], "MeanSquareOut": [ms]},
            attrs={"epsilon": self._epsilon, "decay": self._rho, "momentum": self._momentum},
        )


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={
                "Param": [p],
                "Grad": [g],
                "SquaredAccumulator": [sq],
                "LinearAccumulator": [lin],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq], "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


class ModelAverage(Optimizer):
    """Running parameter average (reference optimizer.py:ModelAverage).

    Accumulates sum of params each step; apply()/restore() swap the averaged
    values in and out of the parameter variables.
    """

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = []
        self._sum_vars = {}
        self._cnt_var = None
        program = default_main_program()
        block = program.global_block()
        helper = LayerHelper("model_average")
        self._cnt_var = helper.create_global_variable(
            name=unique_name.generate("ma_cnt"), dtype="float32", shape=(1,), persistable=True
        )
        helper.set_variable_initializer(self._cnt_var, ConstantInitializer(0.0))
        block.append_op(
            type="increment",
            inputs={"X": [self._cnt_var]},
            outputs={"Out": [self._cnt_var]},
            attrs={"step": 1.0},
        )
        for param in program.all_parameters():
            if not param.trainable:
                continue
            helper2 = LayerHelper("model_average")
            s = helper2.create_global_variable(
                name=unique_name.generate(param.name + ".ma_sum"),
                dtype=param.dtype,
                shape=param.shape,
                persistable=True,
            )
            helper2.set_variable_initializer(s, ConstantInitializer(0.0))
            self._sum_vars[param.name] = s
            block.append_op(
                type="elementwise_add",
                inputs={"X": [s], "Y": [param]},
                outputs={"Out": [s]},
                attrs={"axis": -1},
            )

    def apply(self, executor, need_restore=True):
        """Write each parameter's average, sum / max(count, 1), into its
        scope tensor in place (the tensor a captured step reads); with
        ``need_restore``, keep copies of the values for ``restore``."""
        scope = global_scope()
        self._backup = {}
        cnt = float(scope.find_var(self._cnt_var.name).reshape(()))
        with torch.no_grad():
            for pname, svar in self._sum_vars.items():
                cur = scope.find_var(pname)
                if need_restore:
                    self._backup[pname] = cur.clone()
                avg = scope.find_var(svar.name) / max(cnt, 1.0)
                cur.copy_(avg.to(cur.dtype))

    def restore(self, executor):
        """Copy the values ``apply`` replaced back into the parameters'
        scope tensors, in place."""
        scope = global_scope()
        with torch.no_grad():
            for pname, val in getattr(self, "_backup", {}).items():
                scope.find_var(pname).copy_(val)
        self._backup = {}


# short aliases matching `fluid.optimizer.*`
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
