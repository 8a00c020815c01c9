"""Weight-decay regularizers (reference: python/paddle/fluid/regularizer.py).

A copy of paddle_tpu/regularizer.py, which the port keeps so that it never
imports the JAX package. append_regularization_ops rewrites each (param,
grad) pair to grad = grad + penalty_grad, exactly like the reference: L2
appends scale and elementwise_add, L1 sign, scale and elementwise_add
(kernels: ops/math.py), in fp32 under bf16 AMP O2 (their outputs are
@GRAD variables).
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer", "append_regularization_ops"]


class WeightDecayRegularizer:
    def append_ops(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_ops(self, param, grad, block):
        decay = block.create_var(
            name=grad.name + ".l2decay", dtype=param.dtype, shape=param.shape
        )
        block.append_op(
            type="scale",
            inputs={"X": [param]},
            outputs={"Out": [decay]},
            attrs={"scale": self._coeff},
        )
        new_grad = block.create_var(
            name=grad.name + ".reg", dtype=param.dtype, shape=param.shape
        )
        block.append_op(
            type="elementwise_add",
            inputs={"X": [grad], "Y": [decay]},
            outputs={"Out": [new_grad]},
            attrs={"axis": -1},
        )
        return new_grad


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_ops(self, param, grad, block):
        sign = block.create_var(name=grad.name + ".sign", dtype=param.dtype, shape=param.shape)
        block.append_op(type="sign", inputs={"X": [param]}, outputs={"Out": [sign]})
        decay = block.create_var(name=grad.name + ".l1decay", dtype=param.dtype, shape=param.shape)
        block.append_op(
            type="scale",
            inputs={"X": [sign]},
            outputs={"Out": [decay]},
            attrs={"scale": self._coeff},
        )
        new_grad = block.create_var(name=grad.name + ".reg", dtype=param.dtype, shape=param.shape)
        block.append_op(
            type="elementwise_add",
            inputs={"X": [grad], "Y": [decay]},
            outputs={"Out": [new_grad]},
            attrs={"axis": -1},
        )
        return new_grad


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(parameters_and_grads, regularization=None):
    params_and_grads = []
    for param, grad in parameters_and_grads:
        regularization_term = None
        if getattr(param, "regularizer", None) is not None:
            regularization_term = param.regularizer
        elif regularization is not None:
            regularization_term = regularization
        if grad is None or regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        new_grad = regularization_term.append_ops(param, grad, grad.block.program.global_block())
        params_and_grads.append((param, new_grad))
    return params_and_grads
