"""Parameter initializers (reference: python/paddle/fluid/initializer.py).

Each initializer appends an init op (fill_constant / uniform_random /
gaussian_random) to the startup program, exactly as the JAX package's
initializers do, so both packages build the same startup program. The
random init ops' kernels are ops/nn.py's ``gaussian_random`` and
``uniform_random`` (drawn from torch generators: the statistics are the
JAX package's, the bits are not).
"""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "Initializer",
    "ConstantInitializer",
    "UniformInitializer",
    "NormalInitializer",
    "XavierInitializer",
]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(var):
        shape = var.shape
        if len(shape) < 2:
            return (shape[0] if shape else 1,) * 2
        fan_in = shape[1] * int(np.prod(shape[2:])) if len(shape) > 2 else shape[1]
        fan_out = shape[0] * int(np.prod(shape[2:])) if len(shape) > 2 else shape[0]
        # note: for fc weights (in, out) paddle uses shape[0]=in as fan_in
        if len(shape) == 2:
            fan_in, fan_out = shape[0], shape[1]
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            "fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "value": float(self.value)},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            "uniform_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": float(self.low),
                "max": float(self.high),
                "seed": self.seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
            },
        )


class XavierInitializer(Initializer):
    """Glorot init (reference: initializer.py:XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = self._fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fi + fo))
        return NormalInitializer(0.0, std, self.seed)(var, block)

