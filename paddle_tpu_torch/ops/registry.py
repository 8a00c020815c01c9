"""Operator kernel registry (counterpart of paddle_tpu/ops/registry.py).

The reference registers per-device C++ kernels through OpKernelType and a
global OpInfoMap (reference: paddle/fluid/framework/op_registry.h). Here
every op has ONE implementation: a function from torch tensors to torch
tensors, which the eager interpreter (framework/interpreter.py) calls op by
op. A kernel works on whatever device its inputs lie on; where an op has a
hand-written CUDA kernel (fused_attention, decode_attention), its wrapper
launches it for CUDA tensors and runs the plain PyTorch version only for
CPU tensors.

Kernel signature::

    @register_op("relu")
    def relu(ctx):
        return {"Out": torch.relu(ctx.input("X"))}
"""
from __future__ import annotations

import difflib
from typing import Callable, Dict

KERNELS: Dict[str, Callable] = {}


def register_op(op_type: str):
    def deco(fn):
        if op_type in KERNELS:
            raise ValueError("duplicate kernel for op %r" % op_type)
        KERNELS[op_type] = fn
        return fn

    return deco


def get_kernel(op_type: str) -> Callable:
    if op_type not in KERNELS:
        near = difflib.get_close_matches(op_type, KERNELS, n=1)
        raise NotImplementedError(
            "no kernel registered for op %r in paddle_tpu_torch "
            "(registered: %d ops)%s"
            % (op_type, len(KERNELS),
               "; did you mean %r?" % near[0] if near else ""))
    return KERNELS[op_type]


class OpContext:
    """Per-op view handed to a kernel by the interpreter. ``device`` is
    where the program runs: ops that make tensors from attrs
    (assign_value, fill_constant, gaussian_random) put them there.
    ``rng_fn`` makes the op's random generators (framework/interpreter.py
    RngStream.for_op)."""

    def __init__(self, op, env, block, device, rng_fn):
        self._op = op
        self._env = env
        self._block = block
        self.device = device
        self._rng_fn = rng_fn

    @property
    def op(self):
        """The Operator this context runs."""
        return self._op

    # -- inputs ---------------------------------------------------------
    def input(self, slot: str, default=None):
        names = self._op.input(slot)
        if not names:
            return default
        return self._env[names[0]]

    def has_input(self, slot: str) -> bool:
        return bool(self._op.input(slot))

    # -- attrs / metadata ------------------------------------------------
    def attr(self, name: str, default=None):
        return self._op.attr(name, default)

    def out_var(self, slot: str, idx: int = 0):
        """Variable metadata (shape/dtype) for an output slot."""
        name = self._op.output(slot)[idx]
        return self._block.var(name)

    def out_dtype(self, slot: str = "Out"):
        from ..framework.dtypes import as_torch_dtype

        return as_torch_dtype(self.out_var(slot).dtype)

    # -- services --------------------------------------------------------
    def rng(self):
        """A fresh ``torch.Generator`` on the op's device for this draw
        (counterpart of the reference's ``OpContext.rng``, which hands out
        a jax PRNG key). Its seed derives from the program seed, the
        block, the op's position (or ``__rng_idx__`` stamp), the draw
        count and the program's step; the bits differ from JAX's."""
        return self._rng_fn()

    @property
    def is_test(self) -> bool:
        return bool(self._op.attr("is_test", False))
