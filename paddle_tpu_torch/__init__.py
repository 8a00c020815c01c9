"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The same Fluid-style Program/Block/Operator IR and ``layers.*`` builders as
the JAX package, run eagerly over torch tensors by framework/interpreter.py.
Every TPU (Pallas) kernel on a ported path has a hand-written CUDA twin for
Hopper under csrc/, built on first use (kernels/_build.py). This package
imports torch and numpy, never jax and never paddle_tpu.

Ported so far: serving the decoder LM (serving/decode.py) through the
flash-attention prefill kernel (K1) and the decode-attention kernel (K3),
and training it (``Executor.run`` of a program built with
``optimizer.Adam(...).minimize``) through K1 and the flash-attention
backward kernels (K2, or K4 with ``PADDLE_TPU_FLASH_FUSED_BWD=1``).
"""
from . import (backward, clip, framework, initializer, io, layers,
               optimizer, regularizer)
from .backward import append_backward
from .executor import Executor
from .framework import (
    CPUPlace,
    CUDAPlace,
    Program,
    Scope,
    default_main_program,
    default_startup_program,
    global_scope,
    program_guard,
    scope_guard,
    unique_name,
)
from .param_attr import ParamAttr

__all__ = [
    "CPUPlace", "CUDAPlace", "Executor", "ParamAttr", "Program", "Scope",
    "append_backward", "backward", "clip", "default_main_program",
    "default_startup_program", "framework", "global_scope", "initializer",
    "io", "layers", "optimizer", "program_guard", "regularizer",
    "scope_guard", "unique_name",
]
