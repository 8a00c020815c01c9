"""append_backward (reference: python/paddle/fluid/backward.py); a copy of
paddle_tpu/backward.py, which the port keeps so that it never imports the
JAX package.

The reference walks the forward ops in reverse, asking each op's
GradOpMaker to emit grad ops (hundreds of hand-written grad kernels). Here
backward is one symbolic ``autodiff`` op: the interpreter runs the forward
prefix of the block under autograd and asks ``torch.autograd.grad`` for the
gradients (framework/interpreter.py:run_block), so PyTorch differentiates
the whole graph at once. ``X@GRAD`` variables are
still materialized, so downstream API (grad clipping, weight decay,
optimizer ops, debugging fetches of gradients) sees the same names the
reference would produce.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .framework.core import Parameter, Program, Variable, grad_var_name

__all__ = ["append_backward"]


def append_backward(
    loss: Variable,
    parameter_list: Optional[List[str]] = None,
    no_grad_set=None,
    callbacks=None,
) -> List[Tuple[Parameter, Variable]]:
    program: Program = loss.block.program
    block = program.global_block()

    if parameter_list is not None:
        params = [block.var(n) if isinstance(n, str) else n for n in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    no_grad = {v.name if isinstance(v, Variable) else v for v in (no_grad_set or set())}
    params = [p for p in params if p.name not in no_grad]
    if not params:
        raise ValueError("no trainable parameters to differentiate")

    grad_vars = []
    for p in params:
        g = block.create_var(
            name=grad_var_name(p.name),
            shape=p.shape,
            dtype=p.dtype,
            persistable=False,
            stop_gradient=True,
        )
        grad_vars.append(g)

    block.append_op(
        type="autodiff",
        inputs={"Loss": [loss]},
        outputs={"Grads": [g.name for g in grad_vars]},
        attrs={
            "loss_name": loss.name,
            "param_names": [p.name for p in params],
        },
    )
    return list(zip(params, grad_vars))
