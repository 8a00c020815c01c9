"""Gradient & error clipping (reference: python/paddle/fluid/clip.py); a copy
of paddle_tpu/clip.py, which the port keeps so that it never imports the
JAX package. It appends ops to a Program: clip (GradientClipByValue),
clip_by_norm (GradientClipByNorm), and square, reduce_sum, sum, sqrt,
fill_constant, elementwise_max, elementwise_div and elementwise_mul
(GradientClipByGlobalNorm), whose kernels are ops/math.py's. They read
@GRAD inputs, so under bf16 AMP O2 they stay in fp32 (the interpreter's
``_o2_eligible``). ErrorClipByValue holds its bounds and appends
nothing, as in the JAX package."""
from __future__ import annotations

from .framework.core import Variable

__all__ = [
    "ErrorClipByValue",
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "set_gradient_clip",
    "append_gradient_clip_ops",
]


class BaseErrorClipAttr:
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        if min is None:
            min = -max
        self.max, self.min = max, min


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        if min is None:
            min = -max
        self.max, self.min = float(max), float(min)

    def _create_operators(self, param, grad):
        block = grad.block.program.global_block()
        out = block.create_var(name=grad.name + ".clip", dtype=grad.dtype, shape=grad.shape)
        block.append_op(
            type="clip",
            inputs={"X": [grad]},
            outputs={"Out": [out]},
            attrs={"min": self.min, "max": self.max},
        )
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        block = grad.block.program.global_block()
        out = block.create_var(name=grad.name + ".clip", dtype=grad.dtype, shape=grad.shape)
        block.append_op(
            type="clip_by_norm",
            inputs={"X": [grad]},
            outputs={"Out": [out]},
            attrs={"max_norm": self.clip_norm},
        )
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scales all gradients by clip_norm/max(global_norm, clip_norm)
    (reference clip.py:GradientClipByGlobalNorm). Per-program state: one
    instance may be attached to the parameters of several programs, so
    sq-sums and the scale var are keyed by program."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)
        self._sq_sums = {}  # id(program) -> [vars]
        self._scale_vars = {}  # id(program) -> var

    def _process_context(self, context, param, grad):
        from .framework import unique_name

        program = grad.block.program
        block = program.global_block()
        sq = block.create_var(
            name=unique_name.generate(grad.name + ".sqsum"), dtype=grad.dtype, shape=()
        )
        sqv = block.create_var(
            name=unique_name.generate(grad.name + ".sq"), dtype=grad.dtype, shape=grad.shape
        )
        block.append_op(type="square", inputs={"X": [grad]}, outputs={"Out": [sqv]})
        block.append_op(
            type="reduce_sum",
            inputs={"X": [sqv]},
            outputs={"Out": [sq]},
            attrs={"reduce_all": True, "keep_dim": False},
        )
        self._sq_sums.setdefault(id(program), []).append(sq)

    def _global_scale(self, block):
        from .framework import unique_name

        pid = id(block.program)
        if pid not in self._scale_vars:
            def mk(suffix):
                return block.create_var(
                    name=unique_name.generate("gclip." + suffix), dtype="float32", shape=()
                )

            total = mk("total")
            block.append_op(
                type="sum", inputs={"X": self._sq_sums[pid]}, outputs={"Out": [total]}
            )
            gnorm = mk("gnorm")
            block.append_op(type="sqrt", inputs={"X": [total]}, outputs={"Out": [gnorm]})
            clipv = mk("maxnorm")
            block.append_op(
                type="fill_constant",
                outputs={"Out": [clipv]},
                attrs={"shape": [], "dtype": "float32", "value": self.clip_norm},
            )
            denom = mk("denom")
            block.append_op(
                type="elementwise_max",
                inputs={"X": [gnorm], "Y": [clipv]},
                outputs={"Out": [denom]},
                attrs={"axis": -1},
            )
            scale = mk("scale")
            block.append_op(
                type="elementwise_div",
                inputs={"X": [clipv], "Y": [denom]},
                outputs={"Out": [scale]},
                attrs={"axis": -1},
            )
            self._scale_vars[pid] = scale
        return self._scale_vars[pid]

    def _create_operators(self, param, grad):
        block = grad.block.program.global_block()
        scale = self._global_scale(block)
        out = block.create_var(name=grad.name + ".clip", dtype=grad.dtype, shape=grad.shape)
        block.append_op(
            type="elementwise_mul",
            inputs={"X": [grad], "Y": [scale]},
            outputs={"Out": [out]},
            attrs={"axis": -1},
        )
        return param, out


def set_gradient_clip(clip, param_list=None, program=None):
    """Attach `clip` to parameters (reference clip.py:set_gradient_clip):
    with no param_list, every parameter of `program` (default main) gets
    it. Program-scoped like the reference — earlier versions stored a
    process-global default that silently leaked into every later
    program."""
    from .framework.core import default_main_program

    program = program or default_main_program()
    if param_list is None:
        param_list = program.all_parameters()
    for p in param_list:
        if not isinstance(p, Variable):
            p = program.global_block().var(p)
        p.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    clip_attrs = {}
    context = {}
    result = []
    for p, g in param_grads:
        clip = getattr(p, "gradient_clip_attr", None)
        if clip is None:
            result.append((p, g))
            continue
        clip_attrs[(p.name)] = clip
        clip._process_context(context, p, g)
    for p, g in param_grads:
        clip = clip_attrs.get(p.name)
        if clip is None:
            continue
        result.append(clip._create_operators(p, g))
    return result
