"""Eager block interpreter: runs a Program Block op by op over torch tensors.

Counterpart of paddle_tpu/framework/trace.py (``trace_op`` /
``trace_block``), which traces a whole Block into one XLA computation.
PyTorch runs eagerly, so here each op's kernel runs as it is reached and
its outputs land in ``env``; the hand-written CUDA kernels launch from
inside their ops (ops/attention.py, ops/kv_cache.py).

Training: the ``autodiff`` op (backward.append_backward) takes the place
of the reference's ``jax.vjp`` over the forward prefix. The ops before the
first ``autodiff`` run once, with the parameters it names as fresh leaves
that require grad, so autograd records the forward; each ``autodiff`` then
asks ``torch.autograd.grad`` for the gradients of its loss with respect to
its parameters at the block's entry values, and binds them as
``<param>@GRAD``. The ops after the first ``autodiff`` (the optimizer's)
run under ``torch.no_grad()``.

Mixed precision (``Program.enable_mixed_precision``): as the reference's
``trace_op`` does, each op of an AMP program reads its float inputs through
a cast view, in bf16 for the matmul class (``_AMP_BF16_OPS``; under O2 also
the elementwise path, ``_AMP_BF16_O2_OPS``, where ``_o2_eligible``) and in
fp32 for the ops pinned to it (``_AMP_FP32_OPS``). The parameters and the
optimizer state stay fp32: a cast is an op that autograd records, so the
gradient of an fp32 parameter read in bf16 comes back fp32, and the ops
after ``autodiff`` read ``@GRAD`` inputs, which ``_o2_eligible`` keeps in
fp32.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import ops as _ops  # noqa: F401  (registers every kernel)
from ..ops.registry import OpContext, get_kernel
from .core import Block, Operator, grad_var_name

# feed/fetch (present in reference-style serialized programs) are no-ops:
# the caller feeds and fetches directly; `read` ops are a later slice
_SKIP_OPS = {"feed", "fetch", "read"}

# the optimizing transpiler's stamp of an op's pre-rewrite position, which
# keys its random stream when present (as in the JAX package's trace.py)
_RNG_IDX_ATTR = "__rng_idx__"

_MASK64 = (1 << 64) - 1


def _mix(*vals: int) -> int:
    """A 63-bit seed from a tuple of integers (splitmix64 steps), so that
    neighbouring ops, draws and steps get unrelated generators."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h = (h ^ (int(v) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


class RngStream:
    """Deterministic random stream keyed on (seed, step, block, op
    position, draw number), the counterpart of the JAX package's
    ``RngStream``: the same program, seed and step give the same bits, and
    adding ops elsewhere does not move another op's stream. The bits are
    torch's, not JAX's."""

    def __init__(self, seed: int = 0, step: int = 0):
        self.seed = int(seed)
        self.step = int(step)

    def for_op(self, block_idx: int, op_idx: int,
               device: torch.device) -> Callable[[], torch.Generator]:
        draws = [0]

        def next_generator():
            gen = torch.Generator(device=device)
            gen.manual_seed(_mix(self.seed, self.step, block_idx, op_idx,
                                 draws[0]))
            draws[0] += 1
            return gen

        return next_generator


class TraceError(RuntimeError):
    """Carries the failing op's context — its type, input shapes and attrs
    — mirroring the reference's enforce messages (same name as the JAX
    package's error)."""


# The AMP op sets, a copy of the reference's (paddle_tpu/framework/
# trace.py; a test holds them equal). bf16 shares fp32's exponent range, so
# no loss scaling is needed.
_AMP_BF16_OPS = {
    "mul", "matmul", "conv2d", "conv3d", "conv2d_transpose",
    "conv3d_transpose", "sequence_conv", "fused_attention",
    "fused_lm_head_loss", "fused_fc",
}
_AMP_FP32_OPS = {
    "softmax_with_cross_entropy", "cross_entropy", "layer_norm",
    "softmax", "sequence_softmax", "reduce_mean",
    "reduce_sum", "mean", "exp", "log", "linear_chain_crf", "warpctc",
    "nce", "hierarchical_sigmoid", "l2_normalize",
}
# O2: the elementwise path joins the bf16 set, so activations stay bf16
# between products; layer_norm moves from the fp32 pin to bf16 in and out
# (its kernel keeps its statistics in fp32)
_AMP_BF16_O2_OPS = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "relu", "tanh", "sigmoid", "swish", "leaky_relu", "relu6",
    "brelu", "dropout", "lookup_table", "layer_norm",
}


def _is_grad_name(name: str) -> bool:
    return name.endswith("@GRAD") or "@GRAD@" in name


def _o2_eligible(op: Operator, block: Block) -> bool:
    """True when an _AMP_BF16_O2_OPS instance sits on the activation
    stream: no @GRAD input or output (gradient math stays fp32) and no
    persistable output (optimizer state stays fp32)."""
    if any(_is_grad_name(n) for n in op.input_arg_names):
        return False
    for name in op.output_arg_names:
        if _is_grad_name(name):
            return False
        var = block._find_var_recursive(name)
        if var is not None and var.persistable:
            return False
    return True


def amp_dtype(op: Operator, block: Block) -> Optional[torch.dtype]:
    """The dtype an op of an AMP program reads its float inputs in (bf16,
    fp32), or None for an op that reads them as they are."""
    program = block.program
    if not getattr(program, "_amp", False):
        return None
    o2 = getattr(program, "_amp_level", "O1") == "O2"
    if op.type in _AMP_BF16_OPS or (o2 and op.type in _AMP_BF16_O2_OPS
                                    and _o2_eligible(op, block)):
        return torch.bfloat16
    if op.type in _AMP_FP32_OPS:
        return torch.float32
    return None


class _EnvView(dict):
    """Env lookup that raises with op context for variables that were
    never produced."""

    def __init__(self, env, op):
        super().__init__()
        self._env = env
        self._op = op

    def __getitem__(self, name):
        if name in self._env:
            return self._env[name]
        raise KeyError(
            "variable %r (input of op %r) has no value: not a feed, not "
            "persistable state, and not produced by any earlier op"
            % (name, self._op.type))

    def __contains__(self, name):
        return name in self._env


class _CastEnvView(_EnvView):
    """Env view that casts float32 and bfloat16 inputs to the op's AMP
    dtype (other dtypes pass as they are)."""

    def __init__(self, env, op, dtype):
        super().__init__(env, op)
        self._amp_dtype = dtype

    def __getitem__(self, name):
        v = super().__getitem__(name)
        dt = getattr(v, "dtype", None)
        if dt in (torch.float32, torch.bfloat16) and dt != self._amp_dtype:
            return v.to(self._amp_dtype)
        return v


def run_op(op: Operator, block: Block, env: Dict, device: torch.device,
           rng_fn: Callable[[], torch.Generator]):
    """Run one op's kernel on ``env``'s tensors; its outputs land in
    ``env``. ``rng_fn`` makes the op's random generators. A
    non-persistable output whose variable has ``stop_gradient`` is
    detached (the JAX package's stop_gradient)."""
    kernel = get_kernel(op.type)
    dtype = amp_dtype(op, block)
    view = (_EnvView(env, op) if dtype is None
            else _CastEnvView(env, op, dtype))
    ctx = OpContext(op, view, block, device, rng_fn)
    try:
        result = kernel(ctx)
    except NotImplementedError:
        raise
    except Exception as e:
        in_shapes = {
            slot: [tuple(getattr(env.get(n), "shape", ())) if n in env
                   else None for n in names]
            for slot, names in op.inputs.items()
        }
        raise TraceError(
            "error while running op %r (inputs %s, attrs %s): %s"
            % (op.type, in_shapes, op.attrs, e)) from e
    for slot, names in op.outputs.items():
        if slot not in result:
            continue
        vals = result[slot]
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for name, val in zip(names, vals):
            if isinstance(val, torch.Tensor) and val.requires_grad:
                var = block._find_var_recursive(name)
                if var is not None and var.stop_gradient and \
                        not var.persistable:
                    val = val.detach()
            env[name] = val


def _drops(ops, keep) -> Dict[int, List[str]]:
    """{position in ``ops``: the names no later op reads or writes}, less
    ``keep``."""
    last = {}
    for n, (_, op) in enumerate(ops):
        for name in op.input_arg_names + op.output_arg_names:
            last[name] = n
    drops: Dict[int, List[str]] = {}
    for name, n in last.items():
        if name not in keep:
            drops.setdefault(n, []).append(name)
    return drops


def run_block(block: Block, env: Dict, device: torch.device,
              rng: Optional[RngStream] = None,
              keep: Optional[Sequence[str]] = None) -> Dict:
    """Run every op of ``block`` in order on ``env`` (mutated in place and
    returned); ``device`` is where ops that make tensors from attrs put
    them, ``rng`` the program's random stream for this step (seed 0, step
    0 when not given). With ``keep``, a block without ``autodiff`` drops
    each other variable from ``env`` after the last op that reads or
    writes it, so its memory is reused while the block runs (a captured
    CUDA graph's pool then holds what is live at once, not every
    intermediate)."""
    rng = rng if rng is not None else RngStream()
    ops = [(i, op) for i, op in enumerate(block.ops)
           if op.type not in _SKIP_OPS]
    first_ad = next((n for n, (_, op) in enumerate(ops)
                     if op.type == "autodiff"), None)

    def run(i, op):
        run_op(op, block, env, device,
               rng.for_op(block.idx, op.attrs.get(_RNG_IDX_ATTR, i), device))

    if first_ad is None:
        drops = _drops(ops, set(keep)) if keep is not None else {}
        for n, (i, op) in enumerate(ops):
            run(i, op)
            for name in drops.get(n, ()):
                env.pop(name, None)
        return env

    # -- training: the forward prefix once, under autograd ----------------
    ad_ops = [op for _, op in ops[first_ad:] if op.type == "autodiff"]
    param_names: List[str] = list(dict.fromkeys(
        n for op in ad_ops for n in op.attr("param_names")))
    leaves = {}
    for name in param_names:
        if name not in env:
            raise TraceError("parameter %r has no value in scope — run the "
                             "startup program first" % name)
        leaves[name] = env[name] = env[name].detach().requires_grad_(True)
    produced = set()
    with torch.enable_grad():
        for i, op in ops[:first_ad]:
            run(i, op)
            produced.update(op.output_arg_names)

    # -- the autodiff ops and everything after them -------------------------
    n_ad = len(ad_ops)
    for i, op in ops[first_ad:]:
        if op.type != "autodiff":
            with torch.no_grad():
                run(i, op)
            continue
        n_ad -= 1
        loss_name = op.attr("loss_name")
        loss = env.get(loss_name)
        if loss_name not in produced or loss is None or \
                not loss.requires_grad:
            raise TraceError(
                "loss %r is not computed by the forward ops preceding the "
                "first backward pass; differentiating a loss built between "
                "two minimize() calls is unsupported" % loss_name)
        names = list(op.attr("param_names"))
        # gradients at the block's entry values: the optimizer ops of an
        # earlier autodiff made new tensors and left these leaves alone
        grads = torch.autograd.grad(loss.sum(), [leaves[n] for n in names],
                                    retain_graph=n_ad > 0, allow_unused=True)
        for name, g in zip(names, grads):
            env[grad_var_name(name)] = (g if g is not None
                                        else torch.zeros_like(leaves[name]))
    return env
