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
run under ``torch.no_grad()``. Mixed precision is a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

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


def run_op(op: Operator, block: Block, env: Dict, device: torch.device,
           rng_fn: Callable[[], torch.Generator]):
    """Run one op's kernel on ``env``'s tensors; its outputs land in
    ``env``. ``rng_fn`` makes the op's random generators. A
    non-persistable output whose variable has ``stop_gradient`` is
    detached (the JAX package's stop_gradient)."""
    kernel = get_kernel(op.type)
    ctx = OpContext(op, _EnvView(env, op), block, device, rng_fn)
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


def run_block(block: Block, env: Dict, device: torch.device,
              rng: Optional[RngStream] = None) -> Dict:
    """Run every op of ``block`` in order on ``env`` (mutated in place and
    returned); ``device`` is where ops that make tensors from attrs put
    them, ``rng`` the program's random stream for this step (seed 0, step
    0 when not given)."""
    if getattr(block.program, "_amp", False):
        raise NotImplementedError(
            "mixed precision (bf16 AMP O1/O2) is a later slice of the port")
    rng = rng if rng is not None else RngStream()
    ops = [(i, op) for i, op in enumerate(block.ops)
           if op.type not in _SKIP_OPS]
    first_ad = next((n for n, (_, op) in enumerate(ops)
                     if op.type == "autodiff"), None)

    def run(i, op):
        run_op(op, block, env, device,
               rng.for_op(block.idx, op.attrs.get(_RNG_IDX_ATTR, i), device))

    if first_ad is None:
        for i, op in ops:
            run(i, op)
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
