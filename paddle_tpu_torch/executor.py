"""Executor: runs a Program on a place (counterpart of
paddle_tpu/executor.py; reference: paddle/fluid/framework/executor.cc).

``Executor(place).run(program, feed, fetch_list)`` feeds the named
variables (cast to their declared dtypes; int64 stays int64), reads the
persistable variables the program touches from the scope, runs the block
eagerly through the interpreter (forward, ``autodiff`` and the optimizer
ops of a training program), writes the persistable results back into the
scope, detached, and returns the fetched values, ``@GRAD`` variables
included.

Unlike the JAX package, whose Executor defaults to ``CPUPlace()``, no
place means ``CUDAPlace(0)``: the card, and an error where there is none.

Each program has its own step counter, folded into its random stream, so
running the startup program does not move the main program's stream.

Not ported: the optimizing transpiler (an ``opt_level`` other than 0),
``run_loop`` and reader ops raise NotImplementedError; feed bucketizing,
the compile caches and NaN checks have no parameter here.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .framework.core import Program, Variable, default_main_program
from .framework.dtypes import as_torch_dtype
from .framework.interpreter import RngStream, run_block
from .framework.scope import CUDAPlace, Place, Scope, global_scope

__all__ = ["Executor", "analyze_state"]


def analyze_state(program: Program, feed_names):
    """Persistable vars read (state inputs) and written (state outputs)
    by the program's ops (the JAX package's executor.analyze_state)."""
    read, written = [], []
    seen_r, seen_w = set(), set()
    for block in program.blocks:
        for op in block.ops:
            for name in op.input_arg_names:
                var = block._find_var_recursive(name)
                if var is not None and var.persistable and name not in seen_r and name not in feed_names:
                    seen_r.add(name)
                    read.append(name)
            for name in op.output_arg_names:
                var = block._find_var_recursive(name)
                if var is not None and var.persistable and name not in seen_w:
                    seen_w.add(name)
                    written.append(name)
    return read, written


def _fetch_name(f) -> str:
    return f.name if isinstance(f, Variable) else str(f)


def _as_feed_tensor(value, var: Optional[Variable], device: torch.device):
    """A feed on ``device``, cast to its variable's declared dtype when the
    program declares it (the JAX package's _as_feed_array)."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value, copy=True))
    if var is not None:
        value = value.to(as_torch_dtype(var.dtype))
    return value.to(device)


class Executor:
    def __init__(self, place: Optional[Place] = None,
                 opt_level: Optional[int] = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()
        if opt_level:
            raise NotImplementedError(
                "the optimizing transpiler (opt_level %r) is a later slice of "
                "the port" % (opt_level,))
        self._seed = 0
        # per-PROGRAM step counters, the random stream's step (weak keys: a
        # dead program's counter must not pass to a new one at its address)
        self._steps = weakref.WeakKeyDictionary()

    def program_steps(self, program: Program) -> int:
        """Steps run on ``program``'s own stream."""
        return self._steps.get(program, 0)

    def _next_step(self, program: Program) -> int:
        cur = self._steps.get(program, 0)
        self._steps[program] = cur + 1
        return cur

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ) -> List:
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        feed = feed or {}
        fetch_names = [_fetch_name(f) for f in (fetch_list or [])]
        gb = program.global_block()
        if any(op.type == "read" for b in program.blocks for op in b.ops):
            raise NotImplementedError(
                "reader ops are a later slice of the port: feed the batch")

        env: Dict = {}
        state_in, state_out = analyze_state(program, set(feed))
        for name in state_in:
            val = scope.find_var(name)
            if val is None:
                raise RuntimeError(
                    "persistable variable %r has no value in scope; run the "
                    "startup program first" % name)
            env[name] = val
        for name, value in feed.items():
            var = gb.vars.get(name)
            env[name] = _as_feed_tensor(value, var, self.device)

        seed = program.random_seed if program.random_seed else self._seed
        run_block(gb, env, self.device,
                  RngStream(seed, self._next_step(program)))

        for name in dict.fromkeys(state_in + state_out):
            if name in env:
                scope.set_var(name, env[name].detach())
        fetches = []
        for name in fetch_names:
            if name not in env:
                raise KeyError(
                    "fetch target %r was not produced by the program" % name)
            val = env[name]
            if isinstance(val, torch.Tensor):
                val = val.detach()
                if return_numpy:
                    val = val.cpu().numpy()
            fetches.append(val)
        return fetches

    def run_loop(self, *args, **kwargs):
        raise NotImplementedError(
            "run_loop is a later slice of the port: call run() per step")
