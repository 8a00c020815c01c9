"""Executor: runs a Program on a place (counterpart of
paddle_tpu/executor.py; reference: paddle/fluid/framework/executor.cc).

``Executor(place).run(program, feed, fetch_list)`` feeds the named
variables (cast to their declared dtypes; int64 stays int64), reads the
persistable variables the program touches from the scope, runs the block
(forward, ``autodiff`` and the optimizer ops of a training program) and
returns the fetched values, ``@GRAD`` variables included. Unlike the JAX
package, whose Executor defaults to ``CPUPlace()``, no place means
``CUDAPlace(0)``: the card, and an error where there is none.

How a step runs. The JAX package jits the whole step once per (program,
feed signature, fetch list) and replays the executable. Here the step is
a ``serving.engine.GraphStep``, looked up through the program's Engine in
the executor's StepCache (``step_cache``, bounded to half the card's
memory, least recently used out first) by a key over the program's
content, the feed signature, the fetch order, the state signature and
the environment (``engine.env_fingerprint``). Its function runs the block
op by op, then copies every state output into its static state buffer.
On the card the first call runs that function twice on a side stream
without the copy (the warm-ups: every kernel built, no state moved),
captures one run into a CUDA graph and replays it; every later call
replays it, one launch for the whole step. On the CPU the function runs
op by op on the same buffers. A capture that fails raises, naming the
op, and so does every later call of that step: nothing falls back to
op-by-op execution on the card. ``use_program_cache=False`` builds (and
on the card captures) a step for the one call and drops it after.

State is updated in place (the port's counterpart of the JAX package's
donated state). A step's state buffers are the scope's own tensors where
they fit (on the step's device, contiguous, not requiring grad, not made
under inference mode; else tensors the step allocates), and after a call
the scope holds them. So a tensor read from the scope before a step
holds that step's result after it: clone what you keep. A value put into
the scope since the last step (``set_var``, a load) is copied into the
buffer by the next call. Fetches are copies and survive later steps.

The random-op rule. A program holding an op that draws random numbers
from a host-seeded generator (``ops.registry.RANDOM_OPS``:
``gaussian_random``, the initializers of startup programs) runs op by
op on every call, on the card too, with the same in-place state. Its
generators are seeded on the host from (seed, step, block, op, draw),
and a replayed graph would repeat the seeds of its capture step.
Startup programs run once, so the main path never pays for this. Ops
that may draw from a device key (``ops.registry.KEYED_OPS``: dropout and
fused_attention, ops/rng.py) keep the graph: such a step takes one
more feed, ``RNG_FEED``, the ``[seed, step]`` counter its graph reads,
written before each replay (``run_loop`` uploads one row per step and
copies it on the device), so each replay draws its own step's bits and
equals that step run op by op. Each program has its own step counter
(``program_steps``), folded into its random stream, so running the
startup program does not move the main program's stream; the seed is
``program.random_seed`` (0 when unset).

``run_loop(program, feed, fetch_list, steps)`` runs ``steps`` steps and
returns the last one's fetches, as ``steps`` calls of ``run`` would: the
same state after, the same step counter. It replays the step ``steps``
times with no host sync between the replays; feeds are loaded into the
step's buffers once, and ``per_step_feeds`` carry a leading ``steps``
axis, are uploaded once and copied slice by slice on the device before
each replay. Reader programs (``layers.py_reader`` ... ``read_file``)
need no feed: ``run`` pulls one batch per ``read`` op, ``run_loop`` a
window of up to ``steps``, which closes early at EOF (that window trains,
the next call raises ``EOFException``) or at a batch of another shape
(pushed back for the next call). Windows are double-buffered across
calls: after the replays of window N are queued, the next window is
pulled, stacked and uploaded on a side stream while the card works, and
a later call that cannot use it (other ``steps``, a changed program, a
``run``, a ``reset()``) gives its batches back untouched;
``PADDLE_TPU_READER_PREFETCH=0`` turns it off. A reader error met while
prefetching is raised by the call that would have used the window, with
its original traceback. A window of any length replays the step captured
for one batch, so window lengths need no capture of their own (the JAX
package compiles one loop per length).

Not ported: the optimizing transpiler (an ``opt_level`` other than 0
raises NotImplementedError); the NaN checks and compile-cache knobs have
no parameter here. ``run`` does not bucketize its feeds;
``inference.Predictor`` does, through the static helpers
``_check_feed_shapes``, ``_bucketize_feeds`` and ``_slice_bucketized``.
"""
from __future__ import annotations

import os
import time
import traceback
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .framework.core import Program, Variable, default_main_program
from .framework.dtypes import as_torch_dtype
from .framework.interpreter import RngStream, run_block
from .framework.scope import (CUDAPlace, Place, Scope, fp32_sums,
                              global_scope)
from .ops.registry import KEYED_OPS, RANDOM_OPS

__all__ = ["Executor", "analyze_state", "next_pow2", "RNG_FEED"]

# the step's random counter, [seed, step] int64: a feed of every step whose
# program holds an op that may draw from a device key (ops.registry.KEYED_OPS:
# dropout, fused_attention), which a captured graph reads, so that each
# replay draws that step's bits
RNG_FEED = "@RNG_COUNTER@"


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


def next_pow2(n: int) -> int:
    """The least power of two >= n (1 for n <= 1)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _fetch_name(f) -> str:
    return f.name if isinstance(f, Variable) else str(f)


def _shape(x):
    return tuple(getattr(x, "shape", np.shape(x)))


def _as_feed_tensor(value, var: Optional[Variable]):
    """A feed as a tensor, cast to its variable's declared dtype when the
    program declares it (the JAX package's _as_feed_array). A tensor stays
    where it is; a host array becomes a CPU tensor (the step stages it
    onto its device)."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    if var is not None:
        value = value.to(as_torch_dtype(var.dtype))
    return value


def _adoptable(val, device) -> bool:
    """Can the scope's tensor itself be a step's state buffer, updated in
    place?"""
    return (isinstance(val, torch.Tensor) and val.device == device
            and val.is_contiguous() and not val.requires_grad
            and not val.is_inference())


def _clone(v):
    return v.detach().clone() if isinstance(v, torch.Tensor) else v


class Executor:
    def __init__(self, place: Optional[Place] = None,
                 opt_level: Optional[int] = None):
        from .serving.engine import StepCache, default_step_bytes

        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()
        if self.device.type == "cuda":
            fp32_sums()
        if opt_level:
            raise NotImplementedError(
                "the optimizing transpiler (opt_level %r) is a later slice of "
                "the port" % (opt_level,))
        self._seed = 0
        # the captured steps of every program this executor ran, by key
        self.step_cache = StepCache(default_step_bytes(self.device))
        # per-program Engines, read ops, plans and step keys, step counters
        # and prefetched windows; weak keys: a dead program's entries must
        # not pass to a new program allocated at its address
        self._engines = weakref.WeakKeyDictionary()
        self._read_ops = weakref.WeakKeyDictionary()
        self._plans = weakref.WeakKeyDictionary()
        self._steps = weakref.WeakKeyDictionary()
        self._reader_prefetch = weakref.WeakKeyDictionary()
        self._last_loop_steps = weakref.WeakKeyDictionary()
        self._stage_stream = None
        # host ms spent pulling and stacking reader batches
        self.reader_pull_ms = 0.0

    # -- step counters -----------------------------------------------------
    def program_steps(self, program: Program) -> int:
        """Steps run on ``program``'s own stream — the random stream's step
        position. Checkpoint it so a resumed run draws what the
        uninterrupted run would have."""
        return self._steps.get(program, 0)

    def set_program_steps(self, program: Program, n: int):
        """Restore ``program``'s step position (the inverse of
        ``program_steps``, for a sample-exact resume)."""
        self._steps[program] = int(n)

    def _next_steps(self, program: Program, n: int) -> int:
        cur = self._steps.get(program, 0)
        self._steps[program] = cur + n
        return cur

    def close(self):
        """Free this executor's steps (graphs, pools, buffers that the
        scope does not hold) and its prefetched windows."""
        self.step_cache.clear()
        self._reader_prefetch.clear()
        self._engines.clear()

    # -- the step -----------------------------------------------------------
    def _engine_for(self, program: Program):
        from .serving.engine import Engine

        eng = self._engines.get(program)
        if eng is None:
            eng = self._engines[program] = Engine(program,
                                                  memory=self.step_cache)
        return eng

    def _feed_value(self, program, name, value):
        var = program.global_block()._find_var_recursive(name)
        return _as_feed_tensor(value, var)

    @staticmethod
    def _state_values(scope, state_in):
        vals = {}
        missing = []
        for name in state_in:
            val = scope.find_var(name)
            if val is None:
                missing.append(name)
            vals[name] = val
        if missing:
            raise RuntimeError(
                "persistable variables %s have no value in scope; run the "
                "startup program first" % (missing,))
        return vals

    def _state_buffers(self, vals):
        """The scope's tensors where they can be state buffers, else
        copies on the step's device (one buffer per tensor)."""
        bufs, seen = {}, set()
        for name, val in vals.items():
            if _adoptable(val, self.device) and val.data_ptr() not in seen:
                bufs[name] = val
            else:
                if not isinstance(val, torch.Tensor):
                    val = torch.from_numpy(np.array(val))
                bufs[name] = val.detach().to(self.device).clone(
                    memory_format=torch.contiguous_format)
            seen.add(bufs[name].data_ptr())
        return bufs

    @staticmethod
    def _step_fn(program, device, fetch_names, state_out, write_only):
        """The step's function ``fn(static, write=True, rng=None)``: the
        block on the static buffers (feeds and state), each intermediate
        dropped after its last reader; with ``write``, every state output
        that has a buffer copied into it. Returns the fetches, then the
        write-only state outputs."""
        block = program.global_block()
        written = [n for n in state_out if n not in write_only]
        keep = tuple(dict.fromkeys(tuple(fetch_names) + tuple(state_out)))

        def fn(static, write=True, rng=None):
            env = dict(static)
            counter = env.pop(RNG_FEED, None)
            if rng is None and counter is not None:
                rng = RngStream(counter=counter)
            run_block(block, env, device, rng, keep=keep)
            for name in fetch_names:
                if name not in env:
                    raise KeyError("fetch target %r was not produced by "
                                   "the program" % name)
            if write:
                with torch.no_grad():
                    # an output that aliases another buffer (an op that
                    # passes its input through) is read before any copy
                    ptrs = {static[n].data_ptr(): n for n in written}
                    new = {}
                    for n in written:
                        v = env[n]
                        if ptrs.get(v.data_ptr(), n) != n:
                            v = v.clone()
                        new[n] = v
                    for n, v in new.items():
                        if v is not static[n]:
                            static[n].copy_(v)
            return tuple(env[n] for n in fetch_names) + tuple(
                env[n] for n in write_only)

        return fn

    def _memo(self, program):
        """This program's memos, dropped when its version moves: its
        state and random-op plan by feed names, its step keys."""
        memo = self._plans.get(program)
        if memo is None or memo[0] != program._version:
            memo = self._plans[program] = (program._version, {}, {})
        return memo

    def _plan(self, program, feed_names):
        """(state inputs, state outputs, holds a random op, holds an op
        that draws from a device key) of ``program`` fed ``feed_names``."""
        plans = self._memo(program)[1]
        names = frozenset(feed_names)
        got = plans.get(names)
        if got is None:
            state_in, state_out = analyze_state(program, names)
            ops = [op for b in program.blocks for op in b.ops]
            random = any(op.type in RANDOM_OPS for op in ops)
            keyed = any(op.type in KEYED_OPS for op in ops)
            got = plans[names] = (state_in, state_out, random, keyed)
        return got

    def _step_for(self, program, feeds, state_vals, fetch_names, state_out,
                  use_cache):
        """The program's step at these feeds and state: from the step cache
        (a hit), else built (and stored unless ``use_cache`` is off)."""
        from .serving.engine import GraphStep, feed_signature

        eng = self._engine_for(program)
        specs = [(n, tuple(v.shape), v.dtype) for n, v in feeds.items()]
        state_sig = tuple((n, _shape(v), str(getattr(v, "dtype", "")))
                          for n, v in state_vals.items())
        write_only = tuple(n for n in state_out if n not in state_vals)
        feed_sig = feed_signature(specs)

        def build():
            fn = self._step_fn(program, self.device, fetch_names, state_out,
                               write_only)
            step = GraphStep(
                fn, specs, self.device,
                name="run %s %s" % (eng.fingerprint(), key[:8]),
                warmup=lambda static: fn(static, write=False),
                buffers=self._state_buffers(state_vals))
            # the state inputs (static buffers) and the state outputs
            # that no op reads, which the step returns after its fetches
            step.state, step.write_only = tuple(state_vals), write_only
            return step

        from .serving.engine import env_fingerprint

        keys = self._memo(program)[2]
        fields = (feed_sig, fetch_names, state_sig, write_only,
                  env_fingerprint())
        key = keys.get(fields)
        if key is None:
            key = keys[fields] = eng.key("run", feed_sig, fetch_names,
                                         state_sig, write_only)
        if not use_cache:
            return build()
        step, _ = eng.acquire("run", key, build, meta=lambda: eng.meta(
            "run", feed_sig, fetch_names))
        return step

    def _run_steps(self, program, scope, feeds, per_step, k, fetch_names,
                   use_cache):
        """Run ``k`` steps of ``program``: ``feeds`` the same every step,
        ``per_step`` name -> (k, ...) device tensors sliced per step.
        Returns the last step's fetches (copies, on the step's device)
        with the scope holding the new state."""
        first = {n: v[0] for n, v in per_step.items()}
        first.update(feeds)
        state_in, state_out, random, keyed = self._plan(program, first)
        vals = self._state_values(scope, state_in)
        step0 = self._next_steps(program, k)
        n_fetch = len(fetch_names)
        seed = program.random_seed if program.random_seed else self._seed
        if keyed and not random:
            # the graph's random counter: one [seed, step] row per step
            counters = torch.tensor([[seed, step0 + i] for i in range(k)],
                                    dtype=torch.int64)
            if k == 1:
                first[RNG_FEED] = counters[0]
            else:
                per_step = dict(per_step)
                per_step[RNG_FEED] = counters.to(self.device)
                first[RNG_FEED] = per_step[RNG_FEED][0]

        def read(outs):
            return [_clone(v) for v in outs]

        if random:
            # the random-op rule: op by op, each step on its own stream
            fn = self._step_fn(program, self.device, fetch_names, state_out,
                               tuple(n for n in state_out if n not in vals))
            static = {n: (v if v.device == self.device
                          else v.to(self.device))
                      for n, v in first.items()}
            static.update(self._state_buffers(vals))
            for i in range(k):
                for n, v in per_step.items():
                    static[n] = v[i].to(self.device)
                outs = fn(static, rng=RngStream(seed, step0 + i))
            outs = read(outs)
            state = {n: static[n] for n in vals}
            write_only = outs[n_fetch:]
            names_wo = [n for n in state_out if n not in vals]
        else:
            graph = self._step_for(program, first, vals, fetch_names,
                                   state_out, use_cache)
            call = dict(first)
            call.update(vals)
            for i in range(k):
                for n, v in per_step.items():
                    call[n] = v[i]
                outs = graph(call, read=read if i == k - 1 else None)
                if i == 0:
                    # later steps find their feeds and state in place
                    for n in list(feeds) + list(vals):
                        call[n] = graph.static[n]
            state = {n: graph.static[n] for n in graph.state}
            write_only = outs[n_fetch:]
            names_wo = graph.write_only
        for name, val in state.items():
            scope.set_var(name, val)
        for name, val in zip(names_wo, write_only):
            old = scope.find_var(name)
            if isinstance(old, torch.Tensor) and old.shape == val.shape and \
                    old.dtype == val.dtype and old.device == val.device and \
                    not old.is_inference():
                old.copy_(val)
            else:
                scope.set_var(name, val)
        return outs[:n_fetch]

    def _finish(self, fetches, return_numpy):
        if return_numpy:
            return [v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                    for v in fetches]
        return list(fetches)

    def _to_device(self, tensors: Dict[str, torch.Tensor]):
        """Tensors on the step's device; a host tensor goes up through
        pinned memory without blocking the host."""
        out = {}
        for n, v in tensors.items():
            if v.device != self.device and self.device.type == "cuda" and \
                    v.device.type == "cpu":
                v = v.pin_memory().to(self.device, non_blocking=True)
            out[n] = v.to(self.device)
        return out

    # -- public API ---------------------------------------------------------
    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict] = None,
        fetch_list: Optional[Sequence] = None,
        feed_var_name: str = "feed",
        fetch_var_name: str = "fetch",
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,
    ) -> List:
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        feed = feed or {}
        fetch_names = tuple(_fetch_name(f) for f in (fetch_list or []))
        gb = program.global_block()
        feeds = {name: self._feed_value(program, name, value)
                 for name, value in feed.items()}
        # reader ops: one batch from each (reference read_op.cc); a window
        # that run_loop prefetched goes back to its readers first, so this
        # step sees the batches in pipeline order
        self._flush_reader_prefetch(program)
        read_ops = self._read_ops_for(program, gb)
        if read_ops:
            t0 = time.perf_counter()
            for op in read_ops:
                batch = self._next_batch(self._holder_for(gb, op))
                for out_name in op.output("Out"):
                    feeds[out_name] = self._feed_value(program, out_name,
                                                       batch[out_name])
            self.reader_pull_ms += (time.perf_counter() - t0) * 1e3
        fetches = self._run_steps(program, scope, feeds, {}, 1, fetch_names,
                                  use_program_cache)
        return self._finish(fetches, return_numpy)

    def run_loop(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict] = None,
        fetch_list: Optional[Sequence] = None,
        steps: int = 1,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,
        per_step_feeds: Optional[Sequence[str]] = None,
    ) -> List:
        """Run up to ``steps`` consecutive steps and return the LAST
        executed step's fetches; the same state, fetches and step counter
        as ``steps`` calls of ``run`` (see the module docstring: feeds,
        ``per_step_feeds``, reader windows and their prefetch)."""
        if steps < 1:
            raise ValueError("run_loop needs steps >= 1, got %d" % steps)
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        feed = feed or {}
        fetch_names = tuple(_fetch_name(f) for f in (fetch_list or []))

        per_step_names = set(per_step_feeds or ())
        unknown = per_step_names - set(feed)
        if unknown:
            raise ValueError(
                "per_step_feeds %s are not in the feed dict" % sorted(unknown))
        gb = program.global_block()
        feeds, per_step = {}, {}
        for name, value in feed.items():
            if name in per_step_names:
                shape = _shape(value)
                if not shape or shape[0] != steps:
                    raise ValueError(
                        "per-step feed %r must carry a leading steps-sized "
                        "axis (%d), got shape %s" % (name, steps, shape))
                per_step[name] = self._feed_value(program, name, value)
            else:
                feeds[name] = self._feed_value(program, name, value)

        read_ops = self._read_ops_for(program, gb)
        if read_ops and per_step_names:
            # checked BEFORE any pull so a failed call consumes nothing
            raise NotImplementedError(
                "per_step_feeds cannot be combined with reader-op "
                "programs (the reader window length may truncate below "
                "`steps`, desynchronizing the stacked feeds)")
        eof_exc = None
        prefetch_on = (use_program_cache and os.environ.get(
            "PADDLE_TPU_READER_PREFETCH", "1") != "0"
            # stage ahead only once the window size proves stable: the
            # first call (or a size change) cannot predict the next window
            and self._last_loop_steps.get(program) == steps)
        self._last_loop_steps[program] = steps
        k = steps
        if read_ops:
            slot = self._reader_prefetch.pop(program, None)
            if slot is not None and (
                    slot["version"] != program._version
                    or slot["steps"] != steps or not prefetch_on
                    or any(getattr(h, "_ptpu_epoch", 0) != e
                           for _o, h, _b, e in slot["op_windows"])):
                # unusable (shape mismatch, or a reset() started a new
                # epoch): restore still-current batches, pull fresh below
                self._flush_reader_prefetch(program, slot)
                slot = None
            if slot is not None and slot["k"] == 0:
                raise slot["eof"]  # prefetch found the pipeline exhausted
            if slot is not None:
                window, k, eof_exc = slot["feeds"], slot["k"], slot["eof"]
                if slot["ready"] is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(slot["ready"])
                    for v in window.values():
                        v.record_stream(cur)
                slot = None
            else:
                op_windows, k, eof_exc = self._pull_reader_window(
                    gb, read_ops, steps)
                if k == 0:
                    raise eof_exc  # exhausted before the window started
                window = self._to_device(
                    self._stack_reader_window(program, op_windows, k))
                # the stack copied the batches: a DataLoader's slots go
                # back to its ring before the steps run
                del op_windows
            per_step.update(window)
        per_step = self._to_device(per_step)
        fetches = self._run_steps(program, scope, feeds, per_step, k,
                                  fetch_names, use_program_cache)
        if read_ops and prefetch_on and eof_exc is None:
            self._prefetch(program, gb, read_ops, steps)
        return self._finish(fetches, return_numpy)

    # -- the reader path -----------------------------------------------------
    def _read_ops_for(self, program: Program, gb):
        """(Static) read-op list, cached per program version so the hot
        path does not rescan every op each step."""
        entry = self._read_ops.get(program)
        if entry is None or entry[0] != program._version:
            entry = (program._version,
                     [op for op in gb.ops if op.type == "read"])
            self._read_ops[program] = entry
        return entry[1]

    def _holder_for(self, gb, op):
        """The read op's pipeline, told this executor's device (a
        ``double_buffer`` without a place stages there)."""
        rvar = gb._find_var_recursive(op.input("Reader")[0])
        holder = getattr(rvar, "_reader_holder", None)
        if holder is None:
            raise RuntimeError(
                "reader variable %r has no bound pipeline; build it "
                "with layers.py_reader" % op.input("Reader")[0])
        # a stage that is only an object with next() takes no device
        bind = getattr(holder, "bind_device", None)
        if bind is not None:
            bind(self.device)
        return holder

    @staticmethod
    def _next_batch(holder):
        """Pull the next reader batch, honoring batches a previous
        run_loop window pushed back (partial-shape boundary). The
        executor does not start the pipeline: py_reader needs its
        reader.start() per epoch (reference semantics)."""
        buf = getattr(holder, "_ptpu_pushback", None)
        if buf:
            return buf.pop(0)
        return holder.next()

    @staticmethod
    def _push_back(holder, batch):
        buf = getattr(holder, "_ptpu_pushback", None)
        if buf is None:
            buf = []
            holder._ptpu_pushback = buf
        buf.insert(0, batch)

    def _pull_reader_window(self, gb, read_ops, steps):
        """Pull up to `steps` aligned batches from every read op.
        Returns (op_windows, k, eof_exc): op_windows is a list of
        (op, holder, batches[:k], holder_epoch) — batches beyond the
        common window k are already pushed back (multi-reader skew
        realignment; k == 0 pushes ALL pulls back so an EOF on one
        reader costs the others nothing). holder_epoch snapshots the
        holder's reset/start generation so a later flush can tell these
        batches belong to the CURRENT epoch. eof_exc is the EOFException
        that closed the window early, or None."""
        from .io.reader import EOFException

        t0 = time.perf_counter()
        op_windows = []
        eof_exc = None
        for op in read_ops:
            holder = self._holder_for(gb, op)
            out_names = op.output("Out")
            batches = []
            for _ in range(steps):
                try:
                    b = self._next_batch(holder)
                except EOFException as e:
                    # tracebackless: the exception may wait in the
                    # prefetch slot until the next call raises it, and a
                    # live traceback would pin this frame chain (and the
                    # window's batches) in a reference cycle
                    eof_exc = e.with_traceback(None)
                    break
                if batches and any(
                        _shape(b[o]) != _shape(batches[0][o])
                        for o in out_names):
                    # shape boundary (e.g. partial final batch): close
                    # the window here, keep the batch for the next call
                    self._push_back(holder, b)
                    break
                batches.append(b)
            op_windows.append((op, holder, batches,
                               getattr(holder, "_ptpu_epoch", 0)))
        k = min(len(b) for _, _, b, _e in op_windows) if op_windows else 0
        for _op, holder, batches, _e in op_windows:
            for b in reversed(batches[k:]):
                self._push_back(holder, b)
            del batches[k:]
        self.reader_pull_ms += (time.perf_counter() - t0) * 1e3
        return op_windows, k, eof_exc

    def _stack_reader_window(self, program, op_windows, k):
        """Each reader output stacked into a (k, ...) per-step feed, cast
        to its declared dtype: on the device where the reader staged its
        batches there (double_buffer), else on the host."""
        t0 = time.perf_counter()
        feeds = {}
        for op, _holder, batches, _epoch in op_windows:
            for out_name in op.output("Out"):
                vals = [b[out_name] for b in batches[:k]]
                if all(isinstance(v, torch.Tensor) for v in vals):
                    stacked = torch.stack(vals)
                else:
                    stacked = np.stack([np.asarray(v) for v in vals])
                feeds[out_name] = self._feed_value(program, out_name, stacked)
        self.reader_pull_ms += (time.perf_counter() - t0) * 1e3
        return feeds

    def _prefetch(self, program, gb, read_ops, steps):
        """Stage the NEXT window now, while the card still runs this one:
        the host pull and stack, and the upload on a side stream, hide
        under the current window. An EOF mid-pull is remembered (k > 0:
        the next call trains the short window; k == 0: it raises). Any
        other reader error is deferred the same way: this window already
        ran, and the error belongs to the call that would have used the
        broken batch."""
        try:
            nwin, nk, neof = self._pull_reader_window(gb, read_ops, steps)
            feeds, ready = None, None
            if nk:
                feeds = self._stack_reader_window(program, nwin, nk)
                # keep, for a flush, each step's slice of the stacked
                # window (cast, on the host or where the reader staged
                # it) in place of the pulled batches: the window then
                # holds none of the reader's memory (a DataLoader's slots)
                nwin = [(op, holder, [{o: feeds[o][i]
                                       for o in op.output("Out")}
                                      for i in range(nk)], epoch)
                        for op, holder, _b, epoch in nwin]
                if self.device.type == "cuda":
                    if self._stage_stream is None:
                        self._stage_stream = torch.cuda.Stream(self.device)
                    side = self._stage_stream
                    with torch.cuda.stream(side):
                        feeds = self._to_device(feeds)
                        ready = torch.cuda.Event()
                        ready.record(side)
                else:
                    feeds = self._to_device(feeds)
            self._reader_prefetch[program] = {
                "version": program._version, "steps": steps, "k": nk,
                "eof": neof, "op_windows": nwin, "feeds": feeds,
                "ready": ready}
        except Exception as e:  # noqa: BLE001 — deferred, not dropped
            # tracebackless for the same frame-cycle reason as the EOF
            # capture, but a real error's diagnostics must survive the
            # deferral: the formatted original traceback rides along as
            # the __cause__ (a string: no frame objects, no cycle)
            if e.__traceback__ is not None and e.__cause__ is None:
                e.__cause__ = RuntimeError(
                    "original traceback (deferred from reader "
                    "prefetch):\n" + "".join(traceback.format_exception(
                        type(e), e, e.__traceback__)).rstrip())
            self._reader_prefetch[program] = {
                "version": program._version, "steps": steps, "k": 0,
                "eof": e.with_traceback(None), "op_windows": [],
                "feeds": None, "ready": None}

    def _flush_reader_prefetch(self, program, slot=None):
        """Return a prefetched but unused window to its holders (raw
        batches, original order) — called whenever the prefetched window
        cannot be used: different steps, new program version, a plain
        run(), or prefetch off. Pass `slot` when it was already popped.
        Batches from a holder whose reset()/start() epoch moved on are
        DROPPED, not pushed back: they belong to the finished epoch (the
        same contract as the _ptpu_pushback clear in
        layers.io._make_reader_var)."""
        if slot is None:
            slot = self._reader_prefetch.pop(program, None)
        if slot is None:
            return
        for _op, holder, batches, epoch in reversed(slot["op_windows"]):
            if getattr(holder, "_ptpu_epoch", 0) != epoch:
                continue  # stale epoch: discard
            for b in reversed(batches):
                self._push_back(holder, b)

    # -- helpers the inference Predictor shares -------------------------------
    @staticmethod
    def _check_feed_shapes(program: Program, feed_sig):
        """Fail fast with the variable name when a feed's shape cannot
        match its declaration (wrong rank, or a static dim mismatch);
        ``feed_sig`` is ``((name, shape, dtype), ...)``."""
        gb = program.global_block()
        for name, shape, _dtype in feed_sig:
            var = gb._find_var_recursive(name)
            declared = getattr(var, "shape", None) if var is not None else None
            if not declared:
                continue
            declared = tuple(declared)
            ok = len(declared) == len(shape) and all(
                d in (-1, None) or d == s for d, s in zip(declared, shape))
            if not ok:
                raise ValueError(
                    "feed %r has shape %s but the program declares %s "
                    "(-1 = any); fix the feed or the layers.data "
                    "declaration" % (name, tuple(shape), declared))

    @staticmethod
    def _bucketize_feeds(program: Program, feed_arrays):
        """Apply a bucketize stamp (``program._bucketize``) at the feed
        boundary: pad every stamped feed's batch axis with zero rows up to
        the next power of two, so the feed signature is the bucket, not
        the raw batch size. Returns the real row count to slice fetches
        back to, or None when the stamp does not apply to this call (a
        stamped feed missing, or row counts that disagree: the call then
        runs at its raw signature, still correct)."""
        bkt = getattr(program, "_bucketize", None)
        if not bkt:
            return None
        names = bkt.get("feeds") or ()
        rows = set()
        for name in names:
            arr = feed_arrays.get(name)
            if arr is None or getattr(arr, "ndim", 0) < 1:
                return None
            rows.add(int(arr.shape[0]))
        if len(rows) != 1:
            return None
        n = rows.pop()
        bucket = next_pow2(n)
        if bucket != n:
            for name in names:
                arr = np.asarray(feed_arrays[name])
                pad = np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)
                feed_arrays[name] = np.concatenate([arr, pad], axis=0)
        return n

    @staticmethod
    def _slice_bucketized(program: Program, fetch_names, outs, n):
        """Slice batch-carrying fetches (the stamp lists them) back to the
        real row count ``n``."""
        if n is None:
            return outs
        sliced = set(getattr(program, "_bucketize", {}).get("fetches", ()))
        return [o[:n] if name in sliced else o
                for name, o in zip(fetch_names, outs)]
