"""Engine: the build/execute core shared by DecodePredictor and Predictor
(counterpart of paddle_tpu/serving/engine.py).

The JAX package compiles each step program once per feed signature into
an XLA executable and replays it. Here a step program is a Block that the
interpreter runs op by op from Python; what stands in for the executable
is a ``GraphStep``: static feed buffers and, on the card, one captured
``torch.cuda.CUDAGraph`` that a call replays in one launch.

``Engine`` owns, for ONE program:

- identity: the program, its process-local ``version`` and its content
  ``fingerprint()``, and ``env_fingerprint()``, which completes every key;
- the feed plan: ``feed_var(name)`` (memoized per program version),
  ``feed_plan(names)`` and ``convert_feeds``, as in the JAX package;
- ``key(kind, feed_sig, fetch_names, *extra)``, hashed over the JAX
  package's field order (kind, program fingerprint, feed signature, fetch
  order, extras, environment);
- ``acquire(kind, key, build)``, the memory tier: a hit returns the step,
  a miss builds it and stores it. ``graph_step`` builds the program's own
  GraphStep through it. The tier is a ``StepCache`` that an owner's
  engines share; it holds at most a given number of bytes of device
  memory in its steps and evicts the least recently used past that.

Left out, and why:

- The JAX package's disk tier (``runtime/aot_cache.py``: ``AotDiskCache``
  load and store, preload, sidecars). A CUDA graph holds device addresses
  and cannot outlive its process. What persists across processes here is
  the kernels' nvcc build (``kernels/_build.py``).
- ``Engine.optimized``: it waits for the optimizing transpiler, which is
  not ported.
"""
from __future__ import annotations

import collections
import hashlib
import itertools
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Engine", "GraphStep", "StepCache", "default_step_bytes",
           "env_fingerprint", "feed_signature"]

# Environment knobs that the port reads while a step runs, which change
# its kernels without changing the program: a set knob is part of every
# key. (The JAX package's aot_cache._TRACE_ENV names its own; a knob read
# while a program is built, as PADDLE_TPU_ATTN_BTHD, is in the program.)
_TRACE_ENV = ("PADDLE_TPU_FLASH_FUSED_BWD",)


def env_fingerprint() -> Tuple:
    """Everything outside the program that shapes a step: the torch and
    CUDA versions, the card's name and compute capability, the fp32-sums
    flags (``framework.scope.fp32_sums``) and the set trace knobs."""
    device = ("cpu",)
    if torch.cuda.is_available():
        i = torch.cuda.current_device()
        device = (torch.cuda.get_device_name(i),
                  tuple(torch.cuda.get_device_capability(i)))
    matmul = torch.backends.cuda.matmul
    return (
        torch.__version__,
        torch.version.cuda,
        device,
        (bool(matmul.allow_tf32), bool(torch.backends.cudnn.allow_tf32),
         bool(matmul.allow_bf16_reduced_precision_reduction)),
        tuple((k, os.environ[k]) for k in _TRACE_ENV if k in os.environ),
    )


def feed_signature(specs) -> Tuple:
    """``((name, shape, dtype name), ...)`` sorted by name, from
    ``(name, shape, dtype)`` triples (any dtype spec numpy or torch
    understands): the feed part of a key."""
    from ..framework.dtypes import convert_dtype

    return tuple(sorted((n, tuple(int(d) for d in shape), convert_dtype(dt))
                        for n, shape, dt in specs))


class GraphStep:
    """One step program at one feed signature, called as
    ``step(feeds, read=None)``.

    The step owns a static tensor for each feed, of the declared shape and
    dtype, on its device. A call copies each feed into its buffer (a host
    array through pinned staging, without blocking the host; a feed that
    IS the buffer, same ``data_ptr``, is not copied: that is how a decode
    step's K/V slabs stay in place) and runs ``eager(static)``, the
    program's eager function, on the buffers:

    - on the card through one ``torch.cuda.CUDAGraph``. The first call runs
      ``warmup`` (``eager`` unless given) on a side stream ``WARMUP``
      times, so that every kernel is built and every lazily made buffer
      exists, then captures one run of ``eager`` on that stream into a
      graph with its own memory pool; that call and every later one replay
      it. A training step's ``warmup`` is its function without the copy of
      the new state into the state buffers, so the warm-ups move no state
      and the first call trains one step, as every later one does. K3's counters come from the step's own
      store (``ops.kv_cache.own_counters``), so no other graph or stream
      shares them. If the capture fails the step raises, naming the op
      where it can, and every later call raises too: it never runs
      eagerly on CUDA;
    - on the CPU eagerly, on the same buffers.

    Calls run on the current stream, each after the last call's work on
    whatever stream that ran. The outputs of a replay alias the graph's
    memory (a step's static buffers, where it returns them) and are valid
    until the next call; ``read(outputs)``, when given, runs under the
    step's lock, so copy-in, replay and read-out are atomic. ``eager``
    stays reachable, and ``run_eager`` runs it on the buffers without the
    graph (the A/B and reference passes of chip_smoke.py). ``nbytes`` is
    the device memory the step holds: its buffers and its graph's pool.
    ``buffers`` names tensors to use as static buffers as they are (a
    training step's state: the scope's own tensors, updated in place)
    instead of, or beside, the ones ``specs`` makes; one that stands for
    a spec must have its shape, dtype and device, or the step raises.
    With ``lender`` (another GraphStep) the buffers are that step's own
    static tensors, which this step's graph reads and writes by address
    (a speculative draft or verify step over its decode step's K/V
    slabs): they are not counted in ``nbytes``, and the step cache drops
    this step with its lender.
    """

    WARMUP = 2
    _serials = itertools.count()

    def __init__(self, eager: Callable[[Dict[str, torch.Tensor]], Tuple],
                 specs: Sequence, device, name: str = "step",
                 warmup: Optional[Callable] = None,
                 buffers: Optional[Dict[str, torch.Tensor]] = None,
                 lender: Optional["GraphStep"] = None):
        self.eager = eager
        self.warmup = eager if warmup is None else warmup
        self.name = name
        self.kind = "step"       # the Engine's kind, set when it builds it
        self.device = torch.device(device)
        self.serial = next(GraphStep._serials)
        buffers = dict(buffers or {})
        self.static = {}
        for n, shape, dtype in specs:
            buf = buffers.get(n)
            if buf is None:
                self.static[n] = torch.zeros(tuple(shape), dtype=dtype,
                                             device=self.device)
            elif (tuple(buf.shape) != tuple(shape) or buf.dtype != dtype
                  or buf.device != self.device):
                raise ValueError(
                    "step %s: buffer %r is %s %s on %s; the step takes %s "
                    "%s on %s" % (name, n, tuple(buf.shape), buf.dtype,
                                  buf.device, tuple(shape), dtype,
                                  self.device))
        self.static.update(buffers)
        self.lender = lender
        self._lent = frozenset()
        if lender is not None:
            foreign = sorted(n for n, b in buffers.items()
                             if lender.static.get(n) is not b)
            if foreign:
                raise ValueError("step %s: buffers %s are not step %s's"
                                 % (name, foreign, lender.name))
            self._lent = frozenset(buffers)
        self.captures = 0
        self.replays = 0
        self.pool_bytes = 0
        self.meta: Optional[Dict] = None
        self.on_capture: Optional[Callable[["GraphStep"], None]] = None
        self._pinned: Dict[str, torch.Tensor] = {}
        self._copied = None      # event after the last host copy
        self._done = None        # event after the last call's work
        self._counters: Dict = {}
        self._graph = None
        self._outs = None
        self._failed: Optional[BaseException] = None
        self._lock = threading.Lock()

    @property
    def captured(self) -> bool:
        return self._graph is not None

    @property
    def nbytes(self) -> int:
        return self.pool_bytes + sum(b.numel() * b.element_size()
                                     for n, b in self.static.items()
                                     if n not in self._lent)

    def __call__(self, feeds, read=None):
        return self._run(feeds, read, self.device.type == "cuda")

    def run_eager(self, feeds, read=None):
        """A call that runs ``eager`` on the buffers, never the graph."""
        return self._run(feeds, read, False)

    def capture(self) -> None:
        """Capture now, on the buffers as they are (a no-op on the CPU and
        once captured)."""
        with self._lock:
            if self.device.type == "cuda" and self._graph is None:
                self._capture()

    # -- internals ----------------------------------------------------------
    def _run(self, feeds, read, replay):
        with self._lock:
            cur = None
            if self.device.type == "cuda":
                cur = torch.cuda.current_stream(self.device)
                if self._done is not None:
                    cur.wait_event(self._done)
            self._load(feeds)
            outs = self._replay() if replay else self.eager(self.static)
            got = outs if read is None else read(outs)
            if cur is not None:
                if self._done is None:
                    self._done = torch.cuda.Event()
                self._done.record(cur)
            return got

    def _load(self, feeds) -> None:
        staged = False
        for name, buf in self.static.items():
            if name not in feeds:
                raise KeyError("step %s: missing feed %r (expects %s)"
                               % (self.name, name, sorted(self.static)))
            val = feeds[name]
            if isinstance(val, torch.Tensor) and \
                    val.data_ptr() == buf.data_ptr() and \
                    val.dtype == buf.dtype and val.shape == buf.shape:
                continue
            shape = tuple(getattr(val, "shape", np.shape(val)))
            if shape != tuple(buf.shape):
                raise ValueError("step %s: feed %r has shape %s, the step "
                                 "was built for %s" % (self.name, name, shape,
                                                       tuple(buf.shape)))
            if isinstance(val, torch.Tensor) and val.device.type != "cpu":
                buf.copy_(val)
                continue
            src = val if isinstance(val, torch.Tensor) else \
                torch.from_numpy(np.asarray(val))
            if self.device.type != "cuda":
                buf.copy_(src)
                continue
            pin = self._pinned.get(name)
            if pin is None:
                pin = self._pinned[name] = torch.empty(
                    buf.shape, dtype=buf.dtype, pin_memory=True)
            if not staged and self._copied is not None:
                # the last call's copies may still read the staging
                self._copied.synchronize()
            staged = True
            pin.copy_(src)
            buf.copy_(pin, non_blocking=True)
        if staged:
            if self._copied is None:
                self._copied = torch.cuda.Event()
            self._copied.record()

    def _replay(self):
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self.replays += 1
        return self._outs

    def _capture(self) -> None:
        from .. import observability as obs
        from ..ops.kv_cache import own_counters

        if self._failed is not None:
            raise RuntimeError("step %s: its CUDA graph capture failed "
                               "earlier (no eager fallback): %s"
                               % (self.name, self._failed))
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with own_counters(self._counters):
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    self.warmup(self.static)
            try:
                # thread_local: another thread of the program (a reader's
                # staging thread) may make CUDA calls that are unsafe
                # during a capture; the capturing thread may not
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    # the capture starts with the allocator's cache
                    # emptied: what it reserves from here is the pool
                    held = torch.cuda.memory_reserved(self.device)
                    outs = self.eager(self.static)
            except Exception as e:
                # ending a broken capture raises its own error: report the
                # interpreter's, which names the op, else the first one
                from ..framework.interpreter import TraceError

                chain = [e]
                while chain[-1].__context__ is not None:
                    chain.append(chain[-1].__context__)
                cause = next((x for x in chain
                              if isinstance(x, TraceError)), chain[-1])
                self._failed = cause
                raise RuntimeError(
                    "step %s: CUDA graph capture failed (no eager "
                    "fallback): %s" % (self.name, cause)) from e
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - held
        cur.wait_stream(side)
        self._graph, self._outs = graph, outs
        self.captures += 1
        ms = (time.perf_counter() - t0) * 1e3
        obs.COMPILE_TOTAL.inc(kind=self.kind, stage="capture")
        obs.COMPILE_LATENCY_MS.observe(ms, kind=self.kind, stage="capture")
        obs.TIMELINE.record_compile(self.kind, self.name, wall_ms=ms,
                                    cache="capture")
        if self.on_capture is not None:
            self.on_capture(self)


class StepCache:
    """The memory tier of one owner's engines (a predictor passes one to
    all of them, as the JAX package passes one disk cache): built steps by
    key, least recently used first.

    ``max_bytes`` bounds the device memory that its steps hold (their
    static buffers and graph pools, ``GraphStep.nbytes``): when a build,
    a capture (once its pool is known) or a lower bound takes them past
    it, the least recently used steps other than the new one are evicted,
    with their graphs, pools and buffers. A hit moves its step to the end
    and evicts nothing, so the steps one request looks up before it runs
    them (a decode bucket's decode and prefill steps) evict each other
    only when the bound cannot hold both. ``None`` is no bound.
    ``traces`` counts builds and captures, evicted steps' too.

    A PINNED step (``get``/``put`` with ``pin=True``) is never evicted:
    its owner (a DecodeServer's decode step, whose static buffers are the
    server's live K/V slabs) runs it for a lifetime of its own and hands
    it back with ``release``, which drops it from the cache. Its bytes
    still count against the bound, so the others make room. A step whose
    buffers another step lends (``GraphStep.lender``) leaves the cache
    with its lender, evicted or released, and the lender of the step
    just built is not evicted to make room for it."""

    def __init__(self, max_bytes: Optional[int] = None):
        self._max_bytes = max_bytes
        self.builds = 0
        self.evictions = 0
        self._evicted_captures = 0
        self._steps: "collections.OrderedDict" = collections.OrderedDict()
        self._pinned: set = set()
        self._lock = threading.Lock()

    @property
    def max_bytes(self) -> Optional[int]:
        return self._max_bytes

    @max_bytes.setter
    def max_bytes(self, value: Optional[int]) -> None:
        with self._lock:
            self._max_bytes = value
            self._trim(None)

    def get(self, key, pin: bool = False):
        with self._lock:
            step = self._steps.get(key)
            if step is not None:
                self._steps.move_to_end(key)
                if pin:
                    self._pinned.add(key)
            return step

    def put(self, key, step, pin: bool = False) -> None:
        with self._lock:
            self._steps[key] = step
            self._steps.move_to_end(key)
            if pin:
                self._pinned.add(key)
            self.builds += 1
            self._trim(step)
        step.on_capture = self._captured

    def release(self, step) -> None:
        """Unpin ``step`` and drop it from the cache (its graph, pool and
        buffers go with the last reference); not counted as an
        eviction."""
        with self._lock:
            for key, s in self._with_borrowers(step):
                del self._steps[key]
                self._pinned.discard(key)
                self._evicted_captures += s.captures

    def _with_borrowers(self, step) -> List:
        """(key, step) of ``step`` and of every cached step that borrows
        its buffers."""
        return [(key, s) for key, s in self._steps.items()
                if s is step or s.lender is step]

    def _captured(self, step) -> None:
        with self._lock:
            if any(s is step for s in self._steps.values()):
                self._trim(step)

    def _trim(self, keep) -> None:
        if self._max_bytes is None:
            return
        from .. import observability as obs

        total = sum(s.nbytes for s in self._steps.values())
        for key in list(self._steps):
            if total <= self._max_bytes:
                break
            step = self._steps.get(key)
            if step is None or step is keep or key in self._pinned or \
                    (keep is not None and keep.lender is step):
                continue
            gone = self._with_borrowers(step)
            if any(s is keep or k in self._pinned for k, s in gone):
                continue
            for k, s in gone:
                del self._steps[k]
                total -= s.nbytes
                self.evictions += 1
                self._evicted_captures += s.captures
                obs.CACHE_EVICTIONS.inc(kind=s.kind)

    def clear(self) -> None:
        """Drop every step, with its graph, pool and buffers (not counted
        as evictions)."""
        with self._lock:
            self._evicted_captures += sum(s.captures
                                          for s in self._steps.values())
            self._steps.clear()
            self._pinned.clear()

    def steps(self) -> List:
        """The cached steps, least recently used first."""
        with self._lock:
            return list(self._steps.values())

    def __len__(self) -> int:
        return len(self._steps)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.steps())

    @property
    def traces(self) -> int:
        return self.builds + self._evicted_captures + sum(
            s.captures for s in self.steps())


def default_step_bytes(device) -> Optional[int]:
    """The default bound of a predictor's StepCache: half the card's
    memory; none on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory // 2


class Engine:
    """Build/execute core for one Program. Cheap to construct: nothing is
    built until ``acquire``. ``memory`` is the StepCache of built steps,
    by key, that an owner shares among its engines (unbounded when
    none is given)."""

    def __init__(self, program, memory: Optional[StepCache] = None,
                 feed_names: Optional[Sequence[str]] = None,
                 fetch_names: Optional[Sequence[str]] = None):
        self.program = program
        self.memory = StepCache() if memory is None else memory
        self.feed_names = list(feed_names) if feed_names is not None else None
        self.fetch_names = (list(fetch_names) if fetch_names is not None
                            else None)
        # per-version memos: negative feed lookups are not cached
        # (create_var alone does not bump program._version)
        self._feed_vars: Tuple = (None, {})
        self._fp: Tuple = (None, None)

    # -- identity -----------------------------------------------------------
    @property
    def version(self):
        """The program's process-local mutation counter."""
        return getattr(self.program, "_version", None)

    def fingerprint(self, full: bool = False) -> str:
        """The program's content fingerprint, cached per version: short
        (8 hex), or ``full``."""
        if self._fp[0] != self.version or self._fp[1] is None:
            self._fp = (self.version, self.program.fingerprint())
        return self._fp[1] if full else self._fp[1][:8]

    # -- feed plan ----------------------------------------------------------
    def feed_var(self, name: str):
        """Declared Variable behind a feed name, memoized per program
        version."""
        ver, cache = self._feed_vars
        if ver != self.version:
            cache = {}
            self._feed_vars = (self.version, cache)
        var = cache.get(name)
        if var is None:
            var = self.program.global_block()._find_var_recursive(name)
            if var is not None:
                cache[name] = var
        return var

    def feed_plan(self, feed_names: Optional[Sequence[str]] = None
                  ) -> List[Tuple[str, object, Optional[np.dtype]]]:
        """``[(name, declared var, numpy dtype or None)]`` for a frozen
        feed set."""
        from ..framework.dtypes import as_numpy_dtype

        names = self.feed_names if feed_names is None else feed_names
        plan = []
        for name in names or ():
            var = self.feed_var(name)
            want = (np.dtype(as_numpy_dtype(var.dtype))
                    if var is not None else None)
            plan.append((name, var, want))
        return plan

    def convert_feeds(self, feed: Dict, plan=None) -> Dict[str, np.ndarray]:
        """Feed dict -> contiguous, declared-dtype arrays (KeyError names
        the missing feed)."""
        if plan is None:
            plan = self.feed_plan()
        out = {}
        for name, _var, want in plan:
            if name not in feed:
                raise KeyError("missing feed %r (model expects %s)"
                               % (name, [n for n, _, _ in plan]))
            arr = feed[name]
            if type(arr) is not np.ndarray:
                arr = np.asarray(arr)
            if want is not None and arr.dtype != want:
                arr = arr.astype(want)
            out[name] = arr
        return out

    # -- keys ---------------------------------------------------------------
    def key_fields(self, kind: str, feed_sig, fetch_names, *extra) -> Tuple:
        """(kind, program content fingerprint, feed signature, fetch ORDER,
        <caller extras>, environment fingerprint). The program's version
        is absent: the content fingerprint covers it."""
        return ((kind, self.fingerprint(full=True), feed_sig,
                 tuple(fetch_names)) + tuple(extra) + (env_fingerprint(),))

    def key(self, kind: str, feed_sig, fetch_names, *extra) -> str:
        """24-hex content key over ``key_fields``."""
        fields = self.key_fields(kind, feed_sig, fetch_names, *extra)
        return hashlib.sha1(repr(tuple(fields)).encode()).hexdigest()[:24]

    def tier(self) -> str:
        """The program's transpile/quantization tier from its stamps: int8,
        O<level>, O2 (a bucketize-stamped export), else raw."""
        p = self.program
        if getattr(p, "_quantized", None):
            return "int8"
        lvl = getattr(p, "_opt_level", None)
        if lvl:
            return "O%d" % int(lvl)
        if getattr(p, "_bucketize", None):
            return "O2"
        return "raw"

    def meta(self, kind: str, feed_sig, fetch_names) -> Dict:
        """What a built step is: kind, program, tier, feeds, fetches,
        environment, creation time."""
        return {"kind": kind, "program": self.fingerprint(),
                "tier": self.tier(),
                "feed_sig": feed_sig, "fetch_names": tuple(fetch_names),
                "env": env_fingerprint(), "created": time.time()}

    # -- acquisition --------------------------------------------------------
    def acquire(self, kind: str, key: str, build: Callable[[], object],
                meta: Optional[Callable[[], Dict]] = None,
                pin: bool = False):
        """The memory tier: ``(step, "memory")`` on a hit, else
        ``(build(), "built")``, stored under ``key`` with ``meta()`` as
        its ``meta``; ``pin`` pins it (StepCache). Hits, misses and builds
        go to the ``CACHE_*`` and ``COMPILE_*`` series (stage="build"; the
        step's capture, on the card, records stage="capture")."""
        from .. import observability as obs

        fp = self.fingerprint()
        step = self.memory.get(key, pin=pin)
        if step is not None:
            obs.CACHE_HITS.inc(kind=kind, tier="memory", program=fp)
            return step, "memory"
        obs.CACHE_MISSES.inc(kind=kind, tier="memory", program=fp)
        t0 = time.perf_counter()
        step = build()
        step.kind = kind
        if meta is not None:
            step.meta = meta()
        self.memory.put(key, step, pin=pin)
        ms = (time.perf_counter() - t0) * 1e3
        obs.COMPILE_TOTAL.inc(kind=kind, stage="build")
        obs.COMPILE_LATENCY_MS.observe(ms, kind=kind, stage="build")
        obs.TIMELINE.record_compile(kind, fp, wall_ms=ms, cache="build")
        return step, "built"

    def eager(self, state: Dict[str, torch.Tensor], device: torch.device
              ) -> Callable[[Dict[str, torch.Tensor]], Tuple]:
        """The program's eager function: ``fn(feeds)`` runs its global
        block on ``state`` and ``feeds`` under inference mode, each
        intermediate dropped after its last reader, and returns the
        fetches in order."""
        from ..framework.interpreter import run_block

        block = self.program.global_block()
        fetch_names = tuple(self.fetch_names)

        def fn(feeds):
            env = dict(state)
            env.update(feeds)
            with torch.inference_mode():
                run_block(block, env, device, keep=fetch_names)
            return tuple(env[n] for n in fetch_names)

        return fn

    def graph_step(self, kind: str, specs: Sequence, state, device,
                   *extra, check: Optional[Callable[[], None]] = None,
                   pin: bool = False, lender: Optional[GraphStep] = None,
                   lent: Sequence[str] = ()) -> GraphStep:
        """The GraphStep of this program at the feed specs ``(name, shape,
        torch dtype)``, looked up by ``key`` (``extra`` completes it)
        through ``acquire`` on every call; ``check()`` runs before a
        build; ``pin`` pins the step (StepCache). With ``lender`` the
        feeds named ``lent`` are that step's static tensors (GraphStep's
        ``lender``), and its serial completes the key: the step is that
        lender's only."""
        feed_sig = feed_signature(specs)
        fetches = tuple(self.fetch_names)
        if lender is not None:
            extra = extra + ("lender", lender.serial)
        key = self.key(kind, feed_sig, fetches, *extra)

        def build():
            if check is not None:
                check()
            buffers = None
            if lender is not None:
                missing = sorted(n for n in lent if n not in lender.static)
                if missing:
                    raise ValueError("step %s has no buffers %s to lend"
                                     % (lender.name, missing))
                buffers = {n: lender.static[n] for n in lent}
            return GraphStep(self.eager(state, device), specs, device,
                             name="%s %s %s" % (kind, self.fingerprint(),
                                                key[:8]),
                             buffers=buffers, lender=lender)

        return self.acquire(kind, key, build,
                            meta=lambda: self.meta(kind, feed_sig, fetches),
                            pin=pin)[0]
