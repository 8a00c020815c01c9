"""Inference serving: Predictor (counterpart of paddle_tpu/inference.py;
reference: paddle/fluid/inference/api/api_impl.cc, NativePredictor).

``Predictor`` loads a ``save_inference_model`` directory (either
package's) and runs it through the Engine (serving/engine.py): one
GraphStep per feed signature, built on first use and, on the card,
captured into one CUDA graph and replayed by every later call. A model
stamped by the bucketize pass (``program._bucketize``) has its batch axis
padded to the next power of two, so request sizes share steps, and its
batch-carrying fetches sliced back.

Left out, and why: the JAX package persists its executables on disk
(``aot_cache``, ``cache_dir`` and ``preload`` arguments); a CUDA graph
holds device addresses and cannot outlive its process, so the port takes
no such argument. The optimizing transpiler (``opt_level`` above 0) and
the static analyzer (``PADDLE_TPU_VERIFY``) are not ported and raise.
``PredictorServer``, the batching server, is a later slice.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

__all__ = ["Predictor", "create_paddle_predictor"]


class Predictor:
    """NativePredictor analog.

    predictor = Predictor(model_dir)                    # on the card
    predictor = Predictor(model_dir, place=CPUPlace())
    outs = predictor.run({"img": batch})                # dict feed
    outs = predictor.run([batch])                       # positional feed

    ``place=None`` means ``CUDAPlace(0)``; with no CUDA device that raises
    — the predictor never moves to the CPU unasked. ``max_step_bytes``
    bounds the device memory of the cached steps (buffers and graph
    pools; None: ``serving.engine.default_step_bytes``, half the card).
    """

    def __init__(self, model_dir: str, place=None,
                 opt_level: Optional[int] = None,
                 max_step_bytes: Optional[int] = None):
        from . import io as fluid_io
        from .executor import analyze_state
        from .framework.scope import CUDAPlace, Scope, fp32_sums
        from .serving.engine import Engine, StepCache, default_step_bytes

        if opt_level is None:  # the JAX package's PADDLE_TPU_OPT knob
            try:
                opt_level = int(os.environ.get("PADDLE_TPU_OPT", "0"))
            except ValueError:
                opt_level = 0
        if opt_level > 0:
            raise NotImplementedError(
                "the optimizing transpiler (opt_level %r) is a later slice "
                "of the port" % (opt_level,))
        if os.environ.get("PADDLE_TPU_VERIFY", "").strip().lower() not in (
                "", "0", "off", "false"):
            raise NotImplementedError(
                "PADDLE_TPU_VERIFY: the static analyzer (analysis/) is a "
                "later slice of the port")
        self.place = CUDAPlace(0) if place is None else place
        self.device = self.place.torch_device()
        if self.device.type == "cuda":
            fp32_sums()
        self.model_dir = model_dir
        self._scope = Scope()
        self._program, self._feed_names, fetch_targets = (
            fluid_io.load_inference_model(model_dir, scope=self._scope,
                                          place=self.place))
        self._fetch_names = [t.name for t in fetch_targets]
        self._steps = StepCache(default_step_bytes(self.device)
                                if max_step_bytes is None
                                else max_step_bytes)
        self._engine = Engine(self._program, memory=self._steps,
                              feed_names=self._feed_names,
                              fetch_names=self._fetch_names)
        self._feed_plan = self._engine.feed_plan()
        # params are resident device state, loaded once
        state_in, _ = analyze_state(self._program, set(self._feed_names))
        self._state = {}
        for n in state_in:
            val = self._scope.find_var(n)
            if val is None:
                raise RuntimeError(
                    "inference model is missing persistable %r" % n)
            self._state[n] = val

    @property
    def traces(self) -> int:
        """Steps built plus graphs captured."""
        return self._steps.traces

    def _step(self, feed_arrays):
        """The GraphStep for these feeds' signature, by its key."""
        from .executor import Executor
        from .framework.dtypes import as_torch_dtype

        feed_sig = tuple((n, tuple(a.shape), str(a.dtype))
                         for n, a in sorted(feed_arrays.items()))
        specs = [(n, shape, as_torch_dtype(dt)) for n, shape, dt in feed_sig]
        # fail fast with the variable name on an impossible feed shape
        return self._engine.graph_step(
            "predict", specs, self._state, self.device,
            check=lambda: Executor._check_feed_shapes(self._program,
                                                      feed_sig))

    def warm(self, batch_rows: int) -> bool:
        """Build (and on the card capture, on zero-valued feeds) the step
        for a ``batch_rows``-row batch of the model's declared feed shapes
        without returning anything. Returns False (a no-op) when a
        declared feed shape has dynamic non-batch dims or a static batch
        dim."""
        from .executor import Executor

        feed_arrays = {}
        for name, var, want in self._feed_plan:
            shape = tuple(getattr(var, "shape", None) or ())
            if (not shape or shape[0] not in (-1, None)
                    or any(d is None or d < 0 for d in shape[1:])):
                return False
            feed_arrays[name] = np.zeros(
                (batch_rows,) + shape[1:], want or np.float32)
        # a bucketized model runs at the bucket: warm that signature
        Executor._bucketize_feeds(self._program, feed_arrays)
        self._step(feed_arrays).capture()
        return True

    def run(self, feed, return_numpy: bool = True) -> List:
        """Run one batch: ``feed`` is a dict by feed name or a list in
        ``feed_names`` order. Returns the fetches in order, as numpy
        arrays or (``return_numpy=False``) as tensors on the predictor's
        device that later calls leave alone."""
        from .executor import Executor

        if isinstance(feed, (list, tuple)):
            feed = dict(zip(self._feed_names, feed))
        feed_arrays = self._engine.convert_feeds(feed, self._feed_plan)
        rows = Executor._bucketize_feeds(self._program, feed_arrays)
        step = self._step(feed_arrays)

        def read(outs):
            if return_numpy:
                return [o.to("cpu", copy=True).numpy() for o in outs]
            return [o.clone() for o in outs]

        outs = step(feed_arrays, read=read)
        return Executor._slice_bucketized(self._program, self._fetch_names,
                                          outs, rows)

    predict = run  # api parity sugar

    @property
    def feed_names(self) -> List[str]:
        return list(self._feed_names)

    @property
    def fetch_names(self) -> List[str]:
        return list(self._fetch_names)


def create_paddle_predictor(config_or_dir, **kwargs) -> Predictor:
    """reference api.cc:CreatePaddlePredictor parity shim."""
    if isinstance(config_or_dir, str):
        return Predictor(config_or_dir, **kwargs)
    return Predictor(getattr(config_or_dir, "model_dir"), **kwargs)
