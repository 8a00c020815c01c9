"""Inference serving: Predictor and PredictorServer (counterpart of
paddle_tpu/inference.py; reference: paddle/fluid/inference/api/api_impl.cc,
NativePredictor).

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

``PredictorServer`` is the serving loop, a two-stage pipeline: requests
enter the runtime's bounded C++ channel (runtime/recordio.py) as
zero-copy frames; a STACKING stage drains them with dynamic batching,
stacks rows and pads to the next power-of-two bucket; a DEVICE stage runs
the predictor over a bounded in-flight queue so host-side assembly
overlaps the card. Responses fan back out by request id.
"""
from __future__ import annotations

import os
import pickle
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import observability as obs
from .observability import tracing as _tracing
from .runtime import recordio as _rio

__all__ = ["Predictor", "PredictorServer", "create_paddle_predictor"]


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

    def run(self, feed, return_numpy: bool = True,
            _obs_path: str = "direct") -> List:
        """Run one batch: ``feed`` is a dict by feed name or a list in
        ``feed_names`` order. Returns the fetches in order, as numpy
        arrays or (``return_numpy=False``) as tensors on the predictor's
        device that later calls leave alone. Its latency (ending in the
        read of the outputs), rows and count go to the ``PREDICT_*``
        series under ``path=_obs_path``."""
        from .executor import Executor

        t0 = time.perf_counter()
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
        outs = Executor._slice_bucketized(self._program, self._fetch_names,
                                          outs, rows)
        first = next(iter(feed_arrays.values()), None)
        obs.PREDICT_LATENCY_MS.observe((time.perf_counter() - t0) * 1e3,
                                       path=_obs_path)
        obs.PREDICT_REQUESTS.inc(path=_obs_path)
        obs.PREDICT_BATCH_ROWS.observe(
            first.shape[0] if first is not None and first.ndim else 1,
            path=_obs_path)
        return outs

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


# -- request wire format (the JAX package's, byte for byte) ----------------
#
# Zero-copy frame (fast path): contiguous numeric sample arrays ride the
# channel as the shared array-frame layout from runtime/recordio.py
# (b"Z" | rid u64 | nslots u32 | per-slot dtype/shape/bytes: the SAME
# layout the DataLoader writes into its shared-memory slots). The
# stacking stage reconstructs each row as an ``np.frombuffer`` VIEW over
# the received message — no pickle object graph is built on either side
# of the channel. Samples the frame cannot carry (object / record
# dtypes) fall back to the pickled form, prefixed b"P".

_encode_request = _rio.encode_frame
_decode_request = _rio.decode_frame


def _encode_sample(rid: int, sample) -> bytes:
    """One request sample (per-slot arrays, no batch dim) -> wire frame:
    the zero-copy form when every slot has a buffer-exporting dtype, the
    pickled ``b"P"`` form otherwise. Shared by ``PredictorServer.submit``
    and ``DecodeServer.submit``, so the front doors never drift in what
    they put on the wire."""
    rows, fast = [], True
    for a in sample:
        if type(a) is not np.ndarray:
            a = np.asarray(a)
        if a.dtype.kind in "OVMm":
            # object graphs and datetime/timedelta (no buffer export)
            # can't ride the frame
            fast = False
        elif not a.flags["C_CONTIGUOUS"]:
            a = np.ascontiguousarray(a)
        rows.append(a)
    return (_encode_request(rid, rows) if fast
            else b"P" + pickle.dumps((rid, rows), protocol=4))


class PredictorServer:
    """Pipelined dynamic-batching serving loop (counterpart of the JAX
    package's PredictorServer: the NativePredictor run loop as a
    two-stage pipeline).

    server = PredictorServer(predictor, max_batch=8)
    server.start()
    fut = server.submit((row0,))          # per-slot sample arrays
    outs = fut.result()                   # list of per-fetch rows
    server.stop()

    Requests enter a C++ bounded channel as zero-copy binary frames
    (pickle only for object-dtype samples). Two worker stages overlap:

    - the STACKING stage drains up to ``max_batch`` frames per iteration
      (``ptrt_chan_recv_batch``: block for the first, then collect up to
      ``max_wait_ms`` longer or until full), stacks rows into one batch,
      and pads it up to the next power-of-two BUCKET (not to max_batch —
      a 5-row batch runs at 8 rows, not 32);
    - the DEVICE stage pops stacked batches from a bounded in-flight
      queue (depth ``in_flight``) and runs the predictor (on the card one
      graph replay per batch), so host-side decode/stack overlaps device
      execution. With the queue empty and the device stage idle, the
      stacking stage runs the batch itself under ``_dev_lock``.

    ``start()`` pre-warms every bucket's step (one ``Predictor.warm`` per
    bucket: built, and on the card captured), so no live request ever
    pays a build or a capture. ``max_wait_ms`` is the latency/throughput knob: 0 (default)
    ships whatever is queued immediately; a few ms lets slow traffic
    coalesce into fuller buckets.

    ``server.start_http(port)`` additionally serves the process metrics
    (request latency histograms, bucket fill, pad-waste rows, in-flight
    depth, per-stage latency; see paddle_tpu_torch.observability) at
    ``GET /metrics`` in Prometheus text format and ``GET /metrics.json``
    as a JSON snapshot.
    """

    def __init__(self, predictor: Predictor, max_batch: int = 8,
                 capacity: int = 256, pad_batches: bool = True,
                 max_wait_ms: float = 0.0, in_flight: int = 2,
                 buckets: Optional[Sequence[int]] = None,
                 prewarm: bool = True):
        from .runtime.recordio import Channel

        if max_batch < 1:
            raise ValueError("max_batch must be >= 1, got %d" % max_batch)
        self.predictor = predictor
        self.max_batch = max_batch
        # pad every dynamic batch up to its BUCKET (zero rows, sliced off
        # after predict): one step per bucket instead of one per distinct
        # batch size the traffic happens to produce
        self.pad_batches = pad_batches
        self.max_wait_ms = float(max_wait_ms)
        self.in_flight = max(1, int(in_flight))
        if buckets is None:
            buckets, b = [], 1
            while b < max_batch:
                buckets.append(b)
                b *= 2
        self.buckets = sorted({int(b) for b in buckets} | {max_batch})
        self._prewarm = prewarm
        self._prewarmed = False
        self._chan = Channel(capacity)
        self._inflight: "queue.Queue" = queue.Queue(self.in_flight)
        # serializes predictor execution between the device stage and the
        # stacking stage's idle-device inline fast path
        self._dev_lock = threading.Lock()
        self._stack_thread: Optional[threading.Thread] = None
        self._dev_thread: Optional[threading.Thread] = None
        self._results: Dict[int, "_Future"] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self._http = None
        self._http_thread: Optional[threading.Thread] = None
        # diagnostic: executed batches by REAL row count (device thread
        # writes, anyone may read; tests and the serving bench use it)
        self.batch_size_counts: Dict[int, int] = {}

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def start(self):
        if self._dev_thread is not None and self._dev_thread.is_alive():
            return
        if self.pad_batches and self._prewarm and not self._prewarmed:
            # build and capture every bucket's step BEFORE serving: a cold
            # bucket would stall its whole batch (and everything queued
            # behind it) for a capture mid-traffic
            t0 = time.perf_counter()
            for b in self.buckets:
                if not self.predictor.warm(b):
                    break  # dynamic non-batch dims: bucket sigs stay lazy
            self._prewarmed = True
            obs.SERVER_STAGE_MS.observe(
                (time.perf_counter() - t0) * 1e3, stage="prewarm")
        self._stack_thread = threading.Thread(
            target=self._stack_loop, daemon=True)
        self._dev_thread = threading.Thread(
            target=self._device_loop, daemon=True)
        self._stack_thread.start()
        self._dev_thread.start()

    def submit(self, sample: Sequence[np.ndarray]) -> "_Future":
        """sample: one array per feed slot (a single row, no batch dim)."""
        fut = _Future()
        fut._t0 = time.perf_counter()  # request latency incl. queue wait
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._results[rid] = fut
        fut._bind(self, rid)
        tid = _tracing.maybe_start()
        if tid is not None:
            # standalone-server client edge: no wire hop, so the id
            # binds straight into the stage-correlation table
            _tracing.bind_rid(rid, tid)
            _tracing.record_span(tid, "client.submit", rid=rid)
        try:
            sent = self._chan.send(_encode_sample(rid, sample))
        except BaseException:
            # an encode/convert failure must not leak the result-table
            # entry registered above
            with self._lock:
                self._results.pop(rid, None)
            _tracing.pop_rid(rid)
            raise
        if not sent:
            with self._lock:
                self._results.pop(rid, None)
            _tracing.pop_rid(rid)
            raise RuntimeError("predictor server is stopped")
        return fut

    def submit_frame(self, msg) -> "_Future":
        """Submit an ALREADY-ENCODED request frame (the fleet worker's
        fan-in path: the Router forwards the client's wire frame
        verbatim, so the worker re-encodes nothing). The frame's
        embedded tag becomes the request id — the caller owns the tag
        namespace and must not collide with ids minted by ``submit()``
        (a fleet worker only ever receives router-minted tags, so the
        two namespaces never mix in one server)."""
        rid = _rio.frame_tag(msg)
        fut = _Future()
        fut._t0 = time.perf_counter()
        with self._lock:
            if rid in self._results:
                raise ValueError("request tag %d is already in flight"
                                 % rid)
            self._results[rid] = fut
        fut._bind(self, rid)
        if not self._chan.send(msg):
            with self._lock:
                self._results.pop(rid, None)
            raise RuntimeError("predictor server is stopped")
        return fut

    @staticmethod
    def _assemble(rows, nreal: int, bucket: int):
        """Per-slot batch assembly in ONE pass: rows gather (C++ threaded
        memcpy for >=1 MiB payloads, Python loop below it) straight into
        a bucket-sized buffer whose pad tail is zeroed in place — the old
        np.stack + np.concatenate pair copied every padded batch twice.
        A lone unpadded row is returned as a VIEW (no copy at all)."""
        from .runtime.recordio import batch_assemble

        feed = []
        for j in range(len(rows[0])):
            r0 = rows[0][j]
            if nreal == 1 and bucket == 1:
                feed.append(r0[None])
                continue
            slot = [rows[i][j] for i in range(nreal)]
            dt = r0.dtype
            if any(r.dtype != dt for r in slot):
                # mixed-dtype rows promote like np.stack did — filling an
                # r0-typed buffer would silently truncate (0.7 -> 0)
                dt = np.result_type(*[r.dtype for r in slot])
            out = np.empty((bucket,) + r0.shape, dt)
            if not batch_assemble(slot, out[:nreal]):
                for i in range(nreal):
                    if slot[i].shape != r0.shape:
                        # np.stack used to raise here; a bare out[i]=
                        # assignment would silently BROADCAST a
                        # mismatched row into a wrong batch
                        raise ValueError(
                            "sample %d slot %d has shape %s; this batch "
                            "expects %s" % (i, j, slot[i].shape, r0.shape))
                    out[i] = slot[i]
            if bucket > nreal:
                out[nreal:] = 0
            feed.append(out)
        return feed

    # -- pipeline stages --------------------------------------------------
    def _stack_loop(self):
        max_wait_s = self.max_wait_ms / 1e3
        while True:
            batch = self._chan.recv_batch(
                self.max_batch, max_wait_s if max_wait_s > 0 else None)
            if batch is None:
                self._inflight.put(None)  # closed + drained: stop device
                return
            t0 = time.perf_counter()
            reqs = []
            for msg in batch:
                # per-MESSAGE decode: one malformed frame (fuzzed bytes,
                # a torn requeue) must not take down the well-formed
                # requests that happened to share its drain batch. A
                # frame whose HEADER survived still names its request —
                # that future gets a structured reject instead of
                # hanging to its caller's timeout; headerless garbage is
                # counted and dropped.
                try:
                    reqs.append(_decode_request(msg))
                except Exception as e:
                    obs.PREDICT_FAILURES.inc(path="server_decode")
                    try:
                        fut = self._pop(_rio.frame_tag(msg))
                    except Exception:
                        continue
                    if fut is not None:
                        fut.set_exception(ValueError(
                            "malformed request frame rejected: %s"
                            % (e,)))
            if not reqs:
                continue
            try:
                rows = [r[1] for r in reqs]
                nreal = len(rows)
                bucket = (self._bucket_for(nreal) if self.pad_batches
                          else nreal)
                feed = self._assemble(rows, nreal, bucket)
                obs.PREDICT_BATCH_ROWS.observe(nreal, path="server")
                obs.SERVER_BUCKET_FILL.observe(nreal, bucket=str(bucket))
                obs.SERVER_ROWS.inc(nreal, kind="real")
                if bucket > nreal:
                    obs.SERVER_ROWS.inc(bucket - nreal, kind="pad")
                stack_ms = (time.perf_counter() - t0) * 1e3
                obs.SERVER_STAGE_MS.observe(stack_ms, stage="stack")
                if _tracing.bound():
                    for rid, _ in reqs:
                        t_id = _tracing.rid_trace(rid)
                        if t_id is not None:
                            _tracing.record_span(
                                t_id, "server.stack", dur_ms=stack_ms,
                                rid=rid, rows=nreal, bucket=bucket)
                            obs.REQUEST_PHASE_MS.observe(stack_ms,
                                                         phase="stack")
            except Exception:
                # mixed slot counts / row shapes inside ONE drain batch
                # (a mangled-but-decodable frame riding with healthy
                # requests, or genuinely inconsistent clients): degrade
                # to per-request batches so only the offending request
                # fails — the old fan-out failed every co-batched
                # neighbour with the stranger's error
                self._queue_singly(reqs)
                continue
            # idle-device fast path: with nothing queued and the device
            # stage idle, the queue hop + thread wake would be pure added
            # latency — run the batch HERE (under the device lock), so
            # the pipeline collapses to a single stage at low load and
            # expands under load, where the hop pays for itself
            ran_inline = False
            if (self._inflight.empty()
                    and self._dev_lock.acquire(blocking=False)):
                try:
                    self._run_batch(reqs, feed)
                    ran_inline = True
                finally:
                    self._dev_lock.release()
            if not ran_inline:
                self._inflight.put((reqs, feed))
                obs.SERVER_INFLIGHT_DEPTH.set(self._inflight.qsize())

    def _queue_singly(self, reqs):
        """Batch-assembly failure fallback: each request becomes its own
        single-row batch, so assembly/shape errors fail exactly the
        request that caused them (the predictor's own feed checks catch
        arity/shape nonsense per request). The degraded path costs one
        dispatch per request — it only runs when a drain batch was
        internally inconsistent, which healthy uniform traffic never
        is."""
        for req in reqs:
            try:
                bucket = self._bucket_for(1) if self.pad_batches else 1
                feed = self._assemble([req[1]], 1, bucket)
            except Exception as e:
                self._fail([req], e)
                continue
            obs.PREDICT_BATCH_ROWS.observe(1, path="server")
            obs.SERVER_ROWS.inc(1, kind="real")
            self._inflight.put(([req], feed))
            obs.SERVER_INFLIGHT_DEPTH.set(self._inflight.qsize())

    def _device_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                return
            obs.SERVER_INFLIGHT_DEPTH.set(self._inflight.qsize())
            reqs, feed = item
            with self._dev_lock:
                self._run_batch(reqs, feed)

    def _run_batch(self, reqs, feed):
        """Device-stage body: one predictor dispatch, responses fanned
        back out by request id. Caller holds ``_dev_lock``."""
        t0 = time.perf_counter()
        try:
            outs = self.predictor.run(feed, _obs_path="server_batch")
        except Exception as e:  # fan the error out; keep serving
            self._fail(reqs, e)
            return
        dev_ms = (time.perf_counter() - t0) * 1e3
        obs.SERVER_STAGE_MS.observe(dev_ms, stage="device")
        n = len(reqs)
        self.batch_size_counts[n] = self.batch_size_counts.get(n, 0) + 1
        now = time.perf_counter()
        traced = _tracing.bound()
        for i, (rid, _) in enumerate(reqs):
            if traced:
                # span + phase BEFORE _pop — _pop drops the binding
                t_id = _tracing.rid_trace(rid)
                if t_id is not None:
                    _tracing.record_span(t_id, "server.device",
                                         dur_ms=dev_ms, rid=rid, rows=n)
                    obs.REQUEST_PHASE_MS.observe(dev_ms, phase="device")
            fut = self._pop(rid)
            if fut is not None:  # None: abandoned via cancel/timeout
                fut.set_result([o[i] for o in outs])
                obs.PREDICT_LATENCY_MS.observe(
                    (now - fut._t0) * 1e3, path="server")
                obs.PREDICT_REQUESTS.inc(path="server")

    def _fail(self, reqs, e):
        """Error path: every request still gets its latency sample and a
        failure count, so error rates are visible at /metrics (the old
        loop fanned the exception out silently)."""
        now = time.perf_counter()
        for rid, _ in reqs:
            obs.PREDICT_FAILURES.inc(path="server")
            fut = self._pop(rid)
            if fut is not None:
                fut.set_exception(e)
                obs.PREDICT_LATENCY_MS.observe(
                    (now - fut._t0) * 1e3, path="server")

    def _pop(self, rid):
        # every future exit path (fan-out, failure, cancel, malformed-
        # frame reject) funnels here: the trace binding can never leak
        _tracing.pop_rid(rid)
        with self._lock:
            return self._results.pop(rid, None)

    # -- observability endpoint ------------------------------------------
    def start_http(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Expose the process metrics over HTTP for a Prometheus scrape:
        ``GET /metrics`` serves the text exposition of the global
        registry, ``GET /metrics.json`` the JSON snapshot including the
        step timeline. port=0 picks a free port; returns the bound port.
        """
        if self._http is not None:
            return self._http.server_address[1]
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from .observability import export

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(h):  # noqa: N805 — BaseHTTPRequestHandler idiom
                path = h.path.split("?", 1)[0]
                if path == "/metrics":
                    body = export.to_prometheus().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/metrics.json":
                    body = export.dumps_json(indent=2).encode("utf-8")
                    ctype = "application/json"
                else:
                    h.send_response(404)
                    h.end_headers()
                    return
                h.send_response(200)
                h.send_header("Content-Type", ctype)
                h.send_header("Content-Length", str(len(body)))
                h.end_headers()
                h.wfile.write(body)

            def log_message(self, *args):  # scrape spam stays off stderr
                pass

        self._http = ThreadingHTTPServer((host, port), _Handler)
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True)
        self._http_thread.start()
        return self._http.server_address[1]

    def stop_http(self):
        if self._http is None:
            return
        self._http.shutdown()
        self._http.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=5)
            self._http_thread = None
        self._http = None

    def stop(self):
        self.stop_http()
        self._chan.close()
        # the stacking stage drains the channel, forwards the last
        # batches, then sends the device stage its None sentinel
        if self._stack_thread is not None:
            self._stack_thread.join(timeout=5)
            self._stack_thread = None
        if self._dev_thread is not None:
            self._dev_thread.join(timeout=5)
            self._dev_thread = None


class _Future:
    """Completion handle for one submitted sample.

    A ``result(timeout)`` that raises TimeoutError ABANDONS the request:
    its entry in the server's result table is released immediately (the
    pre-pipeline server leaked it until process exit) and the row's
    result or error is silently dropped when its batch completes.
    ``cancel()`` does the same without waiting first.
    """

    def __init__(self):
        self._ev = threading.Event()
        self._val = None
        self._exc = None
        self._t0 = 0.0
        self._t_first = None   # DecodeServer: the first token's host time
        self._server = None
        self._rid = None
        self._cb_lock = threading.Lock()
        self._callbacks: list = []

    def _bind(self, server, rid):
        self._server = server
        self._rid = rid

    def add_done_callback(self, fn):
        """Call ``fn(self)`` when the result or error lands (immediately
        if it already has). Runs on the completing thread (the server's
        device/stacking stage) — keep it short; exceptions are swallowed
        so a broken callback cannot kill the serving loop. The fleet
        worker streams responses back to the router this way instead of
        parking one thread per in-flight request."""
        run_now = False
        with self._cb_lock:
            if self._ev.is_set():
                run_now = True
            else:
                self._callbacks.append(fn)
        if run_now:
            self._run_callback(fn)

    def _run_callback(self, fn):
        try:
            fn(self)
        except Exception:
            pass

    def _fire_callbacks(self):
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            self._run_callback(fn)

    def cancel(self):
        """Drop this request: the server forgets it now and discards its
        result when the batch completes. A result that already arrived
        stays readable."""
        srv, self._server = self._server, None
        if srv is not None and not self._ev.is_set():
            srv._pop(self._rid)

    def set_result(self, v):
        self._val = v
        with self._cb_lock:
            self._ev.set()
        self._fire_callbacks()

    def set_exception(self, e):
        self._exc = e
        with self._cb_lock:
            self._ev.set()
        self._fire_callbacks()

    def result(self, timeout: Optional[float] = None,
               cancel_on_timeout: bool = True):
        """Wait for the row. On timeout the request is ABANDONED (see
        class docstring) unless ``cancel_on_timeout=False``, which keeps
        the entry alive for poll-style callers that intend to re-wait."""
        if not self._ev.wait(timeout):
            if cancel_on_timeout:
                self.cancel()
                raise TimeoutError(
                    "predict result not ready (request abandoned; "
                    "resubmit to retry, or poll with "
                    "cancel_on_timeout=False)")
            raise TimeoutError("predict result not ready")
        if self._exc is not None:
            raise self._exc
        return self._val
