"""paddle_tpu_torch.observability: the metric registry (metrics.py, a copy
of the JAX package's), its export (export.py: Prometheus text and JSON),
the compile timeline (timeline.py), request tracing (tracing.py, a copy),
and the series the ported paths write, under the JAX package's names,
kinds, labels, buckets and help texts:

- the Engine's builds and captures and its step cache: ``COMPILE_*``,
  ``CACHE_*`` (serving/engine.py; a build or a capture is the port's
  compile);
- the servers: ``PREDICT_*``, ``SERVER_*`` (inference.py
  ``PredictorServer``), ``DECODE_*`` (serving/decode.py), and
  ``REQUEST_PHASE_MS`` / ``TRACE_SPANS`` for traced requests;
- the input path: the DataLoader's five ``paddle_tpu_loader_*`` series and
  the recordio readers' skipped-input counter.

The rest of the JAX package's series (executor steps, AOT cache, fleet,
checkpoints, transpiler, quantization) wait for the modules that write
them.
"""
from __future__ import annotations

from . import export, metrics, timeline, tracing  # noqa: F401
from .export import to_json, to_prometheus  # noqa: F401
from .metrics import (  # noqa: F401
    DEFAULT_SIZE_BUCKETS, MetricRegistry, REGISTRY, get_registry,
    process_labels, set_replica,
)
from .timeline import TIMELINE, StepTimeline  # noqa: F401

__all__ = [
    "REGISTRY", "TIMELINE", "get_registry",
    "MetricRegistry", "StepTimeline", "metrics", "timeline", "export",
    "tracing", "to_prometheus", "to_json", "set_replica", "process_labels",
    "reset_all",
    "COMPILE_TOTAL", "COMPILE_LATENCY_MS", "CACHE_HITS", "CACHE_MISSES",
    "CACHE_EVICTIONS", "PREDICT_LATENCY_MS", "PREDICT_REQUESTS",
    "PREDICT_BATCH_ROWS", "PREDICT_FAILURES", "SERVER_ROWS",
    "SERVER_BUCKET_FILL", "SERVER_INFLIGHT_DEPTH", "SERVER_STAGE_MS",
    "LOADER_BATCHES", "LOADER_BLOCKED_MS", "LOADER_WORKER_BUSY_MS",
    "LOADER_QUEUE_DEPTH", "LOADER_WORKERS", "DECODE_TOKENS", "DECODE_SLOTS",
    "DECODE_STEP_MS", "DECODE_REQUESTS", "DECODE_PREFIX_QUERIES",
    "DECODE_PREFIX_HITS", "DECODE_PREFIX_BYTES", "DECODE_SPEC_PROPOSED",
    "DECODE_SPEC_ACCEPTED", "TRAIN_SKIPPED_BATCHES",
    "REQUEST_PHASE_MS", "TRACE_SPANS",
]

COMPILE_TOTAL = REGISTRY.counter(
    "paddle_tpu_compile_total",
    "Program compilations (trace + XLA compile), by executor kind")
COMPILE_LATENCY_MS = REGISTRY.histogram(
    "paddle_tpu_compile_latency_ms",
    "Wall time of each compilation (first call: trace+compile+run)")
CACHE_HITS = REGISTRY.counter(
    "paddle_tpu_compile_cache_hits_total",
    "Compile-cache hits, by kind, program fingerprint, and "
    "tier=memory|disk (disk = persistent AOT executable store)")
CACHE_MISSES = REGISTRY.counter(
    "paddle_tpu_compile_cache_misses_total",
    "Compile-cache misses, by kind, program fingerprint, and "
    "tier=memory|disk")
CACHE_EVICTIONS = REGISTRY.counter(
    "paddle_tpu_compile_cache_evictions_total",
    "Compile-cache LRU evictions (cap: PADDLE_TPU_COMPILE_CACHE_MAX)")
PREDICT_LATENCY_MS = REGISTRY.histogram(
    "paddle_tpu_predict_latency_ms",
    "Predictor request latency (path=direct|server; server includes queue "
    "wait)")
PREDICT_REQUESTS = REGISTRY.counter(
    "paddle_tpu_predict_requests_total", "Predictor requests served")
PREDICT_BATCH_ROWS = REGISTRY.histogram(
    "paddle_tpu_predict_batch_rows",
    "Rows per executed predict batch (server: dynamic batch fill)",
    buckets=DEFAULT_SIZE_BUCKETS)
PREDICT_FAILURES = REGISTRY.counter(
    "paddle_tpu_predict_failures_total",
    "Predict requests completed with an error, by path (error rate = "
    "this / paddle_tpu_predict_requests_total)")
SERVER_ROWS = REGISTRY.counter(
    "paddle_tpu_server_rows_total",
    "Rows through the serving device stage, kind=real|pad "
    "(pad-waste ratio = pad / (real + pad))")
SERVER_BUCKET_FILL = REGISTRY.histogram(
    "paddle_tpu_server_bucket_fill",
    "Real rows per executed server batch, labeled by the padded bucket "
    "size it ran at (fill efficiency per compiled signature)",
    buckets=DEFAULT_SIZE_BUCKETS)
SERVER_INFLIGHT_DEPTH = REGISTRY.gauge(
    "paddle_tpu_server_inflight_depth",
    "Stacked batches waiting for the serving device stage right now "
    "(0 = device-bound, at capacity = host-bound)")
SERVER_STAGE_MS = REGISTRY.histogram(
    "paddle_tpu_server_stage_ms",
    "Per-batch wall time of each serving pipeline stage "
    "(stage=stack|device)")
LOADER_BATCHES = REGISTRY.counter(
    "paddle_tpu_loader_batches_total",
    "DataLoader batches delivered, by loader and transport="
    "shm|pickle|inline (pickle = batch outgrew the slot or object dtype)")
LOADER_BLOCKED_MS = REGISTRY.counter(
    "paddle_tpu_loader_blocked_ms_total",
    "Time DataLoader consumers spent blocked in next() (starvation "
    "fraction = this / wall time)")
LOADER_WORKER_BUSY_MS = REGISTRY.counter(
    "paddle_tpu_loader_worker_busy_ms_total",
    "Summed DataLoader worker decode+assemble time (utilization = this / "
    "(workers x wall time))")
LOADER_QUEUE_DEPTH = REGISTRY.gauge(
    "paddle_tpu_loader_queue_depth",
    "Ready DataLoader batches buffered consumer-side right now "
    "(0 while blocked = workers can't keep up)")
LOADER_WORKERS = REGISTRY.gauge(
    "paddle_tpu_loader_workers", "Worker processes per running DataLoader")
DECODE_TOKENS = REGISTRY.counter(
    "paddle_tpu_decode_tokens_total",
    "Tokens generated by the KV-cache decode path, by kind=prefill "
    "(prompt tokens absorbed) | decode (sampled tokens)")
DECODE_SLOTS = REGISTRY.gauge(
    "paddle_tpu_decode_slots",
    "Continuous-batching cache-slot occupancy, state=active|free "
    "(active at the slot cap with a non-empty admission queue = grow "
    "slots or add replicas)")
DECODE_STEP_MS = REGISTRY.histogram(
    "paddle_tpu_decode_step_ms",
    "Wall time per decode iteration, stage=prefill (one admission "
    "sub-batch) | step (one token across every active slot)")
DECODE_REQUESTS = REGISTRY.counter(
    "paddle_tpu_decode_requests_total",
    "Decode-serving sequences, kind=admitted (entered a cache slot) | "
    "retired (finished and freed it); admitted - retired = in flight")
DECODE_PREFIX_QUERIES = REGISTRY.counter(
    "paddle_tpu_decode_prefix_queries_total",
    "Shared-prefix store lookups at admission (one per admitted "
    "prompt when prefix sharing is on)")
DECODE_PREFIX_HITS = REGISTRY.counter(
    "paddle_tpu_decode_prefix_hits_total",
    "Shared-prefix store hits, by kind=full (whole prompt served from "
    "cached K/V rows) | partial (cached header + suffix extension) | "
    "batch (deduped against an identical prompt admitted in the same "
    "sub-batch); hit rate = hits / queries — the ROADMAP-named signal")
DECODE_PREFIX_BYTES = REGISTRY.gauge(
    "paddle_tpu_decode_prefix_bytes",
    "Resident bytes of prefilled K/V rows in the shared-prefix store "
    "(bounded by PADDLE_TPU_PREFIX_CACHE_MAX_BYTES; refcounted entries "
    "are eviction-exempt while sequences decode from them)")
DECODE_SPEC_PROPOSED = REGISTRY.counter(
    "paddle_tpu_decode_spec_proposed_total",
    "Draft tokens proposed to speculative verify windows")
DECODE_SPEC_ACCEPTED = REGISTRY.counter(
    "paddle_tpu_decode_spec_accepted_total",
    "Draft tokens the target accepted; acceptance rate = accepted / "
    "proposed — the signal that decides whether speculation pays "
    "(each verified round also emits one bonus token not counted here)")
TRAIN_SKIPPED_BATCHES = REGISTRY.counter(
    "paddle_tpu_train_skipped_batches_total",
    "Input the hardened training data plane dropped instead of "
    "crashing or poisoning parameters, by reason=nonfinite (in-graph "
    "NaN/Inf sentinel zeroed the update and quarantined the batch) | "
    "corrupt_chunk (tolerant recordio chunk skip+resync) | "
    "corrupt_record (record whose payload no longer unpickles)")
REQUEST_PHASE_MS = REGISTRY.histogram(
    "paddle_tpu_request_phase_ms",
    "Per-phase latency attribution of TRACED serving requests, by "
    "phase=queue (router admission -> dispatch) | service (dispatch -> "
    "reply, the whole worker round trip) | stack | device (the worker-"
    "side stages) | total (submit -> reply). Folded from trace spans as "
    "requests complete, so mass appears only while "
    "PADDLE_TPU_TRACE_SAMPLE > 0 — the attributed view of "
    "paddle_tpu_predict_latency_ms")
TRACE_SPANS = REGISTRY.counter(
    "paddle_tpu_trace_spans_total",
    "Trace spans recorded by this process's flight recorder, by "
    "phase=span name (client.submit, router.dispatch, worker.recv, "
    "server.device, decode.retire, ...) — nonzero means sampling is "
    "live; compare against the recorder's dropped count in /trace.json")
tracing._SPANS_TOTAL = TRACE_SPANS


def reset_all():
    """Zero the registry and clear the timeline and the trace recorder."""
    REGISTRY.reset()
    TIMELINE.reset()
    tracing.reset()
