"""paddle_tpu_torch.observability: the metric registry (metrics.py, a copy
of the JAX package's) and the series the ported input path writes, under
the JAX package's names and help texts: the DataLoader's five
``paddle_tpu_loader_*`` series and the recordio readers' skipped-input
counter. The rest of the JAX package's observability (timeline, tracing,
the executor's and servers' series) is not ported yet."""
from __future__ import annotations

from . import metrics  # noqa: F401
from .metrics import (  # noqa: F401
    DEFAULT_SIZE_BUCKETS, MetricRegistry, REGISTRY, get_registry,
    process_labels, set_replica, to_prometheus,
)

__all__ = [
    "REGISTRY", "get_registry", "MetricRegistry", "metrics",
    "to_prometheus", "set_replica", "process_labels",
    "LOADER_BATCHES", "LOADER_BLOCKED_MS", "LOADER_WORKER_BUSY_MS",
    "LOADER_QUEUE_DEPTH", "LOADER_WORKERS", "TRAIN_SKIPPED_BATCHES",
]

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
TRAIN_SKIPPED_BATCHES = REGISTRY.counter(
    "paddle_tpu_train_skipped_batches_total",
    "Input the hardened training data plane dropped instead of "
    "crashing or poisoning parameters, by reason=nonfinite (in-graph "
    "NaN/Inf sentinel zeroed the update and quarantined the batch) | "
    "corrupt_chunk (tolerant recordio chunk skip+resync) | "
    "corrupt_record (record whose payload no longer unpickles)")
