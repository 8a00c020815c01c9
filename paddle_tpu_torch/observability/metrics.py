"""Structured metrics registry: counters, gauges, histograms, summaries
(a copy of paddle_tpu/observability/metrics.py).

An always-on substrate for the questions a running job asks at any
moment (how many batches went by which transport, how long a consumer
waited), not only inside a start/stop profiling window: recording is a
dict update under a lock (sub-microsecond), nothing is formatted or
aggregated until somebody reads (export.py), and the whole thing resets
in O(metrics).

Metric types:
- Counter: monotonically increasing float (``.inc()``).
- Gauge: last-write-wins float (``.set()`` / ``.inc()``).
- Histogram: fixed-bucket latency/size distribution (``.observe()``);
  buckets are upper bounds, +Inf is implicit. Default buckets are
  latency-in-ms shaped.
- Summary: exact count/sum/min/max (``.observe()``).

All types take free-form labels as keyword arguments; each distinct label
combination is an independent series, exactly the Prometheus data model.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Summary", "MetricRegistry",
    "REGISTRY", "get_registry", "DEFAULT_LATENCY_BUCKETS_MS",
    "DEFAULT_SIZE_BUCKETS", "set_replica", "process_labels",
]

# -- process identity ------------------------------------------------------
#
# N fleet workers all export the same metric names; a scrape/merge of
# their payloads needs a per-process label or the series collide. When a
# replica identity is set — via PADDLE_TPU_REPLICA at import, or
# set_replica() at runtime — every exported series (export.py) carries
# ``replica="<name|pid>"``. Unset (the default, every pre-fleet process)
# the exposition is byte-identical to before.

_PROCESS_LABELS: Dict[str, str] = {}
if os.environ.get("PADDLE_TPU_REPLICA"):
    _PROCESS_LABELS["replica"] = os.environ["PADDLE_TPU_REPLICA"]


def set_replica(name: Optional[str] = None):
    """Tag this process's metric exports with ``replica=name`` (the pid
    when name is None) — call once at fleet-worker startup."""
    _PROCESS_LABELS["replica"] = (str(name) if name is not None
                                  else str(os.getpid()))


def process_labels() -> Dict[str, str]:
    """Constant labels stamped onto every exported series ({} unless a
    replica identity was set)."""
    return dict(_PROCESS_LABELS)

# latency buckets in milliseconds: sub-ms serving hits through multi-minute
# compiles and captures all land in a finite bucket before +Inf
DEFAULT_LATENCY_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0, 300000.0,
)

# power-of-two-ish count buckets (batch sizes, window lengths)
DEFAULT_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._series: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def _reset(self):
        self._series.clear()

    def remove(self, **labels):
        """Retire one label series (e.g. a closed Executor's depth gauge
        — without this, per-instance series outlive their instance and
        grow the registry and every exposition payload unboundedly)."""
        with self._lock:
            self._series.pop(_label_key(labels), None)

    def samples(self) -> List[Tuple[Dict[str, str], object]]:
        """[(labels_dict, value)] snapshot; value shape depends on kind."""
        with self._lock:
            return [(dict(k), self._copy_value(v))
                    for k, v in self._series.items()]

    @staticmethod
    def _copy_value(v):
        return v


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up (got %r)" % amount)
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def total(self) -> float:
        """Sum over every label combination."""
        with self._lock:
            return float(sum(self._series.values()))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels):
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Histogram(_Metric):
    """Fixed upper-bound buckets; per-series value is
    [bucket_counts..., overflow_count, sum, count]."""

    kind = "histogram"

    def __init__(self, name, help, lock,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS):
        super().__init__(name, help, lock)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram %r needs at least one bucket" % name)
        self.buckets = bs

    def observe(self, value: float, **labels):
        key = _label_key(labels)
        with self._lock:
            v = self._series.get(key)
            if v is None:
                v = [0] * (len(self.buckets) + 1) + [0.0, 0]
                self._series[key] = v
            i = 0
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    break
            else:
                i = len(self.buckets)  # overflow (+Inf only)
            v[i] += 1
            v[-2] += float(value)
            v[-1] += 1

    @staticmethod
    def _copy_value(v):
        return list(v)

    def stats(self, **labels) -> Dict[str, float]:
        """{'count', 'sum', 'mean'} for one series ({} labels = unlabeled)."""
        with self._lock:
            v = self._series.get(_label_key(labels))
        if v is None:
            return {"count": 0, "sum": 0.0, "mean": 0.0}
        count, total = v[-1], v[-2]
        return {"count": count, "sum": total,
                "mean": (total / count) if count else 0.0}


class Summary(_Metric):
    """Exact count/sum/min/max per series — the legacy profiler's event
    table (min/max cannot be reconstructed from histogram buckets)."""

    kind = "summary"

    def observe(self, value: float, **labels):
        key = _label_key(labels)
        value = float(value)
        with self._lock:
            v = self._series.get(key)
            if v is None:
                self._series[key] = [1, value, value, value]
            else:
                v[0] += 1
                v[1] += value
                if value < v[2]:
                    v[2] = value
                if value > v[3]:
                    v[3] = value

    @staticmethod
    def _copy_value(v):
        return list(v)

    def stats(self, **labels) -> Dict[str, float]:
        with self._lock:
            v = self._series.get(_label_key(labels))
        if v is None:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0}
        return {"count": v[0], "sum": v[1], "min": v[2], "max": v[3]}


class MetricRegistry:
    """Process-wide metric namespace. Registration is idempotent: asking
    for an existing name returns the existing metric (executors and
    predictors are constructed freely; their metrics are shared), but a
    kind mismatch on an existing name is a hard error."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        "metric %r already registered as %s, not %s"
                        % (name, m.kind, cls.kind))
                return m
            m = cls(name, help, self._lock, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def summary(self, name: str, help: str = "") -> Summary:
        return self._get_or_create(Summary, name, help)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> Iterable[_Metric]:
        """Metrics in registration order (stable exposition output)."""
        with self._lock:
            return list(self._metrics.values())

    def reset(self):
        """Zero every series; registered metrics stay registered."""
        with self._lock:
            for m in self._metrics.values():
                m._reset()


REGISTRY = MetricRegistry()


def get_registry() -> MetricRegistry:
    return REGISTRY

