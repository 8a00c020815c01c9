"""Exposition: Prometheus text format and JSON snapshots of the registry
(a copy of paddle_tpu/observability/export.py).

``to_prometheus()`` renders the registry in the Prometheus text exposition
format (version 0.0.4): the payload the servers' ``/metrics`` endpoint
serves and a scrape job ingests directly. ``to_json()`` bundles the same
data with the compile timeline (timeline.py), as ``/metrics.json`` serves
it. (The JAX package's before/after deltas and its fleet merge of several
processes' dumps wait for the fleet.)
"""
from __future__ import annotations

import json
import math
from typing import Dict, Optional

from .metrics import (Counter, Gauge, Histogram, MetricRegistry, Summary,
                      REGISTRY, process_labels)
from .timeline import TIMELINE, StepTimeline

__all__ = ["to_prometheus", "to_json", "dumps_json"]


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_str(labels: Dict[str, str], extra: Optional[Dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join('%s="%s"' % (k, _escape(v))
                    for k, v in sorted(items.items()))
    return "{%s}" % body


def _fmt(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def to_prometheus(registry: Optional[MetricRegistry] = None) -> str:
    """Prometheus text exposition of every registered metric. Metrics with
    no series yet still emit HELP/TYPE plus (for unlabeled counters and
    gauges) an explicit 0 sample, so scrape dashboards see the full
    catalogue from the first scrape."""
    registry = registry or REGISTRY
    proc = process_labels()  # replica identity, when set (fleet workers)
    out = []
    for m in registry.collect():
        samples = [(dict(proc, **labels), v) for labels, v in m.samples()]
        kind = "summary" if isinstance(m, Summary) else m.kind
        out.append("# HELP %s %s" % (m.name, _escape(m.help or m.name)))
        out.append("# TYPE %s %s" % (m.name, kind))
        if isinstance(m, (Counter, Gauge)):
            if not samples:
                out.append("%s%s 0" % (m.name, _labels_str(proc)))
            for labels, value in samples:
                out.append("%s%s %s" % (m.name, _labels_str(labels),
                                        _fmt(value)))
        elif isinstance(m, Histogram):
            for labels, v in samples:
                cum = 0
                for ub, n in zip(m.buckets, v[:len(m.buckets)]):
                    cum += n
                    out.append("%s_bucket%s %d" % (
                        m.name, _labels_str(labels, {"le": _fmt(ub)}), cum))
                cum += v[len(m.buckets)]  # overflow
                out.append("%s_bucket%s %d" % (
                    m.name, _labels_str(labels, {"le": "+Inf"}), cum))
                out.append("%s_sum%s %s" % (m.name, _labels_str(labels),
                                            _fmt(v[-2])))
                out.append("%s_count%s %d" % (m.name, _labels_str(labels),
                                              v[-1]))
        elif isinstance(m, Summary):
            for labels, v in samples:
                ls = _labels_str(labels)
                out.append("%s_count%s %d" % (m.name, ls, v[0]))
                out.append("%s_sum%s %s" % (m.name, ls, _fmt(v[1])))
                out.append("%s_min%s %s" % (m.name, ls, _fmt(v[2])))
                out.append("%s_max%s %s" % (m.name, ls, _fmt(v[3])))
    return "\n".join(out) + "\n"


def to_json(registry: Optional[MetricRegistry] = None,
            timeline: Optional[StepTimeline] = None,
            include_timeline: bool = True) -> Dict:
    """JSON-able snapshot: {"metrics": {name: {kind, help, series}},
    "timeline": <timeline snapshot>}."""
    registry = registry or REGISTRY
    proc = process_labels()
    metrics = {}
    for m in registry.collect():
        series = []
        for labels, v in m.samples():
            labels = dict(proc, **labels)
            if isinstance(m, Histogram):
                series.append({"labels": labels,
                               "buckets": dict(zip(
                                   [_fmt(b) for b in m.buckets] + ["+Inf"],
                                   v[:len(m.buckets) + 1])),
                               "sum": v[-2], "count": v[-1]})
            elif isinstance(m, Summary):
                series.append({"labels": labels, "count": v[0], "sum": v[1],
                               "min": v[2], "max": v[3]})
            else:
                series.append({"labels": labels, "value": v})
        metrics[m.name] = {"kind": m.kind, "help": m.help, "series": series}
    out = {"metrics": metrics}
    if proc:
        out["replica"] = proc.get("replica")
    if include_timeline:
        out["timeline"] = (timeline or TIMELINE).snapshot()
    return out


def dumps_json(registry: Optional[MetricRegistry] = None,
               timeline: Optional[StepTimeline] = None,
               indent: Optional[int] = None,
               include_timeline: bool = True) -> str:
    return json.dumps(to_json(registry, timeline, include_timeline),
                      indent=indent, sort_keys=True)
