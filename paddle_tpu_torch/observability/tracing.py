"""Request tracing: per-request spans and a flight recorder (a copy of
paddle_tpu/observability/tracing.py; it imports nothing above
``metrics.process_labels``).

A trace is a ``trace_id`` (16 hex chars, minted once at the client edge)
plus the spans recorded against it while the request moves through a
server: client.submit, server.stack, server.device, decode.admit,
decode.retire. Sampling is decided ONCE, at the client edge
(``maybe_start``): the ``PADDLE_TPU_TRACE_SAMPLE`` rate (default 0.0:
tracing is off and the untraced path is one falsy check per stage).

Each process keeps ONE bounded ``TraceRecorder`` ring (O(1) append,
``dropped`` accounting, never unbounded memory). Multi-stage servers
correlate through a process-local ``rid -> trace_id`` binding table: the
ingress path binds, every stage records via ``rid_span``, and the future
fan-out pops. The ``paddle_tpu_trace_spans_total`` counter hook is
injected by ``observability/__init__`` after the instruments register.

Span timestamps are wall-clock ``time.time()`` starts; ``dur_ms`` may be
0 for instant events.
"""
from __future__ import annotations

import collections
import os
import random
import threading
import time
from typing import Dict, Iterable, List, Optional

from .metrics import process_labels

__all__ = [
    "TraceRecorder", "RECORDER", "get_recorder", "new_trace_id",
    "sample_rate", "set_sample_rate", "sampled", "maybe_start",
    "record_span",
    "bind_rid", "rid_trace", "pop_rid", "rid_span", "bound",
    "process_trace_id", "snapshot", "merge_snapshots", "reset",
]

_DEFAULT_CAP = 4096


def _env_rate() -> float:
    try:
        rate = float(os.environ.get("PADDLE_TPU_TRACE_SAMPLE", "0") or 0.0)
    except ValueError:
        return 0.0
    return min(1.0, max(0.0, rate))


class TraceRecorder:
    """Bounded ring of span records (one per process; see module doc)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("PADDLE_TPU_TRACE_CAP",
                                              _DEFAULT_CAP))
            except ValueError:
                capacity = _DEFAULT_CAP
        self._lock = threading.Lock()
        self._spans = collections.deque(maxlen=max(1, capacity))
        self._seq = 0  # total spans ever recorded

    def record(self, trace_id: str, name: str, *,
               ts: Optional[float] = None, dur_ms: float = 0.0,
               **attrs) -> None:
        """Append one span. ``ts`` defaults to ``now - dur`` (the span
        START; callers time a phase then record it after the fact)."""
        if ts is None:
            ts = time.time() - dur_ms / 1e3
        span = {"trace_id": trace_id, "name": name, "ts": ts,
                "dur_ms": round(float(dur_ms), 4)}
        if attrs:
            span.update(attrs)
        with self._lock:
            span["seq"] = self._seq
            self._seq += 1
            self._spans.append(span)
        if _SPANS_TOTAL is not None:
            _SPANS_TOTAL.inc(phase=name)

    def snapshot(self) -> Dict:
        """JSON-able view: spans oldest-first plus ring accounting
        (``dropped`` = spans that aged out), stamped with this process's
        replica identity (empty string in an unlabeled process)."""
        with self._lock:
            spans = [dict(s) for s in self._spans]
            return {"capacity": self._spans.maxlen,
                    "recorded": self._seq,
                    "dropped": self._seq - len(spans),
                    "replica": process_labels().get("replica", ""),
                    "spans": spans}

    def spans(self, trace_id: Optional[str] = None) -> List[Dict]:
        with self._lock:
            spans = [dict(s) for s in self._spans]
        if trace_id is not None:
            spans = [s for s in spans if s["trace_id"] == trace_id]
        return spans

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._seq = 0


RECORDER = TraceRecorder()

# paddle_tpu_trace_spans_total counter, injected by observability/__init__
# after instrument registration (avoids a circular import at load time)
_SPANS_TOTAL = None

_rate = _env_rate()
_rand = random.Random()

# rid -> trace_id for requests in flight through a multi-stage server in
# THIS process. Bounded by the server's own in-flight bound (futures are
# popped on completion/failure, and _pop hooks pop the binding too).
_rids: Dict[int, str] = {}
_rids_lock = threading.Lock()

# lazily-minted stable id for process-scoped spans (trainer steps,
# profiler events) that belong to no request
_proc_tid: Optional[str] = None


def get_recorder() -> TraceRecorder:
    return RECORDER


def new_trace_id() -> str:
    """16 hex chars of OS entropy — unique across the fleet's processes
    (a PRNG seeded identically in forked workers would collide)."""
    return os.urandom(8).hex()


def sample_rate() -> float:
    return _rate


def set_sample_rate(rate: float) -> None:
    """Runtime override of ``PADDLE_TPU_TRACE_SAMPLE`` for THIS process.
    Only processes that mint traces (clients / the router) need it —
    workers record on header arrival and never consult the rate."""
    global _rate
    _rate = min(1.0, max(0.0, float(rate)))


def sampled() -> bool:
    """One rate check with no id minting — for process-scoped spans
    (trainer steps) that rate-sample individually and record under
    ``process_trace_id()`` instead of a per-request trace."""
    if _rate <= 0.0:
        return False
    return _rate >= 1.0 or _rand.random() < _rate


def maybe_start() -> Optional[str]:
    """The ONE sampling decision, at the client edge: a fresh trace_id
    at the configured rate, else None (request travels untraced on the
    byte-identical pre-trace wire form)."""
    if _rate <= 0.0:
        return None
    if _rate < 1.0 and _rand.random() >= _rate:
        return None
    return new_trace_id()


def record_span(trace_id: str, name: str, *, ts: Optional[float] = None,
                dur_ms: float = 0.0, **attrs) -> None:
    RECORDER.record(trace_id, name, ts=ts, dur_ms=dur_ms, **attrs)


def process_trace_id() -> str:
    """Stable trace_id for process-scoped spans (train steps, profiler
    events) — one synthetic 'trace' per process lifetime."""
    global _proc_tid
    if _proc_tid is None:
        _proc_tid = "proc" + new_trace_id()[:12]
    return _proc_tid


# -- rid binding (multi-stage servers) -----------------------------------

def bind_rid(rid: int, trace_id: str) -> None:
    with _rids_lock:
        _rids[rid] = trace_id


def rid_trace(rid: int) -> Optional[str]:
    if not _rids:  # the common untraced case: one falsy check, no lock
        return None
    with _rids_lock:
        return _rids.get(rid)


def pop_rid(rid: int) -> Optional[str]:
    if not _rids:
        return None
    with _rids_lock:
        return _rids.pop(rid, None)


def bound() -> bool:
    """True iff any in-flight request in this process is traced — the
    cheap gate server stage loops check before doing span bookkeeping."""
    return bool(_rids)


def rid_span(rid: int, name: str, *, dur_ms: float = 0.0,
             **attrs) -> None:
    """Record a span against the trace bound to ``rid``, if any. The
    untraced fast path is one falsy dict check."""
    tid = rid_trace(rid)
    if tid is not None:
        RECORDER.record(tid, name, dur_ms=dur_ms, **attrs)


# -- snapshots / fleet merge ---------------------------------------------

def snapshot() -> Dict:
    return RECORDER.snapshot()


def merge_snapshots(snaps: Iterable[Dict]) -> Dict:
    """One fleet-wide span list from per-process recorder snapshots
    (the ``merge_json_snapshots`` idea, for traces): each span is
    stamped with its origin replica, the whole list is ts-sorted so a
    single trace reads as a waterfall, and ring accounting sums."""
    spans: List[Dict] = []
    replicas: List[str] = []
    recorded = dropped = 0
    for snap in snaps:
        if not snap:
            continue
        replica = snap.get("replica", "") or "router"
        replicas.append(replica)
        recorded += int(snap.get("recorded", 0))
        dropped += int(snap.get("dropped", 0))
        for s in snap.get("spans", ()):
            s = dict(s)
            s.setdefault("replica", replica)
            spans.append(s)
    spans.sort(key=lambda s: (s["trace_id"], s["ts"], s.get("seq", 0)))
    return {"replicas": replicas, "recorded": recorded,
            "dropped": dropped, "spans": spans}


def reset() -> None:
    """Clear the ring AND the rid binding table (test isolation; the
    ``observability.reset_all()`` hook)."""
    RECORDER.reset()
    with _rids_lock:
        _rids.clear()
