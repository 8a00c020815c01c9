"""Step timeline: a bounded ring buffer of compile events (the part of
paddle_tpu/observability/timeline.py that the servers and the
``/metrics.json`` export use).

Where metrics.py answers "how many / how fast on average", the timeline
answers "what happened, and when". Each built or captured step
(serving/engine.py) appends a compile event (kind, program fingerprint,
wall ms, ``cache="build"`` or ``"capture"``). Per-request serving latency
is NOT a timeline event; it lives in the registry's
``paddle_tpu_predict_latency_ms`` histogram.

The buffer is a ``collections.deque(maxlen=...)``: recording is an O(1)
append and memory is bounded no matter how long the process serves.
Left out: the JAX package's XLA cost analysis (``hlo_cost_stats``) and
its device-time fence, which have no counterpart here.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, Optional

__all__ = ["StepTimeline", "TIMELINE"]

_DEFAULT_CAP = 1024


class StepTimeline:
    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("PADDLE_TPU_TIMELINE_CAP",
                                              _DEFAULT_CAP))
            except ValueError:
                capacity = _DEFAULT_CAP
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=max(1, capacity))
        self._seq = 0          # total events ever recorded

    # -- recording -------------------------------------------------------
    def _append(self, ev: Dict):
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            self._events.append(ev)

    def record_compile(self, kind: str, program: Optional[str] = None, *,
                       wall_ms: Optional[float] = None,
                       cache: str = "miss"):
        """One step made ready: ``cache`` says how ("build": the program
        turned into a step's eager function and buffers; "capture": its
        CUDA graph captured)."""
        ev = {"type": "compile", "ts": time.time(), "kind": kind,
              "cache": cache}
        if program is not None:
            ev["program"] = program
        if wall_ms is not None:
            ev["wall_ms"] = round(wall_ms, 4)
        self._append(ev)

    # -- reading ---------------------------------------------------------
    def snapshot(self) -> Dict:
        """JSON-able view: events oldest-first plus ring-buffer accounting
        (`dropped` = events that aged out of the buffer)."""
        with self._lock:
            events = [dict(e) for e in self._events]
            return {"capacity": self._events.maxlen,
                    "recorded": self._seq,
                    "dropped": self._seq - len(events),
                    "events": events}

    def reset(self):
        with self._lock:
            self._events.clear()
            self._seq = 0


TIMELINE = StepTimeline()
