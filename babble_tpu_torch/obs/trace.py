"""Bounded ring-buffer span tracer with Chrome trace-event export.

Spans are recorded into a fixed-capacity ring: constant memory, O(1)
record, oldest spans silently dropped once the ring wraps. The export
shape is the Chrome trace-event JSON format (complete "X" events), so
`GET /debug/trace` output loads directly in Perfetto / chrome://tracing.

Timestamps come exclusively from the injected Clock seam — the tracer
itself never touches wall time, so it is byte-deterministic under the
simulator's SimClock.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

from ..common.clock import Clock, SYSTEM_CLOCK

DEFAULT_SPAN_CAPACITY = 4096


class Span:
    __slots__ = ("name", "start", "duration", "attrs", "thread")

    def __init__(self, name: str, start: float, duration: float,
                 attrs: Optional[dict], thread: str):
        self.name = name
        self.start = start
        self.duration = duration
        self.attrs = attrs
        self.thread = thread


class SpanTracer:
    """Fixed-capacity span ring. Thread-safe; wraps by overwriting."""

    def __init__(self, clock: Optional[Clock] = None,
                 capacity: int = DEFAULT_SPAN_CAPACITY):
        if capacity < 1:
            raise ValueError("span capacity must be >= 1")
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: List[Optional[Span]] = [None] * capacity  # guarded-by: _lock
        self._next = 0  # guarded-by: _lock — total spans ever recorded
        self.dropped = 0  # guarded-by: _lock — overwritten by ring wrap

    def record(self, name: str, start: float, duration: float,
               attrs: Optional[dict] = None) -> None:
        sp = Span(name, start, duration, attrs,
                  threading.current_thread().name)
        with self._lock:
            if self._next >= self.capacity and \
                    self._ring[self._next % self.capacity] is not None:
                self.dropped += 1
            self._ring[self._next % self.capacity] = sp
            self._next += 1

    @contextmanager
    def span(self, name: str, histogram=None, **attrs):
        """Time a block: one clock-read pair records a span and (if given)
        feeds the same duration into `histogram.observe`."""
        start = self.clock.monotonic()
        try:
            yield
        finally:
            duration = self.clock.monotonic() - start
            self.record(name, start, duration, attrs or None)
            if histogram is not None:
                histogram.observe(duration)

    def spans(self) -> List[Span]:
        """Retained spans, oldest first."""
        with self._lock:
            if self._next <= self.capacity:
                return [s for s in self._ring[: self._next] if s is not None]
            head = self._next % self.capacity
            return [s for s in self._ring[head:] + self._ring[:head]
                    if s is not None]

    def to_chrome_trace(self, pid: int = 0,
                        trace_id: Optional[str] = None) -> dict:
        """Chrome trace-event JSON: complete ("X") events, µs timestamps,
        plus thread_name metadata so Perfetto shows real thread names.
        `trace_id` narrows the export to spans carrying that causal-trace
        id in their attrs (the /debug/trace?trace_id= filter)."""
        spans = self.spans()
        if trace_id is not None:
            spans = [sp for sp in spans
                     if sp.attrs and sp.attrs.get("trace") == trace_id]
        tids: Dict[str, int] = {}
        events: List[dict] = []
        for sp in spans:
            tid = tids.setdefault(sp.thread, len(tids))
            ev = {
                "name": sp.name,
                "ph": "X",
                "ts": round(sp.start * 1e6, 3),
                "dur": round(sp.duration * 1e6, 3),
                "pid": pid,
                "tid": tid,
            }
            if sp.attrs:
                ev["args"] = sp.attrs
            events.append(ev)
        meta = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": thread}}
            for thread, tid in sorted(tids.items(), key=lambda kv: kv[1])
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}
