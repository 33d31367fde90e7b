"""Black-box flight recorder.

A bounded, Clock-timestamped ring of typed structured records — the
"what was the node doing just before it went wrong" counterpart to the
metrics registry's "how much" and the span tracer's "how long". Call
sites across the consensus stack append small named records (backend
ladder transitions, dispatch-queue lifecycle, watchdog stall episodes,
fame re-openings, resets, fork evidence, sig-backlog pressure); the
ring keeps the most recent ``capacity`` of them and is dumped wholesale
when something trips: a watchdog stall, a DivergenceChecker failure, a
demotion flap, an SLO breach, or a crash.

Determinism contract (the sim's byte-equality gates depend on it):

- every record is timestamped through the injected Clock, never the OS
  clock, so same-seed sim runs produce byte-identical record streams;
- record fields must be deterministic values (rounds, counts, Clock
  durations) — no thread names, object ids or wall-clock times;
- ``stream_bytes()`` is canonical sorted-key JSON and its sha256
  (``fingerprint()``) joins ``SimCluster.result()``'s determinism
  fingerprint alongside the block digest and trace fingerprint;
- dump artifact filenames are deterministic (node id + dump ordinal +
  reason — no timestamps), so replay artifacts line up across runs.

Record names are static string literals at call sites, enforced by the
`obs-flightrec-static-name` lint rule (analysis/obs.py) — receivers
must be *named* ``flightrec`` (e.g. ``obs.flightrec``) for the rule to
see them, which doubles as a naming convention.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from ..common.clock import Clock, SYSTEM_CLOCK

# ring capacity: ~2k records is minutes of context at consensus rates
# while keeping a dump artifact comfortably under a megabyte
DEFAULT_FLIGHT_CAPACITY = 2048

# dumps held in memory when no dump_dir is configured (the sim runs
# file-free; the sweep exports these on failure)
MAX_DUMP_DOCS = 8

# Clock seconds between dumps: the FIRST trigger in a failure episode
# captures the interesting ring; a stall, its SLO breach and a demotion
# flap milliseconds later would dump near-identical copies otherwise
DEFAULT_DUMP_SUPPRESS_S = 30.0

# events within this Clock window counting toward a flap before the
# recorder self-dumps (e.g. 3 backend demotions in 10s)
FLAP_WINDOW_S = 10.0
FLAP_THRESHOLD = 3


class FlightRecord:
    """One typed record: monotonically increasing ``seq``, Clock time
    ``t``, static ``name`` and a small dict of deterministic fields."""

    __slots__ = ("seq", "t", "name", "fields")

    def __init__(self, seq: int, t: float, name: str,
                 fields: Dict[str, Any]):
        self.seq = seq
        self.t = t
        self.name = name
        self.fields = fields

    def to_dict(self) -> Dict[str, Any]:
        # floats rounded so accumulated Clock arithmetic renders stably
        fields = {
            k: (round(v, 9) if isinstance(v, float) else v)
            for k, v in self.fields.items()
        }
        return {
            "seq": self.seq,
            "t": round(self.t, 9),
            "name": self.name,
            "fields": fields,
        }


class FlightRecorder:
    """Bounded ring of FlightRecords with triggered whole-ring dumps."""

    def __init__(self, clock: Optional[Clock] = None, node_id: int = 0,
                 capacity: int = DEFAULT_FLIGHT_CAPACITY,
                 dump_dir: Optional[str] = None,
                 logger: Optional[logging.Logger] = None,
                 dump_suppress_s: float = DEFAULT_DUMP_SUPPRESS_S):
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.node_id = node_id
        self.capacity = max(1, capacity)
        self.dump_dir = dump_dir
        self.logger = logger if logger is not None else logging.getLogger(
            "babble.flightrec"
        )
        self.dump_suppress_s = dump_suppress_s
        self._lock = threading.Lock()
        # guarded-by: _lock — fixed ring, same discipline as SpanTracer
        self._ring: List[Optional[FlightRecord]] = [None] * self.capacity
        self._next = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock — overwritten records
        self.dumps = 0  # guarded-by: _lock — dumps emitted (not suppressed)
        self.dumps_suppressed = 0  # guarded-by: _lock
        self.dump_docs: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._last_dump_at: Optional[float] = None  # guarded-by: _lock
        # guarded-by: _lock — recent event times per flap kind
        self._flap_times: Dict[str, Deque[float]] = {}

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------

    def record(self, name: str, **fields: Any) -> None:
        """Append one record. ``name`` must be a static string literal
        at the call site (obs-flightrec-static-name); fields must be
        deterministic values — no wall-clock, no thread identity."""
        t = self.clock.monotonic()
        with self._lock:
            slot = self._next % self.capacity
            if self._ring[slot] is not None:
                self.dropped += 1
            self._ring[slot] = FlightRecord(self._next, t, name, fields)
            self._next += 1

    def note_flap(self, kind: str) -> Optional[str]:
        """Count one event toward a flap; auto-dump when FLAP_THRESHOLD
        land within FLAP_WINDOW_S of Clock time (e.g. a node bouncing
        between backend rungs). Returns the dump path when one fired."""
        now = self.clock.monotonic()
        with self._lock:
            times = self._flap_times.get(kind)
            if times is None:
                times = self._flap_times[kind] = deque(maxlen=FLAP_THRESHOLD)
            times.append(now)
            flapping = (
                len(times) >= FLAP_THRESHOLD
                and now - times[0] <= FLAP_WINDOW_S
            )
        if flapping:
            return self.dump(kind + "-flap", window_s=FLAP_WINDOW_S,
                             events=FLAP_THRESHOLD)
        return None

    # ------------------------------------------------------------------
    # reading
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return min(self._next, self.capacity)

    def records(self) -> List[FlightRecord]:
        """Snapshot, oldest first (same wrap logic as SpanTracer)."""
        with self._lock:
            head = self._next % self.capacity
            ordered = self._ring[head:] + self._ring[:head]
        return [r for r in ordered if r is not None]

    def stream_bytes(self) -> bytes:
        """Canonical byte serialization of the current record stream —
        the unit of the sim's byte-identical-replay guarantee."""
        docs = [r.to_dict() for r in self.records()]
        return json.dumps(docs, sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    def fingerprint(self) -> str:
        """sha256 of ``stream_bytes()`` — joins the sim's determinism
        fingerprint in ``SimCluster.result()``."""
        return hashlib.sha256(self.stream_bytes()).hexdigest()

    def to_json(self) -> Dict[str, Any]:
        """Full document for ``GET /debug/flightrec``."""
        with self._lock:
            dropped = self.dropped
            dumps = self.dumps
            suppressed = self.dumps_suppressed
        return {
            "node": self.node_id,
            "capacity": self.capacity,
            "dropped": dropped,
            "dumps": dumps,
            "dumps_suppressed": suppressed,
            "fingerprint": self.fingerprint(),
            "records": [r.to_dict() for r in self.records()],
        }

    # ------------------------------------------------------------------
    # dumping
    # ------------------------------------------------------------------

    def dump(self, reason: str, dump_dir: Optional[str] = None,
             **context: Any) -> Optional[str]:
        """Dump the whole ring: a structured document appended to the
        bounded in-memory ``dump_docs`` list, written as a JSON artifact
        when a dump dir is configured, and summarized to the log. Dumps
        within ``dump_suppress_s`` of the previous one are suppressed
        (any reason — the first trigger of an episode owns the ring).
        Returns the artifact path, or None when in-memory only or
        suppressed."""
        t = self.clock.monotonic()
        with self._lock:
            if (
                self._last_dump_at is not None
                and t - self._last_dump_at < self.dump_suppress_s
            ):
                self.dumps_suppressed += 1
                return None
            self._last_dump_at = t
            self.dumps += 1
            ordinal = self.dumps
            dropped = self.dropped
        records = [r.to_dict() for r in self.records()]
        doc = {
            "reason": reason,
            "node": self.node_id,
            "t": round(t, 9),
            "ordinal": ordinal,
            "context": {
                k: (round(v, 9) if isinstance(v, float) else v)
                for k, v in context.items()
            },
            "dropped": dropped,
            "records": records,
        }
        with self._lock:
            self.dump_docs.append(doc)
            if len(self.dump_docs) > MAX_DUMP_DOCS:
                self.dump_docs.pop(0)
        path = None
        directory = dump_dir if dump_dir is not None else self.dump_dir
        if directory:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(
                directory,
                f"flightrec-node{self.node_id}-{ordinal:02d}-{reason}.json",
            )
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
        self.logger.warning(
            "flight recorder dump (%s): %d records, node %d%s",
            reason, len(records), self.node_id,
            f" -> {path}" if path else " (in-memory)",
        )
        return path
