"""Cross-node causal trace contexts.

A hashgraph transaction's life is inherently cross-node: submitted on
one node, gossiped and re-gossiped, minted into an event, assigned a
round, voted famous, and finally committed everywhere. A `TraceContext`
follows one transaction across that whole path — **out-of-band**: trace
identifiers ride the sync RPC payloads as extra optional JSON fields
(`Traces` on SyncResponse/EagerSyncRequest, net/commands.py) and are
NEVER part of the signed event bytes, so event hashes, signatures and
wire compatibility with trace-unaware nodes are untouched. The
`obs-ctx-in-event` lint rule (babble_tpu/analysis/obs.py) enforces the
invariant statically; `tests/test_sim.py` proves it differentially
(traced and untraced same-seed clusters commit identical digests).

Determinism is by construction, not by luck:

- ``trace_id = sha256(tx)[:16]`` — any node can derive it from the
  transaction bytes alone, so consensus-side hooks (hashgraph passes)
  need no side channel to find the context for an event's payload;
- ``span_id = sha256(trace_id|node_id)[:16]`` — reproducible per hop;
- every stage mark reads the injected Clock, so under the simulator's
  virtual time two same-seed runs produce byte-identical cluster
  traces (`SimCluster.trace_fingerprint()`).

Memory is bounded: the store holds at most `capacity` live contexts,
LRU by Clock time; an eviction increments `obs_traces_dropped_total`.
Contexts complete (and are removed) at commit, so steady state is the
in-flight transaction window, not history.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from hashlib import sha256
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..common.clock import Clock

DEFAULT_TRACE_CAPACITY = 4096

# per-node pipeline stages, in causal order. `submit` exists only on the
# origin node; `receive` only on nodes that learned the context over the
# wire; the rest are marked wherever the event carrying the transaction
# is inserted and decided.
STAGES = ("submit", "receive", "event", "round", "famous", "commit")


def trace_id_for(tx: bytes) -> str:
    """Deterministic trace id: any node derives it from the tx bytes."""
    return sha256(bytes(tx)).hexdigest()[:16]


def span_id_for(trace_id: str, node_id: int) -> str:
    """Deterministic per-node base span id for one trace."""
    return sha256(f"{trace_id}|{node_id}".encode()).hexdigest()[:16]


class TraceContext:
    """One transaction's live trace state on one node.

    `parent` is the SENDING node's base span id (empty at the origin):
    the cross-node causal edge. Stage spans within a node parent to the
    node's own base span id.
    """

    __slots__ = ("trace_id", "origin", "span_id", "parent", "marks")

    def __init__(self, trace_id: str, origin: int, span_id: str,
                 parent: str):
        self.trace_id = trace_id
        self.origin = origin
        self.span_id = span_id
        self.parent = parent
        self.marks: Dict[str, float] = {}

    def to_wire(self) -> dict:
        """The out-of-band wire form piggybacked on sync payloads. The
        receiver chains to OUR span id — `Span` becomes its `parent`."""
        return {"Id": self.trace_id, "Origin": self.origin,
                "Span": self.span_id}


class TraceStore:
    """Bounded per-node store of live TraceContexts, LRU by Clock time.

    Thread-safe: gossip handler threads absorb contexts while the babble
    loop marks consensus stages. All public methods are cheap no-ops when
    the store is disabled or empty, so trace-unaware workloads pay one
    dict check per hook.
    """

    def __init__(self, clock: Clock, node_id: int, registry, tracer,
                 capacity: int = DEFAULT_TRACE_CAPACITY,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError("trace capacity must be >= 1")
        self.clock = clock
        self.node_id = node_id
        self.tracer = tracer
        self.capacity = capacity
        self.enabled = enabled
        self._lock = threading.Lock()
        # guarded-by: _lock — insertion order IS recency (LRU)
        self._ctxs: "OrderedDict[str, TraceContext]" = OrderedDict()
        self._dropped = registry.counter(
            "obs_traces_dropped_total",
            "Live trace contexts evicted by the LRU capacity bound",
        )
        registry.gauge(
            "obs_traces_live", "Live trace contexts currently held",
        ).set_function(lambda: len(self._ctxs))
        # end-to-end stage decomposition, one histogram per causal edge
        # (part of the sim determinism contract)
        self._h_submit_event = registry.histogram(
            "babble_trace_stage_submit_to_event_seconds",
            "Causal-trace stage: transaction submit -> carried in an event",
        )
        self._h_event_round = registry.histogram(
            "babble_trace_stage_event_to_round_seconds",
            "Causal-trace stage: event insertion -> round assigned",
        )
        self._h_round_famous = registry.histogram(
            "babble_trace_stage_round_to_famous_seconds",
            "Causal-trace stage: round assigned -> round-received decided",
        )
        self._h_famous_commit = registry.histogram(
            "babble_trace_stage_famous_to_commit_seconds",
            "Causal-trace stage: round-received decided -> block commit",
        )

    # ------------------------------------------------------------------
    # context lifecycle
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        # unguarded-ok: GIL-atomic len() for a staleness-tolerant debug probe
        return len(self._ctxs)

    def get(self, trace_id: str) -> Optional[TraceContext]:
        with self._lock:
            return self._ctxs.get(trace_id)

    def _insert(self, ctx: TraceContext) -> None:  # requires-lock: _lock
        """Caller must hold _lock."""
        self._ctxs[ctx.trace_id] = ctx
        while len(self._ctxs) > self.capacity:
            self._ctxs.popitem(last=False)
            self._dropped.inc()

    def begin(self, tx: bytes) -> None:
        """Open a trace at the submission edge (origin node). Idempotent:
        re-submitting identical bytes keeps the first submit mark."""
        if not self.enabled:
            return
        tid = trace_id_for(tx)
        now = self.clock.monotonic()
        with self._lock:
            if tid in self._ctxs:
                self._ctxs.move_to_end(tid)
                return
            ctx = TraceContext(tid, self.node_id,
                               span_id_for(tid, self.node_id), parent="")
            ctx.marks["submit"] = now
            self._insert(ctx)
        self.tracer.record(
            "trace.submit", now, 0.0,
            {"trace": tid, "span": ctx.span_id, "parent": "",
             "node": self.node_id},
        )

    def absorb(self, wire_ctxs: Sequence[dict]) -> None:
        """Adopt contexts piggybacked on an inbound sync payload. Must run
        BEFORE the payload's events are inserted so the consensus hooks
        find them. Idempotent under duplicate delivery (dup_rate faults):
        a known trace id is only touched, never re-parented."""
        if not self.enabled or not wire_ctxs:
            return
        now = self.clock.monotonic()
        recorded: List[TraceContext] = []
        with self._lock:
            for w in wire_ctxs:
                tid = w.get("Id") if isinstance(w, dict) else None
                if not isinstance(tid, str) or not tid:
                    continue
                if tid in self._ctxs:
                    self._ctxs.move_to_end(tid)
                    continue
                parent = w.get("Span", "")
                if not isinstance(parent, str):
                    parent = ""
                try:
                    origin = int(w.get("Origin", -1))
                except (TypeError, ValueError):
                    origin = -1
                ctx = TraceContext(tid, origin,
                                   span_id_for(tid, self.node_id), parent)
                ctx.marks["receive"] = now
                self._insert(ctx)
                recorded.append(ctx)
        for ctx in recorded:
            self.tracer.record(
                "trace.receive", now, 0.0,
                {"trace": ctx.trace_id, "span": ctx.span_id,
                 "parent": ctx.parent, "node": self.node_id},
            )

    def contexts_for(self, events: Iterable) -> List[dict]:
        """Wire contexts for the traced transactions carried by an
        outgoing event diff — the out-of-band piggyback payload."""
        # unguarded-ok: racy emptiness probe; the locked block below is authoritative
        if not self.enabled or not self._ctxs:
            return []
        out: List[dict] = []
        seen = set()
        with self._lock:
            for ev in events:
                for tx in ev.transactions():
                    tid = trace_id_for(tx)
                    if tid in seen:
                        continue
                    ctx = self._ctxs.get(tid)
                    if ctx is None:
                        continue
                    seen.add(tid)
                    self._ctxs.move_to_end(tid)
                    out.append(ctx.to_wire())
        return out

    # ------------------------------------------------------------------
    # consensus stage marks
    # ------------------------------------------------------------------

    def mark_event(self, txs: Sequence[bytes]) -> None:
        """The transaction is now carried by an inserted event."""
        self._mark(txs, "event", "submit", self._h_submit_event,
                   "trace.event")

    def mark_round(self, txs: Sequence[bytes]) -> None:
        """The carrying event was assigned a round (DivideRounds)."""
        self._mark(txs, "round", "event", self._h_event_round,
                   "trace.round")

    def mark_famous(self, txs: Sequence[bytes]) -> None:
        """The carrying event's round-received was decided — every unique
        famous witness of a later round sees it (DecideRoundReceived)."""
        self._mark(txs, "famous", "round", self._h_round_famous,
                   "trace.famous")

    def mark_commit(self, txs: Sequence[bytes]) -> None:
        """The transaction committed in a block: observe the final stage
        and complete (remove) the context — completion is not a drop."""
        # unguarded-ok: racy emptiness probe; the locked pop below is authoritative
        if not self.enabled or not self._ctxs or not txs:
            return
        now = self.clock.monotonic()
        done: List[Tuple[TraceContext, Optional[float]]] = []
        with self._lock:
            for tx in txs:
                ctx = self._ctxs.pop(trace_id_for(tx), None)
                if ctx is not None:
                    done.append((ctx, ctx.marks.get("famous")))
        for ctx, prev in done:
            if prev is not None:
                self._h_famous_commit.observe(now - prev)
            start = prev if prev is not None else now
            self.tracer.record(
                "trace.commit", start, now - start,
                {"trace": ctx.trace_id, "span": ctx.span_id + ":commit",
                 "parent": ctx.span_id, "node": self.node_id},
            )

    def _mark(self, txs: Sequence[bytes], stage: str, prev_stage: str,
              histogram, span_name: str) -> None:
        # unguarded-ok: racy emptiness probe; the locked walk below is authoritative
        if not self.enabled or not self._ctxs or not txs:
            return
        now = self.clock.monotonic()
        marked: List[Tuple[TraceContext, Optional[float]]] = []
        with self._lock:
            for tx in txs:
                tid = trace_id_for(tx)
                ctx = self._ctxs.get(tid)
                if ctx is None or stage in ctx.marks:
                    continue
                ctx.marks[stage] = now
                self._ctxs.move_to_end(tid)
                marked.append((ctx, ctx.marks.get(prev_stage)))
        for ctx, prev in marked:
            if prev is not None:
                histogram.observe(now - prev)
            # the stage span covers the wait since the previous stage, so
            # the Perfetto timeline reads as contiguous per-node segments
            start = prev if prev is not None else now
            self.tracer.record(  # obs-ok: stage names are literals at the mark_* call sites
                span_name, start, now - start,
                {"trace": ctx.trace_id, "span": ctx.span_id + ":" + stage,
                 "parent": ctx.span_id, "node": self.node_id},
            )


def assemble_cluster_trace(node_docs: Sequence[Tuple[Optional[int], dict]],
                           ) -> dict:
    """Merge per-node Chrome-trace documents into one cluster timeline.

    `node_docs` is ``[(node_id_or_None, chrome_trace_doc), ...]``; a
    non-None node id overrides the document's pids (the sim path), None
    keeps the pids the exporting node stamped (the HTTP federation path,
    where each /debug/trace response already carries its node id).

    Parent references that do not resolve to any span in the merged
    document are **cleanly truncated**: the span is re-rooted
    (``parent=""``) and marked ``truncated`` — a crashed or unreachable
    node's spans are absent, never dangling. The output therefore
    contains no orphan parent span ids by construction.
    """
    events: List[dict] = []
    span_ids = set()
    for node_id, doc in node_docs:
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)  # never mutate the exporting tracer's dicts
            if node_id is not None:
                ev["pid"] = node_id
            args = ev.get("args")
            if isinstance(args, dict) and args.get("span"):
                span_ids.add(args["span"])
            events.append(ev)
    for ev in events:
        args = ev.get("args")
        if not isinstance(args, dict):
            continue
        parent = args.get("parent")
        if parent and parent not in span_ids:
            args = dict(args)
            args["parent"] = ""
            args["truncated"] = True
            ev["args"] = args
    return {"traceEvents": events, "displayTimeUnit": "ms"}
