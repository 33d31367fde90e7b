"""Observability for the port's host layer: the members the hashgraph and
the device engines read, behind the injected Clock seam.

One `Observability` object per hashgraph bundles a typed
`MetricsRegistry` (counters / gauges / log-bucketed histograms with
declared, bounded label sets), a bounded ring-buffer `SpanTracer`, the
cross-node `TraceStore`, the `FlightRecorder`, the decision
`ProvenanceRecorder` and the host-clock `DeviceLedger`, all timed through
one `Clock`. The cluster health plane and the SLO engine of the
reference's node layer are not part of the port yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..common.clock import Clock, SYSTEM_CLOCK
from .devledger import DeviceLedger, ledger_call
from .flightrec import (
    DEFAULT_FLIGHT_CAPACITY,
    FlightRecord,
    FlightRecorder,
)
from .metrics import (
    Counter,
    DEFAULT_COUNT_BUCKETS,
    DEFAULT_LATENCY_BUCKETS,
    DEFAULT_SIZE_BUCKETS,
    Gauge,
    Histogram,
    MAX_LABEL_SETS,
    MetricsRegistry,
    log_buckets,
)
from .provenance import (
    DEFAULT_PROV_ROUND_CAP,
    DivergenceBisector,
    ProvenanceRecorder,
    RoundProvenance,
    bisect_pass_results,
    capture_pass_results,
)
from .trace import DEFAULT_SPAN_CAPACITY, Span, SpanTracer
from .tracectx import (
    DEFAULT_TRACE_CAPACITY,
    TraceContext,
    TraceStore,
    trace_id_for,
    span_id_for,
)

__all__ = [
    "Observability",
    "DeviceLedger",
    "ledger_call",
    "FlightRecorder",
    "FlightRecord",
    "ProvenanceRecorder",
    "RoundProvenance",
    "DivergenceBisector",
    "capture_pass_results",
    "bisect_pass_results",
    "DEFAULT_PROV_ROUND_CAP",
    "DEFAULT_FLIGHT_CAPACITY",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "SpanTracer",
    "Span",
    "TraceContext",
    "TraceStore",
    "trace_id_for",
    "span_id_for",
    "log_buckets",
    "DEFAULT_LATENCY_BUCKETS",
    "DEFAULT_SIZE_BUCKETS",
    "DEFAULT_COUNT_BUCKETS",
    "DEFAULT_SPAN_CAPACITY",
    "DEFAULT_TRACE_CAPACITY",
    "MAX_LABEL_SETS",
]


class Observability:
    """Per-node bundle of registry + tracer + trace store + the clock
    they all time by."""

    def __init__(self, clock: Optional[Clock] = None, node_id: int = 0,
                 span_capacity: int = DEFAULT_SPAN_CAPACITY,
                 trace_capacity: int = DEFAULT_TRACE_CAPACITY,
                 tracing: bool = True,
                 flightrec_capacity: int = DEFAULT_FLIGHT_CAPACITY):
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.node_id = node_id
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer(clock=self.clock, capacity=span_capacity)
        # black-box flight recorder: bounded ring of typed
        # structured records dumped wholesale on stall/divergence/flap/
        # SLO breach — same Clock seam, same determinism contract
        self.flightrec = FlightRecorder(
            clock=self.clock, node_id=node_id, capacity=flightrec_capacity,
        )
        # consensus decision provenance: per-round voting
        # tables + fame-decision whys, captured by every engine at its
        # host-side integration seam — the DivergenceBisector's input
        self.provenance = ProvenanceRecorder(
            clock=self.clock, node_id=node_id,
        )
        # cross-node causal tracing: live TraceContexts for
        # in-flight transactions, bounded, feeding per-stage histograms
        # and trace.* spans into the registry/tracer above
        self.traces = TraceStore(
            clock=self.clock, node_id=node_id, registry=self.registry,
            tracer=self.tracer, capacity=trace_capacity, enabled=tracing,
        )
        # device-time ledger: per-pass cost cells on the host clock —
        # durations follow the clock policy (real SystemClock only; a
        # virtual clock records exact zeros)
        self.devledger = DeviceLedger(self)

    # Delegates so call sites read `obs.counter("...")`. The name flows
    # through a parameter here, which the obs-dynamic-name rule cannot
    # prove static — waived: the rule checks the *call sites*, which do
    # pass literals.
    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self.registry.counter(name, help_text, labels)  # obs-ok: delegate, name checked at call sites

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self.registry.gauge(name, help_text, labels)  # obs-ok: delegate, name checked at call sites

    def histogram(self, name: str, help_text: str = "",
                  labels: Sequence[str] = (), buckets=None) -> Histogram:
        return self.registry.histogram(name, help_text, labels, buckets=buckets)  # obs-ok: delegate, name checked at call sites

    def span(self, name: str, histogram=None, **attrs):
        """Context manager timing a block into the span ring (and an
        optional histogram) via the injected clock."""
        return self.tracer.span(name, histogram=histogram, **attrs)  # obs-ok: delegate, name checked at call sites
