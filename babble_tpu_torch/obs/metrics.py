"""Typed metrics registry with Prometheus text exposition.

Three metric kinds — counters, gauges, log-bucketed histograms — each
declared once by a STATIC name (the `obs-*` lint family rejects computed
names) with an optional declared label set. Series cardinality is
bounded by construction: once a metric holds `MAX_LABEL_SETS` distinct
label combinations, further novel combinations collapse into a single
`other` series, so a buggy or adversarial label value can never grow the
registry without bound.

Determinism contract: the registry never reads a clock or RNG — every
observed value arrives from the caller, who measures through the
injected Clock seam (common/clock.py). Under the simulator's SimClock,
two runs of the same seed therefore produce byte-identical exposition
and snapshots (the sim's latency-histogram fingerprint rides on this).
Rendering sorts metrics by name and series by label values, so output
order never depends on declaration or observation interleaving.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# hard per-metric cap on distinct label-value combinations; the overflow
# series keeps totals right while freezing cardinality
MAX_LABEL_SETS = 64
OVERFLOW_LABEL = "other"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def log_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """`count` log-spaced histogram bounds: start, start*factor, ... ."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("log_buckets needs start>0, factor>1, count>=1")
    out: List[float] = []
    v = float(start)
    for _ in range(count):
        out.append(v)
        v *= factor
    return tuple(out)


# 1 ms .. ~65 s: spans gossip round-trips, consensus passes and commit
# latency on one axis (the +Inf bucket absorbs pathological stalls)
DEFAULT_LATENCY_BUCKETS = log_buckets(0.001, 2.0, 17)
# 64 B .. 16 MiB: wire frames (DEFAULT_MAX_FRAME is 64 MiB -> +Inf tail)
DEFAULT_SIZE_BUCKETS = log_buckets(64, 4.0, 10)
# 1 .. 1024 items: event counts per sync payload (sync_limit-bounded)
DEFAULT_COUNT_BUCKETS = log_buckets(1, 2.0, 11)


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render without the dot."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Child:
    """A metric bound to one label-value combination."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Metric", key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._metric._inc(self._key, amount)

    def dec(self, amount: float = 1.0) -> None:
        self._metric._inc(self._key, -amount)

    def set(self, value: float) -> None:
        self._metric._set(self._key, value)

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        self._metric._observe(self._key, value, exemplar=exemplar)


class Metric:
    """Base: name, declared label set, bounded series map."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, label_names: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name: {ln!r}")
        self.name = name
        self.help = help_text
        self.label_names: Tuple[str, ...] = tuple(label_names)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}  # guarded-by: _lock

    # -- label resolution --------------------------------------------------

    def labels(self, **kv: str) -> _Child:
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: got labels {sorted(kv)}, "
                f"declared {list(self.label_names)}"
            )
        # the child carries the RAW key; the cardinality bound is applied
        # inside each mutation op while self._lock is held, so admission
        # and insertion are one atomic step (deciding here and inserting
        # later let two first-callers overshoot MAX_LABEL_SETS)
        return _Child(self, tuple(str(kv[ln]) for ln in self.label_names))

    def _bind_locked(self, key: Tuple[str, ...]) -> Tuple[str, ...]:  # requires-lock: _lock
        """The declared-bounded cardinality guarantee: novel combinations
        past MAX_LABEL_SETS collapse into one `other` series. Must be
        called with self._lock held, immediately before the insertion it
        admits."""
        if key in self._series or len(self._series) < MAX_LABEL_SETS:
            return key
        return (OVERFLOW_LABEL,) * len(key)

    def _no_labels_key(self) -> Tuple[str, ...]:
        if self.label_names:
            raise ValueError(f"{self.name}: declared labels {self.label_names};"
                             " use .labels(...)")
        return ()

    # -- rendering ---------------------------------------------------------

    def _label_str(self, key: Tuple[str, ...]) -> str:
        if not key:
            return ""
        pairs = ",".join(
            f'{n}="{_escape_label(v)}"' for n, v in zip(self.label_names, key)
        )
        return "{" + pairs + "}"

    def _sorted_series(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._series.items())


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._inc(self._no_labels_key(), amount)

    def _inc(self, key: Tuple[str, ...], amount: float) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        with self._lock:
            key = self._bind_locked(key)
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **kv: str) -> float:
        key = tuple(str(kv[ln]) for ln in self.label_names) if kv else ()
        with self._lock:
            return float(self._series.get(key, 0.0))  # type: ignore[arg-type]

    def render(self) -> List[str]:
        return [
            f"{self.name}{self._label_str(k)} {_fmt(v)}"  # type: ignore[arg-type]
            for k, v in self._sorted_series()
        ]

    def snapshot(self) -> dict:
        return {
            "type": self.kind,
            "series": {
                ",".join(k): v for k, v in self._sorted_series()
            },
        }


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name: str, help_text: str, label_names: Sequence[str] = ()):
        super().__init__(name, help_text, label_names)
        # pull-time callback for the unlabeled series (read at render)
        # unguarded-ok: rebound once at declaration time; racing readers
        # see None or the callback, both safe
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        self._set(self._no_labels_key(), value)

    def inc(self, amount: float = 1.0) -> None:
        self._inc(self._no_labels_key(), amount)

    def dec(self, amount: float = 1.0) -> None:
        self._inc(self._no_labels_key(), -amount)

    def set_function(self, fn: Callable[[], float]) -> "Gauge":
        """Evaluate `fn` at exposition time (live view of node state)."""
        self._no_labels_key()
        self._fn = fn
        return self

    def _set(self, key: Tuple[str, ...], value: float) -> None:
        with self._lock:
            self._series[self._bind_locked(key)] = float(value)

    def _inc(self, key: Tuple[str, ...], amount: float) -> None:
        with self._lock:
            key = self._bind_locked(key)
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **kv: str) -> float:
        if self._fn is not None:
            return self._read_fn()
        key = tuple(str(kv[ln]) for ln in self.label_names) if kv else ()
        with self._lock:
            return float(self._series.get(key, 0.0))  # type: ignore[arg-type]

    def _read_fn(self) -> float:
        try:
            return float(self._fn())  # type: ignore[misc]
        except Exception:  # noqa: BLE001 — a broken callback must not
            return 0.0  # take the whole exposition down

    def render(self) -> List[str]:
        if self._fn is not None:
            return [f"{self.name} {_fmt(self._read_fn())}"]
        return [
            f"{self.name}{self._label_str(k)} {_fmt(v)}"  # type: ignore[arg-type]
            for k, v in self._sorted_series()
        ]

    def snapshot(self) -> dict:
        if self._fn is not None:
            return {"type": self.kind, "series": {"": self._read_fn()}}
        return {
            "type": self.kind,
            "series": {
                ",".join(k): v for k, v in self._sorted_series()
            },
        }


class Histogram(Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_text: str,
        label_names: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ):
        super().__init__(name, help_text, label_names)
        bs = tuple(buckets) if buckets is not None else DEFAULT_LATENCY_BUCKETS
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"{self.name}: buckets must strictly increase")
        self.buckets = bs
        # last exemplar per series (e.g. the trace_id of the latest
        # commit-latency observation): rendered as a `# EXEMPLAR` comment
        # in the exposition so a p99 breach links to a concrete trace
        self._exemplars: Dict[Tuple[str, ...], str] = {}  # guarded-by: _lock

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        self._observe(self._no_labels_key(), value, exemplar=exemplar)

    def _observe(self, key: Tuple[str, ...], value: float,
                 exemplar: Optional[str] = None) -> None:
        v = float(value)
        with self._lock:
            key = self._bind_locked(key)
            st = self._series.get(key)
            if st is None:
                # per-bucket counts (non-cumulative) + [sum, count]
                st = [[0] * (len(self.buckets) + 1), [0.0, 0]]
                self._series[key] = st
            counts, agg = st  # type: ignore[misc]
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            counts[i] += 1
            agg[0] += v
            agg[1] += 1
            if exemplar is not None:
                self._exemplars[key] = str(exemplar)

    def exemplar(self, **kv: str) -> Optional[str]:
        """Last exemplar attached to one series, or None."""
        key = tuple(str(kv[ln]) for ln in self.label_names) if kv else ()
        with self._lock:
            return self._exemplars.get(key)

    def stats(self, **kv: str) -> Tuple[int, float]:
        """(count, sum) of one series; (0, 0.0) when never observed."""
        key = tuple(str(kv[ln]) for ln in self.label_names) if kv else ()
        with self._lock:
            st = self._series.get(key)
            if st is None:
                return 0, 0.0
            return int(st[1][1]), float(st[1][0])  # type: ignore[index]

    def render(self) -> List[str]:
        out: List[str] = []
        with self._lock:
            exemplars = dict(self._exemplars)
        for key, st in self._sorted_series():
            counts, agg = st  # type: ignore[misc]
            cum = 0
            for le, c in zip(self.buckets, counts):
                cum += c
                lk = self._bucket_label(key, _fmt(le))
                out.append(f"{self.name}_bucket{lk} {cum}")
            cum += counts[-1]
            out.append(f"{self.name}_bucket{self._bucket_label(key, '+Inf')} {cum}")
            ls = self._label_str(key)
            out.append(f"{self.name}_sum{ls} {_fmt(agg[0])}")
            out.append(f"{self.name}_count{ls} {cum}")
            ex = exemplars.get(key)
            if ex is not None:
                # text format 0.0.4 has no native exemplar syntax; a
                # comment line keeps the exposition parseable everywhere
                # while still surfacing the trace link next to its series
                out.append(
                    f'# EXEMPLAR {self.name}{ls} trace_id="{_escape_label(ex)}"'
                )
        return out

    def _bucket_label(self, key: Tuple[str, ...], le: str) -> str:
        pairs = [
            f'{n}="{_escape_label(v)}"' for n, v in zip(self.label_names, key)
        ]
        pairs.append(f'le="{le}"')
        return "{" + ",".join(pairs) + "}"

    def snapshot(self) -> dict:
        series = {}
        with self._lock:
            exemplars = dict(self._exemplars)
        for key, st in self._sorted_series():
            counts, agg = st  # type: ignore[misc]
            cum, buckets = 0, []
            for le, c in zip(self.buckets, counts):
                cum += c
                buckets.append([_fmt(le), cum])
            entry = {
                "count": agg[1], "sum": agg[0], "buckets": buckets,
            }
            ex = exemplars.get(key)
            if ex is not None:
                # deterministic under the sim (trace ids hash tx bytes),
                # so including it keeps the snapshot fingerprint-safe
                entry["exemplar"] = ex
            series[",".join(key)] = entry
        return {"type": self.kind, "series": series}


class MetricsRegistry:
    """Get-or-create home for every metric of one node.

    Re-requesting a name returns the existing metric; a kind or label-set
    mismatch raises (two call sites silently disagreeing about a metric's
    shape is a bug, not a merge)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}  # guarded-by: _lock

    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labels)

    def histogram(
        self, name: str, help_text: str = "", labels: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help_text, labels, buckets=buckets
        )

    def _get_or_create(self, cls, name, help_text, labels, **kw) -> Metric:
        # double-checked creation: a lock-free fast path for the hot
        # re-request case (a GIL-atomic dict read; never partially
        # constructed, since insertion below happens after construction,
        # under the lock), then re-check + create under the registry lock
        # so N concurrent first-callers all receive the SAME instance.
        # unguarded-ok: fast-path read; the locked slow path re-validates
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, help_text, labels, **kw)
                    self._metrics[name] = m
                    return m
        if type(m) is not cls or m.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} re-declared as {cls.kind} "
                f"labels={tuple(labels)} (was {m.kind} "
                f"labels={m.label_names})"
            )
        return m

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def expose(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """Structured dict view (sim fingerprints, bench emission)."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return {m.name: m.snapshot() for m in metrics}

    def snapshot_flat(self) -> Dict[str, float]:
        """One-level dict for structured logging: `name{labels}` -> value;
        histograms contribute `_count` and `_sum` entries."""
        out: Dict[str, float] = {}
        for name, snap in self.snapshot().items():
            if snap["type"] == "histogram":
                for key, st in snap["series"].items():
                    suffix = "{" + key + "}" if key else ""
                    out[f"{name}_count{suffix}"] = st["count"]
                    out[f"{name}_sum{suffix}"] = round(st["sum"], 9)
            else:
                for key, v in snap["series"].items():
                    suffix = "{" + key + "}" if key else ""
                    out[name + suffix] = v
        return out
