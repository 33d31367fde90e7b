"""Device-time ledger, host-clock edition: the API the engines' call
sites use (`activate`, `component`, `now`, `ledger_call`), so that
tpu/live.py and tpu/engine.py read as the reference's do.

Each dispatch's wall time is booked into cumulative cells keyed by
(rung, pass, layout, component), with component one of

    stage     host restage work before the dispatch
    run       host time of one seam call (on the card: the launches,
              which return before the kernels finish)
    fetch     blocked device->host result wait (where the kernels
              finish, on the card)
    integrate host write-back of pass results

Durations follow the clock policy of the reference: the real SystemClock
is read directly; under any injected virtual clock the ledger records
0.0 and never touches the clock. Compile and retrace accounting (the
reference listens to jax.monitoring) has no counterpart here: the port's
kernels are built once per process by nvcc, outside any seam.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Tuple

from ..common.clock import SystemClock

# lifecycle components a dispatch's wall time decomposes into
COMPONENTS = ("stage", "run", "fetch", "integrate")

_TL = threading.local()


class _Ctx:
    __slots__ = ("ledger", "rung", "layout")

    def __init__(self, ledger: "DeviceLedger", rung: str, layout: str):
        self.ledger = ledger
        self.rung = rung
        self.layout = layout


def ledger_call(entry: str, fn, *args, **kwargs):
    """Module-level seam for call sites without an obs handle: times
    `fn(*args, **kwargs)` into the thread's active ledger, or passes
    straight through when none is active."""
    ctx = getattr(_TL, "ctx", None)
    if ctx is None:
        return fn(*args, **kwargs)
    return ctx.ledger.call(entry, fn, *args, **kwargs)


class DeviceLedger:
    """Per-hashgraph cost ledger: cumulative [calls, seconds] cells keyed
    by (rung, pass, layout, component), under one lock."""

    def __init__(self, obs):
        self.obs = obs
        self.clock = obs.clock
        self._real = isinstance(self.clock, SystemClock)
        self._lock = threading.Lock()
        self._cells: Dict[Tuple[str, str, str, str], List[float]] = {}  # guarded-by: _lock
        self._m_pass = obs.histogram(
            "babble_kernel_pass_seconds",
            "Device-time ledger: seconds per kernel pass / lifecycle "
            "component, by engine rung and voting-table layout",
            labels=("rung", "pass", "layout"),
        )

    def now(self) -> float:
        return self.clock.monotonic() if self._real else 0.0

    @contextmanager
    def activate(self, rung: str, layout: str = "wide"):
        """Bind this ledger and (rung, layout) to the current thread so
        `ledger_call` seams below this frame attribute to it."""
        prev = getattr(_TL, "ctx", None)
        _TL.ctx = _Ctx(self, rung, layout)
        try:
            yield self
        finally:
            _TL.ctx = prev

    def call(self, entry: str, fn, *args, **kwargs):
        """Time one host call of an entry point under the `run` component
        of the active (rung, layout), or of rung "unknown"."""
        ctx = getattr(_TL, "ctx", None)
        if ctx is not None and ctx.ledger is self:
            rung, layout = ctx.rung, ctx.layout
        else:
            rung, layout = "unknown", "wide"
        t0 = self.now()
        out = fn(*args, **kwargs)
        dt = self.now() - t0
        self._add((rung, entry, layout, "run"), 1, dt)
        self._m_pass.labels(rung=rung, layout=layout, **{"pass": entry}).observe(dt)
        return out

    def component(self, rung: str, component: str, seconds: float,
                  layout: str = "wide", calls: int = 1) -> None:
        """Record host-side lifecycle time (stage/fetch/integrate) for a
        dispatch on `rung`, measured with `now()`."""
        if component not in COMPONENTS:
            raise ValueError(f"unknown ledger component {component!r}")
        self._add((rung, "dispatch", layout, component), calls, seconds)
        self._m_pass.labels(
            rung=rung, **{"pass": component}, layout=layout
        ).observe(seconds)

    def _add(self, key, calls: int, seconds: float) -> None:
        with self._lock:
            cell = self._cells.setdefault(key, [0, 0.0])
            cell[0] += calls
            cell[1] += seconds

    def snapshot(self) -> Dict[str, List[float]]:
        """"rung/pass/layout/component" -> [calls, seconds], sorted."""
        with self._lock:
            return {"/".join(k): list(v) for k, v in sorted(self._cells.items())}
