"""Time source seam for the node runtime.

Every wall-clock read and sleep in the node layer goes through a `Clock`
so the deterministic simulator (babble_tpu/sim/) can substitute virtual
time: a `SimClock` advanced by an event-loop scheduler instead of the OS.
Production code uses `SystemClock` (the module-level `SYSTEM_CLOCK`
singleton), which delegates straight to `time.monotonic` / `time.sleep`.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod


class Clock(ABC):
    """Monotonic time + sleep, substitutable for virtual time."""

    @abstractmethod
    def monotonic(self) -> float: ...

    @abstractmethod
    def sleep(self, seconds: float) -> None: ...


class SystemClock(Clock):
    """The OS clock — production default."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


# shared default: SystemClock is stateless, one instance serves everyone
SYSTEM_CLOCK = SystemClock()
