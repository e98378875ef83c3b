"""The clock seam of the observability layer (counterpart of
``repro.obs.clock``).  Every span timestamp comes through a ``Clock``:
``SystemClock`` (``time.monotonic``, immune to wall-clock steps) in
production, ``VirtualClock`` in the scheduler simulation, which sets it to
the tick counter so a trace replayed with a seed gives the same spans
byte for byte."""

from __future__ import annotations

import time
from typing import Protocol

__all__ = ["Clock", "SystemClock", "VirtualClock"]


class Clock(Protocol):
    def now(self) -> float:  # pragma: no cover - protocol
        ...


class SystemClock:
    """Monotonic host time (seconds)."""

    def now(self) -> float:
        return time.monotonic()


class VirtualClock:
    """A clock that moves only when told to (``set``, ``advance``)."""

    def __init__(self, t: float = 0.0):
        self._t = float(t)

    def now(self) -> float:
        return self._t

    def set(self, t: float) -> None:
        self._t = float(t)

    def advance(self, dt: float = 1.0) -> None:
        self._t += float(dt)
