"""Shared event sinks (counterpart of ``repro.obs.sink``): the one JSONL
appender of the precision controller's and the serve monitor's event
logs, a path-bound ``JsonlSink``, and the bounded ``RingBuffer`` behind
``ServeEngine.events`` and a tracer's spans."""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Iterable, Iterator

__all__ = ["jsonl_append", "JsonlSink", "RingBuffer"]


def jsonl_append(path: str, records: Iterable[dict]) -> None:
    """Append ``records`` to ``path`` as JSON Lines, creating the parent
    directory if needed; one ``open`` per call."""
    records = list(records)
    if not records:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


class JsonlSink:
    """A JSONL appender bound to one path (``path=None`` disables it, so
    callers need no guard)."""

    def __init__(self, path: str | None):
        self.path = path

    def emit(self, *records: dict) -> None:
        if self.path:
            jsonl_append(self.path, records)


class RingBuffer:
    """Bounded append-only store with list-like reads (``append``,
    iteration, ``len``, indexing, slicing).  ``capacity=None`` is
    unbounded; otherwise the oldest items are evicted and ``dropped``
    counts them."""

    def __init__(self, capacity: int | None = None):
        if capacity is not None and capacity <= 0:
            raise ValueError(
                f"RingBuffer capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._q: deque = deque(maxlen=capacity)
        self.dropped = 0

    def append(self, item) -> None:
        if self.capacity is not None and len(self._q) == self.capacity:
            self.dropped += 1
        self._q.append(item)

    def extend(self, items: Iterable) -> None:
        for it in items:
            self.append(it)

    def clear(self) -> None:
        self._q.clear()
        self.dropped = 0

    def __iter__(self) -> Iterator:
        return iter(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._q)[i]
        return self._q[i]

    def __bool__(self) -> bool:
        return bool(self._q)

    def __repr__(self) -> str:
        return (f"RingBuffer(capacity={self.capacity}, len={len(self._q)}, "
                f"dropped={self.dropped})")
