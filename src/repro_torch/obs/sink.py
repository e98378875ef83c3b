"""The JSONL event appender shared by the precision controller's event log
and the serve-time monitor's (the port's copy of ``repro.obs.sink``'s
``jsonl_append``)."""

from __future__ import annotations

import json
import os
from typing import Iterable

__all__ = ["jsonl_append"]


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
