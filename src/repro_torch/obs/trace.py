"""Request-lifecycle tracing: causally linked spans on an injectable clock.

Counterpart of ``repro.obs.trace``.  The serve engine opens one root span
per request (``name="request"``, ``trace_id`` the request id) whose
children cover each scheduler state the request passes through::

    request(rid)
    ├─ queued            submit -> admission
    ├─ prefill_slab ×N   one per prefill slab
    ├─ swapped ×M        preempt -> restore
    ├─ rollback ×R       speculative rejections (spec engine)
    └─ [token events]    one per emitted token, on the root span

plus engine-level ``decode_step`` (and, speculative, ``draft``/``verify``)
spans without a trace id, linked to their requests by the ``rids`` attr.
TTFT and TPOT come from the token events (``request_latencies``).  Span
ids are a per-tracer counter; timestamps come from the ``Clock``
(``obs.clock``), so under the simulation's virtual clock a span tree is a
pure function of the trace.  Spans are host records only: the tracer
never touches a tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.clock import Clock, SystemClock
from repro_torch.obs.sink import RingBuffer, jsonl_append

__all__ = ["Span", "Tracer", "span_forest", "request_latencies", "percentile"]


@dataclass
class Span:
    span_id: int
    name: str
    t_start: float
    trace_id: int | str | None = None
    parent_id: int | None = None
    t_end: float | None = None
    attrs: dict = field(default_factory=dict)
    events: list = field(default_factory=list)

    @property
    def open(self) -> bool:
        return self.t_end is None

    @property
    def duration(self) -> float | None:
        return None if self.t_end is None else self.t_end - self.t_start

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id, "name": self.name,
            "trace_id": self.trace_id, "parent_id": self.parent_id,
            "t_start": self.t_start, "t_end": self.t_end,
            "attrs": dict(self.attrs), "events": list(self.events),
        }


class Tracer:
    """Span factory and store: it owns the clock and the id counter; spans
    are plain data.  ``capacity`` bounds the store (a ``RingBuffer``)."""

    def __init__(self, clock: Clock | None = None,
                 capacity: int | None = None):
        self.clock = clock if clock is not None else SystemClock()
        self.spans: RingBuffer = RingBuffer(capacity)
        self._next_id = 1

    def start(self, name: str, *, trace_id=None,
              parent: "Span | None" = None, **attrs) -> Span:
        s = Span(span_id=self._next_id, name=name, t_start=self.clock.now(),
                 trace_id=trace_id if trace_id is not None
                 else (parent.trace_id if parent is not None else None),
                 parent_id=parent.span_id if parent is not None else None,
                 attrs=attrs)
        self._next_id += 1
        self.spans.append(s)
        return s

    def end(self, span: Span, **attrs) -> Span:
        span.t_end = self.clock.now()
        if attrs:
            span.attrs.update(attrs)
        return span

    def event(self, span: Span, name: str, **attrs) -> dict:
        e = {"name": name, "t": self.clock.now(), **attrs}
        span.events.append(e)
        return e

    def export_jsonl(self, path: str) -> int:
        """Append every stored span to ``path``; returns the span count."""
        rows = self.to_dicts()
        jsonl_append(path, rows)
        return len(rows)

    def to_dicts(self) -> list[dict]:
        return [s.to_dict() for s in self.spans]


def span_forest(spans) -> dict:
    """``{span_id: {"span": span dict, "children": [span_id, ...]}}`` over
    dicts or ``Span`` objects.  Raises on a dangling ``parent_id``."""
    nodes = {}
    for s in spans:
        d = s.to_dict() if isinstance(s, Span) else dict(s)
        nodes[d["span_id"]] = {"span": d, "children": []}
    for sid, node in nodes.items():
        pid = node["span"]["parent_id"]
        if pid is None:
            continue
        if pid not in nodes:
            raise ValueError(f"span {sid} has dangling parent_id {pid}")
        nodes[pid]["children"].append(sid)
    return nodes


def request_latencies(spans) -> list[dict]:
    """``{"rid", "ttft", "tpot", "total", "tokens"}`` of every closed root
    ``request`` span with a token event: TTFT the first token's time less
    the span's start, TPOT the mean gap between the time-sorted token
    events (None with one token; a speculative round commits several
    tokens at one time, so a step count would overstate it), in the
    clock's units."""
    out = []
    for s in spans:
        d = s.to_dict() if isinstance(s, Span) else dict(s)
        if d["name"] != "request" or d["t_end"] is None:
            continue
        toks = sorted(e["t"] for e in d["events"] if e["name"] == "token")
        if not toks:
            continue
        gaps = [t1 - t0 for t0, t1 in zip(toks, toks[1:])]
        out.append({"rid": d["trace_id"], "ttft": toks[0] - d["t_start"],
                    "tpot": sum(gaps) / len(gaps) if gaps else None,
                    "total": d["t_end"] - d["t_start"], "tokens": len(toks)})
    return out


def percentile(values, q: float) -> float | None:
    """Nearest-rank percentile (q in [0, 100]); None on no values."""
    vals = sorted(v for v in values if v is not None)
    if not vals:
        return None
    k = max(0, min(len(vals) - 1, int(round(q / 100.0 * (len(vals) - 1)))))
    return vals[k]
