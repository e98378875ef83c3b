"""Process-wide metrics registry: labelled counters, gauges, histograms.

Counterpart of ``repro.obs.metrics``.  One registry gathers the signals of
the serve engine (tokens, slabs, preemptions, TTFT/TPOT), the speculative
lane, the precision controller's and the serve monitor's knee-loop events,
the executors' compile cache, the certification memo and the kernels'
launch counts, with two exporters: ``export_jsonl(path)`` (one sample a
line) and ``to_prometheus()``/``export_prometheus(path)`` (the Prometheus
textfile-collector format, no HTTP server in the process).  Names follow
``repro_<area>_<noun>`` with unit suffixes (``_total``, ``_seconds``);
``constant_labels`` stamp every sample of a registry.  Everything here is
host Python: recording reads no device value.

One deliberate difference (ROADMAP Queue 3, T8): JAX's
``collect_process_metrics`` sweeps Pallas trace counts
(``repro_kernel_traces``); the port has no traces, so it sweeps the
kernel wrappers' launch counts (``fn.launches`` and the variants'
counters) into ``repro_kernel_launches``, labelled by kernel.
"""

from __future__ import annotations

import re
import threading

from repro_torch.obs.sink import jsonl_append

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "set_registry", "collect_process_metrics",
    "kernel_launch_counts", "parse_prometheus", "record_controller_events",
    "record_spec_events",
]

# latency buckets (seconds), JAX's: wide, since the simulation's clock
# counts ticks and a CPU run is far slower than the card
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   50.0, 100.0, float("inf"))


def _label_key(label_names, labels: dict) -> tuple:
    if set(labels) != set(label_names):
        raise ValueError(
            f"expected labels {sorted(label_names)}, got {sorted(labels)}")
    return tuple(str(labels[k]) for k in label_names)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", label_names=()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._data: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _samples(self):
        """[(label_values_tuple, value)] — value shape is kind-specific."""
        with self._lock:
            return list(self._data.items())


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        k = _label_key(self.label_names, labels)
        with self._lock:
            self._data[k] = self._data.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._data.get(_label_key(self.label_names, labels), 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._data[_label_key(self.label_names, labels)] = float(value)

    def value(self, **labels) -> float | None:
        return self._data.get(_label_key(self.label_names, labels))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", label_names=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        b = tuple(sorted(buckets))
        if not b or b[-1] != float("inf"):
            b = b + (float("inf"),)
        self.buckets = b

    def observe(self, value: float, **labels) -> None:
        k = _label_key(self.label_names, labels)
        with self._lock:
            cell = self._data.get(k)
            if cell is None:
                cell = {"counts": [0] * len(self.buckets),
                        "sum": 0.0, "count": 0}
                self._data[k] = cell
            for i, b in enumerate(self.buckets):
                if value <= b:
                    cell["counts"][i] += 1
                    break
            cell["sum"] += float(value)
            cell["count"] += 1

    def summary(self, **labels) -> dict | None:
        return self._data.get(_label_key(self.label_names, labels))


class MetricsRegistry:
    """Get-or-create metric store.  Re-registering a name returns the same
    metric (label set and kind must match — a mismatch is a bug, not a new
    metric)."""

    def __init__(self, constant_labels: dict | None = None):
        self.constant_labels = dict(constant_labels or {})
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, labels, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labels, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls) or m.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} "
                    f"with labels {m.label_names}")
            return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # ------------------------------ export ---------------------------------
    def snapshot(self) -> list[dict]:
        """Flat sample list: ``{"metric", "type", "labels", ...values}``."""
        out = []
        const = self.constant_labels
        for name in sorted(self._metrics):
            m = self._metrics[name]
            for key, val in m._samples():
                labels = {**const, **dict(zip(m.label_names, key))}
                rec = {"metric": name, "type": m.kind, "labels": labels}
                if m.kind == "histogram":
                    rec.update(sum=val["sum"], count=val["count"],
                               buckets=list(m.buckets[:-1]) + ["+Inf"],
                               counts=list(val["counts"]))
                else:
                    rec["value"] = val
                out.append(rec)
        return out

    def to_prometheus(self) -> str:
        """Prometheus textfile-collector exposition text."""
        def fmt_labels(d):
            if not d:
                return ""
            inner = ",".join(f'{k}="{v}"' for k, v in sorted(d.items()))
            return "{" + inner + "}"

        def fmt_le(b):
            return "+Inf" if b == float("inf") else repr(float(b))

        lines = []
        const = self.constant_labels
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, val in m._samples():
                labels = {**const, **dict(zip(m.label_names, key))}
                if m.kind == "histogram":
                    cum = 0
                    for b, c in zip(m.buckets, val["counts"]):
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            f"{fmt_labels({**labels, 'le': fmt_le(b)})} {cum}")
                    lines.append(f"{name}_sum{fmt_labels(labels)} {val['sum']}")
                    lines.append(f"{name}_count{fmt_labels(labels)} {val['count']}")
                else:
                    lines.append(f"{name}{fmt_labels(labels)} {val}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export_prometheus(self, path: str) -> None:
        import os
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_prometheus())

    def export_jsonl(self, path: str) -> int:
        rows = self.snapshot()
        jsonl_append(path, rows)
        return len(rows)


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"(,|$)')


def parse_prometheus(text: str) -> dict:
    """Read textfile-collector exposition text back: ``{(name, ((label,
    value), ...)): float}`` of every sample, the ``# HELP``/``# TYPE``
    lines checked for form.  Raises ``ValueError`` on a line that does not
    parse (what a scrape of the exported file would reject)."""
    out = {}
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("#"):
            parts = ln.split(" ", 3)
            if parts[1] not in ("HELP", "TYPE") or len(parts) < 3 or (
                    parts[1] == "TYPE" and parts[3:] not in (
                        ["counter"], ["gauge"], ["histogram"], ["untyped"])):
                raise ValueError(f"bad comment line {ln!r}")
            continue
        m = _SAMPLE.match(ln)
        if m is None:
            raise ValueError(f"bad sample line {ln!r}")
        labels = ()
        if m.group(3):
            pairs = _LABEL.findall(m.group(3))
            if ",".join(f'{k}="{v}"' for k, v, _ in pairs) != m.group(3):
                raise ValueError(f"bad labels in {ln!r}")
            labels = tuple((k, v) for k, v, _ in pairs)
        out[(m.group(1), labels)] = float(m.group(4))
    return out


def record_controller_events(registry: MetricsRegistry, events,
                             *, area: str = "controller") -> None:
    """Mirror knee-loop event dicts (precision controller / serve monitor —
    both share the ``{"gemm", "role", "event", ...}`` schema) into the
    registry: an event counter plus per-(gemm, role) gauges of the live
    numerics signals."""
    n_events = registry.counter(
        f"repro_{area}_events_total", f"{area} knee-loop events",
        labels=("gemm", "role", "event"))
    gauges = {
        "m_acc": registry.gauge(f"repro_{area}_m_acc",
                                "running accumulator mantissa width",
                                labels=("gemm", "role")),
        "measured_vrr": registry.gauge(f"repro_{area}_measured_vrr",
                                       "live variance retention ratio",
                                       labels=("gemm", "role")),
        "log_v": registry.gauge(f"repro_{area}_log_v",
                                "measured knee-test statistic v(n2)",
                                labels=("gemm", "role")),
        "swamp_rate": registry.gauge(f"repro_{area}_swamp_rate",
                                     "fully-absorbed chunk-add fraction",
                                     labels=("gemm", "role")),
    }
    for e in events:
        gemm = str(e.get("gemm", "?"))
        role = str(e.get("role", "?"))
        n_events.inc(gemm=gemm, role=role, event=str(e.get("event", "?")))
        for field, gauge in gauges.items():
            v = e.get(field)
            if v is not None:
                gauge.set(float(v), gemm=gemm, role=role)


def record_spec_events(registry: MetricsRegistry, events,
                       *, area: str = "serve_spec") -> None:
    """Mirror speculative-decode ``spec_round`` event dicts (one per batch
    row per round, emitted by ``serve.spec.SpecDecodeEngine``) into the
    registry: round/proposal/acceptance/emission/rollback counters plus a
    rollback-depth histogram — the ``record_controller_events`` posture
    applied to the spec lane's schema."""
    rounds = registry.counter(
        f"repro_{area}_rounds_total",
        "speculative rounds (one per batch row per draft/verify cycle)")
    counters = {
        "proposed": registry.counter(
            f"repro_{area}_proposed_tokens_total",
            "draft tokens proposed"),
        "accepted": registry.counter(
            f"repro_{area}_accepted_tokens_total",
            "draft tokens the verify pass accepted"),
        "emitted": registry.counter(
            f"repro_{area}_emitted_tokens_total",
            "tokens committed by spec rounds (accepted + bonus)"),
        "rollback_depth": registry.counter(
            f"repro_{area}_rollback_tokens_total",
            "rejected tokens scrubbed by page-exact rollback"),
    }
    depth = registry.histogram(
        f"repro_{area}_rollback_depth",
        "per-round rollback depth in tokens",
        buckets=(0, 1, 2, 4, 8, 16, float("inf")))
    for e in events:
        if e.get("event") != "spec_round":
            continue
        rounds.inc()
        for field, c in counters.items():
            v = e.get(field)
            if v:
                c.inc(float(v))
        d = e.get("rollback_depth")
        if d is not None:
            depth.observe(float(d))


# --------------------------- process-wide default ---------------------------

_DEFAULT: MetricsRegistry | None = None
_DEFAULT_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry (created on first use)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT


def set_registry(registry: MetricsRegistry | None) -> None:
    """Swap the process-wide registry (tests install a fresh one)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = registry


def kernel_launch_counts() -> dict:
    """``{kernel: launches}`` of every kernel wrapper's counters, read from
    the host (no device sync): ``qmatmul_fused`` is
    ``qmatmul_fused.launches``, ``qmatmul_fused.fold`` its
    ``fold_launches``, and so on."""
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import bwd_pair as B
    from repro_torch.kernels import fused as F
    from repro_torch.kernels import qmatmul as K3
    from repro_torch.kernels import quantize as K2

    out = {}
    for fn in (F.qmatmul_fused, B.qmatmul_bwd_pair, A.paged_attn_decode,
               A.flash_prefill_paged, A.flash_prefill_paged_geom,
               A.flash_prefill, K2.quantize, K3.qmatmul):
        for attr in sorted(vars(fn)):
            if attr.endswith("launches"):
                kind = attr[:-len("launches")].rstrip("_")
                out[fn.__name__ + ("." + kind if kind else "")] = \
                    getattr(fn, attr)
    return out


def collect_process_metrics(registry: MetricsRegistry) -> None:
    """Sweep the process-wide counter surfaces into ``registry`` as gauges:
    the kernels' launch counts, the knee-certification memo and the serve
    compile cache.  Idempotent (gauges are set), so call it right before
    exporting."""
    from repro_torch.serve import plan as _plan
    from repro_torch.serve import scheduler as _sched

    g = registry.gauge("repro_kernel_launches",
                       "kernel launches since process start (or the last "
                       "reset of the wrappers' counts)", labels=("kernel",))
    for kernel, count in kernel_launch_counts().items():
        g.set(count, kernel=kernel)

    cert = _plan.certification_stats()
    g = registry.gauge("repro_knee_certifications",
                       "knee-test certification memo traffic",
                       labels=("key",))
    for key, count in cert.items():
        g.set(count, key=key)

    cache = _sched.process_cache_stats()
    g = registry.gauge("repro_serve_compile_cache",
                       "process-wide serve compile cache traffic",
                       labels=("key",))
    for key, count in cache.items():
        g.set(count, key=key)
