"""In-graph numerics telemetry: swamping stats of the true training
gradients, from inside the train step.

Counterpart of ``repro.obs.ingraph``.  The eager telemetry tick measures
the backward roles on synthetic N(0, 1) gradients; tagging a model's
``QuantPlan`` (``tag_quant_plan``) sets ``QDotConfig.stats_tag`` on every
quantized field, which makes each ``qdot`` backward run the stats variant
of the backward pair (K9's kernel: dx and dw bitwise the untagged ones,
plus the BWD and GRAD rows) and one K8 replay of the saved residuals (the
FWD row).  The tagged step is therefore the untagged step, bit for bit,
and a cadence tick can take its place.

Data path: each tagged backward hands its device rows to the active
``InGraphCollector`` (``dispatch_raw``), which only keeps them; the tick
copies them to the host once, after the step, and merges them in arrival
order in float64 (slot-wise ``+``, ``max`` for MAX_ABS: the exact ensemble
union, so layers sharing a plan field and microbatches compose).  There is
no host sync per GEMM.

Under stochastic rounding the tagged backward draws its roles' streams as
the untagged one does: K9 takes the BWD and GRAD role seeds and the FWD
replay the FWD seed (``kernels.ops``), so the tagged step stays the
untagged step bitwise.  The windows reach the controller as RNE probes,
as in the JAX package, whose collector records no rounding.

``InGraphTelemetry`` runs the cadence tick: it caches the tagged model's
step and runs observe -> (on a schedule change) re-plan, as
``repro_torch.train.loop.run_telemetry_tick`` does; with a ``registry``
(``obs.metrics``) each tick's controller events are recorded there
(``record_controller_events``, area ``controller``), as JAX's tick does.

Under a mesh (``InGraphTelemetry(dist=)``) each row is reduced as it is
emitted over the mesh axes its role's work is split over (the batch axes
for FWD, every split axis for BWD and GRAD; ``kernels.ops._psum_row``), so
every rank's collector holds one global window per site, whose counts and
max are the single device's, and every rank's controller reaches the same
verdicts.  JAX's configs name the reduction's axes (``stats_axis``); no
one tuple names the port's per-role axes, so its configs carry none.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import replace

import numpy as np
import torch

from repro_torch.kernels.common import N_STATS, STAT_COUNT, STAT_MAX_ABS
from repro_torch.telemetry.controller import PLAN_FIELDS, GemmProbe
from repro_torch.telemetry.stats import EnsembleStats

__all__ = ["InGraphCollector", "InGraphTelemetry", "collecting",
           "dispatch_raw", "tag_quant_plan"]

_ADDITIVE = tuple(i for i in range(N_STATS) if i != STAT_MAX_ABS)

# active-collector stack: an empty stack drops the rows
_STACK: list["InGraphCollector"] = []


def dispatch_raw(tag: str, role: str, n: int, n1: int, m_acc: int,
                 row) -> None:
    """Route one float32 (N_STATS,) stats row (a tensor, on the device of
    the GEMM that made it) and its geometry to the active collector;
    dropped when none is active."""
    if _STACK:
        _STACK[-1].emit(tag, role, n, n1, m_acc, row)


@contextmanager
def collecting(collector: "InGraphCollector"):
    _STACK.append(collector)
    try:
        yield collector
    finally:
        _STACK.pop()


class InGraphCollector:
    """Accumulator of stats rows keyed (tag, role).

    ``emit`` keeps a row as it comes (no copy to the host); ``flush``
    copies every pending row to the host in one transfer and ``ingest``s
    them in arrival order.  Rows under one key sum-merge in float64;
    ``n`` keeps the longest accumulation (the eager probe's merge rule).
    Zero-count rows are merge identities and are dropped.
    """

    def __init__(self):
        self._cells: dict[tuple[str, str], dict] = {}
        self._pending: list[tuple] = []

    def emit(self, tag: str, role: str, n: int, n1: int, m_acc: int,
             row) -> None:
        self._pending.append((tag, role, int(n), int(n1), int(m_acc), row))

    def flush(self) -> None:
        if not self._pending:
            return
        host = torch.stack([r.reshape(-1).to(torch.float64)
                            for *_, r in self._pending]).cpu().numpy()
        for (tag, role, n, n1, m_acc, _), row in zip(self._pending, host):
            if row[STAT_COUNT] > 0:
                self.ingest(tag, role, n, n1, m_acc, row)
        self._pending.clear()

    def ingest(self, tag: str, role: str, n: int, n1: int, m_acc: int,
               row: np.ndarray) -> None:
        """Merge one host row (float64) into its cell."""
        cell = self._cells.get((tag, role))
        if cell is None:
            self._cells[(tag, role)] = {
                "row": np.array(row, np.float64), "n": int(n), "n1": int(n1),
                "m_acc": int(m_acc), "emissions": 1,
            }
            return
        r = cell["row"]
        for i in _ADDITIVE:
            r[i] += row[i]
        r[STAT_MAX_ABS] = max(r[STAT_MAX_ABS], row[STAT_MAX_ABS])
        cell["n"] = max(cell["n"], int(n))
        cell["emissions"] += 1

    def __len__(self) -> int:
        self.flush()
        return len(self._cells)

    def clear(self) -> None:
        self._cells.clear()
        self._pending.clear()

    def rows(self) -> dict[tuple[str, str], np.ndarray]:
        """The merged float64 row of every (tag, role)."""
        self.flush()
        return {key: cell["row"].copy() for key, cell in self._cells.items()}

    def probes(self) -> dict[tuple[str, str], GemmProbe]:
        """The collected windows as controller probes: drop-in for
        ``probe_model_stats``'s result, measured on the true gradients."""
        self.flush()
        return {
            key: GemmProbe(stats=EnsembleStats.from_raw(cell["row"]),
                           n=cell["n"], n1=cell["n1"], m_acc=cell["m_acc"])
            for key, cell in self._cells.items()
        }


def tag_quant_plan(model_cfg):
    """The stats-variant ModelConfig: every quantized plan field tagged
    with its own name.  Numerics are untouched."""
    plan = model_cfg.quant
    for name in PLAN_FIELDS:
        qcfg = getattr(plan, name, None)
        if qcfg is None or qcfg.is_exact:
            continue
        plan = replace(plan, **{name: replace(qcfg, stats_tag=name)})
    return replace(model_cfg, quant=plan)


class InGraphTelemetry:
    """Runs the in-graph cadence tick.

    ``tick(model, state, batch, step=...)`` runs ONE tagged train step
    (bitwise the normal step: use its state, the step is not repeated),
    feeds the collected windows to the controller, and returns ``(state,
    metrics, events, new_model_or_None)``, the re-plan contract of
    ``run_telemetry_tick``.  The tagged model's step is built once and
    cached until the model changes.  The port has no autotuner, so a
    re-plan has nothing to re-tune.  ``registry``: a ``MetricsRegistry``
    that records each tick's controller events.
    """

    def __init__(self, controller, train_cfg, *, seq_len: int,
                 global_batch: int, registry=None, dist=None):
        from repro_torch.dist import LOCAL

        self.registry = registry
        self.dist = LOCAL if dist is None else dist
        self.controller = controller
        self.train_cfg = train_cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self._cached: tuple | None = None  # (model_cfg, step fn)

    def due(self, step: int) -> bool:
        return self.controller.due(step)

    def stats_step(self, model):
        """The tagged model's train step (cached per model config)."""
        if self._cached is not None and self._cached[0] == model.cfg:
            return self._cached[1]
        from repro_torch.models.api import get_model
        from repro_torch.train.loop import make_train_step

        tagged = get_model(tag_quant_plan(model.cfg))
        fn = make_train_step(tagged, self.train_cfg, self.dist)
        self._cached = (model.cfg, fn)
        return fn

    def tick(self, model, state: dict, batch: dict, *, step: int):
        fn = self.stats_step(model)
        collector = InGraphCollector()
        with collecting(collector):
            new_state, metrics = fn(state, batch)
        events = self.controller.observe(step, collector.probes())
        if self.registry is not None:
            from repro_torch.obs.metrics import record_controller_events

            record_controller_events(self.registry, events,
                                     area="controller")
        if not self.controller.dirty:
            return new_state, metrics, events, None
        from repro_torch.models.api import get_model
        from repro_torch.telemetry.controller import apply_schedule

        new_cfg = apply_schedule(model.cfg, self.controller.policy,
                                 self.controller.schedule(),
                                 seq_len=self.seq_len,
                                 global_batch=self.global_batch)
        self._cached = None
        return new_state, metrics, events, get_model(new_cfg)
