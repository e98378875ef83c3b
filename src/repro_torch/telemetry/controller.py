"""Closed-loop accumulation-precision controller.

Counterpart of ``repro.telemetry.controller``.  The paper sizes
accumulators offline; this loop takes, every telemetry cadence tick, the
MEASURED variance retention of each monitored GEMM accumulator
(``EnsembleStats``, from the stats kernels), evaluates the paper's §4.4
knee test on the measurement and on the closed-form prediction, and, with
hysteresis, bumps or trims that GEMM's ``m_acc``:

* **bump** when either log-v breaches the cutoff ``hysteresis`` consecutive
  ticks (the measured breach catches what the model cannot see, the
  predicted one what the measurement cannot resolve);
* **trim** when the accumulator sits above the solver bound while the
  measurement shows comfortable margin (below ``trim_frac`` of the cutoff)
  and the closed form certifies the next narrower width.

For a chunked kernel the measured retention is the inter-chunk stage's, so
the knee test runs at ``n2 = ceil(n / n1)``.  Every decision (and every
"ok") is appended to a JSONL event log, one object per line::

    {"step", "gemm", "role", "event",            # "bump" | "trim" | "ok"
     "source",                                   # "measured" | "predicted" |
                                                 #   "both" | null
     "m_acc", "m_pred",                          # running / solver-bound width
     "measured_vrr", "predicted_vrr",            # live vs closed-form VRR
     "log_v", "log_v_pred", "cutoff",            # knee-test operands (n2-based)
     "swamp_rate", "max_exp",                    # raw swamping signals
     "n", "n1", "n2",                            # accumulation geometry
     "rounding",                                 # carry mode: "rne" | "sr"
     "noise_ratio", "jitter_fraction"}           # SR-mode error decomposition

A stochastic-rounding probe (``rounding="sr"``) runs the knee test on the
jitter statistic and acts on the measured breach only; the eager probe
hands the controller its configs' rounding (``telemetry.probe``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any

from repro_torch.core.policy import AccumulationPolicy
from repro_torch.core.vrr import CUTOFF_LOG_V
from repro_torch.obs.sink import jsonl_append
from repro_torch.telemetry.stats import EnsembleStats, predicted_kernel_vrr

__all__ = ["ControllerConfig", "GemmProbe", "PrecisionController",
           "apply_schedule", "PLAN_FIELDS", "ROLES"]

PLAN_FIELDS = ("attn_qkv", "attn_out", "mlp_up", "mlp_down", "lm_head")
ROLES = ("fwd", "bwd", "grad")


@dataclass(frozen=True)
class ControllerConfig:
    cadence: int = 50          # steps between telemetry probes
    hysteresis: int = 2        # consecutive agreeing ticks before acting
    trim_frac: float = 0.2     # trim only when v_meas < trim_frac * cutoff
    cutoff: float = CUTOFF_LOG_V
    # f32 carrier mantissa — the emulation ceiling (one constant everywhere)
    m_acc_max: int = AccumulationPolicy.M_ACC_CARRIER
    m_acc_min: int = 1
    max_trim_below: int = 0    # how far below the solver bound trims may go
    # GEMMs whose widths are pinned by practice, not by the solver (the
    # paper keeps the last layer at 16-bit): monitored and bumpable, but
    # never trimmed toward the solver bound
    pinned: tuple = ("lm_head",)


@dataclass(frozen=True)
class GemmProbe:
    """One monitored accumulator's measurement + geometry: the stats
    window, the total accumulation length ``n``, the chunk length ``n1``
    (the kernel's rounding cadence) and the currently-running ``m_acc``.

    ``rounding`` is the carry-rounding mode of the probed kernel ("rne" or
    "sr") — it selects which knee statistic the controller evaluates, since
    the two modes fail differently (RNE swamping REMOVES variance, SR
    injects zero-mean jitter; see ``EnsembleStats.measured_log_v_sr``)."""

    stats: EnsembleStats
    n: int
    n1: int
    m_acc: int
    rounding: str = "rne"


@dataclass
class PrecisionController:
    """Hysteresis loop over per-(gemm, role) accumulator widths.

    ``observe(step, probes)`` ingests one telemetry tick and returns the
    event records it logged; ``schedule()`` is the realized per-GEMM
    ``m_acc`` map (empty until the controller first acts), consumed by
    ``apply_schedule``; ``to_meta``/``restore_meta`` serialize it for a
    checkpoint's meta (``train.checkpoint``).
    """

    policy: Any                      # the base AccumulationPolicy
    cfg: ControllerConfig = field(default_factory=ControllerConfig)
    log_path: str | None = None

    def __post_init__(self):
        self._schedule: dict[tuple[str, str], int] = {}
        self._streak: dict[tuple[str, str], int] = {}
        self.dirty = False

    # ------------------------------ observe --------------------------------
    def due(self, step: int) -> bool:
        return self.cfg.cadence > 0 and step % self.cfg.cadence == 0

    def _predicted_bound(self, n: int) -> int:
        """The solver's m_acc for length ``n`` under the UNPERTURBED policy
        (the closed-form bound the loop steers toward)."""
        p = replace(self.policy, mode="predicted", perturbation=0)
        sol = p.for_length(n)
        return sol.m_acc if sol is not None else self.cfg.m_acc_max

    def observe(self, step: int,
                probes: dict[tuple[str, str], GemmProbe]) -> list[dict]:
        events = []
        for key, probe in sorted(probes.items()):
            sr = probe.rounding == "sr"
            n2 = max(-(-probe.n // max(probe.n1, 1)), 1)
            m_pred = self._predicted_bound(probe.n)
            measured = float(probe.stats.measured_vrr)
            v_meas = float(probe.stats.measured_log_v_sr(n2) if sr
                           else probe.stats.measured_log_v(n2))
            pred = predicted_kernel_vrr(probe.m_acc, self.policy.m_p,
                                        probe.n1, n2, nzr=self.policy.nzr)
            v_pred = n2 * (1.0 - pred)
            floor = max(m_pred - self.cfg.max_trim_below, self.cfg.m_acc_min)

            breach_m = v_meas >= self.cfg.cutoff
            # the closed form models RNE swamping (variance REMOVAL); under
            # SR the carry error is injected zero-mean jitter, so the
            # prediction would flag every deliberately below-knee width the
            # SR mode exists to run at — SR acts on measurement only
            breach_p = (not sr) and v_pred >= self.cfg.cutoff
            source = ("both" if breach_m and breach_p
                      else "measured" if breach_m
                      else "predicted" if breach_p else None)

            streak = self._streak.get(key, 0)
            action = "ok"
            m_new = probe.m_acc
            if (breach_m or breach_p) and probe.m_acc < self.cfg.m_acc_max:
                streak = max(streak, 0) + 1
                if streak >= self.cfg.hysteresis:
                    action = "bump"
                    m_new = probe.m_acc + 1
            elif (key[0] not in self.cfg.pinned
                  and probe.m_acc > floor
                  and v_meas < self.cfg.trim_frac * self.cfg.cutoff
                  and self._trim_certified(probe, n2)):
                streak = min(streak, 0) - 1
                if streak <= -self.cfg.hysteresis:
                    action = "trim"
                    m_new = probe.m_acc - 1
            else:
                streak = 0
            if action != "ok":
                streak = 0
                self._schedule[key] = m_new
                self.dirty = True
            self._streak[key] = streak

            events.append({
                "step": step, "gemm": key[0], "role": key[1],
                "event": action, "source": source,
                "m_acc": m_new, "m_pred": m_pred,
                "measured_vrr": round(measured, 6),
                "predicted_vrr": round(float(pred), 6),
                "log_v": round(v_meas, 4), "log_v_pred": round(v_pred, 4),
                "cutoff": round(self.cfg.cutoff, 4),
                "swamp_rate": round(float(probe.stats.swamp_rate), 6),
                "max_exp": round(float(probe.stats.max_exponent), 2)
                if math.isfinite(float(probe.stats.max_exponent)) else None,
                "n": probe.n, "n1": probe.n1, "n2": n2,
                "rounding": probe.rounding,
                "noise_ratio": round(float(probe.stats.noise_ratio), 6),
                "jitter_fraction":
                    round(float(probe.stats.jitter_fraction), 6),
            })
        self._log(events)
        return events

    def _trim_certified(self, probe: GemmProbe, n2: int) -> bool:
        """Closed-form guard for trims: the next narrower width must still
        pass the knee test — measurement alone never under-provisions."""
        pred = predicted_kernel_vrr(probe.m_acc - 1, self.policy.m_p,
                                    probe.n1, n2, nzr=self.policy.nzr)
        return n2 * (1.0 - pred) < self.cfg.cutoff

    # ------------------------------ outputs --------------------------------
    def schedule(self) -> dict[tuple[str, str], int]:
        self.dirty = False
        return dict(self._schedule)

    def _log(self, events: list[dict]) -> None:
        if not self.log_path or not events:
            return
        jsonl_append(self.log_path, events)

    # --------------------------- checkpointing -----------------------------
    def to_meta(self) -> dict:
        """JSON-serializable realized precision schedule, written into
        checkpoint meta so a restore reproduces the precision trajectory."""
        return {f"{g}:{r}": m for (g, r), m in sorted(self._schedule.items())}

    def restore_meta(self, meta: dict | None) -> None:
        if not meta:
            return
        for key, m in meta.items():
            g, r = key.split(":")
            self._schedule[(g, r)] = int(m)
        self.dirty = bool(self._schedule)

    def streaks_meta(self) -> dict:
        """The hysteresis streaks, ``"<gemm>:<role>" -> streak``: with the
        schedule, what a resumed run needs to act on the same ticks as an
        uninterrupted one (the JAX package's checkpoints leave them out)."""
        return {f"{g}:{r}": s for (g, r), s in sorted(self._streak.items())}

    def restore_streaks(self, meta: dict | None) -> None:
        for key, s in (meta or {}).items():
            g, r = key.split(":")
            self._streak[(g, r)] = int(s)


def apply_schedule(model_cfg, policy, schedule: dict[tuple[str, str], int],
                   *, seq_len: int, global_batch: int):
    """Re-plan the model's QuantPlan under ``policy``, then overwrite the
    per-(gemm, role) ``m_acc`` with the controller's realized schedule.
    Returns a new ModelConfig; widths are clamped to the f32 carrier
    (``AccumulationPolicy.M_ACC_CARRIER``, the one emulation ceiling)."""
    from repro_torch.core.policy import plan_for_model

    cfg = plan_for_model(model_cfg, seq_len=seq_len,
                         global_batch=global_batch, policy=policy)
    plan = cfg.quant
    for (name, role), m in schedule.items():
        qcfg = getattr(plan, name, None)
        if qcfg is None or role not in ROLES:
            continue
        prec = getattr(qcfg, role)
        if prec is None:
            continue
        m = min(max(int(m), 1), AccumulationPolicy.M_ACC_CARRIER)
        plan = replace(plan, **{name: replace(qcfg, **{role: replace(prec, m_acc=m)})})
    return replace(cfg, quant=plan)
