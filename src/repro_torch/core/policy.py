"""AccumulationPolicy: per-GEMM accumulator formats from the VRR solver.

Counterpart of ``repro.core.policy``: the ``exact``, ``predicted`` and
``perturbed`` modes (the paper's PP sweep) and ``plan_for_model``, which
builds a ``QuantPlan`` of the port's ``QDotConfig`` per dense GEMM type.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.precision import min_m_acc
from repro_torch.quant.formats import FP8_152, FPFormat

__all__ = ["GEMMPrecision", "AccumulationPolicy", "plan_for_model"]

MODES = ("exact", "predicted", "perturbed")


@dataclass(frozen=True)
class GEMMPrecision:
    """Accumulator assignment for one GEMM role: a (1, e_acc, m_acc) carry
    rounded once per ``chunk`` products."""

    m_acc: int
    e_acc: int = 6
    chunk: int = 64

    @property
    def fmt(self) -> FPFormat:
        return FPFormat(e=self.e_acc, m=self.m_acc)


@dataclass(frozen=True)
class AccumulationPolicy:
    """``mode="exact"``: native wide accumulation everywhere.
    ``mode="predicted"``: the solver's narrowest suitable width (PP = 0).
    ``mode="perturbed"``: the solver's width plus ``perturbation`` bits
    (negative = fewer), clamped to [1, M_ACC_CARRIER].

    ``rounding`` is the carry rounding of every solver-assigned GEMM:
    ``"rne"`` (the paper's round to nearest) or ``"sr"`` (stochastic
    rounding seeded by ``sr_seed``, the below-the-knee mode); the lm_head's
    fixed 16-bit carry stays RNE."""

    mode: str = "exact"
    m_p: int = 5          # (1,5,2) x (1,5,2) products carry 5 mantissa bits
    chunk: int = 64
    perturbation: int = 0
    nzr: float = 1.0
    e_acc: int = 6
    rounding: str = "rne"
    sr_seed: int = 0

    # the narrow carry lives in an f32 register: its mantissa cannot be
    # wider than f32's 23 bits
    M_ACC_CARRIER = 23

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")

    def for_length(self, n: int) -> GEMMPrecision | None:
        """Accumulator format for accumulation length ``n`` (None = exact)."""
        if self.mode == "exact":
            return None
        m = min_m_acc(n, self.m_p, chunked=self.chunk > 0,
                      chunk=self.chunk or 64, nzr=self.nzr)
        if self.mode == "perturbed":
            m = min(max(m + self.perturbation, 1), self.M_ACC_CARRIER)
        return GEMMPrecision(m_acc=m, e_acc=self.e_acc, chunk=self.chunk)

    def perturbed(self, pp: int) -> "AccumulationPolicy":
        return replace(self, mode="perturbed", perturbation=pp)


def plan_for_model(cfg, *, seq_len: int, global_batch: int,
                   policy: AccumulationPolicy):
    """``cfg`` with a QuantPlan of solver-assigned formats for every dense
    GEMM type.  FWD length = fan-in, BWD = fan-out, GRAD = tokens
    (``seq_len * global_batch``).  The lm_head keeps the paper's 16-bit
    practice: a fixed (1,6,9) carry with unquantized operands."""
    from repro_torch.kernels.ops import QDotConfig
    from repro_torch.models.config import QuantPlan

    if policy.mode == "exact":
        return replace(cfg, quant=QuantPlan())
    tokens = seq_len * global_batch

    def qcfg(fan_in: int, fan_out: int) -> QDotConfig:
        return QDotConfig(
            fwd=policy.for_length(fan_in),
            bwd=policy.for_length(fan_out),
            grad=policy.for_length(int(tokens * policy.nzr) or 1),
            repr_fmt=FP8_152, rounding=policy.rounding,
            sr_seed=policy.sr_seed)

    d, dh = cfg.d_model, cfg.head_dim
    qkv_out = (cfg.n_heads + 2 * cfg.n_kv_heads) * dh
    d_ff = cfg.d_ff or d
    head16 = GEMMPrecision(m_acc=9, e_acc=6, chunk=policy.chunk)
    plan = QuantPlan(
        attn_qkv=qcfg(d, qkv_out),
        attn_out=qcfg(cfg.n_heads * dh, d),
        mlp_up=qcfg(d, d_ff),
        mlp_down=qcfg(d_ff, d),
        lm_head=QDotConfig(fwd=head16, bwd=head16, grad=head16,
                           repr_fmt=None))
    return replace(cfg, quant=plan)
