"""EnsembleStats: streaming swamping statistics and the measured VRR.

Counterpart of ``repro.telemetry.stats``.  The stats kernels (K8, K9 and
K12's ports: ``qmatmul_fused``, ``qmatmul_bwd_pair`` and
``paged_attn_decode`` with ``collect_stats=True``) reduce, per monitored
accumulator, one ``N_STATS`` row (``repro_torch.kernels.common``): the
ensemble moments of the reduced-precision and of the ideal (f32)
accumulation of the same products, the max carry magnitude and the
swamped-add counters.  ``EnsembleStats`` holds them in Welford form (count,
mean, M2), so windows merge exactly across steps (Chan's combine).

The headline quantity is ``measured_vrr``, Var(quantized sums) /
Var(ideal sums) over the output ensemble, comparable with the closed forms
of ``repro_torch.core.vrr``: ``predicted_kernel_vrr`` is the prediction for
the kernels' semantics (ideal f32 within a chunk, a quantized carry across
chunks).

A plain dataclass of float32 scalars (numpy): the rows reach the host once
per window, and every read-out is host arithmetic.  ``from_raw`` centers
the moments in float64 and rounds each field once to float32 (the JAX
package's ``from_raw`` states the same, but its ``jnp`` arithmetic
canonicalizes the float64 row to float32 first: ROADMAP F6).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.vrr import CUTOFF_LOG_V, vrr
from repro_torch.kernels.common import (
    N_STATS,
    STAT_ADDS,
    STAT_COUNT,
    STAT_MAX_ABS,
    STAT_SUM_ERR,
    STAT_SUM_I,
    STAT_SUM_Q,
    STAT_SUMSQ_ERR,
    STAT_SUMSQ_I,
    STAT_SUMSQ_Q,
    STAT_SWAMPED,
)

__all__ = ["EnsembleStats", "gemm_stats", "predicted_kernel_vrr",
           "host_row", "stats_kw"]

_f32 = np.float32
_ZERO = _f32(0.0)


def host_row(raw) -> np.ndarray:
    """A stats row (torch tensor on any device, or array-like) as a float64
    numpy vector."""
    if isinstance(raw, torch.Tensor):
        raw = raw.detach().to("cpu", torch.float64).numpy()
    return np.asarray(raw, np.float64).reshape(-1)


@dataclass(frozen=True)
class EnsembleStats:
    """Welford-form swamping statistics of one (or a merge of) accumulator
    ensembles; every field a float32 scalar."""

    count: np.float32      # ensemble size (output elements observed)
    mean_q: np.float32     # mean of reduced-precision sums
    m2_q: np.float32       # sum of squared deviations, reduced-precision
    mean_i: np.float32     # mean of ideal (f32) sums
    m2_i: np.float32       # sum of squared deviations, ideal
    max_abs: np.float32    # max |carry| over all chunk updates
    swamped: np.float32    # fully-absorbed chunk adds (q(c+p) == c, p != 0)
    adds: np.float32       # chunk adds with a non-zero addend
    err_sum: np.float32 = _ZERO    # sum of (q - ideal) over final outputs
    err_sumsq: np.float32 = _ZERO  # sum of (q - ideal)^2 over final outputs

    # ------------------------------ ingest ---------------------------------
    @classmethod
    def from_raw(cls, raw) -> "EnsembleStats":
        """From one kernel stats row (the (N_STATS,) float32 vector, on the
        device or the host; a device row is copied to the host here).  The
        ``sumsq - c * mean^2`` centering runs in float64."""
        raw = host_row(raw)
        c = raw[STAT_COUNT]
        safe = max(c, 1.0)
        mean_q = raw[STAT_SUM_Q] / safe
        mean_i = raw[STAT_SUM_I] / safe
        return cls(
            count=_f32(c),
            mean_q=_f32(mean_q),
            m2_q=_f32(max(raw[STAT_SUMSQ_Q] - c * mean_q * mean_q, 0.0)),
            mean_i=_f32(mean_i),
            m2_i=_f32(max(raw[STAT_SUMSQ_I] - c * mean_i * mean_i, 0.0)),
            max_abs=_f32(raw[STAT_MAX_ABS]),
            swamped=_f32(raw[STAT_SWAMPED]),
            adds=_f32(raw[STAT_ADDS]),
            err_sum=_f32(raw[STAT_SUM_ERR]),
            err_sumsq=_f32(raw[STAT_SUMSQ_ERR]),
        )

    @classmethod
    def zero(cls) -> "EnsembleStats":
        return cls(*([_ZERO] * 10))

    def to_raw(self) -> np.ndarray:
        """Inverse of ``from_raw`` (float32 arithmetic): the (N_STATS,) raw
        row, sums recomposed from the Welford moments.  Rows are closed
        under slot-wise ``+`` (``max`` in MAX_ABS) with the zero row as
        identity."""
        c = self.count
        row = [_ZERO] * N_STATS
        row[STAT_COUNT] = c
        row[STAT_SUM_Q] = c * self.mean_q
        row[STAT_SUMSQ_Q] = self.m2_q + c * self.mean_q * self.mean_q
        row[STAT_SUM_I] = c * self.mean_i
        row[STAT_SUMSQ_I] = self.m2_i + c * self.mean_i * self.mean_i
        row[STAT_MAX_ABS] = self.max_abs
        row[STAT_SWAMPED] = self.swamped
        row[STAT_ADDS] = self.adds
        row[STAT_SUM_ERR] = self.err_sum
        row[STAT_SUMSQ_ERR] = self.err_sumsq
        return np.array(row, np.float32)

    # ------------------------------ reduce ---------------------------------
    def merge(self, other: "EnsembleStats") -> "EnsembleStats":
        """Chan's parallel-Welford combine (associative, exact ensemble
        union), in float32 as the JAX package's."""
        ca, cb = self.count, other.count
        c = ca + cb
        safe = np.maximum(c, _f32(1.0))

        def comb(mean_a, m2_a, mean_b, m2_b):
            d = mean_b - mean_a
            mean = mean_a + d * cb / safe
            m2 = m2_a + m2_b + d * d * ca * cb / safe
            return mean, m2

        mq, m2q = comb(self.mean_q, self.m2_q, other.mean_q, other.m2_q)
        mi, m2i = comb(self.mean_i, self.m2_i, other.mean_i, other.m2_i)
        return EnsembleStats(
            count=c, mean_q=mq, m2_q=m2q, mean_i=mi, m2_i=m2i,
            max_abs=np.maximum(self.max_abs, other.max_abs),
            swamped=self.swamped + other.swamped,
            adds=self.adds + other.adds,
            err_sum=self.err_sum + other.err_sum,
            err_sumsq=self.err_sumsq + other.err_sumsq,
        )

    def psum(self, axis_name: str) -> "EnsembleStats":
        raise NotImplementedError(
            "mesh-wide reduction of stats windows comes with the sharding "
            "slice (ROADMAP [dist])")

    # ----------------------------- read-outs -------------------------------
    @property
    def var_q(self):
        return self.m2_q / np.maximum(self.count, _f32(1.0))

    @property
    def var_i(self):
        return self.m2_i / np.maximum(self.count, _f32(1.0))

    @property
    def measured_vrr(self):
        """Var(reduced-precision sums) / Var(ideal sums), the live VRR;
        1.0 when the ideal ensemble is degenerate."""
        if self.m2_i > 0.0:
            return self.m2_q / np.maximum(self.m2_i, _f32(1e-30))
        return _f32(1.0)

    @property
    def swamp_rate(self):
        return self.swamped / np.maximum(self.adds, _f32(1.0))

    @property
    def max_exponent(self):
        """log2 of the largest |carry| (headroom against e_acc's range);
        -inf for an empty window."""
        if self.max_abs > 0.0:
            return np.log2(np.maximum(self.max_abs, _f32(1e-30)))
        return _f32(-np.inf)

    def measured_log_v(self, n: int) -> float:
        """log v(n) = n (1 - VRR_measured), Eq. (6) on the measurement; use
        n = n2, the inter-chunk length, for the chunked kernels."""
        return float(n) * (1.0 - float(self.measured_vrr))

    @property
    def error_mse(self):
        return self.err_sumsq / np.maximum(self.count, _f32(1.0))

    @property
    def error_bias(self):
        return self.err_sum / np.maximum(self.count, _f32(1.0))

    @property
    def noise_ratio(self):
        """MSE / Var(ideal); 0 when the ideal ensemble is degenerate."""
        if self.m2_i > 0.0:
            return self.error_mse / np.maximum(self.var_i, _f32(1e-30))
        return _f32(0.0)

    @property
    def jitter_fraction(self):
        """1 - bias^2 / MSE: the error energy a constant offset does not
        explain."""
        mse = self.error_mse
        if mse > 0.0:
            b = self.error_bias
            return _f32(1.0) - b * b / np.maximum(mse, _f32(1e-30))
        return _f32(1.0)

    def measured_log_v_sr(self, n: int) -> float:
        """n times the rounding-noise share of the output's energy, the
        knee statistic of a stochastic-rounding carry."""
        r = float(self.noise_ratio)
        return float(n) * (r / (1.0 + r))

    def suitable(self, n: int, *, cutoff: float = CUTOFF_LOG_V,
                 rounding: str = "rne") -> bool:
        """The paper's §4.4 knee test on the measurement."""
        if rounding == "sr":
            return self.measured_log_v_sr(n) < cutoff
        return self.measured_log_v(n) < cutoff


def predicted_kernel_vrr(m_acc: int, m_p: int, n1: int, n2: int,
                         *, nzr: float = 1.0) -> float:
    """Closed-form VRR of the kernels' semantics: ideal f32 intra-chunk
    sums, a (1, e_acc, m_acc) inter-chunk carry, the inter-chunk stage of
    Corollary 1 with the grown operand mantissa ``min(m_acc, m_p + log2
    n1)``.  Compare with ``EnsembleStats.measured_vrr``."""
    n1_eff = max(int(round(nzr * n1)), 1)
    m_inter = min(m_acc, m_p + int(round(math.log2(max(n1_eff, 1)))))
    return vrr(m_acc, m_inter, max(int(n2), 1))


def stats_kw(p) -> dict:
    """``qmatmul_fused`` keywords of a GEMMPrecision-or-None role: its carry
    format and chunk (128, schedule only, for a wide role)."""
    if p is None:
        return dict(e_acc=8, m_acc=23, block_k=128)
    return dict(e_acc=p.e_acc, m_acc=p.m_acc,
                block_k=p.chunk if p.chunk > 0 else 128)


def gemm_stats(a: torch.Tensor, b: torch.Tensor, *, precision=None,
               repr_fmt=None, quantize_a: bool = True,
               quantize_b: bool = True, a_packed: bool = False,
               b_packed: bool = False, rounding: str = "rne",
               sr_seed: int = 0) -> tuple[torch.Tensor, EnsembleStats]:
    """One GEMM through K8's kernel: ``(c, EnsembleStats)``, c bitwise the
    stats-off call's; ``block_k`` is the precision's chunk."""
    from repro_torch.kernels.fused import qmatmul_fused

    y, raw = qmatmul_fused(
        a, b, repr_fmt=repr_fmt, quantize_a=quantize_a,
        quantize_b=quantize_b, a_packed=a_packed, b_packed=b_packed,
        collect_stats=True, rounding=rounding, sr_seed=sr_seed,
        **stats_kw(precision))
    return y, EnsembleStats.from_raw(raw)


def bwd_pair_stats(g: torch.Tensor, xq: torch.Tensor, wq: torch.Tensor, *,
                   repr_fmt=None, bwd=None, grad=None, packed: bool = True,
                   quantize_g: bool = True, rounding: str = "rne",
                   sr_seed_bwd: int = 0, sr_seed_grad: int = 0):
    """The backward pair through K9's kernel: ``(dx, dw, bwd_stats,
    grad_stats)``, dx and dw bitwise the stats-off pair's; each role's
    chunk is its precision's (128, schedule only, for a wide role)."""
    from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair

    b, gr = stats_kw(bwd), stats_kw(grad)
    dx, dw, raw = qmatmul_bwd_pair(
        g, xq, wq, repr_fmt=repr_fmt, bwd_acc=(b["e_acc"], b["m_acc"]),
        grad_acc=(gr["e_acc"], gr["m_acc"]), bwd_chunk=b["block_k"],
        grad_chunk=gr["block_k"], packed=packed, quantize_g=quantize_g,
        collect_stats=True, rounding=rounding, sr_seed_bwd=sr_seed_bwd,
        sr_seed_grad=sr_seed_grad)
    return (dx, dw, EnsembleStats.from_raw(raw[0]),
            EnsembleStats.from_raw(raw[1]))
