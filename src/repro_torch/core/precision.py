"""Minimal accumulation-precision solver (paper §4.4).

Counterpart of ``repro.core.precision`` (``suitable`` and ``min_m_acc``).
"""

from __future__ import annotations

import math

from repro_torch.core.vrr import CUTOFF_LOG_V, log_variance_lost, vrr

__all__ = ["suitable", "min_m_acc"]


def suitable(m_acc: int, m_p: int, n: int, *, chunked: bool = False,
             chunk: int = 64, nzr: float = 1.0,
             cutoff: float = CUTOFF_LOG_V) -> bool:
    """True iff ``m_acc`` retains enough variance for a length-``n`` sum.
    Chunked accumulation applies the knee test per stage (intra-chunk at
    n1, inter-chunk at n2 with the grown inter-chunk operand mantissa)."""
    n_eff = max(int(round(nzr * n)), 1)
    if n_eff <= 1:
        return True
    if chunked:
        n1 = min(chunk, n)
        n2 = max(math.ceil(n / n1), 1)
        n1_eff = max(int(round(nzr * n1)), 1)
        m_inter = min(m_acc, m_p + int(round(math.log2(max(n1_eff, 1)))))
        intra_ok = log_variance_lost(vrr(m_acc, m_p, n1_eff), n1_eff) < cutoff
        inter_ok = log_variance_lost(vrr(m_acc, m_inter, n2), n2) < cutoff
        return intra_ok and inter_ok
    return log_variance_lost(vrr(m_acc, m_p, n_eff), n_eff) < cutoff


def min_m_acc(n: int, m_p: int, *, chunked: bool = False, chunk: int = 64,
              nzr: float = 1.0, m_acc_lo: int = 1, m_acc_hi: int = 32,
              cutoff: float = CUTOFF_LOG_V, floor: bool = True) -> int:
    """Smallest m_acc in [m_acc_lo, m_acc_hi] passing the v(n) < 50 test
    (binary search: VRR is monotone in m_acc).  ``floor`` enforces
    m_acc >= m_p + 1 (normal) / m_p (chunked), the paper's Table-1 floors."""
    lo, hi = m_acc_lo, m_acc_hi
    if floor:
        lo = max(lo, m_p if chunked else m_p + 1)
        hi = max(hi, lo)
    if not suitable(hi, m_p, n, chunked=chunked, chunk=chunk, nzr=nzr,
                    cutoff=cutoff):
        raise ValueError(f"no m_acc <= {hi} suitable for n={n}, m_p={m_p}")
    while lo < hi:
        mid = (lo + hi) // 2
        if suitable(mid, m_p, n, chunked=chunked, chunk=chunk, nzr=nzr,
                    cutoff=cutoff):
            hi = mid
        else:
            lo = mid + 1
    return lo
