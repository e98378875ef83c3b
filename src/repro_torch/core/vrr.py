"""Variance Retention Ratio (VRR), closed form (float64 numpy).

Counterpart of ``repro.core.vrr``, restricted to what the serving slice
uses: ``vrr`` (Theorem 1), ``vrr_chunked`` (Corollary 1),
``log_variance_lost`` (log of Eq. 6) and the §4.4 cutoff.  ``m_p`` is the
mantissa width of the product terms, ``m_acc`` the accumulator mantissa
width, ``n`` the accumulation length.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["qfunc", "vrr", "vrr_chunked", "log_variance_lost",
           "CUTOFF_LOG_V"]

# Paper §4.4: m_acc is suitable for length n iff v(n) < 50.
CUTOFF_LOG_V = math.log(50.0)

_erfc_vec = np.vectorize(math.erfc, otypes=[np.float64])


def qfunc(x):
    """Q(x) = P[N(0,1) > x] = 0.5 * erfc(x / sqrt(2)), vectorized float64."""
    x = np.asarray(x, dtype=np.float64)
    return 0.5 * _erfc_vec(x / np.sqrt(2.0))


# Above this length the exact O(n) sums over i are replaced by trapezoidal
# quadrature on a geometric grid (the summands are smooth in log i).
_EXACT_SUM_MAX = 20_000
_GRID_POINTS = 4_096


def _q_i_terms(n: int, m_acc: int):
    """(i, q_i, weight) for i in [2, n-1]: exact enumeration for small n,
    a geometric grid with trapezoidal weights for large n."""
    if n < 3:
        z = np.zeros(0)
        return z, z, z
    if n <= _EXACT_SUM_MAX:
        i = np.arange(2, n, dtype=np.float64)
        w = np.ones_like(i)
    else:
        i = np.unique(
            np.rint(np.geomspace(2.0, float(n - 1), _GRID_POINTS))
        ).astype(np.float64)
        w = np.empty_like(i)
        w[1:-1] = (i[2:] - i[:-2]) / 2.0
        w[0] = (i[1] - i[0]) / 2.0 + 0.5
        w[-1] = (i[-1] - i[-2]) / 2.0 + 0.5
    t = float(2.0 ** m_acc)
    q = 2.0 * qfunc(t / np.sqrt(i)) * (1.0 - 2.0 * qfunc(t / np.sqrt(i - 1.0)))
    return i, q, w


def _alpha_partial(m_acc: int, m_p: int, j_hi: int) -> float:
    """alpha_j = 2^(m_acc - 3 m_p)/3 * sum_{j=1..j_hi} 2^j (2^j-1)(2^{j+1}-1)."""
    j = np.arange(1, j_hi + 1, dtype=np.float64)
    s = np.sum(2.0 ** j * (2.0 ** j - 1.0) * (2.0 ** (j + 1) - 1.0))
    return float(2.0 ** (m_acc - 3 * m_p) / 3.0 * s)


def vrr(m_acc: int, m_p: int, n: int) -> float:
    """Theorem 1: VRR with both full and partial swamping, in [0, 1]."""
    if n <= 1:
        return 1.0
    m_acc, m_p, n = int(m_acc), int(m_p), int(n)
    sqrt_n = math.sqrt(n)
    # full-swamping events A_i, i = 2..n-1, with partial-swamping loss
    alpha = _alpha_partial(m_acc, m_p, m_p)
    i, q, w = _q_i_terms(n, m_acc)
    mask = i > alpha
    num_full = float(np.sum((i[mask] - alpha) * q[mask] * w[mask]))
    k1 = float(np.sum(q[mask] * w[mask]))
    # boundary events A'_{j_r}, j_r = 2..m_p
    num_partial = 0.0
    k2 = 0.0
    for j_r in range(2, m_p + 1):
        alpha_jr = _alpha_partial(m_acc, m_p, j_r - 1)
        if not (n > alpha_jr):
            continue
        n_jm1 = 2.0 ** (m_acc - m_p + (j_r - 1) + 1)
        q_lo = qfunc(2.0 ** (m_acc - m_p + j_r - 1) / sqrt_n)
        q_hi = qfunc(2.0 ** (m_acc - m_p + j_r) / sqrt_n)
        q_prime = n_jm1 * 2.0 * q_lo * (1.0 - 2.0 * q_hi)
        num_partial += max(n - alpha_jr, 0.0) * q_prime
        k2 += q_prime
    # no-swamping event A_n
    k3 = max(1.0 - 2.0 * qfunc(2.0 ** (m_acc - m_p + 1) / sqrt_n), 0.0)
    k = k1 + k2 + k3
    if k <= 0.0:
        return 0.0
    out = (num_full + num_partial + n * k3) / (k * n)
    return float(min(max(out, 0.0), 1.0))


def vrr_chunked(m_acc: int, m_p: int, n1: int, n2: int) -> float:
    """Corollary 1: chunk size n1, n2 chunks; the inter-chunk operands carry
    ``min(m_acc, m_p + log2 n1)`` mantissa bits."""
    m_inter = min(m_acc, m_p + int(round(math.log2(max(n1, 1)))))
    return vrr(m_acc, m_p, n1) * vrr(m_acc, m_inter, n2)


def log_variance_lost(vrr_value: float, n: int) -> float:
    """log of Eq. (6): log v(n) = n * (1 - VRR).  Suitable iff < ln(50)."""
    return float(n) * (1.0 - float(vrr_value))
