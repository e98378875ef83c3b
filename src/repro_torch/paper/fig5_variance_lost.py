"""Paper Figure 5 (a, b): normalized exponential variance lost v(n) as a
function of accumulation length for m_acc in {6..14}, normal and
chunked-64.  Reported as the knee length per precision (the max n with
v(n) < 50), the quantity Table 1 is read off from.

Closed-form analysis (``repro_torch.core``), host arithmetic only; the
output lines are the JAX package's ``benchmarks/fig5_variance_lost.py``.

  PYTHONPATH=src python -m repro_torch.paper.fig5_variance_lost
"""

from __future__ import annotations

import math

from repro_torch.core.precision import suitable
from repro_torch.core.vrr import CUTOFF_LOG_V, log_variance_lost, vrr


def knee_length(m_acc: int, *, chunked: bool = False, m_p: int = 5) -> int:
    """Largest n (geometric search, then bisection) passing v(n) < 50."""
    lo, hi = 2, 2
    while suitable(m_acc, m_p, hi, chunked=chunked) and hi < 2 ** 34:
        lo, hi = hi, hi * 2
    if hi >= 2 ** 34:
        return hi
    while hi - lo > max(lo // 100, 1):  # 1% resolution
        mid = (lo + hi) // 2
        if suitable(m_acc, m_p, mid, chunked=chunked):
            lo = mid
        else:
            hi = mid
    return lo


def run(csv=False):
    print("### Fig 5a/b analogue: knee accumulation length per m_acc "
          "(m_p=5, chunk=64)")
    print(f"{'m_acc':>6s} {'knee (normal)':>15s} {'knee (chunked)':>15s} "
          f"{'chunk gain':>11s}")
    out = {}
    prev_n = None
    for m_acc in range(6, 15):
        kn = knee_length(m_acc)
        kc = knee_length(m_acc, chunked=True)
        gain = kc / kn
        ratio = f" (x{kn / prev_n:.1f} vs m-1)" if prev_n else ""
        print(f"{m_acc:6d} {kn:15,d} {kc:15,d} {gain:10.0f}x{ratio}")
        out[m_acc] = (kn, kc)
        prev_n = kn
    # v(n) around one knee, like the published figure
    m_acc = 9
    print(f"\nlog10 v(n) around the m_acc={m_acc} knee "
          f"(cutoff log10(50) = {CUTOFF_LOG_V / math.log(10):.2f}):")
    kn = out[m_acc][0]
    for mult in (0.25, 0.5, 1.0, 2.0, 4.0):
        n = int(kn * mult)
        lv = log_variance_lost(vrr(m_acc, 5, n), n) / math.log(10)
        print(f"  n = {n:10,d} ({mult:4.2f} x knee): log10 v = {lv:10.3g}")
    return {f"knee_normal_{m}": v[0] for m, v in out.items()}


if __name__ == "__main__":
    run()
