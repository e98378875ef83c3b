"""Paper Figure 5c: VRR as a function of chunk size for several
accumulation setups, showing the flat maximum (the exact chunk size does
not matter as long as it is neither too small nor too large).

Closed-form analysis (``repro_torch.core.vrr``), host arithmetic only; the
output lines are the JAX package's ``benchmarks/fig5c_chunk_sweep.py``.

  PYTHONPATH=src python -m repro_torch.paper.fig5c_chunk_sweep
"""

from __future__ import annotations

from repro_torch.core.vrr import vrr, vrr_chunked

SETUPS = [
    # (m_acc, m_p, n): the paper's "several accumulation setups"
    (6, 5, 2 ** 14),
    (7, 5, 2 ** 16),
    (8, 5, 2 ** 18),
    (9, 5, 2 ** 20),
]


def run(csv=False):
    chunk_sizes = [2 ** k for k in range(2, 13)]
    print("### Fig 5c analogue: VRR vs chunk size (dashed = no chunking)")
    header = "m_acc  n       nochunk " + " ".join(f"{c:>7d}" for c in chunk_sizes)
    print(header)
    out = {}
    for m_acc, m_p, n in SETUPS:
        base = vrr(m_acc, m_p, n)
        vals = [vrr_chunked(m_acc, m_p, c, -(-n // c)) for c in chunk_sizes]
        print(f"{m_acc:5d}  2^{len(bin(n)) - 3:<4d} {base:7.4f} "
              + " ".join(f"{v:7.4f}" for v in vals))
        # flatness of the plateau: the middle chunk sizes (32..512)
        mid = vals[3:8]
        out[(m_acc, n)] = max(mid) - min(mid)
    print("\nplateau flatness (max-min over chunk 32..512): "
          + ", ".join(f"{k}: {v:.4f}" for k, v in out.items()))
    print("=> chunking raises VRR toward 1 and the plateau is flat "
          "(paper: exact chunk size is not of paramount importance)")
    return {"max_plateau_spread": max(out.values())}


if __name__ == "__main__":
    run()
