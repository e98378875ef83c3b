"""G's decode route per qwen2-1.5b decode shape at M = 8, timed two ways:
eagerly (CUDA events around a run of wrapper calls, the host's launch work
included, as the serving engine calls G) and as a CUDA graph replay (the
card's time alone); then one decode step's 197 GEMMs both ways.  Run on a
machine with the card, from the repo root:

  python tools/sm90/g_decode.py
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import sm90  # noqa: E402
from repro_torch.kernels.fused import qmatmul_fused, qmatmul_fused_with  # noqa: E402

SHAPES = [("attn_q", 1536, 1536), ("attn_k", 1536, 256),
          ("mlp_gate", 1536, 8960), ("mlp_down", 8960, 1536),
          ("lm_head", 1536, 151936)]
LAYERS = [(1536, 1536), (1536, 256), (1536, 256), (1536, 1536),
          (1536, 8960), (1536, 8960), (8960, 1536)]
DEPTH, M = 28, 8


def main() -> None:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, k, n in SHAPES:
        head = name == "lm_head"
        w = (torch.randn((n, k) if head else (k, n), generator=gen,
                         device=dev) / math.sqrt(k)).to(torch.bfloat16)
        w = w.T if head else w
        a = torch.randn((M, k), generator=gen, device=dev)
        kw = dict(repr_fmt=None if head else (5, 2), e_acc=6,
                  m_acc=9 if head else 5, block_k=64)
        sched = sm90.decode_schedule(M, n, k, 64, 1)
        run = lambda: qmatmul_fused_with(a, w, sched, **kw)  # noqa: E731
        eager = cs.cuda_time(run, reps=50)
        graph, _ = cs.lib_time(run, reps=20)
        print(f"G decode {name} K={k} N={n} M={M} {sched}: eager "
              f"{eager:.4f} ms, graph {graph:.4f} ms, bytes bound "
              f"{k * n * 2 / cs.HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    ws = [(torch.randn(kn, generator=gen, device=dev) / 40).to(torch.bfloat16)
          for _ in range(DEPTH) for kn in LAYERS]
    emb = (torch.randn((151936, 1536), generator=gen, device=dev) / 40).to(
        torch.bfloat16)
    xs = {k: torch.randn((M, k), generator=gen, device=dev) for k in (1536, 8960)}

    def step():
        for w in ws:
            qmatmul_fused(xs[w.shape[0]], w, repr_fmt=(5, 2), e_acc=6,
                          m_acc=5, block_k=64)
        qmatmul_fused(xs[1536], emb.T, e_acc=6, m_acc=9, block_k=64)

    eager = cs.cuda_time(step, reps=5)
    graph, spread = cs.lib_time(step, reps=3)
    print(f"G one decode step (197 GEMMs, M={M}): eager {eager:.3f} ms, "
          f"graph {graph:.3f} ms [{spread[0]:.3f}-{spread[1]:.3f}]", flush=True)


if __name__ == "__main__":
    main()
