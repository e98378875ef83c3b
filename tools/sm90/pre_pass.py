"""B with g quantized once a call into bf16 (the wrapper's path when
quantize_g and the format has at most 7 mantissa bits) against B reading g
as f32 and quantizing it in every block, on the same inputs at the
training step's layer shapes (T = 512): times, and the outputs held
bitwise.  Run on a machine with the card, from the repo root:

  python tools/sm90/pre_pass.py
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
from repro_torch.kernels import bwd_pair as bp  # noqa: E402
from repro_torch.kernels.fused import qmatmul_fused  # noqa: E402
from repro_torch.models.api import dense_gemm_shapes  # noqa: E402


class _NoScratch:
    """``torch`` as the wrapper sees it, but refusing the bf16 scratch, so
    that the wrapper takes its f32-g path."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(*a, **k):
        return None if k.get("dtype") is torch.bfloat16 else torch.empty(*a, **k)


def main() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = cs._train_cfg()
    shapes = dense_gemm_shapes(cfg, seq_len=cs.TRAIN_SEQ,
                               global_batch=cs.TRAIN_BATCH)
    t = shapes[0][1]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    total = {True: 0.0, False: 0.0}
    for tag, _, k, n, qc in shapes[1:]:
        x = torch.randn((t, k), generator=gen, device=dev)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        g = torch.randn((t, n), generator=gen, device=dev) / math.sqrt(n)
        ekw, bkw = cs._e_kw(qc), cs._b_kw(qc)
        _, xq, wq = qmatmul_fused(x, w, return_quantized=True, **ekw)
        outs, ms = {}, {}
        for once in (True, False, False, True):     # in turns
            bp.torch = torch if once else _NoScratch()
            outs[once] = bp.qmatmul_bwd_pair(g, xq, wq, **bkw)
            ms[once] = cs.cuda_time(
                lambda: bp.qmatmul_bwd_pair(g, xq, wq, **bkw), reps=10)
        bp.torch = torch
        same = all(torch.equal(a, b) for a, b in zip(outs[True], outs[False]))
        for once, v in ms.items():
            total[once] += v * cfg.n_layers
        print(f"{tag} K={k} N={n}: B with Q(g) once {ms[True]:.4f} ms, in "
              f"every block {ms[False]:.4f} ms; outputs bitwise equal: {same}",
              flush=True)
    print(f"a step's {len(shapes[1:]) * cfg.n_layers} layer calls: "
          f"{total[True]:.2f} ms with Q(g) once, {total[False]:.2f} ms in "
          f"every block")


if __name__ == "__main__":
    main()
