"""Why the bitwise kernels stay on the CUDA cores: on a layer's dx operands
at T = 512 (Q(g) and Q(w) in (1,5,2), exact in bf16), the share of 64-term
chunk partials where a bf16 tensor-core product (mma.sync m16n8k16, f32
accumulate, the chunk's 4 k-groups chained through C) differs from the
sequential f32 FMA chain the kernels' contract fixes (mma_vs_fma.cu,
built here with nvcc into build/).  Run on a machine with the card, from
the repo root:

  python tools/sm90/mma_vs_fma.py
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.build import _nvcc  # noqa: E402
from repro_torch.kernels.common import quantize_block  # noqa: E402


def main() -> None:
    so = ROOT / "build" / "mma_vs_fma.so"
    so.parent.mkdir(exist_ok=True)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(so), str(Path(__file__).with_suffix(".cu"))],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, t, n, k in (("attn_q dx", 512, 1536, 1536),
                          ("mlp_gate dx", 512, 8960, 1536)):
        g = quantize_block(torch.randn((t, n), generator=gen, device=dev)
                           / math.sqrt(n), 5, 2)
        w = quantize_block((torch.randn((k, n), generator=gen, device=dev)
                            / math.sqrt(k)).to(torch.bfloat16).float(), 5, 2)
        a = g.to(torch.bfloat16).contiguous()           # [T, N], exact
        b = w.T.to(torch.bfloat16).contiguous()         # [N, K], exact
        assert torch.equal(a.float(), g) and torch.equal(b.float(), w.T)
        om = torch.empty((n // 64, t, k), device=dev)
        of = torch.empty_like(om)
        assert lib.run(a.data_ptr(), b.data_ptr(), t, k, n, om.data_ptr(),
                       of.data_ptr()) == 0
        torch.cuda.synchronize()
        differ = float((om != of).float().mean())
        rel = float(((om - of).abs() / of.abs().clamp_min(1e-30)).max())
        prod = (a.float()[:, :64, None] * b.float()[None, :64, :64]).abs()
        lo = prod.where(prod > 0, torch.full_like(prod, math.inf)).amin(1)
        span = torch.log2(prod.amax(1) / lo)
        print(f"{name}: {om.numel()} chunk partials, {differ:.6f} of them "
              f"differ between the bf16 mma.sync and the FMA chain (max "
              f"relative gap {rel:.3g}); a chunk's non-zero products span "
              f"{float(span.median()):.1f} binades (median), "
              f"{float(span.max()):.1f} at most", flush=True)


if __name__ == "__main__":
    main()
