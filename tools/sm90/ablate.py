"""Where the time of the Hopper tile (csrc/qgemm_sm90.cuh) goes: B and K8
timed at the training step's layer shapes (T = 512) with one phase of the
tile taken out at a time, each variant built from a patched copy of the
sources under build/ablate/.  The variants' outputs are wrong; only their
times mean something.  Also the FMA loop unrolled 16-fold, the first
design, and common.cuh's quantize_rne and unpack_code in place of the
tile's branch-free versions (the same bits).  Run on a machine with the
card, from the repo root:

  python tools/sm90/ablate.py
"""

from __future__ import annotations

import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair  # noqa: E402
from repro_torch.kernels.fused import qmatmul_fused  # noqa: E402
from repro_torch.models.api import dense_gemm_shapes  # noqa: E402

HEADER = "qgemm_sm90.cuh"
FOLD = ("      fold<STATS>(acc,",
        "      if (s == steps - 1) fold<STATS>(acc,")
DECODE = ("      decode<TA>(p.a, slot, As, gt, p.qr, p.dec);\n"
          "      decode<TB>(p.b, slot + B_OFF, Bs, gt, p.qr, p.dec);\n", "")
ISSUE = ("    if (si < steps) {", "    if (si < steps && s < 0) {")
UNROLL = ("#pragma unroll 1\n  for (int k = 0; k < KT; ++k) {",
          "#pragma unroll\n  for (int k = 0; k < KT; ++k) {")
COMMON = [("  const unsigned mag = b & d.magmask;\n",
           "  return unpack_code((int8_t)(b & 0xffu), d.sbit - (23 - d.sh), "
           "23 - d.sh);\n  const unsigned mag = b & d.magmask;\n"),
          ("  const unsigned xb = __float_as_uint(x), xi = xb & 0x7fffffffu;\n",
           "  return quantize_rne(x, QFmt{q.identity, q.shift, q.maxv, "
           "q.minn});\n  const unsigned xb = __float_as_uint(x), "
           "xi = xb & 0x7fffffffu;\n")]
VARIANTS = {
    "as is": [],
    "FMA loop unrolled": [UNROLL],
    "common.cuh's Q": COMMON,
    "no fold": [FOLD],
    "no decode": [DECODE],
    "no copies": [ISSUE],
    "FMAs only": [FOLD, DECODE, ISSUE],
}


def build_variants(out: Path) -> None:
    procs = []
    for i, (name, patches) in enumerate(VARIANTS.items()):
        d = out / str(i)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, d)
        src = (d / HEADER).read_text()
        for old, new in patches:
            assert old in src, (name, old)
            src = src.replace(old, new)
        (d / HEADER).write_text(src)
        flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        for lib in ("bwd_pair", "qgemm_stats"):
            procs.append(subprocess.Popen([build._nvcc(), *flags, "-w", "-o",
                                           str(d / f"{lib}.so"),
                                           str(d / f"{lib}.cu")]))
    for p in procs:
        if p.wait() != 0:
            raise RuntimeError("a variant did not build")


def main() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = cs._train_cfg()
    shapes = dense_gemm_shapes(cfg, seq_len=cs.TRAIN_SEQ,
                               global_batch=cs.TRAIN_BATCH)
    t = shapes[0][1]
    cases = {}
    for tag, _, k, n, qc in shapes[1:]:
        if (k, n) in cases or (k, n) == (1536, 256):
            continue
        x = torch.randn((t, k), generator=gen, device=dev)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        g = torch.randn((t, n), generator=gen, device=dev) / math.sqrt(n)
        ekw, bkw = cs._e_kw(qc), cs._b_kw(qc)
        _, xq, wq = qmatmul_fused(x, w, return_quantized=True, **ekw)
        cases[(k, n)] = (tag, g, xq, wq, cs._k8_codes_kw(ekw), bkw,
                         4 * t * k * n / cs.F32_FLOPS * 1e3)
    out = ROOT / "build" / "ablate"
    build_variants(out)
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip())
    for i, name in enumerate(VARIANTS):
        for lib in ("bwd_pair", "qgemm_stats"):
            build._loaded[lib] = ctypes.CDLL(str(out / str(i) / f"{lib}.so"))
        cols = []
        for tag, g, xq, wq, k8kw, bkw, fb in cases.values():
            b = cs.cuda_time(lambda: qmatmul_bwd_pair(g, xq, wq, **bkw), reps=5)
            k8 = cs.cuda_time(lambda: qmatmul_fused(xq, wq, collect_stats=True,
                                                    **k8kw), reps=5)
            cols.append(f"{tag} B {b:.4f} ms ({fb / b:.3f}) K8 {k8:.4f} ms "
                        f"({fb / 2 / k8:.3f})")
        print(f"{name:18s} " + " | ".join(cols), flush=True)
    print("(in brackets: the share of the f32-FMA bound)")


if __name__ == "__main__":
    main()
