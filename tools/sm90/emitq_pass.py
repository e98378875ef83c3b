"""E's quantize-and-pack pass (csrc/qgemm_emitq.cu) with its 8-element
vector path (as built) and with every operand taken element by element:
one training step's 196 E calls (T = 512, the predicted plan's layer
shapes) timed as a sequence, outputs compared.  Each variant is built from
a copy of the sources under build/emitq_pass/.  Run on a machine with the
card, from the repo root:

  python tools/sm90/emitq_pass.py
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
from repro_torch.kernels.fused import qmatmul_fused  # noqa: E402
from repro_torch.models.api import dense_gemm_shapes  # noqa: E402

SCALAR = ("  const int vec = s_c == 1", "  const int vec = 0 && s_c == 1")
VARIANTS = {"8-element vector path (as built)": [], "element by element": [SCALAR]}


def main() -> None:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = build.BUILD_DIR / "emitq_pass"
    procs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        d = out / str(i)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, d)
        src = (d / "qgemm_emitq.cu").read_text()
        for old, new in patches:
            assert old in src, (name, old)
            src = src.replace(old, new)
        (d / "qgemm_emitq.cu").write_text(src)
        procs[name] = (d / "qgemm_emitq.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-w", "-o",
             str(d / "qgemm_emitq.so"), str(d / "qgemm_emitq.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))
    for name, (_, p) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"{name} did not build")

    cfg = cs._train_cfg()
    shapes = dense_gemm_shapes(cfg, seq_len=cs.TRAIN_SEQ,
                               global_batch=cs.TRAIN_BATCH)[1:]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    t = shapes[0][1]
    tensors = {}
    for _, _, k, n, qc in shapes:
        if (k, n) not in tensors:
            tensors[(k, n)] = (
                torch.randn((t, k), generator=gen, device=dev),
                (torch.randn((k, n), generator=gen, device=dev)
                 / math.sqrt(k)).to(torch.bfloat16), cs._e_kw(qc))
    calls = [tensors[(k, n)] for _ in range(cfg.n_layers)
             for _, _, k, n, _ in shapes]

    def step():
        return [qmatmul_fused(x, w, return_quantized=True, **kw)
                for x, w, kw in calls]

    print(f"card: {smi}; {len(calls)} E calls at T={t}", flush=True)
    first = None
    for name, (so, _) in procs.items():
        build._loaded["qgemm_emitq"] = ctypes.CDLL(str(so))
        outs = step()[:len(tensors)]
        torch.cuda.synchronize()
        same = first is None or all(
            all(torch.equal(a, b) for a, b in zip(o, f))
            for o, f in zip(outs, first))
        first = first or outs
        print(f"E {name}: one step's calls {cs.cuda_time(step, reps=3):.3f} "
              f"ms, outputs {'bitwise equal' if same else 'DIFFERENT'}",
              flush=True)


if __name__ == "__main__":
    main()
