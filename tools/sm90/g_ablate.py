"""G's decode kernel (csrc/qgemm.cu) with one phase taken out at a time,
each variant built from a patched copy of the sources under
build/g_ablate/: no weight quantization, no staging of A, no global loads
of the weights, no fold kernel; and with the next step's loads issued
before a step's FMAs, or with room for 3 or 2 resident blocks an SM (more
registers a thread) in place of 4.  The phase-less variants' outputs are wrong; only
their times count.  Card time (a CUDA graph replay) per qwen2-1.5b decode
shape at M = 8.  Run on a machine with the card, from the repo root:

  python tools/sm90/g_ablate.py
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
from repro_torch.kernels import build, fused, sm90  # noqa: E402
from repro_torch.kernels.common import qfmt_args  # noqa: E402

# chunk_partial's loop, and the same loop with the next step's weights
# loaded before a step's FMAs
_STEP_LOOP = """  unsigned cur[8];
#pragma unroll 1
  for (int k0 = kb; k0 < ke; k0 += KS) {
    load_step<TB, KFAST>(p, n, k0, ke, cur);
    step_fma<TB, KFAST, QB>(p, cur, As + (k0 - kb) * ROWS, min(KS, ke - k0), part);
  }
"""
_PREFETCH_LOOP = """  unsigned cur[8], nxt[8];
  load_step<TB, KFAST>(p, n, kb, ke, cur);
#pragma unroll 1
  for (int k0 = kb; k0 < ke; k0 += KS) {
    if (k0 + KS < ke) load_step<TB, KFAST>(p, n, k0 + KS, ke, nxt);
    step_fma<TB, KFAST, QB>(p, cur, As + (k0 - kb) * ROWS, min(KS, ke - k0), part);
#pragma unroll
    for (int i = 0; i < 8; ++i) cur[i] = nxt[i];
  }
"""

VARIANTS = {
    "as built": [],
    "no weight quantize": [("if (qb)\n", "if (false)\n")],
    "no A staging": [("stage_a<4>(p, A, m0, kr0, len, As);", ";"),
                     ("stage_a<1>(p, A, m0, kr0, len, As);", ";")],
    "no weight loads": [
        ("__ldg(reinterpret_cast<const uint4*>(B + off) + q)",
         "make_uint4((unsigned)off, q, 0u, 0u)"),
        ("__ldg(reinterpret_cast<const unsigned*>(B + off))", "(unsigned)off")],
    "no fold kernel": [("if (rc != 0 || !split) return rc;", "return rc;")],
    "next step's loads in flight": [(_STEP_LOOP, _PREFETCH_LOOP)],
    "3 blocks an SM": [("__launch_bounds__(MAX_SLOTS * LANES, 4)",
                        "__launch_bounds__(MAX_SLOTS * LANES, 3)")],
    "2 blocks an SM": [("__launch_bounds__(MAX_SLOTS * LANES, 4)",
                        "__launch_bounds__(MAX_SLOTS * LANES, 2)")],
}
SHAPES = [("attn_q", 1536, 1536), ("attn_k", 1536, 256),
          ("mlp_gate", 1536, 8960), ("mlp_down", 8960, 1536),
          ("lm_head", 1536, 151936)]
M = 8


def build_variants(out: Path) -> dict:
    procs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        d = out / str(i)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, d)
        src = (d / "qgemm.cu").read_text()
        for old, new in patches:
            assert old in src, (name, old)
            src = src.replace(old, new)
        (d / "qgemm.cu").write_text(src)
        procs[name] = (d / "qgemm.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "qgemm.so"),
             str(d / "qgemm.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name} did not build:\n{log}")
        libs[name] = so
    return libs


def main() -> None:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    libs = build_variants(build.BUILD_DIR / "g_ablate")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for name, k, n in SHAPES:
        head = name == "lm_head"
        w = (torch.randn((n, k) if head else (k, n), generator=gen,
                         device=dev) / math.sqrt(k)).to(torch.bfloat16)
        cases.append((name, torch.randn((M, k), generator=gen, device=dev),
                      w.T if head else w, head))
    for vname, so in libs.items():
        f = ctypes.CDLL(str(so)).qgemm
        f.restype, f.argtypes = ctypes.c_int, fused._ARGTYPES
        parts = []
        for name, a, w, head in cases:
            k, n = w.shape
            s = sm90.decode_schedule(M, n, k, 64, 1)
            out = torch.empty((M, n), device=dev)
            ws = torch.empty((max(s.ws_floats, 1),), device=dev)
            fmt = None if head else (5, 2)

            def run():
                rc = f(a.data_ptr(), 0, a.stride(0), a.stride(1), w.data_ptr(),
                       1, w.stride(0), w.stride(1), out.data_ptr(), M, n, k,
                       64, *(fmt or (8, 23)), *qfmt_args(fmt or (8, 23)),
                       int(fmt is not None), int(fmt is not None),
                       *qfmt_args((6, 9 if head else 5)),
                       *qfmt_args((8, 23)), 0, 8, 23, 0, 0, 0, 0, 0, 0,
                       s.slots, s.slices, ws.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc

            parts.append(f"{name} {cs.lib_time(run, reps=20)[0]:.4f}")
        print(f"G decode, {vname}: {', '.join(parts)} ms", flush=True)


if __name__ == "__main__":
    main()
