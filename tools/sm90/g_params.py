"""G's kernels (csrc/qgemm.cu: the decode kernel and the Hopper tile of
its large route) with their arguments as a __grid_constant__ kernel
parameter (as built) and passed by value: registers (ptxas) and times at
the serve cell's decode step (197 GEMMs at M = 8, the decode route) and at
the training step's lm_head forward (T = 512, the tile), outputs compared.
Each variant is built from a copy of the sources under build/g_params/.
Run on a machine with the card, from the repo root:

  python tools/sm90/g_params.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, sm90  # noqa: E402
from repro_torch.kernels.common import qfmt_args  # noqa: E402

BY_VALUE = [("qgemm_decode_kernel(const __grid_constant__ Decode p)",
             "qgemm_decode_kernel(Decode p)"),
            ("qgemm_tile_kernel(const __grid_constant__ sm90::Gemm p)",
             "qgemm_tile_kernel(sm90::Gemm p)")]
VARIANTS = {"__grid_constant__ (as built)": [], "by value": BY_VALUE}
LAYER_KN = [(1536, 1536), (1536, 256), (1536, 256), (1536, 1536),
            (1536, 8960), (1536, 8960), (8960, 1536)]
DEPTH, VOCAB, D = 28, 151936, 1536
_LL, _I, _P, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
ARGTYPES = [_P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _I, _I, _I, _I, _I, _I,
            _F, _F, _I, _I, _I, _I, _F, _F, _I, ctypes.c_uint, _I, _I, _I,
            _P, _P]


def build_variants(out: Path) -> dict:
    """{variant: (library path, ptxas register lines)}"""
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
        regs = sorted(r for fn, (r, _) in cs._ptxas_entries(log).items()
                      if "qgemm_decode_kernel" in fn
                      or "qgemm_tile_kernel" in fn)
        libs[name] = (so, regs)
    return libs


def main() -> None:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = build_variants(build.BUILD_DIR / "g_params")
    gen = torch.Generator(device=dev).manual_seed(0)
    ws = {kn: torch.randn(kn, generator=gen, device=dev).to(torch.bfloat16)
          for kn in set(LAYER_KN)}
    emb = torch.randn((VOCAB, D), generator=gen, device=dev).to(torch.bfloat16)
    x8 = {k: torch.randn((8, k), generator=gen, device=dev) for k in (D, 8960)}
    x512 = torch.randn((512, D), generator=gen, device=dev)

    def call(f, a, b, fmt, acc):
        m, k = a.shape
        n = b.shape[1]
        out = torch.empty((m, n), device=dev)
        s = sm90.g_schedule(m, n, k, 64, 0, 1)
        if isinstance(s, sm90.DecodeSchedule):
            ws = torch.empty((max(s.ws_floats, 1),), device=dev)
            route = (0, s.slots, s.slices, ws.data_ptr())
        else:
            route = (1, s.groups, 1, None)
        rc = f(a.data_ptr(), 0, a.stride(0), a.stride(1), b.data_ptr(), 1,
               b.stride(0), b.stride(1), out.data_ptr(), m, n, k, 64,
               *qfmt_args(fmt or (8, 23)), int(fmt is not None),
               int(fmt is not None), *qfmt_args(acc), 0, 0, *route,
               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"qgemm launch failed: CUDA error {rc}")
        return out

    print(f"card: {smi}", flush=True)
    first = None
    for name, (so, regs) in libs.items():
        f = ctypes.CDLL(str(so)).qgemm
        f.restype, f.argtypes = ctypes.c_int, ARGTYPES

        def step():     # the predicted plan's layer GEMMs, then the head
            outs = [call(f, x8[k], ws[(k, n)], (5, 2), (6, 5))
                    for _ in range(DEPTH) for k, n in LAYER_KN]
            return outs + [call(f, x8[D], emb.T, None, (6, 9))]

        def head():
            return call(f, x512, emb.T, None, (6, 9))

        outs = step()[-len(LAYER_KN) - 1:] + [head()]
        torch.cuda.synchronize()
        same = first is None or all(torch.equal(a, b)
                                    for a, b in zip(outs, first))
        first = first or outs
        print(f"G {name}: decode step {cs.cuda_time(step, reps=3):.3f} ms, "
              f"lm_head forward T=512 {cs.cuda_time(head, reps=3):.3f} ms, "
              f"outputs {'bitwise equal' if same else 'DIFFERENT'}; "
              f"registers a thread {regs}", flush=True)


if __name__ == "__main__":
    main()
