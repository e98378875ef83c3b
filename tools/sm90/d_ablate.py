"""D's kernel (csrc/paged_decode.cu) with one phase taken out at a time,
each variant built from a patched copy of the sources under
build/d_ablate/: no page loads, no K decode, no scores, no p.v, no
distributed-shared-memory gathers, no fold, the two cluster barriers of a
round as block barriers, and no pages at all (the launch, q, the output
and the last cluster barrier).  K12 (``paged_decode_stats``) is timed in
every variant too, and in two of its own: without its second pass (the
kernel alone; minus D, the stats work inside the kernel) and its second
pass alone (``stats_finish`` over the launch's partial rows, the kernel
not launched).  Every variant keeps each barrier on every thread, so none
can hang; the phase-less variants' outputs are wrong, and only their
times count.  Card time (a CUDA graph replay) at qwen2-1.5b's serve arena
(B 8, a 64-page table, rows of up to 384 tokens: 128 partial rows) and at
a 4096-token row (B 1, 256 pages: 16 partial rows).  Run on a machine
with the card, from the repo root:

  python tools/sm90/d_ablate.py
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
from repro_torch.kernels import attention, build, sm90  # noqa: E402
from repro_torch.kernels.common import N_STATS  # noqa: E402

VARIANTS = {
    "as built": [],
    "no page loads": [
        ("stage_pages(kc, kp, ids, mine, KV, hk, page_elems, L.code_bytes, vec);", ";"),
        ("stage_pages(vc, vp, ids, mine, KV, hk, page_elems, L.code_bytes, vec);", ";")],
    "no K decode": [("for (int r = warp; r < mine * PS;", "for (int r = warp; r < 0;")],
    "no scores": [("        score_pass<2>(c0, n_sc, kf, qs, sc, G, PS, dp, tok0, seq_len, scale);", ""),
                  ("        score_pass<1>(c0, n_sc, kf, qs, sc, G, PS, dp, tok0, seq_len, scale);", "")],
    "no p.v": [("for (int i = tid; i < mine * DH;", "for (int i = tid; i < 0;")],
    "no gathers": [("for (int i = tid; i < npr * per_o;", "for (int i = tid; i < 0;"),
                   ("for (int i = tid; i < npr * G; i += DECODE_THREADS) {\n      const int k = i / G, owner = k / per;\n      cm_all",
                    "for (int i = tid; i < 0; i += DECODE_THREADS) {\n      const int k = i / G, owner = k / per;\n      cm_all"),
                   ("for (int i = tid; i < npr * G; i += DECODE_THREADS) {\n      const int k = i / G, owner = k / per;\n      lsum_all",
                    "for (int i = tid; i < 0; i += DECODE_THREADS) {\n      const int k = i / G, owner = k / per;\n      lsum_all")],
    "no fold": [("      for (int k = 0; k < npr; ++k) {\n        const float a", "      for (int k = 0; k < 0; ++k) {\n        const float a")],
    "block barriers in a round": [
        ("cluster.sync();  // every rank's maxima are published", "__syncthreads();"),
        ("cluster.sync();  // every rank's partials are published", "__syncthreads();")],
    "no pages": [("const int n_pages = (seq_len + PS - 1) / PS;", "const int n_pages = 0 * seq_len;")],
    "K12 without its second pass": [
        ("return stats_finish(part, B * KV * CL, B * KV * CL, 1, stats, s);",
         "return 0;")],
    "K12's second pass alone": [
        ("cudaError_t e = cudaLaunchKernelEx(", "cudaError_t e = STATS ? cudaSuccess : cudaLaunchKernelEx(")],
}
SHAPES = [("serve arena", [384, 0, 17, 64, 100, 129, 256, 311], 64),
          ("4096-token row", [4096], 256)]
H, KV, DH = 12, 2, 128


def build_variants(out: Path) -> dict:
    procs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        d = out / str(i)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, d)
        src = (d / "paged_decode.cu").read_text()
        for old, new in patches:
            assert old in src, (name, old)
            src = src.replace(old, new)
        (d / "paged_decode.cu").write_text(src)
        procs[name] = (d / "paged_decode.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "paged_decode.so"),
             str(d / "paged_decode.cu")], stdout=subprocess.PIPE,
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
    libs = build_variants(build.BUILD_DIR / "d_ablate")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for name, lens, width in SHAPES:
        n_pages, pt = cs._decode_table(gen, dev, lens, width)
        kc, vc, kse, vse = cs._attn_arena(gen, dev, n_pages, KV, DH)
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((len(lens), H, DH), generator=gen, device=dev)
        cases.append((name, (q, kc, vc, kse, vse, pt, sl)))
    for vname, so in libs.items():
        lib = ctypes.CDLL(str(so))
        d, k12 = lib.paged_decode, lib.paged_decode_stats
        d.restype, d.argtypes = ctypes.c_int, attention._DECODE_ARGS
        k12.restype = ctypes.c_int
        k12.argtypes = attention._DECODE_ARGS[:-1] + [ctypes.c_void_p] * 3
        parts = {"D": [], "K12": []}
        for name, (q, kc, vc, kse, vse, pt, sl) in cases:
            b, width = q.shape[0], pt.shape[1]
            s = sm90.attn_decode_schedule(b, KV, width, H // KV, cs.PAGE, DH)
            scale, *qacc = attention._attn_consts(DH, (6, 5))
            out = torch.empty_like(q)
            part = torch.zeros((s.blocks, N_STATS), dtype=torch.float64,
                               device=dev)
            row = torch.zeros((N_STATS,), dtype=torch.float32, device=dev)
            args = (q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                    kse.data_ptr(), vse.data_ptr(), pt.data_ptr(), width,
                    sl.data_ptr(), out.data_ptr(), b, KV, H // KV, cs.PAGE,
                    DH, s.cluster, s.rank_pages, scale, 5, 2, *qacc)

            def run_d():
                rc = d(*args, torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc

            def run_k12():
                rc = k12(*args, part.data_ptr(), row.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc

            for k, run in (("D", run_d), ("K12", run_k12)):
                parts[k].append(f"{name} {cs.lib_time(run, reps=20)[0]:.4f}")
        for k, p in parts.items():
            print(f"{k}, {vname}: {', '.join(p)} ms", flush=True)


if __name__ == "__main__":
    main()
