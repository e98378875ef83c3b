"""P's kernel (csrc/paged_prefill.cu on csrc/attn_prefill_sm90.cuh, the
prefill walk it shares with K10) with one phase taken out at a time, each
variant built from a patched copy of the sources under build/p_ablate/:
no K staging, no scores, no page maxima and running max, no
probabilities and l sums (B1), no copies of the other ranks'
probabilities (distributed shared memory), no V staging, no p.v and o
fold, the first two cluster barriers of a round as block barriers, p.v
with one chain a thread where the kernel takes two, and no pages at all
(the launch, q, the carries and the output).  Every variant keeps each
barrier on every thread, so none can hang; the phase-less variants'
outputs are wrong, and only their times count.  Card time (a CUDA graph replay) at
qwen2-1.5b's 64-token slab (q_offset 320), the 384-token one-shot prompt
and a 2048-token one-shot prompt.  Run on a machine with the card, from
the repo root:

  python tools/sm90/p_ablate.py
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

HEADER = "attn_prefill_sm90.cuh"
VARIANTS = {
    "as built": [],
    "no K staging": [("stage<PAGED>(a, kf, L.qst, L.dp, a.kp, a.k, ids, ksc, hk, base, c_own + s0, n, 0);", ";")],
    "no scores": [("score_piece(a, L, qs, kf, sc, r0, c_own + s0, n, s0);", ";")],
    "no maxima": [("for (int i = tid; i < mine * HR; i += PREFILL_THREADS) {\n"
                   "      const int j = i / HR, hr = i - j * HR;\n"
                   "      const float* s = sc + hr * L.sst + j * PS;\n"
                   "      float mx",
                   "for (int i = tid; i < 0; i += PREFILL_THREADS) {\n"
                   "      const int j = i / HR, hr = i - j * HR;\n"
                   "      const float* s = sc + hr * L.sst + j * PS;\n"
                   "      float mx"),
                  ("for (int i = tid; i < npr * HR; i += PREFILL_THREADS) {\n"
                   "      const int k = i / HR, owner = k / per;\n"
                   "      cm_all",
                   "for (int i = tid; i < 0; i += PREFILL_THREADS) {\n"
                   "      const int k = i / HR, owner = k / per;\n"
                   "      cm_all"),
                  ("for (int k = 0; k < npr; ++k) {  // al_all holds m",
                   "for (int k = 0; k < 0; ++k) {  // al_all holds m"),
                  ("for (int i = tid; i < npr * HR; i += PREFILL_THREADS)\n      al_all[i]",
                   "for (int i = tid; i < 0; i += PREFILL_THREADS)\n      al_all[i]")],
    "no B1": [("for (int i = tid; i < HR * n_own; i += PREFILL_THREADS) {",
               "for (int i = tid; i < 0; i += PREFILL_THREADS) {"),
              ("for (int i = tid; i < mine * HR; i += PREFILL_THREADS) {\n"
               "      const int j = i / HR, hr = i - j * HR;\n"
               "      const float* s = sc + hr * L.sst + j * PS;\n"
               "      float acc",
               "for (int i = tid; i < 0; i += PREFILL_THREADS) {\n"
               "      const int j = i / HR, hr = i - j * HR;\n"
               "      const float* s = sc + hr * L.sst + j * PS;\n"
               "      float acc")],
    "no copies": [("for (int i = tid; i < HR * L.sst / 4;", "for (int i = tid; i < 0;")],
    "no V staging": [("stage<PAGED>(a, vf, dsl, dsl, a.vp, a.v, ids, vsc, hk, base, c_on + s0, n, d0);", ";")],
    "no p.v": [("for (int gi = threadIdx.x; gi < HH * nd4;",
                "for (int gi = threadIdx.x; gi < 0;")],
    # the round's last cluster barrier stays: without it a block could
    # leave while another reads its shared memory
    "block barriers": [
        ("cluster.sync();  // every rank's maxima are published", "__syncthreads();"),
        ("cluster.sync();  // every rank's probabilities and l sums are published",
         "__syncthreads();")],
    # not a phase taken out: p.v with one chain a thread at every shape
    "p.v one chain a thread": [("#define PREFILL_PV_TWO_ROWS 256",
                                "#define PREFILL_PV_TWO_ROWS 1000000000")],
    "no pages": [("const int p_end = min(cdiv(a.ncols, PS), n_causal);",
                  "const int p_end = 0 * n_causal;")],
}
# (what, T, q_offset): P over the serve arena's pages
SHAPES = [("slab", 64, 320), ("prompt 384", 384, 0), ("prompt 2048", 2048, 0)]
H, KV, DH = 12, 2, 128


def build_variants(out: Path) -> dict:
    procs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        d = out / str(i)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, d)
        src = (d / HEADER).read_text()
        for old, new in patches:
            assert old in src, (name, old)
            src = src.replace(old, new)
        (d / HEADER).write_text(src)
        procs[name] = (d / "paged_prefill.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "paged_prefill.so"),
             str(d / "paged_prefill.cu")], stdout=subprocess.PIPE,
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
    libs = build_variants(build.BUILD_DIR / "p_ablate")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for name, t, q_off in SHAPES:
        kv_len = q_off + t
        n = -(-kv_len // cs.PAGE)
        kc, vc, kse, vse = cs._attn_arena(gen, dev, n + 1, KV, DH)
        row = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
        row[:n] = (torch.randperm(n, generator=gen, device=dev) + 1).to(
            torch.int32)
        q = torch.randn((t, H, DH), generator=gen, device=dev)
        s = sm90.attn_prefill_schedule(t, KV, H // KV, cs.PAGE, DH, n)
        cases.append((name, s, (q, kc, vc, kse, vse, row), (t, q_off, kv_len)))
    scale, *qacc = attention._attn_consts(DH, (6, 5))
    for vname, so in libs.items():
        fn = ctypes.CDLL(str(so)).paged_prefill
        fn.restype, fn.argtypes = ctypes.c_int, attention._PREFILL_ARGS
        times = []
        for name, s, (q, kc, vc, kse, vse, row), (t, q_off, kv_len) in cases:
            out = torch.empty_like(q)
            args = (q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                    kse.data_ptr(), vse.data_ptr(), row.data_ptr(),
                    out.data_ptr(), t, H, KV, cs.PAGE, DH, q_off, t, kv_len, 0,
                    scale, 5, 2, *qacc, s.rows, s.cluster, s.rank_pages)

            def run():
                rc = fn(*args, torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc

            times.append(f"{name} {cs.lib_time(run, reps=20)[0]:.4f}")
        print(f"P, {vname}: {', '.join(times)} ms", flush=True)


if __name__ == "__main__":
    main()
