"""P and K10 under every schedule (rows a tile, cluster, pages a block a
round) whose shared memory fits a block, at qwen2-1.5b's serve shapes:
P at the 64-token slab (q_offset 320), one-shot prompts of 384, 96, 17 and
2048 tokens, K10 at a 384-token prompt (chunk 16) and at S = 512 (chunk
128).  Card time by CUDA-graph replay (``chip_smoke.lib_time``, 3 rounds of
10); prints the six fastest schedules and the slowest of each shape.  The
schedule changes no output bit, so only times count.  Run on a machine with
the card, from the repo root:

  python tools/sm90/p_sweep.py
"""

from __future__ import annotations

import itertools
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import attention as A  # noqa: E402
from repro_torch.kernels import build, sm90  # noqa: E402

H, KV, DH, PS = 12, 2, 128, 16


def main() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fp = build.function("paged_prefill", "paged_prefill", A._PREFILL_ARGS)
    fk = build.function("flash_prefill", "flash_prefill", A._DENSE_ARGS)
    scale, *qacc = A._attn_consts(DH, (6, 5))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def p_case(t, q_off):
        kv_len = q_off + t
        n = -(-kv_len // PS)
        kc, vc, kse, vse = cs._attn_arena(gen, dev, n + 1, KV, DH)
        row = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
        row[:n] = (torch.randperm(n, generator=gen, device=dev) + 1).to(
            torch.int32)
        q = torch.randn((t, H, DH), generator=gen, device=dev)
        out = torch.empty_like(q)

        def run(rows, cl, r):
            rc = fp(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                    kse.data_ptr(), vse.data_ptr(), row.data_ptr(),
                    out.data_ptr(), t, H, KV, PS, DH, q_off, t, kv_len, 0,
                    scale, 5, 2, *qacc, rows, cl, r, stream())
            assert rc == 0, rc
        return run, n, PS

    def k_case(s, chunk):
        q, k, v = (torch.randn((s, n, DH), generator=gen, device=dev)
                   for n in (H, KV, KV))
        out = torch.empty_like(q)

        def run(rows, cl, r):
            rc = fk(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                    None, out.data_ptr(), None, None, s, H, s, KV, DH, chunk,
                    0, 0, scale, *qacc, rows, cl, r, 0, 0, stream())
            assert rc == 0, rc
        return run, -(-s // chunk), chunk

    cases = [("P slab", p_case(64, 320)), ("P 384", p_case(384, 0)),
             ("P 96", p_case(96, 0)), ("P 17", p_case(17, 0)),
             ("P 2048", p_case(2048, 0)), ("K10 384 c16", k_case(384, 16)),
             ("K10 512 c128", k_case(512, 128))]
    for name, (run, n, ps) in cases:
        res = []
        for rows, cl in itertools.product((1, 2, 4, 8, 16), (1, 2, 4, 8)):
            if cl > n:
                continue
            for r in sorted({1, 2, 3, 4, 6, 8, -(-n // cl)}):
                if r > 8 or r > -(-n // cl):
                    continue
                smem = sm90.attn_prefill_smem(6, rows, ps, DH, cl, r)
                if smem > sm90.SMEM_LIMIT:
                    continue
                ms = cs.lib_time(lambda: run(rows, cl, r), reps=10,
                                 rounds=3)[0]
                res.append((ms, rows, cl, r, smem))
        res.sort()
        print(f"{name} best: " + ", ".join(
            f"{ms:.4f} (rows {rows} cl {cl} r {r} smem {smem})"
            for ms, rows, cl, r, smem in res[:6]), flush=True)
        print(f"{name} worst: {res[-1][0]:.4f} {res[-1][1:]}", flush=True)


if __name__ == "__main__":
    main()
