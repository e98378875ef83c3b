"""The host's time a call of D (``paged_attn_decode``) and of K12 (its
``collect_stats=True`` call) at qwen2-1.5b's serve arena (B 8, H 12, KV 2,
dh 128, page 16, a 64-page table, rows of up to 384 tokens): 100 calls
enqueued with no synchronisation between them (host clock), and the same
100 calls until the card is done; the median of 5.  Where the two agree,
the calls are bound by the host.  Takes the checkout at ROOT, so that two
trees compare in one command on a machine with the card:

  for r in build/parent . . build/parent; do python tools/sm90/d_host.py $r; done
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

root = str(Path(sys.argv[1]).resolve())
sys.path[:0] = [root + "/src", root]

import torch  # noqa: E402

from repro_torch.kernels.attention import paged_attn_decode  # noqa: E402
from repro_torch.kernels.common import quantize_block  # noqa: E402
from repro_torch.quant.qtensor import pack_block  # noqa: E402

LENS = [384, 0, 17, 64, 100, 129, 256, 311]
H, KV, DH, PAGE, WIDTH = 12, 2, 128, 16, 64


def main() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_pages = 1 + sum(-(-s // PAGE) for s in LENS)

    def codes():
        x = torch.randn((n_pages, KV, PAGE, DH), generator=gen, device=dev)
        return pack_block(quantize_block(x, 5, 2), 5, 2)

    se = lambda: torch.randint(-2, 3, (n_pages,), generator=gen, device=dev,
                               dtype=torch.int32)
    pt = torch.zeros((len(LENS), WIDTH), dtype=torch.int32, device=dev)
    nxt = 1
    for b, s in enumerate(LENS):
        n = -(-s // PAGE)
        pt[b, :n] = torch.arange(nxt, nxt + n, device=dev)
        nxt += n
    args = (codes(), codes(), se(), se(), pt,
            torch.tensor(LENS, dtype=torch.int32, device=dev))
    q = torch.randn((len(LENS), H, DH), generator=gen, device=dev)
    for what, stats in (("D", False), ("K12", True)):
        call = lambda: paged_attn_decode(q, *args, kv_fmt=(5, 2), acc=(6, 5),
                                         collect_stats=stats)
        for _ in range(5):
            call()
        res = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                call()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            res.append(((t1 - t0) * 1e4, (time.perf_counter() - t0) * 1e4))
        enq, full = sorted(res)[2]
        print(f"{what} host {root}: enqueue {enq:.1f} us a call, until the "
              f"card is done {full:.1f} us a call", flush=True)


if __name__ == "__main__":
    main()
