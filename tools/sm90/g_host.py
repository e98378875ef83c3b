"""The host's time a call of G (``qmatmul_fused``) at the decode shapes of
qwen2-1.5b (M = 8): 100 calls enqueued with no synchronisation between
them (host clock), and the same 100 calls until the card is done; the
median of 5.  Where the two agree, the calls are bound by the host.  Takes
the checkout at ROOT, so that two trees compare in one command on a
machine with the card:

  for r in build/parent . . build/parent; do python tools/sm90/g_host.py $r; done
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path

root = str(Path(sys.argv[1]).resolve())
sys.path[:0] = [root + "/src", root]

import torch  # noqa: E402

from repro_torch.kernels.fused import qmatmul_fused  # noqa: E402

SHAPES = [("attn_q", 1536, 1536), ("attn_k", 1536, 256),
          ("mlp_gate", 1536, 8960), ("mlp_down", 8960, 1536)]


def main() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(repr_fmt=(5, 2), e_acc=6, m_acc=5, block_k=64)
    for name, k, n in SHAPES:
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        a = torch.randn((8, k), generator=gen, device=dev)
        for _ in range(5):
            qmatmul_fused(a, w, **kw)
        res = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                qmatmul_fused(a, w, **kw)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            res.append(((t1 - t0) * 1e4, (time.perf_counter() - t0) * 1e4))
        enq, full = sorted(res)[2]
        print(f"G host {root} {name}: enqueue {enq:.1f} us a call, until the "
              f"card is done {full:.1f} us a call", flush=True)


if __name__ == "__main__":
    main()
