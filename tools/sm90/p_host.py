"""The host's time a call of P (``flash_prefill_paged``) at qwen2-1.5b's
64-token slab (H 12, KV 2, dh 128, page 16, q_offset 320, a 64-page row)
and of K10 (``flash_prefill``) at the 384-token one-shot prompt (chunk 16):
100 calls enqueued with no synchronisation between them (host clock), and
the same 100 calls until the card is done; the median of 5.  Where the two
agree, the calls are bound by the host.  Takes the checkout at ROOT, so
that two trees compare in one command on a machine with the card:

  for r in build/parent . . build/parent; do python tools/sm90/p_host.py $r; done
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

root = str(Path(sys.argv[1]).resolve())
sys.path[:0] = [root + "/src", root]

import torch  # noqa: E402

from repro_torch.kernels.attention import (  # noqa: E402
    flash_prefill,
    flash_prefill_paged,
)
from repro_torch.kernels.common import quantize_block  # noqa: E402
from repro_torch.quant.qtensor import pack_block  # noqa: E402

H, KV, DH, PAGE, WIDTH = 12, 2, 128, 16, 64
SLAB, Q_OFF, PROMPT = 64, 320, 384


def host_time(call) -> tuple[float, float]:
    """(enqueue, until done) microseconds a call: the median of 5 runs of
    100 calls."""
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
    return sorted(res)[2]


def main() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    kv_len = Q_OFF + SLAB
    n_pages = 1 + -(-kv_len // PAGE)

    def codes():
        x = torch.randn((n_pages, KV, PAGE, DH), generator=gen, device=dev)
        return pack_block(quantize_block(x, 5, 2), 5, 2)

    se = lambda: torch.randint(-2, 3, (n_pages,), generator=gen, device=dev,
                               dtype=torch.int32)
    row = torch.zeros((WIDTH,), dtype=torch.int32, device=dev)
    row[:n_pages - 1] = torch.arange(1, n_pages, device=dev)
    args = (codes(), codes(), se(), se(), row, Q_OFF, SLAB, kv_len)
    q = torch.randn((SLAB, H, DH), generator=gen, device=dev)
    qd, kd, vd = (torch.randn((PROMPT, n, DH), generator=gen, device=dev)
                  for n in (H, KV, KV))
    for what, call in (
            ("P", lambda: flash_prefill_paged(q, *args, kv_fmt=(5, 2),
                                              acc=(6, 5))),
            ("K10", lambda: flash_prefill(qd, kd, vd, acc=(6, 5),
                                          chunk=PAGE))):
        enq, full = host_time(call)
        print(f"{what} host {root}: enqueue {enq:.1f} us a call, until the "
              f"card is done {full:.1f} us a call", flush=True)


if __name__ == "__main__":
    main()
