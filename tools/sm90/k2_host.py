"""The host's time a call of K2 (``quantize``) at the oracle training
step's 12 distinct calls of qwen2-1.5b (T = 512; x f32 (T, K), w bf16
(K, N), g f32 (T, N) for the four (K, N) of a layer, to (1,5,2)): 100 calls
enqueued with no synchronisation between them (host clock), and the same
100 calls until the card is done; the median of 5.  Where the two agree,
the calls are bound by the host.  Takes the checkout at ROOT, so that two
trees compare in one command on a machine with the card:

  for r in build/parent . . build/parent; do python tools/sm90/k2_host.py $r; done
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

root = str(Path(sys.argv[1]).resolve())
sys.path[:0] = [root + "/src", root]

import torch  # noqa: E402

from repro_torch.kernels.quantize import quantize  # noqa: E402

T = 512
SHAPES = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536))


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
    for k, n in SHAPES:
        for what, shape, dtype in (("x", (T, k), torch.float32),
                                   ("w", (k, n), torch.bfloat16),
                                   ("g", (T, n), torch.float32)):
            v = torch.randn(shape, generator=gen, device=dev).to(dtype)
            enq, full = host_time(lambda: quantize(v, e=5, m=2))
            print(f"K2 host {root} {what} {tuple(shape)} {str(dtype)[6:]}: "
                  f"enqueue {enq:.1f} us a call, until the card is done "
                  f"{full:.1f} us a call", flush=True)


if __name__ == "__main__":
    main()
