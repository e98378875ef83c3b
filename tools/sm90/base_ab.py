"""The base paths of G and E, and the RNE training step, of the checkout at
ROOT, so that two trees compare in one command on a machine with the card:

  for r in build/parent . . build/parent; do python tools/sm90/base_ab.py $r; done

* G: a qwen2-1.5b decode step's 197 base calls (M = 8: 28 layers of 7
  GEMMs under (1,5,2) operands and a (1,6,5) carry every 64 products, then
  the tied lm_head's embed.T under a (1,6,9) carry), called eagerly: the
  host clock until the last is enqueued and until the card is done, a
  step, the median of 5;
* E: one training step's 196 base calls (T = 512, the same layer shapes),
  CUDA events around the sequence, the median of 5;
* the training step: the train cell of ``chip_smoke.py`` (qwen2-1.5b at
  full width and depth, batch 8 x 64 tokens, predicted plan, chunk 64)
  through the launcher's ``build``, 6 steps, the host clock around each
  (ended by a sync).
"""

from __future__ import annotations

import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

root = str(Path(sys.argv[1]).resolve())
sys.path[:0] = [root + "/src", root]

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused import qmatmul_fused  # noqa: E402

LAYER = [("attn_q", 1536, 1536), ("attn_k", 1536, 256), ("attn_v", 1536, 256),
         ("attn_o", 1536, 1536), ("mlp_gate", 1536, 8960),
         ("mlp_up", 1536, 8960), ("mlp_down", 8960, 1536)]
LAYERS = 28
VOCAB = 151936
LAYER_KW = dict(repr_fmt=(5, 2), e_acc=6, m_acc=5, block_k=64)
HEAD_KW = dict(repr_fmt=None, e_acc=6, m_acc=9, block_k=64)


def g_step(dev, gen) -> None:
    ws = [(torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
           ).to(torch.bfloat16) for _, k, n in LAYER]
    xs = [torch.randn((8, k), generator=gen, device=dev) for _, k, _ in LAYER]
    emb = (torch.randn((VOCAB, 1536), generator=gen, device=dev) * 0.02
           ).to(torch.bfloat16)
    xh = torch.randn((8, 1536), generator=gen, device=dev)

    def step():
        for _ in range(LAYERS):
            for x, w in zip(xs, ws):
                qmatmul_fused(x, w, **LAYER_KW)
        qmatmul_fused(xh, emb.T, **HEAD_KW)

    step()
    torch.cuda.synchronize()
    res = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        res.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
    enq, full = sorted(res)[2]
    print(f"AB {root} G decode step (197 calls, M = 8): enqueued in "
          f"{enq:.3f} ms, card done in {full:.3f} ms (median of 5; all "
          f"{[round(r[1], 3) for r in res]})", flush=True)


def e_step(dev, gen) -> None:
    ws = [(torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
           ).to(torch.bfloat16) for _, k, n in LAYER]
    xs = [torch.randn((512, k), generator=gen, device=dev) for _, k, _ in LAYER]

    def step():
        for _ in range(LAYERS):
            for x, w in zip(xs, ws):
                qmatmul_fused(x, w, return_quantized=True, **LAYER_KW)

    step()
    torch.cuda.synchronize()
    res = []
    for _ in range(5):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        step()
        t1.record()
        torch.cuda.synchronize()
        res.append(t0.elapsed_time(t1))
    print(f"AB {root} E training step (196 calls, T = 512): "
          f"{statistics.median(res):.3f} ms (median of 5; all "
          f"{[round(r, 3) for r in res]})", flush=True)


def train_steps() -> None:
    from repro_torch.launch.train import build as build_train
    from repro_torch.launch.train import parse_args
    from repro_torch.train.loop import make_train_step

    args = parse_args(["--arch", "qwen2-1.5b", "--steps", "6",
                       "--global-batch", "8", "--seq-len", "64", "--lr",
                       "1e-3", "--warmup", "2", "--policy", "predicted",
                       "--chunk", "64", "--seed", "0", "--device", "cuda"])
    model, tc, state, data, _ = build_train(args)
    step_fn = make_train_step(model, tc)
    times, losses = [], []
    for _ in range(6):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"AB {root} RNE training step: steady {min(times[1:]):.1f} ms, "
          f"median of steps 2-6 {statistics.median(times[1:]):.1f} ms (all "
          f"{[round(t, 1) for t in times]}), losses "
          f"{[round(x, 5) for x in losses]}", flush=True)


def main() -> None:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    build.build_all()
    print(f"AB {root} card: {smi}; kernels ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    g_step(dev, gen)
    e_step(dev, gen)
    torch.cuda.empty_cache()
    train_steps()


if __name__ == "__main__":
    main()
