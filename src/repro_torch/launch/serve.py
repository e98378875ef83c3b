"""Serving driver: continuous batching over the paged int8 KV arena.

Counterpart of ``repro.launch.serve`` for the dense family on one device:
paged int8 KV pages, the hand-written Hopper kernels for the quantized
GEMMs and the paged attention, optimistic admission with preemption/swap,
chunked prefill slabs interleaved with batched decode, and the serve-time
VRR monitor (``--monitor-cadence N``: every N decode steps K12's kernel
probes the longest context and a swamping breach widens its bucket's
carry; events append to ``--monitor-log``).  Runs on CUDA unless
``--device cpu`` (the plain PyTorch versions; small configs only).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --smoke --prompt-lens 16,32,48 --gen 16 --policy predicted --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.policy import AccumulationPolicy, plan_for_model
from repro_torch.models.api import get_model
from repro_torch.serve.scheduler import ServeEngine, resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-lens", default="16,32,48",
                    help="comma-separated prompt lengths, one request each")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0,
                    help="KV pool pages (0 = sized for the workload +25%%)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill slab size in tokens (multiple of "
                         "--page-size; 0 = one-shot prefill)")
    ap.add_argument("--policy", choices=["exact", "predicted"],
                    default="exact")
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--monitor-cadence", type=int, default=0,
                    help="decode steps between serve-time VRR probes "
                         "(0 = off)")
    ap.add_argument("--monitor-log", default="",
                    help="JSONL path for the monitor's events")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args):
    """(engine, prompts) for parsed ``args``: planned config, bf16 params
    from a seeded generator on the device, the engine, and seeded
    prompts."""
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    prompt_lens = [int(x) for x in args.prompt_lens.split(",")]
    max_ctx = max(prompt_lens) + args.gen
    policy = AccumulationPolicy(mode=args.policy, chunk=args.chunk)
    cfg = plan_for_model(cfg, seq_len=max_ctx, global_batch=len(prompt_lens),
                         policy=policy)
    model = get_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init_params(gen, device)
    # the JAX driver serves bf16 params
    params = _map(lambda x: x.to(torch.bfloat16)
                  if x.dtype == torch.float32 else x, params)
    tokens_needed = sum(n + args.gen for n in prompt_lens)
    n_pages = args.pages or (
        -(-int(tokens_needed * 1.25) // args.page_size) + 1)
    eng = ServeEngine(model, params, n_pages=n_pages,
                      page_size=args.page_size, max_batch=args.max_batch,
                      prefill_chunk_tokens=args.prefill_chunk or None,
                      monitor_cadence=args.monitor_cadence,
                      monitor_log=args.monitor_log or None, seed=args.seed,
                      device=device)
    rng = np.random.RandomState(args.seed + 1)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in prompt_lens]
    return eng, prompts


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def main(argv=None) -> dict:
    args = parse_args(argv)
    eng, prompts = build(args)
    rids = [eng.submit(p, args.gen) for p in prompts]
    dev = eng.executor.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    results = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    packed = eng.kv_bytes_per_token()
    f32 = eng.kv_bytes_per_token(carrier_bytes=4)
    print(f"arch={eng.cfg.name} device={dev} requests={len(rids)} "
          f"prompt_lens={[len(p) for p in prompts]} gen={args.gen}")
    print(f"continuous batching: {eng.decoded_tokens} decoded + "
          f"{eng.prefill_tokens} prefill tokens in {dt:.3f}s, max "
          f"concurrent {eng.max_concurrent}, pool {eng.n_pages} x "
          f"{args.page_size}-token pages")
    print(f"scheduler: {eng.prefill_slabs} prefill slabs "
          f"(chunk={args.prefill_chunk or 'one-shot'}), {eng.preemptions} "
          f"preemptions / {eng.restores} restores, utilization "
          f"{eng.utilization():.3f}")
    print(f"KV bytes/token: packed {packed:.1f} vs f32 {f32:.1f}")
    if args.monitor_cadence:
        kinds = [e["event"] for e in eng.events]
        print(f"monitor: {len(kinds)} ticks, "
              f"{kinds.count('rebucket')} rebuckets, bucket m_acc "
              f"{[b.m_acc for b in eng.plan.buckets]}")
    print("sample generation (request 0):", results[rids[0]])
    eng.pool.check_invariants()
    return {"seconds": dt, "results": results,
            "decoded_tokens": eng.decoded_tokens,
            "prefill_tokens": eng.prefill_tokens,
            "kv_bytes_per_token": packed, "max_concurrent": eng.max_concurrent,
            "preemptions": eng.preemptions, "restores": eng.restores}


if __name__ == "__main__":
    main()
