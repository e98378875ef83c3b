"""Serving driver: continuous batching over the paged int8 KV arena.

Counterpart of ``repro.launch.serve`` for the dense family on one device:
paged int8 KV pages, the hand-written Hopper kernels for the quantized
GEMMs and the paged attention, optimistic admission with preemption/swap,
chunked prefill slabs interleaved with batched decode, and the serve-time
VRR monitor (``--monitor-cadence N``: every N decode steps K12's kernel
probes the longest context and a swamping breach widens its bucket's
carry; events append to ``--monitor-log``).  Runs on CUDA unless
``--device cpu`` (the plain PyTorch versions; small configs only).
``--ckpt-dir`` serves the parameters of the latest training checkpoint
there, under the plan with the run's recorded ``precision_schedule``
applied; ``--n-layers`` cuts the depth (to match such a checkpoint).

``--serve-mesh N`` serves tensor-parallel over N ranks, which the launcher
spawns itself (one process a rank, rank r on ``cuda:(r % cards)``): each
runs the same engine schedule in lockstep on its output-dim slice of the
weights and its KV-head slice of the arena, and rank 0 reports.  The
backend follows ``dist.serve_backend``: NCCL when every rank has a card of
its own, gloo when ranks share one (and with ``--device cpu``); the rule
is printed.  ``--logit-wire int8`` sums d_model-partial logits over an
int8 wire instead of gathering them (lossy in general).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --smoke --prompt-lens 16,32,48 --gen 16 --policy predicted --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --policy \
      predicted --device cpu --serve-mesh 2
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.policy import AccumulationPolicy, plan_for_model
from repro_torch.models.api import get_model
from repro_torch.dist import LOCAL, Dist, all_gather
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
    ap.add_argument("--ckpt-dir", default="",
                    help="restore params (and the recorded precision "
                         "schedule) from the latest training checkpoint")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the model to this many layers (0 = the "
                         "config's depth)")
    ap.add_argument("--serve-mesh", type=int, default=0,
                    help="tensor-parallel ranks (0 = one device); heads, d_ff "
                         "and the arena's KV heads split over them, logits "
                         "stay bitwise the single-device logits")
    ap.add_argument("--logit-wire", choices=["gather", "int8"],
                    default="gather",
                    help="sharded unembed: exact gather, or the int8 "
                         "compressed-sum wire (lossy in general)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _restore_params(ckpt_dir: str, cfg, policy, params, *, seq_len: int,
                    global_batch: int):
    """(config, params, schedule): the latest checkpoint's params, and the
    config re-planned under the precision schedule the run trained with
    (as recorded; None when there is none)."""
    from repro_torch.telemetry.controller import (
        PrecisionController,
        apply_schedule,
    )
    from repro_torch.train.checkpoint import latest_step, restore_checkpoint

    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    state, meta = restore_checkpoint(ckpt_dir, step, {"params": params})
    schedule = meta.get("precision_schedule")
    if schedule:
        ctl = PrecisionController(policy)
        ctl.restore_meta(schedule)
        cfg = apply_schedule(cfg, policy, ctl.schedule(), seq_len=seq_len,
                             global_batch=global_batch)
        print(f"restored step {step} with precision schedule {schedule}")
    else:
        print(f"restored step {step} (no precision schedule recorded)")
    return cfg, state["params"], schedule


def plan_widths(cfg) -> dict:
    """``{"<gemm>:<role>": m_acc}`` of the config's quantized GEMMs."""
    from repro_torch.telemetry.controller import PLAN_FIELDS, ROLES

    out = {}
    for name in PLAN_FIELDS:
        q = getattr(cfg.quant, name, None)
        for role in ROLES:
            prec = None if q is None else getattr(q, role)
            if prec is not None:
                out[f"{name}:{role}"] = prec.m_acc
    return out


def build(args):
    """(engine, prompts, restored schedule) for parsed ``args``: planned
    config, bf16 params from a seeded generator on the device (or from
    ``--ckpt-dir``), the engine, and seeded prompts."""
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    prompt_lens = [int(x) for x in args.prompt_lens.split(",")]
    max_ctx = max(prompt_lens) + args.gen
    policy = AccumulationPolicy(mode=args.policy, chunk=args.chunk)
    cfg = plan_for_model(cfg, seq_len=max_ctx, global_batch=len(prompt_lens),
                         policy=policy)
    model = get_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init_params(gen, device)
    schedule = None
    if args.ckpt_dir:
        cfg, params, schedule = _restore_params(
            args.ckpt_dir, cfg, policy, params, seq_len=max_ctx,
            global_batch=len(prompt_lens))
        model = get_model(cfg)
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
    return eng, prompts, schedule


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.serve_mesh:
        return main_tp(args)
    eng, prompts, schedule = build(args)
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
    if args.ckpt_dir:
        print(f"plan m_acc: {plan_widths(eng.cfg)}")
    print("sample generation (request 0):", results[rids[0]])
    eng.pool.check_invariants()
    return {"seconds": dt, "results": results,
            "schedule": schedule, "plan": plan_widths(eng.cfg),
            "decoded_tokens": eng.decoded_tokens,
            "prefill_tokens": eng.prefill_tokens,
            "kv_bytes_per_token": packed, "max_concurrent": eng.max_concurrent,
            "preemptions": eng.preemptions, "restores": eng.restores}


# --------------------------------------------------------------------------
# tensor-parallel serving: a job, run in this process or over spawned ranks
# --------------------------------------------------------------------------


def serve_job(job: dict, dist: Dist = LOCAL, device="cuda") -> dict:
    """Serve one job on this process, alone (``dist`` LOCAL) or as one rank
    of a tensor-parallel group; every rank runs the same schedule.

    ``job``: ``cfg`` (planned), ``params`` (a tree of CPU tensors) or
    ``seed`` (random weights drawn on ``device``, bf16, as ``build``
    draws them), ``n_pages``, ``page_size``, ``max_batch``,
    ``prefill_chunk`` (None: one-shot), ``plan`` (None: the engine's),
    ``prompts``, ``gen``, ``preempt_after`` (None, or engine steps after
    which the youngest resident is preempted), ``monitor_cadence``,
    ``logit_step`` (the decode step whose logits are returned).

    Returns the token streams, the sha256 of every decode step's logits,
    the ``logit_step``-th step's logits, the arena (every rank's KV heads
    gathered; rank 0 only), the host seconds of the decode steps and the
    prefill slabs, the engine's counts and the monitor's events."""
    import hashlib

    from repro_torch.quant.formats import FPFormat
    from repro_torch.serve.kvcache import PagedKVConfig
    from repro_torch.serve.scheduler import ModelExecutor, ShardedModelExecutor

    device = torch.device(device)
    cfg = job["cfg"]
    model = get_model(cfg)
    if job.get("params") is not None:
        params = _map(lambda x: x.to(device), job["params"])
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(job["seed"])
        params = _map(lambda x: x.to(torch.bfloat16)
                      if x.dtype == torch.float32 else x,
                      model.init_params(gen, device))
    pc = PagedKVConfig.for_model(cfg, n_pages=job["n_pages"],
                                 page_size=job["page_size"],
                                 kv_fmt=FPFormat(e=5, m=2))
    kw = dict(kv_fmt=pc.kv_fmt, max_batch=job["max_batch"], device=device)
    ex = (ShardedModelExecutor(model, params, pc, dist=dist, **kw)
          if dist.sharded else ModelExecutor(model, params, pc, **kw))
    del params
    times = {"decode": 0.0, "prefill": 0.0}
    hashes, kept = [], {}
    decode_logits, prefill = ex.decode_logits, ex.prefill

    def timed_decode_logits(req):
        t0 = time.perf_counter()
        logits = decode_logits(req)
        host = logits.float().cpu().numpy()
        times["decode"] += time.perf_counter() - t0
        hashes.append(hashlib.sha256(host.tobytes()).hexdigest())
        if len(hashes) - 1 == job.get("logit_step", 0):
            kept["logits"] = host
        return logits

    def timed_prefill(req):
        t0 = time.perf_counter()
        out = prefill(req)
        times["prefill"] += time.perf_counter() - t0
        return out

    ex.decode_logits, ex.prefill = timed_decode_logits, timed_prefill
    eng = ServeEngine(model, None, n_pages=job["n_pages"],
                      page_size=job["page_size"], max_batch=job["max_batch"],
                      prefill_chunk_tokens=job.get("prefill_chunk"),
                      plan=job.get("plan"),
                      monitor_cadence=job.get("monitor_cadence", 0),
                      seed=job.get("seed", 0), executor=ex, device=device)
    rids = [eng.submit(p, job["gen"]) for p in job["prompts"]]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if job.get("preempt_after") is not None:
        for _ in range(job["preempt_after"]):
            eng.step()
        eng.preempt(max(eng.active))
    results = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    eng.pool.check_invariants()
    arena = {}
    for name in ("k", "v"):
        full = torch.cat(all_gather(ex.kv[name], dist), dim=2)
        arena[name] = full.cpu().numpy() if dist.rank == 0 else None
    for name in ("k_se", "v_se"):
        every = all_gather(ex.kv[name], dist)
        if any(not torch.equal(every[0], x) for x in every[1:]):
            raise AssertionError(f"the ranks' page exponents {name} differ")
        arena[name] = every[0].cpu().numpy() if dist.rank == 0 else None
    return dict(
        rank=dist.rank, tokens=[results[r] for r in rids],
        logit_hashes=hashes, logits=kept.get("logits"),
        arena=arena if dist.rank == 0 else None, seconds=seconds,
        decode_s=times["decode"], prefill_s=times["prefill"],
        decoded=eng.decoded_tokens, prefill_tokens=eng.prefill_tokens,
        prefill_slabs=eng.prefill_slabs, preemptions=eng.preemptions,
        restores=eng.restores, events=list(eng.events),
        plan_m_acc=[b.m_acc for b in eng.plan.buckets],
        kv_bytes_per_token=eng.kv_bytes_per_token(),
        kv_bytes_per_token_shard=eng.kv_bytes_per_token(per_shard=True),
        tp_shards=eng.tp_shards)


def _serve_rank(rank: int, size: int, init_method: str, job: dict,
                device: str, backend: str) -> dict:
    from repro_torch.dist import init_group, rank_device

    dev = rank_device(rank, torch.device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)   # the ranks share the host's cores
    dist = init_group(rank, size, init_method, backend, device=dev,
                      logit_wire=job.get("logit_wire", "gather"))
    return serve_job(job, dist, dev)


def run_tp(job: dict, n_ranks: int, device="cuda", *,
           timeout_s: float = 1800.0) -> list[dict]:
    """``serve_job`` over ``n_ranks`` spawned ranks (each rank's result in
    rank order).  The kernels are built here first, so the ranks only load
    them; the backend follows ``dist.serve_backend`` (printed)."""
    from repro_torch.dist import serve_backend, spawn

    dev = resolve_device(device)
    backend, rule = serve_backend(dev, n_ranks)
    print(f"serve mesh: {n_ranks} tensor-parallel ranks, backend {rule}; "
          f"logit wire {job.get('logit_wire', 'gather')}", flush=True)
    if dev.type == "cuda":
        from repro_torch.kernels import build as kernel_build

        kernel_build.build_all()
    return spawn(_serve_rank, n_ranks, (job, str(dev), backend),
                 timeout_s=timeout_s)


def main_tp(args) -> dict:
    """``main`` under ``--serve-mesh``: the seeded model and prompts of
    ``build``, served over the spawned ranks."""
    if args.ckpt_dir:
        raise NotImplementedError("--ckpt-dir is not served under "
                                  "--serve-mesh")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    prompt_lens = [int(x) for x in args.prompt_lens.split(",")]
    cfg = plan_for_model(cfg, seq_len=max(prompt_lens) + args.gen,
                         global_batch=len(prompt_lens),
                         policy=AccumulationPolicy(mode=args.policy,
                                                   chunk=args.chunk))
    rng = np.random.RandomState(args.seed + 1)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in prompt_lens]
    n_pages = args.pages or (
        -(-int(sum(n + args.gen for n in prompt_lens) * 1.25)
          // args.page_size) + 1)
    job = dict(cfg=cfg, seed=args.seed, n_pages=n_pages,
               page_size=args.page_size, max_batch=args.max_batch,
               prefill_chunk=args.prefill_chunk or None, prompts=prompts,
               gen=args.gen, monitor_cadence=args.monitor_cadence,
               logit_wire=args.logit_wire)
    r0 = run_tp(job, args.serve_mesh, device)[0]
    print(f"arch={cfg.name} device={device} ranks={args.serve_mesh} "
          f"requests={len(prompts)} prompt_lens={prompt_lens} gen={args.gen}")
    print(f"continuous batching: {r0['decoded']} decoded + "
          f"{r0['prefill_tokens']} prefill tokens in {r0['seconds']:.3f}s "
          f"(rank 0's host clock), {r0['prefill_slabs']} prefill slabs, "
          f"{r0['preemptions']} preemptions / {r0['restores']} restores")
    print(f"KV bytes/token: {r0['kv_bytes_per_token']:.1f} in all, "
          f"{r0['kv_bytes_per_token_shard']:.1f} a rank; bucket m_acc "
          f"{r0['plan_m_acc']}")
    print("sample generation (request 0):", r0["tokens"][0])
    return {"seconds": r0["seconds"], "results": dict(enumerate(r0["tokens"])),
            "decoded_tokens": r0["decoded"],
            "prefill_tokens": r0["prefill_tokens"],
            "kv_bytes_per_token": r0["kv_bytes_per_token"],
            "preemptions": r0["preemptions"], "restores": r0["restores"],
            "plan": plan_widths(cfg), "ranks": args.serve_mesh, "rank0": r0}


if __name__ == "__main__":
    main()
