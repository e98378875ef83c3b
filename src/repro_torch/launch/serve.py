"""Serving driver: continuous batching over the paged int8 KV arena.

Counterpart of ``repro.launch.serve`` on one device:
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

Before traffic the engine makes every certified bucket's signatures
(``ServeEngine.warmup``: on the card, captures the CUDA graph of each
bucket's decode step and prefill slab; ``--no-warmup`` leaves them to the
first request of each), and prints its compile-cache counters after.
``--spec-decode K`` serves with speculative decoding: a draft model
(``--draft-config``, default qwen2-0.5b, which must share the target's
vocabulary; its weights seeded from ``--seed`` + 7) proposes K tokens a
round, one batched verify scores them, and a rejection is a page-exact
rollback; the streams stay bitwise plain greedy decode.

Without ``--prompt-lens`` the requests are ``--batch`` prompts of
``--prompt-len`` tokens, as in JAX.  ``--reserve-admission`` admits by
worst-case page reservation (no preemption, the baseline of the bursty
utilization comparison); ``--v-hint`` bounds the attention carry's
per-term magnitude for the planner's exponent; ``--events-capacity``
bounds the engine's event ring buffer (0 = unbounded).  ``--obs-spans
PATH`` traces every request (``obs.trace``) and writes its span tree as
JSONL, with TTFT percentiles from the spans; ``--obs-metrics PATH`` and
``--obs-prometheus PATH`` export the engine's metrics registry
(``obs.metrics``), with the kernels' launch counts, the certification
memo and the compile cache swept in at exit.  ``--legacy`` serves the
static batch instead (``_legacy_main``: one prefill, then every prompt
token and ``--gen`` tokens through ``models.lm.decode_step`` over a dense
bf16 cache, all rows at one position; ``--batch`` prompts of
``--prompt-len`` tokens from ``SyntheticLM``).  ``--arch`` takes the
dense, MoE and VLM configs (``configs.ARCHS``; the SSM, hybrid and
encoder-decoder ones are not ported yet and raise); the VLM stub is
served on tokens only, as JAX's engine serves it.

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
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --policy \
      predicted --device cpu --spec-decode 4
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --policy \
      predicted --device cpu --legacy
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
    ap.add_argument("--prompt-lens", default="",
                    help="comma-separated prompt lengths, one request each; "
                         "default: --batch prompts of --prompt-len tokens")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0,
                    help="KV pool pages (0 = sized for the workload +25%%)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill slab size in tokens (multiple of "
                         "--page-size; 0 = one-shot prefill)")
    ap.add_argument("--reserve-admission", action="store_true",
                    help="worst-case page-reservation admission, no "
                         "preemption (the baseline)")
    ap.add_argument("--policy", choices=["exact", "predicted"],
                    default="exact")
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--v-hint", type=float, default=0.0,
                    help="certified per-term bound on the attention carry "
                         "(value magnitude x softmax weight) for the "
                         "planner's e_acc; 0 = serve.plan.DEFAULT_V_HINT.  "
                         "The monitor reports the measured hint beside it")
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
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="speculative decoding: a draft model proposes K "
                         "tokens a round, one batched verify scores them, "
                         "a rejection is a page-exact rollback (0 = off); "
                         "the streams stay bitwise plain greedy decode")
    ap.add_argument("--draft-config", default="qwen2-0.5b",
                    help="the draft model's arch for --spec-decode (it must "
                         "share the target's vocabulary)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup before traffic (each bucket's "
                         "signatures are then made, on the card captured, "
                         "by its first request)")
    ap.add_argument("--legacy", action="store_true",
                    help="serve the static batch (models.lm.decode_step)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs-spans", default="",
                    help="trace the request lifecycle (obs.trace) and "
                         "export the span tree as JSONL here")
    ap.add_argument("--obs-metrics", default="",
                    help="record engine metrics in the registry "
                         "(obs.metrics) and export them as JSONL here")
    ap.add_argument("--obs-prometheus", default="",
                    help="also export the registry in Prometheus textfile-"
                         "collector format here")
    ap.add_argument("--events-capacity", type=int, default=4096,
                    help="ring-buffer capacity of the engine's events "
                         "(monitor, preempt, restore, spec rounds; 0 = "
                         "unbounded)")
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


def prompt_lengths(args) -> list[int]:
    """``--prompt-lens``, or ``--batch`` copies of ``--prompt-len``."""
    if args.prompt_lens:
        return [int(x) for x in args.prompt_lens.split(",")]
    return [args.prompt_len] * args.batch


def build_params(args):
    """(planned config, model, bf16 params, restored schedule, device) for
    parsed ``args``: params from a seeded generator on the device, or from
    ``--ckpt-dir``."""
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    prompt_lens = prompt_lengths(args)
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
    return cfg, model, params, schedule, device


def obs_of(args):
    """(tracer, registry) that ``--obs-spans`` and ``--obs-metrics``/
    ``--obs-prometheus`` ask for, each None when off."""
    tracer = registry = None
    if args.obs_spans:
        from repro_torch.obs.trace import Tracer

        tracer = Tracer()
    if args.obs_metrics or args.obs_prometheus:
        from repro_torch.obs.metrics import get_registry

        registry = get_registry()
    return tracer, registry


def build(args, tracer=None, registry=None):
    """(engine, prompts, restored schedule) for parsed ``args``: planned
    config, bf16 params from a seeded generator on the device (or from
    ``--ckpt-dir``), the engine (tracing into ``tracer``, recording into
    ``registry``), and seeded prompts."""
    cfg, model, params, schedule, device = build_params(args)
    prompt_lens = prompt_lengths(args)
    max_ctx = max(prompt_lens) + args.gen
    policy = AccumulationPolicy(mode=args.policy, chunk=args.chunk)
    tokens_needed = sum(n + args.gen for n in prompt_lens)
    n_pages = args.pages or (
        -(-int(tokens_needed * 1.25) // args.page_size) + 1)
    eng_kw = dict(n_pages=n_pages, page_size=args.page_size,
                  max_batch=args.max_batch, v_hint=args.v_hint or None,
                  prefill_chunk_tokens=args.prefill_chunk or None,
                  reserve_admission=args.reserve_admission,
                  monitor_cadence=args.monitor_cadence,
                  monitor_log=args.monitor_log or None, seed=args.seed,
                  device=device, tracer=tracer, metrics=registry,
                  events_capacity=args.events_capacity or None)
    if args.spec_decode:
        from repro_torch.serve.spec import SpecDecodeEngine

        draft_cfg = (get_smoke_config(args.draft_config) if args.smoke
                     else get_config(args.draft_config))
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise SystemExit(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: verify compares token ids")
        draft_cfg = plan_for_model(draft_cfg, seq_len=max_ctx,
                                   global_batch=len(prompt_lens),
                                   policy=policy)
        draft_model = get_model(draft_cfg)
        dgen = torch.Generator(device=device)
        dgen.manual_seed(args.seed + 7)
        draft_params = _map(lambda x: x.to(torch.bfloat16)
                            if x.dtype == torch.float32 else x,
                            draft_model.init_params(dgen, device))
        eng = SpecDecodeEngine(model, params, spec_k=args.spec_decode,
                               draft_model=draft_model,
                               draft_params=draft_params, **eng_kw)
        print(f"speculative decoding: k={args.spec_decode} draft "
              f"{draft_cfg.name} ({args.draft_config})")
    else:
        eng = ServeEngine(model, params, **eng_kw)
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
    if args.legacy:
        cfg, model, params, _, device = build_params(args)
        return _legacy_main(args, cfg, model, params, device)
    if args.serve_mesh:
        if args.spec_decode:
            raise SystemExit("--spec-decode does not compose with "
                             "--serve-mesh (single device only)")
        return main_tp(args)
    tracer, registry = obs_of(args)
    eng, prompts, schedule = build(args, tracer, registry)
    if not args.no_warmup:
        warm = eng.warmup()
        print(f"warmup: {warm['compiles']} compiles across "
              f"{warm['buckets']} buckets in {warm['seconds']:.2f}s")
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
    admission = "reservation" if args.reserve_admission else "optimistic"
    print(f"scheduler: {eng.prefill_slabs} prefill slabs "
          f"(chunk={args.prefill_chunk or 'one-shot'}), {eng.preemptions} "
          f"preemptions / {eng.restores} restores, utilization "
          f"{eng.utilization():.3f} ({admission} admission)")
    print(f"KV bytes/token: packed {packed:.1f} vs f32 {f32:.1f}")
    if args.monitor_cadence:
        kinds = [e["event"] for e in eng.events]
        print(f"monitor: {len(kinds)} ticks, "
              f"{kinds.count('rebucket')} rebuckets, bucket m_acc "
              f"{[b.m_acc for b in eng.plan.buckets]}")
    if args.ckpt_dir:
        print(f"plan m_acc: {plan_widths(eng.cfg)}")
    if args.spec_decode:
        print(f"spec decode: {eng.spec_rounds} rounds, acceptance "
              f"{eng.acceptance_rate():.3f} "
              f"({eng.spec_accepted}/{eng.spec_proposed} draft tokens), "
              f"{eng.spec_emitted} tokens committed by verify, "
              f"{eng.spec_rollback_tokens} rolled back, "
              f"{eng.fallback_rows} plain-lane fallbacks")
    cstats = eng.compile_stats()
    steady = cstats["compiles"] - cstats["warm_compiles"]
    print(f"compile cache: {cstats['compiles']} compiles "
          f"({cstats['warm_compiles']} at warmup, {steady} steady-state), "
          f"{cstats['hits']} dispatch hits / {cstats['misses']} misses"
          f"{' (CUDA graphs)' if eng.executor.graphs else ''}")
    print("sample generation (request 0):", results[rids[0]])
    eng.pool.check_invariants()
    latency = export_obs(args, tracer, registry)
    out = {"seconds": dt, "results": results,
           "schedule": schedule, "plan": plan_widths(eng.cfg),
           "decoded_tokens": eng.decoded_tokens,
           "prefill_tokens": eng.prefill_tokens,
           "kv_bytes_per_token": packed, "max_concurrent": eng.max_concurrent,
           "preemptions": eng.preemptions, "restores": eng.restores,
           "utilization": eng.utilization(), "events": list(eng.events),
           "compile_stats": cstats, "latency": latency}
    if args.spec_decode:
        out.update(spec_rounds=eng.spec_rounds,
                   acceptance_rate=eng.acceptance_rate(),
                   spec_rollback_tokens=eng.spec_rollback_tokens)
    return out


def export_obs(args, tracer, registry) -> dict | None:
    """Write the spans and the registry ``args`` ask for; returns the
    TTFT/TPOT percentiles of the traced requests (host seconds), or None
    without a tracer."""
    latency = None
    if tracer is not None:
        from repro_torch.obs.trace import percentile, request_latencies

        n = tracer.export_jsonl(args.obs_spans)
        lats = request_latencies(tracer.spans)
        ttft = [r["ttft"] for r in lats]
        tpot = [r["tpot"] for r in lats]
        latency = {"requests": len(lats),
                   "ttft_p50": percentile(ttft, 50),
                   "ttft_p99": percentile(ttft, 99),
                   "tpot_p50": percentile(tpot, 50),
                   "tpot_p99": percentile(tpot, 99)}
        print(f"spans: {n} exported to {args.obs_spans}; TTFT "
              f"p50={latency['ttft_p50']} p99={latency['ttft_p99']} (s), "
              f"TPOT p50={latency['tpot_p50']} p99={latency['tpot_p99']} "
              f"(s)")
    if registry is not None:
        from repro_torch.obs.metrics import collect_process_metrics

        collect_process_metrics(registry)
        if args.obs_metrics:
            registry.export_jsonl(args.obs_metrics)
        if args.obs_prometheus:
            registry.export_prometheus(args.obs_prometheus)
    return latency


# --------------------------------------------------------------------------
# the legacy static batch
# --------------------------------------------------------------------------


def _legacy_main(args, cfg, model, params, device) -> dict:
    """Static-batch prefill and greedy decode (JAX's ``_legacy_main``, the
    dense, MoE and VLM families; the VLM stub's patch embeddings from
    ``with_extras`` at JAX's ``PRNGKey(1)`` feed the prefill): ``--batch`` ``SyntheticLM`` prompts of ``--prompt-len``
    tokens, one prefill (whose logits JAX's launcher discards too), then
    every prompt token and ``--gen`` - 1 more through ``decode_step`` over
    a dense bf16 cache, all rows at one position.  The positions are a
    device tensor made once, so no step reads anything back to the host;
    the tokens come back at the end.  Returns tok/s over the decode loop
    and the (batch, gen) generated tokens."""
    from repro_torch.data import prng
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, with_extras

    prompt_len = args.prompt_len
    if args.prompt_lens:
        print(f"note: legacy static batch serves {args.batch} uniform "
              f"prompts of {prompt_len} tokens; --prompt-lens "
              f"{args.prompt_lens!r} applies to the paged engine only")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=prompt_len, global_batch=args.batch,
                                  seed=args.seed), device=device)
    batch = with_extras(next(data), cfg, key=prng.prng_key(1))
    max_t = prompt_len + args.gen
    pos = torch.arange(max_t, dtype=torch.int32, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        model.prefill(params, batch, cfg)
        state = model.init_decode_state(cfg, args.batch, max_t, device)
        # replay the prompt through decode to fill the caches
        prompt = batch["tokens"]
        for i in range(prompt.shape[1]):
            logits, state = model.decode_step(params, prompt[:, i:i + 1],
                                              state, pos[i], cfg)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        sync()
        t_prefill = time.perf_counter() - t0
        out_tokens = [tok]
        t0 = time.perf_counter()
        base = prompt.shape[1]
        for i in range(args.gen - 1):
            logits, state = model.decode_step(params, tok, state,
                                              pos[base + i], cfg)
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
            out_tokens.append(tok)
        sync()
    t_decode = time.perf_counter() - t0
    gen = torch.cat(out_tokens, dim=1).cpu()
    toks_per_s = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"arch={cfg.name} device={device} batch={args.batch} "
          f"prompt={prompt_len} gen={args.gen} [legacy static batch]")
    print(f"prefill: {t_prefill:.3f}s   decode: {t_decode:.3f}s "
          f"({toks_per_s:.1f} tok/s)")
    print("sample generation (seq 0):", gen[0].tolist())
    return {"tok_per_s": float(toks_per_s), "gen": gen,
            "prefill_s": t_prefill, "decode_s": t_decode,
            "prompt": batch["tokens"].cpu()}


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
    prefill slabs, the engine's counts, the monitor's events and the
    kernels' launches over the job (``launches``)."""
    import hashlib

    from repro_torch.quant.formats import FPFormat
    from repro_torch.serve.kvcache import PagedKVConfig
    from repro_torch.serve.scheduler import ModelExecutor, ShardedModelExecutor

    device = torch.device(device)
    launches0 = launch_counts()
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
    # eager on one device too: the executor the sharded ranks are held
    # against, its calls timed one by one
    ex = (ShardedModelExecutor(model, params, pc, dist=dist, **kw)
          if dist.sharded else ModelExecutor(model, params, pc, graphs=False,
                                             **kw))
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
        tp_shards=eng.tp_shards,
        launches={k: v - launches0[k] for k, v in launch_counts().items()})


def launch_counts() -> dict:
    """The serving kernels' launch counters now (each wrapper counts where
    it launches its kernel): G/E, D and its carry entry, P and its carry
    entry."""
    from repro_torch.kernels.attention import (flash_prefill_paged,
                                               paged_attn_decode)
    from repro_torch.kernels.fused import qmatmul_fused

    d, p = paged_attn_decode, flash_prefill_paged
    return {"qmatmul_fused": qmatmul_fused.launches,
            "paged_attn_decode": d.launches,
            "paged_attn_decode(return_carry)": d.carry_launches,
            "flash_prefill_paged": p.launches,
            "flash_prefill_paged(return_carry)": p.carry_launches}


def _serve_rank(rank: int, size: int, init_method: str, jobs: list,
                device: str, backend: str, setup=None):
    from repro_torch.dist import init_group, rank_device

    dev = rank_device(rank, torch.device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)   # the ranks share the host's cores
    dist = init_group(rank, size, init_method, backend, device=dev,
                      logit_wire=jobs[0].get("logit_wire", "gather"))
    first = setup(dist, dev) if setup is not None else None
    return first, [serve_job(job, dist, dev) for job in jobs]


def run_tp(jobs, n_ranks: int, device="cuda", *, timeout_s: float = 1800.0,
           setup=None) -> list:
    """``serve_job`` over ``n_ranks`` spawned ranks, started once for every
    job of the list ``jobs`` (run in order; one logit wire for all).  Each
    rank's result in rank order: ``{"setup": setup(dist, device) or None,
    "runs": [each job's result]}`` (``setup``, a picklable function every
    rank calls first).  The kernels are built here first, so the ranks only load
    them; the backend follows ``dist.serve_backend`` (printed)."""
    from repro_torch.dist import serve_backend, spawn

    jobs = list(jobs)
    dev = resolve_device(device)
    backend, rule = serve_backend(dev, n_ranks)
    print(f"serve mesh: {n_ranks} tensor-parallel ranks, backend {rule}; "
          f"logit wire {jobs[0].get('logit_wire', 'gather')}; "
          f"{len(jobs)} job(s)", flush=True)
    if dev.type == "cuda":
        from repro_torch.kernels import build as kernel_build

        kernel_build.build_all()
    outs = spawn(_serve_rank, n_ranks, (jobs, str(dev), backend, setup),
                 timeout_s=timeout_s)
    return [{"setup": first, "runs": runs} for first, runs in outs]


def main_tp(args, extra_jobs=(), setup=None) -> dict:
    """``main`` under ``--serve-mesh``: the seeded model and prompts of
    ``build``, served over the spawned ranks, then ``extra_jobs`` on the
    same ranks (rank 0's results under ``"extra"``, every rank's
    ``setup`` result under ``"setups"``)."""
    if args.ckpt_dir:
        raise NotImplementedError("--ckpt-dir is not served under "
                                  "--serve-mesh")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if cfg.moe is not None:
        raise NotImplementedError(
            "--serve-mesh does not take MoE models (ROADMAP [moe-ep]: "
            "moe_apply's expert-parallel branch)")
    prompt_lens = prompt_lengths(args)
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
    ranks = run_tp([job, *extra_jobs], args.serve_mesh, device, setup=setup)
    r0 = ranks[0]["runs"][0]
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
            "plan": plan_widths(cfg), "ranks": args.serve_mesh, "rank0": r0,
            "extra": ranks[0]["runs"][1:],
            "setups": [r["setup"] for r in ranks]}


if __name__ == "__main__":
    main()
