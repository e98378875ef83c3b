"""Training driver: AdamW steps of a dense LM under an accumulation plan.

Counterpart of ``repro.launch.train`` on one device: the synthetic LM
stream, the plan's quantized GEMMs through the hand-written Hopper kernels
(E forward, B backward, G for the unquantized lm_head), a bf16 compute copy
of the parameters once per step, microbatches, optional dynamic loss
scaling, and one JSON record per logged step.  Runs on CUDA unless
``--device cpu`` (the plain PyTorch versions; small configs only).

Swamping telemetry: ``--telemetry-cadence N`` probes every quantized GEMM
every N steps (``train.loop.run_telemetry_tick``: one forward, then the
stats kernel K8 on the lm_head's live operands and on synthetic ones at
each layer GEMM's geometry) and lets the closed-loop precision controller
bump or trim each GEMM's ``m_acc``; ``--ingraph-telemetry`` makes the
cadence step itself the tagged step (``obs.ingraph``: the stats variants
K9 and K8 on the true gradients, the same numerics).  Events print as
``{"telemetry": ...}`` lines and append to ``--telemetry-log``; a
re-planned model goes on training.

Checkpoints (``--ckpt-dir``, every ``--ckpt-every`` steps and at the end;
``train.checkpoint``, the JAX package's layout) hold the parameters, the
AdamW moments and step, the loss scaler, the data cursor and the
controller's realized ``precision_schedule`` (with its hysteresis streaks,
so a resumed run re-plans as the uninterrupted one does).  A run started
with a checkpoint in ``--ckpt-dir`` resumes from the latest one.
``--crash-at-step N`` kills a fresh run before step N (exit 42), for the
restart supervisor (``launch.supervisor``).  ``--n-layers`` cuts the depth.

``--rounding sr`` rounds every solver-assigned GEMM's chunk carries
stochastically (the below-the-knee mode), seeded by ``--sr-seed``: the
same seed reproduces the run bitwise.  E, B and the stats kernels K8 and
K9 carry it on the card; the lm_head keeps its RNE 16-bit carry.

``--a2q-reg S`` turns on A2Q (``train.optimizer``): the per-column l1 cap
of every 2-D parameter, from the plan's narrowest accumulator format and
``--a2q-x-bound``, penalized in the loss at strength S and projected after
every step, so that carry can never overflow.

``--obs-metrics PATH`` and ``--obs-prometheus PATH`` export the process's
metrics registry (``obs.metrics``) at exit, as JSONL and in Prometheus's
textfile format: the in-graph ticks' controller events (the registry is
kept whenever ``--ingraph-telemetry`` is on, as JAX's launcher keeps it;
the eager tick records none, as in JAX), the kernels' launch counts, the
certification memo and the compile cache.

``--mesh`` (JAX's: ``auto``, ``DxM``, ``PxDxM``) trains over a mesh of
spawned ranks (``run_mesh``): the batch's rows split over the data axes
(``pod`` x ``data``, ``sharding.specs.batch_spec``), the f32 masters and
both AdamW moments stored as JAX's rules split them (FSDP over ``data``,
``model`` where JAX puts it, ``ShardingRules``), each GEMM's output
columns split over the model axis, every GEMM's backward on K-slices over
every rank, so every rank's losses, grad norms, params and moments are
the single device's, bit for bit (``train.loop``), under ``--rounding sr``
too (the SR keys take each block's place in the whole GEMM).  ``auto`` is
the single device on one card.  Ranks that share a card talk over gloo,
ranks with a card each over NCCL.  A model axis must divide the KV heads,
d_ff and the vocab.  ``run_mesh([MeshJob(args, shape, oracle_plan)])``
(no flag, as in JAX) trains the unfused oracle (K2 and K3) over the mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --steps 20 --policy predicted --device cpu \\
      --telemetry-cadence 5
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Callable, NamedTuple

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.policy import AccumulationPolicy, plan_for_model
from repro_torch.data.pipeline import DataConfig, SyntheticLM, with_extras
from repro_torch.dist import LOCAL, Dist
from repro_torch.models.api import get_model, param_count
from repro_torch.serve.scheduler import resolve_device
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.loop import (
    TrainConfig,
    init_train_state,
    make_train_step,
    param_specs,
    run_telemetry_tick,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--policy", choices=["exact", "predicted", "perturbed"],
                    default="exact")
    ap.add_argument("--pp", type=int, default=0,
                    help="precision perturbation (bits) for --policy perturbed")
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--rounding", choices=["rne", "sr"], default="rne",
                    help="inter-chunk carry rounding of the quantized "
                         "GEMMs: round to nearest even (the paper's) or "
                         "seeded stochastic rounding (the below-the-knee "
                         "mode)")
    ap.add_argument("--sr-seed", type=int, default=0,
                    help="seed of --rounding sr (the same seed reproduces "
                         "the run bitwise)")
    ap.add_argument("--a2q-reg", type=float, default=0.0,
                    help="A2Q weight-norm regularizer strength (0 = off): "
                         "the per-output-column l1 caps from the plan's "
                         "narrowest accumulator format are penalized in "
                         "the loss and projected after every step, so the "
                         "reduced carries cannot overflow")
    ap.add_argument("--a2q-x-bound", type=float, default=16.0,
                    help="certified bound on the activation operand's "
                         "magnitude for the --a2q-reg cap")
    ap.add_argument("--loss-scaling", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry-cadence", type=int, default=0,
                    help="steps between swamping-telemetry probes (0 = "
                         "off); the closed-loop controller bumps or trims "
                         "per-GEMM m_acc from the measurements")
    ap.add_argument("--telemetry-log", default="",
                    help="JSONL event-log path (default ./telemetry.jsonl)")
    ap.add_argument("--ingraph-telemetry", action="store_true",
                    help="measure on the true training gradients: the "
                         "cadence tick is the tagged step itself (the same "
                         "numerics, bit for bit)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--crash-at-step", type=int, default=-1,
                    help="fault injection: hard-exit at this step "
                         "(supervisor test)")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the model to this many layers (0 = the "
                         "config's depth)")
    ap.add_argument("--obs-metrics", default="",
                    help="export the metrics registry as JSONL here at "
                         "exit (repro_torch.obs.metrics)")
    ap.add_argument("--obs-prometheus", default="",
                    help="export the registry in Prometheus textfile-"
                         "collector format here at exit")
    ap.add_argument("--mesh", default="auto",
                    help="'auto' (every card as data), 'DxM' or 'PxDxM'")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def obs_registry(args):
    """The process-wide metrics registry when ``--obs-metrics``,
    ``--obs-prometheus`` or ``--ingraph-telemetry`` asks for it (JAX's
    rule), else None."""
    if args.obs_metrics or args.obs_prometheus or args.ingraph_telemetry:
        from repro_torch.obs.metrics import get_registry

        return get_registry()
    return None


def export_obs(args, registry) -> None:
    """Sweep the process's counters into ``registry`` and write the
    exports ``args`` asks for."""
    if registry is None:
        return
    from repro_torch.obs.metrics import collect_process_metrics

    collect_process_metrics(registry)
    if args.obs_metrics:
        registry.export_jsonl(args.obs_metrics)
    if args.obs_prometheus:
        registry.export_prometheus(args.obs_prometheus)


def build_telemetry(args, tc, registry=None, dist: Dist = LOCAL):
    """(controller, in-graph tick runner) for parsed ``args``; both None
    when telemetry is off (cadence 0 or the exact policy), the runner None
    without ``--ingraph-telemetry``; the runner records its events in
    ``registry``.  Under a row-split ``dist`` the tagged rows reduce over
    the batch axes."""
    if args.telemetry_cadence <= 0 or args.policy == "exact":
        if args.ingraph_telemetry:
            raise SystemExit("--ingraph-telemetry needs --telemetry-cadence "
                             "> 0 and a non-exact --policy")
        return None, None
    from repro_torch.obs.ingraph import InGraphTelemetry
    from repro_torch.telemetry.controller import (
        ControllerConfig,
        PrecisionController,
    )

    controller = PrecisionController(
        _policy(args), ControllerConfig(cadence=args.telemetry_cadence),
        log_path=args.telemetry_log or os.path.join(args.ckpt_dir or ".",
                                                    "telemetry.jsonl"))
    ingraph = None
    if args.ingraph_telemetry:
        ingraph = InGraphTelemetry(
            controller, tc, seq_len=args.seq_len,
            global_batch=args.global_batch, registry=registry, dist=dist)
    return controller, ingraph


def _policy(args) -> AccumulationPolicy:
    if args.rounding == "sr" and args.policy == "exact":
        raise SystemExit("--rounding sr needs a non-exact --policy (exact "
                         "mode has no emulated carries to dither)")
    return AccumulationPolicy(
        mode=args.policy, chunk=args.chunk,
        perturbation=args.pp if args.policy == "perturbed" else 0,
        rounding=args.rounding, sr_seed=args.sr_seed)


def model_config(args):
    """The unplanned model config of ``--arch``/``--smoke``, cut to
    ``--n-layers`` when given."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return cfg


def _lead(dist: Dist) -> bool:
    """Whether this process prints and writes files (rank 0 of a mesh)."""
    return dist.mesh is None or dist.mesh.rank == 0


def _save(args, step, state, data, controller, dist: Dist = LOCAL,
          specs=None) -> None:
    """Write the step's checkpoint; prints its bytes on disk and the
    write's wall milliseconds as a ``{"checkpoint": ...}`` line.  Under a
    mesh every rank gathers the whole arrays and rank 0 writes them."""
    if dist.mesh is not None:
        from repro_torch.sharding.specs import tree_specs_map, unshard

        def whole(tree):
            return tree_specs_map(lambda p, sp: unshard(p, sp, dist).cpu(),
                                  tree, specs)

        state = {"params": whole(state["params"]),
                 "opt": {"m": whole(state["opt"]["m"]),
                         "v": whole(state["opt"]["v"]),
                         "step": state["opt"]["step"]},
                 "scaler": state["scaler"]}
        if not _lead(dist):
            return
    meta = {"data": data.state_dict()}
    if controller is not None:
        meta["telemetry_streaks"] = controller.streaks_meta()
    t0 = time.perf_counter()
    path = save_checkpoint(args.ckpt_dir, step, state, meta=meta,
                           precision_schedule=controller.to_meta()
                           if controller else None)
    ms = (time.perf_counter() - t0) * 1e3
    size = sum(f.stat().st_size for f in os.scandir(path))
    print(json.dumps({"checkpoint": {"step": step, "bytes": size,
                                     "save_ms": round(ms, 1)}}), flush=True)


def _restore(args, last, model, state, dist: Dist, specs):
    """(state, meta) of checkpoint ``last``; under a mesh each rank reads
    the whole arrays and keeps its blocks (JAX's elastic restore)."""
    if dist.mesh is None:
        return restore_checkpoint(args.ckpt_dir, last, state)
    from repro_torch.sharding.specs import shard

    whole = whole_shapes(model)
    like = {"params": whole, "opt": {"m": whole, "v": whole,
                                     "step": state["opt"]["step"]},
            "scaler": state["scaler"]}

    def block(path, t):
        # params/... and opt/{m,v}/... split as the params do; the rest
        # (the AdamW step, the scaler) is replicated
        parts = path.split("/")
        if parts[0] == "params":
            keys = parts[1:]
        elif parts[:2] in (["opt", "m"], ["opt", "v"]):
            keys = parts[2:]
        else:
            return t
        sp = specs
        for key in keys:
            sp = sp[key]
        return shard(t, sp, dist.mesh).contiguous().clone()

    device = state["opt"]["step"].device
    return restore_checkpoint(args.ckpt_dir, last, like, device=device,
                              shardings=block)


def resume(args, model, state, data, controller, dist: Dist = LOCAL,
           specs=None):
    """(model, state, first step): from the latest checkpoint in
    ``--ckpt-dir``, if there is one; the controller's schedule and streaks
    restored and the model re-planned under the schedule.  Under a mesh,
    onto this rank's blocks, whatever mesh wrote it."""
    last = latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if last is None:
        return model, state, 0
    t0 = time.perf_counter()
    state, meta = _restore(args, last, model, state, dist, specs)
    ms = (time.perf_counter() - t0) * 1e3
    data.load_state_dict(meta["data"])
    start = int(meta["step"])
    if _lead(dist):
        print(f"resumed from step {start} (restored in {ms:.1f} ms)",
              flush=True)
    schedule = meta.get("precision_schedule")
    if controller is not None:
        controller.restore_streaks(meta.get("telemetry_streaks"))
        if schedule:
            from repro_torch.telemetry.controller import apply_schedule

            controller.restore_meta(schedule)
            model = get_model(apply_schedule(
                model.cfg, _policy(args), controller.schedule(),
                seq_len=args.seq_len, global_batch=args.global_batch))
            if _lead(dist):
                print(f"restored precision schedule: {schedule}", flush=True)
    return model, state, start


def a2q_config(args, cfg, show: bool = True) -> O.A2QConfig | None:
    """``--a2q-reg``'s constraint for the planned ``cfg``: the cap from
    the narrowest accumulator format of the plan (a certificate against it
    covers every wider one), printed when ``show``; None when off."""
    if args.a2q_reg <= 0:
        return None
    from repro_torch.telemetry.controller import PLAN_FIELDS, ROLES

    precs = [p for f in PLAN_FIELDS
             for q in [getattr(cfg.quant, f, None)] if q is not None
             for r in ROLES for p in [getattr(q, r)] if p is not None]
    if not precs:
        raise SystemExit("--a2q-reg needs a non-exact --policy (nothing to "
                         "certify in exact mode)")
    narrow = min(precs, key=lambda p: (p.e_acc, p.m_acc))
    a2q = O.A2QConfig(e_acc=narrow.e_acc, m_acc=narrow.m_acc,
                      x_bound=args.a2q_x_bound, strength=args.a2q_reg,
                      project=True)
    if show:
        print(f"a2q: cap per-column l1 at {O.a2q_l1_cap(a2q):.4g} (acc "
              f"({narrow.e_acc},{narrow.m_acc}), x_bound "
              f"{args.a2q_x_bound})", flush=True)
    return a2q


def oracle_plan(cfg):
    """``cfg`` with ``fused=False`` in every QDotConfig of its plan: the
    unfused oracle (K2 and K3) in place of G, E and B (``train``'s and
    ``MeshJob``'s ``plan``; no flag, as in JAX)."""
    from repro_torch.telemetry.controller import PLAN_FIELDS

    fields = {name: dataclasses.replace(getattr(cfg.quant, name),
                                        fused=False)
              for name in PLAN_FIELDS if getattr(cfg.quant, name) is not None}
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant,
                                                              **fields))


def build(args, dist: Dist = LOCAL, device=None, plan=None):
    """(model, train config, state, data, device) for parsed ``args``;
    under a mesh ``dist`` the state holds this rank's blocks on ``device``
    and the data stream draws the global batch (JAX's single-process
    ``SyntheticLM``; the step takes the rank's rows).  ``plan`` (a
    function of the planned model config, e.g. ``oracle_plan``) rewrites
    the plan."""
    device = resolve_device(args.device) if device is None else device
    cfg = model_config(args)
    cfg = plan_for_model(cfg, seq_len=args.seq_len,
                         global_batch=args.global_batch, policy=_policy(args))
    if plan is not None:
        cfg = plan(cfg)
    model = get_model(cfg)
    tc = TrainConfig(
        opt=O.OptConfig(lr=args.lr, warmup_steps=args.warmup,
                        total_steps=args.steps),
        microbatches=args.microbatches, use_loss_scaling=args.loss_scaling,
        scaler=O.LossScaleConfig(init_scale=1000.0, dynamic=True),
        a2q=a2q_config(args, cfg, show=_lead(dist)))
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = init_train_state(model, gen, device, tc, dist)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  global_batch=args.global_batch,
                                  seed=args.seed), device=device)
    return model, tc, state, data, device


def build_mesh(spec: str, device: torch.device) -> dict | None:
    """JAX's ``--mesh``: ``auto`` puts every card on the data axis, ``(n,
    1)`` over (data, model), and is the single device on one card or the
    CPU; ``DxM`` is (data, model), ``PxDxM`` (pod, data, model).  Returns
    the axis sizes, or None for one rank."""
    if spec == "auto":
        n = torch.cuda.device_count() if device.type == "cuda" else 1
        shape = {"data": n, "model": 1}
    else:
        dims = [int(x) for x in spec.lower().split("x")]
        names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
            len(dims))
        if names is None or min(dims) < 1:
            raise SystemExit(f"--mesh {spec!r}: want auto, DxM or PxDxM")
        shape = dict(zip(names, dims))
    if math.prod(shape.values()) == 1:
        return None
    return shape


def main(argv=None) -> dict:
    args = parse_args(argv)
    shape = build_mesh(args.mesh, torch.device(args.device))
    if shape is not None:
        return run_mesh([MeshJob(args, shape)])[0][0]
    return train(args)


def launch_counts() -> dict:
    """The training kernels' launch counters now (each wrapper counts where
    it launches its kernel): G, E, K8, B, B's carry entry and K9, their SR
    instantiations apart, and the oracle's K2 and K3."""
    from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair as b
    from repro_torch.kernels.fused import qmatmul_fused as f
    from repro_torch.kernels.qmatmul import qmatmul
    from repro_torch.kernels.quantize import quantize

    return {"qmatmul_fused": f.launches,
            "qmatmul_fused(return_quantized)": f.emitq_launches,
            "qmatmul_fused(collect_stats)": f.stats_launches,
            "qmatmul_bwd_pair": b.launches,
            "qmatmul_bwd_pair(dx_carry)": b.carry_launches,
            "qmatmul_bwd_pair(collect_stats)": b.stats_launches,
            "qmatmul_fused(rounding=sr)": f.sr_launches,
            "qmatmul_fused(return_quantized, rounding=sr)":
                f.sr_emitq_launches,
            "qmatmul_fused(collect_stats, rounding=sr)": f.sr_stats_launches,
            "qmatmul_bwd_pair(rounding=sr)": b.sr_launches,
            "qmatmul_bwd_pair(collect_stats, rounding=sr)":
                b.sr_stats_launches,
            "quantize": quantize.launches, "qmatmul": qmatmul.launches}


def train(args, dist: Dist = LOCAL, device=None, finish=None,
          plan=None) -> dict:
    """The training run of parsed ``args`` on this process (one rank of a
    mesh under ``dist``; ``plan`` as ``build``'s).  Returns the final loss,
    the logged records, the schedule, the host seconds of each logged step
    (the logging reads the loss, so each holds its step's device work), the
    kernels' launches over the run and whatever ``finish(state, model,
    dist)`` returns (a dict; a picklable function under ``run_mesh``), read
    from the final state this process holds."""
    lead = _lead(dist)
    launches0 = launch_counts()
    model, tc, state, data, device = build(args, dist, device, plan)
    specs = param_specs(model, dist)
    if lead:
        n = param_count(whole_shapes(model)) / 1e6
        print(f"arch={model.cfg.name} params={n:.1f}M policy={args.policy} "
              f"pp={args.pp} rounding={args.rounding} device={device}"
              + (f" mesh={dist.mesh.describe()}" if dist.mesh else ""),
              flush=True)
    registry = obs_registry(args) if lead else None
    if dist.mesh is not None and not lead:
        # one event log: rank 0's (every rank's controller decides alike)
        args = argparse.Namespace(**{**vars(args),
                                     "telemetry_log": os.devnull})
    controller, ingraph = build_telemetry(args, tc, registry, dist)
    model, state, start = resume(args, model, state, data, controller, dist,
                                 specs)
    step_fn = make_train_step(model, tc, dist)
    metrics_f = open(args.metrics_out, "a") if (args.metrics_out and
                                                lead) else None
    t0 = time.time()
    last_loss = float("nan")
    records, step_seconds = [], []
    patch_embeds = None     # the VLM stub's, drawn once: JAX's fixed key
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        if step == args.crash_at_step and start == 0:
            # one-shot fault injection: only a fresh run dies here; the
            # supervisor's restart resumes from the latest checkpoint
            print(f"FAULT INJECTION: dying at step {step}", flush=True)
            os._exit(42)
        batch = next(data)
        if model.cfg.vision_tokens:
            if patch_embeds is None:
                patch_embeds = with_extras(batch, model.cfg)["patch_embeds"]
            batch = {**batch, "patch_embeds": patch_embeds}
        events, new_model = [], None
        if ingraph is not None and ingraph.due(step + 1):
            # the tagged step takes the normal step's place: the same
            # numerics, plus the true-gradient windows for the controller
            state, m, events, new_model = ingraph.tick(model, state, batch,
                                                       step=step + 1)
        else:
            state, m = step_fn(state, batch)
            if controller is not None and controller.due(step + 1):
                gen = torch.Generator(device=device)
                gen.manual_seed(args.seed * 1000003 + step + 1)
                events, new_model = run_telemetry_tick(
                    controller, model, state, batch, step=step + 1, gen=gen,
                    seq_len=args.seq_len, global_batch=args.global_batch,
                    dist=dist)
        for e in events:
            if e["event"] != "ok" and lead:
                print(json.dumps({"telemetry": e}), flush=True)
        if new_model is not None:
            # the controller changed some m_acc: train on under the new plan
            model = new_model
            step_fn = make_train_step(model, tc, dist)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            last_loss = float(m["loss"])
            rec = {"step": step + 1, "loss": last_loss,
                   "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                   "skipped": float(m["skipped"]),
                   "loss_scale": float(m["loss_scale"]),
                   "elapsed_s": round(time.time() - t0, 1)}
            if "aux" in m:      # a MoE config's load-balance term
                rec["aux"] = float(m["aux"])
            records.append(rec)
            step_seconds.append(time.perf_counter() - t_step)
            if lead:
                print(json.dumps(rec), flush=True)
            if metrics_f:
                metrics_f.write(json.dumps(rec) + "\n")
                metrics_f.flush()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _save(args, step + 1, state, data, controller, dist, specs)
    # the loop saved the last step already when it fell on the cadence
    saved_last = start >= args.steps or args.steps % args.ckpt_every == 0
    if args.ckpt_dir and not saved_last:
        _save(args, args.steps, state, data, controller, dist, specs)
    if metrics_f:
        metrics_f.close()
    export_obs(args, registry)
    out = {"final_loss": last_loss, "steps": args.steps, "records": records,
           "schedule": controller.to_meta() if controller else {},
           "step_seconds": step_seconds}
    if finish is not None:
        out.update(finish(state, model, dist))
    out["launches"] = {k: v - launches0[k]
                       for k, v in launch_counts().items()}
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def whole_shapes(model):
    """The model's whole params as meta tensors (their shapes)."""
    return model.init_params(torch.Generator(), "meta")


class MeshJob(NamedTuple):
    """One job of ``run_mesh``: parsed ``args``, the mesh ``shape`` (axis ->
    size) it trains over, and its ``plan`` (picklable, as ``build``'s)."""

    args: argparse.Namespace
    shape: dict
    plan: Callable | None = None


def _train_rank(rank: int, size: int, init_method: str, jobs: list,
                batch_axes: list, device: str, backend: str,
                finish) -> list[dict]:
    from repro_torch.dist import init_meshes, rank_device

    dev = rank_device(rank, torch.device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)   # the ranks share the host's cores
    meshes = list(dict.fromkeys(
        (_key(j.shape), b) for j, b in zip(jobs, batch_axes)))
    dists = dict(zip(meshes, init_meshes(
        rank, [(dict(k), b) for k, b in meshes], init_method, backend,
        fsdp_axis="data", device=dev)))
    outs = []
    for job, baxes in zip(jobs, batch_axes):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = train(job.args, dists[_key(job.shape), baxes], dev, finish,
                    job.plan)
        out.update(rank=rank, seconds=time.perf_counter() - t0)
        outs.append(out)
    return outs


def _key(shape: dict) -> tuple:
    return tuple(shape.items())


def run_mesh(jobs: list[MeshJob], *, finish=None,
             timeout_s: float = 1800.0) -> list:
    """``train`` for every job of the list ``jobs`` (``MeshJob``s, run in
    order; their meshes all of one size), one spawned rank a mesh point,
    the ranks started once for all.  Each rank's list of results, in rank
    order.  The kernels are built here first, so the ranks only load them;
    the backend follows ``dist.serve_backend``'s rule (printed): NCCL when
    every rank has a card of its own, gloo when ranks share one and on the
    CPU.  A model axis that does not divide the KV heads, d_ff or the
    vocab raises here, before any rank starts."""
    from repro_torch.dist import serve_backend, spawn
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.specs import batch_spec
    from repro_torch.train.loop import check_model_axis

    jobs = [MeshJob(j.args, dict(j.shape), j.plan) for j in jobs]
    for j in jobs:
        check_model_axis(model_config(j.args), j.shape.get("model", 1))
    dev = resolve_device(jobs[0].args.device)
    meshes = [Mesh(j.shape) for j in jobs]
    baxes = [batch_spec(j.args.global_batch, m) for j, m in zip(jobs, meshes)]
    backend, rule = serve_backend(dev, meshes[0].size)
    for m, b in {(_key(m.shape), b): (m, b)
                 for m, b in zip(meshes, baxes)}.values():
        cols = tuple(a for a in m.shape if a not in b and m.shape[a] > 1)
        print(f"train mesh: {m.describe()} ({m.size} ranks), batch over "
              f"{b or 'no axis'}, FSDP over data, GEMM columns over "
              f"{cols or 'no axis'}; backend {rule}", flush=True)
    for j, m, b in zip(jobs, meshes, baxes):
        a = j.args
        if a.global_batch // a.microbatches % m.axis_size(b):
            raise SystemExit(f"a microbatch of {a.global_batch} // "
                             f"{a.microbatches} rows does not split over "
                             f"the batch axes {b}")
    if dev.type == "cuda":
        from repro_torch.kernels import build as kernel_build

        kernel_build.build_all()
    outs = spawn(_train_rank, meshes[0].size,
                 (jobs, baxes, str(dev), backend, finish),
                 timeout_s=timeout_s)
    for per_rank in outs:
        for o in per_rank:
            if "peak_bytes" in o:
                print(f"rank {o['rank']}: peak {o['peak_bytes'] / 2**30:.2f} "
                      f"GiB allocated, {o['seconds']:.1f} s", flush=True)
    return outs


if __name__ == "__main__":
    main()
