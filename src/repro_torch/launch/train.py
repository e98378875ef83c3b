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
Not ported: A2Q, the metrics registry and meshes.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --steps 20 --policy predicted --device cpu \\
      --telemetry-cadence 5
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.policy import AccumulationPolicy, plan_for_model
from repro_torch.data.pipeline import DataConfig, SyntheticLM
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
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_telemetry(args, tc):
    """(controller, in-graph tick runner) for parsed ``args``; both None
    when telemetry is off (cadence 0 or the exact policy), the runner None
    without ``--ingraph-telemetry``."""
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
        ingraph = InGraphTelemetry(controller, tc, seq_len=args.seq_len,
                                   global_batch=args.global_batch)
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


def _save(args, step, state, data, controller) -> None:
    """Write the step's checkpoint; prints its bytes on disk and the
    write's wall milliseconds as a ``{"checkpoint": ...}`` line."""
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


def resume(args, model, state, data, controller):
    """(model, state, first step): from the latest checkpoint in
    ``--ckpt-dir``, if there is one; the controller's schedule and streaks
    restored and the model re-planned under the schedule."""
    last = latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if last is None:
        return model, state, 0
    t0 = time.perf_counter()
    state, meta = restore_checkpoint(args.ckpt_dir, last, state)
    ms = (time.perf_counter() - t0) * 1e3
    data.load_state_dict(meta["data"])
    start = int(meta["step"])
    print(f"resumed from step {start} (restored in {ms:.1f} ms)", flush=True)
    schedule = meta.get("precision_schedule")
    if controller is not None:
        controller.restore_streaks(meta.get("telemetry_streaks"))
        if schedule:
            from repro_torch.telemetry.controller import apply_schedule

            controller.restore_meta(schedule)
            model = get_model(apply_schedule(
                model.cfg, _policy(args), controller.schedule(),
                seq_len=args.seq_len, global_batch=args.global_batch))
            print(f"restored precision schedule: {schedule}", flush=True)
    return model, state, start


def build(args):
    """(model, train config, state, data, device) for parsed ``args``."""
    device = resolve_device(args.device)
    cfg = model_config(args)
    cfg = plan_for_model(cfg, seq_len=args.seq_len,
                         global_batch=args.global_batch, policy=_policy(args))
    model = get_model(cfg)
    tc = TrainConfig(
        opt=O.OptConfig(lr=args.lr, warmup_steps=args.warmup,
                        total_steps=args.steps),
        microbatches=args.microbatches, use_loss_scaling=args.loss_scaling,
        scaler=O.LossScaleConfig(init_scale=1000.0, dynamic=True))
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = init_train_state(model, gen, device, tc)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  global_batch=args.global_batch,
                                  seed=args.seed), device=device)
    return model, tc, state, data, device


def main(argv=None) -> dict:
    args = parse_args(argv)
    model, tc, state, data, device = build(args)
    print(f"arch={model.cfg.name} params="
          f"{param_count(state['params']) / 1e6:.1f}M policy={args.policy} "
          f"pp={args.pp} rounding={args.rounding} device={device}",
          flush=True)
    controller, ingraph = build_telemetry(args, tc)
    model, state, start = resume(args, model, state, data, controller)
    step_fn = make_train_step(model, tc)
    metrics_f = open(args.metrics_out, "a") if args.metrics_out else None
    t0 = time.time()
    last_loss = float("nan")
    for step in range(start, args.steps):
        if step == args.crash_at_step and start == 0:
            # one-shot fault injection: only a fresh run dies here; the
            # supervisor's restart resumes from the latest checkpoint
            print(f"FAULT INJECTION: dying at step {step}", flush=True)
            os._exit(42)
        batch = next(data)
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
                    seq_len=args.seq_len, global_batch=args.global_batch)
        for e in events:
            if e["event"] != "ok":
                print(json.dumps({"telemetry": e}), flush=True)
        if new_model is not None:
            # the controller changed some m_acc: train on under the new plan
            model = new_model
            step_fn = make_train_step(model, tc)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            last_loss = float(m["loss"])
            rec = {"step": step + 1, "loss": last_loss,
                   "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                   "skipped": float(m["skipped"]),
                   "loss_scale": float(m["loss_scale"]),
                   "elapsed_s": round(time.time() - t0, 1)}
            print(json.dumps(rec), flush=True)
            if metrics_f:
                metrics_f.write(json.dumps(rec) + "\n")
                metrics_f.flush()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _save(args, step + 1, state, data, controller)
    if args.ckpt_dir and latest_step(args.ckpt_dir) != args.steps:
        _save(args, args.steps, state, data, controller)
    if metrics_f:
        metrics_f.close()
    return {"final_loss": last_loss, "steps": args.steps,
            "schedule": controller.to_meta() if controller else {}}


if __name__ == "__main__":
    main()
