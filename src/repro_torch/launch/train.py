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
re-planned model goes on training.  Not ported: stochastic rounding, A2Q,
the metrics registry, meshes and checkpoints (so no ``precision_schedule``
in a checkpoint's meta yet).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --steps 20 --policy predicted --device cpu \\
      --telemetry-cadence 5
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.policy import AccumulationPolicy, plan_for_model
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.api import get_model, param_count
from repro_torch.serve.scheduler import resolve_device
from repro_torch.train import optimizer as O
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
        log_path=args.telemetry_log or "telemetry.jsonl")
    ingraph = None
    if args.ingraph_telemetry:
        ingraph = InGraphTelemetry(controller, tc, seq_len=args.seq_len,
                                   global_batch=args.global_batch)
    return controller, ingraph


def _policy(args) -> AccumulationPolicy:
    return AccumulationPolicy(
        mode=args.policy, chunk=args.chunk,
        perturbation=args.pp if args.policy == "perturbed" else 0)


def build(args):
    """(model, train config, state, data, device) for parsed ``args``."""
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
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
          f"pp={args.pp} device={device}", flush=True)
    controller, ingraph = build_telemetry(args, tc)
    step_fn = make_train_step(model, tc)
    metrics_f = open(args.metrics_out, "a") if args.metrics_out else None
    t0 = time.time()
    last_loss = float("nan")
    for step in range(args.steps):
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
    if metrics_f:
        metrics_f.close()
    return {"final_loss": last_loss, "steps": args.steps,
            "schedule": controller.to_meta() if controller else {}}


if __name__ == "__main__":
    main()
