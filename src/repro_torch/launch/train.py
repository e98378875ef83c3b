"""Training driver: AdamW steps of a dense LM under an accumulation plan.

Counterpart of ``repro.launch.train`` on one device: the synthetic LM
stream, the plan's quantized GEMMs through the hand-written Hopper kernels
(E forward, B backward, G for the unquantized lm_head), a bf16 compute copy
of the parameters once per step, microbatches, optional dynamic loss
scaling, and one JSON record per logged step.  Runs on CUDA unless
``--device cpu`` (the plain PyTorch versions; small configs only).  Not
ported: stochastic rounding, A2Q, telemetry, observability, meshes and
checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --steps 20 --policy predicted --device cpu
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
from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step


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
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args):
    """(model, train config, state, data, device) for parsed ``args``."""
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    policy = AccumulationPolicy(
        mode=args.policy, chunk=args.chunk,
        perturbation=args.pp if args.policy == "perturbed" else 0)
    cfg = plan_for_model(cfg, seq_len=args.seq_len,
                         global_batch=args.global_batch, policy=policy)
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
    step_fn = make_train_step(model, tc)
    metrics_f = open(args.metrics_out, "a") if args.metrics_out else None
    t0 = time.time()
    last_loss = float("nan")
    for step in range(args.steps):
        state, m = step_fn(state, next(data))
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
    return {"final_loss": last_loss, "steps": args.steps}


if __name__ == "__main__":
    main()
