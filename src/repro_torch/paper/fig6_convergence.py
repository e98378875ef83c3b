"""Paper Figure 6: convergence under predicted precision (PP=0) and
perturbed precision (PP<0), against the exact-accumulation baseline, at
reduced scale (the smoke config, synthetic LM data).

The paper's claim structure, reproduced on loss:
  * PP =  0 : converges within noise of the exact baseline
  * PP <  0 : visibly degraded convergence, worsening with |PP|

Counterpart of the JAX package's ``benchmarks/fig6_convergence.py``: the
same defaults, runs and output lines, training through the port's train
step (the hand-written kernels on ``cuda``, their plain versions with
``--device cpu``).  The weights come from a ``torch.Generator`` seeded
with ``seed``, so the curves are the port's own, not the JAX package's;
the data stream is JAX's (``repro_torch.data.pipeline``).  JAX's
``autotune`` argument has no counterpart: the port's kernels pick their
schedules from the shapes (ROADMAP [serve-rest] decides the autotuner's
fate).

  PYTHONPATH=src python -m repro_torch.paper.fig6_convergence [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import AccumulationPolicy, plan_for_model
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.api import get_model
from repro_torch.serve.scheduler import resolve_device
from repro_torch.train import optimizer as O
from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step


def train_once(arch: str, policy_mode: str, pp: int, *, steps: int,
               seq: int = 64, batch: int = 8, seed: int = 0,
               device="cuda") -> list[float]:
    device = resolve_device(device)
    cfg = get_smoke_config(arch)
    pol = AccumulationPolicy(
        mode=policy_mode, perturbation=pp if policy_mode == "perturbed" else 0)
    cfg = plan_for_model(cfg, seq_len=seq, global_batch=batch, policy=pol)
    model = get_model(cfg)
    tc = TrainConfig(opt=O.OptConfig(lr=3e-3, warmup_steps=10,
                                     total_steps=steps))
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(model, gen, device, tc)
    step = make_train_step(model, tc)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed, noise=0.02),
                       device=device)
    losses = []
    for _ in range(steps):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    return losses


def run(csv=False, steps: int = 60, arch: str = "qwen2-1.5b",
        device="cuda"):
    runs = {
        "exact": ("exact", 0),
        "PP= 0": ("predicted", 0),
        "PP=-2": ("perturbed", -2),
        "PP=-4": ("perturbed", -4),
    }
    print(f"### Fig 6 analogue: {arch} smoke, {steps} steps, synthetic LM")
    final = {}
    for name, (mode, pp) in runs.items():
        losses = train_once(arch, mode, pp, steps=steps, device=device)
        tail = float(np.mean(losses[-10:]))
        final[name] = tail
        marks = " ".join(f"{losses[i]:.2f}" for i in
                         range(steps // 6, steps, steps // 6))
        print(f"{name:6s} tail-loss {tail:.4f}   curve: {marks}")
    base = final["exact"]
    print("\ndegradation vs exact baseline (paper Fig. 6d analogue):")
    for name, v in final.items():
        print(f"  {name:6s} {v - base:+.4f}")
    ok0 = abs(final["PP= 0"] - base)
    okm = final["PP=-4"] - base
    print(f"\nPP=0 within noise: |d|={ok0:.4f}; PP=-4 degraded by {okm:+.4f} "
          f"=> predictions {'VALID & TIGHT' if okm > max(3 * ok0, 0.05) else 'inconclusive at this scale'}")
    return {"pp0_delta": ok0, "pp-4_delta": okm, "tails": final}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(steps=args.steps, arch=args.arch, device=args.device)


if __name__ == "__main__":
    main()
