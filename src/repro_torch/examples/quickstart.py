"""Quickstart: the paper's analysis in five minutes.

1. Evaluate the VRR for an accumulation you care about.
2. Solve the minimal accumulator mantissa width (the paper's Table-1 move).
3. Train a small model with the solver-assigned reduced-precision
   accumulation and watch it converge like the exact baseline.

Counterpart of the JAX package's ``examples/quickstart.py``: the same
steps and output lines; the training runs through the port's train step,
the hand-written chunked-carry GEMM kernels on ``cuda`` (their plain
versions with ``--device cpu``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import torch

from repro_torch.core.precision import min_m_acc
from repro_torch.core.vrr import log_variance_lost, vrr, vrr_chunked


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # -----------------------------------------------------------------------
    # 1. VRR: will a (1,6,9) 16-bit accumulator survive a 1M-term GRAD sum?
    # -----------------------------------------------------------------------
    n = 1_048_576          # GRAD accumulation length at train_4k (B*T tokens)
    m_p = 5                # (1,5,2) x (1,5,2) products carry 5 mantissa bits

    for m_acc in (9, 12, 15):
        r = vrr(m_acc, m_p, n)
        v = log_variance_lost(r, n)
        verdict = "OK" if v < 3.912 else "UNSUITABLE"
        print(f"m_acc={m_acc:2d}: VRR={r:.6f}  log v(n)={v:9.2f}  -> {verdict}")

    # -----------------------------------------------------------------------
    # 2. Minimal precision, normal vs chunked accumulation (Corollary 1)
    # -----------------------------------------------------------------------
    normal = min_m_acc(n, m_p)
    chunked = min_m_acc(n, m_p, chunked=True, chunk=64)
    print(f"\nminimal m_acc for n={n}: normal={normal}b, chunked-64={chunked}b "
          f"(chunking saves {normal - chunked} bits)")
    print(f"chunked VRR at the assignment: "
          f"{vrr_chunked(chunked, m_p, 64, n // 64):.6f}")

    # -----------------------------------------------------------------------
    # 3. Train with the assignment (reduced-precision accumulation emulated
    #    by the chunked-carry GEMM kernels)
    # -----------------------------------------------------------------------
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.api import get_model
    from repro_torch.serve.scheduler import resolve_device
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_train_step)

    device = resolve_device(args.device)
    cfg = get_smoke_config("qwen2-1.5b")
    cfg = plan_for_model(cfg, seq_len=64, global_batch=8,
                         policy=AccumulationPolicy(mode="predicted"))
    print("\nassigned plan (mlp.up):", cfg.quant.mlp_up)

    model = get_model(cfg)
    tc = TrainConfig()
    state = init_train_state(model, torch.Generator(device=device).manual_seed(0),
                             device, tc)
    step = make_train_step(model, tc)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=8), device=device)
    losses = []
    for i in range(args.steps):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
        if (i + 1) % 10 == 0:
            print(f"step {i + 1:3d}  loss {losses[-1]:.3f}")
    print("\nreduced-precision-accumulation training converges; see "
          "repro_torch/paper/fig6_convergence.py for the PP sweep.")
    return losses


if __name__ == "__main__":
    main()
