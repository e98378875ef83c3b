"""Paper-style precision assignment for a ported architecture x shape.

Prints the Table-1 analogue for an LLM: per-GEMM (FWD / BWD / GRAD)
minimal accumulator mantissa widths, normal and chunked, from the VRR
solver, the hardware-design artifact the paper's method produces.

Counterpart of the JAX package's ``examples/precision_assignment.py``, with
the same output lines.  Its default architecture is qwen2-1.5b, the one
the port's registry holds (the JAX example's default, qwen3-8b, is not
ported).  Host arithmetic only.

  PYTHONPATH=src python -m repro_torch.examples.precision_assignment \\
      [--arch qwen2-1.5b] [--shape train_4k] [--nzr 1.0]
"""

import argparse

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.acc_lengths import transformer_specs
from repro_torch.core.precision import assign_network


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--nzr", type=float, default=1.0,
                    help="non-zero ratio estimate for GRAD operands")
    ap.add_argument("--m-p", type=int, default=5)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shp = SHAPES[args.shape]
    specs = transformer_specs(
        d_model=cfg.d_model,
        d_ff=cfg.d_ff or cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim,
        seq_len=shp.seq_len,
        global_batch=shp.global_batch,
        vocab_size=cfg.vocab_size,
        moe_experts=0,      # the port's registry holds dense models only
        moe_top_k=0,
        nzr=args.nzr,
    )
    a = assign_network(cfg.name, specs, m_p=args.m_p)

    print(f"# {cfg.name} @ {shp.name} (seq={shp.seq_len}, "
          f"batch={shp.global_batch}, m_p={args.m_p}, nzr={args.nzr})")
    print(f"{'GEMM':14s} {'role':5s} {'length n':>12s} {'normal':>7s} "
          f"{'chunked':>8s}")
    for s in specs:
        nb, cb = a.get(s.layer, s.role)
        print(f"{s.layer:14s} {s.role:5s} {s.n:12,d} {nb:6d}b {cb:7d}b")

    grads = [a.get(s.layer, "GRAD")[0] for s in specs if s.role == "GRAD"]
    fwds = [a.get(s.layer, "FWD")[0] for s in specs if s.role == "FWD"]
    print(f"\nmax GRAD requirement: {max(grads)}b mantissa "
          f"(+1 sign +6 exp = {max(grads) + 7}-bit accumulator)")
    print(f"max FWD  requirement: {max(fwds)}b mantissa")
    print("=> a 32-bit accumulator is "
          f"{32 - (max(grads) + 7)} bits wider than this workload needs.")


if __name__ == "__main__":
    main()
