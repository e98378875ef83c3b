"""End-to-end run: exact baseline vs predicted (PP=0) vs perturbed (PP<0)
reduced-accumulation training, the paper's Figure 6 experiment scaled to
one device, through the training launcher (``repro_torch.launch.train``).
Then a fault-injection leg: the launcher crashes mid-run, the supervisor
(``repro_torch.launch.supervisor``) restarts it, and it resumes from its
checkpoint and finishes.

Counterpart of the JAX package's ``examples/train_lowprec.py``: the same
defaults and output lines.  The checkpoint cadence of the supervisor leg
is ``min(20, steps // 4)`` (20 at the default 80 steps, as in JAX), so a
short run has a checkpoint before its crash.

  PYTHONPATH=src python -m repro_torch.examples.train_lowprec [--device cpu]
  Larger:  ... --steps 300
"""

import argparse
import shutil
import subprocess
import sys
import tempfile

from repro_torch.launch import train as T


def run(policy, pp, args, extra=None):
    argv = [
        "--arch", args.arch, "--smoke",
        "--steps", str(args.steps),
        "--global-batch", str(args.batch),
        "--seq-len", str(args.seq),
        "--policy", policy, "--pp", str(pp),
        "--lr", "3e-3", "--log-every", str(max(args.steps // 5, 1)),
        "--device", args.device,
    ] + (extra or [])
    print(f"\n=== policy={policy} pp={pp} ===", flush=True)
    return T.main(argv)["final_loss"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--skip-supervisor", action="store_true")
    args = ap.parse_args(argv)

    results = {
        "exact": run("exact", 0, args),
        "predicted (PP=0)": run("predicted", 0, args),
        "perturbed (PP=-2)": run("perturbed", -2, args),
        "perturbed (PP=-4)": run("perturbed", -4, args),
    }

    print("\n================ summary ================")
    base = results["exact"]
    for k, v in results.items():
        print(f"{k:18s} final_loss={v:.4f}  (vs exact {v - base:+.4f})")
    print("expected: PP=0 tracks exact; larger perturbations degrade "
          "(paper Fig. 6d).")

    rc = 0
    if not args.skip_supervisor:
        # fault tolerance: crash mid-run, the supervisor restarts, the run
        # resumes from its checkpoint and finishes
        d = tempfile.mkdtemp(prefix="lowprec_ckpt_")
        try:
            cmd = [sys.executable, "-m", "repro_torch.launch.train",
                   "--arch", args.arch, "--smoke",
                   "--steps", str(args.steps),
                   "--global-batch", str(args.batch),
                   "--seq-len", str(args.seq),
                   "--device", args.device,
                   "--ckpt-dir", d,
                   "--ckpt-every", str(min(20, max(args.steps // 4, 1))),
                   "--crash-at-step", str(args.steps // 2),
                   "--log-every", str(max(args.steps // 4, 1))]
            print("\n=== fault-injection + supervisor restart ===", flush=True)
            rc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.supervisor",
                 "--max-restarts", "2", "--"] + cmd).returncode
            print("supervisor exit:", rc, "(0 = resumed and completed)")
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return results, rc


if __name__ == "__main__":
    sys.exit(main()[1])
