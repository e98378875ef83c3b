"""Restart-on-failure around the trainer.

Counterpart of ``repro.launch.supervisor``: a thin supervisor re-runs the
training command when it dies (a fault, a preemption, a watchdog).  The
checkpoints are atomic and carry the data cursor, so every restart resumes
where the latest checkpoint left off.

  PYTHONPATH=src python -m repro_torch.launch.supervisor --max-restarts 5 -- \\
      python -m repro_torch.launch.train --smoke --steps 20 --device cpu \\
      --ckpt-dir build/run1 --ckpt-every 10 [--crash-at-step 12]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

__all__ = ["supervise"]


def supervise(cmd: list[str], *, max_restarts: int = 10,
              backoff_s: float = 1.0) -> int:
    """Run ``cmd`` until it exits 0 or the restart budget is spent; returns
    the last exit code.  The budget guards against crash loops (a broken
    config), not against transient faults."""
    restarts = 0
    while True:
        t0 = time.time()
        proc = subprocess.run(cmd)
        if proc.returncode == 0:
            if restarts:
                print(f"[supervisor] job completed after {restarts} "
                      "restart(s)", flush=True)
            return 0
        restarts += 1
        if restarts > max_restarts:
            print(f"[supervisor] giving up after {max_restarts} restarts "
                  f"(last exit code {proc.returncode})", flush=True)
            return proc.returncode
        print(f"[supervisor] worker died (exit {proc.returncode}, uptime "
              f"{time.time() - t0:.1f}s) - restart {restarts}/{max_restarts} "
              f"in {backoff_s:.1f}s", flush=True)
        time.sleep(backoff_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--backoff-s", type=float, default=1.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- followed by the training command")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (use: supervisor [opts] -- cmd ...)")
    return supervise(cmd, max_restarts=args.max_restarts,
                     backoff_s=args.backoff_s)


if __name__ == "__main__":
    sys.exit(main())
