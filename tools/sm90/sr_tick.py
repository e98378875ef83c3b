"""The eager telemetry tick of the train cell under ``--rounding sr`` (or
``rne``): qwen2-1.5b at full width and depth through the training
launcher's set-up with ``chip_smoke.py``'s ``[train] sr`` arguments
(``--sr-seed 7 --policy perturbed --pp -2``), one training step, then
``TICKS`` ticks on its state, each timed by the host clock between two
synchronisations, with the tick's launches by kernel.  Takes the checkout
at ROOT, so that two trees compare in one command on a machine with the
card:

  for r in build/parent . . build/parent; do python tools/sm90/sr_tick.py $r; done
  python tools/sm90/sr_tick.py . rne
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

root = str(Path(sys.argv[1]).resolve())
rounding = sys.argv[2] if len(sys.argv) > 2 else "sr"
sys.path[:0] = [root + "/src", root]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

TICKS = 4

# every launch counter a wrapper of either tree may carry
COUNTERS = [("G", "qmatmul_fused", "launches"),
            ("G sr", "qmatmul_fused", "sr_launches"),
            ("E", "qmatmul_fused", "emitq_launches"),
            ("E sr", "qmatmul_fused", "sr_emitq_launches"),
            ("K8", "qmatmul_fused", "stats_launches"),
            ("K8 sr", "qmatmul_fused", "sr_stats_launches")]


def main() -> None:
    from repro_torch.kernels import fused
    from repro_torch.launch.train import build, build_telemetry
    from repro_torch.train.loop import make_train_step, run_telemetry_tick

    args = cs._train_args("--telemetry-cadence", "1", "--rounding", rounding,
                          "--sr-seed", str(cs.TRAIN_SR_SEED), "--policy",
                          "perturbed", "--pp", "-2")
    model, tc, state, data, _ = build(args)
    controller, _ = build_telemetry(args, tc)
    batch = next(data)
    state, _ = make_train_step(model, tc)(state, batch)
    counters = [(name, getattr(fused, fn), attr) for name, fn, attr in COUNTERS
                if hasattr(getattr(fused, fn), attr)]
    ms, used = [], {}
    for i in range(TICKS + 1):
        for _, fn, attr in counters:
            setattr(fn, attr, 0)
        gen = torch.Generator(device=args.device).manual_seed(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_telemetry_tick(controller, model, state, batch, step=1, gen=gen,
                           seq_len=args.seq_len,
                           global_batch=args.global_batch)
        torch.cuda.synchronize()
        if i:   # the first tick warms up
            ms.append((time.perf_counter() - t0) * 1e3)
        used = {name: getattr(fn, attr) for name, fn, attr in counters
                if getattr(fn, attr)}
    print(f"sr_tick {root} {rounding}: median {np.median(ms):.1f} ms "
          f"[{min(ms):.1f}-{max(ms):.1f}] over {TICKS} ticks "
          f"({', '.join(f'{v:.1f}' for v in ms)}); launches a tick {used}",
          flush=True)


if __name__ == "__main__":
    main()
