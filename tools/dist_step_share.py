"""The share of a data-parallel training step that each rank spends in
collectives: ``launch/train.py --mesh 2x1`` on the train cell (qwen2-1.5b,
the predicted plan, chunk 64, 8 x 64 tokens), 2 spawned ranks, every
``torch.distributed.all_gather``/``all_reduce`` the step issues timed on
the host clock (the call returns when its tensors are on this rank, so the
time holds the transfer and any wait for the other rank).  Each step ends
in a device synchronisation.  Prints one JSON line a rank and step: the
step's seconds, the seconds in collectives and their share, the calls and
the bytes received, and the ``TOP`` call sites by seconds (op, shape and
dtype: their calls, seconds and bytes received).  The ranks take the
launcher's backend rule (gloo when they share a card, and on the CPU).

  PYTHONPATH=src python tools/dist_step_share.py [--steps 3] [extra launcher args]

On the CPU at the smoke size: ``... tools/dist_step_share.py --smoke
--device cpu``.
"""

from __future__ import annotations

import json
import sys
import time

import torch
import torch.distributed as tdist

TOP = 8     # the call sites (op, shape, dtype) with the most seconds a step


def _rank(rank, size, init_method, argv, steps, batch_axes, backend):
    from repro_torch.dist import init_mesh, rank_device
    from repro_torch.launch import train as T
    from repro_torch.train.loop import make_train_step

    args = T.parse_args(argv)
    dev = rank_device(rank, torch.device(args.device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist = init_mesh(rank, {"data": size, "model": 1}, init_method, backend,
                     batch_axes=batch_axes, fsdp_axis="data", device=dev)
    tally = {"s": 0.0, "calls": 0, "bytes": 0}
    by_shape: dict = {}

    def timed(fn, received):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            dt = time.perf_counter() - t0
            tally["s"] += dt
            tally["calls"] += 1
            tally["bytes"] += received(*a)
            x = a[1] if fn is gather else a[0]
            key = f"{fn.__name__} {tuple(x.shape)} {x.dtype}"
            row = by_shape.setdefault(key, [0, 0.0, 0])
            row[0] += 1
            row[1] += dt
            row[2] += received(*a)
            return out
        return call

    def gathered(parts, x, *rest, **kw):
        return x.numel() * x.element_size() * (len(parts) - 1)

    def reduced(x, *rest, **kw):
        return x.numel() * x.element_size()

    gather = tdist.all_gather
    tdist.all_gather = timed(tdist.all_gather, gathered)
    tdist.all_reduce = timed(tdist.all_reduce, reduced)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    model, tc, state, data, _ = T.build(args, dist, dev)
    step_fn = make_train_step(model, tc, dist)
    out = []
    for step in range(steps):
        batch = next(data)
        sync()
        tally.update(s=0.0, calls=0, bytes=0)
        by_shape.clear()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        sync()
        secs = time.perf_counter() - t0
        out.append(dict(rank=rank, step=step + 1, step_s=secs,
                        collective_s=tally["s"],
                        collective_share=tally["s"] / secs,
                        calls=tally["calls"], bytes_in=tally["bytes"],
                        top=sorted(([k, *v] for k, v in by_shape.items()),
                                   key=lambda r: -r[2])[:TOP]))
    return out


def main(argv=None) -> None:
    from repro_torch.dist import serve_backend, spawn
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve.scheduler import resolve_device
    from repro_torch.sharding.specs import batch_spec

    argv = list(sys.argv[1:] if argv is None else argv)
    steps = 3
    if "--steps" in argv:
        i = argv.index("--steps")
        steps = int(argv[i + 1])
        del argv[i:i + 2]
    argv = ["--arch", "qwen2-1.5b", "--policy", "predicted", "--chunk", "64",
            "--global-batch", "8", "--seq-len", "64", *argv]
    args = T.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = Mesh({"data": 2, "model": 1})
    backend, rule = serve_backend(dev, mesh.size)
    if dev.type == "cuda":
        from repro_torch.kernels import build as kernel_build

        kernel_build.build_all()
    print(f"2 ranks, backend {rule}", flush=True)
    if dev.type == "cuda":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    outs = spawn(_rank, mesh.size,
                 (argv, steps, batch_spec(args.global_batch, mesh), backend),
                 timeout_s=900)
    for per_rank in outs:
        for rec in per_rank:
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
