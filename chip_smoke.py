"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``repro_torch`` (never ``jax`` or ``repro``) in phases, each printed
on its own line:

1. build: compiles the Hopper kernels of ``src/repro_torch/csrc`` with
   ``nvcc`` (one process per source, in parallel) into ``build/``, and
   prints each instantiation of the Hopper tile ``qgemm_sm90.cuh`` (E,
   K8, B, K9, G's large route), of G's decode kernel and of K3's tile
   with its registers and spill bytes and, at the path's operand kinds
   and schedules, its shared memory and resident blocks an SM (fails on a
   spill, or on fewer than two 256-thread blocks of the tile, one for
   K9's lm_head call, G's decode kernel and K3), and the prefill walk of
   P and K10 (``attn_prefill_sm90.cuh``) at the serve shapes' schedules:
   tile rows, cluster, pages a round, shared memory, resident blocks an SM
   (at least two) and clusters that fit;
2. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (bitwise on lattice operands, at most 1 ulp of
   the carry format on random ones, mismatch fractions printed), with its
   time, the plain version's time, one PyTorch library call's time as a
   yardstick and the least time the card could take (its bound); G per
   shape at M = 1, 8, 16, 32 and 64 through both of its routes (the
   decode kernel and the Hopper tile), each held against the plain
   version and timed;
   D and its stats variant (K12's kernel) at the serve arena (B 8), the
   monitor's B 1 and a 4096-token row, each with the cluster its schedule
   picks: D bitwise its plain version on random and lattice q, K12 against
   D and its plain version (o bitwise, the stats row's counters and
   MAX_ABS bitwise, its sums within ``SUM_REL``/``SUM_ABS``), two launches
   bitwise; both timed as a CUDA graph replay and eagerly; P at the
   64-token slab (q_offset 320), over the 8 serve prompts' one-shot calls
   and at a 2048-token one-shot prompt under the plan's bucket for it,
   bitwise its plain version on random and lattice q (padded rows exactly
   0), each timed as a CUDA graph replay and eagerly beside SDPA, the
   bound and the CUDA-core bound of its rounded mul-then-add;
3. serve: qwen2-1.5b at full width and depth (28 layers, d 1536, vocab
   151936) under the predicted accumulation plan (chunk 64, page 16), bf16
   random weights from a seeded generator, 8 requests of mixed prompt
   lengths, 32 generated tokens each, one-shot and then with 64-token
   prefill slabs.  Every kernel's launch count over each run must be > 0,
   and one request's prefill logits are held against the plain versions;
   then the one-shot run with the serve-time VRR monitor every 4 decode
   steps (K12; its streams equal the monitor-off run's unless it
   re-buckets) and a forced 1-bit-carry plan that must re-bucket;
   ``[serve-graph]``: the same cell on CUDA graphs (the compile cache's
   signatures captured by the warmup), one-shot and with slabs: streams
   and arena bitwise the eager runs', 0 steady-state captures, the
   warmup's captures and seconds, eager and graphed tokens/s, launches
   counted over the replays, the graph pool's bytes; P's device-geometry
   entry (``[kernels] P flash_prefill_paged(geom)``) bitwise its
   launch-argument entry and its plain version on 22 slab geometries and
   timed beside it; ``[spec]``: speculative decoding at k = 4 on graphs
   with the seeded qwen2-0.5b draft and with draft = target (every round
   k + 1 tokens), streams bitwise the eager one-shot run's, 0 steady-state
   captures, and one batch's verify at full depth bitwise 5 sequential
   decode steps, the qwen2-0.5b run traced and metered (its draft, verify
   and rollback spans, its ``repro_serve_spec_*`` counters the engine's);
   D is also timed at verify's 40 rows; ``[obs]``: the one-shot and slab
   runs, eager and graphed, with a ``Tracer`` and a ``MetricsRegistry``:
   streams and arena bitwise the obs-off runs, one root span a request,
   the token counter the tokens generated, the Prometheus text parsed, the
   end-to-end time against the obs-off run's; ``[reserve]``: the engine
   on graphs with ``reserve_admission=True`` on a pool too small to reserve
   every request at once: no preemption, its G, D and P(geom) launch shapes
   recorded and held against their plain versions, each stream against the
   optimistic run's (bitwise where the request decoded at the same buckets,
   by the simulation's replay of both schedules); ``[legacy]``: the legacy
   static batch through ``launch/serve.py --legacy`` (4 prompts of 32
   tokens, 16 generated, ``decode_step`` over a dense bf16 cache), G's
   launch shapes recorded and bitwise their plain version, tok/s;
4. train kernels: E (the forward GEMM with int8 residual codes), B (the
   backward pair) and the stats variants K8 (G's, on f32/bf16 operands and
   on E's int8 codes) and K9 (B's) against their plain versions and their
   stats-off kernels at every distinct layer shape of the training step
   (T = 512 tokens) and on a slice of the tied lm_head; the whole lm_head
   backward (T = 512, N = 151936) unsplit, through K9, and chained over 10
   N segments with the dx carry (K7), each against the plain version
   (bitwise); K8 at the eager telemetry tick's own FWD/BWD/GRAD calls of
   every layer tag and of the whole lm_head; E's C against K8's on the
   same operands, bitwise; at each distinct layer shape and the whole
   lm_head, K9 beside B (the stats overhead on one tile) and K3's BWD +
   GRAD, and K8 beside E (G's tile route for the lm_head, whose C is
   held bitwise against K8's), each with the share of its f32-FMA bound;
   one step's E and B launches and one
   in-graph telemetry tick's K8 and K9 launches timed as sequences, with
   their f32-FMA bounds, their plain versions timed at one layer's 7 calls
   beside the kernels there (the bitwise checks stay on the operands
   above);
5. train: qwen2-1.5b at full width and depth through the training
   launcher's set-up (predicted plan, chunk 64, batch 8 x seq 64, seeded
   f32 weights, ``SyntheticLM``), 6 AdamW steps at lr 1e-3 with 2 warmup
   steps and the eager telemetry tick every 2 steps
   (``--telemetry-cadence 2``): per-step loss, gradient norm, step time,
   tokens/s, peak memory and launches (E 392 under the default
   ``REPRO_REMAT_POLICY=full``, whose backward recomputes each layer, G 1,
   B 197 a step; G 197 and K8 24 a tick), each tick's time, events and
   schedule; the loss must be finite and fall; 2 more steps under
   ``none`` (E 196) beside the steady ``full`` step; one step of a 1-layer cut through the kernels and
   through their plain versions, bitwise; then 3 full-depth in-graph
   ticks (``--ingraph-telemetry``: K9 197, K8 197, B 0 each; median and
   spread of their times) and, at the 2-layer
   cut, the tagged step against the untagged one, bitwise; then the
   launcher's ``main`` under ``--policy perturbed --pp -2`` with a tick
   every step (eager, then in-graph), 3 full-depth steps each: the
   controller must bump, the model be re-planned and training go on; the
   in-graph run exports the metrics registry (``--obs-metrics``,
   ``--obs-prometheus``): every controller event counted, the launch
   gauges the run's counts;
   ``[train-4k]``: the train cell's model at 4096 tokens, batch 1, 3
   steps under ``full`` (one more profiled), one under ``dots`` (peak
   and launches within 1% of ``full``'s), the bytes a layer keeps under
   ``none`` and the 28-layer need they give (not attempted where it
   cannot fit), 2 steps of 2 microbatches with loss scaling, and 2
   layers ``full`` bitwise ``none``; ``[fig6]``: the paper's Fig. 6
   runner at its defaults, its tail losses and verdict;
6. the oracle and the dense prefill: on the serve cell, one request's full-depth
   prefill logits under the unfused oracle plan (``QDotConfig(
   fused=False)``: K2 quantize and K3 chunked qmatmul) against the fused
   plan, bitwise, and the dense resumable prefill K10 on layer 0 at full
   width over the 8 prompts (one-shot, 64-token slabs with the carry out
   and in, and the bucketed P: outputs and arena bitwise), K10 against its
   plain version there and at S = 512 with chunk 64 and 128, its 8
   one-shot calls timed as a CUDA graph replay and eagerly; K2 and K3
   against their plain versions at the training shapes and one oracle
   step's launches timed (K2 as a CUDA graph replay, each of its 12
   distinct calls alone too, and eagerly; K3's plain version at one
   layer's calls and the lm_head's, which its whole-head check reads);
   the 2-layer oracle step
   against the fused step (loss and every gradient bitwise) and 2
   full-depth steps of the train cell under each (losses bitwise, step
   time and peak memory);
7. stochastic rounding (``--rounding sr``): E, B, K8 and K9 with SR
   carries at one layer's four GEMM shapes of the train cell, on random and
   lattice operands, each bitwise its plain version, K8's C bitwise E's,
   K9's dx/dw bitwise B's, B's dx and dw bitwise the plain fused call on
   (g, Q(w)^T) and (Q(x)^T, g) at the role seeds, another seed changing
   every output, and each SR kernel timed beside its RNE run (per shape
   and over one layer's seven calls); ``[sr] G``: G under SR at those
   shapes, its decode route at M = 1, 8, 32 and 64 under each split it
   can take and its tile route at M = 512, bitwise the plain version and
   E's C, each timed beside RNE; ``[sr] K7``: B's dx carry-in entry under
   SR chained over 10 N segments at mlp gate/up (N = 8960), bitwise the
   unsplit SR B and the chained plain version, timed beside the RNE chain;
   ``[sr] K10``: the serve prompts' dense prefill under SR, one-shot and in
   64-token slabs through the carry, bitwise the plain version and the
   one-shot walk, another seed changing every output, timed by CUDA-graph
   replay beside RNE; ``tests/test_below_knee.py``'s
   regression on the card (K 8192, chunk 32, ``m_acc = knee - 2``: RNE
   stalls, SR reaches the wide loss); the train cell under ``--rounding
   sr --sr-seed 7 --policy perturbed --pp -2`` at full width and depth, 6
   steps with the eager tick every 2 steps (its no-grad forward through G
   under SR, no E) and step 5 in-graph (the loss must fall; the SR
   launches of G, E, B, K8 and K9 counted); a 1-layer SR step bitwise
   through the plain versions; a 2-layer tagged oracle step
   (``fused=False``: the rows from K8 on its f32 residuals) against the
   tagged fused step, loss and gradients bitwise, every row's counters and
   MAX_ABS bitwise and its sums within ``SUM_REL``/``SUM_ABS``;
8. analysis (first, while the build runs on a thread of its own: it runs
   PyTorch ops only): the Monte Carlo of swamped accumulation on the card at
   ``tests/test_vrr_montecarlo.py``'s points under its assertions, Table
   1's assignment of the paper's three networks against the published
   table (the JAX package's match count), and qwen2-1.5b's accumulation
   lengths beside the train cell's plan;
9. tp (after the dense prefill, before training): tensor-parallel
   serving, 2 ranks sharing the one card (gloo).  Kernels: D's carry entry
   (``return_carry=True``) at the serve arena for a rank's share (KV 1, g
   6) and unsplit, P's carry out at the 64-token slab (a rank's share and
   unsplit) and over the 8 one-shot prompts, each o, m and l bitwise its
   plain version on random and lattice q and its finalize bitwise the
   finalized kernel, timed by CUDA-graph replay beside it; P resumed at
   pages 1, 7, 12 and 23 of the 384-token prompt from the carry of the
   pages before, bitwise the one-shot walk; G at a rank's seven weight
   slices at M = 8, 64 and 384, bitwise.  Engine: the serve prompts at
   full width and 4 layers, half the serve cell's tokens each, one-shot
   through ``launch/serve.py --serve-mesh 2`` and with 64-token slabs and
   a forced preemption through ``serve_job``, each against the
   single-device engine under the same ``tp_shards=2`` plan: tokens, every
   decode step's logits (sha256; one step bitwise), the arena gathered
   from the ranks byte for byte, the per-rank pools in lockstep; the
   decode step's time beside the single device's (2 ranks sharing one
   card: not a TP speed figure); which gloo collectives take CUDA
   tensors; the int8 logit wire bitwise the gather wire on a lattice
   input; the carry entries' launches counted on rank 0;
   then training over a mesh of ranks sharing the card (gloo; not a speed
   figure): ``[dist-train]`` B and K9 on both ranks' K-slices (RNE);
   ``[dist-sr]`` the SR keys' origins (E, K8 and G on a rank's rows and
   columns, G's decode route on 2 x 8 rows, B and K9 on K-slices) bitwise
   the whole SR calls and the plain versions, timed beside RNE; the
   launcher's ``--mesh 2x1`` at full width and 4 layers (2 steps), 2
   layers with microbatches and loss scaling, 2 layers with an in-graph
   tick, ``--rounding sr`` at 4 layers with an in-graph tick, and the
   unfused oracle at 2 layers with an in-graph tick, each against the
   single device (records, schedules, tick verdicts and the blocks of the
   final state by digests); ``[dist-model]`` the model axis: ``--mesh
   1x2`` at 4 layers, and ``--mesh 2x2`` (4 ranks) under the predicted
   plan, ``--rounding sr`` with an eager tick and ``--policy exact``
   (within 1e-3, ROADMAP F8) at 2 layers, against the single device;
10. ckpt: the train cell at full width and 2 layers through the launcher,
   uninterrupted and then under the restart supervisor with a crash at
   step 3 and a checkpoint every 2 steps (losses after the resume bitwise
   the uninterrupted run's; bytes on disk, save and restore ms), and the
   last checkpoint served through ``launch/serve.py --ckpt-dir`` under
   its recorded precision schedule;
11. variants, quantize_outputs and A2Q (after the SR phases; ``[qout]``'s
   serving right after the dense prefill): ``[variants]``, every variant
   of the fused GEMM against its plain version on lattice (bitwise) and
   random operands under RNE and SR: G's ``out_fmt``/``pack_out``
   epilogue, int8-code (``a_packed``/``b_packed``) and unquantized
   operands on both routes (codes on the tile) at M = 8 and 512, E's
   epilogue and f32 residuals at (1,5,2) and (1,6,9), K8's epilogue on
   E's codes and on f32 x and bf16 w; each epilogue bitwise K2 (and
   ``pack_block``) of the call without it, K8's row bitwise unchanged by
   it; each timed by CUDA-graph replay beside its base call (G's over one
   layer's 7 GEMMs and the decode step's 197 at M = 8, the rest over one
   layer's 7 calls at M = 512); ``[qout]``, under
   ``AccumulationPolicy(quantize_outputs=True)``: the serve prompts at
   full depth (G's epilogue counted), 2-layer serving bitwise the plain
   path (tokens, arena), ``qdot_packed`` at the decode shapes bitwise
   ``QTensor.pack`` of the plain rounding, 6 full-depth training steps
   (the loss falls, E's epilogue 392 launches a step, every dense output
   on the (1,5,2) lattice), a 2-layer step bitwise its plain versions and
   with ``pack_residuals=False`` bitwise the packed step; ``[a2q]``, the
   launcher under ``--a2q-reg 1e-4 --a2q-x-bound 16`` at full width and
   depth for 3 steps with the certificate ok after each, and
   ``tests/test_a2q.py``'s adversarial check through K8 under RNE and SR;
12. families (last): ``[families]``, the paged half of the other model
   families at their published widths.  G at moonshot-v1-16b-a3b's expert
   shapes (gate/up 2048 x 1408, down 1408 x 2048; the (8, 23) carry at
   chunk 128, no representation format, f32 activations of bf16 values,
   bf16 weights) at the capacities of a decode step (1), a 64-token slab
   (7) and the train cell (60), and B at 60 with raw f32 residuals, one
   expert's 3 GEMMs each, bitwise their plain versions on random and
   lattice operands, timed beside the bound and bf16 ``torch.matmul``.
   ``moe-serve``: moonshot at 8 of 48 layers (5.37 B parameters; 48 would
   need a 115.6 GB f32 draw), the predicted plan, the serve cell's 8
   prompts one-shot, eager with every G (expert and dense) and D call
   recorded and the expert launches counted, then on CUDA graphs (P's
   device-geometry entry recorded on a prompt's slab): each recorded call
   against its plain version, the graphed streams and arena bitwise the
   eager ones, a full decode step's launches by kernel (192 expert G a
   layer), the decode tok/s and the expert G calls' share of a decode
   step's kernel time (their graph replay over the profiler's sum).
   ``moe-train``: moonshot at 2 layers (1.85 B parameters; 4 would need
   about 48 GB before activations) through the launcher, 8 x 64, AdamW,
   3 steps: finite losses and aux, the expert G and B calls at capacity 60
   recorded and bitwise their plain versions, the step time and peak
   memory; a 1-layer step (2 x 64, no remat) bitwise through the plain
   versions.  ``qk-norm``: qwen3-8b at full width and depth on graphs, G,
   D and P recorded on a slab and a decode step, the decode tok/s.
   ``vlm``: internvl2-2b at 2 layers, 2 steps of 2 x 512 with 256 patch
   embeddings a row bitwise through the plain versions, the loss unmoved
   by the image positions' tokens;
13. result: one JSON line per kernel (the SR carries of G, E, B, K7, K8,
   K9 and K10, D's and P's carry variants, B's and K9's K-slices, the SR
   origins, the fused GEMM's variants and the MoE experts' G and B as
   entries of their own;
   ``plain_depth`` says what a ``plain_ms`` covers, ``plain_depth_kernel_ms`` the kernel there), the seconds by
   phase, the card's name and power limit, and the final JSON line.

Any failed check exits non-zero.  Without a CUDA device it exits non-zero
before printing a result.

  python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import weakref
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12      # tensor cores, f32 accumulate
FP8_FLOPS = 1979e12      # tensor cores, E4M3/E5M2 operands
F32_FLOPS = 67e12        # CUDA cores

SEED = 0
PAGE = 16
GEN = 32
MAX_BATCH = 8
PROMPT_LENS = (17, 40, 64, 96, 150, 200, 300, 384)
SLAB = 64


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_time(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.cache
def _side_stream():
    """One warm-up stream for every ``lib_time`` call: cuBLAS keeps a
    workspace for each stream it has run on, so a new stream a call would
    hold about 32 MiB of the card for the rest of the run."""
    return torch.cuda.Stream()


def lib_time(fn, reps: int = 5, rounds: int = 5):
    """The library's card time for ``fn()``: its launches captured once in
    a CUDA graph and replayed, so the host's cost of launching many small
    PyTorch calls (which bounded eager timings of the library sequences
    and moved them up to 2x between runs) is left out.  Returns the median
    of ``rounds`` means over ``reps`` replays, and (min, max) of the means."""
    side = _side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    means = sorted(cuda_time(graph.replay, reps=reps, warmup=1)
                   for _ in range(rounds))
    del graph
    return means[rounds // 2], (means[0], means[-1])


def lib_str(lib) -> str:
    """``lib_time``'s result as text: the median and the spread."""
    med, (lo, hi) = lib
    return f"{med:.4f} ms [{lo:.4f}-{hi:.4f}]"


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    return seq_bound([(n_bytes, flops, peak_flops)])


def seq_bound(costs):
    """The bound of a sequence of launches, each (bytes, operations, the
    peak rate of its operand type): all bytes over the memory rate against
    each launch's operations over its own peak, summed."""
    t_bytes = sum(c[0] for c in costs) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(c[1] / c[2] for c in costs) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fma_bound(costs) -> float:
    """A GEMM sequence's f32-FMA bound (ms): its multiply-adds at the f32
    rate of the CUDA cores, where the bitwise kernels run (a tensor-core
    MMA does not form their sequential f32 chunk partials)."""
    return sum(c[1] for c in costs) / F32_FLOPS * 1e3


def ulps(got, want, m: int, min_exp: int) -> torch.Tensor:
    """|got - want| in ulps of the (1, e, m) format at max(|got|, |want|)."""
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs())
    exp = torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag))))
    ulp = torch.exp2(torch.clamp(exp, min=min_exp) - m)
    return (got - want).abs() / ulp


def compare(label: str, got, want, m: int, e: int, *, bitwise: bool,
            quiet: bool = False) -> float:
    """Print the mismatch fraction and max ulps (unless ``quiet``); fail
    past 1 ulp of the (1, e, m) format, or on any mismatch when
    ``bitwise``.  Returns max |err|."""
    mism = float((got != want).float().mean())
    u = float(ulps(got, want, m, -(2 ** (e - 1) - 1)).max())
    err = float((got - want).abs().max())
    if not quiet:
        print(f"  {label}: mismatch fraction {mism:.6f}, max {u:.3f} ulp of "
              f"(1,{e},{m}), max |err| {err:.3g}", flush=True)
    check(torch.isfinite(got).all().item(), f"{label}: non-finite output")
    check(u <= 1.0, f"{label}: {u} ulp > 1")
    if bitwise:
        check(mism == 0.0, f"{label}: not bitwise on lattice operands")
    return err


def check_stats(label: str, got, want) -> float:
    """Print and check a stats row against its plain version; returns the
    largest |error| over the sum slots (``kernels.common.stats_gap``: the
    counters and MAX_ABS bitwise, the sums within SUM_REL/SUM_ABS)."""
    from repro_torch.kernels.common import stats_gap

    exact, ratio = stats_gap(got, want)
    err = float((got.double().cpu() - want.double().cpu()).abs().max())
    print(f"  {label} stats: counters and MAX_ABS "
          f"{'bitwise' if exact else 'DIFFERENT'}, sum slots at "
          f"{ratio:.3g} of their bound, max |err| {err:.3g}", flush=True)
    check(exact, f"{label}: stats counters differ from the plain version")
    check(ratio <= 1.0, f"{label}: stats sums beyond their bound")
    return err


# --------------------------------------------------------------------------
# phase 1: build
# --------------------------------------------------------------------------


def start_build():
    """The kernels' build (``build.build_all``: one ``nvcc`` a source, all
    at once) on a thread of its own, so that work which needs no kernel
    (``phase_analysis``: PyTorch ops only) runs on the card meanwhile;
    ``phase_build`` waits for it."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build

    pool = ThreadPoolExecutor(1)
    t0 = time.perf_counter()
    fut = pool.submit(lambda: (build.build_all(), time.perf_counter() - t0))
    pool.shutdown(wait=False)
    return fut


def phase_build(background=None) -> str:
    """The build (waiting for ``start_build``'s, where given), with each
    source's seconds, the card and the compiler, the ptxas reports and
    ``sm90_report``."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    if background is not None:
        built, dt = background.result()
        waited = time.perf_counter() - t0
    else:
        built = build.build_all()
        dt = waited = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    ends = {k: round(v, 1) for k, v in sorted(built.items(),
                                              key=lambda kv: kv[1])}
    print(f"[build] {len(built)} kernels built in {dt:.2f}s into "
          f"{build.BUILD_DIR} ({', '.join(sorted(built)) or 'cached'}), "
          f"{waited:.2f}s of it waited for; seconds to each source's end "
          f"{ends}", flush=True)
    for name in build.KERNELS:
        log = build._lib_path(name).with_suffix(".log")
        regs = [ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln] if log.exists() else []
        print(f"[build] {name}: {' | '.join(regs) or 'no ptxas report'}")
    print(f"[build] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{nvcc}; card: {smi}", flush=True)
    sm90_report(build)
    return smi


# The Hopper tile's kernels (csrc/qgemm_sm90.cuh): (library, entry prefix
# of its *_smem / *_occupancy functions, kernel, [(operand kinds, resident
# 256-thread blocks an SM it must reach)]) at the training path's kinds:
# K8 on int8 codes and on the lm_head's f32 x and bf16 embed.T; E on its
# bf16 scratches; B and K9 on codes with g as bf16 Q(g), and on the
# lm_head's f32 x, bf16 w and f32 g, where K9's shadow carry leaves room
# for one block (reported, not required to be two); G's large route on f32
# x and bf16 weights (its kinds are bf16 flags).
SM90_TILES = [
    ("qgemm_stats", "qgemm_stats", "qgemm_stats_kernel", [((2, 2), 2), ((0, 1), 2)]),
    ("qgemm_emitq", "qgemm_emitq", "qgemm_emitq_kernel", [((), 2)]),
    ("bwd_pair", "bwd_pair", "bwd_pair_kernel", [((2, 2, 1), 2), ((0, 1, 0), 2)]),
    ("bwd_pair", "bwd_pair_stats", "bwd_pair_stats_kernel",
     [((2, 2, 1), 2), ((0, 1, 0), 1)]),
    ("qgemm", "qgemm_tile", "qgemm_tile_kernel", [((0, 1), 2), ((0, 0), 2)]),
    # the output epilogue's kernels (the tile's OUT flag): K8's and G's at
    # the paths' kinds and on int8 codes, E's on its bf16 scratch (0) and
    # on f32 residuals (1)
    ("qgemm_stats", "qgemm_stats_out", "qgemm_stats_out_kernel",
     [((2, 2), 2), ((0, 1), 2)]),
    ("qgemm_emitq", "qgemm_emitq_out", "qgemm_emitq_out_kernel",
     [((0,), 2), ((1,), 2)]),
    ("qgemm", "qgemm_tile_out", "qgemm_tile_out_kernel",
     [((0, 1), 2), ((2, 2), 2), ((2, 0), 2)]),
]
# Kernels whose instantiations the build phase reports (registers, spill
# bytes; a spill fails): the tile's, G's decode kernel and its fold kernel
# (each with a last template flag false/true, RNE/SR), K3's tile, the
# decode attention's (D, K12) and the prefill walk's (P; K10 under RNE and
# SR).
_KERNEL = re.compile(r"(qgemm_stats_kernel|qgemm_emitq_kernel|qgemm_tile_kernel|"
                     r"qgemm_decode_kernel|qgemm_fold_kernel|qmatmul_kernel|"
                     r"qgemm_stats_out_kernel|qgemm_emitq_out_kernel|"
                     r"qgemm_tile_out_kernel|qgemm_decode_out_kernel|"
                     r"qgemm_fold_out_kernel|quantize_pass_kernel|"
                     r"paged_decode_kernel|"
                     r"attn_prefill_kernel|"
                     r"bwd_pair_stats_kernel|bwd_pair_kernel)"
                     r"(?:I(.*?)EEv|E)")
_TILE_KERNELS = {k for _, _, k, _ in SM90_TILES}


def _tile_name(fn: str):
    """``kernel<types>`` of a mangled instantiation of a reported kernel
    (``kernel`` alone for one that is not a template), or None."""
    m = _KERNEL.search(fn)
    if m is None:
        return None
    if m.group(2) is None:
        return m.group(1)
    args, names = m.group(2), []
    while args:
        sub = re.match(r"13__nv_bfloat16|S\d*_|Lb([01])E", args)
        if sub:         # bf16 is the only class type, so every substitution
            names.append(("false", "true")[int(sub.group(1))]
                         if sub.group(1) else "bf16")
            args = args[sub.end():]
        else:
            names.append({"a": "int8", "f": "f32"}[args[0]])
            args = args[1:]
    return f"{m.group(1)}<{', '.join(names)}>"


def _ptxas_entries(log: str) -> dict:
    """{mangled function: (registers, spill bytes)} of a ptxas -v log."""
    out, fn, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn is not None:
            out[fn] = (int(m.group(1)), spill)
    return out


def sm90_report(build) -> None:
    """Registers and spill bytes of every instantiation of the Hopper tile,
    of G's decode kernel and of K3's tile (from ptxas); the tile's dynamic
    shared memory and resident blocks an SM at 4 chunk groups at the
    training path's operand kinds, and the resident blocks of G's decode
    kernel at the decode step's schedules and of K3 at 4 slices; fails on
    a spill or on fewer resident blocks than asked."""
    import ctypes

    from repro_torch.kernels import sm90
    from repro_torch.kernels.qmatmul import smem_bytes

    for lib in ("qgemm_stats", "qgemm_emitq", "bwd_pair", "qgemm", "qmatmul",
                "paged_decode", "paged_prefill", "flash_prefill"):
        log = build._lib_path(lib).with_suffix(".log").read_text()
        for fn, (regs, spill) in sorted(_ptxas_entries(log).items()):
            name = _tile_name(fn)
            if name is None:
                continue
            tag = "sm90 " if name.split("<")[0] in _TILE_KERNELS else ""
            print(f"[build] {tag}{name}: {regs} registers, {spill} spill "
                  f"bytes", flush=True)
            check(spill == 0, f"{name} spills {spill} bytes")
    for lib, entry, kernel, kinds in SM90_TILES:
        args = [ctypes.c_int] * (len(kinds[0][0]) + 1)
        smem = build.function(lib, f"{entry}_smem", args)
        occ = build.function(lib, f"{entry}_occupancy", args)
        for k, need in kinds:
            n = occ(*k, 4)
            print(f"[build] sm90 {kernel} kinds {k} at 4 chunk groups (256 "
                  f"threads): {smem(*k, 4)} bytes of dynamic shared memory, "
                  f"{n} resident blocks an SM (at least {need} required)",
                  flush=True)
            check(n >= need, f"{kernel} kinds {k}: {n} resident blocks an SM")
    occ = build.function("qgemm", "qgemm_decode_occupancy", [ctypes.c_int] * 6)
    occ_out = build.function("qgemm", "qgemm_decode_out_occupancy",
                             [ctypes.c_int] * 6)
    seen = set()
    for k, n, kfast in ((1536, 1536, 0), (1536, 256, 0), (1536, 8960, 0),
                        (8960, 1536, 0), (1536, 151936, 1)):
        s = sm90.decode_schedule(MAX_BATCH, n, k, 64, 1)
        if (s.slots, kfast) in seen:
            continue
        seen.add((s.slots, kfast))
        for sr in (0, 1):
            for kernel, fn in (("qgemm_decode_kernel", occ),
                               ("qgemm_decode_out_kernel", occ_out)):
                r = fn(0, 1, kfast, s.slots, 64, sr)
                print(f"[build] {kernel}<f32, bf16, "
                      f"{('false', 'true')[kfast]}, {('false', 'true')[sr]}> "
                      f"at {s.slots} slots ({s.threads} threads, K={k} N={n} "
                      f"M={MAX_BATCH}): {s.smem} bytes of dynamic shared "
                      f"memory, {r} resident blocks an SM", flush=True)
                check(r >= 1, f"{kernel} (sr {sr}): {r} resident blocks an "
                      f"SM")
    occ = build.function("qmatmul", "qmatmul_occupancy", [ctypes.c_int] * 3)
    for a, b in ((0, 0), (0, 1), (1, 1)):
        r = occ(a, b, 4)
        print(f"[build] qmatmul_kernel<{('f32', 'bf16')[a]}, "
              f"{('f32', 'bf16')[b]}> at 4 slices (256 threads): "
              f"{smem_bytes(4)} bytes of dynamic shared memory, {r} resident "
              f"blocks an SM", flush=True)
        check(r >= 1, f"K3: {r} resident blocks an SM")
    # D and K12 (qwen2-1.5b: g 6, dh 128): the cluster, its blocks' shared
    # memory and the clusters that fit the card at once, at the serve
    # arena and the monitor's B 1 (the 1024-token bucket's 64 pages) and
    # at the 4096-token row
    # (and D's carry entry, at a rank's share of the arena under 2 ranks,
    # KV 1, too: it must fit as D does)
    smem = build.function("paged_decode", "paged_decode_smem", [ctypes.c_int] * 5)
    fit = build.function("paged_decode", "paged_decode_clusters", [ctypes.c_int] * 6)
    for b, kv, width, what in ((MAX_BATCH, 2, 64, "serve arena"),
                               (1, 2, 64, "monitor"),
                               (1, 2, 256, "4096-token row"),
                               (MAX_BATCH, 1, 64, "rank's share")):
        s = sm90.attn_decode_schedule(b, kv, width, 6, PAGE, 128)
        n = [fit(k, 6, PAGE, 128, s.cluster, s.rank_pages) for k in (0, 1, 2)]
        print(f"[build] paged_decode_kernel at the {what} (B={b}, KV {kv}, "
              f"width {width}): cluster {s.cluster}, {s.rank_pages} pages a "
              f"block a round, {s.blocks} blocks of {sm90.ATTN_THREADS} "
              f"threads, {smem(6, PAGE, 128, s.cluster, s.rank_pages)} bytes "
              f"of dynamic shared memory; clusters that fit at once: D {n[0]}, "
              f"K12 {n[1]}, D's carry entry {n[2]}", flush=True)
        check(min(n) >= b * 2, f"D/K12 at the {what}: {n} clusters fit")
        check(n[2] == n[0], f"D's carry entry fits {n[2]} clusters, D {n[0]}")
    # P and K10 (qwen2-1.5b: g 6, dh 128; K10 under RNE and SR) at the
    # schedules of the serve shapes: tile rows, cluster, pages a block a
    # round, shared memory, resident blocks an SM (at least two) and
    # clusters that fit at once
    for lib, what, t, ps, n_pages in PREFILL_BUILD_SHAPES:
        s = sm90.attn_prefill_schedule(t, 2, 6, ps, 128, n_pages)
        args = (6, s.rows, ps, 128, s.cluster, s.rank_pages)
        smem = build.function(lib, f"{lib}_smem", [ctypes.c_int] * 6)(*args)
        check(smem == s.smem, f"{lib} at {what}: smem {smem} != {s.smem}")
        for sr in ((False, True) if lib == "flash_prefill" else (False,)):
            entry = f"{lib}_sr" if sr else lib
            occ = build.function(lib, f"{entry}_occupancy",
                                 [ctypes.c_int] * 6)(*args)
            fit = build.function(lib, f"{entry}_clusters",
                                 [ctypes.c_int] * 6)(*args)
            print(f"[build] attn_prefill_kernel<"
                  f"{str(lib == 'paged_prefill').lower()}, {str(sr).lower()}> "
                  f"({lib}) at {what} (T={t}, page {ps}, {n_pages} pages): "
                  f"{s.rows} rows a tile, cluster {s.cluster}, {s.rank_pages} "
                  f"pages a block a round, {s.blocks} blocks of "
                  f"{sm90.PREFILL_THREADS} threads, {smem} bytes of dynamic "
                  f"shared memory, {occ} resident blocks an SM, {fit} clusters "
                  f"fit at once", flush=True)
            check(occ >= 2, f"{entry} at {what}: {occ} resident blocks an SM")


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------


def _lattice(gen, shape, device):
    """(1,5,2) points over a narrow exponent range: every f32 sum of a
    chunk's products is exact, so any summation order agrees."""
    e = torch.randint(-2, 3, shape, generator=gen, device=device)
    j = torch.randint(0, 4, shape, generator=gen, device=device)
    s = torch.randint(0, 2, shape, generator=gen, device=device) * 2 - 1
    x = s * torch.exp2(e.float()) * (1 + j / 4)
    return torch.where(torch.rand(shape, generator=gen, device=device) < 0.1,
                       torch.zeros_like(x), x).float()


def gemm_shapes(cfg):
    """(name, K, N, QDotConfig) of the dense GEMMs of one layer plus the
    tied lm_head, in the order a layer runs them."""
    from repro_torch.models.api import dense_gemm_shapes

    shapes = dense_gemm_shapes(cfg, seq_len=1, global_batch=1)
    return [(tag, k, n, qc) for tag, _, k, n, qc in shapes[1:] + shapes[:1]]


def _gemm_kw(qc) -> dict:
    p = qc.fwd
    return dict(repr_fmt=qc.repr_fmt, e_acc=p.e_acc, m_acc=p.m_acc,
                block_k=p.chunk)


# M at which G's two routes are timed per shape: the decode route's switch
# (sm90.DECODE_MAX_M) is set from these lines
G_ROUTE_MS = (1, MAX_BATCH, 16, 32, SLAB)


def _g_schedules(m, n, k, chunk):
    """{label: schedule} of G's two routes at one shape: the decode route
    (as it would be scheduled there) and the tile."""
    from repro_torch.kernels import sm90

    out = {}
    dec = sm90.decode_schedule(m, n, k, chunk, 1)
    if dec is not None:
        out[f"decode (slots {dec.slots}, slices {dec.slices})"] = dec
    tile = sm90.gemm_schedule(m, n, k, chunk, 0, 1, stats=False)
    out[f"tile (groups {tile.groups})"] = tile
    return out


def phase_gemm(cfg, dev) -> dict:
    """G per shape of the serve cell (each layer GEMM, and the tied head's
    embed.T view) at every M of ``G_ROUTE_MS``: each route (the decode
    kernel, the Hopper tile) bitwise the plain version on lattice
    operands and within 1 carry ulp on random ones, and timed beside bf16
    ``torch.matmul`` and the bound; the route ``qmatmul_fused`` takes is
    marked ``*``."""
    from repro_torch.kernels import sm90
    from repro_torch.kernels.fused import (qmatmul_fused,
                                           qmatmul_fused_reference,
                                           qmatmul_fused_with)

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    weights = {}
    print("[kernels] G qmatmul_fused per shape and M: each route vs plain "
          "(bitwise on lattice operands; random: mismatch fraction), kernel "
          "ms; bf16 torch.matmul ms and the bound; * marks the route G takes",
          flush=True)
    max_err = 0.0
    for name, k, n, qc in gemm_shapes(cfg):
        p = qc.fwd
        is_head = name == "lm_head"
        if is_head:  # the tied head: a transposed view of the embedding
            emb = (torch.randn((n, k), generator=gen, device=dev)
                   / math.sqrt(k)).to(torch.bfloat16)
            w = emb.T
        else:
            w = (torch.randn((k, n), generator=gen, device=dev)
                 / math.sqrt(k)).to(torch.bfloat16)
        weights[name] = w
        kw = _gemm_kw(qc)
        wl = (_lattice(gen, (n, k), dev).to(torch.bfloat16).T if is_head
              else _lattice(gen, (k, n), dev).to(torch.bfloat16))
        for m in G_ROUTE_MS:
            a = torch.randn((m, k), generator=gen, device=dev)
            al = _lattice(gen, (m, k), dev)
            want = qmatmul_fused_reference(a, w, **kw)
            want_l = qmatmul_fused_reference(al, wl, **kw)
            taken = sm90.g_schedule(m, n, k, p.chunk, 0, 1)
            parts = []
            for label, sched in _g_schedules(m, n, k, p.chunk).items():
                got = qmatmul_fused_with(a, w, sched, **kw)
                err = compare(f"G {name} M={m} {label} random", got, want,
                              p.m_acc, p.e_acc, bitwise=False, quiet=True)
                mism = float((got != want).float().mean())
                if sched == taken:
                    max_err = max(max_err, err)
                    check(torch.equal(qmatmul_fused(a, w, **kw), got),
                          f"G {name} M={m}: qmatmul_fused differs from its "
                          "schedule")
                compare(f"G {name} M={m} {label} lattice",
                        qmatmul_fused_with(al, wl, sched, **kw), want_l,
                        p.m_acc, p.e_acc, bitwise=True, quiet=True)
                ms = cuda_time(lambda: qmatmul_fused_with(a, w, sched, **kw),
                               reps=20)
                star = "*" if sched == taken else ""
                parts.append(f"{label}{star} {ms:.4f} ms (random mismatch "
                             f"{mism:.6f})")
            ab = a.to(torch.bfloat16)
            lib = lib_time(lambda: torch.matmul(ab, w))
            b_ms, b_by = bound_ms(m * k * 4 + k * n * 2 + m * n * 4,
                                  2 * m * n * k, BF16_FLOPS)
            print(f"  G {name} M={m} K={k} N={n}: {'; '.join(parts)}; "
                  f"lattice bitwise; library {lib_str(lib)}, bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
    return {"weights": weights, "max_abs_err": max_err}


def gemm_step(cfg, dev, weights: dict) -> dict:
    """The GEMMs of ONE decode step at M = max_batch: 7 per layer x depth
    plus the lm_head, each on its own weight in layer order, timed as one
    sequence."""
    from repro_torch.kernels.fused import qmatmul_fused, qmatmul_fused_reference

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    calls = []
    n_bytes = flops = 0
    shapes = gemm_shapes(cfg)
    for _ in range(cfg.n_layers):
        for name, k, n, qc in shapes[:-1]:
            w = (torch.randn((k, n), generator=gen, device=dev)
                 / math.sqrt(k)).to(torch.bfloat16)
            calls.append((torch.randn((MAX_BATCH, k), generator=gen,
                                      device=dev), w, _gemm_kw(qc)))
    calls.append((torch.randn((MAX_BATCH, cfg.d_model), generator=gen,
                              device=dev), weights["lm_head"],
                  _gemm_kw(shapes[-1][3])))
    for a, w, _ in calls:
        m, k = a.shape
        n = w.shape[1]
        n_bytes += m * k * 4 + k * n * 2 + m * n * 4
        flops += 2 * m * n * k

    def run(fn, seq=calls):
        for a, w, kw in seq:
            fn(a, w, **kw)

    ms = cuda_time(lambda: run(qmatmul_fused), reps=5)
    # the plain version timed at a cut depth, one layer's GEMMs, beside the
    # kernel on the same calls
    layer = calls[:len(shapes) - 1]
    plain = cuda_time(lambda: run(qmatmul_fused_reference, layer), reps=1,
                      warmup=0)
    layer_ms = cuda_time(lambda: run(qmatmul_fused, layer), reps=5)
    lib = lib_time(lambda: run(lambda a, w, **kw: torch.matmul(
        a.to(torch.bfloat16), w)))
    b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS)
    f_ms = fma_bound([(n_bytes, flops, BF16_FLOPS)])
    depth = f"one layer's {len(layer)} GEMMs at M={MAX_BATCH}"
    print(f"[kernels] G one decode step ({len(calls)} GEMMs, M={MAX_BATCH}, "
          f"{n_bytes / 1e9:.3f} GB): kernel {ms:.3f} ms, library "
          f"{lib_str(lib)} ({ms / lib[0]:.2f}x), bound {b_ms:.3f} ms "
          f"({b_by}), {b_ms / ms:.3f} of bound; f32-FMA bound {f_ms:.4f} ms; "
          f"plain at {depth} {plain:.1f} ms against the kernel's "
          f"{layer_ms:.4f} ms there", flush=True)
    return dict(ms=ms, plain_ms=plain, plain_depth=depth,
                plain_depth_kernel_ms=layer_ms, library_ms=lib[0],
                library_spread_ms=list(lib[1]), bound_ms=b_ms, bound_by=b_by,
                fma_bound_ms=f_ms, calls=len(calls))


def _attn_arena(gen, dev, n_pages, kv, dh):
    from repro_torch.kernels.common import quantize_block
    from repro_torch.quant.qtensor import pack_block

    def codes():
        x = torch.randn((n_pages, kv, PAGE, dh), generator=gen, device=dev)
        return pack_block(quantize_block(x, 5, 2), 5, 2)

    kse = torch.randint(-2, 3, (n_pages,), generator=gen, device=dev,
                        dtype=torch.int32)
    vse = torch.randint(-2, 3, (n_pages,), generator=gen, device=dev,
                        dtype=torch.int32)
    return codes(), codes(), kse, vse


def _attn_check(label, got, want, acc, *, bitwise) -> float:
    """Attention outputs: o and l are carries of the (1, e_acc, m_acc)
    format, so the finalized o / l is checked at 2 carry ulps of |want|
    plus one carry ulp of the largest output; bitwise where asked."""
    e_acc, m_acc = acc
    mism = float((got != want).float().mean())
    err = (got - want).abs()
    tol = 2.0 ** (1 - m_acc) * want.abs() + 2.0 ** -m_acc * want.abs().max()
    print(f"  {label}: mismatch fraction {mism:.6f}, max |err| "
          f"{float(err.max()):.3g}", flush=True)
    check(torch.isfinite(got).all().item(), f"{label}: non-finite output")
    check(bool((err <= tol).all()), f"{label}: beyond 2 carry ulps")
    if bitwise:
        check(mism == 0.0, f"{label}: not bitwise")
    return float(err.max())


def _decode_table(gen, dev, lens, width):
    """A page table of ``width`` columns holding the rows' pages of a
    fresh arena in a random order (padded with the null page 0)."""
    n_pages = 1 + sum(-(-s // PAGE) for s in lens)
    pt = torch.zeros((len(lens), width), dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    used = 0
    for b, s in enumerate(lens):
        np_ = -(-s // PAGE)
        pt[b, :np_] = perm[used:used + np_].to(torch.int32)
        used += np_
    return n_pages, pt


# P's and K10's schedules reported by the build phase: (library, what, T,
# page or chunk, pages the longest tile walks)
PREFILL_BUILD_SHAPES = (
    ("paged_prefill", "the 64-token slab", SLAB, PAGE, 24),
    ("paged_prefill", "the 384-token one-shot prompt", 384, PAGE, 24),
    ("paged_prefill", "the 2048-token one-shot prompt", 2048, PAGE, 128),
    ("flash_prefill", "the 384-token one-shot prompt", 384, PAGE, 24),
    ("flash_prefill", "S = 512 at chunk 128", 512, 128, 4))


# D's and K12's shapes: the serve arena (B 8, the 1024-token bucket's
# width), the serve monitor's K12 call (B 1, the same width), a 4096-token
# row (256 pages: the cluster takes it in 6 rounds), and the speculative
# verify's B * (k + 1) = 40 rows at k = 4 (row (i, j) of the serve arena's
# row i at length + j; a padded row stays 0)
SERVE_LENS = [384, 0, 17, 64, 100, 129, 256, 311]
SPEC_K = 4
DECODE_SHAPES = (("serve arena", SERVE_LENS, None),
                 ("monitor B=1", [384], None), ("4096-token row", [4096], 256),
                 ("verify B*S=40", [n + j if n else 0 for n in SERVE_LENS
                                    for j in range(SPEC_K + 1)], None))


def phase_decode(cfg, dev, plan) -> dict:
    """D and K12 at each of ``DECODE_SHAPES``: bitwise their plain versions
    on random and on lattice q, K12's o bitwise D's, its counters and
    MAX_ABS bitwise and sums within the bound, two launches bitwise, a
    length-0 row exactly 0; each timed eagerly (CUDA events around 50
    calls: at tens of us this measures the wrapper) and as a CUDA graph
    replay (``lib_time``: the kernel), beside SDPA over the same K/V and
    the bound.  The plain versions are timed at the serve arena."""
    from repro_torch.kernels import sm90
    from repro_torch.kernels.attention import (
        paged_attn_decode, paged_attn_decode_reference,
        paged_attn_decode_stats_reference)
    from repro_torch.kernels.common import exp2_int
    from repro_torch.quant.formats import FP8_152
    from repro_torch.quant.qtensor import unpack_block

    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    _, bucket = plan.bucket_for(384)
    acc = bucket.acc
    res = {}
    for what, lens, width in DECODE_SHAPES:
        width = width or bucket.max_pages(PAGE)
        nb = len(lens)
        n_pages, pt = _decode_table(gen, dev, lens, width)
        kc, vc, kse, vse = _attn_arena(gen, dev, n_pages, kv, dh)
        seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((nb, h, dh), generator=gen, device=dev)
        ql = _lattice(gen, (nb, h, dh), dev)
        args = (kc, vc, kse, vse, pt, seq_lens)
        kw = dict(kv_fmt=FP8_152, acc=acc)
        sched = sm90.attn_decode_schedule(nb, kv, width, h // kv, PAGE, dh)
        print(f"[kernels] D paged_attn_decode vs plain at the {what}: B={nb} "
              f"H={h} KV={kv} dh={dh} page {PAGE}, width {width}, lengths "
              f"{lens}, acc {acc}; cluster {sched.cluster}, "
              f"{sched.rank_pages} pages a block a round, {sched.blocks} "
              f"blocks", flush=True)
        d_err = s_err = 0.0
        for label, qq in (("random q", q), ("lattice q", ql)):
            got = paged_attn_decode(qq, *args, **kw)
            got2 = paged_attn_decode(qq, *args, **kw)
            d_err = max(d_err, _attn_check(
                f"D {label}", got, paged_attn_decode_reference(qq, *args, **kw),
                acc, bitwise=True))
            check(torch.equal(got.view(torch.int32), got2.view(torch.int32)),
                  f"D {what} {label}: two launches differ")
            for b, n in enumerate(lens):
                check(n > 0 or bool((got[b] == 0).all()),
                      "D: a length-0 row is not exactly 0")
            # the page table is wider than the rows' pages (the kernel stops
            # at each row's last page, the plain version walks every column
            # as the TPU kernel does)
            o, row = paged_attn_decode(qq, *args, collect_stats=True, **kw)
            o2, row2 = paged_attn_decode(qq, *args, collect_stats=True, **kw)
            po, prow = paged_attn_decode_stats_reference(qq, *args, **kw)
            _attn_check(f"K12 {label} vs D", o, got, acc, bitwise=True)
            s_err = max(s_err, _attn_check(f"K12 {label} vs plain", o, po, acc,
                                           bitwise=True),
                        check_stats(f"K12 {label}", row, prow))
            check(torch.equal(o, o2) and torch.equal(row, row2),
                  f"K12 {what} {label}: two launches differ")
        run_d = lambda: paged_attn_decode(q, *args, **kw)
        run_k12 = lambda: paged_attn_decode(q, *args, collect_stats=True, **kw)
        eager, eager_s = cuda_time(run_d, reps=50), cuda_time(run_k12, reps=50)
        graph, graph_s = lib_time(run_d, reps=50), lib_time(run_k12, reps=50)
        # yardstick: SDPA over the same K/V gathered dense (bf16),
        # length-masked
        ln = seq_lens.long()
        lmax = int(ln.max())
        ptl = pt.long()

        def dense(codes, se):
            x = unpack_block(codes[ptl], 5, 2) * exp2_int(
                se[ptl])[..., None, None, None]      # (B, W, KV, ps, dh)
            x = x.permute(0, 2, 1, 3, 4).reshape(nb, kv, -1, dh)[:, :, :lmax]
            return x.repeat_interleave(h // kv, dim=1).to(torch.bfloat16)

        kd, vd = dense(kc, kse), dense(vc, vse)
        mask = (torch.arange(lmax, device=dev)[None, :] < ln[:, None])[:, None, None, :]
        qb = q[:, :, None].to(torch.bfloat16)
        lib = lib_time(lambda: torch.nn.functional.scaled_dot_product_attention(
            qb, kd, vd, attn_mask=mask), reps=50)
        del kd, vd
        pages_read = sum(-(-n // PAGE) for n in lens)
        n_bytes = (pages_read * kv * PAGE * dh * 2 + q.numel() * 4 * 2
                   + pt.numel() * 4 + nb * 4 + pages_read * 2 * 4)
        flops = 4 * sum(lens) * dh * h
        b_ms, b_by = bound_ms(n_bytes, flops, F32_FLOPS)
        # K12's function also writes its stats row (its partial rows are
        # the design's own workspace, not the function's bytes)
        s_b, s_by = bound_ms(n_bytes + 40, flops, F32_FLOPS)
        print(f"  time D at the {what}: graph replay {lib_str(graph)}, eager "
              f"{eager:.4f} ms; SDPA {lib_str(lib)} ({graph[0] / lib[0]:.2f}x); "
              f"bound {b_ms:.7f} ms ({b_by})", flush=True)
        print(f"  time K12 at the {what}: graph replay {lib_str(graph_s)} "
              f"({graph_s[0] / graph[0]:.3f}x D), eager {eager_s:.4f} ms; "
              f"bound {s_b:.7f} ms ({s_by})", flush=True)
        base = dict(library_ms=lib[0], library_spread_ms=list(lib[1]),
                    cluster=sched.cluster, rank_pages=sched.rank_pages)
        res[what] = dict(
            D=dict(ms=graph[0], graph_spread_ms=list(graph[1]), eager_ms=eager,
                   bound_ms=b_ms, bound_by=b_by, max_abs_err=d_err, **base),
            K12=dict(ms=graph_s[0], graph_spread_ms=list(graph_s[1]),
                     eager_ms=eager_s, bound_ms=s_b, bound_by=s_by,
                     max_abs_err=s_err, **base))
        if what == "serve arena":
            plain = cuda_time(lambda: paged_attn_decode_reference(q, *args, **kw),
                              reps=1, warmup=0)
            s_plain = cuda_time(lambda: paged_attn_decode_stats_reference(
                q, *args, **kw), reps=1, warmup=0)
            print(f"  plain versions at the {what}: D {plain:.2f} ms, K12 "
                  f"{s_plain:.2f} ms", flush=True)
            res[what]["D"]["plain_ms"] = plain
            res[what]["K12"]["plain_ms"] = s_plain
    # the kernels line: the serve arena's numbers, the other shapes beside
    out = {}
    for k in ("D", "K12"):
        out[k] = dict(res["serve arena"][k])
        out[k]["max_abs_err"] = max(r[k]["max_abs_err"] for r in res.values())
        out[k]["at"] = {w: {x: r[k][x] for x in ("ms", "graph_spread_ms",
                                                 "eager_ms", "bound_ms",
                                                 "library_ms", "cluster")}
                        for w, r in res.items() if w != "serve arena"}
    return dict(out["D"], stats=out["K12"])


def _p_case(gen, dev, cfg, plan, t, q_off, q_len):
    """P's operands for a T-row slab at ``q_off`` with ``q_len`` live rows:
    a fresh arena holding the sequence's pages in a random order, the
    page row padded to the bucket's width, random q, and SDPA's dense
    bf16 K/V and causal mask over the same values (its yardstick)."""
    from repro_torch.kernels.common import exp2_int
    from repro_torch.quant.qtensor import unpack_block

    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv_len = q_off + q_len
    _, bucket = plan.bucket_for(kv_len)
    width = bucket.max_pages(PAGE)
    n_used = -(-kv_len // PAGE)
    kc, vc, kse, vse = _attn_arena(gen, dev, n_used + 1, kv, dh)
    row = torch.zeros((width,), dtype=torch.int32, device=dev)
    row[:n_used] = (torch.randperm(n_used, generator=gen, device=dev) + 1
                    ).to(torch.int32)
    q = torch.randn((t, h, dh), generator=gen, device=dev)
    rl = row[:n_used].long()

    def dense(codes, se):
        x = unpack_block(codes[rl], 5, 2) * exp2_int(se[rl])[:, None, None, None]
        x = x.permute(1, 0, 2, 3).reshape(kv, -1, dh)[:, :kv_len]
        return x.repeat_interleave(h // kv, dim=0)[None].to(torch.bfloat16)

    # a one-shot prompt's mask is SDPA's own causal one (as in K10's row)
    rows = q_off + torch.arange(q_len, device=dev)
    mask = None if q_off == 0 else (
        torch.arange(kv_len, device=dev)[None, :] <= rows[:, None])[None, None]
    qb = q[:q_len].permute(1, 0, 2)[None].to(torch.bfloat16)
    attended = sum(q_off + r + 1 for r in range(q_len))
    n_bytes = (n_used * kv * PAGE * dh * 2 + q.numel() * 4 * 2 + width * 4
               + n_used * 2 * 4)
    return dict(args=(kc, vc, kse, vse, row, q_off, q_len, kv_len),
                q=q, acc=bucket.acc, sdpa=(qb, dense(kc, kse), dense(vc, vse), mask),
                bytes=n_bytes, flops=4 * attended * dh * h)


def _p_check(label, cases, dev) -> float:
    """P bitwise its plain version on the cases' random q and on lattice q;
    padded rows exactly 0; one launch a call."""
    from repro_torch.kernels.attention import (
        flash_prefill_paged, flash_prefill_paged_reference)
    from repro_torch.quant.formats import FP8_152

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    err = 0.0
    for c in cases:
        kw = dict(kv_fmt=FP8_152, acc=c["acc"])
        for what, q in (("random q", c["q"]),
                        ("lattice q", _lattice(gen, tuple(c["q"].shape), dev))):
            n0 = flash_prefill_paged.launches
            got = flash_prefill_paged(q, *c["args"], **kw)
            check(flash_prefill_paged.launches == n0 + q.is_cuda,
                  f"P {label}: not one launch a call")
            err = max(err, _attn_check(
                f"P {label} T={q.shape[0]} q_offset {c['args'][5]} {what}",
                got, flash_prefill_paged_reference(q, *c["args"], **kw),
                c["acc"], bitwise=True))
            check(bool((got[c["args"][6]:] == 0).all()),
                  f"P {label}: padded rows are not exactly 0")
    return err


def _p_time(label, cases, plain_reps=1) -> dict:
    """P over the cases' calls in sequence: as a CUDA graph replay (the
    kernel's card time), eagerly (CUDA events, the host's share in it),
    the plain version once, SDPA over the same values, the bound and the
    CUDA-core bound of the design's rounded mul-then-add."""
    from repro_torch.kernels.attention import (
        flash_prefill_paged, flash_prefill_paged_reference)
    from repro_torch.quant.formats import FP8_152

    def run(fn):
        for c in cases:
            fn(c["q"], *c["args"], kv_fmt=FP8_152, acc=c["acc"])

    graph = lib_time(lambda: run(flash_prefill_paged), reps=20)
    eager = cuda_time(lambda: run(flash_prefill_paged), reps=20)
    plain = cuda_time(lambda: run(flash_prefill_paged_reference),
                      reps=plain_reps, warmup=0)

    def sdpa():
        for c in cases:
            qb, kb, vb, mask = c["sdpa"]
            torch.nn.functional.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=mask, is_causal=mask is None)

    lib = lib_time(sdpa, reps=20)
    b_ms, b_by = seq_bound([(c["bytes"], c["flops"], F32_FLOPS) for c in cases])
    ma_ms = 2 * sum(c["flops"] for c in cases) / F32_FLOPS * 1e3
    print(f"  time P {label} ({len(cases)} launches): graph replay "
          f"{lib_str(graph)}, eager {eager:.4f} ms, plain {plain:.2f} ms, "
          f"SDPA {lib_str(lib)} ({graph[0] / lib[0]:.2f}x); bound {b_ms:.6f} "
          f"ms ({b_by}), {b_ms / graph[0]:.4f} of it; mul-then-add bound "
          f"{ma_ms:.6f} ms, {ma_ms / graph[0]:.4f} of it", flush=True)
    return dict(ms=graph[0], graph_spread_ms=list(graph[1]), eager_ms=eager,
                plain_ms=plain, library_ms=lib[0],
                library_spread_ms=list(lib[1]), bound_ms=b_ms, bound_by=b_by,
                mul_add_bound_ms=ma_ms)


def phase_prefill(cfg, dev, plan) -> dict:
    """P (``flash_prefill_paged``) at three shapes: a 64-token slab at
    q_offset 320 (the serve cell's slab run), the 8 serve prompts' one-shot
    calls (K10's row does the same work) and a 2048-token one-shot prompt
    under the plan's bucket for it; bitwise its plain version on random and
    lattice q, each timed as a CUDA graph replay and eagerly beside SDPA
    and the bound."""
    from repro_torch.kernels import sm90

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    shapes = {"slab": [(SLAB, 320, SLAB)],
              "8 one-shot prompts": [(n, 0, n) for n in PROMPT_LENS],
              "2048-token prompt": [(2048, 0, 2048)]}
    res, err = {}, 0.0
    for what, calls in shapes.items():
        cases = [_p_case(gen, dev, cfg, plan, *c) for c in calls]
        scheds = [sm90.attn_prefill_schedule(
            t, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, PAGE,
            cfg.head_dim, sm90.prefill_pages(PAGE, q_off, q_len, 0,
                                             q_off + q_len))
            for t, q_off, q_len in calls]
        print(f"[kernels] P flash_prefill_paged vs plain at the {what}: "
              f"H={cfg.n_heads} KV={cfg.n_kv_heads} dh={cfg.head_dim}, "
              f"(T, q_offset) {[c[:2] for c in calls]}, acc "
              f"{sorted({c['acc'] for c in cases})}; (rows, cluster, pages a "
              f"round) {[(s.rows, s.cluster, s.rank_pages) for s in scheds]}",
              flush=True)
        err = max(err, _p_check(what, cases, dev))
        res[what] = _p_time(what, cases)
        del cases
    out = dict(res["slab"], max_abs_err=err)
    out["at"] = {w: {k: r[k] for k in ("ms", "graph_spread_ms", "eager_ms",
                                       "plain_ms", "library_ms", "bound_ms",
                                       "mul_add_bound_ms")}
                 for w, r in res.items() if w != "slab"}
    return out


# --------------------------------------------------------------------------
# phase 3: the serving path at full width and depth
# --------------------------------------------------------------------------


def _counters():
    """Kernel name -> (wrapper, attribute holding its launch count)."""
    from repro_torch.kernels.attention import flash_prefill_paged, paged_attn_decode
    from repro_torch.kernels.fused import qmatmul_fused

    return {"qmatmul_fused": (qmatmul_fused, "launches"),
            "paged_attn_decode": (paged_attn_decode, "launches"),
            "flash_prefill_paged": (flash_prefill_paged, "launches")}


def zero_counts(counters) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counts(counters) -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


@contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain PyTorch versions (for
    the kernels-vs-plain checks only; the port itself never does this)."""
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import bwd_pair as B
    from repro_torch.kernels import fused as F
    from repro_torch.kernels import ops as O
    from repro_torch.models import layers as L

    from repro_torch.kernels import qmatmul as K3
    from repro_torch.kernels import quantize as K2

    saved = (O.qmatmul_fused, O.qmatmul_bwd_pair, O.quantize, O.qmatmul,
             L.paged_attn_decode, L.flash_prefill_paged,
             L.flash_prefill_paged_geom, L.flash_prefill)
    O.qmatmul_fused = F.qmatmul_fused_reference
    O.qmatmul_bwd_pair = B.qmatmul_bwd_pair_reference
    O.quantize = K2.quantize_reference
    O.qmatmul = K3.qmatmul_reference
    L.paged_attn_decode = A.paged_attn_decode_reference
    L.flash_prefill_paged = A.flash_prefill_paged_reference
    L.flash_prefill_paged_geom = A.flash_prefill_paged_geom_reference
    L.flash_prefill = A.flash_prefill_reference
    try:
        yield
    finally:
        (O.qmatmul_fused, O.qmatmul_bwd_pair, O.quantize, O.qmatmul,
         L.paged_attn_decode, L.flash_prefill_paged,
         L.flash_prefill_paged_geom, L.flash_prefill) = saved


@contextmanager
def recording_kernels(calls: dict):
    """Record the serve path's kernel calls (G, D and P's device-geometry
    entry, as the model calls them) into ``calls``: one entry a launch
    shape, ``key -> (args cloned at the call, kwargs)``.  The calls still
    run their kernels."""
    from repro_torch.kernels import ops as O
    from repro_torch.models import layers as L

    def kw_key(kw):
        return repr(sorted(kw.items()))

    shapes = {
        "G": lambda a, b, **kw: (tuple(a.shape), tuple(b.shape), b.stride(),
                                 kw_key(kw)),
        "D": lambda q, *rest, **kw: (tuple(q.shape), tuple(rest[4].shape),
                                     kw_key(kw)),
        "P": lambda q, *rest, **kw: (tuple(q.shape), tuple(rest[4].shape),
                                     kw_key(kw)),
    }

    def recorder(kind, fn):
        def rec(*args, **kw):
            key = (kind,) + shapes[kind](*args, **kw)
            if key not in calls:
                calls[key] = (tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args), dict(kw))
            return fn(*args, **kw)
        return rec

    saved = (O.qmatmul_fused, L.paged_attn_decode, L.flash_prefill_paged_geom)
    O.qmatmul_fused = recorder("G", saved[0])
    L.paged_attn_decode = recorder("D", saved[1])
    L.flash_prefill_paged_geom = recorder("P", saved[2])
    try:
        yield calls
    finally:
        (O.qmatmul_fused, L.paged_attn_decode,
         L.flash_prefill_paged_geom) = saved


def check_recorded(label: str, calls: dict, gen, kinds=("G", "D", "P"),
                   tag: str = "[spec]") -> dict:
    """Each recorded launch shape through its kernel and its plain version:
    G within 1 carry ulp on the recorded operands and bitwise on lattice
    ones of the same shapes and layout; D and P bitwise on the recorded
    query and on a lattice one, P also bitwise its launch-argument entry
    on the live rows with its padded rows exactly 0.  Returns each kernel's
    max |err| on the recorded operands and the shapes checked."""
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import fused as F

    err = {"G": 0.0, "D": 0.0, "P": 0.0}
    seen = {"G": [], "D": [], "P": []}
    for key, (args, kw) in calls.items():
        kind = key[0]
        dev = args[0].device
        if kind == "G":
            a, b = args
            m, e = kw.get("m_acc", 23), kw.get("e_acc", 8)
            tag = f"{label} G {tuple(a.shape)} x {tuple(b.shape)}"
            err["G"] = max(err["G"], compare(
                f"{tag} recorded", F.qmatmul_fused(a, b, **kw),
                F.qmatmul_fused_reference(a, b, **kw), m, e, bitwise=False,
                quiet=True))
            al = _lattice(gen, tuple(a.shape), dev).to(a.dtype)
            bl = torch.empty_like(b)
            bl.copy_(_lattice(gen, tuple(b.shape), dev))
            compare(f"{tag} lattice", F.qmatmul_fused(al, bl, **kw),
                    F.qmatmul_fused_reference(al, bl, **kw), m, e,
                    bitwise=True, quiet=True)
            seen["G"].append((tuple(a.shape), tuple(b.shape)))
            continue
        q, rest = args[0], args[1:]
        ql = _lattice(gen, tuple(q.shape), dev).to(q.dtype)
        if kind == "D":
            tag = f"{label} D q {tuple(q.shape)} table {tuple(rest[4].shape)}"
            for what, qq in (("recorded", q), ("lattice", ql)):
                got = A.paged_attn_decode(qq, *rest, **kw)
                want = A.paged_attn_decode_reference(qq, *rest, **kw)
                check(torch.equal(got, want), f"{tag} {what}: not bitwise "
                                              "its plain version")
                if what == "recorded":
                    err["D"] = max(err["D"], float((got - want).abs().max()))
            seen["D"].append((tuple(q.shape), tuple(rest[4].shape)))
            continue
        geom = rest[5]
        q0, q_len, kv_len, _ = (int(x) for x in geom.tolist())
        tag = (f"{label} P(geom) T {q.shape[0]} row {rest[4].shape[0]} "
               f"({q0}, {q_len})")
        for what, qq in (("recorded", q), ("lattice", ql)):
            got = A.flash_prefill_paged_geom(qq, *rest, **kw)
            want = A.flash_prefill_paged_geom_reference(qq, *rest, **kw)
            host = A.flash_prefill_paged(qq[:q_len].contiguous(), *rest[:5],
                                         q0, q_len, kv_len, **kw)
            check(torch.equal(got, want), f"{tag} {what}: not bitwise its "
                                          "plain version")
            check(torch.equal(got[:q_len], host), f"{tag} {what}: not bitwise "
                                                  "the launch-argument P")
            check(bool((got[q_len:] == 0).all()), f"{tag} {what}: padded "
                                                  "rows are not exactly 0")
            if what == "recorded":
                err["P"] = max(err["P"], float((got - want).abs().max()))
        seen["P"].append((q.shape[0], rest[4].shape[0], q0, q_len))
    print(f"{tag} {label}: {len(calls)} launch shapes recorded and held "
          f"against the plain versions (G within 1 carry ulp on the recorded "
          f"operands, bitwise on lattice ones; D and P bitwise): G (M, K) x "
          f"(K, N) {seen['G']}; D (q, table) {seen['D']}; P (T, row width, "
          f"q_offset, q_len) {seen['P']}; max |err| {err}", flush=True)
    missing = [k for k in kinds if not seen[k]]
    check(not missing, f"{label}: kernels {missing} of the path were not "
                       "recorded")
    return dict(err=err, shapes=seen)


def build_engine(cfg, params, dev, prefill_chunk, graphs=False, spec=None,
                 n_pages=None, **engine_kw):
    """The serve cell's engine with a host-clocked executor: eager by
    default (the bitwise reference of the graphed runs), on CUDA graphs
    with ``graphs``; ``spec`` (a dict of ``SpecDecodeEngine`` arguments)
    makes it a speculative engine."""
    from repro_torch.models.api import get_model
    from repro_torch.serve import scheduler as S
    from repro_torch.serve.kvcache import PagedKVConfig
    from repro_torch.quant.formats import FPFormat

    class TimedExecutor(S.ModelExecutor):
        """Host-clock time of every prefill slab and decode step; each call
        ends in a device-to-host read of its tokens, so the clock covers
        the device work."""

        prefill_s = decode_s = 0.0

        def prefill(self, req):
            t0 = time.perf_counter()
            out = super().prefill(req)
            self.prefill_s += time.perf_counter() - t0
            return out

        def decode(self, req):
            t0 = time.perf_counter()
            out = super().decode(req)
            self.decode_s += time.perf_counter() - t0
            return out

    model = get_model(cfg)
    n_pages = n_pages or serve_pages()
    pc = PagedKVConfig.for_model(cfg, n_pages=n_pages, page_size=PAGE)
    ex = TimedExecutor(model, params, pc, kv_fmt=FPFormat(5, 2),
                       max_batch=MAX_BATCH, device=dev, graphs=graphs)
    kw = dict(n_pages=n_pages, page_size=PAGE, max_batch=MAX_BATCH,
              prefill_chunk_tokens=prefill_chunk, executor=ex, device=dev,
              **engine_kw)
    if spec is not None:
        from repro_torch.serve.spec import SpecDecodeEngine

        eng = SpecDecodeEngine(model, params, **spec, **kw)
        executors = (ex, eng.draft_executor)
    else:
        eng = S.ServeEngine(model, params, **kw)
        executors = (ex,)
    if graphs:
        GRAPH_EXECUTORS.extend((weakref.ref(e), e._cache) for e in executors)
    return eng


def serve_pages() -> int:
    """The serve cell's pool: its requests' tokens and 25%, as the
    launcher sizes it, and the null page."""
    return -(-int(sum(n + GEN for n in PROMPT_LENS) * 1.25) // PAGE) + 1


# (weak reference, cache entry) of every graph executor ``build_engine``
# made: ``phase_graph_teardown`` checks they are all released
GRAPH_EXECUTORS: list = []


def phase_serve(cfg, params, dev, prompts, prefill_chunk) -> dict:
    from repro_torch.kernels.fused import qmatmul_fused

    counters = _counters()
    eng = build_engine(cfg, params, dev, prefill_chunk)
    rids = [eng.submit(p, GEN) for p in prompts]
    zero_counts(counters)
    qmatmul_fused.fold_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(counters)
    folds = qmatmul_fused.fold_launches
    ex = eng.executor
    label = f"chunk={prefill_chunk or 'one-shot'}"
    print(f"[serve] {label}: {len(rids)} requests, prompts {list(PROMPT_LENS)}, "
          f"gen {GEN}: {eng.decoded_tokens} decoded tokens in {dt:.3f}s "
          f"({eng.decoded_tokens / dt:.1f} tok/s end to end); decode steps "
          f"{ex.decode_s:.3f}s ({eng.decoded_tokens / ex.decode_s:.1f} tok/s); "
          f"prefill {eng.prefill_tokens} tokens in {eng.prefill_slabs} slabs, "
          f"{ex.prefill_s:.3f}s ({eng.prefill_tokens / ex.prefill_s:.1f} "
          f"tok/s); KV bytes/token {eng.kv_bytes_per_token():.1f}; "
          f"preemptions {eng.preemptions}; launches {launches} (G's count "
          f"is of calls; its split calls' fold kernels: {folds} launches)",
          flush=True)
    for k, v in launches.items():
        check(v > 0, f"{label}: kernel {k} was not launched on the main path")
    check(folds > 0, f"{label}: G's split decode route was not taken")
    check(all(len(results[r]) == GEN for r in rids), f"{label}: short stream")
    vocab = cfg.vocab_size
    check(all(0 <= t < vocab for r in rids for t in results[r]),
          f"{label}: token out of range")
    eng.pool.check_invariants()
    check(eng.pool.free_pages == eng.pool.n_pages - 1, f"{label}: page leak")
    return dict(launches=launches, fold_launches=folds,
                streams=[results[r] for r in rids],
                arena={k: v.clone() for k, v in ex.kv.items()},
                seconds=dt, decoded=eng.decoded_tokens,
                decode_s=ex.decode_s, prefill_s=ex.prefill_s,
                prefill_tokens=eng.prefill_tokens)


MONITOR_CADENCE = 4
MONITOR_LOG = ROOT / "build" / "monitor.jsonl"      # gitignored


def phase_serve_monitor(cfg, params, dev, prompts, one_shot) -> dict:
    """The one-shot serving run again with the serve-time VRR monitor
    (``monitor_cadence`` 4: K12 on the longest context's layer-0 pages);
    its streams equal the monitor-off run's unless it re-buckets.  Then a
    plan forced to a 1-bit carry (``m_acc`` 1 in every bucket) on the two
    longest prompts, whose monitor must log a re-bucket."""
    from dataclasses import replace

    from repro_torch.kernels.attention import paged_attn_decode
    from repro_torch.serve.plan import plan_attention

    counters = dict(_counters(), **{
        K12_NAME: (paged_attn_decode, "stats_launches")})
    MONITOR_LOG.unlink(missing_ok=True)
    eng = build_engine(cfg, params, dev, None,
                       monitor_cadence=MONITOR_CADENCE,
                       monitor_log=str(MONITOR_LOG), seed=SEED)
    rids = [eng.submit(p, GEN) for p in prompts]
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(counters)
    kinds = [e["event"] for e in eng.events]
    streams = [results[r] for r in rids]
    same = sum(a == b for a, b in zip(streams, one_shot["streams"]))
    print(f"[serve] monitor every {MONITOR_CADENCE} decode steps: "
          f"{len(kinds)} ticks ({kinds.count('rebucket')} rebucket, "
          f"{kinds.count('ok')} ok), swamp rates "
          f"{[e['swamp_rate'] for e in eng.events]}, {dt:.3f}s end to end "
          f"({dt - one_shot['seconds']:+.3f}s against the monitor-off run), "
          f"{same}/{len(rids)} streams equal the monitor-off run's, "
          f"launches {launches}", flush=True)
    for k, v in launches.items():
        check(v > 0, f"monitored run: kernel {k} was not launched")
    check(launches[K12_NAME] == len(kinds), "one K12 call per tick")
    check(sum(1 for _ in open(MONITOR_LOG)) == len(kinds),
          "the monitor log lost events")
    if "rebucket" not in kinds:
        check(same == len(rids), "the monitor changed a stream without "
                                 "re-bucketing")
    plan = plan_attention(eng.pc.tokens_capacity, PAGE)
    narrow = replace(plan, buckets=tuple(replace(b, m_acc=1)
                                         for b in plan.buckets))
    eng = build_engine(cfg, params, dev, None, plan=narrow,
                       monitor_cadence=MONITOR_CADENCE, seed=SEED)
    for p in prompts[-2:]:
        eng.submit(p, GEN)
    zero_counts(counters)
    eng.run()
    n12 = read_counts(counters)[K12_NAME]
    kinds = [e["event"] for e in eng.events]
    first = next((e for e in eng.events if e["event"] == "rebucket"), None)
    print(f"[serve] forced 1-bit carry plan: {len(kinds)} ticks, "
          f"{kinds.count('rebucket')} rebucket; first rebucket "
          f"{json.dumps(first)}; bucket m_acc now "
          f"{[b.m_acc for b in eng.plan.buckets]}", flush=True)
    check(first is not None, "the forced narrow plan did not re-bucket")
    return dict(launches=launches[K12_NAME] + n12, events=len(kinds))


# --------------------------------------------------------------------------
# [serve-graph]: serving's compiled step, CUDA graphs behind the cache
# --------------------------------------------------------------------------

P_GEOM_NAME = "flash_prefill_paged(geom)"   # P's device-geometry entry


def _graph_counters():
    """The graphed serve path's kernels: G, D and P's device-geometry
    entry (the launch-argument P must stay at 0 there)."""
    from repro_torch.kernels.attention import (
        flash_prefill_paged, flash_prefill_paged_geom, paged_attn_decode)
    from repro_torch.kernels.fused import qmatmul_fused

    return {"qmatmul_fused": (qmatmul_fused, "launches"),
            "qmatmul_fused fold": (qmatmul_fused, "fold_launches"),
            "paged_attn_decode": (paged_attn_decode, "launches"),
            P_GEOM_NAME: (flash_prefill_paged_geom, "launches"),
            "flash_prefill_paged": (flash_prefill_paged, "launches")}


def _same_arena(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def phase_serve_graph(cfg, params, dev, prompts, eager_runs) -> dict:
    """The serve cell on CUDA graphs (``ModelExecutor(graphs=True)``),
    warmed, one-shot and with ``SLAB``-token slabs: every stream and the
    arena after the run bitwise the eager ``[serve]`` run's, 0 captures and
    0 misses after the warmup, hits > 0; the warmup's captures and
    seconds, decode-steps-only and end-to-end tokens/s beside the eager
    run's in this call, each kernel's launches counted over the replays
    and the executor's graph pool bytes."""
    counters = _graph_counters()
    out = {}
    for chunk, eager in zip((None, SLAB), eager_runs):
        label = f"chunk={chunk or 'one-shot'}"
        eng = build_engine(cfg, params, dev, chunk, graphs=True)
        ex = eng.executor
        warm = eng.warmup()
        check(warm["compiles"] > 0, f"[serve-graph] {label}: nothing captured")
        ex.prefill_s = ex.decode_s = 0.0
        rids = [eng.submit(p, GEN) for p in prompts]
        zero_counts(counters)
        torch.cuda.synchronize()
        with ex.compile_stats_scope() as delta:
            t0 = time.perf_counter()
            results = eng.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = read_counts(counters)
        streams = [results[r] for r in rids]
        same = sum(a == b for a, b in zip(streams, eager["streams"]))
        arena = _same_arena(ex.kv, eager["arena"])
        pool = ex.pool_bytes()
        print(f"[serve-graph] {label}: warmup {warm['compiles']} captures in "
              f"{warm['seconds']:.2f}s over {warm['buckets']} buckets; "
              f"{eng.decoded_tokens} decoded tokens in {dt:.3f}s "
              f"({eng.decoded_tokens / dt:.1f} tok/s end to end; eager "
              f"{eager['decoded'] / eager['seconds']:.1f}); decode steps "
              f"{ex.decode_s:.3f}s ({eng.decoded_tokens / ex.decode_s:.1f} "
              f"tok/s; eager {eager['decoded'] / eager['decode_s']:.1f}, "
              f"{eager['decode_s'] / ex.decode_s:.2f}x); prefill "
              f"{eng.prefill_tokens} tokens in {ex.prefill_s:.3f}s (eager "
              f"{eager['prefill_s']:.3f}s); steady state {delta}; launches "
              f"over the replays {launches}; graph pool "
              f"{pool / 2**20:.1f} MiB; {same}/{len(rids)} streams and the "
              f"arena {'bitwise' if arena else 'DIFFERENT'} against the "
              f"eager run", flush=True)
        check(same == len(rids), f"[serve-graph] {label}: a stream differs "
                                 "from the eager run's")
        check(arena, f"[serve-graph] {label}: the arena differs from the "
                     "eager run's")
        check(delta["compiles"] == 0 and delta["misses"] == 0
              and delta["hits"] > 0,
              f"[serve-graph] {label}: steady-state captures {delta}")
        for k in ("qmatmul_fused", "qmatmul_fused fold", "paged_attn_decode",
                  P_GEOM_NAME):
            check(launches[k] > 0, f"[serve-graph] {label}: kernel {k} was "
                                   "not launched on the main path")
        check(launches["flash_prefill_paged"] == 0,
              f"[serve-graph] {label}: the launch-argument P ran")
        eng.pool.check_invariants()
        out[label] = dict(launches=launches, warm=warm, seconds=dt,
                          decode_s=ex.decode_s, prefill_s=ex.prefill_s,
                          decoded=eng.decoded_tokens, pool_bytes=pool,
                          eager_decode_s=eager["decode_s"],
                          eager_seconds=eager["seconds"], streams=streams,
                          arena={k: v.clone() for k, v in ex.kv.items()},
                          executor=ex)
        del eng, ex
        gc.collect()
    return out


P_GEOM_CASES = 22


def _p_geom_case(label, q, q_len, arena, row, t0, kw) -> float:
    """P's device-geometry entry at one geometry: bitwise the
    launch-argument entry on the live rows and its plain version, padded
    rows exactly 0.  Returns max |err| against the plain version."""
    from repro_torch.kernels.attention import (
        flash_prefill_paged, flash_prefill_paged_geom,
        flash_prefill_paged_geom_reference, prefill_geom)

    geom = prefill_geom(t0, q_len, device=q.device)
    got = flash_prefill_paged_geom(q, *arena, row, geom, **kw)
    host = flash_prefill_paged(q[:q_len].contiguous(), *arena, row, t0,
                               q_len, t0 + q_len, **kw)
    plain = flash_prefill_paged_geom_reference(q, *arena, row, geom, **kw)
    check(torch.equal(got[:q_len], host),
          f"P geom {label}: not bitwise the launch-argument P")
    check(torch.equal(got, plain), f"P geom {label}: not bitwise its plain "
                                   "version")
    check(bool((got[q_len:] == 0).all()),
          f"P geom {label}: padded rows are not exactly 0")
    return float((got - plain).abs().max())


def _serve_p_shapes(plan) -> list:
    """The (T, row width, q_offset, q_len, bucket) launches of P's
    device-geometry entry in the ``[serve-graph]`` runs: each prompt
    one-shot (T its bucket's max_ctx, as the one-shot run pads it) and its
    first and last ``SLAB``-token slabs (T ``SLAB``), both over the row
    of the prompt's bucket."""
    out = {}
    for n in PROMPT_LENS:
        _, b = plan.bucket_for(n)
        w = b.max_pages(PAGE)
        out.setdefault((b.max_ctx, w, 0, n), b)
        for t0 in sorted({0, SLAB * ((n - 1) // SLAB)}):
            out.setdefault((SLAB, w, t0, min(SLAB, n - t0)), b)
    return [k + (b,) for k, b in out.items()]


def phase_p_geom(cfg, dev, plan) -> dict:
    """P's device-geometry entry at qwen2-1.5b's widths, bitwise the
    launch-argument entry on the live rows and the plain version, padded
    rows exactly 0, on random and lattice q: at a 64-token slab over a
    24-page row (kv up to 384 tokens) on ``P_GEOM_CASES`` geometries
    (ragged tails, single rows, page-aligned offsets), then at every launch
    shape of the ``[serve-graph]`` runs (``_serve_p_shapes``: the one-shot
    padded slabs at T 64, 256 and 1024 and the 64-token slabs over each
    bucket's row, each schedule the main path picks; the padded q rows
    random, as the main path's are not 0); timed by graph replay beside
    the launch-argument entry on the serve slab (q_offset 320), with the
    plain version, SDPA and the bound."""
    from repro_torch.kernels import sm90
    from repro_torch.kernels.attention import (
        flash_prefill_paged, flash_prefill_paged_geom,
        flash_prefill_paged_geom_reference, prefill_geom)
    from repro_torch.quant.formats import FP8_152

    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    width, t = 24, SLAB
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    arena = _attn_arena(gen, dev, width + 1, kv, dh)
    row = (torch.randperm(width, generator=gen, device=dev) + 1).to(
        torch.int32)
    rng = np.random.RandomState(SEED + 61)
    geoms = [(320, SLAB), (0, SLAB), (0, 1), (368, 16), (0, 17)] + [
        (PAGE * int(rng.randint(0, width - SLAB // PAGE + 1)),
         int(rng.randint(1, SLAB + 1))) for _ in range(P_GEOM_CASES - 5)]
    sched = sm90.attn_prefill_schedule(t, kv, h // kv, PAGE, dh, width)
    print(f"[kernels] P {P_GEOM_NAME} vs the launch-argument entry and the "
          f"plain version: T={t}, a {width}-page row, {len(geoms)} "
          f"geometries (q_offset, q_len) {geoms}; schedule from the shapes "
          f"(rows, cluster, pages a round) ({sched.rows}, {sched.cluster}, "
          f"{sched.rank_pages})", flush=True)
    err = 0.0
    for i, (t0, q_len) in enumerate(geoms):
        _, bucket = plan.bucket_for(t0 + q_len)
        kw = dict(kv_fmt=FP8_152, acc=bucket.acc)
        q = torch.zeros((t, h, dh), device=dev)
        q[:q_len] = (_lattice(gen, (q_len, h, dh), dev) if i % 2 else
                     torch.randn((q_len, h, dh), generator=gen, device=dev))
        err = max(err, _p_geom_case(f"({t0}, {q_len})", q, q_len, arena,
                                    row, t0, kw))
    print(f"  {len(geoms)}/{len(geoms)} geometries bitwise the "
          "launch-argument entry and the plain version, padded rows 0",
          flush=True)
    # the [serve-graph] runs' own launch shapes, over a serve-like arena:
    # page 0 the null page (zeros), the row's pages past the live ones 0
    shapes = _serve_p_shapes(plan)
    n_arena = 1 + max(w for _, w, _, _, _ in shapes)
    arena = _attn_arena(gen, dev, n_arena, kv, dh)
    for x in arena:
        x[0] = 0
    perm = (torch.randperm(n_arena - 1, generator=gen, device=dev) + 1).to(
        torch.int32)
    scheds = {}
    t_start = time.perf_counter()
    for tt, w, t0, q_len, b in shapes:
        row = torch.zeros((w,), dtype=torch.int32, device=dev)
        used = -(-(t0 + q_len) // PAGE)
        row[:used] = perm[:used]
        kw = dict(kv_fmt=FP8_152, acc=b.acc)
        for kind in ("random", "lattice"):
            q = (_lattice(gen, (tt, h, dh), dev) if kind == "lattice" else
                 torch.randn((tt, h, dh), generator=gen, device=dev))
            err = max(err, _p_geom_case(
                f"T {tt} row {w} ({t0}, {q_len}) {kind}", q, q_len, arena,
                row, t0, kw))
        sc = sm90.attn_prefill_schedule(tt, kv, h // kv, PAGE, dh, w)
        scheds[(tt, w)] = (sc.rows, sc.cluster, sc.rank_pages)
    print(f"  the [serve-graph] launch shapes: {len(shapes)} (T, row width, "
          f"q_offset, q_len) {[s[:4] for s in shapes]}, random and lattice "
          f"q, bitwise the launch-argument entry and the plain version, "
          f"padded rows 0 ({time.perf_counter() - t_start:.1f}s); schedules "
          f"(T, width) -> (rows, cluster, pages a round) {scheds}",
          flush=True)
    # timing at the serve slab: q_offset 320, 64 live rows
    case = _p_case(gen, dev, cfg, plan, SLAB, 320, SLAB)
    kc2, vc2, kse2, vse2, row2, q_off, q_len, kv_len = case["args"]
    kw = dict(kv_fmt=FP8_152, acc=case["acc"])
    geom = prefill_geom(q_off, q_len, device=dev)
    q = case["q"]
    run_geom = lambda: flash_prefill_paged_geom(q, kc2, vc2, kse2, vse2,
                                                row2, geom, **kw)
    run_host = lambda: flash_prefill_paged(q, kc2, vc2, kse2, vse2, row2,
                                           q_off, q_len, kv_len, **kw)
    check(torch.equal(run_geom(), run_host()), "P geom at the slab")
    graph, host = lib_time(run_geom, reps=20), lib_time(run_host, reps=20)
    eager = cuda_time(run_geom, reps=20)
    plain = cuda_time(lambda: flash_prefill_paged_geom_reference(
        q, kc2, vc2, kse2, vse2, row2, geom, **kw), reps=1, warmup=0)
    qb, kb, vb, mask = case["sdpa"]
    lib = lib_time(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask), reps=20)
    b_ms, b_by = bound_ms(case["bytes"] + 16, case["flops"], F32_FLOPS)
    print(f"  time P geom at the slab (q_offset 320, row width "
          f"{row2.shape[0]}): graph replay {lib_str(graph)} beside the "
          f"launch-argument entry {lib_str(host)} ({graph[0] / host[0]:.3f}x), "
          f"eager {eager:.4f} ms, plain {plain:.2f} ms, SDPA {lib_str(lib)} "
          f"({graph[0] / lib[0]:.2f}x); bound {b_ms:.6f} ms ({b_by})",
          flush=True)
    return dict(ms=graph[0], graph_spread_ms=list(graph[1]), eager_ms=eager,
                host_entry_ms=host[0], host_entry_spread_ms=list(host[1]),
                plain_ms=plain, library_ms=lib[0],
                library_spread_ms=list(lib[1]), bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, geometries=len(geoms),
                serve_shapes=len(shapes))


def phase_graph_teardown(allocated_before: int) -> dict:
    """After ``[serve-graph]`` and ``[spec]``: every graph executor they
    built is collected, the process cache holds none of their graphs or
    pools, and the card's allocated memory is back within
    ``TEARDOWN_SLACK`` of where it stood before them (the pools, the draft
    weights and the arenas are not carried into the training phases)."""
    gc.collect()
    torch.cuda.empty_cache()
    alive = sum(ref() is not None for ref, _ in GRAPH_EXECUTORS)
    held = sum(bool(e["fns"]) or e["pool"] is not None
               for _, e in GRAPH_EXECUTORS)
    now = torch.cuda.memory_allocated()
    print(f"[serve-graph] teardown: {len(GRAPH_EXECUTORS)} graph executors, "
          f"{alive} alive, {held} cache entries still holding graphs; "
          f"allocated {now / 2**20:.1f} MiB against {allocated_before / 2**20:.1f}"
          f" MiB before [serve-graph], reserved "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB", flush=True)
    check(alive == 0, "a graph executor outlived its engine")
    check(held == 0, "the process cache kept a dead executor's graphs")
    check(now <= allocated_before + TEARDOWN_SLACK,
          f"{(now - allocated_before) / 2**20:.1f} MiB still allocated after "
          "the graphed phases")
    return dict(allocated=now, before=allocated_before)


# what a library may keep after the graphed phases (cuBLAS's workspace of
# the capture stream): far below a graph pool or the draft's weights
TEARDOWN_SLACK = 256 * 2**20


# --------------------------------------------------------------------------
# [spec]: speculative decoding with a qwen2-0.5b draft
# --------------------------------------------------------------------------


def _draft(cfg_target, dev):
    """qwen2-0.5b planned as the target (predicted, chunk 64) and its bf16
    weights seeded from SEED + 7, as ``launch/serve.py --spec-decode``
    seeds them."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.models.api import get_model

    max_ctx = max(PROMPT_LENS) + GEN
    dcfg = plan_for_model(get_config("qwen2-0.5b"), seq_len=max_ctx,
                          global_batch=len(PROMPT_LENS),
                          policy=AccumulationPolicy(mode="predicted",
                                                    chunk=64))
    check(dcfg.vocab_size == cfg_target.vocab_size, "draft vocab differs")
    model = get_model(dcfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    params = model.init_params(gen, dev)

    def bf16(t):
        return ({k: bf16(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to(torch.bfloat16))

    return model, bf16(params)


def _draft_kernels(cfg, params, dev, prompts, one_shot, dmodel,
                   dparams) -> dict:
    """The draft lane's kernels at the launch shapes ``[spec]`` gives them,
    held against their plain versions (``check_recorded``): a spec engine's
    draft executor primes each prompt (a one-shot ``final=False`` slab at
    its draft bucket's width: P's device-geometry entry at dh 64 and G at
    d 896 / d_ff 4864) and runs one batched draft step over the 8 rows (G
    at M 8 with the head, D at g 7, dh 64, the table at the round's
    bucket), eagerly through the step functions its graphs capture, with
    every kernel call recorded."""
    from repro_torch.models.api import DecodeRequest, PrefillRequest

    eng = build_engine(cfg, params, dev, None, graphs=True,
                       spec=dict(spec_k=SPEC_K, draft_model=dmodel,
                                 draft_params=dparams))
    ex, plan, pool = eng.draft_executor, eng.draft_plan, eng.draft_pool
    calls: dict = {}
    with recording_kernels(calls):
        for rid, p in enumerate(prompts):
            n = len(p)
            pages = pool.allocate(rid, n)
            bi, bucket = plan.bucket_for(n)
            req = PrefillRequest(
                rid=rid, tokens=tuple(p), hist_pages=(),
                slab_pages=tuple(pages), t0=0, acc=bucket.acc, final=False,
                bucket_pages=bucket.max_pages(PAGE),
                slab_width=bucket.max_ctx,
                call=plan.kernel_call(bi, kv_fmt=ex.kv_fmt))
            slab_w, width, values = ex._prefill_inputs(req)
            ex._eager(ex._prefill_fn(req.acc, width, slab_w, False,
                                     req.call), values)
        rids = list(range(len(prompts)))
        for rid in rids:
            pool.extend(rid, SPEC_K)       # the round's pos + k, as _draft_ready
        _, bucket = plan.bucket_for(max(pool.seq_len(r) for r in rids))
        pt = pool.page_table(rids, bucket.max_pages(PAGE))
        req = DecodeRequest(
            rids=tuple(rids),
            last_tokens=tuple(s[0] for s in one_shot["streams"]),
            page_table=tuple(tuple(r) for r in pt.tolist()),
            positions=tuple(len(p) for p in prompts),
            seq_lens=tuple(len(p) + 1 for p in prompts), acc=bucket.acc)
        _, width, values = ex._batch_inputs(
            req, np.asarray(req.last_tokens, np.int32))
        ex._eager(ex._decode_fn(req.acc, width), values)
    torch.cuda.synchronize()
    del eng, ex
    gen = torch.Generator(device=dev).manual_seed(SEED + 73)
    out = check_recorded("qwen2-0.5b draft lane", calls, gen)
    del calls
    gc.collect()
    return out


def _spec_run(cfg, params, dev, prompts, label, draft_model, draft_params,
              obs: bool = False):
    """One speculative run on graphs; with ``obs`` a tracer and a registry
    on the engine, whose spans (draft, verify and rollback among them) and
    ``repro_serve_spec_*`` counters are checked against the engine's."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer, span_forest

    tracer = Tracer() if obs else None
    registry = MetricsRegistry() if obs else None
    eng = build_engine(cfg, params, dev, None, graphs=True,
                       spec=dict(spec_k=SPEC_K, draft_model=draft_model,
                                 draft_params=draft_params),
                       tracer=tracer, metrics=registry)
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = (eng.compile_stats()["warm_compiles"],
            eng.draft_executor.compile_stats()["warm_compiles"])
    rids = [eng.submit(p, GEN) for p in prompts]
    with eng.executor.compile_stats_scope() as d_t, \
            eng.draft_executor.compile_stats_scope() as d_d:
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    rec = dict(streams=[results[r] for r in rids], seconds=dt,
               rounds=eng.spec_rounds, proposed=eng.spec_proposed,
               accepted=eng.spec_accepted, emitted=eng.spec_emitted,
               rollback=eng.spec_rollback_tokens,
               fallback=eng.fallback_rows, primes=eng.draft_primes,
               events=[e for e in eng.events if e["event"] == "spec_round"],
               warm=warm, warm_s=warm_s, delta=(d_t, d_d),
               decoded=eng.decoded_tokens,
               pool_bytes=(eng.executor.pool_bytes(),
                           eng.draft_executor.pool_bytes()))
    print(f"[spec] {label}: k={SPEC_K}, warmup {warm[0]} + {warm[1]} (draft) "
          f"captures in {warm_s:.2f}s; {eng.decoded_tokens} tokens in "
          f"{dt:.3f}s ({eng.decoded_tokens / dt:.1f} tok/s end to end); "
          f"{eng.spec_rounds} rounds, acceptance {eng.acceptance_rate():.4f} "
          f"({eng.spec_accepted}/{eng.spec_proposed}), "
          f"{eng.spec_emitted} tokens committed by verify, "
          f"{eng.spec_rollback_tokens} rolled back, {eng.fallback_rows} "
          f"plain-lane rows, {eng.draft_primes} draft primes; steady state "
          f"target {d_t}, draft {d_d}; graph pools "
          f"{rec['pool_bytes'][0] / 2**20:.1f} + "
          f"{rec['pool_bytes'][1] / 2**20:.1f} MiB", flush=True)
    for d in (d_t, d_d):
        check(d["compiles"] == 0 and d["misses"] == 0 and d["hits"] > 0,
              f"[spec] {label}: steady-state captures {d}")
    if obs:
        spans = tracer.to_dicts()
        span_forest(spans)                  # raises on an orphan
        names = {}
        for sp in spans:
            names[sp["name"]] = names.get(sp["name"], 0) + 1
        count = {m["metric"]: m.get("value") for m in registry.snapshot()}
        print(f"[spec] {label}: spans by name {names}; registry rounds "
              f"{count.get('repro_serve_spec_rounds_total')}, rollback "
              f"tokens {count.get('repro_serve_spec_rollback_tokens_total')}"
              f", acceptance {count.get('repro_serve_spec_acceptance_rate')}",
              flush=True)
        check(all(names.get(n, 0) > 0 for n in ("draft", "verify",
                                                 "rollback")),
              f"[spec] {label}: no draft, verify or rollback span")
        check(names.get("request") == len(prompts)
              and count["repro_serve_spec_rounds_total"] == eng.spec_rounds
              and count["repro_serve_spec_rollback_tokens_total"]
              == eng.spec_rollback_tokens,
              f"[spec] {label}: spans or counters disagree with the engine")
        rec["span_names"] = names
    eng.pool.check_invariants()
    check(eng.draft_pool.free_pages == eng.draft_pool.n_pages - 1,
          f"[spec] {label}: draft pages leaked")
    return rec


def _verify_vs_decode(cfg, params, dev, prompts) -> dict:
    """One batch's verify at full width, bitwise k + 1 sequential decode
    steps: the 8 prompts prefilled (eagerly) into an arena, a random
    (k + 1)-token candidate a row, ``lm.paged_verify`` (the GEMMs at B *
    (k + 1) = 40 rows) against 5 ``lm.paged_decode`` steps (8 rows):
    logits and arena bitwise; the verify's kernel calls recorded and held
    against their plain versions (``check_recorded``)."""
    from repro_torch.models import lm
    from repro_torch.models.api import paged_init_state
    from repro_torch.quant.formats import FPFormat
    from repro_torch.serve.plan import plan_attention

    fmt = FPFormat(5, 2)
    s_v = SPEC_K + 1
    plan = plan_attention(2048, PAGE)
    width = plan.bucket_for(max(PROMPT_LENS) + s_v)[1].max_pages(PAGE)
    _, bucket = plan.bucket_for(max(PROMPT_LENS) + s_v)
    b = len(prompts)
    kv = paged_init_state(cfg, n_pages=1 + b * width, page_size=PAGE,
                          device=dev)
    pt = torch.zeros((b, width), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for i, p in enumerate(prompts):
            pages = torch.arange(1 + i * width, 1 + (i + 1) * width,
                                 dtype=torch.int32, device=dev)
            pt[i] = pages
            used = pages[:-(-len(p) // PAGE)].long()
            lm.paged_prefill(params, torch.tensor([p], device=dev), kv,
                             pages, used, 0, len(p), cfg, kv_fmt=fmt,
                             acc=bucket.acc, want_logits=False)
    pos = torch.tensor([len(p) for p in prompts], device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    cand = torch.randint(0, cfg.vocab_size, (b, s_v), generator=gen,
                         device=dev)
    kv_seq = {k: v.clone() for k, v in kv.items()}
    calls: dict = {}
    with torch.no_grad():
        with recording_kernels(calls):
            lv = lm.paged_verify(params, cand, kv, pt, pos,
                                 (pos + 1).to(torch.int32), cfg, kv_fmt=fmt,
                                 acc=bucket.acc)
        same = []
        for j in range(s_v):
            lj = lm.paged_decode(params, cand[:, j:j + 1], kv_seq, pt,
                                 pos + j, (pos + 1 + j).to(torch.int32), cfg,
                                 kv_fmt=fmt, acc=bucket.acc)
            same.append(torch.equal(lv[:, j], lj[:, 0]))
    arena = _same_arena(kv, kv_seq)
    print(f"[spec] verify of {b} rows x {s_v} tokens (GEMMs at {b * s_v} "
          f"rows) vs {s_v} sequential decode steps at full depth: logits "
          f"{sum(same)}/{s_v} slab indices bitwise, arena "
          f"{'bitwise' if arena else 'DIFFERENT'}", flush=True)
    check(all(same) and arena, "[spec] verify is not bitwise the sequential "
                               "decode steps")
    rec = check_recorded("target verify", calls, gen, kinds=("G", "D"))
    return dict(slots=s_v, rows=b, kernels=rec)


def phase_spec(cfg, params, dev, prompts, one_shot) -> dict:
    """``[spec]``: the serve cell's 8 prompts (32 tokens each) through the
    speculative engine on CUDA graphs, warmed, k = 4: with the seeded
    qwen2-0.5b draft (acceptance near 0 on random weights is expected),
    then with draft = target (every round commits k + 1 tokens); each
    stream bitwise the eager ``[serve]`` one-shot run's, 0 steady-state
    captures on both executors; then one batch's verify at full width
    bitwise 5 sequential decode steps, its kernels (G at 40 rows, D at 40
    rows) held against their plain versions at those launch shapes; the
    draft lane's kernels likewise at theirs (``_draft_kernels``)."""
    from repro_torch.models.api import get_model

    dmodel, dparams = _draft(cfg, dev)
    runs = {}
    for label, dm, dp in (("qwen2-0.5b draft", dmodel, dparams),
                          ("draft = target", get_model(cfg), params)):
        # the first run traced and metered ([obs]): its rejections roll back
        r = _spec_run(cfg, params, dev, prompts, label, dm, dp,
                      obs=label == "qwen2-0.5b draft")
        same = sum(a == b for a, b in zip(r["streams"], one_shot["streams"]))
        print(f"[spec] {label}: {same}/{len(prompts)} streams bitwise the "
              f"eager one-shot run's (plain greedy)", flush=True)
        check(same == len(prompts), f"[spec] {label}: a stream differs from "
                                    "plain greedy decode")
        runs[label] = r
        gc.collect()
        torch.cuda.empty_cache()
    dk = _draft_kernels(cfg, params, dev, prompts, one_shot, dmodel, dparams)
    del dparams, dmodel
    full = runs["draft = target"]
    last = {}
    for e in full["events"]:
        last[e["rid"]] = e
    check(full["accepted"] == full["proposed"] > 0,
          "[spec] draft = target: a proposal was rejected")
    check(all(e["emitted"] == SPEC_K + 1 for e in full["events"]
              if e is not last[e["rid"]]),
          "[spec] draft = target: a round committed fewer than k + 1")
    vv = _verify_vs_decode(cfg, params, dev, prompts)
    return dict(runs=runs, verify=vv, draft_kernels=dk)


# --------------------------------------------------------------------------
# [obs], [reserve], [legacy]: the rest of serving and its observability
# --------------------------------------------------------------------------

OBS_SPANS = ROOT / "build" / "spans.jsonl"          # gitignored
OBS_PROM = ROOT / "build" / "serve.prom"            # gitignored
# the [reserve] pool: too small to reserve all 8 requests' final lengths at
# once (97 pages), so reservation holds the last one back
RESERVE_PAGES = 72
LEGACY_ARGV = ("--batch", "4", "--prompt-len", "32", "--gen", "16")


def _obs_checks(label, tracer, registry, streams, launches):
    """One root span per request, each closed with a token event per
    generated token and no orphan; the token counter the tokens
    generated; the registry's Prometheus text (after the process sweep)
    parses, with the launch gauges the counts read.  Returns the TTFT and
    TPOT percentiles from the spans (host seconds)."""
    from repro_torch.obs.metrics import (collect_process_metrics,
                                         kernel_launch_counts,
                                         parse_prometheus)
    from repro_torch.obs.trace import (percentile, request_latencies,
                                       span_forest)

    spans = tracer.to_dicts()
    forest = span_forest(spans)             # raises on an orphan
    roots = [n["span"] for n in forest.values()
             if n["span"]["name"] == "request"]
    check(len(roots) == len(streams) and all(
        r["t_end"] is not None for r in roots),
        f"[obs] {label}: {len(roots)} request roots for {len(streams)} "
        "requests")
    check(all(len([e for e in r["events"] if e["name"] == "token"]) == GEN
              for r in roots), f"[obs] {label}: a root's token events are "
                               "not its tokens")
    generated = sum(len(x) for x in streams)
    collect_process_metrics(registry)
    text = registry.to_prometheus()
    parsed = parse_prometheus(text)
    tokens = parsed[("repro_serve_tokens_total", ())]
    check(tokens == generated, f"[obs] {label}: token counter {tokens} != "
                               f"{generated} generated")
    sweep = kernel_launch_counts()
    for name, n in launches.items():
        key = {P_GEOM_NAME: "flash_prefill_paged_geom",
               "qmatmul_fused fold": "qmatmul_fused.fold"}.get(name, name)
        check(sweep.get(key) == n and parsed[
            ("repro_kernel_launches", (("kernel", key),))] == n,
            f"[obs] {label}: launch gauge of {key} is not its count {n}")
    lats = request_latencies(spans)
    ttft = [r["ttft"] for r in lats]
    tpot = [r["tpot"] for r in lats]
    return dict(spans=len(spans), prom_lines=len(text.splitlines()),
                samples=len(parsed), tokens=tokens,
                ttft=(percentile(ttft, 50), percentile(ttft, 99)),
                tpot=(percentile(tpot, 50), percentile(tpot, 99)),
                text=text, span_dicts=spans)


def phase_obs(cfg, params, dev, prompts, eager_runs, graph_runs) -> dict:
    """``[obs]``: the serve cell's one-shot and ``SLAB``-token runs, eager
    and on CUDA graphs, each with a ``Tracer`` and a ``MetricsRegistry``:
    streams and arena bitwise the same runs without them (``[serve]``,
    ``[serve-graph]``), the checks of ``_obs_checks``, the kernels
    launched, and the end-to-end time against the obs-off run's in this
    call.  The graphed runs are engines of their own on the
    ``[serve-graph]`` runs' warmed executors (no capture: their graphs are
    replayed), whose arena is zeroed in place first, the state the
    obs-off run started from, so that a KV write the obs-on run skipped
    shows in the arena.  The spans of the graphed one-shot run and its
    Prometheus text go to ``build/``."""
    from repro_torch.models.api import get_model
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.scheduler import ServeEngine

    out = {}
    for graphs in (False, True):
        counters = _graph_counters() if graphs else dict(
            _counters(), **{"qmatmul_fused fold": (
                _counters()["qmatmul_fused"][0], "fold_launches")})
        for chunk, base in zip((None, SLAB),
                               eager_runs if not graphs else (
                                   graph_runs["chunk=one-shot"],
                                   graph_runs[f"chunk={SLAB}"])):
            label = (f"{'graphed' if graphs else 'eager'} "
                     f"chunk={chunk or 'one-shot'}")
            tracer, registry = Tracer(), MetricsRegistry()
            if graphs:
                ex = base["executor"]
                for t in ex.kv.values():    # the graphs keep their pointers
                    t.zero_()
                eng = ServeEngine(get_model(cfg), params,
                                  n_pages=serve_pages(), page_size=PAGE,
                                  max_batch=MAX_BATCH,
                                  prefill_chunk_tokens=chunk, executor=ex,
                                  device=dev, tracer=tracer,
                                  metrics=registry)
            else:
                eng = build_engine(cfg, params, dev, chunk, tracer=tracer,
                                   metrics=registry)
            rids = [eng.submit(p, GEN) for p in prompts]
            zero_counts(counters)
            torch.cuda.synchronize()
            with eng.executor.compile_stats_scope() as delta:
                t0 = time.perf_counter()
                results = eng.run()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            launches = read_counts(counters)
            check(not graphs or delta["compiles"] == 0,
                  f"[obs] {label}: captured {delta['compiles']} graphs")
            streams = [results[r] for r in rids]
            same = sum(a == b for a, b in zip(streams, base["streams"]))
            arena = _same_arena(eng.executor.kv, base["arena"])
            for k in ("qmatmul_fused", "paged_attn_decode"):
                check(launches[k] > 0, f"[obs] {label}: {k} not launched")
            r = _obs_checks(label, tracer, registry, streams, launches)
            ratio = dt / base["seconds"]
            print(f"[obs] {label}: {same}/{len(rids)} streams and the arena "
                  f"{'bitwise' if arena else 'DIFFERENT'} against the run "
                  f"without obs; {r['spans']} spans ({len(rids)} request "
                  f"roots), token counter {r['tokens']:.0f}, Prometheus "
                  f"text {r['prom_lines']} lines, {r['samples']} samples "
                  f"parsed; TTFT p50/p99 {r['ttft'][0]:.4f}/"
                  f"{r['ttft'][1]:.4f} s, TPOT p50/p99 {r['tpot'][0]:.4f}/"
                  f"{r['tpot'][1]:.4f} s; end to end {dt:.3f} s against "
                  f"{base['seconds']:.3f} s without obs ({ratio:.3f}x); "
                  f"launches {launches}", flush=True)
            check(same == len(rids) and arena,
                  f"[obs] {label}: obs changed a stream or the arena")
            if graphs and chunk is None:
                OBS_SPANS.unlink(missing_ok=True)
                tracer.export_jsonl(str(OBS_SPANS))
                OBS_PROM.write_text(r["text"])
            out[label] = dict(seconds=dt, base_seconds=base["seconds"],
                              ratio=ratio, launches=launches,
                              **{k: r[k] for k in ("spans", "tokens", "ttft",
                                                   "tpot")})
            eng.pool.check_invariants()
            del eng, tracer, registry
            if graphs:
                del ex
                base.pop("executor")
            gc.collect()
    return out


def phase_reserve(cfg, params, dev, prompts, one_shot) -> dict:
    """``[reserve]``: the serve prompts through the engine on CUDA graphs
    (the card's default) with ``reserve_admission=True`` on a pool of
    ``RESERVE_PAGES`` pages, under the ``[serve]`` run's plan: no
    preemption, every G, D and P(geom) launch shape recorded at its first
    call and held against its plain version (``check_recorded``; G also
    bitwise on the recorded operands), the kernels launched, and every
    stream bitwise the optimistic one-shot run's: a row's logits depend
    on its own tokens and its step's carry format only, and every bucket
    of this plan carries one format, so the schedule cannot move a
    request to another one."""
    from repro_torch.serve.plan import plan_attention

    counters = _graph_counters()
    plan = plan_attention((serve_pages() - 1) * PAGE, PAGE)
    formats = {tuple(b.acc) for b in plan.buckets}
    check(len(formats) == 1, f"[reserve] the plan's buckets carry "
                             f"{sorted(formats)}: a schedule may change a "
                             "request's format")
    eng = build_engine(cfg, params, dev, None, graphs=True,
                       n_pages=RESERVE_PAGES, plan=plan,
                       reserve_admission=True)
    rids = [eng.submit(p, GEN) for p in prompts]
    calls: dict = {}
    admitted = []
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_kernels(calls):
        while eng.pending or eng.active or eng.swapped:
            admitted.append(eng.step()["admitted"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(counters)
    streams = [eng.finished[r] for r in rids]
    same = [a == b for a, b in zip(streams, one_shot["streams"])]
    late = [i for i, a in enumerate(admitted) if a is not None]
    need = sum(eng.pool.pages_for(len(p) + GEN) for p in prompts)
    print(f"[reserve] reservation admission, {RESERVE_PAGES}-page pool (the "
          f"{len(prompts)} requests reserve {need} pages), graphed, no "
          f"warmup: {eng.decoded_tokens} tokens in {dt:.3f} s; admitted at "
          f"steps {late}; preemptions {eng.preemptions}, max concurrent "
          f"{eng.max_concurrent}; streams equal to the optimistic one-shot "
          f"run's: {sum(same)}/{len(rids)} (every bucket carries "
          f"{formats.pop()}; streams that differ: "
          f"{[i for i, x in enumerate(same) if not x]}); launches "
          f"{launches}", flush=True)
    check(eng.preemptions == 0, "[reserve] reservation admission preempted")
    check(all(same), "[reserve] a stream differs from the optimistic "
                     "run's under a one-format plan")
    for k in ("qmatmul_fused", "paged_attn_decode", P_GEOM_NAME):
        check(launches[k] > 0, f"[reserve] {k} was not launched")
    eng.pool.check_invariants()
    del eng
    gc.collect()
    gen = torch.Generator(device=dev).manual_seed(SEED + 81)
    rec = check_recorded("reservation admission", calls, gen, tag="[reserve]")
    check(rec["err"]["G"] == 0.0, "[reserve] G not bitwise its plain "
                                  "version on the recorded operands")
    del calls
    return dict(seconds=dt, launches=launches, same=sum(same),
                preemptions=0, kernels=rec)


def phase_legacy(dev, smi: str) -> dict:
    """``[legacy]``: the legacy static batch through the launcher
    (``launch/serve.py --legacy``: ``_legacy_main``) at full width and
    depth: 4 ``SyntheticLM`` prompts of 32 tokens, 16 generated, the
    predicted plan.  G launched (its count from this run), every G launch
    shape recorded at its first call and held against its plain version
    (``check_recorded``), bitwise on the recorded operands too; tok/s of
    the decode loop beside the card's name and power limit."""
    import contextlib
    import io

    from repro_torch.launch import serve as S

    counters = {"qmatmul_fused": _counters()["qmatmul_fused"],
                "qmatmul_fused fold": (_counters()["qmatmul_fused"][0],
                                       "fold_launches")}
    argv = ["--arch", "qwen2-1.5b", "--legacy", "--policy", "predicted",
            "--chunk", "64", "--seed", str(SEED), "--device", "cuda",
            *LEGACY_ARGV]
    calls: dict = {}
    zero_counts(counters)
    buf = io.StringIO()
    with recording_kernels(calls), contextlib.redirect_stdout(buf):
        res = S.main(argv)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    gen_tokens = res["gen"]
    print(f"[legacy] {buf.getvalue().strip().splitlines()[0]}; prefill "
          f"{res['prefill_s']:.3f} s, decode {res['decode_s']:.3f} s, "
          f"{res['tok_per_s']:.1f} tok/s on {smi}; launches {launches}; "
          f"sample {gen_tokens[0].tolist()}", flush=True)
    check(tuple(gen_tokens.shape) == (4, 16), "[legacy] short generation")
    check(bool(((gen_tokens >= 0) & (gen_tokens < 151936)).all()),
          "[legacy] token out of range")
    check(launches["qmatmul_fused"] > 0, "[legacy] G was not launched")
    gen = torch.Generator(device=dev).manual_seed(SEED + 91)
    rec = check_recorded("legacy static batch", calls, gen, kinds=("G",),
                         tag="[legacy]")
    check(rec["err"]["G"] == 0.0, "[legacy] G not bitwise its plain "
                                  "version on the recorded operands")
    out = dict(launches=launches, tok_per_s=res["tok_per_s"], kernels=rec)
    del calls, res
    gc.collect()
    return out


# One request's prefill logits, kernels vs plain versions on the card.
# Every kernel is held bit for bit against its plain version above (same
# summation order; the products are exact), so the logits may differ only
# where a transcendental (exp2f) of the kernel and of PyTorch differ in the
# last bit; such a step moves a carry by one (1,e,m) ulp.  Tolerance on
# logits of scale ~3 (tied embeddings, std d^-1/2):
LOGIT_TOL = 0.0625


def phase_logits(cfg, params, dev, prompt) -> float:
    from repro_torch.models.api import get_paged_model, paged_init_state
    from repro_torch.quant.formats import FPFormat
    from repro_torch.serve.plan import plan_attention

    pm = get_paged_model(cfg)
    n = len(prompt)
    plan = plan_attention(4 * PAGE * (-(-n // PAGE)), PAGE)
    _, bucket = plan.bucket_for(n)
    pages = torch.arange(1, -(-n // PAGE) + 1, device=dev)

    def run():
        kv = paged_init_state(cfg, n_pages=int(pages[-1]) + 1, page_size=PAGE,
                              device=dev)
        with torch.no_grad():
            return pm.prefill(params, torch.tensor([prompt], device=dev), kv,
                              pages.to(torch.int32), pages, 0, n,
                              kv_fmt=FPFormat(5, 2), acc=bucket.acc).float()

    got = run()
    with plain_versions():
        want = run()
    err = float((got - want).abs().max())
    print(f"[serve] prefill logits of a {n}-token request, kernels vs plain "
          f"versions: max |err| {err:.4g} (logit scale "
          f"{float(want.abs().max()):.3g}), argmax {int(got.argmax())} vs "
          f"{int(want.argmax())}", flush=True)
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    check(err <= LOGIT_TOL, f"prefill logits differ by {err} > {LOGIT_TOL}")
    return err


# --------------------------------------------------------------------------
# phase 4: the training path: kernels E and B, then the trainer
# --------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH = 64, 8          # the JAX launcher's defaults
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 6, 1e-3, 2
TRAIN_SR_SEED = 7                       # --sr-seed of the SR phases
HEAD_SLICE = 4096                       # lm_head columns checked vs plain
HEAD_SEGMENTS = 10                      # the JAX N-split of the lm_head


def _train_cfg(n_layers=None, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
               rounding="rne"):
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model

    cfg = get_config("qwen2-1.5b")
    if n_layers is not None:
        cfg = replace(cfg, n_layers=n_layers)
    return plan_for_model(cfg, seq_len=seq, global_batch=batch,
                          policy=AccumulationPolicy(mode="predicted", chunk=64,
                                                    rounding=rounding,
                                                    sr_seed=TRAIN_SR_SEED))


def _roles(qc):
    """(e_acc, m_acc, chunk) of the three roles of a QDotConfig."""
    from repro_torch.kernels.ops import _acc_params, _pair_chunks

    f = _acc_params(qc.fwd)
    (eb, mb, _), (eg, mg, _) = _acc_params(qc.bwd), _acc_params(qc.grad)
    gc, bc = _pair_chunks(qc)
    return f, (eb, mb, bc), (eg, mg, gc)


def _e_kw(qc):
    (e, m, c), _, _ = _roles(qc)
    return dict(repr_fmt=qc.repr_fmt, e_acc=e, m_acc=m, block_k=c or 128)


def _b_kw(qc):
    _, (eb, mb, bc), (eg, mg, gc) = _roles(qc)
    return dict(repr_fmt=qc.repr_fmt, bwd_acc=(eb, mb), grad_acc=(eg, mg),
                bwd_chunk=bc, grad_chunk=gc, packed=qc.packs,
                quantize_g=qc.repr_fmt is not None)


# The costs below are (bytes, operations, peak rate).  A layer GEMM of the
# training step contracts (1,5,2) values (E5M2: quantized in the kernel or
# decoded from int8 codes), which the FP8 tensor cores take, so its bound
# is at FP8_FLOPS; the lm_head contracts raw f32 x bf16 values, bounded at
# BF16_FLOPS.  The bound is of the work, not of this design: FP8 MMA keeps
# fewer accumulator bits than f32, so it cannot form the kernels' exact
# chunk partials, and that gap is the design's cost.
def _e_cost(t, k, n):
    # x f32 and w bf16 read, y f32 and both code tensors written
    return (t * k * 4 + k * n * 2 + t * n * 4 + t * k + k * n, 2 * t * k * n,
            FP8_FLOPS)


def _b_cost(t, k, n, packed=True, w_bytes=1, x_bytes=1):
    # g f32 and the residuals read, dx and dw f32 written
    xb, wb = (1, 1) if packed else (x_bytes, w_bytes)
    return (t * n * 4 + t * k * xb + k * n * wb + t * k * 4 + k * n * 4,
            4 * t * k * n, FP8_FLOPS if packed else BF16_FLOPS)


def _k8_cost(t, k, n, codes):
    # operands read (int8 codes, or the lm_head's f32 x and bf16 w), C f32
    # written; the partial rows (80 bytes a 64 x 64 tile) are negligible
    ab, bb, peak = (1, 1, FP8_FLOPS) if codes else (4, 2, BF16_FLOPS)
    return t * k * ab + k * n * bb + t * n * 4, 2 * t * k * n, peak


def _k8_codes_kw(ekw):
    """K8 on the saved int8 codes of E (the in-graph FWD replay)."""
    return dict(ekw, quantize_a=False, quantize_b=False, a_packed=True,
                b_packed=True)


def check_k8(label, a, b, kw, *, base) -> float:
    """K8 at one shape: C bitwise the stats-off kernel's (``base``: G, or
    E's y for codes) and the plain version's, the row against the plain
    version's (``check_stats``), two launches bitwise.  Returns the max
    |error| against the plain version (C and row)."""
    from repro_torch.kernels.fused import (qmatmul_fused,
                                           qmatmul_fused_stats_reference)

    c, row = qmatmul_fused(a, b, collect_stats=True, **kw)
    c2, row2 = qmatmul_fused(a, b, collect_stats=True, **kw)
    pc, prow = qmatmul_fused_stats_reference(a, b, **kw)
    m = kw["m_acc"]
    e = kw["e_acc"]
    compare(f"K8 {label} vs stats-off kernel", c, base, m, e, bitwise=True)
    err = compare(f"K8 {label} vs plain", c, pc, m, e, bitwise=True)
    check(torch.equal(c, c2) and torch.equal(row, row2),
          f"K8 {label}: two launches differ")
    return max(err, check_stats(f"K8 {label}", row, prow))


def check_k9(label, g, xq, wq, kw) -> float:
    """K9 at one shape: dx, dw bitwise B's and the plain version's, both
    rows against the plain version's, two launches bitwise."""
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_stats_reference)

    dx, dw, rows = qmatmul_bwd_pair(g, xq, wq, collect_stats=True, **kw)
    _, _, rows2 = qmatmul_bwd_pair(g, xq, wq, collect_stats=True, **kw)
    bdx, bdw = qmatmul_bwd_pair(g, xq, wq, **kw)
    pdx, pdw, prows = qmatmul_bwd_pair_stats_reference(g, xq, wq, **kw)
    (eb, mb), (eg, mg) = kw["bwd_acc"], kw["grad_acc"]
    compare(f"K9 dx {label} vs B", dx, bdx, mb, eb, bitwise=True)
    compare(f"K9 dw {label} vs B", dw, bdw, mg, eg, bitwise=True)
    err = max(compare(f"K9 dx {label} vs plain", dx, pdx, mb, eb,
                      bitwise=True),
              compare(f"K9 dw {label} vs plain", dw, pdw, mg, eg,
                      bitwise=True))
    check(torch.equal(rows, rows2), f"K9 {label}: two launches differ")
    return max(err, check_stats(f"K9 {label}", rows, prows))


def check_probe_roles(gen, layer, head, hx, emb) -> float:
    """K8 at the eager telemetry tick's own calls
    (``telemetry.probe.role_operands``): FWD, BWD (g @ Q(w).T with
    ``quantize_b=False``) and GRAD (Q(x).T @ g with ``quantize_a=False``)
    of every synthetic layer tag at its T = 512 shape on the probe's
    unit-Gaussian f32 operands, and of the lm_head on f32 hidden states and
    the f32 embed.T view (the probe runs on the f32 masters).  Each against
    its plain version and G, which quantizes both operands again (Q(Q(v))
    = Q(v), so C is the same); returns the largest |error|."""
    from repro_torch.kernels.fused import qmatmul_fused
    from repro_torch.telemetry.probe import _normal, role_operands
    from repro_torch.telemetry.stats import stats_kw

    err, seen = 0.0, set()
    for tag, t, k, n, qc in layer + [head]:
        if (k, n, repr(qc)) in seen:
            continue
        seen.add((k, n, repr(qc)))
        if tag == "lm_head":
            x, w = hx, emb.T.float()
        else:
            x, w = _normal(gen, (t, k)), _normal(gen, (k, n))
        g = _normal(gen, (t, n))
        for role, (a, b, p, flags, _) in role_operands(x, w, qc, g).items():
            kw = dict(repr_fmt=qc.repr_fmt, **stats_kw(p))
            label = (f"probe {tag} {role} M={a.shape[0]} K={a.shape[1]} "
                     f"N={b.shape[1]}")
            err = max(err, check_k8(label, a, b, dict(kw, **flags),
                                    base=qmatmul_fused(a, b, **kw)))
        del x, w, g
    return err


def _k3_pair_ms(g, x, w, qc) -> float:
    """K3's BWD + GRAD on the values B contracts (g quantized, the
    residuals decoded to f32, as the oracle's K2 would hand them over):
    the same math on the independent tile, timed."""
    from repro_torch.kernels.common import quantize_block
    from repro_torch.kernels.qmatmul import qmatmul
    from repro_torch.quant.qtensor import unpack_block

    f = qc.repr_fmt
    if qc.packs:
        x, w = unpack_block(x, f.e, f.m), unpack_block(w, f.e, f.m)
    gq = quantize_block(g, f.e, f.m) if f is not None else g
    bwd, grad = _k3_kw(qc.bwd), _k3_kw(qc.grad)
    return cuda_time(lambda: (qmatmul(gq, w.T, **bwd),
                              qmatmul(x.T, gq, **grad)), reps=2)


def sm90_line(tag, t, k, n, b_ms, k9_ms, k3_ms, k8_ms, fwd_ms, fwd) -> None:
    """One shape's line for the Hopper tile: B beside K9 (the same grid
    and tile plus the stats shadow, so K9 over B is the stats overhead)
    and K3's BWD + GRAD; the forward kernel (E, or G for the lm_head, both
    on the same tile) beside K8 (K8 over it is the stats overhead); each
    kernel with the share of its f32-FMA bound."""
    fb = 4 * t * k * n / F32_FLOPS * 1e3
    ff = fb / 2
    print(f"  sm90 {tag} T={t} K={k} N={n}: B {b_ms:.4f} ms ({fb / b_ms:.3f}"
          f" of its f32-FMA bound {fb:.4f} ms), K9 {k9_ms:.4f} ms "
          f"({fb / k9_ms:.3f}; {k9_ms / b_ms:.3f}x B), K3 BWD+GRAD "
          f"{k3_ms:.4f} ms; {fwd} {fwd_ms:.4f} ms ({ff / fwd_ms:.3f} of "
          f"{ff:.4f} ms), K8 {k8_ms:.4f} ms ({ff / k8_ms:.3f}; "
          f"{k8_ms / fwd_ms:.3f}x {fwd})", flush=True)


def phase_train_kernels(dev) -> dict:
    """E, B, K8 and K9 against their plain versions (and K8/K9 against G,
    E and B) at every distinct layer shape of the training step (T = 512
    tokens) and on a 4096-column slice of the tied lm_head; the whole
    lm_head backward unsplit (B, K9) and chained over the JAX package's 10
    N segments (K7), against each other and the chained plain version,
    bitwise; K8 at the eager tick's own role calls
    (``check_probe_roles``); and one step's worth of E and B launches, and
    one in-graph tick's K8 and K9 launches, timed as sequences."""
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_nsplit, qmatmul_bwd_pair_reference,
        qmatmul_bwd_pair_stats_reference)
    from repro_torch.kernels.fused import (
        qmatmul_fused, qmatmul_fused_reference, qmatmul_fused_stats_reference)
    from repro_torch.models.api import dense_gemm_shapes

    cfg = _train_cfg()
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    shapes = dense_gemm_shapes(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    head, layer = shapes[0], shapes[1:]
    t = head[1]
    print(f"[kernels] E qmatmul_fused(return_quantized) and B "
          f"qmatmul_bwd_pair vs plain at T={t} (per shape: kernel ms, bf16 "
          f"torch.matmul ms, bound ms; plain ms over a whole step below)",
          flush=True)
    e_err = b_err = s_err = p_err = 0.0
    tensors = {}
    for tag, _, k, n, qc in layer:
        if (k, n) in tensors:
            continue
        ekw, bkw = _e_kw(qc), _b_kw(qc)
        (_, m_f, _), (eb, mb, _), (eg, mg, _) = _roles(qc)
        x = torch.randn((t, k), generator=gen, device=dev)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        g = torch.randn((t, n), generator=gen, device=dev) / math.sqrt(n)
        y, xq, wq = qmatmul_fused(x, w, return_quantized=True, **ekw)
        ry, rxq, rwq = qmatmul_fused_reference(x, w, return_quantized=True,
                                               **ekw)
        e_err = max(e_err, compare(f"E {tag} K={k} N={n} random", y, ry,
                                   m_f, ekw["e_acc"], bitwise=True))
        check(torch.equal(xq, rxq) and torch.equal(wq, rwq),
              f"E {tag}: codes differ from pack_block")
        compare(f"E {tag} vs K8 on the same operands", y, qmatmul_fused(
            x, w, collect_stats=True, **ekw)[0], m_f, ekw["e_acc"],
            bitwise=True)
        dx, dw = qmatmul_bwd_pair(g, xq, wq, **bkw)
        rdx, rdw = qmatmul_bwd_pair_reference(g, xq, wq, **bkw)
        b_err = max(b_err, compare(f"B dx {tag} random", dx, rdx, mb, eb,
                                   bitwise=False),
                    compare(f"B dw {tag} random", dw, rdw, mg, eg,
                            bitwise=False))
        xl, wl = _lattice(gen, (t, k), dev), _lattice(gen, (k, n), dev)
        gl = _lattice(gen, (t, n), dev)
        lat = qmatmul_fused(xl, wl.to(torch.bfloat16), return_quantized=True,
                            **ekw)
        rlat = qmatmul_fused_reference(xl, wl.to(torch.bfloat16),
                                       return_quantized=True, **ekw)
        e_err = max(e_err, compare(f"E {tag} lattice", lat[0], rlat[0], m_f,
                                   ekw["e_acc"], bitwise=True))
        check(torch.equal(lat[1], rlat[1]) and torch.equal(lat[2], rlat[2]),
              f"E {tag} lattice: codes differ")
        for got, want, (e_, m_), r in zip(
                qmatmul_bwd_pair(gl, lat[1], lat[2], **bkw),
                qmatmul_bwd_pair_reference(gl, lat[1], lat[2], **bkw),
                ((eb, mb), (eg, mg)), ("dx", "dw")):
            compare(f"B {r} {tag} lattice", got, want, m_, e_, bitwise=True)
        tensors[(k, n)] = (x, w, g, xq, wq)
        s_err = max(s_err, check_k8(
            f"{tag} K={k} N={n} f32 x bf16 w", x, w, ekw,
            base=qmatmul_fused(x, w, **ekw)))
        s_err = max(s_err, check_k8(
            f"{tag} K={k} N={n} int8 codes", xq, wq, _k8_codes_kw(ekw),
            base=y))
        s_err = max(s_err, check_k8(
            f"{tag} K={k} N={n} f32 lattice", xl, wl, ekw,
            base=qmatmul_fused(xl, wl, **ekw)))
        p_err = max(p_err, check_k9(f"{tag} K={k} N={n}", g, xq, wq, bkw),
                    check_k9(f"{tag} K={k} N={n} lattice", gl, lat[1],
                             lat[2], bkw))
        e_ms = cuda_time(lambda: qmatmul_fused(x, w, return_quantized=True,
                                               **ekw), reps=10)
        b_ms = cuda_time(lambda: qmatmul_bwd_pair(g, xq, wq, **bkw), reps=5)
        g_ms = cuda_time(lambda: qmatmul_fused(x, w, **ekw), reps=10)
        s_ms = cuda_time(lambda: qmatmul_fused(x, w, collect_stats=True,
                                               **ekw), reps=10)
        sq_ms = cuda_time(lambda: qmatmul_fused(
            xq, wq, collect_stats=True, **_k8_codes_kw(ekw)), reps=10)
        p_ms = cuda_time(lambda: qmatmul_bwd_pair(g, xq, wq,
                                                  collect_stats=True, **bkw),
                         reps=5)
        print(f"  time {tag} K={k} N={n} stats vs stats-off: K8 f32 "
              f"{s_ms:.4f} ms vs G {g_ms:.4f} ms ({s_ms / g_ms:.3f}x); K8 "
              f"int8 codes {sq_ms:.4f} ms vs E {e_ms:.4f} ms "
              f"({sq_ms / e_ms:.3f}x); K9 {p_ms:.4f} ms vs B {b_ms:.4f} ms "
              f"({p_ms / b_ms:.3f}x)", flush=True)
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
        e_lib = lib_time(lambda: torch.matmul(xb, w))
        b_lib = lib_time(lambda: (torch.matmul(gb, w.T),
                                  torch.matmul(xb.T, gb)))
        e_b, e_by = bound_ms(*_e_cost(t, k, n))
        b_b, b_by = bound_ms(*_b_cost(t, k, n))
        print(f"  time {tag} K={k} N={n}: E kernel {e_ms:.4f} ms, library "
              f"{lib_str(e_lib)}, bound {e_b:.4f} ms ({e_by}); B kernel "
              f"{b_ms:.4f} ms, library {lib_str(b_lib)}, bound {b_b:.4f} ms "
              f"({b_by})", flush=True)
        sm90_line(tag, t, k, n, b_ms, p_ms, _k3_pair_ms(g, xq, wq, qc),
                  sq_ms, e_ms, "E")

    # the tied lm_head: raw f32 x and the bf16 embed.T view, no quantization
    _, _, k, n, qc = head
    hkw = _b_kw(qc)
    _, (eb, mb, _), (eg, mg, _) = _roles(qc)
    emb = (torch.randn((n, k), generator=gen, device=dev)
           / math.sqrt(k)).to(torch.bfloat16)
    hx = torch.randn((t, k), generator=gen, device=dev)
    hg = torch.randn((t, n), generator=gen, device=dev) / math.sqrt(n)
    sl = slice(0, HEAD_SLICE)
    for lattice in (False, True):
        gs = _lattice(gen, (t, HEAD_SLICE), dev) if lattice else hg[:, sl]
        xs = _lattice(gen, (t, k), dev) if lattice else hx
        ws = (_lattice(gen, (HEAD_SLICE, k), dev).to(torch.bfloat16).T
              if lattice else emb[sl].T)
        got = qmatmul_bwd_pair(gs, xs, ws, **hkw)
        want = qmatmul_bwd_pair_reference(gs, xs, ws, **hkw)
        label = "lattice" if lattice else "random"
        err = max(compare(f"B dx lm_head[:, :{HEAD_SLICE}] {label}", got[0],
                          want[0], mb, eb, bitwise=lattice),
                  compare(f"B dw lm_head[:, :{HEAD_SLICE}] {label}", got[1],
                          want[1], mg, eg, bitwise=lattice))
        b_err = max(b_err, 0.0 if lattice else err)
        gkw = _e_kw(qc)
        s_err = max(s_err, check_k8(
            f"lm_head[:, :{HEAD_SLICE}] {label}", xs, ws, gkw,
            base=qmatmul_fused(xs, ws, **gkw)))
        p_err = max(p_err, check_k9(f"lm_head[:, :{HEAD_SLICE}] {label}",
                                    gs, xs, ws, hkw))
    full = qmatmul_bwd_pair(hg, hx, emb.T, **hkw)
    chained = qmatmul_bwd_pair_nsplit(hg, hx, emb.T, n_split=HEAD_SEGMENTS,
                                      **hkw)
    torch.cuda.synchronize()
    seg_same = torch.equal(full[0], chained[0]) and torch.equal(full[1],
                                                                chained[1])
    print(f"  K7 lm_head backward in {HEAD_SEGMENTS} chained N segments vs "
          f"the unsplit call: {'bitwise equal' if seg_same else 'DIFFERENT'}",
          flush=True)
    check(seg_same, "chained dx_carry segments differ from the unsplit call")
    plain = []
    k7_plain = cuda_time(lambda: plain.append(_nsplit_plain(hg, hx, emb.T,
                                                            hkw)),
                         reps=1, warmup=0)
    (pdx, pdw), = plain
    k7_err = max(compare(f"K7 dx lm_head T={t} N={n} chained vs plain",
                         chained[0], pdx, mb, eb, bitwise=True),
                 compare(f"K7 dw lm_head T={t} N={n} chained vs plain",
                         chained[1], pdw, mg, eg, bitwise=True))
    b_err = max(b_err,
                compare(f"B dx lm_head T={t} N={n} unsplit vs plain",
                        full[0], pdx, mb, eb, bitwise=True),
                compare(f"B dw lm_head T={t} N={n} unsplit vs plain",
                        full[1], pdw, mg, eg, bitwise=True))
    del full, chained, plain, pdx, pdw
    # K9 on the whole lm_head, as the in-graph tick runs it
    p_err = max(p_err, check_k9(f"lm_head T={t} N={n}", hg, hx, emb.T, hkw))
    s_err = max(s_err, check_probe_roles(gen, layer, head, hx, emb))
    seg = lambda fn: fn(hg, hx, emb.T, n_split=HEAD_SEGMENTS, **hkw)  # noqa
    k7_ms = cuda_time(lambda: seg(qmatmul_bwd_pair_nsplit), reps=2, warmup=1)
    hxb, hgb, embt = hx.to(torch.bfloat16), hg.to(torch.bfloat16), emb.T
    head_lib = lambda: (torch.matmul(hgb, embt.T),  # noqa: E731
                        torch.matmul(hxb.T, hgb))
    k7_lib = lib_time(head_lib)
    k7_b, k7_by = bound_ms(*_b_cost(t, k, n, packed=False, x_bytes=4,
                                    w_bytes=2))
    k7_f = fma_bound([_b_cost(t, k, n)])
    print(f"  time K7 lm_head T={t} K={k} N={n}: kernel {k7_ms:.3f} ms, "
          f"plain {k7_plain:.1f} ms, library {lib_str(k7_lib)}, bound "
          f"{k7_b:.4f} ms ({k7_by}); f32-FMA bound {k7_f:.3f} ms, "
          f"{k7_f / k7_ms:.4f} of it", flush=True)
    gkw = _e_kw(qc)
    s_err = max(s_err, compare(
        f"G lm_head forward T={t} N={n} (tile route) vs K8's C",
        qmatmul_fused(hx, emb.T, **gkw),
        qmatmul_fused(hx, emb.T, collect_stats=True, **gkw)[0], qc.fwd.m_acc,
        qc.fwd.e_acc, bitwise=True))
    head_g = cuda_time(lambda: qmatmul_fused(hx, emb.T, **gkw), reps=3)
    print(f"  time G lm_head forward T={t} K={k} N={n}: kernel {head_g:.3f} "
          f"ms, library {lib_str(lib_time(lambda: torch.matmul(hxb, embt)))}",
          flush=True)
    head_b = cuda_time(lambda: qmatmul_bwd_pair(hg, hx, emb.T, **hkw), reps=2)
    head_k9 = cuda_time(lambda: qmatmul_bwd_pair(hg, hx, emb.T,
                                                 collect_stats=True, **hkw),
                        reps=2)
    head_k8 = cuda_time(lambda: qmatmul_fused(hx, emb.T, collect_stats=True,
                                              **gkw), reps=2)
    sm90_line("lm_head", t, k, n, head_b, head_k9,
              _k3_pair_ms(hg, hx, emb.T, qc), head_k8, head_g, "G")

    # one training step's launches of E and B (7 per layer x depth, plus
    # the lm_head's B), in layer order on the per-shape tensors above
    depth = cfg.n_layers
    calls = [(tensors[(k, n)], qc) for _ in range(depth)
             for _, _, k, n, qc in layer]

    # the plain versions are timed at a cut depth: one layer's 7 calls
    # (no lm_head), beside the kernels on the same calls
    one_layer = calls[:len(layer)]

    def run_e(fn, seq=calls, head=True):
        for (x, w, _, _, _), qc in seq:
            fn(x, w, return_quantized=True, **_e_kw(qc))

    def run_b(fn, seq=calls, head=True):
        for (_, _, g, xq, wq), qc in seq:
            fn(g, xq, wq, **_b_kw(qc))
        if head:
            fn(hg, hx, emb.T, **hkw)

    def lib_e():
        for (x, w, _, _, _), _ in calls:
            torch.matmul(x.to(torch.bfloat16), w)

    def lib_b():
        for (x, w, g, _, _), _ in calls:
            gb = g.to(torch.bfloat16)
            torch.matmul(gb, w.T)
            torch.matmul(x.to(torch.bfloat16).T, gb)
        head_lib()

    # one in-graph telemetry tick's K8 and K9 launches: the FWD replays on
    # the saved codes (and the raw lm_head) and the stats pairs
    hkw8 = _e_kw(qc)

    def run_k8(fn, seq=calls, head=True):
        for (_, _, _, xq, wq), qc_ in seq:
            fn(xq, wq, **_k8_codes_kw(_e_kw(qc_)))
        if head:
            fn(hx, emb.T, **hkw8)

    def run_k9(fn, seq=calls, head=True):
        for (_, _, g, xq, wq), qc_ in seq:
            fn(g, xq, wq, **_b_kw(qc_))
        if head:
            fn(hg, hx, emb.T, **hkw)

    def lib_k8():
        lib_e()
        torch.matmul(hxb, embt)

    e_cost = [_e_cost(t, k, n) for _ in range(depth) for _, _, k, n, _ in layer]
    b_cost = [_b_cost(t, k, n) for _ in range(depth)
              for _, _, k, n, _ in layer]
    b_cost.append(_b_cost(t, head[2], head[3], packed=False, x_bytes=4,
                          w_bytes=2))
    k8_cost = [_k8_cost(t, k, n, True) for _ in range(depth)
               for _, _, k, n, _ in layer]
    k8_cost.append(_k8_cost(t, head[2], head[3], False))
    k8 = functools.partial(qmatmul_fused, collect_stats=True)
    k9 = functools.partial(qmatmul_bwd_pair, collect_stats=True)
    k9_plain = qmatmul_bwd_pair_stats_reference
    out = {}
    for name, run, fn, ref, lib, cost, err in (
            ("E", run_e, qmatmul_fused, qmatmul_fused_reference, lib_e,
             e_cost, e_err),
            ("B", run_b, qmatmul_bwd_pair, qmatmul_bwd_pair_reference, lib_b,
             b_cost, b_err),
            ("K8", run_k8, k8, qmatmul_fused_stats_reference, lib_k8,
             k8_cost, s_err),
            ("K9", run_k9, k9, k9_plain, lib_b, b_cost, p_err)):
        ms = cuda_time(lambda: run(fn), reps=2, warmup=1)
        plain = cuda_time(lambda: run(ref, one_layer, False), reps=1,
                          warmup=0)
        layer_ms = cuda_time(lambda: run(fn, one_layer, False), reps=3)
        lib_ms = lib_time(lib, reps=3)
        b_ms, b_by = seq_bound(cost)
        f_ms = fma_bound(cost)
        what = ("one in-graph telemetry tick" if name in ("K8", "K9")
                else "one training step")
        cut = f"one layer's {len(one_layer)} calls at T={t}"
        print(f"[kernels] {name} {what} ({len(cost)} launches, "
              f"T={t}): kernel {ms:.3f} ms, library {lib_str(lib_ms)}, "
              f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.4f} of bound; "
              f"f32-FMA bound {f_ms:.3f} ms, {f_ms / ms:.4f} of it; "
              f"{ms / lib_ms[0]:.2f}x the library; plain at {cut} "
              f"{plain:.1f} ms against the kernel's {layer_ms:.3f} ms there",
              flush=True)
        out[name] = dict(ms=ms, plain_ms=plain, plain_depth=cut,
                         plain_depth_kernel_ms=layer_ms,
                         library_ms=lib_ms[0],
                         library_spread_ms=list(lib_ms[1]), bound_ms=b_ms,
                         bound_by=b_by, fma_bound_ms=f_ms, max_abs_err=err)
    print(f"[kernels] stats overhead over one step's sequence: K8 "
          f"{out['K8']['ms'] / out['E']['ms']:.3f}x E, K9 "
          f"{out['K9']['ms'] / out['B']['ms']:.3f}x B", flush=True)
    # K7's plain chain is the lm_head's bitwise check, timed as it runs
    out["K7"] = dict(ms=k7_ms, plain_ms=k7_plain,
                     plain_depth=f"the lm_head backward in {HEAD_SEGMENTS} "
                                 f"chained segments at T={t}",
                     library_ms=k7_lib[0],
                     library_spread_ms=list(k7_lib[1]), bound_ms=k7_b,
                     bound_by=k7_by, fma_bound_ms=k7_f, max_abs_err=k7_err)
    return out


def _nsplit_plain(g, x, w, kw, segs=HEAD_SEGMENTS):
    """The ``segs`` chained segments through the plain version, each at
    its place in N: (dx, dw)."""
    from repro_torch.kernels.bwd_pair import (pair_segment_width,
                                              qmatmul_bwd_pair_reference)

    t, n = g.shape
    seg = pair_segment_width(n, segs, kw["bwd_chunk"])
    dx = torch.zeros((t, x.shape[1]), dtype=torch.float32, device=g.device)
    dws = []
    for lo in range(0, n, seg):
        hi = min(lo + seg, n)
        dx, dw = qmatmul_bwd_pair_reference(g[:, lo:hi], x, w[:, lo:hi],
                                            dx_carry=dx, n_offset=lo,
                                            n_total=n, **kw)
        dws.append(dw)
    return dx, torch.cat(dws, dim=1)


E_NAME = "qmatmul_fused(return_quantized)"     # kernel E
K7_NAME = "qmatmul_bwd_pair(dx_carry)"          # B's carry-in entry


K8_NAME = "qmatmul_fused(collect_stats)"        # K8's kernel
K9_NAME = "qmatmul_bwd_pair(collect_stats)"     # K9's kernel
# K12's kernel; each call is two launches, the kernel and its second pass
K12_NAME = "paged_attn_decode(collect_stats)"


def _train_counters():
    """G, E, B, B's dx carry-in entry (K7) and the stats kernels K8 and
    K9, as ``_counters``."""
    from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
    from repro_torch.kernels.fused import qmatmul_fused

    return {"qmatmul_fused": (qmatmul_fused, "launches"),
            E_NAME: (qmatmul_fused, "emitq_launches"),
            "qmatmul_bwd_pair": (qmatmul_bwd_pair, "launches"),
            K7_NAME: (qmatmul_bwd_pair, "carry_launches"),
            K8_NAME: (qmatmul_fused, "stats_launches"),
            K9_NAME: (qmatmul_bwd_pair, "stats_launches")}


@contextmanager
def remat_policy(pol: str):
    """``REPRO_REMAT_POLICY=pol`` for the body: the training forward reads
    it each time it runs (``repro_torch.models.lm._remat``)."""
    old = os.environ.get("REPRO_REMAT_POLICY")
    os.environ["REPRO_REMAT_POLICY"] = pol
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_REMAT_POLICY", None)
        else:
            os.environ["REPRO_REMAT_POLICY"] = old


def want_step(cfg, microbatches: int = 1) -> dict:
    """The launches of one untagged training step of ``cfg`` under the
    current remat policy: E on every layer GEMM each forward pass, G on
    the lm_head, B on every GEMM, once a microbatch."""
    from repro_torch.models.api import dense_gemm_shapes
    from repro_torch.models.lm import layer_forwards

    n = (len(dense_gemm_shapes(cfg, seq_len=1, global_batch=1)) - 1
         ) * cfg.n_layers
    return {E_NAME: microbatches * layer_forwards(cfg) * n,
            "qmatmul_fused": microbatches,
            "qmatmul_bwd_pair": microbatches * (n + 1),
            K7_NAME: 0, K8_NAME: 0, K9_NAME: 0}


TELEMETRY_CADENCE = 2
TELEMETRY_LOG = ROOT / "build" / "telemetry.jsonl"   # gitignored


def _train_argv(*extra) -> list[str]:
    """The training launcher's arguments of the train cell; a flag in
    ``extra`` overrides its earlier value."""
    return ["--arch", "qwen2-1.5b", "--steps", str(TRAIN_STEPS),
            "--global-batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
            "--lr", str(TRAIN_LR), "--warmup", str(TRAIN_WARMUP), "--policy",
            "predicted", "--chunk", "64", "--seed", str(SEED), "--device",
            "cuda", "--telemetry-log", str(TELEMETRY_LOG), *extra]


def _train_args(*extra):
    from repro_torch.launch.train import parse_args

    return parse_args(_train_argv(*extra))


def phase_train(dev) -> dict:
    """qwen2-1.5b at full width and depth through the training launcher's
    own set-up (``repro_torch.launch.train.build``): predicted plan, chunk
    64, seeded f32 weights, ``SyntheticLM`` batches, AdamW, and the eager
    swamping-telemetry tick every ``TELEMETRY_CADENCE`` steps
    (``--telemetry-cadence``: ``run_telemetry_tick`` and the controller, as
    the launcher's loop drives them); a re-planned model goes on
    training."""
    from repro_torch.launch.train import build, build_telemetry
    from repro_torch.models.api import dense_gemm_shapes, param_count
    from repro_torch.train.loop import make_train_step, run_telemetry_tick

    args = _train_args("--telemetry-cadence", str(TELEMETRY_CADENCE))
    TELEMETRY_LOG.unlink(missing_ok=True)
    torch.cuda.reset_peak_memory_stats()
    model, tc, state, data, _ = build(args)
    controller, _ = build_telemetry(args, tc)
    cfg = model.cfg
    step_fn = make_train_step(model, tc)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    n_layer_gemms = len(dense_gemm_shapes(cfg, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH)) - 1
    want = want_step(cfg)
    # a tick: the probe's forward (G on every quantized GEMM, no autograd),
    # then K8 on the lm_head's 3 roles and on the 7 synthetic layer tags'
    want_tick = {E_NAME: 0, "qmatmul_fused": n_layer_gemms * cfg.n_layers + 1,
                 "qmatmul_bwd_pair": 0, K7_NAME: 0,
                 K8_NAME: 3 * (n_layer_gemms + 1), K9_NAME: 0}
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{param_count(state['params']) / 1e6:.1f}M params (f32 masters), "
          f"predicted plan chunk 64, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"lr {TRAIN_LR} warmup {TRAIN_WARMUP}", flush=True)
    counters = _train_counters()
    losses, step_ms, launches = [], [], {k: 0 for k in counters}
    tick_ms, tick_launches, n_events = [], {k: 0 for k in counters}, 0
    from repro_torch.telemetry.controller import PLAN_FIELDS, ROLES
    for step in range(TRAIN_STEPS):
        batch = next(data)
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        per = read_counts(counters)
        for k, v in per.items():
            launches[k] += v
        losses.append(loss)
        step_ms.append(dt)
        print(f"[train] step {step + 1}: loss {loss:.5f}, grad norm "
              f"{gnorm:.4f}, lr {float(m['lr']):.3g}, skipped "
              f"{float(m['skipped']):.0f}, {dt:.1f} ms ({tokens / dt * 1e3:.1f}"
              f" tokens/s), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
              f"launches {per}", flush=True)
        check(per == want, f"step {step + 1}: launches {per} != {want}")
        if controller.due(step + 1):
            gen = torch.Generator(device=dev)
            gen.manual_seed(args.seed * 1000003 + step + 1)
            zero_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events, new_model = run_telemetry_tick(
                controller, model, state, batch, step=step + 1, gen=gen,
                seq_len=args.seq_len, global_batch=args.global_batch)
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            per = read_counts(counters)
            for k, v in per.items():
                tick_launches[k] += v
            kinds = {}
            for e in events:
                kinds[e["event"]] = kinds.get(e["event"], 0) + 1
                if e["event"] != "ok":
                    print(json.dumps({"telemetry": e}), flush=True)
            roles = {(e["gemm"], e["role"]) for e in events}
            print(f"[train] telemetry tick at step {step + 1}: "
                  f"{tick_ms[-1]:.1f} ms ({tick_ms[-1] / dt:.3f} of this "
                  f"step), events {kinds} over {len(roles)} (field, role) "
                  f"keys, schedule {controller.to_meta()}, launches {per}",
                  flush=True)
            check(per == want_tick, f"tick launches {per} != {want_tick}")
            check(roles == {(f, r) for f in PLAN_FIELDS for r in ROLES},
                  f"tick gave verdicts for {sorted(roles)} only")
            check(all(math.isfinite(e["measured_vrr"]) for e in events),
                  "non-finite measured VRR")
            n_events += len(events)
            if new_model is not None:   # the launcher goes on re-planned
                model = new_model
                step_fn = make_train_step(model, tc)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for k in ("qmatmul_fused", E_NAME, "qmatmul_bwd_pair"):
        check(launches[k] > 0, f"kernel {k} was not launched by the trainer")
    profile = _profile_step(step_fn, state, next(data), min(step_ms[1:]))
    from repro_torch.train import optimizer as O

    grads = O.tree_map(torch.zeros_like, state["params"])
    no_skip = torch.zeros((), dtype=torch.bool, device=dev)
    opt_ms = cuda_time(lambda: O.adamw_update(state["params"], grads,
                                              state["opt"], tc.opt,
                                              skip=no_skip), reps=1, warmup=1)
    print(f"[train] the AdamW update alone (in place, {param_count(grads) / 1e6:.1f}M"
          f" f32 parameters): {opt_ms:.1f} ms", flush=True)
    del grads
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; steady step {min(step_ms[1:]):.1f} ms "
          f"({tokens / min(step_ms[1:]) * 1e3:.1f} tokens/s); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {launches}", flush=True)
    logged = sum(1 for _ in open(TELEMETRY_LOG))
    print(f"[train] telemetry: {len(tick_ms)} ticks at cadence "
          f"{TELEMETRY_CADENCE}, {min(tick_ms):.1f}-{max(tick_ms):.1f} ms a "
          f"tick ({sum(tick_ms) / len(tick_ms) / min(step_ms[1:]):.3f} of a "
          f"steady step), {n_events} events ({logged} logged to "
          f"{TELEMETRY_LOG.name}), final schedule {controller.to_meta()}, "
          f"launches {tick_launches}", flush=True)
    check(logged == n_events, "the event log lost events")
    none_ms, none_peak = _steps_without_remat(step_fn, state, data, cfg,
                                              min(step_ms[1:]))
    del state
    return dict(launches=launches, losses=losses, step_ms=step_ms, peak=peak,
                tick_ms=tick_ms, tick_launches=tick_launches, profile=profile,
                none_ms=none_ms, none_peak=none_peak)


def _steps_without_remat(step_fn, state, data, cfg, full_ms: float,
                         steps: int = 2):
    """``steps`` more steps of a training cell under
    ``REPRO_REMAT_POLICY=none`` (every activation kept for the backward,
    E once a layer GEMM): the steady step and its peak memory, beside the
    ``full`` policy's steady step ``full_ms``."""
    with remat_policy("none"):
        rows = _timed_steps("[train] none", step_fn, state, data, cfg, steps,
                            TRAIN_SEQ * TRAIN_BATCH)
    ms, peak = min(r[1] for r in rows), max(r[2] for r in rows)
    print(f"[train] the same cell under REPRO_REMAT_POLICY=none: steady step "
          f"{ms:.1f} ms against full's {full_ms:.1f} ms ({full_ms / ms:.3f}x);"
          f" peak memory {peak / 2 ** 30:.2f} GiB", flush=True)
    return ms, peak


def _profile_step(step_fn, state, batch, step_ms: float,
                  tag: str = "[train]"):
    """One more step under ``torch.profiler``: device time by kernel, and
    the kernels' summed time against ``step_ms``, a step's wall time
    measured without the profiler (kernels run one at a time on one
    stream, so their sum is the device's busy time).  Returns {kernel:
    ms}, or None where the profiler saw no device time."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_fn(state, batch)
            torch.cuda.synchronize()
        rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
    except Exception as exc:  # the profiler is a reading, not a check
        print(f"{tag} profile: not measured ({type(exc).__name__}: {exc})",
              flush=True)
        return None
    if not rows:
        print(f"{tag} profile: not measured (no device time)", flush=True)
        return None
    busy = sum(r[0] for r in rows)
    print(f"{tag} profile of one step: kernels {busy:.1f} ms in all "
          f"({len(rows)} kernel names), {busy / step_ms:.3f} of the steady "
          f"step's {step_ms:.1f} ms (device idle share "
          f"{1 - busy / step_ms:.3f})", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  profile {ms:9.3f} ms {count:6d} x {key[:90]}", flush=True)
    return {key: ms for ms, _, key in rows}


def phase_train_vs_plain(dev, rounding: str = "rne") -> None:
    """One step of a 2-layer cut of qwen2-1.5b at full width (batch 2 x
    seq 64): loss and every gradient through the kernels, then through
    their plain versions on the same card, bitwise; ``rounding="sr"``
    runs the plan's carries stochastically (E and B under SR, the lm_head
    RNE)."""
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import _grads, compute_copy
    from repro_torch.train.optimizer import tree_leaves

    cfg = _train_cfg(n_layers=2, batch=2, rounding=rounding)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    params = model.init_params(gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, TRAIN_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)

    def step():
        c = compute_copy(params)
        loss, _ = model.loss_fn(c, {"tokens": tokens}, cfg)
        loss.backward()
        return loss.detach(), _grads(c, params)

    counters = {**_train_counters(), **_sr_counters()}
    zero_counts(counters)
    lk, gk = step()
    used = read_counts(counters)
    with plain_versions():
        t0 = time.perf_counter()
        lp, gp = step()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    leaves = list(zip(tree_leaves(gk), tree_leaves(gp)))
    same = sum(bool(torch.equal(a, b)) for a, b in leaves)
    err = max(float((a - b).abs().max()) for a, b in leaves)
    tag = "[sr]" if rounding == "sr" else "[train]"
    print(f"{tag} kernels vs plain, 2 layers at full width, batch 2 x seq "
          f"{TRAIN_SEQ}, rounding {rounding}: loss {float(lk):.6f} vs "
          f"{float(lp):.6f}; {same}/{len(leaves)} gradient leaves bitwise "
          f"equal (max |err| {err:.3g}); kernel launches {used}; plain step "
          f"{plain_s:.1f} s", flush=True)
    e, b = (E_SR_NAME, B_SR_NAME) if rounding == "sr" else (
        E_NAME, "qmatmul_bwd_pair")
    check(used[e] > 0 and used[b] > 0, f"the kernel step launched no {e} or "
          f"{b}")
    check(torch.equal(lk, lp), "loss differs between kernels and plain")
    check(same == len(leaves), "a gradient differs between kernels and plain")


INGRAPH_TICKS = 3


def phase_train_ingraph(dev, steady_step_ms: float) -> dict:
    """``INGRAPH_TICKS`` full-depth in-graph telemetry ticks in a row
    (``--ingraph-telemetry``: ``InGraphTelemetry.tick``, the tagged step in
    the normal step's place), each on the next batch: their median time
    and spread against the steady untagged step, their peak memory, and
    each tick's launches (every qdot backward through K9 and a K8 FWD
    replay, no B).  Then, at the 2-layer full-width cut (batch 2 x seq
    64), the tagged step against the untagged step from the same state:
    loss and every state leaf bitwise."""
    import copy

    from repro_torch.launch.train import build, build_telemetry
    from repro_torch.models.api import dense_gemm_shapes, get_model
    from repro_torch.models.lm import layer_forwards
    from repro_torch.obs.ingraph import (InGraphCollector, collecting,
                                         tag_quant_plan)
    from repro_torch.train.loop import TrainConfig, make_train_step
    from repro_torch.train.optimizer import (init_opt_state, init_scaler,
                                             tree_leaves)

    args = _train_args("--telemetry-cadence", "1", "--ingraph-telemetry")
    TELEMETRY_LOG.unlink(missing_ok=True)
    model, tc, state, data, _ = build(args)
    _, ingraph = build_telemetry(args, tc)
    cfg = model.cfg
    n_gemms = len(dense_gemm_shapes(cfg, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH)) - 1
    n_qdot = n_gemms * cfg.n_layers + 1
    want = {"qmatmul_fused": 1, E_NAME: layer_forwards(cfg) * (n_qdot - 1),
            "qmatmul_bwd_pair": 0,
            K7_NAME: 0, K8_NAME: n_qdot, K9_NAME: n_qdot}
    counters = _train_counters()
    total = {k: 0 for k in counters}
    tick_ms, replanned = [], 0
    torch.cuda.reset_peak_memory_stats()
    for i in range(INGRAPH_TICKS):
        batch = next(data)
        ingraph.stats_step(model)   # build the tagged step outside the clock
        torch.cuda.synchronize()
        zero_counts(counters)
        t0 = time.perf_counter()
        state, m, events, new_model = ingraph.tick(model, state, batch,
                                                   step=i + 1)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        per = read_counts(counters)
        kinds = {}
        for e in events:
            kinds[e["event"]] = kinds.get(e["event"], 0) + 1
        print(f"[train] in-graph tick {i + 1}, full depth: {tick_ms[-1]:.1f} "
              f"ms, loss {loss:.5f}, events {kinds} over "
              f"{len({(e['gemm'], e['role']) for e in events})} (field, "
              f"role) keys, re-planned {new_model is not None}, launches "
              f"{per}", flush=True)
        check(per == want, f"in-graph tick launches {per} != {want}")
        check(math.isfinite(loss), "in-graph tick: non-finite loss")
        check(len(events) == 15, f"in-graph tick gave {len(events)} verdicts")
        for k, v in per.items():
            total[k] += v
        if new_model is not None:
            model, replanned = new_model, replanned + 1
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(tick_ms))
    print(f"[train] in-graph tick, full depth, {INGRAPH_TICKS} ticks: median "
          f"{med:.1f} ms [{min(tick_ms):.1f}-{max(tick_ms):.1f}] "
          f"({med / steady_step_ms:.3f} of the steady untagged step's "
          f"{steady_step_ms:.1f} ms), peak memory {peak / 2 ** 30:.2f} GiB, "
          f"re-planned {replanned} times, launches {total}", flush=True)
    del state, m
    torch.cuda.empty_cache()

    cfg2 = _train_cfg(n_layers=2, batch=2)
    untagged, tagged = get_model(cfg2), get_model(tag_quant_plan(cfg2))
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    params = untagged.init_params(gen, dev)
    tokens = torch.randint(0, cfg2.vocab_size, (2, TRAIN_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    tc2 = TrainConfig()
    state0 = {"params": params, "opt": init_opt_state(params),
              "scaler": init_scaler(tc2.scaler, dev)}
    s0, m0 = make_train_step(untagged, tc2)(copy.deepcopy(state0),
                                            {"tokens": tokens})
    col = InGraphCollector()
    zero_counts(counters)
    with collecting(col):
        s1, m1 = make_train_step(tagged, tc2)(copy.deepcopy(state0),
                                              {"tokens": tokens})
    used = read_counts(counters)
    rows = col.rows()
    leaves = list(zip(tree_leaves(s0), tree_leaves(s1)))
    same = sum(bool(torch.equal(a, b)) for a, b in leaves)
    print(f"[train] tagged vs untagged step, 2 layers at full width, batch 2"
          f" x seq {TRAIN_SEQ}: loss {float(m0['loss']):.6f} vs "
          f"{float(m1['loss']):.6f}; {same}/{len(leaves)} state leaves "
          f"bitwise equal; {len(rows)} (field, role) windows; launches "
          f"{used}", flush=True)
    check(torch.equal(m0["loss"], m1["loss"]), "tagged step changed the loss")
    check(same == len(leaves), "tagged step changed the state")
    check(len(rows) == 15 and all(r[0] > 0 for r in rows.values()),
          "tagged step: a window is missing or empty")
    return dict(tick_ms=med, ticks_ms=tick_ms, launches=total, peak=peak)


REPLAN_STEPS = 3
TRAIN_METRICS = ROOT / "build" / "train_metrics.jsonl"   # gitignored
TRAIN_PROM = ROOT / "build" / "train.prom"               # gitignored


def phase_train_replan(dev) -> dict:
    """The controller acting on the card: the training launcher's own
    ``main`` at full width and depth under ``--policy perturbed --pp -2``
    (every quantized width 2 bits under the predicted plan) with a
    telemetry tick every step, ``REPLAN_STEPS`` steps, once with the eager
    tick and once in-graph (``--ingraph-telemetry``).  The narrowed long
    accumulations breach (the closed form flags mlp_up's BWD and
    mlp_down's FWD, N = 8960); after the controller's hysteresis (2
    agreeing ticks) it bumps them, ``apply_schedule`` re-plans the model,
    and the launcher builds the new model's step and trains on.  Checks:
    a bump logged before the last step, the last step built for a model
    that carries every width the controller set, 15 verdicts a tick,
    finite losses, and the whole run's launches (a step's E, G and B, an
    eager tick's G and K8; in-graph, K8 and K9 and no B).  The in-graph run
    also exports the metrics registry (``--obs-metrics``,
    ``--obs-prometheus``, ``[obs]``): every controller event counted, the
    launch gauges the run's counts, the Prometheus text parsed."""
    import contextlib
    import io

    from repro_torch.launch import train as LT
    from repro_torch.models.api import dense_gemm_shapes
    from repro_torch.models.lm import layer_forwards

    cfg = _train_cfg()
    n_qdot = (len(dense_gemm_shapes(cfg, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH)) - 1
              ) * cfg.n_layers + 1
    s, fwd = REPLAN_STEPS, layer_forwards(cfg)
    wants = {
        False: {E_NAME: s * fwd * (n_qdot - 1),
                "qmatmul_fused": s * (1 + n_qdot),
                "qmatmul_bwd_pair": s * n_qdot, K7_NAME: 0, K8_NAME: s * 24,
                K9_NAME: 0},
        True: {E_NAME: s * fwd * (n_qdot - 1), "qmatmul_fused": s,
               "qmatmul_bwd_pair": 0, K7_NAME: 0, K8_NAME: s * n_qdot,
               K9_NAME: s * n_qdot}}
    make_step, built = LT.make_train_step, []

    def recording(model, tc, *rest):   # the plan of every step it builds
        built.append(model.cfg)
        return make_step(model, tc, *rest)

    counters = _train_counters()
    out = {}
    from repro_torch.obs.metrics import (MetricsRegistry, parse_prometheus,
                                         set_registry)

    for ingraph in (False, True):
        obs = (("--ingraph-telemetry", "--obs-metrics", str(TRAIN_METRICS),
                "--obs-prometheus", str(TRAIN_PROM)) if ingraph else ())
        argv = _train_argv("--policy", "perturbed", "--pp", "-2",
                           "--telemetry-cadence", "1", "--steps", str(s),
                           "--log-every", "1", *obs)
        TELEMETRY_LOG.unlink(missing_ok=True)
        TRAIN_METRICS.unlink(missing_ok=True)
        set_registry(MetricsRegistry())
        built.clear()
        buf = io.StringIO()
        LT.make_train_step = recording
        zero_counts(counters)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                res = LT.main(argv)
            torch.cuda.synchronize()
        finally:
            LT.make_train_step = make_step
        secs = time.perf_counter() - t0
        used = read_counts(counters)
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]
        losses = [r["loss"] for r in recs if "loss" in r]
        logged = [json.loads(ln) for ln in open(TELEMETRY_LOG)]
        acted = [e for e in logged if e["event"] != "ok"]
        what = "in-graph" if ingraph else "eager"
        actions = [tuple(e[k] for k in ("step", "gemm", "role", "event",
                                        "m_acc", "source")) for e in acted]
        print(f"[train] re-plan, {what} tick every step under perturbed PP "
              f"-2, {s} full-depth steps in {secs:.1f} s: losses "
              f"{[round(x, 5) for x in losses]}, actions {actions}, "
              f"schedule {res['schedule']}, steps built for {len(built)} "
              f"plans, launches {used}", flush=True)
        check(len(losses) == s and all(math.isfinite(x) for x in losses),
              f"re-plan ({what}): losses {losses}")
        check(len(logged) == 15 * s, f"re-plan ({what}): {len(logged)} "
              f"verdicts for {s} ticks")
        check(any(e["event"] == "bump" and e["step"] < s for e in acted),
              f"re-plan ({what}): no bump before the last step")
        check(len(built) >= 2 and built[-1].quant != built[0].quant,
              f"re-plan ({what}): no step built for a re-planned model")
        final = {(e["gemm"], e["role"]): e["m_acc"] for e in acted}
        check(all(getattr(getattr(built[-1].quant, g), r).m_acc == m
                  for (g, r), m in final.items()),
              f"re-plan ({what}): the last plan lacks a width the "
              f"controller set")
        check(res["schedule"] == {f"{g}:{r}": m for (g, r), m in
                                  sorted(final.items())},
              f"re-plan ({what}): schedule {res['schedule']}")
        check(used == wants[ingraph],
              f"re-plan ({what}): launches {used} != {wants[ingraph]}")
        if ingraph:
            rows = [json.loads(ln) for ln in open(TRAIN_METRICS)]
            events = sum(r["value"] for r in rows
                         if r["metric"] == "repro_controller_events_total")
            gauges = {r["labels"]["kernel"]: r["value"] for r in rows
                      if r["metric"] == "repro_kernel_launches"}
            prom = parse_prometheus(TRAIN_PROM.read_text())
            print(f"[obs] training export (--obs-metrics, --obs-prometheus):"
                  f" {len(rows)} samples, {events:.0f} controller events of "
                  f"{len(logged)} logged, launch gauges K8 "
                  f"{gauges.get('qmatmul_fused.stats')} K9 "
                  f"{gauges.get('qmatmul_bwd_pair.stats')}, Prometheus "
                  f"{len(prom)} samples parsed", flush=True)
            check(events == len(logged), "[obs] the training export lacks "
                                         "a controller event")
            check(gauges.get("qmatmul_fused.stats") == used[K8_NAME]
                  and gauges.get("qmatmul_bwd_pair.stats") == used[K9_NAME],
                  "[obs] the training export's launch gauges are not the "
                  "run's counts")
        set_registry(None)
        out[what] = dict(launches=used, losses=losses, acted=len(acted))
        del res
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# [train-4k]: the published 4096-token length under the remat policies
# --------------------------------------------------------------------------

T4K_SEQ = 4096          # Qwen2's pre-training length (arXiv:2407.10671)
T4K_STEPS = 3


def _t4k_argv(*extra) -> tuple:
    return ("--seq-len", str(T4K_SEQ), "--global-batch", "1", "--steps",
            str(T4K_STEPS), *extra)


def _timed_steps(label, step_fn, state, data, cfg, steps, tokens,
                 microbatches=1):
    """``steps`` training steps, each timed and held to the current remat
    policy's launches (``want_step``); per step (loss, ms, peak bytes,
    the launches counted)."""
    counters = _train_counters()
    want = want_step(cfg, microbatches)
    rows = []
    for step in range(steps):
        batch = next(data)
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        per = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        rows.append((loss, dt, peak, per))
        print(f"{label} step {step + 1}: loss {loss:.5f}, grad "
              f"norm {float(m['grad_norm']):.4f}, skipped "
              f"{float(m['skipped']):.0f}, {dt:.1f} ms ({tokens / dt * 1e3:.1f}"
              f" tokens/s), peak memory {peak / 2 ** 30:.2f} GiB, launches "
              f"{ {k: v for k, v in per.items() if v} }", flush=True)
        check(per == want, f"{label}: launches {per} != {want}")
        check(math.isfinite(loss), f"{label}: non-finite loss")
    return rows


def _kept_bytes(dev, n_layers: int) -> int:
    """Bytes the training forward of qwen2-1.5b cut to ``n_layers`` leaves
    for its backward at batch 1 x ``T4K_SEQ`` under the current remat
    policy: memory allocated after the loss, less before it."""
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import compute_copy

    cfg = _train_cfg(n_layers=n_layers, seq=T4K_SEQ, batch=1)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    params = model.init_params(gen, dev)
    c = compute_copy(params)
    tokens = torch.randint(0, cfg.vocab_size, (1, T4K_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    loss, _ = model.loss_fn(c, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - base
    del loss, c, params
    torch.cuda.empty_cache()
    return kept


def phase_train_4k(dev) -> dict:
    """``[train-4k]``: qwen2-1.5b at full width and depth at the published
    4096-token length through the training launcher's ``build`` (predicted
    plan, chunk 64).  (a) global batch 1 under the default ``full`` remat,
    ``T4K_STEPS`` steps: step ms, tokens/s, peak memory and the launches,
    held to the policy's counts.  (b) one step under ``dots``: its peak
    and launches within 1% of (a)'s (the GEMMs are kernels, so ``dots``
    keeps what ``full`` keeps), after one profiled ``full`` step.  (c)
    ``none`` at 1 and 2 layers: the
    bytes one layer keeps, against ``full``'s, and the 28-layer peak they
    predict; no 28-layer step under ``none`` is attempted.  (d) global
    batch 2 in 2 microbatches with dynamic loss scaling, 2 steps.  (e) at
    2 layers, the loss and every gradient under ``full`` bitwise those
    under ``none`` and those of the plain versions
    (``_t4k_remat_vs_plain``)."""
    from repro_torch.launch.train import build
    from repro_torch.models.api import param_count
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import tree_leaves

    total = torch.cuda.get_device_properties(0).total_memory
    gib = 2 ** 30
    out = {}
    with remat_policy("full"):
        torch.cuda.reset_peak_memory_stats()
        model, tc, state, data, _ = build(_train_args(*_t4k_argv()))
        cfg = model.cfg
        state_bytes = torch.cuda.memory_allocated()
        # the step's bf16 compute copy of every parameter of 2+ dimensions
        copy_bytes = sum(2 * p.numel() for p in tree_leaves(state["params"])
                         if p.ndim >= 2)
        print(f"[train-4k] {cfg.name}: {cfg.n_layers} layers, d "
              f"{cfg.d_model}, vocab {cfg.vocab_size}, "
              f"{param_count(state['params']) / 1e6:.1f}M params; predicted "
              f"plan chunk 64, batch 1 x seq {T4K_SEQ}; training state "
              f"{state_bytes / gib:.2f} GiB on a {total / gib:.2f} GiB card",
              flush=True)
        step_fn = make_train_step(model, tc)
        rows = _timed_steps("[train-4k] full", step_fn, state, data, cfg,
                            T4K_STEPS, T4K_SEQ)
        steady = min(r[1] for r in rows[1:])
        _profile_step(step_fn, state, next(data), steady, tag="[train-4k]")
    losses = [r[0] for r in rows]
    peak_full, used = rows[-1][2], rows[-1][3]
    print(f"[train-4k] (a) full: losses {[round(x, 5) for x in losses]}; "
          f"steady step {steady:.1f} ms ({T4K_SEQ / steady * 1e3:.1f} "
          f"tokens/s); peak memory {peak_full / gib:.2f} GiB of "
          f"{total / gib:.2f}; launches a step {used}", flush=True)
    check(peak_full < total, "[train-4k] peak above the card's memory")
    out.update(step_ms=steady, peak=peak_full, losses=losses, launches=used)

    with remat_policy("dots"):
        (loss_d, ms_d, peak_d, used_d), = _timed_steps(
            "[train-4k] dots", step_fn, state, data, cfg, 1, T4K_SEQ)
    print(f"[train-4k] (b) dots: {ms_d:.1f} ms, peak memory "
          f"{peak_d / gib:.2f} GiB against full's {peak_full / gib:.2f} GiB "
          f"({peak_d / peak_full:.4f}x); launches {used_d} against full's "
          f"{used}", flush=True)
    check(abs(peak_d / peak_full - 1) <= 0.01,
          "[train-4k] dots' peak is not full's within 1%")
    check(used_d == used, "[train-4k] dots launches differ from full's")
    out.update(dots_ms=ms_d, dots_peak=peak_d)
    del state, step_fn, model, data
    gc.collect()
    torch.cuda.empty_cache()

    kept = {}
    for pol in ("none", "full"):
        with remat_policy(pol):
            kept[pol] = {n: _kept_bytes(dev, n) for n in (1, 2)}
    layer = {p: k[2] - k[1] for p, k in kept.items()}
    # at the forward's end under none: the state, the compute copy, what
    # the embedding, lm_head and loss keep (1 layer's kept bytes less the
    # layer's) and every layer's residuals; the backward only adds to it
    need = (state_bytes + copy_bytes + kept["none"][1] - layer["none"]
            + cfg.n_layers * layer["none"])
    print(f"[train-4k] (c) none: one layer keeps {layer['none'] / 2 ** 20:.1f}"
          f" MiB for its backward at batch 1 x seq {T4K_SEQ} (full: "
          f"{layer['full'] / 2 ** 20:.1f} MiB, its input); the lm_head and "
          f"loss keep {(kept['none'][1] - layer['none']) / gib:.2f} GiB; "
          f"{cfg.n_layers} layers under none hold at least {need / gib:.2f} "
          f"GiB at the forward's end (state {state_bytes / gib:.2f}, compute "
          f"copy {copy_bytes / gib:.2f}) against the card's "
          f"{total / gib:.2f} GiB: "
          f"{'fits' if need < total else 'does not fit, not attempted'}",
          flush=True)
    check(layer["none"] > layer["full"] > 0, "[train-4k] none keeps no more "
          "than full")
    out.update(layer_none=layer["none"], layer_full=layer["full"],
               none_need=need)

    with remat_policy("full"):
        torch.cuda.reset_peak_memory_stats()
        model, tc, state, data, _ = build(_train_args(*_t4k_argv(
            "--global-batch", "2", "--microbatches", "2", "--loss-scaling",
            "--steps", "2")))
        step_fn = make_train_step(model, tc)
        rows_mb = _timed_steps("[train-4k] microbatches 2, loss scaling",
                               step_fn, state, data, model.cfg, 2,
                               2 * T4K_SEQ, microbatches=2)
    ms_mb = rows_mb[-1][1]
    print(f"[train-4k] (d) global batch 2 in 2 microbatches, loss scaling: "
          f"step {ms_mb:.1f} ms ({ms_mb / steady:.3f}x (a)'s), peak memory "
          f"{max(r[2] for r in rows_mb) / gib:.2f} GiB", flush=True)
    out.update(mb_ms=ms_mb, mb_peak=max(r[2] for r in rows_mb))
    del state, step_fn, model, data
    gc.collect()
    torch.cuda.empty_cache()

    out.update(_t4k_remat_vs_plain(dev))
    return out


def _t4k_remat_vs_plain(dev) -> dict:
    """``[train-4k]`` (e): qwen2-1.5b cut to 2 layers at full width, batch
    1 x ``T4K_SEQ``: the loss and every gradient through the kernels under
    ``full``, then under ``none``, then through the kernels' plain
    versions under ``full``, all three bitwise.  The plain run holds E, B
    and G to their plain versions at the 4096-row shapes of the
    [train-4k] steps (B's weight gradient over 64 chunks of T, the
    lm_head's 4096 x 151936 G and B, whose f32 g passes 2^31 bytes)."""
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import _grads, compute_copy
    from repro_torch.train.optimizer import tree_leaves

    cfg = _train_cfg(n_layers=2, seq=T4K_SEQ, batch=1)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 73)
    params = model.init_params(gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, T4K_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)

    def step():
        c = compute_copy(params)
        loss, _ = model.loss_fn(c, {"tokens": tokens}, cfg)
        loss.backward()
        return loss.detach(), tree_leaves(_grads(c, params))

    counters = _train_counters()
    got, used = {}, {}
    for pol in ("full", "none"):
        with remat_policy(pol):
            zero_counts(counters)
            got[pol] = step()
            used[pol] = read_counts(counters)
    with remat_policy("full"), plain_versions():
        t0 = time.perf_counter()
        got["plain"] = step()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    loss = float(got["full"][0])
    for label in ("none", "plain"):
        leaves = list(zip(got["full"][1], got[label][1]))
        same = sum(bool(torch.equal(a, b)) for a, b in leaves)
        err = max(float((a - b).abs().max()) for a, b in leaves)
        print(f"[train-4k] (e) 2 layers at seq {T4K_SEQ}, kernels under full "
              f"vs {'kernels under none' if label == 'none' else 'plain'}: "
              f"loss {loss:.6f} vs {float(got[label][0]):.6f}; "
              f"{same}/{len(leaves)} gradient leaves bitwise equal (max "
              f"|err| {err:.3g})", flush=True)
        check(torch.equal(got["full"][0], got[label][0]),
              f"[train-4k] full's loss differs from {label}'s")
        check(same == len(leaves), f"[train-4k] a gradient differs between "
              f"full and {label}")
    print(f"[train-4k] (e) kernel launches under full "
          f"{ {k: v for k, v in used['full'].items() if v} }, under none "
          f"{ {k: v for k, v in used['none'].items() if v} }; plain step "
          f"{plain_s:.1f} s", flush=True)
    for k in (E_NAME, "qmatmul_fused", "qmatmul_bwd_pair"):
        check(used["full"][k] > 0 and used["none"][k] > 0,
              f"[train-4k] (e) launched no {k}")
    del got, params
    torch.cuda.empty_cache()
    return dict(plain_4k_s=plain_s)


def phase_fig6(dev) -> dict:
    """``[fig6]``: ``repro_torch.paper.fig6_convergence.run()`` at its
    defaults on the card (the smoke config, 60 steps of 8 x 64 tokens, the
    exact baseline, PP 0, -2 and -4): its lines, the four tail losses and
    the verdict, and its kernel launches (E, G and B on the quantized
    runs)."""
    import contextlib
    import io

    from repro_torch.paper.fig6_convergence import run

    counters = _train_counters()
    zero_counts(counters)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = run(device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    used = read_counts(counters)
    for line in buf.getvalue().splitlines():
        if line.strip():
            print(f"[fig6] {line}", flush=True)
    tails = res["tails"]
    print(f"[fig6] tail losses {json.dumps(tails)}; {secs:.1f} s; launches "
          f"{ {k: v for k, v in used.items() if v} }", flush=True)
    check(set(tails) == {"exact", "PP= 0", "PP=-2", "PP=-4"} and all(
        math.isfinite(v) for v in tails.values()), f"[fig6] tails {tails}")
    for k in (E_NAME, "qmatmul_fused", "qmatmul_bwd_pair"):
        check(used[k] > 0, f"[fig6] {k} was not launched")
    return dict(secs=secs, **res)


# --------------------------------------------------------------------------
# the oracle (K2, K3) and the dense resumable prefill (K10)
# --------------------------------------------------------------------------

K2_NAME = "quantize"                   # K2: the oracle's operand quantizer
K3_NAME = "qmatmul"                    # K3: the oracle's chunked GEMM
K10_NAME = "flash_prefill"             # K10: the dense resumable prefill


def oracle_plan(cfg):
    """``cfg`` with ``fused=False`` in every QDotConfig of its plan: the
    unfused oracle (K2 and K3) in place of G, E and B.  The JAX package
    has no such helper; the tests keep their own."""
    from dataclasses import replace

    from repro_torch.telemetry.controller import PLAN_FIELDS

    fields = {name: replace(getattr(cfg.quant, name), fused=False)
              for name in PLAN_FIELDS if getattr(cfg.quant, name) is not None}
    return replace(cfg, quant=replace(cfg.quant, **fields))


def _oracle_counters():
    """The training counters plus K2 and K3."""
    from repro_torch.kernels.qmatmul import qmatmul
    from repro_torch.kernels.quantize import quantize

    return dict(_train_counters(), **{K2_NAME: (quantize, "launches"),
                                      K3_NAME: (qmatmul, "launches")})


def _k3_kw(p) -> dict:
    """K3's arguments for one role (``kernels.ops._mm``)."""
    from repro_torch.kernels.ops import _WIDE_CHUNK, _acc_params

    e, m, c = _acc_params(p)
    return dict(e_acc=e, m_acc=m, block_k=c or _WIDE_CHUNK)


def _k3_cost(a, b, peak):
    """(bytes, operations, peak) of one K3 call: A and B read in their
    dtypes, C f32 written; 2MNK operations."""
    m, k = a.shape
    n = b.shape[1]
    return (a.numel() * a.element_size() + b.numel() * b.element_size()
            + m * n * 4, 2 * m * n * k, peak)


def _k2_call_times(k, n, f, x, w, g) -> list[dict]:
    """K2 on one (K, N)'s three calls of the oracle step (x f32 (T, K), w
    bf16 (K, N), g f32 (T, N)), each alone: a CUDA graph replay of one
    call (median and spread), eagerly, and its bound (the input read and
    the f32 output written, over the memory rate)."""
    from repro_torch.kernels.quantize import quantize

    res = []
    for what, v in (("x", x), ("w", w), ("g", g)):
        call = functools.partial(quantize, v, e=f.e, m=f.m)
        graph = lib_time(call, reps=50)
        eager = cuda_time(call, reps=50, warmup=5)
        b_ms, _ = bound_ms(v.numel() * (v.element_size() + 4), 0, F32_FLOPS)
        print(f"  K2 call {what} {tuple(v.shape)} {str(v.dtype)[6:]}: graph "
              f"replay {lib_str(graph)}, eager {eager:.4f} ms, bound "
              f"{b_ms:.5f} ms, {b_ms / graph[0]:.4f} of it", flush=True)
        res.append(dict(kn=(k, n), call=what, shape=list(v.shape),
                        dtype=str(v.dtype)[6:], ms=graph[0],
                        graph_spread_ms=list(graph[1]), eager_ms=eager,
                        bound_ms=b_ms))
    return res


def phase_oracle_kernels(dev) -> dict:
    """K2 and K3 against their plain versions, bitwise, at the training
    cell's layer shapes (T = 512; the four distinct (K, N) of a layer; K2
    on x, w and g, K3 in its three roles FWD Q(x) @ Q(w), BWD Q(g) @ Q(w)^T
    and GRAD Q(x)^T @ Q(g), on K2's outputs and on lattice operands) and
    on ``HEAD_SLICE`` columns of the tied lm_head (raw f32 x, the bf16
    embed.T view); then one oracle training step's K2 launches (3 a
    quantized qdot) and K3 launches (3 a qdot, the whole lm_head
    included) timed as sequences against the plain versions and, for K3,
    bf16 ``torch.matmul`` at the same shapes; K2's 588 short launches as a
    CUDA graph replay (median and spread; eagerly they measure the host),
    the eager time beside, and each of its 12 distinct calls alone.  The
    timed step's three calls on the whole lm_head are also held bitwise
    against the plain step's outputs."""
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_reference
    from repro_torch.kernels.quantize import quantize, quantize_reference
    from repro_torch.models.api import dense_gemm_shapes

    cfg = _train_cfg()
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    shapes = dense_gemm_shapes(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    head, layer = shapes[0], shapes[1:]
    t = head[1]
    print(f"[kernels] K2 quantize and K3 qmatmul (the fused=False oracle) vs "
          f"plain at T={t} (per shape and role: kernel ms, bf16 "
          f"torch.matmul ms; plain ms over a whole step below)", flush=True)
    k3_err = 0.0
    tensors, k2_calls = {}, []
    for tag, _, k, n, qc in layer:
        if (k, n) in tensors:
            continue
        f = qc.repr_fmt
        x = torch.randn((t, k), generator=gen, device=dev)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        g = torch.randn((t, n), generator=gen, device=dev) / math.sqrt(n)
        q = {}
        for name, v in (("x", x), ("w", w), ("g", g)):
            got = quantize(v, e=f.e, m=f.m)
            want = quantize_reference(v, e=f.e, m=f.m)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"K2 {tag} {name}: not bitwise the plain version")
            q[name] = got
        print(f"  K2 {tag} x ({t}, {k}) f32, w ({k}, {n}) bf16, g ({t}, {n})"
              f" f32 to {f}: bitwise the plain version", flush=True)
        lat = [_lattice(gen, s_, dev) for s_ in ((t, k), (k, n), (t, n))]
        for label, (xq, wq, gq) in (("random", (q["x"], q["w"], q["g"])),
                                    ("lattice", lat)):
            for role, a, b, p in (("FWD", xq, wq, qc.fwd),
                                  ("BWD", gq, wq.T, qc.bwd),
                                  ("GRAD", xq.T, gq, qc.grad)):
                kw = _k3_kw(p)
                k3_err = max(k3_err, compare(
                    f"K3 {tag} {role} {label} M={a.shape[0]} K={a.shape[1]} "
                    f"N={b.shape[1]}", qmatmul(a, b, **kw),
                    qmatmul_reference(a, b, **kw), kw["m_acc"], kw["e_acc"],
                    bitwise=True))
        xq, wq, gq = q["x"], q["w"], q["g"]
        xb, wb, gb = (v.to(torch.bfloat16) for v in (xq, wq, gq))
        times = []
        for role, a, b, p, la, lb in (("FWD", xq, wq, qc.fwd, xb, wb),
                                      ("BWD", gq, wq.T, qc.bwd, gb, wb.T),
                                      ("GRAD", xq.T, gq, qc.grad, xb.T, gb)):
            kw = _k3_kw(p)
            ms = cuda_time(lambda: qmatmul(a, b, **kw), reps=5)
            lib = lib_time(lambda: torch.matmul(la, lb))
            times.append(f"{role} {ms:.4f} ms (library {lib_str(lib)})")
        print(f"  time {tag} K={k} N={n}: K3 {', '.join(times)}",
              flush=True)
        k2_calls += _k2_call_times(k, n, f, x, w, g)
        tensors[(k, n)] = (x, w, g, xq, wq, gq, xb, wb, gb)

    # the tied lm_head: repr_fmt None, so no K2; raw f32 x, bf16 embed.T
    _, _, k, n, hq = head
    emb = (torch.randn((n, k), generator=gen, device=dev)
           / math.sqrt(k)).to(torch.bfloat16)
    hx = torch.randn((t, k), generator=gen, device=dev)
    hg = torch.randn((t, n), generator=gen, device=dev) / math.sqrt(n)
    sl = slice(0, HEAD_SLICE)
    for lattice in (False, True):
        xs = _lattice(gen, (t, k), dev) if lattice else hx
        ws = (_lattice(gen, (HEAD_SLICE, k), dev).to(torch.bfloat16).T
              if lattice else emb[sl].T)
        gs = _lattice(gen, (t, HEAD_SLICE), dev) if lattice else hg[:, sl]
        for role, a, b, p in (("FWD", xs, ws, hq.fwd), ("BWD", gs, ws.T, hq.bwd),
                              ("GRAD", xs.T, gs, hq.grad)):
            kw = _k3_kw(p)
            k3_err = max(k3_err, compare(
                f"K3 lm_head[:, :{HEAD_SLICE}] {role} "
                f"{'lattice' if lattice else 'random'}", qmatmul(a, b, **kw),
                qmatmul_reference(a, b, **kw), kw["m_acc"], kw["e_acc"],
                bitwise=True))

    # one oracle training step's launches, in layer order
    depth = cfg.n_layers
    calls = [(tensors[(k, n)], qc) for _ in range(depth)
             for _, _, k, n, qc in layer]
    hxb, hgb = hx.to(torch.bfloat16), hg.to(torch.bfloat16)

    def run_k2(fn):
        for (x, w, g, *_), qc in calls:
            f = qc.repr_fmt
            for v in (x, w, g):
                fn(v, e=f.e, m=f.m)

    def k3_calls():
        """(A, B, role precision, peak rate): the layers contract (1,5,2)
        values (K2's outputs) at the FP8 rate, the lm_head raw f32 x bf16
        at the bf16 rate, as the E and B rows count them."""
        for (_, _, _, xq, wq, gq, *_), qc in calls:
            yield xq, wq, qc.fwd, FP8_FLOPS
            yield gq, wq.T, qc.bwd, FP8_FLOPS
            yield xq.T, gq, qc.grad, FP8_FLOPS
        yield hx, emb.T, hq.fwd, BF16_FLOPS
        yield hg, emb, hq.bwd, BF16_FLOPS
        yield hx.T, hg, hq.grad, BF16_FLOPS

    k3_list = list(k3_calls())
    # the plain version is timed at a cut depth: one layer's calls and the
    # lm_head's three, whose outputs the whole-head check needs; the kernel
    # beside it on the same calls
    k3_cut = k3_list[:3 * len(layer)] + k3_list[-3:]
    head_out = {}

    def run_k3(fn, seq=k3_list):
        """K3's calls of ``seq`` (one step's by default); keeps the whole
        lm_head's three outputs, its last three."""
        outs = head_out[fn] = []
        for i, (a, b, p, _) in enumerate(seq):
            y = fn(a, b, **_k3_kw(p))
            if i >= len(seq) - 3:
                outs.append(y)

    def check_head() -> float:
        """K3 on the whole tied lm_head (FWD N = vocab, BWD contracting K =
        vocab, GRAD writing the (d, vocab) dw) against the plain version's
        outputs of the same step, bitwise."""
        err = 0.0
        for role, got, want, p in zip(
                ("FWD", "BWD", "GRAD"), head_out.pop(qmatmul),
                head_out.pop(qmatmul_reference), (hq.fwd, hq.bwd, hq.grad)):
            kw = _k3_kw(p)
            err = max(err, compare(
                f"K3 lm_head {role} whole (T={t}, N={n}) vs plain", got, want,
                kw["m_acc"], kw["e_acc"], bitwise=True))
        return err

    def lib_k3():
        for (*_, xb, wb, gb), _ in calls:
            torch.matmul(xb, wb)
            torch.matmul(gb, wb.T)
            torch.matmul(xb.T, gb)
        torch.matmul(hxb, emb.T)
        torch.matmul(hgb, emb)
        torch.matmul(hxb.T, hgb)

    k2_cost = [(v.numel() * (v.element_size() + 4), 0, F32_FLOPS)
               for (x, w, g, *_), _ in calls for v in (x, w, g)]
    k3_cost = [_k3_cost(a, b, peak) for a, b, _, peak in k3_list]
    out = {}
    for name, run, fn, ref, lib, cost, err in (
            ("K2", run_k2, quantize, quantize_reference, None, k2_cost, 0.0),
            ("K3", run_k3, qmatmul, qmatmul_reference, lib_k3, k3_cost,
             k3_err)):
        graph = None
        if name == "K2":
            # 588 short launches: the eager sequence measures the host, so
            # the card's time is a CUDA graph replay, the eager time beside
            graph = lib_time(lambda: run(fn), reps=3)
        eager = cuda_time(lambda: run(fn), reps=2, warmup=1)
        ms = graph[0] if graph else eager
        if name == "K3":
            plain = cuda_time(lambda: run(ref, k3_cut), reps=1, warmup=0)
            cut_ms = cuda_time(lambda: run(fn, k3_cut), reps=2, warmup=1)
            err = max(err, check_head())
            cut = (f"one layer's {3 * len(layer)} calls and the lm_head's "
                   f"3 at T={t}")
        else:
            plain = cuda_time(lambda: run(ref), reps=1, warmup=0)
            cut_ms, cut = eager, f"the whole step's {len(cost)} calls"
        lib_ms = lib_time(lib, reps=3) if lib is not None else None
        b_ms, b_by = seq_bound(cost)
        lib_s = (f"library {lib_str(lib_ms)}" if lib_ms is not None else
                 "library none (no PyTorch call rounds to (1,e,m) with "
                 "saturation and flush to zero: a float8_e5m2 cast has "
                 "another exponent range and overflows to inf)")
        f_ms = fma_bound(cost) if name == "K3" else None
        fma_s = ("" if f_ms is None else
                 f"; f32-FMA bound {f_ms:.3f} ms, {f_ms / ms:.4f} of it")
        k_s = (f"graph replay {lib_str(graph)}, eager {eager:.4f} ms" if graph
               else f"kernel {ms:.3f} ms")
        print(f"[kernels] {name} one oracle training step ({len(cost)} "
              f"launches, T={t}): {k_s}, {lib_s}, bound {b_ms:.4f} ms "
              f"({b_by}), {b_ms / ms:.4f} of bound{fma_s}; plain at {cut} "
              f"{plain:.1f} ms against the kernel's {cut_ms:.3f} ms there "
              f"(eager)", flush=True)
        out[name] = dict(ms=ms, plain_ms=plain, plain_depth=cut,
                         plain_depth_kernel_ms=cut_ms,
                         library_ms=lib_ms and lib_ms[0],
                         library_spread_ms=lib_ms and list(lib_ms[1]),
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        if graph:
            out[name].update(graph_spread_ms=list(graph[1]), eager_ms=eager)
        if f_ms is not None:
            out[name]["fma_bound_ms"] = f_ms
    # the step's sequence against the sum of its calls' replays: the calls
    # of a layer, each (K, N) as often as the layer runs it
    per_layer = {}
    for _, _, k, n, _ in layer:
        per_layer[(k, n)] = per_layer.get((k, n), 0) + 1
    step_sum = depth * sum(per_layer[c["kn"]] * c["ms"] for c in k2_calls)
    print(f"  K2 the step as the sum of its calls' replays: {step_sum:.4f} ms "
          f"(the sequence's replay {out['K2']['ms']:.4f} ms)", flush=True)
    out["K2"]["calls"] = k2_calls
    return out


def phase_train_oracle(dev) -> dict:
    """The unfused oracle on the training path.  At the 2-layer cut of
    qwen2-1.5b at full width (batch 2 x seq 64): one step under the oracle
    plan (``oracle_plan``: every qdot through K2 and K3) against the fused
    step, the loss and every gradient leaf bitwise, and no G, E or B
    launch in the oracle step.  Then the train cell at full depth (the
    training launcher's own set-up, the same seeded weights and batches)
    for 2 steps, fused and then oracle: the losses bitwise, each run's
    second step time and peak memory, and its launches."""
    from repro_torch.launch.train import build
    from repro_torch.models.api import dense_gemm_shapes, get_model
    from repro_torch.models.lm import layer_forwards
    from repro_torch.train.loop import _grads, compute_copy, make_train_step
    from repro_torch.train.optimizer import tree_leaves

    fused_names = ("qmatmul_fused", E_NAME, "qmatmul_bwd_pair")
    counters = _oracle_counters()
    cfg = _train_cfg(n_layers=2, batch=2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    params = get_model(cfg).init_params(gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, TRAIN_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)

    def step(c):
        model = get_model(c)
        cc = compute_copy(params)
        loss, _ = model.loss_fn(cc, {"tokens": tokens}, c)
        loss.backward()
        return loss.detach(), _grads(cc, params)

    zero_counts(counters)
    lf, gf = step(cfg)
    used_f = read_counts(counters)
    zero_counts(counters)
    lo, go = step(oracle_plan(cfg))
    used_o = read_counts(counters)
    leaves = list(zip(tree_leaves(gf), tree_leaves(go)))
    same = sum(bool(torch.equal(a, b)) for a, b in leaves)
    err = max(float((a - b).abs().max()) for a, b in leaves)
    print(f"[train] oracle vs fused, 2 layers at full width, batch 2 x seq "
          f"{TRAIN_SEQ}: loss {float(lo):.6f} vs {float(lf):.6f}; "
          f"{same}/{len(leaves)} gradient leaves bitwise equal (max |err| "
          f"{err:.3g}); launches oracle {used_o}, fused {used_f}", flush=True)
    check(torch.equal(lo, lf), "oracle loss differs from the fused loss")
    check(same == len(leaves), "an oracle gradient differs from the fused")
    check(used_o[K2_NAME] > 0 and used_o[K3_NAME] > 0,
          "the oracle step launched no K2 or K3")
    check(all(used_o[k] == 0 for k in fused_names),
          "the oracle step launched a fused kernel")
    check(used_f[K2_NAME] == 0 and used_f[K3_NAME] == 0,
          "the fused step launched an oracle kernel")
    del params, gf, go, leaves
    torch.cuda.empty_cache()

    full = _train_cfg()
    n_qdot = (len(dense_gemm_shapes(full, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH)) - 1
              ) * full.n_layers + 1
    steps, fwd = 2, layer_forwards(full)
    # a layer qdot: K2 on x and w each forward pass and on g; K3 once a
    # forward pass and twice in the backward (the lm_head: K3 only)
    want = {True: {K2_NAME: steps * (2 * fwd + 1) * (n_qdot - 1),
                   K3_NAME: steps * ((fwd + 2) * (n_qdot - 1) + 3)},
            False: {K2_NAME: 0, K3_NAME: 0,
                    E_NAME: steps * fwd * (n_qdot - 1),
                    "qmatmul_fused": steps,
                    "qmatmul_bwd_pair": steps * n_qdot}}
    runs = {}
    for oracle in (False, True):
        torch.cuda.reset_peak_memory_stats()
        model, tc, state, data, _ = build(_train_args())
        if oracle:
            model = get_model(oracle_plan(model.cfg))
        step_fn = make_train_step(model, tc)
        zero_counts(counters)
        losses, ms = [], []
        for _ in range(steps):
            batch = next(data)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        used = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        what = "oracle" if oracle else "fused"
        print(f"[train] {what} full depth, batch {TRAIN_BATCH} x seq "
              f"{TRAIN_SEQ}: losses {losses}, step ms {[round(x, 1) for x in ms]}"
              f", peak memory {peak / 2 ** 30:.2f} GiB, launches {used}",
              flush=True)
        check(all(used[k] == v for k, v in want[oracle].items()),
              f"{what} full-depth launches {used} != {want[oracle]}")
        if oracle:
            check(all(used[k] == 0 for k in fused_names),
                  "the oracle step launched a fused kernel")
        runs[oracle] = dict(losses=losses, ms=ms[-1], peak=peak,
                            launches=used)
        del model, state, data, step_fn
        torch.cuda.empty_cache()
    o, f = runs[True], runs[False]
    print(f"[train] oracle vs fused step at full depth: losses "
          f"{'bitwise equal' if o['losses'] == f['losses'] else 'DIFFERENT'};"
          f" second step {o['ms']:.1f} ms vs {f['ms']:.1f} ms "
          f"({o['ms'] / f['ms']:.3f}x); peak memory "
          f"{o['peak'] / 2 ** 30:.2f} vs {f['peak'] / 2 ** 30:.2f} GiB",
          flush=True)
    check(o["losses"] == f["losses"], "full-depth oracle loss differs")
    return dict(launches=o["launches"], ms=o["ms"], fused_ms=f["ms"])


def phase_serve_oracle(cfg, params, dev, prompt) -> dict:
    """The serve cell's prefill logits of one request at full depth under
    the oracle plan (K2 and K3 at serving shapes, P for attention)
    against the fused plan's (G), bitwise, with the oracle run's
    launches."""
    from repro_torch.kernels.attention import flash_prefill_paged
    from repro_torch.models.api import get_paged_model, paged_init_state
    from repro_torch.quant.formats import FPFormat
    from repro_torch.serve.plan import plan_attention

    n = len(prompt)
    plan = plan_attention(4 * PAGE * (-(-n // PAGE)), PAGE)
    _, bucket = plan.bucket_for(n)
    pages = torch.arange(1, -(-n // PAGE) + 1, device=dev)
    counters = dict(_oracle_counters(), flash_prefill_paged=(
        flash_prefill_paged, "launches"))

    def run(c):
        kv = paged_init_state(c, n_pages=int(pages[-1]) + 1, page_size=PAGE,
                              device=dev)
        zero_counts(counters)
        with torch.no_grad():
            logits = get_paged_model(c).prefill(
                params, torch.tensor([prompt], device=dev), kv,
                pages.to(torch.int32), pages, 0, n, kv_fmt=FPFormat(5, 2),
                acc=bucket.acc)
        torch.cuda.synchronize()
        return logits, kv, read_counts(counters)

    lf, kvf, _ = run(cfg)
    lo, kvo, used = run(oracle_plan(cfg))
    same_kv = all(torch.equal(kvf[k], kvo[k]) for k in kvf)
    print(f"[serve] oracle vs fused prefill logits of a {n}-token request at "
          f"full depth: {'bitwise equal' if torch.equal(lf, lo) else 'DIFFERENT'}"
          f" (max |err| {float((lf.float() - lo.float()).abs().max()):.3g}), "
          f"arena {'bitwise equal' if same_kv else 'DIFFERENT'}; oracle "
          f"launches {used}", flush=True)
    check(torch.equal(lf, lo) and same_kv, "oracle prefill differs")
    check(used[K2_NAME] > 0 and used[K3_NAME] > 0
          and used["flash_prefill_paged"] > 0, "oracle serving launches")
    check(used["qmatmul_fused"] == 0, "the oracle prefill launched G")
    return dict(launches=used)


DENSE_SPLIT = 256                      # a resume point of the K10 checks


def phase_dense_prefill(cfg, params, dev, plan, prompts) -> dict:
    """The dense resumable prefill at qwen2-1.5b's widths (H 12, KV 2, dh
    128, page 16), on layer 0's attention weights and the serve cell's 8
    prompts (the layer's rms-normed embeddings), each prompt at its
    predicted bucket's carry: ``attn_prefill_paged`` (one-shot, K10),
    ``attn_prefill_chunk_paged`` in ``SLAB``-token slabs (K10 with the
    carry out, then in) and ``attn_prefill_bucketed`` (P): outputs and
    arena bytes bitwise equal, and both K10 paths bitwise through the plain
    versions.  Then K10 against its plain version on the one-shot calls'
    own inputs and at S = 512 with chunk 64 and 128 (random and lattice,
    one-shot and resumed at ``DENSE_SPLIT``, block_q 8, 16 and 32), and
    the 8 one-shot calls timed as a sequence against the plain version and
    bf16 causal SDPA."""
    from repro_torch.kernels import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models.api import paged_init_state
    from repro_torch.quant.formats import FPFormat

    fmt = FPFormat(5, 2)
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    ln1 = params["layers"]["ln1"][0]
    counters = {K10_NAME: (A.flash_prefill, "launches"),
                "flash_prefill_paged": (A.flash_prefill_paged, "launches")}
    oneshot_inputs = []
    real = L.flash_prefill

    def recording(q, k, v, **kw):
        # the layers pass an AttnCall: kept as the keywords it stands for
        call = kw.pop("call", None)
        if call is not None:
            kw.update(acc=call.acc, chunk=call.chunk,
                      block_q=call.resolve_block_q(), q_offset=call.q_offset,
                      kv_offset=call.kv_offset)
            if call.return_carry:
                kw["return_carry"] = True
        oneshot_inputs.append((q, k, v, kw))
        return real(q, k, v, **kw)

    def arena(npg):
        st = paged_init_state(cfg, n_pages=npg + 1, page_size=PAGE,
                              device=dev)
        return {k: v[0] for k, v in st.items()}

    def paths(x, pages, n, acc, width):
        """The three layer paths' outputs and arenas."""
        npg = pages.shape[0]
        kv1 = arena(npg)
        y1 = L.attn_prefill_paged(lp, x, kv1, pages, torch.arange(
            n, device=dev)[None], cfg, kv_fmt=fmt, acc=acc)
        kv2, ys = arena(npg), []
        for a in range(0, n, SLAB):
            b = min(a + SLAB, n)
            ys.append(L.attn_prefill_chunk_paged(
                lp, x[:, a:b], kv2, pages[:a // PAGE],
                pages[a // PAGE:-(-b // PAGE)], a, cfg, kv_fmt=fmt, acc=acc))
        kv3, ys3 = arena(npg), []
        row = torch.zeros((width,), dtype=torch.int32, device=dev)
        row[:npg] = pages
        for a in range(0, n, SLAB):
            q_len = min(SLAB, n - a)
            xs = torch.nn.functional.pad(x[:, a:a + q_len],
                                         (0, 0, 0, SLAB - q_len))
            sp = torch.zeros((SLAB // PAGE,), dtype=torch.int32, device=dev)
            used = -(-q_len // PAGE)
            sp[:used] = pages[a // PAGE:a // PAGE + used]
            ys3.append(L.attn_prefill_bucketed(
                lp, xs, kv3, row, sp, a, q_len, cfg, kv_fmt=fmt,
                acc=acc)[:, :q_len])
        return (y1, torch.cat(ys, 1), torch.cat(ys3, 1)), (kv1, kv2, kv3)

    print(f"[serve] dense prefill at full width: layer 0, H={h} KV={kv} "
          f"dh={dh} page {PAGE}, prompts {list(PROMPT_LENS)}, slabs {SLAB}",
          flush=True)
    zero_counts(counters)
    results, equal = [], 0
    L.flash_prefill = recording
    try:
        for prompt in prompts:
            n = len(prompt)
            _, bucket = plan.bucket_for(n)
            tok = torch.tensor(prompt, device=dev)
            x = L.rms_norm(params["embed"][tok].to(torch.bfloat16), ln1,
                           cfg.norm_eps)[None]
            pages = torch.arange(1, -(-n // PAGE) + 1, dtype=torch.int32,
                                 device=dev)
            n_before = len(oneshot_inputs)
            ys, kvs = paths(x, pages, n, bucket.acc, bucket.max_pages(PAGE))
            # keep the one-shot call's inputs only (the first of the prompt)
            del oneshot_inputs[n_before + 1:]
            ok = (all(torch.equal(ys[0], y) for y in ys[1:])
                  and all(torch.equal(kvs[0][k], kk[k]) for kk in kvs[1:]
                          for k in kvs[0]))
            equal += ok
            results.append((x, pages, n, bucket, ys[0]))
    finally:
        L.flash_prefill = real
    launches = read_counts(counters)
    print(f"[serve] dense prefill: {equal}/{len(prompts)} prompts with "
          f"one-shot K10, {SLAB}-token K10 slabs and bucketed P bitwise "
          f"equal (outputs and arena bytes); launches {launches}", flush=True)
    check(equal == len(prompts), "the three prefill paths differ")
    check(launches[K10_NAME] > 0 and launches["flash_prefill_paged"] > 0,
          "the dense prefill phase launched no K10 or P")
    with plain_versions():
        for x, pages, n, bucket, y in results:
            ys, _ = paths(x, pages, n, bucket.acc, bucket.max_pages(PAGE))
            check(all(torch.equal(y, yy) for yy in ys),
                  f"{n}-token prompt: kernels differ from the plain versions")
    print("[serve] dense prefill: the three paths bitwise through the plain "
          "versions too", flush=True)

    err = 0.0
    for q, k, v, kw in oneshot_inputs:
        got = A.flash_prefill(q, k, v, **kw)
        err = max(err, _attn_check(
            f"K10 one-shot S={q.shape[0]} chunk {kw['chunk']} acc "
            f"{kw['acc']}", got, A.flash_prefill_reference(q, k, v, **kw),
            kw["acc"], bitwise=True))
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    s512, acc = 512, plan.bucket_for(512)[1].acc
    for chunk in (64, 128):
        for label in ("random", "lattice"):
            mk = ((lambda s_: _lattice(gen, s_, dev)) if label == "lattice"
                  else (lambda s_: torch.randn(s_, generator=gen,
                                               device=dev)))
            q, k, v = mk((s512, h, dh)), mk((s512, kv, dh)), mk((s512, kv, dh))
            kw = dict(acc=acc, chunk=chunk)
            want = A.flash_prefill_reference(q, k, v, **kw)
            for bq in A.BLOCK_QS:
                err = max(err, _attn_check(
                    f"K10 S={s512} chunk {chunk} block_q {bq} {label}",
                    A.flash_prefill(q, k, v, block_q=bq, **kw), want, acc,
                    bitwise=True))
            c = A.flash_prefill(q, k[:DENSE_SPLIT], v[:DENSE_SPLIT],
                                return_carry=True, **kw)
            pc = A.flash_prefill_reference(q, k[:DENSE_SPLIT], v[:DENSE_SPLIT],
                                           return_carry=True, **kw)
            for got_, want_, name in zip(c, pc, ("o", "m", "l")):
                check(torch.equal(got_, want_),
                      f"K10 carry {name} differs from the plain version")
            res = A.flash_prefill(q, k[DENSE_SPLIT:], v[DENSE_SPLIT:],
                                  kv_offset=DENSE_SPLIT, carry=c, **kw)
            err = max(err, _attn_check(
                f"K10 S={s512} chunk {chunk} {label} resumed at "
                f"{DENSE_SPLIT} vs one-shot", res, want, acc, bitwise=True))
        ms = lib_time(lambda: A.flash_prefill(q, k, v, **kw), reps=20)[0]
        qb = q.permute(1, 0, 2)[None].to(torch.bfloat16)
        kb = k.repeat_interleave(h // kv, dim=1).permute(1, 0, 2)[None].to(
            torch.bfloat16)
        vb = v.repeat_interleave(h // kv, dim=1).permute(1, 0, 2)[None].to(
            torch.bfloat16)
        lib = lib_time(lambda: torch.nn.functional.scaled_dot_product_attention(
            qb, kb, vb, is_causal=True), reps=20)
        print(f"  time K10 S={s512} chunk {chunk}: graph replay {ms:.4f} ms, "
              f"SDPA {lib_str(lib)}", flush=True)

    def run(fn):
        for q, k, v, kw in oneshot_inputs:
            fn(q, k, v, **kw)

    dense = []
    for q, k, v, _ in oneshot_inputs:
        rep = lambda t: t.repeat_interleave(h // kv, dim=1).permute(  # noqa
            1, 0, 2)[None].to(torch.bfloat16)
        dense.append((q.permute(1, 0, 2)[None].to(torch.bfloat16), rep(k),
                      rep(v)))

    def lib_run():
        for qb, kb, vb in dense:
            torch.nn.functional.scaled_dot_product_attention(
                qb, kb, vb, is_causal=True)

    graph = lib_time(lambda: run(A.flash_prefill), reps=10)
    eager = cuda_time(lambda: run(A.flash_prefill), reps=10)
    plain = cuda_time(lambda: run(A.flash_prefill_reference), reps=1,
                      warmup=0)
    lib = lib_time(lib_run, reps=10)
    # bytes: q, k, v read and the output written (f32); operations: the
    # score and value contractions over the attended (row, column) pairs
    cost = [((q.numel() * 2 + k.numel() * 2) * 4,
             4 * h * dh * q.shape[0] * (q.shape[0] + 1) // 2, F32_FLOPS)
            for q, k, _, _ in oneshot_inputs]
    b_ms, b_by = seq_bound(cost)
    ma_ms = 2 * sum(c[1] for c in cost) / F32_FLOPS * 1e3
    print(f"[kernels] K10 the serve prompts' one-shot prefill "
          f"({len(cost)} launches, S {list(PROMPT_LENS)}, chunk {PAGE}): "
          f"graph replay {lib_str(graph)}, eager {eager:.4f} ms, plain "
          f"{plain:.1f} ms, SDPA {lib_str(lib)} ({graph[0] / lib[0]:.2f}x), "
          f"bound {b_ms:.5f} ms ({b_by}), {b_ms / graph[0]:.4f} of it; "
          f"mul-then-add bound {ma_ms:.5f} ms, {ma_ms / graph[0]:.4f} of it",
          flush=True)
    return dict(launches=launches[K10_NAME], ms=graph[0],
                graph_spread_ms=list(graph[1]), eager_ms=eager,
                plain_ms=plain, library_ms=lib[0],
                library_spread_ms=list(lib[1]), bound_ms=b_ms, bound_by=b_by,
                mul_add_bound_ms=ma_ms, max_abs_err=err,
                oneshot_inputs=oneshot_inputs)


# --------------------------------------------------------------------------
# stochastic rounding: E, B, K8 and K9 under --rounding sr
# --------------------------------------------------------------------------

E_SR_NAME = "qmatmul_fused(return_quantized, rounding=sr)"
B_SR_NAME = "qmatmul_bwd_pair(rounding=sr)"
K8_SR_NAME = "qmatmul_fused(collect_stats, rounding=sr)"
K9_SR_NAME = "qmatmul_bwd_pair(collect_stats, rounding=sr)"
G_SR_NAME = "qmatmul_fused(rounding=sr)"
G_SR_FOLD = "qmatmul_fused(rounding=sr) fold"   # a split call's fold kernel
K7_SR_NAME = "qmatmul_bwd_pair(dx_carry, rounding=sr)"
K10_SR_NAME = "flash_prefill(rounding=sr)"


def _sr_counters():
    """The SR launches of G (and its split calls' fold kernel), E, B,
    B's dx carry-in entry (K7), K8, K9 and K10, counted apart, as
    ``_counters``."""
    from repro_torch.kernels.attention import flash_prefill
    from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
    from repro_torch.kernels.fused import qmatmul_fused

    return {G_SR_NAME: (qmatmul_fused, "sr_launches"),
            G_SR_FOLD: (qmatmul_fused, "sr_fold_launches"),
            E_SR_NAME: (qmatmul_fused, "sr_emitq_launches"),
            B_SR_NAME: (qmatmul_bwd_pair, "sr_launches"),
            K7_SR_NAME: (qmatmul_bwd_pair, "sr_carry_launches"),
            K8_SR_NAME: (qmatmul_fused, "sr_stats_launches"),
            K9_SR_NAME: (qmatmul_bwd_pair, "sr_stats_launches"),
            K10_SR_NAME: (flash_prefill, "sr_launches")}


def _sr_kw(qc):
    """E's and B's keywords of a layer's QDotConfig under its SR plan: the
    FWD role seed for E, the BWD and GRAD ones for B (``sr_role_seed``)."""
    from repro_torch.kernels.ops import sr_role_seed

    ekw = dict(_e_kw(qc), rounding="sr",
               sr_seed=sr_role_seed(qc.sr_seed, "fwd"))
    bkw = dict(_b_kw(qc), rounding="sr",
               sr_seed_bwd=sr_role_seed(qc.sr_seed, "bwd"),
               sr_seed_grad=sr_role_seed(qc.sr_seed, "grad"))
    return ekw, bkw


def _sr_shape_checks(label, x, w, g, qc) -> float:
    """E, K8, B and K9 under SR on one layer shape's operands: each bitwise
    its plain version; K8's C (on the f32 operands and on E's codes)
    bitwise E's and K9's dx/dw bitwise B's; B's dx and dw bitwise the
    plain fused call on (g, Q(w)^T) and (Q(x)^T, g) at the role seeds;
    another seed changes E's C and B's dx and dw.  Returns the max |error|
    against the plain versions."""
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_reference,
        qmatmul_bwd_pair_stats_reference)
    from repro_torch.kernels.fused import (
        qmatmul_fused, qmatmul_fused_reference, qmatmul_fused_stats_reference)
    from repro_torch.quant.qtensor import unpack_block

    ekw, bkw = _sr_kw(qc)
    (_, m_f, _), (eb, mb, bc), (eg, mg, gc) = _roles(qc)
    e_f = ekw["e_acc"]
    y, xq, wq = qmatmul_fused(x, w, return_quantized=True, **ekw)
    ry, rxq, rwq = qmatmul_fused_reference(x, w, return_quantized=True, **ekw)
    err = compare(f"E sr {label}", y, ry, m_f, e_f, bitwise=True)
    check(torch.equal(xq, rxq) and torch.equal(wq, rwq),
          f"E sr {label}: codes differ from pack_block")
    for what, a, b, kw in (("f32", x, w, ekw),
                           ("codes", xq, wq, _k8_codes_kw(ekw))):
        c, row = qmatmul_fused(a, b, collect_stats=True, **kw)
        pc, prow = qmatmul_fused_stats_reference(a, b, **kw)
        compare(f"K8 sr {label} {what} vs E", c, y, m_f, e_f, bitwise=True,
                quiet=True)
        err = max(err, compare(f"K8 sr {label} {what}", c, pc, m_f, e_f,
                               bitwise=True),
                  check_stats(f"K8 sr {label} {what}", row, prow))
    dx, dw = qmatmul_bwd_pair(g, xq, wq, **bkw)
    pdx, pdw = qmatmul_bwd_pair_reference(g, xq, wq, **bkw)
    err = max(err, compare(f"B sr dx {label}", dx, pdx, mb, eb, bitwise=True),
              compare(f"B sr dw {label}", dw, pdw, mg, eg, bitwise=True))
    sdx, sdw, rows = qmatmul_bwd_pair(g, xq, wq, collect_stats=True, **bkw)
    _, _, prows = qmatmul_bwd_pair_stats_reference(g, xq, wq, **bkw)
    check(torch.equal(sdx, dx) and torch.equal(sdw, dw),
          f"K9 sr {label}: dx/dw differ from B's")
    err = max(err, check_stats(f"K9 sr {label}", rows, prows))
    f = qc.repr_fmt
    x32, w32 = unpack_block(xq, f.e, f.m), unpack_block(wq, f.e, f.m)
    fdx = qmatmul_fused_reference(g, w32.T, repr_fmt=f, e_acc=eb, m_acc=mb,
                                  block_k=bc, rounding="sr",
                                  sr_seed=bkw["sr_seed_bwd"])
    fdw = qmatmul_fused_reference(x32.T, g, repr_fmt=f, e_acc=eg, m_acc=mg,
                                  block_k=gc, rounding="sr",
                                  sr_seed=bkw["sr_seed_grad"])
    compare(f"B sr dx {label} vs the fused call on (g, Q(w)^T)", dx, fdx, mb,
            eb, bitwise=True)
    compare(f"B sr dw {label} vs the fused call on (Q(x)^T, g)", dw, fdw, mg,
            eg, bitwise=True)
    oy = qmatmul_fused(x, w, return_quantized=True,
                       **dict(ekw, sr_seed=ekw["sr_seed"] + 1))[0]
    odx, odw = qmatmul_bwd_pair(g, xq, wq, **dict(
        bkw, sr_seed_bwd=bkw["sr_seed_bwd"] + 1,
        sr_seed_grad=bkw["sr_seed_grad"] + 1))
    differ = [not torch.equal(a, b) for a, b in ((oy, y), (odx, dx),
                                                  (odw, dw))]
    print(f"  sr {label}: another seed changes E's C, B's dx, B's dw: "
          f"{differ}", flush=True)
    check(all(differ), f"sr {label}: another seed left an output unchanged")
    return err


def phase_sr_kernels(dev) -> dict:
    """E, B, K8 and K9 under SR at one layer's four distinct GEMM shapes of
    the train cell (T = 512, the plan's chunk 64, the SR plan's role seeds
    of ``--sr-seed 7``), on random and on lattice operands
    (``_sr_shape_checks``); then each SR kernel timed by CUDA events beside
    its RNE run on the same inputs (the ratio and each one's share of the
    f32-FMA bound), per shape and over one layer's seven calls, with the
    plain version's time over those seven.  The bound is the RNE kernel's
    (SR adds integer work only) and SR has no library call."""
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_reference,
        qmatmul_bwd_pair_stats_reference)
    from repro_torch.kernels.fused import (
        qmatmul_fused, qmatmul_fused_reference, qmatmul_fused_stats_reference)
    from repro_torch.models.api import dense_gemm_shapes

    cfg = _train_cfg(rounding="sr")
    layer = dense_gemm_shapes(cfg, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH)[1:]
    t = layer[0][1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    print(f"[sr] kernels: E, B, K8 and K9 under SR at T={t}, seed "
          f"{TRAIN_SR_SEED} (role seeds), vs plain and vs each other",
          flush=True)
    tensors, err = {}, 0.0
    for tag, _, k, n, qc in layer:
        if (k, n) in tensors:
            continue
        x = torch.randn((t, k), generator=gen, device=dev)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        g = torch.randn((t, n), generator=gen, device=dev) / math.sqrt(n)
        err = max(err, _sr_shape_checks(f"{tag} K={k} N={n} random", x, w,
                                        g, qc))
        err = max(err, _sr_shape_checks(
            f"{tag} K={k} N={n} lattice", _lattice(gen, (t, k), dev),
            _lattice(gen, (k, n), dev).to(torch.bfloat16),
            _lattice(gen, (t, n), dev), qc))
        ekw, _ = _sr_kw(qc)
        _, xq, wq = qmatmul_fused(x, w, return_quantized=True, **ekw)
        tensors[(k, n)] = (x, w, g, xq, wq)
    print("[sr] kernel times, SR beside RNE on the same inputs (ms; share "
          "of the f32-FMA bound)", flush=True)
    for (k, n), (x, w, g, xq, wq) in tensors.items():
        qc = next(q for _, _, kk, nn, q in layer if (kk, nn) == (k, n))
        ekw, bkw = _sr_kw(qc)
        rne_e = dict(ekw, rounding="rne")
        rne_b = dict(bkw, rounding="rne")
        fb = 4 * t * k * n / F32_FLOPS * 1e3
        cols = []
        for name, sr_fn, rne_fn, reps, bound in (
                ("E", lambda: qmatmul_fused(x, w, return_quantized=True,
                                            **ekw),
                 lambda: qmatmul_fused(x, w, return_quantized=True, **rne_e),
                 10, fb / 2),
                ("B", lambda: qmatmul_bwd_pair(g, xq, wq, **bkw),
                 lambda: qmatmul_bwd_pair(g, xq, wq, **rne_b), 5, fb),
                ("K8", lambda: qmatmul_fused(xq, wq, collect_stats=True,
                                             **_k8_codes_kw(ekw)),
                 lambda: qmatmul_fused(xq, wq, collect_stats=True,
                                       **_k8_codes_kw(rne_e)), 10, fb / 2),
                ("K9", lambda: qmatmul_bwd_pair(g, xq, wq,
                                                collect_stats=True, **bkw),
                 lambda: qmatmul_bwd_pair(g, xq, wq, collect_stats=True,
                                          **rne_b), 5, fb)):
            rne_ms = cuda_time(rne_fn, reps=reps)
            sr_ms = cuda_time(sr_fn, reps=reps)
            cols.append(f"{name} {sr_ms:.4f} vs {rne_ms:.4f} "
                        f"({sr_ms / rne_ms:.3f}x; {bound / sr_ms:.3f} vs "
                        f"{bound / rne_ms:.3f})")
        print(f"  sr time K={k} N={n}: " + ", ".join(cols), flush=True)

    # one layer's seven calls of each kernel, in layer order
    calls = [(tensors[(k, n)], qc) for _, _, k, n, qc in layer]
    costs = {"E": [_e_cost(t, k, n) for _, _, k, n, _ in layer],
             "B": [_b_cost(t, k, n) for _, _, k, n, _ in layer],
             "K8": [_k8_cost(t, k, n, True) for _, _, k, n, _ in layer]}
    costs["K9"] = costs["B"]

    def run(name, rounding, plain=False):
        for (x, w, g, xq, wq), qc in calls:
            ekw, bkw = _sr_kw(qc)
            ekw, bkw = dict(ekw, rounding=rounding), dict(bkw,
                                                          rounding=rounding)
            if name == "E":
                (qmatmul_fused_reference if plain else qmatmul_fused)(
                    x, w, return_quantized=True, **ekw)
            elif name == "B":
                (qmatmul_bwd_pair_reference if plain else qmatmul_bwd_pair)(
                    g, xq, wq, **bkw)
            elif name == "K8":
                kw = _k8_codes_kw(ekw)
                if plain:
                    qmatmul_fused_stats_reference(xq, wq, **kw)
                else:
                    qmatmul_fused(xq, wq, collect_stats=True, **kw)
            elif plain:
                qmatmul_bwd_pair_stats_reference(g, xq, wq, **bkw)
            else:
                qmatmul_bwd_pair(g, xq, wq, collect_stats=True, **bkw)

    out = {}
    for name in ("E", "B", "K8", "K9"):
        rne_ms = cuda_time(lambda: run(name, "rne"), reps=3, warmup=1)
        ms = cuda_time(lambda: run(name, "sr"), reps=3, warmup=1)
        plain = cuda_time(lambda: run(name, "sr", plain=True), reps=1,
                          warmup=0)
        b_ms, b_by = seq_bound(costs[name])
        f_ms = fma_bound(costs[name])
        print(f"[sr] {name} one layer's {len(calls)} calls (T={t}): SR "
              f"{ms:.3f} ms, RNE {rne_ms:.3f} ms ({ms / rne_ms:.3f}x), plain "
              f"(SR) {plain:.1f} ms, bound {b_ms:.4f} ms ({b_by}); f32-FMA "
              f"bound {f_ms:.3f} ms, SR at {f_ms / ms:.4f} of it, RNE at "
              f"{f_ms / rne_ms:.4f}", flush=True)
        out[name] = dict(ms=ms, rne_ms=rne_ms, sr_over_rne=ms / rne_ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         fma_bound_ms=f_ms, library_ms=None, max_abs_err=err)
    return out


KNEE_K, KNEE_CHUNK, KNEE_STEPS, KNEE_LR = 8192, 32, 30, 2e-4


def phase_sr_below_knee(dev) -> dict:
    """``tests/test_below_knee.py``'s regression at its own size through
    the port's ``qdot`` on the card: a linear model x[8, 8192] @ w[8192, 8]
    trained 30 steps at lr 2e-4 (a seed a step under SR) with a (1,6,m)
    carry every 32 products at ``m_acc = knee - 2``, under RNE and SR,
    beside the wide (1,8,23) carry.  Checks the JAX gate: RNE stalls (its
    final loss above 5x the wide one) while SR reaches the wide loss
    (below 2x it, and below a quarter of RNE's).  Runs E and B under SR."""
    from repro_torch.core.policy import GEMMPrecision
    from repro_torch.core.precision import min_m_acc
    from repro_torch.kernels.ops import QDotConfig, qdot
    from repro_torch.quant.formats import FP8_152

    knee = min_m_acc(KNEE_K, 5, chunked=True, chunk=KNEE_CHUNK)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((8, KNEE_K)).astype(
        np.float32)).to(dev)
    w_true = torch.from_numpy((rng.standard_normal((KNEE_K, 8))
                               / np.sqrt(KNEE_K)).astype(np.float32)).to(dev)
    y = x @ w_true

    def cfg(rounding, m_acc, e_acc=6):
        return QDotConfig(fwd=GEMMPrecision(m_acc=m_acc, e_acc=e_acc,
                                            chunk=KNEE_CHUNK),
                          repr_fmt=FP8_152, rounding=rounding)

    def train(c, sr):
        w = torch.zeros((KNEE_K, 8), device=dev)
        for s in range(KNEE_STEPS):
            wl = w.clone().requires_grad_()
            pred = qdot(x, wl, c, sr_seed=s) if sr else qdot(x, wl, c)
            torch.mean((pred - y) ** 2).backward()
            w = w - KNEE_LR * wl.grad
        with torch.no_grad():
            pred = qdot(x, w, c, sr_seed=10_000) if sr else qdot(x, w, c)
            return float(torch.mean((pred - y) ** 2))

    counters = _sr_counters()
    zero_counts(counters)
    t0 = time.perf_counter()
    wide = train(cfg("rne", 23, 8), False)
    rne = train(cfg("rne", knee - 2), False)
    sr = train(cfg("sr", knee - 2), True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    used = read_counts(counters)
    print(f"[sr] below-knee: K {KNEE_K}, chunk {KNEE_CHUNK}, 8 x 8, "
          f"{KNEE_STEPS} steps at lr {KNEE_LR}, m_acc {knee - 2} (knee "
          f"{knee}): final loss wide {wide:.6f}, RNE {rne:.6f} "
          f"({rne / wide:.2f}x wide), SR {sr:.6f} ({sr / wide:.3f}x wide, "
          f"{sr / rne:.3f}x RNE); {secs:.1f} s; SR launches {used}",
          flush=True)
    check(rne > 5 * wide, "below-knee: RNE did not stall above 5x wide")
    check(sr < 2 * wide, "below-knee: SR did not reach 2x the wide loss")
    check(sr < 0.25 * rne, "below-knee: SR not below a quarter of RNE")
    check(used[E_SR_NAME] > 0 and used[B_SR_NAME] > 0,
          "below-knee: E or B launched no SR carry")
    return dict(wide=wide, rne=rne, sr=sr, launches=used)


def phase_train_sr(dev, rne_step_ms: float, rne_tick_ms=None) -> dict:
    """The train cell under ``--rounding sr --sr-seed 7 --policy perturbed
    --pp -2`` (every quantized width 2 bits under the predicted plan) at
    full width and depth through the launcher's set-up: 6 steps of 8 x 64
    tokens with the eager telemetry tick every 2 steps (the probe's no-grad
    forward through G under SR, K8 under SR on the synthetic layer roles)
    and step 5 as the in-graph tagged step (K9 under SR).  The loss must
    fall; launches are checked each step (a step's E and B under SR, the
    lm_head's G and B under RNE) and each tick (G under SR on every layer
    GEMM, no E); prints the steady step against the RNE run's, and each
    tick's time against the RNE ticks' (``rne_tick_ms``)."""
    from repro_torch.launch.train import build, build_telemetry
    from repro_torch.models.api import dense_gemm_shapes
    from repro_torch.models.lm import layer_forwards
    from repro_torch.obs.ingraph import InGraphTelemetry
    from repro_torch.train.loop import make_train_step, run_telemetry_tick

    args = _train_args("--telemetry-cadence", str(TELEMETRY_CADENCE),
                       "--rounding", "sr", "--sr-seed", str(TRAIN_SR_SEED),
                       "--policy", "perturbed", "--pp", "-2")
    TELEMETRY_LOG.unlink(missing_ok=True)
    torch.cuda.reset_peak_memory_stats()
    model, tc, state, data, _ = build(args)
    controller, _ = build_telemetry(args, tc)
    ingraph = InGraphTelemetry(controller, tc, seq_len=args.seq_len,
                               global_batch=args.global_batch)
    cfg = model.cfg
    n = (len(dense_gemm_shapes(cfg, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH)) - 1) * cfg.n_layers
    counters = {**_train_counters(), **_sr_counters()}
    zero = {k: 0 for k in counters}
    fwd = layer_forwards(cfg)
    want_step = dict(zero, **{E_SR_NAME: fwd * n, B_SR_NAME: n,
                              "qmatmul_fused": 1, "qmatmul_bwd_pair": 1})
    # the probe's no-grad forward (G under SR on the layer GEMMs, G under
    # RNE on the lm_head), K8 under SR on the 7 layer tags' 3 roles and
    # under RNE on the lm_head's 3
    want_tick = dict(zero, **{G_SR_NAME: n, "qmatmul_fused": 1,
                              K8_SR_NAME: 21, K8_NAME: 3})
    want_tagged = dict(zero, **{E_SR_NAME: fwd * n, "qmatmul_fused": 1,
                                K9_SR_NAME: n, K9_NAME: 1, K8_SR_NAME: n,
                                K8_NAME: 1})
    print(f"[train] sr: {cfg.name} {cfg.n_layers} layers, --rounding sr "
          f"--sr-seed {TRAIN_SR_SEED} --policy perturbed --pp -2, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} steps, eager tick "
          f"every {TELEMETRY_CADENCE} steps, step 5 in-graph", flush=True)
    losses, step_ms, tick_ms, total = [], [], [], dict(zero)
    step_fn = make_train_step(model, tc)
    for step in range(TRAIN_STEPS):
        batch = next(data)
        tagged = step + 1 == 5
        if tagged:
            ingraph.stats_step(model)   # built outside the clock
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if tagged:
            state, m, events, new_model = ingraph.tick(model, state, batch,
                                                       step=step + 1)
        else:
            state, m = step_fn(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        per = read_counts(counters)
        losses.append(loss)
        if not tagged:
            step_ms.append(dt)
        want = want_tagged if tagged else want_step
        print(f"[train] sr step {step + 1}{' (in-graph)' if tagged else ''}"
              f": loss {loss:.5f}, {dt:.1f} ms, launches "
              f"{ {k: v for k, v in per.items() if v} }", flush=True)
        check(per == want, f"sr step {step + 1}: launches {per} != {want}")
        for k, v in per.items():
            total[k] += v
        if tagged and new_model is not None:
            model = new_model
            step_fn = make_train_step(model, tc)
        if controller.due(step + 1):
            gen = torch.Generator(device=dev)
            gen.manual_seed(args.seed * 1000003 + step + 1)
            zero_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events, new_model = run_telemetry_tick(
                controller, model, state, batch, step=step + 1, gen=gen,
                seq_len=args.seq_len, global_batch=args.global_batch)
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            per = read_counts(counters)
            acts = [(e["gemm"], e["role"], e["event"], e["m_acc"],
                     e["rounding"]) for e in events if e["event"] != "ok"]
            rne = ("" if not rne_tick_ms else
                   f" (the RNE run's ticks {min(rne_tick_ms):.1f}-"
                   f"{max(rne_tick_ms):.1f} ms)")
            print(f"[train] sr telemetry tick at step {step + 1}: "
                  f"{tick_ms[-1]:.1f} ms{rne}, "
                  f"{len(events)} verdicts, actions {acts}, launches "
                  f"{ {k: v for k, v in per.items() if v} }", flush=True)
            check(per == want_tick, f"sr tick launches {per} != {want_tick}")
            check({e["rounding"] for e in events} == {"rne", "sr"},
                  "sr tick: the probes' rounding is not the plan's")
            for k, v in per.items():
                total[k] += v
            if new_model is not None:
                model = new_model
                step_fn = make_train_step(model, tc)
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"sr: loss did not fall: {losses}")
    steady = min(step_ms[1:])
    print(f"[train] sr: {TRAIN_STEPS} steps, loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; steady step {steady:.1f} ms against the RNE "
          f"run's {rne_step_ms:.1f} ms ({steady / rne_step_ms:.3f}x); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"schedule {controller.to_meta()}; SR launches "
          f"{ {k: total[k] for k in _sr_counters()} }", flush=True)
    for k in (G_SR_NAME, E_SR_NAME, B_SR_NAME, K8_SR_NAME, K9_SR_NAME):
        check(total[k] > 0, f"sr: {k} was not launched by the trainer")
    del state
    return dict(launches=total, losses=losses, step_ms=steady,
                tick_ms=tick_ms)


# --------------------------------------------------------------------------
# stochastic rounding: G, K7 and K10 under --rounding sr; the oracle's rows
# --------------------------------------------------------------------------

G_SR_MS = (1, MAX_BATCH, 32, 64)        # M of G's decode route under SR
G_SR_TILE_M = TRAIN_BATCH * TRAIN_SEQ   # the eager tick's forward: the tile
# B's dx carry-in entry (K7) under SR is chained over the lm_head's JAX
# split count at mlp gate/up (N = 8960): the JAX package splits no layer GEMM
# at its default 8 MiB VMEM budget (one segment would be the unsplit call)
K7_SR_SEGMENTS = HEAD_SEGMENTS


def _g_sr_schedules(m, n, k, chunk):
    """{label: schedule} of G's decode route at one shape under every split
    it can take there: the one ``sm90.decode_schedule`` picks, and the
    other of unsplit and split at the same slots."""
    from dataclasses import replace

    from repro_torch.kernels import sm90

    dec = sm90.decode_schedule(m, n, k, chunk, 1)
    if dec is None:
        return {}
    slices = -(-(-(-k // chunk)) // dec.slots)   # a split: a slot a chunk
    other = replace(dec, slices=1 if dec.slices > 1 else slices,
                    ws_floats=sm90.decode_ws(
                        m, n, k, chunk, 1 if dec.slices > 1 else slices))
    # where a round holds every chunk a split has one slice: no other split
    return {f"decode (slots {s.slots}, slices {s.slices})": s
            for s in (dec, other)}


def phase_sr_g(dev) -> dict:
    """``[sr] G``: G under SR at one layer's four distinct GEMM shapes of
    the train cell (the plan's chunk 64, the SR plan's FWD role seed), on
    random and on lattice operands: the decode route at M = 1, 8, 32 and
    64 under each split it can take (``_g_sr_schedules``, through
    ``qmatmul_fused_with``) and the tile route at M = 512, each bitwise the
    plain version and E's C under the same seed; ``qmatmul_fused`` takes
    ``sm90.g_schedule``'s route (marked ``*``).  Each case timed by CUDA
    events beside RNE on the same inputs; then one layer's seven SR calls
    at M = 512 (the eager tick's forward) against RNE, the plain version
    and the bound."""
    from repro_torch.kernels import sm90
    from repro_torch.kernels.fused import (qmatmul_fused,
                                           qmatmul_fused_reference,
                                           qmatmul_fused_with)
    from repro_torch.models.api import dense_gemm_shapes

    cfg = _train_cfg(rounding="sr")
    layer = dense_gemm_shapes(cfg, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH)[1:]
    gen = torch.Generator(device=dev).manual_seed(SEED + 81)
    print(f"[sr] G: decode route at M {list(G_SR_MS)} (every split), tile "
          f"route at M {G_SR_TILE_M}, seed {TRAIN_SR_SEED} (FWD role seed), "
          f"vs plain and E; ms SR vs RNE by CUDA events", flush=True)
    err, seen, weights = 0.0, set(), {}
    for tag, _, k, n, qc in layer:
        if (k, n) in seen:
            continue
        seen.add((k, n))
        ekw, _ = _sr_kw(qc)
        rne = dict(ekw, rounding="rne")
        chunk = ekw["block_k"]
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        wl = _lattice(gen, (k, n), dev).to(torch.bfloat16)
        weights[(k, n)] = w
        for m in G_SR_MS + (G_SR_TILE_M,):
            routed = sm90.g_schedule(m, n, k, chunk, 0, 1)
            tile = sm90.gemm_schedule(m, n, k, chunk, 0, 1, stats=False)
            scheds = (_g_sr_schedules(m, n, k, chunk) if m in G_SR_MS else
                      {f"tile (groups {tile.groups})": tile})
            times = []
            for label, bw in (("random", w), ("lattice", wl)):
                a = (torch.randn((m, k), generator=gen, device=dev)
                     if label == "random" else _lattice(gen, (m, k), dev))
                want = qmatmul_fused_reference(a, bw, **ekw)
                e = qmatmul_fused(a, bw, return_quantized=True, **ekw)[0]
                err = max(err, compare(
                    f"G sr {tag} K={k} N={n} M={m} {label} routed",
                    qmatmul_fused(a, bw, **ekw), want, ekw["m_acc"],
                    ekw["e_acc"], bitwise=True, quiet=True))
                check(torch.equal(e, want), f"G sr {tag} M={m}: E's C differs")
                for sl, sched in scheds.items():
                    got = qmatmul_fused_with(a, bw, sched, **ekw)
                    err = max(err, compare(
                        f"G sr {tag} K={k} N={n} M={m} {sl} {label}", got,
                        want, ekw["m_acc"], ekw["e_acc"], bitwise=True,
                        quiet=True))
                    if label == "random":
                        sr_ms = cuda_time(lambda: qmatmul_fused_with(
                            a, bw, sched, **ekw), reps=20)
                        rne_ms = cuda_time(lambda: qmatmul_fused_with(
                            a, bw, sched, **rne), reps=20)
                        mark = "*" if sched == routed else ""
                        times.append(f"{sl}{mark} {sr_ms:.4f} vs {rne_ms:.4f}"
                                     f" ({sr_ms / rne_ms:.3f}x)")
            print(f"  sr G {tag} K={k} N={n} M={m}: bitwise plain and E "
                  f"(random, lattice); " + ", ".join(times), flush=True)

    # one layer's seven SR calls at the eager tick's M, in layer order
    t = G_SR_TILE_M
    xs = {k: torch.randn((t, k), generator=gen, device=dev)
          for k in {k for _, _, k, _, _ in layer}}
    calls = [(xs[k], weights[(k, n)], _sr_kw(qc)[0])
             for _, _, k, n, qc in layer]

    def run(rounding, fn=qmatmul_fused):
        for a, b, kw in calls:
            fn(a, b, **dict(kw, rounding=rounding))

    rne_ms = cuda_time(lambda: run("rne"), reps=5)
    ms = cuda_time(lambda: run("sr"), reps=5)
    plain = cuda_time(lambda: run("sr", qmatmul_fused_reference), reps=1,
                      warmup=0)
    # x f32 and w bf16 read, C f32 written; (1,5,2) operands at the FP8 rate
    costs = [(t * k * 4 + k * n * 2 + t * n * 4, 2 * t * k * n, FP8_FLOPS)
             for _, _, k, n, _ in layer]
    b_ms, b_by = seq_bound(costs)
    f_ms = fma_bound(costs)
    print(f"[sr] G one layer's {len(calls)} calls at M={t} (the tile route): "
          f"SR {ms:.3f} ms, RNE {rne_ms:.3f} ms ({ms / rne_ms:.3f}x), plain "
          f"(SR) {plain:.1f} ms, bound {b_ms:.4f} ms ({b_by}); f32-FMA bound "
          f"{f_ms:.3f} ms, SR at {f_ms / ms:.4f} of it, RNE at "
          f"{f_ms / rne_ms:.4f}", flush=True)
    return dict(ms=ms, rne_ms=rne_ms, sr_over_rne=ms / rne_ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, fma_bound_ms=f_ms,
                library_ms=None, max_abs_err=err)


def phase_sr_k7(dev) -> dict:
    """``[sr] K7``: B's dx carry-in entry under SR at the train cell's
    widest layer GEMM (mlp gate/up, T = 512, K = 1536, N = 8960, E's codes
    at the SR plan's role seeds), chained over ``K7_SR_SEGMENTS`` N
    segments at their place in N: dx and dw bitwise the unsplit SR B and
    the chained plain version, on random and lattice operands, one SR
    carry launch a segment; the chain timed beside the chained RNE call."""
    from repro_torch.kernels.bwd_pair import (qmatmul_bwd_pair,
                                              qmatmul_bwd_pair_nsplit)
    from repro_torch.kernels.fused import qmatmul_fused
    from repro_torch.models.api import dense_gemm_shapes

    cfg = _train_cfg(rounding="sr")
    tag, t, k, n, qc = max(dense_gemm_shapes(
        cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)[1:],
        key=lambda s: s[3])
    ekw, bkw = _sr_kw(qc)
    (eb, mb), (eg, mg) = bkw["bwd_acc"], bkw["grad_acc"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 91)
    counters = _sr_counters()
    print(f"[sr] K7: {tag} T={t} K={k} N={n} in {K7_SR_SEGMENTS} chained "
          f"N segments under SR (role seeds of --sr-seed {TRAIN_SR_SEED})",
          flush=True)
    err, launches = 0.0, 0
    for label in ("random", "lattice"):
        mk = ((lambda s_: _lattice(gen, s_, dev)) if label == "lattice"
              else (lambda s_: torch.randn(s_, generator=gen, device=dev)))
        x = mk((t, k))
        w = (mk((k, n)) / math.sqrt(k)).to(torch.bfloat16)
        g = mk((t, n)) / (1 if label == "lattice" else math.sqrt(n))
        _, xq, wq = qmatmul_fused(x, w, return_quantized=True, **ekw)
        full = qmatmul_bwd_pair(g, xq, wq, **bkw)
        zero_counts(counters)
        chained = qmatmul_bwd_pair_nsplit(g, xq, wq, n_split=K7_SR_SEGMENTS,
                                          **bkw)
        used = read_counts(counters)
        pdx, pdw = _nsplit_plain(g, xq, wq, bkw, K7_SR_SEGMENTS)
        for what, a, b, m_, e_ in (("dx", chained[0], full[0], mb, eb),
                                   ("dw", chained[1], full[1], mg, eg)):
            compare(f"K7 sr {what} {label} chained vs unsplit B", a, b, m_,
                    e_, bitwise=True)
        err = max(err, compare(f"K7 sr dx {label} chained vs plain",
                               chained[0], pdx, mb, eb, bitwise=True),
                  compare(f"K7 sr dw {label} chained vs plain", chained[1],
                          pdw, mg, eg, bitwise=True))
        check(used[K7_SR_NAME] == K7_SR_SEGMENTS and used[B_SR_NAME] == 0,
              f"K7 sr: launches {used} (want every segment on the SR carry "
              f"entry)")
        launches += used[K7_SR_NAME]
        del full, chained, pdx, pdw
    rne = dict(bkw, rounding="rne")
    chain = lambda kw: qmatmul_bwd_pair_nsplit(  # noqa: E731
        g, xq, wq, n_split=K7_SR_SEGMENTS, **kw)
    rne_ms = cuda_time(lambda: chain(rne), reps=3, warmup=1)
    ms = cuda_time(lambda: chain(bkw), reps=3, warmup=1)
    plain = cuda_time(lambda: _nsplit_plain(g, xq, wq, bkw, K7_SR_SEGMENTS),
                      reps=1, warmup=0)
    b_ms, b_by = bound_ms(*_b_cost(t, k, n))
    f_ms = fma_bound([_b_cost(t, k, n)])
    print(f"[sr] K7 chain of {K7_SR_SEGMENTS} at T={t} K={k} N={n}: SR "
          f"{ms:.3f} ms, RNE {rne_ms:.3f} ms ({ms / rne_ms:.3f}x), plain (SR) "
          f"{plain:.1f} ms, bound {b_ms:.4f} ms ({b_by}); f32-FMA bound "
          f"{f_ms:.3f} ms, SR at {f_ms / ms:.4f} of it, RNE at "
          f"{f_ms / rne_ms:.4f}", flush=True)
    return dict(ms=ms, rne_ms=rne_ms, sr_over_rne=ms / rne_ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, fma_bound_ms=f_ms,
                library_ms=None, max_abs_err=err, phase_launches=launches)


def phase_sr_prefill(dev, oneshot_inputs) -> dict:
    """``[sr] K10``: the dense-prefill phase's K10 calls under SR (seed
    ``TRAIN_SR_SEED``): the 8 serve prompts' one-shot calls at chunk 16
    (layer 0's q, k and v), each bitwise its plain version, then walked in
    ``SLAB``-token query slabs, the history's carry out and the slab's KV
    in, bitwise the one-shot rows; a lattice prompt of 384 tokens bitwise
    its plain version; another seed changes every output.  The 8 one-shot
    calls timed by CUDA-graph replay beside RNE (as the dense-prefill
    phase times K10), eagerly, and through the plain version."""
    from repro_torch.kernels import attention as A

    sr = dict(rounding="sr", sr_seed=TRAIN_SR_SEED)
    h, kv = oneshot_inputs[0][0].shape[1], oneshot_inputs[0][1].shape[1]
    dh = oneshot_inputs[0][0].shape[2]
    print(f"[sr] K10: the {len(oneshot_inputs)} serve prompts' one-shot "
          f"calls (H={h} KV={kv} dh={dh}) under SR, seed {TRAIN_SR_SEED}, "
          f"and in {SLAB}-token slabs through the carry", flush=True)
    A.flash_prefill.sr_launches = 0
    err, resumed, differ = 0.0, 0, 0
    for q, k, v, kw in oneshot_inputs:
        s = q.shape[0]
        got = A.flash_prefill(q, k, v, **kw, **sr)
        err = max(err, _attn_check(
            f"K10 sr one-shot S={s} chunk {kw['chunk']} acc {kw['acc']}",
            got, A.flash_prefill_reference(q, k, v, **kw, **sr), kw["acc"],
            bitwise=True))
        slabs = []
        for a in range(0, s, SLAB):
            b = min(a + SLAB, s)
            c = None if a == 0 else A.flash_prefill(
                q[a:b], k[:a], v[:a], return_carry=True,
                **dict(kw, q_offset=a), **sr)
            slabs.append(A.flash_prefill(q[a:b], k[a:b], v[a:b], carry=c,
                                         **dict(kw, q_offset=a, kv_offset=a),
                                         **sr))
        resumed += bool(torch.equal(torch.cat(slabs), got))
        other = A.flash_prefill(q, k, v, **kw, rounding="sr",
                                sr_seed=TRAIN_SR_SEED + 1)
        differ += not torch.equal(other, got)
    print(f"  K10 sr: {resumed}/{len(oneshot_inputs)} prompts' {SLAB}-token "
          f"slabs through the carry bitwise the one-shot walk; another seed "
          f"changes {differ}/{len(oneshot_inputs)}", flush=True)
    check(resumed == len(oneshot_inputs), "K10 sr: a resumed walk differs")
    check(differ == len(oneshot_inputs), "K10 sr: another seed changed "
          "no output")
    gen = torch.Generator(device=dev).manual_seed(SEED + 101)
    q, k, v, kw = oneshot_inputs[-1]
    ql, kl, vl = (_lattice(gen, t.shape, dev) for t in (q, k, v))
    err = max(err, _attn_check(
        f"K10 sr S={q.shape[0]} lattice", A.flash_prefill(ql, kl, vl, **kw,
                                                          **sr),
        A.flash_prefill_reference(ql, kl, vl, **kw, **sr), kw["acc"],
        bitwise=True))
    launches = A.flash_prefill.sr_launches

    def run(fn, **extra):
        for q, k, v, kw in oneshot_inputs:
            fn(q, k, v, **kw, **extra)

    rne = lib_time(lambda: run(A.flash_prefill), reps=10)
    graph = lib_time(lambda: run(A.flash_prefill, **sr), reps=10)
    eager = cuda_time(lambda: run(A.flash_prefill, **sr), reps=10)
    plain = cuda_time(lambda: run(A.flash_prefill_reference, **sr), reps=1,
                      warmup=0)
    cost = [((q.numel() * 2 + k.numel() * 2) * 4,
             4 * h * dh * q.shape[0] * (q.shape[0] + 1) // 2, F32_FLOPS)
            for q, k, _, _ in oneshot_inputs]
    b_ms, b_by = seq_bound(cost)
    print(f"[sr] K10 the serve prompts' one-shot prefill under SR "
          f"({len(cost)} launches): graph replay {lib_str(graph)}, RNE "
          f"{lib_str(rne)} ({graph[0] / rne[0]:.3f}x), eager {eager:.4f} ms, "
          f"plain (SR) {plain:.1f} ms, bound {b_ms:.5f} ms ({b_by}), "
          f"{b_ms / graph[0]:.4f} of it", flush=True)
    return dict(ms=graph[0], graph_spread_ms=list(graph[1]),
                rne_ms=rne[0], sr_over_rne=graph[0] / rne[0], eager_ms=eager,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, max_abs_err=err, phase_launches=launches)


def phase_train_oracle_rows(dev) -> dict:
    """The oracle's stats rows: at the 2-layer full-width cut (batch 2 x
    seq 64) one tagged step under the oracle plan (every qdot through K2
    and K3, its three roles' rows from K8 replays on the f32 residuals and
    g) against the tagged fused step (FWD from K8 on E's codes, BWD and
    GRAD from K9) on the same weights and batch: the loss and every
    gradient leaf bitwise, the same 15 (field, role) windows, each row's
    counters and MAX_ABS bitwise and its sums within SUM_REL/SUM_ABS
    (``check_stats``); no K9, E or B in the oracle step."""
    from repro_torch.models.api import get_model
    from repro_torch.obs.ingraph import (InGraphCollector, collecting,
                                         tag_quant_plan)
    from repro_torch.train.loop import _grads, compute_copy
    from repro_torch.train.optimizer import tree_leaves

    counters = _oracle_counters()
    cfg = _train_cfg(n_layers=2, batch=2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 111)
    params = get_model(cfg).init_params(gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, TRAIN_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)

    def step(c):
        model = get_model(c)
        col = InGraphCollector()
        zero_counts(counters)
        with collecting(col):
            cc = compute_copy(params)
            loss, _ = model.loss_fn(cc, {"tokens": tokens}, c)
            loss.backward()
        return loss.detach(), _grads(cc, params), col.rows(), read_counts(
            counters)

    lf, gf, rf, used_f = step(tag_quant_plan(cfg))
    lo, go, ro, used_o = step(tag_quant_plan(oracle_plan(cfg)))
    same = sum(bool(torch.equal(a, b)) for a, b in zip(tree_leaves(gf),
                                                        tree_leaves(go)))
    print(f"[train] tagged oracle vs tagged fused step, 2 layers at full "
          f"width, batch 2 x seq {TRAIN_SEQ}: loss {float(lo):.6f} vs "
          f"{float(lf):.6f}; {same}/{len(tree_leaves(gf))} gradient leaves "
          f"bitwise; {len(ro)} vs {len(rf)} (field, role) windows; launches "
          f"oracle { {k: v for k, v in used_o.items() if v} }, fused "
          f"{ {k: v for k, v in used_f.items() if v} }", flush=True)
    check(torch.equal(lo, lf), "tagged oracle: the loss differs")
    check(same == len(tree_leaves(gf)), "tagged oracle: a gradient differs")
    check(sorted(ro) == sorted(rf) and len(ro) == 15,
          f"tagged oracle windows {sorted(ro)} != {sorted(rf)}")
    check(used_o[K8_NAME] > 0 and all(used_o[k] == 0 for k in (
        K9_NAME, E_NAME, "qmatmul_bwd_pair")), f"tagged oracle launches "
          f"{used_o}")
    err = 0.0
    for key in sorted(rf):
        err = max(err, check_stats(
            f"oracle row {key[0]}/{key[1]} vs the fused step's",
            torch.as_tensor(ro[key]), torch.as_tensor(rf[key])))
    del params, gf, go
    return dict(max_abs_err=err, launches=used_o)


# --------------------------------------------------------------------------
# the paper's analysis: the Monte Carlo of swamping, Table 1
# --------------------------------------------------------------------------

MC_ENSEMBLE = 2048
# tests/test_vrr_montecarlo.py's points: (m_acc, n, chunk, ensemble)
MC_HIGH = ((8, 1024), (10, 16384), (12, 65536), (14, 65536))
MC_KNEE = ((5, 1024), (6, 2048), (7, 4096), (9, 65536))
# Paper Table 1, (normal, chunked-64) mantissa bits, as
# benchmarks/table1_precisions.py holds the published table
TABLE1 = {
    "CIFAR-10 ResNet 32": {
        ("Conv 0", "FWD"): (6, 5), ("ResBlock 1", "FWD"): (6, 5),
        ("ResBlock 2", "FWD"): (7, 5), ("ResBlock 3", "FWD"): (7, 5),
        ("ResBlock 1", "BWD"): (6, 5), ("ResBlock 2", "BWD"): (7, 5),
        ("ResBlock 3", "BWD"): (8, 5),
        ("Conv 0", "GRAD"): (11, 8), ("ResBlock 1", "GRAD"): (11, 8),
        ("ResBlock 2", "GRAD"): (10, 6), ("ResBlock 3", "GRAD"): (9, 6),
    },
    "ImageNet ResNet 18": {
        ("Conv 0", "FWD"): (9, 6), ("ResBlock 1", "FWD"): (7, 5),
        ("ResBlock 2", "FWD"): (8, 5), ("ResBlock 3", "FWD"): (8, 5),
        ("ResBlock 4", "FWD"): (9, 6),
        ("ResBlock 1", "BWD"): (8, 6), ("ResBlock 2", "BWD"): (9, 6),
        ("ResBlock 3", "BWD"): (9, 6), ("ResBlock 4", "BWD"): (10, 6),
        ("Conv 0", "GRAD"): (15, 10), ("ResBlock 1", "GRAD"): (15, 9),
        ("ResBlock 2", "GRAD"): (12, 8), ("ResBlock 3", "GRAD"): (10, 6),
        ("ResBlock 4", "GRAD"): (9, 5),
    },
    "ImageNet AlexNet": {
        ("Conv 1", "FWD"): (7, 5), ("Conv 2", "FWD"): (9, 5),
        ("Conv 3", "FWD"): (9, 5), ("Conv 4", "FWD"): (8, 5),
        ("Conv 5", "FWD"): (8, 5), ("FC 1", "FWD"): (9, 6),
        ("FC 2", "FWD"): (8, 5),
        ("Conv 2", "BWD"): (8, 5), ("Conv 3", "BWD"): (8, 5),
        ("Conv 4", "BWD"): (10, 8), ("Conv 5", "BWD"): (8, 5),
        ("FC 1", "BWD"): (8, 5), ("FC 2", "BWD"): (8, 5),
        ("Conv 1", "GRAD"): (10, 7), ("Conv 2", "GRAD"): (9, 6),
        ("Conv 3", "GRAD"): (8, 6), ("Conv 4", "GRAD"): (6, 5),
        ("Conv 5", "GRAD"): (6, 5), ("FC 1", "GRAD"): (6, 5),
        ("FC 2", "GRAD"): (6, 5),
    },
}
# the JAX package's own count on it, pinned by tests/test_torch_analysis.py:
# (layer, role) entries equal to the published pair, single cells equal
TABLE1_EQUAL = (12, 43)


def _mc(dev, m_acc, n, *, chunk=0, ensemble=MC_ENSEMBLE):
    """(simulated VRR, card seconds) of one Monte Carlo point: an ensemble
    of N(0, 1) (1,5,5) product streams of length n accumulated at
    (1,6,m_acc) by ``swamped_variance``, over n."""
    from repro_torch.quant import FPFormat, swamped_variance

    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = float(swamped_variance(gen, n, FPFormat(6, m_acc), FPFormat(5, 5),
                               ensemble=ensemble, chunk=chunk, device=dev))
    return v / n, time.perf_counter() - t0


def phase_analysis(dev) -> dict:
    """The paper's analysis on the card.  The Monte Carlo of swamped
    accumulation (``quant.accumulate.swamped_variance``, ensemble 2048,
    (1,6,m_acc) accumulator, (1,5,5) products) at
    ``tests/test_vrr_montecarlo.py``'s points under its assertions: the
    high-VRR points within 0.08 of ``vrr``, the knee points where theory
    is at most the simulation + 0.08, deep swamping where both collapse,
    and chunk 64 against ``vrr_chunked`` (and above the plain sum).  Then
    Table 1: ``assign_network`` on the paper's three networks against
    the published table (the match count must be the JAX package's), and
    qwen2-1.5b's ``transformer_specs`` beside the m_acc of the train
    cell's plan."""
    from repro_torch.core import acc_lengths as AL
    from repro_torch.core.precision import assign_network
    from repro_torch.core.vrr import vrr, vrr_chunked

    t_start = time.perf_counter()
    print(f"[analysis] Monte Carlo of swamping on the card: ensemble "
          f"{MC_ENSEMBLE}, (1,6,m_acc) accumulator, (1,5,5) products "
          "(simulated VRR, theory, card seconds)", flush=True)
    points = []

    def point(kind, m_acc, n, th, ok, **kw):
        mc, secs = _mc(dev, m_acc, n, **kw)
        good = ok(mc, th)
        print(f"  {kind} (m_acc {m_acc}, n {n}"
              f"{', chunk ' + str(kw['chunk']) if kw.get('chunk') else ''}"
              f"{', ensemble ' + str(kw['ensemble']) if 'ensemble' in kw else ''}"
              f"): MC {mc:.5f}, theory {th:.5f}, {secs:.2f} s "
              f"{'ok' if good else 'MISS'}", flush=True)
        points.append(dict(kind=kind, m_acc=m_acc, n=n, mc=mc, theory=th,
                           seconds=secs, **kw))
        check(good, f"Monte Carlo point {kind} ({m_acc}, {n}) missed: MC "
              f"{mc} against theory {th}")
        return mc

    for m_acc, n in MC_HIGH:
        th = vrr(m_acc, 5, n)
        check(th > 0.99, f"({m_acc}, {n}) is not a high-VRR point")
        point("high-VRR", m_acc, n, th, lambda mc, th: abs(mc - th) <= 0.08)
    for m_acc, n in MC_KNEE:
        th = vrr(m_acc, 5, n)
        check(0.3 < th < 0.999, f"({m_acc}, {n}) is not inside the knee")
        point("knee", m_acc, n, th, lambda mc, th: th <= mc + 0.08)
    point("deep swamping", 4, 16384, vrr(4, 5, 16384),
          lambda mc, th: th < 0.45 and mc < 0.35, ensemble=1024)
    plain = point("plain at the chunk point", 6, 8192, vrr(6, 5, 8192),
                  lambda mc, th: True, ensemble=1024)
    point("chunk 64", 6, 8192, vrr_chunked(6, 5, 64, 8192 // 64),
          lambda mc, th: mc > plain and mc > 0.85 and abs(mc - th) <= 0.12,
          chunk=64, ensemble=1024)

    entries = cells = total = 0
    for net, fn in (("CIFAR-10 ResNet 32", AL.resnet32_cifar),
                    ("ImageNet ResNet 18", AL.resnet18_imagenet),
                    ("ImageNet AlexNet", AL.alexnet_imagenet)):
        a = assign_network(net, fn(), m_p=5)
        e = c = 0
        for (layer, role), pub in TABLE1[net].items():
            got = a.get(layer, role)
            e += got == pub
            c += (got[0] == pub[0]) + (got[1] == pub[1])
        print(f"[analysis] Table 1 {net}: {e}/{len(TABLE1[net])} (layer, "
              f"role) entries equal the published (normal, chunked) pair, "
              f"{c}/{2 * len(TABLE1[net])} cells", flush=True)
        entries, cells, total = entries + e, cells + c, total + len(TABLE1[net])
    print(f"[analysis] Table 1 total: {entries}/{total} entries, {cells}/"
          f"{2 * total} cells equal the published table (the JAX package: "
          f"{TABLE1_EQUAL[0]}, {TABLE1_EQUAL[1]})", flush=True)
    check((entries, cells) == TABLE1_EQUAL,
          "Table 1 match count differs from the JAX package's")

    cfg = _train_cfg()
    specs = AL.transformer_specs(
        d_model=cfg.d_model, d_ff=cfg.d_ff, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, vocab_size=cfg.vocab_size)
    a = assign_network("qwen2-1.5b", specs, m_p=5)
    print(f"[analysis] qwen2-1.5b transformer_specs at batch {TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ}, (normal, chunked-64) m_acc beside the train "
          "cell's plan:", flush=True)
    fields = {"attn.qkv": "attn_qkv", "attn.out": "attn_out",
              "mlp.up": "mlp_up", "mlp.down": "mlp_down", "lm_head": "lm_head"}
    for s_ in specs:
        q = getattr(cfg.quant, fields.get(s_.layer, ""), None)
        prec = None if q is None else getattr(q, s_.role.lower())
        plan_s = (f"plan m_acc {prec.m_acc} (chunk {prec.chunk})"
                  if prec is not None else "no dense GEMM of the plan")
        print(f"  {s_.layer} {s_.role} n={s_.n}: {a.get(s_.layer, s_.role)}; "
              f"{plan_s}", flush=True)
    secs = time.perf_counter() - t_start
    print(f"[analysis] phase {secs:.1f} s", flush=True)
    return dict(points=points, table1=(entries, cells, total), seconds=secs)


# --------------------------------------------------------------------------
# checkpoints and restarts
# --------------------------------------------------------------------------

CKPT_DIR = ROOT / "build" / "ckpt"      # gitignored; deleted afterwards
CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY, CKPT_CRASH = 2, 4, 2, 3


def _ckpt_argv(*extra) -> list[str]:
    """The train cell at CKPT_LAYERS layers, full width, under the plan
    perturbed by -4 bits with a telemetry tick every step, so the
    controller widens every layer GEMM twice in the 4 steps and its
    schedule (below the predicted plan's widths) is part of the state."""
    return _train_argv("--n-layers", str(CKPT_LAYERS), "--steps",
                       str(CKPT_STEPS), "--log-every", "1", "--policy",
                       "perturbed", "--pp", "-4", "--telemetry-cadence", "1",
                       *extra)


def _records(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _ckpt_counters():
    # the launcher serves on CUDA graphs: its P is the device-geometry entry
    return dict(_train_counters(), **_counters(),
                **{P_GEOM_NAME: _graph_counters()[P_GEOM_NAME]})


def phase_ckpt_start(dev) -> dict:
    """``[ckpt]``'s first half: CKPT_STEPS steps through the training
    launcher uninterrupted, then the supervised run started in a child
    process, which ``phase_ckpt`` waits for (the checks between the two
    run beside it: the child is mostly process starts and checkpoint
    I/O)."""
    import atexit
    import contextlib
    import io
    import shutil

    from repro_torch.launch import train as LT

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    counters = _ckpt_counters()
    plain = CKPT_DIR / "plain.jsonl"
    zero_counts(counters)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        LT.main(_ckpt_argv("--metrics-out", str(plain)))
    torch.cuda.synchronize()
    train_used = read_counts(counters)
    want = [(r["step"], r["loss"], r["grad_norm"]) for r in _records(plain)]
    print(f"[ckpt] uninterrupted: {CKPT_STEPS} steps at {CKPT_LAYERS} "
          f"layers, full width: losses {[w[1] for w in want]}, launches "
          f"{train_used}", flush=True)
    check(all(math.isfinite(w[1]) for w in want), "a loss is not finite")
    torch.cuda.empty_cache()        # room for the child processes
    check(all(train_used[k] > 0 for k in (E_NAME, "qmatmul_bwd_pair",
                                          "qmatmul_fused", K8_NAME)),
          "the uninterrupted run missed a kernel of the training path")
    run, resumed = CKPT_DIR / "run", CKPT_DIR / "resumed.jsonl"
    cmd = [sys.executable, "-m", "repro_torch.launch.supervisor",
           "--max-restarts", "2", "--backoff-s", "0.1", "--",
           sys.executable, "-m", "repro_torch.launch.train",
           *_ckpt_argv("--ckpt-dir", str(run), "--ckpt-every",
                       str(CKPT_EVERY), "--crash-at-step",
                       str(CKPT_CRASH), "--metrics-out", str(resumed),
                       "--telemetry-log", str(CKPT_DIR / "t.jsonl"))]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out, err = (open(CKPT_DIR / name, "w") for name in ("out.log",
                                                         "err.log"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True, env=env,
                            cwd=ROOT)
    # a check failing before phase_ckpt exits the script: the child goes too
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return dict(want=want, train_used=train_used, proc=proc, t0=t0,
                files=(out, err), run=run, resumed=resumed)


def phase_ckpt(dev, started: dict) -> dict:
    """Checkpoints and restarts on the card: qwen2-1.5b at full width, the
    depth cut to CKPT_LAYERS layers (at full depth a checkpoint holds about
    18.5 GB of f32 masters and moments).  CKPT_STEPS steps through the
    training launcher uninterrupted, then the same steps under the restart
    supervisor with ``--crash-at-step 3 --ckpt-every 2``: a checkpoint
    before the crash, the restart resuming from it, one at the end; every
    loss after the resume bitwise the uninterrupted run's.  Then the last
    checkpoint served through ``launch/serve.py --ckpt-dir``: one request,
    under the recorded precision schedule.  Prints the checkpoint's bytes
    on disk and its save and restore ms; deletes the checkpoints.  The
    uninterrupted steps and the supervised child were started by
    ``phase_ckpt_start`` (``started``); this waits for the child."""
    import contextlib
    import io
    import shutil

    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT

    counters = _ckpt_counters()
    want, run, resumed = (started[k] for k in ("want", "run", "resumed"))
    try:
        proc = started["proc"]
        rc = proc.wait(timeout=600)
        secs = time.perf_counter() - started["t0"]
        for f in started["files"]:
            f.close()
        log = (CKPT_DIR / "out.log").read_text()
        check(rc == 0, f"supervised run exit {rc}: {log[-2000:]} "
              f"{(CKPT_DIR / 'err.log').read_text()[-2000:]}")
        for want_s in (f"FAULT INJECTION: dying at step {CKPT_CRASH}",
                       "restart 1/2", f"resumed from step {CKPT_EVERY}"):
            check(want_s in log, f"supervised run: no {want_s!r} in its log")
        saves = [json.loads(line)["checkpoint"] for line in log.splitlines()
                 if line.startswith('{"checkpoint"')]
        restore_ms = float(re.search(r"restored in ([0-9.]+) ms", log)[1])
        got = [(r["step"], r["loss"], r["grad_norm"])
               for r in _records(resumed)]
        check([g[0] for g in got] == [1, 2, 3, 3, 4],
              f"supervised run logged steps {[g[0] for g in got]}")
        after = got[CKPT_CRASH:]
        same = after == want[CKPT_EVERY:] and got[:CKPT_CRASH] == want[:CKPT_CRASH]
        print(f"[ckpt] supervised (--crash-at-step {CKPT_CRASH}, "
              f"--ckpt-every {CKPT_EVERY}; beside the phases after "
              f"phase_ckpt_start): {secs:.1f} s, one restart; "
              f"losses after the resume {[a[1] for a in after]} "
              f"{'bitwise' if same else 'DIFFERENT from'} the uninterrupted "
              f"run's; schedule restored at the resume: "
              f"{'restored precision schedule' in log}", flush=True)
        check(same, "a loss after the resume differs from the uninterrupted "
              "run's")
        for sv in saves:
            print(f"[ckpt] checkpoint step {sv['step']}: {sv['bytes']} bytes "
                  f"on disk ({sv['bytes'] / 2 ** 30:.3f} GiB), save "
                  f"{sv['save_ms']} ms", flush=True)
        print(f"[ckpt] restore of step {CKPT_EVERY}: {restore_ms} ms "
              "(read, then copied to the card)", flush=True)
        check([sv["step"] for sv in saves] == [CKPT_EVERY, CKPT_STEPS],
              f"checkpoint writes {[sv['step'] for sv in saves]}")

        last = json.loads((run / f"step_{CKPT_STEPS:08d}" /
                           "meta.json").read_text())
        schedule = last.get("precision_schedule")
        check(bool(schedule), "the last checkpoint records no precision "
              "schedule: the controller never re-planned")
        serve_argv = ["--arch", "qwen2-1.5b", "--n-layers", str(CKPT_LAYERS),
                      "--policy", "predicted", "--chunk", "64",
                      "--prompt-lens", "64", "--gen", "8", "--seed",
                      str(SEED), "--device", "cuda"]
        zero_counts(counters)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = LS.main([*serve_argv, "--ckpt-dir", str(run)])
        torch.cuda.synchronize()
        serve_used = read_counts(counters)
        plan = LS.plan_widths(plan_for_model(
            LT.model_config(LT.parse_args(_ckpt_argv())), seq_len=64 + 8,
            global_batch=1, policy=AccumulationPolicy(mode="predicted",
                                                       chunk=64)))
        print(f"[ckpt] served one request from the step-{CKPT_STEPS} "
              f"checkpoint: {res['decoded_tokens']} decoded tokens, tokens "
              f"{next(iter(res['results'].values()))}; restored schedule "
              f"{schedule}; serve plan m_acc {res['plan']} (without the "
              f"schedule: {plan}); launches {serve_used}", flush=True)
        check(res["schedule"] == schedule, "serve restored another schedule")
        check(all(res["plan"][k] == v for k, v in schedule.items()),
              "the serve plan does not carry the recorded schedule")
        check(any(plan[k] != v for k, v in schedule.items()),
              "the recorded schedule equals the serve plan's own widths")
        check(all(serve_used[k] > 0 for k in ("qmatmul_fused",
                                              "paged_attn_decode",
                                              P_GEOM_NAME)),
              "serving from the checkpoint missed a kernel of the serve path")
        return dict(saves=saves, restore_ms=restore_ms, seconds=secs,
                    train_launches=started["train_used"],
                    serve_launches=serve_used)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 10: tensor-parallel serving, 2 ranks on the one card
# --------------------------------------------------------------------------

TP_RANKS = 2
TP_LAYERS = 4                   # [tp]'s engines: full width, cut depth
# tokens generated a request in the [tp] engine runs: half the serve cell's
# (a decode step of 2 ranks sharing the card takes about 4x one device's)
TP_GEN = GEN // 2
TP_PREEMPT_AFTER = 6            # engine steps before the forced preemption
TP_RESUME_PAGES = (1, 7, 12, 23)  # P resumed there on the 384-token prompt
TP_G_MS = (MAX_BATCH, SLAB, 384)  # G's M: decode, a slab, a one-shot prompt
D_CARRY_NAME = "paged_attn_decode(return_carry)"
P_CARRY_NAME = "flash_prefill_paged(return_carry)"
P_RESUME_NAME = "flash_prefill_paged(carry, start_page)"


def _tp_heads(cfg, ranks):
    """(what, heads, KV heads) of the attention calls: a rank's share and
    the unsplit model."""
    return (("rank's share", cfg.n_heads // ranks, cfg.n_kv_heads // ranks),
            ("unsplit", cfg.n_heads, cfg.n_kv_heads))


def _tp_decode(cfg, dev, plan) -> dict:
    """D's carry entry at the serve arena (B 8) for a rank's share (KV 1, g
    6) and unsplit: o, m, l bitwise the plain walk's carry on random and
    lattice q, its finalize bitwise D's output; timed by graph replay
    beside D on the same inputs."""
    from repro_torch.kernels.attention import (
        finalize_carry, paged_attn_decode, paged_attn_decode_reference)
    from repro_torch.quant.formats import FP8_152

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    lens = DECODE_SHAPES[0][1]
    _, bucket = plan.bucket_for(max(lens))
    acc, width, dh = bucket.acc, bucket.max_pages(PAGE), cfg.head_dim
    kw = dict(kv_fmt=FP8_152, acc=acc)
    res = {}
    for what, h, kv in _tp_heads(cfg, TP_RANKS):
        n_pages, pt = _decode_table(gen, dev, lens, width)
        kc, vc, kse, vse = _attn_arena(gen, dev, n_pages, kv, dh)
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (kc, vc, kse, vse, pt, sl)
        q = torch.randn((len(lens), h, dh), generator=gen, device=dev)
        print(f"[tp] D's carry entry vs plain at the serve arena, {what}: "
              f"B={len(lens)} H={h} KV={kv} dh={dh}, width {width}, acc {acc}",
              flush=True)
        err = 0.0
        for label, qq in (("random q", q),
                          ("lattice q", _lattice(gen, tuple(q.shape), dev))):
            got = paged_attn_decode(qq, *args, return_carry=True, **kw)
            want = paged_attn_decode_reference(qq, *args, return_carry=True,
                                               **kw)
            for part, a, b in zip("oml", got, want):
                check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                      f"D carry {what} {label}: {part} not bitwise the plain "
                      "walk's")
            fin = finalize_carry(got[0], got[2])
            check(torch.equal(fin, paged_attn_decode(qq, *args, **kw)),
                  f"D carry {what} {label}: its finalize differs from D")
            err = max(err, float((got[0] - want[0]).abs().max()))
            print(f"  D carry {what} {label}: o, m, l bitwise the plain "
                  "walk's; finalize bitwise D", flush=True)
        carry = lib_time(lambda: paged_attn_decode(q, *args, return_carry=True,
                                                   **kw), reps=50)
        fin = lib_time(lambda: paged_attn_decode(q, *args, **kw), reps=50)
        plain = cuda_time(lambda: paged_attn_decode_reference(
            q, *args, return_carry=True, **kw), reps=1, warmup=0)
        pages = sum(-(-n // PAGE) for n in lens)
        n_bytes = (pages * kv * PAGE * dh * 2 + q.numel() * 4 * 2
                   + pt.numel() * 4 + len(lens) * 4 + pages * 2 * 4
                   + 2 * len(lens) * h * 4)
        b_ms, b_by = bound_ms(n_bytes, 4 * sum(lens) * dh * h, F32_FLOPS)
        print(f"  time at the {what}: D's carry entry graph replay "
              f"{lib_str(carry)} against D's {lib_str(fin)} "
              f"({carry[0] / fin[0]:.3f}x); plain {plain:.2f} ms; bound "
              f"{b_ms:.7f} ms ({b_by})", flush=True)
        res[what] = dict(ms=carry[0], graph_spread_ms=list(carry[1]),
                         finalized_ms=fin[0], plain_ms=plain, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err)
    out = dict(res["rank's share"], library_ms=None)
    out["unsplit"] = res["unsplit"]
    return out


def _tp_prefill(cfg, dev, plan) -> dict:
    """P's carry out at the 64-token slab (a rank's share and unsplit) and
    over the 8 one-shot prompts (a rank's share): bitwise the plain walk's
    carry on random and lattice q, its finalize bitwise P; then P resumed at
    ``TP_RESUME_PAGES`` of the 384-token prompt from the carry of the pages
    before (a carry-out call with ``kv_len = start_page * page``): bitwise
    the one-shot walk and the plain resumed walk.  Each timed by graph
    replay beside P on the same inputs."""
    from types import SimpleNamespace

    from repro_torch.kernels.attention import (
        finalize_carry, flash_prefill_paged, flash_prefill_paged_reference)
    from repro_torch.quant.formats import FP8_152

    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    heads = dict((w, SimpleNamespace(n_heads=h, n_kv_heads=kv,
                                     head_dim=cfg.head_dim))
                 for w, h, kv in _tp_heads(cfg, TP_RANKS))
    shapes = (("slab", "rank's share", [(SLAB, 320, SLAB)]),
              ("slab", "unsplit", [(SLAB, 320, SLAB)]),
              ("8 one-shot prompts", "rank's share",
               [(n, 0, n) for n in PROMPT_LENS]))
    res, err = {}, 0.0
    for what, share, calls in shapes:
        cases = [_p_case(gen, dev, heads[share], plan, *c) for c in calls]
        print(f"[tp] P's carry out vs plain at the {what}, {share}: H="
              f"{heads[share].n_heads} KV={heads[share].n_kv_heads}, (T, "
              f"q_offset) {[c[:2] for c in calls]}", flush=True)
        for c in cases:
            kw = dict(kv_fmt=FP8_152, acc=c["acc"])
            for label, qq in (("random q", c["q"]),
                              ("lattice q", _lattice(gen, tuple(c["q"].shape),
                                                     dev))):
                got = flash_prefill_paged(qq, *c["args"], return_carry=True,
                                          **kw)
                want = flash_prefill_paged_reference(qq, *c["args"],
                                                     return_carry=True, **kw)
                for part, a, b in zip("oml", got, want):
                    check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                          f"P carry {what} {share} {label}: {part} not bitwise")
                check(torch.equal(finalize_carry(got[0], got[2]),
                                  flash_prefill_paged(qq, *c["args"], **kw)),
                      f"P carry {what} {share}: its finalize differs from P")
                err = max(err, float((got[0] - want[0]).abs().max()))
        print(f"  P carry out {what} {share}: o, m, l bitwise the plain walk's "
              f"on random and lattice q ({len(cases)} calls); finalize "
              f"bitwise P", flush=True)

        def run(carry, cases=cases):
            for c in cases:
                flash_prefill_paged(c["q"], *c["args"], kv_fmt=FP8_152,
                                    acc=c["acc"], return_carry=carry)

        carry = lib_time(lambda: run(True), reps=20)
        fin = lib_time(lambda: run(False), reps=20)
        plain = cuda_time(lambda: [flash_prefill_paged_reference(
            c["q"], *c["args"], kv_fmt=FP8_152, acc=c["acc"],
            return_carry=True) for c in cases], reps=1, warmup=0)
        n_bytes = sum(c["bytes"] + 2 * c["q"].shape[0] * c["q"].shape[1] * 4
                      for c in cases)
        b_ms, b_by = bound_ms(n_bytes, sum(c["flops"] for c in cases),
                              F32_FLOPS)
        print(f"  time P carry out {what} {share}: graph replay "
              f"{lib_str(carry)} against P's {lib_str(fin)} "
              f"({carry[0] / fin[0]:.3f}x); plain {plain:.2f} ms; bound "
              f"{b_ms:.6f} ms ({b_by})", flush=True)
        res[(what, share)] = dict(ms=carry[0], graph_spread_ms=list(carry[1]),
                                  finalized_ms=fin[0], plain_ms=plain,
                                  bound_ms=b_ms, bound_by=b_by)
        del cases
    out = dict(res[("slab", "rank's share")], max_abs_err=err,
               library_ms=None)
    out["at"] = {f"{w}, {s}": r for (w, s), r in res.items()
                 if (w, s) != ("slab", "rank's share")}

    # the resumed walk, on the 384-token prompt at a rank's share
    share = heads["rank's share"]
    c = _p_case(gen, dev, share, plan, 384, 0, 384)
    kw = dict(kv_fmt=FP8_152, acc=c["acc"])
    q, (kc, vc, kse, vse, row, q_off, q_len, kv_len) = c["q"], c["args"]
    pages = (kc, vc, kse, vse, row, q_off, q_len)
    one = flash_prefill_paged(q, *pages, kv_len, **kw)
    one_c = flash_prefill_paged(q, *pages, kv_len, return_carry=True, **kw)
    carries = {sp: flash_prefill_paged(q, *pages, sp * PAGE, return_carry=True,
                                       **kw) for sp in TP_RESUME_PAGES}
    n0 = flash_prefill_paged.resume_launches
    for sp, cin in carries.items():
        res_o = flash_prefill_paged(q, *pages, kv_len, carry=cin,
                                    start_page=sp, **kw)
        res_c = flash_prefill_paged(q, *pages, kv_len, carry=cin,
                                    start_page=sp, return_carry=True, **kw)
        plain_o = flash_prefill_paged_reference(q, *pages, kv_len, carry=cin,
                                                start_page=sp, **kw)
        check(torch.equal(res_o.view(torch.int32), one.view(torch.int32)),
              f"P resumed at page {sp}: not bitwise the one-shot walk")
        check(torch.equal(res_o, plain_o),
              f"P resumed at page {sp}: not bitwise the plain resumed walk")
        check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(res_c, one_c)),
              f"P resumed at page {sp}: its carry is not the one-shot's")
    launches = flash_prefill_paged.resume_launches - n0
    sp = TP_RESUME_PAGES[len(TP_RESUME_PAGES) // 2]
    resumed = lib_time(lambda: flash_prefill_paged(
        q, *pages, kv_len, carry=carries[sp], start_page=sp, **kw), reps=20)
    fin = lib_time(lambda: flash_prefill_paged(q, *pages, kv_len, **kw),
                   reps=20)
    plain = cuda_time(lambda: flash_prefill_paged_reference(
        q, *pages, kv_len, carry=carries[sp], start_page=sp, **kw), reps=1,
        warmup=0)
    # the rows' columns from page sp on: those pages, q, the carry in (o,
    # m, l) and the output, each once
    attended = sum(max(0, r + 1 - sp * PAGE) for r in range(384))
    rows = 384 * share.n_heads
    n_bytes = ((-(-384 // PAGE) - sp) * share.n_kv_heads * PAGE
               * share.head_dim * 2 + 3 * rows * share.head_dim * 4
               + 2 * rows * 4 + row.numel() * 4)
    b_ms, b_by = bound_ms(n_bytes, 4 * attended * share.head_dim
                          * share.n_heads, F32_FLOPS)
    print(f"[tp] P resumed at pages {list(TP_RESUME_PAGES)} of the 384-token "
          f"prompt ({share.n_heads} heads, KV {share.n_kv_heads}) from the "
          f"carry of the pages before: bitwise the one-shot walk, its carry "
          f"and the plain resumed walk ({launches} launches); at page {sp}: "
          f"graph replay {lib_str(resumed)} against the one-shot P "
          f"{lib_str(fin)}; plain {plain:.2f} ms; bound {b_ms:.6f} ms "
          f"({b_by})", flush=True)
    resume = dict(ms=resumed[0], graph_spread_ms=list(resumed[1]),
                  one_shot_ms=fin[0], plain_ms=plain, bound_ms=b_ms,
                  bound_by=b_by, max_abs_err=0.0, library_ms=None,
                  launches=launches, start_page=sp)
    return dict(carry=out, resume=resume)


def _tp_gemms(cfg, dev) -> None:
    """G at a rank's output-dim slices of the layer weights (the seven per
    layer), at M = ``TP_G_MS``: bitwise the plain version on random and on
    lattice operands; the route G takes is printed."""
    from repro_torch.kernels import sm90
    from repro_torch.kernels.fused import (qmatmul_fused,
                                           qmatmul_fused_reference)

    s, q = TP_RANKS, cfg.quant
    d, hd, kvd, f = (cfg.d_model, cfg.n_heads * cfg.head_dim,
                     cfg.n_kv_heads * cfg.head_dim, cfg.d_ff)
    shapes = (("wq", d, hd // s, q.attn_qkv), ("wk", d, kvd // s, q.attn_qkv),
              ("wv", d, kvd // s, q.attn_qkv), ("wo", hd, d // s, q.attn_out),
              ("w_gate", d, f // s, q.mlp_up), ("w_up", d, f // s, q.mlp_up),
              ("w_down", f, d // s, q.mlp_down))
    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    lines = []
    for name, k, n, qc in shapes:
        kw = _gemm_kw(qc)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        wl = _lattice(gen, (k, n), dev).to(torch.bfloat16)
        for m in TP_G_MS:
            for what, a, b in (("random", torch.randn((m, k), generator=gen,
                                                      device=dev), w),
                               ("lattice", _lattice(gen, (m, k), dev), wl)):
                check(torch.equal(qmatmul_fused(a, b, **kw),
                                  qmatmul_fused_reference(a, b, **kw)),
                      f"G at the rank's {name} (K={k}, N={n}), M={m}, {what}: "
                      "not bitwise the plain version")
            sched = sm90.g_schedule(m, n, k, qc.fwd.chunk, 0, 1)
            route = ("tile" if isinstance(sched, sm90.Schedule) else
                     f"decode (slots {sched.slots}, slices {sched.slices})")
            lines.append(f"{name} M={m} {route}")
    print(f"[tp] G at a rank's slices (K, N): "
          f"{[(n, k, nn) for n, k, nn, _ in shapes]}, M {list(TP_G_MS)}: "
          f"bitwise the plain version on random and lattice operands; routes "
          f"{'; '.join(lines)}", flush=True)


def phase_tp_kernels(cfg, dev, plan) -> dict:
    d = _tp_decode(cfg, dev, plan)
    p = _tp_prefill(cfg, dev, plan)
    _tp_gemms(cfg, dev)
    return dict(D=d, P=p["carry"], resume=p["resume"])


def _tp_int8_wire(cfg, dist, dev) -> dict:
    """The int8 logit wire against the gather wire on a lattice input: x
    and the head in {-1, 0, 1} (sparse), rank 0's partial logit (0, 0)
    pinned at 127 (x[0, 0] = 127, the only nonzero of its head row and
    column in rank 0's slice), so every partial is an integer of the
    wire's unit scale; the two wires' logits bitwise.  Then
    ``compressed_psum`` against the f32 sum on integer partials, bitwise
    (JAX's lattice test)."""
    from repro_torch.dist import psum
    from repro_torch.models.lm import _unembed_sharded
    from repro_torch.train.compression import compressed_psum

    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    d, v = cfg.d_model, 4096

    def tern(shape, p):
        x = torch.randint(-1, 2, shape, generator=gen, device=dev).float()
        return torch.where(torch.rand(shape, generator=gen, device=dev) < p,
                           x, torch.zeros_like(x))

    x, head = tern((3, d), 0.05), tern((d, v), 0.05)
    d_loc = d // dist.size
    x[0, 0], head[0, :], head[:d_loc, 0] = 127.0, 0.0, 0.0
    head[0, 0] = 1.0
    x, head = x.to(torch.bfloat16), head.to(torch.bfloat16)
    gather = _unembed_sharded(x, head, cfg, dataclasses.replace(
        dist, logit_wire="gather"))
    int8 = _unembed_sharded(x, head, cfg, dataclasses.replace(
        dist, logit_wire="int8"))
    parts = torch.randint(-127, 128, (3, 16), generator=gen,
                          device=dev).float()
    parts[0, 0] = 127.0
    wire, _ = compressed_psum(parts, dist)
    return dict(logits=torch.equal(gather.view(torch.int16),
                                   int8.view(torch.int16)),
                max_logit=float(gather.float().abs().max()),
                psum=torch.equal(wire, psum(parts, dist)))


def tp_setup(cfg, dist, dev) -> dict:
    """What each ``[tp]`` rank runs before its jobs (``run_tp``'s
    ``setup``): which gloo collectives take CUDA tensors directly, and the
    int8 wire on a lattice input."""
    import torch.distributed as tdist

    probe = {}
    for name, fn in (("all_reduce", lambda t: tdist.all_reduce(t)),
                     ("all_gather", lambda t: tdist.all_gather(
                         [torch.empty_like(t) for _ in range(dist.size)], t))):
        try:
            fn(torch.ones(4, device=dev))
            probe[name] = f"takes {dev.type} tensors"
        except Exception as e:  # noqa: BLE001 -- reported
            probe[name] = f"refuses {dev.type} tensors ({type(e).__name__})"
    return dict(gloo=probe, int8=_tp_int8_wire(cfg, dist, dev))


def phase_tp_engine(cfg, dev, prompts) -> dict:
    """2 ranks (gloo) on the one card serve the serve cell's prompts at
    full width, ``TP_LAYERS`` layers (``--n-layers``: the gloo traffic
    grows with depth; ``TP_GEN`` tokens each), one-shot and with
    64-token slabs and a forced preemption, both through the launcher's
    own ``--serve-mesh 2`` entry (``launch/serve.py``'s ``main``, whose
    ``run_tp`` starts the ranks once for its job and the slab job; each
    job's kernel counts read by ``serve_job``, from 0 at its start); each
    against the
    single-device engine under the same ``tp_shards=2`` plan: tokens, the
    logits of every decode step (sha256) and of one bitwise, the arena
    gathered from the ranks byte for byte; the pools checked
    (``ShardedPagePool.check_invariants`` in ``serve_job``)."""
    from repro_torch.launch import serve as S
    from repro_torch.serve.plan import plan_attention

    # the launcher's pool for these requests, and its engine's plan (the
    # plan does not depend on the depth)
    cfg = dataclasses.replace(cfg, n_layers=TP_LAYERS)
    n_pages = -(-int(sum(n + TP_GEN for n in PROMPT_LENS) * 1.25) // PAGE) + 1
    base = dict(cfg=cfg, seed=SEED, n_pages=n_pages, page_size=PAGE,
                max_batch=MAX_BATCH, prompts=prompts, gen=TP_GEN,
                plan=plan_attention((n_pages - 1) * PAGE, PAGE,
                                    tp_shards=TP_RANKS))
    # the launcher keeps the first decode step's logits; the slab run a
    # later step's, when more rows are running
    one_job = dict(base, prefill_chunk=None, logit_step=0)
    chunk_job = dict(base, prefill_chunk=SLAB, preempt_after=TP_PREEMPT_AFTER,
                     logit_step=3)
    t0 = time.perf_counter()
    single = [S.serve_job(j, device=dev) for j in (one_job, chunk_job)]
    t_single = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the launcher's own --serve-mesh entry, its ranks started once for its
    # one-shot job and the slab job
    argv = ["--arch", "qwen2-1.5b", "--policy", "predicted", "--chunk", "64",
            "--prompt-lens", ",".join(map(str, PROMPT_LENS)), "--gen",
            str(TP_GEN), "--page-size", str(PAGE), "--max-batch", str(MAX_BATCH),
            "--seed", str(SEED), "--serve-mesh", str(TP_RANKS),
            "--n-layers", str(TP_LAYERS), "--device", dev.type]
    out = S.main_tp(S.parse_args(argv), [chunk_job],
                    functools.partial(tp_setup, cfg))
    t_ranks = time.perf_counter() - t0
    setups = out["setups"]
    print(f"[tp] engine: single device {t_single:.1f}s (2 runs), the "
          f"launcher's 2 ranks {t_ranks:.1f}s for both jobs (process start "
          f"included); gloo: {setups[0]['gloo']}", flush=True)
    runs = (("one-shot (launch/serve.py --serve-mesh 2)", single[0],
             out["rank0"]),
            (f"{SLAB}-token slabs, forced preemption", single[1],
             out["extra"][0]))
    for label, one, tp in runs:
        check(tp["tp_shards"] == TP_RANKS, f"{label}: not {TP_RANKS} ranks")
        check(tp["tokens"] == one["tokens"],
              f"[tp] {label}: tokens differ from the single device's")
        check(tp["logit_hashes"] == one["logit_hashes"],
              f"[tp] {label}: a decode step's logits differ")
        check(np.array_equal(tp["logits"].view(np.int32),
                             one["logits"].view(np.int32)),
              f"[tp] {label}: a decode step's logits not bitwise")
        for name in ("k", "v", "k_se", "v_se"):
            check(np.array_equal(tp["arena"][name], one["arena"][name]),
                  f"[tp] {label}: arena {name} differs")
        check(all(len(t) == TP_GEN for t in tp["tokens"]), f"{label}: short")
        steps = len(one["logit_hashes"])
        print(f"[tp] {label}: tokens, {steps} decode steps' logits (one "
              f"bitwise, every step by sha256) and the gathered arena "
              f"({sum(a.nbytes for a in tp['arena'].values())} bytes) bitwise "
              f"the single device's under the tp_shards=2 plan (bucket m_acc "
              f"{one['plan_m_acc']}); preemptions {tp['preemptions']}, "
              f"restores {tp['restores']}; decode step {1e3 * one['decode_s'] / steps:.2f} "
              f"ms on one device, {1e3 * tp['decode_s'] / steps:.2f} ms with 2 "
              f"ranks sharing one card (not a TP speed figure); KV "
              f"bytes/token {tp['kv_bytes_per_token']:.1f}, a rank "
              f"{tp['kv_bytes_per_token_shard']:.1f}", flush=True)
    chunked = out["extra"][0]
    check(chunked["preemptions"] >= 1 and chunked["restores"] >= 1,
          "[tp] the forced preemption did not happen")
    for r in setups:
        check(r["int8"]["logits"] and r["int8"]["psum"],
              f"[tp] the int8 wire is not bitwise on the lattice input: "
              f"{r['int8']}")
    print(f"[tp] int8 logit wire on the lattice input: logits bitwise the "
          f"gather wire's (max |logit| {setups[0]['int8']['max_logit']:.0f}); "
          f"compressed_psum bitwise the f32 sum on integer partials",
          flush=True)
    launches = chunked["launches"]
    print(f"[tp] launches on rank 0 over the slab run: {launches}", flush=True)
    for name in ("qmatmul_fused", D_CARRY_NAME, P_CARRY_NAME):
        check(launches[name] > 0, f"[tp] {name} was not launched")
    check(launches["paged_attn_decode"] == 0
          and launches["flash_prefill_paged"] == 0,
          "[tp] a rank ran a finalized attention call")
    return dict(launches=launches,
                decode_ms=[1e3 * r["decode_s"] / len(r["logit_hashes"])
                           for r in (single[1], chunked)])


# --------------------------------------------------------------------------
# phase 13: training over a mesh's data axis ([dist-train])
# --------------------------------------------------------------------------

DIST_SHAPE = {"data": 2, "model": 1}      # --mesh 2x1: 2 ranks, one card
MODEL_SHAPE = {"data": 1, "model": 2}     # --mesh 1x2
MESH_2X2 = {"data": 2, "model": 2}        # --mesh 2x2: 4 ranks, one card
DIST_LAYERS = 4          # the mesh runs' depth at full width
E_SR_ORIGIN_NAME = "qmatmul_fused(return_quantized, rounding=sr) (row0, col0)"
K8_SR_ORIGIN_NAME = "qmatmul_fused(collect_stats, rounding=sr) (row0, col0)"
G_SR_ORIGIN_NAME = "qmatmul_fused(rounding=sr) (row0, col0)"
B_SR_KSLICE_NAME = "qmatmul_bwd_pair(rounding=sr) (K-slice)"
K9_SR_KSLICE_NAME = "qmatmul_bwd_pair(collect_stats, rounding=sr) (K-slice)"
EXACT_REL = 1e-3         # --policy exact on the card (ROADMAP F8)
B_KSLICE_NAME = "qmatmul_bwd_pair (K-slice)"
K9_KSLICE_NAME = "qmatmul_bwd_pair(collect_stats) (K-slice)"
DIST_RECORD = ("step", "loss", "grad_norm", "lr", "skipped", "loss_scale")


def _dist_argv(*extra) -> list:
    """The launcher's arguments of the [dist-train] runs: qwen2-1.5b at
    full width, the predicted plan, 8 x 64 tokens, 2 steps (a mesh step
    is mostly gloo traffic through the host: a third step checked nothing
    the first two do not)."""
    return ["--arch", "qwen2-1.5b", "--policy", "predicted", "--chunk",
            "64", "--steps", "2", "--global-batch", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--log-every", "1", "--seed",
            str(SEED), "--device", "cuda", *extra]


def phase_dist_kslices(dev) -> dict:
    """B and K9 on a rank's K-slice, as the data-parallel backward calls
    them (every row of g, the rank's K columns of the residual codes, its
    K rows of w), at every distinct layer shape of the training step (T =
    512) and on a 4096-column slice of the tied lm_head (f32 x, the
    embed.T view): for each of the 2 ranks' slices, dx and dw bitwise the
    whole call's slices and within 1 carry ulp of the plain version on the
    same slice; K9's dx and dw bitwise B's, its two rows' counters summed
    over the slices equal to the whole call's.  Timed at mlp_gate's slice
    (K = 768 of 1536, N = 8960; mlp_up's shape, de-duplicated) beside the
    plain version, the bound and the bf16 library pair."""
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_reference,
        qmatmul_bwd_pair_stats_reference)
    from repro_torch.kernels.common import STAT_COUNT, STAT_MAX_ABS
    from repro_torch.kernels.fused import qmatmul_fused
    from repro_torch.models.api import dense_gemm_shapes

    cfg = _train_cfg()
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    shapes = dense_gemm_shapes(cfg, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH)
    head, layer = shapes[0], shapes[1:]
    t, ranks = head[1], DIST_SHAPE["data"]
    cases, seen = [], set()
    for tag, _, k, n, qc in layer:
        if (k, n) in seen:
            continue
        seen.add((k, n))
        x = torch.randn((t, k), generator=gen, device=dev)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        _, xq, wq = qmatmul_fused(x, w, return_quantized=True, **_e_kw(qc))
        g = torch.randn((t, n), generator=gen, device=dev) / math.sqrt(n)
        cases.append((f"{tag} K={k} N={n}", g, xq, wq, _b_kw(qc)))
    d = cfg.d_model
    hx = torch.randn((t, d), generator=gen, device=dev)
    emb = (torch.randn((4096, d), generator=gen, device=dev)
           / math.sqrt(d)).to(torch.bfloat16)
    hg = torch.randn((t, 4096), generator=gen, device=dev) / 64.0
    cases.append((f"lm_head K={d} N=4096 (of {cfg.vocab_size})", hg, hx,
                  emb.T, _b_kw(cfg.quant.lm_head)))
    b_err = k9_err = 0.0
    print(f"[dist-train] B and K9 on the {ranks} ranks' K-slices vs the "
          f"whole call and the plain version at T={t}", flush=True)
    for label, g, xq, wq, kw in cases:
        (eb, mb), (eg, mg) = kw["bwd_acc"], kw["grad_acc"]
        whole = qmatmul_bwd_pair(g, xq, wq, **kw)
        wstat = qmatmul_bwd_pair(g, xq, wq, collect_stats=True, **kw)
        ks = xq.shape[1] // ranks
        rows = []
        for r in range(ranks):
            sl = slice(r * ks, (r + 1) * ks)
            xs, ws = xq[:, sl].contiguous(), wq[sl]
            dx, dw = qmatmul_bwd_pair(g, xs, ws, **kw)
            sdx, sdw, row = qmatmul_bwd_pair(g, xs, ws, collect_stats=True,
                                             **kw)
            pdx, pdw = qmatmul_bwd_pair_reference(g, xs, ws, **kw)
            quiet = r > 0
            compare(f"B dx {label} rank {r} vs whole", dx, whole[0][:, sl],
                    mb, eb, bitwise=True, quiet=quiet)
            compare(f"B dw {label} rank {r} vs whole", dw, whole[1][sl],
                    mg, eg, bitwise=True, quiet=quiet)
            b_err = max(b_err, compare(f"B dx {label} rank {r} vs plain",
                                       dx, pdx, mb, eb, bitwise=False,
                                       quiet=True),
                        compare(f"B dw {label} rank {r} vs plain", dw, pdw,
                                mg, eg, bitwise=False, quiet=True))
            check(torch.equal(sdx, dx) and torch.equal(sdw, dw),
                  f"K9 {label} rank {r}: dx/dw differ from B's")
            if r == 0:
                _, _, prow = qmatmul_bwd_pair_stats_reference(g, xs, ws,
                                                              **kw)
                k9_err = max(k9_err, check_stats(
                    f"K9 {label} rank 0 slice", row, prow))
            rows.append(row.double())
        tot = sum(rows)
        check(torch.equal(tot[:, STAT_COUNT],
                          wstat[2].double()[:, STAT_COUNT])
              and torch.equal(torch.stack(rows)[:, :, STAT_MAX_ABS].amax(0),
                              wstat[2].double()[:, STAT_MAX_ABS]),
              f"K9 {label}: the slices' counts or max differ from the "
              "whole call's")
    # time one rank's slice at mlp_gate (mlp_up's shape)
    _, g, xq, wq, kw = next(c for c in cases if c[0].startswith("mlp_gate"))
    k, n = xq.shape[1], wq.shape[1]
    ks = k // ranks
    xs, ws = xq[:, :ks].contiguous(), wq[:ks]
    gb = g.to(torch.bfloat16)
    xsb, wsb = xs.to(torch.bfloat16), ws.to(torch.bfloat16)
    out = {}
    for name, extra, ref in (
            ("B", {}, qmatmul_bwd_pair_reference),
            ("K9", dict(collect_stats=True),
             qmatmul_bwd_pair_stats_reference)):
        ms = cuda_time(lambda: qmatmul_bwd_pair(g, xs, ws, **extra, **kw),
                       reps=5)
        plain = cuda_time(lambda: ref(g, xs, ws, **kw), reps=1, warmup=1)
        lib = lib_time(lambda: (torch.matmul(gb, wsb.T),
                                torch.matmul(xsb.T, gb)))
        bnd, by = bound_ms(*_b_cost(t, ks, n))
        print(f"[dist-train] {name} on a K-slice (T={t}, K={ks} of {k}, "
              f"N={n}): kernel {ms:.4f} ms, plain {plain:.1f} ms, library "
              f"{lib_str(lib)}, bound {bnd:.4f} ms ({by})", flush=True)
        out[name] = dict(max_abs_err=b_err if name == "B" else k9_err,
                         ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=lib[0], library_spread_ms=list(lib[1]),
                         shape=[t, ks, n])
    return out


DIST_SR_DECODE_M = 16   # G's decode route under [dist-sr]: 2 ranks' 8 rows


def _origin_blocks(t, n):
    """{label: (rows, cols)} of the blocks 2 ranks hold: a batch rank's rows
    and a model rank's columns, rank 1's (non-zero origins) last."""
    ht, hn = t // 2, n // 2
    return {f"rank {r} rows": (slice(r * ht, (r + 1) * ht), slice(0, n))
            for r in range(2)} | {
        f"rank {r} columns": (slice(0, t), slice(r * hn, (r + 1) * hn))
        for r in range(2)}


def _origin_kw(rows, cols, n):
    return dict(row0=rows.start, col0=cols.start, n_cols=n)


def phase_dist_sr(dev) -> dict:
    """``[dist-sr]``: the SR keys' origins at the training path's shapes
    (T = 512, full width, the SR plan's role seeds of ``--sr-seed 7``), at
    every distinct layer GEMM shape and at the tied lm_head's (f32 x, the
    embed.T view; SR forced, the plan's lm_head being RNE), the lm_head
    both at the full vocab and on a 4096-column slice.  E, K8 (on E's
    codes) and G (the routed call: the tile at these rows) on each of 2
    batch ranks' rows (``row0``) and each of 2 model ranks' columns
    (``col0``, ``n_cols``), and G's decode route on 2 ranks' 8 rows of a
    16-row call: each bitwise the whole SR call's block and, rank 1's, its
    plain version on the block.  B and K9 on both ranks' K-slices
    (``k_offset``, ``k_total``): bitwise the whole SR pair's slices and,
    rank 1's, the plain version; K9's dx and dw B's.  The plain versions
    run on the lm_head's slice only (at the full vocab they take minutes).
    Timed at mlp_gate (mlp_up's shape; rank 1's block) by CUDA events
    beside the RNE call on the same block; the bound is the RNE entry's
    and SR has no library call."""
    from repro_torch.kernels import sm90
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_reference,
        qmatmul_bwd_pair_stats_reference)
    from repro_torch.kernels.fused import (
        qmatmul_fused, qmatmul_fused_reference, qmatmul_fused_stats_reference,
        qmatmul_fused_with)
    from repro_torch.models.api import dense_gemm_shapes

    cfg = _train_cfg(rounding="sr")
    shapes = dense_gemm_shapes(cfg, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH)
    head, layer = shapes[0], shapes[1:]
    t = head[1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 91)
    print(f"[dist-sr] E, K8, G, B and K9 under SR at their mesh origins "
          f"(T={t}, 2 ranks' rows, columns and K-slices) vs the whole SR "
          f"call and the plain version", flush=True)
    cases, seen = [], set()
    for tag, _, k, n, qc in layer:
        if (k, n) in seen:
            continue
        seen.add((k, n))
        ekw, bkw = _sr_kw(qc)
        x = torch.randn((t, k), generator=gen, device=dev)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        g = torch.randn((t, n), generator=gen, device=dev) / math.sqrt(n)
        cases.append((f"{tag} K={k} N={n}", x, w, g, ekw, bkw, True))
    d, v = cfg.d_model, cfg.vocab_size
    hq = cfg.quant.lm_head
    hkw = dict(_e_kw(hq), rounding="sr", sr_seed=TRAIN_SR_SEED)
    hbkw = dict(_b_kw(hq), rounding="sr", sr_seed_bwd=TRAIN_SR_SEED + 1,
                sr_seed_grad=TRAIN_SR_SEED + 2)
    for cols, plain_too in ((v, False), (4096, True)):
        emb = (torch.randn((cols, d), generator=gen, device=dev)
               / math.sqrt(d)).to(torch.bfloat16)
        cases.append((f"lm_head K={d} N={cols}" + (
            f" (of {v})" if cols < v else ""),
            torch.randn((t, d), generator=gen, device=dev), emb.T,
            torch.randn((t, cols), generator=gen, device=dev) / 64.0,
            hkw, hbkw, plain_too))
    err = dict.fromkeys(("E", "K8", "G", "B", "K9"), 0.0)
    for label, x, w, g, ekw, bkw, plain_too in cases:
        k, n = w.shape
        m, e = ekw["m_acc"], ekw["e_acc"]
        (eb, mb), (eg, mg) = bkw["bwd_acc"], bkw["grad_acc"]
        head_case = ekw["repr_fmt"] is None
        y = qmatmul_fused(x, w, **ekw)
        if not head_case:
            ye, xq, wq = qmatmul_fused(x, w, return_quantized=True, **ekw)
            check(torch.equal(ye, y), f"[dist-sr] {label}: E's C is not G's")
            k8kw = _k8_codes_kw(ekw)
        else:
            xq, wq, k8kw = x, w, ekw
        for blk, (rows, cols) in _origin_blocks(t, n).items():
            o = _origin_kw(rows, cols, n)
            want = y[rows, cols]
            plain = plain_too and blk.startswith("rank 1")
            got = {"G": qmatmul_fused(x[rows], w[:, cols], **ekw, **o)}
            if not head_case:
                got["E"] = qmatmul_fused(x[rows], w[:, cols],
                                         return_quantized=True, **ekw,
                                         **o)[0]
            got["K8"], row = qmatmul_fused(xq[rows], wq[:, cols],
                                           collect_stats=True, **k8kw, **o)
            for name, c in got.items():
                compare(f"{name} sr {label} {blk} vs whole", c, want, m, e,
                        bitwise=True, quiet=True)
            if plain:
                pw = qmatmul_fused_reference(x[rows], w[:, cols], **ekw, **o)
                pc, prow = qmatmul_fused_stats_reference(
                    xq[rows], wq[:, cols], **k8kw, **o)
                for name, c, ref in (("G", got["G"], pw), ("E", got.get("E"),
                                                            pw),
                                     ("K8", got["K8"], pc)):
                    if c is not None:
                        err[name] = max(err[name], compare(
                            f"{name} sr {label} {blk} vs plain", c, ref, m,
                            e, bitwise=True, quiet=True))
                err["K8"] = max(err["K8"], check_stats(
                    f"K8 sr {label} {blk}", row, prow))
        # G's decode route: 2 ranks' 8 rows of a 16-row call
        xm = x[:DIST_SR_DECODE_M]
        dec = sm90.decode_schedule(DIST_SR_DECODE_M // 2, n, k,
                                   ekw["block_k"],
                                   int(w.dtype == torch.bfloat16))
        if dec is not None:
            whole = qmatmul_fused(xm, w, **ekw)
            h = DIST_SR_DECODE_M // 2
            for r in range(2):
                got = qmatmul_fused_with(xm[r * h:(r + 1) * h], w, dec,
                                         row0=r * h, **ekw)
                compare(f"G decode sr {label} rank {r} rows vs whole", got,
                        whole[r * h:(r + 1) * h], m, e, bitwise=True,
                        quiet=True)
        # B and K9 on both ranks' K-slices
        wdx, wdw = qmatmul_bwd_pair(g, xq, wq, **bkw)
        ks = k // 2
        for r in range(2):
            sl = slice(r * ks, (r + 1) * ks)
            xs, ws = xq[:, sl].contiguous(), wq[sl]
            o = dict(k_offset=r * ks, k_total=k)
            dx, dw = qmatmul_bwd_pair(g, xs, ws, **bkw, **o)
            sdx, sdw, rows2 = qmatmul_bwd_pair(g, xs, ws, collect_stats=True,
                                               **bkw, **o)
            compare(f"B sr dx {label} rank {r} vs whole", dx, wdx[:, sl], mb,
                    eb, bitwise=True, quiet=True)
            compare(f"B sr dw {label} rank {r} vs whole", dw, wdw[sl], mg, eg,
                    bitwise=True, quiet=True)
            check(torch.equal(sdx, dx) and torch.equal(sdw, dw),
                  f"[dist-sr] K9 {label} rank {r}: dx/dw differ from B's")
            if r == 1 and plain_too:
                pdx, pdw = qmatmul_bwd_pair_reference(g, xs, ws, **bkw, **o)
                err["B"] = max(err["B"], compare(
                    f"B sr dx {label} rank 1 vs plain", dx, pdx, mb, eb,
                    bitwise=True, quiet=True), compare(
                    f"B sr dw {label} rank 1 vs plain", dw, pdw, mg, eg,
                    bitwise=True, quiet=True))
                _, _, prows = qmatmul_bwd_pair_stats_reference(g, xs, ws,
                                                               **bkw, **o)
                err["K9"] = max(err["K9"], check_stats(
                    f"K9 sr {label} rank 1", rows2, prows))
        print(f"  [dist-sr] {label}: E, K8, G at both ranks' rows and "
              f"columns, G's decode route at 2 x 8 rows, B and K9 at both "
              f"K-slices bitwise the whole SR calls"
              + (" and the plain versions" if plain_too else ""),
              flush=True)
    # timed at mlp_gate (mlp_up's shape), rank 1's block, beside RNE on
    # the same block
    label, x, w, g, ekw, bkw, _ = next(c for c in cases
                                       if c[0].startswith("mlp_gate"))
    k, n = w.shape
    _, xq, wq = qmatmul_fused(x, w, return_quantized=True, **ekw)
    rows = slice(t // 2, t)
    xr, xqr = x[rows], xq[rows]
    o = dict(row0=t // 2, col0=0, n_cols=n)
    ks = k // 2
    xs, ws = xq[:, ks:].contiguous(), wq[ks:]
    ko = dict(k_offset=ks, k_total=k)
    rne_e, rne_b = dict(ekw, rounding="rne"), dict(bkw, rounding="rne")
    k8 = _k8_codes_kw(ekw)
    th = t // 2
    calls = {
        "E": (lambda kw: qmatmul_fused(xr, w, return_quantized=True, **kw,
                                       **o),
              lambda: qmatmul_fused_reference(xr, w, return_quantized=True,
                                              **ekw, **o),
              ekw, rne_e, _e_cost(th, k, n)),
        "K8": (lambda kw: qmatmul_fused(xqr, wq, collect_stats=True, **kw,
                                        **o),
               lambda: qmatmul_fused_stats_reference(xqr, wq, **k8, **o),
               k8, dict(k8, rounding="rne"), _k8_cost(th, k, n, True)),
        "G": (lambda kw: qmatmul_fused(xr, w, **kw, **o),
              lambda: qmatmul_fused_reference(xr, w, **ekw, **o),
              ekw, rne_e,
              (th * k * 4 + k * n * 2 + th * n * 4, 2 * th * k * n,
               FP8_FLOPS)),
        "B": (lambda kw: qmatmul_bwd_pair(g, xs, ws, **kw, **ko),
              lambda: qmatmul_bwd_pair_reference(g, xs, ws, **bkw, **ko),
              bkw, rne_b, _b_cost(t, ks, n)),
        "K9": (lambda kw: qmatmul_bwd_pair(g, xs, ws, collect_stats=True,
                                           **kw, **ko),
               lambda: qmatmul_bwd_pair_stats_reference(g, xs, ws, **bkw,
                                                        **ko),
               bkw, rne_b, _b_cost(t, ks, n))}
    out = {}
    for name, (fn, ref, sr_kw, rne_kw, cost) in calls.items():
        reps = 5 if name in ("B", "K9") else 10
        rne_ms = cuda_time(lambda: fn(rne_kw), reps=reps)
        ms = cuda_time(lambda: fn(sr_kw), reps=reps)
        plain = cuda_time(ref, reps=1, warmup=0)
        bnd, by = bound_ms(*cost)
        where = (f"K-slice K={ks} of {k}" if name in ("B", "K9")
                 else f"rows {t // 2}..{t} of {t}")
        print(f"[dist-sr] {name} at its SR origin ({label}, rank 1's "
              f"{where}): SR {ms:.4f} ms, RNE {rne_ms:.4f} ms "
              f"({ms / rne_ms:.3f}x), plain {plain:.1f} ms, bound "
              f"{bnd:.4f} ms ({by})", flush=True)
        out[name] = dict(max_abs_err=err[name], ms=ms, rne_ms=rne_ms,
                         plain_ms=plain, bound_ms=bnd, bound_by=by,
                         library_ms=None, shape=[
                             t if name in ("B", "K9") else th,
                             ks if name in ("B", "K9") else k, n])
    return out


def _dist_records(res) -> list:
    return [{k: r[k] for k in DIST_RECORD} for r in res["records"]]


def digest(t: torch.Tensor) -> tuple[int, int]:
    """Two integer sums of a tensor's bit patterns (plain and weighted by
    position mod 65521), computed where the tensor lives: equal tensors
    give equal digests, and a changed bit changes both."""
    flat = t.detach().contiguous().view(-1)
    bits = flat.view({4: torch.int32, 2: torch.int16,
                      1: torch.int8}[flat.element_size()])
    plain, weighted, step = 0, 0, 1 << 24
    for lo in range(0, bits.numel(), step):
        c = bits[lo:lo + step].to(torch.int64)
        w = torch.arange(lo, lo + c.numel(), device=c.device) % 65521 + 1
        plain += int(c.sum())
        weighted += int((c * w).sum())
    return plain, weighted


def _leaves(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def state_digests(state: dict, specs=None, mesh=None, rank=None) -> dict:
    """``digest`` of every params, ``m`` and ``v`` leaf by path; with
    ``specs`` and ``mesh``, of rank ``rank``'s block of each (whole state
    in), which that rank's own digests must equal."""
    from repro_torch.sharding.specs import shard, tree_specs_map

    out = {}
    for name, tree in (("params", state["params"]),
                       ("m", state["opt"]["m"]), ("v", state["opt"]["v"])):
        if specs is not None:
            tree = tree_specs_map(lambda x, sp: shard(x, sp, mesh, rank),
                                  tree, specs)
        for path, x in _leaves(tree, name):
            out[path] = digest(x)
    return out


def rank_digests(state, model, dist) -> dict:
    """``launch.train.train``'s ``finish``: the digests of the state this
    rank holds."""
    return {"digests": state_digests(state)}


def block_digests(shapes: tuple, state, model, dist) -> dict:
    """``launch.train.train``'s ``finish`` on the single device: the
    digests of every rank's blocks of its (whole) state under a mesh of
    each shape of ``shapes``, by the shape's ``describe``."""
    from repro_torch.dist import Dist
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.loop import param_specs

    out = {}
    for shape in shapes:
        mesh = Mesh(dict(shape))
        specs = param_specs(model, Dist(mesh=mesh))
        out[mesh.describe()] = [state_digests(state, specs, mesh, r)
                                for r in range(mesh.size)]
    return {"block_digests": out}


def _tick_verdicts(path) -> list:
    with open(path) as f:
        return [{k: e.get(k) for k in ("step", "gemm", "role", "event",
                                        "m_acc")}
                for e in map(json.loads, f)]


def _tick_logs(name: str):
    """(single device's, mesh's) event logs of tick run ``name``, fresh."""
    logs = [ROOT / "build" / f"dist_tick_{name}_{who}.jsonl"
            for who in ("single", "mesh")]
    for f in logs:
        f.parent.mkdir(exist_ok=True)
        if f.exists():
            f.unlink()
    return logs


def _mesh_vs_single(groups, *, same=None, digest_runs=(), exact_runs=()):
    """``groups``: lists of jobs, (tag, label, mesh shape, argv, plan or
    None, tick) each, a list's shapes of one size.  Each list is one start
    of its ranks (``run_mesh``, the launcher's ``--mesh``), every list's
    start at once, each waited on by a thread of its own (the ranks are
    processes: they share nothing of this one), while this process runs
    the single-device runs on the same arguments (``same``: label -> the
    label whose single-device run it shares, its digests taken under both
    meshes).  Each run is held to its single device: every rank's
    records and schedule bitwise (within F8's 1e-3 relative for
    ``exact_runs``), the blocks of the final state by digests for
    ``digest_runs``, the tick verdicts equal.  Returns (single results,
    every list's ranks' results, every list's seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import train as LT

    same = dict(same or {})
    jobs = [job for group in groups for job in group]
    shapes: dict = {}
    for _, label, shape, *_ in jobs:
        shapes.setdefault(same.get(label, label), []).append(shape)
    logs = {label: _tick_logs(f"{tag}_{i}") for i, (tag, label, *_, tick)
            in enumerate(jobs) if tick}

    def mesh(group):
        t0 = time.perf_counter()
        outs = LT.run_mesh(
            [LT.MeshJob(LT.parse_args(
                argv + (["--telemetry-log", str(logs[label][1])]
                        if label in logs else [])
                + ["--mesh", "x".join(map(str, shape.values()))]),
                shape, plan) for _, label, shape, argv, plan, _ in group],
            finish=rank_digests, timeout_s=600)
        return outs, time.perf_counter() - t0

    single, secs = {}, {}
    with ThreadPoolExecutor(len(groups)) as pool:
        futures = [pool.submit(mesh, group) for group in groups]
        for _, label, shape, argv, plan, _ in jobs:
            if label in same:
                continue
            extra = (["--telemetry-log", str(logs[label][0])]
                     if label in logs else [])
            t0 = time.perf_counter()
            single[label] = LT.train(
                LT.parse_args(argv + extra),
                finish=functools.partial(block_digests, tuple(shapes[label]))
                if label in digest_runs else None, plan=plan)
            secs[label] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
        for label, twin in same.items():
            single[label] = single[twin]
        done = [f.result() for f in futures]
    for group, (outs, _) in zip(groups, done):
        for i, (tag, label, shape, _, _, _) in enumerate(group):
            _check_mesh_run(tag, label, shape, i, outs, single[label],
                            secs.get(label), logs.get(label),
                            label in digest_runs, label in exact_runs)
    return single, [o for o, _ in done], [t for _, t in done], secs


def _check_mesh_run(tag, label, shape, i, outs, want, secs, logs, digests,
                    exact) -> None:
    """``_mesh_vs_single``'s checks of run ``i`` of one start of ranks."""
    desc = _desc(shape)
    for r, per_rank in enumerate(outs):
        res = per_rank[i]
        if exact:
            got, ref = _dist_records(res), _dist_records(want)
            check([a["step"] for a in got] == [b["step"] for b in ref],
                  f"[{tag}] {desc} {label}: rank {r} logged steps "
                  f"{[a['step'] for a in got]}, the single device "
                  f"{[b['step'] for b in ref]}")
            for a, b in zip(got, ref):
                for key in ("loss", "grad_norm"):
                    rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
                    check(rel <= EXACT_REL,
                          f"[{tag}] {desc} {label}: rank {r}'s {key} "
                          f"{a[key]} vs {b[key]} beyond {EXACT_REL}")
            continue
        check(_dist_records(res) == _dist_records(want),
              f"[{tag}] {desc} {label}: rank {r}'s records differ from the "
              f"single device's: {_dist_records(res)} vs "
              f"{_dist_records(want)}")
        check(res["schedule"] == want["schedule"],
              f"[{tag}] {desc} {label}: rank {r}'s schedule differs")
        if digests:
            check(res["digests"] == want["block_digests"][desc][r],
                  f"[{tag}] {desc} {label}: rank {r}'s blocks of the final "
                  "state differ from the single device's")
    how = "within F8's relative 1e-3" if exact else "bitwise"
    extra = (", every rank's blocks of the final params and both moments "
             "by digests" if digests else "")
    took = f"single device {secs:.1f}s, " if secs is not None else ""
    print(f"[{tag}] {desc} {label}: losses "
          f"{[r['loss'] for r in want['records']]}, grad norms "
          f"{[r['grad_norm'] for r in want['records']]} {how} on every "
          f"rank{extra} ({took}rank 0 {outs[0][i]['seconds']:.1f}s, peak "
          f"GiB by rank {_peaks(outs, i)})", flush=True)
    if logs:
        v_single, v_mesh = (_tick_verdicts(f) for f in logs)
        check(v_single and v_single == v_mesh,
              f"[{tag}] {desc} {label}: the tick's verdicts differ")
        print(f"[{tag}] {desc} {label}: {len(v_single)} tick verdicts equal "
              f"({sum(e['event'] != 'ok' for e in v_single)} not ok), "
              f"schedule {want['schedule']}", flush=True)


def _peaks(outs, i) -> list:
    return [round(p[i].get("peak_bytes", 0) / 2**30, 2) for p in outs]


def phase_dist_train(dev, smi: str) -> dict:
    """Training over meshes of ranks sharing the card (gloo) against the
    single device on the same arguments, qwen2-1.5b at full width.

    ``[dist-train]``, ``--mesh 2x1``: ``DIST_LAYERS`` layers (the gloo
    traffic grows with depth), 2 steps (losses, grad norms, lrs, skip
    flags and loss scales bitwise; each rank's blocks of the final params
    and both moments by digests, two integer sums of their bits computed
    on the card, equal to the same blocks of the single device's state);
    2 steps at 2 layers with ``--microbatches 2 --loss-scaling`` and with
    an in-graph tick at step 2 (the same records, schedule and tick
    verdicts); SR under the mesh, ``--rounding sr --policy perturbed --pp
    -2`` at ``DIST_LAYERS`` layers, 2 steps, an in-graph tick at step 2
    (E's rows, B's and K9's K-slices and K8's FWD replay at their SR
    origins); the unfused oracle (``plan=oracle_plan``: K2 and K3 on the
    rows and K-slices) at 2 layers, 2 steps, an in-graph tick at step 2.

    ``[dist-model]``, the model axis: ``--mesh 1x2`` on the first run's
    arguments (each GEMM's output columns over the model axis, its
    K-slices over both ranks), in the same start of 2 ranks (``run_mesh``
    with a mesh a job); ``--mesh 2x2`` (4 ranks) at 2 layers, 2 steps: the
    predicted plan and ``--rounding sr`` with an eager tick at step 2 (G's
    SR forward on the rows, at their origins), bitwise, and ``--policy
    exact`` within 1e-3 relative (ROADMAP F8: cuBLAS's bits depend on the
    shape).

    The 2 ranks and the 4 start at once, beside the single-device runs
    (``_mesh_vs_single``); each rank's kernel counts are read over each
    run (from 0 at its start).  Prints each rank's peak memory and rank
    0's step times: not a speed figure, the ranks share one card through
    host memory, and the two starts share the host."""
    from repro_torch.launch import train as LT

    tick = ["--policy", "perturbed", "--pp", "-2", "--telemetry-cadence",
            "2", "--ingraph-telemetry"]
    two = ["--n-layers", "2", "--steps", "2"]
    depth = ["--n-layers", str(DIST_LAYERS)]
    sr = ["--rounding", "sr", "--sr-seed", str(TRAIN_SR_SEED)]
    first_label = f"{DIST_LAYERS} layers"
    t, m, s2 = "dist-train", "dist-model", DIST_SHAPE
    ranks2 = [(t, first_label, s2, _dist_argv(*depth), None, False),
              (t, "2 layers, --microbatches 2 --loss-scaling", s2,
               _dist_argv(*two, "--microbatches", "2", "--loss-scaling"),
               None, False),
              (t, "2 layers, in-graph tick at step 2", s2,
               _dist_argv(*two, *tick), None, True),
              (t, f"{DIST_LAYERS} layers, --rounding sr, in-graph tick at "
               "step 2", s2, _dist_argv(*depth, "--steps", "2", *tick, *sr),
               None, True),
              (t, "2 layers, the oracle, in-graph tick at step 2", s2,
               _dist_argv(*two, *tick), LT.oracle_plan, True),
              (m, f"{DIST_LAYERS} layers, the model axis", MODEL_SHAPE,
               _dist_argv(*depth), None, False)]
    eager_sr = ["--policy", "perturbed", "--pp", "-2", "--telemetry-cadence",
                "2", *sr]
    ranks4 = [(m, "2 layers, predicted", MESH_2X2, _dist_argv(*two), None,
               False),
              (m, "2 layers, --rounding sr, eager tick at step 2", MESH_2X2,
               _dist_argv(*two, *eager_sr), None, True),
              (m, "2 layers, --policy exact", MESH_2X2,
               _dist_argv(*two, "--policy", "exact"), None, False)]
    # the first single-device run, beside the ranks' start, serves the
    # 2x1 and 1x2 runs of its arguments
    single, (outs, outs4), (t2, t4), secs = _mesh_vs_single(
        [ranks2, ranks4], same={ranks2[-1][1]: first_label},
        digest_runs=[label for _, label, *_ in ranks2 + ranks4[:2]],
        exact_runs=[ranks4[2][1]])
    first, t_first = single[first_label], secs[first_label]
    n_leaves = len(first["block_digests"][_desc(DIST_SHAPE)][0])
    print(f"[dist-train] {n_leaves} leaves of params and moments compared "
          "by digests in each run", flush=True)
    main_l, tick_l = outs[0][0]["launches"], outs[0][2]["launches"]
    sr_l, or_l = outs[1][3]["launches"], outs[0][4]["launches"]
    m_l = outs[1][5]["launches"]
    # rank 3 of 2x2: the second batch rank and the second model rank
    l22 = outs4[-1][1]["launches"]
    for name in ("qmatmul_fused", E_NAME, "qmatmul_bwd_pair"):
        check(main_l[name] > 0, f"[dist-train] {name} was not launched")
        check(m_l[name] > 0, f"[dist-model] 1x2: {name} was not launched")
    check(tick_l[K9_NAME] > 0 and tick_l[K8_NAME] > 0,
          "[dist-train] the tick launched no K9 or K8")
    check(main_l[K7_NAME] == 0, "[dist-train] a dx carry entry ran")
    for name in (E_SR_NAME, B_SR_NAME, K8_SR_NAME, K9_SR_NAME):
        check(sr_l[name] > 0, f"[dist-train] sr: {name} was not launched "
              "on rank 1")
    check(sr_l[E_NAME] == 0, "[dist-train] sr: a layer GEMM ran RNE E")
    check(or_l[K2_NAME] > 0 and or_l[K3_NAME] > 0 and or_l[E_NAME] == 0
          and or_l["qmatmul_bwd_pair"] == 0,
          f"[dist-train] the oracle's launches are not K2 and K3: {or_l}")
    for name in (E_SR_NAME, B_SR_NAME, G_SR_NAME, K8_SR_NAME):
        check(l22[name] > 0, f"[dist-model] 2x2 sr: {name} was not "
              "launched on rank 3")
    print(f"[dist-train] launches on rank 0: {DIST_LAYERS} layers {main_l}; "
          f"tick run {tick_l}; on rank 1, the SR run {sr_l}; on rank 0, "
          f"the oracle run {or_l}", flush=True)
    print(f"[dist-model] launches on rank 1 of 1x2 {m_l}; on rank 3 of 2x2 "
          f"over the SR run {l22}", flush=True)
    step_ms = [1e3 * x for x in outs[0][0]["step_seconds"]]
    one_ms = [1e3 * x for x in first["step_seconds"]]
    new = sum(outs[0][i]["seconds"] for i in (3, 4, 5))
    print(f"[dist-train] {smi.strip()}: backend gloo (ranks share the "
          f"card); {DIST_LAYERS}-layer step ms on rank 0's host clock "
          f"{[round(x, 1) for x in step_ms]} (single device "
          f"{[round(x, 1) for x in one_ms]}); peak allocated GiB by rank "
          f"{_peaks(outs, 0)} at {DIST_LAYERS} layers (single device "
          f"{first.get('peak_bytes', 0) / 2**30:.2f}; at full depth 20.92 "
          f"against 34.62, PERF.md's record); the first single-device run "
          f"{t_first:.1f}s; the 2 ranks {t2:.1f}s for 6 runs and the 4 "
          f"{t4:.1f}s for 3, at once, beside the other single-device runs "
          f"(process starts included); of the 2 ranks' time, the SR, oracle "
          f"and 1x2 runs {new:.1f}s on rank 0; not a speed figure",
          flush=True)
    return dict(launches=main_l["qmatmul_bwd_pair"]
                + outs[0][1]["launches"]["qmatmul_bwd_pair"],
                k9_launches=tick_l[K9_NAME], step_ms=step_ms,
                sr_launches=sr_l, sr4_launches=l22)


def _desc(shape) -> str:
    from repro_torch.launch.mesh import Mesh

    return Mesh(dict(shape)).describe()


# --------------------------------------------------------------------------
# phase 12: the fused GEMM's last variants, quantize_outputs and A2Q
# --------------------------------------------------------------------------

G_OUT_NAME = "qmatmul_fused(out_fmt)"                   # G's epilogue
G_OUT_FOLD = "qmatmul_fused(out_fmt) fold"              # its split folds
G_OPERAND_NAME = "qmatmul_fused(a_packed/b_packed, quantize_a/b)"
E_OUT_NAME = "qmatmul_fused(return_quantized, out_fmt)"  # E's epilogue
E_F32_NAME = "qmatmul_fused(return_quantized, pack_residuals=False)"
K8_OUT_NAME = "qmatmul_fused(collect_stats, out_fmt)"
VAR_M = TRAIN_BATCH * TRAIN_SEQ         # E's, K8's and G's tile M: 512
R152, R169 = (5, 2), (6, 9)
TF32_FLOPS = 495e12      # tensor cores, TF32 operands: (1,6,9) fits them
# G's variants on both routes: at M = 8 (the decode route) on the layer's
# four distinct shapes, at M = 512 (the tile) on attn_q and attn_k
G_VARIANTS = {
    "out_fmt": dict(out_fmt=R152),
    "pack_out": dict(out_fmt=R152, pack_out=True),
    "packed": dict(a_packed=True, b_packed=True),
    "unquantized_b": dict(quantize_b=False),
    "unquantized_a_out": dict(quantize_a=False, out_fmt=R152),
}
E_VARIANTS = {
    "out_fmt": dict(out_fmt=R152),
    "pack_out": dict(out_fmt=R152, pack_out=True),
    "f32 residuals (1,5,2)": dict(pack_residuals=False),
    "f32 residuals (1,6,9)": dict(pack_residuals=False, repr_fmt=R169),
    "f32 residuals, pack_out": dict(pack_residuals=False, out_fmt=R152,
                                    pack_out=True),
}


def _var_counters():
    """The variants' launch counts, as ``_counters``."""
    from repro_torch.kernels.fused import qmatmul_fused as f

    return {G_OUT_NAME: (f, "out_launches"),
            G_OUT_FOLD: (f, "out_fold_launches"),
            G_OPERAND_NAME: (f, "operand_launches"),
            E_OUT_NAME: (f, "emitq_out_launches"),
            E_F32_NAME: (f, "emitq_f32_launches"),
            K8_OUT_NAME: (f, "stats_out_launches")}


def _codes(x):
    """int8 codes of ``x`` rounded to (1,5,2) (test operands)."""
    from repro_torch.kernels.common import quantize_block
    from repro_torch.quant.qtensor import pack_block

    return pack_block(quantize_block(x.float(), *R152), *R152)


def _k2(x, fmt=R152):
    """K2 on the card: the standalone rounding of ``x`` to ``fmt``."""
    from repro_torch.kernels.quantize import quantize

    return quantize(x, e=fmt[0], m=fmt[1])


def _check_epilogue(label, got, base, kw) -> None:
    """An ``out_fmt`` call's C against the same call without it: bitwise
    K2 of that C, and with ``pack_out`` bitwise ``pack_block`` of that."""
    from repro_torch.quant.qtensor import pack_block

    want = _k2(base, kw["out_fmt"])
    if kw.get("pack_out"):
        want = pack_block(want, *kw["out_fmt"])
    check(got.dtype == want.dtype and torch.equal(got, want),
          f"{label}: the epilogue is not K2 (and pack_block) of the call "
          "without it")


def _var_compare(label, got, want, kw, acc, lattice) -> float:
    """A variant's C against its plain version: int8 codes bitwise on
    lattice operands and decoded within 1 ulp of the output format on
    random ones; floats as ``compare``, in ulps of the output format (of
    the carry without one)."""
    from repro_torch.quant.qtensor import unpack_block

    fmt = kw.get("out_fmt") or acc
    if kw.get("pack_out"):
        check(got.dtype == torch.int8, f"{label}: pack_out gave {got.dtype}")
        if lattice:
            check(torch.equal(got, want), f"{label}: codes differ")
        got, want = unpack_block(got, *fmt), unpack_block(want, *fmt)
    return compare(label, got, want, fmt[1], fmt[0], bitwise=lattice,
                   quiet=True)


def _variant_operands(gen, dev, m, k, n, lattice):
    a = (_lattice(gen, (m, k), dev) if lattice
         else torch.randn((m, k), generator=gen, device=dev))
    w = (_lattice(gen, (k, n), dev) if lattice
         else torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k))
    return a, w.to(torch.bfloat16)


def _distinct_shapes(cfg):
    """(name, K, N, QDotConfig) of one layer's distinct GEMM shapes."""
    seen, out = set(), []
    for name, k, n, qc in gemm_shapes(cfg)[:-1]:
        if (k, n) not in seen:
            seen.add((k, n))
            out.append((name, k, n, qc))
    return out


def _variant_checks(cfg, dev) -> float:
    """Every variant of G (both routes where it runs), E and K8 against
    its plain version on lattice and random operands under RNE and SR;
    each epilogue bitwise K2 (and ``pack_block``) of the call without it,
    and K8's row bitwise the same with and without it.  Returns the
    largest |error| on random operands."""
    from repro_torch.kernels import sm90
    from repro_torch.kernels.common import stats_gap
    from repro_torch.kernels.fused import (qmatmul_fused,
                                           qmatmul_fused_reference,
                                           qmatmul_fused_stats_reference,
                                           qmatmul_fused_with)

    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    shapes = _distinct_shapes(cfg)
    max_err, n_checks = 0.0, 0
    for m, cases in ((MAX_BATCH, shapes), (VAR_M, shapes[:2])):
        for name, k, n, qc in cases:
            for rounding in ("rne", "sr"):
                kw = dict(_gemm_kw(qc), rounding=rounding,
                          sr_seed=TRAIN_SR_SEED)
                acc = (qc.fwd.e_acc, qc.fwd.m_acc)
                for lattice in (True, False):
                    a, w = _variant_operands(gen, dev, m, k, n, lattice)
                    base = qmatmul_fused(a, w, **kw)
                    for vname, vkw in G_VARIANTS.items():
                        packed = "a_packed" in vkw
                        aa, ww = (_codes(a), _codes(w)) if packed else (a, w)
                        want = qmatmul_fused_reference(aa, ww, **kw, **vkw)
                        kinds = (2, 2) if packed else (0, 1)
                        scheds = [sm90.gemm_schedule(m, n, k, kw["block_k"],
                                                     *kinds, stats=False)]
                        dec = sm90.decode_schedule(m, n, k, kw["block_k"], 1)
                        if not packed and dec is not None:
                            scheds.append(dec)
                        label = (f"G {vname} {name} M={m} {rounding} "
                                 f"{'lattice' if lattice else 'random'}")
                        for s in scheds:
                            got = qmatmul_fused_with(aa, ww, s, **kw, **vkw)
                            err = _var_compare(f"{label} {type(s).__name__}",
                                               got, want, vkw, acc, lattice)
                            max_err = max(max_err, 0 if lattice else err)
                            n_checks += 1
                        routed = qmatmul_fused(aa, ww, **kw, **vkw)
                        check(any(torch.equal(routed, qmatmul_fused_with(
                            aa, ww, s, **kw, **vkw)) for s in scheds),
                            f"{label}: qmatmul_fused left its routes")
                        if "out_fmt" in vkw and "quantize_a" not in vkw:
                            _check_epilogue(label, routed, base, vkw)
                    if m != VAR_M:
                        continue
                    # E at the training M: every variant, and its epilogue
                    # against the base E call; then K8 with out_fmt
                    ekw = dict(kw, return_quantized=True)
                    c0, xq0, wq0 = qmatmul_fused(a, w, **ekw)
                    for vname, vkw in E_VARIANTS.items():
                        vkw = dict(vkw)
                        rf = vkw.pop("repr_fmt", None)
                        vk = dict(ekw, **vkw) if rf is None else dict(
                            ekw, **vkw, repr_fmt=rf)
                        c, xq, wq = qmatmul_fused(a, w, **vk)
                        pc, pxq, pwq = qmatmul_fused_reference(a, w, **vk)
                        label = (f"E {vname} {name} {rounding} "
                                 f"{'lattice' if lattice else 'random'}")
                        check(torch.equal(xq, pxq) and torch.equal(wq, pwq),
                              f"{label}: residuals differ from plain")
                        check(xq.dtype == (torch.int8 if vkw.get(
                            "pack_residuals", True) else torch.float32),
                            f"{label}: residuals of {xq.dtype}")
                        err = _var_compare(label, c, pc, vkw, acc, lattice)
                        max_err = max(max_err, 0 if lattice else err)
                        n_checks += 1
                        if rf is None and "out_fmt" in vkw:
                            _check_epilogue(label, c, c0, vkw)
                        if rf is None and "out_fmt" not in vkw:
                            check(torch.equal(c, c0), f"{label}: C differs "
                                  "from the packed call's")
                    skw = dict(kw, collect_stats=True)
                    for kinds, (aa, ww) in (((2, 2), (xq0, wq0)),
                                            ((0, 1), (a, w))):
                        pk = dict(a_packed=kinds[0] == 2,
                                  b_packed=kinds[1] == 2)
                        b0, row0 = qmatmul_fused(aa, ww, **pk, **skw)
                        for pack in (False, True):
                            vkw = dict(out_fmt=R152, pack_out=pack)
                            c, row = qmatmul_fused(aa, ww, **pk, **skw, **vkw)
                            pc, prow = qmatmul_fused_stats_reference(
                                aa, ww, **pk, **kw, **vkw)
                            label = (f"K8 out_fmt pack_out={pack} kinds "
                                     f"{kinds} {name} {rounding} "
                                     f"{'lattice' if lattice else 'random'}")
                            err = _var_compare(label, c, pc, vkw, acc,
                                               lattice)
                            max_err = max(max_err, 0 if lattice else err)
                            check(torch.equal(row, row0),
                                  f"{label}: the stats row moved")
                            exact, ratio = stats_gap(row, prow)
                            check(exact and ratio <= 1.0,
                                  f"{label}: stats row differs from plain")
                            _check_epilogue(label, c, b0, vkw)
                            n_checks += 1
    print(f"[variants] {n_checks} variant calls against their plain versions "
          f"(G on both routes at M = {MAX_BATCH} and {VAR_M}, E and K8 at "
          f"M = {VAR_M}; lattice bitwise, random max |err| {max_err:.3g}); "
          f"every epilogue bitwise K2 (and pack_block) of the call without "
          f"it; K8's rows unchanged by out_fmt", flush=True)
    return max_err


def _replay_pair(label, run, base_run, n_bytes, flops, peak, plain_run,
                 lib_run) -> dict:
    """A variant's sequence and its base sequence on the same inputs, each
    by CUDA-graph replay (median [spread] of ``lib_time``), the plain
    version's eager time, the bf16 library yardstick and the bound."""
    var = lib_time(run)
    base = lib_time(base_run)
    plain = cuda_time(plain_run, reps=1, warmup=0)
    lib = lib_time(lib_run)
    b_ms, b_by = bound_ms(n_bytes, flops, peak)
    print(f"[variants] {label}: {lib_str(var)} by graph replay against the "
          f"base {lib_str(base)} ({var[0] / base[0]:.3f}x); plain "
          f"{plain:.1f} ms; bf16 torch.matmul {lib_str(lib)}; bound "
          f"{b_ms:.4f} ms ({b_by}), {b_ms / var[0]:.3f} of it", flush=True)
    return dict(ms=var[0], spread_ms=list(var[1]), base_ms=base[0],
                base_spread_ms=list(base[1]), plain_ms=plain,
                library_ms=lib[0], library_spread_ms=list(lib[1]),
                bound_ms=b_ms, bound_by=b_by)


def phase_variants(cfg, dev) -> dict:
    """``[variants]``: the fused GEMM's last variants on the card.  Checks
    (``_variant_checks``), then each variant timed by CUDA-graph replay
    beside its base call on the same inputs: G's epilogue over one layer's
    7 GEMMs and the decode step's 197 GEMMs at M = 8 (``out_fmt``,
    ``pack_out``), G's operand variants (int8 codes at M = 512 on the
    tile, an unquantized operand at M = 8), and one layer's 7 calls at M =
    512 of E with the epilogue, E with f32 residuals at (1,5,2) and
    (1,6,9), and K8 with the epilogue on E's codes."""
    from repro_torch.kernels.fused import (qmatmul_fused,
                                           qmatmul_fused_reference,
                                           qmatmul_fused_stats_reference)

    t0 = time.perf_counter()
    max_err = _variant_checks(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    shapes = gemm_shapes(cfg)
    layer = shapes[:-1]
    calls8 = [(torch.randn((MAX_BATCH, k), generator=gen, device=dev),
               (torch.randn((k, n), generator=gen, device=dev)
                / math.sqrt(k)).to(torch.bfloat16), _gemm_kw(qc))
              for _ in range(cfg.n_layers) for _, k, n, qc in layer]
    # the decode step's lm_head: the tied embedding's transposed view, which
    # the quantize_outputs plan leaves without an output format
    _, hk, hn, hqc = shapes[-1]
    head = (torch.randn((MAX_BATCH, hk), generator=gen, device=dev),
            (torch.randn((hn, hk), generator=gen, device=dev)
             / math.sqrt(hk)).to(torch.bfloat16).T, _gemm_kw(hqc))
    calls512 = [(torch.randn((VAR_M, k), generator=gen, device=dev),
                 (torch.randn((k, n), generator=gen, device=dev)
                  / math.sqrt(k)).to(torch.bfloat16), _gemm_kw(qc))
                for _, k, n, qc in layer]
    out = {}
    counters = _var_counters()

    def seq(calls, fn, **extra):
        def run():
            for a, w, kw in calls:
                fn(a, w, **kw, **extra)
        return run

    def lib_seq(calls):
        return seq(calls, lambda a, w, **kw: torch.matmul(
            a.to(torch.bfloat16), w.to(torch.bfloat16)))

    def g_bytes(calls, a_bytes=4, w_bytes=2, c_bytes=4):
        return sum(a.shape[0] * a.shape[1] * a_bytes + w.numel() * w_bytes
                   + a.shape[0] * w.shape[1] * c_bytes for a, w, _ in calls)

    def flops(calls):
        return sum(2 * a.shape[0] * a.shape[1] * w.shape[1]
                   for a, w, _ in calls)

    lay8 = calls8[:len(layer)]
    # G's epilogue: one layer's 7 (the entry), then the decode step's 197
    g_out = _replay_pair(
        f"G out_fmt, one layer's {len(lay8)} GEMMs at M={MAX_BATCH}",
        seq(lay8, qmatmul_fused, out_fmt=R152), seq(lay8, qmatmul_fused),
        g_bytes(lay8), flops(lay8), BF16_FLOPS,
        seq(lay8, qmatmul_fused_reference, out_fmt=R152), lib_seq(lay8))
    step_calls = calls8 + [head]

    def with_out(**extra):
        return [(a, w, dict(kw, **extra)) for a, w, kw in calls8] + [head]

    step = lib_time(seq(with_out(out_fmt=R152), qmatmul_fused))
    step_pack = lib_time(seq(with_out(out_fmt=R152, pack_out=True),
                             qmatmul_fused))
    step_base = lib_time(seq(step_calls, qmatmul_fused))
    sb, sby = bound_ms(g_bytes(step_calls), flops(step_calls), BF16_FLOPS)
    print(f"[variants] G the decode step's {len(step_calls)} GEMMs at "
          f"M={MAX_BATCH} by graph replay ({len(calls8)} with the epilogue, "
          f"the lm_head without, as the quantize_outputs plan runs them): "
          f"out_fmt {lib_str(step)}, pack_out {lib_str(step_pack)}, base "
          f"{lib_str(step_base)} ({step[0] / step_base[0]:.3f}x, "
          f"{step_pack[0] / step_base[0]:.3f}x); bound {sb:.4f} ms ({sby})",
          flush=True)
    g_out.update(step_ms=step[0], step_pack_ms=step_pack[0],
                 step_base_ms=step_base[0], step_bound_ms=sb,
                 step_gemms=len(step_calls))
    out["G_out"] = g_out
    # G's operand variants: int8 codes of E's residual layout on the tile
    codes = [(_codes(a), _codes(w), kw) for a, w, kw in calls512]
    pk = dict(a_packed=True, b_packed=True)
    zero_counts(counters)
    seq(codes, qmatmul_fused, **pk)()
    torch.cuda.synchronize()
    op_launches = read_counts(counters)[G_OPERAND_NAME]
    g_op = _replay_pair(
        f"G int8-code operands, one layer's {len(codes)} GEMMs at M={VAR_M} "
        "(the tile), base G on the f32 x and bf16 w",
        seq(codes, qmatmul_fused, **pk), seq(calls512, qmatmul_fused),
        g_bytes(codes, 1, 1), flops(codes), FP8_FLOPS,
        seq(codes, qmatmul_fused_reference, **pk), lib_seq(calls512))
    unq = lib_time(seq(lay8, qmatmul_fused, quantize_a=False))
    print(f"[variants] G with x unquantized, one layer's {len(lay8)} GEMMs at "
          f"M={MAX_BATCH}: {lib_str(unq)} ({unq[0] / g_out['base_ms']:.3f}x "
          f"the base)", flush=True)
    g_op.update(launches=op_launches, unquantized_ms=unq[0])
    out["G_operand"] = g_op
    # E's epilogue and f32 residuals, one layer's 7 calls at M = 512
    def e_bytes(res_bytes, c_bytes=4):
        return sum(a.numel() * 4 + w.numel() * 2 + a.shape[0] * w.shape[1]
                   * c_bytes + (a.numel() + w.numel()) * res_bytes
                   for a, w, _ in calls512)

    eq = dict(return_quantized=True)
    out["E_out"] = _replay_pair(
        f"E out_fmt, one layer's {len(calls512)} calls at M={VAR_M}",
        seq(calls512, qmatmul_fused, **eq, out_fmt=R152),
        seq(calls512, qmatmul_fused, **eq), e_bytes(1), flops(calls512),
        FP8_FLOPS, seq(calls512, qmatmul_fused_reference, **eq,
                       out_fmt=R152), lib_seq(calls512))
    f32 = dict(eq, pack_residuals=False)
    out["E_f32"] = _replay_pair(
        f"E f32 residuals (1,5,2), one layer's {len(calls512)} calls at "
        f"M={VAR_M}",
        seq(calls512, qmatmul_fused, **f32), seq(calls512, qmatmul_fused, **eq),
        e_bytes(4), flops(calls512), FP8_FLOPS,
        seq(calls512, qmatmul_fused_reference, **f32), lib_seq(calls512))
    wide = [(a, w, dict(kw, repr_fmt=R169)) for a, w, kw in calls512]
    w169 = _replay_pair(
        f"E f32 residuals (1,6,9), one layer's {len(wide)} calls at "
        f"M={VAR_M}, beside the base E at (1,5,2)",
        seq(wide, qmatmul_fused, **f32), seq(calls512, qmatmul_fused, **eq),
        e_bytes(4), flops(wide), TF32_FLOPS,
        seq(wide, qmatmul_fused_reference, **f32), lib_seq(calls512))
    out["E_f32"]["wide_ms"] = w169["ms"]
    out["E_f32"]["wide_bound_ms"] = w169["bound_ms"]
    # K8's epilogue on E's codes (the in-graph FWD replay's operands)
    codes8 = [(c[0], c[1], dict(kw, quantize_a=False, quantize_b=False,
                                a_packed=True, b_packed=True,
                                collect_stats=True)) for c, (_, _, kw) in
              zip(codes, calls512)]
    zero_counts(counters)
    seq(codes8, qmatmul_fused, out_fmt=R152)()
    torch.cuda.synchronize()
    k8_launches = read_counts(counters)[K8_OUT_NAME]

    def k8_plain(a, w, **kw):
        kw = {k_: v for k_, v in kw.items() if k_ != "collect_stats"}
        return qmatmul_fused_stats_reference(a, w, **kw)

    out["K8_out"] = _replay_pair(
        f"K8 out_fmt on E's codes, one layer's {len(codes8)} calls at "
        f"M={VAR_M}",
        seq(codes8, qmatmul_fused, out_fmt=R152), seq(codes8, qmatmul_fused),
        g_bytes(codes8, 1, 1), flops(codes8), FP8_FLOPS,
        seq(codes8, k8_plain, out_fmt=R152), lib_seq(calls512))
    out["K8_out"]["launches"] = k8_launches
    for v in out.values():
        v["max_abs_err"] = max_err
    print(f"[variants] phase {time.perf_counter() - t0:.1f}s", flush=True)
    return out


# ---------------------------------------------------------- quantize_outputs

# Six steps, as the train cell's: over JAX's SyntheticLM batches the loss
# under (1,5,2) activations rises over the first three (12.410, 12.398,
# 12.419, the same bits under REPRO_REMAT_POLICY none and full) and
# falls by the sixth (12.089)
QOUT_STEPS = 6
QOUT_SERVE = 2          # requests of the 2-layer kernels-vs-plain serve run
QOUT_SERVE_GEN = 4


@contextmanager
def quantize_outputs_policy():
    """The training launcher's set-up under ``AccumulationPolicy(
    quantize_outputs=True)``: neither launcher has a flag for it, so the
    launcher's policy is wrapped (the path is reached through the API, as
    the JAX package's tests reach it)."""
    from repro_torch.launch import train as L

    orig = L._policy
    L._policy = lambda args: dataclasses.replace(orig(args),
                                                 quantize_outputs=True)
    try:
        yield
    finally:
        L._policy = orig


def _qout_cfg(cfg, seq, batch, **policy):
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model

    return plan_for_model(cfg, seq_len=seq, global_batch=batch,
                          policy=AccumulationPolicy(
                              mode="predicted", chunk=64,
                              quantize_outputs=True, **policy))


def phase_qout_train(dev, rne_step_ms: float, rne_profile=None) -> dict:
    """``[qout]`` training: the train cell at full width and depth through
    the launcher's set-up under quantize_outputs, ``QOUT_STEPS`` steps:
    the loss falls, E runs with its epilogue (196 launches a forward pass,
    392 a step under the default remat, the base E none) and every dense
    forward output of the first step, the recompute's included, lies on
    the (1,5,2) lattice.  One more step is profiled, and its kernels are
    set beside the RNE step's profile (``rne_profile``): the kernels whose
    device time moved most."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build
    from repro_torch.models.lm import layer_forwards
    from repro_torch.quant.formats import FP8_152
    from repro_torch.train.loop import make_train_step

    args = _train_args("--steps", str(QOUT_STEPS))
    with quantize_outputs_policy():
        model, tc, state, data, _ = build(args)
    q = model.cfg.quant
    check(q.attn_qkv.out_fmt == FP8_152 and q.lm_head.out_fmt is None,
          "quantize_outputs did not set the plan's out_fmt")
    step_fn = make_train_step(model, tc)
    counters = {**_train_counters(), **_var_counters()}
    real = ops.qmatmul_fused
    on_lattice = []
    # 196 at full depth, each forward pass (the recompute included)
    n_dense = 7 * model.cfg.n_layers * layer_forwards(model.cfg)

    def spy(*a, **kw):
        out = real(*a, **kw)
        if kw.get("out_fmt") is not None:
            y = out[0] if isinstance(out, tuple) else out
            on_lattice.append(bool(torch.equal(_k2(y), y)))
        return out

    losses, times, launches = [], [], []
    for step in range(QOUT_STEPS):
        batch = next(data)
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.qmatmul_fused = spy if step == 0 else real
        try:
            state, m = step_fn(state, batch)
        finally:
            ops.qmatmul_fused = real
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        used = read_counts(counters)
        losses.append(loss)
        launches.append(used)
        print(f"[qout] train step {step + 1}: loss {loss:.5f}, "
              f"{times[-1]:.1f} ms (RNE step without the epilogue "
              f"{rne_step_ms:.1f} ms), launches {E_OUT_NAME} "
              f"{used[E_OUT_NAME]}, {E_NAME} {used[E_NAME]}, G "
              f"{used['qmatmul_fused']}, B {used['qmatmul_bwd_pair']}",
              flush=True)
        check(math.isfinite(loss), "quantize_outputs: non-finite loss")
        check(used[E_OUT_NAME] == n_dense and used[E_NAME] == 0,
              f"quantize_outputs step: E's epilogue launched "
              f"{used[E_OUT_NAME]} times, the base E {used[E_NAME]}")
    check(losses[-1] < losses[0], f"quantize_outputs: loss did not fall "
          f"({losses})")
    check(len(on_lattice) == n_dense and all(on_lattice),
          f"{len(on_lattice)} dense outputs seen, "
          f"{sum(on_lattice)} on the (1,5,2) lattice")
    print(f"[qout] train: {QOUT_STEPS} full-depth steps, loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; all {n_dense} dense forward "
          f"outputs of step 1 on the (1,5,2) lattice; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    prof = _profile_step(step_fn, state, next(data), min(times[1:]),
                         tag="[qout] train")
    if prof is not None and rne_profile is not None:
        keys = set(prof) | set(rne_profile)
        delta = sorted(((prof.get(k, 0.0) - rne_profile.get(k, 0.0), k)
                        for k in keys), key=lambda d: -abs(d[0]))
        print(f"[qout] train profile against the RNE step's: kernels "
              f"{sum(prof.values()):.1f} ms against "
              f"{sum(rne_profile.values()):.1f} ms, steady step "
              f"{min(times[1:]):.1f} ms against {rne_step_ms:.1f} ms; the "
              f"kernels that moved most:", flush=True)
        for d, k in delta[:8]:
            print(f"  qout-rne {d:+9.3f} ms ({prof.get(k, 0.0):.3f} against "
                  f"{rne_profile.get(k, 0.0):.3f}) {k[:90]}", flush=True)
    del state, step_fn
    return dict(launches=sum(u[E_OUT_NAME] for u in launches),
                step_ms=times, losses=losses)


def phase_qout_vs_plain(dev) -> dict:
    """``[qout]`` at 2 layers (full width, batch 2 x seq 64): one step
    under quantize_outputs through the kernels, then through their plain
    versions, bitwise (loss and every gradient); and the same step with
    ``pack_residuals=False`` (E's f32 residuals, B on them) bitwise the
    packed one."""
    from repro_torch.models.api import get_model
    from repro_torch.models.lm import layer_forwards
    from repro_torch.train.loop import _grads, compute_copy
    from repro_torch.train.optimizer import tree_leaves

    cfg = _qout_cfg(_base_cfg(2), TRAIN_SEQ, 2)
    f32_plan = dataclasses.replace(cfg.quant, **{
        f: dataclasses.replace(getattr(cfg.quant, f), pack_residuals=False)
        for f in ("attn_qkv", "attn_out", "mlp_up", "mlp_down")})
    cfg_f32 = dataclasses.replace(cfg, quant=f32_plan)
    gen = torch.Generator(device=dev).manual_seed(SEED + 47)
    model = get_model(cfg)
    params = model.init_params(gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, TRAIN_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)

    def step(c):
        m = get_model(c)
        cc = compute_copy(params)
        loss, _ = m.loss_fn(cc, {"tokens": tokens}, c)
        loss.backward()
        return loss.detach(), _grads(cc, params)

    counters = {**_train_counters(), **_var_counters()}
    zero_counts(counters)
    lk, gk = step(cfg)
    used = read_counts(counters)
    zero_counts(counters)
    lf, gf = step(cfg_f32)
    used_f32 = read_counts(counters)
    with plain_versions():
        t0 = time.perf_counter()
        lp, gp = step(cfg)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    out = {}
    for label, (l2, g2) in (("plain", (lp, gp)), ("f32 residuals", (lf, gf))):
        leaves = list(zip(tree_leaves(gk), tree_leaves(g2)))
        same = sum(bool(torch.equal(a, b)) for a, b in leaves)
        print(f"[qout] 2 layers, kernels vs {label}: loss {float(lk):.6f} "
              f"vs {float(l2):.6f}; {same}/{len(leaves)} gradient leaves "
              f"bitwise equal", flush=True)
        check(torch.equal(lk, l2), f"[qout] loss differs from {label}")
        check(same == len(leaves), f"[qout] a gradient differs from {label}")
    print(f"[qout] launches packed {used[E_OUT_NAME]} E with the epilogue, "
          f"f32 residuals {used_f32[E_F32_NAME]} E with f32 residuals; plain "
          f"step {plain_s:.1f} s", flush=True)
    n_e = 14 * layer_forwards(cfg)      # 2 layers' 7 GEMMs, each pass
    check(used[E_OUT_NAME] == n_e and used_f32[E_F32_NAME] == n_e,
          f"[qout] E variants launched {used[E_OUT_NAME]} and "
          f"{used_f32[E_F32_NAME]} times")
    out["f32_launches"] = used_f32[E_F32_NAME]
    return out


def _base_cfg(n_layers=None):
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-1.5b")
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def phase_qout_serve(params, dev, prompts, one_shot) -> dict:
    """``[qout]`` serving: the serve cell's prompts at full depth under
    the quantize_outputs plan (G's epilogue on the 196 layer GEMMs of every
    step, the base G on the lm_head; launches counted); at 2 layers, the
    tokens and the arena through the kernels bitwise the plain path; one
    ``qdot_packed`` per decode shape bitwise ``QTensor.pack`` of the plain
    rounding."""
    from repro_torch.kernels.fused import qmatmul_fused_reference
    from repro_torch.kernels.ops import qdot_packed
    from repro_torch.quant.qtensor import QTensor
    from repro_torch.train.optimizer import tree_map

    max_ctx = max(PROMPT_LENS) + GEN
    cfg = _qout_cfg(_base_cfg(), max_ctx, len(PROMPT_LENS))
    counters = {**_counters(), **_var_counters()}
    eng = build_engine(cfg, params, dev, None)
    rids = [eng.submit(p, GEN) for p in prompts]
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    used = read_counts(counters)
    ex = eng.executor
    print(f"[qout] serve one-shot, full depth: {eng.decoded_tokens} decoded "
          f"tokens in {dt:.3f} s (decode steps {ex.decode_s:.3f} s; the RNE "
          f"plan's one-shot run {one_shot['decode_s']:.3f} s); launches "
          f"{used}", flush=True)
    check(used[G_OUT_NAME] > 0 and used["qmatmul_fused"] > 0,
          "[qout] serving launched no G epilogue or no base G (lm_head)")
    check(all(len(res[r]) == GEN and all(0 <= t < cfg.vocab_size
                                         for t in res[r]) for r in rids),
          "[qout] serving: a short or out-of-range stream")
    same = sum(res[r] == s for r, s in zip(rids, one_shot["streams"]))
    print(f"[qout] {same}/{len(rids)} streams equal the RNE plan's (the "
          f"outputs are rounded to (1,5,2), so they may part)", flush=True)
    eng.pool.check_invariants()
    g_launches = used[G_OUT_NAME]
    del eng
    # 2 layers: kernels vs plain, tokens and the arena
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = {k: (tree_map(lambda t: t[:2], v) if k == "layers" else v)
               for k, v in params.items()}
    runs = []
    for plain in (False, True):
        e2 = build_engine(cfg2, params2, dev, None)
        r2 = [e2.submit(p, QOUT_SERVE_GEN) for p in prompts[:QOUT_SERVE]]
        if plain:
            with plain_versions():
                out2 = e2.run()
        else:
            out2 = e2.run()
        runs.append(([out2[r] for r in r2],
                     {k: v.clone() for k, v in e2.executor.kv.items()}))
    (tk, ak), (tp, ap) = runs
    arena_same = all(torch.equal(ak[k], ap[k]) for k in ak)
    print(f"[qout] serve at 2 layers, {QOUT_SERVE} requests x "
          f"{QOUT_SERVE_GEN} tokens: kernels vs plain tokens "
          f"{'equal' if tk == tp else 'DIFFERENT'}, arena "
          f"{'bitwise' if arena_same else 'DIFFERENT'}", flush=True)
    check(tk == tp and arena_same, "[qout] serving differs from plain")
    # qdot_packed at each decode shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    for name, k, n, qc in gemm_shapes(cfg)[:-1]:
        x = torch.randn((MAX_BATCH, k), generator=gen, device=dev)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        qt = qdot_packed(x, w, qc)
        want = QTensor.pack(qmatmul_fused_reference(x, w, **_gemm_kw(qc)),
                            qc.out_fmt)
        check(torch.equal(qt.payload, want.payload),
              f"[qout] qdot_packed {name} differs from QTensor.pack")
    print(f"[qout] qdot_packed at the {len(gemm_shapes(cfg)) - 1} decode "
          f"shapes bitwise QTensor.pack of the plain rounding", flush=True)
    return dict(launches=g_launches)


# ---------------------------------------------------------------------- a2q

A2Q_STEPS = 3


def _adversarial_x(w: np.ndarray, x_bound: float, rng, mode: str):
    """tests/test_a2q.py's worst-case bounded input for max |x @ w|."""
    col = int(np.argmax(np.abs(w).sum(0)))
    if mode == "aligned":
        return (np.sign(w[:, col]) * x_bound).astype(np.float32)[None, :]
    if mode == "anti":
        return (-np.sign(w[:, col]) * x_bound).astype(np.float32)[None, :]
    return (rng.choice([-1.0, 1.0], size=(4, w.shape[0])) * x_bound *
            rng.uniform(0.5, 1.0, size=(4, w.shape[0]))).astype(np.float32)


def phase_a2q(dev) -> dict:
    """``[a2q]``: ``launch/train.py --policy predicted --a2q-reg 1e-4
    --a2q-x-bound 16`` at full width and depth through the launcher's
    set-up, ``A2Q_STEPS`` steps, the certificate ok after each; the
    launcher's refusal under ``--policy exact``; then the adversarial
    check of ``tests/test_a2q.py`` through K8 on the card under RNE and
    SR: projected weights keep STAT_MAX_ABS below the clamp, weights 4x
    over the cap trip it."""
    from repro_torch.core.policy import GEMMPrecision
    from repro_torch.launch.train import build, parse_args
    from repro_torch.telemetry.stats import gemm_stats
    from repro_torch.train import optimizer as O
    from repro_torch.train.loop import make_train_step

    t0 = time.perf_counter()
    args = _train_args("--steps", str(A2Q_STEPS), "--a2q-reg", "1e-4",
                       "--a2q-x-bound", "16")
    model, tc, state, data, _ = build(args)
    check(tc.a2q is not None and tc.a2q.strength == 1e-4,
          "--a2q-reg set no A2Q constraint")
    step_fn = make_train_step(model, tc)
    for step in range(A2Q_STEPS):
        state, m = step_fn(state, next(data))
        cert = O.a2q_certificate(state["params"], tc.a2q)
        loss = float(m["loss"])
        print(f"[a2q] launcher step {step + 1}: loss {loss:.5f}, certificate "
              f"{cert}", flush=True)
        check(math.isfinite(loss) and cert["ok"],
              f"[a2q] step {step + 1}: certificate {cert}")
    del state, step_fn
    try:
        build(parse_args(_train_argv("--policy", "exact", "--a2q-reg",
                                     "1e-4")))
        fail("[a2q] --a2q-reg under --policy exact was not refused")
    except SystemExit:
        pass
    torch.cuda.empty_cache()
    cfg = O.A2QConfig(e_acc=4, m_acc=9, x_bound=4.0, margin_bits=1,
                      strength=1e-3)
    acc_max = O.acc_format_max(cfg.e_acc, cfg.m_acc)
    prec = GEMMPrecision(m_acc=cfg.m_acc, e_acc=cfg.e_acc, chunk=32)

    def max_carry(x, w, rounding="rne", seed=0):
        _, st = gemm_stats(torch.from_numpy(x).to(dev), w, precision=prec,
                           rounding=rounding, sr_seed=seed)
        return float(st.max_abs)

    for rounding in ("rne", "sr"):
        rng = np.random.RandomState(0)
        worst = 0.0
        for trial in range(12):
            k, n = int(rng.randint(16, 257)), int(rng.randint(4, 49))
            scale = float(rng.uniform(0.5, 20.0))
            w = torch.from_numpy(rng.standard_normal((k, n)).astype(
                np.float32) * scale).to(dev)
            wp = O.a2q_project({"w": w}, cfg)["w"]
            check(O.a2q_certificate({"w": wp}, cfg)["ok"],
                  "[a2q] a projected weight is not certified")
            for mode in ("aligned", "anti", "random"):
                x = _adversarial_x(wp.cpu().numpy(), cfg.x_bound, rng, mode)
                worst = max(worst, max_carry(x, wp, rounding, trial))
        rng = np.random.RandomState(1)
        tripped = 0
        for _ in range(6):
            k, n = int(rng.randint(64, 257)), int(rng.randint(4, 33))
            w = torch.from_numpy(rng.standard_normal((k, n)).astype(
                np.float32)).to(dev)
            wp = O.a2q_project({"w": w}, cfg)["w"] * 4.0
            x = _adversarial_x(wp.cpu().numpy(), cfg.x_bound, rng, "aligned")
            tripped += max_carry(x, wp, rounding) >= acc_max
        print(f"[a2q] adversarial through K8, {rounding}: projected weights' "
              f"largest STAT_MAX_ABS {worst} < clamp {acc_max} over 36 "
              f"inputs; weights 4x over the cap trip it {tripped}/6",
              flush=True)
        check(worst < acc_max, f"[a2q] {rounding}: a certified carry reached "
              "the clamp")
        check(tripped == 6, f"[a2q] {rounding}: unprojected weights tripped "
              f"{tripped}/6")
    print(f"[a2q] phase {time.perf_counter() - t0:.1f}s", flush=True)
    return {}


# Seconds spent in each phase (a nested phase's time also counts in its
# caller's), printed before the result: where the script's time limit goes
# --------------------------------------------------------------------------
# [families]: the paged half of the other model families (MoE, qk-norm, the
# VLM stub), at their published widths
# --------------------------------------------------------------------------

MOE_ARCH = "moonshot-v1-16b-a3b"
# moe-serve: 8 of moonshot's 48 layers (5.37 B parameters, a 21.5 GB f32
# draw; 48 would need 115.6 GB); moe-train: 2 layers (1.85 B parameters,
# about 30 GB of masters, moments, bf16 copy and gradients at 16 bytes a
# parameter; 4 would be about 48 GB before activations); its plain-version
# step at 1 layer (the plain expert GEMMs run one launch a k)
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS, MOE_PLAIN_LAYERS = 8, 2, 1
MOE_TRAIN_STEPS = 3
QK_ARCH = "qwen3-8b"                     # full depth: 36 layers, 8.19 B
VLM_ARCH = "internvl2-2b"
VLM_LAYERS, VLM_SEQ, VLM_BATCH, VLM_STEPS = 2, 512, 2, 2
# the expert GEMMs: moonshot's gate/up and down, at the capacities of a
# decode step (8 rows: 1), a 64-token slab (7) and the train cell (60)
EXPERT_GEMMS = (("gate", 2048, 1408), ("up", 2048, 1408),
                ("down", 1408, 2048))
EXPERT_CAPS = (1, 7, 60)
G_EXPERT_NAME = "qmatmul_fused (MoE experts)"
B_EXPERT_NAME = "qmatmul_bwd_pair (MoE experts)"
EXPERT_KW = dict(repr_fmt=None, e_acc=8, m_acc=23, block_k=128)
EXPERT_B_KW = dict(repr_fmt=None, bwd_acc=(8, 23), grad_acc=(8, 23),
                   bwd_chunk=128, grad_chunk=128, packed=False,
                   quantize_g=False)


def _bf16_draw(model, seed: int, dev):
    """``model``'s seeded float32 parameters as bf16, a leaf at a time (the
    float32 leaf freed once cast), as the serving launcher holds them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(gen, dev)

    def cast(tree):
        for k, v in list(tree.items()):
            if isinstance(v, dict):
                cast(v)
            elif v.dtype == torch.float32:
                tree[k] = v.to(torch.bfloat16)
                del v
        return tree

    return cast(params)


@contextmanager
def counting_experts(counts: dict):
    """Count the G and B launches the MoE expert MLPs make (the wrappers'
    counters read around each ``_moe_expert_mlp_fused`` call and its
    backward): ``counts["G"]``, ``counts["B"]``."""
    from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
    from repro_torch.kernels.fused import qmatmul_fused
    from repro_torch.models import layers as L

    inner = L._moe_expert_mlp_fused
    counts.setdefault("G", 0)
    counts.setdefault("B", 0)

    class _Marks(torch.autograd.Function):
        """Identity whose backward reads B's counter at its two ends."""

        @staticmethod
        def forward(ctx, h, end):
            ctx.end = end
            return h.view_as(h)

        @staticmethod
        def backward(ctx, g):
            if ctx.end:     # runs first in the backward: the experts' end
                counts["_b0"] = qmatmul_bwd_pair.launches
            else:
                counts["B"] += qmatmul_bwd_pair.launches - counts.pop("_b0")
            return g, None

    def wrapped(h, *w):
        g0 = qmatmul_fused.launches
        grad = torch.is_grad_enabled() and h.requires_grad
        if grad:
            h = _Marks.apply(h, False)
        out = inner(h, *w)
        counts["G"] += qmatmul_fused.launches - g0
        return _Marks.apply(out, True) if grad else out

    L._moe_expert_mlp_fused = wrapped
    try:
        yield counts
    finally:
        L._moe_expert_mlp_fused = inner


@contextmanager
def recording_calls(calls: dict, keep=None):
    """Record G's (every ``qmatmul_fused`` call: G, E, and K8) and B's
    calls as ``qdot`` makes them, those ``keep(args, kw)`` accepts: one
    entry a launch shape and keywords, ``key -> (args cloned, kwargs)``.
    The calls still run their kernels."""
    from repro_torch.kernels import ops as O

    def recorder(kind, fn):
        def rec(*args, **kw):
            key = (kind, tuple(tuple(a.shape) for a in args
                               if torch.is_tensor(a)),
                   tuple(str(a.dtype) for a in args if torch.is_tensor(a)),
                   repr(sorted(kw.items())))
            if key not in calls and (keep is None or keep(args, kw)):
                calls[key] = (tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args), dict(kw))
            return fn(*args, **kw)
        return rec

    saved = (O.qmatmul_fused, O.qmatmul_bwd_pair)
    O.qmatmul_fused = recorder("G", saved[0])
    O.qmatmul_bwd_pair = recorder("B", saved[1])
    try:
        yield calls
    finally:
        O.qmatmul_fused, O.qmatmul_bwd_pair = saved


def check_recorded_bitwise(label: str, calls: dict) -> dict:
    """Each recorded G/E/K8 or B call through its kernel and its plain
    version on the recorded operands: every output (E's codes, B's dx and
    dw) bitwise.  Returns the shapes checked by kind (expert calls are the
    ones without a representation format)."""
    from repro_torch.kernels import bwd_pair as B
    from repro_torch.kernels import fused as F

    seen: dict = {}
    for key, (args, kw) in calls.items():
        kind = key[0]
        run, ref = ((F.qmatmul_fused, F.qmatmul_fused_reference)
                    if kind == "G" else
                    (B.qmatmul_bwd_pair, B.qmatmul_bwd_pair_reference))
        got, want = run(*args, **kw), ref(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        name = kind
        if kind == "G" and kw.get("return_quantized"):
            name = "E"
        elif kind == "G" and kw.get("collect_stats"):
            name = "K8"
        if kw.get("repr_fmt") is None and name in ("G", "B") \
                and kw.get("m_acc", kw.get("bwd_acc", (8, 23))) in (23, (8, 23)):
            name += " expert"
        for a, b in zip(got, want):
            check(torch.equal(a, b), f"{label} {name} {key[1]}: not bitwise "
                                     "its plain version")
        seen.setdefault(name, []).append(key[1])
    print(f"[families] {label}: {len(calls)} launch shapes recorded, each "
          f"bitwise its plain version: " + "; ".join(
              f"{k} {v}" for k, v in sorted(seen.items())), flush=True)
    return seen


def _expert_costs(m: int, b_pass: bool):
    """(bytes, operations, peak) of one expert's 3 GEMMs at capacity m: G
    reads f32 x and bf16 w and writes f32 y; B reads f32 g and x and bf16
    w and writes f32 dx and dw."""
    out = []
    for _, k, n in EXPERT_GEMMS:
        if b_pass:
            out.append((4 * m * n + 4 * m * k + 2 * k * n + 4 * m * k
                        + 4 * k * n, 4 * m * k * n, BF16_FLOPS))
        else:
            out.append((4 * m * k + 2 * k * n + 4 * m * n, 2 * m * k * n,
                        BF16_FLOPS))
    return out


def _expert_kernels(dev) -> dict:
    """The expert GEMMs' kernels at moonshot's shapes: G at capacities 1,
    7 and 60, B at 60, one expert's 3 GEMMs each (f32 activations of bf16
    values, the bf16 weights as the layer hands them), bitwise their plain
    versions on random and lattice operands; their time (CUDA events),
    the plain versions', the bound and bf16 ``torch.matmul`` on the same
    shapes (B: the two matmuls of dx and dw) by graph replay."""
    from repro_torch.kernels.bwd_pair import (qmatmul_bwd_pair,
                                              qmatmul_bwd_pair_reference)
    from repro_torch.kernels.fused import (qmatmul_fused,
                                           qmatmul_fused_reference)

    gen = torch.Generator(device=dev).manual_seed(SEED + 91)

    def operands(m, lattice):
        ops = []
        for _, k, n in EXPERT_GEMMS:
            mk = ((lambda s: _lattice(gen, s, dev)) if lattice else
                  (lambda s: torch.randn(s, generator=gen, device=dev)
                   .to(torch.bfloat16).float()))
            ops.append((mk((m, k)), (mk((k, n)) / 8).to(torch.bfloat16),
                        mk((m, n))))
        return ops

    out = {}
    for m in EXPERT_CAPS:
        err = 0.0
        for lattice in (False, True):
            for a, w, _ in operands(m, lattice):
                got = qmatmul_fused(a, w, **EXPERT_KW)
                want = qmatmul_fused_reference(a, w, **EXPERT_KW)
                check(torch.equal(got, want), f"[families] expert G at M = "
                      f"{m}, {tuple(a.shape)} x {tuple(w.shape)}, "
                      f"{'lattice' if lattice else 'random'}: not bitwise")
                err = max(err, float((got - want).abs().max()))
        ops = operands(m, False)

        def run():
            for a, w, _ in ops:
                qmatmul_fused(a, w, **EXPERT_KW)

        # device time by graph replay: 3 eager launches of a few tens of
        # microseconds each are bound by the host's launch work
        ms = lib_time(run)[0]
        eager_ms = cuda_time(run, reps=20)
        t0 = time.perf_counter()
        for a, w, _ in ops:
            qmatmul_fused_reference(a, w, **EXPERT_KW)
        torch.cuda.synchronize()
        plain = 1e3 * (time.perf_counter() - t0)
        lib = lib_time(lambda: [torch.matmul(a.to(torch.bfloat16), w)
                                for a, w, _ in ops])
        bnd, by = seq_bound(_expert_costs(m, False))
        out[f"G{m}"] = dict(ms=ms, eager_ms=eager_ms, plain_ms=plain,
                            bound_ms=bnd, bound_by=by, library_ms=lib[0],
                            library_spread_ms=lib[1], max_abs_err=err)
        print(f"[families] expert G at M = {m} (one expert's gate, up, down: "
              f"2048x1408, 2048x1408, 1408x2048; (8,23) at chunk 128): "
              f"bitwise its plain version on random and lattice operands; "
              f"{ms:.4f} ms by graph replay (eager {eager_ms:.4f}), bound {bnd:.4f} ms ({by}; {bnd / ms:.3f}), "
              f"plain {plain:.1f} ms, bf16 torch.matmul {lib_str(lib)} "
              f"({ms / lib[0]:.2f}x)", flush=True)
    m = EXPERT_CAPS[-1]
    err = 0.0
    for lattice in (False, True):
        for a, w, g in operands(m, lattice):
            got = qmatmul_bwd_pair(g, a, w, **EXPERT_B_KW)
            want = qmatmul_bwd_pair_reference(g, a, w, **EXPERT_B_KW)
            for x, y in zip(got, want):
                check(torch.equal(x, y), f"[families] expert B at T = {m}, "
                      f"K {a.shape[1]}, N {w.shape[1]}: not bitwise")
                err = max(err, float((x - y).abs().max()))
    ops = operands(m, False)

    def run_b():
        for a, w, g in ops:
            qmatmul_bwd_pair(g, a, w, **EXPERT_B_KW)

    ms = lib_time(run_b)[0]
    eager_ms = cuda_time(run_b, reps=20)
    t0 = time.perf_counter()
    for a, w, g in ops:
        qmatmul_bwd_pair_reference(g, a, w, **EXPERT_B_KW)
    torch.cuda.synchronize()
    plain = 1e3 * (time.perf_counter() - t0)
    lib = lib_time(lambda: [(torch.matmul(g.to(torch.bfloat16), w.T),
                             torch.matmul(a.to(torch.bfloat16).T,
                                          g.to(torch.bfloat16)))
                            for a, w, g in ops])
    bnd, by = seq_bound(_expert_costs(m, True))
    out["B60"] = dict(ms=ms, eager_ms=eager_ms, plain_ms=plain, bound_ms=bnd,
                      bound_by=by, library_ms=lib[0],
                      library_spread_ms=lib[1], max_abs_err=err)
    print(f"[families] expert B at T = {m} (one expert's 3 GEMMs, f32 "
          f"residuals, bf16 w, g unquantized, (8,23) at chunks 128): bitwise "
          f"its plain version on random and lattice operands; {ms:.4f} ms by "
          f"graph replay (eager {eager_ms:.4f}), "
          f"bound {bnd:.4f} ms ({by}; {bnd / ms:.3f}), plain {plain:.1f} ms, "
          f"2 bf16 torch.matmul {lib_str(lib)} ({ms / lib[0]:.2f}x)",
          flush=True)
    return out


def _moe_serve_cfg(n_layers):
    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=n_layers)
    return plan_for_model(cfg, seq_len=max(PROMPT_LENS) + GEN,
                          global_batch=len(PROMPT_LENS),
                          policy=AccumulationPolicy(mode="predicted",
                                                    chunk=64))


def _graph_run(cfg, params, dev, prompts, label: str, eager=None) -> dict:
    """The serve cell's prompts one-shot on CUDA graphs, warmed: streams,
    arena, decode tok/s; against ``eager`` (a ``phase_serve``-like
    result) the streams and arena bitwise, 0 steady-state captures."""
    counters = _graph_counters()
    eng = build_engine(cfg, params, dev, None, graphs=True)
    ex = eng.executor
    warm = eng.warmup()
    ex.prefill_s = ex.decode_s = 0.0
    rids = [eng.submit(p, GEN) for p in prompts]
    zero_counts(counters)
    torch.cuda.synchronize()
    with ex.compile_stats_scope() as delta:
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = read_counts(counters)
    streams = [results[r] for r in rids]
    check(delta["compiles"] == 0 and delta["misses"] == 0,
          f"[families] {label}: steady-state captures {delta}")
    check(all(len(s) == GEN for s in streams), f"[families] {label}: short "
                                                "stream")
    for k in ("qmatmul_fused", "paged_attn_decode", P_GEOM_NAME):
        check(launches[k] > 0, f"[families] {label}: kernel {k} was not "
                               "launched on the graphed path")
    out = dict(streams=streams, warm=warm, seconds=dt, decode_s=ex.decode_s,
               decoded=eng.decoded_tokens, launches=launches,
               tok_s=eng.decoded_tokens / ex.decode_s)
    msg = ""
    if eager is not None:
        same = sum(a == b for a, b in zip(streams, eager["streams"]))
        # every page but the null page (0): each padded decode row writes
        # its K/V there at slot 0, and a MoE step's padded rows differ
        # (each one's capacity slots depend on its place in the batch), so
        # which row's write lands is the scatter's pick; no row reads it
        arena = _same_arena({k: v[:, 1:] for k, v in ex.kv.items()},
                            {k: v[:, 1:] for k, v in eager["arena"].items()})
        check(same == len(rids), f"[families] {label}: a graphed stream "
                                 "differs from the eager run's")
        if not arena:   # where: by tensor, the layers and pages that differ
            where = {k: sorted({(int(i[0]), int(i[1])) for i in (
                v != eager["arena"][k]).nonzero()[:, :2].tolist()})[:16]
                for k, v in ex.kv.items()}
            print(f"[families] {label}: arena differs at (layer, page) "
                  f"{where}", flush=True)
        check(arena, f"[families] {label}: the graphed arena differs from "
                     "the eager run's")
        msg = (f"; {same}/{len(rids)} streams and the arena (but the null "
               f"page) bitwise the eager run's (eager decode steps "
               f"{eager['decoded']} tokens in "
               f"{eager['decode_s']:.3f}s, "
               f"{eager['decoded'] / eager['decode_s']:.1f} tok/s)")
    print(f"[families] {label} on graphs: warmup {warm['compiles']} captures "
          f"in {warm['seconds']:.2f}s; {eng.decoded_tokens} decoded tokens in "
          f"{dt:.3f}s end to end; decode steps {ex.decode_s:.3f}s "
          f"({out['tok_s']:.1f} tok/s); launches over the replays "
          f"{launches}{msg}", flush=True)
    out["executor"], out["plan"], out["pool"] = ex, eng.plan, eng.pool
    return out


def _record_graph_prefill(out: dict, prompts, calls: dict) -> None:
    """The 64-token prompt's prefill slab through the graphed executor's
    step function run eagerly (``_eager``: P's device-geometry entry and G
    as the graph captured them), every kernel call recorded
    (``recording_kernels``; a short slab keeps the plain versions'
    checks short)."""
    from repro_torch.models.api import PrefillRequest

    ex, plan, pool = out["executor"], out["plan"], out["pool"]
    p = prompts[PROMPT_LENS.index(64)]
    pages = pool.allocate(10 ** 6, len(p))
    bi, bucket = plan.bucket_for(len(p))
    req = PrefillRequest(
        rid=10 ** 6, tokens=tuple(p), hist_pages=(), slab_pages=tuple(pages),
        t0=0, acc=bucket.acc, final=True,
        bucket_pages=bucket.max_pages(PAGE), slab_width=bucket.max_ctx,
        call=plan.kernel_call(bi, kv_fmt=ex.kv_fmt))
    with recording_kernels(calls):
        slab_w, width, values = ex._prefill_inputs(req)
        ex._eager(ex._prefill_fn(req.acc, width, slab_w, True, req.call),
                  values)
    torch.cuda.synchronize()
    pool.release(10 ** 6)


def _decode_profile(step, label: str, expert_ms: float) -> float | None:
    """One eager decode step (``step()``) under ``torch.profiler``: the
    kernels' summed device time, and the expert G calls' share of it
    (``expert_ms``, their graph-replayed time over the step's calls)."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
    except Exception as exc:  # the profiler is a reading, not a check
        print(f"[families] {label} profile: not measured "
              f"({type(exc).__name__}: {exc})", flush=True)
        return None
    if busy <= 0:
        print(f"[families] {label} profile: not measured (no device time)",
              flush=True)
        return None
    print(f"[families] {label}: one decode step's kernels {busy:.2f} ms in "
          f"all (profiler); the expert G calls {expert_ms:.2f} ms of it "
          f"(graph replay of the step's expert calls), a share of "
          f"{expert_ms / busy:.3f}", flush=True)
    return busy


def _moe_serve(dev) -> dict:
    """``[families] moe-serve``: moonshot-v1-16b-a3b at full width and
    ``MOE_SERVE_LAYERS`` layers, the predicted plan, the serve cell's 8
    prompts (32 tokens each) one-shot, eager with every kernel call
    recorded (G of the experts and of the dense GEMMs, D), then on CUDA
    graphs (with P's device-geometry entry recorded on a prompt's slab):
    every recorded call held against its plain version, the graphed
    streams and arena bitwise the eager ones, the launches of a decode
    step by kernel, the decode tok/s, the expert G calls' share of a
    decode step's kernel time."""
    from repro_torch.kernels.fused import qmatmul_fused
    from repro_torch.models.api import get_model

    cfg = _moe_serve_cfg(MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = _bf16_draw(get_model(cfg), SEED + 51, dev)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    calls: dict = {}
    experts: dict = {}
    counters = _counters()
    eng = build_engine(cfg, params, dev, None)
    rids = [eng.submit(p, GEN) for p in prompts]
    step_launches, full_req = [], []
    decode = eng.executor.decode

    def counted_decode(req):
        before = read_counts(counters)
        g0, f0 = experts.get("G", 0), qmatmul_fused.fold_launches
        res = decode(req)
        after = read_counts(counters)
        step_launches.append(dict(
            rows=len(req.rids), **{k: after[k] - before[k] for k in after},
            fold=qmatmul_fused.fold_launches - f0,
            expert_G=experts["G"] - g0))
        if len(req.rids) == MAX_BATCH:
            full_req[:] = [req]
        return res

    eng.executor.decode = counted_decode
    zero_counts(counters)
    qmatmul_fused.fold_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_kernels(calls), counting_experts(experts):
        results = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(counters)
    ex = eng.executor
    eager = dict(streams=[results[r] for r in rids],
                 arena={k: v.clone() for k, v in ex.kv.items()},
                 decoded=eng.decoded_tokens, decode_s=ex.decode_s,
                 seconds=dt)
    full = [s for s in step_launches if s["rows"] == MAX_BATCH]
    check(full, "[families] moe-serve: no decode step over the full batch")
    for k, v in launches.items():
        check(v > 0, f"[families] moe-serve: kernel {k} was not launched")
    per_layer = 3 * cfg.moe.n_experts
    check(full[0]["expert_G"] == per_layer * cfg.n_layers,
          f"[families] moe-serve: {full[0]['expert_G']} expert G launches in "
          f"a decode step, not {per_layer} a layer")
    eng.pool.check_invariants()
    print(f"[families] moe-serve: {MOE_ARCH} at full width (d 2048, 16/16 "
          f"heads, dh 128, 64 experts top-6 of d_ff 1408, 2 shared, vocab "
          f"163840), {cfg.n_layers} of 48 layers (drawn in {t_draw:.1f}s), "
          f"predicted plan; eager one-shot: {eng.decoded_tokens} decoded "
          f"tokens in {dt:.3f}s; decode steps {ex.decode_s:.3f}s "
          f"({eng.decoded_tokens / ex.decode_s:.1f} tok/s); launches over "
          f"the run {launches} (G's expert calls {experts['G']}); one "
          f"decode step over 8 rows: {full[0]} (capacity 1 a decode step: "
          f"{per_layer} expert G a layer)", flush=True)
    # the expert G calls of one decode step, graph-replayed: the step's
    # decode-route calls at M = 1 over the layers' weights
    a = torch.randn((1, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(SEED + 52), device=dev).to(
        torch.bfloat16).float()
    moe = params["layers"]["moe"]

    def step_experts():
        for li in range(cfg.n_layers):
            for e in range(cfg.moe.n_experts):
                h = qmatmul_fused(a, moe["w_gate"][li, e], **EXPERT_KW)
                qmatmul_fused(a, moe["w_up"][li, e], **EXPERT_KW)
                qmatmul_fused(h, moe["w_down"][li, e], **EXPERT_KW)

    expert_ms = lib_time(step_experts, reps=3, rounds=3)[0]
    # one more full-batch decode step (into the finished run's pages)
    busy = _decode_profile(lambda: decode(full_req[0]), "moe-serve",
                           expert_ms)
    graphed = _graph_run(cfg, params, dev, prompts, "moe-serve", eager)
    _record_graph_prefill(graphed, prompts, calls)
    rec = check_recorded("moe-serve", calls, torch.Generator(
        device=dev).manual_seed(SEED + 53), tag="[families]")
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    cap = _capacity(cfg, MAX_BATCH)
    check(any(s[0][0] == cap and s[1] in ((d, f), (f, d))
              for s in rec["shapes"]["G"]),
          f"[families] moe-serve: no expert G at a decode step's capacity "
          f"{cap} recorded")
    del graphed["executor"], eng, ex, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, expert_G=experts["G"], step=full[0],
                tok_s=graphed["tok_s"], eager_tok_s=eager["decoded"]
                / eager["decode_s"], expert_ms=expert_ms, busy_ms=busy,
                err=rec["err"], shapes=rec["shapes"])


def _record_graph_decode(out: dict, prompts, calls: dict) -> None:
    """One decode step over the 8 prompts' rows (positions at their
    lengths, in pages allocated for it) through the graphed executor's
    step function run eagerly, every kernel call recorded."""
    from repro_torch.models.api import DecodeRequest

    ex, plan, pool = out["executor"], out["plan"], out["pool"]
    rids = [10 ** 6 + i for i in range(len(prompts))]
    for rid, p in zip(rids, prompts):
        pool.allocate(rid, len(p) + 1)
    _, bucket = plan.bucket_for(max(len(p) + 1 for p in prompts))
    pt = pool.page_table(rids, bucket.max_pages(PAGE))
    req = DecodeRequest(
        rids=tuple(rids), last_tokens=tuple(p[0] for p in prompts),
        page_table=tuple(tuple(r) for r in pt.tolist()),
        positions=tuple(len(p) for p in prompts),
        seq_lens=tuple(len(p) + 1 for p in prompts), acc=bucket.acc)
    with recording_kernels(calls):
        _, width, values = ex._batch_inputs(
            req, np.asarray(req.last_tokens, np.int32))
        ex._eager(ex._decode_fn(req.acc, width), values)
    torch.cuda.synchronize()
    for rid in rids:
        pool.release(rid)


def _expert_call(cfg):
    """Whether a recorded G or B call is one of ``cfg``'s MoE experts': no
    representation format, its weight (G's b, B's wq) of an expert's
    shape."""
    d, f = cfg.d_model, cfg.moe.d_ff_expert

    def keep(args, kw) -> bool:
        w = args[1] if len(args) == 2 else args[2]
        return kw.get("repr_fmt") is None and tuple(w.shape) in ((d, f),
                                                                 (f, d))
    return keep


def _capacity(cfg, tokens: int) -> int:
    mc = cfg.moe
    return max(int(mc.capacity_factor * mc.top_k * tokens / mc.n_experts), 1)


def _moe_train(dev) -> dict:
    """``[families] moe-train``: moonshot at full width and
    ``MOE_TRAIN_LAYERS`` layers through the training launcher, the train
    cell's ``SyntheticLM`` 8 x 64 and AdamW, 3 steps, predicted: finite
    losses and the aux term, the expert G (capacity 60) and B calls
    recorded and bitwise their plain versions, the expert launches counted,
    the step time and peak memory; then one step at
    ``MOE_PLAIN_LAYERS`` layer (batch 2 x 64, no remat, so the plain
    version's recompute is left out) through the kernels and through their
    plain versions, loss and every gradient bitwise."""
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.launch import train as LT
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import _grads, compute_copy
    from repro_torch.train.optimizer import tree_leaves

    args = LT.parse_args(_train_argv(
        "--arch", MOE_ARCH, "--n-layers", str(MOE_TRAIN_LAYERS), "--steps",
        str(MOE_TRAIN_STEPS), "--log-every", "1"))
    mcfg = LT.model_config(args)
    cap = _capacity(mcfg, TRAIN_BATCH * TRAIN_SEQ)
    experts: dict = {}
    calls: dict = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with counting_experts(experts), recording_calls(calls,
                                                    _expert_call(mcfg)):
        res = LT.train(args)
    recs = res["records"]
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["aux"])
              for r in recs), f"[families] moe-train: non-finite {recs}")
    per_layer = 3 * mcfg.moe.n_experts * MOE_TRAIN_LAYERS
    check(experts["G"] == 2 * per_layer * MOE_TRAIN_STEPS
          and experts["B"] == per_layer * MOE_TRAIN_STEPS,
          f"[families] moe-train: expert launches {experts}")
    check(any(k[0] == "G" and k[1][0][0] == cap for k in calls)
          and any(k[0] == "B" and k[1][0][0] == cap for k in calls),
          f"[families] moe-train: no expert G and B at capacity {cap} "
          "recorded")
    seen = check_recorded_bitwise("moe-train (expert calls)", calls)
    del calls
    step_ms = [round(1e3 * x, 1) for x in res["step_seconds"]]
    print(f"[families] moe-train: {MOE_ARCH} at full width, "
          f"{MOE_TRAIN_LAYERS} layers (1.85 B parameters), SyntheticLM 8 x "
          f"64, AdamW, predicted: losses {[r['loss'] for r in recs]}, aux "
          f"{[r['aux'] for r in recs]}, step ms {step_ms}, peak "
          f"{res.get('peak_bytes', 0) / 2**30:.2f} GiB; expert launches over the "
          f"{MOE_TRAIN_STEPS} steps: G {experts['G']} (forward and the "
          f"remat recompute), B {experts['B']}; every launch "
          f"{res['launches']}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.configs import get_config

    cfg = plan_for_model(dataclasses.replace(get_config(MOE_ARCH),
                                             n_layers=MOE_PLAIN_LAYERS),
                         seq_len=TRAIN_SEQ, global_batch=2,
                         policy=AccumulationPolicy(mode="predicted",
                                                   chunk=64))
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 57)
    params = model.init_params(gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, TRAIN_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)

    def step():
        c = compute_copy(params)
        loss, m = model.loss_fn(c, {"tokens": tokens}, cfg)
        loss.backward()
        return loss.detach(), m["aux"].detach(), _grads(c, params)

    with remat_policy("none"):
        lk, ak, gk = step()
        with plain_versions():
            t0 = time.perf_counter()
            lp, ap, gp = step()
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
    leaves = list(zip(tree_leaves(gk), tree_leaves(gp)))
    same = sum(bool(torch.equal(a, b)) for a, b in leaves)
    print(f"[families] moe-train kernels vs plain, {MOE_PLAIN_LAYERS} layer "
          f"at full width, batch 2 x {TRAIN_SEQ} (expert capacity "
          f"{_capacity(cfg, 2 * TRAIN_SEQ)}): loss {float(lk):.6f} vs "
          f"{float(lp):.6f}, aux {float(ak):.6f} vs {float(ap):.6f}; "
          f"{same}/{len(leaves)} gradient leaves bitwise; plain step "
          f"{plain_s:.1f} s", flush=True)
    check(torch.equal(lk, lp) and torch.equal(ak, ap),
          "[families] moe-train: loss or aux differs from the plain versions")
    check(same == len(leaves), "[families] moe-train: a gradient differs "
                               "from the plain versions")
    return dict(records=recs, step_ms=step_ms, peak=res.get("peak_bytes"),
                experts=experts, launches=res["launches"], seen=seen)


def _qk_norm(dev) -> dict:
    """``[families] qk-norm``: qwen3-8b at full width and depth, the
    predicted plan, the serve cell's 8 prompts one-shot on CUDA graphs;
    G, D and P recorded on a prompt's prefill slab and one decode step
    through the graphed step functions, each held against its plain
    version; the decode tok/s."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.models.api import get_model

    cfg = plan_for_model(get_config(QK_ARCH), seq_len=max(PROMPT_LENS) + GEN,
                         global_batch=len(PROMPT_LENS),
                         policy=AccumulationPolicy(mode="predicted",
                                                   chunk=64))
    t0 = time.perf_counter()
    params = _bf16_draw(get_model(cfg), SEED + 61, dev)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    out = _graph_run(cfg, params, dev, prompts, "qk-norm")
    calls: dict = {}
    _record_graph_prefill(out, prompts, calls)
    _record_graph_decode(out, prompts, calls)
    rec = check_recorded("qk-norm", calls, torch.Generator(
        device=dev).manual_seed(SEED + 62), tag="[families]")
    print(f"[families] qk-norm: {QK_ARCH} at full width and depth (36 "
          f"layers, d 4096, 32/8 heads, dh 128, d_ff 12288, vocab 151936, "
          f"drawn in {t_draw:.1f}s): {out['tok_s']:.1f} decode tok/s on "
          f"graphs", flush=True)
    del out["executor"], params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(tok_s=out["tok_s"], err=rec["err"])


def _vlm(dev) -> dict:
    """``[families] vlm``: internvl2-2b at full width and ``VLM_LAYERS``
    layers, ``VLM_STEPS`` AdamW steps of 2 x 512 tokens with
    ``with_extras``' 256 patch embeddings a row, through the kernels and
    then through their plain versions from the same seed (no remat in
    either): losses, grad norms and the final parameters bitwise; the loss
    unchanged by the tokens at the image positions."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                           with_extras)
    from repro_torch.models.api import get_model
    from repro_torch.train import optimizer as O
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_train_step)
    from repro_torch.train.optimizer import tree_leaves

    cfg = plan_for_model(dataclasses.replace(get_config(VLM_ARCH),
                                             n_layers=VLM_LAYERS),
                         seq_len=VLM_SEQ, global_batch=VLM_BATCH,
                         policy=AccumulationPolicy(mode="predicted",
                                                   chunk=64))
    model = get_model(cfg)
    tc = TrainConfig(opt=O.OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                                     total_steps=VLM_STEPS))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=VLM_SEQ,
                                  global_batch=VLM_BATCH, seed=SEED),
                       device=dev)
    batches = [with_extras(next(data), cfg) for _ in range(VLM_STEPS)]

    def run():
        gen = torch.Generator(device=dev).manual_seed(SEED + 71)
        state = init_train_state(model, gen, dev, tc)
        step = make_train_step(model, tc)
        recs = []
        for b in batches:
            state, m = step(state, b)
            recs.append((m["loss"].clone(), m["grad_norm"].clone()))
        return recs, state["params"]

    counters = _train_counters()
    with remat_policy("none"):
        zero_counts(counters)
        t0 = time.perf_counter()
        rk, pk = run()
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        used = read_counts(counters)
        with plain_versions():
            t0 = time.perf_counter()
            rp, pp = run()
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
    check(used[E_NAME] > 0 and used["qmatmul_bwd_pair"] > 0,
          "[families] vlm: the kernel steps launched no E or B")
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(rk, rp))
    leaves = list(zip(tree_leaves(pk), tree_leaves(pp)))
    same_p = sum(bool(torch.equal(a, b)) for a, b in leaves)
    losses = [float(r[0]) for r in rk]
    check(all(math.isfinite(x) for x in losses), "[families] vlm: loss")
    check(same, "[families] vlm: a step's loss or grad norm differs from "
                "the plain versions")
    check(same_p == len(leaves), "[families] vlm: the parameters after the "
                                 "steps differ from the plain versions'")
    vt = cfg.vision_tokens
    with torch.no_grad():
        b = batches[0]
        base = model.loss_fn(pk, b, cfg, remat=False)[0]
        inside = b["tokens"].clone()
        inside[:, :vt] = (inside[:, :vt] + 1) % cfg.vocab_size
        same_in = model.loss_fn(pk, {**b, "tokens": inside}, cfg,
                                remat=False)[0]
        after = b["tokens"].clone()
        after[:, vt + 1] = (after[:, vt + 1] + 1) % cfg.vocab_size
        moved = model.loss_fn(pk, {**b, "tokens": after}, cfg,
                              remat=False)[0]
    check(torch.equal(base, same_in) and not torch.equal(base, moved),
          "[families] vlm: the loss scores an image position")
    print(f"[families] vlm: {VLM_ARCH} at full width (d 2048, 16/8 heads, "
          f"d_ff 8192, vocab 92553), {VLM_LAYERS} of 24 layers, "
          f"{VLM_STEPS} steps of {VLM_BATCH} x {VLM_SEQ} with {vt} patch "
          f"embeddings a row: losses {losses}, each step's loss and grad "
          f"norm and all {len(leaves)} parameter leaves after the steps "
          f"bitwise the plain versions' (kernels {kernel_s:.1f}s, plain "
          f"{plain_s:.1f}s; launches {used}); the loss unchanged by the "
          f"tokens at the {vt} image positions, moved by one after them",
          flush=True)
    return dict(losses=losses, launches=used)


def phase_families(dev, smi: str) -> dict:
    """``[families]``: the expert GEMMs' kernels at moonshot's shapes
    (``_expert_kernels``), then the runs ``moe-serve``, ``moe-train``,
    ``qk-norm`` and ``vlm``, each with the card's name and power limit and
    its seconds."""
    out, secs = {}, {}
    for name, fn in (("expert kernels", _expert_kernels),
                     ("moe-serve", _moe_serve), ("moe-train", _moe_train),
                     ("qk-norm", _qk_norm), ("vlm", _vlm)):
        t0 = time.perf_counter()
        out[name] = fn(dev)
        secs[name] = round(time.perf_counter() - t0, 1)
        print(f"[families] {name}: {secs[name]}s on {smi.strip()}",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[families] seconds by run {secs}", flush=True)
    return out


PHASE_SECONDS: dict = {}


def _timed(fn):
    @functools.wraps(fn)
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            PHASE_SECONDS[fn.__name__] = (PHASE_SECONDS.get(fn.__name__, 0.0)
                                          + time.perf_counter() - t0)
    return run


for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = _timed(globals()[_name])


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.models.api import get_model
    from repro_torch.serve.plan import plan_attention

    t_start = time.perf_counter()
    # the build on its own thread, the Monte Carlo (PyTorch ops only) on
    # the card meanwhile
    background = start_build()
    phase_analysis(dev)
    torch.cuda.empty_cache()
    smi = phase_build(background)
    max_ctx = max(PROMPT_LENS) + GEN
    cfg = plan_for_model(get_config("qwen2-1.5b"), seq_len=max_ctx,
                         global_batch=len(PROMPT_LENS),
                         policy=AccumulationPolicy(mode="predicted", chunk=64))
    check(cfg.quant.attn_qkv.fwd.m_acc == 5 and cfg.quant.lm_head.fwd.m_acc == 9,
          "unexpected plan")
    plan = plan_attention(2048, PAGE)

    g = phase_gemm(cfg, dev)
    g_step = gemm_step(cfg, dev, g["weights"])
    g_err = g["max_abs_err"]
    del g
    d = phase_decode(cfg, dev, plan)
    k12 = d.pop("stats")
    p = phase_prefill(cfg, dev, plan)
    pg = phase_p_geom(cfg, dev, plan)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = get_model(cfg).init_params(gen, dev)

    def to_bf16(tree):
        if isinstance(tree, dict):
            return {k: to_bf16(v) for k, v in tree.items()}
        return tree.to(torch.bfloat16)

    params = to_bf16(params)
    torch.cuda.empty_cache()
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    one = phase_serve(cfg, params, dev, prompts, None)
    chunked = phase_serve(cfg, params, dev, prompts, SLAB)
    same = sum(a == b for a, b in zip(one["streams"], chunked["streams"]))
    print(f"[serve] chunked vs one-shot: {same}/{len(prompts)} token streams "
          "identical", flush=True)
    check(same == len(prompts), "chunked prefill changed a token stream")
    phase_logits(cfg, params, dev, prompts[0])
    mon = phase_serve_monitor(cfg, params, dev, prompts, one)
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    sgr = phase_serve_graph(cfg, params, dev, prompts, (one, chunked))
    phase_obs(cfg, params, dev, prompts, (one, chunked), sgr)
    for run in (one, chunked, *sgr.values()):
        run.pop("arena", None)
        run.pop("executor", None)
    phase_reserve(cfg, params, dev, prompts, one)
    phase_spec(cfg, params, dev, prompts, one)
    phase_graph_teardown(mem0)
    torch.cuda.empty_cache()
    leg = phase_legacy(dev, smi)
    torch.cuda.empty_cache()
    phase_serve_oracle(cfg, params, dev, prompts[0])
    dp = phase_dense_prefill(cfg, params, dev, plan, prompts)
    k10_inputs = dp.pop("oneshot_inputs")
    qs = phase_qout_serve(params, dev, prompts, one)
    del params
    gc.collect()        # an engine's reference cycles hold the weights
    torch.cuda.empty_cache()
    tpk = phase_tp_kernels(cfg, dev, plan)
    torch.cuda.empty_cache()
    tpe = phase_tp_engine(cfg, dev, prompts)
    torch.cuda.empty_cache()
    dks = phase_dist_kslices(dev)
    torch.cuda.empty_cache()
    dsr = phase_dist_sr(dev)
    torch.cuda.empty_cache()
    dtr = phase_dist_train(dev, smi)
    torch.cuda.empty_cache()

    tk = phase_train_kernels(dev)
    torch.cuda.empty_cache()
    ok = phase_oracle_kernels(dev)
    torch.cuda.empty_cache()
    tr = phase_train(dev)
    torch.cuda.empty_cache()
    phase_train_vs_plain(dev)
    torch.cuda.empty_cache()
    to = phase_train_oracle(dev)
    torch.cuda.empty_cache()
    ig = phase_train_ingraph(dev, min(tr["step_ms"][1:]))
    torch.cuda.empty_cache()
    phase_train_replan(dev)
    torch.cuda.empty_cache()
    phase_train_4k(dev)
    torch.cuda.empty_cache()
    sk = phase_sr_kernels(dev)
    torch.cuda.empty_cache()
    sg = phase_sr_g(dev)
    torch.cuda.empty_cache()
    s7 = phase_sr_k7(dev)
    torch.cuda.empty_cache()
    s10 = phase_sr_prefill(dev, k10_inputs)
    del k10_inputs
    torch.cuda.empty_cache()
    phase_sr_below_knee(dev)
    ts = phase_train_sr(dev, min(tr["step_ms"][1:]), tr["tick_ms"])
    torch.cuda.empty_cache()
    # [ckpt]'s supervised child (process starts, checkpoint I/O; its 4
    # 2-layer steps the only card work) runs beside the phases up to
    # phase_ckpt
    ck = phase_ckpt_start(dev)
    var = phase_variants(cfg, dev)
    torch.cuda.empty_cache()
    qt = phase_qout_train(dev, min(tr["step_ms"][1:]), tr["profile"])
    torch.cuda.empty_cache()
    phase_fig6(dev)
    torch.cuda.empty_cache()
    phase_train_vs_plain(dev, rounding="sr")
    torch.cuda.empty_cache()
    phase_train_oracle_rows(dev)
    torch.cuda.empty_cache()
    qp = phase_qout_vs_plain(dev)
    torch.cuda.empty_cache()
    phase_a2q(dev)
    torch.cuda.empty_cache()
    phase_ckpt(dev, ck)
    torch.cuda.empty_cache()
    fam = phase_families(dev, smi)
    ek, ms, mt = fam["expert kernels"], fam["moe-serve"], fam["moe-train"]

    kernels = [
        dict(name="qmatmul_fused", route="cuda",
             source="src/repro_torch/csrc/qgemm.cu",
             replaces="src/repro/kernels/fused.py:107",
             launches=one["launches"]["qmatmul_fused"],
             fold_launches=one["fold_launches"],
             legacy_launches=leg["launches"]["qmatmul_fused"],
             max_abs_err=g_err, **{k: g_step[k] for k in (
                 "ms", "plain_ms", "plain_depth", "plain_depth_kernel_ms",
                 "bound_ms", "bound_by", "library_ms", "library_spread_ms",
                 "fma_bound_ms")}),
        dict(name="paged_attn_decode", route="cuda",
             source="src/repro_torch/csrc/paged_decode.cu",
             replaces="src/repro/kernels/attention.py:560",
             launches=one["launches"]["paged_attn_decode"], **d),
        dict(name="flash_prefill_paged", route="cuda",
             source="src/repro_torch/csrc/paged_prefill.cu",
             replaces="src/repro/kernels/attention.py:930",
             launches=one["launches"]["flash_prefill_paged"], **p),
        # P's device-geometry entry: the graphed serve path's prefill
        # (launches over the [serve-graph] one-shot run's replays)
        dict(name=P_GEOM_NAME, route="cuda",
             source="src/repro_torch/csrc/paged_prefill.cu",
             replaces="src/repro/kernels/attention.py:930",
             launches=sgr["chunk=one-shot"]["launches"][P_GEOM_NAME], **pg),
        dict(name=E_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm_emitq.cu",
             replaces="src/repro/kernels/fused.py:136",
             launches=tr["launches"][E_NAME], **tk["E"]),
        dict(name="qmatmul_bwd_pair", route="cuda",
             source="src/repro_torch/csrc/bwd_pair.cu",
             replaces="src/repro/kernels/bwd_pair.py:96",
             launches=tr["launches"]["qmatmul_bwd_pair"], **tk["B"]),
        # the dx carry-in entry: the trainer makes one unsplit B call per
        # layer (no VMEM slab to fit), so it is not launched on the path
        dict(name=K7_NAME, route="cuda",
             source="src/repro_torch/csrc/bwd_pair.cu",
             replaces="src/repro/kernels/bwd_pair.py:155",
             launches=tr["launches"][K7_NAME], **tk["K7"]),
        # the stats kernels: K8 on the eager ticks and the in-graph ticks,
        # K9 on the in-graph ticks, K12 on the serve monitor's ticks
        dict(name=K8_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm_stats.cu",
             replaces="src/repro/kernels/fused.py:174",
             launches=tr["tick_launches"][K8_NAME] + ig["launches"][K8_NAME],
             **tk["K8"]),
        dict(name=K9_NAME, route="cuda",
             source="src/repro_torch/csrc/bwd_pair.cu",
             replaces="src/repro/kernels/bwd_pair.py:214",
             launches=ig["launches"][K9_NAME], **tk["K9"]),
        dict(name=K12_NAME, route="cuda",
             source="src/repro_torch/csrc/paged_decode.cu",
             replaces="src/repro/kernels/attention.py:607",
             launches=mon["launches"], **k12),
        # the oracle's kernels over the full-depth oracle training steps,
        # and the dense prefill over the dense-prefill phase's layer paths
        dict(name=K2_NAME, route="cuda",
             source="src/repro_torch/csrc/quantize.cu",
             replaces="src/repro/kernels/quantize.py:22",
             launches=to["launches"][K2_NAME], **ok["K2"]),
        dict(name=K3_NAME, route="cuda",
             source="src/repro_torch/csrc/qmatmul.cu",
             replaces="src/repro/kernels/qmatmul.py:31",
             launches=to["launches"][K3_NAME], **ok["K3"]),
        dict(name=K10_NAME, route="cuda",
             source="src/repro_torch/csrc/flash_prefill.cu",
             replaces="src/repro/kernels/attention.py:258",
             launches=dp.pop("launches"), **dp),
        # the SR carries of E, B, K8 and K9 (the tile's SR instantiations),
        # launched over the [train] sr run; timed over one layer's calls
        dict(name=E_SR_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm_emitq.cu",
             replaces="src/repro/kernels/fused.py:136",
             launches=ts["launches"][E_SR_NAME], **sk["E"]),
        dict(name=B_SR_NAME, route="cuda",
             source="src/repro_torch/csrc/bwd_pair.cu",
             replaces="src/repro/kernels/bwd_pair.py:96",
             launches=ts["launches"][B_SR_NAME], **sk["B"]),
        dict(name=K8_SR_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm_stats.cu",
             replaces="src/repro/kernels/fused.py:174",
             launches=ts["launches"][K8_SR_NAME], **sk["K8"]),
        dict(name=K9_SR_NAME, route="cuda",
             source="src/repro_torch/csrc/bwd_pair.cu",
             replaces="src/repro/kernels/bwd_pair.py:214",
             launches=ts["launches"][K9_SR_NAME], **sk["K9"]),
        # G's SR carry on both routes: the [train] sr run's eager ticks (the
        # probe's no-grad forward at M = 512, the tile route); timed over
        # one layer's calls there
        dict(name=G_SR_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm.cu",
             replaces="src/repro/kernels/fused.py:107",
             launches=ts["launches"][G_SR_NAME],
             fold_launches=ts["launches"][G_SR_FOLD], **sg),
        # the SR carries of K7 and K10 are on no path of the train and serve
        # cells (one unsplit B a layer; serving is RNE, as the JAX
        # package's engine): the [train] sr run counts 0 of each there;
        # phase_launches counts their own phases' calls
        dict(name=K7_SR_NAME, route="cuda",
             source="src/repro_torch/csrc/bwd_pair.cu",
             replaces="src/repro/kernels/bwd_pair.py:155",
             launches=ts["launches"][K7_SR_NAME], **s7),
        dict(name=K10_SR_NAME, route="cuda",
             source="src/repro_torch/csrc/flash_prefill.cu",
             replaces="src/repro/kernels/attention.py:258",
             launches=ts["launches"][K10_SR_NAME], **s10),
        # the carry variants of D and P on the tensor-parallel serving path
        # ([tp]): D's carry entry and P's carry out over the 2-rank slab run
        # (rank 0's counts); P's carry in is on no JAX path, and its
        # launches are the [tp] resume walk's
        dict(name=D_CARRY_NAME, route="cuda",
             source="src/repro_torch/csrc/paged_decode.cu",
             replaces="src/repro/kernels/attention.py:560",
             launches=tpe["launches"][D_CARRY_NAME], **tpk["D"]),
        dict(name=P_CARRY_NAME, route="cuda",
             source="src/repro_torch/csrc/paged_prefill.cu",
             replaces="src/repro/kernels/attention.py:930",
             launches=tpe["launches"][P_CARRY_NAME], **tpk["P"]),
        # B and K9 on a rank's K-slice: the data-parallel backward
        # ([dist-train]); launches over rank 0's full-depth and microbatch
        # runs (B) and its tick run (K9); timed at mlp_gate's slice
        dict(name=B_KSLICE_NAME, route="cuda",
             source="src/repro_torch/csrc/bwd_pair.cu",
             replaces="src/repro/kernels/bwd_pair.py:96",
             launches=dtr["launches"], **dks["B"]),
        dict(name=K9_KSLICE_NAME, route="cuda",
             source="src/repro_torch/csrc/bwd_pair.cu",
             replaces="src/repro/kernels/bwd_pair.py:214",
             launches=dtr["k9_launches"], **dks["K9"]),
        # the SR keys' origins under a mesh ([dist-sr]): E's, K8's and G's
        # rows and columns, B's and K9's K-slices; launches over the mesh SR
        # runs on a rank whose origins are not 0 (rank 1 of [dist-train]'s
        # 2x1 SR run for E, B and its tick's K8 and K9; rank 3 of
        # [dist-model]'s 2x2 SR run for G, its eager tick's forward); timed
        # at mlp_gate's rank-1 block (mlp_up's shape)
        dict(name=E_SR_ORIGIN_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm_emitq.cu",
             replaces="src/repro/kernels/fused.py:136",
             launches=dtr["sr_launches"][E_SR_NAME], **dsr["E"]),
        dict(name=K8_SR_ORIGIN_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm_stats.cu",
             replaces="src/repro/kernels/fused.py:174",
             launches=dtr["sr_launches"][K8_SR_NAME], **dsr["K8"]),
        dict(name=G_SR_ORIGIN_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm.cu",
             replaces="src/repro/kernels/fused.py:107",
             launches=dtr["sr4_launches"][G_SR_NAME], **dsr["G"]),
        dict(name=B_SR_KSLICE_NAME, route="cuda",
             source="src/repro_torch/csrc/bwd_pair.cu",
             replaces="src/repro/kernels/bwd_pair.py:96",
             launches=dtr["sr_launches"][B_SR_NAME], **dsr["B"]),
        dict(name=K9_SR_KSLICE_NAME, route="cuda",
             source="src/repro_torch/csrc/bwd_pair.cu",
             replaces="src/repro/kernels/bwd_pair.py:214",
             launches=dtr["sr_launches"][K9_SR_NAME], **dsr["K9"]),
        dict(name=P_RESUME_NAME, route="cuda",
             source="src/repro_torch/csrc/paged_prefill.cu",
             replaces="src/repro/kernels/attention.py:930",
             launches_from="the [tp] resume walk", **tpk["resume"]),
        # the fused GEMM's last variants: G's and E's output epilogue over
        # the quantize_outputs runs ([qout]: serving, 6 training steps), E's
        # f32 residuals over the 2-layer pack_residuals=False step; G's
        # operand variants and K8's epilogue, on no path of the cells, over
        # one eager run of their [variants] sequence; each timed over one
        # layer's 7 calls (G's epilogue at M = 8, the rest at M = 512)
        dict(name=G_OUT_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm.cu",
             replaces="src/repro/kernels/fused.py:96",
             launches=qs["launches"], **var["G_out"]),
        dict(name=G_OPERAND_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm.cu",
             replaces="src/repro/kernels/fused.py:86", **var["G_operand"]),
        dict(name=E_OUT_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm_emitq.cu",
             replaces="src/repro/kernels/fused.py:96",
             launches=qt["launches"], **var["E_out"]),
        dict(name=E_F32_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm_emitq.cu",
             replaces="src/repro/kernels/fused.py:136",
             launches=qp["f32_launches"], **var["E_f32"]),
        dict(name=K8_OUT_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm_stats.cu",
             replaces="src/repro/kernels/fused.py:229", **var["K8_out"]),
        # the MoE experts' G and B ([families]): G's launches in the experts
        # over [families] moe-serve's eager one-shot run, timed over one
        # expert's 3 GEMMs at a decode step's capacity 1 (capacities 7 and
        # 60 under "by_capacity"); B's launches in the experts over
        # moe-train's 3 steps, timed over one expert's 3 GEMMs at 60
        dict(name=G_EXPERT_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm.cu",
             replaces="src/repro/kernels/fused.py:107",
             launches=ms["expert_G"], train_launches=mt["experts"]["G"],
             by_capacity={m: ek[f"G{m}"] for m in EXPERT_CAPS},
             **ek[f"G{EXPERT_CAPS[0]}"]),
        dict(name=B_EXPERT_NAME, route="cuda",
             source="src/repro_torch/csrc/bwd_pair.cu",
             replaces="src/repro/kernels/bwd_pair.py:96",
             launches=mt["experts"]["B"], **ek["B60"]),
    ]
    print("[time] seconds by phase " + json.dumps(
        {k: round(v, 1) for k, v in sorted(PHASE_SECONDS.items(),
                                           key=lambda kv: -kv[1])}),
          flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
