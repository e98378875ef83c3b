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
   their f32-FMA bounds;
5. train: qwen2-1.5b at full width and depth through the training
   launcher's set-up (predicted plan, chunk 64, batch 8 x seq 64, seeded
   f32 weights, ``SyntheticLM``), 6 AdamW steps at lr 1e-3 with 2 warmup
   steps and the eager telemetry tick every 2 steps
   (``--telemetry-cadence 2``): per-step loss, gradient norm, step time,
   tokens/s, peak memory and launches (E 196, G 1, B 197 a step; G 197 and
   K8 24 a tick), each tick's time, events and schedule; the loss must be
   finite and fall; one step of a 2-layer cut through the kernels and
   through their plain versions, bitwise; then 3 full-depth in-graph
   ticks (``--ingraph-telemetry``: K9 197, K8 197, B 0 each; median and
   spread of their times) and, at the 2-layer
   cut, the tagged step against the untagged one, bitwise; then the
   launcher's ``main`` under ``--policy perturbed --pp -2`` with a tick
   every step (eager, then in-graph), 3 full-depth steps each: the
   controller must bump, the model be re-planned and training go on;
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
   distinct calls alone too, and eagerly); the 2-layer oracle step
   against the fused step (loss and every gradient bitwise) and 2
   full-depth steps of the train cell under each (losses bitwise, step
   time and peak memory);
7. stochastic rounding (``--rounding sr``): E, B, K8 and K9 with SR
   carries at one layer's four GEMM shapes of the train cell, on random and
   lattice operands, each bitwise its plain version, K8's C bitwise E's,
   K9's dx/dw bitwise B's, B's dx and dw bitwise the plain fused call on
   (g, Q(w)^T) and (Q(x)^T, g) at the role seeds, another seed changing
   every output, and each SR kernel timed beside its RNE run (per shape
   and over one layer's seven calls); ``tests/test_below_knee.py``'s
   regression on the card (K 8192, chunk 32, ``m_acc = knee - 2``: RNE
   stalls, SR reaches the wide loss); the train cell under ``--rounding
   sr --sr-seed 7 --policy perturbed --pp -2`` at full width and depth, 6
   steps with the eager tick every 2 steps and step 5 in-graph (the loss
   must fall; the SR launches of E, B, K8 and K9 counted); a 2-layer SR
   step bitwise through the plain versions;
8. analysis: the Monte Carlo of swamped accumulation on the card at
   ``tests/test_vrr_montecarlo.py``'s points under its assertions, Table
   1's assignment of the paper's three networks against the published
   table (the JAX package's match count), and qwen2-1.5b's accumulation
   lengths beside the train cell's plan;
9. ckpt: the train cell at full width and 2 layers through the launcher,
   uninterrupted and then under the restart supervisor with a crash at
   step 3 and a checkpoint every 2 steps (losses after the resume bitwise
   the uninterrupted run's; bytes on disk, save and restore ms), and the
   last checkpoint served through ``launch/serve.py --ckpt-dir`` under
   its recorded precision schedule;
10. result: one JSON line per kernel (the SR carries of E, B, K8 and K9
   as entries of their own), the card's name and power limit, and the
   final JSON line.

Any failed check exits non-zero.  Without a CUDA device it exits non-zero
before printing a result.

  python3 chip_smoke.py
"""

from __future__ import annotations

import functools
import json
import math
import re
import subprocess
import sys
import time
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


def phase_build() -> str:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    dt = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[build] {len(built)} kernels built in {dt:.2f}s into "
          f"{build.BUILD_DIR} ({', '.join(sorted(built)) or 'cached'})",
          flush=True)
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
]
# Kernels whose instantiations the build phase reports (registers, spill
# bytes; a spill fails): the tile's, G's decode kernel, K3's tile, the
# decode attention's (D, K12) and the prefill walk's (P, K10).
_KERNEL = re.compile(r"(qgemm_stats_kernel|qgemm_emitq_kernel|qgemm_tile_kernel|"
                     r"qgemm_decode_kernel|qmatmul_kernel|paged_decode_kernel|"
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
    occ = build.function("qgemm", "qgemm_decode_occupancy", [ctypes.c_int] * 5)
    seen = set()
    for k, n, kfast in ((1536, 1536, 0), (1536, 256, 0), (1536, 8960, 0),
                        (8960, 1536, 0), (1536, 151936, 1)):
        s = sm90.decode_schedule(MAX_BATCH, n, k, 64, 1)
        if (s.slots, kfast) in seen:
            continue
        seen.add((s.slots, kfast))
        r = occ(0, 1, kfast, s.slots, 64)
        print(f"[build] qgemm_decode_kernel<f32, bf16, "
              f"{('false', 'true')[kfast]}> at {s.slots} slots ({s.threads} "
              f"threads, K={k} N={n} M={MAX_BATCH}): {s.smem} bytes of dynamic "
              f"shared memory, {r} resident blocks an SM", flush=True)
        check(r >= 1, f"G's decode kernel: {r} resident blocks an SM")
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
    smem = build.function("paged_decode", "paged_decode_smem", [ctypes.c_int] * 5)
    fit = build.function("paged_decode", "paged_decode_clusters", [ctypes.c_int] * 6)
    for b, width, what in ((MAX_BATCH, 64, "serve arena"), (1, 64, "monitor"),
                           (1, 256, "4096-token row")):
        s = sm90.attn_decode_schedule(b, 2, width, 6, PAGE, 128)
        n = [fit(k, 6, PAGE, 128, s.cluster, s.rank_pages) for k in (0, 1)]
        print(f"[build] paged_decode_kernel at the {what} (B={b}, KV 2, "
              f"width {width}): cluster {s.cluster}, {s.rank_pages} pages a "
              f"block a round, {s.blocks} blocks of {sm90.ATTN_THREADS} "
              f"threads, {smem(6, PAGE, 128, s.cluster, s.rank_pages)} bytes "
              f"of dynamic shared memory; clusters that fit at once: D {n[0]}, "
              f"K12 {n[1]}", flush=True)
        check(min(n) >= b * 2, f"D/K12 at the {what}: {n} clusters fit")
    # P and K10 (qwen2-1.5b: g 6, dh 128) at the schedules of the serve
    # shapes: tile rows, cluster, pages a block a round, shared memory,
    # resident blocks an SM (at least two) and clusters that fit at once
    for lib, what, t, ps, n_pages in PREFILL_BUILD_SHAPES:
        s = sm90.attn_prefill_schedule(t, 2, 6, ps, 128, n_pages)
        args = (6, s.rows, ps, 128, s.cluster, s.rank_pages)
        smem = build.function(lib, f"{lib}_smem", [ctypes.c_int] * 6)(*args)
        occ = build.function(lib, f"{lib}_occupancy", [ctypes.c_int] * 6)(*args)
        fit = build.function(lib, f"{lib}_clusters", [ctypes.c_int] * 6)(*args)
        print(f"[build] attn_prefill_kernel<{str(lib == 'paged_prefill').lower()}> "
              f"({lib}) at "
              f"{what} (T={t}, page {ps}, {n_pages} pages): {s.rows} rows a "
              f"tile, cluster {s.cluster}, {s.rank_pages} pages a block a "
              f"round, {s.blocks} blocks of {sm90.PREFILL_THREADS} threads, "
              f"{smem} bytes of dynamic shared memory, {occ} resident blocks "
              f"an SM, {fit} clusters fit at once", flush=True)
        check(smem == s.smem, f"{lib} at {what}: smem {smem} != {s.smem}")
        check(occ >= 2, f"{lib} at {what}: {occ} resident blocks an SM")


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

    def run(fn):
        for a, w, kw in calls:
            fn(a, w, **kw)

    ms = cuda_time(lambda: run(qmatmul_fused), reps=5)
    plain = cuda_time(lambda: run(qmatmul_fused_reference), reps=1, warmup=0)
    lib = lib_time(lambda: run(lambda a, w, **kw: torch.matmul(
        a.to(torch.bfloat16), w)))
    b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS)
    f_ms = fma_bound([(n_bytes, flops, BF16_FLOPS)])
    print(f"[kernels] G one decode step ({len(calls)} GEMMs, M={MAX_BATCH}, "
          f"{n_bytes / 1e9:.3f} GB): kernel {ms:.3f} ms, plain {plain:.1f} "
          f"ms, library {lib_str(lib)} ({ms / lib[0]:.2f}x), bound "
          f"{b_ms:.3f} ms ({b_by}), {b_ms / ms:.3f} of bound; f32-FMA bound "
          f"{f_ms:.4f} ms", flush=True)
    return dict(ms=ms, plain_ms=plain, library_ms=lib[0],
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
# width), the serve monitor's K12 call (B 1, the same width) and a
# 4096-token row (256 pages: the cluster takes it in 6 rounds)
DECODE_SHAPES = (("serve arena", [384, 0, 17, 64, 100, 129, 256, 311], None),
                 ("monitor B=1", [384], None), ("4096-token row", [4096], 256))


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
             L.paged_attn_decode, L.flash_prefill_paged, L.flash_prefill)
    O.qmatmul_fused = F.qmatmul_fused_reference
    O.qmatmul_bwd_pair = B.qmatmul_bwd_pair_reference
    O.quantize = K2.quantize_reference
    O.qmatmul = K3.qmatmul_reference
    L.paged_attn_decode = A.paged_attn_decode_reference
    L.flash_prefill_paged = A.flash_prefill_paged_reference
    L.flash_prefill = A.flash_prefill_reference
    try:
        yield
    finally:
        (O.qmatmul_fused, O.qmatmul_bwd_pair, O.quantize, O.qmatmul,
         L.paged_attn_decode, L.flash_prefill_paged, L.flash_prefill) = saved


def build_engine(cfg, params, dev, prefill_chunk, **engine_kw):
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
    n_pages = -(-int(sum(n + GEN for n in PROMPT_LENS) * 1.25) // PAGE) + 1
    pc = PagedKVConfig.for_model(cfg, n_pages=n_pages, page_size=PAGE)
    ex = TimedExecutor(model, params, pc, kv_fmt=FPFormat(5, 2),
                       max_batch=MAX_BATCH, device=dev)
    return S.ServeEngine(model, params, n_pages=n_pages, page_size=PAGE,
                         max_batch=MAX_BATCH, prefill_chunk_tokens=prefill_chunk,
                         executor=ex, device=dev, **engine_kw)


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

    def run_e(fn):
        for (x, w, _, _, _), qc in calls:
            fn(x, w, return_quantized=True, **_e_kw(qc))

    def run_b(fn):
        for (_, _, g, xq, wq), qc in calls:
            fn(g, xq, wq, **_b_kw(qc))
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

    def run_k8(fn):
        for (_, _, _, xq, wq), qc_ in calls:
            fn(xq, wq, **_k8_codes_kw(_e_kw(qc_)))
        fn(hx, emb.T, **hkw8)

    def run_k9(fn):
        for (_, _, g, xq, wq), qc_ in calls:
            fn(g, xq, wq, **_b_kw(qc_))
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
        plain = cuda_time(lambda: run(ref), reps=1, warmup=0)
        lib_ms = lib_time(lib, reps=3)
        b_ms, b_by = seq_bound(cost)
        f_ms = fma_bound(cost)
        what = ("one in-graph telemetry tick" if name in ("K8", "K9")
                else "one training step")
        print(f"[kernels] {name} {what} ({len(cost)} launches, "
              f"T={t}): kernel {ms:.3f} ms, plain {plain:.1f} ms, library "
              f"{lib_str(lib_ms)}, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms:.4f} of bound; f32-FMA bound {f_ms:.3f} ms, "
              f"{f_ms / ms:.4f} of it; {ms / lib_ms[0]:.2f}x the library",
              flush=True)
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms[0],
                         library_spread_ms=list(lib_ms[1]), bound_ms=b_ms,
                         bound_by=b_by, fma_bound_ms=f_ms, max_abs_err=err)
    print(f"[kernels] stats overhead over one step's sequence: K8 "
          f"{out['K8']['ms'] / out['E']['ms']:.3f}x E, K9 "
          f"{out['K9']['ms'] / out['B']['ms']:.3f}x B", flush=True)
    out["K7"] = dict(ms=k7_ms, plain_ms=k7_plain, library_ms=k7_lib[0],
                     library_spread_ms=list(k7_lib[1]), bound_ms=k7_b,
                     bound_by=k7_by, fma_bound_ms=k7_f, max_abs_err=k7_err)
    return out


def _nsplit_plain(g, x, w, kw):
    """The chained segments through the plain version: (dx, dw)."""
    from repro_torch.kernels.bwd_pair import (pair_segment_width,
                                              qmatmul_bwd_pair_reference)

    t, n = g.shape
    seg = pair_segment_width(n, HEAD_SEGMENTS, kw["bwd_chunk"])
    dx = torch.zeros((t, x.shape[1]), dtype=torch.float32, device=g.device)
    dws = []
    for lo in range(0, n, seg):
        hi = min(lo + seg, n)
        dx, dw = qmatmul_bwd_pair_reference(g[:, lo:hi], x, w[:, lo:hi],
                                            dx_carry=dx, **kw)
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
    want = {E_NAME: n_layer_gemms * cfg.n_layers,
            "qmatmul_fused": 1,
            "qmatmul_bwd_pair": n_layer_gemms * cfg.n_layers + 1,
            K7_NAME: 0, K8_NAME: 0, K9_NAME: 0}
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
    _profile_step(step_fn, state, next(data), min(step_ms[1:]))
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
    del state
    return dict(launches=launches, losses=losses, step_ms=step_ms, peak=peak,
                tick_ms=tick_ms, tick_launches=tick_launches)


def _profile_step(step_fn, state, batch, step_ms: float) -> None:
    """One more step under ``torch.profiler``: device time by kernel, and
    the kernels' summed time against ``step_ms``, a step's wall time
    measured without the profiler (kernels run one at a time on one
    stream, so their sum is the device's busy time)."""
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
        print(f"[train] profile: not measured ({type(exc).__name__}: {exc})",
              flush=True)
        return
    busy = sum(r[0] for r in rows)
    print(f"[train] profile of one step: kernels {busy:.1f} ms in all "
          f"({len(rows)} kernel names), {busy / step_ms:.3f} of the steady "
          f"step's {step_ms:.1f} ms (device idle share "
          f"{1 - busy / step_ms:.3f})", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  profile {ms:9.3f} ms {count:6d} x {key[:90]}", flush=True)


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
    want = {"qmatmul_fused": 1, E_NAME: n_qdot - 1, "qmatmul_bwd_pair": 0,
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
    eager tick's G and K8; in-graph, K8 and K9 and no B)."""
    import contextlib
    import io

    from repro_torch.launch import train as LT
    from repro_torch.models.api import dense_gemm_shapes

    cfg = _train_cfg()
    n_qdot = (len(dense_gemm_shapes(cfg, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH)) - 1
              ) * cfg.n_layers + 1
    s = REPLAN_STEPS
    wants = {
        False: {E_NAME: s * (n_qdot - 1), "qmatmul_fused": s * (1 + n_qdot),
                "qmatmul_bwd_pair": s * n_qdot, K7_NAME: 0, K8_NAME: s * 24,
                K9_NAME: 0},
        True: {E_NAME: s * (n_qdot - 1), "qmatmul_fused": s,
               "qmatmul_bwd_pair": 0, K7_NAME: 0, K8_NAME: s * n_qdot,
               K9_NAME: s * n_qdot}}
    make_step, built = LT.make_train_step, []

    def recording(model, tc):   # the plan of every step the launcher builds
        built.append(model.cfg)
        return make_step(model, tc)

    counters = _train_counters()
    out = {}
    for ingraph in (False, True):
        argv = _train_argv("--policy", "perturbed", "--pp", "-2",
                           "--telemetry-cadence", "1", "--steps", str(s),
                           "--log-every", "1",
                           *(("--ingraph-telemetry",) if ingraph else ()))
        TELEMETRY_LOG.unlink(missing_ok=True)
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
        out[what] = dict(launches=used, losses=losses, acted=len(acted))
        del res
        torch.cuda.empty_cache()
    return out


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
    head_out = {}

    def run_k3(fn):
        """One step's K3 calls; keeps the whole lm_head's three outputs."""
        outs = head_out[fn] = []
        for i, (a, b, p, _) in enumerate(k3_list):
            y = fn(a, b, **_k3_kw(p))
            if i >= len(k3_list) - 3:
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
        plain = cuda_time(lambda: run(ref), reps=1, warmup=0)
        if name == "K3":
            err = max(err, check_head())
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
              f"launches, T={t}): {k_s}, plain {plain:.1f} ms, "
              f"{lib_s}, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.4f} of "
              f"bound{fma_s}", flush=True)
        out[name] = dict(ms=ms, plain_ms=plain,
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
    steps = 2
    want = {True: {K2_NAME: steps * 3 * (n_qdot - 1),
                   K3_NAME: steps * 3 * n_qdot},
            False: {K2_NAME: 0, K3_NAME: 0, E_NAME: steps * (n_qdot - 1),
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
                mul_add_bound_ms=ma_ms, max_abs_err=err)


# --------------------------------------------------------------------------
# stochastic rounding: E, B, K8 and K9 under --rounding sr
# --------------------------------------------------------------------------

E_SR_NAME = "qmatmul_fused(return_quantized, rounding=sr)"
B_SR_NAME = "qmatmul_bwd_pair(rounding=sr)"
K8_SR_NAME = "qmatmul_fused(collect_stats, rounding=sr)"
K9_SR_NAME = "qmatmul_bwd_pair(collect_stats, rounding=sr)"


def _sr_counters():
    """The SR launches of E, B, K8 and K9, counted apart, as
    ``_counters``."""
    from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
    from repro_torch.kernels.fused import qmatmul_fused

    return {E_SR_NAME: (qmatmul_fused, "sr_emitq_launches"),
            B_SR_NAME: (qmatmul_bwd_pair, "sr_launches"),
            K8_SR_NAME: (qmatmul_fused, "sr_stats_launches"),
            K9_SR_NAME: (qmatmul_bwd_pair, "sr_stats_launches")}


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


def phase_train_sr(dev, rne_step_ms: float) -> dict:
    """The train cell under ``--rounding sr --sr-seed 7 --policy perturbed
    --pp -2`` (every quantized width 2 bits under the predicted plan) at
    full width and depth through the launcher's set-up: 6 steps of 8 x 64
    tokens with the eager telemetry tick every 2 steps (K8 under SR on the
    synthetic layer roles) and step 5 as the in-graph tagged step (K9
    under SR).  The loss must fall; launches are checked each step (a
    step's E and B under SR, the lm_head's G and B under RNE); prints the
    steady step against the RNE run's."""
    from repro_torch.launch.train import build, build_telemetry
    from repro_torch.models.api import dense_gemm_shapes
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
    want_step = dict(zero, **{E_SR_NAME: n, B_SR_NAME: n,
                              "qmatmul_fused": 1, "qmatmul_bwd_pair": 1})
    # the probe's forward (E under SR, G on the lm_head), K8 under SR on
    # the 7 layer tags' 3 roles and under RNE on the lm_head's 3
    want_tick = dict(zero, **{E_SR_NAME: n, "qmatmul_fused": 1,
                              K8_SR_NAME: 21, K8_NAME: 3})
    want_tagged = dict(zero, **{E_SR_NAME: n, "qmatmul_fused": 1,
                                K9_SR_NAME: n, K9_NAME: 1, K8_SR_NAME: n,
                                K8_NAME: 1})
    print(f"[train] sr: {cfg.name} {cfg.n_layers} layers, --rounding sr "
          f"--sr-seed {TRAIN_SR_SEED} --policy perturbed --pp -2, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} steps, eager tick "
          f"every {TELEMETRY_CADENCE} steps, step 5 in-graph", flush=True)
    losses, step_ms, total = [], [], dict(zero)
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
            per = read_counts(counters)
            acts = [(e["gemm"], e["role"], e["event"], e["m_acc"],
                     e["rounding"]) for e in events if e["event"] != "ok"]
            print(f"[train] sr telemetry tick at step {step + 1}: "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms, "
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
    for k in _sr_counters():
        check(total[k] > 0, f"sr: {k} was not launched by the trainer")
    del state
    return dict(launches=total, losses=losses, step_ms=steady)


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


def phase_ckpt(dev) -> dict:
    """Checkpoints and restarts on the card: qwen2-1.5b at full width, the
    depth cut to CKPT_LAYERS layers (at full depth a checkpoint holds about
    18.5 GB of f32 masters and moments).  CKPT_STEPS steps through the
    training launcher uninterrupted, then the same steps under the restart
    supervisor with ``--crash-at-step 3 --ckpt-every 2``: a checkpoint
    before the crash, the restart resuming from it, one at the end; every
    loss after the resume bitwise the uninterrupted run's.  Then the last
    checkpoint served through ``launch/serve.py --ckpt-dir``: one request,
    under the recorded precision schedule.  Prints the checkpoint's bytes
    on disk and its save and restore ms; deletes the checkpoints."""
    import contextlib
    import io
    import os
    import shutil

    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    counters = dict(_train_counters(), **_counters())
    try:
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
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=600)
        secs = time.perf_counter() - t0
        log = out.stdout
        check(out.returncode == 0, f"supervised run exit {out.returncode}: "
              f"{log[-2000:]} {out.stderr[-2000:]}")
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
              f"--ckpt-every {CKPT_EVERY}): {secs:.1f} s, one restart; "
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
                                              "flash_prefill_paged")),
              "serving from the checkpoint missed a kernel of the serve path")
        return dict(saves=saves, restore_ms=restore_ms, seconds=secs,
                    train_launches=train_used, serve_launches=serve_used)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


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
    smi = phase_build()
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
    phase_serve_oracle(cfg, params, dev, prompts[0])
    dp = phase_dense_prefill(cfg, params, dev, plan, prompts)
    del params
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
    sk = phase_sr_kernels(dev)
    torch.cuda.empty_cache()
    phase_sr_below_knee(dev)
    ts = phase_train_sr(dev, min(tr["step_ms"][1:]))
    torch.cuda.empty_cache()
    phase_train_vs_plain(dev, rounding="sr")
    torch.cuda.empty_cache()
    phase_analysis(dev)
    torch.cuda.empty_cache()
    phase_ckpt(dev)

    kernels = [
        dict(name="qmatmul_fused", route="cuda",
             source="src/repro_torch/csrc/qgemm.cu",
             replaces="src/repro/kernels/fused.py:107",
             launches=one["launches"]["qmatmul_fused"],
             fold_launches=one["fold_launches"],
             max_abs_err=g_err, **{k: g_step[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "library_spread_ms", "fma_bound_ms")}),
        dict(name="paged_attn_decode", route="cuda",
             source="src/repro_torch/csrc/paged_decode.cu",
             replaces="src/repro/kernels/attention.py:560",
             launches=one["launches"]["paged_attn_decode"], **d),
        dict(name="flash_prefill_paged", route="cuda",
             source="src/repro_torch/csrc/paged_prefill.cu",
             replaces="src/repro/kernels/attention.py:930",
             launches=one["launches"]["flash_prefill_paged"], **p),
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
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
