"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``repro_torch`` (never ``jax`` or ``repro``) in phases, each printed
on its own line:

1. build: compiles the Hopper kernels of ``src/repro_torch/csrc`` with
   ``nvcc`` (one process per source, in parallel) into ``build/``;
2. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (bitwise on lattice operands, at most 1 ulp of
   the carry format on random ones, mismatch fractions printed), with its
   time, the plain version's time, one PyTorch library call's time as a
   yardstick and the least time the card could take (its bound);
3. serve: qwen2-1.5b at full width and depth (28 layers, d 1536, vocab
   151936) under the predicted accumulation plan (chunk 64, page 16), bf16
   random weights from a seeded generator, 8 requests of mixed prompt
   lengths, 32 generated tokens each, one-shot and then with 64-token
   prefill slabs.  Every kernel's launch count over each run must be > 0,
   and one request's prefill logits are held against the plain versions;
4. train kernels: E (the forward GEMM with int8 residual codes) and B
   (the backward pair) against their plain versions at every distinct
   layer shape of the training step (T = 512 tokens) and on a slice of
   the tied lm_head, the whole lm_head backward (T = 512, N = 151936)
   unsplit and chained over 10 N segments with the dx carry (K7), both
   against the unsplit call and the chained plain version (bitwise), and
   one step's E and B launches timed as a sequence;
5. train: qwen2-1.5b at full width and depth through the training
   launcher's set-up (predicted plan, chunk 64, batch 8 x seq 64, seeded
   f32 weights, ``SyntheticLM``), 6 AdamW steps at lr 1e-3 with 2 warmup
   steps: per-step loss, gradient norm, step time, tokens/s, peak memory
   and launches (E 196, G 1, B 197 a step); the loss must be finite and
   fall; then one step of a 2-layer cut through the kernels and through
   their plain versions, bitwise;
6. result: one JSON line per kernel, the card's name and power limit, and
   the final JSON line.

Any failed check exits non-zero.  Without a CUDA device it exits non-zero
before printing a result.

  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
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


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulps(got, want, m: int, min_exp: int) -> torch.Tensor:
    """|got - want| in ulps of the (1, e, m) format at max(|got|, |want|)."""
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs())
    exp = torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag))))
    ulp = torch.exp2(torch.clamp(exp, min=min_exp) - m)
    return (got - want).abs() / ulp


def compare(label: str, got, want, m: int, e: int, *, bitwise: bool) -> float:
    """Print the mismatch fraction and max ulps; fail past 1 ulp of the
    (1, e, m) format, or on any mismatch when ``bitwise``."""
    mism = float((got != want).float().mean())
    u = float(ulps(got, want, m, -(2 ** (e - 1) - 1)).max())
    err = float((got - want).abs().max())
    print(f"  {label}: mismatch fraction {mism:.6f}, max {u:.3f} ulp of "
          f"(1,{e},{m}), max |err| {err:.3g}", flush=True)
    check(torch.isfinite(got).all().item(), f"{label}: non-finite output")
    check(u <= 1.0, f"{label}: {u} ulp > 1")
    if bitwise:
        check(mism == 0.0, f"{label}: not bitwise on lattice operands")
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
    return smi


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


def phase_gemm(cfg, dev) -> dict:
    from repro_torch.kernels.fused import qmatmul_fused, qmatmul_fused_reference

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    weights = {}
    print("[kernels] G qmatmul_fused vs plain (per shape: kernel ms, plain "
          "ms, bf16 torch.matmul ms, bound ms)", flush=True)
    rows, max_err = [], 0.0
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
        for m in ((1, MAX_BATCH) if is_head else (MAX_BATCH, SLAB)):
            kw = _gemm_kw(qc)
            a = torch.randn((m, k), generator=gen, device=dev)
            got = qmatmul_fused(a, w, **kw)
            want = qmatmul_fused_reference(a, w, **kw)
            max_err = max(max_err, compare(f"{name} M={m} random", got, want,
                                           p.m_acc, p.e_acc, bitwise=False))
            al = _lattice(gen, (m, k), dev)
            wl = _lattice(gen, (k, n), dev).to(torch.bfloat16)
            compare(f"{name} M={m} lattice", qmatmul_fused(al, wl, **kw),
                    qmatmul_fused_reference(al, wl, **kw), p.m_acc, p.e_acc,
                    bitwise=True)
            ms = cuda_time(lambda: qmatmul_fused(a, w, **kw), reps=20)
            plain = cuda_time(lambda: qmatmul_fused_reference(a, w, **kw),
                              reps=1, warmup=0)
            ab = a.to(torch.bfloat16)
            lib = cuda_time(lambda: torch.matmul(ab, w), reps=20)
            b_ms, b_by = bound_ms(m * k * 4 + k * n * 2 + m * n * 4,
                                  2 * m * n * k, BF16_FLOPS)
            rows.append((name, m, k, n, ms, plain, lib, b_ms, b_by))
            print(f"  time {name} M={m} K={k} N={n}: kernel {ms:.4f} ms, "
                  f"plain {plain:.2f} ms, library {lib:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
    return {"weights": weights, "rows": rows, "max_abs_err": max_err}


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
    lib = cuda_time(lambda: run(lambda a, w, **kw: torch.matmul(
        a.to(torch.bfloat16), w)), reps=5)
    b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS)
    print(f"[kernels] G one decode step ({len(calls)} GEMMs, M={MAX_BATCH}, "
          f"{n_bytes / 1e9:.3f} GB): kernel {ms:.3f} ms, plain {plain:.1f} "
          f"ms, library {lib:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
          f"{b_ms / ms:.3f} of bound", flush=True)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, calls=len(calls))


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


def phase_decode(cfg, dev, plan) -> dict:
    from repro_torch.kernels.attention import (
        paged_attn_decode, paged_attn_decode_reference)
    from repro_torch.quant.formats import FP8_152

    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    seq_lens = torch.tensor([384, 0, 17, 64, 100, 129, 256, 311],
                            dtype=torch.int32, device=dev)
    _, bucket = plan.bucket_for(int(seq_lens.max()))
    acc, width = bucket.acc, bucket.max_pages(PAGE)
    n_pages = 1 + sum(-(-int(s) // PAGE) for s in seq_lens)
    kc, vc, kse, vse = _attn_arena(gen, dev, n_pages, kv, dh)
    pt = torch.zeros((MAX_BATCH, width), dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    used = 0
    for b, s in enumerate(seq_lens.tolist()):
        np_ = -(-s // PAGE)
        pt[b, :np_] = perm[used:used + np_].to(torch.int32)
        used += np_
    q = torch.randn((MAX_BATCH, h, dh), generator=gen, device=dev)
    args = (kc, vc, kse, vse, pt, seq_lens)
    kw = dict(kv_fmt=FP8_152, acc=acc)
    print(f"[kernels] D paged_attn_decode vs plain: B={MAX_BATCH} H={h} "
          f"KV={kv} dh={dh} page {PAGE}, lengths {seq_lens.tolist()}, "
          f"acc {acc}", flush=True)
    got = paged_attn_decode(q, *args, **kw)
    max_err = _attn_check("D random q", got,
                          paged_attn_decode_reference(q, *args, **kw), acc,
                          bitwise=False)
    check(bool((got[1] == 0).all()), "D: a length-0 row is not exactly 0")
    ql = _lattice(gen, (MAX_BATCH, h, dh), dev)
    _attn_check("D lattice q", paged_attn_decode(ql, *args, **kw),
                paged_attn_decode_reference(ql, *args, **kw), acc,
                bitwise=True)
    ms = cuda_time(lambda: paged_attn_decode(q, *args, **kw), reps=50)
    plain = cuda_time(lambda: paged_attn_decode_reference(q, *args, **kw),
                      reps=1, warmup=0)
    # yardstick: SDPA over the same K/V gathered dense (bf16), length-masked
    lens = seq_lens.long()
    lmax = int(lens.max())
    from repro_torch.kernels.common import exp2_int
    from repro_torch.quant.qtensor import unpack_block

    def dense(codes, se):
        x = unpack_block(codes[pt.long()], 5, 2) * exp2_int(
            se[pt.long()])[..., None, None, None]      # (B, W, KV, ps, dh)
        x = x.permute(0, 2, 1, 3, 4).reshape(MAX_BATCH, kv, -1, dh)[:, :, :lmax]
        return x.repeat_interleave(h // kv, dim=1).to(torch.bfloat16)

    kd, vd = dense(kc, kse), dense(vc, vse)
    mask = (torch.arange(lmax, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    qb = q[:, :, None].to(torch.bfloat16)
    lib = cuda_time(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kd, vd, attn_mask=mask), reps=50)
    pages_read = int(sum(-(-s // PAGE) for s in seq_lens.tolist()))
    n_bytes = (pages_read * kv * PAGE * dh * 2 + q.numel() * 4 * 2
               + pt.numel() * 4 + MAX_BATCH * 4 + pages_read * 2 * 4)
    flops = 4 * int(lens.sum()) * dh * h
    b_ms, b_by = bound_ms(n_bytes, flops, F32_FLOPS)
    print(f"  time D: kernel {ms:.4f} ms, plain {plain:.2f} ms, SDPA "
          f"{lib:.4f} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=max_err)


def phase_prefill(cfg, dev, plan) -> dict:
    from repro_torch.kernels.attention import (
        flash_prefill_paged, flash_prefill_paged_reference)
    from repro_torch.kernels.common import exp2_int
    from repro_torch.quant.formats import FP8_152
    from repro_torch.quant.qtensor import unpack_block

    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    q_off, q_len = 320, SLAB                       # a 64-token slab, history 320
    kv_len = q_off + q_len
    _, bucket = plan.bucket_for(kv_len)
    acc, width = bucket.acc, bucket.max_pages(PAGE)
    n_used = -(-kv_len // PAGE)
    kc, vc, kse, vse = _attn_arena(gen, dev, n_used + 1, kv, dh)
    row = torch.zeros((width,), dtype=torch.int32, device=dev)
    row[:n_used] = (torch.randperm(n_used, generator=gen, device=dev) + 1
                    ).to(torch.int32)
    q = torch.randn((q_len, h, dh), generator=gen, device=dev)
    args = (kc, vc, kse, vse, row, q_off, q_len, kv_len)
    kw = dict(kv_fmt=FP8_152, acc=acc)
    print(f"[kernels] P flash_prefill_paged vs plain: T={q_len} H={h} "
          f"KV={kv} dh={dh}, q_offset {q_off}, kv_len {kv_len}, acc {acc}",
          flush=True)
    max_err = _attn_check("P random q", flash_prefill_paged(q, *args, **kw),
                          flash_prefill_paged_reference(q, *args, **kw), acc,
                          bitwise=False)
    ql = _lattice(gen, (q_len, h, dh), dev)
    _attn_check("P lattice q", flash_prefill_paged(ql, *args, **kw),
                flash_prefill_paged_reference(ql, *args, **kw), acc,
                bitwise=True)
    ms = cuda_time(lambda: flash_prefill_paged(q, *args, **kw), reps=50)
    plain = cuda_time(lambda: flash_prefill_paged_reference(q, *args, **kw),
                      reps=1, warmup=0)
    rl = row[:n_used].long()

    def dense(codes, se):
        x = unpack_block(codes[rl], 5, 2) * exp2_int(se[rl])[:, None, None, None]
        x = x.permute(1, 0, 2, 3).reshape(kv, -1, dh)[:, :kv_len]
        return x.repeat_interleave(h // kv, dim=0)[None].to(torch.bfloat16)

    kd, vd = dense(kc, kse), dense(vc, vse)
    rows = q_off + torch.arange(q_len, device=dev)
    mask = (torch.arange(kv_len, device=dev)[None, :] <= rows[:, None])[None, None]
    qb = q.permute(1, 0, 2)[None].to(torch.bfloat16)
    lib = cuda_time(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kd, vd, attn_mask=mask), reps=50)
    attended = int(sum(q_off + r + 1 for r in range(q_len)))
    n_bytes = (n_used * kv * PAGE * dh * 2 + q.numel() * 4 * 2 + width * 4
               + n_used * 2 * 4)
    b_ms, b_by = bound_ms(n_bytes, 4 * attended * dh * h, F32_FLOPS)
    print(f"  time P: kernel {ms:.4f} ms, plain {plain:.2f} ms, SDPA "
          f"{lib:.4f} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=max_err)


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

    saved = (O.qmatmul_fused, O.qmatmul_bwd_pair, L.paged_attn_decode,
             L.flash_prefill_paged)
    O.qmatmul_fused = F.qmatmul_fused_reference
    O.qmatmul_bwd_pair = B.qmatmul_bwd_pair_reference
    L.paged_attn_decode = A.paged_attn_decode_reference
    L.flash_prefill_paged = A.flash_prefill_paged_reference
    try:
        yield
    finally:
        (O.qmatmul_fused, O.qmatmul_bwd_pair, L.paged_attn_decode,
         L.flash_prefill_paged) = saved


def build_engine(cfg, params, dev, prefill_chunk):
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
                         executor=ex, device=dev)


def phase_serve(cfg, params, dev, prompts, prefill_chunk) -> dict:
    counters = _counters()
    eng = build_engine(cfg, params, dev, prefill_chunk)
    rids = [eng.submit(p, GEN) for p in prompts]
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(counters)
    ex = eng.executor
    label = f"chunk={prefill_chunk or 'one-shot'}"
    print(f"[serve] {label}: {len(rids)} requests, prompts {list(PROMPT_LENS)}, "
          f"gen {GEN}: {eng.decoded_tokens} decoded tokens in {dt:.3f}s "
          f"({eng.decoded_tokens / dt:.1f} tok/s end to end); decode steps "
          f"{ex.decode_s:.3f}s ({eng.decoded_tokens / ex.decode_s:.1f} tok/s); "
          f"prefill {eng.prefill_tokens} tokens in {eng.prefill_slabs} slabs, "
          f"{ex.prefill_s:.3f}s ({eng.prefill_tokens / ex.prefill_s:.1f} "
          f"tok/s); KV bytes/token {eng.kv_bytes_per_token():.1f}; "
          f"preemptions {eng.preemptions}; launches {launches}", flush=True)
    for k, v in launches.items():
        check(v > 0, f"{label}: kernel {k} was not launched on the main path")
    check(all(len(results[r]) == GEN for r in rids), f"{label}: short stream")
    vocab = cfg.vocab_size
    check(all(0 <= t < vocab for r in rids for t in results[r]),
          f"{label}: token out of range")
    eng.pool.check_invariants()
    check(eng.pool.free_pages == eng.pool.n_pages - 1, f"{label}: page leak")
    return dict(launches=launches, streams=[results[r] for r in rids],
                seconds=dt, decoded=eng.decoded_tokens,
                decode_s=ex.decode_s, prefill_s=ex.prefill_s,
                prefill_tokens=eng.prefill_tokens)


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
HEAD_SLICE = 4096                       # lm_head columns checked vs plain
HEAD_SEGMENTS = 10                      # the JAX N-split of the lm_head


def _train_cfg(n_layers=None, seq=TRAIN_SEQ, batch=TRAIN_BATCH):
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model

    cfg = get_config("qwen2-1.5b")
    if n_layers is not None:
        cfg = replace(cfg, n_layers=n_layers)
    return plan_for_model(cfg, seq_len=seq, global_batch=batch,
                          policy=AccumulationPolicy(mode="predicted", chunk=64))


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


def _e_cost(t, k, n):
    # x f32 and w bf16 read, y f32 and both code tensors written
    return t * k * 4 + k * n * 2 + t * n * 4 + t * k + k * n, 2 * t * k * n


def _b_cost(t, k, n, packed=True, w_bytes=1, x_bytes=1):
    # g f32 and the residuals read, dx and dw f32 written
    xb, wb = (1, 1) if packed else (x_bytes, w_bytes)
    return (t * n * 4 + t * k * xb + k * n * wb + t * k * 4 + k * n * 4,
            4 * t * k * n)


def phase_train_kernels(dev) -> dict:
    """E and B against their plain versions at every distinct layer shape
    of the training step (T = 512 tokens) and on a 4096-column slice of
    the tied lm_head; the whole lm_head backward unsplit (B) and chained
    over the JAX package's 10 N segments (K7), each against the other and
    against the chained plain version, bitwise; and one step's worth of E
    and B launches timed as a sequence."""
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_nsplit, qmatmul_bwd_pair_reference)
    from repro_torch.kernels.fused import qmatmul_fused, qmatmul_fused_reference
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
    e_err = b_err = 0.0
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
                                   m_f, ekw["e_acc"], bitwise=False))
        check(torch.equal(xq, rxq) and torch.equal(wq, rwq),
              f"E {tag}: codes differ from pack_block")
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
        compare(f"E {tag} lattice", lat[0], rlat[0], m_f, ekw["e_acc"],
                bitwise=True)
        check(torch.equal(lat[1], rlat[1]) and torch.equal(lat[2], rlat[2]),
              f"E {tag} lattice: codes differ")
        for got, want, (e_, m_), r in zip(
                qmatmul_bwd_pair(gl, lat[1], lat[2], **bkw),
                qmatmul_bwd_pair_reference(gl, lat[1], lat[2], **bkw),
                ((eb, mb), (eg, mg)), ("dx", "dw")):
            compare(f"B {r} {tag} lattice", got, want, m_, e_, bitwise=True)
        tensors[(k, n)] = (x, w, g, xq, wq)
        e_ms = cuda_time(lambda: qmatmul_fused(x, w, return_quantized=True,
                                               **ekw), reps=10)
        b_ms = cuda_time(lambda: qmatmul_bwd_pair(g, xq, wq, **bkw), reps=5)
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
        e_lib = cuda_time(lambda: torch.matmul(xb, w), reps=10)
        b_lib = cuda_time(lambda: (torch.matmul(gb, w.T),
                                   torch.matmul(xb.T, gb)), reps=10)
        e_b, e_by = bound_ms(*_e_cost(t, k, n), BF16_FLOPS)
        b_b, b_by = bound_ms(*_b_cost(t, k, n), BF16_FLOPS)
        print(f"  time {tag} K={k} N={n}: E kernel {e_ms:.4f} ms, library "
              f"{e_lib:.4f} ms, bound {e_b:.4f} ms ({e_by}); B kernel "
              f"{b_ms:.4f} ms, library {b_lib:.4f} ms, bound {b_b:.4f} ms "
              f"({b_by})", flush=True)

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
    seg = lambda fn: fn(hg, hx, emb.T, n_split=HEAD_SEGMENTS, **hkw)  # noqa
    k7_ms = cuda_time(lambda: seg(qmatmul_bwd_pair_nsplit), reps=2, warmup=1)
    hxb, hgb, embt = hx.to(torch.bfloat16), hg.to(torch.bfloat16), emb.T
    head_lib = lambda: (torch.matmul(hgb, embt.T),  # noqa: E731
                        torch.matmul(hxb.T, hgb))
    k7_lib = cuda_time(head_lib, reps=3)
    k7_b, k7_by = bound_ms(*_b_cost(t, k, n, packed=False, x_bytes=4,
                                    w_bytes=2), BF16_FLOPS)
    print(f"  time K7 lm_head T={t} K={k} N={n}: kernel {k7_ms:.3f} ms, "
          f"plain {k7_plain:.1f} ms, library {k7_lib:.3f} ms, bound "
          f"{k7_b:.4f} ms ({k7_by})", flush=True)
    gkw = _e_kw(qc)
    head_g = cuda_time(lambda: qmatmul_fused(hx, emb.T, **gkw), reps=3)
    print(f"  time G lm_head forward T={t} K={k} N={n}: kernel {head_g:.3f} "
          f"ms, library {cuda_time(lambda: torch.matmul(hxb, embt), reps=3):.3f}"
          f" ms", flush=True)

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

    e_cost = [_e_cost(t, k, n) for _ in range(depth) for _, _, k, n, _ in layer]
    b_cost = [_b_cost(t, k, n) for _ in range(depth)
              for _, _, k, n, _ in layer]
    b_cost.append(_b_cost(t, head[2], head[3], packed=False, x_bytes=4,
                          w_bytes=2))
    out = {}
    for name, run, lib, cost in (
            ("E", run_e, lib_e, e_cost), ("B", run_b, lib_b, b_cost)):
        fn = qmatmul_fused if name == "E" else qmatmul_bwd_pair
        ref = (qmatmul_fused_reference if name == "E"
               else qmatmul_bwd_pair_reference)
        ms = cuda_time(lambda: run(fn), reps=2, warmup=1)
        plain = cuda_time(lambda: run(ref), reps=1, warmup=0)
        lib_ms = cuda_time(lib, reps=3)
        b_ms, b_by = bound_ms(sum(c[0] for c in cost), sum(c[1] for c in cost),
                              BF16_FLOPS)
        print(f"[kernels] {name} one training step ({len(cost)} launches, "
              f"T={t}): kernel {ms:.3f} ms, plain {plain:.1f} ms, library "
              f"{lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms:.4f} of bound", flush=True)
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=e_err if name == "E" else b_err)
    out["K7"] = dict(ms=k7_ms, plain_ms=k7_plain, library_ms=k7_lib,
                     bound_ms=k7_b, bound_by=k7_by, max_abs_err=k7_err)
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


def _train_counters():
    """G, E, B and B's dx carry-in entry (K7), as ``_counters``."""
    from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
    from repro_torch.kernels.fused import qmatmul_fused

    return {"qmatmul_fused": (qmatmul_fused, "launches"),
            E_NAME: (qmatmul_fused, "emitq_launches"),
            "qmatmul_bwd_pair": (qmatmul_bwd_pair, "launches"),
            K7_NAME: (qmatmul_bwd_pair, "carry_launches")}


def phase_train(dev) -> dict:
    """qwen2-1.5b at full width and depth through the training launcher's
    own set-up (``repro_torch.launch.train.build``): predicted plan, chunk
    64, seeded f32 weights, ``SyntheticLM`` batches, AdamW."""
    from repro_torch.launch.train import build, parse_args
    from repro_torch.models.api import dense_gemm_shapes, param_count
    from repro_torch.train.loop import make_train_step

    args = parse_args(["--arch", "qwen2-1.5b", "--steps", str(TRAIN_STEPS),
                       "--global-batch", str(TRAIN_BATCH), "--seq-len",
                       str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--warmup",
                       str(TRAIN_WARMUP), "--policy", "predicted", "--chunk",
                       "64", "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    model, tc, state, data, _ = build(args)
    cfg = model.cfg
    step_fn = make_train_step(model, tc)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    n_layer_gemms = len(dense_gemm_shapes(cfg, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH)) - 1
    want = {E_NAME: n_layer_gemms * cfg.n_layers,
            "qmatmul_fused": 1,
            "qmatmul_bwd_pair": n_layer_gemms * cfg.n_layers + 1,
            K7_NAME: 0}
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{param_count(state['params']) / 1e6:.1f}M params (f32 masters), "
          f"predicted plan chunk 64, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"lr {TRAIN_LR} warmup {TRAIN_WARMUP}", flush=True)
    counters = _train_counters()
    losses, step_ms, launches = [], [], {k: 0 for k in counters}
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
    del state
    return dict(launches=launches, losses=losses, step_ms=step_ms, peak=peak)


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


def phase_train_vs_plain(dev) -> None:
    """One step of a 2-layer cut of qwen2-1.5b at full width (batch 2 x
    seq 64): loss and every gradient through the kernels, then through
    their plain versions on the same card, bitwise."""
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import _grads, compute_copy
    from repro_torch.train.optimizer import tree_leaves

    cfg = _train_cfg(n_layers=2, batch=2)
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

    counters = _train_counters()
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
    print(f"[train] kernels vs plain, 2 layers at full width, batch 2 x seq "
          f"{TRAIN_SEQ}: loss {float(lk):.6f} vs {float(lp):.6f}; "
          f"{same}/{len(leaves)} gradient leaves bitwise equal (max |err| "
          f"{err:.3g}); kernel launches {used}; plain step {plain_s:.1f} s",
          flush=True)
    check(used[E_NAME] > 0 and used["qmatmul_bwd_pair"] > 0,
          "the kernel step launched no E or B")
    check(torch.equal(lk, lp), "loss differs between kernels and plain")
    check(same == len(leaves), "a gradient differs between kernels and plain")


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
    del params
    torch.cuda.empty_cache()

    tk = phase_train_kernels(dev)
    torch.cuda.empty_cache()
    tr = phase_train(dev)
    torch.cuda.empty_cache()
    phase_train_vs_plain(dev)

    kernels = [
        dict(name="qmatmul_fused", route="cuda",
             source="src/repro_torch/csrc/qgemm.cu",
             replaces="src/repro/kernels/fused.py:107",
             launches=one["launches"]["qmatmul_fused"],
             max_abs_err=g_err, **{k: g_step[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="paged_attn_decode", route="cuda",
             source="src/repro_torch/csrc/paged_decode.cu",
             replaces="src/repro/kernels/attention.py:560",
             launches=one["launches"]["paged_attn_decode"], **d),
        dict(name="flash_prefill_paged", route="cuda",
             source="src/repro_torch/csrc/paged_prefill.cu",
             replaces="src/repro/kernels/attention.py:930",
             launches=one["launches"]["flash_prefill_paged"], **p),
        dict(name=E_NAME, route="cuda",
             source="src/repro_torch/csrc/qgemm.cu",
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
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
