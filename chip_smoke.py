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
4. result: one JSON line per kernel, the card's name and power limit, and
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
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    q = cfg.quant
    return [("wq", d, h * dh, q.attn_qkv), ("wk", d, kv * dh, q.attn_qkv),
            ("wv", d, kv * dh, q.attn_qkv), ("wo", h * dh, d, q.attn_out),
            ("w_gate", d, f, q.mlp_up), ("w_up", d, f, q.mlp_up),
            ("w_down", f, d, q.mlp_down),
            ("lm_head", d, cfg.vocab_size, q.lm_head)]


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
    from repro_torch.kernels.attention import flash_prefill_paged, paged_attn_decode
    from repro_torch.kernels.fused import qmatmul_fused

    return {"qmatmul_fused": qmatmul_fused,
            "paged_attn_decode": paged_attn_decode,
            "flash_prefill_paged": flash_prefill_paged}


@contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain PyTorch versions (for
    the logit check only; the port itself never does this)."""
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import fused as F
    from repro_torch.kernels import ops as O
    from repro_torch.models import layers as L

    saved = (O.qmatmul_fused, L.paged_attn_decode, L.flash_prefill_paged)
    O.qmatmul_fused = F.qmatmul_fused_reference
    L.paged_attn_decode = A.paged_attn_decode_reference
    L.flash_prefill_paged = A.flash_prefill_paged_reference
    try:
        yield
    finally:
        O.qmatmul_fused, L.paged_attn_decode, L.flash_prefill_paged = saved


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
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
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
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
