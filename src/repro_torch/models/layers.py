"""Layer functions of the dense decoder (plain functions on tensors).

Counterpart of ``repro.models.layers`` for the dense family: training
attention (``attn_apply``), the paged serving entries (the bucketed slab
``attn_prefill_bucketed`` through P, the dense one-shot and slab prefills
``attn_prefill_paged`` and ``attn_prefill_chunk_paged`` through K10,
``attn_decode_paged`` and the speculative verify ``attn_verify_paged``
through D) and the SwiGLU MLP.

Under tensor-parallel serving (a sharded ``dist.Dist``) the serve-path
functions run on the rank's output-dim slices of the params
(``sharding.specs.serve_param_specs``) and its KV-head slice of the
arena: each rank walks its heads' whole online softmax with the
single-device kernel's order and rounding, emits the raw carry, and the
ranks merge the carries exactly (``_merge_sharded_carry``); every
output-split GEMM is gathered back on its last dim (``dist.gather_cols``,
JAX's ``_gather_cols``).
Params are nested dicts of tensors; compute is bf16 with float32 where the
JAX package uses it.  Every dense GEMM goes through ``dense``, which runs
the differentiable quantized ``qdot`` when the model's QuantPlan assigns a
config.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.dist import LOCAL, Dist, gather_cols, psum_carry
from repro_torch.kernels.attention import (
    BLOCK_Q,
    NEG,
    finalize_carry,
    flash_prefill,
    flash_prefill_paged,
    flash_prefill_paged_geom,
    paged_attn_decode,
    prefill_geom,
)
from repro_torch.kernels.ops import QDotConfig, qdot
from repro_torch.models.config import ModelConfig
from repro_torch.serve import kvcache as KV

Params = dict[str, Any]

COMPUTE_DTYPE = torch.bfloat16


def dense(x: torch.Tensor, w: torch.Tensor, qcfg: QDotConfig | None = None,
          bias: torch.Tensor | None = None, out_fmt=None) -> torch.Tensor:
    """y = x @ w (+ bias), bf16 out.

    With a QDotConfig: float32 x into ``qdot`` (the bf16 weights go to the
    kernel as they are: bf16 -> f32 is exact, and a float32 copy of the
    weights is never made), output cast to bf16, bias added in bf16.
    Without: a bf16 product (the JAX package leaves it to XLA's dot).

    ``out_fmt`` is the consumer-format hint: the (1, e, m) format of the
    op that takes y unchanged, into which the GEMM's epilogue rounds y
    (replacing the config's ``out_fmt``), so that op can skip its own
    quantization; straight-through in the backward.
    """
    if qcfg is not None and not qcfg.is_exact:
        if out_fmt is not None and out_fmt != qcfg.out_fmt:
            qcfg = dataclasses.replace(qcfg, out_fmt=out_fmt)
        y = qdot(x.to(torch.float32), w, qcfg).to(COMPUTE_DTYPE)
    else:
        y = torch.matmul(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def rope(q: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  q: (..., S, H, d_head); positions: (..., S)."""
    d = q.shape[-1]
    half = d // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=q.device)
    freqs = torch.pow(theta, -idx / half)
    angles = positions[..., :, None].to(torch.float32) * freqs
    angles = angles[..., :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    q1, q2 = q[..., :half], q[..., half:]
    out = torch.cat([q1 * cos - q2 * sin, q2 * cos + q1 * sin], dim=-1)
    return out.to(q.dtype)


def _normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * std


def attn_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = 1.0 / math.sqrt(d)
    p: Params = {
        "wq": _normal(gen, (d, h * dh), std, device),
        "wk": _normal(gen, (d, kv * dh), std, device),
        "wv": _normal(gen, (d, kv * dh), std, device),
        "wo": _normal(gen, (h * dh, d), std / math.sqrt(2 * cfg.n_layers),
                      device),
    }
    if cfg.attn_bias:
        for name, n in (("bq", h * dh), ("bk", kv * dh), ("bv", kv * dh)):
            p[name] = torch.zeros((n,), dtype=torch.float32, device=device)
    return p


def mlp_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": _normal(gen, (d, f), 1.0 / math.sqrt(d), device),
        "w_up": _normal(gen, (d, f), 1.0 / math.sqrt(d), device),
        "w_down": _normal(gen, (f, d), 1.0 / math.sqrt(f)
                          / math.sqrt(2 * cfg.n_layers), device),
    }


def _q_proj(p: Params, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    q = dense(x, p["wq"], cfg.quant.attn_qkv, p.get("bq")).reshape(
        b, s, -1, cfg.head_dim)
    return rope(q, positions, cfg.rope_theta)


def _kv_proj(p: Params, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor):
    b, s, _ = x.shape
    dh = cfg.head_dim
    k = dense(x, p["wk"], cfg.quant.attn_qkv, p.get("bk")).reshape(b, s, -1, dh)
    v = dense(x, p["wv"], cfg.quant.attn_qkv, p.get("bv")).reshape(b, s, -1, dh)
    return rope(k, positions, cfg.rope_theta), v


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true division on every backend (PyTorch on CUDA multiplies
    by the reciprocal of a Python-number divisor, one bit off at times)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q (b, s, h, dh), k/v (b, t, kv, dh) bf16; ``mask`` broadcastable to
    (b, kv, g, s, t).  Scores and p.v accumulate in f32 (products of
    bf16 are exact in f32), the softmax runs in f32 and the probabilities
    are rounded to bf16, as the JAX package's einsums with
    ``preferred_element_type=float32`` do.  Returns (b, s, h*dh) bf16."""
    b, s, h, dh = q.shape
    kv = cfg.n_kv_heads
    g = h // kv
    qg = q.reshape(b, s, kv, g, dh).to(torch.float32)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    sc = torch.where(mask, true_div(sc, math.sqrt(dh)), -math.inf)
    w = torch.softmax(sc, dim=-1).to(COMPUTE_DTYPE)
    o = torch.einsum("bkgst,btkd->bskgd", w.to(torch.float32),
                     v.to(torch.float32))
    return o.to(COMPUTE_DTYPE).reshape(b, s, h * dh)


def attn_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor) -> torch.Tensor:
    """Causal (training) self-attention over x (B, S, D) at ``positions``
    (B, S); plain PyTorch ops, differentiable."""
    k, v = _kv_proj(p, x, cfg, positions)
    m = positions[:, :, None] >= positions[:, None, :]          # (B, S, S)
    mask = m[:, None, None]                                     # (B,1,1,S,S)
    q = _q_proj(p, x, cfg, positions)
    o = _gqa_attend(q, k, v, mask, cfg)
    return dense(o, p["wo"], cfg.quant.attn_out)


def _merge_sharded_carry(o_l: torch.Tensor, m_l: torch.Tensor,
                         l_l: torch.Tensor, dist: Dist) -> torch.Tensor:
    """The ranks' local-head carries ``o_l`` (..., h_loc, dh), ``m_l``/``l_l``
    (..., h_loc) merged to full heads and finalized, exactly.  Each rank
    places its carry at heads ``[rank * h_loc, (rank + 1) * h_loc)`` of a
    full-head carry holding the neutral ``(0, NEG, 0)`` elsewhere, and
    ``psum_carry`` merges them: owners scale by 2^0 = 1, non-owners by
    2^(NEG - m_g) = +0, so the sums add exact zeros and the merged carry
    is the concatenation of the ranks' carries (JAX's order: scale, sum,
    finalize once).  Returns (..., H, dh) float32."""
    h_loc, dh = o_l.shape[-2], o_l.shape[-1]
    lead = tuple(o_l.shape[:-2])
    h = h_loc * dist.size
    lo = dist.rank * h_loc
    dev = o_l.device
    o_f = torch.zeros(lead + (h, dh), dtype=torch.float32, device=dev)
    m_f = torch.full(lead + (h,), NEG, dtype=torch.float32, device=dev)
    l_f = torch.zeros(lead + (h,), dtype=torch.float32, device=dev)
    o_f[..., lo:lo + h_loc, :] = o_l
    m_f[..., lo:lo + h_loc] = m_l
    l_f[..., lo:lo + h_loc] = l_l
    o_f, _, l_f = psum_carry(o_f, m_f, l_f, dist)
    return finalize_carry(o_f, l_f)


def attn_decode_paged(p: Params, x: torch.Tensor, kv: dict[str, torch.Tensor],
                      page_table: torch.Tensor, positions: torch.Tensor,
                      seq_lens: torch.Tensor, cfg: ModelConfig, *, kv_fmt,
                      acc: tuple[int, int], dist: Dist = LOCAL) -> torch.Tensor:
    """One-token decode against a layer's arena slice ``kv`` (updated in
    place).  ``x`` (B, 1, D); ``page_table`` (B, W) int32; ``positions``
    (B,) each row's write position; ``seq_lens`` (B,) int32 attended
    tokens including this one, 0 for padded rows (whose write lands in the
    null page).  Under a sharded ``dist`` each rank walks its own heads
    (D's carry entry) and the carries merge exactly."""
    b = x.shape[0]
    pos2 = positions[:, None]
    q = _q_proj(p, x, cfg, pos2)                   # (B, 1, H, dh)
    k1, v1 = _kv_proj(p, x, cfg, pos2)
    page_size = kv["k"].shape[2]
    page_id = torch.gather(page_table.long(), 1,
                           (positions // page_size)[:, None].long())[:, 0]
    slot = (positions % page_size).long()
    ax = dist if dist.sharded else None
    KV.append_token(kv["k"], kv["k_se"], k1[:, 0].to(torch.float32),
                    page_id, slot, kv_fmt, pmax_axis=ax)
    KV.append_token(kv["v"], kv["v_se"], v1[:, 0].to(torch.float32),
                    page_id, slot, kv_fmt, pmax_axis=ax)
    args = (q[:, 0].to(torch.float32), kv["k"], kv["v"], kv["k_se"],
            kv["v_se"], page_table, seq_lens)
    if ax is None:
        o = paged_attn_decode(*args, kv_fmt=kv_fmt, acc=acc)
    else:
        o = _merge_sharded_carry(*paged_attn_decode(
            *args, kv_fmt=kv_fmt, acc=acc, return_carry=True), dist)
    o = o.reshape(b, 1, -1).to(COMPUTE_DTYPE)
    y = dense(o, p["wo"], cfg.quant.attn_out)
    return y if ax is None else gather_cols(y, dist)


def attn_verify_paged(p: Params, x: torch.Tensor, kv: dict[str, torch.Tensor],
                      page_table: torch.Tensor, positions: torch.Tensor,
                      seq_lens: torch.Tensor, cfg: ModelConfig, *, kv_fmt,
                      acc: tuple[int, int], dist: Dist = LOCAL) -> torch.Tensor:
    """Speculative-decode verify through a layer: ``S = k + 1`` tokens a
    sequence in one batched pass, bitwise ``S`` sequential
    ``attn_decode_paged`` steps.  ``x`` (B, S, D), the last committed
    token and the k proposals; ``positions`` (B,) the first write
    position of each row; ``seq_lens`` (B,) int32 the attended length at
    slab index 0 (0 for padded rows).  The S tokens' K/V append slot by
    slot, in order, under ``append_token``'s page-scale rule (a slot-0
    write fixes the page's exponent; appends never read, so writing all S
    before attending changes nothing); then one D call over the B * S
    flattened rows, row (i, j) with sequence i's page-table row and its
    own length ``seq_lens + j``, so each row's walk is the decode walk at
    that context.  Under a sharded ``dist`` each rank walks its own heads
    (D's carry entry) and the carries merge exactly."""
    b, s, _ = x.shape
    steps = torch.arange(s, device=x.device)
    pos2 = positions[:, None] + steps[None, :]
    q = _q_proj(p, x, cfg, pos2)                   # (B, S, H, dh)
    k1, v1 = _kv_proj(p, x, cfg, pos2)
    page_size = kv["k"].shape[2]
    ax = dist if dist.sharded else None
    pt = page_table.long()
    for j in range(s):
        pos_j = positions + j
        page_id = torch.gather(pt, 1, (pos_j // page_size)[:, None].long())[:, 0]
        slot = (pos_j % page_size).long()
        KV.append_token(kv["k"], kv["k_se"], k1[:, j].to(torch.float32),
                        page_id, slot, kv_fmt, pmax_axis=ax)
        KV.append_token(kv["v"], kv["v_se"], v1[:, j].to(torch.float32),
                        page_id, slot, kv_fmt, pmax_axis=ax)
    q_flat = q.reshape(b * s, *q.shape[2:]).to(torch.float32)
    pt_flat = torch.repeat_interleave(page_table, s, dim=0)
    sl_flat = torch.where(seq_lens[:, None] > 0,
                          seq_lens[:, None] + steps[None, :].to(seq_lens.dtype),
                          torch.zeros_like(seq_lens)[:, None]).reshape(b * s)
    args = (q_flat, kv["k"], kv["v"], kv["k_se"], kv["v_se"], pt_flat,
            sl_flat.to(torch.int32))
    if ax is None:
        o = paged_attn_decode(*args, kv_fmt=kv_fmt, acc=acc)
    else:
        o = _merge_sharded_carry(*paged_attn_decode(
            *args, kv_fmt=kv_fmt, acc=acc, return_carry=True), dist)
    o = o.reshape(b, s, -1).to(COMPUTE_DTYPE)
    y = dense(o, p["wo"], cfg.quant.attn_out)
    return y if ax is None else gather_cols(y, dist)


def attn_prefill_bucketed(p: Params, x: torch.Tensor,
                          kv: dict[str, torch.Tensor], page_row: torch.Tensor,
                          slab_page_ids: torch.Tensor, q_offset, q_len,
                          cfg: ModelConfig, *, kv_fmt,
                          acc: tuple[int, int], call=None,
                          dist: Dist = LOCAL) -> torch.Tensor:
    """One prefill slab of one sequence through a layer.  ``x`` (1, T, D)
    holds the slab (rows ``>= q_len`` are padding, zeroed before the
    arena write); the slab's K/V are quantized into ``slab_page_ids``, then
    one P call attends history and slab off the updated arena.

    ``q_offset``/``q_len`` are host ints (P's launch-argument entry
    ``flash_prefill_paged``) or 0-d int32 tensors on x's device, JAX's
    traced geometry: then the positions, the live mask and P's ``geom``
    are formed on the device and nothing reads them on the host
    (``flash_prefill_paged_geom``), so the layer can be captured in a CUDA
    graph that serves every slab geometry.  Under a sharded ``dist`` (host
    ints only) each rank walks its own heads (P's carry out) and the
    carries merge exactly."""
    t = x.shape[1]
    on_device = isinstance(q_offset, torch.Tensor) or isinstance(
        q_len, torch.Tensor)
    rows = torch.arange(t, device=x.device)
    if on_device:
        q_offset = torch.as_tensor(q_offset, dtype=torch.int32,
                                   device=x.device)
        q_len = torch.as_tensor(q_len, dtype=torch.int32, device=x.device)
    positions = (q_offset + rows)[None]
    q = _q_proj(p, x, cfg, positions)              # (1, T, H, dh)
    k, v = _kv_proj(p, x, cfg, positions)
    live = (rows < q_len)[:, None, None]
    kf = torch.where(live, k[0].to(torch.float32), 0.0)
    vf = torch.where(live, v[0].to(torch.float32), 0.0)
    ax = dist if dist.sharded else None
    KV.write_prompt(kv["k"], kv["k_se"], kf, slab_page_ids, kv_fmt,
                    pmax_axis=ax)
    KV.write_prompt(kv["v"], kv["v_se"], vf, slab_page_ids, kv_fmt,
                    pmax_axis=ax)
    pages = (q[0].to(torch.float32), kv["k"], kv["v"], kv["k_se"],
             kv["v_se"], page_row)
    if on_device:
        if ax is not None:
            raise NotImplementedError(
                "the sharded prefill takes its geometry as host ints")
        o = flash_prefill_paged_geom(*pages, prefill_geom(q_offset, q_len),
                                     kv_fmt=kv_fmt, acc=acc, call=call)
    elif ax is None:
        o = flash_prefill_paged(*pages, q_offset, q_len, q_offset + q_len,
                                kv_fmt=kv_fmt, acc=acc, call=call)
    else:
        o = _merge_sharded_carry(*flash_prefill_paged(
            *pages, q_offset, q_len, q_offset + q_len, kv_fmt=kv_fmt,
            acc=acc, call=call, return_carry=True), dist)
    o = o.reshape(1, t, -1).to(COMPUTE_DTYPE)
    y = dense(o, p["wo"], cfg.quant.attn_out)
    return y if ax is None else gather_cols(y, dist)


def attn_prefill_paged(p: Params, x: torch.Tensor, kv: dict[str, torch.Tensor],
                       page_ids: torch.Tensor, positions: torch.Tensor,
                       cfg: ModelConfig, *, kv_fmt, acc: tuple[int, int],
                       block_q: int | None = None) -> torch.Tensor:
    """Causal prefill of ONE whole sequence through a layer: its K/V are
    quantized into ``page_ids`` (in place), then the queries attend the
    values the arena now holds (``write_prompt``'s dequantized view) in one
    dense ``flash_prefill`` call at the page-size carry cadence.  ``x``
    (1, S, D); ``positions`` (1, S).  Bitwise ``attn_prefill_bucketed``
    over the same prompt."""
    s = x.shape[1]
    q = _q_proj(p, x, cfg, positions)              # (1, S, H, dh)
    k, v = _kv_proj(p, x, cfg, positions)
    kdq = KV.write_prompt(kv["k"], kv["k_se"], k[0].to(torch.float32),
                          page_ids, kv_fmt)
    vdq = KV.write_prompt(kv["v"], kv["v_se"], v[0].to(torch.float32),
                          page_ids, kv_fmt)
    o = flash_prefill(q[0].to(torch.float32), kdq, vdq, acc=acc,
                      chunk=kv["k"].shape[2], block_q=block_q or BLOCK_Q)
    o = o.reshape(1, s, -1).to(COMPUTE_DTYPE)
    return dense(o, p["wo"], cfg.quant.attn_out)


def attn_prefill_chunk_paged(p: Params, x: torch.Tensor,
                             kv: dict[str, torch.Tensor],
                             hist_page_ids: torch.Tensor,
                             slab_page_ids: torch.Tensor, t0: int,
                             cfg: ModelConfig, *, kv_fmt,
                             acc: tuple[int, int],
                             block_q: int | None = None) -> torch.Tensor:
    """One chunked-prefill slab of ONE sequence through a layer.  ``x``
    (1, T, D) holds the slab's hidden states at absolute positions
    ``t0 + i``; ``t0`` is page-aligned.  The slab's K/V go into
    ``slab_page_ids`` (in place) with the one-shot page grouping; its
    queries then attend the history ``hist_page_ids`` (``gather_pages``
    view) in a carry-out ``flash_prefill`` pass, resumed by a carry-in
    causal pass over the slab's own K/V.  Per query row the same page-size
    blocks in the same order as a one-shot prefill: bitwise outputs and
    arena."""
    s = x.shape[1]
    page_size = kv["k"].shape[2]
    if t0 % page_size != 0:
        raise ValueError(f"slab offset {t0} not page-aligned ({page_size})")
    positions = (t0 + torch.arange(s, dtype=torch.int32,
                                   device=x.device))[None]
    q = _q_proj(p, x, cfg, positions)              # (1, T, H, dh)
    k, v = _kv_proj(p, x, cfg, positions)
    kdq = KV.write_prompt(kv["k"], kv["k_se"], k[0].to(torch.float32),
                          slab_page_ids, kv_fmt)
    vdq = KV.write_prompt(kv["v"], kv["v_se"], v[0].to(torch.float32),
                          slab_page_ids, kv_fmt)
    kw = dict(acc=acc, chunk=page_size, block_q=block_q or BLOCK_Q,
              q_offset=t0)
    qf = q[0].to(torch.float32)
    carry = None
    if t0 > 0:
        kh = KV.gather_pages(kv["k"], kv["k_se"], hist_page_ids, kv_fmt)
        vh = KV.gather_pages(kv["v"], kv["v_se"], hist_page_ids, kv_fmt)
        carry = flash_prefill(qf, kh[:t0], vh[:t0], return_carry=True, **kw)
    o = flash_prefill(qf, kdq, vdq, kv_offset=t0, carry=carry, **kw)
    o = o.reshape(1, s, -1).to(COMPUTE_DTYPE)
    return dense(o, p["wo"], cfg.quant.attn_out)


def _logistic(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), every op rounded to x's dtype: XLA's expansion of
    ``lax.logistic`` (``torch.sigmoid`` rounds once instead)."""
    return 1.0 / (1.0 + torch.exp(-x))


class _SiLU(torch.autograd.Function):
    """x * logistic(x) whose backward is JAX's: ``lax.logistic``'s
    derivative is g * (ans * (1 - ans)), and the product rule adds
    g * ans, every op in x's dtype."""

    @staticmethod
    def forward(ctx, x):
        s = _logistic(x)
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (x * g) * (s * (1.0 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * logistic(x) as the JAX package's bf16 ``jax.nn.silu`` evaluates
    it, forward and backward (see ``_logistic`` and ``_SiLU``)."""
    return _SiLU.apply(x)


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              dist: Dist = LOCAL) -> torch.Tensor:
    """SwiGLU.  Under a sharded ``dist`` every weight is split on its
    output dim: w_gate/w_up give the rank's d_ff slice, the gate is
    elementwise, the hidden is gathered to the full d_ff for w_down's
    contraction, and w_down's d_model slice is gathered back."""
    g = dense(x, p["w_gate"], cfg.quant.mlp_up)
    u = dense(x, p["w_up"], cfg.quant.mlp_up)
    h = silu(g) * u
    if dist.sharded:
        h = gather_cols(h, dist)
        return gather_cols(dense(h, p["w_down"], cfg.quant.mlp_down), dist)
    return dense(h, p["w_down"], cfg.quant.mlp_down)
