"""Layer functions of the decoder (plain functions on tensors).

Counterpart of ``repro.models.layers`` for the dense family (with qwen3's
qk-norm: q and k rms-normed per head after the bias and before RoPE, in
every path that projects them) and the MoE block (``moe_apply``: top-k
routing, fixed capacity, the expert MLPs one ``qdot`` a GEMM); training
attention (``attn_apply``), the legacy static batch's decode over a dense
bf16 cache (``attn_decode``, ``attn_cache_init``), the paged serving
entries (the bucketed slab
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
Under data-parallel training (a ``dist.Dist`` whose batch rows are split
over ranks, ``dist.batch_split``) each rank runs the training functions on
its rows, and every reduction over tokens runs on the global batch's
full shape, as the single device runs it: the GEMMs' GRAD through
``qdot``'s K-slices, and the norm scales' and qkv biases' gradients as the
same reduction of the per-token products gathered over the batch ranks
(``_MeshScale``, ``_MeshBias``); so each gradient is the single device's
bit for bit.  The ranks of a replica axis (the model axis) hold the same
rows: each GEMM splits its output columns over them and gathers them
(``qdot``), and everything else runs whole on each of them.

Params are nested dicts of tensors; compute is bf16 with float32 where the
JAX package uses it.  Every dense GEMM goes through ``dense``, which runs
the differentiable quantized ``qdot`` when the model's QuantPlan assigns a
config.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.dist import (LOCAL, Dist, all_gather, all_to_all,
                              cat_over, gather_cols, gather_rows, k_slice,
                              psum_carry)
from repro_torch.kernels.attention import (
    BLOCK_Q,
    NEG,
    AttnCall,
    finalize_carry,
    flash_prefill,
    flash_prefill_paged,
    flash_prefill_paged_geom,
    flash_prefill_paged_geom_reference,
    flash_prefill_paged_reference,
    paged_attn_decode,
    paged_attn_decode_reference,
    prefill_geom,
)
from repro_torch.kernels.ops import QDotConfig, qdot
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.serve import kvcache as KV

Params = dict[str, Any]

COMPUTE_DTYPE = torch.bfloat16


class _MeshBias(torch.autograd.Function):
    """``y + b`` of row-split y; b's gradient is the single device's: the
    cotangent gathered over the batch ranks and summed to b's shape."""

    @staticmethod
    def forward(ctx, y, b, dist):
        ctx.dist, ctx.shape = dist, b.shape
        return y + b

    @staticmethod
    def backward(ctx, g):
        return g, gather_rows(g, ctx.dist).sum_to_size(ctx.shape), None


class _MeshScale(torch.autograd.Function):
    """``a * s`` of row-split a and a broadcast scale s; s's gradient is
    the single device's: ``g * a`` gathered over the batch ranks and
    summed to s's shape (autograd's own reduction, on the full shape)."""

    @staticmethod
    def forward(ctx, a, s, dist):
        ctx.dist = dist
        ctx.save_for_backward(a, s)
        return a * s

    @staticmethod
    def backward(ctx, g):
        a, s = ctx.saved_tensors
        gs = gather_rows(g * a, ctx.dist).sum_to_size(s.shape)
        return g * s, gs, None


class _MeshMatmul(torch.autograd.Function):
    """The exact plan's bf16 ``x @ w`` under a mesh (x this rank's rows):
    the whole y and dx on the rank's rows, dw on its K-slice of every row
    (the global batch's contraction) and gathered, as ``qdot``'s backward
    splits it."""

    @staticmethod
    def forward(ctx, x, w, dist):
        ctx.dist = dist
        ctx.save_for_backward(x, w)
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dist = ctx.dist
        k = w.shape[0]
        r0, _, _ = k_slice(k, dist)
        per = k // dist.replica_size
        x2, g2 = x.reshape(-1, k), g.reshape(-1, w.shape[1])
        x_cols = all_to_all(x2[:, r0:r0 + per], dist, dist.batch_axes,
                            split_dim=1, cat_dim=0)
        dw_s = x_cols.t().mm(gather_rows(g2, dist))
        dw = cat_over(torch.cat(all_gather(dw_s, dist, dist.batch_axes),
                                 dim=0), dist, dist.replica_axes, 0)
        return g2.mm(w.t()).reshape(x.shape), dw, None


def dense(x: torch.Tensor, w: torch.Tensor, qcfg: QDotConfig | None = None,
          bias: torch.Tensor | None = None, out_fmt=None,
          dist: Dist = LOCAL) -> torch.Tensor:
    """y = x @ w (+ bias), bf16 out.

    With a QDotConfig: float32 x into ``qdot`` (the bf16 weights go to the
    kernel as they are: bf16 -> f32 is exact, and a float32 copy of the
    weights is never made), output cast to bf16, bias added in bf16.
    Without: a bf16 product (the JAX package leaves it to XLA's dot).

    ``out_fmt`` is the consumer-format hint: the (1, e, m) format of the
    op that takes y unchanged, into which the GEMM's epilogue rounds y
    (replacing the config's ``out_fmt``), so that op can skip its own
    quantization; straight-through in the backward.

    ``dist`` with a row split: x holds this rank's rows (module
    docstring).
    """
    split = dist.batch_split
    if qcfg is not None and not qcfg.is_exact:
        if out_fmt is not None and out_fmt != qcfg.out_fmt:
            qcfg = dataclasses.replace(qcfg, out_fmt=out_fmt)
        y = qdot(x.to(torch.float32), w, qcfg, dist=dist).to(COMPUTE_DTYPE)
    elif dist.mesh_split and torch.is_grad_enabled():
        y = _MeshMatmul.apply(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE), dist)
    else:
        y = torch.matmul(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))
    if bias is not None:
        b = bias.to(y.dtype)
        y = _MeshBias.apply(y, b, dist) if split and \
            torch.is_grad_enabled() else y + b
    return y


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             dist: Dist = LOCAL) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    a = xf * torch.rsqrt(var + eps)
    s = scale.to(torch.float32)
    if dist.batch_split and torch.is_grad_enabled():
        out = _MeshScale.apply(a, s, dist)
    else:
        out = a * s
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
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=torch.float32, device=device)
    return p


def mlp_init(gen: torch.Generator, cfg: ModelConfig, device,
             d_ff: int | None = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": _normal(gen, (d, f), 1.0 / math.sqrt(d), device),
        "w_up": _normal(gen, (d, f), 1.0 / math.sqrt(d), device),
        "w_down": _normal(gen, (f, d), 1.0 / math.sqrt(f)
                          / math.sqrt(2 * cfg.n_layers), device),
    }


def _q_proj(p: Params, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor, dist: Dist = LOCAL) -> torch.Tensor:
    b, s, _ = x.shape
    q = dense(x, p["wq"], cfg.quant.attn_qkv, p.get("bq"),
              dist=dist).reshape(b, s, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, dist)
    return rope(q, positions, cfg.rope_theta)


def _kv_proj(p: Params, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, dist: Dist = LOCAL):
    b, s, _ = x.shape
    dh = cfg.head_dim
    k = dense(x, p["wk"], cfg.quant.attn_qkv, p.get("bk"),
              dist=dist).reshape(b, s, -1, dh)
    v = dense(x, p["wv"], cfg.quant.attn_qkv, p.get("bv"),
              dist=dist).reshape(b, s, -1, dh)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, dist)
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
               positions: torch.Tensor, dist: Dist = LOCAL) -> torch.Tensor:
    """Causal (training) self-attention over x (B, S, D) at ``positions``
    (B, S); plain PyTorch ops, differentiable.  ``dist``: a row-split
    batch's (module docstring)."""
    k, v = _kv_proj(p, x, cfg, positions, dist)
    m = positions[:, :, None] >= positions[:, None, :]          # (B, S, S)
    mask = m[:, None, None]                                     # (B,1,1,S,S)
    q = _q_proj(p, x, cfg, positions, dist)
    o = _gqa_attend(q, k, v, mask, cfg)
    return dense(o, p["wo"], cfg.quant.attn_out, dist=dist)


def attn_decode(p: Params, x: torch.Tensor, cache: dict[str, torch.Tensor],
                pos, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode of the legacy static batch against a dense bf16
    cache.  ``x`` (b, 1, d); ``cache`` k/v (b, T, kv, dh); ``pos`` the
    position of this token for every row, an int or a 0-d integer tensor
    on x's device (never read on the host).  This token's K/V are written
    at ``pos`` in place (JAX's ``dynamic_update_slice``); the queries
    attend cache slots ``<= pos`` through ``_gqa_attend``'s f32 einsums (no
    kernel); ``wo`` goes through ``dense``.  Returns (y (b, 1, d), the
    cache)."""
    b = x.shape[0]
    pos_t = torch.as_tensor(pos, device=x.device).to(torch.long).reshape(1)
    positions = pos_t.expand(b)[:, None]
    q = _q_proj(p, x, cfg, positions)
    k1, v1 = _kv_proj(p, x, cfg, positions)
    ck, cv = cache["k"], cache["v"]
    ck.index_copy_(1, pos_t, k1.to(ck.dtype))
    cv.index_copy_(1, pos_t, v1.to(cv.dtype))
    t = ck.shape[1]
    mask = (torch.arange(t, device=x.device) <= pos_t)[None, None, None,
                                                        None]
    o = _gqa_attend(q, ck.to(COMPUTE_DTYPE), cv.to(COMPUTE_DTYPE), mask, cfg)
    return dense(o, p["wo"], cfg.quant.attn_out), cache


def attn_cache_init(cfg: ModelConfig, batch: int, max_t: int,
                    device) -> dict[str, torch.Tensor]:
    """The legacy decode's zero bf16 cache, k and v (batch, max_t, kv,
    dh)."""
    shape = (batch, max_t, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}


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
                      acc: tuple[int, int], dist: Dist = LOCAL,
                      oracle: bool = False) -> torch.Tensor:
    """One-token decode against a layer's arena slice ``kv`` (updated in
    place).  ``x`` (B, 1, D); ``page_table`` (B, W) int32; ``positions``
    (B,) each row's write position; ``seq_lens`` (B,) int32 attended
    tokens including this one, 0 for padded rows (whose write lands in the
    null page).  Under a sharded ``dist`` each rank walks its own heads
    (D's carry entry) and the carries merge exactly.  ``oracle``: the
    attention through D's plain version, on any device (JAX's
    ``oracle=True``, its jnp reference)."""
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
    decode = paged_attn_decode_reference if oracle else paged_attn_decode
    if ax is None:
        o = decode(*args, kv_fmt=kv_fmt, acc=acc)
    else:
        o = _merge_sharded_carry(*decode(
            *args, kv_fmt=kv_fmt, acc=acc, return_carry=True), dist)
    o = o.reshape(b, 1, -1).to(COMPUTE_DTYPE)
    y = dense(o, p["wo"], cfg.quant.attn_out)
    return y if ax is None else gather_cols(y, dist)


def attn_verify_paged(p: Params, x: torch.Tensor, kv: dict[str, torch.Tensor],
                      page_table: torch.Tensor, positions: torch.Tensor,
                      seq_lens: torch.Tensor, cfg: ModelConfig, *, kv_fmt,
                      acc: tuple[int, int], dist: Dist = LOCAL,
                      oracle: bool = False) -> torch.Tensor:
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
    (D's carry entry) and the carries merge exactly.  ``oracle``: D's
    plain version, as ``attn_decode_paged``."""
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
    decode = paged_attn_decode_reference if oracle else paged_attn_decode
    if ax is None:
        o = decode(*args, kv_fmt=kv_fmt, acc=acc)
    else:
        o = _merge_sharded_carry(*decode(
            *args, kv_fmt=kv_fmt, acc=acc, return_carry=True), dist)
    o = o.reshape(b, s, -1).to(COMPUTE_DTYPE)
    y = dense(o, p["wo"], cfg.quant.attn_out)
    return y if ax is None else gather_cols(y, dist)


def attn_prefill_bucketed(p: Params, x: torch.Tensor,
                          kv: dict[str, torch.Tensor], page_row: torch.Tensor,
                          slab_page_ids: torch.Tensor, q_offset, q_len,
                          cfg: ModelConfig, *, kv_fmt,
                          acc: tuple[int, int], call=None,
                          dist: Dist = LOCAL,
                          oracle: bool = False) -> torch.Tensor:
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
    carries merge exactly.  ``oracle``: P's plain versions (eager only:
    the host-int one reads its geometry on the host)."""
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
    geom_fn, host_fn = ((flash_prefill_paged_geom_reference,
                         flash_prefill_paged_reference) if oracle else
                        (flash_prefill_paged_geom, flash_prefill_paged))
    if on_device:
        if ax is not None:
            raise NotImplementedError(
                "the sharded prefill takes its geometry as host ints")
        o = geom_fn(*pages, prefill_geom(q_offset, q_len), kv_fmt=kv_fmt,
                    acc=acc, call=call)
    elif ax is None:
        o = host_fn(*pages, q_offset, q_len, q_offset + q_len,
                    kv_fmt=kv_fmt, acc=acc, call=call)
    else:
        o = _merge_sharded_carry(*host_fn(
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
    call = AttnCall(e_acc=acc[0], m_acc=acc[1], chunk=kv["k"].shape[2],
                    block_q=block_q or BLOCK_Q)
    o = flash_prefill(q[0].to(torch.float32), kdq, vdq, call=call)
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
    # the history pass (carry out) and the slab's pass (resumed at t0),
    # each one AttnCall of the dense kernel
    call = AttnCall(e_acc=acc[0], m_acc=acc[1], chunk=page_size,
                    block_q=block_q or BLOCK_Q, q_offset=t0)
    qf = q[0].to(torch.float32)
    carry = None
    if t0 > 0:
        kh = KV.gather_pages(kv["k"], kv["k_se"], hist_page_ids, kv_fmt)
        vh = KV.gather_pages(kv["v"], kv["v_se"], hist_page_ids, kv_fmt)
        carry = flash_prefill(qf, kh[:t0], vh[:t0], call=dataclasses.replace(
            call, return_carry=True))
    o = flash_prefill(qf, kdq, vdq, carry=carry,
                      call=dataclasses.replace(call, kv_offset=t0))
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
    g = dense(x, p["w_gate"], cfg.quant.mlp_up, dist=dist)
    u = dense(x, p["w_up"], cfg.quant.mlp_up, dist=dist)
    h = silu(g) * u
    if dist.sharded:
        h = gather_cols(h, dist)
        return gather_cols(dense(h, p["w_down"], cfg.quant.mlp_down), dist)
    return dense(h, p["w_down"], cfg.quant.mlp_down, dist=dist)


# --------------------------------------------------------------------------
# MoE (top-k routing, fixed capacity; the expert-parallel branch waits for
# ROADMAP [moe-ep])
# --------------------------------------------------------------------------


def moe_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d = cfg.d_model
    mc: MoEConfig = cfg.moe
    e, f = mc.n_experts, mc.d_ff_expert
    p: Params = {
        "router": _normal(gen, (d, e), 1.0 / math.sqrt(d), device),
        "w_gate": _normal(gen, (e, d, f), 1.0 / math.sqrt(d), device),
        "w_up": _normal(gen, (e, d, f), 1.0 / math.sqrt(d), device),
        "w_down": _normal(gen, (e, f, d), 1.0 / math.sqrt(f)
                          / math.sqrt(2 * cfg.n_layers), device),
    }
    if mc.n_shared:
        p["shared"] = mlp_init(gen, cfg, device,
                               d_ff=mc.n_shared * mc.d_ff_expert)
    return p


def _moe_fused_enabled() -> bool:
    """The expert MLPs run through ``qdot`` (kernel G forward, B backward)
    unless ``REPRO_MOE_FUSED=0`` (the JAX package's knob), which selects
    the einsum route."""
    import os

    return os.environ.get("REPRO_MOE_FUSED", "1") != "0"


# the expert GEMMs' config (and the router's, ``_moe_route``): no
# representation format, the (8, 23) carry at the wide chunk 128 in all
# three roles (JAX's QDotConfig(table_dtype="bf16"); the port picks
# schedules from shapes, so the label has no counterpart)
_EXPERT_QCFG = QDotConfig()


def _moe_expert_mlp_fused(h: torch.Tensor, wl: torch.Tensor,
                          wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """The per-expert SwiGLU, one ``qdot`` a GEMM (3 G launches an expert
    forward, 3 B launches backward).  ``h`` (E, cap, D) bf16.  The weights
    go to the kernels as bf16, the values of JAX's float32 copies of the
    bf16-rounded weights (bf16 -> f32 is exact), and their gradients come
    back rounded to bf16 once, as JAX's casts round them."""
    outs = []
    for i in range(h.shape[0]):
        hi = h[i].to(torch.float32)
        g = qdot(hi, wl[i].to(COMPUTE_DTYPE), _EXPERT_QCFG).to(COMPUTE_DTYPE)
        u = qdot(hi, wu[i].to(COMPUTE_DTYPE), _EXPERT_QCFG).to(COMPUTE_DTYPE)
        a = (silu(g) * u).to(torch.float32)
        outs.append(qdot(a, wd[i].to(COMPUTE_DTYPE),
                         _EXPERT_QCFG).to(COMPUTE_DTYPE))
    return torch.stack(outs)


def _moe_expert_mlp_einsum(h: torch.Tensor, wl: torch.Tensor,
                           wu: torch.Tensor, wd: torch.Tensor
                           ) -> torch.Tensor:
    """JAX's einsum route (``REPRO_MOE_FUSED=0``): bf16 operands, float32
    accumulation (products of bf16 values are exact in float32, so the
    GEMMs run on float32 copies), bf16 out."""
    def bmm(a, w):
        return torch.bmm(a.to(torch.float32),
                         w.to(COMPUTE_DTYPE).to(torch.float32)).to(
                             COMPUTE_DTYPE)

    return bmm(silu(bmm(h, wl)) * bmm(h, wu), wd)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` on the last dim: the k largest values and their
    indices, largest first and the lowest index first among equals (a
    stable descending sort; ``torch.topk`` promises no order among
    equals)."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last dim: exp of x less its (constant)
    max, over the sum."""
    u = torch.exp(x - x.detach().amax(dim=-1, keepdim=True))
    return u / u.sum(dim=-1, keepdim=True)


class MoERoute(NamedTuple):
    """Where ``_moe_route`` sends each (token, slot) pair of T tokens: the
    renormalized gates (T, k) float32 and experts (T, k), the expert
    buffer row of each pair in token-then-slot order (T * k,) (``e_loc *
    cap``, the sink, for a dropped or non-local pair), whether it was kept,
    the capacity, and the load-balance aux loss."""

    gate: torch.Tensor
    idx: torch.Tensor
    slot: torch.Tensor
    ok: torch.Tensor
    cap: int
    aux: torch.Tensor


def _moe_route(p: Params, x2: torch.Tensor, cfg: ModelConfig,
               ep_rank: int = 0, ep_size: int = 1) -> MoERoute:
    """JAX's routing of the tokens ``x2`` (T, D) over the experts
    ``ep_rank`` holds of ``ep_size`` ranks: the router's bf16 output (JAX's
    exact ``dense``) in float32, softmax, top-k (``top_k``), the gates
    renormalized over the k (summed in slot order); each expert keeps the
    first ``cap = max(int(capacity_factor * k * T / E), 1)`` of its pairs
    in token-then-slot order and drops the rest.

    The router's GEMM runs on G at the experts' wide config (bf16 values,
    float32 accumulation in a fixed order, one rounding to bf16), not on a
    cuBLAS bf16 GEMM: cuBLAS may pick another algorithm, with another
    summation order, when the step is captured in a CUDA graph, and the
    routing must be the same bits eager and graphed."""
    mc: MoEConfig = cfg.moe
    t = x2.shape[0]
    e, k = mc.n_experts, mc.top_k
    e_loc = e // ep_size
    dev = x2.device

    logits = qdot(x2.to(torch.float32), p["router"].to(COMPUTE_DTYPE),
                  _EXPERT_QCFG).to(COMPUTE_DTYPE).to(torch.float32)  # (T, E)
    probs = _softmax(logits)
    gate, idx = top_k(probs, k)                                 # (T, k)
    total = gate[:, 0]
    for j in range(1, k):
        total = total + gate[:, j]
    gate = gate / total[:, None]

    # load balance (Switch): E * sum_e fraction_tokens_e * mean_prob_e
    # (counted by comparison: bincount reads its input's max on the host)
    counts = (idx.reshape(-1, 1) == torch.arange(e, device=dev)).sum(
        dim=0).to(torch.float32)
    aux = e * torch.sum(true_div(counts, t * k)
                        * true_div(probs.sum(dim=0), t))

    flat_e = idx.reshape(-1)                                    # (T*k,)
    lo = ep_rank * e_loc
    local = (flat_e >= lo) & (flat_e < lo + e_loc)
    le = torch.clamp(flat_e - lo, 0, e_loc - 1)
    cap = max(int(mc.capacity_factor * k * t / e), 1)
    onehot = (local[:, None] & (le[:, None] == torch.arange(
        e_loc, device=dev)[None, :])).to(torch.int64)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=1)
    ok = local & (pos < cap)
    slot = torch.where(ok, le * cap + pos, e_loc * cap)
    return MoERoute(gate, idx, slot, ok, cap, aux)


def _moe_local(p: Params, x2: torch.Tensor, cfg: ModelConfig,
               ep_rank: int = 0, ep_size: int = 1
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE of the tokens ``x2`` (T, D) over the experts ``ep_rank``
    holds of ``ep_size`` ranks: (this rank's partial output (T, D) bf16,
    the load-balance aux loss).  Routed by ``_moe_route``; the dispatch
    writes each kept pair's token into its expert buffer row (the dropped
    ones into the sink row, thrown away); the combine adds each token's k
    gated contributions in slot order, each add rounded to bf16 (JAX's
    bf16 scatter-add)."""
    t, d = x2.shape
    k = cfg.moe.top_k
    e_loc = cfg.moe.n_experts // ep_size
    dev = x2.device
    r = _moe_route(p, x2, cfg, ep_rank, ep_size)
    flat_tok = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)

    buf = torch.zeros((e_loc * r.cap + 1, d), dtype=COMPUTE_DTYPE, device=dev)
    buf = buf.index_put((r.slot,), x2.to(COMPUTE_DTYPE)[flat_tok])
    h = buf[:-1].reshape(e_loc, r.cap, d)

    expert = (_moe_expert_mlp_fused if _moe_fused_enabled()
              else _moe_expert_mlp_einsum)
    o = expert(h, p["w_gate"], p["w_up"], p["w_down"])

    o_flat = torch.cat([o.reshape(e_loc * r.cap, d),
                        torch.zeros((1, d), dtype=COMPUTE_DTYPE, device=dev)])
    gate = r.gate.reshape(-1).to(COMPUTE_DTYPE) * r.ok.to(COMPUTE_DTYPE)
    contrib = (o_flat[r.slot] * gate[:, None]).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=COMPUTE_DTYPE, device=dev)
    for j in range(k):
        y = y + contrib[:, j]
    return y, r.aux


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              dist: Dist = LOCAL) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y, aux float32): every token routed over all the
    experts on this device (JAX's single-device branch), plus the shared
    experts' SwiGLU.  The expert-parallel branch (the experts over the
    model axis) is not ported: a mesh or a sharded serve group raises."""
    if dist.mesh is not None or dist.sharded:
        raise NotImplementedError(
            "MoE under a mesh or a tensor-parallel serve group is not "
            "ported yet (ROADMAP [moe-ep]: moe_apply's expert-parallel "
            "branch)")
    b, s, d = x.shape
    y, aux = _moe_local(p, x.reshape(b * s, d), cfg)
    out = y.reshape(b, s, d)
    if cfg.moe.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg)
    return out, aux.to(torch.float32)
