"""Layer functions of the dense decoder (plain functions on tensors).

Counterpart of ``repro.models.layers`` for the dense family: training
attention (``attn_apply``), the paged serving entries and the SwiGLU MLP.
Params are nested dicts of tensors; compute is bf16 with float32 where the
JAX package uses it.  Every dense GEMM goes through ``dense``, which runs
the differentiable quantized ``qdot`` when the model's QuantPlan assigns a
config.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels.attention import flash_prefill_paged, paged_attn_decode
from repro_torch.kernels.ops import QDotConfig, qdot
from repro_torch.models.config import ModelConfig
from repro_torch.serve import kvcache as KV

Params = dict[str, Any]

COMPUTE_DTYPE = torch.bfloat16


def dense(x: torch.Tensor, w: torch.Tensor, qcfg: QDotConfig | None = None,
          bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w (+ bias), bf16 out.

    With a QDotConfig: float32 x into ``qdot`` (the bf16 weights go to the
    kernel as they are: bf16 -> f32 is exact, and a float32 copy of the
    weights is never made), output cast to bf16, bias added in bf16.
    Without: a bf16 product (the JAX package leaves it to XLA's dot).
    """
    if qcfg is not None and not qcfg.is_exact:
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


def attn_decode_paged(p: Params, x: torch.Tensor, kv: dict[str, torch.Tensor],
                      page_table: torch.Tensor, positions: torch.Tensor,
                      seq_lens: torch.Tensor, cfg: ModelConfig, *, kv_fmt,
                      acc: tuple[int, int]) -> torch.Tensor:
    """One-token decode against a layer's arena slice ``kv`` (updated in
    place).  ``x`` (B, 1, D); ``page_table`` (B, W) int32; ``positions``
    (B,) each row's write position; ``seq_lens`` (B,) int32 attended
    tokens including this one, 0 for padded rows (whose write lands in the
    null page)."""
    b = x.shape[0]
    pos2 = positions[:, None]
    q = _q_proj(p, x, cfg, pos2)                   # (B, 1, H, dh)
    k1, v1 = _kv_proj(p, x, cfg, pos2)
    page_size = kv["k"].shape[2]
    page_id = torch.gather(page_table.long(), 1,
                           (positions // page_size)[:, None].long())[:, 0]
    slot = (positions % page_size).long()
    KV.append_token(kv["k"], kv["k_se"], k1[:, 0].to(torch.float32),
                    page_id, slot, kv_fmt)
    KV.append_token(kv["v"], kv["v_se"], v1[:, 0].to(torch.float32),
                    page_id, slot, kv_fmt)
    o = paged_attn_decode(q[:, 0].to(torch.float32), kv["k"], kv["v"],
                          kv["k_se"], kv["v_se"], page_table, seq_lens,
                          kv_fmt=kv_fmt, acc=acc)
    o = o.reshape(b, 1, -1).to(COMPUTE_DTYPE)
    return dense(o, p["wo"], cfg.quant.attn_out)


def attn_prefill_bucketed(p: Params, x: torch.Tensor,
                          kv: dict[str, torch.Tensor], page_row: torch.Tensor,
                          slab_page_ids: torch.Tensor, q_offset: int,
                          q_len: int, cfg: ModelConfig, *, kv_fmt,
                          acc: tuple[int, int], call=None) -> torch.Tensor:
    """One prefill slab of one sequence through a layer.  ``x`` (1, T, D)
    holds the slab (rows ``>= q_len`` are padding, zeroed before the
    arena write); the slab's K/V are quantized into ``slab_page_ids``, then
    one ``flash_prefill_paged`` call attends history and slab off the
    updated arena.  ``q_offset``/``q_len`` are host ints."""
    t = x.shape[1]
    positions = (q_offset + torch.arange(t, device=x.device))[None]
    q = _q_proj(p, x, cfg, positions)              # (1, T, H, dh)
    k, v = _kv_proj(p, x, cfg, positions)
    live = (torch.arange(t, device=x.device) < q_len)[:, None, None]
    kf = torch.where(live, k[0].to(torch.float32), 0.0)
    vf = torch.where(live, v[0].to(torch.float32), 0.0)
    KV.write_prompt(kv["k"], kv["k_se"], kf, slab_page_ids, kv_fmt)
    KV.write_prompt(kv["v"], kv["v_se"], vf, slab_page_ids, kv_fmt)
    o = flash_prefill_paged(q[0].to(torch.float32), kv["k"], kv["v"],
                            kv["k_se"], kv["v_se"], page_row, q_offset,
                            q_len, q_offset + q_len, kv_fmt=kv_fmt, acc=acc,
                            call=call)
    o = o.reshape(1, t, -1).to(COMPUTE_DTYPE)
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


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU."""
    g = dense(x, p["w_gate"], cfg.quant.mlp_up)
    u = dense(x, p["w_up"], cfg.quant.mlp_up)
    return dense(silu(g) * u, p["w_down"], cfg.quant.mlp_down)
