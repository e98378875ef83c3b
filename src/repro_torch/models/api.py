"""Model API: the launcher-facing model and the paged serving protocol.

Counterpart of ``repro.models.api`` for the dense family: training
(``Model.loss_fn``), the GEMM work-list ``dense_gemm_shapes`` and serving.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

__all__ = ["Model", "get_model", "param_count", "dense_gemm_shapes",
           "PagedModel", "get_paged_model", "paged_init_state",
           "PrefillRequest", "DecodeRequest", "VerifyRequest"]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable  # (generator, device) -> params
    loss_fn: Callable      # (params, batch, cfg) -> (loss, metrics)


def get_model(cfg: ModelConfig) -> Model:
    lm._check_paged(cfg)
    return Model(cfg=cfg,
                 init_params=lambda gen, device: lm.init_params(cfg, gen,
                                                                device),
                 loss_fn=lm.loss_fn)


def param_count(params: Any) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def dense_gemm_shapes(cfg: ModelConfig, *, seq_len: int, global_batch: int
                      ) -> list[tuple[str, int, int, int, Any]]:
    """Every quantized dense GEMM of one layer, and the lm_head, as (tag, M,
    K, N, qcfg): M the tokens of a step, K/N the fan-in/fan-out, ``qcfg``
    the layer's ``QDotConfig`` from the plan (exact GEMMs are left out).
    The lm_head comes first, then one layer's GEMMs in the order it runs
    them."""
    t = seq_len * global_batch
    d, dh = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    f = cfg.d_ff or d
    q = cfg.quant
    entries = [("lm_head", t, d, cfg.vocab_size, q.lm_head),
               ("attn_q", t, d, h * dh, q.attn_qkv),
               ("attn_k", t, d, kv * dh, q.attn_qkv),
               ("attn_v", t, d, kv * dh, q.attn_qkv),
               ("attn_out", t, h * dh, d, q.attn_out),
               ("mlp_gate", t, d, f, q.mlp_up),
               ("mlp_up", t, d, f, q.mlp_up),
               ("mlp_down", t, f, d, q.mlp_down)]
    return [e for e in entries if e[4] is not None and not e[4].is_exact]


@dataclass(frozen=True)
class PrefillRequest:
    """One prefill slab of one sequence: the slab's ``tokens``, the
    sequence's history pages and the slab's pages, the slab's absolute
    page-aligned offset ``t0``, the bucket's carry format, whether this is
    the prompt's last slab, the bucket's page-row width, the padded slab
    width (``slab_width``: tokens past the slab's are zeros, as the JAX
    executor pads for its compiled signature; None = unpadded) and the
    bucket's ``AttnCall``."""

    rid: int
    tokens: tuple
    hist_pages: tuple
    slab_pages: tuple
    t0: int
    acc: tuple
    final: bool
    bucket_pages: int | None = None
    slab_width: int | None = None
    call: Any = None


@dataclass(frozen=True)
class DecodeRequest:
    """One batched decode step: per-sequence parallel tuples plus the page
    table and the batch bucket's carry format."""

    rids: tuple
    last_tokens: tuple
    page_table: tuple
    positions: tuple
    seq_lens: tuple
    acc: tuple


@dataclass(frozen=True)
class VerifyRequest:
    """One batched speculative-verify step: per-sequence parallel tuples as
    in ``DecodeRequest``, but ``tokens`` holds ``k + 1`` candidates a row
    (the last committed token and the draft's proposals), ``positions``
    the first write position of each row and ``seq_lens`` the attended
    length at slab index 0 (``positions + 1``)."""

    rids: tuple
    tokens: tuple          # of per-sequence (k + 1)-tuples
    page_table: tuple
    positions: tuple
    seq_lens: tuple
    acc: tuple


@dataclass(frozen=True)
class PagedModel:
    """The paged serving protocol the executor drives."""

    cfg: ModelConfig
    prefill: Callable
    decode: Callable
    verify: Callable | None = None


def paged_init_state(cfg: ModelConfig, *, n_pages: int, page_size: int,
                     device, kv_fmt=None) -> dict:
    """The paged KV arena of every attention layer, on ``device``."""
    from repro_torch.serve.kvcache import PagedKVConfig, init_arena

    lm._check_paged(cfg)
    return init_arena(PagedKVConfig.for_model(
        cfg, n_pages=n_pages, page_size=page_size, kv_fmt=kv_fmt), device)


def get_paged_model(cfg: ModelConfig) -> PagedModel:
    lm._check_paged(cfg)

    def _prefill(params, tokens, kv_state, page_row, slab_page_ids,
                 q_offset, q_len, **kw):
        return lm.paged_prefill(params, tokens, kv_state, page_row,
                                slab_page_ids, q_offset, q_len, cfg, **kw)

    def _decode(params, tokens, kv_state, page_table, positions, seq_lens,
                **kw):
        return lm.paged_decode(params, tokens, kv_state, page_table,
                               positions, seq_lens, cfg, **kw)

    def _verify(params, tokens, kv_state, page_table, positions, seq_lens,
                **kw):
        return lm.paged_verify(params, tokens, kv_state, page_table,
                               positions, seq_lens, cfg, **kw)

    return PagedModel(cfg=cfg, prefill=_prefill, decode=_decode,
                      verify=_verify)
