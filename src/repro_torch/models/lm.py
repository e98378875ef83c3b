"""Dense decoder-only LM: parameters and the paged serving entry points.

Counterpart of ``repro.models.lm`` for the serving slice.  The layer stack
keeps the JAX layout (every per-layer tensor stacked on a leading layer
axis); the ``scan`` over layers is a Python loop.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]

PAGED_FAMILIES = ("dense",)


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """float32 parameters with the JAX package's shapes and scales, drawn
    from ``gen`` (a generator on ``device``)."""
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not ported")
    d = cfg.d_model
    p: Params = {
        # std d^-1/2 keeps tied-head logits O(1) at init
        "embed": L._normal(gen, (cfg.vocab_size, d), 1.0 / d ** 0.5, device),
        "final_norm": torch.ones((d,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._normal(gen, (d, cfg.vocab_size), 1.0 / d ** 0.5,
                                 device)
    blocks = [{
        "ln1": torch.ones((d,), dtype=torch.float32, device=device),
        "ln2": torch.ones((d,), dtype=torch.float32, device=device),
        "attn": L.attn_init(gen, cfg, device),
        "mlp": L.mlp_init(gen, cfg, device),
    } for _ in range(cfg.n_layers)]
    p["layers"] = _stack(blocks)
    return p


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i``'s slice of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _check_paged(cfg: ModelConfig) -> None:
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(f"paged serving covers {PAGED_FAMILIES}; "
                         f"family {cfg.family!r} is not ported")


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(L.COMPUTE_DTYPE)


def _unembed(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    # the tied head is a transposed VIEW of the embedding: the GEMM kernel
    # reads it through its strides, no copy is made
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.dense(x, head, cfg.quant.lm_head)


def paged_decode(params: Params, tokens: torch.Tensor, kv_state: dict,
                 page_table: torch.Tensor, positions: torch.Tensor,
                 seq_lens: torch.Tensor, cfg: ModelConfig, *, kv_fmt,
                 acc: tuple[int, int]) -> torch.Tensor:
    """One continuous-batching decode token per sequence: ``tokens`` (B, 1),
    ``page_table`` (B, W) int32, ``positions`` (B,) per-row write
    positions, ``seq_lens`` (B,) int32 (0 for padded rows).  Appends each
    row's K/V to ``kv_state`` in place; returns logits (B, 1, V) bf16."""
    _check_paged(cfg)
    x = _embed(params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        kvl = {name: t[i] for name, t in kv_state.items()}
        x = x + L.attn_decode_paged(
            lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), kvl,
            page_table, positions, seq_lens, cfg, kv_fmt=kv_fmt, acc=acc)
        z = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], z, cfg)
    return _unembed(params, x, cfg)


def paged_prefill(params: Params, tokens: torch.Tensor, kv_state: dict,
                  page_row: torch.Tensor, slab_page_ids: torch.Tensor,
                  q_offset: int, q_len: int, cfg: ModelConfig, *, kv_fmt,
                  acc: tuple[int, int], call=None,
                  want_logits: bool = True) -> torch.Tensor | None:
    """One prefill slab of one sequence through the stack: each layer
    writes the slab's K/V into its pages (in place) and attends history
    and slab in one ``flash_prefill_paged`` pass.  ``tokens`` (1, T);
    ``page_row`` the sequence's pages (int32); ``q_offset``/``q_len``
    host ints.  Returns the logits (1, V) of row ``q_len - 1`` when
    ``want_logits``, else None."""
    _check_paged(cfg)
    if tokens.shape[0] != 1:
        raise ValueError("prefill is per admitted sequence (B = 1)")
    x = _embed(params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        kvl = {name: t[i] for name, t in kv_state.items()}
        x = x + L.attn_prefill_bucketed(
            lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), kvl,
            page_row, slab_page_ids, q_offset, q_len, cfg, kv_fmt=kv_fmt,
            acc=acc, call=call)
        z = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], z, cfg)
    if not want_logits:
        return None
    last = max(q_len - 1, 0)
    return _unembed(params, x[:, last:last + 1], cfg)[:, 0]
