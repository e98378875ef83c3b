"""Model API: the launcher-facing model and the paged serving protocol.

Counterpart of ``repro.models.api`` for the dense family's serving path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

__all__ = ["Model", "get_model", "PagedModel", "get_paged_model",
           "paged_init_state", "PrefillRequest", "DecodeRequest"]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable  # (generator, device) -> params


def get_model(cfg: ModelConfig) -> Model:
    lm._check_paged(cfg)
    return Model(cfg=cfg,
                 init_params=lambda gen, device: lm.init_params(cfg, gen,
                                                                device))


@dataclass(frozen=True)
class PrefillRequest:
    """One prefill slab of one sequence: the slab's ``tokens``, the
    sequence's history pages and the slab's pages, the slab's absolute
    page-aligned offset ``t0``, the bucket's carry format, whether this is
    the prompt's last slab, and the bucket's page-row width and
    ``AttnCall``."""

    rid: int
    tokens: tuple
    hist_pages: tuple
    slab_pages: tuple
    t0: int
    acc: tuple
    final: bool
    bucket_pages: int | None = None
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
class PagedModel:
    """The paged serving protocol the executor drives."""

    cfg: ModelConfig
    prefill: Callable
    decode: Callable


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

    return PagedModel(cfg=cfg, prefill=_prefill, decode=_decode)
