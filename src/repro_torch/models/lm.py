"""Dense decoder-only LM: parameters, the training forward and loss, and
the paged serving entry points.

Counterpart of ``repro.models.lm`` for the dense family.  The layer stack
keeps the JAX layout (every per-layer tensor stacked on a leading layer
axis); the ``scan`` over layers is a Python loop, which also takes the
stack as a list of per-layer trees (the trainer's compute copy).  Remat is
left out: it changes memory, not numbers.
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
    """Layer ``i``'s slice of a stacked tree (views, no copies), or entry
    ``i`` of a list of per-layer trees."""
    if isinstance(tree, list):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _check_paged(cfg: ModelConfig) -> None:
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(f"paged serving covers {PAGED_FAMILIES}; "
                         f"family {cfg.family!r} is not ported")


class _EmbedGather(torch.autograd.Function):
    """``embed[tokens]`` with a deterministic backward.

    The gradient is the scatter-add of the rows' cotangents into a zero
    table, in the table's dtype, summing repeated tokens one occurrence at
    a time in token order: each round adds the next occurrence of every
    repeated id with an index write on distinct rows, so no float atomics
    are involved and every run gives the same bits.  This is a sequential
    bf16 sum per row, as XLA's scatter-add on the CPU computes it; PyTorch's
    own ``index_put_(accumulate=True)`` on the card sums in an order that
    can change from run to run.
    """

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.n_rows = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        ids = tokens.reshape(-1).long()
        rows = g.reshape(ids.numel(), -1)
        out = torch.zeros((ctx.n_rows, rows.shape[1]), dtype=g.dtype,
                          device=g.device)
        # occurrence rank of each position among the positions of its id
        order = torch.sort(ids, stable=True).indices
        sid = ids[order]
        pos = torch.arange(ids.numel(), device=ids.device)
        first = torch.ones_like(sid, dtype=torch.bool)
        first[1:] = sid[1:] != sid[:-1]
        start = torch.cummax(torch.where(first, pos, 0), dim=0).values
        rank = torch.empty_like(ids)
        rank[order] = pos - start
        for r in range(int(rank.max()) + 1 if ids.numel() else 0):
            sel = rank == r
            idx = ids[sel]
            out[idx] = out[idx] + rows[sel]
        return out, None


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return _EmbedGather.apply(params["embed"], tokens.long()).to(
        L.COMPUTE_DTYPE)


def _unembed(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    # the tied head is a transposed VIEW of the embedding: the GEMM kernel
    # reads it through its strides, no copy is made
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.dense(x, head, cfg.quant.lm_head)


def forward_hidden(params: Params, batch: dict, cfg: ModelConfig
                   ) -> torch.Tensor:
    """Full-sequence forward up to the final hidden state (B, S, D) bf16;
    ``batch["tokens"]`` (B, S)."""
    _check_paged(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        x = x + L.attn_apply(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                             cfg, positions=positions)
        z = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], z, cfg)
    return x


def forward(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence forward: logits (B, S, V) bf16."""
    return _unembed(params, forward_hidden(params, batch, cfg), cfg)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy in f32: logsumexp as the JAX package takes
    it (max subtracted, exp, sum, log, max added back)."""
    logits = forward(params, batch, cfg)
    tokens = batch["tokens"]
    tgt = tokens[:, 1:].long()
    lg = logits[:, :-1].to(torch.float32)
    amax = lg.detach().amax(dim=-1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, 0.0)
    lse = torch.log(torch.sum(torch.exp(lg - amax), dim=-1)) + amax[..., 0]
    gold = torch.take_along_dim(lg, tgt[..., None], dim=-1)[..., 0]
    ce = lse - gold
    loss = L.true_div(torch.sum(ce), ce.numel())
    return loss, {"ce": loss}


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
