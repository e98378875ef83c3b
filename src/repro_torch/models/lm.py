"""Dense decoder-only LM: parameters, the training forward and loss, and
the paged serving entry points.

Counterpart of ``repro.models.lm`` for the dense family.  The layer stack
keeps the JAX layout (every per-layer tensor stacked on a leading layer
axis); the ``scan`` over layers is a Python loop, which also takes the
stack as a list of per-layer trees (the trainer's compute copy).

Remat, as in the JAX package: the training forward (``remat=True``, the
default) runs each layer under the policy that ``REPRO_REMAT_POLICY``
names when the forward is called (``_remat``).  ``full`` (the default)
keeps a layer's inputs alone and recomputes its forward in the backward;
``dots`` also keeps the outputs of the 2-D matmuls of the differentiated
program (JAX's ``dots_with_no_batch_dims_saveable``); ``none`` keeps
everything autograd saves.  The recompute is bitwise the forward (every
kernel is deterministic and the SR dither is keyed by seed, chunk and
output), so the policy changes memory and time, never numbers.
"""

from __future__ import annotations

import functools
import os
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.dist import LOCAL, Dist, gather_cols
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.telemetry import capture

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


def _unembed(params: Params, x: torch.Tensor, cfg: ModelConfig,
             dist: Dist = LOCAL) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    # the tied head is a transposed VIEW of the embedding: the GEMM kernel
    # reads it through its strides, no copy is made
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if dist.sharded:
        return _unembed_sharded(x, head, cfg, dist)
    return L.dense(x, head, cfg.quant.lm_head)


def _unembed_sharded(x: torch.Tensor, head: torch.Tensor, cfg: ModelConfig,
                     dist: Dist) -> torch.Tensor:
    """The tensor-parallel logits.  ``logit_wire="gather"``: a tied head is
    replicated and its GEMM fully local (trivially exact); an untied
    ``lm_head`` is vocab-split and its logits gathered (pure movement).
    ``logit_wire="int8"``: the head stays replicated, each rank computes
    partial logits over its d_model slice and the partials cross the wire
    as int8 codes under a pmax-shared scale
    (``train.compression.compressed_psum``): exact only where the partials
    sit on the wire's lattice."""
    if dist.logit_wire == "int8":
        from repro_torch.train.compression import compressed_psum

        d_loc = head.shape[0] // dist.size
        lo = dist.rank * d_loc
        part = L.dense(x[..., lo:lo + d_loc], head[lo:lo + d_loc],
                       cfg.quant.lm_head).to(torch.float32)
        logits, _ = compressed_psum(part, dist)
        return logits.to(L.COMPUTE_DTYPE)
    logits = L.dense(x, head, cfg.quant.lm_head)
    if not cfg.tie_embeddings:
        logits = gather_cols(logits, dist)
    return logits


def remat_policy() -> str:
    """The policy ``REPRO_REMAT_POLICY`` names now: ``none``, ``dots``, or
    ``full`` for anything else (the JAX package's reading)."""
    pol = os.environ.get("REPRO_REMAT_POLICY", "full")
    return pol if pol in ("none", "dots") else "full"


def layer_forwards(cfg: ModelConfig) -> int:
    """How many times a training step runs each layer's forward GEMMs under
    the current policy: 2 where the backward recomputes the layer, 1 under
    ``none``.  ``dots`` recomputes them too wherever the plan quantizes a
    GEMM: the hand-written kernels are not matmul ops the policy can keep
    (as JAX's policy cannot keep a ``pallas_call``'s output); the exact
    plan's GEMMs are, and ``dots`` keeps them."""
    pol = remat_policy()
    if pol == "none" or (pol == "dots" and cfg.quant.is_exact):
        return 1
    return 2


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the output of a 2-D matmul of the differentiated program (grad
    mode on: the counterpart of a ``dot_general`` without batch
    dimensions); recompute the rest.  A matmul inside a custom autograd
    function's forward (a GEMM's plain version on the CPU) runs with grad
    mode off and is recomputed, as JAX's policy sees no dot inside a
    ``pallas_call``."""
    if op is torch.ops.aten.mm.default and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _leaves(tree: Any) -> list:
    """The tensors of a nested dict, in its insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _refill(tree: Any, leaves) -> Any:
    """``tree``'s structure holding the tensors drawn from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _refill(v, leaves) for k, v in tree.items()}
    return next(leaves)


def _remat(body):
    """``body(x, lp, positions)`` (one layer; ``lp`` its tree of tensors)
    under the ``REPRO_REMAT_POLICY`` read now, the counterpart of JAX's
    ``_remat``.  ``none`` returns ``body``.  Otherwise the body runs in
    ``torch.utils.checkpoint`` (non-reentrant) with x, the positions and
    the layer's tensors as its saved inputs; ``dots`` adds the selective
    policy ``_dots_policy``.  The body records no telemetry capture itself:
    its recompute runs in the backward, outside the layer loop's
    ``capture.suspended()``."""
    pol = remat_policy()
    if pol == "none":
        return body
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _dots_policy)
                  if pol == "dots" else noop_context_fn)

    def run(x, lp, positions):
        def inner(x, positions, *leaves):
            with capture.suspended():
                return body(x, _refill(lp, iter(leaves)), positions)

        # the body draws no random numbers (the SR dither is keyed), so the
        # RNG state need not be stashed for the recompute
        return checkpoint(inner, x, positions, *_leaves(lp),
                          use_reentrant=False, preserve_rng_state=False,
                          context_fn=context_fn)

    return run


def _block(cfg: ModelConfig, x: torch.Tensor, lp: Params,
           positions: torch.Tensor) -> torch.Tensor:
    """One pre-norm attention + SwiGLU layer."""
    x = x + L.attn_apply(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                         cfg, positions=positions)
    z = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(lp["mlp"], z, cfg)


def forward_hidden(params: Params, batch: dict, cfg: ModelConfig, *,
                   remat: bool = True) -> torch.Tensor:
    """Full-sequence forward up to the final hidden state (B, S, D) bf16;
    ``batch["tokens"]`` (B, S).  ``remat``: each layer under ``_remat``."""
    _check_paged(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    block = functools.partial(_block, cfg)
    if remat:
        block = _remat(block)
    # The telemetry probe must capture the JAX package's set of GEMMs.
    # There the layer stack runs under lax.scan, whose operands are
    # tracers that capture never records: only the GEMMs outside the stack
    # (the lm_head) are replayed, and every layer GEMM is probed on
    # synthetic operands.  So this loop records nothing.
    with capture.suspended():
        for i in range(cfg.n_layers):
            x = block(x, _layer(params["layers"], i), positions)
    return x


def forward(params: Params, batch: dict, cfg: ModelConfig, *,
            remat: bool = True) -> torch.Tensor:
    """Full-sequence forward: logits (B, S, V) bf16."""
    return _unembed(params, forward_hidden(params, batch, cfg, remat=remat),
                    cfg)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig, *,
            remat: bool = True) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy in f32: logsumexp as the JAX package takes
    it (max subtracted, exp, sum, log, max added back)."""
    logits = forward(params, batch, cfg, remat=remat)
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
                 acc: tuple[int, int], dist: Dist = LOCAL) -> torch.Tensor:
    """One continuous-batching decode token per sequence: ``tokens`` (B, 1),
    ``page_table`` (B, W) int32, ``positions`` (B,) per-row write
    positions, ``seq_lens`` (B,) int32 (0 for padded rows).  Appends each
    row's K/V to ``kv_state`` in place; returns logits (B, 1, V) bf16.
    Under a sharded ``dist``: the rank's slices of params and arena, the
    full logits on every rank."""
    _check_paged(cfg)
    x = _embed(params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        kvl = {name: t[i] for name, t in kv_state.items()}
        x = x + L.attn_decode_paged(
            lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), kvl,
            page_table, positions, seq_lens, cfg, kv_fmt=kv_fmt, acc=acc,
            dist=dist)
        z = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], z, cfg, dist)
    return _unembed(params, x, cfg, dist)


def paged_prefill(params: Params, tokens: torch.Tensor, kv_state: dict,
                  page_row: torch.Tensor, slab_page_ids: torch.Tensor,
                  q_offset, q_len, cfg: ModelConfig, *, kv_fmt,
                  acc: tuple[int, int], call=None, want_logits: bool = True,
                  dist: Dist = LOCAL) -> torch.Tensor | None:
    """One prefill slab of one sequence through the stack: each layer
    writes the slab's K/V into its pages (in place) and attends history
    and slab in one P pass.  ``tokens`` (1, T), padded past ``q_len``;
    ``page_row`` the sequence's pages (int32), padded with the null page;
    ``q_offset``/``q_len`` host ints, or 0-d int32 tensors on the device
    (JAX's traced geometry: nothing then reads them on the host, and the
    logits row is taken by a device index).  Returns the logits (1, V) of
    row ``q_len - 1`` (row 0 when ``q_len`` is 0) when ``want_logits``,
    else None."""
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
            acc=acc, call=call, dist=dist)
        z = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], z, cfg, dist)
    if not want_logits:
        return None
    if isinstance(q_len, torch.Tensor):
        last = torch.clamp(q_len.reshape(1).to(device=x.device,
                                               dtype=torch.int64) - 1, min=0)
        row = torch.index_select(x, 1, last)
    else:
        last = max(q_len - 1, 0)
        row = x[:, last:last + 1]
    return _unembed(params, row, cfg, dist)[:, 0]


def paged_verify(params: Params, tokens: torch.Tensor, kv_state: dict,
                 page_table: torch.Tensor, positions: torch.Tensor,
                 seq_lens: torch.Tensor, cfg: ModelConfig, *, kv_fmt,
                 acc: tuple[int, int], dist: Dist = LOCAL) -> torch.Tensor:
    """Speculative-decode verify: ``tokens`` (B, S), the last committed
    token and the k = S - 1 draft proposals of each row, scored in one
    pass, bitwise S sequential ``paged_decode`` steps over the same arena
    (each layer appends the S tokens' K/V slot by slot under the decode
    path's page-scale rule, then attends every slab index as its own
    decode row, ``layers.attn_verify_paged``).  ``positions`` (B,) the
    first write position of each row, ``seq_lens`` (B,) int32 the attended
    length at slab index 0 (0 for padded rows).  Appends in place; returns
    logits (B, S, V) bf16, row j the next-token logits after the row's
    first j + 1 tokens.  The engine rolls the rejected tail back
    (``serve.kvcache.truncate_pages``)."""
    _check_paged(cfg)
    x = _embed(params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        kvl = {name: t[i] for name, t in kv_state.items()}
        x = x + L.attn_verify_paged(
            lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), kvl,
            page_table, positions, seq_lens, cfg, kv_fmt=kv_fmt, acc=acc,
            dist=dist)
        z = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], z, cfg, dist)
    return _unembed(params, x, cfg, dist)
