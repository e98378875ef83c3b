"""Paged KV cache whose pages are int8 (1, e, m) codes.

Counterpart of ``repro.serve.kvcache`` for the single-device engine.
Layout (one arena per model, the layer axis leading)::

    k / v     : (L, P, KV, page_size, dh)  int8 codes
    k_se/v_se : (L, P)                     int32 page scale exponents

Page 0 is the reserved null page: the pool never allocates it, padded
page-table entries point at it and padded decode rows write their masked
token there.  A page's scale exponent is fixed by the first write that
touches it (``_scale_exp`` of the written block's max magnitude); later
tokens of the page quantize under it.

Unlike the functional JAX version, ``append_token`` and ``write_prompt``
update the arena in place: an arena is the largest tensor of the server
and a copy per step would double it.  The values written are the same.

Tensor-parallel serving: each rank holds its KV-head slice of every page
(page ids are global, so one host page table addresses every rank's
slice), and ``pmax_axis`` shares each page's max magnitude over the ranks
before its scale exponent is fixed, so every rank's codes are a bitwise
slice of the single-device arena.  ``ShardedPagePool`` keeps one replica
pool a rank in lockstep with the primary and catches any drift.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.dist import Dist, pmax
from repro_torch.kernels.common import exp2_int, quantize_block
from repro_torch.quant.formats import FPFormat
from repro_torch.quant.qtensor import pack_block, unpack_block

__all__ = [
    "PagedKVConfig",
    "PagePool",
    "ShardedPagePool",
    "SwapStore",
    "init_arena",
    "append_token",
    "write_prompt",
    "gather_pages",
    "dequantize_pages",
    "swap_out_pages",
    "swap_in_pages",
    "truncate_pages",
    "kv_bytes_per_token",
]

# scale exponents clipped well inside f32's normal range
_SE_LIM = 120
# the JAX package takes log2 as log(x) * f32(1 / ln 2) (XLA's lowering);
# floor() of that product is what fixes a page's exponent, and it differs
# from the exact floor(log2 x) next to powers of two, so it is kept as is
_INV_LN2 = float(np.float32(1.0 / math.log(2.0)))
# a subnormal magnitude counts as zero (XLA flushes denormals), so the
# smallest normal f32 is the least amax that sets an exponent
_TINY = float(np.finfo(np.float32).tiny)


@dataclass(frozen=True)
class PagedKVConfig:
    """Shapes and code format of one paged arena."""

    n_layers: int
    n_kv_heads: int
    head_dim: int
    n_pages: int
    page_size: int
    kv_fmt: FPFormat = FPFormat(e=5, m=2)

    def __post_init__(self):
        if self.kv_fmt.bits > 8:
            raise ValueError(f"kv_fmt {self.kv_fmt} does not fit int8 codes")
        if self.n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")

    @property
    def tokens_capacity(self) -> int:
        return (self.n_pages - 1) * self.page_size

    @classmethod
    def for_model(cls, cfg, *, n_pages: int, page_size: int,
                  kv_fmt: FPFormat | None = None) -> "PagedKVConfig":
        return cls(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.head_dim, n_pages=n_pages,
                   page_size=page_size, kv_fmt=kv_fmt or FPFormat(e=5, m=2))


def init_arena(pc: PagedKVConfig, device) -> dict[str, torch.Tensor]:
    """Zero arena (code 0 decodes to +0.0) on ``device``."""
    shape = (pc.n_layers, pc.n_pages, pc.n_kv_heads, pc.page_size,
             pc.head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_se": torch.zeros((pc.n_layers, pc.n_pages), dtype=torch.int32,
                            device=device),
        "v_se": torch.zeros((pc.n_layers, pc.n_pages), dtype=torch.int32,
                            device=device),
    }


def _scale_exp(amax: torch.Tensor) -> torch.Tensor:
    """Per-page power-of-two scale exponent from a block's max magnitude:
    floor(log2(amax)) as the JAX package computes it, clipped to
    +-_SE_LIM; an all-zero (or subnormal) block gets 0."""
    safe = torch.where(amax >= _TINY, amax, torch.ones_like(amax))
    se = torch.floor(torch.log(safe) * _INV_LN2)
    return torch.clamp(se, -_SE_LIM, _SE_LIM).to(torch.int32)


def _encode(x: torch.Tensor, se: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Quantize ``x`` under the 2^se scale and pack to int8 codes; ``se``
    broadcasts over the trailing axes of ``x``."""
    scaled = x * exp2_int(-se)
    return pack_block(quantize_block(scaled, fmt.e, fmt.m), fmt.e, fmt.m)


def _decode(codes: torch.Tensor, se: torch.Tensor,
            fmt: FPFormat) -> torch.Tensor:
    return unpack_block(codes, fmt.e, fmt.m) * exp2_int(se)


def _shared_amax(amax: torch.Tensor, pmax_axis: Dist | None) -> torch.Tensor:
    return amax if pmax_axis is None else pmax(amax, pmax_axis)


def append_token(arena_l: torch.Tensor, se_l: torch.Tensor, x: torch.Tensor,
                 page_id: torch.Tensor, slot: torch.Tensor,
                 fmt: FPFormat, pmax_axis: Dist | None = None) -> None:
    """Write one decode token per sequence into a layer's arena slice, in
    place.  ``arena_l`` (P, KV, page_size, dh) int8, ``se_l`` (P,) int32,
    ``x`` (B, KV, dh) float32, ``page_id``/``slot`` (B,) int64.  A write at
    ``slot == 0`` is the page's first and fixes its scale exponent; padded
    rows carry ``page_id == 0`` (the null page).  ``pmax_axis``: the group
    of a KV-head-sharded arena, over which each page's max magnitude is
    shared before the exponent is fixed (every rank then derives the
    single-device exponent)."""
    amax = _shared_amax(torch.amax(torch.abs(x), dim=(1, 2)), pmax_axis)
    se = torch.where(slot == 0, _scale_exp(amax), se_l[page_id])
    se_l[page_id] = se
    arena_l[page_id, :, slot] = _encode(x, se[:, None, None], fmt)


def write_prompt(arena_l: torch.Tensor, se_l: torch.Tensor, x: torch.Tensor,
                 page_ids: torch.Tensor, fmt: FPFormat,
                 pmax_axis: Dist | None = None) -> torch.Tensor:
    """Write one sequence's slab of K (or V), ``x`` (S, KV, dh) float32, into
    the pages ``page_ids`` of a layer's arena slice, in place.  The tail
    page is zero-padded (code 0 decodes to 0.0; padded tokens are masked
    out of attention).  Returns the (S, KV, dh) float32 values the arena
    now holds (the dequantized view the dense prefill attends, exactly the
    values the paged kernels decode).  ``pmax_axis`` as in
    ``append_token``."""
    s, kv, dh = x.shape
    npg = page_ids.shape[0]
    page_size = arena_l.shape[2]
    xp = torch.nn.functional.pad(x.to(torch.float32),
                                 (0, 0, 0, 0, 0, npg * page_size - s))
    blocks = xp.reshape(npg, page_size, kv, dh).transpose(1, 2)
    se = _scale_exp(_shared_amax(torch.amax(torch.abs(blocks), dim=(1, 2, 3)),
                                 pmax_axis))
    codes = _encode(blocks, se[:, None, None, None], fmt)
    arena_l[page_ids] = codes
    se_l[page_ids] = se
    return _token_major(_decode(codes, se[:, None, None, None], fmt))[:s]


def _token_major(pages: torch.Tensor) -> torch.Tensor:
    """(n, KV, page_size, dh) -> (n * page_size, KV, dh)."""
    n, kv, page_size, dh = pages.shape
    return pages.transpose(1, 2).reshape(n * page_size, kv, dh)


def gather_pages(arena_l: torch.Tensor, se_l: torch.Tensor,
                 page_ids: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Dequantized token-major view of one sequence's pages in a layer:
    (len(page_ids) * page_size, KV, dh) float32, exactly the values
    ``write_prompt`` returned when the pages were written.  Chunked
    prefill attends its history through it."""
    ids = page_ids.long()
    return _token_major(_decode(arena_l[ids], se_l[ids][:, None, None, None],
                                fmt))


def dequantize_pages(arena_l: torch.Tensor, se_l: torch.Tensor,
                     fmt: FPFormat) -> torch.Tensor:
    """Float32 view of all of a layer's pages, (P, KV, page_size, dh): the
    values the paged kernels decode in shared memory."""
    return _decode(arena_l, se_l[:, None, None, None], fmt)


# --------------------------------------------------------------------------
# preemption swap: packed pages round-trip host memory byte-identically
# --------------------------------------------------------------------------


def swap_out_pages(kv: dict[str, torch.Tensor],
                   pages: list[int]) -> dict[str, np.ndarray]:
    """Copy one sequence's pages (all layers) to host memory: the exact
    int8 codes and int32 exponents, keyed by the page's ordinal in the
    sequence (a restore may land them on other page ids)."""
    idx = torch.as_tensor(pages, dtype=torch.int64, device=kv["k"].device)
    return {name: kv[name][:, idx].cpu().numpy() for name in kv}


def swap_in_pages(kv: dict[str, torch.Tensor], pages: list[int],
                  blob: dict[str, np.ndarray]) -> None:
    """Restore a swapped-out blob into (possibly different) pages, in
    place: byte-identical codes and exponents, no recompute."""
    if blob["k"].shape[1] != len(pages):
        raise ValueError(
            f"blob holds {blob['k'].shape[1]} pages, restore got {len(pages)}")
    dev = kv["k"].device
    idx = torch.as_tensor(pages, dtype=torch.int64, device=dev)
    for name in kv:
        kv[name][:, idx] = torch.from_numpy(blob[name]).to(dev)


def truncate_pages(kv: dict[str, torch.Tensor], released: torch.Tensor,
                   boundary_page, keep_slots) -> dict[str, torch.Tensor]:
    """Scrub a rolled-back (rejected-draft) tail out of the arena, in
    place; returns ``kv``.

    ``released`` (R,) int32: the page ids ``PagePool.rollback_seq_len``
    freed, padded with 0 (re-zeroing the null page is harmless); their
    codes and scale exponents return to the zero state, so on pages that
    were fresh before the speculative append the arena is bitwise one that
    never appended.  ``boundary_page`` is the page holding the rollback
    point when it lands mid-page: its slots ``>= keep_slots`` are zeroed,
    its exponent kept (its slot-0 write is part of the accepted prefix);
    ``boundary_page=0, keep_slots=0`` for a page-aligned rollback.  Both
    are ints or 0-d integer tensors on the arena's device (read by no
    host code, so the scrub can be captured in a CUDA graph).  No code is
    rounded again: the accepted tokens' bytes are untouched."""
    dev = kv["k"].device
    page_size = kv["k"].shape[3]
    rel = torch.as_tensor(released, device=dev).to(torch.int64).reshape(-1)
    bnd = torch.as_tensor(boundary_page, device=dev).to(torch.int64).reshape(1)
    keep = torch.as_tensor(keep_slots, device=dev).to(torch.int64)
    slot_mask = (torch.arange(page_size, device=dev) >= keep).reshape(
        1, 1, 1, page_size, 1)
    for name in ("k", "v"):
        codes = kv[name]
        codes.index_fill_(1, rel, 0)
        page = torch.index_select(codes, 1, bnd)          # (L, 1, KV, ps, dh)
        codes.index_copy_(1, bnd, torch.where(slot_mask, torch.zeros_like(page),
                                              page))
        kv[name + "_se"].index_fill_(1, rel, 0)
    return kv


class SwapStore:
    """Host-side store of preempted sequences' packed KV pages: one
    ``swap_out_pages`` blob per sequence plus the cached-token count."""

    def __init__(self):
        self._entries: dict[int, tuple[dict[str, np.ndarray], int]] = {}

    def put(self, sid: int, blob: dict[str, np.ndarray],
            n_tokens: int) -> None:
        if sid in self._entries:
            raise ValueError(f"sequence {sid} already swapped out")
        self._entries[sid] = (blob, n_tokens)

    def take(self, sid: int) -> tuple[dict[str, np.ndarray], int]:
        """Remove and return ``(blob, n_tokens)`` for a restore."""
        return self._entries.pop(sid)

    @property
    def bytes_used(self) -> int:
        return sum(sum(a.nbytes for a in blob.values())
                   for blob, _ in self._entries.values())


def kv_bytes_per_token(pc: PagedKVConfig, *, carrier_bytes: int = 1,
                       tp_shards: int = 1) -> float:
    """Cache bytes per cached token across all layers: K + V payloads plus
    the amortized per-page scale exponents (``carrier_bytes=4`` prices the
    f32 carrier, 2 bf16).  ``tp_shards > 1`` prices one rank's slice of a
    tensor-parallel arena: the payloads split with the KV heads, the page
    exponents are replicated on every rank."""
    per_layer = 2 * (pc.n_kv_heads // tp_shards) * pc.head_dim * carrier_bytes
    if carrier_bytes == 1:
        per_layer += 2 * 4 / pc.page_size
    return pc.n_layers * per_layer


# --------------------------------------------------------------------------
# host-side page accounting
# --------------------------------------------------------------------------


class PagePool:
    """Host-side allocator over the arena's page ids.  Page 0 is never
    handed out; a page is owned by at most one sequence; released pages
    return to the free list (LIFO): free + in-use == n_pages - 1."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: list[int] = list(range(n_pages - 1, 0, -1))
        self._pages: dict[int, list[int]] = {}
        self._lens: dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    def seq_len(self, sid: int) -> int:
        return self._lens[sid]

    def owns(self, sid: int) -> bool:
        return sid in self._pages

    def pages(self, sid: int) -> list[int]:
        return list(self._pages[sid])

    def allocate(self, sid: int, n_tokens: int) -> list[int]:
        """Claim pages for a new sequence of ``n_tokens`` cached tokens."""
        if sid in self._pages:
            raise ValueError(f"sequence {sid} already allocated")
        need = self.pages_for(n_tokens)
        if need > self.free_pages:
            raise RuntimeError(
                f"KV pool exhausted: need {need} pages, {self.free_pages} free")
        got = [self._free.pop() for _ in range(need)]
        self._pages[sid] = got
        self._lens[sid] = n_tokens
        return list(got)

    def extend(self, sid: int, n_new: int = 1) -> list[int]:
        """Grow a sequence by ``n_new`` tokens, claiming pages as its length
        crosses page boundaries.  Returns the newly claimed page ids."""
        new_len = self._lens[sid] + n_new
        need = self.pages_for(new_len) - len(self._pages[sid])
        if need > self.free_pages:
            raise RuntimeError(
                f"KV pool exhausted extending seq {sid}: need {need} pages")
        got = [self._free.pop() for _ in range(need)]
        self._pages[sid].extend(got)
        self._lens[sid] = new_len
        return got

    def release(self, sid: int) -> None:
        """Eviction: all of the sequence's pages return to the free list."""
        self._free.extend(reversed(self._pages.pop(sid)))
        del self._lens[sid]

    def rollback_seq_len(self, sid: int, new_len: int) -> list[int]:
        """Speculative-decode rejection: shrink a sequence to ``new_len``
        cached tokens, freeing the tail pages its rejected suffix claimed
        (returned in sequence order, for ``truncate_pages``).  They go back
        LIFO, as ``release``'s, so a later extend claims exactly the pages
        a pool that never speculated would hand out."""
        if not 1 <= new_len <= self._lens[sid]:
            raise ValueError(
                f"rollback of seq {sid} to {new_len} tokens "
                f"(has {self._lens[sid]})")
        keep = self.pages_for(new_len)
        pages = self._pages[sid]
        tail = pages[keep:]
        self._pages[sid] = pages[:keep]
        self._lens[sid] = new_len
        self._free.extend(reversed(tail))
        return tail

    def page_table(self, sids: list[int], width: int) -> np.ndarray:
        """(len(sids), width) int32 page table padded with the null page."""
        out = np.zeros((len(sids), width), np.int32)
        for i, sid in enumerate(sids):
            pages = self._pages[sid]
            if len(pages) > width:
                raise ValueError(
                    f"seq {sid} has {len(pages)} pages > table width {width}")
            out[i, :len(pages)] = pages
        return out

    def check_invariants(self) -> None:
        used = [p for pages in self._pages.values() for p in pages]
        if 0 in used or 0 in self._free:
            raise AssertionError("null page handed out")
        if len(set(used)) != len(used):
            raise AssertionError("page owned twice")
        if len(used) + len(self._free) != self.n_pages - 1:
            raise AssertionError("page leak")
        for sid, pages in self._pages.items():
            if len(pages) != self.pages_for(self._lens[sid]):
                raise AssertionError(
                    f"seq {sid}: {len(pages)} pages for {self._lens[sid]} "
                    "tokens")


class ShardedPagePool(PagePool):
    """Page accounting for a tensor-parallel arena: one logical allocator
    (page ids are global: rank i holds its KV-head slice of page p at index
    p, so every rank's page table is the same host array) and one replica
    ``PagePool`` a rank, kept in lockstep.  The engine talks only to the
    primary; every mutation is mirrored and checked, and
    ``check_invariants`` also proves the replicas never drifted (a path
    that changed one rank's accounting without the others fails here
    instead of corrupting a remote arena)."""

    def __init__(self, n_pages: int, page_size: int, *, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        super().__init__(n_pages, page_size)
        self.n_shards = n_shards
        self._replicas = [PagePool(n_pages, page_size)
                          for _ in range(n_shards)]

    def _mirror(self, op: str, sid: int, *args) -> None:
        want = self._pages.get(sid)
        for i, rep in enumerate(self._replicas):
            got = getattr(rep, op)(sid, *args)
            if op != "release" and rep._pages.get(sid) != want:
                raise AssertionError(
                    f"shard {i} pool drifted on {op}(sid={sid}): {got} vs "
                    f"primary {want}")

    def allocate(self, sid: int, n_tokens: int) -> list[int]:
        got = super().allocate(sid, n_tokens)
        self._mirror("allocate", sid, n_tokens)
        return got

    def extend(self, sid: int, n_new: int = 1) -> list[int]:
        got = super().extend(sid, n_new)
        self._mirror("extend", sid, n_new)
        return got

    def release(self, sid: int) -> None:
        super().release(sid)
        self._mirror("release", sid)

    def rollback_seq_len(self, sid: int, new_len: int) -> list[int]:
        got = super().rollback_seq_len(sid, new_len)
        self._mirror("rollback_seq_len", sid, new_len)
        return got

    def check_invariants(self) -> None:
        super().check_invariants()
        for i, rep in enumerate(self._replicas):
            rep.check_invariants()
            for what in ("_pages", "_lens", "_free"):
                if getattr(rep, what) != getattr(self, what):
                    raise AssertionError(
                        f"shard {i} {what.strip('_')} drifted from the "
                        "primary")
