"""Accumulator widths for the serve-path attention, per context bucket.

Counterpart of ``repro.serve.plan`` for the single-device engine.  Context
lengths split into geometric buckets; each bucket gets the narrowest
(1, e_acc, m_acc) online-softmax carry that passes both the paper's §4.4
knee test for the kernels' semantics (ideal f32 within one ``page_size``
KV block, quantized carry across the ``n2 = ceil(ctx / page_size)``
blocks) and the overflow bound ``|o| <= ctx * v_hint`` on the exponent.
A tensor-parallel plan (``tp_shards``) certifies the cross-rank carry
merge as one more accumulation stage: up to ``tp_shards - 1`` carry
combines a row, with the unnormalized carry materialized at the merge.
Under ``guarantee="a2q"`` the exponent covers a certified cap ``v_cap`` on
the carry itself (A2Q, ``train.optimizer``) instead of ``ctx * v_hint``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

from repro_torch.core.vrr import CUTOFF_LOG_V
from repro_torch.kernels.attention import AttnCall
from repro_torch.quant.formats import FPFormat
from repro_torch.telemetry.stats import predicted_kernel_vrr

__all__ = ["AttnBucket", "AttnPlan", "certified_log_v",
           "certification_stats", "reset_certification_stats",
           "decode_m_acc", "min_e_acc", "extra_carry_events",
           "max_carry_resumptions",
           "plan_attention", "derive_v_hint", "DEFAULT_V_HINT",
           "VerifyPlan", "plan_verify"]

# the f32 carry is the emulation ceiling
_M_ACC_MAX = 23
# fallback bound on the dequantized KV magnitude: the (1,5,2) KV format's
# |value| at exponent 4
DEFAULT_V_HINT = 16.0


@dataclass(frozen=True)
class AttnBucket:
    """Contexts up to ``max_ctx`` run with the (1, e_acc, m_acc) carry;
    ``resumptions`` is the worst-case number of chunked-prefill carry
    hand-offs it was certified for."""

    max_ctx: int
    e_acc: int
    m_acc: int
    resumptions: int = 0

    @property
    def acc(self) -> tuple[int, int]:
        return (self.e_acc, self.m_acc)

    def max_pages(self, page_size: int) -> int:
        return -(-self.max_ctx // page_size)


@dataclass(frozen=True)
class AttnPlan:
    """Bucketed carry formats; ``prefill_chunk`` is the chunked-prefill slab
    (tokens) the buckets were certified for, None = one-shot prefill;
    ``tp_shards`` the ranks whose carry merge they were certified for;
    ``guarantee``/``v_cap``/``e_min`` the overflow bound their e_acc was
    certified under ("bucket": ``ctx * v_hint``; "a2q": the certified
    carry cap ``v_cap``), which a re-certification must check again."""

    page_size: int
    m_p: int
    buckets: tuple[AttnBucket, ...]
    prefill_chunk: int | None = None
    tp_shards: int = 1
    v_hint: float = DEFAULT_V_HINT
    guarantee: str = "bucket"
    v_cap: float | None = None
    e_min: int = 6

    def bucket_for(self, ctx: int) -> tuple[int, AttnBucket]:
        """(index, bucket) of the narrowest bucket covering ``ctx``."""
        for i, b in enumerate(self.buckets):
            if ctx <= b.max_ctx:
                return i, b
        raise ValueError(
            f"context {ctx} exceeds the plan's {self.buckets[-1].max_ctx}")

    def bumped(self, index: int) -> "AttnPlan":
        """One-bit m_acc bump of bucket ``index`` (and of any wider bucket
        now narrower than it: widths stay monotone in context length),
        clamped to the f32 carrier.  The serve-time monitor's re-bucket."""
        bs = list(self.buckets)
        m = min(bs[index].m_acc + 1, _M_ACC_MAX)
        for i in range(index, len(bs)):
            if bs[i].m_acc < m:
                bs[i] = replace(bs[i], m_acc=m)
        return replace(self, buckets=tuple(bs))

    def kernel_call(self, index: int, *, kv_fmt=None) -> AttnCall:
        """The paged-prefill call of bucket ``index``: the bucket's carry
        format and padded page-row width."""
        b = self.buckets[index]
        return AttnCall(e_acc=b.e_acc, m_acc=b.m_acc, kv_fmt=kv_fmt,
                        max_pages=b.max_pages(self.page_size))


def max_carry_resumptions(ctx: int, prefill_chunk: int | None) -> int:
    """Worst-case chunked-prefill carry hand-offs for a ``ctx`` context."""
    if prefill_chunk is None or ctx <= prefill_chunk:
        return 0
    return -(-ctx // prefill_chunk) - 1


def extra_carry_events(page_size: int, prefill_chunk: int | None,
                       resumptions: int) -> int:
    """Extra carry roundings per query row from carry resumption: zero for
    page-aligned slabs (the hand-off lands on a block edge), one per
    resumption otherwise."""
    if prefill_chunk is None or resumptions == 0:
        return 0
    return 0 if prefill_chunk % page_size == 0 else resumptions


# The knee certification is a pure function of a bucket's geometry, so it
# is memoized process-wide, as JAX's: the monitor and the planner's width
# search evaluate it once per (bucket, width, resumptions), and the
# counters let a test pin that.
_CERT_MEMO: dict[tuple, float] = {}
_CERT_STATS = {"evaluations": 0, "hits": 0}


def certified_log_v(m_acc: int, m_p: int, page_size: int, max_ctx: int,
                    extra_events: int = 0) -> float:
    """Knee statistic ``v = n2 (1 - VRR)`` at a bucket's worst case,
    memoized on the whole geometry key."""
    key = (m_acc, m_p, page_size, max_ctx, extra_events)
    hit = _CERT_MEMO.get(key)
    if hit is not None:
        _CERT_STATS["hits"] += 1
        return hit
    _CERT_STATS["evaluations"] += 1
    n2 = max(-(-max_ctx // page_size), 1) + max(extra_events, 0)
    v = 0.0 if n2 <= 1 else n2 * (1.0 - predicted_kernel_vrr(
        m_acc, m_p, page_size, n2))
    _CERT_MEMO[key] = v
    return v


def certification_stats() -> dict:
    """Copy of the memo's counters (``evaluations``: closed-form
    computations, ``hits``: memo hits)."""
    return dict(_CERT_STATS)


def reset_certification_stats() -> None:
    """Zero the counters and drop the memo (a cold start)."""
    _CERT_MEMO.clear()
    _CERT_STATS["evaluations"] = 0
    _CERT_STATS["hits"] = 0


def decode_m_acc(ctx: int, page_size: int, m_p: int, *,
                 extra_events: int = 0, cutoff: float = CUTOFF_LOG_V) -> int:
    """Narrowest carry mantissa passing the knee test for a ``ctx``-token
    context at chunk length ``page_size``."""
    n2 = max(-(-ctx // page_size), 1) + max(extra_events, 0)
    if n2 <= 1:
        return m_p  # a single block never rounds the carry mid-sum
    for m in range(m_p, _M_ACC_MAX + 1):
        if certified_log_v(m, m_p, page_size, ctx, extra_events) < cutoff:
            return m
    return _M_ACC_MAX


def min_e_acc(ctx: int, *, v_hint: float | None = None, e_min: int = 6,
              boundaries: tuple[int, ...] = (), guarantee: str = "bucket",
              v_cap: float | None = None) -> int:
    """Smallest exponent width whose saturating range covers the carry's
    worst case.  ``guarantee="bucket"``: ``ctx * v_hint`` at the end and
    at every chunked-prefill boundary where the unnormalized carry is
    materialized.  ``guarantee="a2q"``: a certified cap ``v_cap`` on the
    carry itself (the A2Q weight-norm bound ``|sum w x| <= ||w||_1 max|x|``
    holds at any length), so the boundaries are moot."""
    if guarantee == "a2q":
        if v_cap is None or v_cap <= 0.0:
            raise ValueError("guarantee='a2q' needs a positive certified "
                             f"carry cap v_cap, got {v_cap!r}")
        need = math.log2(max(v_cap, 1.0))
    elif guarantee == "bucket":
        hint = DEFAULT_V_HINT if v_hint is None else v_hint
        need = max((math.log2(max(c, 1) * max(hint, 1.0))
                    for c in (*boundaries, ctx)), default=0.0)
    else:
        raise ValueError(f"unknown overflow guarantee {guarantee!r}")
    for e in range(e_min, 9):
        if FPFormat(e=e, m=1).max_exp >= need:
            return e
    return 8


def derive_v_hint(stats, ctx: int, *, margin_bits: int = 1) -> float:
    """Measured KV-magnitude hint from a stats window: ``|o| <= ctx *
    v_hint`` holds for any hint >= ``max_abs / ctx``; rounded up to a power
    of two with ``margin_bits`` of headroom, never looser than
    ``DEFAULT_V_HINT`` (which an empty or non-finite window returns)."""
    ma = float(stats.max_abs)
    if not math.isfinite(ma) or ma <= 0.0 or ctx <= 0:
        return DEFAULT_V_HINT
    hint = 2.0 ** (math.ceil(math.log2(ma / ctx)) + margin_bits)
    return float(min(hint, DEFAULT_V_HINT))


@dataclass(frozen=True)
class VerifyPlan:
    """A base ``AttnPlan`` re-certified for speculative-decode verify
    batches of ``k`` draft tokens: one verify signature per (bucket, k),
    sharing the base plan's buckets and carry formats.  A verify batch
    widens the query-row count, never a row's accumulation length."""

    k: int
    plan: AttnPlan

    @property
    def s_v(self) -> int:
        """Verify width: k draft tokens and the last committed token."""
        return self.k + 1

    def bucket_for(self, ctx: int) -> tuple[int, AttnBucket]:
        """The bucket covering the post-round worst case: call with
        ``base_ctx + k + 1``, so every verify row's walk is within the
        certified ``max_ctx``."""
        return self.plan.bucket_for(ctx)


def plan_verify(plan: AttnPlan, *, k: int,
                v_hint: float | None = None) -> VerifyPlan:
    """Certify ``plan``'s buckets for k-token speculative verify batches.

    Each scored position is an independent query row whose accumulation
    length is its own context (at most the bucket's certified ``max_ctx``),
    and the per-slot KV appends add no carry rounding, so the bucket's knee
    test is re-run at its exact geometry (resumptions and cross-rank events
    included) and the e_acc overflow bound re-checked at ``max_ctx``
    under the hint and guarantee the plan was certified with.  A bucket
    that fails raises: a verify plan never widens a carry silently."""
    if k < 1:
        raise ValueError(f"speculative verify needs k >= 1, got {k}")
    hint = plan.v_hint if v_hint is None else v_hint
    for i, b in enumerate(plan.buckets):
        if b.max_ctx < k + 1:
            raise ValueError(
                f"bucket {i} (max_ctx {b.max_ctx}) cannot hold a "
                f"{k + 1}-token verify slab")
        extra = extra_carry_events(plan.page_size, plan.prefill_chunk,
                                   b.resumptions)
        extra += max(plan.tp_shards - 1, 0)
        v = certified_log_v(b.m_acc, plan.m_p, plan.page_size, b.max_ctx,
                            extra)
        if v >= CUTOFF_LOG_V:
            raise ValueError(
                f"bucket {i} fails the knee test for k={k} verify: "
                f"v={v:.2f} >= {CUTOFF_LOG_V} at m_acc={b.m_acc}")
        e_need = min_e_acc(b.max_ctx, v_hint=hint, e_min=plan.e_min,
                           guarantee=plan.guarantee, v_cap=plan.v_cap)
        if b.e_acc < e_need:
            raise ValueError(
                f"bucket {i} fails the e_acc overflow bound for k={k} "
                f"verify: e_acc={b.e_acc} < required {e_need} at "
                f"ctx={b.max_ctx}")
    return VerifyPlan(k=k, plan=plan)


def plan_attention(max_context: int, page_size: int, *, m_p: int = 5,
                   growth: int = 4, v_hint: float | None = None,
                   e_min: int = 6,
                   prefill_chunk_tokens: int | None = None,
                   tp_shards: int = 1, guarantee: str = "bucket",
                   v_cap: float | None = None) -> AttnPlan:
    """Bucketed plan covering contexts up to ``max_context``: bucket edges
    grow ``growth``x in pages from one page; ``prefill_chunk_tokens``
    certifies each bucket for its worst-case chunked-prefill resumptions.

    ``tp_shards`` certifies the buckets for tensor-parallel serving: a
    rank owns its heads' whole walks, so a head's accumulation length is
    the full context, but the cross-rank merge adds up to ``tp_shards -
    1`` carry-combine events a row, and the unnormalized carry is
    materialized at the merge, so the e_acc bound is checked there too.
    So a TP plan can pick other carry formats than the single-device one.
    ``e_min``, ``guarantee`` and ``v_cap`` go to ``min_e_acc`` and are
    recorded in the plan."""
    hint = DEFAULT_V_HINT if v_hint is None else v_hint
    edges: list[int] = []
    ctx = page_size
    while ctx < max_context:
        edges.append(ctx)
        ctx *= growth
    edges.append(max(max_context, page_size))

    def _bucket(c: int) -> AttnBucket:
        r = max_carry_resumptions(c, prefill_chunk_tokens)
        extra = extra_carry_events(page_size, prefill_chunk_tokens, r)
        extra += max(tp_shards - 1, 0)   # the cross-rank merge
        bounds = (tuple(min(i * prefill_chunk_tokens, c)
                        for i in range(1, r + 1))
                  if prefill_chunk_tokens else ())
        if tp_shards > 1:
            bounds = (*bounds, c)        # the carry on the wire
        return AttnBucket(
            max_ctx=c,
            e_acc=min_e_acc(c, v_hint=hint, e_min=e_min, boundaries=bounds,
                            guarantee=guarantee, v_cap=v_cap),
            m_acc=decode_m_acc(c, page_size, m_p, extra_events=extra),
            resumptions=r)

    return AttnPlan(page_size=page_size, m_p=m_p,
                    buckets=tuple(_bucket(c) for c in edges),
                    prefill_chunk=prefill_chunk_tokens, tp_shards=tp_shards,
                    v_hint=hint, guarantee=guarantee, v_cap=v_cap,
                    e_min=e_min)
