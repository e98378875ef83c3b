"""Continuous-batching scheduler over the paged int8 KV cache.

Counterpart of ``repro.serve.scheduler`` for one device.  ``ServeEngine``
keeps the JAX engine's schedule:

* optimistic admission: a request is admitted when the pages of its FIRST
  prefill slab fit; growth past that goes through preemption;
* one prefill slab per engine step (``prefill_chunk_tokens``, page
  aligned, or the whole prompt), interleaved with
* one batched decode token for every running sequence, the batch padded
  to ``max_batch`` rows (padded rows: null-page table, length 0);
* preemption of the youngest resident sequence when a page is short: its
  int8 pages and exponents are copied to a host ``SwapStore`` and restored
  byte-identically, oldest first, when pages free up;
* eviction of a sequence's pages when it completes.

``ModelExecutor`` is the only place device work happens.  Eager PyTorch
compiles nothing per shape, so a prefill slab is not padded to its
bucket's width (the JAX engine pads for its compile cache; its padded rows
are byte-neutral, so the arena and logits are the same).

The serve-time VRR monitor (``monitor_cadence``): every N decode steps it
probes the longest running context's layer-0 decode accumulator with a
unit-Gaussian query through K12's kernel (``measure_decode_vrr``).  A
breach, the measured swamp rate at or over ``swamp_threshold`` or the
closed-form knee test of the context's bucket, bumps that bucket's m_acc
(``AttnPlan.bumped``) before the context swamps; the bucket is the one of
the grown context.  Each tick logs one event (``self.events``, and
``monitor_log`` as JSON lines).  Tracing, metrics and speculative decoding
are not ported yet.

Tensor-parallel serving (``ShardedModelExecutor``): each rank of a
``torch.distributed`` group runs the same engine schedule in lockstep on
its output-dim slice of the params and its KV-head slice of the arena;
the engine then allocates through a ``ShardedPagePool`` and plans for the
cross-rank carry merge (``plan_attention(tp_shards=)``).  The ranks'
logits are gathered exactly, so every rank takes the same host decisions
(greedy tokens, preemptions, the monitor's draws).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.vrr import CUTOFF_LOG_V
from repro_torch.dist import LOCAL, Dist, all_gather
from repro_torch.models.api import DecodeRequest, PrefillRequest, get_paged_model
from repro_torch.obs.sink import jsonl_append
from repro_torch.quant.formats import FPFormat
from repro_torch.serve.kvcache import (
    PagedKVConfig,
    PagePool,
    ShardedPagePool,
    SwapStore,
    init_arena,
    kv_bytes_per_token,
    swap_in_pages,
    swap_out_pages,
)
from repro_torch.serve.plan import (
    AttnPlan,
    certified_log_v,
    derive_v_hint,
    extra_carry_events,
    plan_attention,
)
from repro_torch.telemetry.stats import EnsembleStats

__all__ = ["Request", "ModelExecutor", "ShardedModelExecutor", "ServeEngine",
           "resolve_device", "measure_decode_vrr"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (the port
    does not fall back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int


@dataclass
class _Seq:
    rid: int
    tokens: list[int]          # prompt + generated
    prompt_len: int
    max_new: int
    generated: list[int] = field(default_factory=list)
    prefilled: int = 0         # prompt tokens whose KV is cached

    @property
    def pos(self) -> int:
        """Write position of the next token's KV (= tokens cached)."""
        return len(self.tokens) - 1

    @property
    def in_prefill(self) -> bool:
        return self.prefilled < self.prompt_len

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


@dataclass
class _Swapped:
    """A preempted sequence: its store entry covers ``n_tokens`` cached
    tokens (0 = preempted before its first slab claimed pages)."""

    seq: _Seq
    n_tokens: int


def measure_decode_vrr(kv_state, page_row, seq_len: int, *, cfg,
                       kv_fmt: FPFormat, acc: tuple[int, int],
                       gen: torch.Generator) -> EnsembleStats:
    """Probe one context's decode-attention accumulator: a unit-Gaussian
    query (drawn from ``gen``, on any device) against the sequence's
    layer-0 KV pages, through K12's kernel.  Returns the window for the
    knee test."""
    from repro_torch.kernels.attention import paged_attn_decode

    dev = kv_state["k"].device
    q = torch.randn((1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=gen.device).to(dev)
    row = torch.as_tensor(np.asarray(page_row, np.int32), device=dev)
    with torch.no_grad():
        _, raw = paged_attn_decode(
            q, kv_state["k"][0], kv_state["v"][0], kv_state["k_se"][0],
            kv_state["v_se"][0], row[None],
            torch.tensor([seq_len], dtype=torch.int32, device=dev),
            kv_fmt=kv_fmt, acc=acc, collect_stats=True)
    return EnsembleStats.from_raw(raw)


class ModelExecutor:
    """Device-side executor: the model, its params and the paged arena."""

    dist: Dist = LOCAL

    def __init__(self, model, params, pc: PagedKVConfig, *, kv_fmt: FPFormat,
                 max_batch: int = 8, device="cuda"):
        self.cfg = model.cfg
        self.params = params
        self.pc = pc
        self.kv_fmt = kv_fmt
        self.max_batch = max_batch
        self.device = resolve_device(device)
        self.kv = init_arena(pc, self.device)
        self.pm = get_paged_model(model.cfg)

    def _int32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    def prefill_logits(self, req: PrefillRequest) -> torch.Tensor | None:
        """Run one prefill slab; the (1, V) logits of its last row on the
        final slab, else None."""
        n_tok = len(req.tokens)
        n_hist = len(req.hist_pages)
        row = np.zeros((max(req.bucket_pages or 0,
                            n_hist + len(req.slab_pages)),), np.int32)
        row[:n_hist] = req.hist_pages
        row[n_hist:n_hist + len(req.slab_pages)] = req.slab_pages
        toks = torch.as_tensor([list(req.tokens)], dtype=torch.int64,
                               device=self.device)
        slab = self._int32(req.slab_pages).long()
        with torch.no_grad():
            return self.pm.prefill(
                self.params, toks, self.kv, self._int32(row), slab, req.t0,
                n_tok, kv_fmt=self.kv_fmt, acc=req.acc, call=req.call,
                want_logits=req.final, dist=self.dist)

    def prefill(self, req: PrefillRequest) -> int | None:
        """One prefill slab; the first generated token (greedy) on the
        final slab."""
        logits = self.prefill_logits(req)
        return int(torch.argmax(logits[0])) if req.final else None

    def decode_logits(self, req: DecodeRequest) -> torch.Tensor:
        """One batched decode step, padded to ``max_batch`` rows (padded
        rows are no-ops: null-page table row, length 0, write to page 0);
        returns the live rows' logits (n, V)."""
        pt_in = np.asarray(req.page_table, np.int32)
        n, width = pt_in.shape
        pt = np.zeros((self.max_batch, width), np.int32)
        pt[:n] = pt_in
        tokens = np.zeros((self.max_batch, 1), np.int64)
        tokens[:n, 0] = req.last_tokens
        pos = np.zeros((self.max_batch,), np.int64)
        pos[:n] = req.positions
        sl = np.zeros((self.max_batch,), np.int32)
        sl[:n] = req.seq_lens
        with torch.no_grad():
            logits = self.pm.decode(
                self.params, torch.as_tensor(tokens, device=self.device),
                self.kv, self._int32(pt),
                torch.as_tensor(pos, device=self.device), self._int32(sl),
                kv_fmt=self.kv_fmt, acc=req.acc, dist=self.dist)
        return logits[:n, 0]

    def decode(self, req: DecodeRequest) -> list[int]:
        """One batched decode token per row; returns the next tokens."""
        return torch.argmax(self.decode_logits(req), dim=-1).tolist()

    def measure_vrr(self, page_row, ctx: int, acc: tuple[int, int],
                    gen: torch.Generator) -> EnsembleStats:
        return measure_decode_vrr(self.kv, page_row, ctx, cfg=self.cfg,
                                  kv_fmt=self.kv_fmt, acc=acc, gen=gen)

    def swap_out(self, rid: int, pages: list[int]) -> dict:
        return swap_out_pages(self.kv, pages)

    def swap_in(self, rid: int, pages: list[int], blob: dict) -> None:
        swap_in_pages(self.kv, pages, blob)


class ShardedModelExecutor(ModelExecutor):
    """Tensor-parallel executor: this rank's share of the model over the
    group of ``dist``, behind the same engine seam.

    Partitioning is output-dim only (``sharding.specs.serve_param_specs``):
    the attention heads and the arena's KV-head axis split over the ranks,
    so each rank owns its heads' whole online-softmax walks (the
    single-device kernel's page order and rounding) and the cross-rank
    merge is the exact carry combine (``dist.psum_carry``).  The logits on
    every rank are therefore bitwise the single-device engine's.  Page
    tables stay on the host, the same on every rank (one allocator's
    global page ids address each rank's slice; ``ServeEngine`` pairs this
    executor with a ``ShardedPagePool``).  Swap-out and swap-in move the
    rank's slice.

    ``params`` are the full params (on this rank's device) and ``pc`` the
    whole arena's config; the executor keeps its slices (``self.pc`` is
    its own arena's).  ``dist.logit_wire`` picks the unembed: ``"gather"``
    (exact) or ``"int8"`` (``train.compression.compressed_psum``, lossy in
    general).  Families other than dense (MoE: its expert sharding would
    nest) are refused; heads, KV heads and d_ff must split evenly."""

    def __init__(self, model, params, pc: PagedKVConfig, *, kv_fmt: FPFormat,
                 dist: Dist, max_batch: int = 8, device="cuda"):
        from dataclasses import replace

        from repro_torch.sharding.specs import serve_param_specs, shard_params

        cfg = model.cfg
        s = dist.size
        if dist.logit_wire not in ("gather", "int8"):
            raise ValueError(f"unknown logit_wire {dist.logit_wire!r}")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"tensor-parallel serving covers the dense family; "
                f"{cfg.family!r} (MoE's expert sharding) is refused")
        for name, dim in (("n_heads", cfg.n_heads),
                          ("n_kv_heads", cfg.n_kv_heads), ("d_ff", cfg.d_ff)):
            if dim % s != 0:
                raise ValueError(f"a serve group of {s} ranks cannot split "
                                 f"{name}={dim}")
        if dist.logit_wire == "int8" and cfg.d_model % s != 0:
            raise ValueError(f"the int8 logit wire slices d_model="
                             f"{cfg.d_model} over {s} ranks; not divisible")
        self.dist = dist
        self.n_shards = s
        specs = serve_param_specs(params, n_shards=s,
                                  logit_wire=dist.logit_wire)
        super().__init__(model, shard_params(params, specs, dist.rank, s),
                         replace(pc, n_kv_heads=pc.n_kv_heads // s),
                         kv_fmt=kv_fmt, max_batch=max_batch, device=device)

    def measure_vrr(self, page_row, ctx: int, acc: tuple[int, int],
                    gen: torch.Generator) -> EnsembleStats:
        """The single-device monitor's probe: the probed row's layer-0
        pages gathered to full heads on every rank (pure movement), then
        K12 on the full-head query, so the stats (and the tick) are the
        single-device engine's.  The gathered pages sit at indices 1..n of
        a small arena whose page 0 is the null page."""
        row = np.asarray(page_row, np.int64)
        used = row[row > 0]
        idx = torch.as_tensor(used, device=self.device)
        arena = {}
        for name, t in self.kv.items():
            t = t[0][idx]
            if name in ("k", "v"):   # every rank's KV heads, in head order
                t = torch.cat(all_gather(t, self.dist), dim=1)
            pages = torch.zeros((1, len(used) + 1) + tuple(t.shape[1:]),
                                dtype=t.dtype, device=self.device)
            pages[0, 1:] = t
            arena[name] = pages
        local = np.zeros_like(row)
        local[:len(used)] = np.arange(1, len(used) + 1)
        return measure_decode_vrr(arena, local, ctx, cfg=self.cfg,
                                  kv_fmt=self.kv_fmt, acc=acc, gen=gen)


class ServeEngine:
    """Continuous-batching serving over one model's paged KV arena."""

    def __init__(self, model, params, *, n_pages: int, page_size: int,
                 kv_fmt: FPFormat | None = None, max_batch: int = 8,
                 prefill_chunk_tokens: int | None = None,
                 plan: AttnPlan | None = None, monitor_cadence: int = 0,
                 monitor_log: str | None = None,
                 swamp_threshold: float = 0.15, seed: int = 0,
                 executor=None, device="cuda"):
        if prefill_chunk_tokens is not None and (
                prefill_chunk_tokens <= 0
                or prefill_chunk_tokens % page_size != 0):
            raise ValueError(
                f"prefill_chunk_tokens {prefill_chunk_tokens} must be a "
                f"positive multiple of page_size {page_size}: slab "
                "boundaries must land on page (carry-block) edges")
        self.cfg = model.cfg
        self.kv_fmt = kv_fmt or FPFormat(e=5, m=2)
        self.page_size = page_size
        self.n_pages = n_pages
        self.pc = PagedKVConfig.for_model(self.cfg, n_pages=n_pages,
                                          page_size=page_size,
                                          kv_fmt=self.kv_fmt)
        self.executor = executor or ModelExecutor(
            model, params, self.pc, kv_fmt=self.kv_fmt, max_batch=max_batch,
            device=device)
        # a tensor-parallel executor gives its rank count: the engine then
        # allocates through a ShardedPagePool (one allocator, a mirrored
        # pool a rank) and plans for the cross-rank carry merge
        self.tp_shards = int(getattr(self.executor, "n_shards", 1) or 1)
        self.pool = (ShardedPagePool(n_pages, page_size,
                                     n_shards=self.tp_shards)
                     if self.tp_shards > 1 else PagePool(n_pages, page_size))
        self.store = SwapStore()
        self.plan = plan or plan_attention(
            self.pc.tokens_capacity, page_size,
            prefill_chunk_tokens=prefill_chunk_tokens,
            tp_shards=self.tp_shards)
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk_tokens
        self.monitor_cadence = monitor_cadence
        self.monitor_log = monitor_log
        self.swamp_threshold = swamp_threshold
        # the monitor's query draws, on the host (the JAX engine splits a
        # PRNGKey(seed)); one (1, H, dh) query a tick
        self._gen = torch.Generator().manual_seed(seed)
        self.events: list[dict] = []
        self._decode_steps = 0

        self.pending: deque[Request] = deque()
        self.active: dict[int, _Seq] = {}
        self.swapped: dict[int, _Swapped] = {}
        self.finished: dict[int, list[int]] = {}
        self._next_rid = 0
        self.steps = 0
        self.decoded_tokens = 0
        self.prefill_tokens = 0
        self.prefill_slabs = 0
        self.preemptions = 0
        self.restores = 0
        self.max_concurrent = 0

    # ------------------------------ intake ---------------------------------
    def submit(self, prompt: list[int], max_new: int) -> int:
        need = self.pool.pages_for(len(prompt) + max_new)
        if need > self.n_pages - 1:
            raise ValueError(
                f"request of {len(prompt)} + {max_new} tokens needs {need} "
                f"pages; the pool holds {self.n_pages - 1}")
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(Request(rid, list(prompt), max_new))
        return rid

    # ------------------------------ admission ------------------------------
    def _admit_one(self) -> int | None:
        """Admit at most one pending request when its first slab's pages
        fit.  While any sequence is swapped out, nothing new is admitted
        (restore before admit)."""
        if not self.pending or self.swapped \
                or len(self.active) >= self.max_batch:
            return None
        req = self.pending[0]
        first = min(self.prefill_chunk or len(req.prompt), len(req.prompt))
        if self.pool.free_pages < self.pool.pages_for(first):
            return None
        self.pending.popleft()
        self.active[req.rid] = _Seq(rid=req.rid, tokens=list(req.prompt),
                                    prompt_len=len(req.prompt),
                                    max_new=req.max_new)
        return req.rid

    # ------------------------------ preemption -----------------------------
    def preempt(self, rid: int) -> None:
        """Swap one resident sequence out to the host store and queue it for
        an oldest-first restore."""
        seq = self.active.pop(rid)
        n_tok = 0
        if self.pool.owns(rid):
            n_tok = self.pool.seq_len(rid)
            self.store.put(rid, self.executor.swap_out(rid, self.pool.pages(rid)),
                           n_tok)
            self.pool.release(rid)
        self.swapped[rid] = _Swapped(seq=seq, n_tokens=n_tok)
        self.preemptions += 1

    def _ensure_pages(self, rid: int, new_len: int) -> bool:
        """Make room to grow ``rid`` to ``new_len`` tokens by preempting
        strictly younger residents, youngest first.  The youngest that is
        still short stalls (False) and retries next step; the oldest never
        stalls, so the engine cannot livelock."""
        held = len(self.pool.pages(rid)) if self.pool.owns(rid) else 0
        need = self.pool.pages_for(new_len) - held
        while need > self.pool.free_pages:
            victim = max((r for r in self.active if r > rid), default=None)
            if victim is None:
                return False
            self.preempt(victim)
        return True

    def _restore_one(self) -> int | None:
        """Re-admit the oldest swapped sequence once its pages fit."""
        if not self.swapped or len(self.active) >= self.max_batch:
            return None
        rid = min(self.swapped)
        ent = self.swapped[rid]
        if ent.n_tokens and \
                self.pool.free_pages < self.pool.pages_for(ent.n_tokens):
            return None
        if ent.n_tokens:
            pages = self.pool.allocate(rid, ent.n_tokens)
            blob, _ = self.store.take(rid)
            self.executor.swap_in(rid, pages, blob)
        del self.swapped[rid]
        self.active[rid] = ent.seq
        self.restores += 1
        return rid

    # ------------------------------ prefill --------------------------------
    def _prefill_slab(self) -> int | None:
        """Advance the oldest prefilling sequence by one slab."""
        rid = next((r for r in sorted(self.active)
                    if self.active[r].in_prefill), None)
        if rid is None:
            return None
        seq = self.active[rid]
        t0 = seq.prefilled
        t1 = min(t0 + (self.prefill_chunk or seq.prompt_len), seq.prompt_len)
        if not self._ensure_pages(rid, t1):
            return None
        if self.pool.owns(rid):
            self.pool.extend(rid, t1 - t0)
        else:
            self.pool.allocate(rid, t1)
        pages = self.pool.pages(rid)
        n_hist = t0 // self.page_size
        final = t1 == seq.prompt_len
        # every slab runs at the FULL prompt's bucket, so each query row's
        # carry format is the one-shot walk's
        bucket_i, bucket = self.plan.bucket_for(seq.prompt_len)
        call = self.plan.kernel_call(bucket_i, kv_fmt=self.kv_fmt)
        tok = self.executor.prefill(PrefillRequest(
            rid=rid, tokens=tuple(seq.tokens[t0:t1]),
            hist_pages=tuple(pages[:n_hist]),
            slab_pages=tuple(pages[n_hist:]), t0=t0, acc=bucket.acc,
            final=final, bucket_pages=bucket.max_pages(self.page_size),
            call=call))
        seq.prefilled = t1
        self.prefill_slabs += 1
        self.prefill_tokens += t1 - t0
        if final:
            seq.tokens.append(int(tok))
            seq.generated.append(int(tok))
            self._maybe_finish(seq)
        return rid

    # ------------------------------ decode ---------------------------------
    def _decode_batch(self) -> list[int]:
        """One decode token for every running (fully prefilled) sequence."""
        batch: list[_Seq] = []
        for rid in sorted(self.active):
            seq = self.active.get(rid)
            if seq is None or seq.in_prefill:
                continue
            if not self._ensure_pages(rid, self.pool.seq_len(rid) + 1):
                continue
            self.pool.extend(rid)
            batch.append(seq)
        if not batch:
            return []
        _, bucket = self.plan.bucket_for(
            max(self.pool.seq_len(s.rid) for s in batch))
        pt = self.pool.page_table([s.rid for s in batch],
                                  bucket.max_pages(self.page_size))
        next_toks = self.executor.decode(DecodeRequest(
            rids=tuple(s.rid for s in batch),
            last_tokens=tuple(s.tokens[-1] for s in batch),
            page_table=tuple(tuple(r) for r in pt.tolist()),
            positions=tuple(s.pos for s in batch),
            seq_lens=tuple(s.pos + 1 for s in batch), acc=bucket.acc))
        finished = []
        for seq, tok in zip(batch, next_toks):
            seq.tokens.append(int(tok))
            seq.generated.append(int(tok))
            self.decoded_tokens += 1
            if self._maybe_finish(seq):
                finished.append(seq.rid)
        self._decode_steps += 1
        if self.monitor_cadence and \
                self._decode_steps % self.monitor_cadence == 0:
            self._monitor()
        return finished

    def _maybe_finish(self, seq: _Seq) -> bool:
        if seq.done:
            self.finished[seq.rid] = list(seq.generated)
            self.pool.release(seq.rid)
            del self.active[seq.rid]
            return True
        return False

    # ------------------------------ stepping -------------------------------
    def step(self) -> dict:
        """One tick: at most one restore or admission, at most one prefill
        slab, one batched decode."""
        self.steps += 1
        restored = self._restore_one()
        admitted = self._admit_one() if restored is None else None
        self.max_concurrent = max(self.max_concurrent, len(self.active))
        prefilled = self._prefill_slab()
        finished = self._decode_batch() if self.active else []
        return {"admitted": admitted, "restored": restored,
                "prefilled": prefilled, "finished": finished,
                "active": len(self.active), "pending": len(self.pending),
                "swapped": len(self.swapped),
                "free_pages": self.pool.free_pages}

    def run(self, max_steps: int = 100_000) -> dict[int, list[int]]:
        """Drive to completion; returns {rid: generated tokens}."""
        for _ in range(max_steps):
            if not self.pending and not self.active and not self.swapped:
                break
            self.step()
        else:
            raise RuntimeError("serve loop did not drain (pool too small "
                               "for the pending prompts?)")
        return dict(self.finished)

    # ------------------------------ monitor --------------------------------
    def _monitor(self) -> None:
        """Swamping probe of the longest running context; a breach (the
        measured swamp rate, or the closed-form knee test at the bucket's
        worst case ``certified_log_v``) re-buckets before the context
        swamps.  The bucket is keyed by the GROWN context length, not by
        the prompt's admission bucket."""
        running = [r for r, s in self.active.items() if not s.in_prefill]
        if not running:
            return
        sid = max(running, key=lambda r: self.pool.seq_len(r))
        ctx = self.pool.seq_len(sid)
        bucket_i, bucket = self.plan.bucket_for(ctx)
        width = bucket.max_pages(self.page_size)
        stats = self.executor.measure_vrr(
            self.pool.page_table([sid], width)[0], ctx, bucket.acc,
            self._gen)
        n2 = -(-ctx // self.page_size)
        swamp = float(stats.swamp_rate)
        v_pred = certified_log_v(
            bucket.m_acc, self.plan.m_p, self.page_size, bucket.max_ctx,
            extra_carry_events(self.page_size, self.plan.prefill_chunk,
                               bucket.resumptions))
        breach_m = swamp >= self.swamp_threshold
        breach_p = v_pred >= CUTOFF_LOG_V
        breach = breach_m or breach_p
        if breach:
            self.plan = self.plan.bumped(bucket_i)
        # the width after the (carrier-clamped) bump: at the m_acc ceiling
        # a breach is a saturated no-op, and the log says so
        m_now = self.plan.buckets[bucket_i].m_acc
        event = {
            "step": self._decode_steps,
            "event": ("rebucket" if breach and m_now > bucket.m_acc
                      else "saturated" if breach else "ok"),
            "source": ("both" if breach_m and breach_p
                       else "measured" if breach_m
                       else "predicted" if breach_p else None),
            "gemm": "attn_decode", "role": "serve",
            "bucket": bucket_i, "ctx": ctx, "n1": self.page_size, "n2": n2,
            "m_acc": m_now,
            "measured_vrr": round(float(stats.measured_vrr), 6),
            "log_v": round(float(stats.measured_log_v(n2)), 4),
            "log_v_pred": round(float(v_pred), 4),
            "cutoff": round(CUTOFF_LOG_V, 4),
            "swamp_rate": round(swamp, 6),
            "swamp_threshold": self.swamp_threshold,
            # the KV-magnitude hint this window certifies, beside the one
            # the plan was built under
            "v_hint_plan": self.plan.v_hint,
            "v_hint_measured": derive_v_hint(stats, ctx),
        }
        self.events.append(event)
        if self.monitor_log:
            jsonl_append(self.monitor_log, [event])

    # ------------------------------ accounting -----------------------------
    def utilization(self) -> float:
        """Decoded tokens per decode-batch slot."""
        return self.decoded_tokens / max(self.steps * self.max_batch, 1)

    def kv_bytes_per_token(self, *, carrier_bytes: int = 1,
                           per_shard: bool = False) -> float:
        """Arena bytes a cached token: the whole arena's (the same under
        tensor parallelism, split), or with ``per_shard=True`` what one
        rank holds (its KV heads, the replicated page exponents)."""
        return kv_bytes_per_token(
            self.pc, carrier_bytes=carrier_bytes,
            tp_shards=self.tp_shards if per_shard else 1)
