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

``ModelExecutor`` is the only place device work happens.  As JAX's, it
keeps a process-wide compile cache (``_PROCESS_CACHE``) of one signature
per (bucket, kernel), padded as JAX pads: on the card each signature is a
captured CUDA graph, replayed with its inputs copied into a static buffer
and the greedy argmax inside; ``warmup`` makes every certified bucket's
signatures before traffic, and ``compile_stats`` counts compiles (captures),
dispatch hits and misses.  The padded rows are byte-neutral, so the arena
and logits are the eager step's.

The serve-time VRR monitor (``monitor_cadence``): every N decode steps it
probes the longest running context's layer-0 decode accumulator with a
unit-Gaussian query through K12's kernel (``measure_decode_vrr``).  A
breach, the measured swamp rate at or over ``swamp_threshold`` or the
closed-form knee test of the context's bucket, bumps that bucket's m_acc
(``AttnPlan.bumped``) before the context swamps; the bucket is the one of
the grown context.  Each tick logs one event (``self.events``, and
``monitor_log`` as JSON lines).  Tracing, metrics and speculative decoding
are not ported yet; speculative decoding is ``serve.spec``.

Tensor-parallel serving (``ShardedModelExecutor``): each rank of a
``torch.distributed`` group runs the same engine schedule in lockstep on
its output-dim slice of the params and its KV-head slice of the arena;
the engine then allocates through a ``ShardedPagePool`` and plans for the
cross-rank carry merge (``plan_attention(tp_shards=)``).  The ranks'
logits are gathered exactly, so every rank takes the same host decisions
(greedy tokens, preemptions, the monitor's draws).  Its gloo collectives
run on the host, so its steps are not captured: it stays eager, and its
``compile_stats`` count signatures as on the CPU.
"""

from __future__ import annotations

import functools
import time
import weakref
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.vrr import CUTOFF_LOG_V
from repro_torch.dist import LOCAL, Dist, all_gather
from repro_torch.models.api import (
    DecodeRequest,
    PrefillRequest,
    VerifyRequest,
    get_paged_model,
)
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
    truncate_pages,
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
           "resolve_device", "measure_decode_vrr", "process_cache_stats"]


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


# One compile cache a serving process, as JAX's ``_PROCESS_CACHE``: keyed
# on everything a step closes over (config, formats, widths, the device
# topology) and, unlike JAX, where params and arena are operands, on their
# storage: a captured CUDA graph holds the pointers it was captured with,
# so executors with other weights or another arena must not replay it
# (ROADMAP T7).  An entry holds no reference to its executor; when the
# executor is collected its signatures and graph pool are dropped (the
# pointers they hold are then dead, and the pool's memory goes back to the
# allocator) and its counters stay.
_PROCESS_CACHE: dict = {}


def _device_topology(device: torch.device) -> tuple:
    """The device count and name folded into every cache key: graphs are
    captured for a card, so executors that see another card, or a count
    changed under them, must not share one."""
    if device.type == "cuda":
        return (torch.cuda.device_count(), torch.cuda.get_device_name(device))
    return (1, device.type)


def _fresh_cache_entry() -> dict:
    return {"fns": {}, "pool": None,
            "stats": {"compiles": 0, "hits": 0, "misses": 0,
                      "warm_compiles": 0}}


def _release_entry(entry: dict) -> None:
    """Drop a collected executor's signatures and graph pool."""
    entry["fns"].clear()
    entry["pool"] = None


def process_cache_stats() -> dict:
    """The compile-cache counters summed over every cached executor
    configuration of this process; ``entries`` counts the configurations."""
    agg = {"entries": len(_PROCESS_CACHE), "compiles": 0, "hits": 0,
           "misses": 0, "warm_compiles": 0}
    for entry in _PROCESS_CACHE.values():
        for k, v in entry["stats"].items():
            agg[k] = agg.get(k, 0) + v
    return agg


def _storage(tree) -> tuple:
    """The data pointers of a tree's tensors, in insertion order."""
    if isinstance(tree, dict):
        return tuple(p for v in tree.values() for p in _storage(v))
    return (tree.data_ptr(),)


def _launch_counters() -> list:
    """(wrapper, attribute) of every kernel launch count a serving step
    can move."""
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import fused as F
    from repro_torch.kernels import qmatmul as K3
    from repro_torch.kernels import quantize as K2

    fns = (A.paged_attn_decode, A.flash_prefill_paged,
           A.flash_prefill_paged_geom, A.flash_prefill, F.qmatmul_fused,
           K2.quantize, K3.qmatmul)
    return [(fn, name) for fn in fns for name in sorted(vars(fn))
            if name.endswith("launches")]


class _StepGraph:
    """One captured serving step: a static int32 input buffer, the CUDA
    graph of ``fn(buffer)`` and its outputs, and the launch counts one
    replay makes (recorded at capture, when the wrappers count launches
    the graph only records; the capture's own counts are taken back).
    The step function, a closure over its executor, is dropped after the
    capture, so the process cache never keeps an executor alive."""

    def __init__(self, fn, n_inputs: int, device, pool):
        self.fn = fn
        self.buf = torch.zeros((n_inputs,), dtype=torch.int32, device=device)
        self.pool = pool
        self.graph = None
        self.outputs = None
        self.deltas: list = []

    def run_eager(self, values: np.ndarray):
        """The step on ``values`` without the graph (the warm-up before a
        capture: it builds and loads the kernels and sets their shared
        memory), on a side stream as ``torch.cuda.graph`` asks."""
        self.buf.copy_(torch.from_numpy(values))
        side = _side_stream(self.buf.device)
        side.wait_stream(torch.cuda.current_stream(self.buf.device))
        with torch.cuda.stream(side), torch.no_grad():
            out = self.fn(self.buf)
        torch.cuda.current_stream(self.buf.device).wait_stream(side)
        return out

    def capture(self) -> None:
        counters = _launch_counters()
        before = [getattr(fn, a) for fn, a in counters]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=self.pool), torch.no_grad():
            self.outputs = self.fn(self.buf)
        self.fn = None
        self.deltas = []
        for (fn, a), b in zip(counters, before):
            d = getattr(fn, a) - b
            setattr(fn, a, b)
            if d:
                self.deltas.append((fn, a, d))

    def replay(self, values: np.ndarray):
        self.buf.copy_(torch.from_numpy(values))
        self.graph.replay()
        for fn, a, d in self.deltas:
            setattr(fn, a, getattr(fn, a) + d)
        return self.outputs


@functools.cache
def _side_stream(device) -> torch.cuda.Stream:
    """One warm-up stream a device for every capture (a library keeps a
    workspace for each stream it has run on)."""
    return torch.cuda.Stream(device)


def _int32(*parts) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.int32).reshape(-1)
                           for x in parts])


class ModelExecutor:
    """Device-side executor: the model, its params, the paged arena and
    the compile cache.

    A step is one signature of the process cache (``_PROCESS_CACHE``):
    decode per (carry format, page-table width) at ``max_batch`` rows,
    prefill per (carry format, page-row width, slab width, final), verify
    per (carry format, width, k + 1), and the rollback scrub at its padded
    width.  On the card (``graphs``, the default there) a signature's
    first call runs the step and captures it in a CUDA graph, and every
    later call copies its inputs into the graph's static int32 buffer
    (one host-to-device copy), replays it and reads the ``max_batch``
    greedy tokens, formed by the argmax inside the graph (one
    device-to-host read).  All graphs of an executor share one memory
    pool.  A capture that fails raises; nothing falls back to the eager
    step.  ``graphs=False`` on the card is the eager executor, kept for
    the bitwise gates: the same steps, launched call by call, with P's
    launch-argument geometry.  On the CPU nothing is captured; a
    signature's first call is its compile.  ``compile_stats`` keeps JAX's
    counters: ``compiles`` (captures, or first calls), ``hits``/``misses``
    (calls that found / made their signature) and ``warm_compiles``.

    Inputs are padded as the JAX executor pads them: decode and verify to
    ``max_batch`` rows (null-page table rows, length 0), a prefill slab to
    its bucket's slab width (zero tokens past ``q_len``, the slab's pages
    padded with the null page) and page-row width.  The padded rows write
    only zeros, or a masked token, into the null page."""

    dist: Dist = LOCAL

    def __init__(self, model, params, pc: PagedKVConfig, *, kv_fmt: FPFormat,
                 max_batch: int = 8, device="cuda", graphs: bool | None = None):
        self.cfg = model.cfg
        self.params = params
        self.pc = pc
        self.kv_fmt = kv_fmt
        self.max_batch = max_batch
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        if graphs and not cuda:
            raise ValueError("CUDA graphs need a CUDA device")
        self.graphs = cuda if graphs is None else bool(graphs)
        # P's geometry as device tensors, except on the eager executor on
        # the card (its launch-argument entry)
        self.device_geometry = self.graphs or not cuda
        self.kv = init_arena(pc, self.device)
        self.pm = get_paged_model(model.cfg)
        self.rollback_pad: int | None = None
        key = self._cache_key()
        entry = _PROCESS_CACHE.get(key)
        if entry is None:
            entry = _PROCESS_CACHE[key] = _fresh_cache_entry()
        self._cache = entry
        weakref.finalize(self, _release_entry, entry)
        self._last: dict = {}

    def _cache_key(self) -> tuple:
        """What a step closes over: config, formats, padding widths, the
        device topology, the executor's kind, and the storage of its params
        and arena (a graph's pointers).  Subclasses add their own."""
        return ("model-executor", self.cfg, self.kv_fmt, self.max_batch,
                self.pc, _device_topology(self.device), self.graphs,
                _storage(self.params), _storage(self.kv))

    # ------------------------------ dispatch -------------------------------
    def _pool(self):
        if self._cache["pool"] is None:
            self._cache["pool"] = torch.cuda.graph_pool_handle()
        return self._cache["pool"]

    def _compile(self, key, fn, values: np.ndarray):
        """Make signature ``key``: run the step on ``values`` and, on the
        graph executor, capture it.  Returns the run's outputs."""
        stats = self._cache["stats"]
        stats["compiles"] += 1
        if not self.graphs:
            self._cache["fns"][key] = None
            return self._eager(fn, values)
        g = _StepGraph(fn, values.size, self.device, self._pool())
        out = g.run_eager(values)
        g.capture()
        self._cache["fns"][key] = g
        return out

    def _eager(self, fn, values: np.ndarray):
        with torch.no_grad():
            return fn(torch.from_numpy(values).to(self.device))

    def _dispatch(self, key, fn, values: np.ndarray):
        """Run one step of signature ``key`` (``fn`` on the int32 input
        vector ``values``), counting a hit or a miss."""
        stats = self._cache["stats"]
        fns = self._cache["fns"]
        if key not in fns:
            stats["misses"] += 1
            return self._compile(key, fn, values)
        stats["hits"] += 1
        g = fns[key]
        return self._eager(fn, values) if g is None else g.replay(values)

    def _null_page(self) -> dict:
        return {name: t[:, 0].clone() for name, t in self.kv.items()}

    def _restore_null_page(self, saved: dict) -> None:
        for name, t in self.kv.items():
            t[:, 0].copy_(saved[name])

    # ------------------------------ step functions -------------------------
    def _decode_fn(self, acc, width: int):
        b = self.max_batch
        cuts = np.cumsum([b, b * width, b, b])

        def step(buf):
            tok, pt, pos, sl = torch.tensor_split(buf, tuple(cuts[:-1]))
            logits = self.pm.decode(
                self.params, tok.long().reshape(b, 1), self.kv,
                pt.reshape(b, width), pos, sl, kv_fmt=self.kv_fmt, acc=acc,
                dist=self.dist)
            return {"logits": logits,
                    "tokens": torch.argmax(logits[:, 0], dim=-1)}

        return step

    def _prefill_fn(self, acc, width: int, slab_w: int, final: bool, call):
        n_slab = -(-slab_w // self.pc.page_size)
        cuts = (slab_w, slab_w + width, slab_w + width + n_slab,
                slab_w + width + n_slab + 1)
        host = not self.device_geometry

        def step(buf, q_offset=None, q_len=None):
            toks, row, slab, q0, ql = torch.tensor_split(buf, cuts)
            if host:
                geom = (q_offset, q_len)
            else:
                geom = (q0.reshape(()), ql.reshape(()))
            logits = self.pm.prefill(
                self.params, toks.long().reshape(1, slab_w), self.kv, row,
                slab.long(), *geom, kv_fmt=self.kv_fmt, acc=acc, call=call,
                want_logits=final, dist=self.dist)
            if logits is None:
                return {"logits": None, "tokens": None}
            return {"logits": logits,
                    "tokens": torch.argmax(logits, dim=-1)}

        return step

    def _verify_fn(self, acc, width: int, s_v: int):
        b = self.max_batch
        cuts = np.cumsum([b * s_v, b * width, b, b])

        def step(buf):
            tok, pt, pos, sl = torch.tensor_split(buf, tuple(cuts[:-1]))
            logits = self.pm.verify(
                self.params, tok.long().reshape(b, s_v), self.kv,
                pt.reshape(b, width), pos, sl, kv_fmt=self.kv_fmt, acc=acc,
                dist=self.dist)
            return {"logits": logits,
                    "tokens": torch.argmax(logits, dim=-1)}

        return step

    def _rollback_fn(self, pad: int):
        def step(buf):
            truncate_pages(self.kv, buf[:pad], buf[pad], buf[pad + 1])
            return {}

        return step

    # ------------------------------ engine ops -----------------------------
    def _prefill_inputs(self, req: PrefillRequest):
        page_size = self.pc.page_size
        n_tok = len(req.tokens)
        width = req.slab_width or n_tok
        n_hist = len(req.hist_pages)
        n_slab = -(-width // page_size)
        toks = np.zeros((width,), np.int32)
        toks[:n_tok] = req.tokens
        slab = np.zeros((n_slab,), np.int32)
        slab[:len(req.slab_pages)] = req.slab_pages
        row = np.zeros((req.bucket_pages or (n_hist + n_slab),), np.int32)
        row[:n_hist] = req.hist_pages
        row[n_hist:n_hist + len(req.slab_pages)] = req.slab_pages
        return width, row.size, _int32(toks, row, slab, req.t0, n_tok)

    def prefill_logits(self, req: PrefillRequest) -> torch.Tensor | None:
        """Run one prefill slab, padded as the JAX executor pads it; the
        (1, V) logits of its last live row on the final slab, else None
        (on the graph executor, a view of the graph's output, valid until
        its next replay)."""
        slab_w, width, values = self._prefill_inputs(req)
        key = ("prefill", tuple(req.acc), width, slab_w, req.final)
        fn = self._prefill_fn(req.acc, width, slab_w, req.final, req.call)
        if not self.device_geometry:
            fn = functools.partial(fn, q_offset=req.t0,
                                   q_len=len(req.tokens))
        out = self._dispatch(key, fn, values)
        self._last = out
        return out["logits"]

    def prefill(self, req: PrefillRequest) -> int | None:
        """One prefill slab; the first generated token (greedy, the step's
        argmax) on the final slab."""
        self.prefill_logits(req)
        return int(self._last["tokens"][0]) if req.final else None

    def _batch_inputs(self, req, tokens: np.ndarray):
        pt_in = np.asarray(req.page_table, np.int32)
        n, width = pt_in.shape
        b = self.max_batch
        pt = np.zeros((b, width), np.int32)
        pt[:n] = pt_in
        tok = np.zeros((b,) + tokens.shape[1:], np.int32)
        tok[:n] = tokens
        pos = np.zeros((b,), np.int32)
        pos[:n] = req.positions
        sl = np.zeros((b,), np.int32)
        sl[:n] = req.seq_lens
        return n, width, _int32(tok, pt, pos, sl)

    def decode_logits(self, req: DecodeRequest) -> torch.Tensor:
        """One batched decode step, padded to ``max_batch`` rows; returns
        the live rows' logits (n, V) (on the graph executor, a view of the
        graph's output, valid until its next replay)."""
        n, width, values = self._batch_inputs(
            req, np.asarray(req.last_tokens, np.int32))
        out = self._dispatch(("decode", tuple(req.acc), width),
                             self._decode_fn(req.acc, width), values)
        self._last = out
        return out["logits"][:n, 0]

    def decode(self, req: DecodeRequest) -> list[int]:
        """One batched decode token per row; returns the next tokens (the
        step's argmax)."""
        self.decode_logits(req)
        return self._last["tokens"][:len(req.rids)].tolist()

    def verify(self, req: VerifyRequest) -> list[list[int]]:
        """One batched speculative-verify step, padded as ``decode``: each
        row's greedy argmax at each of its ``k + 1`` slab indices, entry j
        the target's next token after the row's first j + 1 candidates,
        bitwise what k + 1 sequential ``decode`` calls return."""
        s_v = len(req.tokens[0])
        n, width, values = self._batch_inputs(
            req, np.asarray(req.tokens, np.int32).reshape(-1, s_v))
        out = self._dispatch(("verify", tuple(req.acc), width, s_v),
                             self._verify_fn(req.acc, width, s_v), values)
        return out["tokens"][:n].tolist()

    def rollback(self, rid: int, pages_old: list[int], keep_len: int,
                 old_len: int) -> None:
        """Page-exact rejection: scrub the arena slots of the tokens
        ``keep_len..old_len-1`` (``kvcache.truncate_pages``) after the pool
        rolled the sequence back; ``pages_old`` is its page list before the
        rollback.  The released pages are padded to ``rollback_pad`` (set by
        ``warmup_verify``), so every rollback is one signature."""
        del rid, old_len
        page_size = self.pc.page_size
        n_keep = -(-keep_len // page_size)
        released = pages_old[n_keep:]
        keep_slots = keep_len % page_size
        boundary = pages_old[n_keep - 1] if keep_slots else 0
        if self.rollback_pad is None:
            self.rollback_pad = max(len(released), 1)
        pad = self.rollback_pad
        if len(released) > pad:
            raise ValueError(
                f"rollback released {len(released)} pages > padded width "
                f"{pad} (warm with a larger k)")
        rel = np.zeros((pad,), np.int32)
        rel[:len(released)] = released
        self._dispatch(("rollback", pad), self._rollback_fn(pad),
                       _int32(rel, boundary, keep_slots))

    # ------------------------------ warmup ---------------------------------
    def _warm(self, key, fn, n_inputs: int) -> None:
        if key not in self._cache["fns"]:
            self._compile(key, fn, np.zeros((n_inputs,), np.int32))

    def warmup(self, plan: AttnPlan, prefill_chunk: int | None = None,
               prefill_finals: tuple[bool, ...] | None = None) -> dict:
        """Make every certified bucket's signatures before traffic, as
        JAX's warmup compiles them: the padded decode step and the padded
        prefill slab, final and, for multi-slab prompts, non-final, each
        run once on zero operands (on the graph executor, and captured).
        The zero operands write only into the null page, which is restored,
        so the arena is untouched.  Returns ``{"buckets", "compiles",
        "seconds"}``; ``compile_stats()["warm_compiles"]`` adds what it
        paid."""
        t0 = time.perf_counter()
        stats = self._cache["stats"]
        before = stats["compiles"]
        page_size = self.pc.page_size
        saved = self._null_page()
        b_rows = self.max_batch
        for i, b in enumerate(plan.buckets):
            w = b.max_pages(page_size)
            self._warm(("decode", tuple(b.acc), w),
                       self._decode_fn(b.acc, w), b_rows * (w + 3))
            slab_w = prefill_chunk or b.max_ctx
            call = plan.kernel_call(i, kv_fmt=self.kv_fmt)
            finals = (list(prefill_finals) if prefill_finals is not None
                      else [True] + ([False] if prefill_chunk
                                     and b.max_ctx > prefill_chunk else []))
            n_slab = -(-slab_w // page_size)
            for final in finals:
                fn = self._prefill_fn(b.acc, w, slab_w, final, call)
                if not self.device_geometry:
                    fn = functools.partial(fn, q_offset=0, q_len=0)
                self._warm(("prefill", tuple(b.acc), w, slab_w, final), fn,
                           slab_w + w + n_slab + 2)
        self._restore_null_page(saved)
        self._sync()
        delta = stats["compiles"] - before
        stats["warm_compiles"] += delta
        return {"buckets": len(plan.buckets), "compiles": delta,
                "seconds": time.perf_counter() - t0}

    def warmup_verify(self, plan: AttnPlan, k: int, *,
                      include_verify: bool = True) -> dict:
        """Make the speculative lane's signatures before traffic: the
        (bucket, k) verify of every bucket and the one padded-width
        rollback scrub (``include_verify=False``: the scrub only, for the
        draft lane, which rolls back but is never verified)."""
        t0 = time.perf_counter()
        stats = self._cache["stats"]
        before = stats["compiles"]
        page_size = self.pc.page_size
        s_v = k + 1
        self.rollback_pad = -(-s_v // page_size) + 1
        saved = self._null_page()
        for b in plan.buckets if include_verify else ():
            w = b.max_pages(page_size)
            self._warm(("verify", tuple(b.acc), w, s_v),
                       self._verify_fn(b.acc, w, s_v),
                       self.max_batch * (s_v + w + 2))
        pad = self.rollback_pad
        self._warm(("rollback", pad), self._rollback_fn(pad), pad + 2)
        self._restore_null_page(saved)
        self._sync()
        delta = stats["compiles"] - before
        stats["warm_compiles"] += delta
        return {"buckets": len(plan.buckets), "k": k, "compiles": delta,
                "seconds": time.perf_counter() - t0}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def compile_stats(self) -> dict:
        """Copy of the compile-cache counters: ``compiles`` (captures, or
        first calls), ``hits``/``misses`` (calls that found / made their
        signature), ``warm_compiles`` (those made by ``warmup``)."""
        return dict(self._cache["stats"])

    @contextmanager
    def compile_stats_scope(self):
        """Yields a dict filled, on exit, with the with-block's delta of
        the counters (so tests need not reset the process-wide ones)."""
        before = dict(self._cache["stats"])
        delta: dict = {}
        try:
            yield delta
        finally:
            for k, v in self._cache["stats"].items():
                delta[k] = v - before.get(k, 0)

    def pool_bytes(self) -> int:
        """Bytes of the card held by this executor's graph memory pool
        (its segments in the caching allocator); 0 without graphs."""
        pool = self._cache["pool"]
        if pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(pool))

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
                         kv_fmt=kv_fmt, max_batch=max_batch, device=device,
                         graphs=False)
        # the sharded prefill takes its geometry as host ints
        self.device_geometry = False

    def _cache_key(self) -> tuple:
        return super()._cache_key() + (
            ("tp", self.dist.rank, self.dist.size, self.dist.logit_wire),)

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
                 executor=None, device="cuda", warm_start: bool = False):
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
        if warm_start:
            self.warmup()

    # ------------------------------ compile cache --------------------------
    def warmup(self) -> dict:
        """Make every certified bucket's prefill and decode signatures up
        front (on the card, capture their graphs), so steady-state serving
        makes none."""
        return self.executor.warmup(self.plan, self.prefill_chunk)

    def compile_stats(self) -> dict:
        """The executor's compile-cache counters."""
        return self.executor.compile_stats()

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
            slab_width=self.prefill_chunk or bucket.max_ctx, call=call))
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
