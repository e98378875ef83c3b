"""Deterministic scheduler simulation: a host-only executor and traces.

Counterpart of ``repro.serve.sim`` (numpy only).  ``SimExecutor`` plugs
into ``ServeEngine``'s executor seam and replaces the device work with a
stamped page arena:

* every KV write stamps ``(rid, absolute token index)`` into its slot;
* every attention read (prefill history, decode, verify) checks the
  stamps of the tokens it attends: a page handed to two sequences, a stale
  swapped-out page or a wrong-order restore raises ``SimCorruption``
  naming the slot;
* swapped-out pages are poisoned in the arena, so a table still pointing
  at one is caught on the next read;
* generated tokens are a pure function of ``(rid, absolute index)``, so
  lost, duplicated or reordered tokens show as a mismatch against
  ``expected_generation``.

A whole engine run is microseconds, so the tests replay many seeded
bursty traces.  With ``n_shards > 1`` it keeps a stamp arena per simulated
rank, writes every KV on each, and folds every read over the ranks in a
seeded permuted order (the analog of the exact carry merge): a rank whose
arena drifted is named.  The engine pairs such an executor with a
``ShardedPagePool``.  ``draft_wrong(rid, idx)`` corrupts a draft lane's
output at chosen positions, to force speculative rejections.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "BURSTY_POOL",
    "BURSTY_SEEDS",
    "BURSTY_TRACE",
    "SimCorruption",
    "SimExecutor",
    "TraceRequest",
    "bursty_utilization_comparison",
    "expected_generation",
    "poisson_burst_trace",
    "adversarial_trace",
    "replay_trace",
]


class SimCorruption(AssertionError):
    """KV integrity violation observed by the simulation executor."""


def _stamp(rid: int, idx: int) -> np.int64:
    return np.int64((rid << 24) | (idx + 1))  # +1 keeps 0 distinct from empty


_EMPTY = np.int64(-1)
_POISON = np.int64(-2)  # swapped-out page: any read of it is corruption


class SimExecutor:
    """Pure-host stand-in for ``ModelExecutor`` (see module docstring).

    ``vocab_size`` only shapes the deterministic token stream; the engine
    never inspects token values."""

    pc = None  # no device arena config; engine accounting falls back

    def __init__(self, *, n_pages: int, page_size: int,
                 vocab_size: int = 50021, n_shards: int = 1,
                 merge_seed: int = 0, draft_wrong=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.page_size = page_size
        self.vocab_size = vocab_size
        self.n_shards = n_shards
        # spec-decode DRAFT-lane wrongness: ``draft_wrong(rid, idx)`` True
        # corrupts the decode output predicting absolute index ``idx`` —
        # the knob the fuzz suite turns to force rejections at chosen
        # positions (page boundaries, total wrongness, seeded rates).
        # None (and on every TARGET-lane executor): the exact stream.
        self.draft_wrong = draft_wrong
        # one stamp arena per simulated shard; shard 0 doubles as
        # ``self.pages`` (alias, not copy) so single-shard tests that poke
        # the arena directly keep working — in mesh mode a poke of one
        # shard is a divergence the next verified read must catch
        self.shards = [np.full((n_pages, page_size), _EMPTY, np.int64)
                       for _ in range(n_shards)]
        self.pages = self.shards[0]
        self._merge_rng = np.random.RandomState(merge_seed)
        self.kv = None
        self.swap_outs = 0
        self.swap_ins = 0
        self.rollbacks = 0
        self.reads_verified = 0
        self.merges_folded = 0

    # ------------------------------ token stream ---------------------------
    def next_token(self, rid: int, idx: int) -> int:
        """The token at absolute position ``idx`` of sequence ``rid`` — a
        pure function, so any schedule must produce the same stream."""
        return (rid * 1_000_003 + idx * 97 + 13) % self.vocab_size

    # ------------------------------ shard plumbing -------------------------
    def _write(self, pg: int, slot: int, val: np.int64) -> None:
        for sh in self.shards:
            sh[pg, slot] = val

    def _merged_read(self, pg: int, slot: int, *, where: str) -> np.int64:
        """Fold every shard's slot value in a seeded-permuted order — the
        sim analog of the exact carry merge, whose combine is commutative
        so ANY fold order must yield the same value.  A shard that
        disagrees is named: that is precisely the drifted state in which
        the real cross-shard merge would stop being bit-exact."""
        if self.n_shards == 1:
            return self.pages[pg, slot]
        order = self._merge_rng.permutation(self.n_shards)
        merged = self.shards[order[0]][pg, slot]
        for s in order[1:]:
            got = self.shards[s][pg, slot]
            if got != merged:
                raise SimCorruption(
                    f"{where}: shard divergence at page {pg} slot {slot}: "
                    f"shard {s} holds {int(got)}, merge so far holds "
                    f"{int(merged)} — the cross-shard carry merge would "
                    "not be bit-exact")
            merged = max(merged, got)
            self.merges_folded += 1
        return merged

    def check_shard_lockstep(self) -> None:
        """Assert every shard's arena is byte-identical to shard 0 (the
        whole-arena form of what ``_merged_read`` checks slot-wise)."""
        for s in range(1, self.n_shards):
            if not np.array_equal(self.shards[s], self.pages):
                bad = np.argwhere(self.shards[s] != self.pages)[0]
                raise SimCorruption(
                    f"shard {s} arena diverged from shard 0 at "
                    f"page {bad[0]} slot {bad[1]}")

    # ------------------------------ verification ---------------------------
    def _verify(self, rid: int, pages: list[int] | np.ndarray,
                n_tokens: int, *, where: str) -> None:
        for idx in range(n_tokens):
            pg = int(pages[idx // self.page_size])
            slot = idx % self.page_size
            got = self._merged_read(pg, slot, where=where)
            want = _stamp(rid, idx)
            if got != want:
                kind = ("poisoned (stale swapped-out page)"
                        if got == _POISON else
                        "empty" if got == _EMPTY else
                        f"owned by rid {int(got) >> 24} "
                        f"idx {(int(got) & 0xFFFFFF) - 1}")
                raise SimCorruption(
                    f"{where}: rid {rid} token {idx} expected in page {pg} "
                    f"slot {slot}, but the slot is {kind}")
        self.reads_verified += n_tokens

    # ------------------------------ engine ops -----------------------------
    # The seam speaks the ``repro_torch.models.api`` paged protocol — the SAME
    # PrefillRequest/DecodeRequest objects ModelExecutor receives — so the
    # fuzz suite exercises the scheduler's real request construction.  The
    # sim ignores the bucket-padding fields (bucket_pages/slab_width/call):
    # it has no compiled shapes to keep stable, and stamping only the live
    # tokens is exactly what the padded device path writes.
    def prefill(self, req) -> int | None:
        self._verify(req.rid, list(req.hist_pages), req.t0,
                     where="prefill history")
        for j in range(len(req.tokens)):
            pg = int(req.slab_pages[j // self.page_size])
            self._write(pg, j % self.page_size, _stamp(req.rid, req.t0 + j))
        return (self.next_token(req.rid, req.t0 + len(req.tokens))
                if req.final else None)

    def decode(self, req) -> list[int]:
        out = []
        for i, rid in enumerate(req.rids):
            pos = int(req.positions[i])
            row = req.page_table[i]
            self._write(int(row[pos // self.page_size]),
                        pos % self.page_size, _stamp(rid, pos))
            self._verify(rid, row, int(req.seq_lens[i]), where="decode")
            tok = self.next_token(rid, int(req.seq_lens[i]))
            if self.draft_wrong is not None \
                    and self.draft_wrong(rid, int(req.seq_lens[i])):
                tok = (tok + 1) % self.vocab_size
            out.append(tok)
        return out

    def verify(self, req) -> list[list[int]]:
        """Speculative verify: stamp all ``s_v = k + 1`` candidate
        positions of every row (the batched analog of ``s_v`` sequential
        decode appends), verify the row's full stamped extent, and return
        each slab index's TRUE next token — the target's stream is a pure
        function of position, so emitted tokens are schedule- and
        proposal-independent by construction, exactly the property the
        fuzz suite pins bitwise."""
        out = []
        s_v = len(req.tokens[0])
        for i, rid in enumerate(req.rids):
            pos = int(req.positions[i])
            sl = int(req.seq_lens[i])
            row = req.page_table[i]
            for j in range(s_v):
                p = pos + j
                self._write(int(row[p // self.page_size]),
                            p % self.page_size, _stamp(rid, p))
            self._verify(rid, row, sl + s_v - 1, where="verify")
            out.append([self.next_token(rid, sl + j) for j in range(s_v)])
        return out

    def rollback(self, rid: int, pages_old: list[int], keep_len: int,
                 old_len: int) -> None:
        """Page-exact rejection: clear the stamps of tokens
        ``keep_len..old_len-1`` back to EMPTY on every shard — the sim
        analog of ``kvcache.truncate_pages``' zero-scrub.  A skipped or
        mis-ranged scrub leaves rejected stamps behind, which the
        spec-vs-plain final-arena equality check (and any read that trips
        over a stale slot) then catches."""
        for idx in range(keep_len, old_len):
            pg = int(pages_old[idx // self.page_size])
            self._write(pg, idx % self.page_size, _EMPTY)
        self.rollbacks += 1

    def swap_out(self, rid: int, pages: list[int]) -> dict:
        idx = np.asarray(pages, np.int64)

        def scrubbed(arena: np.ndarray) -> np.ndarray:
            stamps = arena[idx].copy()
            # slots past the sequence's length may hold a PRIOR owner's
            # stale stamps (pages are reused; the real engine never reads
            # past seq_len, so the stale bytes are dead) — scrub them so
            # the restore-time owner check only sees live data
            stamps[(stamps >> 24) != rid] = _EMPTY
            return stamps

        blob = {"stamps": scrubbed(self.pages)}
        if self.n_shards > 1:
            # every shard swaps ITS arena slice out (the real executor's
            # blob gathers each shard's kv-head bytes); restore must put
            # each one back or the next merged read catches the drift
            blob["shard_stamps"] = [scrubbed(sh) for sh in self.shards]
        for sh in self.shards:
            sh[idx] = _POISON
        self.swap_outs += 1
        return blob

    def swap_in(self, rid: int, pages: list[int], blob: dict) -> None:
        per_shard = blob.get("shard_stamps") or [blob["stamps"]]
        if len(per_shard) not in (1, self.n_shards):
            raise SimCorruption(
                f"restore of rid {rid}: blob holds {len(per_shard)} shard "
                f"arenas, executor runs {self.n_shards}")
        idx = np.asarray(pages, np.int64)
        for s, sh in enumerate(self.shards):
            stamps = per_shard[s if len(per_shard) > 1 else 0]
            if stamps.shape[0] != len(pages):
                raise SimCorruption(
                    f"restore of rid {rid}: blob holds {stamps.shape[0]} "
                    f"pages, engine allocated {len(pages)}")
            owners = {int(v) >> 24 for v in stamps.ravel()
                      if v != _EMPTY and v != _POISON}
            if owners - {rid}:
                raise SimCorruption(
                    f"restore of rid {rid} got a blob stamped by rids "
                    f"{owners}")
            sh[idx] = stamps
        self.swap_ins += 1

    def measure_vrr(self, page_row, ctx, acc, gen):
        raise NotImplementedError(
            "the sim executor has no numerics to probe; run the monitor "
            "against ModelExecutor")


def expected_generation(rid: int, prompt_len: int, max_new: int,
                        executor: SimExecutor) -> list[int]:
    """The one and only token stream a correct engine can emit for this
    request, independent of scheduling, preemption or swap order."""
    return [executor.next_token(rid, prompt_len + j) for j in range(max_new)]


# --------------------------------------------------------------------------
# virtual-clock arrival traces
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceRequest:
    t_arrive: int
    prompt_len: int
    max_new: int


def poisson_burst_trace(seed: int, *, n_requests: int = 12,
                        mean_gap: float = 2.0, burst_p: float = 0.35,
                        burst_size: int = 3,
                        prompt_range: tuple[int, int] = (2, 24),
                        gen_range: tuple[int, int] = (1, 12),
                        max_request_tokens: int | None = None,
                        ) -> list[TraceRequest]:
    """Bursty Poisson arrivals: exponential gaps, with probability
    ``burst_p`` a gap instead delivers a burst of ``burst_size``
    simultaneous requests — the regime where reservation admission
    collapses utilization."""
    rng = np.random.RandomState(seed)
    out: list[TraceRequest] = []
    t = 0
    while len(out) < n_requests:
        t += int(rng.exponential(mean_gap))
        k = burst_size if rng.rand() < burst_p else 1
        for _ in range(min(k, n_requests - len(out))):
            p = int(rng.randint(prompt_range[0], prompt_range[1] + 1))
            g = int(rng.randint(gen_range[0], gen_range[1] + 1))
            if max_request_tokens is not None:
                p = min(p, max(max_request_tokens - g, 1))
            out.append(TraceRequest(t, p, g))
    return out


def adversarial_trace(kind: str, *, n_requests: int = 6,
                      capacity_tokens: int = 64) -> list[TraceRequest]:
    """Hand-shaped worst cases: ``all_long`` (each request alone nearly
    fills the pool — maximal preemption churn), ``all_short`` (a flood of
    tiny requests — admission throughput), ``long_then_short`` and
    ``short_then_long`` (head-of-line blocking in both directions)."""
    long_p = max(capacity_tokens // 2 - 4, 2)
    long_g = max(capacity_tokens // 4, 1)
    if kind == "all_long":
        return [TraceRequest(0, long_p, long_g) for _ in range(n_requests)]
    if kind == "all_short":
        return [TraceRequest(i // 4, 2, 2) for i in range(n_requests)]
    if kind == "long_then_short":
        return [TraceRequest(0, long_p, long_g)] + [
            TraceRequest(1, 2, 2) for _ in range(n_requests - 1)]
    if kind == "short_then_long":
        return [TraceRequest(0, 2, 2) for _ in range(n_requests - 1)] + [
            TraceRequest(1, long_p, long_g)]
    raise ValueError(f"unknown adversarial trace kind {kind!r}")


# the pinned bursty-arrival comparison scenario, JAX's
BURSTY_POOL = dict(n_pages=16, page_size=4, max_batch=6)
BURSTY_TRACE = dict(n_requests=24, mean_gap=1.0, burst_p=0.5, burst_size=4,
                    prompt_range=(2, 12), gen_range=(2, 16),
                    max_request_tokens=60)
BURSTY_SEEDS = (11, 12, 13, 14, 15)


def bursty_utilization_comparison(seeds=BURSTY_SEEDS, *,
                                  vocab_size: int = 50) -> dict:
    """Replay the pinned bursty regime against the chunked-prefill +
    optimistic-admission + preemption engine AND the one-prefill-per-step
    worst-case-reservation baseline, aggregating utilization over
    ``seeds`` (every replay also verifies the schedule-independent output
    streams and PagePool invariants)."""
    from repro_torch.serve.scheduler import ServeEngine

    def total(reserve: bool) -> tuple[int, int, int]:
        dec = steps = preempts = 0
        for seed in seeds:
            ex = SimExecutor(n_pages=BURSTY_POOL["n_pages"],
                             page_size=BURSTY_POOL["page_size"],
                             vocab_size=vocab_size)
            eng = ServeEngine(
                None, None, executor=ex, **BURSTY_POOL,
                prefill_chunk_tokens=(None if reserve
                                      else BURSTY_POOL["page_size"]),
                reserve_admission=reserve)
            m = replay_trace(eng, poisson_burst_trace(seed, **BURSTY_TRACE))
            for rid, req in m["submitted"].items():
                exp = expected_generation(rid, req.prompt_len, req.max_new,
                                          ex)
                assert eng.finished[rid] == exp, (seed, rid)
            dec += m["decoded_tokens"]
            steps += m["steps"]
            preempts += m["preemptions"]
        return dec, steps, preempts

    dec_new, steps_new, preempts = total(False)
    dec_base, steps_base, _ = total(True)
    mb = BURSTY_POOL["max_batch"]
    return {
        "seeds": list(seeds),
        "utilization_chunked_preempt": round(dec_new / (steps_new * mb), 4),
        "utilization_reservation_baseline": round(
            dec_base / (steps_base * mb), 4),
        "utilization_gain": round(
            (dec_new / steps_new) / (dec_base / steps_base), 4),
        "steps_chunked_preempt": steps_new,
        "steps_reservation_baseline": steps_base,
        "preemptions": preempts,
    }


def replay_trace(engine, trace: list[TraceRequest], *,
                 prompt_fn=None, max_steps: int = 20_000,
                 check_invariants: bool = True) -> dict:
    """Drive an engine against a virtual-clock arrival trace: each tick
    submits every request whose arrival time has come, then runs one
    ``engine.step()``.  Checks PagePool invariants every tick and that the
    queue fully drains (completion/no-livelock).  Returns scheduling
    metrics plus the {rid: TraceRequest} map for output verification."""
    prompt_fn = prompt_fn or (lambda req: [1] * req.prompt_len)
    trace = sorted(trace, key=lambda r: r.t_arrive)
    submitted: dict[int, TraceRequest] = {}
    # if the engine carries a tracer on a virtual clock, drive it from this
    # loop's tick counter: span timestamps then ARE schedule positions, so
    # a fixed trace + seed yields a byte-identical span tree
    from repro_torch.obs.clock import VirtualClock
    vclock = getattr(getattr(engine, "tracer", None), "clock", None)
    if not isinstance(vclock, VirtualClock):
        vclock = None
    i = 0
    clock = 0
    while i < len(trace) or engine.pending or engine.active or engine.swapped:
        if vclock is not None:
            vclock.set(clock)
        while i < len(trace) and trace[i].t_arrive <= clock:
            rid = engine.submit(prompt_fn(trace[i]), trace[i].max_new)
            submitted[rid] = trace[i]
            i += 1
        engine.step()
        if check_invariants:
            engine.pool.check_invariants()
        clock += 1
        if clock > max_steps:
            raise RuntimeError(
                f"trace did not drain in {max_steps} steps: "
                f"{len(engine.pending)} pending, {len(engine.active)} "
                f"active, {len(engine.swapped)} swapped — livelock?")
    return {
        "steps": clock,
        "decoded_tokens": engine.decoded_tokens,
        "utilization": engine.utilization(),
        "prefill_slabs": engine.prefill_slabs,
        "preemptions": engine.preemptions,
        "restores": engine.restores,
        "max_concurrent": engine.max_concurrent,
        "submitted": submitted,
    }
