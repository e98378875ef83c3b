"""The port's scheduler simulation: JAX's ``tests/test_serve_sim.py``
cases through the port's ``ServeEngine``/``SpecDecodeEngine`` and its
``repro_torch.serve.sim.SimExecutor`` (numpy only, no model), and the two
packages' engines held against each other on the same traces: every
engine step's record, the streams, the events and the pinned bursty
utilization comparison, exactly.

The port's engine runs the JAX engine's schedule: the same admission
(optimistic or by reservation), victim, restore, slab and speculative
round rules.  The simulation stamps every KV write with (rid, index) and
checks every read, so any schedule must reproduce the one token stream
(``expected_generation``); PagePool invariants are checked after every
step.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from repro_torch.serve.scheduler import ServeEngine
from repro_torch.serve.sim import (
    SimCorruption,
    SimExecutor,
    _EMPTY,
    _stamp,
    adversarial_trace,
    expected_generation,
    poisson_burst_trace,
    replay_trace,
)
from repro_torch.serve.spec import SpecDecodeEngine

# JAX's pinned seed (``REPRO_SIM_SEED`` rotates it)
BASE_SEED = int(os.environ.get("REPRO_SIM_SEED", "20260730"))

# (n_pages, max_batch, n_requests, prompt_range, gen_range): three traffic
# regimes — mixed bursty, tiny-request flood, near-capacity requests
REGIMES = [
    (16, 6, 16, (4, 16), (4, 12)),
    (16, 6, 24, (2, 12), (2, 16)),
    (12, 4, 12, (2, 24), (1, 12)),
]
CHUNKS = (None, 4, 8)
SEEDS_PER_CONFIG = 19  # 3 regimes x 3 chunk modes x 19 seeds = 171 replays
PAGE = 4


def make_engine(n_pages=12, max_batch=4, **kw):
    ex = SimExecutor(n_pages=n_pages, page_size=PAGE, vocab_size=211)
    eng = ServeEngine(None, None, n_pages=n_pages, page_size=PAGE,
                      max_batch=max_batch, executor=ex, **kw)
    return eng, ex


def assert_outputs_exact(eng, ex, submitted, *, ctx=""):
    for rid, req in submitted.items():
        got = eng.finished.get(rid)
        exp = expected_generation(rid, req.prompt_len, req.max_new, ex)
        assert got is not None, f"{ctx}: rid {rid} never completed"
        assert got == exp, (
            f"{ctx}: rid {rid} generated {got}, expected {exp} — tokens "
            "lost/duplicated/reordered across scheduling")


# --------------------------------------------------------------------------
# seeded virtual-clock trace replays (the bulk of the 500+ schedules)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("regime", range(len(REGIMES)))
@pytest.mark.parametrize("chunk", CHUNKS)
def test_bursty_trace_replays(regime, chunk):
    n_pages, mb, nreq, pr, gr = REGIMES[regime]
    preempts = 0
    for i in range(SEEDS_PER_CONFIG):
        seed = BASE_SEED + 1000 * regime + i
        eng, ex = make_engine(n_pages=n_pages, max_batch=mb,
                              prefill_chunk_tokens=chunk)
        trace = poisson_burst_trace(
            seed, n_requests=nreq, prompt_range=pr, gen_range=gr,
            max_request_tokens=eng.tokens_capacity)
        m = replay_trace(eng, trace)
        assert_outputs_exact(eng, ex, m["submitted"],
                             ctx=f"regime {regime} chunk {chunk} seed {seed}")
        assert eng.pool.free_pages == eng.pool.n_pages - 1
        assert not eng.active and not eng.swapped and not eng.pending
        assert len(eng.store) == 0, "swap store leaked entries"
        preempts += m["preemptions"]
    if regime == 2 and chunk is not None:
        assert preempts > 0, (
            "the near-capacity regime never preempted — the fuzz suite is "
            "not exercising the swap path")


@pytest.mark.parametrize("kind", ["all_long", "all_short",
                                  "long_then_short", "short_then_long"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_adversarial_traces(kind, chunk):
    eng, ex = make_engine(n_pages=17, max_batch=4, prefill_chunk_tokens=chunk)
    trace = adversarial_trace(kind, n_requests=6,
                              capacity_tokens=eng.tokens_capacity)
    m = replay_trace(eng, trace)
    assert_outputs_exact(eng, ex, m["submitted"], ctx=kind)
    assert eng.pool.free_pages == eng.pool.n_pages - 1


# --------------------------------------------------------------------------
# random op-sequence fuzz: submit / step / forced preempt interleaved
# --------------------------------------------------------------------------


N_FUZZ_SCHEDULES = 330


def test_fuzz_submit_step_preempt_sequences():
    """The numpy fuzz machine (runs even without hypothesis): random
    interleavings of submit, step and FORCED preemption — including of the
    oldest sequence, which the engine's own victim policy never picks —
    with PagePool invariants checked after every operation and exact
    output verification at drain."""
    total_preempts = total_restores = 0
    for i in range(N_FUZZ_SCHEDULES):
        seed = BASE_SEED + 31 * i
        rng = np.random.RandomState(seed)
        n_pages = int(rng.randint(6, 20))
        eng, ex = make_engine(
            n_pages=n_pages, max_batch=int(rng.randint(2, 6)),
            prefill_chunk_tokens=(None, 4, 8)[rng.randint(3)])
        submitted = {}
        cap = eng.tokens_capacity
        for _ in range(int(rng.randint(5, 40))):
            op = rng.rand()
            if op < 0.35 and len(submitted) < 12:
                g = int(rng.randint(1, 8))
                p = int(rng.randint(1, max(cap - g, 2)))
                if eng.pool.pages_for(p + g) > n_pages - 1:
                    p = max(cap - g, 1)
                rid = eng.submit([1] * p, g)
                submitted[rid] = (p, g)
            elif op < 0.45 and eng.active:
                # forced preemption at an arbitrary point — victim chosen
                # uniformly, not by the engine's youngest-first policy
                rid = list(eng.active)[rng.randint(len(eng.active))]
                eng.preempt(rid)
            else:
                eng.step()
            eng.pool.check_invariants()
        # drain
        for _ in range(5000):
            if not eng.pending and not eng.active and not eng.swapped:
                break
            eng.step()
            eng.pool.check_invariants()
        else:
            raise AssertionError(f"seed {seed}: engine failed to drain")
        for rid, (p, g) in submitted.items():
            exp = expected_generation(rid, p, g, ex)
            assert eng.finished.get(rid) == exp, (
                f"seed {seed}: rid {rid} got {eng.finished.get(rid)}, "
                f"expected {exp}")
        assert len(eng.store) == 0
        total_preempts += eng.preemptions
        total_restores += eng.restores
    assert total_preempts > 50 and total_restores > 50, (
        f"fuzz exercised only {total_preempts} preemptions / "
        f"{total_restores} restores — not stressing the swap path")


def test_schedule_count_floor():
    """The acceptance criterion's 500+ generated schedules, accounted
    explicitly so a future edit cannot silently shrink the suite."""
    trace_replays = len(REGIMES) * len(CHUNKS) * SEEDS_PER_CONFIG
    adversarial = 4 * len(CHUNKS)
    assert trace_replays + adversarial + N_FUZZ_SCHEDULES >= 500, (
        trace_replays, adversarial, N_FUZZ_SCHEDULES)


# --------------------------------------------------------------------------
# targeted scheduler properties
# --------------------------------------------------------------------------


def test_no_livelock_under_sustained_forced_preemption():
    """Even with an adversary forcing a preemption every step for a long
    prefix of the run, every request still completes once the forcing
    stops — and during the forcing, the engine never corrupts state."""
    eng, ex = make_engine(n_pages=14, max_batch=4, prefill_chunk_tokens=4)
    submitted = {}
    for i in range(5):
        rid = eng.submit([1] * 9, 6)
        submitted[rid] = (9, 6)
    rng = np.random.RandomState(BASE_SEED)
    for _ in range(40):
        eng.step()
        if eng.active and rng.rand() < 0.9:
            eng.preempt(list(eng.active)[rng.randint(len(eng.active))])
        eng.pool.check_invariants()
    out = eng.run()
    assert set(out) == set(submitted)
    for rid, (p, g) in submitted.items():
        assert out[rid] == expected_generation(rid, p, g, ex), rid
    assert eng.preemptions >= 20  # the adversary really ran


def test_oldest_resident_is_never_a_victim():
    """The no-livelock argument rests on the engine's own victim policy
    never preempting the oldest resident; pin it with a spy on every
    preempt call."""
    eng, ex = make_engine(n_pages=8, max_batch=4, prefill_chunk_tokens=4)
    orig = eng.preempt

    def spy(rid):
        assert rid != min(eng.active), (
            "engine victim policy picked the oldest resident")
        orig(rid)

    eng.preempt = spy
    rids = [eng.submit([1] * 8, 8) for _ in range(4)]
    out = eng.run()
    assert set(out) == set(rids)
    assert eng.preemptions > 0, "pool was too large to force preemption"


def test_swap_roundtrip_restores_byte_identical_stamps():
    """Forced preempt mid-decode, then drain: the restored pages must hold
    the exact stamps swapped out (SimExecutor.swap_in re-checks ownership,
    and the post-restore decode re-verifies every cached token)."""
    eng, ex = make_engine(n_pages=20, max_batch=4, prefill_chunk_tokens=4)
    r0 = eng.submit([1] * 10, 8)
    r1 = eng.submit([1] * 6, 8)
    for _ in range(5):
        eng.step()
    assert r0 in eng.active and not eng.active[r0].in_prefill
    eng.preempt(r0)
    assert r0 in eng.swapped and ex.swap_outs == 1
    out = eng.run()
    # the restore really happened, onto whatever pages were free — the
    # stamp oracle re-verified every cached token afterwards, and the
    # output stream is the schedule-independent one
    assert ex.swap_ins == 1
    assert out[r0] == expected_generation(r0, 10, 8, ex)
    assert out[r1] == expected_generation(r1, 6, 8, ex)


def test_mid_prefill_preemption_resumes_at_slab_boundary():
    """Preempting a sequence between prefill slabs must resume it from the
    pages already written, not restart the prompt."""
    eng, ex = make_engine(n_pages=20, max_batch=2, prefill_chunk_tokens=4)
    rid = eng.submit([1] * 16, 4)
    eng.step()  # admit + slab 1
    assert eng.active[rid].prefilled == 4
    eng.preempt(rid)
    assert eng.swapped[rid].n_tokens == 4
    slabs_before = eng.prefill_slabs
    out = eng.run()
    assert out[rid] == expected_generation(rid, 16, 4, ex)
    # 16 tokens / 4-token slabs = 4 slabs total; the first was not redone
    assert eng.prefill_slabs - slabs_before == 3


def test_reserve_mode_forced_preempt_keeps_reservation():
    """Regression: a forced preempt() in reservation mode must carry the
    victim's page entitlement through the swap — the restore re-registers
    it, later admissions still see it, and ``free >= reserved`` holds (the
    bug was a KeyError in _reserved_outstanding after restore)."""
    eng, ex = make_engine(n_pages=14, max_batch=3, reserve_admission=True)
    submitted = {}
    for _ in range(3):
        rid = eng.submit([1] * 8, 6)
        submitted[rid] = (8, 6)
    for _ in range(3):
        eng.step()
    victim = max(eng.active)
    eng.preempt(victim)
    late = eng.submit([1] * 4, 4)  # admission must not crash nor over-admit
    submitted[late] = (4, 4)
    out = eng.run()
    assert set(out) == set(submitted)
    for rid, (p, g) in submitted.items():
        assert out[rid] == expected_generation(rid, p, g, ex), rid
    eng.pool.check_invariants()


def test_sim_oracle_detects_planted_corruption():
    """Meta-test: the stamp oracle must actually catch a corrupted page —
    otherwise every green run above is vacuous."""
    eng, ex = make_engine(n_pages=12, max_batch=2)
    rid = eng.submit([1] * 9, 6)
    eng.step()
    assert rid in eng.active
    page0 = eng.pool.pages(rid)[0]
    ex.pages[page0, 0] = np.int64((999 << 24) | 1)  # plant a foreign stamp
    with pytest.raises(SimCorruption, match="owned by rid 999"):
        eng.run()


def test_utilization_beats_reservation_baseline_on_bursty_mix():
    """JAX's gate on the pinned bursty scenario (``serve.sim``'s shared
    definition): optimistic admission with preemption at least the
    reservation baseline's utilization."""
    from repro_torch.serve.sim import bursty_utilization_comparison

    b = bursty_utilization_comparison()
    assert b["utilization_chunked_preempt"] >= \
        b["utilization_reservation_baseline"], b
    assert b["preemptions"] > 0, b


# --------------------------------------------------------------------------
# mesh mode: per-shard arenas, merge-order fuzzing, allocator lockstep
# --------------------------------------------------------------------------


def make_mesh_engine(n_shards, *, n_pages=12, max_batch=4, merge_seed=0,
                     **kw):
    ex = SimExecutor(n_pages=n_pages, page_size=PAGE, vocab_size=211,
                     n_shards=n_shards, merge_seed=merge_seed)
    eng = ServeEngine(None, None, n_pages=n_pages, page_size=PAGE,
                      max_batch=max_batch, executor=ex, **kw)
    return eng, ex


def test_mesh_engine_auto_pairs_with_sharded_page_pool():
    """An executor advertising ``n_shards`` gets a ShardedPagePool (one
    logical allocator, N lockstep replicas); a plain one keeps PagePool."""
    from repro_torch.serve.kvcache import ShardedPagePool

    eng, _ = make_mesh_engine(4)
    assert eng.tp_shards == 4
    assert isinstance(eng.pool, ShardedPagePool)
    assert eng.plan.tp_shards == 4  # default plan re-certified for the mesh
    eng1, _ = make_engine()
    assert eng1.tp_shards == 1
    assert not isinstance(eng1.pool, ShardedPagePool)


# 2 shard counts x 50 seeds = 100 seeded mesh schedules, each with its own
# merge-order permutation stream (merge_seed = trace seed), alternating
# one-shot and chunked prefill, invariants checked every tick by
# replay_trace (ShardedPagePool.check_invariants covers every replica)
MESH_SHARDS = (2, 4)
MESH_SEEDS_PER_SHARD = 50


@pytest.mark.parametrize("n_shards", MESH_SHARDS)
def test_mesh_merge_order_fuzz(n_shards):
    preempts = merges = 0
    for i in range(MESH_SEEDS_PER_SHARD):
        seed = BASE_SEED + 7000 * n_shards + i
        eng, ex = make_mesh_engine(
            n_shards, n_pages=16, max_batch=6, merge_seed=seed,
            prefill_chunk_tokens=(PAGE if i % 2 else None))
        trace = poisson_burst_trace(
            seed, n_requests=14, prompt_range=(2, 14), gen_range=(2, 10),
            max_request_tokens=eng.tokens_capacity)
        m = replay_trace(eng, trace)
        assert_outputs_exact(eng, ex, m["submitted"],
                             ctx=f"mesh {n_shards} seed {seed}")
        ex.check_shard_lockstep()
        eng.pool.check_invariants()
        preempts += m["preemptions"]
        merges += ex.merges_folded
    assert merges > 0, "merge folds never ran — mesh mode is vacuous"
    assert preempts > 0, (
        f"{MESH_SEEDS_PER_SHARD} mesh schedules never preempted — the "
        "per-shard swap path is not being exercised")


def test_mesh_schedule_count_floor():
    """The acceptance floor: >= 100 seeded mesh schedules per run."""
    assert len(MESH_SHARDS) * MESH_SEEDS_PER_SHARD >= 100


def test_mesh_divergence_is_detected():
    """Meta-test: corrupt ONE shard's arena — the next merged read must
    name the diverging shard, because that is the state in which the real
    carry merge would stop being bit-exact."""
    eng, ex = make_mesh_engine(3, n_pages=10, max_batch=2)
    rid = eng.submit([1] * 6, 6)
    eng.step()
    eng.step()
    assert rid in eng.active
    page0 = eng.pool.pages(rid)[0]
    ex.shards[1][page0, 0] ^= 1
    with pytest.raises(SimCorruption, match="shard divergence"):
        eng.run()


def test_mesh_swap_roundtrip_restores_every_shard():
    """Forced preempt + drain in mesh mode: the swap blob carries EVERY
    shard's arena slice and the restore puts each one back — proven by
    the post-restore merged reads and final whole-arena lockstep."""
    eng, ex = make_mesh_engine(4, n_pages=20, max_batch=4, merge_seed=5,
                               prefill_chunk_tokens=4)
    r0 = eng.submit([1] * 10, 8)
    r1 = eng.submit([1] * 6, 8)
    for _ in range(5):
        eng.step()
    assert r0 in eng.active and not eng.active[r0].in_prefill
    eng.preempt(r0)
    assert ex.swap_outs == 1
    out = eng.run()
    assert ex.swap_ins == 1
    assert out[r0] == expected_generation(r0, 10, 8, ex)
    assert out[r1] == expected_generation(r1, 6, 8, ex)
    ex.check_shard_lockstep()


def test_mesh_partial_restore_is_detected():
    """A blob that lost a shard's slice (or restored into the wrong shard
    count) is corruption, not a silent fallback."""
    ex = SimExecutor(n_pages=6, page_size=PAGE, n_shards=3)
    from repro_torch.serve.sim import _stamp

    for j in range(6):
        ex._write(2 + j // PAGE, j % PAGE, _stamp(1, j))
    blob = ex.swap_out(1, [2, 3])
    assert len(blob["shard_stamps"]) == 3
    blob["shard_stamps"] = blob["shard_stamps"][:2]
    with pytest.raises(SimCorruption, match="shard arenas"):
        ex.swap_in(1, [2, 3], blob)


def test_sharded_page_pool_mirrors_and_detects_drift():
    """ShardedPagePool: every mutation lands on every replica; a replica
    that drifts (lost page, stale length, desynced free list) fails
    ``check_invariants`` naming the shard."""
    from repro_torch.serve.kvcache import ShardedPagePool

    pool = ShardedPagePool(8, PAGE, n_shards=3)
    pool.allocate(1, 6)
    pool.extend(1, 2)
    pool.allocate(2, 3)
    pool.check_invariants()
    assert pool.page_table([1, 2], 4).shape == (2, 4)
    pool.release(2)
    pool.check_invariants()
    pool._replicas[2]._pages[1] = pool._replicas[2]._pages[1][:-1]
    with pytest.raises(AssertionError):
        pool.check_invariants()


# --------------------------------------------------------------------------
# hypothesis state machine (optional: skipped when hypothesis is absent)
# --------------------------------------------------------------------------


def test_hypothesis_state_machine():
    pytest.importorskip("hypothesis", reason="needs hypothesis")
    from hypothesis import settings
    from hypothesis.stateful import (
        RuleBasedStateMachine,
        initialize,
        invariant,
        rule,
        run_state_machine_as_test,
    )
    from hypothesis import strategies as st

    class EngineMachine(RuleBasedStateMachine):
        @initialize(n_pages=st.integers(6, 18), max_batch=st.integers(2, 5),
                    chunk=st.sampled_from([None, 4, 8]))
        def init_engine(self, n_pages, max_batch, chunk):
            self.eng, self.ex = make_engine(
                n_pages=n_pages, max_batch=max_batch,
                prefill_chunk_tokens=chunk)
            self.submitted = {}

        @rule(p=st.integers(1, 24), g=st.integers(1, 8))
        def submit(self, p, g):
            g = min(g, max(self.eng.tokens_capacity - 1, 1))
            p = min(p, max(self.eng.tokens_capacity - g, 1))
            rid = self.eng.submit([1] * p, g)
            self.submitted[rid] = (p, g)

        @rule()
        def step(self):
            self.eng.step()

        @rule(pick=st.integers(0, 10_000))
        def force_preempt(self, pick):
            if self.eng.active:
                rids = sorted(self.eng.active)
                self.eng.preempt(rids[pick % len(rids)])

        @invariant()
        def pool_invariants(self):
            if hasattr(self, "eng"):
                self.eng.pool.check_invariants()
                assert len(self.eng.active) <= self.eng.max_batch

        def teardown(self):
            if not hasattr(self, "eng"):
                return
            for _ in range(5000):
                if not (self.eng.pending or self.eng.active
                        or self.eng.swapped):
                    break
                self.eng.step()
            for rid, (p, g) in self.submitted.items():
                exp = expected_generation(rid, p, g, self.ex)
                assert self.eng.finished.get(rid) == exp

    EngineMachine.TestCase.settings = settings(
        max_examples=40, stateful_step_count=30, deadline=None)
    run_state_machine_as_test(EngineMachine,
                              settings=EngineMachine.TestCase.settings)


# --------------------------------------------------------------------------
# speculative decoding: draft/verify/rollback interleavings
# --------------------------------------------------------------------------


def make_spec_engine(k, *, n_pages=14, max_batch=4, page_size=PAGE,
                     draft_wrong=None, **kw):
    """SpecDecodeEngine over two stamped sim arenas: the TARGET executor is
    always exact (its stream defines correctness); the DRAFT executor's
    ``draft_wrong(rid, idx)`` knob forces rejections at chosen positions."""
    ex = SimExecutor(n_pages=n_pages, page_size=page_size, vocab_size=211)
    dn = n_pages + max_batch * (-(-(k + 1) // page_size))
    dex = SimExecutor(n_pages=dn, page_size=page_size, vocab_size=211,
                      draft_wrong=draft_wrong)
    eng = SpecDecodeEngine(None, None, spec_k=k, draft_executor=dex,
                           draft_n_pages=dn, n_pages=n_pages,
                           page_size=page_size, max_batch=max_batch,
                           executor=ex, **kw)
    return eng, ex, dex


def _wrongness(kind, seed, page_size):
    """Draft wrongness regimes: None (perfect draft), a seeded ~25% rate,
    rejections exactly at page boundaries (rollbacks that cross page
    edges), and total wrongness (every round rejects everything)."""
    if kind is None:
        return None
    if kind == "always":
        return lambda rid, idx: True
    if kind == "page_boundary":
        return lambda rid, idx: idx % page_size == 0
    if kind == "rate":
        return lambda rid, idx: (rid * 7919 + idx * 104_729 + seed) % 8 < 2
    raise ValueError(kind)


def _no_stale_spec_stamps(eng, ex):
    """The page-exact rollback contract, observed directly: no active
    row's owned pages may hold THIS row's stamp at an index at or past its
    cached length — a skipped or mis-ranged scrub leaves exactly
    ``_stamp(rid, idx)`` behind in the rejected slots.  (Slots past
    seq_len may legally hold a PRIOR owner's stale bytes from page reuse;
    only a same-rid future-index stamp is evidence of a missing scrub.)"""
    for rid, seq in eng.active.items():
        if seq.in_prefill:
            continue
        sl = eng.pool.seq_len(rid)
        pages = eng.pool.pages(rid)
        for idx in range(sl, len(pages) * eng.page_size):
            got = ex.pages[pages[idx // eng.page_size],
                           idx % eng.page_size]
            assert got != _stamp(rid, idx), (
                f"rid {rid}: rejected slot idx {idx} still stamped after "
                f"rollback (seq_len {sl}) — the scrub did not run")


SPEC_KS = (1, 2, 3)
SPEC_WRONG = (None, "rate", "page_boundary", "always")
SPEC_SEEDS_PER_CONFIG = 9  # 3 ks x 4 regimes x 9 seeds = 108 schedules


@pytest.mark.parametrize("k", SPEC_KS)
@pytest.mark.parametrize("wrong", SPEC_WRONG)
def test_spec_fuzz_bitwise_identical_to_plain_greedy(k, wrong):
    """Seeded bursty traces through the speculative engine, across k and
    draft-wrongness regimes, alternating one-shot and chunked prefill:
    every finished stream must equal BOTH the schedule-independent
    expected stream and a plain (non-speculative) greedy engine's output
    on the same trace, bit for bit — no matter how many tokens each round
    accepted or rolled back.  Both page pools drain clean."""
    rounds = rollbacks = 0
    for i in range(SPEC_SEEDS_PER_CONFIG):
        seed = BASE_SEED + 10_000 * k + 100 * SPEC_WRONG.index(wrong) + i
        chunk = (None, PAGE)[i % 2]
        ctx = f"k={k} wrong={wrong} seed={seed}"
        eng, ex, dex = make_spec_engine(
            k, draft_wrong=_wrongness(wrong, seed, PAGE),
            prefill_chunk_tokens=chunk)
        trace = poisson_burst_trace(
            seed, n_requests=10, prompt_range=(2, 16), gen_range=(2, 10),
            max_request_tokens=eng.tokens_capacity)
        m = replay_trace(eng, trace)
        # the plain-greedy reference on the SAME trace
        peng, _ = make_engine(n_pages=14, max_batch=4,
                              prefill_chunk_tokens=chunk)
        replay_trace(peng, trace)
        for rid, req in m["submitted"].items():
            exp = expected_generation(rid, req.prompt_len, req.max_new, ex)
            assert eng.finished.get(rid) == exp, (
                f"{ctx}: rid {rid} spec stream {eng.finished.get(rid)} != "
                f"expected {exp}")
            assert eng.finished[rid] == peng.finished[rid], (
                f"{ctx}: rid {rid} spec vs plain streams diverge")
        eng.pool.check_invariants()
        eng.draft_pool.check_invariants()
        assert eng.pool.free_pages == eng.pool.n_pages - 1, ctx
        assert eng.draft_pool.free_pages == eng.draft_pool.n_pages - 1, (
            f"{ctx}: draft pool leaked pages")
        rounds += eng.spec_rounds
        rollbacks += ex.rollbacks
        if wrong is None:
            assert eng.acceptance_rate() == 1.0, (
                f"{ctx}: a perfect draft must be fully accepted, got "
                f"{eng.acceptance_rate()}")
        if wrong == "always" and eng.spec_rounds:
            assert eng.spec_accepted == 0, ctx
    assert rounds > 0, f"k={k} wrong={wrong}: no spec rounds ran"
    if wrong in ("always", "page_boundary"):
        assert rollbacks > 0, (
            f"k={k} wrong={wrong}: forced rejections never rolled back")


def test_spec_schedule_count_floor():
    """The satellite's 100+ seeded spec schedules, accounted explicitly."""
    assert len(SPEC_KS) * len(SPEC_WRONG) * SPEC_SEEDS_PER_CONFIG >= 100


def test_spec_k4_wide_page():
    """k above the smallest bucket width needs a wider page (plan_verify
    refuses a bucket that cannot hold k+1 slots); page 8 certifies k=4."""
    eng, ex, _ = make_spec_engine(4, n_pages=10, page_size=8,
                                  draft_wrong=lambda rid, idx: idx % 3 == 0)
    trace = poisson_burst_trace(
        BASE_SEED, n_requests=8, prompt_range=(2, 20), gen_range=(2, 12),
        max_request_tokens=eng.tokens_capacity)
    m = replay_trace(eng, trace)
    assert_outputs_exact(eng, ex, m["submitted"], ctx="k=4 page=8")
    assert eng.spec_rounds > 0 and ex.rollbacks > 0


def test_spec_rollback_during_preemption_and_swap():
    """Forced preemption interleaved with spec rounds: the draft lane is
    dropped (recompute, not swapped), the target swaps as usual, and after
    restore + lazy re-prime every stream is still the exact one — rollback
    state never leaks across a preempt/swap/restore cycle."""
    eng, ex, dex = make_spec_engine(
        3, n_pages=16, draft_wrong=lambda rid, idx: idx % 2 == 0)
    submitted = {}
    for _ in range(5):
        rid = eng.submit([1] * 8, 8)
        submitted[rid] = (8, 8)
    rng = np.random.RandomState(BASE_SEED + 5)
    for _ in range(30):
        eng.step()
        if eng.active and rng.rand() < 0.5:
            rids = sorted(eng.active)
            victim = rids[rng.randint(len(rids))]
            eng.preempt(victim)
            assert not eng.draft_pool.owns(victim), (
                "preempt left the victim's draft lane resident")
        eng.pool.check_invariants()
        eng.draft_pool.check_invariants()
        _no_stale_spec_stamps(eng, ex)
    out = eng.run()
    for rid, (p, g) in submitted.items():
        assert out[rid] == expected_generation(rid, p, g, ex), rid
    assert eng.preemptions > 0 and eng.restores > 0
    assert eng.spec_rounds > 0 and ex.rollbacks > 0
    # dropped draft lanes really re-primed after restore
    assert eng.draft_primes > len(submitted)


def test_spec_rollback_scrubs_rejected_slots():
    """After a rejecting round, the target arena's rejected slots read
    EMPTY (page-exact scrub), observed after every step of a full run."""
    eng, ex, _ = make_spec_engine(3, draft_wrong=lambda rid, idx: True)
    rid = eng.submit([1] * 6, 5)
    saw_rejection = False
    for _ in range(40):
        eng.step()
        _no_stale_spec_stamps(eng, ex)
        if rid in eng.active and not eng.active[rid].in_prefill \
                and ex.rollbacks:
            saw_rejection = True
            sl = eng.pool.seq_len(rid)
            pages = eng.pool.pages(rid)
            for idx in range(sl, len(pages) * PAGE):
                assert ex.pages[pages[idx // PAGE], idx % PAGE] == _EMPTY, (
                    f"slot for idx {idx} not scrubbed (seq_len {sl})")
        if not (eng.pending or eng.active or eng.swapped):
            break
    # prefill emits token 1; budgets 4/3/2 run spec rounds, budget 1 rides
    # the plain lane — three all-reject rounds, three target rollbacks
    assert saw_rejection and ex.rollbacks == 3
    assert eng.finished[rid] == expected_generation(rid, 6, 5, ex)


def test_spec_scrub_meta_detects_skipped_rollback():
    """Meta-test: silence the target executor's rollback scrub (the pool
    bookkeeping still truncates) — the stale-stamp probe must trip, or
    every green scrub assertion above is vacuous."""
    eng, ex, _ = make_spec_engine(3, draft_wrong=lambda rid, idx: True)
    ex.rollback = lambda *a, **kw: None  # the planted bug
    eng.submit([1] * 6, 5)
    tripped = False
    for _ in range(40):
        eng.step()
        try:
            _no_stale_spec_stamps(eng, ex)
        except AssertionError:
            tripped = True
            break
        if not (eng.pending or eng.active or eng.swapped):
            break
    assert tripped, "stale-stamp probe missed a skipped rollback scrub"


def test_spec_budget_one_falls_back_to_plain_decode():
    """A row with a single token left cannot profit from speculation (a
    round always commits >= 1 and would waste k+1 page claims): it must
    ride the plain lane, and the spec/plain split still drains exact."""
    eng, ex, _ = make_spec_engine(2)
    r0 = eng.submit([1] * 4, 1)   # budget 1: plain lane only
    r1 = eng.submit([1] * 4, 6)   # budget 6: spec lane
    out = eng.run()
    assert out[r0] == expected_generation(r0, 4, 1, ex)
    assert out[r1] == expected_generation(r1, 4, 6, ex)
    assert eng.spec_rounds > 0


def test_spec_events_and_counters_are_consistent():
    """spec_round events reconcile with the engine counters and the
    emitted token totals (the same events record_spec_events consumes)."""
    eng, ex, _ = make_spec_engine(
        2, draft_wrong=lambda rid, idx: idx % 3 == 0)
    trace = poisson_burst_trace(
        BASE_SEED + 77, n_requests=8, prompt_range=(2, 12),
        gen_range=(2, 8), max_request_tokens=eng.tokens_capacity)
    m = replay_trace(eng, trace)
    ev = [e for e in eng.events if e.get("event") == "spec_round"]
    assert len(ev) == eng.spec_rounds > 0
    assert sum(e["proposed"] for e in ev) == eng.spec_proposed
    assert sum(e["accepted"] for e in ev) == eng.spec_accepted
    assert sum(e["emitted"] for e in ev) == eng.spec_emitted
    assert sum(e["rollback_depth"] for e in ev) == eng.spec_rollback_tokens
    spec_tokens = sum(e["emitted"] for e in ev)
    total = sum(len(eng.finished[r]) for r in m["submitted"])
    # every stream's first token comes from the prefill final (not counted
    # in decoded_tokens); the rest are spec-round or plain-lane decodes
    assert spec_tokens <= eng.decoded_tokens
    assert total == eng.decoded_tokens + len(m["submitted"])
    for e in ev:
        assert 0 <= e["accepted"] <= e["proposed"] == 2
        assert 1 <= e["emitted"] <= e["accepted"] + 1


# --------------------------------------------------------------------------
# the port's engine against JAX's, on the same traces
# --------------------------------------------------------------------------


def _jax_sim():
    from repro.serve.scheduler import ServeEngine as JEngine
    from repro.serve.sim import SimExecutor as JSim
    from repro.serve.spec import SpecDecodeEngine as JSpec

    return JEngine, JSim, JSpec


def _drive(eng, trace):
    """Replay ``trace`` as ``replay_trace`` does, keeping every step's
    record."""
    trace = sorted(trace, key=lambda r: r.t_arrive)
    recs, i, clock = [], 0, 0
    while i < len(trace) or eng.pending or eng.active or eng.swapped:
        while i < len(trace) and trace[i].t_arrive <= clock:
            eng.submit([1] * trace[i].prompt_len, trace[i].max_new)
            i += 1
        recs.append(eng.step())
        clock += 1
        assert clock < 20_000
    return recs


def _summary(eng):
    return dict(finished=eng.finished, steps=eng.steps,
                decoded=eng.decoded_tokens, slabs=eng.prefill_slabs,
                preemptions=eng.preemptions, restores=eng.restores,
                max_concurrent=eng.max_concurrent,
                utilization=eng.utilization(), events=list(eng.events))


@pytest.mark.parametrize("reserve", [False, True])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("regime", range(len(REGIMES)))
def test_engine_steps_equal_jax_engine(regime, chunk, reserve):
    """The same bursty trace through both packages' engines on their
    simulations, optimistic and by reservation: every step's record
    (admitted, restored, prefilled, finished, counts, free pages), the
    streams, counters, utilization and events are equal."""
    JEngine, JSim, _ = _jax_sim()
    n_pages, mb, nreq, pr, gr = REGIMES[regime]
    seed = BASE_SEED + 1000 * regime + 3
    kw = dict(n_pages=n_pages, page_size=PAGE, max_batch=mb,
              prefill_chunk_tokens=chunk, reserve_admission=reserve)
    eng = ServeEngine(None, None, executor=SimExecutor(
        n_pages=n_pages, page_size=PAGE, vocab_size=211), **kw)
    jeng = JEngine(None, None, executor=JSim(
        n_pages=n_pages, page_size=PAGE, vocab_size=211), **kw)
    trace = poisson_burst_trace(seed, n_requests=nreq, prompt_range=pr,
                                gen_range=gr,
                                max_request_tokens=eng.tokens_capacity)
    assert _drive(eng, trace) == _drive(jeng, trace)
    assert _summary(eng) == _summary(jeng)
    if reserve:
        assert eng.preemptions == 0


@pytest.mark.parametrize("wrong", SPEC_WRONG)
def test_spec_engine_steps_equal_jax_engine(wrong):
    """The speculative engine on both packages' simulations, the same
    draft wrongness: step records, streams, spec counters and
    ``spec_round`` events equal."""
    JEngine, JSim, JSpec = _jax_sim()
    k, seed = 2, BASE_SEED + 17
    dn = 14 + 4 * (-(-(k + 1) // PAGE))

    def build(Spec, Sim):
        ex = Sim(n_pages=14, page_size=PAGE, vocab_size=211)
        dex = Sim(n_pages=dn, page_size=PAGE, vocab_size=211,
                  draft_wrong=_wrongness(wrong, seed, PAGE))
        return Spec(None, None, spec_k=k, draft_executor=dex,
                    draft_n_pages=dn, n_pages=14, page_size=PAGE,
                    max_batch=4, executor=ex, prefill_chunk_tokens=PAGE)

    eng, jeng = build(SpecDecodeEngine, SimExecutor), build(JSpec, JSim)
    trace = poisson_burst_trace(seed, n_requests=10, prompt_range=(2, 16),
                                gen_range=(2, 10),
                                max_request_tokens=eng.tokens_capacity)
    assert _drive(eng, trace) == _drive(jeng, trace)
    assert _summary(eng) == _summary(jeng)
    for name in ("spec_rounds", "spec_proposed", "spec_accepted",
                 "spec_emitted", "spec_rollback_tokens", "draft_primes",
                 "fallback_rows"):
        assert getattr(eng, name) == getattr(jeng, name), name


def test_bursty_utilization_comparison_equals_jax():
    """``bursty_utilization_comparison`` gives JAX's numbers exactly."""
    from repro.serve.sim import bursty_utilization_comparison as jax_cmp
    from repro_torch.serve.sim import bursty_utilization_comparison

    assert bursty_utilization_comparison() == jax_cmp()


def test_eos_ends_a_sequence_as_jax_engine():
    """``eos_id``: a sequence ends at the first EOS it emits, on both
    engines alike (the simulation's stream is a pure function of the
    position, so an EOS id taken from a stream cuts it there)."""
    JEngine, JSim, _ = _jax_sim()
    probe = SimExecutor(n_pages=14, page_size=PAGE, vocab_size=211)
    eos = expected_generation(1, 9, 8, probe)[3]
    outs = []
    for Engine, Sim in ((ServeEngine, SimExecutor), (JEngine, JSim)):
        eng = Engine(None, None, n_pages=14, page_size=PAGE, max_batch=4,
                     eos_id=eos, executor=Sim(n_pages=14, page_size=PAGE,
                                              vocab_size=211))
        for p in (5, 9, 7):
            eng.submit([1] * p, 8)
        outs.append((eng.run(), eng.decoded_tokens, eng.steps))
    assert outs[0] == outs[1]
    got = outs[0][0][1]
    assert got[-1] == eos and len(got) == 4
    eng.pool.check_invariants()
