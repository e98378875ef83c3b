"""Speculative decoding with page-exact rollback.

Counterpart of ``repro.serve.spec`` on one device.  A ``SpecDecodeEngine``
is a ``ServeEngine`` whose decode phase runs a smaller draft model ahead
of the target: each round the draft proposes ``k`` tokens (k small decode
steps), the target scores the ``k + 1`` candidate positions in one batched
verify pass (``models.lm.paged_verify``, bitwise ``k + 1`` sequential
decode steps), and the longest agreeing prefix commits.  The tokens
emitted are always the target's own greedy argmaxes, so the stream is
bitwise plain greedy decode whatever the draft proposes; the draft only
sets how many tokens a round commits (1 .. k + 1).

Rejection is an arena truncation, never a requantization:
``PagePool.rollback_seq_len`` frees the tail pages (LIFO, so a re-extend
claims what a pool that never speculated would) and
``kvcache.truncate_pages`` zeroes them and the boundary page's rejected
slots, so on fresh pages the arena is bitwise one that never appended.
Both lanes roll back: the target past the accepted length, the draft to
the same point.

The draft has its own paged arena, ``PagePool``, ``AttnPlan`` and
executor (on the card, its own graphs), driven through the same paged
protocol.  Its state is recompute: on preemption it is dropped, not
swapped, and a row re-primes with one one-shot ``final=False`` prefill of
its committed tokens when it next enters a round.  Rows that cannot
reserve ``k + 1`` target pages (or a draft lane) fall back to plain decode
for the round, so the base engine's no-livelock argument holds.

``plan_verify`` re-certifies every bucket for the (bucket, k) verify
signatures; ``warmup`` makes the draft's prefill and decode, every
bucket's verify and the rollback scrub, so steady-state speculative
serving makes no signature.  The counters (``spec_rounds``,
``spec_proposed``, ``spec_accepted``, ``spec_emitted``,
``spec_rollback_tokens``) and one ``spec_round`` event a row a round
(``engine.events``) are JAX's; with a registry they flow through
``obs.metrics.record_spec_events`` (``repro_serve_spec_*``), and with a
tracer every round emits ``draft`` and ``verify`` spans and a rejection a
``rollback`` span under its request.  ``eos_id`` cuts a round's emitted
tokens at the EOS, and under ``reserve_admission`` a round borrows free
pages only, returned by the rollback within the step.  The simulation's
``SimExecutor`` drives both lanes without a model.
"""

from __future__ import annotations

from repro_torch.models.api import DecodeRequest, PrefillRequest, VerifyRequest
from repro_torch.serve.kvcache import PagedKVConfig, PagePool
from repro_torch.serve.plan import plan_attention, plan_verify
from repro_torch.serve.scheduler import ModelExecutor, ServeEngine, _Seq

__all__ = ["SpecDecodeEngine"]


class SpecDecodeEngine(ServeEngine):
    """Continuous-batching engine with a draft-model speculative lane."""

    def __init__(self, model, params, *, spec_k: int = 4, draft_model=None,
                 draft_params=None, draft_executor=None,
                 draft_n_pages: int | None = None, **kw):
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        warm = kw.pop("warm_start", False)
        super().__init__(model, params, warm_start=False, **kw)
        if self.tp_shards > 1:
            raise NotImplementedError(
                "speculative decoding is single-device (the draft lane and "
                "the rollback scrub are not partitioned), as JAX's")
        self.spec_k = spec_k
        ps = self.page_size
        capacity = self.tokens_capacity
        if draft_n_pages is None:
            # room for every batch row's proposals in flight, so the draft
            # lane runs short of pages strictly less often than the target
            draft_n_pages = self.n_pages \
                + self.max_batch * (-(-(spec_k + 1) // ps))
        if (draft_n_pages - 1) * ps < capacity + spec_k:
            raise ValueError(
                f"draft arena of {draft_n_pages} pages cannot hold a "
                f"max-length sequence plus {spec_k} proposals")
        if draft_executor is None:
            if draft_model is None:
                raise ValueError(
                    "SpecDecodeEngine needs draft_model and draft_params, "
                    "or a draft_executor")
            dpc = PagedKVConfig.for_model(
                draft_model.cfg, n_pages=draft_n_pages, page_size=ps,
                kv_fmt=self.kv_fmt)
            draft_executor = ModelExecutor(
                draft_model, draft_params, dpc, kv_fmt=self.kv_fmt,
                max_batch=self.max_batch, device=self.executor.device,
                graphs=self.executor.graphs, oracle=self.oracle)
        self.draft_model = draft_model
        self.draft_executor = draft_executor
        self.draft_pool = PagePool(draft_n_pages, ps)
        # the draft lane prefills one-shot: its primes are single calls,
        # and its numerics only steer which proposals are made
        self.draft_plan = plan_attention((draft_n_pages - 1) * ps, ps)
        self.verify_plan = plan_verify(self.plan, k=spec_k)
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.spec_rollback_tokens = 0
        self.draft_primes = 0
        self.fallback_rows = 0
        if self.metrics is not None:
            self._m_spec_acc = self.metrics.gauge(
                "repro_serve_spec_acceptance_rate",
                "cumulative accepted/proposed draft tokens")
        if warm:
            self.warmup()

    def acceptance_rate(self) -> float:
        """Accepted over proposed draft tokens, cumulative."""
        return self.spec_accepted / max(self.spec_proposed, 1)

    # ------------------------------ warmup ---------------------------------
    def warmup(self) -> dict | None:
        """The base warmup and the speculative lane's signatures: every
        bucket's (bucket, k) verify and the rollback scrub on the target,
        the draft's per-bucket decode, one-shot ``final=False`` prefill and
        rollback (none for executors without a compile cache)."""
        out = super().warmup()
        wv = getattr(self.executor, "warmup_verify", None)
        if wv is not None:
            wv(self.plan, self.spec_k)
        if getattr(self.draft_executor, "warmup", None) is not None:
            self.draft_executor.warmup(self.draft_plan, None,
                                       prefill_finals=(False,))
            self.draft_executor.warmup_verify(self.draft_plan, self.spec_k,
                                              include_verify=False)
        return out

    # ------------------------------ lifecycle ------------------------------
    def preempt(self, rid: int) -> None:
        # the draft's state is recompute: drop it rather than swap it; the
        # row re-primes after its restore
        if self.draft_pool.owns(rid):
            self.draft_pool.release(rid)
        super().preempt(rid)

    def _maybe_finish(self, seq: _Seq) -> bool:
        done = super()._maybe_finish(seq)
        if done and self.draft_pool.owns(seq.rid):
            self.draft_pool.release(seq.rid)
        return done

    # ------------------------------ draft lane -----------------------------
    def _drop_draft_younger_than(self, rid: int) -> bool:
        """Free draft pages by dropping the youngest draft-resident row
        strictly younger than ``rid`` (older rows are already in this
        round's batch and keep their draft state)."""
        victims = [r for r in self.active
                   if r > rid and self.draft_pool.owns(r)]
        if not victims:
            return False
        self.draft_pool.release(max(victims))
        return True

    def _prime_draft(self, seq: _Seq) -> None:
        """One-shot ``final=False`` prefill of the row's committed tokens
        (all but the last, the first verify input) into the draft arena."""
        rid, n = seq.rid, seq.pos
        pages = self.draft_pool.allocate(rid, n)
        bucket_i, bucket = self.draft_plan.bucket_for(n)
        self.draft_executor.prefill(PrefillRequest(
            rid=rid, tokens=tuple(seq.tokens[:n]), hist_pages=(),
            slab_pages=tuple(pages), t0=0, acc=bucket.acc, final=False,
            bucket_pages=bucket.max_pages(self.page_size),
            slab_width=bucket.max_ctx,
            call=self.draft_plan.kernel_call(bucket_i, kv_fmt=self.kv_fmt)))
        self.draft_primes += 1

    def _draft_ready(self, seq: _Seq) -> int | None:
        """Make the draft lane able to carry ``seq`` through this round and
        claim its pages up front (extended to ``pos + k`` now, so a later
        row's prime cannot take the pages this row's steps need).  A lag of
        one (the last round accepted everything) is caught up by one more
        draft step; a larger lag (plain-decode rounds) re-primes.  Returns
        the draft's cached length at the round's start, or None: the row
        falls back to plain decode this round."""
        rid, k = seq.rid, self.spec_k
        dp = self.draft_pool
        if dp.owns(rid) and dp.seq_len(rid) < seq.pos - 1:
            dp.release(rid)
        held = len(dp.pages(rid)) if dp.owns(rid) else 0
        want = dp.pages_for(seq.pos + k)
        while want - held > dp.free_pages:
            if not self._drop_draft_younger_than(rid):
                return None
        if not dp.owns(rid):
            self._prime_draft(seq)
        d0 = dp.seq_len(rid)
        dp.extend(rid, seq.pos + k - d0)
        return d0

    def _reserve_spec(self, seq: _Seq) -> int | None:
        """Claim a row's round: ``k + 1`` target pages (the verify slab) and
        a ready draft lane.  Under reservation the overshoot borrows free
        pages only (never another row's entitlement) and the rollback
        returns them within the step.  Returns the draft lane's start, or
        None."""
        rid = seq.rid
        if self.reserve_admission:
            if not self.pool.can_extend(rid, 1 + self.spec_k):
                return None
        elif not self._ensure_pages(
                rid, self.pool.seq_len(rid) + 1 + self.spec_k):
            return None
        d0 = self._draft_ready(seq)
        if d0 is None:
            return None
        self.pool.extend(rid, 1 + self.spec_k)
        return d0

    # ------------------------------ rollback -------------------------------
    def _rollback(self, pool, executor, rid: int, keep: int,
                  old: int) -> int:
        """Truncate one lane to ``keep`` cached tokens: the pool's tail
        pages freed and the executor's scrub.  Returns the depth."""
        if keep >= old:
            return 0
        pages_old = pool.pages(rid)
        pool.rollback_seq_len(rid, keep)
        fn = getattr(executor, "rollback", None)
        if fn is not None:
            fn(rid, pages_old, keep, old)
        return old - keep

    # ------------------------------ decode ---------------------------------
    def _decode_batch(self) -> list[int]:
        """One spec round for every eligible running row and one plain
        decode for the rest (the base engine's restore/admit and prefill
        slab run around it)."""
        spec: list[tuple[_Seq, int]] = []
        plain: list[_Seq] = []
        for rid in sorted(self.active):
            seq = self.active.get(rid)
            if seq is None or seq.in_prefill:
                continue
            budget = seq.max_new - len(seq.generated)
            if budget >= 2:
                d0 = self._reserve_spec(seq)
                if d0 is not None:
                    spec.append((seq, d0))
                    continue
            if self.reserve_admission:
                if not self.pool.can_extend(rid):
                    continue
            elif not self._ensure_pages(rid, self.pool.seq_len(rid) + 1):
                continue
            if self.active.get(rid) is None:
                continue
            self.pool.extend(rid)
            plain.append(seq)
            if budget >= 2:
                self.fallback_rows += 1
        finished: list[int] = []
        if spec:
            finished += self._spec_round(spec)
        if plain:
            finished += self._plain_decode(plain)
        if spec or plain:
            self._decode_steps += 1
            if self.monitor_cadence \
                    and self._decode_steps % self.monitor_cadence == 0:
                self._monitor()
        return finished

    def _propose(self, batch: list[tuple[_Seq, int]]
                 ) -> tuple[dict[int, list[int]], int]:
        """Draft phase: batched draft steps until every row holds ``k``
        proposals.  The draft pool already covers ``pos + k``; ``d0`` is
        each row's first write position.  A row one token behind runs a
        catch-up step first, whose output is the known committed token."""
        k = self.spec_k
        props: dict[int, list[int]] = {s.rid: [] for s, _ in batch}
        cur: dict[int, int] = {s.rid: d0 for s, d0 in batch}
        steps = 0
        while True:
            live = [s for s, _ in batch if len(props[s.rid]) < k]
            if not live:
                return props, steps
            rows = []
            for s in live:
                q = cur[s.rid]
                cur[s.rid] = q + 1
                inp = (s.tokens[q] if q < len(s.tokens)
                       else props[s.rid][q - len(s.tokens)])
                rows.append((s, q, inp))
            # bucket by the round's pre-extended draft extent (pos + k): the
            # table covers every page claimed for the round, and all k steps
            # share one decode signature
            _, bucket = self.draft_plan.bucket_for(
                max(self.draft_pool.seq_len(s.rid) for s, _, _ in rows))
            width = bucket.max_pages(self.page_size)
            pt = self.draft_pool.page_table([s.rid for s, _, _ in rows],
                                            width)
            toks = self.draft_executor.decode(DecodeRequest(
                rids=tuple(s.rid for s, _, _ in rows),
                last_tokens=tuple(i for _, _, i in rows),
                page_table=tuple(tuple(r) for r in pt.tolist()),
                positions=tuple(q for _, q, _ in rows),
                seq_lens=tuple(q + 1 for _, q, _ in rows),
                acc=bucket.acc))
            steps += 1
            for (s, q, _), t in zip(rows, toks):
                if q >= s.pos:  # predicts index q + 1, past the committed end
                    props[s.rid].append(int(t))

    def _spec_round(self, batch: list[tuple[_Seq, int]]) -> list[int]:
        """Draft k, verify k + 1, accept the agreeing prefix, roll back."""
        k = self.spec_k
        rows = [s for s, _ in batch]
        rids = [s.rid for s in rows]
        draft_span = None
        if self.tracer is not None:
            draft_span = self.tracer.start("draft", rids=rids, k=k)
        props, steps = self._propose(batch)
        if draft_span is not None:
            self.tracer.end(draft_span, steps=steps)
        # the target pool already covers pos + k + 1 a row (_reserve_spec)
        _, bucket = self.verify_plan.bucket_for(
            max(self.pool.seq_len(r) for r in rids))
        width = bucket.max_pages(self.page_size)
        pt = self.pool.page_table(rids, width)
        verify_span = None
        if self.tracer is not None:
            verify_span = self.tracer.start("verify", rids=rids, k=k)
        outs = self.executor.verify(VerifyRequest(
            rids=tuple(rids),
            tokens=tuple((s.tokens[-1], *props[s.rid]) for s in rows),
            page_table=tuple(tuple(r) for r in pt.tolist()),
            positions=tuple(s.pos for s in rows),
            seq_lens=tuple(s.pos + 1 for s in rows),
            acc=bucket.acc))
        if verify_span is not None:
            self.tracer.end(verify_span)
        if self.metrics is not None:
            self._m_decode.inc()
        finished: list[int] = []
        events = []
        for seq, u in zip(rows, outs):
            rid = seq.rid
            p = props[rid]
            m = 0
            while m < k and p[m] == u[m]:
                m += 1
            # u[:m] are the m accepted proposals; u[m] is the target's own
            # next token after them, so every round commits at least one
            emit = u[:m + 1][:seq.max_new - len(seq.generated)]
            if self.eos_id is not None and self.eos_id in emit:
                emit = emit[:emit.index(self.eos_id) + 1]
            n_e = len(emit)
            old_t = self.pool.seq_len(rid)           # pos + k + 1
            keep_t = seq.pos + n_e
            rb = self._rollback(self.pool, self.executor, rid, keep_t, old_t)
            old_d = self.draft_pool.seq_len(rid)     # pos + k
            self._rollback(self.draft_pool, self.draft_executor, rid,
                           min(old_d, keep_t), old_d)
            if rb and self.tracer is not None:
                h = self._spans.get(rid)
                self.tracer.end(self.tracer.start(
                    "rollback", parent=h["root"] if h else None,
                    trace_id=rid, depth=rb, ctx=keep_t))
            for t in emit:
                seq.tokens.append(int(t))
                seq.generated.append(int(t))
                self.decoded_tokens += 1
                self._obs_token(rid)
            self.spec_rounds += 1
            self.spec_proposed += k
            self.spec_accepted += m
            self.spec_emitted += n_e
            self.spec_rollback_tokens += rb
            events.append({
                "step": self._decode_steps, "event": "spec_round",
                "role": "serve", "rid": rid, "k": k, "proposed": k,
                "accepted": m, "emitted": n_e, "rollback_depth": rb,
                "ctx": keep_t,
            })
            if self._maybe_finish(seq):
                finished.append(rid)
        self.events.extend(events)
        if self.metrics is not None:
            from repro_torch.obs.metrics import record_spec_events

            record_spec_events(self.metrics, events)
            self._m_spec_acc.set(self.acceptance_rate())
        return finished

    def _plain_decode(self, batch: list[_Seq]) -> list[int]:
        """The base engine's batched decode for the rows out of the spec
        round (budget spent, short of pages, no draft lane); their pool
        pages were extended by the caller."""
        _, bucket = self.plan.bucket_for(
            max(self.pool.seq_len(s.rid) for s in batch))
        width = bucket.max_pages(self.page_size)
        pt = self.pool.page_table([s.rid for s in batch], width)
        step_span = None
        if self.tracer is not None:
            step_span = self.tracer.start(
                "decode_step", rids=[s.rid for s in batch])
        next_toks = self.executor.decode(DecodeRequest(
            rids=tuple(s.rid for s in batch),
            last_tokens=tuple(s.tokens[-1] for s in batch),
            page_table=tuple(tuple(r) for r in pt.tolist()),
            positions=tuple(s.pos for s in batch),
            seq_lens=tuple(s.pos + 1 for s in batch), acc=bucket.acc))
        if step_span is not None:
            self.tracer.end(step_span)
        if self.metrics is not None:
            self._m_decode.inc()
        finished = []
        for seq, tok in zip(batch, next_toks):
            seq.tokens.append(int(tok))
            seq.generated.append(int(tok))
            self.decoded_tokens += 1
            self._obs_token(seq.rid)
            if self._maybe_finish(seq):
                finished.append(seq.rid)
        return finished
