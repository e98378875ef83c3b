"""Port vs JAX package: observability (``repro_torch.obs``) and the serve
engine's instrumentation.

* The clock, the sinks, the tracer and the metrics registry against
  JAX's on the same calls under a ``VirtualClock``: span dicts, span
  forests, latencies and percentiles, snapshots, Prometheus text and JSONL
  bytes, equal.
* The certification memo's counts against JAX's on the same plan calls,
  and ``plan_attention(v_hint=)``'s buckets.
* Both packages' engines on their simulations (``serve.sim``) with a
  tracer on the virtual clock and a registry: the span forest and the
  metric snapshot equal, optimistic, by reservation and speculative.
* Both packages' engines on the smoke qwen2-1.5b (predicted plan, JAX in a
  child process with excess precision off, ROADMAP F2) over the same
  trace: spans, snapshot and Prometheus text equal; reservation
  admission's step records and streams, and ``eos_id``'s, against JAX's;
  the port's obs-on run bitwise its obs-off run (streams and arena).
* ``InGraphTelemetry(registry=)`` and the training launcher's
  ``--obs-metrics``/``--obs-prometheus`` export.

Tolerance: none; every comparison is exact (the schedule and the host
records do not depend on the logits, except through the streams, which
are held equal, as ``tests/test_torch_serve.py`` finds them).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.obs as J
import repro_torch.obs as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE = 4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads beside the other pytest workers (ROADMAP P4)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the building blocks, call for call
# --------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [None, 1, 3])
def test_ring_buffer_matches_jax(capacity):
    ours, theirs = T.RingBuffer(capacity), J.RingBuffer(capacity)
    for buf in (ours, theirs):
        for i in range(7):
            buf.append({"i": i})
        buf.extend([{"i": 7}, {"i": 8}])
    assert list(ours) == list(theirs) and len(ours) == len(theirs)
    assert ours.dropped == theirs.dropped and repr(ours) == repr(theirs)
    assert ours[0] == theirs[0] and ours[-1] == theirs[-1]
    assert ours[1:3] == theirs[1:3] and bool(ours) == bool(theirs)
    ours.clear()
    assert len(ours) == 0 and ours.dropped == 0 and not ours


def test_ring_buffer_refuses_and_sinks_match_jax(tmp_path):
    for cls in (T.RingBuffer, J.RingBuffer):
        with pytest.raises(ValueError):
            cls(0)
    recs = [{"a": 1, "b": [1, 2]}, {"c": "x"}]
    for mod, name in ((T, "t"), (J, "j")):
        mod.jsonl_append(str(tmp_path / name / "deep" / "log.jsonl"), recs)
        mod.JsonlSink(str(tmp_path / name / "sink.jsonl")).emit(*recs)
        mod.JsonlSink(None).emit(*recs)
    for f in ("deep/log.jsonl", "sink.jsonl"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


def _script_spans(mod):
    """The same tracer calls on either package, on a virtual clock."""
    clock = mod.VirtualClock(2.0)
    tr = mod.Tracer(clock=clock, capacity=64)
    roots = []
    for rid in range(3):
        root = tr.start("request", trace_id=rid, prompt_len=4 + rid,
                        max_new=3)
        q = tr.start("queued", parent=root)
        clock.advance(rid + 1)
        tr.end(q)
        roots.append(root)
    for step in range(4):
        s = tr.start("decode_step", rids=[0, 1, 2])
        for rid, root in enumerate(roots):
            if step <= rid + 1:
                tr.event(root, "token")
        clock.advance(0.5 * (step + 1))
        tr.end(s, batch=3)
    sw = tr.start("swapped", parent=roots[2], ctx=9)
    clock.set(20.0)
    tr.end(sw)
    for rid, root in enumerate(roots):
        clock.advance(1.0)
        tr.end(root, tokens=rid + 2)
    return tr


def test_tracer_forest_and_latencies_match_jax(tmp_path):
    ours, theirs = _script_spans(T), _script_spans(J)
    assert ours.to_dicts() == theirs.to_dicts()
    assert ours.clock.now() == theirs.clock.now()
    assert T.span_forest(ours.spans) == J.span_forest(theirs.spans)
    assert T.request_latencies(ours.spans) == \
        J.request_latencies(theirs.spans)
    assert ours.export_jsonl(str(tmp_path / "t.jsonl")) == \
        theirs.export_jsonl(str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    span = ours.spans[0]
    assert not span.open and span.duration == span.t_end - span.t_start
    bad = ours.to_dicts() + [dict(ours.to_dicts()[0], span_id=99,
                                  parent_id=1234)]
    with pytest.raises(ValueError, match="dangling"):
        T.span_forest(bad)


@pytest.mark.parametrize("q", [0, 10, 50, 90, 99, 100])
def test_percentile_matches_jax(q):
    vals = [5.0, 1.0, None, 3.0, 2.5, 9.0, None, 0.25]
    assert T.percentile(vals, q) == J.percentile(vals, q)
    assert T.percentile([], q) is None and T.percentile([None], q) is None


def _script_registry(mod):
    r = mod.MetricsRegistry(constant_labels={"shard": "1"})
    c = r.counter("repro_x_total", "things", labels=("kind",))
    c.inc(kind="a")
    c.inc(2.5, kind="b")
    g = r.gauge("repro_level", "a level")
    g.set(3)
    g.set(-1.25)
    h = r.histogram("repro_lat_seconds", "latency", labels=("op",))
    for v in (0.0005, 0.02, 0.3, 7.0, 1e6):
        h.observe(v, op="step")
    h2 = r.histogram("repro_depth", buckets=(0, 1, 4))
    for v in (0, 1, 2, 9):
        h2.observe(v)
    mod.record_controller_events(r, [
        {"gemm": "mlp_up", "role": "grad", "event": "bump", "m_acc": 9,
         "measured_vrr": 0.7, "log_v": 160.0, "swamp_rate": 0.3},
        {"gemm": "attn_decode", "role": "serve", "event": "ok", "m_acc": 7},
        {"event": "ok"},
    ], area="ctl")
    mod.record_spec_events(r, [
        {"event": "spec_round", "proposed": 4, "accepted": 4, "emitted": 5,
         "rollback_depth": 0},
        {"event": "spec_round", "proposed": 4, "accepted": 1, "emitted": 2,
         "rollback_depth": 3},
        {"event": "preempt", "rid": 2},
    ])
    return r


def test_registry_snapshot_prometheus_and_jsonl_match_jax(tmp_path):
    ours, theirs = _script_registry(T), _script_registry(J)
    assert ours.snapshot() == theirs.snapshot()
    text = ours.to_prometheus()
    assert text == theirs.to_prometheus()
    parsed = T.metrics.parse_prometheus(text)
    assert parsed[("repro_x_total", (("kind", "b"), ("shard", "1")))] == 2.5
    assert parsed[("repro_serve_spec_rounds_total", (("shard", "1"),))] == 2
    ours.export_prometheus(str(tmp_path / "t" / "m.prom"))
    theirs.export_prometheus(str(tmp_path / "j" / "m.prom"))
    assert ours.export_jsonl(str(tmp_path / "t.jsonl")) == \
        theirs.export_jsonl(str(tmp_path / "j.jsonl"))
    for f in ("t/m.prom", "t.jsonl"):
        assert (tmp_path / f).read_bytes() == \
            (tmp_path / f.replace("t", "j", 1)).read_bytes()
    assert [json.loads(ln) for ln in
            (tmp_path / "t.jsonl").read_text().splitlines()] == \
        ours.snapshot()


def test_registry_refusals_and_process_default_match_jax():
    for mod in (T, J):
        r = mod.MetricsRegistry()
        assert r.counter("repro_c_total", labels=("a",)) is \
            r.counter("repro_c_total", labels=("a",))
        with pytest.raises(ValueError):
            r.gauge("repro_c_total")
        with pytest.raises(ValueError):
            r.counter("repro_c_total", labels=("b",))
        with pytest.raises(ValueError):
            r.counter("repro_c_total", labels=("a",)).inc(-1, a="x")
        with pytest.raises(ValueError):
            r.counter("repro_c_total", labels=("a",)).inc(b="x")
        fresh = mod.MetricsRegistry()
        mod.set_registry(fresh)
        try:
            assert mod.get_registry() is fresh
        finally:
            mod.set_registry(None)
        assert mod.get_registry() is not fresh
    with pytest.raises(ValueError):
        T.metrics.parse_prometheus("repro_bad{x=1} 2\n")


def test_collect_process_metrics_sweeps_launches_memo_and_cache():
    """The port sweeps the kernel wrappers' launch counts where JAX sweeps
    trace counts (ROADMAP Queue 3, T8), and JAX's memo and cache gauges."""
    from repro_torch.kernels.fused import qmatmul_fused
    from repro_torch.serve import plan as P
    from repro_torch.serve.scheduler import process_cache_stats

    saved = qmatmul_fused.fold_launches
    qmatmul_fused.fold_launches = 17
    try:
        P.certified_log_v(7, 5, 16, 512)
        r = T.MetricsRegistry()
        T.collect_process_metrics(r)
        T.collect_process_metrics(r)      # idempotent: gauges are set
    finally:
        qmatmul_fused.fold_launches = saved
    snap = {(s["metric"], tuple(sorted(s["labels"].items()))): s["value"]
            for s in r.snapshot()}
    assert snap[("repro_kernel_launches",
                 (("kernel", "qmatmul_fused.fold"),))] == 17
    assert ("repro_kernel_launches", (("kernel", "paged_attn_decode"),)) \
        in snap
    for key, v in P.certification_stats().items():
        assert snap[("repro_knee_certifications", (("key", key),))] == v
    for key, v in process_cache_stats().items():
        assert snap[("repro_serve_compile_cache", (("key", key),))] == v


# --------------------------------------------------------------------------
# the certification memo and --v-hint
# --------------------------------------------------------------------------

PLAN_CALLS = [
    dict(max_context=2048, page_size=16),
    dict(max_context=2048, page_size=16),          # all hits now
    dict(max_context=1000, page_size=16, prefill_chunk_tokens=64),
    dict(max_context=300, page_size=8, prefill_chunk_tokens=20),
    dict(max_context=512, page_size=16, tp_shards=2),
    dict(max_context=4096, page_size=16, v_hint=1024.0),
]


def test_certification_counts_match_jax():
    """The same plan calls (plans, a verify plan, direct certifications)
    on both packages from a cold memo: the same evaluations and hits."""
    from repro.serve import plan as JP
    from repro_torch.serve import plan as TP

    counts = []
    for mod in (TP, JP):
        mod.reset_certification_stats()
        assert mod.certification_stats() == {"evaluations": 0, "hits": 0}
        seen = []
        for kw in PLAN_CALLS:
            plan = mod.plan_attention(**kw)
            seen.append(mod.certification_stats())
        mod.plan_verify(plan, k=4)
        mod.certified_log_v(9, 5, 16, 2048)
        mod.decode_m_acc(777, 16, 5)
        seen.append(mod.certification_stats())
        counts.append(seen)
    assert counts[0] == counts[1]
    assert counts[0][1]["evaluations"] == counts[0][0]["evaluations"]
    assert counts[0][1]["hits"] > counts[0][0]["hits"]


@pytest.mark.parametrize("v_hint", [None, 0.5, 16.0, 4096.0])
def test_v_hint_plan_matches_jax(v_hint):
    from repro.serve import plan as JP
    from repro_torch.serve import plan as TP

    for kw in (dict(prefill_chunk_tokens=None), dict(prefill_chunk_tokens=64)):
        t = TP.plan_attention(4096, 16, v_hint=v_hint, **kw)
        j = JP.plan_attention(4096, 16, v_hint=v_hint, **kw)
        assert [(b.max_ctx, b.e_acc, b.m_acc, b.resumptions)
                for b in t.buckets] == \
            [(b.max_ctx, b.e_acc, b.m_acc, b.resumptions) for b in j.buckets]
        assert t.v_hint == j.v_hint
        tv, jv = TP.plan_verify(t, k=3), JP.plan_verify(j, k=3)
        assert tv.s_v == jv.s_v and [b.acc for b in tv.plan.buckets] == \
            [b.acc for b in jv.plan.buckets]


# --------------------------------------------------------------------------
# the engines on their simulations
# --------------------------------------------------------------------------


EVENTS_CAPACITY = 4


def _sim_engine(pkg, kind, tracer, metrics):
    if pkg == "t":
        from repro_torch.serve.scheduler import ServeEngine
        from repro_torch.serve.sim import SimExecutor
        from repro_torch.serve.spec import SpecDecodeEngine
    else:
        from repro.serve.scheduler import ServeEngine
        from repro.serve.sim import SimExecutor
        from repro.serve.spec import SpecDecodeEngine
    kw = dict(n_pages=12, page_size=PAGE, max_batch=4, tracer=tracer,
              metrics=metrics, events_capacity=EVENTS_CAPACITY,
              executor=SimExecutor(n_pages=12, page_size=PAGE,
                                   vocab_size=211))
    if kind == "spec":
        dn = 12 + 4 * 2
        return SpecDecodeEngine(
            None, None, spec_k=3, draft_n_pages=dn, prefill_chunk_tokens=PAGE,
            draft_executor=SimExecutor(
                n_pages=dn, page_size=PAGE, vocab_size=211,
                draft_wrong=lambda rid, idx: idx % 3 == 0), **kw)
    return ServeEngine(None, None, prefill_chunk_tokens=PAGE,
                       reserve_admission=kind == "reserve", **kw)


@pytest.mark.parametrize("kind", ["optimistic", "reserve", "spec"])
def test_sim_engine_spans_and_metrics_match_jax(kind):
    """The same bursty trace through both engines with a tracer on the
    virtual clock and a registry: span dicts, the forest, latencies, the
    snapshot, the Prometheus text and the bounded event ring equal; one
    root per request, its token events the stream's length."""
    from repro.serve.sim import poisson_burst_trace as jtrace
    from repro.serve.sim import replay_trace as jreplay
    from repro_torch.serve.sim import poisson_burst_trace, replay_trace

    out = []
    for pkg, mod, trace_fn, replay in (("t", T, poisson_burst_trace,
                                        replay_trace),
                                       ("j", J, jtrace, jreplay)):
        tracer = mod.Tracer(clock=mod.VirtualClock())
        reg = mod.MetricsRegistry()
        eng = _sim_engine(pkg, kind, tracer, reg)
        m = replay(eng, trace_fn(20260730, n_requests=12,
                                 prompt_range=(2, 20), gen_range=(1, 10),
                                 max_request_tokens=eng.tokens_capacity))
        out.append((tracer.to_dicts(), reg.snapshot(), reg.to_prometheus(),
                    list(eng.events), eng.events.dropped, dict(eng.finished),
                    m["preemptions"]))
    assert out[0] == out[1]
    spans, snap, _, events, dropped, finished, preempts = out[0]
    forest = T.span_forest(spans)
    roots = [n["span"] for n in forest.values()
             if n["span"]["name"] == "request"]
    assert sorted(r["trace_id"] for r in roots) == sorted(finished)
    for r in roots:
        toks = [e for e in r["events"] if e["name"] == "token"]
        assert len(toks) == len(finished[r["trace_id"]])
    tokens = {s["metric"]: s.get("value") for s in snap}
    assert tokens["repro_serve_tokens_total"] == sum(
        len(v) for v in finished.values())
    if kind == "reserve":
        assert preempts == 0
    else:
        assert dropped > 0 and len(events) == EVENTS_CAPACITY
    if kind == "optimistic":
        assert preempts > 0
    if kind == "spec":
        names = {s["name"] for s in spans}
        assert {"draft", "verify", "rollback"} <= names


# --------------------------------------------------------------------------
# the engines on the smoke model: the port against a JAX child
# --------------------------------------------------------------------------

# (arrival tick, prompt length, max new) on a pool too small for the first
# two at once: optimistic admission preempts, reservation waits
TRACE = ((0, 40, 10), (0, 36, 8), (2, 20, 8))
MPAGE, MCHUNK, N_PAGES, MAX_BATCH, GEMM_CHUNK = 16, 16, 6, 2, 16


def _model_cfg(mod_cfg, mod_policy):
    return mod_policy.plan_for_model(
        mod_cfg.get_smoke_config("qwen2-1.5b"), seq_len=48,
        global_batch=len(TRACE),
        policy=mod_policy.AccumulationPolicy(mode="predicted",
                                             chunk=GEMM_CHUNK))


def _prompts(vocab):
    rng = np.random.RandomState(7)
    return [rng.randint(0, vocab, p).tolist() for _, p, _ in TRACE]


def _eos(streams) -> int:
    """A token that some stream first emits after its first token: an EOS
    id that cuts that stream short."""
    return next(t for s in streams for j, t in enumerate(s)
                if j > 0 and t not in s[:j])


def _model_runs(pkg, model, params, vocab, extra_kw):
    """The three runs on either package: (spans, snapshot, Prometheus text,
    streams, step records, preemptions) of the obs run, then the
    reservation and EOS runs' (streams, step records, preemptions)."""
    if pkg == "t":
        from repro_torch.serve.scheduler import ServeEngine
        from repro_torch.serve.sim import TraceRequest, replay_trace
        mod = T
    else:
        from repro.serve.scheduler import ServeEngine
        from repro.serve.sim import TraceRequest, replay_trace
        mod = J
    trace = [TraceRequest(*r) for r in TRACE]

    def run(tracer=None, metrics=None, **kw):
        eng = ServeEngine(model, params, n_pages=N_PAGES, page_size=MPAGE,
                          max_batch=MAX_BATCH, prefill_chunk_tokens=MCHUNK,
                          tracer=tracer, metrics=metrics, **extra_kw, **kw)
        prompts = iter(_prompts(vocab))
        steps = []
        step = eng.step

        def rec():
            steps.append(step())
            return steps[-1]

        eng.step = rec
        m = replay_trace(eng, trace, prompt_fn=lambda req: next(prompts))
        return eng, [eng.finished[r] for r in sorted(m["submitted"])], steps

    out = {}
    tracer = mod.Tracer(clock=mod.VirtualClock())
    reg = mod.MetricsRegistry()
    eng, streams, steps = run(tracer, reg)
    out["obs"] = (tracer.to_dicts(), reg.snapshot(), reg.to_prometheus(),
                  streams, steps, eng.preemptions)
    eng, streams, steps = run(reserve_admission=True)
    out["reserve"] = (streams, steps, eng.preemptions)
    eng, streams, steps = run(eos_id=_eos(out["obs"][3]))
    out["eos"] = (streams, steps, eng.preemptions)
    return out


def obs_child(out_path: str) -> None:
    """The JAX side of the model runs (excess precision off, ROADMAP F2)."""
    import pickle

    import jax
    import jax.numpy as jnp

    from repro import configs as jcfgs
    from repro.core import policy as jpol
    from repro.models.api import get_model

    cfg = _model_cfg(jcfgs, jpol)
    model = get_model(cfg)
    params = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                          jax.jit(model.init_params)(jax.random.PRNGKey(0)))
    out = _model_runs("j", model, params, cfg.vocab_size, {})
    out["params"] = jax.tree.map(np.asarray, params)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def model_runs(tmp_path_factory):
    import pickle

    from repro_torch import configs as tcfgs
    from repro_torch.convert import params_from_jax
    from repro_torch.core import policy as tpol
    from repro_torch.models.api import get_model

    path = str(tmp_path_factory.mktemp("jax_obs") / "jax.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    child = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_obs as t; t.obs_child({path!r})"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert child.returncode == 0, child.stdout + child.stderr
    with open(path, "rb") as f:
        jax_out = pickle.load(f)
    cfg = _model_cfg(tcfgs, tpol)
    model = get_model(cfg)
    params = params_from_jax(jax_out.pop("params"), cfg, "cpu")
    ours = _model_runs("t", model, params, cfg.vocab_size,
                       {"device": "cpu"})
    return dict(ours=ours, jax=jax_out, model=model, params=params, cfg=cfg)


def test_model_engine_spans_metrics_and_prometheus_match_jax(model_runs):
    ours, theirs = model_runs["ours"]["obs"], model_runs["jax"]["obs"]
    spans, snap, text, streams, steps, preempts = ours
    assert streams == theirs[3] and steps == theirs[4]
    assert spans == theirs[0]
    assert snap == theirs[1]
    assert text == theirs[2]
    assert preempts > 0
    parsed = T.metrics.parse_prometheus(text)
    assert parsed[("repro_serve_tokens_total", ())] == sum(map(len, streams))
    assert parsed[("repro_serve_preemptions_total", ())] == preempts
    forest = T.span_forest(spans)
    roots = [n for n in forest.values() if n["span"]["name"] == "request"]
    assert len(roots) == len(TRACE)


def test_model_reservation_admission_matches_jax(model_runs):
    """Reservation admission on the model: JAX's admission order (every
    step's record), no preemption, and JAX's streams; against the
    optimistic run, the streams are the same tokens (greedy decode does
    not depend on which rows share a step here: no bucket changes)."""
    ours, theirs = model_runs["ours"]["reserve"], model_runs["jax"]["reserve"]
    assert ours == theirs
    streams, steps, preempts = ours
    assert preempts == 0
    assert [s["admitted"] for s in steps] != \
        [s["admitted"] for s in model_runs["ours"]["obs"][4]]
    assert streams == model_runs["ours"]["obs"][3]


def test_model_eos_matches_jax(model_runs):
    """``eos_id`` ends each stream at its first EOS, as JAX's engine does:
    every stream is the EOS-free run's cut there (inclusive)."""
    ours, theirs = model_runs["ours"]["eos"], model_runs["jax"]["eos"]
    assert ours == theirs
    full = model_runs["ours"]["obs"][3]
    eos = _eos(full)
    cut = [s[:s.index(eos) + 1] if eos in s else s for s in full]
    assert ours[0] == cut and cut != full


def test_obs_on_is_bitwise_obs_off(model_runs):
    """The instrumented engine runs the same kernels on the same inputs:
    its streams and arena bytes equal the engine's without a tracer or a
    registry."""
    from repro_torch.serve.scheduler import ServeEngine
    from repro_torch.serve.sim import TraceRequest, replay_trace

    arenas, streams = [], []
    for on in (True, False):
        eng = ServeEngine(model_runs["model"], model_runs["params"],
                          n_pages=N_PAGES, page_size=MPAGE,
                          max_batch=MAX_BATCH, prefill_chunk_tokens=MCHUNK,
                          device="cpu",
                          tracer=T.Tracer() if on else None,
                          metrics=T.MetricsRegistry() if on else None)
        prompts = iter(_prompts(model_runs["cfg"].vocab_size))
        m = replay_trace(eng, [TraceRequest(*r) for r in TRACE],
                         prompt_fn=lambda req: next(prompts))
        streams.append([eng.finished[r] for r in sorted(m["submitted"])])
        arenas.append({k: v.clone() for k, v in eng.kv.items()})
    assert streams[0] == streams[1]
    for k in arenas[0]:
        assert torch.equal(arenas[0][k], arenas[1][k]), k


def test_oracle_executor_on_the_cpu(model_runs):
    """``ServeEngine(oracle=True)`` (JAX's executor flag): an eager
    executor and the same streams (on the CPU both run the plain versions;
    the card's test holds the kernels against it)."""
    from repro_torch.serve.scheduler import ServeEngine
    from repro_torch.serve.sim import TraceRequest, replay_trace

    streams, execs = [], []
    for oracle in (False, True):
        eng = ServeEngine(model_runs["model"], model_runs["params"],
                          n_pages=N_PAGES, page_size=MPAGE,
                          max_batch=MAX_BATCH, prefill_chunk_tokens=MCHUNK,
                          device="cpu", oracle=oracle)
        prompts = iter(_prompts(model_runs["cfg"].vocab_size))
        m = replay_trace(eng, [TraceRequest(*r) for r in TRACE],
                         prompt_fn=lambda req: next(prompts))
        streams.append([eng.finished[r] for r in sorted(m["submitted"])])
        execs.append(eng.executor)
    assert streams[0] == streams[1] == model_runs["ours"]["obs"][3]
    assert execs[1].oracle and not execs[1].graphs


# --------------------------------------------------------------------------
# training: the in-graph tick's registry and the launcher's export
# --------------------------------------------------------------------------


def test_train_launcher_exports_the_controller_events(tmp_path):
    """``--ingraph-telemetry --obs-metrics --obs-prometheus``: the export
    holds the controller's events as JAX's ``record_controller_events``
    records them (the same events through both recorders give the same
    samples) and the launch-count sweep; the Prometheus file parses."""
    from repro_torch.launch import train as LT

    T.set_registry(T.MetricsRegistry())
    log = tmp_path / "telemetry.jsonl"
    try:
        LT.main(["--smoke", "--steps", "2", "--global-batch", "2",
                 "--seq-len", "16", "--policy", "perturbed", "--pp", "-2",
                 "--chunk", "16", "--telemetry-cadence", "1",
                 "--ingraph-telemetry", "--telemetry-log", str(log),
                 "--log-every", "1", "--device", "cpu",
                 "--obs-metrics", str(tmp_path / "m.jsonl"),
                 "--obs-prometheus", str(tmp_path / "m.prom")])
    finally:
        T.set_registry(None)
    events = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert events
    rows = [json.loads(ln) for ln in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    ctl = [r for r in rows if r["metric"].startswith("repro_controller_")]
    want = J.MetricsRegistry()
    J.record_controller_events(want, events, area="controller")
    assert sorted(ctl, key=json.dumps) == sorted(want.snapshot(),
                                                 key=json.dumps)
    assert sum(r["value"] for r in ctl
               if r["metric"] == "repro_controller_events_total") == \
        len(events)
    assert any(r["metric"] == "repro_kernel_launches" for r in rows)
    parsed = T.metrics.parse_prometheus((tmp_path / "m.prom").read_text())
    assert ("repro_knee_certifications", (("key", "hits"),)) in parsed


def test_ingraph_telemetry_records_into_its_registry():
    """``InGraphTelemetry(registry=)`` no longer raises: each tick's
    controller events land in the registry as JAX's tick records them."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.api import get_model
    from repro_torch.obs.ingraph import InGraphTelemetry
    from repro_torch.telemetry.controller import (ControllerConfig,
                                                  PrecisionController)
    from repro_torch.train import optimizer as O
    from repro_torch.train.loop import TrainConfig, init_train_state

    policy = AccumulationPolicy(mode="perturbed", chunk=16, perturbation=-2)
    cfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=16,
                         global_batch=2, policy=policy)
    model = get_model(cfg)
    tc = TrainConfig(opt=O.OptConfig(lr=1e-3, warmup_steps=1,
                                     total_steps=2))
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu",
                             tc)
    batch = next(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=16, global_batch=2)))
    reg = T.MetricsRegistry()
    tick = InGraphTelemetry(PrecisionController(
        policy, ControllerConfig(cadence=1)), tc, seq_len=16, global_batch=2,
        registry=reg)
    _, _, events, _ = tick.tick(model, state, batch, step=1)
    assert events
    want = J.MetricsRegistry()
    J.record_controller_events(want, events, area="controller")
    assert reg.snapshot() == want.snapshot()


# --------------------------------------------------------------------------
# the launchers' flags
# --------------------------------------------------------------------------


def _options(parse_args) -> dict:
    """``{option: default}`` of the parser a launcher's ``parse_args``
    builds (caught as it parses no arguments)."""
    import argparse
    from unittest import mock

    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        return real(self, [], namespace)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        parse_args([])
    return {o: a.default for a in seen["parser"]._actions
            for o in a.option_strings}


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_take_every_jax_flag(launcher):
    """Every flag of JAX's launcher is the port's, with JAX's default
    (``--device`` and the port's own extras aside; the training launcher's
    meshes are [dist-train]'s); without ``--prompt-lens`` the requests are
    JAX's ``--batch`` copies of ``--prompt-len``."""
    import importlib

    jax_mod = importlib.import_module(f"repro.launch.{launcher}")
    port = importlib.import_module(f"repro_torch.launch.{launcher}")
    theirs, ours = _options(jax_mod.parse_args), _options(port.parse_args)
    skip = {"--mesh"} if launcher == "train" else set()
    missing = sorted(set(theirs) - set(ours) - skip)
    assert not missing, missing
    for flag in set(theirs) - skip - {"-h", "--help"}:
        assert ours[flag] == theirs[flag], flag
    if launcher == "serve":
        args = port.parse_args([])
        assert port.prompt_lengths(args) == [32] * 4
        assert port.prompt_lengths(port.parse_args(
            ["--prompt-lens", "5,7"])) == [5, 7]
