"""The port's compile cache against the JAX package's
(``tests/test_compile_cache.py``): one signature a (bucket, kernel).

The port's engine keeps JAX's process-wide compile cache; on the card a
signature is a captured CUDA graph, on the CPU its first call.  Pinned here
on the CPU, at the smoke config:

* kernel: P's device-geometry entry (``flash_prefill_paged_geom``, the
  geometry an int32[4] tensor) on 22 slab geometries, aligned and ragged,
  at one (slab width, page-row width): bitwise the launch-argument entry on
  the unpadded slab, rows past ``q_len`` exactly 0;
* model: the same geometries through the executor's padded prefill (slab
  padded to its width with zeros, the slab's pages with the null page, the
  geometry as 0-d tensors): logits and arena bitwise the unpadded
  host-int prefill's, and all 22 through one signature;
* engine: a warmed engine serves randomized traffic with a forced
  preemption and 20+ slab geometries with 0 steady-state compiles; its
  warmup makes as many signatures as JAX's warmup compiles on the same
  smoke plan (a JAX child process, excess precision off: ROADMAP F2);
* ``process_cache_stats``, and executors with other weights not sharing a
  cache entry (a graph holds its parameters' pointers: ROADMAP T7);
* the cache keeps no executor alive: a collected executor's signatures
  (and on the card its graph pool) are dropped, its counters kept.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.attention import (
    flash_prefill_paged,
    flash_prefill_paged_geom,
    prefill_geom,
)
from repro_torch.models import lm
from repro_torch.models.api import PrefillRequest, get_model
from repro_torch.quant.formats import FP8_152
from repro_torch.serve import scheduler as S
from repro_torch.serve.kvcache import PagedKVConfig

ACC = (6, 7)
ENG_KW = dict(n_pages=10, page_size=4, max_batch=3)
CHUNK = 4
# (t0, q_len) slab geometries of tests/test_compile_cache.py
GEOMS = [(0, 8), (0, 5), (0, 4), (0, 1), (4, 8), (4, 4), (4, 3), (4, 1),
         (8, 8), (8, 4), (8, 2), (8, 1), (12, 8), (12, 6), (12, 1), (16, 8),
         (16, 7), (16, 4), (16, 2), (20, 4), (20, 3), (20, 1)]


def jax_child(out_path: str) -> None:
    """The JAX side: the smoke engine's warmup on the plan of
    ``ENG_KW`` with 4-token slabs (its compiles and its buckets)."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.api import get_model as jax_model
    from repro.serve import scheduler as JS

    model = jax_model(jax_smoke("qwen2-1.5b"))
    eng = JS.ServeEngine(model, model.init_params(jax.random.PRNGKey(0)),
                         prefill_chunk_tokens=CHUNK, **ENG_KW)
    warm = eng.warmup()
    with open(out_path, "w") as f:
        json.dump({"warm": warm, "stats": eng.compile_stats(),
                   "buckets": [[b.max_ctx, b.e_acc, b.m_acc]
                               for b in eng.plan.buckets]}, f)


@pytest.fixture(scope="module")
def jax_warm(tmp_path_factory):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = str(tmp_path_factory.mktemp("jax_cc") / "warm.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(repo, "src"),
                                           os.path.join(repo, "tests")]))
    child = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_compile_cache as t; t.jax_child({path!r})"],
        env=env, cwd=repo, capture_output=True, text=True, timeout=600)
    assert child.returncode == 0, child.stdout + child.stderr
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def smoke_model():
    cfg = get_smoke_config("qwen2-1.5b")
    model = get_model(cfg)
    return model, model.init_params(torch.Generator().manual_seed(0), "cpu")


# --------------------------------------------------------------------------
# kernel level: P's device geometry, one launch shape for every slab
# --------------------------------------------------------------------------


def test_device_geometry_entry_serves_all_slab_geometries():
    """22 geometries at one (slab width T, page-row width W): the
    device-geometry entry on the padded slab is bitwise the host-int entry
    on the live rows, and its padded rows are exactly 0."""
    ps, w, t = 4, 6, 8
    h, kv, dh = 4, 2, 8
    gen = torch.Generator().manual_seed(0)
    kc = torch.randint(-127, 128, (w + 1, kv, ps, dh), generator=gen,
                       dtype=torch.int8)
    vc = torch.randint(-127, 128, (w + 1, kv, ps, dh), generator=gen,
                       dtype=torch.int8)
    kse = torch.randint(-3, 3, (w + 1,), generator=gen, dtype=torch.int32)
    vse = torch.randint(-3, 3, (w + 1,), generator=gen, dtype=torch.int32)
    row = (torch.randperm(w, generator=gen) + 1).to(torch.int32)
    q = torch.randn((w * ps, h, dh), generator=gen)
    kw = dict(kv_fmt=FP8_152, acc=ACC)
    for t0, q_len in GEOMS:
        q_len = min(q_len, w * ps - t0)
        qs = torch.zeros((t, h, dh))
        qs[:q_len] = q[t0:t0 + q_len]
        got = flash_prefill_paged_geom(qs, kc, vc, kse, vse, row,
                                       prefill_geom(t0, q_len), **kw)
        want = flash_prefill_paged(q[t0:t0 + q_len].contiguous(), kc, vc,
                                   kse, vse, row, t0, q_len, t0 + q_len,
                                   **kw)
        assert torch.equal(got[:q_len], want), (t0, q_len)
        assert bool((got[q_len:] == 0).all()), (t0, q_len)
    # the geometry as 0-d tensors, as the layers stack it
    geom = prefill_geom(torch.tensor(4, dtype=torch.int32),
                        torch.tensor(3, dtype=torch.int32))
    assert geom.tolist() == [4, 3, 7, 0] and geom.dtype == torch.int32


# --------------------------------------------------------------------------
# model level: the executor's padded slab, one signature
# --------------------------------------------------------------------------


def test_padded_slab_prefill_is_one_signature_and_bitwise(smoke_model):
    """Every geometry through the executor's padded prefill (slab width
    8, page-row width 6, geometry on the device) gives the logits and the
    arena of the unpadded host-int prefill, bitwise, and all 22 share one
    signature."""
    model, params = smoke_model
    cfg = model.cfg
    ps, width, slab_w = 4, 6, 8
    pc = PagedKVConfig.for_model(cfg, n_pages=width + 1, page_size=ps)
    ex = S.ModelExecutor(model, params, pc, kv_fmt=FP8_152, max_batch=3,
                         device="cpu")
    row = list(range(1, width + 1))
    rng = np.random.RandomState(5)
    toks = rng.randint(0, cfg.vocab_size, width * ps).tolist()
    kw = dict(kv_fmt=FP8_152, acc=ACC)
    with ex.compile_stats_scope() as delta:
        for t0, q_len in GEOMS:
            q_len = min(q_len, width * ps - t0)
            for t in ex.kv.values():
                t.zero_()
            with torch.no_grad():
                if t0:   # the history, one unpadded host-int slab
                    pages = torch.tensor(row[:t0 // ps])
                    lm.paged_prefill(params, torch.tensor([toks[:t0]]),
                                     ex.kv, pages.to(torch.int32), pages, 0,
                                     t0, cfg, want_logits=False, **kw)
                ref_kv = {k: v.clone() for k, v in ex.kv.items()}
                n_pg = -(-(t0 + q_len) // ps)
                slab_pages = row[t0 // ps:n_pg]
                want = lm.paged_prefill(
                    params, torch.tensor([toks[t0:t0 + q_len]]), ref_kv,
                    torch.tensor(row, dtype=torch.int32),
                    torch.tensor(slab_pages), t0, q_len, cfg, **kw)
            got = ex.prefill_logits(PrefillRequest(
                rid=0, tokens=tuple(toks[t0:t0 + q_len]),
                hist_pages=tuple(row[:t0 // ps]),
                slab_pages=tuple(slab_pages), t0=t0, acc=ACC, final=True,
                bucket_pages=width, slab_width=slab_w))
            assert torch.equal(got, want), (t0, q_len)
            for k in ex.kv:
                assert torch.equal(ex.kv[k], ref_kv[k]), (t0, q_len, k)
    assert delta["compiles"] == 1 and delta["misses"] == 1, delta
    assert delta["hits"] == len(GEOMS) - 1, delta


# --------------------------------------------------------------------------
# engine level: warmed cache, zero steady-state compiles
# --------------------------------------------------------------------------


def test_warmed_engine_zero_steady_state_compiles(smoke_model, jax_warm):
    """A warm-started engine serves 20+ randomized slab geometries (ragged
    tails, a forced preemption and its restore) without a new signature:
    every dispatch a hit.  Its warmup makes JAX's number of compiles on the
    same plan."""
    model, params = smoke_model
    eng = S.ServeEngine(model, params, prefill_chunk_tokens=CHUNK,
                        warm_start=True, device="cpu", **ENG_KW)
    base = eng.compile_stats()
    assert [[b.max_ctx, b.e_acc, b.m_acc] for b in eng.plan.buckets] \
        == jax_warm["buckets"]
    assert base["warm_compiles"] == base["compiles"] > 0
    assert base["compiles"] == jax_warm["warm"]["compiles"] \
        == jax_warm["stats"]["warm_compiles"], (base, jax_warm)
    arena = {k: v.clone() for k, v in eng.executor.kv.items()}
    rng = np.random.RandomState(1)

    def burst(n_req):
        for _ in range(n_req):
            n = int(rng.randint(4, 21))
            g = int(rng.randint(1, 5))
            eng.submit(list(rng.randint(1, model.cfg.vocab_size, n)), g)

    with eng.executor.compile_stats_scope() as delta:
        burst(4)
        for _ in range(4):
            eng.step()
        victim = max(eng.active) if eng.active else None
        if victim is not None:
            eng.preempt(victim)
        eng.run()
        burst(4)
        eng.run()
    assert eng.prefill_slabs >= 20, "not enough slab geometries exercised"
    assert eng.restores >= 1, "the forced preemption was not restored"
    assert delta["compiles"] == 0, delta
    assert delta["misses"] == 0, delta
    assert delta["hits"] > 0, delta
    # the warmup left the arena as it found it (zero operands write only
    # the null page, which it restores)
    fresh = S.ServeEngine(model, params, prefill_chunk_tokens=CHUNK,
                          device="cpu", **ENG_KW)
    for k, v in arena.items():
        assert torch.equal(v, fresh.executor.kv[k]), k
    eng.pool.check_invariants()
    assert eng.pool.free_pages == eng.pool.n_pages - 1


def test_process_cache_stats_and_no_sharing_across_weights(smoke_model):
    """``process_cache_stats`` sums every entry; an executor over other
    weights (or another arena) gets an entry of its own, so a signature
    made for one is never dispatched for the other."""
    model, params = smoke_model
    other = model.init_params(torch.Generator().manual_seed(1), "cpu")
    pc = PagedKVConfig.for_model(model.cfg, n_pages=10, page_size=4)
    a = S.ModelExecutor(model, params, pc, kv_fmt=FP8_152, device="cpu")
    b = S.ModelExecutor(model, other, pc, kv_fmt=FP8_152, device="cpu")
    assert a._cache is not b._cache
    assert a._cache_key() != b._cache_key()
    assert a._cache_key()[:-2] == b._cache_key()[:-2]   # storage only
    plan = S.plan_attention(pc.tokens_capacity, 4)
    before = S.process_cache_stats()
    wa = a.warmup(plan)
    wb = b.warmup(plan)
    assert wa["compiles"] == wb["compiles"] == 2 * len(plan.buckets)
    agg = S.process_cache_stats()
    assert agg["entries"] >= 2
    assert agg["compiles"] - before["compiles"] == 2 * wa["compiles"]
    assert agg["warm_compiles"] - before["warm_compiles"] \
        == 2 * wa["compiles"]
    assert agg["compiles"] == sum(e["stats"]["compiles"]
                                  for e in S._PROCESS_CACHE.values())
    # a second warmup of the same executor makes nothing
    assert a.warmup(plan)["compiles"] == 0
    assert S._device_topology(torch.device("cpu")) == (1, "cpu")


def test_collected_executor_releases_its_signatures(smoke_model):
    """The process cache holds no reference to an executor: once the
    executor is collected its entry's signatures and pool are dropped (on
    the card the graphs pin dead pointers and the pool's memory) and its
    counters stay in ``process_cache_stats``."""
    model, params = smoke_model
    pc = PagedKVConfig.for_model(model.cfg, n_pages=10, page_size=4)
    ex = S.ModelExecutor(model, params, pc, kv_fmt=FP8_152, device="cpu")
    plan = S.plan_attention(pc.tokens_capacity, 4)
    warm = ex.warmup(plan)
    entry = ex._cache
    assert len(entry["fns"]) == warm["compiles"] > 0
    stats = dict(entry["stats"])
    before = S.process_cache_stats()
    ref = weakref.ref(ex)
    del ex
    gc.collect()
    assert ref() is None
    assert entry["fns"] == {} and entry["pool"] is None
    assert entry["stats"] == stats
    assert S.process_cache_stats() == before
