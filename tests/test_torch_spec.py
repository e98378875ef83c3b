"""Speculative decoding in the port against the JAX package
(``tests/test_serve_spec.py``), on its smoke pair (qwen2-1.5b target,
qwen2-0.5b draft; one 256-token vocabulary, exact GEMMs), with bf16
weights as the launchers serve them, on the CPU.

Every claim of the JAX file, on the port, and each also held against JAX
on the same weights (``convert.params_from_jax``; one JAX child process
for the module, excess precision off: ROADMAP F2):

* ``lm.paged_verify`` on an arena of two rows (one crossing a page
  boundary mid-slab): logits and the post-append arena bitwise k + 1
  sequential ``paged_decode`` steps of the port, and within
  ``test_torch_serve.LOGIT_TOL`` (0.0625) of JAX's ``paged_verify`` on the
  same arena, at least ``CODE_FLOOR`` of the appended codes equal;
* ``truncate_pages`` on the post-verify arena bitwise JAX's, and bitwise
  the arena before the append (never appended);
* ``plan_verify`` accepting and refusing the same (plan, k) cases as JAX's;
* ``SpecDecodeEngine``: streams bitwise the plain engine's greedy streams
  and equal to JAX's ``SpecDecodeEngine``'s, with the same counters (an
  independent draft, so rejections and rollbacks happen); draft = target
  accepts every proposal; a warm-started engine serves mixed traffic with
  0 new signatures on both executors.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import lm
from repro_torch.models.api import get_model
from repro_torch.quant.formats import FP8_152
from repro_torch.serve.kvcache import PagedKVConfig, init_arena, truncate_pages
from repro_torch.serve.plan import plan_attention, plan_verify
from repro_torch.serve.scheduler import ServeEngine
from repro_torch.serve.spec import SpecDecodeEngine

ENG_KW = dict(n_pages=14, page_size=4, max_batch=3)
# test_torch_serve's tolerances: logits, and the least fraction of equal
# arena codes (a transcendental's last f32 bit may move one code)
LOGIT_TOL = 0.0625
CODE_FLOOR = 0.999
STREAM_PROMPTS = (5, 9, 3)
ACCEPT_PROMPTS = (6, 4)
# the verify arena: row 0 at position 7 (its slab spans pages 2 -> 5), row
# 1 at position 2 (within page 3), k = 2
VERIFY_ROWS = (([1, 2], 7), ([3], 2))
VERIFY_PT = [[1, 2, 5], [3, 6, 0]]
S_V = 3


ARCHS = (("qwen2-1.5b", 0), ("qwen2-0.5b", 7))   # (arch, PRNGKey seed)


def _jax_pair():
    """JAX's (target model, f32 params, draft model, f32 params): the smoke
    configs (exact GEMMs, as ``tests/test_serve_spec.py``), seeded."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.api import get_model as jax_model

    out = []
    for arch, seed in ARCHS:
        model = jax_model(jax_smoke(arch))
        out += [model, model.init_params(jax.random.PRNGKey(seed))]
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


def _unflat(flat: dict, tag: str) -> dict:
    tree: dict = {}
    for key, a in flat.items():
        if not key.startswith(tag + "/"):
            continue
        node, parts = tree, key.split("/")[1:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return tree


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).tolist() for n in lens]


def _spec_record(eng) -> dict:
    return {k: getattr(eng, k) for k in (
        "spec_rounds", "spec_proposed", "spec_accepted", "spec_emitted",
        "spec_rollback_tokens", "draft_primes", "fallback_rows")}


def _publish(path: str, arrays: dict) -> None:
    np.savez(path + ".tmp.npz", **arrays)
    os.replace(path + ".tmp.npz", path)


def _await(path: str, proc=None, timeout_s: float = 600.0) -> dict:
    t0 = time.monotonic()
    while not os.path.exists(path):
        if proc is not None and proc.poll() is not None:
            out, err = proc.communicate()
            raise AssertionError(f"the JAX child exited: {out}{err}")
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(path)
        time.sleep(0.05)
    return dict(np.load(path))


def jax_child(params_path: str, state_path: str, out_path: str) -> None:
    """The JAX side.  Publishes the seeded f32 params of the pair (the port
    carries them across while this runs on), runs the two spec-engine runs
    of this module on their bf16 casts, then ``paged_verify`` and
    ``truncate_pages`` on the arena the port wrote (``state_path``)."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jlm
    from repro.quant.formats import FP8_152 as JFMT
    from repro.serve import truncate_pages as jtrunc
    from repro.serve.spec import SpecDecodeEngine as JSpec

    tm, tp, dm, dp = _jax_pair()
    _publish(params_path, {**_flat(tp, "target"), **_flat(dp, "draft")})
    tp, dp = (jax.tree.map(lambda x: x.astype(jnp.bfloat16), t)
              for t in (tp, dp))
    out = {}
    for tag, (draft, dparams, lens, seed, gen) in {
            "spec": (dm, dp, STREAM_PROMPTS, 11, 5),
            "accept": (tm, tp, ACCEPT_PROMPTS, 12, 6)}.items():
        eng = JSpec(tm, tp, spec_k=2, draft_model=draft,
                    draft_params=dparams, **ENG_KW)
        rids = [eng.submit(p, gen) for p in _prompts(lens, seed)]
        res = eng.run()
        out[f"{tag}/streams"] = np.array([res[r] for r in rids])
        rec = _spec_record(eng)
        out[f"{tag}/counters"] = np.array([rec[k] for k in sorted(rec)])
    st = _await(state_path)
    kv0 = {k: jnp.asarray(st[k]) for k in ("k", "v", "k_se", "v_se")}
    pos = jnp.asarray(st["positions"], jnp.int32)
    logits, kv_v = jlm.paged_verify(
        tp, jnp.asarray(st["cand"], jnp.int32), kv0,
        jnp.asarray(VERIFY_PT, jnp.int32), pos, pos + 1, tm.cfg,
        kv_fmt=JFMT, acc=tuple(int(a) for a in st["acc"]))
    port_kv = {k: jnp.asarray(st["after_" + k])
               for k in ("k", "v", "k_se", "v_se")}
    rb = jtrunc(port_kv, jnp.asarray([5], jnp.int32), jnp.int32(2),
                jnp.int32(3))
    out["logits"] = np.asarray(logits.astype(jnp.float32))
    for k in kv_v:
        out["verify_" + k] = np.asarray(kv_v[k])
        out["trunc_" + k] = np.asarray(rb[k])
    _publish(out_path, out)


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


def _verify_state(cfg, params):
    """The two-row arena of ``VERIFY_ROWS`` (prefilled through the port),
    the candidates and the bucket's carry."""
    plan = plan_attention(32, 4)
    _, bucket = plan.bucket_for(10)            # the post-append worst case
    acc = bucket.acc
    kv = init_arena(PagedKVConfig.for_model(cfg, n_pages=10, page_size=4),
                    "cpu")
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for pages, n in VERIFY_ROWS:
            toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, n)))
            ids = torch.tensor(pages, dtype=torch.int32)
            lm.paged_prefill(params, toks, kv, ids, ids.long(), 0, n, cfg,
                             kv_fmt=FP8_152, acc=acc, want_logits=False)
    cand = rng.randint(0, cfg.vocab_size, (2, S_V))
    return kv, cand, acc


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX child (started first), the port's pair on the params it
    publishes, the port's verify on its own arena, and the child's
    outputs."""
    d = tmp_path_factory.mktemp("jax_spec")
    paths = [str(d / n) for n in ("params.npz", "state.npz", "jax.npz")]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(repo, "src"),
                                           os.path.join(repo, "tests")]))
    child = subprocess.Popen(
        [sys.executable, "-c",
         f"import test_torch_spec as t; t.jax_child(*{paths!r})"],
        env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        flat = _await(paths[0], child)
        pair = []
        for (arch, _), tag in zip(ARCHS, ("target", "draft")):
            cfg = get_smoke_config(arch)
            pair += [get_model(cfg),
                     _bf16(params_from_jax(_unflat(flat, tag), cfg, "cpu"))]
        tm, tp = pair[0], pair[1]
        kv0, cand, acc = _verify_state(tm.cfg, tp)
        kv_v = {k: v.clone() for k, v in kv0.items()}
        pt = torch.tensor(VERIFY_PT, dtype=torch.int32)
        pos = torch.tensor([7, 2])
        with torch.no_grad():
            logits = lm.paged_verify(tp, torch.from_numpy(cand), kv_v, pt,
                                     pos, (pos + 1).to(torch.int32), tm.cfg,
                                     kv_fmt=FP8_152, acc=acc)
        state = {k: v.numpy() for k, v in kv0.items()}
        state.update({"after_" + k: v.numpy() for k, v in kv_v.items()},
                     cand=cand, positions=np.array([7, 2]),
                     acc=np.array(acc))
        _publish(paths[1], state)
        out, err = child.communicate(timeout=600)
        assert child.returncode == 0, out + err
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    return dict(pair=tuple(pair), params=flat, kv0=kv0, kv_v=kv_v,
                logits=logits, cand=cand, acc=acc,
                jax=dict(np.load(paths[2])))


@pytest.fixture(scope="module")
def pair(served):
    """The port's (target model, bf16 params, draft model, bf16 params),
    carried across from the JAX package's seeded params."""
    return served["pair"]


# --------------------------------------------------------------------------
# model level: one verify pass == k + 1 sequential decode steps
# --------------------------------------------------------------------------


def test_paged_verify_bitexact_vs_sequential_decode_and_jax(pair, served):
    tm, tp, _, _ = pair
    kv_seq = {k: v.clone() for k, v in served["kv0"].items()}
    pt = torch.tensor(VERIFY_PT, dtype=torch.int32)
    pos = torch.tensor([7, 2])
    cand = torch.from_numpy(served["cand"])
    logits_v = served["logits"]
    assert tuple(logits_v.shape) == (2, S_V, tm.cfg.vocab_size)
    with torch.no_grad():
        for j in range(S_V):
            lj = lm.paged_decode(tp, cand[:, j:j + 1], kv_seq, pt, pos + j,
                                 (pos + 1 + j).to(torch.int32), tm.cfg,
                                 kv_fmt=FP8_152, acc=served["acc"])
            assert torch.equal(logits_v[:, j], lj[:, 0]), j
    for k in kv_seq:
        assert torch.equal(served["kv_v"][k], kv_seq[k]), k
    # against JAX's paged_verify on the same arena and weights
    jx = served["jax"]
    err = float(np.max(np.abs(jx["logits"] - logits_v.float().numpy())))
    eq = tot = 0
    for k in ("k", "v", "k_se", "v_se"):
        eq += int(np.sum(jx["verify_" + k] == served["kv_v"][k].numpy()))
        tot += jx["verify_" + k].size
    print(f"verify vs JAX: max logit error {err:.4g}, arena codes equal "
          f"{eq / tot:.6f}")
    assert err <= LOGIT_TOL
    assert eq / tot >= CODE_FLOOR


def test_rollback_arena_bitwise_jax_and_never_appended(served):
    """Total rejection of row 0's three appends (keep 7: page 5 freed,
    page 2 scrubbed past slot 3) and of row 1's (keep 2 of page 3, page 6
    freed): the arena bitwise the one before the append, and the first
    scrub bitwise JAX's ``truncate_pages`` on the same arena."""
    kv0, kv_v = served["kv0"], served["kv_v"]
    assert any(not torch.equal(kv_v[k], kv0[k]) for k in kv0)
    one = truncate_pages({k: v.clone() for k, v in kv_v.items()},
                         torch.tensor([5], dtype=torch.int32), 2, 3)
    for k in one:
        np.testing.assert_array_equal(one[k].numpy(),
                                      served["jax"]["trunc_" + k])
    both = truncate_pages(one, torch.tensor([6, 0], dtype=torch.int32),
                          torch.tensor(3), torch.tensor(2))
    for k in kv0:
        assert torch.equal(both[k], kv0[k]), k


# --------------------------------------------------------------------------
# planner level: (bucket, k) certification, the same verdicts as JAX
# --------------------------------------------------------------------------


def _plan_cases(mod):
    """(plan, k) cases on module ``mod``'s planner: healthy plans, a
    bucket too small for the slab, a degraded e_acc, a narrowed m_acc."""
    base = mod.plan_attention(64, 4)
    wide = mod.plan_attention(256, 16, prefill_chunk_tokens=64)
    bad_e = dataclasses.replace(base, buckets=(dataclasses.replace(
        base.buckets[-1], e_acc=2),) + base.buckets[1:])
    bad_m = dataclasses.replace(wide, buckets=tuple(
        dataclasses.replace(b, m_acc=1) for b in wide.buckets))
    return [(p, k) for p in (base, wide, bad_e, bad_m)
            for k in (0, 1, 2, 3, 4, 5, 16)]


def _verdict(mod, plan, k):
    try:
        vp = mod.plan_verify(plan, k=k)
    except ValueError as e:
        return ("refused", str(e).split(":")[0].split(" (")[0])
    return ("ok", vp.k, vp.s_v, [vp.bucket_for(c)[0] for c in (1, 4, 5, 17,
                                                               64)])


def test_plan_verify_same_verdicts_as_jax():
    from repro.serve import plan as JP
    from repro_torch.serve import plan as TP

    got = [_verdict(TP, p, k) for p, k in _plan_cases(TP)]
    want = [_verdict(JP, p, k) for p, k in _plan_cases(JP)]
    assert got == want
    assert sum(v[0] == "ok" for v in got) >= 5
    assert sum(v[0] == "refused" for v in got) >= 5
    vp = plan_verify(plan_attention(64, 4), k=3)
    assert vp.s_v == 4 and vp.plan.buckets == plan_attention(64, 4).buckets
    with pytest.raises(ValueError, match="k >= 1"):
        plan_verify(plan_attention(64, 4), k=0)


# --------------------------------------------------------------------------
# engine level: spec streams == plain greedy streams == JAX's
# --------------------------------------------------------------------------


def _run(eng, prompts, gen):
    rids = [eng.submit(list(p), gen) for p in prompts]
    out = eng.run()
    eng.pool.check_invariants()
    return [list(out[r]) for r in rids]


def test_spec_engine_stream_matches_plain_greedy_and_jax(pair, served):
    tm, tp, dm, dp = pair
    prompts = _prompts(STREAM_PROMPTS, 11)
    kw = dict(ENG_KW, device="cpu")
    plain = _run(ServeEngine(tm, tp, **kw), prompts, 5)
    eng = SpecDecodeEngine(tm, tp, spec_k=2, draft_model=dm,
                           draft_params=dp, **kw)
    got = _run(eng, prompts, 5)
    assert got == plain
    assert eng.spec_rounds > 0 and eng.spec_rollback_tokens > 0
    assert eng.draft_pool.free_pages == eng.draft_pool.n_pages - 1
    assert 0.0 <= eng.acceptance_rate() < 1.0
    assert sum(e["event"] == "spec_round" for e in eng.events) \
        == eng.spec_rounds
    jx = served["jax"]
    assert got == jx["spec/streams"].tolist()
    rec = _spec_record(eng)
    assert [rec[k] for k in sorted(rec)] == jx["spec/counters"].tolist()


def test_spec_engine_all_accept_when_draft_is_target(pair, served):
    tm, tp, _, _ = pair
    prompts = _prompts(ACCEPT_PROMPTS, 12)
    kw = dict(ENG_KW, device="cpu")
    plain = _run(ServeEngine(tm, tp, **kw), prompts, 6)
    eng = SpecDecodeEngine(tm, tp, spec_k=2, draft_model=tm, draft_params=tp,
                           **kw)
    got = _run(eng, prompts, 6)
    assert got == plain
    assert eng.spec_rounds > 0 and eng.acceptance_rate() == 1.0
    jx = served["jax"]
    assert got == jx["accept/streams"].tolist()
    rec = _spec_record(eng)
    assert [rec[k] for k in sorted(rec)] == jx["accept/counters"].tolist()


def test_spec_engine_zero_steady_state_compiles(pair):
    """A warm-started spec engine serves mixed traffic (spec rounds,
    rollbacks, draft primes, plain-lane rows) with 0 new signatures on
    both executors."""
    tm, tp, dm, dp = pair
    eng = SpecDecodeEngine(tm, tp, spec_k=2, draft_model=dm,
                           draft_params=dp, warm_start=True,
                           prefill_chunk_tokens=4, device="cpu", **ENG_KW)
    base = eng.compile_stats()
    assert base is not None and base["compiles"] > 0
    assert eng.draft_executor.compile_stats()["warm_compiles"] > 0
    rng = np.random.RandomState(13)
    with eng.executor.compile_stats_scope() as d_t, \
            eng.draft_executor.compile_stats_scope() as d_d:
        for _ in range(2):
            for _ in range(3):
                n = int(rng.randint(3, 13))
                g = int(rng.randint(1, 6))   # gen 1 rides the plain lane
                eng.submit(list(rng.randint(1, tm.cfg.vocab_size, n)), g)
            eng.run()
    assert eng.spec_rounds > 0 and eng.spec_rollback_tokens > 0
    for delta in (d_t, d_d):
        assert delta["compiles"] == 0, delta
        assert delta["misses"] == 0, delta
        assert delta["hits"] > 0, delta


def test_params_from_jax_carries_the_draft(served):
    """``params_from_jax`` on qwen2-0.5b's smoke params (JAX's seeded
    init, from the child): every leaf's bits and shape, and a mis-shaped
    tree refused."""
    np_params = _unflat(served["params"], "draft")
    cfg = get_smoke_config("qwen2-0.5b")
    got = params_from_jax(np_params, cfg, "cpu")
    flat = _flat(np_params)
    assert len(flat) == 14
    for key, a in flat.items():
        t = got
        for p in key.split("/")[1:]:
            t = t[p]
        assert tuple(t.shape) == a.shape, key
        np.testing.assert_array_equal(t.numpy().view(np.int32),
                                      a.view(np.int32), err_msg=key)
    with pytest.raises(ValueError):
        params_from_jax(dict(np_params, embed=np_params["embed"][:-1]), cfg,
                        "cpu")
