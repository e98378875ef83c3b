"""Port vs JAX package: tensor-parallel serving (the carry variants of the
decode and paged-prefill kernels, the exact carry merge, the collectives,
the param specs, the TP plan, the int8 logit wire and the sharded engine).

Sizes are small: the smoke config widened to 8 query and 4 KV heads (JAX's
``_SHARD_CFG`` in ``tests/test_serve_sharded.py``), so 2 and 4 ranks split
it.  Ranks are processes of a gloo group (``repro_torch.dist.spawn``, each
with a join deadline).

Tolerances:

* The carry plain versions against JAX's references and interpret-mode
  kernels: with the serve path's narrow carries ((1,6,5), (1,6,9)) bitwise
  on lattice q (every score's f32 sum over d is exact, and the carry's
  rounding absorbs the f32 order of the p.v sums); otherwise the running
  max ``m`` bitwise and o and l within 2 carry ulps of |want| plus one
  carry ulp of the largest value, 2^-16 of it with the wide (f32) carry,
  where the p.v order itself is the error (the bound of
  ``tests/test_torch_kernels.py``'s attention checks: XLA's dots sum in
  another order, ROADMAP F0).
* Inside the port, bitwise: a resumed paged walk against the one-shot
  walk; ``psum_carry`` over 4 ranks against ``merge_carries``; the 2- and
  4-rank engines against the single-device engine (tokens, every decode
  step's logits, the gathered arena).
* ``merge_carries``/``finalize_carry``, ``compressed_psum`` (lattice and
  random partials), the plan's buckets and the bytes per token: bitwise
  or equal to JAX's.
* The engine's tokens against JAX's single-device engine on the same
  converted params, plan and forced schedule (a JAX child process with
  XLA's excess precision off, ROADMAP F2): equal.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention as JA
from repro.quant.formats import FPFormat as JF
from repro_torch import dist as D
from repro_torch.kernels import attention as TA
from repro_torch.quant.formats import FP8_152

PS, KVH, G, DH = 4, 4, 2, 16          # pages of 4 tokens, 8 heads of 16
SPAWN_TIMEOUT_S = 300


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _lattice(rng, shape):
    """(1,5,2) points over a narrow exponent range, a tenth zero: every f32
    sum of their products with the arena's codes is exact."""
    e = rng.randint(-2, 3, size=shape)
    j = rng.randint(0, 4, size=shape)
    s = rng.choice([-1.0, 1.0], size=shape)
    x = s * np.exp2(e) * (1 + j / 4)
    x[rng.rand(*shape) < 0.1] = 0.0
    return x.astype(np.float32)


def _arena(rng, n_pages=10):
    from repro_torch.kernels.common import quantize_block
    from repro_torch.quant.qtensor import pack_block

    def codes():
        x = torch.from_numpy(rng.randn(n_pages, KVH, PS, DH).astype(np.float32))
        return pack_block(quantize_block(x, 5, 2), 5, 2).numpy()

    return (codes(), codes(), rng.randint(-2, 3, n_pages).astype(np.int32),
            rng.randint(-2, 3, n_pages).astype(np.int32))


def _close(got, want, acc):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    tol = (2.0 ** (1 - acc[1]) * np.abs(want)
           + max(2.0 ** -acc[1], 2.0 ** -16) * np.abs(want).max())
    assert np.all(np.abs(got - want) <= tol)


def _bitwise(acc, lattice) -> bool:
    """Where the module docstring holds the port bitwise JAX's."""
    return lattice and acc[1] <= 9


def _carry_vs(got, want, acc, lattice):
    (go, gm, gl), (wo, wm, wl) = got, want
    np.testing.assert_array_equal(_bits(gm), _bits(wm))
    if _bitwise(acc, lattice):
        np.testing.assert_array_equal(_bits(go), _bits(wo))
        np.testing.assert_array_equal(_bits(gl), _bits(wl))
    else:
        _close(go, wo, acc)
        _close(gl, wl, acc)


# --------------------------------------------------------------------------
# the carry variants: the port's plain versions against JAX's
# --------------------------------------------------------------------------


DECODE_LENS = np.array([0, 5, 16, 13, 37], np.int32)
DECODE_TABLE = np.array([[0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                         [3, 9, 0, 0, 0, 0, 0, 0, 0, 0],
                         [5, 1, 2, 4, 0, 0, 0, 0, 0, 0],
                         [7, 6, 8, 2, 0, 0, 0, 0, 0, 0],
                         [8, 4, 6, 2, 1, 3, 5, 7, 9, 9]], np.int32)


@pytest.mark.parametrize("acc", [(6, 5), (6, 9), (8, 23)])
@pytest.mark.parametrize("lattice", [True, False])
def test_decode_carry_plain_vs_jax(acc, lattice):
    """``paged_attn_decode(return_carry=True)`` (the plain version on the
    CPU) against JAX's reference and its interpret-mode kernel; a padded
    row is the neutral carry; its finalize is the finalized walk."""
    rng = np.random.RandomState(31 + lattice)
    kc, vc, kse, vse = _arena(rng)
    shape = (len(DECODE_LENS), KVH * G, DH)
    q = _lattice(rng, shape) if lattice else rng.randn(*shape).astype(np.float32)
    args = (q, kc, vc, kse, vse, DECODE_TABLE, DECODE_LENS)
    got = TA.paged_attn_decode(*map(_t, args), kv_fmt=FP8_152, acc=acc,
                               return_carry=True)
    got = [g.numpy() for g in got]
    for fn in (JA.paged_attn_decode_reference, JA.paged_attn_decode):
        want = [np.asarray(w) for w in fn(*map(_j, args), kv_fmt=JF(5, 2),
                                          acc=acc, return_carry=True)]
        _carry_vs(got, want, acc, lattice)
    np.testing.assert_array_equal(got[0][0], 0.0)
    np.testing.assert_array_equal(got[1][0], np.float32(TA.NEG))
    np.testing.assert_array_equal(got[2][0], 0.0)
    fin = TA.finalize_carry(_t(got[0]), _t(got[2]))
    out = TA.paged_attn_decode(*map(_t, args), kv_fmt=FP8_152, acc=acc)
    assert torch.equal(fin, out)
    with pytest.raises(ValueError, match="exclusive"):
        TA.paged_attn_decode(*map(_t, args), kv_fmt=FP8_152, acc=acc,
                             return_carry=True, collect_stats=True)


# a 21-token slab after 16 tokens of history, padded to 24 rows, over a
# page row wider than its pages
PREFILL_ROW = np.array([6, 2, 8, 5, 1, 9, 3, 7, 4, 0, 0, 0], np.int32)
T_SLAB, Q_OFF, Q_LEN = 24, 16, 21


def _prefill_args(rng, lattice):
    kc, vc, kse, vse = _arena(rng)
    shape = (T_SLAB, KVH * G, DH)
    q = _lattice(rng, shape) if lattice else rng.randn(*shape).astype(np.float32)
    return (q, kc, vc, kse, vse, PREFILL_ROW)


@pytest.mark.parametrize("acc", [(6, 5), (6, 9), (8, 23)])
@pytest.mark.parametrize("lattice", [True, False])
def test_prefill_carry_plain_vs_jax(acc, lattice):
    """``flash_prefill_paged(return_carry=True)`` and its resume from a
    carry at ``start_page`` (the plain versions on the CPU) against JAX's
    reference and interpret-mode kernel."""
    rng = np.random.RandomState(41 + lattice)
    args = _prefill_args(rng, lattice)
    kv_len = Q_OFF + Q_LEN
    tkw = dict(kv_fmt=FP8_152, acc=acc)
    jkw = dict(kv_fmt=JF(5, 2), acc=acc)
    got = [g.numpy() for g in TA.flash_prefill_paged(
        *map(_t, args), Q_OFF, Q_LEN, kv_len, return_carry=True, **tkw)]
    jfns = (JA.flash_prefill_paged_reference,
            lambda *a, **k: JA.flash_prefill_paged(*a, block_q=8, **k))
    for fn in jfns:
        want = [np.asarray(w) for w in fn(*map(_j, args), Q_OFF, Q_LEN,
                                          kv_len, return_carry=True, **jkw)]
        _carry_vs(got, want, acc, lattice)
    # resumed at page 3 from JAX's carry of pages [0, 3), through both
    jc = JA.flash_prefill_paged_reference(*map(_j, args), Q_OFF, Q_LEN,
                                          3 * PS, return_carry=True, **jkw)
    tc = TA.flash_prefill_paged(*map(_t, args), Q_OFF, Q_LEN, 3 * PS,
                                return_carry=True, **tkw)
    _carry_vs([c.numpy() for c in tc], [np.asarray(c) for c in jc], acc,
              lattice)
    got = TA.flash_prefill_paged(*map(_t, args), Q_OFF, Q_LEN, kv_len,
                                 carry=tuple(_t(np.asarray(c)) for c in jc),
                                 start_page=3, **tkw).numpy()
    for fn in jfns:
        want = np.asarray(fn(*map(_j, args), Q_OFF, Q_LEN, kv_len, carry=jc,
                             start_page=3, **jkw))
        if _bitwise(acc, lattice):
            np.testing.assert_array_equal(_bits(got), _bits(want))
        else:
            _close(got, want, acc)
    np.testing.assert_array_equal(got[Q_LEN:], 0.0)


@pytest.mark.parametrize("start_page", [1, 2, 4, 7, 9])
def test_prefill_resume_is_bitwise_one_shot(start_page):
    """A paged walk resumed at ``start_page`` from the carry of the pages
    before it (a carry-out call with ``kv_len = start_page * page_size``)
    is bitwise the one-shot walk, finalized and as a carry."""
    rng = np.random.RandomState(5 + start_page)
    args = tuple(map(_t, _prefill_args(rng, False)))
    kv_len = Q_OFF + Q_LEN
    kw = dict(kv_fmt=FP8_152, acc=(6, 5))
    one = TA.flash_prefill_paged(*args, Q_OFF, Q_LEN, kv_len, **kw)
    one_c = TA.flash_prefill_paged(*args, Q_OFF, Q_LEN, kv_len,
                                   return_carry=True, **kw)
    c = TA.flash_prefill_paged(*args, Q_OFF, Q_LEN, start_page * PS,
                               return_carry=True, **kw)
    res = TA.flash_prefill_paged(*args, Q_OFF, Q_LEN, kv_len, carry=c,
                                 start_page=start_page, **kw)
    res_c = TA.flash_prefill_paged(*args, Q_OFF, Q_LEN, kv_len, carry=c,
                                   start_page=start_page, return_carry=True,
                                   **kw)
    np.testing.assert_array_equal(_bits(res), _bits(one))
    for a, b in zip(res_c, one_c):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    with pytest.raises(ValueError, match="carry shapes"):
        TA.flash_prefill_paged(*args, Q_OFF, Q_LEN, kv_len,
                               carry=tuple(x[:-1] for x in c),
                               start_page=start_page, **kw)


def _disjoint_carries(rng, s=4, h=8, dh=16):
    """The serving layout: rank i owns heads [2i, 2i + 2), the neutral
    carry (0, NEG, 0) elsewhere; the last head is fully masked on every
    rank (a padded row)."""
    o = np.zeros((s, h, dh), np.float32)
    m = np.full((s, h), TA.NEG, np.float32)
    l = np.zeros((s, h), np.float32)
    for i in range(s):
        lo, hi = 2 * i, 2 * i + 2
        o[i, lo:hi] = rng.randn(hi - lo, dh).astype(np.float32)
        m[i, lo:hi] = np.round(rng.randn(hi - lo) * 4)
        l[i, lo:hi] = np.abs(rng.randn(hi - lo)).astype(np.float32) + 0.5
    o[s - 1, h - 1], m[s - 1, h - 1], l[s - 1, h - 1] = 0.0, TA.NEG, 0.0
    return o, m, l


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (2, 0, 3, 1)])
def test_merge_and_finalize_match_jax(order):
    """``merge_carries``/``finalize_carry`` bitwise JAX's, in any order
    (disjoint ownership), on overlapping random carries too (the same
    fold op for op)."""
    rng = np.random.RandomState(9)
    o, m, l = _disjoint_carries(rng)
    for oo, mm, ll in ((o, m, l), (rng.randn(*o.shape).astype(np.float32),
                                   np.round(rng.randn(*m.shape) * 4
                                            ).astype(np.float32),
                                   np.abs(rng.randn(*l.shape)
                                          ).astype(np.float32))):
        tc = TA.merge_carries([(_t(oo[i]), _t(mm[i]), _t(ll[i]))
                               for i in order])
        jc = JA.merge_carries([(_j(oo[i]), _j(mm[i]), _j(ll[i]))
                               for i in order])
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(
            _bits(TA.finalize_carry(tc[0], tc[2])),
            _bits(JA.finalize_carry(*jc[::2])))


# --------------------------------------------------------------------------
# the collectives over gloo ranks
# --------------------------------------------------------------------------


def _psum_rank(rank, size, init_method, o, m, l):
    dist = D.init_group(rank, size, init_method, "gloo", timeout_s=60)
    got = D.psum_carry(_t(o[rank]), _t(m[rank]), _t(l[rank]), dist)
    cols = D.gather_cols(_t(o[rank][:, :3]), dist)
    return ([x.numpy() for x in got], D.pmax(_t(m[rank]), dist).numpy(),
            cols.numpy())


def test_psum_carry_over_four_ranks_matches_merge():
    """``psum_carry`` over a 4-rank gloo group is bitwise the sequential
    ``merge_carries`` of the same carries (neutral and fully masked heads
    included); the fully masked head finalizes to exactly 0; ``pmax`` and
    ``gather_cols`` are the max and the concatenation."""
    rng = np.random.RandomState(0)
    o, m, l = _disjoint_carries(rng)
    out = D.spawn(_psum_rank, 4, (o, m, l), timeout_s=SPAWN_TIMEOUT_S)
    want = TA.merge_carries([(_t(o[i]), _t(m[i]), _t(l[i])) for i in range(4)])
    for (got, mx, cols) in out:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        fin = TA.finalize_carry(_t(got[0]), _t(got[2])).numpy()
        np.testing.assert_array_equal(fin[-1], 0.0)
        np.testing.assert_array_equal(mx, m.max(axis=0))
        np.testing.assert_array_equal(
            cols, np.concatenate([o[i][:, :3] for i in range(4)], axis=-1))


def _fail_rank(rank, size, init_method):
    dist = D.init_group(rank, size, init_method, "gloo", timeout_s=60)
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return D.pmax(torch.ones(1), dist).item()


def test_spawn_reports_a_failing_rank_within_its_deadline():
    """A rank that raises fails ``spawn`` with its traceback; its partner,
    left waiting in a collective, is joined or killed within the deadline
    (the call never blocks)."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        D.spawn(_fail_rank, 2, timeout_s=120)
    assert time.monotonic() - t0 < 120


# --------------------------------------------------------------------------
# specs, plan, bytes
# --------------------------------------------------------------------------


def _shard_cfg():
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config("qwen2-1.5b"), n_heads=8,
                               n_kv_heads=4)


def test_serve_param_specs_output_dim_only():
    """Every split is the last (output) dim, wo and w_down included, and
    the leading layer dim never; embed and norms replicated; rank r's
    slices concatenate back to the params."""
    from repro_torch.models.api import get_model
    from repro_torch.sharding.specs import serve_param_specs, shard_params

    cfg = _shard_cfg()
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        "cpu")
    specs = serve_param_specs(params, n_shards=2)
    split = []

    def walk(sp, pa, path):
        if isinstance(sp, dict):
            for k in sp:
                walk(sp[k], pa[k], path + (k,))
        elif sp:
            assert sp[-1] == "model" and all(a is None for a in sp[:-1]), path
            assert len(sp) == pa.ndim
            split.append(path[-1])
    walk(specs, params, ())
    assert sorted(split) == sorted(["wq", "wk", "wv", "wo", "bq", "bk", "bv",
                                    "w_gate", "w_up", "w_down"])
    assert specs["embed"] == () and specs["final_norm"] == ()
    parts = [shard_params(params, specs, r, 2) for r in range(2)]
    for name in ("wq", "wo"):
        full = params["layers"]["attn"][name]
        cat = torch.cat([p["layers"]["attn"][name] for p in parts], dim=-1)
        assert torch.equal(cat, full)
    assert parts[1]["embed"] is params["embed"]


def test_serve_param_specs_int8_wire_and_divisibility():
    from repro_torch.sharding.specs import serve_param_specs

    shapes = {"lm_head": torch.zeros((64, 256)), "embed": torch.zeros((256, 64))}
    assert serve_param_specs(shapes, n_shards=4)["lm_head"] == (None, "model")
    int8 = serve_param_specs(shapes, n_shards=4, logit_wire="int8")
    assert int8["lm_head"] == () and int8["embed"] == ()
    with pytest.raises(ValueError, match="cannot split"):
        serve_param_specs({"wq": torch.zeros((64, 66))}, n_shards=4)


@pytest.mark.parametrize("ctx,page,chunk,tp", [
    (256, 8, 8, 4), (256, 8, None, 2), (1904, 16, 64, 2), (1904, 16, None, 2),
    (92, 4, 8, 4)])
def test_plan_tp_shards_buckets_equal_jax(ctx, page, chunk, tp):
    """``plan_attention(tp_shards=)``: buckets (edges, e_acc, m_acc,
    resumptions) equal JAX's; the TP plan can only widen."""
    from repro.serve.plan import plan_attention as jplan
    from repro_torch.serve.plan import plan_attention as tplan

    got = tplan(ctx, page, prefill_chunk_tokens=chunk, tp_shards=tp)
    want = jplan(ctx, page, prefill_chunk_tokens=chunk, tp_shards=tp)
    base = tplan(ctx, page, prefill_chunk_tokens=chunk)
    assert got.tp_shards == tp and base.tp_shards == 1
    assert [dataclasses.astuple(b) for b in got.buckets] == \
        [dataclasses.astuple(b) for b in want.buckets]
    for b1, bt in zip(base.buckets, got.buckets):
        assert bt.m_acc >= b1.m_acc and bt.e_acc >= b1.e_acc


def test_kv_bytes_per_token_per_shard():
    from repro.serve.kvcache import PagedKVConfig as JPC
    from repro.serve.kvcache import kv_bytes_per_token as jbytes
    from repro_torch.serve.kvcache import PagedKVConfig, kv_bytes_per_token

    pc = PagedKVConfig(n_layers=2, n_kv_heads=4, head_dim=16, n_pages=8,
                       page_size=4)
    jpc = JPC(n_layers=2, n_kv_heads=4, head_dim=16, n_pages=8, page_size=4,
              kv_fmt=JF(5, 2))
    for tp in (1, 2, 4):
        assert kv_bytes_per_token(pc, tp_shards=tp) == jbytes(jpc,
                                                              tp_shards=tp)
    full, quarter = kv_bytes_per_token(pc), kv_bytes_per_token(pc, tp_shards=4)
    assert full / 4 < quarter < full


def test_sharded_page_pool_catches_drift():
    from repro_torch.serve.kvcache import ShardedPagePool

    pool = ShardedPagePool(12, 4, n_shards=3)
    pool.allocate(0, 5)
    pool.extend(0, 4)
    pool.allocate(1, 3)
    pool.release(0)
    pool.check_invariants()
    assert all(r._pages == pool._pages for r in pool._replicas)
    pool._replicas[1].extend(1, 4)      # one rank's accounting moves alone
    with pytest.raises(AssertionError, match="drifted"):
        pool.check_invariants()
    pool2 = ShardedPagePool(12, 4, n_shards=2)
    pool2._replicas[0]._free.reverse()  # a replica hands out other pages
    with pytest.raises(AssertionError, match="drifted"):
        pool2.allocate(7, 4)
    with pytest.raises(ValueError):
        ShardedPagePool(12, 4, n_shards=0)


# --------------------------------------------------------------------------
# the int8 logit wire
# --------------------------------------------------------------------------


def _wire_rank(rank, size, init_method, x):
    from repro_torch.train.compression import compressed_psum

    dist = D.init_group(rank, size, init_method, "gloo", timeout_s=60)
    total, residual = compressed_psum(_t(x[rank]), dist)
    return total.numpy(), residual.numpy(), D.psum(_t(x[rank]), dist).numpy()


@pytest.mark.parametrize("lattice", [True, False])
def test_compressed_psum_matches_jax(lattice):
    """``compressed_psum`` over 4 gloo ranks bitwise JAX's (its collectives
    under a named ``vmap`` axis), sum and residual; on lattice partials
    (amax 127: scale 1) it is bitwise the f32 sum, as JAX's test holds."""
    from repro.train.compression import compressed_psum as jcp

    rng = np.random.RandomState(3)
    if lattice:
        x = rng.randint(-127, 128, size=(4, 3, 16)).astype(np.float32)
        x[0, 0, 0] = 127.0
    else:
        x = rng.randn(4, 3, 16).astype(np.float32)
    out = D.spawn(_wire_rank, 4, (x,), timeout_s=SPAWN_TIMEOUT_S)
    jt, jr = jax.vmap(lambda v: jcp(v, "model"), axis_name="model")(_j(x))
    for r, (total, residual, plain) in enumerate(out):
        np.testing.assert_array_equal(_bits(total), _bits(np.asarray(jt[r])))
        np.testing.assert_array_equal(_bits(residual),
                                      _bits(np.asarray(jr[r])))
        if lattice:
            np.testing.assert_array_equal(_bits(total), _bits(plain))


def test_ef_compress_tree_matches_jax():
    from repro.train.compression import ef_compress_tree as jef
    from repro_torch.train.compression import ef_compress_tree

    rng = np.random.RandomState(4)
    g = {"a": rng.randn(5, 3).astype(np.float32),
         "b": {"c": rng.randn(7).astype(np.float32)}}
    e = {"a": rng.randn(5, 3).astype(np.float32) * 1e-3,
         "b": {"c": np.zeros(7, np.float32)}}
    tr, te = ef_compress_tree(jax.tree.map(_t, g), jax.tree.map(_t, e))
    jr, je = jef(jax.tree.map(_j, g), jax.tree.map(_j, e))
    for got, want in ((tr["a"], jr["a"]), (tr["b"]["c"], jr["b"]["c"]),
                      (te["a"], je["a"]), (te["b"]["c"], je["b"]["c"])):
        np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))


# --------------------------------------------------------------------------
# the sharded engine
# --------------------------------------------------------------------------


N_PAGES, PAGE = 24, 4
PROMPT_LENS = (5, 8, 3, 4, 13)
GEN, CHUNK, MAX_BATCH, PREEMPT_AFTER = 6, 8, 3, 4


def _prompts(vocab):
    rng = np.random.RandomState(1)
    return [rng.randint(1, vocab, n).tolist() for n in PROMPT_LENS]


def _jax_cfg():
    from repro.configs import get_smoke_config as jsmoke
    from repro.core.policy import AccumulationPolicy as JPolicy
    from repro.core.policy import plan_for_model as jplan

    cfg = dataclasses.replace(jsmoke("qwen2-1.5b"), n_heads=8, n_kv_heads=4)
    return jplan(cfg, seq_len=64, global_batch=len(PROMPT_LENS),
                 policy=JPolicy(mode="predicted", chunk=16))


def _torch_cfg():
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model

    return plan_for_model(_shard_cfg(), seq_len=64,
                          global_batch=len(PROMPT_LENS),
                          policy=AccumulationPolicy(mode="predicted",
                                                    chunk=16))


def _jax_params():
    from repro.models.api import get_model as jget

    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)),
                        jget(_jax_cfg()).init_params(jax.random.PRNGKey(0)))


def _job(tp, chunk=CHUNK, preempt=PREEMPT_AFTER, **kw):
    from repro_torch.convert import params_from_jax
    from repro_torch.serve.plan import plan_attention

    cfg = _torch_cfg()
    return dict(cfg=cfg, params=params_from_jax(_jax_params(), cfg, "cpu"),
                n_pages=N_PAGES, page_size=PAGE, max_batch=MAX_BATCH,
                prefill_chunk=chunk, prompts=_prompts(cfg.vocab_size),
                gen=GEN, preempt_after=preempt, logit_step=2,
                monitor_cadence=2,
                plan=plan_attention((N_PAGES - 1) * PAGE, PAGE,
                                    prefill_chunk_tokens=chunk,
                                    tp_shards=tp), **kw)


def jax_child(out_path: str, tp: int) -> None:
    """JAX's single-device engine on the same params, prompts, plan and
    forced schedule (run with XLA's excess precision off)."""
    from repro.models.api import get_model as jget
    from repro.serve.kvcache import PagedKVConfig as JPC
    from repro.serve.plan import plan_attention as jplan
    from repro.serve.scheduler import ModelExecutor, ServeEngine

    cfg = _jax_cfg()
    model = jget(cfg)
    params = jax.tree.map(jnp.asarray, _jax_params())
    ex = ModelExecutor(model, params, JPC.for_model(cfg, n_pages=N_PAGES,
                                                    page_size=PAGE),
                       kv_fmt=JF(5, 2), max_batch=MAX_BATCH)
    eng = ServeEngine(model, params, n_pages=N_PAGES, page_size=PAGE,
                      max_batch=MAX_BATCH, executor=ex,
                      prefill_chunk_tokens=CHUNK,
                      plan=jplan((N_PAGES - 1) * PAGE, PAGE,
                                 prefill_chunk_tokens=CHUNK, tp_shards=tp))
    rids = [eng.submit(p, GEN) for p in _prompts(cfg.vocab_size)]
    for _ in range(PREEMPT_AFTER):
        eng.step()
    eng.preempt(max(eng.active))
    out = eng.run()
    np.save(out_path, np.array([out[r] for r in rids]))


@pytest.fixture(scope="module")
def single():
    """The port's single-device engine under each TP plan."""
    from repro_torch.launch.serve import serve_job

    return {tp: serve_job(_job(tp), device="cpu") for tp in (2, 4)}


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_engine_bitwise_single_device(single, tp):
    """2- and 4-rank gloo engines, chunked prefill (8-token slabs over
    ragged prompts) and a forced preemption, the serve monitor every 2
    decode steps: tokens, every decode step's logits, the arena gathered
    from the ranks and the monitor's events bitwise the single-device
    engine's under the same ``tp_shards`` plan; every rank the same
    tokens; the per-rank pools in lockstep (``check_invariants`` in
    ``serve_job``)."""
    from repro_torch.launch.serve import run_tp

    one = single[tp]
    ranks = [r["runs"][0] for r in run_tp([_job(tp)], tp, "cpu",
                                          timeout_s=SPAWN_TIMEOUT_S)]
    r0 = ranks[0]
    assert r0["tp_shards"] == tp and one["tp_shards"] == 1
    assert all(r["tokens"] == one["tokens"] for r in ranks)
    assert r0["logit_hashes"] == one["logit_hashes"]
    assert len(one["logit_hashes"]) >= GEN - 1
    np.testing.assert_array_equal(_bits(r0["logits"]), _bits(one["logits"]))
    for name, a in one["arena"].items():
        np.testing.assert_array_equal(r0["arena"][name], a, err_msg=name)
    assert r0["events"] == one["events"] and len(one["events"]) >= 2
    assert r0["preemptions"] == 1 and r0["restores"] == 1
    assert r0["kv_bytes_per_token"] == one["kv_bytes_per_token"]
    assert r0["kv_bytes_per_token_shard"] < r0["kv_bytes_per_token"]


def test_single_device_tokens_match_jax(single):
    """The port's single-device engine under the TP plan against JAX's on
    the same converted params and forced schedule: the same streams."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "jax.npy")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_allow_excess_precision=false",
                   PYTHONPATH=os.pathsep.join([os.path.join(repo, "src"),
                                               os.path.join(repo, "tests")]))
        child = subprocess.run(
            [sys.executable, "-c",
             f"import test_torch_dist as t; t.jax_child({path!r}, 2)"],
            env=env, cwd=repo, capture_output=True, text=True, timeout=600)
        assert child.returncode == 0, child.stdout + child.stderr
        want = np.load(path).tolist()
    got = single[2]["tokens"]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b) == GEN
    assert got == want, (got, want)


def test_sharded_executor_refuses_what_it_cannot_split():
    from repro_torch.models.api import get_model
    from repro_torch.serve.kvcache import PagedKVConfig
    from repro_torch.serve.scheduler import ShardedModelExecutor

    cfg = _shard_cfg()
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    pc = PagedKVConfig.for_model(cfg, n_pages=6, page_size=4)
    kw = dict(kv_fmt=FP8_152, device="cpu")
    with pytest.raises(ValueError, match="cannot split n_heads"):
        ShardedModelExecutor(model, params, pc, dist=D.Dist(rank=0, size=3),
                             **kw)
    with pytest.raises(ValueError, match="unknown logit_wire"):
        ShardedModelExecutor(model, params, pc,
                             dist=D.Dist(rank=0, size=2, logit_wire="fp8"),
                             **kw)
    ex = ShardedModelExecutor(model, params, pc, dist=D.Dist(rank=1, size=2),
                              **kw)
    assert ex.kv["k"].shape[2] == cfg.n_kv_heads // 2
    assert torch.equal(ex.params["layers"]["attn"]["wq"],
                       params["layers"]["attn"]["wq"][..., 64:])


def test_launcher_serve_mesh_on_cpu():
    """``launch/serve.py --serve-mesh 2 --device cpu``: two gloo ranks
    spawned by the launcher serve the smoke model; its streams equal the
    single-device engine's under the same (``tp_shards=2``) plan; the int8
    wire also serves."""
    from repro_torch.launch import serve as S
    from repro_torch.serve.plan import plan_attention

    argv = ["--smoke", "--policy", "predicted", "--chunk", "16",
            "--device", "cpu", "--prompt-lens", "5,12", "--gen", "4",
            "--page-size", "4"]
    out = S.main(argv + ["--serve-mesh", "2"])
    args = S.parse_args(argv)
    eng, prompts, _ = S.build(args)
    eng.plan = plan_attention(eng.pc.tokens_capacity, 4, tp_shards=2)
    rids = [eng.submit(p, args.gen) for p in prompts]
    res = eng.run()
    assert [out["results"][i] for i in range(len(rids))] == \
        [res[r] for r in rids]
    wire = S.main(argv + ["--serve-mesh", "2", "--logit-wire", "int8"])
    assert all(len(t) == 4 for t in wire["results"].values())
