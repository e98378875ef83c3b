"""Port vs JAX package: elementwise numerics, codes, page exponents, plans.

Everything here is integer or elementwise float code, so the port must
match the JAX package bit for bit on every input.
"""

from __future__ import annotations

import ast
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common import quantize_block as jax_quantize
from repro.quant.qtensor import pack_block as jax_pack, unpack_block as jax_unpack
from repro.serve import kvcache as JKV
from repro_torch.kernels.common import quantize_block
from repro_torch.quant.formats import FPFormat
from repro_torch.quant.qtensor import pack_block, unpack_block
from repro_torch.serve import kvcache as TKV

REPO = Path(__file__).resolve().parents[1]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


# --------------------------------------------------------------------------
# import guard
# --------------------------------------------------------------------------


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"


# --------------------------------------------------------------------------
# (1, e, m) quantizer
# --------------------------------------------------------------------------


def _special_values(e: int, m: int) -> np.ndarray:
    fmt = FPFormat(e, m)
    ulp = 2.0 ** (-m)
    vals = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-39, -3e-39,
            fmt.max_value, -fmt.max_value, fmt.max_value * 1.01,
            fmt.min_normal, fmt.min_normal * (1 - 2 ** -24),
            fmt.min_normal * 0.5, np.finfo(np.float32).max]
    # RNE ties: halfway between neighbours, even and odd lower neighbour
    for k in range(-3, 4):
        for mant in range(4):
            base = (1.0 + mant * ulp) * 2.0 ** k
            vals += [base + 0.5 * ulp * 2.0 ** k, -(base + 0.5 * ulp * 2.0 ** k)]
    return np.array(vals, np.float32)


@pytest.mark.parametrize("e,m", [(5, 2), (6, 5), (6, 9)])
def test_quantize_block_bitwise(e, m):
    rng = np.random.RandomState(100 + e * 16 + m)
    rand_bits = rng.randint(0, 2 ** 32, size=200_000, dtype=np.uint64)
    x = np.concatenate([rand_bits.astype(np.uint32).view(np.float32),
                        _special_values(e, m),
                        (rng.randn(20_000) * 4).astype(np.float32)])
    want = np.asarray(jax_quantize(jnp.asarray(x), e, m))
    got = quantize_block(torch.from_numpy(x), e, m).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_pad2d_matches_jax():
    from repro.kernels.common import pad2d as jax_pad2d
    from repro_torch.kernels.common import pad2d

    x = np.random.RandomState(4).randn(37, 75).astype(np.float32)
    want = np.asarray(jax_pad2d(jnp.asarray(x), 16, 64))
    got = pad2d(torch.from_numpy(x), 16, 64).numpy()
    assert got.shape == want.shape == (48, 128)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_pack_unpack_all_codes_bitwise():
    codes = np.arange(-128, 128, dtype=np.int8)
    want = np.asarray(jax_unpack(jnp.asarray(codes), 5, 2))
    got = unpack_block(torch.from_numpy(codes), 5, 2).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        pack_block(torch.from_numpy(want.copy()), 5, 2).numpy(),
        np.asarray(jax_pack(jnp.asarray(want), 5, 2)))
    # and on values that are not yet (1,5,2) points, incl. non-finite ones
    x = np.concatenate([np.random.RandomState(3).randn(5000).astype(np.float32),
                        np.array([np.inf, -np.inf, np.nan, -0.0], np.float32)])
    np.testing.assert_array_equal(
        pack_block(torch.from_numpy(x), 5, 2).numpy(),
        np.asarray(jax_pack(jnp.asarray(x), 5, 2)))


# --------------------------------------------------------------------------
# KV cache: page exponents and codes
# --------------------------------------------------------------------------


def test_scale_exp_matches_jax_next_to_powers_of_two():
    vals = []
    for k in range(-126, 128):
        for f in (1 - 2.0 ** -24, 1.0, 1 + 2.0 ** -23):
            vals.append(np.ldexp(f, k))
    x = np.array(vals, np.float64).astype(np.float32)
    x = np.concatenate([x[np.isfinite(x)], np.array([0.0, 1e-42, 1.1754942e-38], np.float32),
                        np.abs(np.random.RandomState(5).randn(10_000)
                               ).astype(np.float32)])
    want = np.asarray(JKV._scale_exp(jnp.asarray(x)))
    got = TKV._scale_exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _arena_pair(n_pages=6, kv=2, ps=4, dh=8):
    z = np.zeros((n_pages, kv, ps, dh), np.int8)
    se = np.zeros((n_pages,), np.int32)
    return z, se


def test_write_prompt_and_append_token_codes_bitwise():
    fmt_t, fmt_j = FPFormat(5, 2), JKV.FPFormat(5, 2)
    rng = np.random.RandomState(11)
    arena, se = _arena_pair()
    # a 7-token prompt over pages [3, 1] (ragged tail), magnitudes spread
    # over several page exponents
    x = (rng.randn(7, 2, 8) * np.array([0.3, 5.0])[:, None]).astype(np.float32)
    pages = np.array([3, 1], np.int32)
    ja, jse, _ = JKV.write_prompt(jnp.asarray(arena), jnp.asarray(se),
                                  jnp.asarray(x), jnp.asarray(pages), fmt_j)
    ta, tse = torch.from_numpy(arena.copy()), torch.from_numpy(se.copy())
    TKV.write_prompt(ta, tse, torch.from_numpy(x), torch.from_numpy(pages).long(),
                     fmt_t)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tse.numpy(), np.asarray(jse))
    # decode appends: slot 3 of page 1 (scale kept) and slot 0 of page 4
    # (scale fixed by this write), a padded row on the null page
    tok = (rng.randn(3, 2, 8) * 2).astype(np.float32)
    page_id = np.array([1, 4, 0], np.int32)
    slot = np.array([3, 0, 0], np.int32)
    ja, jse = JKV.append_token(ja, jse, jnp.asarray(tok), jnp.asarray(page_id),
                               jnp.asarray(slot), fmt_j)
    TKV.append_token(ta, tse, torch.from_numpy(tok),
                     torch.from_numpy(page_id).long(),
                     torch.from_numpy(slot).long(), fmt_t)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tse.numpy(), np.asarray(jse))


def test_swap_roundtrip_byte_identical_and_pool_invariants():
    pc = TKV.PagedKVConfig(n_layers=2, n_kv_heads=2, head_dim=8, n_pages=6,
                           page_size=4)
    kv = TKV.init_arena(pc, "cpu")
    g = torch.Generator().manual_seed(0)
    for name in ("k", "v"):
        kv[name].copy_(torch.randint(-128, 128, kv[name].shape, generator=g,
                                     dtype=torch.int8))
    for name in ("k_se", "v_se"):
        kv[name].copy_(torch.randint(-9, 9, kv[name].shape, generator=g,
                                     dtype=torch.int32))
    before = {k: v.clone() for k, v in kv.items()}
    blob = TKV.swap_out_pages(kv, [2, 5])
    store = TKV.SwapStore()
    store.put(7, blob, 6)
    assert store.bytes_used == sum(a.nbytes for a in blob.values())
    got, n_tok = store.take(7)
    assert n_tok == 6
    TKV.swap_in_pages(kv, [4, 1], got)
    for name in kv:
        torch.testing.assert_close(kv[name][:, [4, 1]], before[name][:, [2, 5]],
                                   rtol=0, atol=0)
    pool = TKV.PagePool(6, 4)
    pool.allocate(0, 5)
    pool.extend(0, 4)
    pool.allocate(1, 1)
    pool.check_invariants()
    assert pool.free_pages == 1  # 5 usable pages: 3 + 1 held
    pool.release(0)
    pool.check_invariants()
    assert pool.free_pages == 4
    assert TKV.kv_bytes_per_token(pc) == 2 * (2 * 2 * 8 + 2 * 4 / 4)


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------


def _prec(p):
    return None if p is None else (p.m_acc, p.e_acc, p.chunk)


def _fmt(f):
    return None if f is None else (f.e, f.m)


@pytest.mark.parametrize("mode", ["exact", "predicted", "perturbed"])
def test_plan_for_model_matches_jax(mode):
    """Every role of every GEMM type gets the JAX plan's format; the
    perturbed mode (the paper's PP sweep) at every PP in -4..+4, including
    the clamps at 1 and at the f32 carrier's 23 bits."""
    from repro.configs import get_config as jget
    from repro.core.policy import AccumulationPolicy as JPol
    from repro.core.policy import plan_for_model as jplan
    from repro_torch.configs import get_config as tget
    from repro_torch.core.policy import AccumulationPolicy as TPol
    from repro_torch.core.policy import plan_for_model as tplan

    for pp in (range(-4, 5) if mode == "perturbed" else (0,)):
        jq = jplan(jget("qwen2-1.5b"), seq_len=416, global_batch=8,
                   policy=JPol(mode=mode, chunk=64, perturbation=pp)).quant
        tq = tplan(tget("qwen2-1.5b"), seq_len=416, global_batch=8,
                   policy=TPol(mode=mode, chunk=64, perturbation=pp)).quant
        for name in ("attn_qkv", "attn_out", "mlp_up", "mlp_down", "lm_head"):
            j, t = getattr(jq, name), getattr(tq, name)
            if j is None:
                assert t is None, name
                continue
            assert [_prec(getattr(t, r)) for r in ("fwd", "bwd", "grad")] == \
                [_prec(getattr(j, r)) for r in ("fwd", "bwd", "grad")], \
                (name, pp)
            assert _fmt(t.repr_fmt) == _fmt(j.repr_fmt), name
            assert _fmt(t.out_fmt) == _fmt(j.out_fmt), name
        if mode == "perturbed":
            base = TPol(mode="predicted", chunk=64).for_length(1536).m_acc
            assert tq.attn_qkv.fwd.m_acc == max(base + pp, 1)
    if mode == "predicted":
        # the paper's subject: (1,6,5) carries on the attention/MLP GEMMs
        assert _prec(tq.attn_qkv.fwd) == (5, 6, 64)
        assert _prec(tq.lm_head.fwd) == (9, 6, 64)
    for pp, want in ((-40, 1), (40, TPol.M_ACC_CARRIER)):
        pol = TPol(mode="perturbed", chunk=64, perturbation=pp)
        assert pol.for_length(1536).m_acc == want
        assert JPol(mode="perturbed", chunk=64,
                    perturbation=pp).for_length(1536).m_acc == want


@pytest.mark.parametrize("chunk", [None, 64])
@pytest.mark.parametrize("capacity", [128, 2400])
def test_plan_attention_matches_jax(capacity, chunk):
    from repro.serve.plan import plan_attention as jplan
    from repro_torch.serve.plan import plan_attention as tplan

    j = jplan(capacity, 16, prefill_chunk_tokens=chunk)
    t = tplan(capacity, 16, prefill_chunk_tokens=chunk)
    assert [(b.max_ctx, b.e_acc, b.m_acc, b.resumptions) for b in t.buckets] \
        == [(b.max_ctx, b.e_acc, b.m_acc, b.resumptions) for b in j.buckets]
    assert (t.page_size, t.m_p, t.prefill_chunk, t.v_hint) == \
        (j.page_size, j.m_p, j.prefill_chunk, j.v_hint)
    jc = j.kernel_call(len(j.buckets) - 1, h=12, dh=128, kv_fmt=(5, 2))
    tc = t.kernel_call(len(t.buckets) - 1, kv_fmt=(5, 2))
    assert (tc.acc, tc.kv_fmt, tc.max_pages) == \
        (jc.acc, jc.kv_fmt, jc.max_pages)


def test_vrr_solver_matches_jax():
    import importlib

    JP = importlib.import_module("repro.core.precision")
    JV = importlib.import_module("repro.core.vrr")
    from repro_torch.core import precision as TP
    from repro_torch.core import vrr as TV

    for m_acc, m_p, n in [(5, 5, 64), (9, 5, 1536), (6, 5, 24), (12, 5, 30000)]:
        assert TV.vrr(m_acc, m_p, n) == JV.vrr(m_acc, m_p, n)
        assert TV.vrr_chunked(m_acc, m_p, 64, n) == JV.vrr_chunked(m_acc, m_p, 64, n)
    for n in (64, 1536, 8960, 3328):
        for chunked in (False, True):
            assert TP.min_m_acc(n, 5, chunked=chunked) == \
                JP.min_m_acc(n, 5, chunked=chunked)
