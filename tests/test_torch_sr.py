"""Port vs JAX package: stochastic-rounding (SR) carries.

(a) K1's SR helpers, ``threefry2x32``, ``sr_random_bits`` and
    ``quantize_block_sr`` (and ``carry_update`` in both modes), against the
    JAX functions, bitwise, on hypothesis-drawn inputs with NaN, +-inf,
    subnormals, saturating values and exact formats among them.
(b) The plain versions of E and K8 (``qmatmul_fused`` with
    ``return_quantized``/``collect_stats``) and of B and K9
    (``qmatmul_bwd_pair``) under SR against the JAX Pallas kernels in
    interpret mode: bitwise on lattice operands (every f32 order of an
    intra-chunk sum is exact), within 1 ulp of the carry format on random
    ones (ROADMAP F0; measured: bitwise), the stats rows within
    ``test_torch_telemetry``'s bound.
(c) ``sr_role_seed`` and the autograd ``qdot`` under SR against the JAX
    ``qdot`` (``jax.vjp``), with ``tests/test_torch_train.py``'s bounds.
(d) The port's counterparts of ``tests/test_sr_stats.py`` (its tests that do
    not touch attention) and ``tests/test_below_knee.py``: determinism,
    seed sensitivity, invariance to the tile schedule, dx/dw equal to the
    fused calls, the stats epilogue neutral, the ensemble mean unbiased
    (``slow``, as JAX marks it), the below-the-knee regression (``slow``),
    the SR-aware knee test and the controller's attribution.
(e) The launcher under ``--rounding sr`` on the CPU, and two steps of the
    smoke model against a JAX child process fed the same weights and tokens
    (``--xla_allow_excess_precision=false``, ROADMAP F2), with
    ``tests/test_torch_train.py``'s bounds (F4).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import GEMMPrecision as JGP
from repro.kernels import common as JC
from repro.kernels.bwd_pair import qmatmul_bwd_pair as jax_pair
from repro.kernels.fused import qmatmul_fused as jax_qmatmul
from repro.kernels.ops import QDotConfig as JQC
from repro.kernels.ops import qdot as jax_qdot
from repro.kernels.ops import sr_role_seed as jax_role_seed
from repro.quant.formats import FP8_152 as JFP8
from repro_torch.core.policy import AccumulationPolicy, GEMMPrecision
from repro_torch.kernels import common as TC
from repro_torch.kernels.bwd_pair import (
    qmatmul_bwd_pair,
    qmatmul_bwd_pair_nsplit,
)
from repro_torch.kernels.common import N_STATS
from repro_torch.kernels.fused import (
    chunked_gemm_reference,
    qmatmul_fused,
)
from repro_torch.kernels.ops import QDotConfig, qdot, sr_role_seed
from repro_torch.quant.formats import FP8_152
from repro_torch.quant.qtensor import unpack_block
from test_torch_telemetry import REL_BITWISE, _check_jax_row
from test_torch_train import _bits, _check, _lattice, _np, _operands

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACC = (6, 5)        # narrow enough that carry rounding shows everywhere
SR_SEED = 7
M32 = 0xFFFFFFFF


def _i64(x) -> np.ndarray:
    """JAX uint32 words as int64 (the port's carrier)."""
    return np.asarray(x).astype(np.int64)


def _hyp():
    pytest.importorskip("hypothesis", reason="needs `pip install -e .[test]`")
    from hypothesis import given, settings, strategies as st
    return given, settings, st


# --------------------------------------------------------------------------
# (a) K1's SR helpers
# --------------------------------------------------------------------------


def test_threefry2x32_matches_jax():
    given, settings, st = _hyp()
    u32 = st.integers(min_value=0, max_value=M32)

    @settings(max_examples=40, deadline=None)
    @given(u32, u32, st.lists(u32, min_size=1, max_size=48), u32)
    def prop(k0, k1, c0, c1):
        c0 = np.array(c0 + [0, M32], np.uint64)
        j0, j1 = JC.threefry2x32(jnp.uint32(k0), jnp.uint32(k1),
                                 jnp.asarray(c0.astype(np.uint32)),
                                 jnp.uint32(c1))
        t0, t1 = TC.threefry2x32(k0, k1, torch.from_numpy(c0.astype(np.int64)),
                                 c1)
        np.testing.assert_array_equal(t0.numpy(), _i64(j0))
        np.testing.assert_array_equal(t1.numpy(), _i64(j1))
        # python ints: the scalar path sr_role_seed takes
        s0, s1 = TC.threefry2x32(k0, k1, int(c0[0]), c1)
        assert (s0, s1) == (int(_i64(j0)[0]), int(_i64(j1)[0]))

    prop()


def test_sr_random_bits_matches_jax():
    """The dither keyed on (seed, step, row * n_cols + col), the product
    wrapping mod 2^32 (rows and columns far from the origin)."""
    given, settings, st = _hyp()

    @settings(max_examples=30, deadline=None)
    @given(st.integers(0, M32), st.integers(0, M32),
           st.integers(0, 2 ** 31 - 64), st.integers(0, 2 ** 31 - 64),
           st.integers(1, 2 ** 31 - 1), st.integers(1, 9),
           st.integers(1, 17))
    def prop(seed, step, row0, col0, n_cols, r, c):
        rows = row0 + np.arange(r, dtype=np.int64)[:, None]
        cols = col0 + np.arange(c, dtype=np.int64)[None, :]
        want = JC.sr_random_bits(jnp.uint32(seed), jnp.uint32(step),
                                 jnp.asarray(rows.astype(np.int32)),
                                 jnp.asarray(cols.astype(np.int32)), n_cols)
        got = TC.sr_random_bits(seed, step, torch.from_numpy(rows),
                                torch.from_numpy(cols), n_cols)
        np.testing.assert_array_equal(got.numpy(), _i64(want))

    prop()


def _specials(e: int, m: int) -> np.ndarray:
    max_v = 2.0 ** (2 ** (e - 1) - 1) * (2.0 - 2.0 ** (-m))
    min_n = 2.0 ** -(2 ** (e - 1) - 1)
    vals = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45, -1e-45,
            1e-39, -3e-39, max_v, -max_v, max_v * 1.01, min_n,
            min_n * (1 - 2 ** -24), min_n * 0.5, 1.0 - 2 ** -24,
            np.finfo(np.float32).max, -np.finfo(np.float32).max]
    return np.array(vals, np.float32)


# e = 8 with m < 23 puts min_normal below f32's normals, where XLA:CPU
# flushes the comparison's operand (ROADMAP F3): held to e <= 7 there
SR_FORMATS = [(5, 2), (6, 5), (6, 9), (7, 7), (6, 23), (8, 23)]


@pytest.mark.parametrize("e,m", SR_FORMATS)
def test_quantize_block_sr_matches_jax(e, m):
    """Random bit patterns (every float class) and the specials, each with
    drawn dither bits and with the extremes 0 and 2^32 - 1; (6, 23) drops
    no mantissa bit and (8, 23) is exact (the identity)."""
    given, settings, st = _hyp()

    @settings(max_examples=12, deadline=None)
    @given(st.integers(0, 2 ** 31 - 1))
    def prop(seed):
        rng = np.random.RandomState(seed)
        x = np.concatenate([
            rng.randint(0, 2 ** 32, 4000, dtype=np.uint64).astype(
                np.uint32).view(np.float32),
            (rng.randn(2000) * 4).astype(np.float32), _specials(e, m)])
        bits = rng.randint(0, 2 ** 32, x.size, dtype=np.uint64)
        bits[:64] = 0
        bits[64:128] = M32
        want = JC.quantize_block_sr(jnp.asarray(x), e, m,
                                    jnp.asarray(bits.astype(np.uint32)))
        got = TC.quantize_block_sr(torch.from_numpy(x), e, m,
                                   torch.from_numpy(bits.astype(np.int64)))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))

    prop()


@pytest.mark.parametrize("rounding", ["rne", "sr"])
def test_carry_update_matches_jax(rounding):
    """``carry_update`` of a tile at a logical origin, both modes; RNE is
    the plain quantize of prev + partial."""
    rng = np.random.RandomState(3)
    prev = rng.standard_normal((8, 16)).astype(np.float32)
    part = rng.standard_normal((8, 16)).astype(np.float32)
    seed = jnp.asarray([[SR_SEED]], jnp.uint32)
    want = JC.carry_update(jnp.asarray(prev), jnp.asarray(part),
                           e_acc=ACC[0], m_acc=ACC[1], rounding=rounding,
                           seed_ref=seed, step=5, row0=24, col0=48,
                           n_cols=80)
    got = TC.carry_update(torch.from_numpy(prev), torch.from_numpy(part),
                          e_acc=ACC[0], m_acc=ACC[1], rounding=rounding,
                          seed=SR_SEED, step=5, row0=24, col0=48, n_cols=80)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if rounding == "rne":
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(
            TC.quantize_block(torch.from_numpy(prev + part), *ACC).numpy()))


def test_sr_role_seed_matches_jax():
    for seed in (0, 1, SR_SEED, 2 ** 31 + 5, M32, -3):
        for role in ("fwd", "bwd", "grad"):
            want = int(np.asarray(jax_role_seed(jnp.uint32(seed & M32),
                                                role)))
            assert sr_role_seed(seed, role) == want


# --------------------------------------------------------------------------
# (b) the plain SR E, K8, B and K9 against JAX (interpret mode)
# --------------------------------------------------------------------------

E_CASES = [
    # (T, K, N, chunk, acc, bf16 weights)
    (37, 200, 75, 64, (6, 5), False),
    (64, 96, 130, 16, (6, 5), True),
]


@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize("t,k,n,chunk,acc,w_bf16", E_CASES)
def test_sr_emitq_and_stats_match_jax(t, k, n, chunk, acc, w_bf16, lattice):
    """E and K8 under SR: C (and E's codes) bitwise JAX's kernels, K8's C
    bitwise E's, K8's row within the bound."""
    rng = np.random.RandomState(t + k + n + lattice)
    x = _operands(rng, (t, k), lattice)
    w = _operands(rng, (k, n), lattice, 1 / np.sqrt(k))
    wt = torch.from_numpy(w)
    if w_bf16:
        wt = wt.to(torch.bfloat16)
        w = wt.float().numpy()
    kw = dict(e_acc=acc[0], m_acc=acc[1], block_k=chunk, rounding="sr",
              sr_seed=SR_SEED)
    jy, jxq, jwq = jax_qmatmul(jnp.asarray(x), jnp.asarray(w), repr_fmt=JFP8,
                               return_quantized=True, pack_residuals=True,
                               **kw)
    y, xq, wq = qmatmul_fused(torch.from_numpy(x), wt, repr_fmt=FP8_152,
                              return_quantized=True, **kw)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    _check(f"SR E {t}x{k}x{n}", y.numpy(), np.asarray(jy), acc, lattice)
    jc, jrow = jax_qmatmul(jnp.asarray(x), jnp.asarray(w), repr_fmt=JFP8,
                           collect_stats=True, **kw)
    c, row = qmatmul_fused(torch.from_numpy(x), wt, repr_fmt=FP8_152,
                           collect_stats=True, **kw)
    np.testing.assert_array_equal(_bits(c.numpy()), _bits(y.numpy()))
    _check(f"SR K8 {t}x{k}x{n}", c.numpy(), np.asarray(jc), acc, lattice)
    _check_jax_row(f"SR K8 row {t}x{k}x{n}", row.numpy(), np.asarray(jrow),
                   REL_BITWISE if lattice else 2.0 ** (2 - acc[1]))


B_CASES = [
    # (T, K, N, grad_chunk, bwd_chunk, bwd_acc, grad_acc)
    (40, 72, 150, 16, 64, (6, 5), (6, 5)),
    (64, 130, 96, 64, 16, (6, 5), (6, 7)),
]


@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize("t,k,n,gc,bc,bwd_acc,grad_acc", B_CASES)
def test_sr_bwd_pair_and_stats_match_jax(t, k, n, gc, bc, bwd_acc, grad_acc,
                                         lattice):
    """B and K9 under SR on E's codes: dx and dw bitwise JAX's pair kernel
    (separate seeds for the two carries), K9's dx/dw bitwise B's, its rows
    within the bound."""
    rng = np.random.RandomState(t + 3 * k + n + lattice)
    g = _operands(rng, (t, n), lattice)
    x = _operands(rng, (t, k), lattice)
    w = _operands(rng, (k, n), lattice, 1 / np.sqrt(k))
    _, xq, wq = qmatmul_fused(torch.from_numpy(x), torch.from_numpy(w),
                              repr_fmt=FP8_152, return_quantized=True)
    sb, sg = SR_SEED + 101, SR_SEED + 202
    jkw = dict(repr_fmt=JFP8, bwd_acc=bwd_acc, grad_acc=grad_acc,
               block_t=gc, block_k=32, block_n=bc, packed=True,
               rounding="sr", sr_seed_bwd=sb, sr_seed_grad=sg)
    tkw = dict(repr_fmt=FP8_152, bwd_acc=bwd_acc, grad_acc=grad_acc,
               bwd_chunk=bc, grad_chunk=gc, packed=True, rounding="sr",
               sr_seed_bwd=sb, sr_seed_grad=sg)
    jg, jx, jw = jnp.asarray(g), jnp.asarray(xq.numpy()), jnp.asarray(
        wq.numpy())
    jdx, jdw = jax_pair(jg, jx, jw, **jkw)
    dx, dw = qmatmul_bwd_pair(torch.from_numpy(g), xq, wq, **tkw)
    _check(f"SR B dx {t}x{k}x{n}", dx.numpy(), np.asarray(jdx), bwd_acc,
           lattice)
    _check(f"SR B dw {t}x{k}x{n}", dw.numpy(), np.asarray(jdw), grad_acc,
           lattice)
    jsdx, jsdw, jrows = jax_pair(jg, jx, jw, collect_stats=True, **jkw)
    sdx, sdw, rows = qmatmul_bwd_pair(torch.from_numpy(g), xq, wq,
                                      collect_stats=True, **tkw)
    np.testing.assert_array_equal(_bits(sdx.numpy()), _bits(dx.numpy()))
    np.testing.assert_array_equal(_bits(sdw.numpy()), _bits(dw.numpy()))
    rel = REL_BITWISE if lattice else 2.0 ** (2 - min(bwd_acc[1],
                                                      grad_acc[1]))
    _check_jax_row(f"SR K9 rows {t}x{k}x{n}", rows.numpy(),
                   np.asarray(jrows), rel)


# --------------------------------------------------------------------------
# (c) qdot under SR
# --------------------------------------------------------------------------


def _sr_plan(seed=SR_SEED):
    p = (GEMMPrecision(m_acc=5, chunk=16), JGP(m_acc=5, chunk=16))
    return (QDotConfig(fwd=p[0], bwd=p[0], grad=p[0], repr_fmt=FP8_152,
                       rounding="sr", sr_seed=seed),
            JQC(fwd=p[1], bwd=p[1], grad=p[1], repr_fmt=JFP8,
                rounding="sr", sr_seed=seed))


@pytest.mark.parametrize("lattice", [True, False])
def test_qdot_sr_autograd_matches_jax_vjp(lattice):
    """y, dx and dw of the port's ``qdot`` under SR against ``jax.vjp`` of
    the JAX ``qdot``, bf16 weights handed over as ``dense`` does: bitwise
    on lattice operands, within 1 ulp of the carry on random ones (as
    ``test_qdot_autograd_matches_jax_vjp``)."""
    tcfg, jcfg = _sr_plan()
    rng = np.random.RandomState(11 + lattice)
    x = _operands(rng, (2, 24, 80), lattice)
    w = _operands(rng, (80, 48), lattice, 1 / 9)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    g = _operands(rng, (2, 24, 48), lattice)
    jy, vjp = jax.vjp(lambda a, b: jax_qdot(a, b.astype(jnp.float32), jcfg),
                      jnp.asarray(x), jnp.asarray(wt.float().numpy()
                                                  ).astype(jnp.bfloat16))
    jdx, jdw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wl = wt.clone().requires_grad_()
    y = qdot(xt, wl, tcfg)
    y.backward(torch.from_numpy(g))
    for label, got, want in (("y", y, jy), ("dx", xt.grad, jdx),
                             ("dw", wl.grad, jdw)):
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        _check(f"SR qdot {label}", _np(got), want, ACC, lattice)


def _fused_operands(seed=0, t=96, k=160, n=80):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)))


def test_qdot_sr_matches_direct_fused_call():
    """qdot's per-role seed is the documented contract: its forward is
    the fused GEMM at ``sr_role_seed(seed, "fwd")``; ``sr_seed=`` overrides
    the config's seed for one call."""
    x, w = _fused_operands(2, 64, 128, 48)
    prec = GEMMPrecision(m_acc=ACC[1], e_acc=ACC[0], chunk=32)
    cfg = QDotConfig(fwd=prec, repr_fmt=FP8_152, rounding="sr",
                     sr_seed=SR_SEED)
    kw = dict(repr_fmt=FP8_152, e_acc=ACC[0], m_acc=ACC[1], block_k=32,
              rounding="sr")
    direct = qmatmul_fused(x, w, sr_seed=sr_role_seed(SR_SEED, "fwd"), **kw)
    assert torch.equal(qdot(x, w, cfg), direct)
    other = QDotConfig(fwd=prec, repr_fmt=FP8_152, rounding="sr",
                       sr_seed=SR_SEED + 1)
    assert torch.equal(qdot(x, w, other, sr_seed=SR_SEED), direct)
    assert not torch.equal(qdot(x, w, cfg, sr_seed=SR_SEED + 1), direct)


def test_qdot_sr_requires_fused():
    x, w = _fused_operands(2, 32, 64, 32)
    prec = GEMMPrecision(m_acc=ACC[1], e_acc=ACC[0], chunk=32)
    cfg = QDotConfig(fwd=prec, repr_fmt=FP8_152, rounding="sr", fused=False)
    with pytest.raises(ValueError):
        qdot(x, w, cfg)
    with pytest.raises(ValueError):
        QDotConfig(fwd=prec, rounding="nearest")


def test_qdot_rne_default_parity_with_grads():
    """An explicit RNE config with a seed is the default config, bitwise,
    forward and both gradients."""
    x, w = _fused_operands(1, 64, 128, 48)
    prec = GEMMPrecision(m_acc=ACC[1], e_acc=ACC[0], chunk=32)
    base = QDotConfig(fwd=prec, bwd=prec, grad=prec, repr_fmt=FP8_152)
    expl = QDotConfig(fwd=prec, bwd=prec, grad=prec, repr_fmt=FP8_152,
                      rounding="rne", sr_seed=99)
    outs = []
    for cfg in (base, expl):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = qdot(xx, ww, cfg)
        (y ** 2).sum().backward()
        outs.append((y.detach(), xx.grad, ww.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# (d) the SR contract (tests/test_sr_stats.py, tests/test_below_knee.py)
# --------------------------------------------------------------------------

def _kw(**extra):
    return dict(repr_fmt=FP8_152, e_acc=ACC[0], m_acc=ACC[1], block_k=32,
                **extra)


def test_rne_explicit_is_default_bitwise():
    x, w = _fused_operands()
    assert torch.equal(qmatmul_fused(x, w, **_kw()),
                       qmatmul_fused(x, w, rounding="rne", sr_seed=123,
                                     **_kw()))


def test_invalid_rounding_rejected():
    x, w = _fused_operands()
    with pytest.raises(ValueError):
        qmatmul_fused(x, w, e_acc=6, m_acc=5, rounding="nearest")
    g = torch.zeros((x.shape[0], w.shape[1]))
    with pytest.raises(ValueError):
        qmatmul_bwd_pair(g, x, w, repr_fmt=None, packed=False,
                         rounding="nearest")


def test_sr_deterministic_and_seed_sensitive():
    x, w = _fused_operands()
    kw = _kw(rounding="sr")
    y1 = qmatmul_fused(x, w, sr_seed=SR_SEED, **kw)
    y2 = qmatmul_fused(x, w, sr_seed=SR_SEED, **kw)
    y3 = qmatmul_fused(x, w, sr_seed=SR_SEED + 1, **kw)
    assert torch.equal(y1, y2)
    assert not torch.equal(y1, y3)
    assert not torch.equal(y1, qmatmul_fused(x, w, **_kw()))
    # the seed is taken mod 2^32, as the JAX package's uint32 cast
    assert torch.equal(y1, qmatmul_fused(x, w, sr_seed=SR_SEED + 2 ** 32,
                                         **kw))


@pytest.mark.parametrize("tile", [(16, 16), (32, 48), (64, 64)])
def test_sr_invariant_to_tile_schedule(tile):
    """The dither keys on logical coordinates, not the schedule: the
    product computed tile by tile (``carry_update`` at each tile's origin,
    the Hopper tile's decomposition) is the whole-output plain version,
    bitwise, for any tile shape; JAX's block decompositions agree with
    it."""
    x, w = _fused_operands()
    q = lambda v: TC.quantize_block(v, 5, 2)  # noqa: E731
    xq, wq = q(x), q(w)
    want = qmatmul_fused(x, w, **_kw(rounding="sr", sr_seed=SR_SEED))
    m, k = xq.shape
    n = wq.shape[1]
    got = torch.empty((m, n))
    bm, bn = tile
    for r0 in range(0, m, bm):
        for c0 in range(0, n, bn):
            a, b = xq[r0:r0 + bm], wq[:, c0:c0 + bn]
            carry = torch.zeros((a.shape[0], b.shape[1]))
            for s, k0 in enumerate(range(0, k, 32)):
                part = chunked_gemm_reference(a[:, k0:k0 + 32],
                                              b[k0:k0 + 32], e_acc=8,
                                              m_acc=23, block_k=32)
                carry = TC.carry_update(carry, part, e_acc=ACC[0],
                                        m_acc=ACC[1], rounding="sr",
                                        seed=SR_SEED, step=s, row0=r0,
                                        col0=c0, n_cols=n)
            got[r0:r0 + bm, c0:c0 + bn] = carry
    assert torch.equal(got, want)
    jy = jax_qmatmul(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                     repr_fmt=JFP8, e_acc=ACC[0], m_acc=ACC[1], block_k=32,
                     block_m=bm if bm % 8 == 0 else 16, block_n=128,
                     rounding="sr", sr_seed=SR_SEED)
    _check(f"SR tiles {tile} vs JAX", got.numpy(), np.asarray(jy), ACC,
           False)


def test_sr_backward_pair_matches_fused_gemms():
    """One seed, three kernels: the pair's dx and dw carries draw the
    dither the standalone fused GEMMs draw at those coordinates (K8's, G's
    and E's plain versions)."""
    x, w = _fused_operands()
    g = torch.from_numpy(np.random.RandomState(9).standard_normal(
        (x.shape[0], w.shape[1])).astype(np.float32))
    q = lambda v: TC.quantize_block(v, 5, 2)  # noqa: E731
    xq, wq = q(x), q(w)
    sb, sg = SR_SEED + 101, SR_SEED + 202
    dx, dw = qmatmul_bwd_pair(g, xq, wq, repr_fmt=FP8_152, bwd_acc=ACC,
                              grad_acc=ACC, bwd_chunk=32, grad_chunk=32,
                              packed=False, rounding="sr", sr_seed_bwd=sb,
                              sr_seed_grad=sg)
    gq = q(g)
    kw = dict(e_acc=ACC[0], m_acc=ACC[1], block_k=32, rounding="sr")
    assert torch.equal(dx, qmatmul_fused(gq, wq.T, sr_seed=sb, **kw))
    assert torch.equal(dw, qmatmul_fused(xq.T, gq, sr_seed=sg, **kw))
    c8, _ = qmatmul_fused(gq, wq.T, sr_seed=sb, collect_stats=True,
                          quantize_a=False, quantize_b=False, **kw)
    assert torch.equal(dx, c8)
    ce, _, _ = qmatmul_fused(g, wq.T, sr_seed=sb, return_quantized=True,
                             repr_fmt=FP8_152, **kw)
    assert torch.equal(dx, ce)


def test_sr_carry_entry_raises():
    """The dx carry-in entry (K7) under SR keys its dither on the unsplit
    call's N chunks and dw columns (``n_offset`` of ``n_total``, JAX's
    ``step_off``/``col_off``/``n_total``): an offset off the ``bwd_chunk``
    grid raises, as does a segment past ``n_total`` or on the stats pair;
    the N-split pair under SR is bitwise the unsplit SR pair at 2 and 3
    segments, and a segment keyed as if it were the whole call draws
    other bits."""
    x, w = _fused_operands(t=32, k=40, n=96)
    g = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (32, 96)).astype(np.float32))
    kw = dict(repr_fmt=None, packed=False, bwd_chunk=32, grad_chunk=32,
              bwd_acc=ACC, grad_acc=ACC, rounding="sr",
              sr_seed_bwd=SR_SEED + 1, sr_seed_grad=SR_SEED + 2)
    carry = torch.zeros((32, 40))
    with pytest.raises(ValueError, match="multiple of bwd_chunk"):
        qmatmul_bwd_pair(g[:, 16:], x, w[:, 16:], dx_carry=carry,
                         n_offset=16, n_total=96, **kw)
    with pytest.raises(ValueError, match="n_total"):
        qmatmul_bwd_pair(g[:, 32:], x, w[:, 32:], dx_carry=carry,
                         n_offset=32, n_total=64, **kw)
    with pytest.raises(ValueError, match="segment"):
        qmatmul_bwd_pair(g, x, w, collect_stats=True, n_offset=32, **kw)
    dx, dw = qmatmul_bwd_pair(g, x, w, **kw)
    for n_split in (2, 3):
        sdx, sdw = qmatmul_bwd_pair_nsplit(g, x, w, n_split=n_split, **kw)
        assert torch.equal(sdx, dx) and torch.equal(sdw, dw), n_split
    dx0, _ = qmatmul_bwd_pair(g[:, :32], x, w[:, :32], **kw)
    dx1, dw1 = qmatmul_bwd_pair(g[:, 32:], x, w[:, 32:], dx_carry=dx0,
                                n_offset=32, n_total=96, **kw)
    odx, odw = qmatmul_bwd_pair(g[:, 32:], x, w[:, 32:], dx_carry=dx0, **kw)
    assert torch.equal(dx1, dx) and torch.equal(dw1, dw[:, 32:])
    assert not torch.equal(odx, dx) and not torch.equal(odw, dw[:, 32:])


def test_sr_stats_epilogue_neutral():
    """Telemetry on or off leaves the SR output as it is (K8's C is G's and
    E's), and the row has its N_STATS slots."""
    x, w = _fused_operands()
    kw = _kw(rounding="sr", sr_seed=SR_SEED)
    plain = qmatmul_fused(x, w, **kw)
    with_stats, raw = qmatmul_fused(x, w, collect_stats=True, **kw)
    assert torch.equal(plain, with_stats)
    assert torch.equal(plain, qmatmul_fused(x, w, return_quantized=True,
                                            **kw)[0])
    assert raw.shape == (N_STATS,)


@pytest.mark.slow
def test_sr_ensemble_mean_unbiased_vs_f32_oracle():
    """E_seed[SR GEMM] -> the f32 product of the quantized operands within
    the computed confidence interval; RNE at the same width carries a
    bias the SR mean does not (the JAX test's bounds)."""
    rng = np.random.RandomState(1)
    m, k, n = 8, 2048, 8
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    q = lambda v: TC.quantize_block(v, 5, 2)  # noqa: E731
    oracle = (q(x).double() @ q(w).double()).numpy()
    kw = dict(repr_fmt=FP8_152, e_acc=6, m_acc=4, block_k=64,
              rounding="sr")
    ys = np.stack([qmatmul_fused(x, w, sr_seed=s, **kw).numpy()
                   for s in range(48)])
    mean = ys.mean(0)
    stderr = ys.std(0, ddof=1) / np.sqrt(48)
    z = np.abs(mean - oracle) / np.maximum(stderr, 1e-12)
    assert z.max() < 6.0, f"max |z| = {z.max():.2f}"
    assert z.mean() < 1.5, f"mean |z| = {z.mean():.2f}"
    rne = qmatmul_fused(x, w, repr_fmt=FP8_152, e_acc=6, m_acc=4,
                        block_k=64).numpy()
    assert np.abs(mean - oracle).mean() < 0.5 * np.abs(rne - oracle).mean()


# the below-the-knee geometry of tests/test_below_knee.py
KNEE_K, KNEE_CHUNK = 8192, 32
KNEE_N2 = KNEE_K // KNEE_CHUNK


def _knee():
    from repro_torch.core.precision import min_m_acc
    return min_m_acc(KNEE_K, 5, chunked=True, chunk=KNEE_CHUNK)


def _knee_cfg(rounding: str, m_acc: int, e_acc: int = 6) -> QDotConfig:
    prec = GEMMPrecision(m_acc=m_acc, e_acc=e_acc, chunk=KNEE_CHUNK)
    return QDotConfig(fwd=prec, repr_fmt=FP8_152, rounding=rounding)


def below_knee_losses(device="cpu", steps: int = 30, lr: float = 2e-4):
    """(wide, rne, sr): the final losses of ``tests/test_below_knee.py``'s
    linear regression through the port's ``qdot`` (x 8 x 8192, chunk 32,
    ``m_acc = knee - 2``, a seed per step under SR), on ``device``."""
    m, n = 8, 8
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((m, KNEE_K)).astype(
        np.float32)).to(device)
    w_true = torch.from_numpy((rng.standard_normal((KNEE_K, n))
                               / np.sqrt(KNEE_K)).astype(np.float32)).to(
                                   device)
    y = x @ w_true

    def train(cfg, sr: bool) -> float:
        w = torch.zeros((KNEE_K, n), device=device)
        for s in range(steps):
            wl = w.clone().requires_grad_()
            pred = qdot(x, wl, cfg, sr_seed=s) if sr else qdot(x, wl, cfg)
            torch.mean((pred - y) ** 2).backward()
            w = w - lr * wl.grad
        with torch.no_grad():
            wl = w.clone().requires_grad_()   # the forward of a train step
            pred = (qdot(x, wl, cfg, sr_seed=10_000) if sr
                    else qdot(x, wl, cfg))
            return float(torch.mean((pred - y) ** 2))

    below = _knee() - 2
    return (train(_knee_cfg("rne", 23, 8), False),
            train(_knee_cfg("rne", below), False),
            train(_knee_cfg("sr", below), True))


@pytest.mark.slow
def test_below_knee_sr_converges_where_rne_swamps():
    """At ``m_acc = knee - 2`` SR training reaches the wide-accumulator
    loss (within 2x) while RNE stalls far above it (the JAX gate)."""
    wide, rne, sr = below_knee_losses()
    assert rne > 5 * wide, (wide, rne)
    assert sr < 2 * wide, (wide, sr)
    assert sr < 0.25 * rne, (rne, sr)


def _probe_stats(m_acc: int, rounding: str):
    from repro_torch.telemetry.stats import gemm_stats

    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (16, KNEE_K)).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (KNEE_K, 16)).astype(np.float32))
    prec = GEMMPrecision(m_acc=m_acc, e_acc=6, chunk=KNEE_CHUNK)
    _, st = gemm_stats(x, w, precision=prec, repr_fmt=FP8_152,
                       rounding=rounding, sr_seed=5)
    return st


def test_sr_aware_knee_distinguishes_jitter_from_swamping():
    """One bit under the knee RNE measurably swamps while SR's zero-mean
    jitter passes the SR knee statistic; two bits under, SR fails it too."""
    st_rne = _probe_stats(_knee() - 1, "rne")
    st_sr = _probe_stats(_knee() - 1, "sr")
    assert not st_rne.suitable(KNEE_N2)
    assert st_sr.suitable(KNEE_N2, rounding="sr")
    assert float(st_sr.jitter_fraction) > 0.95
    assert not _probe_stats(_knee() - 2, "sr").suitable(KNEE_N2,
                                                         rounding="sr")


def test_controller_logs_breach_with_rounding_attribution(tmp_path):
    from repro_torch.core.vrr import CUTOFF_LOG_V
    from repro_torch.telemetry.controller import (
        ControllerConfig,
        GemmProbe,
        PrecisionController,
    )

    log = tmp_path / "telemetry.jsonl"
    below = _knee() - 2
    ctl = PrecisionController(AccumulationPolicy(mode="predicted",
                                                 chunk=KNEE_CHUNK),
                              ControllerConfig(hysteresis=1),
                              log_path=str(log))
    probes = {
        ("mlp_up", "fwd"): GemmProbe(stats=_probe_stats(below, "rne"),
                                     n=KNEE_K, n1=KNEE_CHUNK, m_acc=below,
                                     rounding="rne"),
        ("mlp_down", "fwd"): GemmProbe(stats=_probe_stats(below, "sr"),
                                       n=KNEE_K, n1=KNEE_CHUNK, m_acc=below,
                                       rounding="sr"),
    }
    events = {e["gemm"]: e for e in ctl.observe(1, probes)}
    rne_e, sr_e = events["mlp_up"], events["mlp_down"]
    assert rne_e["event"] == "bump" and sr_e["event"] == "bump"
    assert rne_e["rounding"] == "rne" and rne_e["source"] == "both"
    assert sr_e["rounding"] == "sr" and sr_e["source"] == "measured"
    assert sr_e["log_v"] >= CUTOFF_LOG_V
    assert sr_e["jitter_fraction"] > 0.95
    lines = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert {(e["gemm"], e["event"], e["rounding"]) for e in lines} == {
        ("mlp_up", "bump", "rne"), ("mlp_down", "bump", "sr")}


def test_probe_replays_sr_at_the_role_seeds():
    """The eager probe replays an SR config with SR carries at the role
    seeds of the recorded seed, and hands the controller its rounding."""
    from repro_torch.telemetry.probe import probe_gemm, role_operands
    from repro_torch.telemetry.stats import gemm_stats

    tcfg, _ = _sr_plan()
    x, w = _fused_operands(4, 32, 64, 48)
    gen = torch.Generator().manual_seed(0)
    got = probe_gemm(x, w, tcfg, gen=gen, sr_seed=SR_SEED + 1)
    g = torch.randn((32, 48), generator=torch.Generator().manual_seed(0))
    for role, (a, b, p, flags, n) in role_operands(x, w, tcfg, g).items():
        _, st = gemm_stats(a, b, precision=p, repr_fmt=FP8_152,
                           rounding="sr",
                           sr_seed=sr_role_seed(SR_SEED + 1, role), **flags)
        assert got[role].rounding == "sr" and got[role].n == n
        assert got[role].stats == st, role


def test_bwd_pair_stats_wrapper():
    """``telemetry.bwd_pair_stats`` (JAX's export): K9's dx and dw, bitwise
    the stats-off pair, and its two rows as ``EnsembleStats``, under RNE
    and SR."""
    from repro_torch.telemetry import bwd_pair_stats
    from repro_torch.telemetry.stats import EnsembleStats

    x, w = _fused_operands(5, 48, 64, 40)
    g = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (48, 40)).astype(np.float32))
    _, xq, wq = qmatmul_fused(x, w, repr_fmt=FP8_152, return_quantized=True)
    p = GEMMPrecision(m_acc=5, chunk=16)
    for rounding in ("rne", "sr"):
        kw = dict(rounding=rounding, sr_seed_bwd=3, sr_seed_grad=4)
        dx, dw, sb, sg = bwd_pair_stats(g, xq, wq, repr_fmt=FP8_152, bwd=p,
                                        grad=p, **kw)
        pdx, pdw, rows = qmatmul_bwd_pair(
            g, xq, wq, repr_fmt=FP8_152, bwd_acc=(6, 5), grad_acc=(6, 5),
            bwd_chunk=16, grad_chunk=16, collect_stats=True, **kw)
        assert torch.equal(dx, pdx) and torch.equal(dw, pdw)
        assert sb == EnsembleStats.from_raw(rows[0])
        assert sg == EnsembleStats.from_raw(rows[1])
        assert float(sb.count) == 48 * 64 and float(sg.count) == 64 * 40


# --------------------------------------------------------------------------
# (e) the launcher under --rounding sr
# --------------------------------------------------------------------------

SEQ, BATCH, CHUNK, STEPS = 32, 4, 16, 2


def _sr_argv(*extra):
    return ["--smoke", "--steps", str(STEPS), "--global-batch", str(BATCH),
            "--seq-len", str(SEQ), "--chunk", str(CHUNK), "--lr", "1e-3",
            "--warmup", "2", "--policy", "predicted", "--rounding", "sr",
            "--sr-seed", str(SR_SEED), "--log-every", "1", "--device", "cpu",
            *extra]


def test_launch_train_sr_smoke_cpu(capsys):
    """The launcher end to end under ``--rounding sr``: the plan carries SR
    and the seed in every solver-assigned field and RNE on the lm_head;
    the same seed reproduces the run, another seed changes it; ``exact``
    with SR exits with the JAX launcher's message."""
    from repro_torch.launch.train import build, main, parse_args

    cfg = build(parse_args(_sr_argv()))[0].cfg
    for name in ("attn_qkv", "attn_out", "mlp_up", "mlp_down"):
        qc = getattr(cfg.quant, name)
        assert qc.rounding == "sr" and qc.sr_seed == SR_SEED, name
    assert cfg.quant.lm_head.rounding == "rne"
    runs = []
    for seed in (SR_SEED, SR_SEED, SR_SEED + 1):
        argv = _sr_argv()
        argv[argv.index("--sr-seed") + 1] = str(seed)
        main(argv)
        runs.append([json.loads(ln)["loss"] for ln in
                     capsys.readouterr().out.splitlines()
                     if ln.startswith("{")])
    assert len(runs[0]) == STEPS and all(np.isfinite(runs[0]))
    assert runs[0] == runs[1] and runs[0] != runs[2]
    with pytest.raises(SystemExit, match="non-exact"):
        main(_sr_argv("--policy", "exact"))


def _tokens():
    return np.random.RandomState(5).randint(0, 256, (STEPS, BATCH, SEQ)
                                            ).astype(np.int32)


def sr_train_child(out_path: str) -> None:
    """The JAX side: the SR plan of the JAX launcher's arguments, the first
    step's loss and gradients, and ``STEPS`` jitted train steps.  Run with
    ``--xla_allow_excess_precision=false`` (ROADMAP F2)."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.core.policy import AccumulationPolicy as JPol
    from repro.core.policy import plan_for_model as jplan
    from repro.models.api import get_model as jget
    from repro.train import optimizer as JO
    from repro.train.loop import TrainConfig as JTC
    from repro.train.loop import init_train_state, make_train_step
    from test_torch_train import _flat

    jcfg = jplan(jsmoke("qwen2-1.5b"), seq_len=SEQ, global_batch=BATCH,
                 policy=JPol(mode="predicted", chunk=CHUNK, rounding="sr",
                             sr_seed=SR_SEED))
    model = jget(jcfg)
    tc = JTC(opt=JO.OptConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS))
    state = init_train_state(model, jax.random.PRNGKey(0), tc)
    toks = _tokens()
    out = _flat(state["params"], "p0", {})

    def grads(params, batch):
        cast = jax.tree.map(lambda p: p.astype(jnp.bfloat16) if (
            p.dtype == jnp.float32 and p.ndim >= 2) else p, params)
        (loss, _), g = jax.value_and_grad(
            lambda p: model.loss_fn(p, batch, jcfg), has_aux=True)(cast)
        return loss, jax.tree.map(lambda x: x.astype(jnp.float32), g)

    loss, g = jax.jit(grads)(state["params"], {"tokens": jnp.asarray(toks[0])})
    out["loss"] = np.asarray(loss)
    _flat(g, "g", out)
    step = jax.jit(make_train_step(model, tc))
    for s in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(toks[s])})
        out[f"loss{s}"] = np.asarray(m["loss"])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def sr_trained(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_sr_train") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    child = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_sr as t; t.sr_train_child({path!r})"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert child.returncode == 0, child.stdout + child.stderr
    return dict(np.load(path))


def test_sr_train_steps_track_jax(sr_trained):
    """The launcher's SR model and train config (``build`` of
    ``--rounding sr --sr-seed 7``) from JAX's weights on JAX's tokens: the
    first step's loss within 1e-5 and its matrix and embedding gradients
    equal in 99.9% of elements (test_torch_train's bounds; bias gradients
    there within ``BIAS_REL``), then ``STEPS`` AdamW steps with the loss
    within 0.03 of JAX's (ROADMAP F4)."""
    from repro_torch.launch.train import build, parse_args
    from repro_torch.train import optimizer as O
    from repro_torch.train.loop import _grads, compute_copy, make_train_step
    from test_torch_train import BIAS_REL, F32_REL, _flat, _unflat

    model, tc, _, _, _ = build(parse_args(_sr_argv()))
    params = _unflat(sr_trained, "p0")
    toks = _tokens()
    compute = compute_copy(params)
    loss, _ = model.loss_fn(compute, {"tokens": torch.from_numpy(toks[0])},
                            model.cfg)
    loss.backward()
    loss = loss.detach()
    print(f"loss {float(loss):.7f} vs JAX {float(sr_trained['loss']):.7f}")
    assert abs(float(loss) - float(sr_trained["loss"])) <= 1e-5
    grads = _flat(_grads(compute, params), "g", {})
    for name, got in grads.items():
        want = sr_trained[name]
        eq = float(np.mean(got == want))
        rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                     1e-30))
        print(f"{name}: equal {eq:.4f}, relative error {rel:.3g}")
        if name.endswith(("/bq", "/bk", "/bv")):
            assert rel <= BIAS_REL, name
        elif name == "g/final_norm":
            assert rel <= F32_REL, name
        else:
            assert eq >= 0.999, name
    state = {"params": params, "opt": O.init_opt_state(params),
             "scaler": O.init_scaler(tc.scaler)}
    step = make_train_step(model, tc)
    for s in range(STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(toks[s])})
        dl = abs(float(m["loss"]) - float(sr_trained[f"loss{s}"]))
        print(f"step {s}: loss {float(m['loss']):.5f} (JAX "
              f"{float(sr_trained[f'loss{s}']):.5f})")
        assert dl <= 0.03


def test_unpack_of_sr_codes_is_the_quantized_operand():
    """E's codes under SR are those of RNE: SR touches only the carries."""
    x, w = _fused_operands(6, 40, 72, 56)
    _, xq, wq = qmatmul_fused(x, w, return_quantized=True,
                              **_kw(rounding="sr", sr_seed=SR_SEED))
    _, rxq, rwq = qmatmul_fused(x, w, return_quantized=True, **_kw())
    assert torch.equal(xq, rxq) and torch.equal(wq, rwq)
    assert torch.equal(unpack_block(xq, 5, 2), TC.quantize_block(x, 5, 2))
