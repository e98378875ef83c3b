"""Port vs JAX package: the rest of stochastic rounding and the oracle's
stats rows.

(a) G's plain version under SR (``qmatmul_fused`` without
    ``return_quantized``, and the no-grad ``qdot``, which runs G) against
    the JAX ``qmatmul_fused(rounding="sr")`` in interpret mode.
(b) The SR N-split backward pair (the dx carry-in entry, K7, chained over
    segments at their place in N) against the unsplit SR pair and JAX's
    ``qmatmul_bwd_pair_nsplit``: the counterpart of
    ``tests/test_sr_stats.py::test_sr_nsplit_matches_pair``.
(c) K10's plain version under SR: ``_sr_attn_bits`` against JAX's,
    bitwise; the walk against JAX's ``flash_prefill_reference``
    and its interpret-mode kernel; a resumed walk against the one-shot
    walk (the counterpart of ``test_attention_sr_resume_equals_one_shot``),
    seed sensitivity, and query tiles whose pages are masked for some of
    their rows and not for others.
(d) The rows of a tagged oracle ``qdot`` (``QDotConfig(fused=False)``)
    against the JAX package's in a child process, as
    ``tests/test_torch_telemetry.py`` runs the tagged step.

Tolerances.  Bitwise on lattice operands (every f32 order of a chunk's
partial, and of a KV block's p.v, is exact there).  On random operands the
JAX dots sum a chunk's products in another order (ROADMAP F0): G and the
pair within 1 ulp of the carry format, and K10's o and l carries within
1 carry ulp, its running max bitwise; the mismatch fraction is printed
(measured: bitwise, but for 0.00033 of K10's o carries at 1 ulp in one
case).  The stats rows within ``_check_jax_row``'s bound
(counters and MAX_ABS exact, sums at rel 2^-16; F6).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import _sr_attn_bits as jax_sr_attn_bits
from repro.kernels.attention import flash_prefill as jax_fp
from repro.kernels.attention import flash_prefill_reference as jax_fp_ref
from repro.kernels.bwd_pair import qmatmul_bwd_pair as jax_pair
from repro.kernels.bwd_pair import qmatmul_bwd_pair_nsplit as jax_nsplit
from repro.kernels.fused import qmatmul_fused as jax_qmatmul
from repro.quant.formats import FP8_152 as JFP8
from repro_torch.core.policy import GEMMPrecision
from repro_torch.kernels.attention import _sr_attn_bits, flash_prefill
from repro_torch.kernels.attention import flash_prefill_reference
from repro_torch.kernels.bwd_pair import (
    qmatmul_bwd_pair,
    qmatmul_bwd_pair_nsplit,
)
from repro_torch.kernels.common import quantize_block
from repro_torch.kernels.fused import qmatmul_fused
from repro_torch.kernels.ops import QDotConfig, qdot, sr_role_seed
from repro_torch.quant.formats import FP8_152
from test_torch_telemetry import REL_BITWISE, _check_jax_row
from test_torch_train import _check, _lattice, ulps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR_SEED = 7
ACC = (6, 5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _operands(rng, shape, lattice, scale=1.0):
    if lattice:
        return _lattice(rng, shape)
    return (rng.randn(*shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------
# (a) G under SR
# --------------------------------------------------------------------------

G_CASES = [
    # (M, K, N, chunk, repr, (e_acc, m_acc)): decode-sized and ragged M,
    # several chunks, a ragged last chunk, the unquantized lm_head
    (1, 96, 48, 16, "152", ACC),
    (8, 160, 80, 32, "152", ACC),
    (37, 200, 75, 64, "152", ACC),
    (5, 160, 40, 64, None, (6, 9)),
]


@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize("m,k,n,chunk,rf,acc", G_CASES)
def test_g_sr_plain_matches_jax(m, k, n, chunk, rf, acc, lattice):
    """G's plain SR call against the JAX kernel under the same seed, and
    bitwise E's C and K8's C on the same operands (one stream, three
    kernels).  bf16 weights reach G as they are; bf16 -> f32 is exact, so
    the JAX call sees the same values."""
    rng = np.random.RandomState(m * 100 + k + n + lattice)
    a = _operands(rng, (m, k), lattice)
    b = _operands(rng, (k, n), lattice, 1 / np.sqrt(k))
    bt = _t(b).to(torch.bfloat16)
    kw = dict(e_acc=acc[0], m_acc=acc[1], block_k=chunk, rounding="sr",
              sr_seed=SR_SEED)
    want = np.asarray(jax_qmatmul(jnp.asarray(a), jnp.asarray(bt.float().numpy()),
                                  repr_fmt=JFP8 if rf else None, **kw))
    fmt = FP8_152 if rf else None
    got = qmatmul_fused(_t(a), bt, repr_fmt=fmt, **kw)
    _check(f"G sr {m}x{k}x{n}", got.numpy(), want, acc, lattice)
    assert torch.equal(got, qmatmul_fused(_t(a), bt, collect_stats=True,
                                          repr_fmt=fmt, **kw)[0])
    if rf:
        assert torch.equal(got, qmatmul_fused(_t(a), bt, repr_fmt=fmt,
                                              return_quantized=True, **kw)[0])
    assert not torch.equal(got, qmatmul_fused(_t(a), bt, repr_fmt=fmt,
                                              **dict(kw, sr_seed=SR_SEED + 1)))


@pytest.mark.parametrize("lattice", [True, False])
def test_qdot_no_grad_sr_runs_g(lattice):
    """The no-grad SR forward (the eager telemetry probe's, serving's) is
    G at the FWD role seed: bitwise JAX's ``qmatmul_fused`` at
    ``sr_role_seed(seed, "fwd")`` and bitwise the forward of the
    differentiable call, whose E emits the codes."""
    rng = np.random.RandomState(31 + lattice)
    x = _operands(rng, (2, 12, 96), lattice)
    w = _operands(rng, (96, 40), lattice, 1 / 9)
    p = GEMMPrecision(m_acc=ACC[1], e_acc=ACC[0], chunk=32)
    cfg = QDotConfig(fwd=p, bwd=p, grad=p, repr_fmt=FP8_152, rounding="sr",
                     sr_seed=SR_SEED)
    with torch.no_grad():
        y = qdot(_t(x), _t(w), cfg)
    want = np.asarray(jax_qmatmul(
        jnp.asarray(x.reshape(-1, 96)), jnp.asarray(w), repr_fmt=JFP8,
        e_acc=ACC[0], m_acc=ACC[1], block_k=32, rounding="sr",
        sr_seed=sr_role_seed(SR_SEED, "fwd"))).reshape(2, 12, 40)
    _check("no-grad SR qdot", y.numpy(), want, ACC, lattice)
    xt = _t(x).requires_grad_()
    assert torch.equal(qdot(xt, _t(w), cfg).detach(), y)


# --------------------------------------------------------------------------
# (b) the SR N-split pair
# --------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("n_split", [2, 3])
def test_sr_nsplit_matches_pair_and_jax(n_split, packed):
    """The SR pair chained over ``n_split`` N segments with the dx carry
    (K7's entry at each segment's place in N): bitwise the unsplit SR pair,
    and JAX's SR ``qmatmul_bwd_pair_nsplit`` (interpret mode) on lattice
    operands, int8 codes or raw quantized f32 (the JAX test's layout)."""
    rng = np.random.RandomState(10 + n_split)
    t, k, n = 40, 96, 104
    x, w = _lattice(rng, (t, k)), _lattice(rng, (k, n))
    g = _lattice(rng, (t, n))
    if packed:
        _, xq, wq = qmatmul_fused(_t(x), _t(w), repr_fmt=FP8_152,
                                  return_quantized=True)
    else:
        xq, wq = quantize_block(_t(x), 5, 2), quantize_block(_t(w), 5, 2)
    sb, sg = SR_SEED + 101, SR_SEED + 202
    kw = dict(repr_fmt=FP8_152, bwd_acc=ACC, grad_acc=(6, 7), packed=packed,
              rounding="sr", sr_seed_bwd=sb, sr_seed_grad=sg)
    dx, dw = qmatmul_bwd_pair(_t(g), xq, wq, bwd_chunk=16, grad_chunk=8,
                              **kw)
    sdx, sdw = qmatmul_bwd_pair_nsplit(_t(g), xq, wq, n_split=n_split,
                                       bwd_chunk=16, grad_chunk=8, **kw)
    assert torch.equal(sdx, dx) and torch.equal(sdw, dw)
    jdx, jdw = jax_nsplit(jnp.asarray(g), jnp.asarray(xq.numpy()),
                          jnp.asarray(wq.numpy()), n_split=n_split,
                          block_t=8, block_k=32, block_n=16, **kw)
    _check("SR nsplit dx vs JAX", sdx.numpy(), np.asarray(jdx), ACC, True)
    _check("SR nsplit dw vs JAX", sdw.numpy(), np.asarray(jdw), (6, 7), True)
    jpdx, _ = jax_pair(jnp.asarray(g), jnp.asarray(xq.numpy()),
                       jnp.asarray(wq.numpy()), block_t=8, block_k=32,
                       block_n=16, **kw)
    np.testing.assert_array_equal(np.asarray(jpdx), np.asarray(jdx))


# --------------------------------------------------------------------------
# (c) K10 under SR
# --------------------------------------------------------------------------

@pytest.mark.parametrize("row0,h,s,dh", [(0, 4, 8, 16), (96, 6, 40, 32),
                                          (3_000_003, 12, 4, 128)])
def test_sr_attn_bits_match_jax(row0, h, s, dh):
    """The o and l dither of one KV-block update of a slab, keyed on the
    absolute block, row, head and feature (l under the salted seed),
    bitwise JAX's ``_sr_attn_bits`` (its whole-slab form, the one its
    reference draws; its kernel tiles draw the same words at the same
    coordinates); a row far from the origin wraps mod 2^32 as JAX's
    uint32 arithmetic does."""
    for seed, step in ((SR_SEED, 0), (0xDEADBEEF, 123457)):
        jo, jl = jax_sr_attn_bits(jnp.uint32(seed), step, abs_row0=row0,
                                  head0=0, block_q=s, dh=dh, h=h,
                                  shape3=(h, s, dh))
        to, tl = _sr_attn_bits(seed, step, abs_row0=row0, h=h, s=s, dh=dh)
        np.testing.assert_array_equal(to.numpy(),
                                      np.asarray(jo).astype(np.int64))
        np.testing.assert_array_equal(tl.numpy(),
                                      np.asarray(jl).astype(np.int64))


def _attn_lattice(rng, shape):
    """Values whose scores, probabilities' sums and p.v sums are exact in
    f32 in any order: (1,5,2) points over a narrow exponent range."""
    e = rng.randint(-2, 1, size=shape)
    j = rng.randint(0, 4, size=shape)
    s = rng.choice([-1.0, 1.0], size=shape)
    return (s * np.exp2(e) * (1 + j / 4)).astype(np.float32)


def _qkv(rng, s, h, kv, dh, lattice, sk=None):
    sk = s if sk is None else sk
    make = _attn_lattice if lattice else (
        lambda r, shape: r.randn(*shape).astype(np.float32))
    return make(rng, (s, h, dh)), make(rng, (sk, kv, dh)), make(
        rng, (sk, kv, dh))


def _carry_within(label, got, want, acc, lattice):
    """m bitwise; o and l bitwise on lattice operands, else within 1 ulp of
    the carry format, the mismatch fraction printed."""
    (go, gm, gl), (wo, wm, wl) = got, [np.asarray(w) for w in want]
    np.testing.assert_array_equal(gm.numpy(), wm)
    for what, a, b in (("o", go.numpy(), wo), ("l", gl.numpy(), wl)):
        u = ulps(a, b, acc[1], acc[0])
        print(f"{label} {what}: mismatch fraction {np.mean(a != b):.5f}, "
              f"max {u.max():.2f} carry ulp")
        if lattice:
            np.testing.assert_array_equal(a, b)
        else:
            assert u.max() <= 1.0


K10_CASES = [
    # (S, H, KV, dh, chunk, block_q, acc): GQA g = 3 with a ragged last
    # block; 8-row query tiles over 16-token blocks, so a block is masked
    # for some rows of a tile and not for others; no GQA
    (40, 6, 2, 16, 16, 8, ACC),
    (33, 4, 4, 8, 8, 16, (6, 6)),
    (48, 4, 2, 16, 32, 8, (6, 5)),
]


@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize("s,h,kv,dh,chunk,block_q,acc", K10_CASES)
def test_flash_prefill_sr_plain_matches_jax(s, h, kv, dh, chunk, block_q,
                                            acc, lattice):
    """One-shot K10 under SR, carry and finalized output, against JAX's
    reference and its interpret-mode kernel (whose query tiles skip the
    blocks in their causal future and run the partly masked ones): on
    lattice operands bitwise, on random ones within 1 carry ulp
    (``_carry_within``) of the reference."""
    rng = np.random.RandomState(s * h + chunk + lattice)
    q, k, v = _qkv(rng, s, h, kv, dh, lattice)
    kw = dict(acc=acc, chunk=chunk, rounding="sr", sr_seed=SR_SEED)
    got_c = flash_prefill(_t(q), _t(k), _t(v), return_carry=True, **kw)
    jq = [jnp.asarray(a) for a in (q, k, v)]
    _carry_within("K10 sr carry vs JAX reference", got_c,
                  jax_fp_ref(*jq, return_carry=True, **kw), acc, lattice)
    got = flash_prefill(_t(q), _t(k), _t(v), **kw).numpy()
    if lattice:
        np.testing.assert_array_equal(got, np.asarray(jax_fp_ref(*jq, **kw)))
        np.testing.assert_array_equal(
            got, np.asarray(jax_fp(*jq, block_q=block_q, **kw)))
        _carry_within("K10 sr carry vs JAX kernel", got_c,
                      jax_fp(*jq, block_q=block_q, return_carry=True, **kw),
                      acc, True)
    assert np.array_equal(got, flash_prefill_reference(
        _t(q), _t(k), _t(v), **kw).numpy())


@pytest.mark.parametrize("split", [0, 16, 32, 48])
def test_flash_prefill_sr_resume_equals_one_shot(split):
    """Carry out over KV [0, split) and in over the rest under SR, at every
    chunk multiple: bitwise the one-shot walk (o, m, l and the output),
    since the dither keys on the absolute KV block; and bitwise JAX's
    resumed walk on lattice operands.  A query slab placed after its
    history (``q_offset``) resumes the same way."""
    rng = np.random.RandomState(split + 3)
    s, h, kv, dh, chunk = 64, 6, 2, 16, 16
    q, k, v = _qkv(rng, s, h, kv, dh, True)
    kw = dict(acc=ACC, chunk=chunk, rounding="sr", sr_seed=SR_SEED)
    one = flash_prefill(_t(q), _t(k), _t(v), **kw)
    one_c = flash_prefill(_t(q), _t(k), _t(v), return_carry=True, **kw)
    c = flash_prefill(_t(q), _t(k[:split]), _t(v[:split]), return_carry=True,
                      **kw)
    res = flash_prefill(_t(q), _t(k[split:]), _t(v[split:]), kv_offset=split,
                        carry=c, **kw)
    res_c = flash_prefill(_t(q), _t(k[split:]), _t(v[split:]),
                          kv_offset=split, carry=c, return_carry=True, **kw)
    assert torch.equal(res, one)
    for a, b in zip(res_c, one_c):
        assert torch.equal(a, b)
    jq = [jnp.asarray(a) for a in (q, k, v)]
    jc = jax_fp_ref(*[a[:split] if i else a for i, a in enumerate(jq)],
                    return_carry=True, **kw)
    jres = jax_fp_ref(jq[0], jq[1][split:], jq[2][split:], kv_offset=split,
                      carry=jc, **kw)
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    t0 = 24
    qs = q[t0:40]
    want = flash_prefill(_t(qs), _t(k[:40]), _t(v[:40]), q_offset=t0, **kw)
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jax_fp_ref(jnp.asarray(qs), jq[1][:40],
                                            jq[2][:40], q_offset=t0, **kw)))
    c = flash_prefill(_t(qs), _t(k[:16]), _t(v[:16]), q_offset=t0,
                      return_carry=True, **kw)
    two = flash_prefill(_t(qs), _t(k[16:40]), _t(v[16:40]), q_offset=t0,
                        kv_offset=16, carry=c, **kw)
    assert torch.equal(two, want)


def test_flash_prefill_sr_seed_sensitive_and_deterministic():
    """Two calls under one seed agree bitwise; another seed, the seed mod
    2^32 excepted, and RNE each change the output."""
    rng = np.random.RandomState(5)
    q, k, v = (_t(a) for a in _qkv(rng, 40, 4, 2, 16, False))
    kw = dict(acc=ACC, chunk=8)
    a = flash_prefill(q, k, v, rounding="sr", sr_seed=SR_SEED, **kw)
    assert torch.equal(a, flash_prefill(q, k, v, rounding="sr",
                                        sr_seed=SR_SEED, **kw))
    assert torch.equal(a, flash_prefill(q, k, v, rounding="sr",
                                        sr_seed=SR_SEED + 2 ** 32, **kw))
    assert not torch.equal(a, flash_prefill(q, k, v, rounding="sr",
                                            sr_seed=SR_SEED + 1, **kw))
    assert not torch.equal(a, flash_prefill(q, k, v, **kw))


# --------------------------------------------------------------------------
# (d) the oracle's stats rows against JAX's
# --------------------------------------------------------------------------

# (kind, lattice): the predicted plan's (1,5,2) representation, and the
# lm_head's raw operands with a (1,6,9) carry
ORACLE_CASES = [("predicted", True), ("predicted", False), ("lm_head", True)]
ORACLE_SHAPE = (24, 80, 48)


def _oracle_operands(kind, lattice):
    t, k, n = ORACLE_SHAPE
    rng = np.random.RandomState(ORACLE_CASES.index((kind, lattice)) + 40)
    return (_operands(rng, (t, k), lattice), _operands(rng, (k, n), lattice,
                                                       1 / 9),
            _operands(rng, (t, n), lattice))


def oracle_rows_child(out_path: str) -> None:
    """The JAX side of (d): one tagged ``qdot(fused=False)`` forward and
    backward per case, its collector's rows.  Run with
    ``--xla_allow_excess_precision=false`` (ROADMAP F2)."""
    import jax

    from repro.core.policy import GEMMPrecision as JGP
    from repro.kernels.ops import QDotConfig as JQC
    from repro.kernels.ops import qdot as jax_qdot
    from repro.obs.ingraph import InGraphCollector, collecting

    out, meta = {}, []
    for kind, lattice in ORACLE_CASES:
        x, w, g = _oracle_operands(kind, lattice)
        p = JGP(m_acc=5 if kind == "predicted" else 9, chunk=16)
        cfg = JQC(fwd=p, bwd=p, grad=p, fused=False, stats_tag="mlp_up",
                  repr_fmt=JFP8 if kind == "predicted" else None)
        col = InGraphCollector()
        with collecting(col):
            _, vjp = jax.vjp(lambda a, b: jax_qdot(a, b, cfg),
                             jnp.asarray(x), jnp.asarray(w))
            jax.block_until_ready(vjp(jnp.asarray(g)))
            jax.effects_barrier()
        for (tag, role), cell in sorted(col._cells.items()):
            meta.append([kind, lattice, tag, role, cell["n"], cell["n1"],
                         cell["m_acc"]])
            out[f"{kind}/{int(lattice)}/{role}"] = cell["row"]
    out["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_oracle_rows(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_oracle_rows") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    child = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_sr_rest as t; t.oracle_rows_child({path!r})"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
    assert child.returncode == 0, child.stdout + child.stderr
    data = dict(np.load(path))
    data["meta"] = json.loads(bytes(data["meta"]).decode())
    return data


@pytest.mark.parametrize("kind,lattice", ORACLE_CASES)
def test_oracle_stats_rows_match_jax(jax_oracle_rows, kind, lattice):
    """A tagged oracle ``qdot`` step's three rows (K8's plain version on
    the f32 residuals and g: FWD (xq, wq), BWD (g, wq^T) with g quantized,
    GRAD (xq^T, g) with g quantized) against the JAX collector's: the same
    (tag, role) keys and geometry, each row within ``_check_jax_row``'s
    bound at rel 2^-16; y, dx and dw as the untagged oracle's."""
    from repro_torch.obs.ingraph import InGraphCollector, collecting

    x, w, g = _oracle_operands(kind, lattice)
    p = GEMMPrecision(m_acc=5 if kind == "predicted" else 9, chunk=16)
    cfg = QDotConfig(fwd=p, bwd=p, grad=p, fused=False,
                     repr_fmt=FP8_152 if kind == "predicted" else None)
    outs = []
    col = InGraphCollector()
    for tag in (None, "mlp_up"):
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        with collecting(col):
            y = qdot(xt, wt, replace(cfg, stats_tag=tag))
            y.backward(_t(g))
        outs.append((y.detach(), xt.grad, wt.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    want = [m[2:] for m in jax_oracle_rows["meta"]
            if m[0] == kind and m[1] == lattice]
    probes = col.probes()
    assert sorted([key[0], key[1], pr.n, pr.n1, pr.m_acc]
                  for key, pr in probes.items()) == sorted(want)
    for (tag, role), row in col.rows().items():
        _check_jax_row(f"oracle {kind} {role}", row,
                       jax_oracle_rows[f"{kind}/{int(lattice)}/{role}"],
                       REL_BITWISE)
