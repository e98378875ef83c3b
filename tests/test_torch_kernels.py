"""Port vs JAX package: the plain versions of the three Hopper kernels.

The fused GEMM is held bit for bit on lattice operands (every f32
intra-chunk partial is exact, so the summation order cannot matter) and
to at most 1 ulp of the carry format on random operands (the partials'
f32 summation order differs between XLA's dot and PyTorch's; ROADMAP F0).
The attention plain versions are held against the JAX references on one
packed arena; their intra-page sums run in another order than XLA's
dots, so outputs agree to the carry's rounding (bound stated per test).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import (
    flash_prefill_paged_reference as jax_prefill_ref,
    paged_attn_decode_reference as jax_decode_ref,
)
from repro.kernels.fused import qmatmul_fused as jax_qmatmul
from repro.quant.formats import FP8_152 as JFP8
from repro_torch.kernels.attention import (
    flash_prefill_paged,
    flash_prefill_paged_reference,
    paged_attn_decode,
    paged_attn_decode_reference,
)
from repro_torch.kernels.common import quantize_block
from repro_torch.kernels.fused import qmatmul_fused, qmatmul_fused_reference
from repro_torch.kernels.ops import QDotConfig, qdot
from repro_torch.quant.formats import FP8_152, FPFormat
from repro_torch.quant.qtensor import pack_block


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def ulps(got, want, m: int, min_exp: int) -> np.ndarray:
    """|got - want| in units of the (1, e, m) ulp at max(|got|, |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    exp = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    ulp = np.exp2(np.maximum(exp, min_exp) - m)
    return np.abs(got - want) / ulp


def _lattice(rng, shape, exps=(-2, 2), mant_bits=2):
    """Values s * 2^e * (1 + j / 2^mant_bits): (1,5,2) points over a narrow
    exponent range, so every f32 sum of 64 products is exact."""
    e = rng.randint(exps[0], exps[1] + 1, size=shape)
    j = rng.randint(0, 2 ** mant_bits, size=shape)
    s = rng.choice([-1.0, 1.0], size=shape)
    x = s * np.exp2(e) * (1 + j / 2 ** mant_bits)
    x[rng.rand(*shape) < 0.1] = 0.0
    return x.astype(np.float32)


GEMM_CASES = [
    # (M, K, N, chunk, repr, e_acc, m_acc): ragged M/N/K, several chunks
    (37, 200, 75, 64, "152", 6, 5),
    (8, 96, 130, 16, "152", 6, 5),
    (5, 160, 40, 64, None, 6, 9),    # the lm_head: f32 operands, (1,6,9)
    (9, 64, 33, 64, "152", 8, 23),   # wide carry
]


def _jax_gemm(a, b, chunk, rf, e_acc, m_acc):
    return np.asarray(jax_qmatmul(jnp.asarray(a), jnp.asarray(b),
                                  repr_fmt=JFP8 if rf else None, e_acc=e_acc,
                                  m_acc=m_acc, block_k=chunk))


@pytest.mark.parametrize("m,k,n,chunk,rf,e_acc,m_acc", GEMM_CASES)
def test_gemm_plain_bitwise_on_lattice(m, k, n, chunk, rf, e_acc, m_acc):
    rng = np.random.RandomState(m * 1000 + k + n)
    if rf:
        a, b = _lattice(rng, (m, k)), _lattice(rng, (k, n))
    else:  # bf16-representable values for the unquantized lm_head
        a = (rng.randint(-64, 65, (m, k)) / 16).astype(np.float32)
        b = (rng.randint(-64, 65, (k, n)) / 16).astype(np.float32)
    want = _jax_gemm(a, b, chunk, rf, e_acc, m_acc)
    got = qmatmul_fused(torch.from_numpy(a), torch.from_numpy(b),
                        repr_fmt=FP8_152 if rf else None, e_acc=e_acc,
                        m_acc=m_acc, block_k=chunk).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("m,k,n,chunk,rf,e_acc,m_acc", GEMM_CASES)
def test_gemm_plain_within_one_ulp_on_random(m, k, n, chunk, rf, e_acc, m_acc):
    rng = np.random.RandomState(7 + m + k + n)
    a = rng.randn(m, k).astype(np.float32)
    b = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    want = _jax_gemm(a, b, chunk, rf, e_acc, m_acc)
    # bf16 operands reach the port's GEMM as they are (dense() passes the
    # bf16 weights); bf16 -> f32 is exact, so the JAX call sees the same
    # values after the cast
    bt = torch.from_numpy(b).to(torch.bfloat16)
    want_bf = _jax_gemm(a, bt.float().numpy(), chunk, rf, e_acc, m_acc)
    got = qmatmul_fused(torch.from_numpy(a), torch.from_numpy(b),
                        repr_fmt=FP8_152 if rf else None, e_acc=e_acc,
                        m_acc=m_acc, block_k=chunk).numpy()
    got_bf = qmatmul_fused(torch.from_numpy(a), bt,
                           repr_fmt=FP8_152 if rf else None, e_acc=e_acc,
                           m_acc=m_acc, block_k=chunk).numpy()
    min_exp = -(2 ** (e_acc - 1) - 1)
    for g, w in ((got, want), (got_bf, want_bf)):
        u = ulps(g, w, m_acc, min_exp)
        print(f"GEMM {m}x{k}x{n} acc(1,{e_acc},{m_acc}): mismatch fraction "
              f"{np.mean(g != w):.5f}, max {u.max():.2f} ulp")
        # bound: one carry ulp (a differently-ordered f32 partial can flip
        # one rounding of the carry)
        assert u.max() <= 1.0


def test_qdot_reshapes_and_refuses_grad():
    """``qdot`` flattens the leading axes; with a gradient to take it runs
    the backward pair (dx over N, dw over T, in the plain versions' order);
    a representation whose residual codes would not fit in 8 bits is no
    longer refused: its residuals are float32, and y, dx and dw are the
    oracle's."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 3, 48).astype(np.float32))
    w = torch.from_numpy(rng.randn(48, 20).astype(np.float32))
    from repro_torch.core.policy import GEMMPrecision
    from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair_reference

    p = GEMMPrecision(m_acc=5, chunk=16)
    cfg = QDotConfig(fwd=p, bwd=p, grad=p, repr_fmt=FP8_152)
    y = qdot(x, w, cfg)
    assert y.shape == (2, 3, 20) and y.dtype == torch.float32
    ref = qmatmul_fused_reference(x.reshape(6, 48), w, repr_fmt=FP8_152,
                                  e_acc=6, m_acc=5, block_k=16)
    np.testing.assert_array_equal(_bits(y.reshape(6, 20)), _bits(ref))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    yg = qdot(xg, wg, cfg)
    np.testing.assert_array_equal(_bits(yg.detach()), _bits(y))
    g = torch.from_numpy(rng.randn(2, 3, 20).astype(np.float32))
    yg.backward(g)
    xq = pack_block(quantize_block(x.reshape(6, 48), 5, 2), 5, 2)
    wq = pack_block(quantize_block(w, 5, 2), 5, 2)
    dx, dw = qmatmul_bwd_pair_reference(
        g.reshape(6, 20), xq, wq, repr_fmt=FP8_152, bwd_acc=(6, 5),
        grad_acc=(6, 5), bwd_chunk=16, grad_chunk=16, packed=True)
    np.testing.assert_array_equal(_bits(xg.grad.reshape(6, 48)), _bits(dx))
    np.testing.assert_array_equal(_bits(wg.grad), _bits(dw))
    wide = QDotConfig(fwd=p, bwd=p, grad=p, repr_fmt=FPFormat(5, 7))
    assert not wide.packs
    runs = []
    for c in (wide, QDotConfig(fwd=p, bwd=p, grad=p, repr_fmt=FPFormat(5, 7),
                               fused=False)):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        yg = qdot(xg, wg, c)
        yg.backward(g)
        runs.append((yg.detach(), xg.grad, wg.grad))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

PS, KVH, G, DH = 16, 2, 3, 16


def _arena(rng, n_pages=9):
    """Codes of unit-Gaussian values (as K/V land in the arena after the
    page scale is divided out) and page exponents."""
    def codes():
        x = torch.from_numpy(rng.randn(n_pages, KVH, PS, DH).astype(np.float32))
        return pack_block(quantize_block(x, 5, 2), 5, 2).numpy()

    kse = rng.randint(-3, 4, size=(n_pages,)).astype(np.int32)
    vse = rng.randint(-3, 4, size=(n_pages,)).astype(np.int32)
    return codes(), codes(), kse, vse


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _check_attn(got, want, m_acc, e_acc, zero_rows, label):
    np.testing.assert_array_equal(got[zero_rows], 0.0)
    np.testing.assert_array_equal(want[zero_rows], 0.0)
    # bound: the f32 intra-page sums (dh-term scores, 16-term l and p.v)
    # run in another order than XLA's dots, which moves an f32 sum by a few
    # f32 ulps; that can flip a carry rounding, so o and l each end within
    # 1 carry ulp and the finalized o / l within 2 carry ulps (relative
    # 2^(1 - m_acc)) of |want|, plus one carry ulp of the largest output
    # for an o that rounds near zero.  With the wide (f32) carry the order
    # error itself is the bound: 2^-16 of the largest output (a score error
    # of k f32 ulps moves exp2 by k * ln2 * |score| ulps)
    scale = np.abs(want).max()
    tol = (2.0 ** (1 - m_acc) * np.abs(want)
           + max(2.0 ** -m_acc, 2.0 ** -16) * scale)
    err = np.abs(got - want)
    print(f"{label} acc(1,{e_acc},{m_acc}): mismatch fraction "
          f"{np.mean(got != want):.5f}, max |err| {err.max():.3g} "
          f"(max |out| {scale:.3g}), max |err|/tol {np.max(err / tol):.3f}")
    assert np.all(err <= tol)


@pytest.mark.parametrize("acc", [(6, 5), (8, 23)])
def test_decode_plain_vs_jax(acc):
    rng = np.random.RandomState(21)
    kc, vc, kse, vse = _arena(rng)
    seq_lens = np.array([0, 5, 16, 37, 50], np.int32)  # ragged tails, a 0 row
    pt = np.zeros((5, 4), np.int32)
    pt[1, :1] = [3]
    pt[2, :1] = [5]
    pt[3, :3] = [2, 7, 1]
    pt[4, :4] = [8, 4, 6, 2]
    q = rng.randn(5, KVH * G, DH).astype(np.float32)
    from repro.quant.formats import FPFormat as JF
    want = np.asarray(jax_decode_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kse),
        jnp.asarray(vse), jnp.asarray(pt), jnp.asarray(seq_lens),
        kv_fmt=JF(5, 2), acc=acc))
    got = paged_attn_decode(_t(q), _t(kc), _t(vc), _t(kse), _t(vse), _t(pt),
                            _t(seq_lens), kv_fmt=FP8_152, acc=acc).numpy()
    ref = paged_attn_decode_reference(_t(q), _t(kc), _t(vc), _t(kse), _t(vse),
                                      _t(pt), _t(seq_lens), kv_fmt=FP8_152,
                                      acc=acc).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    _check_attn(got, want, acc[1], acc[0], np.array([0]), "decode")


@pytest.mark.parametrize("acc", [(6, 5), (8, 23)])
def test_prefill_plain_vs_jax(acc):
    rng = np.random.RandomState(22)
    kc, vc, kse, vse = _arena(rng)
    # a 21-token slab after 16 tokens of history (q_offset 16, history on
    # page 6), padded to 24 rows; kv_len 37 over 3 pages + 1 padding entry
    t, q_off, q_len = 24, 16, 21
    row = np.array([6, 2, 8, 0, 0], np.int32)
    q = rng.randn(t, KVH * G, DH).astype(np.float32)
    from repro.quant.formats import FPFormat as JF
    want = np.asarray(jax_prefill_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kse),
        jnp.asarray(vse), jnp.asarray(row), q_off, q_len, q_off + q_len,
        kv_fmt=JF(5, 2), acc=acc))
    got = flash_prefill_paged(_t(q), _t(kc), _t(vc), _t(kse), _t(vse),
                              _t(row), q_off, q_len, q_off + q_len,
                              kv_fmt=FP8_152, acc=acc).numpy()
    ref = flash_prefill_paged_reference(
        _t(q), _t(kc), _t(vc), _t(kse), _t(vse), _t(row), q_off, q_len,
        q_off + q_len, kv_fmt=FP8_152, acc=acc).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    _check_attn(got, want, acc[1], acc[0], np.arange(q_len, t), "prefill")
