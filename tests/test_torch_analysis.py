"""Port vs JAX package: the paper's analysis (VRR equations, accumulation
lengths, Table 1's assignment, the software accumulators and their Monte
Carlo).

Tolerances:

* The VRR functions are the same float64 numpy operations in both
  packages: held equal, not to a tolerance.  So are the accumulation
  lengths and the (normal, chunked) assignments, which are integers.
* ``sequential_accumulate`` / ``chunked_accumulate`` are elementwise
  rounding code (f32 adds and the (1, e, m) quantizer): bitwise JAX's on
  the same numpy terms.
* ``swamped_variance`` draws from ``torch.Generator``, not threefry: its
  points are held to the closed forms under
  ``tests/test_vrr_montecarlo.py``'s own tolerances, ``slow`` where that
  file marks them.
"""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acc_lengths as JL
from repro.core import precision as JP
from repro.quant import accumulate as JA
from repro.quant.formats import FPFormat as JF
from repro_torch.core import acc_lengths as TL
from repro_torch.core import precision as TP
from repro_torch.core import vrr as TV
from repro_torch.quant import (
    FP32_LIKE,
    FPFormat,
    chunked_accumulate,
    quantize,
    sequential_accumulate,
    swamped_variance,
)

JV = sys.modules["repro.core.vrr"]   # ``repro.core`` re-exports ``vrr``

# Paper Table 1, (normal, chunked-64) mantissa bits: the published table
# as ``benchmarks/table1_precisions.py`` holds it.
PAPER = {
    "CIFAR-10 ResNet 32": {
        ("Conv 0", "FWD"): (6, 5), ("ResBlock 1", "FWD"): (6, 5),
        ("ResBlock 2", "FWD"): (7, 5), ("ResBlock 3", "FWD"): (7, 5),
        ("ResBlock 1", "BWD"): (6, 5), ("ResBlock 2", "BWD"): (7, 5),
        ("ResBlock 3", "BWD"): (8, 5),
        ("Conv 0", "GRAD"): (11, 8), ("ResBlock 1", "GRAD"): (11, 8),
        ("ResBlock 2", "GRAD"): (10, 6), ("ResBlock 3", "GRAD"): (9, 6),
    },
    "ImageNet ResNet 18": {
        ("Conv 0", "FWD"): (9, 6), ("ResBlock 1", "FWD"): (7, 5),
        ("ResBlock 2", "FWD"): (8, 5), ("ResBlock 3", "FWD"): (8, 5),
        ("ResBlock 4", "FWD"): (9, 6),
        ("ResBlock 1", "BWD"): (8, 6), ("ResBlock 2", "BWD"): (9, 6),
        ("ResBlock 3", "BWD"): (9, 6), ("ResBlock 4", "BWD"): (10, 6),
        ("Conv 0", "GRAD"): (15, 10), ("ResBlock 1", "GRAD"): (15, 9),
        ("ResBlock 2", "GRAD"): (12, 8), ("ResBlock 3", "GRAD"): (10, 6),
        ("ResBlock 4", "GRAD"): (9, 5),
    },
    "ImageNet AlexNet": {
        ("Conv 1", "FWD"): (7, 5), ("Conv 2", "FWD"): (9, 5),
        ("Conv 3", "FWD"): (9, 5), ("Conv 4", "FWD"): (8, 5),
        ("Conv 5", "FWD"): (8, 5), ("FC 1", "FWD"): (9, 6),
        ("FC 2", "FWD"): (8, 5),
        ("Conv 2", "BWD"): (8, 5), ("Conv 3", "BWD"): (8, 5),
        ("Conv 4", "BWD"): (10, 8), ("Conv 5", "BWD"): (8, 5),
        ("FC 1", "BWD"): (8, 5), ("FC 2", "BWD"): (8, 5),
        ("Conv 1", "GRAD"): (10, 7), ("Conv 2", "GRAD"): (9, 6),
        ("Conv 3", "GRAD"): (8, 6), ("Conv 4", "GRAD"): (6, 5),
        ("Conv 5", "GRAD"): (6, 5), ("FC 1", "GRAD"): (6, 5),
        ("FC 2", "GRAD"): (6, 5),
    },
}
NETS = {"CIFAR-10 ResNet 32": "resnet32_cifar",
        "ImageNet ResNet 18": "resnet18_imagenet",
        "ImageNet AlexNet": "alexnet_imagenet"}
# The JAX package's own count on this table: (layer, role) entries whose
# (normal, chunked) pair is the published one, and single cells equal.
TABLE1_ENTRIES_EQUAL = 12
TABLE1_CELLS_EQUAL = 43

# qwen2-1.5b's training cell (the port's train smoke: batch 8 x seq 64)
QWEN = dict(d_model=1536, d_ff=8960, n_heads=12, n_kv_heads=2, d_head=128,
            seq_len=64, global_batch=8, vocab_size=151936)


# ------------------------------ VRR equations ------------------------------

# the grids of tests/test_vrr.py
_POINTS = ([(23, 5, n) for n in (2, 64, 4096, 262144)]
           + [(m, 5, n) for m in (2, 5, 8, 12, 23)
              for n in (0, 1, 2, 10, 1000, 100_000)]
           + [(m, 5, n) for m in (6, 8, 10) for n in (512, 4096, 32768)]
           + [(7, 5, n) for n in (256, 1024, 4096, 16384, 65536)]
           + [(4, 5, 1_000_000), (4, 5, 100_000_000), (16, 5, 4096),
              (4, 5, 65536), (8, 5, 16384), (7, 5, 6554), (5, 5, 1),
              (9, 3, 777), (11, 8, 30_000)])


@pytest.mark.parametrize("m_acc,m_p,n", _POINTS)
def test_vrr_equals_jax(m_acc, m_p, n):
    assert TV.vrr(m_acc, m_p, n) == JV.vrr(m_acc, m_p, n)
    assert TV.vrr_full_swamping(m_acc, n) == JV.vrr_full_swamping(m_acc, n)
    for nzr in (1.0, 0.5, 0.1):
        assert (TV.vrr_sparse(m_acc, m_p, n, nzr)
                == JV.vrr_sparse(m_acc, m_p, n, nzr))


@pytest.mark.parametrize("m_acc,n1,n2,nzr", [
    (8, 4096, 1, 1.0), (7, 64, 1024, 1.0), (7, 64, 1024, 0.3),
    (8, 64, 4096, 1.0), (8, 128, 2048, 1.0), (8, 256, 1024, 1.0),
    (7, 16, 16384, 1.0), (7, 128, 2048, 1.0), (6, 64, 128, 0.25)])
def test_vrr_chunked_equals_jax(m_acc, n1, n2, nzr):
    assert TV.vrr_chunked(m_acc, 5, n1, n2) == JV.vrr_chunked(m_acc, 5, n1, n2)
    assert (TV.vrr_chunked_sparse(m_acc, 5, n1, n2, nzr)
            == JV.vrr_chunked_sparse(m_acc, 5, n1, n2, nzr))


def test_vrr_quadrature_equals_jax(monkeypatch):
    # the geometric-grid path at lengths the exact path also covers
    monkeypatch.setattr(JV, "_EXACT_SUM_MAX", 100)
    monkeypatch.setattr(TV, "_EXACT_SUM_MAX", 100)
    for m_acc, n in ((8, 16384), (7, 10000)):
        assert TV.vrr(m_acc, 5, n) == JV.vrr(m_acc, 5, n)
        assert TV.vrr_full_swamping(m_acc, n) == JV.vrr_full_swamping(m_acc, n)


def test_vrr_helpers_equal_jax():
    assert TV.__all__ == JV.__all__
    x = np.linspace(-6.0, 30.0, 97)
    np.testing.assert_array_equal(TV._erfc(x), JV._erfc(x))
    np.testing.assert_array_equal(TV.qfunc(x), JV.qfunc(x))
    for args in ((8, 5, 5), (10, 5, 5), (6, 3, 2)):
        assert TV._alpha_partial(*args) == JV._alpha_partial(*args)


# ---------------------- accumulation lengths, Table 1 ----------------------


def _specs(mod, name, **kw):
    return [(s.layer, s.role, s.n, s.nzr) for s in getattr(mod, name)(**kw)]


@pytest.mark.parametrize("name,kw", [
    ("resnet32_cifar", {}), ("resnet18_imagenet", {}),
    ("alexnet_imagenet", {}), ("resnet32_cifar", {"batch": 64, "nzr": 0.5}),
    ("alexnet_imagenet", {"batch": 128, "nzr": 1.0}),
    ("transformer_specs", QWEN),
    ("transformer_specs", dict(QWEN, seq_len=4096, nzr=0.5)),
    ("transformer_specs", dict(QWEN, moe_experts=8, moe_top_k=2))])
def test_acc_lengths_equal_jax(name, kw):
    assert _specs(TL, name, **kw) == _specs(JL, name, **kw)


def test_conv_dense_specs_equal_jax():
    for first in (False, True):
        assert ([tuple(vars(s).values()) for s in TL.conv_specs(
            "c", 3, 16, 32, 8, 8, 4, first=first, nzr_fwd=0.5, nzr_grad=0.25)]
            == [tuple(vars(s).values()) for s in JL.conv_specs(
                "c", 3, 16, 32, 8, 8, 4, first=first, nzr_fwd=0.5,
                nzr_grad=0.25)])
        assert ([tuple(vars(s).values()) for s in TL.dense_specs(
            "d", 64, 32, 512, first=first, nzr_grad=0.5)]
            == [tuple(vars(s).values()) for s in JL.dense_specs(
                "d", 64, 32, 512, first=first, nzr_grad=0.5)])


def _assign(pmod, lmod, name, **kw):
    specs = (getattr(lmod, name)(**QWEN) if name == "transformer_specs"
             else getattr(lmod, name)())
    a = pmod.assign_network(name, specs, m_p=5, **kw)
    return a.network, a.m_p, a.chunk, a.entries


@pytest.mark.parametrize("name", [*NETS.values(), "transformer_specs"])
def test_assign_network_equals_jax(name):
    assert _assign(TP, TL, name) == _assign(JP, JL, name)


def test_assign_network_chunk_equals_jax():
    assert (_assign(TP, TL, "resnet32_cifar", chunk=16)
            == _assign(JP, JL, "resnet32_cifar", chunk=16))


def table1_counts(pmod, lmod) -> tuple[int, int, int]:
    """(entries whose (normal, chunked) pair is the published one, single
    cells equal, entries) over the three networks."""
    entries = cells = total = 0
    for net, fn in NETS.items():
        a = pmod.assign_network(net, getattr(lmod, fn)(), m_p=5)
        for (layer, role), (pn, pc) in PAPER[net].items():
            on, oc = a.get(layer, role)
            entries += (on, oc) == (pn, pc)
            cells += (on == pn) + (oc == pc)
            total += 1
    return entries, cells, total


def test_table1_match_count_pinned_to_jax():
    got = table1_counts(TP, TL)
    assert got == table1_counts(JP, JL)
    assert got == (TABLE1_ENTRIES_EQUAL, TABLE1_CELLS_EQUAL, 45)


def test_precision_dataclasses():
    s = TP.AccumSpec("l", "FWD", 64)
    assert s.nzr == 1.0
    with pytest.raises(Exception):
        s.n = 3  # frozen, as JAX's
    a = TP.PrecisionAssignment("net", 5, 64)
    a.entries[("l", "FWD")] = (6, 5)
    assert a.get("l", "FWD") == (6, 5)


# ------------------------- the software accumulators ----------------------


def _terms(seed, shape, fmt=(5, 5)):
    """Seeded normal terms, representable in the product format."""
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(quantize(torch.from_numpy(x), FPFormat(*fmt)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("acc", [(6, 5), (6, 8), (5, 2), (8, 7), (6, 12),
                                 (8, 23)])
@pytest.mark.parametrize("shape", [(64, 200), (3, 5, 17), (1,)])
def test_sequential_accumulate_bitwise_jax(acc, shape):
    x = _terms(sum(acc) * 7 + len(shape), shape)
    got = sequential_accumulate(torch.from_numpy(x), FPFormat(*acc))
    want = JA.sequential_accumulate(jnp.asarray(x), JF(*acc))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("acc", [(6, 5), (6, 8), (5, 2), (8, 7)])
@pytest.mark.parametrize("n,chunk", [(256, 64), (200, 64), (7, 4), (5, 16),
                                     (130, 8)])
def test_chunked_accumulate_bitwise_jax(acc, n, chunk):
    # 200 and 130: a ragged tail chunk, padded with zeros; (5, 16): one
    x = _terms(n * 3 + chunk, (48, n))
    got = chunked_accumulate(torch.from_numpy(x), FPFormat(*acc), chunk)
    want = JA.chunked_accumulate(jnp.asarray(x), JF(*acc), chunk)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_accumulate_specials_bitwise_jax():
    # saturation at max_value, an inf term, a NaN term, signed zeros
    x = np.array([[1e5, 1e5, -3.0], [np.inf, 1.0, 2.0], [np.nan, 1.0, 0.0],
                  [-0.0, -0.0, -0.0], [2.0 ** -20, 2.0 ** -20, 1.0]],
                 np.float32)
    for acc in ((5, 2), (6, 5)):
        got = sequential_accumulate(torch.from_numpy(x), FPFormat(*acc))
        want = JA.sequential_accumulate(jnp.asarray(x), JF(*acc))
        np.testing.assert_array_equal(_bits(got), _bits(want))


# -------------------- Monte Carlo (tests/test_vrr_montecarlo.py) -----------


def mc_vrr(m_acc: int, n: int, *, chunk: int = 0, ensemble: int = 2048,
           seed: int = 0) -> float:
    gen = torch.Generator().manual_seed(seed)
    v = swamped_variance(gen, n, FPFormat(e=6, m=m_acc), FPFormat(e=5, m=5),
                         ensemble=ensemble, chunk=chunk, device="cpu")
    return float(v) / n


@pytest.mark.parametrize("m_acc,n", [
    (8, 1024),
    pytest.param(10, 16384, marks=pytest.mark.slow),
    pytest.param(12, 65536, marks=pytest.mark.slow),
    pytest.param(14, 65536, marks=pytest.mark.slow),
])
def test_mc_high_vrr_regime_tight(m_acc, n):
    th = TV.vrr(m_acc, 5, n)
    assert th > 0.99
    assert mc_vrr(m_acc, n) == pytest.approx(th, abs=0.08)


@pytest.mark.parametrize("m_acc,n", [
    (5, 1024), (6, 2048), (7, 4096),
    pytest.param(9, 65536, marks=pytest.mark.slow),
])
def test_mc_knee_region_theory_conservative(m_acc, n):
    th = TV.vrr(m_acc, 5, n)
    mc = mc_vrr(m_acc, n)
    assert 0.3 < th < 0.999
    assert th <= mc + 0.08


def test_mc_deep_swamping_both_collapse():
    assert TV.vrr(4, 5, 16384) < 0.45
    assert mc_vrr(4, 16384, ensemble=1024) < 0.35


def test_mc_chunking_improves_retention():
    m_acc, n = 6, 8192
    plain = mc_vrr(m_acc, n, ensemble=1024)
    chunked = mc_vrr(m_acc, n, chunk=64, ensemble=1024)
    assert chunked > plain
    assert chunked > 0.85
    assert chunked == pytest.approx(TV.vrr_chunked(m_acc, 5, 64, n // 64),
                                    abs=0.12)


def test_mc_variance_scaling_sanity():
    assert mc_vrr(20, 4096, ensemble=1024) == pytest.approx(1.0, abs=0.08)


def test_swamped_variance_population_variance():
    # jnp.var is the population variance: with a wide accumulator the
    # estimate is var(sums) / var(terms), both with divisor N
    gen = torch.Generator().manual_seed(3)
    got = swamped_variance(gen, 8, FP32_LIKE, FPFormat(5, 5), ensemble=16,
                           device="cpu")
    gen = torch.Generator().manual_seed(3)
    terms = quantize(torch.randn((16, 8), generator=gen), FPFormat(5, 5))
    sums = torch.zeros(16)
    for t in terms.T:
        sums = sums + t
    want = sums.var(correction=0) / terms.var(correction=0)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# ------------- properties (tests/test_properties.py, accumulators) ----------


def test_wide_accumulator_is_exact():
    pytest.importorskip("hypothesis", reason="needs `pip install -e .[test]`")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(st.integers(min_value=2, max_value=300),
           st.integers(min_value=0, max_value=2**31 - 1))
    def prop(n, seed):
        # a wide format's sequential emulation is the plain f32 sum
        x = np.random.RandomState(seed).standard_normal((4, n)).astype(
            np.float32)
        got = sequential_accumulate(torch.from_numpy(x), FP32_LIKE)
        want = np.cumsum(x, axis=-1, dtype=np.float32)[:, -1]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    prop()


def test_chunked_never_worse_retention():
    pytest.importorskip("hypothesis", reason="needs `pip install -e .[test]`")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=15, deadline=None)
    @given(st.integers(min_value=2, max_value=200),
           st.integers(min_value=4, max_value=64),
           st.integers(min_value=3, max_value=9))
    def prop(n, chunk, m_acc):
        # Corollary 1 on the emulation: chunking keeps at least about as
        # much ensemble variance as the sequential sum
        x = torch.from_numpy(_terms(n * 1000 + chunk, (256, n)))
        fmt = FPFormat(e=6, m=m_acc)
        vs = float(torch.var(sequential_accumulate(x, fmt), correction=0))
        vc = float(torch.var(chunked_accumulate(x, fmt, chunk), correction=0))
        assert vc >= 0.8 * vs

    prop()
