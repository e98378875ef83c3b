"""Port vs JAX package: the telemetry slice.

(a) The plain versions of K8 (``qmatmul_fused(collect_stats=True)``), K9
    (``qmatmul_bwd_pair(collect_stats=True)``) and K12
    (``paged_attn_decode(collect_stats=True)``) against the JAX Pallas stats
    kernels in interpret mode, on f32, bf16 and int8-code operands.
(b) ``EnsembleStats``: ``from_raw``, ``merge``, ``to_raw`` and the
    read-outs against the JAX class on the same rows.
(c) The precision controller's event log against the JAX controller's on
    the same probes (the under-provisioned bump, hysteresis, trim, pin).
(d) ``probe_model_stats`` on the smoke model against the JAX probe with
    the JAX draws injected: the same (plan field, role) keys, the same
    captured set (the lm_head only: ROADMAP Queue 3, capture rule), rows
    within bounds.
(e) ``run_telemetry_tick`` end to end under a perturbed plan.
(f) The tagged (in-graph telemetry) train step: bitwise the untagged
    step; its collector's keys and geometry are the JAX collector's and its
    rows within bounds.
(g) The serve-time monitor: a narrow plan re-buckets, keyed by the grown
    context; without a breach the streams are the monitor-off run's.

(d) and (f) run the JAX side in a child process with
``--xla_allow_excess_precision=false`` (ROADMAP F2), as
``tests/test_torch_train.py`` does.

Bounds on a stats row against JAX's (``_check_jax_row``): the counters
(COUNT, SWAMPED, ADDS) and MAX_ABS exactly (measured: exact on every case
here, where the outputs are bitwise or differ only where F0 moves a carry
without moving a count); the first-moment slots within ``rel *
sqrt(COUNT * sum of squares)`` (a Cauchy-Schwarz bound on the sum of
|terms|) and the square slots within ``rel * |value|``.  ``rel`` = 2^-16
where the outputs are bitwise: the JAX row adds f32 tile sums over the
grid (ROADMAP F6), measured at most 4.3e-6 (< 2^-17) relative; 2^(2 -
m_acc) where random operands' products are inexact in f32, so that the
dot order moves the ideal partials and may move a carry (F0).
"""

from __future__ import annotations

import copy
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
from repro.kernels.attention import paged_attn_decode as jax_decode
from repro.kernels.bwd_pair import qmatmul_bwd_pair as jax_pair
from repro.kernels.fused import qmatmul_fused as jax_qmatmul
from repro.quant.formats import FP8_152 as JFP8
from repro.quant.formats import FPFormat as JFPFormat
from repro_torch.core.policy import AccumulationPolicy, GEMMPrecision
from repro_torch.kernels.attention import paged_attn_decode
from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
from repro_torch.kernels.common import N_STATS, quantize_block
from repro_torch.kernels.fused import qmatmul_fused
from repro_torch.quant.formats import FP8_152
from repro_torch.telemetry.stats import EnsembleStats, gemm_stats
from test_torch_kernels import _arena, _lattice, _t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT_SLOTS = (0, 5, 6, 7)          # COUNT, MAX_ABS, SWAMPED, ADDS
FIRST = {1: 2, 3: 4, 8: 9}          # first-moment slot -> its square slot
SQUARE = (2, 4, 9)
REL_BITWISE = 2.0 ** -16


def _check_jax_row(label, got, want, rel):
    got = np.asarray(got, np.float64).reshape(-1, N_STATS)
    want = np.asarray(want, np.float64).reshape(-1, N_STATS)
    worst = 0.0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[list(EXACT_SLOTS)],
                                      w[list(EXACT_SLOTS)], err_msg=label)
        for s in SQUARE:
            bound = rel * abs(w[s])
            assert abs(g[s] - w[s]) <= bound, (label, s, g[s], w[s])
            worst = max(worst, abs(g[s] - w[s]) / max(bound, 1e-300))
        for s, sq in FIRST.items():
            bound = rel * np.sqrt(max(w[0] * w[sq], 0.0))
            assert abs(g[s] - w[s]) <= bound, (label, s, g[s], w[s])
            worst = max(worst, abs(g[s] - w[s]) / max(bound, 1e-300))
    print(f"{label}: counters and MAX_ABS exact, sum slots at {worst:.3g} "
          f"of the bound (rel {rel:.3g})")


# --------------------------------------------------------------------------
# (a) the stats kernels' plain versions against JAX
# --------------------------------------------------------------------------

K8_KINDS = ["f32", "bf16", "int8", "head", "prequantized_b"]


@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize("kind", K8_KINDS)
def test_gemm_stats_plain_matches_jax(kind, lattice):
    """K8's plain version against the JAX stats kernel: C bitwise (measured
    on random operands too), the row within ``_check_jax_row``'s bound;
    f32, bf16 and int8-code operands, the unquantized lm_head, and a
    pre-quantized operand with ``quantize_b=False`` (the probe's BWD)."""
    m, k, n = 37, 200, 75
    rng = np.random.RandomState(K8_KINDS.index(kind) * 2 + lattice)
    a = _lattice(rng, (m, k)) if lattice else rng.randn(m, k).astype(
        np.float32)
    b = _lattice(rng, (k, n)) if lattice else (
        rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    acc = (6, 9) if kind == "head" else (6, 5)
    kw = dict(e_acc=acc[0], m_acc=acc[1], block_k=64)
    rf, jrf = (None, None) if kind == "head" else (FP8_152, JFP8)
    extra = {}
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if kind in ("bf16", "head"):
        tb = tb.to(torch.bfloat16)
        b = tb.float().numpy()
    if kind == "int8":
        _, ta, tb = qmatmul_fused(ta, tb, repr_fmt=FP8_152,
                                  return_quantized=True)
        a, b = ta.numpy(), tb.numpy()
        extra = dict(a_packed=True, b_packed=True)
    if kind == "prequantized_b":
        tb = quantize_block(tb, 5, 2)
        b = tb.numpy()
        extra = dict(quantize_b=False)
    jy, jrow = jax_qmatmul(jnp.asarray(a), jnp.asarray(b), repr_fmt=jrf,
                           collect_stats=True, **kw, **extra)
    y, row = qmatmul_fused(ta, tb, repr_fmt=rf, collect_stats=True, **kw,
                           **extra)
    assert y.shape == (m, n) and row.shape == (N_STATS,)
    assert row.dtype == torch.float32 and float(row[0]) == m * n
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    _check_jax_row(f"K8 {kind} {'lattice' if lattice else 'random'}",
                   row.numpy(), jrow, REL_BITWISE)
    # C is the stats-off call's (G quantizes both operands; quantizing the
    # pre-quantized one again changes nothing)
    if kind != "int8":
        assert torch.equal(y, qmatmul_fused(ta, tb, repr_fmt=rf, **kw))


@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize("packed", [True, False])
def test_bwd_pair_stats_plain_matches_jax(packed, lattice):
    """K9's plain version against the JAX stats pair: dx and dw bitwise
    on lattice operands and on the packed (exact-product) case; on raw
    random f32 operands (the lm_head's layout) the products are inexact,
    so XLA's dot order may move a carry (F0): held to 0.1% of the outputs
    within one carry ulp (measured bitwise), and the rows' sums, whose
    ideal partials do move, to rel 2^(2 - m_acc) (measured 0.0027 of it);
    rows 0 (BWD) and 1 (GRAD)."""
    t, k, n = 40, 72, 150
    rng = np.random.RandomState(10 + 2 * packed + lattice)
    mk = (lambda s: _lattice(rng, s)) if lattice else (
        lambda s: rng.randn(*s).astype(np.float32))
    g, x, w = mk((t, n)), mk((t, k)), mk((k, n)) / 4
    acc = (6, 5) if packed else (6, 9)
    if packed:
        _, xq, wq = qmatmul_fused(torch.from_numpy(x), torch.from_numpy(w),
                                  repr_fmt=FP8_152, return_quantized=True)
        jx, jw = xq.numpy(), wq.numpy()
    else:
        xq, wq, jx, jw = torch.from_numpy(x), torch.from_numpy(w), x, w
    rf, jrf = (FP8_152, JFP8) if packed else (None, None)
    jdx, jdw, jrows = jax_pair(
        jnp.asarray(g), jnp.asarray(jx), jnp.asarray(jw), repr_fmt=jrf,
        bwd_acc=acc, grad_acc=acc, block_t=16, block_k=32, block_n=64,
        packed=packed, quantize_g=packed, collect_stats=True)
    kw = dict(repr_fmt=rf, bwd_acc=acc, grad_acc=acc, bwd_chunk=64,
              grad_chunk=16, packed=packed, quantize_g=packed)
    dx, dw, rows = qmatmul_bwd_pair(torch.from_numpy(g), xq, wq,
                                    collect_stats=True, **kw)
    assert rows.shape == (2, N_STATS)
    assert (float(rows[0, 0]), float(rows[1, 0])) == (t * k, k * n)
    bdx, bdw = qmatmul_bwd_pair(torch.from_numpy(g), xq, wq, **kw)
    assert torch.equal(dx, bdx) and torch.equal(dw, bdw)
    bitwise = lattice or packed
    for got, want in ((dx, jdx), (dw, jdw)):
        got, want = got.numpy(), np.asarray(want)
        if bitwise:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.mean(got != want) <= 0.001
            np.testing.assert_allclose(got, want, rtol=2.0 ** -acc[1],
                                       atol=0)
    _check_jax_row(f"K9 packed={packed} lattice={lattice}", rows.numpy(),
                   jrows, REL_BITWISE if bitwise else 2.0 ** (2 - acc[1]))


@pytest.mark.parametrize("acc", [(6, 5), (6, 2)])
def test_decode_stats_plain_matches_jax(acc):
    """K12's plain version against the JAX stats decode kernel on a page
    table wider than the pages in use (6 columns, at most 4 used: the JAX
    kernel walks all 6 and takes the moments on the last, the CUDA kernel
    stops at each row's last page; ROADMAP T6), with a length-0 row."""
    rng = np.random.RandomState(21 + acc[1])
    kc, vc, kse, vse = _arena(rng)
    seq_lens = np.array([0, 5, 16, 37, 50], np.int32)
    pt = np.zeros((5, 6), np.int32)
    pt[1, :1] = [3]
    pt[2, :1] = [5]
    pt[3, :3] = [2, 7, 1]
    pt[4, :4] = [8, 4, 6, 2]
    q = rng.randn(5, 6, 16).astype(np.float32)
    jo, jrow = jax_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kse),
        jnp.asarray(vse), jnp.asarray(pt), jnp.asarray(seq_lens),
        kv_fmt=JFPFormat(5, 2), acc=acc, collect_stats=True)
    args = (_t(q), _t(kc), _t(vc), _t(kse), _t(vse), _t(pt), _t(seq_lens))
    o, row = paged_attn_decode(*args, kv_fmt=FP8_152, acc=acc,
                               collect_stats=True)
    assert torch.equal(o, paged_attn_decode(*args, kv_fmt=FP8_152, acc=acc))
    assert float(row[0]) == 4 * 6 * 16     # the 4 rows with seq_len > 0
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    _check_jax_row(f"K12 acc {acc}", row.numpy(), jrow, REL_BITWISE)


def test_stats_entries_reject_what_jax_rejects():
    a, b = torch.zeros((4, 8)), torch.zeros((8, 3))
    with pytest.raises(ValueError):   # stats and residuals are exclusive
        qmatmul_fused(a, b, repr_fmt=FP8_152, collect_stats=True,
                      return_quantized=True)
    with pytest.raises(ValueError):   # packed operands need a format
        qmatmul_fused(a.to(torch.int8), b, a_packed=True, collect_stats=True)
    with pytest.raises(ValueError):   # not a rounding mode
        qmatmul_fused(a, b, repr_fmt=FP8_152, collect_stats=True,
                      rounding="nearest")
    g = torch.zeros((4, 3))
    with pytest.raises(ValueError):   # the stats pair takes no carry in
        qmatmul_bwd_pair(g, a, b, repr_fmt=None, packed=False,
                         collect_stats=True, dx_carry=torch.zeros((4, 8)))
    with pytest.raises(ValueError):
        qmatmul_bwd_pair(g, a, b, repr_fmt=None, packed=False,
                         collect_stats=True, rounding="nearest")


@pytest.mark.parametrize("extra", [
    dict(quantize_a=False), dict(quantize_b=False), dict(a_packed=True)])
def test_stats_only_operand_options_need_collect_stats(extra):
    """Per-operand quantization and int8-code operands are K8's options:
    G and E refuse them, K8 takes them."""
    a, b = torch.randn((4, 8)), torch.randn((8, 3))
    if extra.get("a_packed"):
        _, a, _ = qmatmul_fused(a, b, repr_fmt=FP8_152, return_quantized=True)
    for emit in (False, True):
        with pytest.raises(ValueError):
            qmatmul_fused(a, b, repr_fmt=FP8_152, return_quantized=emit,
                          **extra)
    c, row = qmatmul_fused(a, b, repr_fmt=FP8_152, collect_stats=True,
                           **extra)
    assert c.shape == (4, 3) and float(row[0]) == 12


# --------------------------------------------------------------------------
# (b) EnsembleStats
# --------------------------------------------------------------------------


def _rows():
    """Rows as the kernels give them: K8 of the JAX kernel on three GEMMs,
    a cancellation-prone row (mean >> spread) and the empty row."""
    from repro.telemetry.stats import gemm_stats as jgs

    rows = []
    rng = np.random.RandomState(3)
    for m_acc, shift in ((5, 0.0), (2, 0.0), (5, 8.0)):
        a = (rng.randn(24, 128) + shift).astype(np.float32)
        b = rng.randn(128, 20).astype(np.float32)
        _, st = jgs(jnp.asarray(a), jnp.asarray(b), repr_fmt=JFP8,
                    precision=JGP(m_acc=m_acc, e_acc=6, chunk=32))
        rows.append(np.asarray(st.to_raw(), np.float32))
    rows.append(np.array([1000.0, 100003.3, 10000660.0, 100003.0,
                          10000600.0, 104.0, 3.0, 100.0, 0.01, 0.2],
                         np.float32))
    rows.append(np.zeros(N_STATS, np.float32))
    return rows


_FIELDS = ("count", "mean_q", "m2_q", "mean_i", "m2_i", "max_abs",
           "swamped", "adds", "err_sum", "err_sumsq")


def _j(st):
    from repro.telemetry.stats import EnsembleStats as JES

    return JES(*[jnp.float32(getattr(st, f)) for f in _FIELDS])


def test_ensemble_stats_from_raw_matches_jax():
    """from_raw: the fields copied from the row bitwise; the means within
    one f32 ulp; M2 within 2^-21 of the row's sum of squares (the port
    centers in float64, the JAX class in effect in float32: ROADMAP F6; on
    the cancellation-prone row the two differ by 0.39 of an M2 of 0.61)."""
    from repro.telemetry.stats import EnsembleStats as JES

    for raw in _rows():
        st, js = EnsembleStats.from_raw(raw), JES.from_raw(raw)
        for f in ("count", "max_abs", "swamped", "adds", "err_sum",
                  "err_sumsq"):
            assert getattr(st, f) == np.float32(getattr(js, f)), f
            assert isinstance(getattr(st, f), np.float32)
        for f in ("mean_q", "mean_i"):
            np.testing.assert_allclose(getattr(st, f), getattr(js, f),
                                       rtol=2.0 ** -23)
        for f, sq in (("m2_q", 2), ("m2_i", 4)):
            assert abs(float(getattr(st, f)) - float(getattr(js, f))) <= \
                2.0 ** -21 * float(raw[sq]), f
        # from a device-style tensor too
        assert EnsembleStats.from_raw(torch.from_numpy(raw.copy())) == st


def test_ensemble_stats_merge_readouts_to_raw_match_jax():
    """On the same fields, merge, to_raw and every read-out are the JAX
    class's bitwise (both float32 arithmetic in the same order), except
    max_exponent's log2, within one f32 ulp (XLA's log2 is log times
    1/ln 2: ROADMAP F3)."""
    stats = [EnsembleStats.from_raw(r) for r in _rows()]
    for a in stats:
        ja = _j(a)
        np.testing.assert_array_equal(a.to_raw(), np.asarray(ja.to_raw()))
        for prop in ("var_q", "var_i", "measured_vrr", "swamp_rate",
                     "error_mse", "error_bias", "noise_ratio",
                     "jitter_fraction"):
            assert np.float32(getattr(a, prop)) == np.float32(
                getattr(ja, prop)), prop
        np.testing.assert_allclose(a.max_exponent, ja.max_exponent,
                                   rtol=2.0 ** -23)
        for n in (8, 512):
            assert a.measured_log_v(n) == ja.measured_log_v(n)
            assert a.measured_log_v_sr(n) == ja.measured_log_v_sr(n)
            assert a.suitable(n) == ja.suitable(n)
        for b in stats:
            got, want = a.merge(b), ja.merge(_j(b))
            for f in _FIELDS:
                assert getattr(got, f) == np.float32(getattr(want, f)), f
    z = EnsembleStats.zero()
    assert z.merge(stats[0]) == stats[0]
    with pytest.raises(NotImplementedError):
        stats[0].psum("data")


# --------------------------------------------------------------------------
# (c) the controller's event log against JAX's
# --------------------------------------------------------------------------

NUMERIC = ("measured_vrr", "predicted_vrr", "log_v", "log_v_pred",
           "swamp_rate", "noise_ratio", "jitter_fraction", "max_exp")
SAME = ("step", "gemm", "role", "event", "source", "m_acc", "m_pred", "n",
        "n1", "n2", "cutoff", "rounding")


def _check_events(got, want, vrr_tol):
    """Event, source, m_acc and the geometry identical; the measured
    numbers within ``vrr_tol`` (VRR, swamp rate, noise) or ``vrr_tol *
    n2`` (log v); the closed-form ones identical."""
    assert len(got) == len(want)
    for e, je in zip(got, want):
        assert set(e) == set(je)
        for k in SAME:
            assert e[k] == je[k], (k, e, je)
        for k in ("predicted_vrr", "log_v_pred"):
            assert e[k] == je[k], k
        for k in ("measured_vrr", "swamp_rate", "noise_ratio",
                  "jitter_fraction"):
            assert abs(e[k] - je[k]) <= vrr_tol, (k, e[k], je[k])
        assert abs(e["log_v"] - je["log_v"]) <= vrr_tol * e["n2"] + 1e-4
        assert (e["max_exp"] is None) == (je["max_exp"] is None)
        if e["max_exp"] is not None:
            assert abs(e["max_exp"] - je["max_exp"]) <= 0.01


def test_controller_converges_like_jax_on_underprovisioned_layer(tmp_path):
    """The JAX package's smoke gate (start 2 bits under the solver bound
    on a K = 64 x 512 layer), run by both controllers on the same operands
    through each package's K8: the same events tick for tick (bump, bump,
    ok), and the same JSONL schema on disk."""
    from repro.core.policy import AccumulationPolicy as JPol
    from repro.telemetry.controller import ControllerConfig as JCC
    from repro.telemetry.controller import GemmProbe as JGPr
    from repro.telemetry.controller import PrecisionController as JPC
    from repro.telemetry.stats import gemm_stats as jgs
    from repro_torch.core.precision import min_m_acc
    from repro_torch.telemetry.controller import (
        ControllerConfig,
        GemmProbe,
        PrecisionController,
    )

    n1, n2 = 64, 512
    k_len = n1 * n2
    rng = np.random.RandomState(0)
    x = rng.randn(32, k_len).astype(np.float32)
    w = rng.randn(k_len, 32).astype(np.float32)
    m_pred = min_m_acc(k_len, 5, chunked=True, chunk=n1)
    ctl = PrecisionController(AccumulationPolicy(mode="predicted", chunk=n1),
                              ControllerConfig(cadence=1, hysteresis=1),
                              log_path=str(tmp_path / "port.jsonl"))
    jctl = JPC(JPol(mode="predicted", chunk=n1), JCC(cadence=1, hysteresis=1),
               log_path=str(tmp_path / "jax.jsonl"))
    m = m_pred - 2
    kinds = []
    for step in range(1, 6):
        _, st = gemm_stats(torch.from_numpy(x), torch.from_numpy(w),
                           repr_fmt=FP8_152,
                           precision=GEMMPrecision(m_acc=m, e_acc=6,
                                                   chunk=n1))
        _, jst = jgs(jnp.asarray(x), jnp.asarray(w), repr_fmt=JFP8,
                     precision=JGP(m_acc=m, e_acc=6, chunk=n1))
        ev = ctl.observe(step, {("layer", "grad"): GemmProbe(
            stats=st, n=k_len, n1=n1, m_acc=m)})
        jev = jctl.observe(step, {("layer", "grad"): JGPr(
            stats=jst, n=k_len, n1=n1, m_acc=m)})
        _check_events(ev, jev, 1e-5)
        kinds.append(ev[0]["event"])
        m = ev[0]["m_acc"]
        if ev[0]["event"] == "ok":
            break
    assert kinds[0] == "bump" and kinds[-1] == "ok", kinds
    assert abs(m - m_pred) <= 1
    logged = [json.loads(ln) for ln in open(tmp_path / "port.jsonl")]
    jlogged = [json.loads(ln) for ln in open(tmp_path / "jax.jsonl")]
    assert [set(e) for e in logged] == [set(e) for e in jlogged]
    assert ctl.schedule() == jctl.schedule() == {("layer", "grad"): m}


def test_controller_hysteresis_trim_pin_match_jax():
    """Hysteresis, trim and the pinned lm_head on one hand-made window, fed
    to both controllers: identical events (every field)."""
    from repro.core.policy import AccumulationPolicy as JPol
    from repro.telemetry.controller import ControllerConfig as JCC
    from repro.telemetry.controller import GemmProbe as JGPr
    from repro.telemetry.controller import PrecisionController as JPC
    from repro_torch.core.precision import min_m_acc
    from repro_torch.telemetry.controller import (
        ControllerConfig,
        GemmProbe,
        PrecisionController,
    )

    raw = np.array([4096.0, 0.0, 4095.0, 0.0, 4096.0, 64.0, 1.0, 4096.0,
                    0.0, 0.0], np.float32)
    st = EnsembleStats.from_raw(raw)
    k_len = 64 * 512
    m_pred = min_m_acc(k_len, 5, chunked=True, chunk=64)
    for hyst, name, m_acc in ((2, "mlp_up", m_pred + 3), (1, "lm_head", 9)):
        ctl = PrecisionController(AccumulationPolicy(mode="predicted",
                                                     chunk=64),
                                  ControllerConfig(hysteresis=hyst))
        jctl = JPC(JPol(mode="predicted", chunk=64), JCC(hysteresis=hyst))
        for step in (1, 2, 3):
            ev = ctl.observe(step, {(name, "grad"): GemmProbe(
                stats=st, n=k_len, n1=64, m_acc=m_acc)})
            jev = jctl.observe(step, {(name, "grad"): JGPr(
                stats=_j(st), n=k_len, n1=64, m_acc=m_acc)})
            assert ev == jev
        assert ctl.to_meta() == jctl.to_meta()
    assert ev[0]["event"] == "ok"          # lm_head is pinned


def test_apply_schedule_and_meta_roundtrip():
    from repro_torch.configs import get_smoke_config
    from repro_torch.telemetry.controller import (
        PrecisionController,
        apply_schedule,
    )

    policy = AccumulationPolicy(mode="predicted", chunk=64)
    ctl = PrecisionController(policy)
    ctl._schedule[("mlp_up", "grad")] = 11
    meta = ctl.to_meta()
    assert meta == {"mlp_up:grad": 11}
    ctl2 = PrecisionController(policy)
    ctl2.restore_meta(meta)
    assert ctl2.schedule() == {("mlp_up", "grad"): 11}
    cfg = apply_schedule(get_smoke_config("qwen2-1.5b"), policy,
                         {("mlp_up", "grad"): 11, ("lm_head", "fwd"): 99},
                         seq_len=32, global_batch=2)
    assert cfg.quant.mlp_up.grad.m_acc == 11
    assert cfg.quant.lm_head.fwd.m_acc == 23    # clamped to the f32 carrier
    base = apply_schedule(get_smoke_config("qwen2-1.5b"), policy, {},
                          seq_len=32, global_batch=2)
    assert cfg.quant.mlp_up.fwd == base.quant.mlp_up.fwd


# --------------------------------------------------------------------------
# (d), (f): the smoke model against a JAX child process
# --------------------------------------------------------------------------

SEQ, BATCH, CHUNK = 16, 2, 16


def _plans():
    from repro.configs import get_smoke_config as jsmoke
    from repro.core.policy import AccumulationPolicy as JPol
    from repro.core.policy import plan_for_model as jplan
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import plan_for_model

    jcfg = jplan(jsmoke("qwen2-1.5b"), seq_len=SEQ, global_batch=BATCH,
                 policy=JPol(mode="perturbed", perturbation=-2, chunk=CHUNK))
    tcfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=SEQ,
                          global_batch=BATCH,
                          policy=AccumulationPolicy(mode="perturbed",
                                                    perturbation=-2,
                                                    chunk=CHUNK))
    return jcfg, tcfg


def _tokens():
    return np.random.RandomState(7).randint(0, 256, (BATCH, SEQ)).astype(
        np.int32)


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflat(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = torch.from_numpy(v.copy())
    return tree


def telemetry_child(out_path: str) -> None:
    """The JAX side of (d) and (f): the probe with its draws recorded, the
    captured plan fields, and the tagged step's collector.  Run with
    ``--xla_allow_excess_precision=false`` (ROADMAP F2)."""
    from repro.models.api import get_model as jget
    from repro.models.layers import LOCAL, Dist
    from repro.obs.ingraph import InGraphCollector, collecting, tag_quant_plan
    from repro.telemetry import capture
    from repro.telemetry.probe import _plan_field, probe_model_stats
    from repro.train.loop import TrainConfig, init_train_state, make_train_step

    jcfg, _ = _plans()
    model = jget(jcfg)
    state = init_train_state(model, jax.random.PRNGKey(0), TrainConfig())
    batch = {"tokens": jnp.asarray(_tokens())}
    out = _flat(state["params"], "p0", {})
    draws, orig = [], jax.random.normal

    def recorded(key, shape=(), dtype=jnp.float32):
        x = orig(key, shape, dtype)
        draws.append(np.asarray(x))
        return x

    jax.random.normal = recorded
    try:
        probes = probe_model_stats(model, state["params"], batch,
                                   key=jax.random.PRNGKey(1))
    finally:
        jax.random.normal = orig
    for i, d in enumerate(draws):
        out[f"draw{i}"] = d
    meta = {"probe": [], "captured": [], "collector": []}
    for (name, role), p in sorted(probes.items()):
        meta["probe"].append([name, role, p.n, p.n1, p.m_acc])
        out[f"probe/{name}/{role}"] = np.array(
            [float(getattr(p.stats, f)) for f in _FIELDS], np.float64)
    with capture.capture_gemms() as buf:
        model.loss_fn(state["params"], batch, jcfg, LOCAL)
    meta["captured"] = [_plan_field(jcfg.quant, r["cfg"]) for r in buf]
    tagged = jget(tag_quant_plan(jcfg))
    fn = jax.jit(make_train_step(tagged, TrainConfig(), Dist()))
    col = InGraphCollector()
    with collecting(col):
        _, m = fn(state, batch)
        jax.block_until_ready(m)
        jax.effects_barrier()
    for (tag, role), cell in sorted(col._cells.items()):
        meta["collector"].append([tag, role, cell["n"], cell["n1"],
                                  cell["m_acc"]])
        out[f"col/{tag}/{role}"] = cell["row"]
    out["loss"] = np.asarray(m["loss"])
    out["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_telemetry") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    child = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_telemetry as t; t.telemetry_child({path!r})"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
    assert child.returncode == 0, child.stdout + child.stderr
    data = dict(np.load(path))
    data["meta"] = json.loads(bytes(data["meta"]).decode())
    return data


def _check_stats_fields(label, st, want, rel):
    """Counts exact; MAX_ABS within one f32 ulp; means within ``rel`` of
    the spread sqrt(M2 / count) plus 2^-22 of the mean; M2 within ``rel``
    of itself."""
    got = np.array([float(getattr(st, f)) for f in _FIELDS])
    assert got[0] == want[0] and got[6] == want[6] and got[7] == want[7], \
        (label, got, want)
    np.testing.assert_allclose(got[5], want[5], rtol=2.0 ** -23)
    for mean, m2 in ((1, 2), (3, 4)):
        spread = np.sqrt(want[m2] / max(want[0], 1.0))
        assert abs(got[mean] - want[mean]) <= rel * spread + \
            2.0 ** -22 * abs(want[mean]), (label, mean, got, want)
        assert abs(got[m2] - want[m2]) <= rel * want[m2], (label, m2)


def test_probe_model_stats_matches_jax(jax_side, monkeypatch):
    """The eager probe on the smoke model (perturbed plan, PP = -2, chunk
    16) with the JAX draws fed through ``probe._normal``: the captured set
    is the JAX one (the lm_head only: the layer loop does not record), the
    (field, role) keys and their geometry are identical, and every window
    is within ``_check_stats_fields``'s bound with rel = 2^-16."""
    from repro_torch.models.api import get_model
    from repro_torch.telemetry import capture, probe
    from repro_torch.telemetry.probe import _plan_field, probe_model_stats

    _, tcfg = _plans()
    meta = jax_side["meta"]
    params = _unflat(jax_side, "p0")
    batch = {"tokens": torch.from_numpy(_tokens())}
    model = get_model(tcfg)
    with torch.no_grad(), capture.capture_gemms() as buf:
        model.loss_fn(params, batch, tcfg)
    assert [_plan_field(tcfg.quant, r["cfg"]) for r in buf] == \
        meta["captured"] == ["lm_head"]
    draws = [jax_side[f"draw{i}"]
             for i in range(sum(k.startswith("draw") for k in jax_side))]
    queue = list(draws)

    def from_jax(gen, shape):
        d = queue.pop(0)
        assert d.shape == tuple(shape)
        return torch.from_numpy(d.copy())

    monkeypatch.setattr(probe, "_normal", from_jax)
    probes = probe_model_stats(model, params, batch,
                               gen=torch.Generator().manual_seed(1))
    assert not queue, "the port drew fewer arrays than JAX"
    assert sorted([k[0], k[1], p.n, p.n1, p.m_acc]
                  for k, p in probes.items()) == sorted(meta["probe"])
    for (name, role), p in probes.items():
        _check_stats_fields(f"{name}/{role}", p.stats,
                            jax_side[f"probe/{name}/{role}"], 2.0 ** -16)


def test_tagged_step_is_bitwise_the_untagged_step(jax_side):
    """One tagged train step of the smoke model (the in-graph telemetry
    tick's step) against the untagged one from the same state: loss and
    every state leaf bitwise.  The collector's (tag, role) keys and their
    (n, n1, m_acc) are the JAX collector's on the same weights and tokens,
    and its merged rows within ``_check_jax_row``'s bound (rel 2^-16)."""
    from repro_torch.models.api import get_model
    from repro_torch.obs.ingraph import (
        InGraphCollector,
        collecting,
        tag_quant_plan,
    )
    from repro_torch.train import optimizer as O
    from repro_torch.train.loop import TrainConfig, make_train_step

    _, tcfg = _plans()
    tc = TrainConfig()
    params = _unflat(jax_side, "p0")
    state = {"params": params, "opt": O.init_opt_state(params),
             "scaler": O.init_scaler(tc.scaler)}
    batch = {"tokens": torch.from_numpy(_tokens())}
    s0, m0 = make_train_step(get_model(tcfg), tc)(copy.deepcopy(state),
                                                  batch)
    tagged = get_model(tag_quant_plan(tcfg))
    col = InGraphCollector()
    with collecting(col):
        s1, m1 = make_train_step(tagged, tc)(copy.deepcopy(state), batch)
    assert torch.equal(m0["loss"], m1["loss"])
    l0, l1 = O.tree_leaves(s0), O.tree_leaves(s1)
    assert len(l0) == len(l1)
    for a, b in zip(l0, l1):
        assert torch.equal(a, b)
    rows = col.rows()
    probes = col.probes()
    want = jax_side["meta"]["collector"]
    assert sorted([k[0], k[1], p.n, p.n1, p.m_acc]
                  for k, p in probes.items()) == sorted(want)
    assert len(want) == 15     # 5 plan fields x 3 roles
    print(f"loss {float(m1['loss']):.6f} vs JAX {float(jax_side['loss']):.6f}")
    for key, row in rows.items():
        _check_jax_row(f"in-graph {key}", row,
                       jax_side[f"col/{key[0]}/{key[1]}"], REL_BITWISE)


# --------------------------------------------------------------------------
# (e) the eager tick end to end; the launcher
# --------------------------------------------------------------------------


def test_run_telemetry_tick_end_to_end(tmp_path):
    """Under a perturbed plan (PP = -2) every plan field x role of the smoke
    model gets a verdict; a re-planned model changes the plan."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import plan_for_model
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.api import get_model
    from repro_torch.telemetry.controller import (
        PLAN_FIELDS,
        ROLES,
        ControllerConfig,
        PrecisionController,
    )
    from repro_torch.train.loop import (
        TrainConfig,
        init_train_state,
        run_telemetry_tick,
    )

    policy = AccumulationPolicy(mode="perturbed", perturbation=-2, chunk=64)
    cfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=16,
                         global_batch=2, policy=policy)
    model = get_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu",
                             TrainConfig())
    batch = next(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=16, global_batch=2)))
    ctl = PrecisionController(policy, ControllerConfig(cadence=1,
                                                       hysteresis=1),
                              log_path=str(tmp_path / "t.jsonl"))
    n0 = qmatmul_fused.stats_launches
    events, new_model = run_telemetry_tick(
        ctl, model, state, batch, step=1,
        gen=torch.Generator().manual_seed(1), seq_len=16, global_batch=2)
    assert qmatmul_fused.stats_launches == n0   # CPU: the plain versions
    assert {(e["gemm"], e["role"]) for e in events} == {
        (f, r) for f in PLAN_FIELDS for r in ROLES}
    logged = [json.loads(ln) for ln in open(tmp_path / "t.jsonl")]
    assert len(logged) == len(events) == 15
    if new_model is not None:
        assert new_model.cfg.quant != model.cfg.quant


@pytest.mark.parametrize("ingraph", [False, True])
def test_launch_train_telemetry_cpu(tmp_path, capsys, ingraph):
    """The launcher with ``--telemetry-cadence`` (eager probe, or the
    tagged step with ``--ingraph-telemetry``): one event per (field, role)
    per tick logged; the in-graph run's losses are the plain run's."""
    from repro_torch.launch.train import main

    base = ["--smoke", "--steps", "4", "--global-batch", "2", "--seq-len",
            "16", "--log-every", "1", "--chunk", "16", "--policy",
            "perturbed", "--pp", "-2", "--device", "cpu"]
    log = str(tmp_path / "t.jsonl")
    out = main(base + ["--telemetry-cadence", "2", "--telemetry-log", log]
               + (["--ingraph-telemetry"] if ingraph else []))
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"step"')]
    logged = [json.loads(ln) for ln in open(log)]
    assert len(logged) == 2 * 15 and {e["step"] for e in logged} == {2, 4}
    main(base)
    plain = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"step"')]
    assert np.isfinite(out["final_loss"]) and len(recs) == 4
    if ingraph or not out["schedule"]:
        assert [r["loss"] for r in recs] == [r["loss"] for r in plain]
    with pytest.raises(SystemExit):
        main(base + ["--ingraph-telemetry"])


# --------------------------------------------------------------------------
# capture and the config's telemetry fields
# --------------------------------------------------------------------------


def test_capture_records_quantized_gemms_and_suspends():
    from repro_torch.kernels.ops import QDotConfig, qdot
    from repro_torch.telemetry import capture

    x, w = torch.randn(2, 8, 16), torch.randn(16, 4)
    cfg = QDotConfig(fwd=GEMMPrecision(m_acc=6, chunk=8), repr_fmt=FP8_152)
    with capture.capture_gemms() as buf:
        qdot(x, w, cfg)
        qdot(x, w, QDotConfig())            # exact: not recorded
        with capture.suspended():
            assert not capture.active()
            qdot(x, w, cfg)
        assert capture.active()
    assert len(buf) == 1 and buf[0]["x"].shape == (16, 16)
    assert buf[0]["cfg"] is cfg and not capture.active()
    with pytest.raises(NotImplementedError):
        QDotConfig(stats_axis="data")


# --------------------------------------------------------------------------
# (g) the serve-time monitor
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_serving():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import get_model

    model = get_model(get_smoke_config("qwen2-1.5b"))
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    return model, params


def _engine(model, params, **kw):
    from repro_torch.serve.scheduler import ServeEngine

    kw.setdefault("n_pages", 24)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_batch", 4)
    return ServeEngine(model, params, device="cpu", **kw)


def test_engine_monitor_rebuckets_on_breach(smoke_serving, tmp_path):
    """A 1-bit carry (the JAX package's test plan): the monitor logs a
    rebucket and widens the plan mid-serve; its events go to the log."""
    from repro_torch.serve.plan import AttnBucket, AttnPlan

    model, params = smoke_serving
    narrow = AttnPlan(page_size=4, m_p=5,
                      buckets=(AttnBucket(max_ctx=92, e_acc=6, m_acc=1),))
    log = str(tmp_path / "monitor.jsonl")
    eng = _engine(model, params, plan=narrow, monitor_cadence=2,
                  monitor_log=log)
    eng.submit(list(range(1, 30)), 8)
    eng.run()
    rebuckets = [e for e in eng.events if e["event"] == "rebucket"]
    assert rebuckets, f"no rebucket event in {eng.events}"
    assert rebuckets[0]["source"] in ("measured", "both")
    assert eng.plan.buckets[0].m_acc > 1
    assert [json.loads(ln) for ln in open(log)] == eng.events
    assert {"v_hint_plan", "v_hint_measured", "swamp_threshold"} <= \
        set(eng.events[0])


def test_engine_monitor_keys_the_grown_context(smoke_serving):
    """A prompt admitted in bucket 0 (contexts <= 16) that grows past it
    is probed and re-bucketed in bucket 1, whose width the breach raises;
    bucket 0 keeps its width."""
    from repro_torch.serve.plan import AttnBucket, AttnPlan

    model, params = smoke_serving
    plan = AttnPlan(page_size=4, m_p=5, buckets=(
        AttnBucket(max_ctx=16, e_acc=6, m_acc=10),
        AttnBucket(max_ctx=92, e_acc=6, m_acc=1)))
    eng = _engine(model, params, plan=plan, monitor_cadence=6)
    eng.submit(list(range(1, 15)), 10)
    eng.run()
    first = eng.events[0]
    assert first["ctx"] > 16 and first["bucket"] == 1
    assert first["event"] == "rebucket"
    assert eng.plan.buckets[0].m_acc == 10 and eng.plan.buckets[1].m_acc > 1


def test_engine_monitor_without_breach_keeps_the_streams(smoke_serving):
    """The default plan: the monitor only measures (no rebucket), and the
    token streams are the monitor-off run's."""
    model, params = smoke_serving
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 9, 13)]

    def run(**kw):
        eng = _engine(model, params, **kw)
        rids = [eng.submit(p, 6) for p in prompts]
        out = eng.run()
        return eng, [out[r] for r in rids]

    on, streams_on = run(monitor_cadence=2)
    off, streams_off = run()
    assert on.events and all(e["event"] == "ok" for e in on.events)
    assert off.events == []
    assert streams_on == streams_off
