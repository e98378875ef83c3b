"""Port vs JAX package: the unfused ``qdot`` oracle (``QDotConfig(
fused=False)``) and its kernels K2 (quantize) and K3 (chunked qmatmul).

Tolerances, as in ``tests/test_torch_kernels.py``:

* K2's plain version is elementwise integer code: bitwise ``quantize_pallas``
  (interpret mode) on every input, inf, NaN, -0.0, subnormals and the
  (8, 23) identity included.
* K3's plain version and the oracle's GEMMs are contractions: bitwise
  ``qmatmul_pallas`` on lattice operands (every f32 order of a chunk's
  partial is exact) and within 1 ulp of the carry format on random ones,
  the mismatch fraction printed (XLA's dot sums the partial in another
  order than the port; ROADMAP F0).  Measured: bitwise on every case here.
* Inside the port the oracle is the fused path's function: y, dx and dw
  bitwise the fused ``qdot``'s, and a training step of the smoke model
  bitwise in the loss and every gradient leaf.  The serving forward too.
"""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import GEMMPrecision as JGP
from repro.kernels.ops import QDotConfig as JQC, qdot as jax_qdot
from repro.kernels.qmatmul import qmatmul_pallas
from repro.kernels.quantize import quantize_pallas
from repro.quant.formats import FP8_152 as JFP8
from repro.quant.formats import FPFormat as JF
from repro_torch.core.policy import GEMMPrecision
from repro_torch.kernels.ops import QDotConfig, qdot, quantize_op
from repro_torch.kernels.qmatmul import qmatmul, qmatmul_reference
from repro_torch.kernels.quantize import quantize, quantize_reference
from repro_torch.kernels.ref import ref_qmatmul, ref_quantize
from repro_torch.quant.formats import FP8_152, FPFormat
from repro_torch.quant.qnum import quantize as qnum_quantize


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def ulps(got, want, m: int, e: int) -> np.ndarray:
    """|got - want| in units of the (1, e, m) ulp at max(|got|, |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ex = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    return np.abs(got - want) / np.exp2(np.maximum(ex, -(2 ** (e - 1) - 1)) - m)


def _check(label, got, want, acc, lattice):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    u = ulps(got, want, acc[1], acc[0])
    print(f"{label}: mismatch fraction {np.mean(got != want):.5f}, max "
          f"{u.max():.2f} ulp of (1,{acc[0]},{acc[1]})")
    if lattice:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        assert u.max() <= 1.0


def _lattice(rng, shape):
    """(1,5,2) points over a narrow exponent range: every f32 sum of a
    chunk's products is exact."""
    e = rng.randint(-2, 3, size=shape)
    j = rng.randint(0, 4, size=shape)
    s = rng.choice([-1.0, 1.0], size=shape)
    x = s * np.exp2(e) * (1 + j / 4)
    x[rng.rand(*shape) < 0.1] = 0.0
    return x.astype(np.float32)


# --------------------------------------------------------------------------
# K2: quantize
# --------------------------------------------------------------------------

def _special_inputs(rng):
    """Values over the whole f32 range with the specials first: +-0, +-inf,
    NaN, f32 subnormals, overflow, ties at every format's rounding bit."""
    x = (rng.randn(1540) * np.exp2(rng.randint(-60, 60, 1540))).astype(
        np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                         1e-45, 3e38, -3e38, 65504.0, 57344.0, 61440.0,
                         2.0 ** -15, 2.0 ** -14, 1.125, 1.375, -2.5, 1.0 + 2.0 ** -8,
                         1.0 + 2.0 ** -10], np.float32)
    # exact ties: 1 + (2j + 1) 2^-(m + 1) for the narrow mantissas
    ties = np.array([1.0 + (2 * j + 1) * 2.0 ** -(m + 1)
                     for m in (2, 3, 5, 7, 9) for j in range(4)], np.float32)
    return np.concatenate([specials, ties, -ties, x]).reshape(-1, 16)


@pytest.mark.parametrize("fmt", [(5, 2), (6, 5), (4, 3), (8, 23), (6, 9),
                                 (8, 7), (5, 10)])
def test_quantize_plain_matches_jax_bitwise(fmt):
    """K2's plain version (the wrapper on CPU tensors) against the JAX
    kernel in interpret mode, bitwise, on f32 and on bf16 inputs; the
    oracle helpers (``ref_quantize``, ``quant.qnum.quantize``,
    ``ops.quantize_op``) are the same function."""
    e, m = fmt
    x = _special_inputs(np.random.RandomState(e * 31 + m))
    want = np.asarray(quantize_pallas(jnp.asarray(x), e=e, m=m))
    got = quantize(torch.from_numpy(x), e=e, m=m)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    for other in (ref_quantize(torch.from_numpy(x), e=e, m=m),
                  qnum_quantize(torch.from_numpy(x), FPFormat(e, m)),
                  quantize_op(torch.from_numpy(x), FPFormat(e, m))):
        np.testing.assert_array_equal(_bits(other.numpy()), _bits(want))
    # the same bf16 bits on both sides (the two packages' f32 -> bf16 casts
    # give NaN different payloads)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jb = jnp.asarray(xb.view(torch.int16).numpy()).view(jnp.bfloat16)
    want_b = np.asarray(quantize_pallas(jb, e=e, m=m))
    np.testing.assert_array_equal(_bits(quantize(xb, e=e, m=m).numpy()),
                                  _bits(want_b))


def test_quantize_refuses_other_dtypes():
    with pytest.raises(TypeError):
        quantize(torch.zeros(4, dtype=torch.float64), e=5, m=2)
    with pytest.raises(TypeError):
        quantize_reference(torch.zeros(4, dtype=torch.int8), e=5, m=2)


# --------------------------------------------------------------------------
# K3: chunked qmatmul
# --------------------------------------------------------------------------

QMM_CASES = [
    # (M, K, N, block_k, acc, a bf16, b as a transposed view)
    (37, 200, 75, 64, (6, 5), False, False),     # ragged M, N and K
    (8, 96, 130, 16, (6, 5), True, False),
    (5, 160, 40, 64, (6, 9), False, True),       # the lm_head: bf16 embed.T
    (9, 300, 33, 128, (8, 23), False, False),    # a wide role
    (16, 64, 24, 64, (6, 5), True, True),        # K a multiple of the chunk
]


@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize("m,k,n,bk,acc,a_bf16,b_t", QMM_CASES)
def test_qmatmul_plain_matches_jax(m, k, n, bk, acc, a_bf16, b_t, lattice):
    """K3's plain version against ``qmatmul_pallas`` (interpret mode) and
    ``ref_qmatmul``: bitwise on lattice operands, at most 1 carry ulp on
    random ones; bf16 operands and a transposed bf16 view are widened
    exactly, as the JAX kernel's ``pad2d`` cast does."""
    rng = np.random.RandomState(m * 100 + k + n + lattice)
    a = _lattice(rng, (m, k)) if lattice else rng.randn(m, k).astype(
        np.float32)
    b = (_lattice(rng, (k, n)) if lattice
         else (rng.randn(k, n) / np.sqrt(k)).astype(np.float32))
    at = torch.from_numpy(a)
    bt = torch.from_numpy(b)
    if a_bf16:
        at = at.to(torch.bfloat16)
    if b_t:
        bt = bt.T.contiguous().to(torch.bfloat16).T
        assert not bt.is_contiguous()
    want = np.asarray(qmatmul_pallas(jnp.asarray(at.float().numpy()),
                                     jnp.asarray(bt.float().numpy()),
                                     e_acc=acc[0], m_acc=acc[1], block_k=bk))
    kw = dict(e_acc=acc[0], m_acc=acc[1], block_k=bk)
    got = qmatmul(at, bt, **kw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _check(f"K3 {m}x{k}x{n} bk {bk}", got.numpy(), want, acc, lattice)
    for other in (qmatmul_reference(at, bt, **kw), ref_qmatmul(at, bt, **kw)):
        np.testing.assert_array_equal(_bits(other.numpy()),
                                      _bits(got.numpy()))


def test_qmatmul_defaults_are_the_wide_role():
    """A role that is None calls ``qmatmul_pallas(a, b)``: the (8, 23)
    carry at block_k 128, the port's ``_WIDE_CHUNK``."""
    from repro_torch.kernels.ops import _mm

    rng = np.random.RandomState(5)
    a = rng.randn(7, 390).astype(np.float32)
    b = rng.randn(390, 11).astype(np.float32)
    want = np.asarray(qmatmul_pallas(jnp.asarray(a), jnp.asarray(b)))
    for got in (qmatmul(torch.from_numpy(a), torch.from_numpy(b)),
                _mm(torch.from_numpy(a), torch.from_numpy(b), None)):
        _check("K3 wide default", got.numpy(), want, (8, 23), False)
    with pytest.raises(ValueError):
        qmatmul(torch.zeros(2, 3), torch.zeros(4, 2))
    with pytest.raises(ValueError):
        qmatmul(torch.zeros(2, 3), torch.zeros(3, 2), block_k=0)


# --------------------------------------------------------------------------
# the oracle qdot
# --------------------------------------------------------------------------

def _plan(kind, fused):
    """(port QDotConfig, JAX QDotConfig) of one case."""
    p = (GEMMPrecision(m_acc=5, chunk=16), JGP(m_acc=5, chunk=16))
    p9 = (GEMMPrecision(m_acc=9, chunk=16), JGP(m_acc=9, chunk=16))
    if kind in ("predicted", "bf16_x"):
        t = QDotConfig(fwd=p[0], bwd=p[0], grad=p[0], repr_fmt=FP8_152)
        j = JQC(fwd=p[1], bwd=p[1], grad=p[1], repr_fmt=JFP8)
    elif kind == "lm_head":       # repr_fmt None: raw operands, (1,6,9)
        t = QDotConfig(fwd=p9[0], bwd=p9[0], grad=p9[0])
        j = JQC(fwd=p9[1], bwd=p9[1], grad=p9[1])
    elif kind == "out_fmt":       # wide backward roles, a consumer format
        t = QDotConfig(fwd=p[0], repr_fmt=FP8_152, out_fmt=FP8_152)
        j = JQC(fwd=p[1], repr_fmt=JFP8, out_fmt=JFP8)
    else:                         # a representation wider than 8 bits
        t = QDotConfig(fwd=p[0], bwd=p[0], grad=p[0], repr_fmt=FPFormat(6, 9))
        j = JQC(fwd=p[1], bwd=p[1], grad=p[1], repr_fmt=JF(6, 9))
    return replace(t, fused=fused), replace(j, fused=fused)


def _port_vjp(x, w, cfg, g, dist=None):
    xt = x.clone().requires_grad_()
    wt = w.clone().requires_grad_()
    y = qdot(xt, wt, cfg) if dist is None else qdot(xt, wt, cfg, dist=dist)
    y.backward(g)
    return y.detach(), xt.grad, wt.grad


@pytest.mark.parametrize("kind", ["predicted", "lm_head", "out_fmt",
                                  "bf16_x", "wide_repr"])
def test_oracle_qdot_matches_jax_and_the_fused_qdot(kind):
    """y, dx and dw of the port's oracle ``qdot`` against ``jax.vjp`` of the
    JAX ``qdot(fused=False)`` (each within 1 carry ulp of its role, the
    mismatch fraction printed), and bitwise the port's fused ``qdot`` (the
    10-bit ``wide_repr`` through E's f32 residuals).  bf16
    weights come back with bf16 gradients; ``bf16_x`` feeds bf16
    activations too."""
    tcfg, jcfg = _plan(kind, fused=False)
    rng = np.random.RandomState(len(kind) + 3)
    x = rng.randn(2, 24, 80).astype(np.float32)
    w = torch.from_numpy((rng.randn(80, 48) / 9).astype(np.float32)
                         ).to(torch.bfloat16)
    g = torch.from_numpy(rng.randn(2, 24, 48).astype(np.float32))
    xt = torch.from_numpy(x)
    if kind == "bf16_x":
        xt = xt.to(torch.bfloat16)
    jy, vjp = jax.vjp(lambda a, b: jax_qdot(a.astype(jnp.float32),
                                            b.astype(jnp.float32), jcfg),
                      jnp.asarray(xt.float().numpy()).astype(
                          jnp.bfloat16 if kind == "bf16_x" else jnp.float32),
                      jnp.asarray(w.float().numpy()).astype(jnp.bfloat16))
    jdx, jdw = vjp(jnp.asarray(g.numpy()))
    y, dx, dw = _port_vjp(xt, w, tcfg, g)
    assert y.shape == (2, 24, 48) and y.dtype == torch.float32
    assert dx.dtype == xt.dtype and dw.dtype == torch.bfloat16
    for label, got, want, p in (("y", y, jy, tcfg.fwd),
                                ("dx", dx, jdx, tcfg.bwd),
                                ("dw", dw, jdw, tcfg.grad)):
        acc = (8, 23) if p is None else (p.e_acc, p.m_acc)
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        _check(f"oracle qdot {kind} {label} vs JAX", _np(got), want, acc,
               False)
    fy, fdx, fdw = _port_vjp(xt, w, replace(tcfg, fused=True), g)
    for a, b in ((y, fy), (dx, fdx), (dw, fdw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(_np(a)), _bits(_np(b)))
    # the no-grad (serving) forward is the same function
    with torch.no_grad():
        np.testing.assert_array_equal(_bits(_np(qdot(xt, w, tcfg))),
                                      _bits(_np(fy)))


def test_oracle_on_lattice_operands_is_bitwise_jax():
    """On lattice operands every contraction is exact in any f32 order, so
    the oracle's y, dx and dw equal JAX's bit for bit."""
    tcfg, jcfg = _plan("predicted", fused=False)
    rng = np.random.RandomState(9)
    x, w = _lattice(rng, (40, 96)), _lattice(rng, (96, 24))
    g = _lattice(rng, (40, 24))
    jy, vjp = jax.vjp(lambda a, b: jax_qdot(a, b, jcfg), jnp.asarray(x),
                      jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    y, dx, dw = _port_vjp(torch.from_numpy(x), torch.from_numpy(w), tcfg,
                          torch.from_numpy(g))
    for got, want in ((y, jy), (dx, jdx), (dw, jdw)):
        np.testing.assert_array_equal(_bits(_np(got)), _bits(np.asarray(want)))


def test_oracle_refuses_stats_tag():
    """A tagged oracle config (the JAX package's branch without the pair's
    rows) runs: its three roles' rows come from K8's plain version on the
    f32 residuals and g, and equal the tagged fused qdot's rows (K8 and
    K9's plain versions: the same chained sums), with y, dx and dw
    unchanged by the tag; on a mesh of one rank it gives the same
    outputs and rows (nothing is split; ``tests/test_torch_dist_model.py``
    runs it over ranks), and the oracle never packs its residuals."""
    from repro_torch.dist import Dist
    from repro_torch.launch.mesh import Mesh
    from repro_torch.obs.ingraph import InGraphCollector, collecting

    p = GEMMPrecision(m_acc=5, chunk=16)
    rng = np.random.RandomState(21)
    x = torch.from_numpy(rng.randn(24, 80).astype(np.float32))
    w = torch.from_numpy((rng.randn(80, 48) / 9).astype(np.float32)).to(
        torch.bfloat16)
    g = torch.from_numpy(rng.randn(24, 48).astype(np.float32))
    rows, outs = {}, {}
    for fused in (True, False):
        for tag in (None, "mlp_up"):
            cfg = QDotConfig(fwd=p, bwd=p, grad=p, repr_fmt=FP8_152,
                             fused=fused, stats_tag=tag)
            col = InGraphCollector()
            with collecting(col):
                outs[fused, tag] = _port_vjp(x, w, cfg, g)
            rows[fused, tag] = col.rows()
    for fused in (True, False):
        assert not rows[fused, None]
        assert sorted(rows[fused, "mlp_up"]) == [
            ("mlp_up", r) for r in ("bwd", "fwd", "grad")]
        for a, b in zip(outs[fused, None], outs[fused, "mlp_up"]):
            assert torch.equal(a, b)
    for key, row in rows[True, "mlp_up"].items():
        np.testing.assert_array_equal(np.asarray(row),
                                      np.asarray(rows[False, "mlp_up"][key]))
    cfg = QDotConfig(fwd=p, bwd=p, grad=p, repr_fmt=FP8_152, fused=False,
                     stats_tag="mlp_up")
    one = Dist(mesh=Mesh({"data": 1, "model": 1}), batch_axes=("data",),
               fsdp_axis="data")
    col = InGraphCollector()
    with collecting(col):
        for a, b in zip(_port_vjp(x, w, cfg, g, one), outs[False, None]):
            assert torch.equal(a, b)
    assert sorted(col.rows()) == sorted(rows[False, "mlp_up"])
    for key, row in col.rows().items():
        np.testing.assert_array_equal(np.asarray(row),
                                      np.asarray(rows[False, "mlp_up"][key]))
    assert not QDotConfig(repr_fmt=FP8_152, fused=False).packs
    assert QDotConfig(repr_fmt=FP8_152).packs


# --------------------------------------------------------------------------
# the slice: training step and serving forward under the oracle plan
# --------------------------------------------------------------------------

def oracle_plan(cfg):
    """``cfg`` with ``fused=False`` in every QDotConfig of its plan (the
    JAX package has no such helper; ``chip_smoke.py`` keeps its own)."""
    fields = {}
    for name in ("attn_qkv", "attn_out", "mlp_up", "mlp_down", "lm_head"):
        qc = getattr(cfg.quant, name)
        if qc is not None:
            fields[name] = replace(qc, fused=False)
    return replace(cfg, quant=replace(cfg.quant, **fields))


def _smoke_cfg():
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model

    return plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=32,
                          global_batch=4,
                          policy=AccumulationPolicy(mode="predicted",
                                                    chunk=16))


def test_oracle_training_step_is_bitwise_the_fused_step():
    """One training step of the smoke model (2 layers) under the oracle
    plan against the fused plan, same weights and tokens: the loss and
    every gradient leaf bitwise, and the K2/K3 wrappers ran on the CPU
    through their plain versions (no launches counted)."""
    from repro_torch.kernels.qmatmul import qmatmul as k3
    from repro_torch.kernels.quantize import quantize as k2
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import _grads, compute_copy
    from repro_torch.train.optimizer import tree_leaves

    cfg = _smoke_cfg()
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        "cpu")
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (4, 32)).astype(np.int32))

    def step(c):
        model = get_model(c)
        cc = compute_copy(params)
        loss, _ = model.loss_fn(cc, {"tokens": tokens}, c)
        loss.backward()
        return loss.detach(), _grads(cc, params)

    n2, n3 = k2.launches, k3.launches
    lf, gf = step(cfg)
    lo, go = step(oracle_plan(cfg))
    assert (k2.launches, k3.launches) == (n2, n3)
    assert torch.isfinite(lf)
    np.testing.assert_array_equal(_bits(_np(lf)), _bits(_np(lo)))
    leaves = list(zip(tree_leaves(gf), tree_leaves(go)))
    assert len(leaves) > 10
    for a, b in leaves:
        np.testing.assert_array_equal(_bits(_np(a)), _bits(_np(b)))


def test_oracle_serving_prefill_logits_are_bitwise_the_fused():
    """The paged prefill of the smoke model (no gradient: the oracle's
    no-grad forward) under the oracle plan against the fused plan: the
    logits and the arena bitwise."""
    from repro_torch.models.api import (get_model, get_paged_model,
                                        paged_init_state)
    from repro_torch.serve.plan import plan_attention

    cfg = _smoke_cfg()

    def bf16(t):   # the serving weights, as chip_smoke.py serves them
        return ({k: bf16(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to(torch.bfloat16))

    params = bf16(get_model(cfg).init_params(
        torch.Generator().manual_seed(1), "cpu"))
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size, 37)
    n, page = len(prompt), 16
    _, bucket = plan_attention(4 * page * 3, page).bucket_for(n)
    pages = torch.arange(1, -(-n // page) + 1)

    def run(c):
        kv = paged_init_state(c, n_pages=int(pages[-1]) + 1, page_size=page,
                              device="cpu")
        with torch.no_grad():
            logits = get_paged_model(c).prefill(
                params, torch.tensor([prompt.tolist()]), kv,
                pages.to(torch.int32), pages, 0, n, kv_fmt=FP8_152,
                acc=bucket.acc)
        return logits, kv

    lf, kvf = run(cfg)
    lo, kvo = run(oracle_plan(cfg))
    assert torch.equal(lf, lo)
    for name in kvf:
        assert torch.equal(kvf[name], kvo[name]), name
