"""Port vs JAX package: the fused GEMM's last variants and quantize_outputs.

The plain versions of G, E and K8 (``kernels.fused``) against the JAX
Pallas kernel ``qmatmul_fused`` in interpret mode, on the same numpy
inputs: the ``out_fmt``/``pack_out`` epilogue under RNE and SR carries,
int8-code operands (``a_packed``/``b_packed``), operands taken unquantized
(``quantize_a``/``quantize_b`` off), and E's f32 residuals
(``pack_residuals=False``) at (1,5,2) and at (1,6,9), which no int8 code
holds; ``qdot_packed``; ``plan_for_model(quantize_outputs=True)`` field by
field; and, under that plan, a training step and a serving run of the
smoke model against the JAX package in a child process with excess
precision off (ROADMAP F2), and 8 training steps on each package's own
``SyntheticLM`` batches.

Tolerances, as in ``tests/test_torch_train.py``: codes and residuals
bitwise on every input; outputs bitwise on lattice operands (every f32
order of an intra-chunk sum is exact) and, on random ones, within 1 ulp
of the carry format before the epilogue and of the output format after
it (the f32 partial's summation order differs between XLA's dot and
PyTorch's; ROADMAP F0); the training step's and the serving run's
tolerances are those of ``tests/test_torch_train.py`` and
``tests/test_torch_serve.py`` (F4).  Measured: bitwise on every kernel
case here.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import GEMMPrecision as JGP
from repro.kernels.fused import qmatmul_fused as jax_fused
from repro.kernels.ops import QDotConfig as JQC
from repro.kernels.ops import qdot as jax_qdot
from repro.kernels.ops import qdot_packed as jax_qdot_packed
from repro.quant.formats import FPFormat as JF
from repro_torch.core.policy import GEMMPrecision
from repro_torch.kernels import qdot_packed as exported_qdot_packed
from repro_torch.kernels.common import quantize_block
from repro_torch.kernels.fused import emit_output, qmatmul_fused
from repro_torch.kernels.ops import QDotConfig, qdot, qdot_packed
from repro_torch.quant.formats import FPFormat
from repro_torch.quant.qtensor import QTensor, pack_block, unpack_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7        # the SR cases' seed


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def ulps(got, want, m: int, e: int) -> np.ndarray:
    """|got - want| in units of the (1, e, m) ulp at max(|got|, |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ex = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    return np.abs(got - want) / np.exp2(np.maximum(ex, -(2 ** (e - 1) - 1)) - m)


def _lattice(rng, shape):
    """(1,5,2) points over a narrow exponent range: every f32 sum of a
    chunk's products is exact."""
    e = rng.randint(-2, 3, size=shape)
    j = rng.randint(0, 4, size=shape)
    s = rng.choice([-1.0, 1.0], size=shape)
    x = s * np.exp2(e) * (1 + j / 4)
    x[rng.rand(*shape) < 0.1] = 0.0
    return x.astype(np.float32)


def _operands(rng, shape, lattice):
    return _lattice(rng, shape) if lattice else rng.randn(*shape).astype(
        np.float32)


def _check(label, got, want, fmt, lattice):
    """Bitwise on lattice operands, within 1 ulp of ``fmt`` = (e, m) on
    random ones."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    u = ulps(got, want, fmt[1], fmt[0])
    print(f"{label}: mismatch fraction {np.mean(got != want):.5f}, max "
          f"{u.max():.2f} ulp of (1,{fmt[0]},{fmt[1]})")
    if lattice:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        assert u.max() <= 1.0


def _codes(x: np.ndarray, fmt) -> np.ndarray:
    """int8 codes of ``x`` rounded to ``fmt``."""
    t = quantize_block(torch.from_numpy(x), *fmt)
    return pack_block(t, *fmt).numpy()


# --------------------------------------------------------------------------
# G, E and K8: each variant's plain version against JAX's kernel
# --------------------------------------------------------------------------

T, K, N, CHUNK, ACC = 37, 200, 75, 64, (6, 5)
R152, R169 = (5, 2), (6, 9)

# variant -> (JAX and port keywords, operand layout); the operands are
# float32 unless the variant packs them
VARIANTS = {
    "out_fmt": dict(out_fmt=R152),
    "pack_out": dict(out_fmt=R152, pack_out=True),
    "packed_ab": dict(a_packed=True, b_packed=True),
    "packed_a_out": dict(a_packed=True, out_fmt=R152),
    "unquantized_a": dict(quantize_a=False),
    "unquantized_b_out": dict(quantize_b=False, out_fmt=R152),
    "f32_residuals_152": dict(return_quantized=True, pack_residuals=False),
    "f32_residuals_169": dict(return_quantized=True, pack_residuals=False,
                              repr_fmt=R169),
    "f32_residuals_out": dict(return_quantized=True, pack_residuals=False,
                              out_fmt=R152, pack_out=True),
}


def _variant_inputs(variant, lattice):
    rng = np.random.RandomState(sorted(VARIANTS).index(variant) * 3
                                + int(lattice))
    kw = dict(VARIANTS[variant])
    rf = kw.pop("repr_fmt", R152)
    a = _operands(rng, (T, K), lattice)
    b = _operands(rng, (K, N), lattice)
    if kw.get("a_packed"):
        a = _codes(a, rf)
    if kw.get("b_packed"):
        b = _codes(b, rf)
    return a, b, rf, kw


def _jax_kw(kw, rf, rounding):
    out = dict(kw)
    if "out_fmt" in out:
        out["out_fmt"] = JF(*out["out_fmt"])
    return dict(out, repr_fmt=JF(*rf), e_acc=ACC[0], m_acc=ACC[1],
                block_k=CHUNK, rounding=rounding, sr_seed=SEED)


def _torch_kw(kw, rf, rounding):
    return dict(kw, repr_fmt=FPFormat(*rf), e_acc=ACC[0], m_acc=ACC[1],
                block_k=CHUNK, rounding=rounding, sr_seed=SEED)


@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize("rounding", ["rne", "sr"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_matches_jax(variant, rounding, lattice):
    a, b, rf, kw = _variant_inputs(variant, lattice)
    want = jax_fused(jnp.asarray(a), jnp.asarray(b),
                     **_jax_kw(kw, rf, rounding))
    got = qmatmul_fused(torch.from_numpy(a), torch.from_numpy(b),
                        **_torch_kw(kw, rf, rounding))
    label = f"{variant} {rounding} {'lattice' if lattice else 'random'}"
    if kw.get("return_quantized"):
        (want, jaq, jbq), (got, aq, bq) = want, got
        assert aq.dtype == bq.dtype == torch.float32
        np.testing.assert_array_equal(_bits(aq.numpy()), _bits(jaq))
        np.testing.assert_array_equal(_bits(bq.numpy()), _bits(jbq))
    out = kw.get("out_fmt")
    if kw.get("pack_out"):
        assert got.dtype == torch.int8
        if lattice:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = unpack_block(got, *out)
        want = unpack_block(torch.from_numpy(np.asarray(want)), *out)
    _check(label, got.numpy(), np.asarray(want), out or ACC, lattice)
    if out is not None:
        # the output always lies on the output format's lattice
        g = torch.as_tensor(got.numpy())
        assert torch.equal(quantize_block(g, *out), g)


@pytest.mark.parametrize("rounding", ["rne", "sr"])
@pytest.mark.parametrize("pack_out", [False, True])
def test_stats_out_fmt_matches_jax(rounding, pack_out):
    """K8 with the epilogue: C as JAX's; the stats row is the carry's, so
    bitwise the row without ``out_fmt``; C is the epilogue of the
    epilogue-free C."""
    rng = np.random.RandomState(41)
    a, b = _lattice(rng, (T, K)), _lattice(rng, (K, N))
    kw = dict(out_fmt=R152, pack_out=pack_out, collect_stats=True)
    jc, _ = jax_fused(jnp.asarray(a), jnp.asarray(b),
                      **_jax_kw(kw, R152, rounding))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    c, row = qmatmul_fused(ta, tb, **_torch_kw(kw, R152, rounding))
    base, base_row = qmatmul_fused(ta, tb, collect_stats=True,
                                   **_torch_kw({}, R152, rounding))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert torch.equal(row, base_row)
    assert torch.equal(c, emit_output(base, R152, pack_out))


def test_variant_checks_follow_jax():
    a, b = torch.zeros((4, 8)), torch.zeros((8, 3))
    with pytest.raises(ValueError):      # pack_out needs out_fmt
        qmatmul_fused(a, b, repr_fmt=R152, pack_out=True)
    with pytest.raises(ValueError):      # a code of (1,6,9) needs 16 bits
        qmatmul_fused(a, b, repr_fmt=R152, out_fmt=R169, pack_out=True)
    with pytest.raises(ValueError):      # packed operands decode repr_fmt
        qmatmul_fused(a.to(torch.int8), b, a_packed=True)
    with pytest.raises(ValueError):      # residuals are forward-only
        qmatmul_fused(a.to(torch.int8), b, repr_fmt=R152, a_packed=True,
                      return_quantized=True)
    with pytest.raises(ValueError):      # int8 residuals need 8 bits
        qmatmul_fused(a, b, repr_fmt=R169, return_quantized=True)
    # f32 residuals take any representation, or none (the operands)
    _, aq, bq = qmatmul_fused(a + 1.1, b, return_quantized=True,
                              pack_residuals=False)
    assert torch.equal(aq, a + 1.1) and aq.dtype == torch.float32


# --------------------------------------------------------------------------
# qdot: pack_residuals, out_fmt through autograd, qdot_packed
# --------------------------------------------------------------------------

P = GEMMPrecision(m_acc=5, e_acc=6, chunk=16)
JP = JGP(m_acc=5, e_acc=6, chunk=16)


def _cfg(**kw):
    return QDotConfig(fwd=P, bwd=P, grad=P, repr_fmt=FPFormat(5, 2), **kw)


def _jcfg(**kw):
    return JQC(fwd=JP, bwd=JP, grad=JP, repr_fmt=JF(5, 2), **kw)


@pytest.mark.parametrize("repr_fmt", [R152, R169])
@pytest.mark.parametrize("pack_residuals", [True, False])
def test_qdot_out_fmt_residuals_match_jax_vjp(pack_residuals, repr_fmt):
    """y, dx and dw of ``qdot`` under ``out_fmt`` against ``jax.vjp`` of
    JAX's, on lattice operands (bitwise); f32 residuals give the same
    bits as int8 ones."""
    rng = np.random.RandomState(3)
    x, w = _lattice(rng, (24, 48)), _lattice(rng, (48, 40))
    g = _lattice(rng, (24, 40))
    tc = QDotConfig(fwd=P, bwd=P, grad=P, repr_fmt=FPFormat(*repr_fmt),
                    out_fmt=FPFormat(5, 2), pack_residuals=pack_residuals)
    jc = JQC(fwd=JP, bwd=JP, grad=JP, repr_fmt=JF(*repr_fmt),
             out_fmt=JF(5, 2), pack_residuals=pack_residuals)
    assert tc.packs == jc.packs
    jy, vjp = jax.vjp(lambda x, w: jax_qdot(x, w, jc), jnp.asarray(x),
                      jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = qdot(tx, tw, tc)
    y.backward(torch.from_numpy(g))
    for got, want in ((y.detach(), jy), (tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    with torch.no_grad():
        np.testing.assert_array_equal(_bits(qdot(tx, tw, tc).numpy()),
                                      _bits(jy))


@pytest.mark.parametrize("cfg_out,hint", [(None, (5, 2)), ((5, 2), (5, 2)),
                                          ((4, 3), (5, 2)), (None, None)])
def test_dense_out_fmt_hint_matches_jax(cfg_out, hint):
    """``layers.dense``'s consumer-format hint (``out_fmt=``) against JAX's
    ``dense`` under ``jax.vjp``: y (bf16), dx and dw bitwise on lattice
    operands.  The hint replaces the config's ``out_fmt``, so y lies on
    its lattice, and the backward is straight-through (dx, dw as
    without it)."""
    from repro.models.layers import dense as jax_dense
    from repro_torch.models.layers import dense

    rng = np.random.RandomState(11)
    x, w = _lattice(rng, (24, 48)), _lattice(rng, (48, 40))
    g = _lattice(rng, (24, 40))
    tc = _cfg(out_fmt=None if cfg_out is None else FPFormat(*cfg_out))
    jc = _jcfg(out_fmt=None if cfg_out is None else JF(*cfg_out))
    jh = None if hint is None else JF(*hint)
    th = None if hint is None else FPFormat(*hint)
    jy, vjp = jax.vjp(lambda x, w: jax_dense(x, w, jc, out_fmt=jh),
                      jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = dense(tx, tw, tc, out_fmt=th)
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(y.detach().float().numpy()),
                                  _bits(np.asarray(jy.astype(jnp.float32))))
    for got, want in ((tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    out = hint or cfg_out
    if out is not None:
        y32 = y.detach().float()
        assert torch.equal(quantize_block(y32, *out), y32)
    # straight-through: the gradients are those of the call without it
    tx2 = torch.from_numpy(x).requires_grad_()
    tw2 = torch.from_numpy(w).requires_grad_()
    dense(tx2, tw2, _cfg()).backward(torch.from_numpy(g).to(torch.bfloat16))
    assert torch.equal(tx.grad, tx2.grad) and torch.equal(tw.grad, tw2.grad)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("lattice", [True, False])
def test_qdot_packed_matches_jax(lattice, fused):
    rng = np.random.RandomState(43)
    x = _operands(rng, (2, 16, 128), lattice)
    w = _operands(rng, (128, 16), lattice)
    qt = qdot_packed(torch.from_numpy(x), torch.from_numpy(w),
                     _cfg(out_fmt=FPFormat(5, 2), fused=fused))
    jqt = jax_qdot_packed(jnp.asarray(x), jnp.asarray(w),
                          _jcfg(out_fmt=JF(5, 2), fused=fused))
    assert isinstance(qt, QTensor) and qt.payload.dtype == torch.int8
    assert qt.shape == tuple(jqt.payload.shape) == (2, 16, 16)
    assert qt.fmt == FPFormat(5, 2)
    if lattice:
        np.testing.assert_array_equal(qt.payload.numpy(),
                                      np.asarray(jqt.payload))
    _check(f"qdot_packed fused={fused}", qt.unpack().numpy(),
           np.asarray(jqt.unpack()), R152, lattice)
    # decoded, the codes are qdot's output under the same out_fmt
    y = qdot(torch.from_numpy(x), torch.from_numpy(w),
             _cfg(out_fmt=FPFormat(5, 2), fused=fused))
    assert torch.equal(qt.unpack(), y)
    assert exported_qdot_packed is qdot_packed
    with pytest.raises(ValueError):
        qdot_packed(torch.from_numpy(x), torch.from_numpy(w), _cfg())
    with pytest.raises(ValueError):
        qdot_packed(torch.from_numpy(x), torch.from_numpy(w),
                    _cfg(out_fmt=FPFormat(6, 9)))


# --------------------------------------------------------------------------
# the plan, and the smoke model under it against JAX
# --------------------------------------------------------------------------


def _fmt(f):
    return None if f is None else (f.e, f.m)


def _prec(p):
    return None if p is None else (p.m_acc, p.e_acc, p.chunk)


@pytest.mark.parametrize("mode,pp", [("predicted", 0), ("perturbed", -2),
                                     ("exact", 0)])
def test_plan_quantize_outputs_matches_jax(mode, pp):
    from repro.configs import get_config as jget
    from repro.core.policy import AccumulationPolicy as JPol
    from repro.core.policy import plan_for_model as jplan
    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model

    jq = jplan(jget("qwen2-1.5b"), seq_len=64, global_batch=8,
               policy=JPol(mode=mode, chunk=64, perturbation=pp,
                           quantize_outputs=True)).quant
    tq = plan_for_model(get_config("qwen2-1.5b"), seq_len=64, global_batch=8,
                        policy=AccumulationPolicy(
                            mode=mode, chunk=64, perturbation=pp,
                            quantize_outputs=True)).quant
    for name in ("attn_qkv", "attn_out", "mlp_up", "mlp_down", "lm_head"):
        j, t = getattr(jq, name), getattr(tq, name)
        if j is None:
            assert t is None, name
            continue
        for role in ("fwd", "bwd", "grad"):
            assert _prec(getattr(t, role)) == _prec(getattr(j, role)), name
        for field in ("repr_fmt", "out_fmt"):
            assert _fmt(getattr(t, field)) == _fmt(getattr(j, field)), name
        assert (t.fused, t.pack_residuals, t.packs, t.rounding, t.sr_seed,
                t.is_exact) == (j.fused, j.pack_residuals, j.packs,
                                j.rounding, j.sr_seed, j.is_exact), name
    if mode != "exact":
        assert _fmt(tq.attn_qkv.out_fmt) == R152
        assert tq.lm_head.out_fmt is None


SEQ, BATCH, CHUNK_PLAN = 32, 4, 16
# the N-step run on each package's own SyntheticLM batches: the learning
# rate, warm-up and step count of the chip smoke's quantize_outputs run
QOUT_NSTEPS, QOUT_LR, QOUT_WARMUP, QOUT_DATA_SEED = 8, 1e-3, 2, 0


def _plans():
    from repro.configs import get_smoke_config as jsmoke
    from repro.core.policy import AccumulationPolicy as JPol
    from repro.core.policy import plan_for_model as jplan
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model

    jcfg = jplan(jsmoke("qwen2-1.5b"), seq_len=SEQ, global_batch=BATCH,
                 policy=JPol(mode="predicted", chunk=CHUNK_PLAN,
                             quantize_outputs=True))
    tcfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=SEQ,
                          global_batch=BATCH,
                          policy=AccumulationPolicy(mode="predicted",
                                                    chunk=CHUNK_PLAN,
                                                    quantize_outputs=True))
    return jcfg, tcfg


def _tokens():
    return np.random.RandomState(5).randint(0, 256, (BATCH, SEQ)).astype(
        np.int32)


SERVE_LENS, SERVE_GEN, PAGE, MAX_BATCH = (16, 21, 48), 6, 16, 4


def _serve_prompts(vocab):
    rng = np.random.RandomState(31)
    return [rng.randint(0, vocab, n).tolist() for n in SERVE_LENS]


def _serve_pages():
    return -(-int(sum(n + SERVE_GEN for n in SERVE_LENS) * 1.25) // PAGE) + 1


def jax_child(out_path: str) -> None:
    """The JAX side under the quantize_outputs plan: the first training
    step's loss and gradients (w.r.t. the bf16 cast tree, widened to f32,
    as the JAX train step takes them) from PRNGKey(0)'s weights, and a
    one-shot serving run of the prompts on those weights in bf16 (its
    streams and decode logits).  Run with ``--xla_allow_excess_precision=
    false`` (ROADMAP F2)."""
    from repro.models.api import get_model as jget
    from repro.quant.formats import FPFormat as JFmt
    from repro.serve import scheduler as JS
    from repro.serve.kvcache import PagedKVConfig as JPC
    from test_torch_serve import _JaxRec
    from test_torch_train import _flat

    jcfg, _ = _plans()
    model = jget(jcfg)
    params = model.init_params(jax.random.PRNGKey(0))
    out = _flat(params, "p0", {})

    def grads(params, batch):
        cast = jax.tree.map(lambda p: p.astype(jnp.bfloat16) if (
            p.dtype == jnp.float32 and p.ndim >= 2) else p, params)
        (loss, _), g = jax.value_and_grad(
            lambda p: model.loss_fn(p, batch, jcfg), has_aux=True)(cast)
        return loss, jax.tree.map(lambda x: x.astype(jnp.float32), g)

    loss, g = jax.jit(grads)(params, {"tokens": jnp.asarray(_tokens())})
    out["loss"] = np.asarray(loss)
    _flat(g, "g", out)

    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.train import optimizer as JO
    from repro.train.loop import TrainConfig as JTC
    from repro.train.loop import init_train_state, make_train_step

    tc = JTC(opt=JO.OptConfig(lr=QOUT_LR, warmup_steps=QOUT_WARMUP,
                              total_steps=QOUT_NSTEPS))
    state = init_train_state(model, jax.random.PRNGKey(0), tc)
    step = jax.jit(make_train_step(model, tc))
    data = SyntheticLM(DataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH, seed=QOUT_DATA_SEED))
    for s in range(QOUT_NSTEPS):
        batch = next(data)
        state, m = step(state, batch)
        out[f"n_tokens{s}"] = np.asarray(batch["tokens"])
        out[f"n_loss{s}"] = np.asarray(m["loss"])
        out[f"n_grad_norm{s}"] = np.asarray(m["grad_norm"])

    bf = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    ex = _JaxRec(model, bf, JPC.for_model(jcfg, n_pages=_serve_pages(),
                                          page_size=PAGE),
                 kv_fmt=JFmt(5, 2), max_batch=MAX_BATCH)
    eng = JS.ServeEngine(model, bf, n_pages=_serve_pages(), page_size=PAGE,
                         max_batch=MAX_BATCH, executor=ex)
    rids = [eng.submit(p, SERVE_GEN) for p in _serve_prompts(jcfg.vocab_size)]
    res = eng.run()
    out["streams"] = np.array([res[r] for r in rids])
    for rid, rows in ex.decodes.items():
        out[f"decode{rid}"] = np.stack(rows)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_qout") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    child = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_variants as t; t.jax_child({path!r})"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert child.returncode == 0, child.stdout + child.stderr
    return dict(np.load(path))


def test_quantize_outputs_train_step_matches_jax(jax_run):
    """The first step under quantize_outputs, same f32 weights and tokens:
    the loss and every gradient, under ``tests/test_torch_train.py``'s
    tolerances (F4: bias gradients by their relative error norm); every
    dense forward output lies on the (1,5,2) lattice."""
    from test_torch_train import BIAS_REL, F32_REL, _flat, _unflat

    from repro_torch.kernels import ops
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import _grads, compute_copy

    _, tcfg = _plans()
    params = _unflat(jax_run, "p0")
    compute = compute_copy(params)
    seen = []
    real = ops.qmatmul_fused

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append((kw.get("out_fmt"), out[0] if isinstance(out, tuple)
                     else out))
        return out

    ops.qmatmul_fused = spy
    try:
        loss, _ = get_model(tcfg).loss_fn(
            compute, {"tokens": torch.from_numpy(_tokens())}, tcfg)
    finally:
        ops.qmatmul_fused = real
    loss.backward()
    assert abs(float(loss) - float(jax_run["loss"])) <= 1e-5
    outs = [y for f, y in seen if f is not None]
    assert len(outs) == 7 * tcfg.n_layers
    assert all(torch.equal(quantize_block(y, 5, 2), y) for y in outs)
    grads = _flat(_grads(compute, params), "g", {})
    assert set(grads) == {k for k in jax_run if k.startswith("g/")}
    for name, got in grads.items():
        want = jax_run[name]
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


def test_quantize_outputs_serving_matches_jax(jax_run):
    """A one-shot serving run under quantize_outputs on the same bf16
    weights: decode logits within ``tests/test_torch_serve.py``'s
    tolerance, greedy streams equal until a near tie."""
    from test_torch_serve import LOGIT_TOL, _TorchRec
    from test_torch_train import _unflat

    from repro_torch.train.optimizer import tree_map

    from repro_torch.models.api import get_model
    from repro_torch.quant.formats import FPFormat as TF
    from repro_torch.serve import scheduler as TS
    from repro_torch.serve.kvcache import PagedKVConfig as TPC

    _, tcfg = _plans()
    params = tree_map(lambda t: t.to(torch.bfloat16), _unflat(jax_run, "p0"))
    model = get_model(tcfg)
    ex = _TorchRec(model, params, TPC.for_model(tcfg, n_pages=_serve_pages(),
                                                page_size=PAGE),
                   kv_fmt=TF(5, 2), max_batch=MAX_BATCH, device="cpu")
    eng = TS.ServeEngine(model, params, n_pages=_serve_pages(),
                         page_size=PAGE, max_batch=MAX_BATCH, executor=ex,
                         device="cpu")
    rids = [eng.submit(p, SERVE_GEN) for p in _serve_prompts(tcfg.vocab_size)]
    res = eng.run()
    max_err = 0.0
    for i, (a, rid) in enumerate(zip(jax_run["streams"].tolist(), rids)):
        b = res[rid]
        assert len(a) == len(b) == SERVE_GEN
        jl, tl = jax_run[f"decode{i}"], ex.decodes[rid]
        for step in range(1, SERVE_GEN):
            err = float(np.max(np.abs(jl[step - 1] - tl[step - 1])))
            max_err = max(max_err, err)
            assert err <= LOGIT_TOL, (i, step, err)
            if a[step] != b[step]:
                top2 = np.sort(jl[step - 1])[-2:]
                assert top2[1] - top2[0] <= LOGIT_TOL
                break
    print(f"max decode logit error {max_err:.4f}")
    eng.pool.check_invariants()


def test_quantize_outputs_n_steps_on_own_batches_track_jax(jax_run):
    """``QOUT_NSTEPS`` AdamW steps under quantize_outputs from the same
    weights, each package drawing its own ``SyntheticLM(seed)`` batches:
    the tokens are bitwise equal, then the loss and gradient norm of every
    step stay within F4's 0.03 of JAX's, the bounds of
    ``tests/test_torch_train.py``'s N-step run."""
    from test_torch_train import NSTEP_GNORM, NSTEP_LOSS, _unflat

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.api import get_model
    from repro_torch.train import optimizer as O
    from repro_torch.train.loop import TrainConfig, make_train_step

    _, tcfg = _plans()
    tc = TrainConfig(opt=O.OptConfig(lr=QOUT_LR, warmup_steps=QOUT_WARMUP,
                                     total_steps=QOUT_NSTEPS))
    params = _unflat(jax_run, "p0")
    state = {"params": params, "opt": O.init_opt_state(params),
             "scaler": O.init_scaler(tc.scaler)}
    step = make_train_step(get_model(tcfg), tc)
    data = SyntheticLM(DataConfig(vocab_size=tcfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH, seed=QOUT_DATA_SEED))
    worst_l = worst_g = 0.0
    for s in range(QOUT_NSTEPS):
        batch = next(data)
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      jax_run[f"n_tokens{s}"])
        state, m = step(state, batch)
        dl = abs(float(m["loss"]) - float(jax_run[f"n_loss{s}"]))
        dg = abs(float(m["grad_norm"]) / float(jax_run[f"n_grad_norm{s}"])
                 - 1)
        worst_l, worst_g = max(worst_l, dl), max(worst_g, dg)
        print(f"step {s}: loss {float(m['loss']):.5f} (JAX "
              f"{float(jax_run[f'n_loss{s}']):.5f}), grad norm rel {dg:.4f}")
        assert dl <= NSTEP_LOSS and dg <= NSTEP_GNORM
        assert float(m["skipped"]) == 0.0
    print(f"worst: loss {worst_l:.5f}, grad norm {worst_g:.5f}")
