"""Port vs JAX package: the training slice.

The plain versions of kernels E (forward GEMM plus int8 residual codes)
and B (the backward pair, with its dx carry-in entry) against the JAX
Pallas kernels in interpret mode; the autograd ``qdot`` against
``jax.vjp`` of the JAX ``qdot``; ``adamw_update`` against the JAX
optimizer; ``SyntheticLM``'s next-token map; and whole training steps of
the smoke model against a JAX child process fed the same weights and
tokens.

Tolerances, as in ``tests/test_torch_kernels.py``: codes bitwise on every
input; contractions bitwise on lattice operands (every f32 order of an
intra-chunk sum is exact) and within 1 ulp of the carry format on random
ones (the f32 partial's summation order differs between XLA's dot and
PyTorch's; ROADMAP F0).  Measured: bitwise on every case here.
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
from repro.kernels.bwd_pair import (
    qmatmul_bwd_pair as jax_pair,
    qmatmul_bwd_pair_nsplit as jax_nsplit,
)
from repro.kernels.fused import qmatmul_fused as jax_qmatmul
from repro.kernels.ops import QDotConfig as JQC, qdot as jax_qdot
from repro.quant.formats import FP8_152 as JFP8
from repro_torch.core.policy import GEMMPrecision
from repro_torch.kernels.bwd_pair import (
    qmatmul_bwd_pair,
    qmatmul_bwd_pair_nsplit,
)
from repro_torch.kernels.fused import qmatmul_fused
from repro_torch.kernels.ops import QDotConfig, qdot
from repro_torch.quant.formats import FP8_152, FPFormat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _operands(rng, shape, lattice, scale=1.0):
    if lattice:
        return _lattice(rng, shape)
    return (rng.randn(*shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------
# E: forward GEMM + residual codes
# --------------------------------------------------------------------------

E_CASES = [
    # (T, K, N, chunk, acc, bf16 weights)
    (37, 200, 75, 64, (6, 5), False),
    (64, 96, 130, 16, (6, 5), True),
    (5, 64, 33, 64, (8, 23), False),
]


@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize("t,k,n,chunk,acc,w_bf16", E_CASES)
def test_emitq_matches_jax(t, k, n, chunk, acc, w_bf16, lattice):
    rng = np.random.RandomState(t * 7 + k + n)
    x = _operands(rng, (t, k), lattice)
    w = _operands(rng, (k, n), lattice, 1 / np.sqrt(k))
    wt = torch.from_numpy(w)
    if w_bf16:  # dense() hands E the bf16 weights; JAX sees their f32 values
        wt = wt.to(torch.bfloat16)
        w = wt.float().numpy()
    jy, jxq, jwq = jax_qmatmul(
        jnp.asarray(x), jnp.asarray(w), repr_fmt=JFP8, e_acc=acc[0],
        m_acc=acc[1], block_k=chunk, return_quantized=True,
        pack_residuals=True)
    y, xq, wq = qmatmul_fused(torch.from_numpy(x), wt, repr_fmt=FP8_152,
                              e_acc=acc[0], m_acc=acc[1], block_k=chunk,
                              return_quantized=True)
    assert xq.dtype == wq.dtype == torch.int8
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    _check(f"E {t}x{k}x{n}", y.numpy(), np.asarray(jy), acc, lattice)


def test_emitq_needs_an_8_bit_format():
    a = torch.zeros((2, 4))
    with pytest.raises(ValueError):
        qmatmul_fused(a, torch.zeros((4, 3)), repr_fmt=None,
                      return_quantized=True)
    with pytest.raises(ValueError):
        qmatmul_fused(a, torch.zeros((4, 3)), repr_fmt=FPFormat(5, 7),
                      return_quantized=True)


# --------------------------------------------------------------------------
# B: the backward pair (K6) and its dx carry-in entry (K7)
# --------------------------------------------------------------------------

B_CASES = [
    # (T, K, N, grad_chunk, bwd_chunk, bwd_acc, grad_acc, packed)
    (40, 72, 150, 16, 64, (6, 5), (6, 5), True),
    (64, 130, 96, 64, 16, (6, 5), (6, 7), True),
    (24, 48, 200, 16, 64, (6, 9), (6, 9), False),   # the lm_head: raw
]


def _pair_inputs(rng, t, k, n, packed, lattice):
    """g, and the residuals as the forward leaves them: E's codes, or raw
    f32 x with bf16 w behind a transposed view (the tied head)."""
    g = _operands(rng, (t, n), lattice)
    x = _operands(rng, (t, k), lattice)
    w = _operands(rng, (k, n), lattice, 1 / np.sqrt(k))
    if packed:
        _, xq, wq = qmatmul_fused(torch.from_numpy(x), torch.from_numpy(w),
                                  repr_fmt=FP8_152, e_acc=8, m_acc=23,
                                  return_quantized=True)
        return g, xq, wq, np.asarray(xq), np.asarray(wq)
    emb = torch.from_numpy(np.ascontiguousarray(w.T)).to(torch.bfloat16)
    return (g, torch.from_numpy(x), emb.T, x,
            np.ascontiguousarray(emb.T.float().numpy()))


def _jax_pair_kw(rf, bwd_acc, grad_acc, grad_chunk, bwd_chunk, packed):
    return dict(repr_fmt=rf, bwd_acc=bwd_acc, grad_acc=grad_acc,
                block_t=grad_chunk, block_k=32, block_n=bwd_chunk,
                packed=packed, quantize_g=rf is not None)


@pytest.mark.parametrize("lattice", [True, False])
@pytest.mark.parametrize("t,k,n,gc,bc,bwd_acc,grad_acc,packed", B_CASES)
def test_bwd_pair_matches_jax(t, k, n, gc, bc, bwd_acc, grad_acc, packed,
                              lattice):
    rng = np.random.RandomState(t + 3 * k + n)
    g, xq, wq, jx, jw = _pair_inputs(rng, t, k, n, packed, lattice)
    rf, jrf = (FP8_152, JFP8) if packed else (None, None)
    jdx, jdw = jax_pair(jnp.asarray(g), jnp.asarray(jx), jnp.asarray(jw),
                        **_jax_pair_kw(jrf, bwd_acc, grad_acc, gc, bc,
                                       packed))
    dx, dw = qmatmul_bwd_pair(torch.from_numpy(g), xq, wq, repr_fmt=rf,
                              bwd_acc=bwd_acc, grad_acc=grad_acc,
                              bwd_chunk=bc, grad_chunk=gc, packed=packed,
                              quantize_g=rf is not None)
    _check(f"B dx {t}x{k}x{n}", dx.numpy(), np.asarray(jdx), bwd_acc, lattice)
    _check(f"B dw {t}x{k}x{n}", dw.numpy(), np.asarray(jdw), grad_acc,
           lattice)


@pytest.mark.parametrize("packed", [True, False])
def test_bwd_pair_carry_chain_is_the_unsplit_call(packed):
    """K7: chained block-aligned N segments (dx carried in) are bitwise the
    unsplit pair, and match the JAX N-split pair."""
    t, k, n, gc, bc = 32, 40, 200, 16, 32
    acc = (6, 5) if packed else (6, 9)
    rng = np.random.RandomState(4)
    g, xq, wq, jx, jw = _pair_inputs(rng, t, k, n, packed, False)
    rf, jrf = (FP8_152, JFP8) if packed else (None, None)
    kw = dict(repr_fmt=rf, bwd_acc=acc, grad_acc=acc, bwd_chunk=bc,
              grad_chunk=gc, packed=packed, quantize_g=rf is not None)
    gt = torch.from_numpy(g)
    dx, dw = qmatmul_bwd_pair(gt, xq, wq, **kw)
    # two segments by hand: [0, 96) and [96, 200), dx carried across
    dx0, dw0 = qmatmul_bwd_pair(gt[:, :96], xq, wq[:, :96], **kw)
    dx1, dw1 = qmatmul_bwd_pair(gt[:, 96:], xq, wq[:, 96:], dx_carry=dx0,
                                **kw)
    np.testing.assert_array_equal(_bits(dx1), _bits(dx))
    np.testing.assert_array_equal(_bits(torch.cat([dw0, dw1], 1)), _bits(dw))
    sdx, sdw = qmatmul_bwd_pair_nsplit(gt, xq, wq, n_split=3, **kw)
    np.testing.assert_array_equal(_bits(sdx), _bits(dx))
    np.testing.assert_array_equal(_bits(sdw), _bits(dw))
    jdx, jdw = jax_nsplit(jnp.asarray(g), jnp.asarray(jx), jnp.asarray(jw),
                          n_split=3, **_jax_pair_kw(jrf, acc, acc, gc, bc,
                                                    packed))
    _check("nsplit dx", sdx.numpy(), np.asarray(jdx), acc, False)
    _check("nsplit dw", sdw.numpy(), np.asarray(jdw), acc, False)
    with pytest.raises(ValueError):  # the carry in must have dx's shape
        qmatmul_bwd_pair(gt[:, 96:], xq, wq[:, 96:], dx_carry=dx0[:, 1:],
                         **kw)


# --------------------------------------------------------------------------
# the autograd qdot
# --------------------------------------------------------------------------

def _plan(kind):
    p = (GEMMPrecision(m_acc=5, chunk=16), JGP(m_acc=5, chunk=16))
    p9 = (GEMMPrecision(m_acc=9, chunk=16), JGP(m_acc=9, chunk=16))
    if kind == "predicted":
        return (QDotConfig(fwd=p[0], bwd=p[0], grad=p[0], repr_fmt=FP8_152),
                JQC(fwd=p[1], bwd=p[1], grad=p[1], repr_fmt=JFP8))
    if kind == "lm_head":
        return (QDotConfig(fwd=p9[0], bwd=p9[0], grad=p9[0]),
                JQC(fwd=p9[1], bwd=p9[1], grad=p9[1]))
    # wide backward roles and a consumer format on the output
    return (QDotConfig(fwd=p[0], repr_fmt=FP8_152, out_fmt=FP8_152),
            JQC(fwd=p[1], repr_fmt=JFP8, out_fmt=JFP8))


@pytest.mark.parametrize("kind", ["predicted", "lm_head", "wide_out_fmt"])
def test_qdot_autograd_matches_jax_vjp(kind):
    """y, dx and dw of the port's autograd ``qdot`` against ``jax.vjp`` of
    the JAX ``qdot``, with bf16 weights handed over as ``dense`` does (so
    dw comes back rounded to bf16 on both sides)."""
    tcfg, jcfg = _plan(kind)
    rng = np.random.RandomState(len(kind))
    x = rng.randn(2, 24, 80).astype(np.float32)
    wt = torch.from_numpy((rng.randn(80, 48) / 9).astype(np.float32)
                          ).to(torch.bfloat16)
    g = rng.randn(2, 24, 48).astype(np.float32)
    jy, vjp = jax.vjp(lambda a, b: jax_qdot(a, b.astype(jnp.float32), jcfg),
                      jnp.asarray(x), jnp.asarray(wt.float().numpy()
                                                  ).astype(jnp.bfloat16))
    jdx, jdw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wl = wt.clone().requires_grad_()
    y = qdot(xt, wl, tcfg)
    y.backward(torch.from_numpy(g))
    assert y.shape == (2, 24, 48) and xt.grad.dtype == torch.float32
    assert wl.grad.dtype == torch.bfloat16
    for label, got, want, p in (
            ("y", y, jy, tcfg.fwd), ("dx", xt.grad, jdx, tcfg.bwd),
            ("dw", wl.grad, jdw, tcfg.grad)):
        acc = (8, 23) if p is None else (p.e_acc, p.m_acc)
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        _check(f"qdot {kind} {label}", _np(got), want, acc, False)


# --------------------------------------------------------------------------
# optimizer and data
# --------------------------------------------------------------------------

def _opt_trees(rng):
    shapes = {"a": (64, 32), "b": {"c": (32,), "d": (3, 16, 8)}}

    def mk(f):
        return {"a": f(shapes["a"]), "b": {k: f(s) for k, s in
                                           shapes["b"].items()}}

    return (mk(lambda s: rng.randn(*s).astype(np.float32)),
            mk(lambda s: (rng.randn(*s) * 0.01).astype(np.float32)),
            mk(lambda s: (rng.randn(*s) * 0.01).astype(np.float32)),
            mk(lambda s: (rng.rand(*s) * 1e-4).astype(np.float32)))


@pytest.mark.parametrize("step0,clip", [(0, 1e9), (37, 1.0), (0, 0.1)])
def test_adamw_matches_jax(step0, clip):
    """Against the JAX update evaluated op by op (XLA's jit may contract a
    multiply-add of the fused update, moving 0.1-0.5% of the parameters by
    one f32 ulp).  The global norm, a reduction in another order, within 4
    f32 ulps; lr (a cosine past the warmup) within 1 f32 ulp.  Parameters
    and moments bitwise while the clip scale is 1 (the gradients' norm,
    about 0.5, is under ``clip``); with clipping active the scale inherits
    the norm's last bit, so within 2 f32 ulps of each leaf's largest
    element (a moment that cancels can move by more than its own ulp)."""
    from repro.train import optimizer as JO
    from repro_torch.train import optimizer as TO

    P, G, M, V = _opt_trees(np.random.RandomState(step0 + 1))
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, grad_clip=clip)
    jtree = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    jp, jopt, js = JO.adamw_update(
        jtree(P), jtree(G), {"m": jtree(M), "v": jtree(V),
                             "step": jnp.int32(step0)}, JO.OptConfig(**kw))
    ttree = lambda t: TO.tree_map(  # noqa: E731
        lambda x: torch.from_numpy(x.copy()), t)
    tp, topt, ts = TO.adamw_update(
        ttree(P), ttree(G), {"m": ttree(M), "v": ttree(V),
                             "step": torch.tensor(step0, dtype=torch.int32)},
        TO.OptConfig(**kw))
    assert int(topt["step"]) == step0 + 1
    np.testing.assert_allclose(float(ts["lr"]), float(js["lr"]),
                               rtol=2.0 ** -23)
    np.testing.assert_allclose(float(ts["grad_norm"]), float(js["grad_norm"]),
                               rtol=4 * 2.0 ** -23)
    for got, want in ((tp, jp), (topt["m"], jopt["m"]),
                      (topt["v"], jopt["v"])):
        for a, b in zip(TO.tree_leaves(got), jax.tree.leaves(want)):
            if clip >= 1.0:
                np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
            else:
                a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=2.0 ** -22 * np.abs(b).max())


def test_adamw_skip_and_loss_scaler():
    from repro_torch.train import optimizer as TO

    P, G, M, V = _opt_trees(np.random.RandomState(9))
    ttree = lambda t: TO.tree_map(  # noqa: E731
        lambda x: torch.from_numpy(x.copy()), t)
    params, opt = ttree(P), {"m": ttree(M), "v": ttree(V),
                             "step": torch.tensor(3, dtype=torch.int32)}
    TO.adamw_update(params, ttree(G), opt, TO.OptConfig(),
                    skip=torch.tensor(True))
    assert int(opt["step"]) == 3
    for a, b in zip(TO.tree_leaves(params), TO.tree_leaves(ttree(P))):
        assert torch.equal(a, b)
    cfg = TO.LossScaleConfig(init_scale=1024.0, growth_interval=2)
    sc = TO.init_scaler(cfg)
    bad = ttree(G)
    bad["a"][0, 0] = float("inf")
    grads, sc, skip = TO.unscale_and_check(bad, sc, cfg)
    assert bool(skip) and float(sc["scale"]) == 512.0
    assert all(bool((g == 0).all()) for g in TO.tree_leaves(grads))
    for _ in range(2):
        _, sc, skip = TO.unscale_and_check(ttree(G), sc, cfg)
    assert not bool(skip) and float(sc["scale"]) == 1024.0


def test_synthetic_lm_follows_the_jax_next_token_map():
    """The next-token map is the JAX pipeline's int32 affine recurrence
    (bitwise, wrap-around included, at the full vocabulary); batches are a
    function of (seed, step) and the cursor resumes them."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, affine_next

    v = 151936
    rng = np.random.RandomState(0)
    t = rng.randint(0, v, 4096).astype(np.int32)
    a, b = 1 + 2 * 70001, 12345
    want = np.asarray((a * jnp.asarray(t) + b) % v)
    got = affine_next(torch.from_numpy(t), a, b, v).numpy()
    np.testing.assert_array_equal(got, want)

    cfg = DataConfig(vocab_size=v, seq_len=64, global_batch=8, seed=3,
                     noise=0.05)
    data = SyntheticLM(cfg)
    first = next(data)["tokens"]
    assert first.shape == (8, 64) and first.dtype == torch.int32
    tok = first.long()
    nxt = affine_next(tok[:, :-1], data.a_coef, data.b_coef, v)
    follows = float((nxt == tok[:, 1:]).float().mean())
    assert 0.85 < follows < 1.0        # noise hits ~2 x 5% of the pairs
    second = next(data)["tokens"]
    assert not torch.equal(first, second)
    resumed = SyntheticLM(cfg)
    resumed.load_state_dict({"step": 1, "seed": 3})
    assert torch.equal(next(resumed)["tokens"], second)
    assert torch.equal(SyntheticLM(cfg).batch_at(0)["tokens"], first)


@pytest.mark.parametrize("extra", [
    ["--policy", "perturbed", "--pp", "-1"],
    ["--policy", "predicted", "--loss-scaling", "--microbatches", "2"]])
def test_launch_train_smoke_cpu(capsys, extra):
    """The launcher end to end on the CPU: a perturbed plan, and loss
    scaling with two microbatches (the scale must leave the loss as it
    was: the records report the unscaled loss)."""
    from repro_torch.launch.train import main

    out = main(["--smoke", "--steps", "3", "--global-batch", "2",
                "--seq-len", "16", "--log-every", "1", "--chunk", "8",
                "--device", "cpu", *extra])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert len(recs) == 3 and np.isfinite(out["final_loss"])
    assert all(r["skipped"] == 0.0 and 4.0 < r["loss"] < 8.0 for r in recs)
    if "--loss-scaling" in extra:
        assert recs[0]["loss_scale"] == 1000.0


# --------------------------------------------------------------------------
# whole training steps of the smoke model against JAX
# --------------------------------------------------------------------------

SEQ, BATCH, CHUNK, STEPS = 32, 4, 16, 3


def _train_cfgs():
    from repro.configs import get_smoke_config as jsmoke
    from repro.core.policy import AccumulationPolicy as JPol
    from repro.core.policy import plan_for_model as jplan
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model

    jcfg = jplan(jsmoke("qwen2-1.5b"), seq_len=SEQ, global_batch=BATCH,
                 policy=JPol(mode="predicted", chunk=CHUNK))
    tcfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=SEQ,
                          global_batch=BATCH,
                          policy=AccumulationPolicy(mode="predicted",
                                                    chunk=CHUNK))
    return jcfg, tcfg


def _tokens():
    return np.random.RandomState(5).randint(0, 256, (STEPS, BATCH, SEQ)
                                            ).astype(np.int32)


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def train_child(out_path: str) -> None:
    """The JAX side: the first step's loss and gradients (w.r.t. the bf16
    cast tree, widened to f32, as the JAX train step takes them) and
    ``STEPS`` jitted train steps.  Run with
    ``--xla_allow_excess_precision=false`` (ROADMAP F2)."""
    from repro.models.api import get_model as jget
    from repro.train import optimizer as JO
    from repro.train.loop import TrainConfig as JTC
    from repro.train.loop import init_train_state, make_train_step

    jcfg, _ = _train_cfgs()
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
        out[f"grad_norm{s}"] = np.asarray(m["grad_norm"])
    _flat(state["params"], "pN", out)
    np.savez(out_path, **out)


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


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_train") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    child = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_train as t; t.train_child({path!r})"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert child.returncode == 0, child.stdout + child.stderr
    return dict(np.load(path))


# A bias (and the per-layer norms' scales, which have no reduction here)
# gets its gradient from a bf16 sum over the step's tokens: XLA:CPU adds
# them one by one in bf16, rounding after every add, where PyTorch
# accumulates in f32 and rounds once.  Bound on the relative error norm of
# a bias gradient (measured 0.025 at most):
BIAS_REL = 0.06
# the final norm's f32 gradient sums the tokens in another order (measured
# 1.1e-7 relative):
F32_REL = 1e-6


def test_train_step_gradients_match_jax(trained):
    """First step, same f32 weights and tokens: the loss, and every
    gradient leaf.  The matrices' and the embedding's gradients come out of
    the quantized GEMMs (B) and the deterministic scatter-add, fed by the
    same bf16 roundings as XLA's: held to 99.9% equal elements (measured
    100%)."""
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import _grads, compute_copy

    _, tcfg = _train_cfgs()
    params = _unflat(trained, "p0")
    compute = compute_copy(params)
    loss, _ = get_model(tcfg).loss_fn(
        compute, {"tokens": torch.from_numpy(_tokens()[0])}, tcfg)
    loss.backward()
    loss = loss.detach()
    print(f"loss {float(loss):.7f} vs JAX {float(trained['loss']):.7f}")
    assert abs(float(loss) - float(trained["loss"])) <= 1e-5
    grads = _flat(_grads(compute, params), "g", {})
    assert set(grads) == {k for k in trained if k.startswith("g/")}
    for name, got in grads.items():
        want = trained[name]
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


def test_train_steps_track_jax(trained):
    """``STEPS`` AdamW steps from the same weights on the same tokens.
    After the first update the bias gradients' bf16 sum order (above)
    moves the weights apart by about a carry rounding, and the (1,5,2)
    operands amplify that: bounds on the per-step loss (measured 0.0075 at
    most) and gradient norm (measured 1.1%)."""
    from repro_torch.models.api import get_model
    from repro_torch.train import optimizer as O
    from repro_torch.train.loop import TrainConfig, make_train_step

    _, tcfg = _train_cfgs()
    tc = TrainConfig(opt=O.OptConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=STEPS))
    params = _unflat(trained, "p0")
    state = {"params": params, "opt": O.init_opt_state(params),
             "scaler": O.init_scaler(tc.scaler)}
    step = make_train_step(get_model(tcfg), tc)
    toks = _tokens()
    for s in range(STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(toks[s])})
        dl = abs(float(m["loss"]) - float(trained[f"loss{s}"]))
        dg = abs(float(m["grad_norm"]) / float(trained[f"grad_norm{s}"]) - 1)
        print(f"step {s}: loss {float(m['loss']):.5f} (JAX "
              f"{float(trained[f'loss{s}']):.5f}), grad norm rel {dg:.4f}")
        assert dl <= 0.03 and dg <= 0.03
        assert float(m["skipped"]) == 0.0
