"""Port vs JAX package: A2Q, the accumulator-aware overflow guarantee.

The counterpart of ``tests/test_a2q.py`` for ``repro_torch`` (without
``plan_verify``, which comes with speculative decoding): the guarantee
held adversarially through K8's plain version (projected weights never
reach the carry's clamp under RNE or SR carries; the same adversary trips
it on weights over the cap), and the port's ``A2QConfig``,
``a2q_l1_cap``, ``a2q_penalty``, ``a2q_project``, ``a2q_certificate``,
``adamw_update(a2q=)``, the train step's penalty, the launcher's
``--a2q-reg``/``--a2q-x-bound`` and the planner's ``guarantee="a2q"``
against the JAX package's on the same numpy inputs.

Tolerances: the certificate's verdicts and the planner's outputs are
equal; a column's l1 norm is an f32 sum whose order differs between XLA
and PyTorch, so the penalty and the projected weights are held within
``REL`` relative error of JAX's (measured: at most a few f32 ulps).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as JO
from repro_torch.core.policy import GEMMPrecision
from repro_torch.telemetry.stats import gemm_stats
from repro_torch.train import optimizer as O

# acc (1,4,9), inputs bounded by 4, margin 1: a per-column l1 cap of
# 255.75 / 2 / 4 ~ 32, which binds at test scale (tests/test_a2q.py's)
A2Q = O.A2QConfig(e_acc=4, m_acc=9, x_bound=4.0, margin_bits=1,
                  strength=1e-3)
JA2Q = JO.A2QConfig(e_acc=4, m_acc=9, x_bound=4.0, margin_bits=1,
                    strength=1e-3)
ACC_MAX = O.acc_format_max(A2Q.e_acc, A2Q.m_acc)
PREC = GEMMPrecision(m_acc=A2Q.m_acc, e_acc=A2Q.e_acc, chunk=32)
# relative error of an f32 column sum taken in another order
REL = 1e-5


def _adversarial_x(w: np.ndarray, x_bound: float, rng, mode: str):
    """Worst-case bounded input for ``max |x @ w|``: magnitudes at the
    bound, signs aligned with the heaviest column (or against it, or
    random)."""
    col = int(np.argmax(np.abs(w).sum(0)))
    if mode == "aligned":
        return (np.sign(w[:, col]) * x_bound).astype(np.float32)[None, :]
    if mode == "anti":
        return (-np.sign(w[:, col]) * x_bound).astype(np.float32)[None, :]
    return (rng.choice([-1.0, 1.0], size=(4, w.shape[0])) * x_bound *
            rng.uniform(0.5, 1.0, size=(4, w.shape[0]))).astype(np.float32)


def _max_carry(x: np.ndarray, w: torch.Tensor, *, rounding="rne",
               sr_seed=0) -> float:
    """max |carry| K8 saw over every chunk update."""
    _, st = gemm_stats(torch.from_numpy(x), w, precision=PREC,
                       rounding=rounding, sr_seed=sr_seed)
    return float(st.max_abs)


@pytest.mark.parametrize("rounding", ["rne", "sr"])
def test_a2q_constrained_never_overflows_adversarial(rounding):
    rng = np.random.RandomState(0)
    for trial in range(12):
        k = int(rng.randint(16, 257))
        n = int(rng.randint(4, 49))
        scale = float(rng.uniform(0.5, 20.0))
        w = rng.standard_normal((k, n)).astype(np.float32) * scale
        wp = O.a2q_project({"w": torch.from_numpy(w)}, A2Q)["w"]
        assert O.a2q_certificate({"w": wp}, A2Q)["ok"]
        for mode in ("aligned", "anti", "random"):
            x = _adversarial_x(wp.numpy(), A2Q.x_bound, rng, mode)
            m = _max_carry(x, wp, rounding=rounding, sr_seed=trial)
            # certified: strictly below the saturation clamp (margin bit)
            assert m < ACC_MAX, (trial, mode, m)


def test_a2q_meta_unconstrained_trips_detector():
    # weights 4x over the cap reach the clamp: the detector is live
    rng = np.random.RandomState(1)
    tripped = 0
    for _ in range(6):
        k = int(rng.randint(64, 257))
        n = int(rng.randint(4, 33))
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
        wp = O.a2q_project({"w": w}, A2Q)["w"] * 4.0
        x = _adversarial_x(wp.numpy(), A2Q.x_bound, rng, "aligned")
        tripped += _max_carry(x, wp) >= ACC_MAX
    assert tripped == 6


# ----------------------------- optimizer side ------------------------------


def _tree(seed: int, scale: float = 8.0) -> dict:
    rng = np.random.RandomState(seed)
    return {"w": rng.standard_normal((64, 8)).astype(np.float32) * scale,
            "b": rng.standard_normal((8,)).astype(np.float32),
            "stack": {"ln": np.abs(rng.standard_normal((6, 8))).astype(
                np.float32) * scale, "m": rng.standard_normal(
                    (6, 16, 8)).astype(np.float32)}}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= rel * np.maximum(np.abs(want), 1e-30))


@pytest.mark.parametrize("seed,scale", [(2, 8.0), (3, 1.0), (4, 40.0)])
def test_a2q_functions_match_jax(seed, scale):
    tree = _tree(seed, scale)
    t = _to(tree, torch.from_numpy)
    j = _to(tree, jnp.asarray)
    assert O.a2q_l1_cap(A2Q) == JO.a2q_l1_cap(JA2Q)
    assert O.acc_format_max(4, 9) == JO.acc_format_max(4, 9)
    tc, jc = O.a2q_certificate(t, A2Q), JO.a2q_certificate(j, JA2Q)
    assert tc["ok"] == jc["ok"] and tc["acc_max"] == jc["acc_max"]
    _close(tc["max_col_l1"], jc["max_col_l1"])
    _close(float(O.a2q_penalty(t, A2Q)), float(JO.a2q_penalty(j, JA2Q)))
    tp, jp = O.a2q_project(t, A2Q), JO.a2q_project(j, JA2Q)
    for key in ("w", "b"):
        _close(tp[key].numpy(), np.asarray(jp[key]))
    _close(tp["stack"]["ln"].numpy(), np.asarray(jp["stack"]["ln"]))
    # vectors and 3-D stacks pass through untouched
    assert torch.equal(tp["b"], t["b"])
    assert torch.equal(tp["stack"]["m"], t["stack"]["m"])
    assert O.a2q_certificate(tp, A2Q)["ok"] == \
        JO.a2q_certificate(jp, JA2Q)["ok"] is True
    # on the cap: the penalty vanishes, signs and zeros stay
    assert float(O.a2q_penalty(tp, A2Q)) < 1e-9
    assert torch.equal(torch.sign(tp["w"]), torch.sign(t["w"]))


def test_adamw_update_projects_as_jax():
    tree = _tree(5)
    grads = _tree(6, 1.0)
    cfg = O.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    jcfg = JO.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    t = _to(tree, lambda a: torch.from_numpy(a.copy()))
    j = _to(tree, jnp.asarray)
    opt = O.init_opt_state(t)
    O.adamw_update(t, _to(grads, torch.from_numpy), opt, cfg, a2q=A2Q)
    jp, _, _ = JO.adamw_update(j, _to(grads, jnp.asarray),
                               JO.init_opt_state(j), jcfg, a2q=JA2Q)
    assert O.a2q_certificate(t, A2Q)["ok"]
    for got, want in ((t["w"], jp["w"]), (t["b"], jp["b"]),
                      (t["stack"]["ln"], jp["stack"]["ln"]),
                      (t["stack"]["m"], jp["stack"]["m"])):
        _close(got.numpy(), np.asarray(want))
    # project=False: the plain update
    u = _to(tree, lambda a: torch.from_numpy(a.copy()))
    O.adamw_update(u, _to(grads, torch.from_numpy), O.init_opt_state(u),
                   cfg, a2q=O.A2QConfig(e_acc=4, m_acc=9, x_bound=4.0,
                                        project=False))
    assert not O.a2q_certificate(u, A2Q)["ok"]


def test_train_step_penalty_and_projection():
    """The smoke model's step with A2Q: the penalty joins the loss over
    the stacked tree's 2-D leaves (the layers' vectors stacked, the
    embedding), and the parameters are projected after the step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import (
        TrainConfig,
        compute_copy,
        init_train_state,
        make_train_step,
        stacked_2d,
    )

    cfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=16,
                         global_batch=2,
                         policy=AccumulationPolicy(mode="predicted",
                                                   chunk=16))
    model = get_model(cfg)
    # (1,3,5) bounded by 16: a cap of about 0.49 that every column breaks
    a2q = O.A2QConfig(e_acc=3, m_acc=5, x_bound=16.0, strength=1e-4)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=gen, dtype=torch.int32)}
    out = {}
    for name, tc in (("a2q", TrainConfig(a2q=a2q)), ("off", TrainConfig())):
        state = init_train_state(model, torch.Generator().manual_seed(1),
                                 "cpu", tc)
        compute = compute_copy(state["params"])
        leaves = stacked_2d(compute)
        # the embedding and the layers' norm scales and biases, stacked:
        # the 2-D leaves of the stacked tree, in its order
        assert [x.shape for x in leaves] == [
            p.shape for p in O.tree_leaves(state["params"]) if p.ndim == 2]
        assert len(leaves) > 1
        pen = float(O.a2q_penalty(leaves, a2q))
        state, m = make_train_step(model, tc)(state, batch)
        out[name] = (float(m["loss"]), pen, state["params"])
    loss_a2q, pen, params = out["a2q"]
    assert pen > 0
    assert abs((loss_a2q - out["off"][0]) - pen) <= 1e-5 * abs(loss_a2q)
    assert O.a2q_certificate(params, a2q)["ok"]
    assert not O.a2q_certificate(out["off"][2], a2q)["ok"]


def test_launcher_a2q_flags(capsys):
    """``--a2q-reg``/``--a2q-x-bound``: the cap from the plan's narrowest
    accumulator, as the JAX launcher derives it; refused under the exact
    policy; the certificate holds after each step of a smoke run."""
    from repro_torch.launch import train as L

    args = L.parse_args(["--smoke", "--policy", "predicted", "--chunk", "16",
                         "--a2q-reg", "1e-4", "--a2q-x-bound", "16",
                         "--global-batch", "2", "--seq-len", "16",
                         "--steps", "2", "--log-every", "1", "--device",
                         "cpu"])
    model, tc, state, data, _ = L.build(args)
    narrow = min((p for f in ("attn_qkv", "attn_out", "mlp_up", "mlp_down",
                              "lm_head")
                  for r in ("fwd", "bwd", "grad")
                  for p in [getattr(getattr(model.cfg.quant, f), r)]),
                 key=lambda p: (p.e_acc, p.m_acc))
    assert (tc.a2q.e_acc, tc.a2q.m_acc) == (narrow.e_acc, narrow.m_acc)
    assert (tc.a2q.x_bound, tc.a2q.strength, tc.a2q.project) == \
        (16.0, 1e-4, True)
    assert "a2q: cap per-column l1 at" in capsys.readouterr().out
    from repro_torch.train.loop import make_train_step

    step = make_train_step(model, tc)
    for _ in range(2):
        state, _ = step(state, next(data))
        assert O.a2q_certificate(state["params"], tc.a2q)["ok"]
    with pytest.raises(SystemExit):
        L.build(L.parse_args(["--smoke", "--policy", "exact", "--a2q-reg",
                              "1e-4", "--device", "cpu"]))
    off = L.parse_args(["--smoke", "--policy", "predicted", "--device",
                        "cpu"])
    assert L.a2q_config(off, model.cfg) is None


# ------------------------- serve planner a2q mode --------------------------


@pytest.mark.parametrize("ctx", [256, 1024, 4096, 65536])
@pytest.mark.parametrize("e_min", [3, 6])
def test_min_e_acc_guarantees_match_jax(ctx, e_min):
    from repro.serve.plan import min_e_acc as jmin
    from repro_torch.serve.plan import min_e_acc

    for v_cap in (0.5, 256.0, 1e6):
        assert min_e_acc(ctx, e_min=e_min, guarantee="a2q", v_cap=v_cap) \
            == jmin(ctx, e_min=e_min, guarantee="a2q", v_cap=v_cap)
    assert min_e_acc(ctx, e_min=e_min, boundaries=(64, ctx // 2)) == \
        jmin(ctx, e_min=e_min, boundaries=(64, ctx // 2))


def test_plan_a2q_guarantee_is_length_independent():
    from repro_torch.serve.plan import min_e_acc

    bucket = [min_e_acc(ctx, e_min=3) for ctx in (256, 4096, 65536)]
    a2q = [min_e_acc(ctx, e_min=3, guarantee="a2q", v_cap=256.0)
           for ctx in (256, 4096, 65536)]
    assert len(set(a2q)) == 1
    assert bucket[-1] > bucket[0]
    assert a2q[0] <= bucket[-1]


def test_plan_a2q_guarantee_validation():
    from repro.serve.plan import min_e_acc as jmin
    from repro_torch.serve.plan import min_e_acc

    for fn in (min_e_acc, jmin):
        with pytest.raises(ValueError):
            fn(1024, guarantee="a2q")
        with pytest.raises(ValueError):
            fn(1024, guarantee="a2q", v_cap=0.0)
        with pytest.raises(ValueError):
            fn(1024, guarantee="certified-by-vibes")


@pytest.mark.parametrize("chunk", [None, 64])
def test_plan_attention_records_a2q_as_jax(chunk):
    from repro.serve.plan import plan_attention as jplan
    from repro_torch.serve.plan import plan_attention

    t = plan_attention(4096, 16, guarantee="a2q", v_cap=256.0, e_min=3,
                       prefill_chunk_tokens=chunk)
    j = jplan(4096, 16, guarantee="a2q", v_cap=256.0, e_min=3,
              prefill_chunk_tokens=chunk)
    assert (t.guarantee, t.v_cap, t.e_min) == ("a2q", 256.0, 3)
    assert (t.guarantee, t.v_cap, t.e_min) == (j.guarantee, j.v_cap, j.e_min)
    assert [(b.max_ctx, b.e_acc, b.m_acc, b.resumptions) for b in t.buckets] \
        == [(b.max_ctx, b.e_acc, b.m_acc, b.resumptions) for b in j.buckets]
    default = plan_attention(4096, 16)
    assert (default.guarantee, default.v_cap, default.e_min) == \
        ("bucket", None, 6)
