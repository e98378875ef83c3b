"""The layer remat policy (``REPRO_REMAT_POLICY``) of the port's training
forward against the JAX package's.

On the smoke config, through the plain versions of the kernels:

* the loss and every gradient are bitwise across ``full``, ``dots`` and
  ``none``, under the predicted plan (RNE and SR) and the exact plan, and
  through the train step with microbatches and loss scaling;
* what one layer leaves for its backward (``saved_tensors_hooks``, plus
  the matmul outputs that ``dots``' selective policy keeps) against
  ``jax.ad_checkpoint.print_saved_residuals`` of JAX's
  ``_remat(_block_apply)``, for the residuals of at least B*S*D elements;
* a recompute inside ``capture.capture_gemms()`` records nothing, and the
  in-graph collector's rows are equal across policies;
* the port under each policy against JAX's ``loss_fn(remat=True)`` under
  the same policy, in a child process with excess precision off (ROADMAP
  F2), within F4's tolerances (``tests/test_torch_train.py``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import AccumulationPolicy, plan_for_model
from repro_torch.models import lm
from repro_torch.models.api import get_model
from repro_torch.train.loop import _grads, compute_copy
from repro_torch.train.optimizer import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICIES = ("full", "dots", "none")
SEQ, BATCH, CHUNK = 32, 2, 16

PLANS = {
    "predicted": dict(mode="predicted", chunk=CHUNK),
    "predicted-sr": dict(mode="predicted", chunk=CHUNK, rounding="sr",
                         sr_seed=7),
    "exact": dict(mode="exact"),
}


@pytest.fixture(scope="module", autouse=True)
def jax_child(tmp_path_factory):
    """The JAX side of ``test_matches_jax_loss_fn_under_each_policy``
    (``remat_child``), started with the module's first test so that it
    runs beside the others; excess precision off (ROADMAP F2)."""
    path = str(tmp_path_factory.mktemp("jax_remat") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import test_torch_remat as t; t.remat_child({path!r})"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _cfg(plan: str):
    return plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=SEQ,
                          global_batch=BATCH,
                          policy=AccumulationPolicy(**PLANS[plan]))


def _params(cfg):
    return get_model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")


def _tokens(cfg, seed=1):
    return torch.randint(0, cfg.vocab_size, (BATCH, SEQ), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))


def test_policy_reading(monkeypatch):
    cfg, exact = _cfg("predicted"), _cfg("exact")
    monkeypatch.delenv("REPRO_REMAT_POLICY", raising=False)
    assert lm.remat_policy() == "full"
    for env, pol, fwd, fwd_exact in (("full", "full", 2, 2),
                                     ("dots", "dots", 2, 1),
                                     ("none", "none", 1, 1),
                                     ("bogus", "full", 2, 2)):
        monkeypatch.setenv("REPRO_REMAT_POLICY", env)
        assert lm.remat_policy() == pol
        assert lm.layer_forwards(cfg) == fwd
        assert lm.layer_forwards(exact) == fwd_exact
    # read when the forward is built: a body made under none stays plain
    monkeypatch.setenv("REPRO_REMAT_POLICY", "none")
    body = lm._remat(functools.partial(lm._block, cfg))
    assert isinstance(body, functools.partial)


# --------------------------------------------------------------------------
# numbers: bitwise across policies
# --------------------------------------------------------------------------


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_loss_and_grads_bitwise_across_policies(monkeypatch, plan):
    cfg = _cfg(plan)
    params, tokens = _params(cfg), _tokens(cfg)
    out = {}
    for pol in POLICIES:
        monkeypatch.setenv("REPRO_REMAT_POLICY", pol)
        c = compute_copy(params)
        loss, _ = lm.loss_fn(c, {"tokens": tokens}, cfg)
        loss.backward()
        out[pol] = (loss.detach(), tree_leaves(_grads(c, params)))
    for pol in ("dots", "none"):
        assert torch.equal(out[pol][0], out["full"][0]), pol
        assert len(out[pol][1]) == len(out["full"][1])
        for a, b in zip(out[pol][1], out["full"][1]):
            assert torch.equal(a, b), pol
    # remat=False is the plain loop whatever the policy
    monkeypatch.setenv("REPRO_REMAT_POLICY", "full")
    c = compute_copy(params)
    loss, _ = lm.loss_fn(c, {"tokens": tokens}, cfg, remat=False)
    assert torch.equal(loss.detach(), out["none"][0])


def test_microbatches_and_loss_scaling_compose(monkeypatch):
    """The train step with 2 microbatches and dynamic loss scaling: the
    scaled backward recomputes under the same policy; the state after a
    step is bitwise across policies."""
    import copy

    from repro_torch.train import optimizer as O
    from repro_torch.train.loop import TrainConfig, make_train_step

    cfg = _cfg("predicted")
    tc = TrainConfig(microbatches=2, use_loss_scaling=True,
                     scaler=O.LossScaleConfig(init_scale=1000.0,
                                              dynamic=True))
    params = _params(cfg)
    state0 = {"params": params, "opt": O.init_opt_state(params),
              "scaler": O.init_scaler(tc.scaler)}
    step = make_train_step(get_model(cfg), tc)
    out = {}
    for pol in POLICIES:
        monkeypatch.setenv("REPRO_REMAT_POLICY", pol)
        s, m = step(copy.deepcopy(state0), {"tokens": _tokens(cfg, 3)})
        out[pol] = (m["loss"], tree_leaves(s))
        assert float(m["skipped"]) == 0.0
    for pol in ("dots", "none"):
        assert torch.equal(out[pol][0], out["full"][0])
        assert all(torch.equal(a, b)
                   for a, b in zip(out[pol][1], out["full"][1])), pol


# --------------------------------------------------------------------------
# memory: what a layer leaves for its backward, against JAX's residuals
# --------------------------------------------------------------------------

_SHORT = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "i8",
          torch.int32: "i32", torch.bool: "bool"}


def _port_residuals(cfg, pol, monkeypatch):
    """[(dtype, shape, where)] of one layer under ``pol``: the distinct
    tensors autograd saves (``saved_tensors_hooks``; under ``full`` and
    ``dots`` the checkpoint's inputs), and the outputs ``dots``' selective
    policy keeps (``where`` "mm")."""
    monkeypatch.setenv("REPRO_REMAT_POLICY", pol)
    lp = compute_copy(_params(cfg))["layers"][0]
    x = (torch.randn(BATCH, SEQ, cfg.d_model,
                     generator=torch.Generator().manual_seed(2))
         .to(torch.bfloat16).requires_grad_())
    positions = torch.arange(SEQ, dtype=torch.int32)[None].expand(BATCH, SEQ)
    saved, kept = [], []
    policy = lm._dots_policy

    def spy(ctx, op, *args, **kwargs):
        verdict = policy(ctx, op, *args, **kwargs)
        if verdict == lm.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append((_SHORT[args[0].dtype],
                         (args[0].shape[0], args[1].shape[1]), "mm"))
        return verdict

    def pack(t):
        saved.append(t)
        return t

    monkeypatch.setattr(lm, "_dots_policy", spy)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = lm._remat(functools.partial(lm._block, cfg))(x, lp, positions)
    y.float().sum().backward()
    distinct = {(t.untyped_storage().data_ptr(), t.storage_offset(),
                 tuple(t.shape), t.dtype): t for t in saved}
    return [(_SHORT[t.dtype], tuple(t.shape), "saved")
            for t in distinct.values()] + kept


_RES = re.compile(r"^(\w+)\[([\d,]*)\] (.*)$")


def _jax_residuals(plan, pol, monkeypatch):
    """[(dtype, shape, description)] that ``print_saved_residuals`` lists
    for JAX's ``_remat(_block_apply)`` on layer 0 of the same config, the
    layer's parameters cast as the JAX train step casts them."""
    import jax
    import jax.ad_checkpoint
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jsmoke
    from repro.core.policy import AccumulationPolicy as JPol
    from repro.core.policy import plan_for_model as jplan
    from repro.models import layers as JL
    from repro.models import lm as jlm

    monkeypatch.setenv("REPRO_REMAT_POLICY", pol)
    jcfg = jplan(jsmoke("qwen2-1.5b"), seq_len=SEQ, global_batch=BATCH,
                 policy=JPol(**PLANS[plan]))
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    bp = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16) if a.ndim >= 2
                      else a[0], params["layers"])
    x = jnp.zeros((BATCH, SEQ, jcfg.d_model), jnp.bfloat16)
    positions = jnp.broadcast_to(jnp.arange(SEQ, dtype=jnp.int32)[None],
                                 (BATCH, SEQ))

    def body(x, bp):
        y, _ = jlm._block_apply(bp, x, jcfg, JL.LOCAL, positions)
        return jnp.sum(y.astype(jnp.float32))

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax.ad_checkpoint.print_saved_residuals(jlm._remat(body), x, bp)
    out = []
    for line in buf.getvalue().splitlines():
        m = _RES.match(line)
        if m:
            shape = tuple(int(d) for d in m.group(2).split(",") if d)
            out.append((m.group(1), shape, m.group(3)))
    return out


def _large(res, cfg):
    bsd = BATCH * SEQ * cfg.d_model
    return [r for r in res if int(np.prod(r[1])) >= bsd]


def _key(res):
    return collections.Counter((r[0], r[1]) for r in res)


def _nbytes(res):
    size = {"bf16": 2, "f32": 4, "i8": 1, "i32": 4, "bool": 1}
    return sum(size[r[0]] * int(np.prod(r[1])) for r in res)


@pytest.mark.parametrize("plan", ["predicted", "exact"])
def test_saved_residuals_match_jax(monkeypatch, plan):
    """``full``: the layer's input and its weights, as JAX lists them.
    ``dots``: on the predicted plan exactly ``full`` (the GEMMs are kernels,
    not matmul ops, as JAX's are ``pallas_call``s); on the exact plan
    ``full`` plus the layer's seven 2-D GEMM outputs, a superset of the
    dense outputs JAX keeps (JAX's partial evaluation drops those its
    backward never reads; the selective checkpoint keeps every output its
    policy names).  ``none``: the GEMM residuals (the int8 codes of E) and
    the rms-norms' f32 intermediates as JAX's; the attention softmax and
    the SwiGLU keep what each package's autodiff saves (JAX: the
    broadcast mask, masked scores, ``exp`` output and bf16 probabilities;
    PyTorch: the softmax output and the f32 operands of the p.v product),
    no more bytes than JAX's."""
    cfg = _cfg(plan)
    port = {p: _port_residuals(cfg, p, monkeypatch) for p in POLICIES}
    jax_ = {p: _jax_residuals(plan, p, monkeypatch) for p in POLICIES}
    for p in POLICIES:
        print(plan, p, "port", sorted(_key(_large(port[p], cfg)).items()))
        print(plan, p, "jax ", sorted(_key(_large(jax_[p], cfg)).items()))
    assert _key(_large(port["full"], cfg)) == _key(_large(jax_["full"], cfg))
    # every saved input of full, the layer input first, is JAX's
    assert _key(port["full"]) == _key(jax_["full"])
    extra = [r for r in port["dots"] if r[2] == "mm"]
    assert _key([r for r in port["dots"] if r[2] != "mm"]) == _key(
        port["full"])
    t = BATCH * SEQ
    if plan == "predicted":
        assert extra == []
        assert _key(jax_["dots"]) == _key(jax_["full"])
    else:
        d, f = cfg.d_model, cfg.d_ff
        kvd = cfg.n_kv_heads * cfg.head_dim
        qd = cfg.n_heads * cfg.head_dim
        assert _key(extra) == _key([("bf16", (t, n), "") for n in
                                    (kvd, kvd, qd, d, f, f, d)])
        jax_dense = [r for r in jax_["dots"] if "(dense)" in r[2]]
        assert jax_dense and all(r[0] == "bf16" and r[1][-1] in
                                 (kvd, qd, d, f) for r in jax_dense)
        mine = collections.Counter(int(np.prod(r[1])) for r in extra)
        theirs = collections.Counter(int(np.prod(r[1])) for r in jax_dense)
        assert not theirs - mine
    codes = lambda res: _key([r for r in res if r[0] == "i8"])  # noqa: E731
    assert codes(port["none"]) == codes(jax_["none"])
    norm = ("f32", (BATCH, SEQ, cfg.d_model))
    assert _key(port["none"])[norm] == _key(
        [r for r in jax_["none"] if "(rms_norm)" in r[2]])[norm]
    assert _nbytes(_large(port["none"], cfg)) <= _nbytes(
        _large(jax_["none"], cfg))


# --------------------------------------------------------------------------
# telemetry: recompute records nothing; in-graph rows across policies
# --------------------------------------------------------------------------


def test_recompute_records_no_capture(monkeypatch):
    from repro_torch.telemetry import capture

    cfg = _cfg("predicted")
    params, tokens = _params(cfg), _tokens(cfg)
    got = {}
    for pol in POLICIES:
        monkeypatch.setenv("REPRO_REMAT_POLICY", pol)
        c = compute_copy(params)
        with capture.capture_gemms() as rec:
            loss, _ = lm.loss_fn(c, {"tokens": tokens}, cfg)
            n_fwd = len(rec)
            loss.backward()
        got[pol] = (n_fwd, len(rec), [tuple(r["x"].shape) for r in rec])
    # the lm_head alone, recorded once, whatever the policy
    assert got["full"] == got["dots"] == got["none"] == (
        1, 1, [(BATCH * SEQ, cfg.d_model)])


def test_ingraph_rows_equal_across_policies(monkeypatch):
    from repro_torch.obs.ingraph import (InGraphCollector, collecting,
                                         tag_quant_plan)

    cfg = tag_quant_plan(_cfg("predicted"))
    params, tokens = _params(cfg), _tokens(cfg)
    rows = {}
    for pol in POLICIES:
        monkeypatch.setenv("REPRO_REMAT_POLICY", pol)
        col = InGraphCollector()
        c = compute_copy(params)
        with collecting(col):
            loss, _ = lm.loss_fn(c, {"tokens": tokens}, cfg)
            loss.backward()
        rows[pol] = col.rows()
    assert len(rows["full"]) == 15
    for pol in ("dots", "none"):
        assert rows[pol].keys() == rows["full"].keys()
        for k in rows["full"]:
            np.testing.assert_array_equal(rows[pol][k], rows["full"][k])


# --------------------------------------------------------------------------
# against JAX's loss_fn(remat=True) under each policy
# --------------------------------------------------------------------------


def remat_child(out_path: str) -> None:
    """The JAX side: the loss and the gradients w.r.t. the bf16 cast tree of
    ``loss_fn(remat=True)``, jitted under each ``REPRO_REMAT_POLICY`` (read
    at trace time), from ``init_params(PRNGKey(0))``, on the tokens of
    ``_tokens``.  Run with ``--xla_allow_excess_precision=false``."""
    import jax
    import jax.numpy as jnp

    from repro.models.api import get_model as jget
    from test_torch_train import _flat

    from repro.configs import get_smoke_config as jsmoke
    from repro.core.policy import AccumulationPolicy as JPol
    from repro.core.policy import plan_for_model as jplan

    jcfg = jplan(jsmoke("qwen2-1.5b"), seq_len=SEQ, global_batch=BATCH,
                 policy=JPol(**PLANS["predicted"]))
    model = jget(jcfg)
    params = model.init_params(jax.random.PRNGKey(0))
    out = _flat(params, "p0", {})
    batch = {"tokens": jnp.asarray(_tokens(_cfg("predicted")).numpy())}

    def grads(params):
        cast = jax.tree.map(lambda p: p.astype(jnp.bfloat16) if (
            p.dtype == jnp.float32 and p.ndim >= 2) else p, params)
        (loss, _), g = jax.value_and_grad(
            lambda p: model.loss_fn(p, batch, jcfg, remat=True),
            has_aux=True)(cast)
        return loss, jax.tree.map(lambda x: x.astype(jnp.float32), g)

    for pol in POLICIES:
        os.environ["REPRO_REMAT_POLICY"] = pol
        loss, g = jax.jit(grads)(params)
        out[f"{pol}/loss"] = np.asarray(loss)
        _flat(g, f"{pol}/g", out)
    np.savez(out_path, **out)


def test_matches_jax_loss_fn_under_each_policy(monkeypatch, jax_child):
    from test_torch_train import BIAS_REL, F32_REL, _flat, _unflat

    proc, path = jax_child
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    want = dict(np.load(path))
    cfg = _cfg("predicted")
    params = _unflat(want, "p0")
    for pol in POLICIES:
        monkeypatch.setenv("REPRO_REMAT_POLICY", pol)
        c = compute_copy(params)
        loss, _ = lm.loss_fn(c, {"tokens": _tokens(cfg)}, cfg)
        loss.backward()
        loss = loss.detach()
        print(f"{pol}: loss {float(loss):.7f} vs JAX "
              f"{float(want[f'{pol}/loss']):.7f}")
        assert abs(float(loss) - float(want[f"{pol}/loss"])) <= 1e-5
        grads = _flat(_grads(c, params), f"{pol}/g", {})
        assert set(grads) == {k for k in want if k.startswith(f"{pol}/g/")}
        for name, got in grads.items():
            ref = want[name]
            eq = float(np.mean(got == ref))
            rel = float(np.linalg.norm(got - ref)
                        / max(np.linalg.norm(ref), 1e-30))
            if name.endswith(("/bq", "/bk", "/bv")):
                assert rel <= BIAS_REL, name
            elif name.endswith("/final_norm"):
                assert rel <= F32_REL, name
            else:
                assert eq >= 0.999, (name, eq)
