"""Port vs JAX package: the paged half of the model families (ROADMAP
[families]): MoE (moonshot-v1-16b-a3b, llama4-maverick-400b-a17b), qk-norm
(qwen3-8b), the VLM stub (internvl2-2b) and the other dense configs
(llama3.2-3b, granite-8b), on their ``SMOKE`` configs.

The configs, parameters and plans must equal JAX's.  ``moe_apply`` runs
against JAX's, eagerly (no excess precision to turn off), on both expert
routes (the fused ``qdot`` and the einsum, ``REPRO_MOE_FUSED``), each
against JAX's same route, with the routing exact: the same experts and
gates as ``jax.lax.top_k`` (ties included) and the same kept slots under a
capacity that drops tokens.  The training loss, its gradients and 3
AdamW steps, the paged engine's greedy streams and the legacy
``decode_step``'s run against JAX children (one a config group, run side
by side, with ``--xla_allow_excess_precision=false``, ROADMAP F2).

Tolerances, each with what it measured:

* ``moe_apply``'s output, the experts and the kept slots: bitwise; the
  float32 gates within 2 ulp (the softmax's row sums), their bf16
  roundings equal.  The aux loss sums
  softmax rows and a mean over tokens in another order than XLA: within
  ``AUX_REL`` (measured 1.07e-7, one float32 ulp).
* The loss within ``LOSS_TOL`` of JAX's (measured 9.5e-7), and every
  gradient leaf at least ``GRAD_EQ`` equal elements (measured: qwen3's and
  internvl2's bitwise, qk-norm's scales included), except the leaves that
  a bf16 sum over tokens feeds (the biases' rule of
  ``tests/test_torch_train.py``, ``GRAD_REL``) and MoE's below its top
  layer (``EXPERT_EQ``, ``MOE_REL``: ROADMAP F9, the gates' gradient a
  bf16 sum over d_model).
* The 3 steps: F4's 0.03 on the loss and the gradient norm
  (``tests/test_torch_train.py``).
* The greedy streams and the legacy tokens: token for token.
* ``with_extras``' patch embeddings: within 3 float32 ulp of
  ``jax.random.normal`` (``data.prng.normal``: PyTorch's ``log1p``), their
  bf16 roundings, which the model takes, equal.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b", "qwen3-8b",
             "llama3.2-3b", "granite-8b", "internvl2-2b")
MOE_ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b")
TRAIN_ARCHS = ("moonshot-v1-16b-a3b", "qwen3-8b", "internvl2-2b")
# the engine runs: MoE in 16-token slabs (a slab's padded width sets the
# capacity), qwen3 one-shot
SERVE_CHUNKS = {"moonshot-v1-16b-a3b": (16,), "qwen3-8b": (None,)}
SEQ, BATCH, CHUNK, STEPS = 32, 4, 16, 3
PROMPT_LENS, GEN, PAGE, MAX_BATCH = (16, 21, 48), 8, 16, 4
LEGACY_BATCH, LEGACY_PROMPT, LEGACY_GEN = 2, 16, 8

AUX_REL = 1e-6
LOSS_TOL = 1e-5
GRAD_EQ = 0.999
GRAD_REL = 0.06
STEP_TOL = 0.03


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: beside the other pytest workers a full-width
    OpenMP pool thrashes the host's cores (ROADMAP P4)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    """A numpy or JAX array as a tensor (bf16 carried by its bits)."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bf16_tree(tree):
    return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                        if x.dtype == jnp.float32 else x, tree)


def _plans(arch, seq_len, batch):
    from repro.configs import get_smoke_config as jsmoke
    from repro.core.policy import AccumulationPolicy as JPol
    from repro.core.policy import plan_for_model as jplan
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model

    jcfg = jplan(jsmoke(arch), seq_len=seq_len, global_batch=batch,
                 policy=JPol(mode="predicted", chunk=CHUNK))
    tcfg = plan_for_model(get_smoke_config(arch), seq_len=seq_len,
                          global_batch=batch,
                          policy=AccumulationPolicy(mode="predicted",
                                                    chunk=CHUNK))
    return jcfg, tcfg


def _tokens():
    return np.random.RandomState(5).randint(0, 256, (STEPS, BATCH, SEQ)
                                            ).astype(np.int32)


def _prompts():
    rng = np.random.RandomState(31)
    return [rng.randint(0, 256, n).tolist() for n in PROMPT_LENS]


def _n_pages():
    return -(-int(sum(n + GEN for n in PROMPT_LENS) * 1.25) // PAGE) + 1


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _tflat(tree, prefix, out):
    """``_flat`` of a tree of tensors, keeping the tensors."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _tflat(tree[k], f"{prefix}/{k}", out)
    else:
        out[prefix] = tree
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
        d[leaf] = v
    return tree


# --------------------------------------------------------------------------
# the JAX children
# --------------------------------------------------------------------------


def _jax_train(arch: str, out: dict) -> None:
    """The loss, aux and gradients (w.r.t. the bf16 cast tree, widened to
    f32) of ``STEPS`` AdamW steps from key 0's weights, each step JAX's
    ``make_train_step`` without loss scaling: the jitted gradients, the
    finite check, ``adamw_update`` (one compile, where the jitted step
    would add a second)."""
    from repro.data.pipeline import with_extras
    from repro.models.api import get_model
    from repro.train import optimizer as JO

    jcfg, _ = _plans(arch, SEQ, BATCH)
    model = get_model(jcfg)
    opt_cfg = JO.OptConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS)
    # jitted: the same draws as the eager init, in a fraction of its time
    params = jax.jit(model.init_params)(jax.random.PRNGKey(0))
    opt = JO.init_opt_state(params)
    _flat(params, f"{arch}/p0", out)

    def grads(params, batch):
        cast = jax.tree.map(lambda p: p.astype(jnp.bfloat16) if (
            p.dtype == jnp.float32 and p.ndim >= 2) else p, params)
        (loss, m), g = jax.value_and_grad(
            lambda p: model.loss_fn(p, batch, jcfg), has_aux=True)(cast)
        return loss, m, jax.tree.map(lambda x: x.astype(jnp.float32), g)

    grads = jax.jit(grads)
    for s, toks in enumerate(_tokens()):
        loss, m, g = grads(params, with_extras({"tokens": jnp.asarray(toks)},
                                               jcfg))
        if s == 0:
            out[f"{arch}/loss"] = np.asarray(loss)
            out[f"{arch}/aux"] = np.asarray(m.get("aux", 0.0))
            _flat(g, f"{arch}/g", out)
        finite = jnp.array(True)
        for leaf in jax.tree.leaves(g):
            finite = jnp.logical_and(finite, jnp.all(jnp.isfinite(leaf)))
        skip = jnp.logical_not(finite)
        g = jax.tree.map(lambda x: jnp.where(skip, jnp.zeros_like(x), x), g)
        params, opt, stats = JO.adamw_update(params, g, opt, opt_cfg,
                                             skip=skip)
        out[f"{arch}/loss{s}"] = np.asarray(loss)
        out[f"{arch}/grad_norm{s}"] = np.asarray(stats["grad_norm"])


def _jax_serve(arch: str, out: dict) -> None:
    """The paged engine's greedy streams (``SERVE_CHUNKS``) and the legacy ``decode_step``'s greedy tokens (prompt replay, then
    ``LEGACY_GEN`` steps), on the bf16 weights of key 0."""
    from repro.models.api import get_model
    from repro.models.layers import Dist
    from repro.quant.formats import FPFormat
    from repro.serve import scheduler as JS
    from repro.serve.kvcache import PagedKVConfig

    jcfg, _ = _plans(arch, max(PROMPT_LENS) + GEN, len(PROMPT_LENS))
    model = get_model(jcfg)
    params = _bf16_tree(jax.jit(model.init_params)(jax.random.PRNGKey(0)))
    for chunk in SERVE_CHUNKS[arch]:
        ex = JS.ModelExecutor(model, params, PagedKVConfig.for_model(
            jcfg, n_pages=_n_pages(), page_size=PAGE),
            kv_fmt=FPFormat(5, 2), max_batch=MAX_BATCH)
        eng = JS.ServeEngine(model, params, n_pages=_n_pages(),
                             page_size=PAGE, max_batch=MAX_BATCH,
                             prefill_chunk_tokens=chunk, executor=ex)
        rids = [eng.submit(p, GEN) for p in _prompts()]
        res = eng.run()
        out[f"{arch}/streams{chunk}"] = np.array([res[r] for r in rids])
    prompt = np.random.RandomState(7).randint(
        0, 256, (LEGACY_BATCH, LEGACY_PROMPT)).astype(np.int32)
    step = jax.jit(lambda p, t, s, pos: model.decode_step(
        p, t, s, pos, jcfg, Dist()))
    state = model.init_decode_state(jcfg, LEGACY_BATCH,
                                    LEGACY_PROMPT + LEGACY_GEN)
    toks, tok = [], None
    for pos in range(LEGACY_PROMPT + LEGACY_GEN - 1):
        inp = prompt[:, pos:pos + 1] if pos < LEGACY_PROMPT else tok
        logits, state = step(params, jnp.asarray(inp), state, jnp.int32(pos))
        tok = jnp.argmax(logits[:, 0], axis=-1)[:, None]
        if pos >= LEGACY_PROMPT - 1:
            toks.append(np.asarray(tok[:, 0]))
    out[f"{arch}/legacy"] = np.stack(toks, axis=1)


def families_child(out_path: str, jobs: str) -> None:
    """One JAX child: ``jobs`` a comma-separated list of ``train:ARCH`` and
    ``serve:ARCH``."""
    out: dict = {}
    for job in jobs.split(","):
        kind, arch = job.split(":")
        (_jax_train if kind == "train" else _jax_serve)(arch, out)
    np.savez(out_path, **out)


# one child a job, all side by side (each is mostly one thread's jit
# compile)
CHILD_JOBS = ("train:moonshot-v1-16b-a3b", "serve:moonshot-v1-16b-a3b",
              "train:qwen3-8b", "serve:qwen3-8b", "train:internvl2-2b")


@pytest.fixture(scope="module", autouse=True)
def _jax_children(tmp_path_factory):
    """The JAX children, started with the module's first test so that they
    run while the in-process tests do; ``jax_runs`` waits for them."""
    tmp = tmp_path_factory.mktemp("jax_families")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    procs = []
    for i, jobs in enumerate(CHILD_JOBS):
        path = str(tmp / f"jax{i}.npz")
        procs.append((path, subprocess.Popen(
            [sys.executable, "-c", "import test_torch_families as t; "
             f"t.families_child({path!r}, {jobs!r})"],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    yield procs
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_runs(_jax_children):
    import ml_dtypes

    flat = {}
    for path, proc in _jax_children:
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log
        flat.update(np.load(path))
    for k, v in flat.items():
        if v.dtype.kind == "V":     # np.savez keeps bf16 as raw bytes
            flat[k] = v.view(ml_dtypes.bfloat16)
    return flat


# --------------------------------------------------------------------------
# configs, parameters, plans
# --------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_equals_jax(arch, which):
    """Every field of JAX's ``ModelConfig`` (the ``MoEConfig`` field by
    field): equal where the port has it, and JAX's default where it does
    not (the SSM, hybrid and encoder-decoder fields)."""
    import repro.configs as JC
    import repro_torch.configs as TC
    from repro.models.config import ModelConfig as JModel

    jcfg = getattr(JC._module(arch), which)
    tcfg = getattr(TC._module(arch), which)
    tfields = {f.name for f in dataclasses.fields(tcfg)}
    for f in dataclasses.fields(JModel):
        want = getattr(jcfg, f.name)
        if f.name in tfields:
            got = getattr(tcfg, f.name)
            if f.name == "moe" and want is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            elif f.name == "quant":
                assert got.is_exact and want.is_exact
            else:
                assert got == want, f.name
        else:
            assert want == f.default, f.name
    assert tcfg.head_dim == jcfg.head_dim


def test_registry_equals_jax():
    """``ARCHS``, ``ALIASES`` and ``shape_cells`` are JAX's; the SSM,
    hybrid and encoder-decoder archs are listed and refused, each naming
    the ROADMAP item that will port it."""
    import repro.configs as JC
    import repro_torch.configs as TC

    assert TC.ARCHS == JC.ARCHS and TC.ALIASES == JC.ALIASES
    for arch in JC.ALIASES:
        tag = TC.UNPORTED.get(JC.ALIASES[arch])
        if tag is None:
            assert TC.shape_cells(arch) == JC.shape_cells(arch)
            continue
        for fn in (TC.get_config, TC.get_smoke_config, TC.shape_cells):
            with pytest.raises(NotImplementedError, match=rf"\[{tag}\]"):
                fn(arch)
    with pytest.raises(ValueError, match="unknown arch"):
        TC.get_config("gpt-5")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_from_jax(arch):
    """``params_from_jax`` on each ``SMOKE``'s JAX tree (the MoE leaves,
    qk-norm's scales, the stacked layers; ``init_params``' shapes, seeded
    values): every leaf bitwise, f32 and bf16; a misshapen leaf refused; the port's own draw has the same
    shapes."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.models.api import get_model as jget
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models.api import get_model

    cfg = get_smoke_config(arch)
    # JAX's tree and shapes, seeded numpy values (no init compile)
    rng = np.random.RandomState(3)
    params = jax.tree.map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)),
        jax.eval_shape(jget(jsmoke(arch)).init_params,
                       jax.random.PRNGKey(3)))
    for tree in (params, _bf16_tree(params)):
        flat = _flat(jax.tree.map(np.asarray, tree), "p", {})
        got = _tflat(params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                                     "cpu"), "p", {})
        assert set(got) == set(flat)
        for k, v in flat.items():
            bf16 = v.dtype.name == "bfloat16"
            tb = got[k].view(torch.int16 if bf16 else torch.int32)
            np.testing.assert_array_equal(
                tb.numpy(), v.view(np.int16 if bf16 else np.int32), k)
    bad = jax.tree.map(np.asarray, params)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :-1]
    with pytest.raises(ValueError):
        params_from_jax(bad, cfg, "cpu")
    own = _tflat(get_model(cfg).init_params(torch.Generator(), "meta"),
                 "p", {})
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in flat.items()}


def _qcfg_tuple(q):
    if q is None:
        return None
    roles = tuple(None if p is None else (p.m_acc, p.e_acc, p.chunk)
                  for p in (q.fwd, q.bwd, q.grad))
    fmt = tuple(None if f is None else (f.e, f.m)
                for f in (q.repr_fmt, q.out_fmt))
    return roles, fmt, q.fused, q.rounding, q.sr_seed


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_plan_and_gemm_shapes_equal_jax(arch):
    """``plan_for_model`` at full size as JAX builds it, ``mlp_down``
    sized by ``d_ff`` even where the shared expert's fan-in is ``n_shared
    * d_ff_expert`` (ROADMAP Queue 3), and ``dense_gemm_shapes``/
    ``moe_expert_gemm_shapes`` at the train cell's and a decode step's
    token counts."""
    from repro.configs import get_config as jget
    from repro.core.policy import AccumulationPolicy as JPol
    from repro.core.policy import plan_for_model as jplan
    from repro.models import api as JA
    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.models import api as TA

    for seq, batch in ((4096, 256), (1, 8)):
        jcfg = jplan(jget(arch), seq_len=seq, global_batch=batch,
                     policy=JPol(mode="predicted"))
        tcfg = plan_for_model(get_config(arch), seq_len=seq,
                              global_batch=batch,
                              policy=AccumulationPolicy(mode="predicted"))
        for name in ("attn_qkv", "attn_out", "mlp_up", "mlp_down",
                     "lm_head"):
            assert _qcfg_tuple(getattr(tcfg.quant, name)) == \
                _qcfg_tuple(getattr(jcfg.quant, name)), name
        want = [(t, m, k, n, _qcfg_tuple(q)) for t, m, k, n, q in
                JA.dense_gemm_shapes(jcfg, seq_len=seq, global_batch=batch)]
        got = [(t, m, k, n, _qcfg_tuple(q)) for t, m, k, n, q in
               TA.dense_gemm_shapes(tcfg, seq_len=seq, global_batch=batch)]
        assert got == want
        assert TA.moe_expert_gemm_shapes(tcfg, seq_len=seq,
                                         global_batch=batch) == \
            JA.moe_expert_gemm_shapes(jcfg, seq_len=seq, global_batch=batch)


# --------------------------------------------------------------------------
# moe_apply against JAX's, eagerly
# --------------------------------------------------------------------------


def _moe_case(arch, case):
    """(JAX cfg, port cfg, bf16 JAX params, x (2, 16, D) bf16) of a MoE
    smoke config.  ``ties``: the router's columns 1 and 2 copied into 5 and
    6, so every token's logits tie between those experts; ``drops``: a
    capacity factor of 0.5, so experts drop (token, slot) pairs."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import layers as JL
    from repro_torch.configs import get_smoke_config

    jcfg, tcfg = jsmoke(arch), get_smoke_config(arch)
    if case == "drops":
        moe = dataclasses.replace(jcfg.moe, capacity_factor=0.5)
        jcfg = dataclasses.replace(jcfg, moe=moe)
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=0.5))
    p = _bf16_tree(JL.moe_init(jax.random.PRNGKey(1), jcfg))
    if case == "ties":
        r = p["router"]
        p["router"] = r.at[:, 5].set(r[:, 1]).at[:, 6].set(r[:, 2])
    x = jnp.asarray(np.random.RandomState(0).randn(2, 16, jcfg.d_model),
                    jnp.bfloat16)
    return jcfg, tcfg, p, x


def _jax_route(p, x2, cfg):
    """JAX's ``_moe_local`` routing lines at one rank: (gate, idx, slot,
    ok)."""
    from repro.models.layers import dense

    mc = cfg.moe
    t = x2.shape[0]
    e, k = mc.n_experts, mc.top_k
    logits = dense(x2, p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate, idx = jax.lax.top_k(probs, k)
    gate = gate / jnp.sum(gate, axis=-1, keepdims=True)
    flat_e = idx.reshape(-1)
    cap = max(int(mc.capacity_factor * k * t / e), 1)
    onehot = (flat_e[:, None] == jnp.arange(e)[None, :]).astype(jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=1)
    ok = pos < cap
    slot = jnp.where(ok, flat_e * cap + pos, e * cap)
    return gate, idx, slot, ok


@pytest.mark.parametrize("route", ["fused", "einsum"])
@pytest.mark.parametrize("case", ["plain", "ties", "drops"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch, case, route, monkeypatch):
    """``moe_apply`` (the shared expert included) and its routing against
    JAX's on the same bf16 weights and tokens, each route against JAX's
    same route (the two routes do not agree with each other, F1): the
    output bitwise, the experts and kept slots equal, ties broken toward
    the lower index as ``jax.lax.top_k`` breaks them, the gates as the
    module docstring says; the aux within ``AUX_REL``."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    monkeypatch.setenv("REPRO_MOE_FUSED", "1" if route == "fused" else "0")
    jcfg, tcfg, p, x = _moe_case(arch, case)
    tp = jax.tree.map(_t, p)
    jy, jaux = JL.moe_apply(p, x, jcfg, JL.Dist())
    with torch.no_grad():
        ty, taux = TL.moe_apply(tp, _t(x), tcfg)
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    assert abs(float(taux) / float(jaux) - 1) <= AUX_REL

    x2 = x.reshape(-1, jcfg.d_model)
    gate, idx, slot, ok = _jax_route(p, x2, jcfg)
    r = TL._moe_route(tp, _t(x2), tcfg)
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(idx))
    # the softmax's row sums run in another order than XLA's: the float32
    # gates within 2 ulp (measured: 5 of moonshot's 64 differ, by up to
    # 2), the bf16 gates the combine takes equal
    g32 = np.asarray(gate)
    assert np.max(np.abs(r.gate.numpy() - g32)
                  / np.spacing(np.abs(g32))) <= 2.0
    np.testing.assert_array_equal(
        r.gate.to(torch.bfloat16).float().numpy(),
        np.asarray(gate.astype(jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_array_equal(r.slot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(r.ok.numpy(), np.asarray(ok))
    if case == "ties" and tcfg.moe.top_k > 1:
        # each token's two tied experts: the lower index ranks first
        chosen = [set(row[:2]) for row in r.idx.tolist()]
        tied = [c for c in chosen if c in ({1, 5}, {2, 6})]
        assert tied and all(
            row.index(min(c)) < row.index(max(c))
            for row, c in zip(r.idx.tolist(), chosen) if c in tied)
    if case == "drops":
        assert not bool(r.ok.all()) and bool(r.ok.any())


def test_top_k_breaks_ties_as_jax():
    """``layers.top_k`` on rows full of ties: JAX's values and indices."""
    from repro_torch.models.layers import top_k

    rng = np.random.RandomState(2)
    x = rng.randint(0, 4, size=(64, 16)).astype(np.float32)
    for k in (1, 2, 6):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# --------------------------------------------------------------------------
# training against the JAX children
# --------------------------------------------------------------------------


def _port_batch(tcfg, toks):
    from repro_torch.data.pipeline import with_extras

    return with_extras({"tokens": torch.from_numpy(toks)}, tcfg)


# leaves whose gradient a bf16 sum over tokens feeds (XLA:CPU adds in bf16
# one at a time, PyTorch in f32: ROADMAP F4) and the f32 norms' scales
_SUMMED = ("/bq", "/bk", "/bv", "/final_norm")
# MoE (ROADMAP F9): the gates' gradient is a bf16 sum over d_model of the
# products of the combine's cotangent and the expert outputs, which XLA:CPU
# adds in bf16 one at a time; it reaches the router and, through the router
# and the top-k's renormalization, every dx below the top MoE layer, where
# the (1,5,2) rounding of g amplifies it.  The top layer's expert weights
# see none of it (their g is the combine's cotangent times the bf16 gates,
# which are equal); their f32 partials sum in another order (F0), and the
# bf16 gradient flips at times: at least EXPERT_EQ equal elements
# (measured 0.9940).  Every other leaf within MOE_REL relative error norm
# (measured 0.103 at most, the attention weights of layer 0).
EXPERT_EQ = 0.99
MOE_REL = 0.15


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_gradients_match_jax(jax_runs, arch):
    """The first batch's loss (the aux term and the VLM mask in it), the
    aux, and every gradient leaf from the same f32 weights and tokens,
    through the port's bf16 compute copy: qwen3's (qk-norm's scales
    included) and internvl2's bitwise but for the F4 leaves, moonshot's as
    F9 above."""
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import _grads, compute_copy

    _, tcfg = _plans(arch, SEQ, BATCH)
    params = _unflat_t({k: torch.from_numpy(v) for k, v in _tflat(
        _unflat(jax_runs, f"{arch}/p0"), "", {}).items()})
    compute = compute_copy(params)
    loss, m = get_model(tcfg).loss_fn(compute, _port_batch(
        tcfg, _tokens()[0]), tcfg)
    loss.backward()
    loss = float(loss.detach())
    want = float(jax_runs[f"{arch}/loss"])
    print(f"{arch}: loss {loss:.7f} vs JAX {want:.7f}")
    assert abs(loss - want) <= LOSS_TOL
    if tcfg.moe is not None:
        aux = float(jax_runs[f"{arch}/aux"])
        assert abs(float(m["aux"].detach()) / aux - 1) <= AUX_REL
    grads = _flat(_grads(compute, params), f"{arch}/g", {})
    assert set(grads) == {k for k in jax_runs if k.startswith(f"{arch}/g/")}
    moe = tcfg.moe is not None
    for name, got in grads.items():
        want = jax_runs[name]
        eq = float(np.mean(got == want))
        rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                     1e-30))
        print(f"{name}: equal {eq:.4f}, relative error {rel:.3g}")
        if name.endswith(_SUMMED):
            assert rel <= (1e-6 if name.endswith("/final_norm")
                           else GRAD_REL), name
        elif moe and name.endswith("/lm_head"):
            assert eq >= GRAD_EQ, name
        elif moe and "/moe/" in name and not name.endswith("/router"):
            top = float(np.mean(got[-1] == want[-1]))
            print(f"{name}[top]: equal {top:.4f}")
            assert top >= EXPERT_EQ and rel <= MOE_REL, name
        elif moe:
            assert rel <= MOE_REL, name
        else:
            assert eq >= GRAD_EQ, name


def _unflat_t(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.strip("/").split("/")
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return tree


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_track_jax(jax_runs, arch):
    """``STEPS`` AdamW steps from the same weights on the same tokens (and
    patch embeddings): the loss and gradient norm of each within F4's
    bounds of JAX's."""
    from repro_torch.models.api import get_model
    from repro_torch.train import optimizer as O
    from repro_torch.train.loop import TrainConfig, make_train_step

    _, tcfg = _plans(arch, SEQ, BATCH)
    tc = TrainConfig(opt=O.OptConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=STEPS))
    params = _unflat_t({k: torch.from_numpy(v) for k, v in _tflat(
        _unflat(jax_runs, f"{arch}/p0"), "", {}).items()})
    state = {"params": params, "opt": O.init_opt_state(params),
             "scaler": O.init_scaler(tc.scaler)}
    step = make_train_step(get_model(tcfg), tc)
    for s, toks in enumerate(_tokens()):
        state, m = step(state, _port_batch(tcfg, toks))
        dl = abs(float(m["loss"]) - float(jax_runs[f"{arch}/loss{s}"]))
        dg = abs(float(m["grad_norm"])
                 / float(jax_runs[f"{arch}/grad_norm{s}"]) - 1)
        print(f"{arch} step {s}: loss {float(m['loss']):.5f} (JAX "
              f"{float(jax_runs[f'{arch}/loss{s}']):.5f}), grad norm rel "
              f"{dg:.4f}")
        assert dl <= STEP_TOL and dg <= STEP_TOL
        assert float(m["skipped"]) == 0.0
        assert ("aux" in m) == (tcfg.moe is not None)


# --------------------------------------------------------------------------
# serving against the JAX children
# --------------------------------------------------------------------------


def _port_params(arch, tcfg):
    from repro.configs import get_smoke_config as jsmoke
    from repro.models.api import get_model as jget
    from repro_torch.convert import params_from_jax

    jparams = _bf16_tree(jax.jit(jget(jsmoke(arch)).init_params)(
        jax.random.PRNGKey(0)))
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


@pytest.mark.parametrize("arch", tuple(SERVE_CHUNKS))
def test_engine_and_legacy_streams_match_jax(jax_runs, arch):
    """The paged engine's greedy streams (``SERVE_CHUNKS``: moonshot's in
    16-token slabs, each slab's padded width setting its capacity) and the
    legacy ``decode_step``'s greedy tokens: token for token JAX's.  The
    legacy replay's logits are bitwise the port's training forward."""
    from repro_torch.models.api import get_model
    from repro_torch.quant.formats import FPFormat
    from repro_torch.serve import scheduler as TS
    from repro_torch.serve.kvcache import PagedKVConfig

    _, tcfg = _plans(arch, max(PROMPT_LENS) + GEN, len(PROMPT_LENS))
    model = get_model(tcfg)
    params = _port_params(arch, tcfg)
    for chunk in SERVE_CHUNKS[arch]:
        ex = TS.ModelExecutor(model, params, PagedKVConfig.for_model(
            tcfg, n_pages=_n_pages(), page_size=PAGE),
            kv_fmt=FPFormat(5, 2), max_batch=MAX_BATCH, device="cpu")
        eng = TS.ServeEngine(model, params, n_pages=_n_pages(),
                             page_size=PAGE, max_batch=MAX_BATCH,
                             prefill_chunk_tokens=chunk, executor=ex,
                             device="cpu")
        rids = [eng.submit(p, GEN) for p in _prompts()]
        res = eng.run()
        got = np.array([res[r] for r in rids])
        np.testing.assert_array_equal(got, jax_runs[f"{arch}/streams{chunk}"])
    prompt = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (LEGACY_BATCH, LEGACY_PROMPT)).astype(np.int64))
    toks, rows, tok = [], [], None
    with torch.no_grad():
        fwd = model.forward(params, {"tokens": prompt}, tcfg, remat=False)
        state = model.init_decode_state(tcfg, LEGACY_BATCH,
                                        LEGACY_PROMPT + LEGACY_GEN, "cpu")
        for pos in range(LEGACY_PROMPT + LEGACY_GEN - 1):
            inp = prompt[:, pos:pos + 1] if pos < LEGACY_PROMPT else tok
            logits, state = model.decode_step(params, inp, state, pos, tcfg)
            rows.append(logits[:, 0])
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
            if pos >= LEGACY_PROMPT - 1:
                toks.append(tok[:, 0])
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(),
                                  jax_runs[f"{arch}/legacy"])
    assert torch.equal(torch.stack(rows[:LEGACY_PROMPT], 1), fwd)



# --------------------------------------------------------------------------
# qk-norm on every path that projects q and k, the VLM stub, refusals
# --------------------------------------------------------------------------


def test_qk_norm_reaches_every_attention_path():
    """qwen3's q/k norms (scales drawn away from 1, so a path that skipped
    them would show) on the paths the engine comparison does not run:
    ``paged_verify`` bitwise the decode steps it replaces, the dense
    prefill (``attn_prefill_paged`` through K10's plain version) bitwise
    the bucketed one, the legacy static batch bitwise the training
    forward, and the tensor-parallel engine (2 gloo ranks) bitwise the
    single device; with the norms dropped, the forward moves."""
    from repro_torch.launch.serve import run_tp, serve_job
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.api import get_model
    from repro_torch.quant.formats import FPFormat
    from repro_torch.serve.kvcache import PagedKVConfig, init_arena

    _, cfg = _plans("qwen3-8b", 64, 2)
    model = get_model(cfg)
    gen = torch.Generator().manual_seed(3)
    params = model.init_params(gen, "cpu")
    attn = params["layers"]["attn"]
    for name in ("q_norm", "k_norm"):
        attn[name] = 0.5 + torch.rand(attn[name].shape, generator=gen)
    fmt = FPFormat(5, 2)
    toks = torch.randint(0, 256, (2, 20), generator=gen)
    with torch.no_grad():
        fwd = model.forward(params, {"tokens": toks}, cfg, remat=False)
        state = model.init_decode_state(cfg, 2, 24, "cpu")
        rows = [model.decode_step(params, toks[:, i:i + 1], state, i,
                                  cfg)[0] for i in range(20)]
        assert torch.equal(torch.cat(rows, 1), fwd)
        plain = dataclasses.replace(cfg, qk_norm=False)
        moved = model.forward({**params, "layers": {
            **params["layers"], "attn": {k: v for k, v in attn.items()
                                         if not k.endswith("_norm")}}},
            {"tokens": toks}, plain, remat=False)
        assert not torch.equal(moved, fwd)

        pc = PagedKVConfig.for_model(cfg, n_pages=8, page_size=PAGE,
                                     kv_fmt=fmt)
        acc = (8, 23)
        x = L.rms_norm(lm._embed(params, toks[:1]), params["layers"]["ln1"][0],
                       cfg.norm_eps)
        lp0 = lm._layer(params["layers"], 0)["attn"]
        arenas = [{k: v[0] for k, v in init_arena(pc, "cpu").items()}
                  for _ in range(2)]
        pages = torch.tensor([1, 2], dtype=torch.int32)
        y_dense = L.attn_prefill_paged(
            lp0, x, arenas[0], pages,
            torch.arange(20, dtype=torch.int32)[None], cfg, kv_fmt=fmt,
            acc=acc)
        row = torch.tensor([1, 2, 0, 0], dtype=torch.int32)
        y_bucket = L.attn_prefill_bucketed(lp0, x, arenas[1], row, pages, 0,
                                           20, cfg, kv_fmt=fmt, acc=acc)
        assert torch.equal(y_dense, y_bucket)
        for k in arenas[0]:
            assert torch.equal(arenas[0][k], arenas[1][k])

        # verify: one pass over 3 tokens a row, bitwise 3 decode steps
        kv = [init_arena(pc, "cpu") for _ in range(2)]
        table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        first = torch.tensor([5, 9], dtype=torch.int32)
        for a in kv:    # the same history in both arenas
            for t in range(int(first.max())):
                pos = torch.minimum(torch.full_like(first, t), first - 1)
                lm.paged_decode(params, toks[:, t:t + 1], a, table, pos,
                                pos + 1, cfg, kv_fmt=fmt, acc=acc)
        cand = toks[:, 10:13]
        ver = lm.paged_verify(params, cand, kv[0], table, first, first + 1,
                              cfg, kv_fmt=fmt, acc=acc)
        for j in range(3):
            dec = lm.paged_decode(params, cand[:, j:j + 1], kv[1], table,
                                  first + j, first + j + 1, cfg,
                                  kv_fmt=fmt, acc=acc)
            assert torch.equal(ver[:, j], dec[:, 0])

    job = dict(cfg=cfg, params=_bf16_params(params), n_pages=12, page_size=PAGE, max_batch=2,
        prefill_chunk=16, prompts=[toks[0].tolist(), toks[1, :13].tolist()],
        gen=4)
    one = serve_job(job, device="cpu")
    ranks = [r["runs"][0] for r in run_tp([job], 2, "cpu", timeout_s=300)]
    assert all(r["tokens"] == one["tokens"] for r in ranks)
    assert ranks[0]["logit_hashes"] == one["logit_hashes"]


def _bf16_params(tree):
    if isinstance(tree, dict):
        return {k: _bf16_params(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16) if tree.dtype == torch.float32 else tree


def test_with_extras_patch_embeds_match_jax():
    """``with_extras``' patch embeddings against JAX's on the VLM smoke
    config at key 0 (the trainer's) and key 1 (the legacy launcher's):
    within 3 float32 ulp (measured: 0.7-0.9% of the draws differ, by at
    most 2 ulp), every bf16 rounding equal; nothing added for the other
    families; the encoder-decoder stub refused."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.data.pipeline import with_extras as jextras
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import prng
    from repro_torch.data.pipeline import with_extras

    cfg = get_smoke_config("internvl2-2b")
    toks = np.zeros((4, SEQ), np.int32)
    for seed in (0, 1):
        want = np.asarray(jextras({"tokens": jnp.asarray(toks)},
                                  jsmoke("internvl2-2b"),
                                  key=jax.random.PRNGKey(seed))
                          ["patch_embeds"])
        got = with_extras({"tokens": torch.from_numpy(toks)}, cfg,
                          key=prng.prng_key(seed))["patch_embeds"]
        assert got.shape == want.shape == (4, cfg.vision_tokens, cfg.d_model)
        ulp = np.abs(got.numpy().view(np.int32).astype(np.int64)
                     - want.view(np.int32).astype(np.int64))
        print(f"key {seed}: {np.mean(ulp > 0):.4f} differ, max {ulp.max()} "
              "ulp")
        assert ulp.max() <= 3
        np.testing.assert_array_equal(
            got.to(torch.bfloat16).float().numpy(),
            np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(
                jnp.float32)))
    batch = {"tokens": torch.from_numpy(toks)}
    assert with_extras(batch, get_smoke_config("qwen3-8b")) == batch
    with pytest.raises(NotImplementedError, match=r"\[families-encdec\]"):
        with_extras(batch, dataclasses.replace(cfg, family="encdec"))


def test_vlm_loss_ignores_the_image_positions():
    """internvl2's loss scores no position inside the image stub: changing
    the tokens there changes nothing; changing one after it does."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import with_extras
    from repro_torch.models.api import get_model

    cfg = get_smoke_config("internvl2-2b")
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, 256, (2, SEQ), generator=torch.Generator())
    batch = with_extras({"tokens": toks}, cfg)
    vt = cfg.vision_tokens
    with torch.no_grad():
        base = model.loss_fn(params, batch, cfg, remat=False)[0]
        inside = toks.clone()
        inside[:, :vt] = (inside[:, :vt] + 1) % 256
        same = model.loss_fn(params, {**batch, "tokens": inside}, cfg,
                             remat=False)[0]
        after = toks.clone()
        after[:, vt + 1] = (after[:, vt + 1] + 1) % 256
        moved = model.loss_fn(params, {**batch, "tokens": after}, cfg,
                              remat=False)[0]
    assert torch.equal(base, same) and not torch.equal(base, moved)


def test_refusals_name_their_roadmap_items():
    """MoE under ``--mesh`` and ``--serve-mesh`` (and ``moe_apply`` under
    any mesh) raise naming [moe-ep], before any rank starts; the SSM,
    hybrid and encoder-decoder families raise naming their items, in the
    model, the legacy path and the launchers."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import Dist
    from repro_torch.launch import serve as S
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    with pytest.raises(NotImplementedError, match=r"\[moe-ep\]"):
        TR.main(["--arch", "moonshot-v1-16b-a3b", "--smoke", "--device",
                 "cpu", "--steps", "1", "--mesh", "2x1"])
    with pytest.raises(NotImplementedError, match=r"\[moe-ep\]"):
        S.main(["--arch", "moonshot-v1-16b-a3b", "--smoke", "--device",
                "cpu", "--serve-mesh", "2"])
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    p = lm.init_params(cfg, torch.Generator(), "meta")
    dist = Dist(mesh=Mesh({"data": 2, "model": 1}, 0))
    with pytest.raises(NotImplementedError, match=r"\[moe-ep\]"):
        L.moe_apply(lm._layer(p["layers"], 0)["moe"],
                    torch.zeros((1, 2, cfg.d_model)), cfg, dist)
    for fam, tag in (("ssm", "families-ssm"), ("hybrid", "families-ssm"),
                     ("encdec", "families-encdec")):
        bad = dataclasses.replace(get_smoke_config("qwen3-8b"), family=fam)
        for fn in (lambda: lm.init_params(bad, torch.Generator(), "cpu"),
                   lambda: lm.init_decode_state(bad, 1, 4, "cpu"),
                   lambda: lm.paged_decode(None, None, None, None, None,
                                           None, bad, kv_fmt=None,
                                           acc=None)):
            with pytest.raises(NotImplementedError, match=rf"\[{tag}\]"):
                fn()
    for arch, tag in (("mamba2-1.3b", "families-ssm"),
                      ("zamba2-7b", "families-ssm"),
                      ("seamless-m4t-large-v2", "families-encdec")):
        for launcher in (S.main, TR.main):
            with pytest.raises(NotImplementedError, match=rf"\[{tag}\]"):
                launcher(["--arch", arch, "--smoke", "--device", "cpu"])
