"""Port vs JAX package: the legacy static batch (``lm.prefill``,
``lm.init_decode_state``, ``lm.decode_step`` over a dense bf16 cache, and
``launch.serve._legacy_main``) on the smoke qwen2-1.5b under the predicted
plan, on the same bf16 weights and ``SyntheticLM`` prompts.

The JAX side runs in a child process with
``--xla_allow_excess_precision=false`` (ROADMAP F2): its launcher jits the
decode step, and by default XLA's jit drops bf16 roundings the source
makes.  The attention here is ``_gqa_attend``'s f32 einsum over the bf16
cache, no kernel, whose summation order may differ from XLA's (ROADMAP
F0).  So the port's legacy logits are held bitwise to the port's own
training forward, and against JAX with the training forward's tolerance
(``tests/test_torch_train.py``: the loss within 1e-5) on the distance the
training forward itself keeps from JAX on these tokens; the generated
tokens are held equal.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, PROMPT, GEN, CHUNK = 4, 32, 16, 16
ARGV = ["--smoke", "--policy", "predicted", "--chunk", str(CHUNK),
        "--batch", str(BATCH), "--prompt-len", str(PROMPT), "--gen", str(GEN)]
# the training forward's bound on its loss against JAX's
# (tests/test_torch_train.py::test_train_step_gradients_match_jax)
TRAIN_LOSS_TOL = 1e-5
# the serving slice's logit tolerance (tests/test_torch_serve.py): a
# greedy stream may leave JAX's only where JAX's top-2 margin is within it
LOGIT_TOL = 0.0625


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: beside the other pytest workers a full-width
    OpenMP pool thrashes the host's cores (ROADMAP P4)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_setup():
    from repro.configs import get_smoke_config
    from repro.core.policy import AccumulationPolicy, plan_for_model
    from repro.launch.serve import parse_args
    from repro.models.api import get_model

    args = parse_args(ARGV)
    cfg = plan_for_model(get_smoke_config(args.arch),
                         seq_len=PROMPT + GEN, global_batch=BATCH,
                         policy=AccumulationPolicy(mode="predicted",
                                                   chunk=CHUNK))
    model = get_model(cfg)
    # jitted: the same draws as the eager init, in a third of its time
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
        jax.jit(model.init_params)(jax.random.PRNGKey(0)))
    return args, cfg, model, params


def legacy_child(out_path: str) -> None:
    """The JAX side: the params, the prompts, the prefill's logits, every
    decode step's logits of the launcher's loop, and ``_legacy_main``'s
    tokens."""
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch.serve import _legacy_main
    from repro.models.layers import Dist

    args, cfg, model, params = _jax_setup()
    out = {f"p/{k}": v for k, v in _flat(jax.tree.map(np.asarray, params))}
    batch = next(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=PROMPT, global_batch=BATCH,
                                        seed=args.seed)))
    out["prompt"] = np.asarray(batch["tokens"])
    out["prefill"] = np.asarray(jax.jit(lambda p, b: model.prefill(
        p, b, cfg, Dist()))(params, batch).astype(jnp.float32))
    step = jax.jit(lambda p, t, s, pos: model.decode_step(
        p, t, s, pos, cfg, Dist()))
    state = model.init_decode_state(cfg, BATCH, PROMPT + GEN)
    rows = []
    tok = None
    for pos in range(PROMPT + GEN - 1):
        inp = batch["tokens"][:, pos:pos + 1] if pos < PROMPT else tok
        logits, state = step(params, inp, state, jnp.int32(pos))
        rows.append(np.asarray(logits[:, 0].astype(jnp.float32)))
        tok = jnp.argmax(logits[:, 0], axis=-1)[:, None]
    out["decode"] = np.stack(rows)
    out["loss"] = np.asarray(jax.jit(lambda p, b: model.loss_fn(
        p, b, cfg, Dist())[0])(params, batch))
    out["gen"] = np.asarray(_legacy_main(args, cfg, model, params)["gen"])
    np.savez(out_path, **out)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _unflat(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return tree


@pytest.fixture(scope="module")
def legacy(tmp_path_factory):
    import ml_dtypes

    path = str(tmp_path_factory.mktemp("jax_legacy") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    child = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_legacy as t; t.legacy_child({path!r})"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert child.returncode == 0, child.stdout + child.stderr
    flat = dict(np.load(path, allow_pickle=True))
    # np.savez stores bf16 as raw void bytes: view them back
    for k, v in flat.items():
        if v.dtype.kind == "V":
            flat[k] = v.view(ml_dtypes.bfloat16)
    return flat


def _port(legacy):
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import serve as S

    args = S.parse_args(ARGV + ["--device", "cpu", "--legacy"])
    cfg, model, _, _, device = S.build_params(args)
    params = params_from_jax(_unflat(legacy, "p"), cfg, "cpu")
    return args, cfg, model, params, device


def _ce(rows: np.ndarray, tgt: np.ndarray) -> float:
    """Mean next-token cross entropy (float64) of logits ``rows`` (..., V)
    at targets ``tgt`` (...)."""
    x = rows.astype(np.float64)
    m = x.max(-1, keepdims=True)
    lse = np.log(np.exp(x - m).sum(-1)) + m[..., 0]
    gold = np.take_along_axis(x, tgt[..., None], -1)[..., 0]
    return float(np.mean(lse - gold))


def test_legacy_logits_are_the_training_forward_and_track_jax(legacy):
    """The prompt replay through ``decode_step`` (one position a step over
    the bf16 cache) and ``prefill``'s last-position logits are bitwise the
    port's training forward (``lm.forward``) on the same tokens, so the
    legacy path matches JAX exactly as the training forward does: its
    cross entropy over the prompt moves from JAX's replay by the training
    forward's own distance from JAX's (``loss_fn``, jitted in the child),
    within the training forward's bound (``tests/test_torch_train.py``,
    1e-5).  ``prefill``'s greedy token is JAX's ``prefill``'s in every row
    whose top-2 margin in JAX's logits exceeds the serving slice's logit
    tolerance (a near-tie may go either way, ROADMAP F0)."""
    args, cfg, model, params, dev = _port(legacy)
    prompt = torch.from_numpy(legacy["prompt"].astype(np.int64))
    with torch.no_grad():
        fwd = model.forward(params, {"tokens": prompt}, cfg,
                            remat=False).float().numpy()
        loss, _ = model.loss_fn(params, {"tokens": prompt}, cfg, remat=False)
        pre = model.prefill(params, {"tokens": prompt}, cfg).float().numpy()
        state = model.init_decode_state(cfg, BATCH, PROMPT + GEN, dev)
        pos = torch.arange(PROMPT + GEN, dtype=torch.int32)
        rows, tok = [], None
        for i in range(PROMPT + GEN - 1):
            inp = prompt[:, i:i + 1] if i < PROMPT else tok
            logits, state = model.decode_step(params, inp, state, pos[i], cfg)
            rows.append(logits[:, 0].float().numpy())
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
    replay = np.stack(rows[:PROMPT], axis=1)               # (B, S, V)
    np.testing.assert_array_equal(replay, fwd)
    np.testing.assert_array_equal(pre, fwd[:, -1])
    tgt = legacy["prompt"][:, 1:]
    d_replay = _ce(replay[:, :-1], tgt) - _ce(
        np.swapaxes(legacy["decode"][:PROMPT - 1], 0, 1), tgt)
    d_forward = float(loss) - float(legacy["loss"])
    print(f"prompt CE: port - JAX {d_replay:.3g} through decode_step, "
          f"{d_forward:.3g} through the training forward")
    assert abs(d_replay - d_forward) <= TRAIN_LOSS_TOL
    want = legacy["prefill"]
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > LOGIT_TOL
    assert clear.any()
    np.testing.assert_array_equal(pre.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def test_legacy_main_tokens_match_jax(legacy):
    """``_legacy_main``'s (batch, gen) tokens against JAX's
    ``_legacy_main``'s on the same weights and ``SyntheticLM`` prompts, row
    by row: equal until a row leaves JAX's stream, which may happen only
    at a near-tie, a top-2 margin of JAX's logits within the serving
    slice's logit tolerance (``tests/test_torch_serve.py``, ROADMAP F0).
    Measured: rows 0, 1 and 3 equal; row 2 leaves at token 3, where JAX's
    margin is 0.03125."""
    from repro_torch.launch import serve as S

    args, cfg, model, params, dev = _port(legacy)
    out = S._legacy_main(args, cfg, model, params, dev)
    np.testing.assert_array_equal(out["prompt"].numpy(), legacy["prompt"])
    got, want = out["gen"].numpy(), legacy["gen"]
    assert got.shape == want.shape == (BATCH, GEN) and out["tok_per_s"] > 0
    # JAX's launcher loop recorded every step's logits: step PROMPT - 1 + j
    # gave token j
    left = {}
    for r in range(BATCH):
        diff = np.flatnonzero(got[r] != want[r])
        if diff.size == 0:
            continue
        j = int(diff[0])
        top2 = np.sort(legacy["decode"][PROMPT - 1 + j, r].astype(
            np.float32))[-2:]
        assert top2[1] - top2[0] <= LOGIT_TOL, (
            f"row {r} left JAX's stream at token {j} with a top-2 margin "
            f"{top2[1] - top2[0]}")
        left[r] = j
    print(f"rows equal to JAX's: {BATCH - len(left)}/{BATCH}; left at a "
          f"near-tie: {left or 'none'}")
    assert len(left) < BATCH


def test_decode_step_writes_the_cache_in_place_and_refuses_families():
    """``decode_step`` writes K/V at ``pos`` into the state it was given and
    nowhere else; a device-tensor position and an int agree; the other
    families are not ported yet."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.models.api import get_model

    cfg = get_smoke_config("qwen2-1.5b")
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.tensor([[3], [5]])
    with torch.no_grad():
        s1 = lm.init_decode_state(cfg, 2, 8, "cpu")
        l1, out = lm.decode_step(params, toks, s1, 3, cfg)
        s2 = lm.init_decode_state(cfg, 2, 8, "cpu")
        l2, _ = lm.decode_step(params, toks, s2, torch.tensor(3), cfg)
    assert out is s1 and torch.equal(l1, l2) and l1.shape == (2, 1,
                                                               cfg.vocab_size)
    for name in ("k", "v"):
        t = s1["layers"][name]
        assert t.shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim)
        assert bool((t[:, :, 3] != 0).any())
        assert not bool(t[:, :, :3].any()) and not bool(t[:, :, 4:].any())
        assert torch.equal(t, s2["layers"][name])
    ssm = dataclasses.replace(cfg, family="ssm")
    with pytest.raises(NotImplementedError, match=r"\[families\]"):
        lm.init_decode_state(ssm, 2, 8, "cpu")
    with pytest.raises(NotImplementedError, match=r"\[families\]"):
        lm.decode_step(params, toks, s1, 3, ssm)
    arena = lm.init_paged_state(cfg, n_pages=3, page_size=4, device="cpu")
    assert arena["k"].shape[:3] == (cfg.n_layers, 3, cfg.n_kv_heads)
