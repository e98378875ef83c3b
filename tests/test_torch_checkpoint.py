"""Port vs JAX package: checkpoints, restarts and serving from a checkpoint.

* ``train.checkpoint`` writes the JAX package's layout, so a checkpoint of
  either package restores in the other: the array keys are the same path
  strings, and the restored values are bitwise the saved ones (int8 codes
  copied verbatim, floats stored as they are).
* The launcher's crash, the supervisor's restart and the resume give the
  uninterrupted run's losses bitwise (the port's step is deterministic on
  the CPU), with the controller's precision schedule carried across.
* Serving from a checkpoint applies its recorded precision schedule, as
  ``tests/test_serve.py::test_serve_restore_honors_precision_schedule``
  holds the JAX server to it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.api import get_model as jax_get_model
from repro.quant import qtensor as JQ
from repro.quant.formats import FPFormat as JF
from repro.train import checkpoint as JC
from repro.train.loop import TrainConfig as JTC, init_train_state as jax_init
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import AccumulationPolicy, plan_for_model
from repro_torch.models.api import get_model
from repro_torch.quant import FP8_152, FPFormat, QTensor, pack_tree, unpack_tree
from repro_torch.train.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.loop import TrainConfig, init_train_state
from tests.conftest import REPO, SRC


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((3, 4), generator=gen),
                   "b": torch.randn((4,), generator=gen).to(torch.bfloat16),
                   "layers": [torch.randn((2,), generator=gen),
                              torch.arange(5, dtype=torch.int32)]},
        "res": QTensor.pack(torch.randn((6, 5), generator=gen), FP8_152),
        "ef": QTensor.pack_linear(torch.randn((7,), generator=gen)),
        "step": torch.tensor(11, dtype=torch.int32),
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    if isinstance(tree, QTensor):
        out = {f"{prefix}payload": tree.payload}
        if tree.scale is not None:
            out[f"{prefix}scale"] = tree.scale
        return out
    return {prefix[:-1]: tree}


def _assert_bitwise(got, want):
    a, b = _flat(got), _flat(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def test_round_trip_bitwise(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 7, state, meta={"data": {"step": 3}},
                    precision_schedule={"mlp_up:fwd": 9})
    like = _state(seed=1)
    got, meta = restore_checkpoint(str(tmp_path), 7, like)
    _assert_bitwise(got, state)
    assert isinstance(got["res"], QTensor) and got["res"].fmt == FP8_152
    assert torch.equal(got["res"].unpack(), state["res"].unpack())
    assert meta["step"] == 7 and meta["data"] == {"step": 3}
    assert meta["precision_schedule"] == {"mlp_up:fwd": 9}
    assert meta["qtensors"] == {"res": {"e": 5, "m": 2}, "ef": {"linear": True}}
    names = set(np.load(tmp_path / "step_00000007" / "arrays.npz").files)
    assert names == {"params/w", "params/b", "params/layers/0",
                     "params/layers/1", "res/payload", "ef/payload",
                     "ef/scale", "step"}


def test_packed_tree_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(5)
    tree = {"a": torch.randn((4, 8), generator=gen),
            "b": [torch.randn((3,), generator=gen)]}
    packed = pack_tree(tree, FP8_152)
    save_checkpoint(str(tmp_path), 1, {"res": packed})
    got, _ = restore_checkpoint(str(tmp_path), 1,
                                {"res": pack_tree(tree, FP8_152)})
    _assert_bitwise(got["res"], packed)
    for a, b in zip(_flat(unpack_tree(got["res"])).values(),
                    _flat(unpack_tree(packed)).values()):
        assert torch.equal(a, b)


def test_drifted_format_refused(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 2, state)
    like = dict(_state(), res=QTensor.pack(torch.zeros((6, 5)),
                                           FPFormat(4, 3)))
    with pytest.raises(ValueError, match="not portable across formats"):
        restore_checkpoint(str(tmp_path), 2, like)
    # the JAX package refuses a port checkpoint under a drifted format too
    jlike = {"res": JQ.QTensor.pack(jax.numpy.zeros((6, 5)), JF(4, 3))}
    with pytest.raises(ValueError, match="not portable across formats"):
        JC.restore_checkpoint(str(tmp_path), 2, jlike)


def test_latest_step_ignores_tmp(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    save_checkpoint(str(tmp_path), 4, _state())
    save_checkpoint(str(tmp_path), 10, _state())
    os.makedirs(tmp_path / "step_00000020.tmp")   # a write cut short
    assert latest_step(str(tmp_path)) == 10
    # a new write replaces a stale .tmp of the same step
    save_checkpoint(str(tmp_path), 20, _state())
    assert latest_step(str(tmp_path)) == 20
    assert not (tmp_path / "step_00000020.tmp").exists()


def _jax_state():
    cfg = jax_smoke_config("qwen2-1.5b")
    return cfg, jax_init(jax_get_model(cfg), jax.random.PRNGKey(0), JTC())


def _port_state():
    cfg = get_smoke_config("qwen2-1.5b")
    gen = torch.Generator().manual_seed(1)
    return cfg, init_train_state(get_model(cfg), gen, "cpu", TrainConfig())


def test_jax_checkpoint_restores_in_port(tmp_path):
    jcfg, jstate = _jax_state()
    JC.save_checkpoint(str(tmp_path), 5, jstate, meta={"data": {"step": 5}},
                       precision_schedule={"attn_out:grad": 7})
    cfg, like = _port_state()
    got, meta = restore_checkpoint(str(tmp_path), 5, like)
    want = params_from_jax(jax.tree.map(np.asarray, jstate["params"]), cfg,
                           "cpu")
    _assert_bitwise(got["params"], want)
    for k in ("m", "v"):
        assert all(not t.any() for t in _flat(got["opt"][k]).values())
    assert got["opt"]["step"].dtype == torch.int32
    assert float(got["scaler"]["scale"]) == float(jstate["scaler"]["scale"])
    assert meta["precision_schedule"] == {"attn_out:grad": 7}


def test_port_checkpoint_restores_in_jax(tmp_path):
    _, jstate = _jax_state()
    cfg, state = _port_state()
    save_checkpoint(str(tmp_path), 3, state, meta={"data": {"step": 3}})
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jstate)
    got, meta = JC.restore_checkpoint(str(tmp_path), 3, like)
    want = _flat(state)
    jflat = {JC._path_str(p): np.asarray(v) for p, v in
             jax.tree_util.tree_flatten_with_path(got)[0]}
    assert jflat.keys() == want.keys()
    for k, v in jflat.items():
        np.testing.assert_array_equal(v, want[k].numpy(), err_msg=k)
    assert meta["step"] == 3


# ------------------------- crash, supervise, resume -------------------------

_TRAIN = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
          "--steps", "4", "--global-batch", "4", "--seq-len", "32",
          "--policy", "perturbed", "--pp", "-4", "--chunk", "4",
          "--telemetry-cadence", "1", "--log-every", "1", "--device", "cpu"]


def _run(cmd, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=REPO)


def _losses(path):
    return [(r["step"], r["loss"], r["grad_norm"])
            for r in map(json.loads, path.read_text().splitlines())]


def test_crash_supervise_resume_matches_uninterrupted(tmp_path):
    """The trainer dies before step 3 (fault injection); the supervisor
    restarts it; the run resumes from the step-2 checkpoint, under the
    precision schedule the controller had reached, and its losses are the
    uninterrupted run's, bitwise."""
    plain = tmp_path / "plain.jsonl"
    out = _run([*_TRAIN, "--metrics-out", str(plain), "--telemetry-log",
                str(tmp_path / "t0.jsonl")])
    assert out.returncode == 0, out.stdout + out.stderr
    ckpt, resumed = tmp_path / "ckpt", tmp_path / "resumed.jsonl"
    out = _run([sys.executable, "-m", "repro_torch.launch.supervisor",
                "--max-restarts", "2", "--backoff-s", "0.1", "--", *_TRAIN,
                "--ckpt-dir", str(ckpt), "--ckpt-every", "2",
                "--crash-at-step", "3", "--metrics-out", str(resumed)])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "FAULT INJECTION: dying at step 3" in out.stdout
    assert "restart 1/2" in out.stdout
    assert "resumed from step 2" in out.stdout
    assert "restored precision schedule" in out.stdout
    want, got = _losses(plain), _losses(resumed)
    assert [s for s, *_ in got] == [1, 2, 3, 3, 4]
    assert got[:3] == want[:3] and got[3:] == want[2:]
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000004",
                                        "telemetry.jsonl"]
    meta = json.loads((ckpt / "step_00000002" / "meta.json").read_text())
    assert meta["precision_schedule"] and meta["data"]["step"] == 2
    assert set(meta["telemetry_streaks"]) >= set(meta["precision_schedule"])


def test_supervisor_gives_up_on_crash_loop():
    out = _run([sys.executable, "-m", "repro_torch.launch.supervisor",
                "--max-restarts", "1", "--backoff-s", "0.1", "--", *_TRAIN,
                "--crash-at-step", "0"])
    assert out.returncode == 42
    assert "giving up" in out.stdout


# ------------------------------ serve restore -------------------------------


def test_serve_restore_honors_precision_schedule(tmp_path):
    """A JAX-written checkpoint with a recorded schedule: the port's server
    takes its params (bitwise ``params_from_jax``) and the schedule."""
    from repro.core.policy import (
        AccumulationPolicy as JAP,
        plan_for_model as jax_plan,
    )
    from repro_torch.launch.serve import _restore_params

    jcfg = jax_plan(jax_smoke_config("qwen2-1.5b"), seq_len=32,
                    global_batch=2, policy=JAP(mode="predicted", chunk=64))
    jparams = jax_get_model(jcfg).init_params(jax.random.PRNGKey(0))
    JC.save_checkpoint(str(tmp_path), 3, {"params": jparams},
                       precision_schedule={"mlp_up:fwd": 9})
    policy = AccumulationPolicy(mode="predicted", chunk=64)
    cfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=32,
                         global_batch=2, policy=policy)
    gen = torch.Generator().manual_seed(3)
    params = get_model(cfg).init_params(gen, "cpu")
    cfg2, params2, schedule = _restore_params(
        str(tmp_path), cfg, policy, params, seq_len=32, global_batch=2)
    assert schedule == {"mlp_up:fwd": 9}
    assert cfg2.quant.mlp_up.fwd.m_acc == 9
    # un-scheduled GEMMs keep the solver plan
    assert cfg2.quant.attn_qkv.fwd.m_acc == cfg.quant.attn_qkv.fwd.m_acc
    _assert_bitwise(params2, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))


def test_schedule_restores_into_a_quantize_outputs_plan(tmp_path):
    """A checkpoint's meta records the precision schedule, never the
    ``QDotConfig``s: one written before ``QDotConfig.pack_residuals`` and
    ``AccumulationPolicy.quantize_outputs`` existed restores into a plan
    re-made under a ``quantize_outputs`` policy (as the JAX package
    re-plans), with the schedule's widths, the policy's ``out_fmt`` and
    the default ``pack_residuals``."""
    from repro.core.policy import (
        AccumulationPolicy as JAP,
        plan_for_model as jax_plan,
    )
    from repro_torch.launch.serve import _restore_params

    jcfg = jax_plan(jax_smoke_config("qwen2-1.5b"), seq_len=32,
                    global_batch=2, policy=JAP(mode="predicted", chunk=64))
    jparams = jax_get_model(jcfg).init_params(jax.random.PRNGKey(0))
    JC.save_checkpoint(str(tmp_path), 3, {"params": jparams},
                       precision_schedule={"mlp_down:bwd": 8})
    policy = AccumulationPolicy(mode="predicted", chunk=64,
                                quantize_outputs=True)
    cfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=32,
                         global_batch=2, policy=policy)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(3),
                                        "cpu")
    cfg2, _, schedule = _restore_params(
        str(tmp_path), cfg, policy, params, seq_len=32, global_batch=2)
    assert schedule == {"mlp_down:bwd": 8}
    q = cfg2.quant.mlp_down
    assert q.bwd.m_acc == 8 and q.pack_residuals and q.packs
    assert q.out_fmt == cfg.quant.mlp_down.out_fmt is not None
    assert cfg2.quant.attn_qkv == cfg.quant.attn_qkv


def test_serve_main_from_training_checkpoint(tmp_path):
    """The launcher end to end: a training run's last checkpoint served
    with ``--ckpt-dir``; the plan carries the schedule and the served
    params are the checkpoint's."""
    from repro_torch.launch import serve as LS

    ckpt = tmp_path / "ckpt"
    out = _run([*_TRAIN, "--steps", "2", "--ckpt-dir", str(ckpt),
                "--ckpt-every", "2"])
    assert out.returncode == 0, out.stdout + out.stderr
    meta = json.loads((ckpt / "step_00000002" / "meta.json").read_text())
    schedule = meta["precision_schedule"]
    assert schedule
    res = LS.main(["--smoke", "--policy", "predicted", "--chunk", "4",
                   "--device", "cpu", "--prompt-lens", "16,24", "--gen", "4",
                   "--ckpt-dir", str(ckpt)])
    assert res["schedule"] == schedule
    for key, m in schedule.items():
        assert res["plan"][key] == m
    assert all(len(v) == 4 for v in res["results"].values())
