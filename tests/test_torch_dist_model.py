"""Port: the rest of training over a mesh -- stochastic rounding under a
mesh (the SR keys' row, column and K origins), the model axis (``--mesh
DxM`` with M > 1) and the unfused oracle under a row split -- against the
JAX package's kernels and the port's single device.

The origins' plain versions are held against JAX's whole SR calls in
interpret mode; the mesh runs against the port's single-device run on the
same arguments (itself held against JAX by ``tests/test_torch_train.py``
and ``tests/test_torch_sr.py``; JAX's distributed tests do not run on this
jax, ROADMAP F1).  Ranks are processes of a gloo group, one torch thread
each.  The smoke config (2 layers, d 64, 4/2 heads), 8 sequences of 16
tokens, 3 steps.

Tolerances:

* G's, E's and K8's plain versions on a block of rows (``row0``) or of
  columns (``col0``, ``n_cols``) under SR: bitwise the same block of
  JAX's whole ``qmatmul_fused(..., rounding="sr")`` on lattice operands
  (every f32 order of a chunk's partial is exact), and bitwise the port's
  whole call's block on random ones.
* B's and K9's plain versions on K-slices (``k_offset``, ``k_total``)
  under SR: dx's columns and dw's rows bitwise JAX's whole SR
  ``qmatmul_bwd_pair`` on lattice operands and the port's whole call on
  random ones; K9's dx and dw bitwise B's.
* ``--mesh 2x1`` and ``2x2`` under ``--rounding sr``, ``1x2`` and ``2x2``
  under the predicted plan, ``2x2`` under ``--policy exact`` and ``2x1``
  under the oracle (``plan=oracle_plan``) with an in-graph tick every
  step: every rank's records (losses, grad norms, lrs, skip flags, loss
  scales) and schedule bitwise the single device's, and its blocks of the
  final params and both moments bitwise the same blocks of the single
  device's state; the oracle tick's verdicts equal.
* A checkpoint written on ``2x1`` and restored onto ``1x2``: the
  uninterrupted run's step-3 record, bitwise.
* A model axis that does not divide the KV heads raises.
"""

from __future__ import annotations

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bwd_pair import qmatmul_bwd_pair as jax_pair
from repro.kernels.fused import qmatmul_fused as jax_qmatmul
from repro.quant.formats import FP8_152 as JFP8
from repro_torch import dist as D
from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
from repro_torch.kernels.fused import qmatmul_fused
from repro_torch.launch import train as T
from repro_torch.quant.formats import FP8_152
from test_torch_dist_train import (BASE, _check_state, _numpy_state,
                                   _records, _threads)
from test_torch_train import _lattice

SPAWN_TIMEOUT_S = 300
SR_SEED = 7
ACC = (6, 5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _operands(rng, shape, lattice, scale=1.0):
    if lattice:
        return _lattice(rng, shape)
    return (rng.randn(*shape) * scale).astype(np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


# --------------------------------------------------------------------------
# the SR origins' plain versions against JAX's whole calls
# --------------------------------------------------------------------------

M, K, N, CHUNK = 48, 96, 80, 16
BLOCKS = {"rows": [(0, 16, 0, N), (16, 48, 0, N)],
          "cols": [(0, M, 0, 40), (0, M, 40, 80)],
          "both": [(24, 48, 40, 80), (0, 24, 16, 56)]}


@pytest.mark.parametrize("lattice", [True, False], ids=["lattice", "random"])
@pytest.mark.parametrize("kind", ["G", "E", "K8"])
def test_fused_sr_origins_match_whole_call(kind, lattice):
    """G, E and K8 on blocks of the output (a rank's rows under a row
    split, its columns under the model axis) with ``row0``, ``col0`` and
    ``n_cols``: bitwise the whole SR call's blocks, JAX's on lattice
    operands; without the origin a block draws other bits."""
    rng = np.random.RandomState(3 + lattice)
    a = _operands(rng, (M, K), lattice)
    b = _operands(rng, (K, N), lattice, 1 / np.sqrt(K))
    bt = _t(b).to(torch.bfloat16)
    kw = dict(e_acc=ACC[0], m_acc=ACC[1], block_k=CHUNK, rounding="sr",
              sr_seed=SR_SEED, repr_fmt=FP8_152)
    extra = {"G": {}, "E": dict(return_quantized=True),
             "K8": dict(collect_stats=True)}[kind]
    whole = qmatmul_fused(_t(a), bt, **kw)
    if lattice:
        want = np.asarray(jax_qmatmul(
            jnp.asarray(a), jnp.asarray(bt.float().numpy()), repr_fmt=JFP8,
            **{k: v for k, v in kw.items() if k != "repr_fmt"}))
        np.testing.assert_array_equal(_bits(whole.numpy()), _bits(want))
    for blocks in BLOCKS.values():
        for r0, r1, c0, c1 in blocks:
            got = qmatmul_fused(_t(a[r0:r1]), bt[:, c0:c1], row0=r0,
                                col0=c0, n_cols=N, **kw, **extra)
            got = got[0] if extra else got
            assert torch.equal(got, whole[r0:r1, c0:c1]), (r0, c0)
    off = qmatmul_fused(_t(a[16:]), bt, **kw)
    assert not torch.equal(off, whole[16:])


@pytest.mark.parametrize("lattice", [True, False], ids=["lattice", "random"])
@pytest.mark.parametrize("stats", [False, True], ids=["B", "K9"])
def test_pair_sr_k_slices_match_whole_call(stats, lattice):
    """B and K9 on the K-slices of the mesh backward (every row of g, the
    slice's x columns and w rows) with ``k_offset``/``k_total``: dx's
    columns and dw's rows bitwise the whole SR pair's, JAX's on lattice
    operands; K9's dx and dw are B's."""
    rng = np.random.RandomState(11 + lattice)
    t, k, n = 40, 96, 64
    x = _operands(rng, (t, k), lattice)
    w = _operands(rng, (k, n), lattice, 1 / np.sqrt(k))
    g = _operands(rng, (t, n), lattice, 1 / np.sqrt(n))
    _, xq, wq = qmatmul_fused(_t(x), _t(w), repr_fmt=FP8_152,
                              return_quantized=True)
    kw = dict(repr_fmt=FP8_152, bwd_acc=ACC, grad_acc=(6, 7), packed=True,
              rounding="sr", sr_seed_bwd=SR_SEED + 101,
              sr_seed_grad=SR_SEED + 202)
    dx, dw = qmatmul_bwd_pair(_t(g), xq, wq, bwd_chunk=16, grad_chunk=8,
                              **kw)
    if lattice:
        jdx, jdw = jax_pair(jnp.asarray(g), jnp.asarray(xq.numpy()),
                            jnp.asarray(wq.numpy()), block_t=8, block_k=32,
                            block_n=16, **kw)
        np.testing.assert_array_equal(_bits(dx.numpy()), _bits(jdx))
        np.testing.assert_array_equal(_bits(dw.numpy()), _bits(jdw))
    for parts in (2, 4):
        ks = k // parts
        for i in range(parts):
            sl = slice(i * ks, (i + 1) * ks)
            out = qmatmul_bwd_pair(_t(g), xq[:, sl].contiguous(), wq[sl],
                                   bwd_chunk=16, grad_chunk=8,
                                   k_offset=i * ks, k_total=k,
                                   collect_stats=stats, **kw)
            assert torch.equal(out[0], dx[:, sl]), (parts, i)
            assert torch.equal(out[1], dw[sl]), (parts, i)
            if stats:
                b = qmatmul_bwd_pair(_t(g), xq[:, sl].contiguous(), wq[sl],
                                     bwd_chunk=16, grad_chunk=8,
                                     k_offset=i * ks, k_total=k, **kw)
                assert torch.equal(b[0], out[0]) and torch.equal(b[1], out[1])
    off = qmatmul_bwd_pair(_t(g), xq[:, ks:].contiguous(), wq[ks:],
                           bwd_chunk=16, grad_chunk=8, **kw)
    assert not torch.equal(off[0], dx[:, ks:])


# --------------------------------------------------------------------------
# training over the meshes against the single device
# --------------------------------------------------------------------------

SR = ["--policy", "perturbed", "--pp", "-2", "--rounding", "sr",
      "--sr-seed", "5"]
PRED = ["--policy", "predicted"]
EXACT = ["--policy", "exact"]
TICK = ["--policy", "perturbed", "--pp", "-4", "--chunk", "8",
        "--telemetry-cadence", "1", "--ingraph-telemetry"]
MESHES = {"2x1": {"data": 2, "model": 1}, "1x2": {"data": 1, "model": 2},
          "2x2": {"data": 2, "model": 2}}


def _rank(rank, size, init_method, shape, jobs):
    torch.set_num_threads(1)
    from repro_torch.sharding.specs import batch_spec
    from repro_torch.launch.mesh import Mesh

    baxes = batch_spec(8, Mesh(dict(shape)))
    dist = D.init_mesh(rank, shape, init_method, "gloo", batch_axes=baxes)
    return [T.train(T.parse_args(argv), dist, torch.device("cpu"),
                    _numpy_state, T.oracle_plan if oracle else None)
            for argv, oracle in jobs]


def _log(d, who, name):
    return ["--telemetry-log", str(d / f"{who}_{name}.jsonl")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_model")
    ck = d / "ck"
    single = {}
    with _threads(1):
        for name, extra, oracle in (("sr", SR, False), ("pred", PRED, False),
                                    ("exact", EXACT, False),
                                    ("oracle", TICK, True)):
            single[name] = T.train(
                T.parse_args(BASE + extra + _log(d, "single", name)),
                finish=_numpy_state, plan=T.oracle_plan if oracle else None)
    jobs = {
        "2x1": [(BASE + SR, False), (BASE + TICK + _log(d, "mesh", "oracle"),
                                     True),
                (BASE + PRED + ["--ckpt-dir", str(ck), "--ckpt-every", "2"],
                 False)],
        "1x2": [(BASE + PRED, False)],
        "2x2": [(BASE + SR, False), (BASE + PRED, False),
                (BASE + EXACT, False)],
    }
    names = {"2x1": ("sr", "oracle", "pred"), "1x2": ("pred", "resumed"),
             "2x2": ("sr", "pred", "exact")}
    mesh = {}
    for key in ("2x1", "1x2", "2x2"):
        if key == "1x2":
            # the 2x1 run's step-2 checkpoint, restored onto 1x2
            shutil.rmtree(ck / "step_00000003")
            jobs[key].append((BASE + PRED + ["--ckpt-dir", str(ck)], False))
        outs = D.spawn(_rank, 4 if key == "2x2" else 2,
                       (MESHES[key], jobs[key]), timeout_s=SPAWN_TIMEOUT_S)
        for i, name in enumerate(names[key]):
            mesh[key, name] = [o[i] for o in outs]
    return single, mesh, d


@pytest.mark.parametrize("key,name", [("2x1", "sr"), ("2x2", "sr"),
                                      ("1x2", "pred"), ("2x2", "pred"),
                                      ("2x2", "exact"), ("2x1", "oracle")])
def test_mesh_bitwise_single_device(runs, key, name):
    """Every rank's records, schedule and blocks of the final state are
    the single device's, bitwise (the exact plan's ``torch.matmul`` too,
    on this CPU; on the card see ROADMAP F8)."""
    single, mesh, _ = runs
    ref = single[name]
    for res in mesh[key, name]:
        assert _records(res) == _records(ref)
        assert res["schedule"] == ref["schedule"]
    _check_state(ref, mesh[key, name], MESHES[key])
    if name == "oracle":
        assert ref["schedule"], "the tick should re-plan at this setting"


def test_oracle_tick_verdicts_under_row_split(runs):
    """The oracle's in-graph tick on 2x1 (its K8 replays on each rank's
    rows and K-slices, merged over the ranks): the single device's
    verdicts."""
    _, _, d = runs
    keys = ("step", "gemm", "role", "event", "source", "m_acc", "m_pred",
            "n", "n1", "n2")

    def verdicts(who):
        with open(d / f"{who}_oracle.jsonl") as f:
            return [{k: e.get(k) for k in keys} for e in map(json.loads, f)]

    want = verdicts("single")
    assert want and verdicts("mesh") == want


def test_checkpoint_from_2x1_restores_onto_1x2(runs):
    single, mesh, _ = runs
    want = _records(single["pred"])[2:]
    for res in mesh["1x2", "resumed"]:
        assert _records(res) == want


def test_model_axis_must_divide_kv_heads():
    """The smoke config's 2 KV heads do not split over a model axis of 4:
    refused before any rank starts."""
    with pytest.raises(ValueError, match="KV heads"):
        T.main(BASE + PRED + ["--mesh", "1x4"])
