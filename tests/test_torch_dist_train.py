"""Port: training over a mesh's data axis (FSDP over ``data``, the batch
over ``pod`` x ``data``) against the port's single device, and its pure
functions against the JAX package's.

The reference for the distributed step is the port's single-device step
(itself held against JAX by ``tests/test_torch_train.py``): JAX's own
distributed tests do not run on this jax (ROADMAP F1).  Ranks are
processes of a gloo group (``repro_torch.dist.spawn``), one torch thread
each; the single-device references run in this process on one thread.
The smoke config, 8 sequences of 16 tokens, 3 steps.

Tolerances:

* The spec rules, ``batch_spec``: equal to JAX's, leaf for leaf.
* ``EnsembleStats.psum`` over 2 and 4 ranks against JAX's ``psum`` under
  a named ``vmap`` axis on the same float32 fields: count, max, swamped
  and adds bitwise; the means and second moments within 2^-20 relative
  (float32 sums in another order), and the port's psum against its own
  sequential ``merge`` (JAX's cross-check) within the same bound.
* B's plain version on K-slices: dx and dw bitwise the whole call's
  slices (RNE), stats off and on; the slices' stats rows merged equal the
  whole row's exact slots bitwise and its sums within SUM_REL/SUM_ABS.
* ``--mesh 2x1`` and ``2x2x1`` training: bitwise the single device for 3
  steps (losses, grad norms, skip flags, loss scales, and every rank's
  blocks of the final params and both moments), plain, with
  ``--microbatches 2 --loss-scaling``, with A2Q, under
  ``quantize_outputs``, with the eager tick every step and with the
  in-graph tick every step (both re-plan).  The
  eager tick's events equal the single device's; the in-graph tick's
  verdicts equal, its rows' counts and max bitwise and its sums within
  SUM_REL/SUM_ABS plus one float32 rounding of each part's Cauchy-Schwarz
  bound for the first-moment slots (each rank's K9 row is a float32 row
  of its part; ``_window_gap``).
* ``--policy exact`` (the layer GEMMs are ``torch.matmul``): bitwise on
  this CPU (a row count that changes the library's bits would show here;
  on the card see ROADMAP Queue 3).
* Checkpoints: a run resumed across meshes (2 ranks -> 1, 1 -> 2) gives
  the uninterrupted run's step-3 record, bitwise.
* ``--mesh 1x2`` and ``--mesh 2x1 --rounding sr`` through the launcher:
  one step, the single device's record bitwise.
"""

from __future__ import annotations

import contextlib
import math
import shutil

import numpy as np
import pytest
import torch

from repro_torch import dist as D
from repro_torch.launch import train as T
from repro_torch.train import optimizer as O

SPAWN_TIMEOUT_S = 300
BASE = ["--smoke", "--steps", "3", "--policy", "predicted", "--chunk", "16",
        "--device", "cpu", "--log-every", "1", "--global-batch", "8",
        "--seq-len", "16"]
TELE = ["--policy", "perturbed", "--pp", "-4", "--chunk", "8",
        "--telemetry-cadence", "1"]
CONFIGS = {
    "plain": [],
    "mb_ls": ["--microbatches", "2", "--loss-scaling"],
    "a2q": ["--a2q-reg", "1e-2", "--a2q-x-bound", "2e6"],
    "eager": TELE,
    "ingraph": TELE + ["--ingraph-telemetry"],
    "exact": ["--policy", "exact"],
}
MESH_2X1 = {"data": 2, "model": 1}
MESH_2X2X1 = {"pod": 2, "data": 2, "model": 1}


@contextlib.contextmanager
def _threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _argv(name, d, who, *extra):
    out = BASE + CONFIGS[name] + list(extra)
    if name in ("eager", "ingraph"):
        out += ["--telemetry-log", str(d / f"{who}_{name}.jsonl")]
    return out


def _mesh_dist(rank, size, init_method, shape, batch_axes, fsdp="data"):
    torch.set_num_threads(1)
    return D.init_mesh(rank, shape, init_method, "gloo",
                       batch_axes=batch_axes, fsdp_axis=fsdp)


def _tagged_rows(args, dist):
    """The in-graph collector's rows of one tagged step at step 1."""
    from repro_torch.models.api import get_model
    from repro_torch.obs.ingraph import (InGraphCollector, collecting,
                                         tag_quant_plan)
    from repro_torch.train.loop import make_train_step

    model, tc, state, data, _ = T.build(args, dist, torch.device("cpu"))
    tagged = get_model(tag_quant_plan(model.cfg))
    col = InGraphCollector()
    with collecting(col):
        make_train_step(tagged, tc, dist)(state, next(data))
    return {k: np.asarray(v) for k, v in col.rows().items()}


def _a2q_cert(args, dist):
    model, tc, state, _, _ = T.build(args, dist, torch.device("cpu"))
    return O.a2q_certificate(state["params"], tc.a2q, dist)


@contextlib.contextmanager
def _quantize_outputs():
    """The launcher's policy under ``quantize_outputs=True`` (no launcher
    flag has it, in either package)."""
    import dataclasses

    orig = T._policy
    T._policy = lambda args: dataclasses.replace(orig(args),
                                                 quantize_outputs=True)
    try:
        yield
    finally:
        T._policy = orig


def _numpy_state(state, model, dist) -> dict:
    """``T.train``'s ``finish``: the state this rank holds, as numpy (a
    rank's tensors would cross the result queue as shared memory that the
    exiting rank takes with it)."""
    return {"state": O.tree_map(lambda t: t.detach().cpu().numpy(), state)}


def _jobs_rank(rank, size, init_method, shape, batch_axes, jobs):
    dist = _mesh_dist(rank, size, init_method, shape, batch_axes)
    out = []
    for kind, argv in jobs:
        if kind == "psum":
            out.append(_psum(dist, argv, _psum_fields(size)))
            continue
        args = T.parse_args(argv)
        if kind in ("train", "qout"):
            with (_quantize_outputs() if kind == "qout"
                  else contextlib.nullcontext()):
                out.append(T.train(args, dist, torch.device("cpu"),
                                   _numpy_state))
        elif kind == "rows":
            out.append(_tagged_rows(args, dist))
        else:
            out.append(_a2q_cert(args, dist))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    single, ck1, ck2 = {}, d / "ck_single", d / "ck_mesh"
    with _threads(1):
        for name in CONFIGS:
            extra = (["--ckpt-dir", str(ck1), "--ckpt-every", "2"]
                     if name == "plain" else [])
            single[name] = T.train(T.parse_args(_argv(name, d, "single",
                                                      *extra)),
                                   finish=_numpy_state)
        with _quantize_outputs():
            single["qout"] = T.train(T.parse_args(_argv("plain", d, "q")),
                                     finish=_numpy_state)
        single["rows"] = _tagged_rows(T.parse_args(_argv("ingraph", d, "x")),
                                      D.LOCAL)
        single["cert"] = _a2q_cert(T.parse_args(_argv("a2q", d, "x")),
                                   D.LOCAL)
    shutil.rmtree(ck1 / "step_00000003")
    jobs = [("train", _argv(name, d, "mesh", *(
        ["--ckpt-dir", str(ck2), "--ckpt-every", "2"]
        if name == "plain" else []))) for name in CONFIGS]
    jobs += [("train", BASE + ["--ckpt-dir", str(ck1)]),
             ("rows", _argv("ingraph", d, "x")),
             ("cert", _argv("a2q", d, "x")), ("psum", ("data",)),
             ("qout", _argv("plain", d, "q"))]
    outs = D.spawn(_jobs_rank, 2, (MESH_2X1, ("data",), jobs),
                   timeout_s=SPAWN_TIMEOUT_S)
    mesh = {name: [o[i] for o in outs] for i, name in enumerate(CONFIGS)}
    n = len(CONFIGS)
    mesh["resumed_from_1"] = [o[n] for o in outs]
    mesh["rows"] = [o[n + 1] for o in outs]
    mesh["cert"] = [o[n + 2] for o in outs]
    mesh["psum2"] = [o[n + 3] for o in outs]
    mesh["qout"] = [o[n + 4] for o in outs]
    outs4 = D.spawn(_jobs_rank, 4, (MESH_2X2X1, ("pod", "data"),
                                    [("train", _argv("plain", d, "m4")),
                                     ("psum", ("pod", "data"))]),
                    timeout_s=SPAWN_TIMEOUT_S)
    mesh["2x2x1"] = [o[0] for o in outs4]
    mesh["psum4"] = [o[1] for o in outs4]
    shutil.rmtree(ck2 / "step_00000003")
    with _threads(1):
        mesh["resumed_on_1"] = T.train(T.parse_args(BASE + ["--ckpt-dir",
                                                            str(ck2)]))
    return single, mesh, d


# --------------------------------------------------------------------------
# the pure functions against JAX's
# --------------------------------------------------------------------------


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("shape", [dict(data=2, model=2),
                                   dict(data=7, model=512),
                                   dict(data=16, model=16),
                                   dict(pod=2, data=16, model=16)],
                         ids=["2x2", "7x512", "16x16", "2x16x16"])
def test_param_specs_match_jax(shape):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jcfg
    from repro.models.api import get_model as jmodel
    from repro.sharding.specs import ShardingRules as JRules
    from repro.sharding.specs import build_param_specs as jspecs
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import get_model
    from repro_torch.sharding.specs import ShardingRules, build_param_specs

    model = jmodel(jcfg("qwen2-1.5b"))
    shapes = jax.eval_shape(model.init_params,
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = dict(_flat(jspecs(shapes, JRules(_FakeMesh(**shape)))))
    port = get_model(get_smoke_config("qwen2-1.5b"))
    got = dict(_flat(build_param_specs(
        port.init_params(torch.Generator(), "meta"),
        ShardingRules(_FakeMesh(**shape)))))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == tuple(want[k]), k


@pytest.mark.parametrize("batch,shape", [
    (256, dict(pod=2, data=16, model=16)), (8, dict(pod=2, data=16,
                                                    model=16)),
    (1, dict(pod=2, data=16, model=16)), (32, dict(data=16, model=16)),
    (8, dict(data=2, model=1)), (8, dict(pod=2, data=2, model=1)),
    (6, dict(pod=2, data=4, model=1))])
def test_batch_spec_matches_jax(batch, shape):
    from repro.sharding.specs import batch_spec as jbatch
    from repro_torch.sharding.specs import batch_spec

    assert batch_spec(batch, _FakeMesh(**shape)) == \
        tuple(jbatch(batch, _FakeMesh(**shape)))


_FIELDS = ("count", "mean_q", "m2_q", "mean_i", "m2_i", "max_abs",
           "swamped", "adds", "err_sum", "err_sumsq")
_EXACT = ("count", "max_abs", "swamped", "adds")


def _stats_rows(n):
    """n raw stats rows of a plausible ensemble each."""
    from repro_torch.kernels.common import (N_STATS, STAT_ADDS, STAT_COUNT,
                                            STAT_MAX_ABS, STAT_SUM_ERR,
                                            STAT_SUM_I, STAT_SUM_Q,
                                            STAT_SUMSQ_ERR, STAT_SUMSQ_I,
                                            STAT_SUMSQ_Q, STAT_SWAMPED)

    rng = np.random.RandomState(n)
    rows = np.zeros((n, N_STATS), np.float64)
    for r in range(n):
        c = 64 * (r + 1)
        q = rng.randn(c) * (1 + r) + 0.3
        i = q + rng.randn(c) * 1e-3
        rows[r, STAT_COUNT] = c
        rows[r, STAT_SUM_Q], rows[r, STAT_SUMSQ_Q] = q.sum(), (q * q).sum()
        rows[r, STAT_SUM_I], rows[r, STAT_SUMSQ_I] = i.sum(), (i * i).sum()
        rows[r, STAT_SUM_ERR] = (q - i).sum()
        rows[r, STAT_SUMSQ_ERR] = ((q - i) ** 2).sum()
        rows[r, STAT_MAX_ABS] = np.abs(q).max()
        rows[r, STAT_SWAMPED] = rng.randint(0, 50)
        rows[r, STAT_ADDS] = 100 + rng.randint(0, 50)
    return rows


def _psum_fields(n):
    """The float32 fields of JAX's ``from_raw`` of ``_stats_rows(n)``,
    computed here in numpy as JAX's from_raw does in float32."""
    from repro_torch.telemetry.stats import EnsembleStats

    return [[float(getattr(EnsembleStats.from_raw(
        np.asarray(r, np.float32)), f)) for f in _FIELDS]
        for r in _stats_rows(n)]


def _psum(dist, axis, fields):
    from repro_torch.telemetry.stats import EnsembleStats

    st = EnsembleStats(*[np.float32(v) for v in
                         fields[dist.mesh.axis_index(axis)]])
    return [float(getattr(st.psum(axis, dist), f)) for f in _FIELDS]


@pytest.mark.parametrize("n", [2, 4])
def test_ensemble_psum_matches_jax(runs, n):
    import jax
    import jax.numpy as jnp

    from repro.telemetry.stats import EnsembleStats as JStats
    from repro_torch.telemetry.stats import EnsembleStats

    fields = _psum_fields(n)
    stacked = JStats(*[jnp.asarray([fl[i] for fl in fields], jnp.float32)
                       for i in range(len(_FIELDS))])
    want = jax.vmap(lambda s: s.psum("i"), axis_name="i")(stacked)
    got = runs[1][f"psum{n}"]
    merged = EnsembleStats(*[np.float32(v) for v in fields[0]])
    for fl in fields[1:]:
        merged = merged.merge(EnsembleStats(*[np.float32(v) for v in fl]))
    for rank_vals in got:
        assert rank_vals == got[0]          # every rank the same bits
    for i, f in enumerate(_FIELDS):
        w = float(np.asarray(getattr(want, f))[0])
        g = got[0][i]
        if f in _EXACT:
            assert np.float32(g) == np.float32(w), f
            assert np.float32(g) == getattr(merged, f), f
        else:
            assert abs(g - w) <= 2.0 ** -20 * abs(w), (f, g, w)
            m = float(getattr(merged, f))
            assert abs(g - m) <= 2.0 ** -20 * abs(m), (f, g, m)


@pytest.mark.parametrize("stats", [False, True], ids=["plain", "stats"])
def test_pair_on_k_slices_bitwise_whole_call(stats):
    from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
    from repro_torch.kernels.common import stats_gap
    from repro_torch.quant.formats import FP8_152
    from repro_torch.quant.qtensor import QTensor

    rng = np.random.RandomState(3)
    t, k, n = 64, 96, 80
    g = torch.from_numpy(rng.randn(t, n).astype(np.float32))
    x = QTensor.pack(torch.from_numpy(rng.randn(t, k).astype(np.float32)),
                     FP8_152).payload
    w = QTensor.pack(torch.from_numpy(rng.randn(k, n).astype(np.float32)),
                     FP8_152).payload
    kw = dict(repr_fmt=FP8_152, bwd_acc=(5, 6), grad_acc=(5, 7),
              bwd_chunk=16, grad_chunk=8, packed=True, quantize_g=True,
              collect_stats=stats)
    whole = qmatmul_bwd_pair(g, x, w, **kw)
    for r in (2, 3, 4):
        ks = k // r
        rows = []
        for i in range(r):
            part = qmatmul_bwd_pair(g, x[:, i * ks:(i + 1) * ks].contiguous(),
                                    w[i * ks:(i + 1) * ks], **kw)
            assert torch.equal(part[0], whole[0][:, i * ks:(i + 1) * ks])
            assert torch.equal(part[1], whole[1][i * ks:(i + 1) * ks])
            if stats:
                rows.append(part[2].double())
        if stats:
            from repro_torch.kernels.common import STAT_MAX_ABS

            tot = sum(rows)
            tot[:, STAT_MAX_ABS] = torch.stack(rows)[:, :,
                                                     STAT_MAX_ABS].amax(0)
            exact, ratio = stats_gap(tot, whole[2])
            assert exact and ratio <= 1.0, ratio


# --------------------------------------------------------------------------
# training over the mesh against the single device
# --------------------------------------------------------------------------

_REC = ("step", "loss", "grad_norm", "lr", "skipped", "loss_scale")


def _records(res):
    return [{k: r[k] for k in _REC} for r in res["records"]]


def _check_state(single, ranks, shape):
    """Every rank's blocks of params and both moments equal the single
    device's slices of them, bitwise."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.api import get_model
    from repro_torch.sharding.specs import (ShardingRules, build_param_specs,
                                            shard)

    model = get_model(get_smoke_config("qwen2-1.5b"))
    specs = build_param_specs(model.init_params(torch.Generator(), "meta"),
                              ShardingRules(Mesh(dict(shape))))
    mesh = Mesh(dict(shape))
    for r, res in enumerate(ranks):
        for tree in ("params", "m", "v"):
            def pick(st):
                return st["params"] if tree == "params" else st["opt"][tree]

            whole = dict(_flat(pick(single["state"])))
            mine = dict(_flat(pick(res["state"])))
            spec = dict(_flat(specs, ))
            for path, w in whole.items():
                want = shard(torch.from_numpy(w), spec[path], mesh, r)
                assert np.array_equal(mine[path], want.numpy()), \
                    (r, tree, path)
        assert int(res["state"]["opt"]["step"]) == \
            int(single["state"]["opt"]["step"])


@pytest.mark.parametrize("scaling", ["none", "dynamic", "static"])
@pytest.mark.parametrize("overflow", [False, True], ids=["finite", "inf"])
def test_block_grads_match_whole_gradients(scaling, overflow):
    """``block_grads``, one whole leaf at a time, against the single
    device's tree ops (``unscale_and_check`` or the finite check, then
    ``global_norm``): every rank's blocks, the skip flag and the clip norm
    bitwise, on an overflowing step too (zeroed, or left as they are under
    a static scale)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.specs import shard, tree_specs_map
    from repro_torch.train.loop import block_grads

    rng = np.random.RandomState(11)
    whole = {"embed": rng.randn(24, 16), "final_norm": rng.randn(16),
             "layers": {"wq": rng.randn(3, 16, 8), "ln": rng.randn(3, 16)}}
    whole = O.tree_map(lambda a: torch.from_numpy(a.astype(np.float32)),
                       whole)
    if overflow:
        whole["layers"]["wq"][1, 2, 3] = float("inf")
    specs = {"embed": (None, "data"), "final_norm": (None,),
             "layers": {"wq": (None, "data", None), "ln": (None, None)}}
    scaler = {"scale": torch.tensor(1024.0), "good_steps": torch.tensor(3)}
    cfg = O.LossScaleConfig(init_scale=1024.0, dynamic=scaling == "dynamic")
    if scaling == "none":
        skip = torch.logical_not(O.all_finite(whole))
        want = O.tree_map(
            lambda g: torch.where(skip, torch.zeros_like(g), g), whole)
    else:
        want, _, skip = O.unscale_and_check(whole, scaler, cfg)
    norm = O.global_norm(want)
    assert bool(skip) == overflow
    for r in range(2):
        mesh = Mesh({"data": 2, "model": 1}, r)
        got, got_skip, got_norm = block_grads(
            O.tree_map(lambda g: lambda g=g: g.clone(), whole), specs, mesh,
            unscale=None if scaling == "none" else scaler["scale"],
            zero_on_skip=scaling != "static")
        assert bool(got_skip) == overflow
        assert _bits(got_norm) == _bits(norm)
        blocks = tree_specs_map(lambda g, sp: shard(g, sp, mesh), want,
                                specs)
        for a, b in zip(O.tree_leaves(got), O.tree_leaves(blocks)):
            assert a.is_contiguous() and a.shape == b.shape
            assert np.array_equal(a.numpy().view(np.int32),
                                  b.contiguous().numpy().view(np.int32))


def _bits(t) -> bytes:
    return t.detach().numpy().tobytes()


@pytest.mark.parametrize("name", ["plain", "mb_ls", "a2q", "eager",
                                  "ingraph", "qout", "2x2x1"])
def test_mesh_training_bitwise_single_device(runs, name):
    single, mesh, _ = runs
    ref = single["plain" if name == "2x2x1" else name]
    shape = MESH_2X2X1 if name == "2x2x1" else MESH_2X1
    for res in mesh[name]:
        assert _records(res) == _records(ref)
        assert res["schedule"] == ref["schedule"]
    _check_state(ref, mesh[name], shape)
    if name in ("eager", "ingraph"):
        assert ref["schedule"], "the tick should re-plan at this setting"


def test_exact_policy_under_mesh(runs):
    """The exact plan's layer GEMMs are ``torch.matmul`` on the rank's rows
    and, in the backward, on K-slices of the global batch: bitwise here."""
    single, mesh, _ = runs
    for res in mesh["exact"]:
        assert _records(res) == _records(single["exact"])
    _check_state(single["exact"], mesh["exact"], MESH_2X1)


def _events(path):
    import json

    with open(path) as f:
        return [json.loads(line) for line in f]


_VERDICT = ("step", "gemm", "role", "event", "source", "m_acc", "m_pred",
            "n", "n1", "n2")


def test_mesh_ticks_match_single_device(runs):
    """The eager tick's events are the single device's; the in-graph
    tick's verdicts are, and its rows' counts and max bitwise, its sums
    within SUM_REL/SUM_ABS and one float32 rounding a part
    (``_window_gap``)."""
    single, mesh, d = runs
    assert _events(d / "mesh_eager.jsonl") == _events(d / "single_eager.jsonl")
    got = _events(d / "mesh_ingraph.jsonl")
    want = _events(d / "single_ingraph.jsonl")
    assert [{k: e.get(k) for k in _VERDICT} for e in got] == \
        [{k: e.get(k) for k in _VERDICT} for e in want]
    assert got
    for rows in mesh["rows"]:
        assert sorted(rows) == sorted(single["rows"])
        for key, row in rows.items():
            assert _window_gap(row, single["rows"][key], parts=4) <= 1.0, key


def _window_gap(got, want, parts):
    """Largest |got - want| / bound over the sum slots of a merged window
    whose exact slots must be bitwise.  The mesh's window is the union of
    ``parts`` rows (layers x ranks), each rounded once to float32 by its
    kernel: a square slot (no cancellation) stays within SUM_REL of its
    value; a first-moment slot within SUM_REL of its value plus, for each
    part, one float32 rounding (2^-24) of the part's Cauchy-Schwarz bound
    sqrt(count * sum of squares)."""
    from repro_torch.kernels.common import (STAT_COUNT, STAT_EXACT,
                                            STAT_FIRST, STAT_SQUARE,
                                            SUM_ABS, SUM_REL)

    assert [got[i] for i in STAT_EXACT] == [want[i] for i in STAT_EXACT]
    ratio = 0.0
    for s in STAT_SQUARE:
        d = abs(got[s] - want[s])
        ratio = max(ratio, d and d / (SUM_REL * abs(want[s])))
    for s, sq in STAT_FIRST.items():
        cs = math.sqrt(max(want[STAT_COUNT] * want[sq], 0.0))
        bound = SUM_REL * abs(want[s]) + (SUM_ABS + parts * 2.0 ** -24) * cs
        d = abs(got[s] - want[s])
        ratio = max(ratio, d and d / bound)
    return ratio


def test_a2q_certificate_under_mesh(runs):
    """A2Q's columns are whole on every rank (the data axis splits the
    embedding's D, not V), and the certificate's max is a pmax."""
    single, mesh, _ = runs
    for cert in mesh["cert"]:
        assert cert == single["cert"]


def test_checkpoint_restores_across_meshes(runs):
    single, mesh, _ = runs
    want = _records(single["plain"])[2:]
    for res in mesh["resumed_from_1"]:
        assert _records(res) == want
    assert _records(mesh["resumed_on_1"]) == want


def test_launcher_mesh_entry(capsys):
    """``main`` under ``--mesh 2x1`` spawns the ranks and prints the
    backend rule; its losses are the single device's."""
    argv = BASE[:2] + ["1"] + BASE[3:]
    with _threads(1):
        want = T.main(argv)["records"]
    got = T.main(argv + ["--mesh", "2x1"])["records"]
    assert [r["loss"] for r in got] == [r["loss"] for r in want]
    assert "backend the CPU: gloo" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [["--mesh", "1x2"],
                                   ["--mesh", "2x1", "--rounding", "sr",
                                    "--policy", "perturbed"]],
                         ids=["model-axis", "sr"])
def test_mesh_refuses_what_it_does_not_take(extra):
    """What this mesh path once refused runs: the model axis and SR over
    ranks, one step through the launcher's ``--mesh``, the single
    device's record bitwise (``tests/test_torch_dist_model.py`` holds
    them over more steps, meshes and the state)."""
    argv = BASE[:2] + ["1"] + BASE[3:] + extra[2:]
    with _threads(1):
        want = T.main(argv)["records"]
    got = T.main(argv + extra[:2])["records"]
    assert _records({"records": got}) == _records({"records": want})
