"""Port vs JAX package: weights carried across, and the serving slice as a
whole (smoke qwen2-1.5b, predicted plan, paged int8 arena, continuous
batching) on the same parameters and prompts."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.policy import AccumulationPolicy as JPolicy
from repro.core.policy import plan_for_model as jax_plan
from repro.models.api import get_model as jax_get_model
from repro.serve import scheduler as JS
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import AccumulationPolicy, plan_for_model
from repro_torch.models.api import get_model
from repro_torch.serve import scheduler as TS

PROMPT_LENS = (16, 21, 48)
GEN = 8
PAGE = 16
MAX_BATCH = 4
CHUNK = 16  # GEMM chunk: every GEMM of the smoke model runs several chunks


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _walk(a, b, fn, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _walk(a[k], b[k], fn, f"{path}/{k}")
    else:
        fn(a, b, path)


@pytest.mark.parametrize("bf16", [False, True])
def test_params_from_jax_roundtrip(bf16):
    cfg = jax_smoke("qwen2-1.5b")
    params = jax_get_model(cfg).init_params(jax.random.PRNGKey(3))
    if bf16:
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    np_params = _np_tree(params)
    got = params_from_jax(np_params, get_smoke_config("qwen2-1.5b"), "cpu")

    def same(j, t, path):
        assert tuple(t.shape) == j.shape, path
        want_dtype = torch.bfloat16 if bf16 else torch.float32
        assert t.dtype == want_dtype, path
        tb = t.view(torch.int16) if bf16 else t.view(torch.int32)
        jb = j.view(np.int16) if bf16 else j.view(np.int32)
        np.testing.assert_array_equal(tb.numpy(), jb, err_msg=path)

    _walk(np_params, got, same)
    with pytest.raises(ValueError):
        bad = dict(np_params, embed=np_params["embed"][:-1])
        params_from_jax(bad, get_smoke_config("qwen2-1.5b"), "cpu")


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------


class _JaxRec(JS.ModelExecutor):
    """JAX executor that records every call's logits and the codes of the
    pages each prefill slab wrote."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.prefills, self.decodes = [], {}

    def decode(self, req):
        self._rids = req.rids
        return super().decode(req)

    def _prefill_fn(self, *a, **kw):
        fn = super()._prefill_fn(*a, **kw)

        def rec(params, toks, kv, row, slab, q_off, q_len):
            logits, new_kv = fn(params, toks, kv, row, slab, q_off, q_len)
            pages = [int(p) for p in np.asarray(slab) if p]
            self.prefills.append((
                None if logits is None else np.asarray(
                    logits.astype(jnp.float32)),
                {k: np.asarray(v[:, pages]) for k, v in new_kv.items()}))
            return logits, new_kv
        return rec

    def _decode_fn(self, *a, **kw):
        fn = super()._decode_fn(*a, **kw)

        def rec(params, tokens, kv, pt, pos, sl):
            logits, new_kv = fn(params, tokens, kv, pt, pos, sl)
            rows = np.asarray(logits[:, 0].astype(jnp.float32))
            for i, rid in enumerate(self._rids):
                self.decodes.setdefault(rid, []).append(rows[i])
            return logits, new_kv
        return rec


class _TorchRec(TS.ModelExecutor):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.prefills, self.decodes = [], {}

    def prefill_logits(self, req):
        logits = super().prefill_logits(req)
        pages = list(req.slab_pages)
        self.prefills.append((
            None if logits is None else logits.float().numpy(),
            {k: v[:, pages].numpy() for k, v in self.kv.items()}))
        return logits

    def decode_logits(self, req):
        logits = super().decode_logits(req)
        for i, rid in enumerate(req.rids):
            self.decodes.setdefault(rid, []).append(logits[i].float().numpy())
        return logits


def _prompts(vocab):
    rng = np.random.RandomState(31)
    return [rng.randint(0, vocab, n).tolist() for n in PROMPT_LENS]


def _n_pages():
    return -(-int(sum(n + GEN for n in PROMPT_LENS) * 1.25) // PAGE) + 1


def _configs():
    max_ctx = max(PROMPT_LENS) + GEN
    jcfg = jax_plan(jax_smoke("qwen2-1.5b"), seq_len=max_ctx,
                    global_batch=len(PROMPT_LENS),
                    policy=JPolicy(mode="predicted", chunk=CHUNK))
    tcfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=max_ctx,
                          global_batch=len(PROMPT_LENS),
                          policy=AccumulationPolicy(mode="predicted",
                                                    chunk=CHUNK))
    return jcfg, tcfg


def _jax_params(jcfg):
    model = jax_get_model(jcfg)
    return model, jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                               model.init_params(jax.random.PRNGKey(0)))


def jax_child(out_path: str) -> None:
    """The JAX side of the slice comparison: serve the prompts one-shot and
    chunked and save every recorded array.  Run in a child process with
    ``--xla_allow_excess_precision=false``: by default XLA's jit drops a
    bf16 rounding that is followed by a cast back to f32 (the bf16
    activations entering ``qdot``, the attention kernels and the arena
    writes), so the jitted engine computes some activations in f32 where
    the source rounds them to bf16.  The port rounds as the source does."""
    from repro.quant.formats import FPFormat as JF
    from repro.serve.kvcache import PagedKVConfig as JPC

    jcfg, _ = _configs()
    jmodel, jparams = _jax_params(jcfg)
    out = {}
    for chunk in (None, 16):
        ex = _JaxRec(jmodel, jparams,
                     JPC.for_model(jcfg, n_pages=_n_pages(), page_size=PAGE),
                     kv_fmt=JF(5, 2), max_batch=MAX_BATCH)
        eng = JS.ServeEngine(jmodel, jparams, n_pages=_n_pages(),
                             page_size=PAGE, max_batch=MAX_BATCH,
                             prefill_chunk_tokens=chunk, executor=ex)
        rids = [eng.submit(p, GEN) for p in _prompts(jcfg.vocab_size)]
        res = eng.run()
        tag = f"c{chunk}"
        out[f"{tag}/streams"] = np.array([res[r] for r in rids])
        for i, (logits, pages) in enumerate(ex.prefills):
            if logits is not None:
                out[f"{tag}/prefill{i}/logits"] = logits
            for name, a in pages.items():
                out[f"{tag}/prefill{i}/{name}"] = a
        for rid, rows in ex.decodes.items():
            out[f"{tag}/decode{rid}"] = np.stack(rows)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages serve the same prompts on the same bf16 params, one-shot
    and with 16-token prefill slabs."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = str(tmp_path_factory.mktemp("jax_slice") / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.join(repo, "src"),
                                           os.path.join(repo, "tests")]))
    child = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_serve as t; t.jax_child({path!r})"],
        env=env, cwd=repo, capture_output=True, text=True, timeout=600)
    assert child.returncode == 0, child.stdout + child.stderr
    jax_out = dict(np.load(path))

    jcfg, tcfg = _configs()
    _, jparams = _jax_params(jcfg)
    tparams = params_from_jax(_np_tree(jparams), tcfg, "cpu")
    tmodel = get_model(tcfg)
    from repro_torch.quant.formats import FPFormat as TF
    from repro_torch.serve.kvcache import PagedKVConfig as TPC

    out = {}
    for chunk in (None, 16):
        texec = _TorchRec(tmodel, tparams,
                          TPC.for_model(tcfg, n_pages=_n_pages(),
                                        page_size=PAGE),
                          kv_fmt=TF(5, 2), max_batch=MAX_BATCH, device="cpu")
        teng = TS.ServeEngine(tmodel, tparams, n_pages=_n_pages(),
                              page_size=PAGE, max_batch=MAX_BATCH,
                              prefill_chunk_tokens=chunk, executor=texec,
                              device="cpu")
        tr = [teng.submit(p, GEN) for p in _prompts(tcfg.vocab_size)]
        tres = teng.run()
        out[chunk] = dict(jax=_unpack(jax_out, f"c{chunk}"), texec=texec,
                          teng=teng, tstreams=[tres[r] for r in tr])
    return out


def _unpack(flat: dict, tag: str) -> dict:
    """The child's arrays of one run as (prefills, decodes, streams)."""
    prefills, i = [], 0
    while f"{tag}/prefill{i}/k" in flat:
        pre = f"{tag}/prefill{i}/"
        prefills.append((flat.get(pre + "logits"),
                         {n: flat[pre + n] for n in ("k", "v", "k_se", "v_se")}))
        i += 1
    decodes = {int(k.rsplit("decode", 1)[1]): list(v)
               for k, v in flat.items() if k.startswith(f"{tag}/decode")}
    return dict(prefills=prefills, decodes=decodes,
                streams=flat[f"{tag}/streams"].tolist())


# Both packages run the same quantized GEMMs, int8 arena, carry formats and
# bf16 roundings; what can still differ is a transcendental function's last
# f32 bit (exp in silu, cos/sin/pow in rope, log for the page exponent come
# from XLA's and PyTorch's own libraries), which can move a bf16 rounding
# and then one (1,5,2) operand or KV code by one step.  Least fraction of
# equal arena codes after the prefill slabs:
CODE_FLOOR = 0.999
# Logit tolerance for such a step, on logits of scale ~3 (tied embeddings,
# std d^-1/2, rms-normed hidden state): one operand step moves a GEMM
# output by a quarter of one product, ~0.03 here, and two layers and the
# lm_head can double that.
LOGIT_TOL = 0.0625


@pytest.mark.parametrize("chunk", [None, 16])
def test_slice_matches_jax(served, chunk):
    r = served[chunk]
    jx, tx = r["jax"], r["texec"]
    # same schedule: the same prefill slabs, final slabs in the same places
    assert len(jx["prefills"]) == len(tx.prefills)
    assert [l is None for l, _ in jx["prefills"]] == \
        [l is None for l, _ in tx.prefills]

    eq = tot = 0
    max_pre = 0.0
    for (jl, jpages), (tl, tpages) in zip(jx["prefills"], tx.prefills):
        for name in ("k", "v", "k_se", "v_se"):
            eq += int(np.sum(jpages[name] == tpages[name]))
            tot += jpages[name].size
        if jl is not None:
            max_pre = max(max_pre, float(np.max(np.abs(jl - tl))))
    frac = eq / tot
    print(f"chunk={chunk}: prefill arena codes equal {frac:.5f}, max "
          f"prefill logit error {max_pre:.4f}")
    assert max_pre <= LOGIT_TOL
    assert frac >= CODE_FLOOR

    # per-step logits and greedy streams, request by request until its
    # stream leaves JAX's, which may happen only at a near-tie (a top-2
    # margin within the logit tolerance); decode rows are independent, so
    # a request's logits do not depend on the batch it shares
    max_err, diverged = 0.0, {}
    for i, (a, b) in enumerate(zip(jx["streams"], r["tstreams"])):
        assert len(a) == len(b) == GEN
        jl, tl = jx["decodes"][i], tx.decodes[i]
        assert len(jl) == len(tl) == GEN - 1
        for step in range(1, GEN):  # token 0 comes from the prefill logits
            err = float(np.max(np.abs(jl[step - 1] - tl[step - 1])))
            max_err = max(max_err, err)
            assert err <= LOGIT_TOL, (i, step, err)
            if a[step] != b[step]:
                top2 = np.sort(jl[step - 1])[-2:]
                assert top2[1] - top2[0] <= LOGIT_TOL, (
                    f"request {i} left JAX's stream at token {step} with a "
                    f"top-2 margin {top2[1] - top2[0]:.3f}")
                diverged[i] = step
                break
    print(f"chunk={chunk}: max decode logit error {max_err:.4f}, streams "
          f"diverged {diverged or 'nowhere'}")


def test_slice_chunked_prefill_is_bitwise_oneshot(served):
    one, ch = served[None], served[16]
    assert one["tstreams"] == ch["tstreams"]
    assert ch["teng"].prefill_slabs > len(PROMPT_LENS)
    finals = [l for l, _ in one["texec"].prefills if l is not None]
    finals_ch = [l for l, _ in ch["texec"].prefills if l is not None]
    for a, b in zip(finals, finals_ch):
        np.testing.assert_array_equal(a, b)
    for rid, rows in one["texec"].decodes.items():
        np.testing.assert_array_equal(np.stack(rows),
                                      np.stack(ch["texec"].decodes[rid]))
    ch["teng"].pool.check_invariants()
    assert ch["teng"].pool.free_pages == ch["teng"].pool.n_pages - 1
