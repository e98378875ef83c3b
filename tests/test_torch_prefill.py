"""Port vs JAX package: the dense resumable prefill K10 (``flash_prefill``),
the arena's dequantized views, and the two layer functions that run K10
(``attn_prefill_paged``, ``attn_prefill_chunk_paged``).

Tolerances:

* K10's plain version against ``flash_prefill`` (interpret mode) and
  ``flash_prefill_reference``: the running max ``m`` bitwise (an integer
  on the lattice); the o and l carries and the finalized output within the
  bound of ``tests/test_torch_kernels.py``'s attention checks, 2 carry
  ulps of |want| (relative 2^(1 - m_acc)) plus one carry ulp of the
  largest value, and with the wide (f32) carry 2^-16 of the largest value
  (the intra-block f32 sums run in another order than XLA's dots, ROADMAP
  F0; a score error of k f32 ulps moves exp2 by k * ln2 * |score| ulps).
  The mismatch fraction is printed.  Measured: bitwise with the (1,6,5)
  carry, a few f32 ulps with the wide one.
* Inside the port, bitwise: a walk resumed at any chunk multiple against
  the one-shot walk (o, m, l and the output); the three prefill layer
  paths (one-shot K10, 16-token slabs through K10 with the carry out and
  in, and the bucketed paged prefill P) in outputs and arena bytes.
* The arena's views (``write_prompt``'s return, ``gather_pages``,
  ``dequantize_pages``): integer code and exact power-of-two scales,
  bitwise JAX's.
* The layer functions against JAX's (run eagerly, so XLA's excess
  precision does not apply; ROADMAP F2): the projections are quantized
  GEMMs (F0) and rope's cos/sin come from each package's own library, so
  a K/V value can land one (1,5,2) code step away: at least ``CODE_FLOOR``
  of the arena codes equal, and the layer output within ``OUT_TOL`` of
  JAX's (the bf16 outputs are O(1); one code step of one K/V value moves
  an output by a small fraction of that).  Measured: every code and every
  output bitwise.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import (
    flash_prefill as jax_fp,
    flash_prefill_reference as jax_fp_ref,
)
from repro.quant.formats import FPFormat as JF
from repro.serve import kvcache as JKV
from repro_torch.kernels.attention import (
    AttnCall,
    flash_prefill,
    flash_prefill_reference,
)
from repro_torch.quant.formats import FPFormat
from repro_torch.serve import kvcache as TKV


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(label, got, want, acc):
    """The attention bound of the module docstring."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    tol = (2.0 ** (1 - acc[1]) * np.abs(want)
           + max(2.0 ** -acc[1], 2.0 ** -16) * scale)
    err = np.abs(got.astype(np.float64) - want)
    print(f"{label} acc(1,{acc[0]},{acc[1]}): mismatch fraction "
          f"{np.mean(got != want):.5f}, max |err| {err.max():.3g}, "
          f"max |err|/tol {np.max(err / np.maximum(tol, 1e-30)):.3f}")
    assert np.all(err <= tol)


def _qkv(rng, s, h, kv, dh, sk=None):
    sk = s if sk is None else sk
    return (rng.randn(s, h, dh).astype(np.float32),
            rng.randn(sk, kv, dh).astype(np.float32),
            rng.randn(sk, kv, dh).astype(np.float32))


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _carry_ok(label, got, want, acc):
    (go, gm, gl), (wo, wm, wl) = got, [np.asarray(w) for w in want]
    np.testing.assert_array_equal(gm.numpy(), wm)
    _close(f"{label} o", go.numpy(), wo, acc)
    _close(f"{label} l", gl.numpy(), wl, acc)


# --------------------------------------------------------------------------
# K10: the plain version against the JAX kernel and reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,h,kv,dh,chunk,acc", [
    (40, 6, 2, 16, 16, (6, 5)),      # GQA g = 3, a ragged last block
    (33, 4, 4, 8, 8, (6, 5)),        # no GQA, chunk 8
    (48, 4, 2, 16, 32, (8, 23)),     # the wide carry
    (21, 4, 1, 16, 16, (6, 9)),      # one KV head
])
def test_flash_prefill_plain_vs_jax(s, h, kv, dh, chunk, acc):
    """One-shot K10 (finalized, and with ``return_carry``) against the JAX
    kernel in interpret mode and its reference."""
    rng = np.random.RandomState(s * h + chunk)
    q, k, v = _qkv(rng, s, h, kv, dh)
    kw = dict(acc=acc, chunk=chunk)
    got = flash_prefill(_t(q), _t(k), _t(v), **kw).numpy()
    want_kernel = np.asarray(jax_fp(*_j(q, k, v), block_q=8, **kw))
    want_ref = np.asarray(jax_fp_ref(*_j(q, k, v), **kw))
    _close("K10 one-shot vs JAX kernel", got, want_kernel, acc)
    _close("K10 one-shot vs JAX reference", got, want_ref, acc)
    _carry_ok("K10 carry", flash_prefill(_t(q), _t(k), _t(v),
                                         return_carry=True, **kw),
              jax_fp_ref(*_j(q, k, v), return_carry=True, **kw), acc)
    np.testing.assert_array_equal(
        _bits(flash_prefill_reference(_t(q), _t(k), _t(v), **kw).numpy()),
        _bits(got))


@pytest.mark.parametrize("split", [0, 16, 32, 64])
def test_flash_prefill_resume_is_bitwise_the_one_shot_walk(split):
    """Carry out over KV [0, split), carry in over [split, Sk): bitwise the
    one-shot walk in o, m, l and the finalized output, at every chunk
    multiple; and within the bound of JAX's resumed walk."""
    rng = np.random.RandomState(split + 1)
    s, h, kv, dh, chunk, acc = 64, 6, 2, 16, 16, (6, 5)
    q, k, v = _qkv(rng, s, h, kv, dh)
    kw = dict(acc=acc, chunk=chunk)
    one = flash_prefill(_t(q), _t(k), _t(v), **kw)
    one_c = flash_prefill(_t(q), _t(k), _t(v), return_carry=True, **kw)
    c = flash_prefill(_t(q), _t(k[:split]), _t(v[:split]), return_carry=True,
                      **kw)
    res = flash_prefill(_t(q), _t(k[split:]), _t(v[split:]), kv_offset=split,
                        carry=c, **kw)
    res_c = flash_prefill(_t(q), _t(k[split:]), _t(v[split:]),
                          kv_offset=split, carry=c, return_carry=True, **kw)
    assert torch.equal(res, one)
    for a, b in zip(res_c, one_c):
        assert torch.equal(a, b)
    jc = jax_fp_ref(*_j(q, k[:split], v[:split]), return_carry=True, **kw)
    jres = jax_fp_ref(*_j(q, k[split:], v[split:]), kv_offset=split,
                      carry=jc, **kw)
    _close(f"K10 resumed at {split}", res.numpy(), np.asarray(jres), acc)
    if split < s:   # the JAX kernel's grid needs a KV block
        jres = jax_fp(*_j(q, k[split:], v[split:]), kv_offset=split,
                      carry=jc, block_q=16, **kw)
        _close(f"K10 resumed at {split} vs JAX kernel", res.numpy(),
               np.asarray(jres), acc)


def test_flash_prefill_offsets_vs_jax():
    """A query slab placed after its history (``q_offset``) attending the
    whole KV, then the same slab resumed over its own KV (``kv_offset`` =
    ``q_offset``): against JAX, and the two-pass walk bitwise the
    single pass."""
    rng = np.random.RandomState(11)
    t0, t, h, kv, dh, chunk, acc = 32, 24, 4, 2, 16, 16, (6, 5)
    q, k, v = _qkv(rng, t, h, kv, dh, sk=t0 + t)
    kw = dict(acc=acc, chunk=chunk, q_offset=t0)
    got = flash_prefill(_t(q), _t(k), _t(v), **kw)
    _close("K10 q_offset", got.numpy(),
           np.asarray(jax_fp(*_j(q, k, v), block_q=8, **kw)), acc)
    c = flash_prefill(_t(q), _t(k[:t0]), _t(v[:t0]), return_carry=True, **kw)
    two = flash_prefill(_t(q), _t(k[t0:]), _t(v[t0:]), kv_offset=t0,
                        carry=c, **kw)
    assert torch.equal(two, got)
    call = AttnCall(e_acc=acc[0], m_acc=acc[1], chunk=chunk, q_offset=t0,
                    kv_offset=t0, block_q=32)
    assert torch.equal(flash_prefill(_t(q), _t(k[t0:]), _t(v[t0:]), carry=c,
                                     call=call), got)


def test_flash_prefill_refuses():
    q, k, v = (torch.zeros(8, 4, 16), torch.zeros(8, 2, 16),
               torch.zeros(8, 2, 16))
    with pytest.raises(ValueError, match="multiple of chunk"):
        flash_prefill(q, k, v, chunk=16, kv_offset=8)
    with pytest.raises(ValueError):
        flash_prefill(q, torch.zeros(8, 3, 16), torch.zeros(8, 3, 16))
    with pytest.raises(ValueError):
        flash_prefill(q, k, v, carry=(torch.zeros(8, 4, 16),
                                      torch.zeros(8, 4), torch.zeros(7, 4)))
    with pytest.raises(ValueError, match="rounding"):
        flash_prefill(q, k, v, rounding="nearest")
    with pytest.raises(ValueError, match="rounding"):
        flash_prefill_reference(q, k, v, rounding="nearest")
    with pytest.raises(NotImplementedError):
        flash_prefill(q, k, v, block_q=12)


# --------------------------------------------------------------------------
# the arena's dequantized views
# --------------------------------------------------------------------------

def test_arena_views_match_jax():
    """``write_prompt``'s returned view, ``gather_pages`` and
    ``dequantize_pages`` against JAX's, bitwise (codes and scales too);
    the views are the values the paged kernels decode."""
    rng = np.random.RandomState(2)
    n_pages, kv, ps, dh, s = 7, 2, 16, 16, 37
    x = (rng.randn(s, kv, dh) * 3).astype(np.float32)
    ids = np.array([5, 2, 6], np.int32)
    arena = np.zeros((n_pages, kv, ps, dh), np.int8)
    se = np.zeros((n_pages,), np.int32)
    ja, jse, jdq = JKV.write_prompt(jnp.asarray(arena), jnp.asarray(se),
                                    jnp.asarray(x), jnp.asarray(ids),
                                    JF(5, 2))
    ta, tse = _t(arena), _t(se)
    tdq = TKV.write_prompt(ta, tse, _t(x), _t(ids), FPFormat(5, 2))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tse.numpy(), np.asarray(jse))
    assert tdq.shape == (s, kv, dh)
    np.testing.assert_array_equal(_bits(tdq.numpy()), _bits(np.asarray(jdq)))
    gid = np.array([2, 6], np.int32)
    jg = JKV.gather_pages(ja, jse, jnp.asarray(gid), JF(5, 2))
    tg = TKV.gather_pages(ta, tse, _t(gid), FPFormat(5, 2))
    np.testing.assert_array_equal(_bits(tg.numpy()), _bits(np.asarray(jg)))
    np.testing.assert_array_equal(_bits(tg[:ps].numpy()),
                                  _bits(tdq[ps:2 * ps].numpy()))
    jd = JKV.dequantize_pages(ja, jse, JF(5, 2))
    td = TKV.dequantize_pages(ta, tse, FPFormat(5, 2))
    np.testing.assert_array_equal(_bits(td.numpy()), _bits(np.asarray(jd)))
    # the gathered view is the page-major view read token-major
    np.testing.assert_array_equal(
        _bits(tg.numpy()),
        _bits(td[gid].transpose(1, 2).reshape(-1, kv, dh).numpy()))


# --------------------------------------------------------------------------
# the layer functions
# --------------------------------------------------------------------------

PAGE = 16
CODE_FLOOR = 0.999
OUT_TOL = 0.0625


def _layer_setup():
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.core.policy import AccumulationPolicy as JPolicy
    from repro.core.policy import plan_for_model as jax_plan
    from repro.models.api import get_model as jax_get_model
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model

    jcfg = jax_plan(jax_smoke("qwen2-1.5b"), seq_len=64, global_batch=1,
                    policy=JPolicy(mode="predicted", chunk=16))
    tcfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=64,
                          global_batch=1,
                          policy=AccumulationPolicy(mode="predicted",
                                                    chunk=16))
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                           jax_get_model(jcfg).init_params(
                               jax.random.PRNGKey(5)))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tp = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    return jcfg, tcfg, jp, tp


def _t_arena(tcfg, n_pages):
    from repro_torch.models.api import paged_init_state

    kv = paged_init_state(tcfg, n_pages=n_pages, page_size=PAGE,
                          device="cpu")
    return {k: v[0].clone() for k, v in kv.items()}


@pytest.mark.parametrize("s,slab", [(45, 32), (64, 16)])
def test_prefill_layers_vs_bucketed_and_jax(s, slab):
    """The port's one-shot ``attn_prefill_paged`` (K10), its
    ``attn_prefill_chunk_paged`` in ``slab``-token slabs (K10, carry out
    then in) and ``attn_prefill_bucketed`` (P) on the same prompt:
    bitwise outputs and arena.  Then against JAX's one-shot and chunked
    layer functions: ``CODE_FLOOR`` and ``OUT_TOL``."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    jcfg, tcfg, jp, tp = _layer_setup()
    rng = np.random.RandomState(s)
    x = torch.from_numpy(rng.randn(1, s, tcfg.d_model).astype(np.float32)
                         ).to(torch.bfloat16)
    fmt, jfmt, acc = FPFormat(5, 2), JF(5, 2), (6, 5)
    npg = -(-s // PAGE)
    pages = torch.arange(1, npg + 1, dtype=torch.int32)
    pos = torch.arange(s)[None]

    kv1 = _t_arena(tcfg, npg + 2)
    y1 = TL.attn_prefill_paged(tp, x, kv1, pages, pos, tcfg, kv_fmt=fmt,
                               acc=acc)
    kv2, ys = _t_arena(tcfg, npg + 2), []
    for a in range(0, s, slab):
        b = min(a + slab, s)
        ys.append(TL.attn_prefill_chunk_paged(
            tp, x[:, a:b], kv2, pages[:a // PAGE],
            pages[a // PAGE:-(-b // PAGE)], a, tcfg, kv_fmt=fmt, acc=acc))
    y2 = torch.cat(ys, 1)
    kv3, ys = _t_arena(tcfg, npg + 2), []
    for a in range(0, s, slab):
        q_len = min(slab, s - a)
        xs = torch.nn.functional.pad(x[:, a:a + q_len],
                                     (0, 0, 0, slab - q_len))
        sp = torch.zeros(-(-slab // PAGE), dtype=torch.int32)
        n = -(-q_len // PAGE)
        sp[:n] = pages[a // PAGE:a // PAGE + n]
        ys.append(TL.attn_prefill_bucketed(
            tp, xs, kv3, pages, sp, a, q_len, tcfg, kv_fmt=fmt,
            acc=acc)[:, :q_len])
    y3 = torch.cat(ys, 1)
    assert torch.equal(y1, y2) and torch.equal(y1, y3)
    for name in kv1:
        assert torch.equal(kv1[name], kv2[name]), name
        assert torch.equal(kv1[name], kv3[name]), name

    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jkv = {k: jnp.asarray(v.numpy()) for k, v in _t_arena(tcfg, npg + 2).items()}
    jy1, jkv1 = JL.attn_prefill_paged(
        jp, jx, jkv, jnp.asarray(pages.numpy()), jnp.asarray(pos.numpy()),
        jcfg, JL.LOCAL, kv_fmt=jfmt, acc=acc, block_q=16)
    jkv2, jys = dict(jkv), []
    for a in range(0, s, slab):
        b = min(a + slab, s)
        jy, jkv2 = JL.attn_prefill_chunk_paged(
            jp, jx[:, a:b], jkv2, jnp.asarray(pages[:a // PAGE].numpy()),
            jnp.asarray(pages[a // PAGE:-(-b // PAGE)].numpy()), a, jcfg,
            JL.LOCAL, kv_fmt=jfmt, acc=acc, block_q=16)
        jys.append(jy)
    jy2 = jnp.concatenate(jys, axis=1)
    want = np.asarray(jy1.astype(jnp.float32))
    np.testing.assert_array_equal(want, np.asarray(jy2.astype(jnp.float32)))
    eq = tot = 0
    for name in kv1:
        np.testing.assert_array_equal(np.asarray(jkv1[name]),
                                      np.asarray(jkv2[name]))
        eq += int(np.sum(kv1[name].numpy() == np.asarray(jkv1[name])))
        tot += kv1[name].numel()
    err = float(np.max(np.abs(y1.float().numpy() - want)))
    print(f"S={s}: arena codes equal {eq / tot:.5f}, max |y - y_jax| "
          f"{err:.4g} (max |y| {np.abs(want).max():.3g}), outputs equal "
          f"{np.mean(y1.float().numpy() == want):.5f}")
    assert eq / tot >= CODE_FLOOR
    assert err <= OUT_TOL


def test_chunk_paged_refuses_an_unaligned_slab():
    from repro_torch.models import layers as TL

    _, tcfg, _, tp = _layer_setup()
    kv = _t_arena(tcfg, 4)
    x = torch.zeros((1, 8, tcfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="page-aligned"):
        TL.attn_prefill_chunk_paged(tp, x, kv, torch.tensor([1]),
                                    torch.tensor([2]), 8, tcfg,
                                    kv_fmt=FPFormat(5, 2), acc=(6, 5))
