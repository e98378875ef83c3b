"""The port's Hopper kernels against their plain PyTorch versions on the
card.  Marked ``gpu``: each test skips without a CUDA device (decided
inside the test).  Run on a machine with one:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The kernels sum in the plain versions' order (the GEMM's products are
exact), so agreement is expected bit for bit; the checks allow one ulp of
the carry format (a transcendental's last bit may differ between the
kernel's exp2f and PyTorch's), and demand bitwise on lattice operands.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import (
    flash_prefill_paged,
    flash_prefill_paged_reference,
    paged_attn_decode,
    paged_attn_decode_reference,
)
from repro_torch.kernels.common import quantize_block
from repro_torch.kernels.fused import qmatmul_fused, qmatmul_fused_reference
from repro_torch.quant.formats import FP8_152
from repro_torch.quant.qtensor import pack_block

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulps(got, want, m, e):
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs())
    ex = torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag))))
    ulp = torch.exp2(torch.clamp(ex, min=-(2 ** (e - 1) - 1)) - m)
    return float(((got - want).abs() / ulp).max())


def _lattice(gen, shape, dev):
    e = torch.randint(-2, 3, shape, generator=gen, device=dev)
    j = torch.randint(0, 4, shape, generator=gen, device=dev)
    s = torch.randint(0, 2, shape, generator=gen, device=dev) * 2 - 1
    return (s * torch.exp2(e.float()) * (1 + j / 4)).float()


@pytest.mark.parametrize("m,k,n,chunk,rf,acc,b_bf16,b_t", [
    (37, 200, 75, 64, True, (6, 5), False, False),
    (8, 1536, 256, 64, True, (6, 5), True, False),
    (64, 2048, 1536, 64, True, (6, 5), True, False),
    (8, 1536, 4000, 64, False, (6, 9), True, True),   # tied-head view
    (3, 100, 70, 16, True, (8, 23), False, True),
])
def test_gemm_kernel_matches_plain(dev, m, k, n, chunk, rf, acc, b_bf16, b_t):
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    kw = dict(repr_fmt=FP8_152 if rf else None, e_acc=acc[0], m_acc=acc[1],
              block_k=chunk)
    a = torch.randn((m, k), generator=gen, device=dev)
    b = torch.randn((n, k) if b_t else (k, n), generator=gen,
                    device=dev) / math.sqrt(k)
    b = b.to(torch.bfloat16) if b_bf16 else b
    b = b.T if b_t else b
    got = qmatmul_fused(a, b, **kw)
    want = qmatmul_fused_reference(a, b, **kw)
    torch.cuda.synchronize()
    assert _ulps(got, want, acc[1], acc[0]) <= 1.0
    al, bl = _lattice(gen, (m, k), dev), _lattice(gen, (k, n), dev)
    torch.testing.assert_close(qmatmul_fused(al, bl, **kw),
                               qmatmul_fused_reference(al, bl, **kw),
                               rtol=0, atol=0)


def _arena(gen, dev, n_pages, kv, ps, dh):
    def codes():
        x = torch.randn((n_pages, kv, ps, dh), generator=gen, device=dev)
        return pack_block(quantize_block(x, 5, 2), 5, 2)

    se = lambda: torch.randint(-2, 3, (n_pages,), generator=gen, device=dev,
                               dtype=torch.int32)
    return codes(), codes(), se(), se()


def _attn_ok(got, want, acc):
    tol = (2.0 ** (1 - acc[1]) * want.abs()
           + 2.0 ** -acc[1] * want.abs().max())
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= tol).all())


def _decode_case(gen, dev, lens, width, kv, dh, ps=16):
    """An arena holding the rows' pages in a random order, the page table
    (padded with the null page 0 to ``width``) and the lengths."""
    n_pages = 1 + sum(-(-s // ps) for s in lens)
    kc, vc, kse, vse = _arena(gen, dev, n_pages, kv, ps, dh)
    pt = torch.zeros((len(lens), width), dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    used = 0
    for b, s in enumerate(lens):
        np_ = -(-s // ps)
        pt[b, :np_] = perm[used:used + np_].to(torch.int32)
        used += np_
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return kc, vc, kse, vse, pt, sl


SERVE_LENS = [0, 17, 64, 100, 129, 256, 311, 384]


# (h, kv, dh, acc, lengths, page-table width, the cluster the schedule
# picks[, page size]): the serve arena (B 8), narrow heads, every cluster
# size the schedule can pick (by width, and by batch), the monitor's B 1,
# a 4096-token row (256 pages: 8 blocks of 6 pages a round, 6 rounds),
# and a head width that is not a multiple of 4 with pages of 5 tokens (30
# bytes a page slice: codes staged a byte a thread)
DECODE_CASES = [
    (12, 2, 128, (6, 5), SERVE_LENS, 24, 8),
    (4, 2, 16, (8, 23), SERVE_LENS, 24, 8),
    (12, 2, 128, (6, 5), [0, 5, 16, 33, 48, 64, 70, 80], 5, 4),
    (12, 2, 128, (6, 5), [0, 5, 16, 33, 48, 9, 40, 30], 3, 2),
    (12, 2, 128, (6, 5), [0, 1, 16, 9, 15, 3, 12, 7], 1, 1),
    (12, 2, 128, (6, 5), (SERVE_LENS * 2)[1:], 26, 4),       # B 15
    (12, 2, 128, (6, 5), (SERVE_LENS * 5)[:33], 26, 2),      # B 33
    (12, 2, 128, (6, 5), (SERVE_LENS * 5)[:40], 26, 1),      # B 40
    (12, 2, 128, (6, 5), [300], 26, 8),                       # the monitor's
    (12, 2, 128, (6, 5), [4096, 0, 1000], 256, 8),
    (6, 3, 6, (6, 5), [0, 13, 40, 3], 9, 8, 5),
]


@pytest.mark.parametrize("h,kv,dh,acc,lens,width,cluster,ps",
                         [c + (16,) * (len(c) == 7) for c in DECODE_CASES])
def test_decode_kernel_matches_plain(dev, h, kv, dh, acc, lens, width,
                                     cluster, ps):
    """D bitwise its plain version on random and on lattice q (the split
    walk keeps every bit on any operands), at the schedule's cluster; one
    launch a call; two launches equal; a length-0 row exactly 0."""
    from repro_torch.kernels import sm90

    assert sm90.attn_decode_schedule(len(lens), kv, width, h // kv, ps,
                                     dh).cluster == cluster
    gen = torch.Generator(device=dev).manual_seed(h * dh + width + len(lens))
    args = _decode_case(gen, dev, lens, width, kv, dh, ps)
    for q in (torch.randn((len(lens), h, dh), generator=gen, device=dev),
              _lattice(gen, (len(lens), h, dh), dev)):
        n0, s0 = paged_attn_decode.launches, paged_attn_decode.stats_launches
        got = paged_attn_decode(q, *args, kv_fmt=FP8_152, acc=acc)
        again = paged_attn_decode(q, *args, kv_fmt=FP8_152, acc=acc)
        want = paged_attn_decode_reference(q, *args, kv_fmt=FP8_152, acc=acc)
        torch.cuda.synchronize()
        assert paged_attn_decode.launches == n0 + 2
        assert paged_attn_decode.stats_launches == s0
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, want)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        for b, s in enumerate(lens):
            if s == 0:
                assert bool((got[b] == 0).all())


def test_decode_entries_match_their_mirrors(dev):
    """The kernel's shared memory equals ``sm90.attn_decode_smem`` at every
    head shape and schedule; at the serve arena's schedule (the 1024-token
    bucket's 64 pages) all 16 clusters of D and of K12 fit the card at
    once, and the 4096-token row's fit."""
    import ctypes

    from repro_torch.kernels import build, sm90

    smem = build.function("paged_decode", "paged_decode_smem",
                          [ctypes.c_int] * 5)
    clusters = build.function("paged_decode", "paged_decode_clusters",
                              [ctypes.c_int] * 6)
    for g, ps, dh in ((6, 16, 128), (2, 16, 16), (8, 32, 128), (3, 5, 7)):
        for cl in range(1, 9):
            for r in (1, 3, 8):
                assert smem(g, ps, dh, cl, r) == sm90.attn_decode_smem(
                    g, ps, dh, cl, r)
    for b, width in ((8, 64), (1, 256)):
        s = sm90.attn_decode_schedule(b, 2, width, 6, 16, 128)
        for stats in (0, 1):
            n = clusters(stats, 6, 16, 128, s.cluster, s.rank_pages)
            assert n >= 2 * b, (b, width, stats, n)


# (T, q_offset, q_len, start_page[, h, kv, dh, page size]) and the
# (rows, cluster) the schedule picks: the serve slab (cluster 8), rows not
# a multiple of the tile and ending mid-page (cluster 2), start_page > 0,
# T = 1 (one row a tile; no cluster, and cluster 8 over a 383-token
# history), a one-shot 64-token prompt (cluster 4), a 128-page history,
# a 2048-token one-shot prompt (no cluster: 512 tiles), and a head width
# and page size other than the serve ones (dh 7: codes loaded a byte at a
# time; 5-token pages)
PREFILL_CASES = [
    ((64, 320, 64, 0), (8, 8)),
    ((24, 16, 21, 0), (2, 2)),
    ((16, 48, 16, 2), (1, 2)),
    ((1, 0, 1, 0), (1, 1)),
    ((1, 383, 1, 0), (1, 8)),
    ((64, 0, 64, 0), (4, 4)),
    ((64, 1984, 64, 0), (8, 8)),
    ((2048, 0, 2048, 0), (8, 1)),
    ((37, 5, 30, 1, 6, 3, 7, 5), (8, 4)),
]


@pytest.mark.parametrize("case,sched", PREFILL_CASES)
def test_prefill_kernel_matches_plain(dev, case, sched):
    """P bitwise its plain version on random and on lattice q (the split
    walk keeps every bit on any operands) at the schedule's tile and
    cluster; padded rows exactly 0; one launch a call; two launches equal."""
    from repro_torch.kernels import sm90

    t, q_off, q_len, start_page, h, kv, dh, ps = case + (12, 2, 128, 16)[
        len(case) - 4:]
    kv_len = q_off + q_len
    got_s = sm90.attn_prefill_schedule(
        t, kv, h // kv, ps, dh,
        sm90.prefill_pages(ps, q_off, q_len, 0, kv_len, start_page))
    assert (got_s.rows, got_s.cluster) == sched
    gen = torch.Generator(device=dev).manual_seed(t + q_off)
    acc = (6, 5)
    n_used = -(-kv_len // ps)
    kc, vc, kse, vse = _arena(gen, dev, n_used + 1, kv, ps, dh)
    row = torch.zeros((n_used + 3,), dtype=torch.int32, device=dev)
    row[:n_used] = torch.randperm(n_used, generator=gen, device=dev) + 1
    args = (kc, vc, kse, vse, row, q_off, q_len, kv_len)
    kw = dict(kv_fmt=FP8_152, acc=acc, start_page=start_page)
    for q in (torch.randn((t, h, dh), generator=gen, device=dev),
              _lattice(gen, (t, h, dh), dev)):
        n0 = flash_prefill_paged.launches
        got = flash_prefill_paged(q, *args, **kw)
        again = flash_prefill_paged(q, *args, **kw)
        want = flash_prefill_paged_reference(q, *args, **kw)
        torch.cuda.synchronize()
        assert flash_prefill_paged.launches == n0 + 2
        assert bool(torch.isfinite(got).all())
        assert bool((got[q_len:] == 0).all())
        assert torch.equal(got, want)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_prefill_entries_match_their_mirrors(dev):
    """P's and K10's shared memory equals ``sm90.attn_prefill_smem`` at
    every head shape and schedule; at the serve shapes' schedules two
    blocks fit an SM (K10 under RNE and under SR)."""
    import ctypes

    from repro_torch.kernels import build, sm90

    for lib in ("paged_prefill", "flash_prefill"):
        smem = build.function(lib, f"{lib}_smem", [ctypes.c_int] * 6)
        occs = [build.function(lib, f"{e}_occupancy", [ctypes.c_int] * 6)
                for e in ((lib, f"{lib}_sr") if lib == "flash_prefill"
                          else (lib,))]
        for g, ps, dh in ((6, 16, 128), (2, 16, 16), (8, 32, 128), (3, 5, 7),
                          (6, 128, 128), (6, 100, 64)):
            for br in (1, 8):
                for cl in (1, 2, 8):
                    for r in (1, 3, 8):
                        assert smem(g, br, ps, dh, cl, r) == \
                            sm90.attn_prefill_smem(g, br, ps, dh, cl, r)
        for t, ps, n_pages in ((64, 16, 24), (384, 16, 24), (2048, 16, 128),
                               (512, 64, 8), (512, 128, 4)):
            s = sm90.attn_prefill_schedule(t, 2, 6, ps, 128, n_pages)
            for occ in occs:
                n = occ(6, s.rows, ps, 128, s.cluster, s.rank_pages)
                assert n >= 2, (lib, t, ps, s, n)


def test_wrappers_raise_instead_of_falling_back(dev):
    a = torch.randn((4, 8), device=dev)
    with pytest.raises(ValueError):
        qmatmul_fused(a, torch.randn((8, 4)))          # mixed devices
    pages = torch.zeros((3, 2, 16, 256), dtype=torch.int8, device=dev)
    se = torch.zeros((3,), dtype=torch.int32, device=dev)
    q = torch.zeros((1, 4, 256), device=dev)
    pt = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):           # dh beyond the tile
        paged_attn_decode(q, pages, pages, se, se, pt, se[:1],
                          kv_fmt=FP8_152, acc=(6, 5))


def test_smoke_engine_on_gpu_matches_cpu(dev):
    """The whole smoke slice through the kernels on the card vs the plain
    versions on the CPU: the same token streams."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.models.api import get_model
    from repro_torch.serve.scheduler import ServeEngine

    cfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=56,
                         global_batch=3,
                         policy=AccumulationPolicy(mode="predicted", chunk=16))
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")

    def bf16(t):
        return ({k: bf16(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to(torch.bfloat16))

    params = bf16(params)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (16, 21, 48)]

    def run(device, p):
        eng = ServeEngine(model, p, n_pages=10, page_size=16, max_batch=4,
                          device=device)
        rids = [eng.submit(x, 8) for x in prompts]
        out = eng.run()
        return [out[r] for r in rids]

    def to(t, d):
        return ({k: to(v, d) for k, v in t.items()} if isinstance(t, dict)
                else t.to(d))

    assert run(dev, to(params, dev)) == run("cpu", params)


# --------------------------------------------------------------------------
# training: E (forward + codes), B (backward pair) and pack_code
# --------------------------------------------------------------------------


def test_pack_code_matches_pack_block(dev):
    """E's codes are pack_code(quantize(a)): every one of the 256 codes (as
    its value), and specials: +-0, +-inf and overflow (saturate), NaN
    (packs to signed zero), values below the smallest normal (flush)."""
    from repro_torch.quant.qtensor import unpack_block

    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    vals = unpack_block(codes, 5, 2)
    specials = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                             float("nan"), 1e9, -1e9, 3e-5, -3e-5, 1e-40,
                             57344.0, 65535.0, 2.0 ** -15, 0.1])
    a = torch.cat([vals, specials])[None].to(dev)
    b = torch.zeros((a.shape[1], 1), device=dev)
    _, aq, _ = qmatmul_fused(a, b, repr_fmt=FP8_152, e_acc=6, m_acc=5,
                             block_k=64, return_quantized=True)
    want = pack_block(quantize_block(a.cpu(), 5, 2), 5, 2)
    torch.cuda.synchronize()
    assert torch.equal(aq.cpu(), want)
    # a code with a nonzero exponent field comes back as itself (field 0 is
    # +-0 whatever the mantissa, and packs as the bare sign)
    live = ((codes.to(torch.int32) >> 2) & 31) != 0
    assert torch.equal(aq.cpu()[0, :256][live], codes[live])


@pytest.mark.parametrize("t,k,n,w_bf16", [
    (512, 1536, 256, True), (64, 200, 75, False), (8, 96, 130, True)])
def test_emitq_kernel_matches_plain(dev, t, k, n, w_bf16):
    gen = torch.Generator(device=dev).manual_seed(t + k + n)
    kw = dict(repr_fmt=FP8_152, e_acc=6, m_acc=5, block_k=64)
    for lattice in (False, True):
        a = (_lattice(gen, (t, k), dev) if lattice
             else torch.randn((t, k), generator=gen, device=dev))
        b = (_lattice(gen, (k, n), dev) if lattice
             else torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k))
        b = b.to(torch.bfloat16) if w_bf16 else b
        n0 = qmatmul_fused.emitq_launches
        got = qmatmul_fused(a, b, return_quantized=True, **kw)
        want = qmatmul_fused_reference(a, b, return_quantized=True, **kw)
        torch.cuda.synchronize()
        assert qmatmul_fused.emitq_launches == n0 + 1
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        if lattice:
            assert torch.equal(got[0], want[0])
        else:
            assert _ulps(got[0], want[0], 5, 6) <= 1.0


@pytest.mark.parametrize("t,k,n,packed", [
    (512, 1536, 256, True), (96, 130, 200, True), (64, 1536, 1000, False)])
def test_bwd_pair_kernel_matches_plain(dev, t, k, n, packed):
    """B against its plain version, packed residuals and the raw lm_head
    (f32 x, bf16 w behind the embed.T view); the chained dx carry (K7)
    bitwise the unsplit call."""
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_reference)

    gen = torch.Generator(device=dev).manual_seed(t * 3 + n)
    acc = (6, 5) if packed else (6, 9)
    rf = FP8_152 if packed else None
    kw = dict(repr_fmt=rf, bwd_acc=acc, grad_acc=acc, bwd_chunk=64,
              grad_chunk=64, packed=packed, quantize_g=packed)
    for lattice in (False, True):
        mk = (lambda s: _lattice(gen, s, dev)) if lattice else (
            lambda s: torch.randn(s, generator=gen, device=dev))
        g, x = mk((t, n)), mk((t, k))
        if packed:
            _, xq, wq = qmatmul_fused(x, mk((k, n)) / 8, repr_fmt=FP8_152,
                                      return_quantized=True)
        else:
            xq, wq = x, (mk((n, k)) / 8).to(torch.bfloat16).T
        got = qmatmul_bwd_pair(g, xq, wq, **kw)
        want = qmatmul_bwd_pair_reference(g, xq, wq, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if lattice:
                assert torch.equal(a, b)
            else:
                assert _ulps(a, b, acc[1], acc[0]) <= 1.0
        cut = 64 * (n // 128)
        n0 = qmatmul_bwd_pair.launches
        c0 = qmatmul_bwd_pair.carry_launches
        dx0, dw0 = qmatmul_bwd_pair(g[:, :cut], xq, wq[:, :cut], **kw)
        dx1, dw1 = qmatmul_bwd_pair(g[:, cut:], xq, wq[:, cut:],
                                    dx_carry=dx0, **kw)
        torch.cuda.synchronize()
        assert qmatmul_bwd_pair.launches == n0 + 1
        assert qmatmul_bwd_pair.carry_launches == c0 + 1
        assert torch.equal(dx1, got[0])
        assert torch.equal(torch.cat([dw0, dw1], 1), got[1])


def test_train_step_kernels_match_plain(dev):
    """One training step of the smoke model on the card, through the
    kernels and then through their plain versions (``chip_smoke``'s
    ``plain_versions``): bitwise loss and gradients."""
    from chip_smoke import plain_versions
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import _grads, compute_copy
    from repro_torch.train.optimizer import tree_leaves

    cfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=32,
                         global_batch=4,
                         policy=AccumulationPolicy(mode="predicted", chunk=16))
    model = get_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)).to(dev)

    def step():
        c = compute_copy(params)
        loss, _ = model.loss_fn(c, {"tokens": tokens}, cfg)
        loss.backward()
        return loss.detach(), _grads(c, params)

    lk, gk = step()
    with plain_versions():
        lp, gp = step()
    torch.cuda.synchronize()
    assert torch.equal(lk, lp)
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        assert torch.equal(a, b)


def test_sr_train_step_kernels_match_plain(dev):
    """``test_train_step_kernels_match_plain`` under ``--rounding sr``: E
    and B run their SR carries (counted on ``sr_emitq_launches`` and
    ``sr_launches``), the lm_head stays RNE; bitwise the plain versions."""
    from chip_smoke import plain_versions
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
    from repro_torch.models.api import get_model
    from repro_torch.models.lm import layer_forwards
    from repro_torch.train.loop import _grads, compute_copy
    from repro_torch.train.optimizer import tree_leaves

    cfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=32,
                         global_batch=4,
                         policy=AccumulationPolicy(mode="predicted", chunk=16,
                                                   rounding="sr", sr_seed=7))
    model = get_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)).to(dev)

    def step():
        c = compute_copy(params)
        loss, _ = model.loss_fn(c, {"tokens": tokens}, cfg)
        loss.backward()
        return loss.detach(), _grads(c, params)

    e0, b0 = qmatmul_fused.sr_emitq_launches, qmatmul_bwd_pair.sr_launches
    r0 = qmatmul_fused.emitq_launches
    lk, gk = step()
    torch.cuda.synchronize()
    n_gemms = 7 * cfg.n_layers
    # E once a forward pass: twice under the default remat (the backward
    # recomputes each layer), once under REPRO_REMAT_POLICY=none
    assert qmatmul_fused.sr_emitq_launches == e0 + n_gemms * layer_forwards(
        cfg)
    assert qmatmul_bwd_pair.sr_launches == b0 + n_gemms
    assert qmatmul_fused.emitq_launches == r0
    with plain_versions():
        lp, gp = step()
    torch.cuda.synchronize()
    assert torch.equal(lk, lp)
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# telemetry: the stats variants K8 (GEMM), K9 (backward pair), K12 (decode)
# --------------------------------------------------------------------------


def _stats_ok(got, want):
    """Counters and MAX_ABS bitwise; sum slots within the stated bound
    (``kernels.common``'s SUM_REL / SUM_ABS)."""
    from repro_torch.kernels.common import stats_gap

    exact, ratio = stats_gap(got, want)
    assert exact, (got, want)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("m,k,n,kind", [
    (37, 200, 75, "f32"), (512, 1536, 256, "bf16"), (96, 130, 200, "int8"),
    (64, 1536, 1000, "head"), (40, 300, 24, "prequantized_b")])
def test_gemm_stats_kernel_matches_plain_and_g(dev, m, k, n, kind):
    """K8: C bitwise its plain version's and the stats-off kernel's (G, or
    E's y for int8-code operands); the row's counters and MAX_ABS bitwise,
    its sums within the bound; two launches give the same row."""
    from repro_torch.kernels.fused import qmatmul_fused_stats_reference

    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    acc = (6, 9) if kind == "head" else (6, 5)
    kw = dict(repr_fmt=None if kind == "head" else FP8_152, e_acc=acc[0],
              m_acc=acc[1], block_k=64)
    for lattice in (False, True):
        mk = (lambda s: _lattice(gen, s, dev)) if lattice else (
            lambda s: torch.randn(s, generator=gen, device=dev))
        a, b = mk((m, k)), mk((k, n)) / math.sqrt(k)
        extra = {}
        if kind in ("bf16", "head"):
            b = b.to(torch.bfloat16)
        if kind == "head":
            b = b.T.contiguous().T          # the embed.T view's strides
        if kind == "int8":
            base, a, b = qmatmul_fused(a, b, return_quantized=True, **kw)
            extra = dict(a_packed=True, b_packed=True)
        elif kind == "prequantized_b":
            b = quantize_block(b, 5, 2)
            extra = dict(quantize_b=False)
            base = qmatmul_fused(a, b, **kw)    # Q(Q(b)) = Q(b)
        else:
            base = qmatmul_fused(a, b, **kw)
        n0 = qmatmul_fused.stats_launches
        c, row = qmatmul_fused(a, b, collect_stats=True, **kw, **extra)
        c2, row2 = qmatmul_fused(a, b, collect_stats=True, **kw, **extra)
        pc, prow = qmatmul_fused_stats_reference(a, b, **kw, **extra)
        torch.cuda.synchronize()
        assert qmatmul_fused.stats_launches == n0 + 2
        assert torch.equal(c, base) and torch.equal(c, pc)
        assert torch.equal(row, row2) and torch.equal(c, c2)
        assert float(row[0]) == m * n
        _stats_ok(row, prow)


@pytest.mark.parametrize("t,k,n,packed", [
    (512, 1536, 256, True), (96, 130, 200, True), (64, 1536, 1000, False)])
def test_bwd_pair_stats_kernel_matches_plain_and_b(dev, t, k, n, packed):
    """K9: dx and dw bitwise B's and the plain version's; both rows'
    counters and MAX_ABS bitwise, sums within the bound; deterministic."""
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_stats_reference)

    gen = torch.Generator(device=dev).manual_seed(t * 5 + n)
    acc = (6, 5) if packed else (6, 9)
    kw = dict(repr_fmt=FP8_152 if packed else None, bwd_acc=acc,
              grad_acc=acc, bwd_chunk=64, grad_chunk=64, packed=packed,
              quantize_g=packed)
    for lattice in (False, True):
        mk = (lambda s: _lattice(gen, s, dev)) if lattice else (
            lambda s: torch.randn(s, generator=gen, device=dev))
        g, x = mk((t, n)), mk((t, k))
        if packed:
            _, xq, wq = qmatmul_fused(x, mk((k, n)) / 8, repr_fmt=FP8_152,
                                      return_quantized=True)
        else:
            xq, wq = x, (mk((n, k)) / 8).to(torch.bfloat16).T
        n0 = qmatmul_bwd_pair.stats_launches
        dx, dw, rows = qmatmul_bwd_pair(g, xq, wq, collect_stats=True, **kw)
        _, _, rows2 = qmatmul_bwd_pair(g, xq, wq, collect_stats=True, **kw)
        bdx, bdw = qmatmul_bwd_pair(g, xq, wq, **kw)
        pdx, pdw, prows = qmatmul_bwd_pair_stats_reference(g, xq, wq, **kw)
        torch.cuda.synchronize()
        assert qmatmul_bwd_pair.stats_launches == n0 + 2
        assert torch.equal(dx, bdx) and torch.equal(dw, bdw)
        assert torch.equal(dx, pdx) and torch.equal(dw, pdw)
        assert torch.equal(rows, rows2)
        assert rows.shape == (2, 10)
        assert float(rows[0, 0]) == t * k and float(rows[1, 0]) == k * n
        _stats_ok(rows, prows)


@pytest.mark.parametrize("lens,width,seed", [
    ([384, 0, 17, 64, 100, 129, 256, 311], 32, 7),  # the serve arena
    ([300], 26, 33),                                # the monitor's B 1
    ([4096], 256, 263),                             # 6 rounds of 48 pages
])
def test_decode_stats_kernel_matches_plain_and_d(dev, lens, width, seed):
    """K12 on a page table wider than the pages in use (the kernel stops at
    each sequence's last page, the plain version walks every column as the
    TPU kernel does): o bitwise D's and the plain version's, the row's
    counters and MAX_ABS bitwise, sums within the bound; deterministic;
    one count a call on ``stats_launches`` (each call is two launches:
    the kernel and the pass that sums its partial rows)."""
    from repro_torch.kernels.attention import paged_attn_decode_stats_reference

    h, kv, dh, acc = 12, 2, 128, (6, 5)
    gen = torch.Generator(device=dev).manual_seed(seed)
    args = _decode_case(gen, dev, lens, width, kv, dh)
    kw = dict(kv_fmt=FP8_152, acc=acc)
    for q in (torch.randn((len(lens), h, dh), generator=gen, device=dev),
              _lattice(gen, (len(lens), h, dh), dev)):
        n0 = paged_attn_decode.stats_launches
        d0 = paged_attn_decode.launches
        o, row = paged_attn_decode(q, *args, collect_stats=True, **kw)
        o2, row2 = paged_attn_decode(q, *args, collect_stats=True, **kw)
        assert paged_attn_decode.launches == d0
        d = paged_attn_decode(q, *args, **kw)
        po, prow = paged_attn_decode_stats_reference(q, *args, **kw)
        torch.cuda.synchronize()
        assert paged_attn_decode.stats_launches == n0 + 2
        assert torch.equal(o, d) and torch.equal(o, po)
        assert torch.equal(row, row2) and torch.equal(o, o2)
        assert float(row[0]) == sum(s > 0 for s in lens) * h * dh
        _stats_ok(row, prow)


def test_stats_wrappers_raise_on_the_card(dev):
    a = torch.randn((8, 16), device=dev)
    with pytest.raises(ValueError):     # stats and residual emission
        qmatmul_fused(a, torch.randn((16, 4), device=dev), repr_fmt=FP8_152,
                      collect_stats=True, return_quantized=True)
    with pytest.raises(ValueError):     # not a rounding mode
        qmatmul_fused(a, torch.randn((16, 4), device=dev), repr_fmt=FP8_152,
                      collect_stats=True, rounding="nearest")
    codes = torch.zeros((8, 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):     # residuals of packed operands
        qmatmul_fused(codes, codes.T.contiguous(), repr_fmt=FP8_152,
                      a_packed=True, b_packed=True, return_quantized=True)
    with pytest.raises(ValueError):     # pack_out without out_fmt
        qmatmul_fused(a, torch.randn((16, 4), device=dev), repr_fmt=FP8_152,
                      pack_out=True)
    # G takes int8 codes and per-operand quantization (once K8's alone)
    c = qmatmul_fused(codes, codes.T.contiguous(), repr_fmt=FP8_152,
                      a_packed=True, b_packed=True)
    b = torch.randn((16, 4), device=dev)
    torch.testing.assert_close(
        qmatmul_fused(a, b, repr_fmt=FP8_152, quantize_b=False),
        qmatmul_fused_reference(a.cpu(), b.cpu(), repr_fmt=FP8_152,
                                quantize_b=False).to(dev), rtol=0, atol=0)
    assert torch.equal(c, torch.zeros_like(c))


# --------------------------------------------------------------------------
# the Hopper tile of E, K8, B and K9 (csrc/qgemm_sm90.cuh): every schedule it can
# pick, reached through the shapes that select it
# --------------------------------------------------------------------------


def _operand(gen, shape, dev, lattice):
    return (_lattice(gen, shape, dev) if lattice
            else torch.randn(shape, generator=gen, device=dev))


def _codes(v):
    return pack_block(quantize_block(v, 5, 2), 5, 2)


@pytest.mark.parametrize("t,k,n,chunk,kind,groups", [
    (40, 70, 50, 64, "int8", 1),      # K < chunk in both roles; ragged
    (100, 130, 150, 64, "int8", 2),   # 3 and 2 chunks; pitches off 16 bytes
    (96, 80, 520, 64, "int8", 4),     # 9 chunks, N not a chunk multiple
    (64, 96, 200, 24, "int8", 4),     # chunk 24 cuts the codes' 16-byte pieces
    (70, 96, 300, 100, "f32", 2),     # raw f32, x a transposed view, chunk 100
    (48, 64, 1000, 64, "head", 4),    # f32 x, bf16 w behind the embed.T view
    (33, 40, 260, 32, "bf16", 4),     # bf16 x and w
])
def test_sm90_bwd_pair_schedules_match_plain(dev, t, k, n, chunk, kind,
                                            groups):
    """B on the Hopper tile at each chunk-group count, operand kind and
    layout: dx and dw bitwise the plain version on random and lattice
    operands, and a dx_carry chain of two chunk-aligned N segments (K7)
    bitwise the unsplit call."""
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_reference)
    from repro_torch.kernels.sm90 import pair_schedule

    kinds = {"int8": (2, 2), "f32": (0, 0), "head": (0, 1), "bf16": (1, 1)}
    assert pair_schedule(t, k, n, chunk, chunk, *kinds[kind],
                         int(kind != "head")).groups == groups
    gen = torch.Generator(device=dev).manual_seed(t + 7 * k + n)
    packed = kind == "int8"
    rf = None if kind == "head" else FP8_152
    acc = (6, 9) if kind == "head" else (6, 5)
    kw = dict(repr_fmt=rf, bwd_acc=acc, grad_acc=(6, 7), bwd_chunk=chunk,
              grad_chunk=chunk, packed=packed, quantize_g=rf is not None)
    for lattice in (False, True):
        g = _operand(gen, (t, n), dev, lattice)
        x = _operand(gen, (t, k), dev, lattice)
        w = _operand(gen, (k, n), dev, lattice) / 8
        if kind == "int8":
            x, w = _codes(x), _codes(w)
        elif kind == "f32":
            x = x.T.contiguous().T
        elif kind == "head":
            w = w.to(torch.bfloat16).T.contiguous().T
        else:
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        n0 = qmatmul_bwd_pair.launches
        got = qmatmul_bwd_pair(g, x, w, **kw)
        want = qmatmul_bwd_pair_reference(g, x, w, **kw)
        torch.cuda.synchronize()
        assert qmatmul_bwd_pair.launches == n0 + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        cut = chunk * max(1, n // chunk // 2)
        if cut >= n:                    # one chunk of N: nothing to chain
            continue
        c0 = qmatmul_bwd_pair.carry_launches
        dx0, dw0 = qmatmul_bwd_pair(g[:, :cut], x, w[:, :cut], **kw)
        dx1, dw1 = qmatmul_bwd_pair(g[:, cut:], x, w[:, cut:], dx_carry=dx0,
                                    **kw)
        torch.cuda.synchronize()
        assert qmatmul_bwd_pair.carry_launches == c0 + 1
        assert torch.equal(dx1, got[0])
        assert torch.equal(torch.cat([dw0, dw1], 1), got[1])


@pytest.mark.parametrize("m,k,n,chunk,kind,groups", [
    (37, 48, 80, 64, "f32", 1),       # K < chunk
    (70, 150, 130, 64, "bf16", 2),    # 3 chunks; pitches off 16 bytes
    (100, 608, 96, 64, "int8", 4),    # int8 codes, K not a chunk multiple
    (64, 304, 200, 48, "head", 4),    # f32 x, bf16 embed.T view, chunk 48
    (48, 200, 70, 40, "a_view", 4),   # A a transposed view (GRAD's x.T)
])
def test_sm90_gemm_stats_schedules_match_plain(dev, m, k, n, chunk, kind,
                                              groups):
    """K8 on the Hopper tile at each chunk-group count, operand kind and
    layout: C bitwise the plain version's, the row's counters and MAX_ABS
    bitwise and its sums within the bound, two launches identical."""
    from repro_torch.kernels.fused import qmatmul_fused_stats_reference
    from repro_torch.kernels.sm90 import gemm_schedule

    kinds = {"f32": (0, 0), "bf16": (0, 1), "int8": (2, 2), "head": (0, 1),
             "a_view": (0, 0)}
    assert gemm_schedule(m, n, k, chunk, *kinds[kind]).groups == groups
    gen = torch.Generator(device=dev).manual_seed(m + 3 * k + n)
    acc = (6, 9) if kind == "head" else (6, 5)
    kw = dict(repr_fmt=None if kind == "head" else FP8_152, e_acc=acc[0],
              m_acc=acc[1], block_k=chunk)
    for lattice in (False, True):
        a = _operand(gen, (m, k), dev, lattice)
        b = _operand(gen, (k, n), dev, lattice) / math.sqrt(k)
        extra = {}
        if kind == "bf16":
            b = b.to(torch.bfloat16)
        elif kind == "head":
            b = b.to(torch.bfloat16).T.contiguous().T
        elif kind == "int8":
            a, b = _codes(a), _codes(b)
            extra = dict(a_packed=True, b_packed=True)
        elif kind == "a_view":
            a = a.T.contiguous().T
            extra = dict(quantize_a=False)
        n0 = qmatmul_fused.stats_launches
        c, row = qmatmul_fused(a, b, collect_stats=True, **kw, **extra)
        c2, row2 = qmatmul_fused(a, b, collect_stats=True, **kw, **extra)
        pc, prow = qmatmul_fused_stats_reference(a, b, **kw, **extra)
        torch.cuda.synchronize()
        assert qmatmul_fused.stats_launches == n0 + 2
        assert torch.equal(c, pc)
        assert torch.equal(c, c2) and torch.equal(row, row2)
        assert float(row[0]) == m * n
        _stats_ok(row, prow)


def _same(got, want):
    """Bitwise as values, a NaN where the other has a NaN."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _specials(x, gen):
    """A copy of x with NaN, +-inf and an overflowing value at seeded
    positions."""
    x = x.contiguous().clone()
    idx = torch.randperm(x.numel(), generator=gen, device=x.device)[:4]
    x.view(-1)[idx] = torch.tensor([float("nan"), float("inf"),
                                    -float("inf"), 1e9],
                                   device=x.device).to(x.dtype)
    return x


@pytest.mark.parametrize("m,k,n,chunk,kind,groups", [
    (37, 48, 80, 64, "f32", 1),       # K < chunk; ragged M and N
    (70, 150, 130, 64, "bf16", 2),    # bf16 A; 3 chunks; pitches off 16 bytes
    (100, 608, 96, 64, "f32", 4),     # K not a chunk multiple
    (64, 304, 200, 20, "f32", 4),     # chunk 20 cuts the scratch's pieces
    (48, 200, 70, 40, "views", 4),    # A and B transposed views
    (40, 136, 72, 32, "specials", 4), # NaN, inf and overflow in A and B
])
def test_sm90_emitq_schedules_match_plain(dev, m, k, n, chunk, kind, groups):
    """E on the Hopper tile at each chunk-group count, operand kind and
    layout: C and both code tensors bitwise the plain version (NaN for
    NaN) on random and lattice operands, and C bitwise K8's on the same
    operands; one count a call."""
    from repro_torch.kernels.sm90 import emitq_schedule

    assert emitq_schedule(m, n, k, chunk).groups == groups
    gen = torch.Generator(device=dev).manual_seed(m + 5 * k + n)
    kw = dict(repr_fmt=FP8_152, e_acc=6, m_acc=5, block_k=chunk)
    for lattice in (False, True):
        a = _operand(gen, (m, k), dev, lattice)
        b = (_operand(gen, (k, n), dev, lattice) / math.sqrt(k)).to(
            torch.bfloat16)
        if kind == "bf16":
            a = a.to(torch.bfloat16)
        elif kind == "views":
            a, b = a.T.contiguous().T, b.T.contiguous().T
        elif kind == "specials":
            a, b = _specials(a, gen), _specials(b, gen)
        n0 = qmatmul_fused.emitq_launches
        c, aq, bq = qmatmul_fused(a, b, return_quantized=True, **kw)
        pc, paq, pbq = qmatmul_fused_reference(a, b, return_quantized=True,
                                               **kw)
        k8, _ = qmatmul_fused(a, b, collect_stats=True, **kw)
        torch.cuda.synchronize()
        assert qmatmul_fused.emitq_launches == n0 + 1
        assert torch.equal(aq, paq) and torch.equal(bq, pbq)
        _same(c, pc)
        _same(c, k8)
        if kind == "specials":
            assert bool(torch.isnan(c).any())


@pytest.mark.parametrize("t,k,n,chunk,kind,groups", [
    (40, 70, 50, 64, "int8", 1),      # K < chunk in both roles; ragged
    (100, 130, 150, 64, "int8", 2),   # 3 and 2 chunks; pitches off 16 bytes
    (96, 80, 520, 64, "int8", 4),     # 9 chunks, N not a chunk multiple
    (64, 96, 200, 24, "int8", 4),     # chunk 24 cuts the codes' 16-byte pieces
    (70, 96, 300, 100, "f32", 2),     # raw f32, x a transposed view, chunk 100
    (48, 64, 1000, 64, "head", 4),    # f32 x, bf16 w behind the embed.T view
    (33, 40, 260, 32, "bf16", 4),     # bf16 x and w
])
def test_sm90_bwd_pair_stats_schedules_match_plain(dev, t, k, n, chunk, kind,
                                                  groups):
    """K9 on the Hopper tile at each chunk-group count and residual kind:
    dx and dw bitwise B's and the plain version's, both rows' counters and
    MAX_ABS bitwise and sums within the bound, two launches identical."""
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_stats_reference)
    from repro_torch.kernels.sm90 import pair_schedule

    kinds = {"int8": (2, 2), "f32": (0, 0), "head": (0, 1), "bf16": (1, 1)}
    assert pair_schedule(t, k, n, chunk, chunk, *kinds[kind],
                         int(kind != "head"), stats=True).groups == groups
    gen = torch.Generator(device=dev).manual_seed(3 * t + k + n)
    packed = kind == "int8"
    rf = None if kind == "head" else FP8_152
    acc = (6, 9) if kind == "head" else (6, 5)
    kw = dict(repr_fmt=rf, bwd_acc=acc, grad_acc=(6, 7), bwd_chunk=chunk,
              grad_chunk=chunk, packed=packed, quantize_g=rf is not None)
    for lattice in (False, True):
        g = _operand(gen, (t, n), dev, lattice)
        x = _operand(gen, (t, k), dev, lattice)
        w = _operand(gen, (k, n), dev, lattice) / 8
        if kind == "int8":
            x, w = _codes(x), _codes(w)
        elif kind == "f32":
            x = x.T.contiguous().T
        elif kind == "head":
            w = w.to(torch.bfloat16).T.contiguous().T
        else:
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        n0 = qmatmul_bwd_pair.stats_launches
        dx, dw, rows = qmatmul_bwd_pair(g, x, w, collect_stats=True, **kw)
        dx2, dw2, rows2 = qmatmul_bwd_pair(g, x, w, collect_stats=True, **kw)
        bdx, bdw = qmatmul_bwd_pair(g, x, w, **kw)
        pdx, pdw, prows = qmatmul_bwd_pair_stats_reference(g, x, w, **kw)
        torch.cuda.synchronize()
        assert qmatmul_bwd_pair.stats_launches == n0 + 2
        assert torch.equal(dx, bdx) and torch.equal(dw, bdw)
        assert torch.equal(dx, pdx) and torch.equal(dw, pdw)
        assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
        assert torch.equal(rows, rows2)
        assert float(rows[0, 0]) == t * k and float(rows[1, 0]) == k * n
        _stats_ok(rows, prows)


def test_sm90_unpacks_every_code(dev):
    """The tile's int8 decode on all 256 codes of (1,5,2), along k and
    along mn: C = codes @ identity carries each code's value exactly."""
    from repro_torch.kernels.fused import qmatmul_fused_stats_reference
    from repro_torch.quant.qtensor import unpack_block

    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    eye = _codes(torch.eye(16, device=dev))
    kw = dict(repr_fmt=FP8_152, e_acc=8, m_acc=23, block_k=64,
              a_packed=True, b_packed=True)
    for a in (codes.reshape(16, 16).to(dev),
              codes.reshape(16, 16).T.contiguous().to(dev).T):
        c, _ = qmatmul_fused(a, eye, collect_stats=True, **kw)
        pc, _ = qmatmul_fused_stats_reference(a, eye, **kw)
        torch.cuda.synchronize()
        assert torch.equal(c, pc)
        assert torch.equal(c, unpack_block(a, 5, 2))


def test_sm90_smem_matches_schedule_and_two_blocks_fit(dev):
    """The kernels' shared memory a block equals kernels/sm90.py's mirror
    for every operand kind and group count, and at the training path's
    operands (int8 codes; the lm_head's f32 x and bf16 w) two 256-thread
    blocks of B and of K8 are resident on an SM, and of E and of K9 at the
    layers' operands; K9's lm_head call (f32 x and g) fits one."""
    import ctypes

    from repro_torch.kernels import build, sm90

    i1, i3, i4 = [ctypes.c_int], [ctypes.c_int] * 3, [ctypes.c_int] * 4
    k8_smem = build.function("qgemm_stats", "qgemm_stats_smem", i3)
    k8_occ = build.function("qgemm_stats", "qgemm_stats_occupancy", i3)
    e_smem = build.function("qgemm_emitq", "qgemm_emitq_smem", i1)
    e_occ = build.function("qgemm_emitq", "qgemm_emitq_occupancy", i1)
    b_smem = build.function("bwd_pair", "bwd_pair_smem", i4)
    b_occ = build.function("bwd_pair", "bwd_pair_occupancy", i4)
    k9_smem = build.function("bwd_pair", "bwd_pair_stats_smem", i4)
    k9_occ = build.function("bwd_pair", "bwd_pair_stats_occupancy", i4)
    for groups in (1, 2, 4):
        for a in (0, 1, 2):
            for b in (0, 1, 2):
                assert k8_smem(a, b, groups) == sm90.smem_bytes(
                    sm90.stage_bytes(a, b), groups, True)
        assert e_smem(groups) == sm90.emitq_schedule(
            64, 64, 64 * groups, 64).smem
        for x, w in ((2, 2), (0, 0), (0, 1), (1, 1), (1, 0)):
            for g in (0, 1):
                stage = max(sm90.stage_bytes(g, w), sm90.stage_bytes(x, g))
                assert b_smem(x, w, g, groups) == sm90.smem_bytes(
                    stage, groups, False)
                assert k9_smem(x, w, g, groups) == sm90.smem_bytes(
                    stage, groups, True)
    assert k8_occ(2, 2, 4) >= 2 and k8_occ(0, 1, 4) >= 2
    assert b_occ(2, 2, 1, 4) >= 2 and b_occ(0, 1, 0, 4) >= 2
    assert e_occ(4) >= 2 and k9_occ(2, 2, 1, 4) >= 2
    assert k9_occ(0, 1, 0, 4) >= 1


# --------------------------------------------------------------------------
# the oracle's kernels K2 (quantize) and K3 (chunked qmatmul), and the dense
# resumable prefill K10
# --------------------------------------------------------------------------


def test_quantize_kernel_matches_plain(dev):
    """K2 bitwise its plain version on f32 and bf16 inputs of every
    magnitude and the specials (+-0, +-inf, NaN, subnormals), aligned and
    not (an odd offset into the storage takes the scalar path), on a
    transposed view (copied first), and the (8, 23) identity; one launch
    a call."""
    from repro_torch.kernels.quantize import quantize, quantize_reference

    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((1027, 33), generator=gen, device=dev) * torch.exp2(
        torch.randint(-60, 60, (1027, 33), generator=gen, device=dev).float())
    x[0, :8] = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                             float("nan"), 1e-40, -1e-40, 3e38], device=dev)
    for fmt in ((5, 2), (6, 5), (6, 9), (8, 23)):
        for v in (x, x.to(torch.bfloat16), x.reshape(-1)[1:], x.T):
            n0 = quantize.launches
            got = quantize(v, e=fmt[0], m=fmt[1])
            want = quantize_reference(v, e=fmt[0], m=fmt[1])
            torch.cuda.synchronize()
            assert quantize.launches == n0 + 1
            assert got.shape == v.shape and got.dtype == torch.float32
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("m,k,n,bk,acc,kind", [
    (512, 1536, 256, 64, (6, 5), "f32"),
    (37, 200, 75, 16, (6, 5), "f32"),
    (512, 1536, 4000, 64, (6, 9), "head"),     # f32 x, bf16 embed.T view
    (96, 130, 200, 128, (8, 23), "bf16"),
    (1536, 512, 300, 64, (6, 5), "grad"),      # x^T: a transposed A
])
def test_qmatmul_kernel_matches_plain(dev, m, k, n, bk, acc, kind):
    """K3 bitwise its plain version (the same operation sequence: fused
    multiply-adds in increasing k, the carry rounded once a chunk) on
    random and lattice operands, through strides; one launch a call."""
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_reference

    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    kw = dict(e_acc=acc[0], m_acc=acc[1], block_k=bk)
    for lattice in (False, True):
        mk = (lambda s: _lattice(gen, s, dev)) if lattice else (
            lambda s: torch.randn(s, generator=gen, device=dev))
        a = mk((m, k))
        b = mk((k, n)) if lattice else mk((k, n)) / math.sqrt(k)
        if kind == "head":
            b = mk((n, k)).to(torch.bfloat16).T
        elif kind == "bf16":
            a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        elif kind == "grad":
            a = mk((k, m)).T
        n0 = qmatmul.launches
        got = qmatmul(a, b, **kw)
        want = qmatmul_reference(a, b, **kw)
        torch.cuda.synchronize()
        assert qmatmul.launches == n0 + 1
        assert torch.equal(got, want)


# (S, chunk, acc[, h, kv, dh]): the serve prompts' chunk, K10's S = 512
# calls at chunk 64, chunk 128 (carry out and in at a chunk multiple),
# S = 1, a 17-row prompt (one row a tile, cluster 2), and a head width and
# chunk other than the serve ones (dh 7: rows loaded a float at a time; 150
# rows in tiles of 8, the last one short)
FLASH_CASES = [(384, 16, (6, 5)), (512, 64, (6, 7)), (200, 128, (8, 23)),
               (512, 128, (6, 5)), (1, 16, (6, 5)), (17, 16, (6, 5)),
               (150, 48, (6, 5), 6, 3, 7)]


@pytest.mark.parametrize("s,chunk,acc,h,kv,dh",
                         [c + (12, 2, 128)[len(c) - 3:] for c in FLASH_CASES])
def test_flash_prefill_kernel_matches_plain(dev, s, chunk, acc, h, kv, dh):
    """K10 bitwise its plain version on random and on lattice operands, for
    every block_q (which the walk does not read); carry out at a chunk
    multiple (o, m, l bitwise the plain version's), then in: bitwise the
    one-shot walk; one launch a call."""
    from repro_torch.kernels.attention import (BLOCK_QS, flash_prefill,
                                               flash_prefill_reference)

    gen = torch.Generator(device=dev).manual_seed(s + chunk)
    for mk in (lambda shape: torch.randn(shape, generator=gen, device=dev),
               lambda shape: _lattice(gen, shape, dev)):
        q, k, v = mk((s, h, dh)), mk((s, kv, dh)), mk((s, kv, dh))
        kw = dict(acc=acc, chunk=chunk)
        want = flash_prefill_reference(q, k, v, **kw)
        for bq in BLOCK_QS:
            n0 = flash_prefill.launches
            got = flash_prefill(q, k, v, block_q=bq, **kw)
            torch.cuda.synchronize()
            assert flash_prefill.launches == n0 + 1
            assert torch.equal(got, want)
        split = chunk * (s // (2 * chunk))
        c = flash_prefill(q, k[:split], v[:split], return_carry=True, **kw)
        pc = flash_prefill_reference(q, k[:split], v[:split],
                                     return_carry=True, **kw)
        for a, b in zip(c, pc):
            assert torch.equal(a, b)
        res = flash_prefill(q, k[split:], v[split:], kv_offset=split, carry=c,
                            **kw)
        torch.cuda.synchronize()
        assert torch.equal(res, want)
    with pytest.raises(NotImplementedError):     # beyond the kernel's tiles
        flash_prefill(q, k, v, acc=acc, chunk=256)


def test_oracle_train_step_matches_fused(dev):
    """One training step of the smoke model under the unfused oracle plan
    (K2 and K3 only) against the fused plan (G, E and B only): the loss
    and every gradient leaf bitwise."""
    from dataclasses import replace

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
    from repro_torch.kernels.qmatmul import qmatmul
    from repro_torch.kernels.quantize import quantize
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import _grads, compute_copy
    from repro_torch.train.optimizer import tree_leaves

    cfg = plan_for_model(get_smoke_config("qwen2-1.5b"), seq_len=32,
                         global_batch=4,
                         policy=AccumulationPolicy(mode="predicted", chunk=16))
    plan = cfg.quant
    oracle = replace(cfg, quant=replace(plan, **{
        f: replace(getattr(plan, f), fused=False) for f in
        ("attn_qkv", "attn_out", "mlp_up", "mlp_down", "lm_head")}))
    params = get_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)).to(dev)

    def step(c):
        cc = compute_copy(params)
        loss, _ = get_model(c).loss_fn(cc, {"tokens": tokens}, c)
        loss.backward()
        return loss.detach(), _grads(cc, params)

    lf, gf = step(cfg)
    n = (quantize.launches, qmatmul.launches, qmatmul_fused.emitq_launches,
         qmatmul_bwd_pair.launches)
    lo, go = step(oracle)
    torch.cuda.synchronize()
    assert quantize.launches > n[0] and qmatmul.launches > n[1]
    assert (qmatmul_fused.emitq_launches, qmatmul_bwd_pair.launches) == n[2:]
    assert torch.equal(lf, lo)
    for a, b in zip(tree_leaves(gf), tree_leaves(go)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# G's two routes (the decode kernel and the Hopper tile) and K3's
# chunk-sliced tile
# --------------------------------------------------------------------------

# qwen2-1.5b's decode GEMMs: (name, K, N); the tied lm_head is embed.T
QWEN_DECODE = [("attn_q", 1536, 1536), ("attn_k", 1536, 256),
               ("mlp_gate", 1536, 8960), ("mlp_down", 8960, 1536),
               ("lm_head", 1536, 151936)]


def _g_operands(gen, dev, m, k, n, *, head, lattice):
    a = _operand(gen, (m, k), dev, lattice)
    if head:
        b = (_operand(gen, (n, k), dev, lattice) / 8).to(torch.bfloat16).T
    else:
        b = (_operand(gen, (k, n), dev, lattice) / 8).to(torch.bfloat16)
    return a, b


def _g_kw(head, chunk=64):
    return dict(repr_fmt=None if head else FP8_152, e_acc=6,
                m_acc=9 if head else 5, block_k=chunk)


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("name,k,n", QWEN_DECODE)
def test_g_decode_route_at_decode_shapes(dev, name, k, n, m):
    """G at every qwen2-1.5b decode shape takes the decode route and is
    bitwise the plain version on random and lattice operands; one count a
    call, and one fold launch a split call."""
    from repro_torch.kernels import sm90

    head = name == "lm_head"
    sched = sm90.g_schedule(m, n, k, 64, 0, 1)
    assert isinstance(sched, sm90.DecodeSchedule)
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    kw = _g_kw(head)
    for lattice in (False, True):
        a, b = _g_operands(gen, dev, m, k, n, head=head, lattice=lattice)
        n0, f0 = qmatmul_fused.launches, qmatmul_fused.fold_launches
        got = qmatmul_fused(a, b, **kw)
        want = qmatmul_fused_reference(a, b, **kw)
        torch.cuda.synchronize()
        assert qmatmul_fused.launches == n0 + 1
        assert qmatmul_fused.fold_launches == f0 + int(sched.slices > 1)
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["head_view", "ragged", "unaligned",
                                  "specials", "f32_b", "chunk_cut", "a_view",
                                  "a_bf16"])
def test_g_decode_route_layouts_and_edges(dev, case):
    """The decode route on the tied head's transposed view (k-contiguous
    16-byte loads), ragged M, K and N, strides off 16 bytes and a chunk
    that cuts the 16-byte pieces (element paths), NaN and Inf in the
    weights (propagated as the plain version does), f32 weights, and A as
    a transposed view or bf16: bitwise the plain version."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    m, k, n, chunk, head = 5, 200, 75, 64, False
    if case == "head_view":
        m, k, n, head = 8, 320, 1000, True
    elif case == "chunk_cut":
        m, k, n, chunk, head = 7, 300, 260, 20, True
    a, b = _g_operands(gen, dev, m, k, n, head=head, lattice=False)
    if case == "unaligned":
        b = torch.randn((k, n + 1), generator=gen, device=dev).to(
            torch.bfloat16)[:, 1:]
    elif case == "specials":
        b = _specials(b, gen)
        a = _specials(a, gen)
    elif case == "f32_b":
        b = b.float()
    elif case == "a_view":
        a = a.T.contiguous().T
    elif case == "a_bf16":
        a = a.to(torch.bfloat16)
    kw = _g_kw(head, chunk)
    got = qmatmul_fused(a, b, **kw)
    want = qmatmul_fused_reference(a, b, **kw)
    torch.cuda.synchronize()
    _same(got, want)
    if case == "specials":
        assert bool(torch.isnan(got).any())


def _decode(m, n, k, chunk, b_kind, slots, split):
    """A decode schedule with the given slots, split or not."""
    from repro_torch.kernels import sm90

    width = sm90.DECODE_LANES * (4 // (4 if b_kind == 0 else 2))
    nc = -(-k // chunk)
    slices = -(-nc // slots) if split else 1
    return sm90.DecodeSchedule(
        slots, slices, -(-n // width), -(-m // sm90.DECODE_ROWS), width,
        sm90.decode_ws(m, n, k, chunk, slices),
        sm90.decode_smem(slots, chunk, width))


@pytest.mark.parametrize("m,k,n,chunk,slots,split", [
    (8, 1536, 256, 64, 8, True),      # attn_k as scheduled: 3 slices
    (8, 1536, 256, 256, 6, False),    # no split, one round, chunk 256
    (3, 8960, 200, 64, 8, True),      # 18 slices of 8 chunks, ragged N
    (8, 8960, 136, 64, 8, False),     # no split, 18 rounds
    (13, 700, 90, 48, 5, True),       # two row groups, ragged last chunk
    (13, 700, 90, 48, 3, False),      # 5 rounds of 3 slots
    (8, 200, 90, 48, 8, False),       # more slots than chunks
    (8, 300, 70, 64, 1, True),        # a block a chunk
])
@pytest.mark.parametrize("b_kind", [0, 1])
def test_g_decode_schedules_match_plain(dev, m, k, n, chunk, slots, split,
                                        b_kind):
    """The decode route at each split (no split, rounds; a split over
    slices, folded by the fold kernel) for bf16 and f32 weights, and the
    tile route at the same operands: all bitwise the plain version."""
    from repro_torch.kernels import sm90
    from repro_torch.kernels.fused import qmatmul_fused_with

    gen = torch.Generator(device=dev).manual_seed(m * k + n)
    kw = _g_kw(False, chunk)
    sched = _decode(m, n, k, chunk, b_kind, slots, split)
    assert (sched.slices > 1) == split
    tile = sm90.gemm_schedule(m, n, k, chunk, 0, b_kind, stats=False)
    for lattice in (False, True):
        a, b = _g_operands(gen, dev, m, k, n, head=False, lattice=lattice)
        b = b.float() if b_kind == 0 else b
        want = qmatmul_fused_reference(a, b, **kw)
        got = qmatmul_fused_with(a, b, sched, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(qmatmul_fused_with(a, b, tile, **kw), want)


@pytest.mark.parametrize("m,k,n,chunk,kind", [
    (65, 1536, 1536, 64, "bf16"),     # just past the decode route
    (64, 1536, 8960, 64, "bf16"),     # mlp_gate at a prefill slab
    (70, 150, 130, 64, "f32"),        # 3 chunks; pitches off 16 bytes
    (96, 300, 1000, 64, "head"),      # f32 x, bf16 embed.T view
    (80, 200, 70, 40, "a_view"),      # A a transposed view
])
def test_g_tile_route_matches_k8(dev, m, k, n, chunk, kind):
    """G above the decode route runs the Hopper tile without the shadow
    carry: C bitwise K8's on the same operands and the plain version's."""
    from repro_torch.kernels import sm90
    from repro_torch.kernels.fused import qmatmul_fused_stats_reference

    kinds = {"bf16": (0, 1), "f32": (0, 0), "head": (0, 1), "a_view": (0, 0)}
    sched = sm90.g_schedule(m, n, k, chunk, *kinds[kind])
    assert isinstance(sched, sm90.Schedule)
    assert sched.groups == sm90.chunk_groups(-(-k // chunk))
    gen = torch.Generator(device=dev).manual_seed(m + 2 * k + n)
    kw = _g_kw(kind == "head", chunk)
    for lattice in (False, True):
        a = _operand(gen, (m, k), dev, lattice)
        b = _operand(gen, (k, n), dev, lattice) / math.sqrt(k)
        if kind == "bf16":
            b = b.to(torch.bfloat16)
        elif kind == "head":
            b = b.to(torch.bfloat16).T.contiguous().T
        elif kind == "a_view":
            a = a.T.contiguous().T
        got = qmatmul_fused(a, b, **kw)
        k8, _ = qmatmul_fused(a, b, collect_stats=True, **kw)
        want, _ = qmatmul_fused_stats_reference(a, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, k8) and torch.equal(got, want)


def test_g_entries_match_their_mirrors(dev):
    """G's workspace and shared-memory entries equal kernels/sm90.py's
    mirrors; every decode schedule of the model's shapes fits a block
    with at least one resident (under RNE and under SR), and the tile route at the lm_head's kinds
    two 256-thread blocks an SM."""
    import ctypes

    from repro_torch.kernels import build, sm90

    lib = build.library("qgemm")
    ws = lib.qgemm_decode_ws
    ws.restype, ws.argtypes = ctypes.c_longlong, [ctypes.c_int] * 5
    i3, i5, i6 = [ctypes.c_int] * 3, [ctypes.c_int] * 5, [ctypes.c_int] * 6
    smem = build.function("qgemm", "qgemm_decode_smem", i3)
    occ = build.function("qgemm", "qgemm_decode_occupancy", i6)
    t_smem = build.function("qgemm", "qgemm_tile_smem", i3)
    t_occ = build.function("qgemm", "qgemm_tile_occupancy", i3)
    for m in (1, 3, 8, 16, 32, 64):
        for _, k, n in QWEN_DECODE:
            s = sm90.decode_schedule(m, n, k, 64, 1)
            assert ws(m, n, k, 64, s.slices) == s.ws_floats
            assert smem(1, s.slots, 64) == s.smem
            for sr in (0, 1):
                assert occ(0, 1, int(n == 151936), s.slots, 64, sr) >= 1
    for slots in (1, 3, 5, 8):
        for chunk in (16, 64, 128, 200):
            for b_bf16 in (0, 1):
                width = sm90.DECODE_LANES * (2 if b_bf16 else 1)
                assert smem(b_bf16, slots, chunk) == sm90.decode_smem(
                    slots, chunk, width)
    for groups in (1, 2, 4):
        for a in (0, 1):
            for b in (0, 1):
                assert t_smem(a, b, groups) == sm90.smem_bytes(
                    sm90.stage_bytes(a, b), groups, False)
    assert t_occ(0, 1, 4) >= 2


@pytest.mark.parametrize("m,k,n,bk,kind,slices", [
    (96, 50, 80, 64, "f32", 1),       # one chunk, ragged K
    (70, 150, 130, 64, "bwd", 2),     # 3 chunks; B = w.T (k-contiguous)
    (512, 1536, 256, 64, "f32", 4),   # attn_k's FWD: 32 tiles
    (1536, 512, 300, 64, "grad", 4),  # A = x.T (m-contiguous)
    (100, 700, 90, 128, "bf16", 4),   # the wide roles' chunk 128, ragged K
    (64, 300, 72, 20, "bwd", 4),      # chunk 20 cuts the 16-byte pieces
    (33, 200, 60, 128, "unaligned", 2),  # pitches off 16 bytes
])
def test_qmatmul_slices_match_plain(dev, m, k, n, bk, kind, slices):
    """K3 at each slice count (from the chunk count) with k-contiguous and
    m-contiguous views, f32 and bf16 operands, chunks 64, 128 and 20, and
    ragged K: bitwise its plain version on random and lattice operands."""
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_reference, slices_for

    assert slices_for(-(-k // bk)) == slices
    gen = torch.Generator(device=dev).manual_seed(m + 3 * k + n)
    kw = dict(e_acc=6, m_acc=5, block_k=bk)
    for lattice in (False, True):
        a = _operand(gen, (m, k), dev, lattice)
        b = _operand(gen, (k, n), dev, lattice) / math.sqrt(k)
        if kind == "bwd":
            b = b.T.contiguous().T
        elif kind == "grad":
            a = a.T.contiguous().T
        elif kind == "bf16":
            a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        elif kind == "unaligned":
            a = torch.randn((m, k + 1), generator=gen, device=dev)[:, 1:]
            b = torch.randn((k, n + 3), generator=gen, device=dev)[:, 3:]
        got = qmatmul(a, b, **kw)
        want = qmatmul_reference(a, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_qmatmul_entries_match_their_mirrors(dev):
    """K3's shared memory a block equals kernels/qmatmul.py's mirror at
    each slice count, and a block of each is resident."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.qmatmul import smem_bytes

    smem = build.function("qmatmul", "qmatmul_smem", [ctypes.c_int])
    occ = build.function("qmatmul", "qmatmul_occupancy", [ctypes.c_int] * 3)
    for s in (1, 2, 4):
        assert smem(s) == smem_bytes(s)
        for a in (0, 1):
            for b in (0, 1):
                assert occ(a, b, s) >= 1


@pytest.mark.parametrize("n,chunk", [(1300, 0), (2048, 0), (4100, 8)])
def test_accumulate_on_card_bitwise_cpu(dev, n, chunk):
    """The software accumulators (``quant.accumulate``): on the card the
    scan runs whole blocks of steps as CUDA graph replays
    (``GRAPH_STEPS``), the rest eagerly; bitwise the CPU's sequential
    loop, with a tail and as a chunked two-level sum."""
    from repro_torch.quant import (
        FPFormat,
        chunked_accumulate,
        quantize,
        sequential_accumulate,
    )

    rs = np.random.RandomState(n + chunk)
    x = quantize(torch.from_numpy(rs.standard_normal((333, n)).astype(
        np.float32)), FPFormat(5, 5))
    fmt = FPFormat(6, 7)
    if chunk:
        got = chunked_accumulate(x.to(dev), fmt, chunk)
        want = chunked_accumulate(x, fmt, chunk)
    else:
        got = sequential_accumulate(x.to(dev), fmt)
        want = sequential_accumulate(x, fmt)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


# --------------------------------------------------------------------------
# stochastic rounding on the Hopper tile: E, K8, B and K9 under SR
# --------------------------------------------------------------------------

SR = dict(rounding="sr")


@pytest.mark.parametrize("m,k,n,chunk,groups", [
    (37, 48, 80, 64, 1),       # K < chunk; ragged M and N (padded tiles)
    (70, 150, 130, 64, 2),     # 3 chunks
    (100, 608, 96, 64, 4),     # K not a chunk multiple
    (64, 304, 200, 20, 4),     # chunk 20
    (130, 1536, 256, 64, 4),   # a layer's K, N = 256
])
def test_sr_emitq_and_stats_match_plain(dev, m, k, n, chunk, groups):
    """E and K8 under SR at each chunk-group count: C (and E's codes)
    bitwise the plain version on random and lattice operands, K8's C
    bitwise E's (f32 operands, and on E's codes), its row against the plain
    one; SR launches counted apart; another seed, and RNE, differ."""
    from repro_torch.kernels.fused import qmatmul_fused_stats_reference
    from repro_torch.kernels.sm90 import emitq_schedule

    assert emitq_schedule(m, n, k, chunk).groups == groups
    gen = torch.Generator(device=dev).manual_seed(m + 5 * k + n)
    kw = dict(repr_fmt=FP8_152, e_acc=6, m_acc=5, block_k=chunk, sr_seed=77,
              **SR)
    codes = dict(kw, quantize_a=False, quantize_b=False, a_packed=True,
                 b_packed=True)
    for lattice in (False, True):
        a = _operand(gen, (m, k), dev, lattice)
        b = (_operand(gen, (k, n), dev, lattice) / math.sqrt(k)).to(
            torch.bfloat16)
        counts = (qmatmul_fused.sr_emitq_launches,
                  qmatmul_fused.sr_stats_launches,
                  qmatmul_fused.emitq_launches, qmatmul_fused.stats_launches)
        c, aq, bq = qmatmul_fused(a, b, return_quantized=True, **kw)
        pc, paq, pbq = qmatmul_fused_reference(a, b, return_quantized=True,
                                               **kw)
        k8, row = qmatmul_fused(a, b, collect_stats=True, **kw)
        k8c, rowc = qmatmul_fused(aq, bq, collect_stats=True, **codes)
        _, prow = qmatmul_fused_stats_reference(a, b, **kw)
        _, prowc = qmatmul_fused_stats_reference(aq, bq, **codes)
        other = qmatmul_fused(a, b, return_quantized=True,
                              **dict(kw, sr_seed=78))[0]
        rne = qmatmul_fused(a, b, return_quantized=True,
                            **dict(kw, rounding="rne"))[0]
        torch.cuda.synchronize()
        assert (qmatmul_fused.sr_emitq_launches,
                qmatmul_fused.sr_stats_launches,
                qmatmul_fused.emitq_launches,
                qmatmul_fused.stats_launches) == (
                    counts[0] + 2, counts[1] + 2, counts[2] + 1, counts[3])
        assert torch.equal(aq, paq) and torch.equal(bq, pbq)
        assert torch.equal(c, pc)
        assert torch.equal(k8, c) and torch.equal(k8c, c)
        _stats_ok(row, prow)
        _stats_ok(rowc, prowc)
        assert not torch.equal(c, other) and not torch.equal(c, rne)


@pytest.mark.parametrize("t,k,n,chunk,kind,groups", [
    (40, 70, 50, 64, "int8", 1),      # K < chunk in both roles; ragged
    (100, 130, 150, 64, "int8", 2),   # 3 and 2 chunks
    (96, 80, 520, 64, "int8", 4),     # 9 chunks, N not a chunk multiple
    (64, 96, 200, 24, "int8", 4),     # chunk 24
    (48, 64, 1000, 64, "head", 4),    # f32 x, bf16 w behind the embed.T view
])
def test_sr_bwd_pair_and_stats_match_plain(dev, t, k, n, chunk, kind,
                                          groups):
    """B and K9 under SR at each chunk-group count: dx and dw bitwise the
    plain version on random and lattice operands, K9's bitwise B's and its
    rows against the plain ones; dx bitwise K8 on (Q(g), Q(w)^T) under the
    BWD seed and dw K8 on (Q(x)^T, Q(g)) under the GRAD seed; SR launches
    counted apart; other seeds differ."""
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_reference,
        qmatmul_bwd_pair_stats_reference)
    from repro_torch.kernels.sm90 import pair_schedule
    from repro_torch.quant.qtensor import unpack_block

    kinds = {"int8": (2, 2), "head": (0, 1)}
    assert pair_schedule(t, k, n, chunk, chunk, *kinds[kind],
                         int(kind != "head")).groups == groups
    gen = torch.Generator(device=dev).manual_seed(t + 11 * k + n)
    packed = kind == "int8"
    rf = FP8_152 if packed else None
    acc = (6, 5) if packed else (6, 9)
    sb, sg = 1001, 2002
    kw = dict(repr_fmt=rf, bwd_acc=acc, grad_acc=(6, 7), bwd_chunk=chunk,
              grad_chunk=chunk, packed=packed, quantize_g=packed,
              sr_seed_bwd=sb, sr_seed_grad=sg, **SR)
    for lattice in (False, True):
        g = _operand(gen, (t, n), dev, lattice)
        x = _operand(gen, (t, k), dev, lattice)
        w = _operand(gen, (k, n), dev, lattice) / 8
        if packed:
            x, w = _codes(x), _codes(w)
            x32, w32 = unpack_block(x, 5, 2), unpack_block(w, 5, 2)
            gq = quantize_block(g, 5, 2)
        else:
            w = w.to(torch.bfloat16).T.contiguous().T
            x32, w32, gq = x, w.float(), g
        counts = (qmatmul_bwd_pair.sr_launches,
                  qmatmul_bwd_pair.sr_stats_launches,
                  qmatmul_bwd_pair.launches)
        dx, dw = qmatmul_bwd_pair(g, x, w, **kw)
        pdx, pdw = qmatmul_bwd_pair_reference(g, x, w, **kw)
        sdx, sdw, rows = qmatmul_bwd_pair(g, x, w, collect_stats=True, **kw)
        _, _, prows = qmatmul_bwd_pair_stats_reference(g, x, w, **kw)
        odx, odw = qmatmul_bwd_pair(g, x, w, **dict(kw, sr_seed_bwd=sb + 1,
                                                    sr_seed_grad=sg + 1))
        fkw = dict(collect_stats=True, quantize_a=False, quantize_b=False,
                   block_k=chunk, **SR)
        fdx, _ = qmatmul_fused(gq, w32.T, e_acc=acc[0], m_acc=acc[1],
                               sr_seed=sb, **fkw)
        fdw, _ = qmatmul_fused(x32.T, gq, e_acc=6, m_acc=7, sr_seed=sg,
                               **fkw)
        torch.cuda.synchronize()
        assert (qmatmul_bwd_pair.sr_launches,
                qmatmul_bwd_pair.sr_stats_launches,
                qmatmul_bwd_pair.launches) == (counts[0] + 2, counts[1] + 1,
                                               counts[2])
        assert torch.equal(dx, pdx) and torch.equal(dw, pdw)
        assert torch.equal(sdx, dx) and torch.equal(sdw, dw)
        _stats_ok(rows, prows)
        assert torch.equal(fdx, dx) and torch.equal(fdw, dw)
        assert not torch.equal(odx, dx) and not torch.equal(odw, dw)


@pytest.mark.parametrize("m,k,n,chunk,slots,split", [
    (1, 1536, 1536, 64, 8, True),     # decode, M = 1, split
    (8, 1536, 256, 64, 8, True),      # attn_k as scheduled: 3 slices
    (8, 8960, 136, 64, 8, False),     # no split, 18 rounds of 8 chunks
    (13, 700, 90, 48, 3, False),      # two row groups, ragged last chunk
    (13, 700, 90, 48, 5, True),       # the fold kernel, ragged
    (64, 1536, 8960, 64, 8, True),    # mlp_gate at a prefill slab
])
@pytest.mark.parametrize("b_kind", [0, 1])
def test_g_sr_schedules_match_plain(dev, m, k, n, chunk, slots, split,
                                    b_kind):
    """G under SR through each decode schedule (rounds folded in the block
    at chunk c0 + q; a split folded by the SR fold kernel) and through the
    tile route at the same operands: all bitwise the plain version and E's
    C on random and lattice operands; another seed and RNE differ."""
    from repro_torch.kernels import sm90
    from repro_torch.kernels.fused import qmatmul_fused_with

    gen = torch.Generator(device=dev).manual_seed(m * k + n + 1)
    kw = dict(_g_kw(False, chunk), sr_seed=991, **SR)
    sched = _decode(m, n, k, chunk, b_kind, slots, split)
    tile = sm90.gemm_schedule(m, n, k, chunk, 0, b_kind, stats=False)
    for lattice in (False, True):
        a, b = _g_operands(gen, dev, m, k, n, head=False, lattice=lattice)
        b = b.float() if b_kind == 0 else b
        want = qmatmul_fused_reference(a, b, **kw)
        got = qmatmul_fused_with(a, b, sched, **kw)
        e = qmatmul_fused(a, b, return_quantized=True, **kw)[0]
        other = qmatmul_fused_with(a, b, sched, **dict(kw, sr_seed=992))
        rne = qmatmul_fused_with(a, b, sched, **dict(kw, rounding="rne"))
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(e, want)
        assert torch.equal(qmatmul_fused_with(a, b, tile, **kw), want)
        assert not torch.equal(other, got) and not torch.equal(rne, got)


@pytest.mark.parametrize("m,name,k,n", [
    (1, "attn_q", 1536, 1536), (8, "attn_k", 1536, 256),
    (8, "lm_head", 1536, 151936), (64, "mlp_down", 8960, 1536),
    (512, "attn_q", 1536, 1536)])
def test_g_sr_routes_count_apart(dev, m, name, k, n):
    """``qmatmul_fused`` under SR takes ``sm90.g_schedule``'s route (the
    rounding does not move it) and counts on ``sr_launches`` (and
    ``sr_fold_launches`` for a split call), never on the RNE counters;
    bitwise the plain version."""
    from repro_torch.kernels import sm90

    head = name == "lm_head"
    sched = sm90.g_schedule(m, n, k, 64, 0, 1)
    gen = torch.Generator(device=dev).manual_seed(m + n)
    kw = dict(_g_kw(head), sr_seed=5, **SR)
    a, b = _g_operands(gen, dev, m, k, n, head=head, lattice=False)
    counts = (qmatmul_fused.sr_launches, qmatmul_fused.sr_fold_launches,
              qmatmul_fused.launches, qmatmul_fused.fold_launches)
    got = qmatmul_fused(a, b, **kw)
    torch.cuda.synchronize()
    split = isinstance(sched, sm90.DecodeSchedule) and sched.slices > 1
    assert (qmatmul_fused.sr_launches, qmatmul_fused.sr_fold_launches,
            qmatmul_fused.launches, qmatmul_fused.fold_launches) == (
                counts[0] + 1, counts[1] + split, counts[2], counts[3])
    assert torch.equal(got, qmatmul_fused_reference(a, b, **kw))


@pytest.mark.parametrize("t,k,n,chunk,segs,kind", [
    (64, 1536, 8960, 64, 10, "int8"),   # mlp gate/up, as the JAX split
    (100, 130, 300, 32, 3, "int8"),     # ragged tiles and segments
    (96, 200, 1000, 64, 4, "head"),     # f32 x, bf16 w, f32 g
])
def test_sr_carry_chain_matches_unsplit_and_plain(dev, t, k, n, chunk, segs,
                                                  kind):
    """B's dx carry-in entry (K7) under SR, chained over ``segs`` N
    segments at their place in N: dx and dw bitwise the unsplit SR B and
    the chained plain version; SR carry launches counted apart."""
    from chip_smoke import _nsplit_plain
    from repro_torch.kernels.bwd_pair import (qmatmul_bwd_pair,
                                              qmatmul_bwd_pair_nsplit,
                                              qmatmul_bwd_pair_reference)

    gen = torch.Generator(device=dev).manual_seed(t + k + n)
    for lattice in (False, True):
        x = _operand(gen, (t, k), dev, lattice)
        w = _operand(gen, (k, n), dev, lattice) / math.sqrt(k)
        g = _operand(gen, (t, n), dev, lattice) / math.sqrt(n)
        if kind == "int8":
            _, xq, wq = qmatmul_fused(x, w, repr_fmt=FP8_152,
                                      return_quantized=True)
            kw = dict(repr_fmt=FP8_152, packed=True)
        else:
            xq, wq = x, w.to(torch.bfloat16)
            kw = dict(repr_fmt=None, packed=False)
        kw.update(bwd_acc=(6, 5), grad_acc=(6, 7), bwd_chunk=chunk,
                  grad_chunk=chunk, sr_seed_bwd=3, sr_seed_grad=4, **SR)
        dx, dw = qmatmul_bwd_pair(g, xq, wq, **kw)
        n0 = (qmatmul_bwd_pair.sr_carry_launches,
              qmatmul_bwd_pair.carry_launches)
        sdx, sdw = qmatmul_bwd_pair_nsplit(g, xq, wq, n_split=segs, **kw)
        torch.cuda.synchronize()
        assert qmatmul_bwd_pair.carry_launches == n0[1]
        assert qmatmul_bwd_pair.sr_carry_launches - n0[0] == segs
        assert torch.equal(sdx, dx) and torch.equal(sdw, dw)
        pdx, pdw = _nsplit_plain(g, xq, wq, kw, segs)
        assert torch.equal(sdx, pdx) and torch.equal(sdw, pdw)
        udx, udw = qmatmul_bwd_pair_reference(g, xq, wq, **kw)
        assert torch.equal(udx, dx) and torch.equal(udw, dw)


@pytest.mark.parametrize("s,chunk,acc,q_off", [
    (384, 16, (6, 5), 0), (64, 16, (6, 5), 320), (512, 64, (6, 7), 0),
    (150, 48, (6, 5), 0), (17, 16, (6, 5), 0)])
def test_flash_prefill_sr_matches_plain_and_resumes(dev, s, chunk, acc,
                                                    q_off):
    """K10 under SR (qwen2-1.5b's heads: H 12, KV 2, dh 128): bitwise its
    plain version on random and lattice operands, one-shot and with the
    carry out at a chunk multiple and back in (bitwise the one-shot walk);
    another seed and RNE differ; SR launches counted apart."""
    from repro_torch.kernels.attention import (flash_prefill,
                                               flash_prefill_reference)

    h, kv, dh = 12, 2, 128
    gen = torch.Generator(device=dev).manual_seed(s + chunk + q_off)
    kw = dict(acc=acc, chunk=chunk, q_offset=q_off, sr_seed=123, **SR)
    sk = q_off + s
    for mk in (lambda shape: torch.randn(shape, generator=gen, device=dev),
               lambda shape: _lattice(gen, shape, dev)):
        q, k, v = mk((s, h, dh)), mk((sk, kv, dh)), mk((sk, kv, dh))
        want = flash_prefill_reference(q, k, v, **kw)
        n0 = (flash_prefill.sr_launches, flash_prefill.launches)
        got = flash_prefill(q, k, v, **kw)
        torch.cuda.synchronize()
        assert (flash_prefill.sr_launches, flash_prefill.launches) == (
            n0[0] + 1, n0[1])
        assert torch.equal(got, want)
        split = chunk * (sk // (2 * chunk))
        c = flash_prefill(q, k[:split], v[:split], return_carry=True, **kw)
        pc = flash_prefill_reference(q, k[:split], v[:split],
                                     return_carry=True, **kw)
        for a, b in zip(c, pc):
            assert torch.equal(a, b)
        res = flash_prefill(q, k[split:], v[split:], kv_offset=split,
                            carry=c, **kw)
        other = flash_prefill(q, k, v, **dict(kw, sr_seed=124))
        rne = flash_prefill(q, k, v, **dict(kw, rounding="rne"))
        torch.cuda.synchronize()
        assert torch.equal(res, want)
        assert not torch.equal(other, got) and not torch.equal(rne, got)


# --------------------------------------------------------------------------
# the carry variants of D and P (tensor-parallel serving)
# --------------------------------------------------------------------------


# (h, kv, dh, lengths, page-table width): a rank's share of the serve arena
# under 2 ranks (g 6 of KV 1), the unsplit serve arena, the monitor's B 1,
# a 4096-token row, and heads and pages other than the serve ones
DECODE_CARRY_CASES = [
    (6, 1, 128, SERVE_LENS, 24),
    (12, 2, 128, SERVE_LENS, 24),
    (12, 2, 128, [300], 26),
    (6, 1, 128, [4096, 0, 1000], 256),
    (6, 3, 6, [0, 13, 40, 3], 9, 5),
]


@pytest.mark.parametrize("h,kv,dh,lens,width,ps",
                         [c + (16,) * (len(c) == 5) for c in DECODE_CARRY_CASES])
def test_decode_carry_kernel_matches_plain(dev, h, kv, dh, lens, width, ps):
    """D's carry entry (``return_carry=True``): o, m and l bitwise the plain
    walk's carry on random and lattice q, its finalize bitwise D's output;
    counted on ``carry_launches`` only; a length-0 row is the neutral
    carry (0, NEG, 0)."""
    from repro_torch.kernels.attention import NEG, finalize_carry

    gen = torch.Generator(device=dev).manual_seed(h * dh + width + 7)
    args = _decode_case(gen, dev, lens, width, kv, dh, ps)
    kw = dict(kv_fmt=FP8_152, acc=(6, 5))
    for q in (torch.randn((len(lens), h, dh), generator=gen, device=dev),
              _lattice(gen, (len(lens), h, dh), dev)):
        n0 = (paged_attn_decode.launches, paged_attn_decode.carry_launches)
        got = paged_attn_decode(q, *args, return_carry=True, **kw)
        want = paged_attn_decode_reference(q, *args, return_carry=True, **kw)
        out = paged_attn_decode(q, *args, **kw)
        torch.cuda.synchronize()
        assert (paged_attn_decode.launches,
                paged_attn_decode.carry_launches) == (n0[0] + 1, n0[1] + 1)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(finalize_carry(got[0], got[2]), out)
        for b, s in enumerate(lens):
            if s == 0:
                assert bool((got[0][b] == 0).all() and (got[1][b] == NEG).all()
                            and (got[2][b] == 0).all())
    with pytest.raises(ValueError):
        paged_attn_decode(q, *args, return_carry=True, collect_stats=True,
                          **kw)


def test_decode_carry_entry_fits_like_d(dev):
    """D's carry instantiation fits as many clusters at once as D at the
    serve arena and at a rank's share of it."""
    import ctypes

    from repro_torch.kernels import build, sm90

    clusters = build.function("paged_decode", "paged_decode_clusters",
                              [ctypes.c_int] * 6)
    for b, kv, g in ((8, 2, 6), (8, 1, 6), (1, 2, 6)):
        s = sm90.attn_decode_schedule(b, kv, 64, g, 16, 128)
        d, c = (clusters(kind, g, 16, 128, s.cluster, s.rank_pages)
                for kind in (0, 2))
        assert c == d and c >= 2 * b, (b, kv, d, c)


# (T, q_offset, q_len[, h, kv, dh, page size]): a rank's share of the
# serve slab under 2 ranks (6 heads, KV 1), the unsplit slab, a one-shot
# prompt, a ragged slab, and other heads and pages
PREFILL_CARRY_CASES = [
    (64, 320, 64, 6, 1, 128, 16),
    (64, 320, 64),
    (384, 0, 384, 6, 1, 128, 16),
    (24, 16, 21),
    (37, 5, 30, 6, 3, 7, 5),
]


@pytest.mark.parametrize("case", PREFILL_CARRY_CASES)
def test_prefill_carry_out_and_resume_match_plain(dev, case):
    """P's carry out bitwise the plain walk's, its finalize bitwise P's
    output; P resumed at every ``start_page`` from the carry of the pages
    before it (itself a carry-out call with ``kv_len = start_page *
    page_size``) bitwise the one-shot walk, out and carry, and bitwise the
    plain resumed walk; each variant counted on its own counter."""
    from repro_torch.kernels.attention import finalize_carry

    t, q_off, q_len, h, kv, dh, ps = case + (12, 2, 128, 16)[len(case) - 3:]
    kv_len = q_off + q_len
    gen = torch.Generator(device=dev).manual_seed(t + q_off + 11)
    n_used = -(-kv_len // ps)
    kc, vc, kse, vse = _arena(gen, dev, n_used + 1, kv, ps, dh)
    row = torch.zeros((n_used + 3,), dtype=torch.int32, device=dev)
    row[:n_used] = torch.randperm(n_used, generator=gen, device=dev) + 1
    pages = (kc, vc, kse, vse, row)
    kw = dict(kv_fmt=FP8_152, acc=(6, 5))
    for q in (torch.randn((t, h, dh), generator=gen, device=dev),
              _lattice(gen, (t, h, dh), dev)):
        args = (q, *pages, q_off, q_len)
        n0 = (flash_prefill_paged.launches, flash_prefill_paged.carry_launches,
              flash_prefill_paged.resume_launches)
        one = flash_prefill_paged(*args, kv_len, **kw)
        carry = flash_prefill_paged(*args, kv_len, return_carry=True, **kw)
        want = flash_prefill_paged_reference(*args, kv_len,
                                             return_carry=True, **kw)
        torch.cuda.synchronize()
        for a, b in zip(carry, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(finalize_carry(carry[0], carry[2]), one)
        stops = sorted({1, n_used // 2, n_used - 1} - {0})
        for sp in stops:
            c = flash_prefill_paged(*args, sp * ps, return_carry=True, **kw)
            res = flash_prefill_paged(*args, kv_len, carry=c, start_page=sp,
                                      **kw)
            resc = flash_prefill_paged(*args, kv_len, carry=c,
                                       start_page=sp, return_carry=True, **kw)
            plain = flash_prefill_paged_reference(*args, kv_len, carry=c,
                                                  start_page=sp, **kw)
            torch.cuda.synchronize()
            assert torch.equal(res, one), sp
            assert torch.equal(res, plain), sp
            for a, b in zip(resc, carry):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert (flash_prefill_paged.launches,
                flash_prefill_paged.carry_launches,
                flash_prefill_paged.resume_launches) == (
            n0[0] + 1, n0[1] + 1 + len(stops), n0[2] + 2 * len(stops))


def test_tp_engine_on_one_card_matches_single_device(dev):
    """Two ranks on one card (gloo, collectives through host memory) serve
    qwen2-1.5b at full width and 2 layers with 32-token prefill slabs and
    a forced preemption: tokens, every decode step's logits and the arena
    gathered from both ranks bitwise the single-device engine's under the
    same ``tp_shards=2`` plan."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.launch.serve import run_tp, serve_job
    from repro_torch.serve.plan import plan_attention

    cfg = plan_for_model(dataclasses.replace(get_config("qwen2-1.5b"),
                                             n_layers=2),
                         seq_len=96, global_batch=4,
                         policy=AccumulationPolicy(mode="predicted", chunk=64))
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in (17, 40, 64, 9)]
    n_pages = 40
    job = dict(cfg=cfg, seed=0, n_pages=n_pages, page_size=16, max_batch=4,
               prefill_chunk=32, prompts=prompts, gen=8, preempt_after=3,
               logit_step=2, plan=plan_attention((n_pages - 1) * 16, 16,
                                                 prefill_chunk_tokens=32,
                                                 tp_shards=2))
    one = serve_job(job, device=dev)
    ranks = [r["runs"][0] for r in run_tp([job], 2, dev, timeout_s=600)]
    assert all(r["tokens"] == one["tokens"] for r in ranks)
    assert ranks[0]["logit_hashes"] == one["logit_hashes"]
    assert np.array_equal(ranks[0]["logits"], one["logits"])
    for name, a in one["arena"].items():
        assert np.array_equal(ranks[0]["arena"][name], a), name
    assert ranks[0]["preemptions"] == 1 and ranks[0]["restores"] == 1


# --------------------------------------------------------------------------
# the fused GEMM's last variants: the out_fmt / pack_out epilogue of G, E
# and K8, G's int8-code and unquantized operands, E's f32 residuals
# --------------------------------------------------------------------------

G_VARIANTS = {
    "out_fmt": dict(out_fmt=(5, 2)),
    "pack_out": dict(out_fmt=(5, 2), pack_out=True),
    "packed_ab": dict(a_packed=True, b_packed=True),
    "packed_b_out": dict(b_packed=True, out_fmt=(5, 2), pack_out=True),
    "unquantized_a": dict(quantize_a=False),
    "unquantized_b_out": dict(quantize_b=False, out_fmt=(5, 2)),
}


def _variant_operands(gen, m, k, n, kw, dev, lattice, b_bf16=True):
    a = _operand(gen, (m, k), dev, lattice)
    b = _operand(gen, (k, n), dev, lattice) / (1 if lattice else 16)
    if b_bf16 and not lattice:
        b = b.to(torch.bfloat16)
    if kw.get("a_packed"):
        a = _codes(a)
    if kw.get("b_packed"):
        b = _codes(b.float())
    return a, b


def _same_variant(label, got, want, kw, acc, lattice):
    from repro_torch.quant.qtensor import unpack_block

    torch.cuda.synchronize()
    if kw.get("pack_out"):
        assert got.dtype == want.dtype == torch.int8, label
        if lattice:
            assert torch.equal(got.cpu(), want.cpu()), label
        got, want = unpack_block(got, 5, 2), unpack_block(want, 5, 2)
    fmt = kw.get("out_fmt") or acc
    if lattice:
        assert torch.equal(got.cpu(), want.cpu()), label
    else:
        assert _ulps(got.cpu(), want.cpu(), fmt[1], fmt[0]) <= 1.0, label


@pytest.mark.parametrize("rounding", ["rne", "sr"])
@pytest.mark.parametrize("m", [8, 96])
@pytest.mark.parametrize("variant", sorted(G_VARIANTS))
def test_g_variants_match_plain_on_both_routes(dev, variant, m, rounding):
    """Each of G's variants on the decode route (float operands; split and
    unsplit) and on the tile, against the plain version; the epilogue is
    the plain epilogue of the base call, bitwise."""
    from repro_torch.kernels import sm90
    from repro_torch.kernels.fused import emit_output, qmatmul_fused_with

    kw = G_VARIANTS[variant]
    k, n, chunk = 1536, 256, 64
    base = dict(repr_fmt=FP8_152, e_acc=6, m_acc=5, block_k=chunk,
                rounding=rounding, sr_seed=11)
    packed = kw.get("a_packed") or kw.get("b_packed")
    for lattice in (True, False):
        gen = torch.Generator(device=dev).manual_seed(m + len(variant))
        a, b = _variant_operands(gen, m, k, n, kw, dev, lattice)
        want = qmatmul_fused_reference(a, b, **base, **kw)
        kinds = (2 if kw.get("a_packed") else 0,
                 2 if kw.get("b_packed") else int(b.dtype == torch.bfloat16))
        scheds = [sm90.gemm_schedule(m, n, k, chunk, *kinds, stats=False)]
        if not packed:
            scheds += [_decode(m, n, k, chunk, kinds[1], 8, split)
                       for split in (False, True)]
        for s in scheds:
            got = qmatmul_fused_with(a, b, s, **base, **kw)
            _same_variant(f"{variant} {s}", got, want, kw, (6, 5), lattice)
        got = qmatmul_fused(a, b, **base, **kw)
        _same_variant(f"{variant} routed", got, want, kw, (6, 5), lattice)
        if kw.get("out_fmt"):
            plain_kw = {k_: v for k_, v in kw.items()
                        if k_ not in ("out_fmt", "pack_out")}
            c = qmatmul_fused(a, b, **base, **plain_kw)
            assert torch.equal(got.cpu(), emit_output(
                c, (5, 2), kw.get("pack_out", False)).cpu())


E_VARIANTS = {
    "out_fmt": dict(out_fmt=(5, 2)),
    "pack_out": dict(out_fmt=(5, 2), pack_out=True),
    "f32_residuals_152": dict(pack_residuals=False),
    "f32_residuals_169": dict(pack_residuals=False, repr_fmt=(6, 9)),
    "f32_residuals_out": dict(pack_residuals=False, out_fmt=(5, 2),
                              pack_out=True),
    "unquantized_a_codes": dict(quantize_a=False),
}


@pytest.mark.parametrize("rounding", ["rne", "sr"])
@pytest.mark.parametrize("variant", sorted(E_VARIANTS))
def test_emitq_variants_match_plain(dev, variant, rounding):
    """E's variants: C and the residuals (int8 codes, or float32) against
    the plain version; C the base E call's C through the plain epilogue;
    f32 residuals at (1,5,2) give the packed call's C."""
    from repro_torch.kernels.fused import emit_output

    kw = dict(E_VARIANTS[variant])
    rf = kw.pop("repr_fmt", (5, 2))
    t, k, n = 200, 1536, 320
    base = dict(repr_fmt=rf, e_acc=6, m_acc=5, block_k=64,
                return_quantized=True, rounding=rounding, sr_seed=5)
    for lattice in (True, False):
        gen = torch.Generator(device=dev).manual_seed(len(variant) * 7)
        x = _operand(gen, (t, k), dev, lattice)
        w = (_operand(gen, (k, n), dev, lattice) / (1 if lattice else 16)
             ).to(torch.bfloat16)
        c, xq, wq = qmatmul_fused(x, w, **base, **kw)
        pc, pxq, pwq = qmatmul_fused_reference(x, w, **base, **kw)
        torch.cuda.synchronize()
        assert xq.dtype == pxq.dtype and wq.dtype == pwq.dtype
        assert torch.equal(xq.cpu(), pxq.cpu()) and torch.equal(
            wq.cpu(), pwq.cpu())
        _same_variant(variant, c, pc, kw, (6, 5), lattice)
        if kw.get("out_fmt"):
            plain_kw = {k_: v for k_, v in kw.items()
                        if k_ not in ("out_fmt", "pack_out")}
            c0 = qmatmul_fused(x, w, **base, **plain_kw)[0]
            assert torch.equal(c.cpu(), emit_output(
                c0, (5, 2), kw.get("pack_out", False)).cpu())
        if variant == "f32_residuals_152":
            assert torch.equal(c, qmatmul_fused(x, w, **base)[0])


@pytest.mark.parametrize("rounding", ["rne", "sr"])
@pytest.mark.parametrize("kinds", [(0, 1), (2, 2), (0, 2)])
@pytest.mark.parametrize("pack_out", [False, True])
def test_stats_out_matches_plain_and_keeps_the_row(dev, kinds, pack_out,
                                                   rounding):
    """K8 with the epilogue: C the plain version's and the epilogue of the
    base K8 call's C; the stats row bitwise the base call's."""
    from repro_torch.kernels.fused import emit_output

    m, k, n = 96, 1536, 200
    gen = torch.Generator(device=dev).manual_seed(sum(kinds) + pack_out)
    a = _lattice(gen, (m, k), dev)
    b = _lattice(gen, (k, n), dev)
    kw = dict(repr_fmt=FP8_152, e_acc=6, m_acc=5, block_k=64,
              collect_stats=True, rounding=rounding, sr_seed=3)
    if kinds[0] == 2:
        a = _codes(a)
    if kinds[1] == 2:
        b = _codes(b)
    elif kinds[1] == 1:
        b = b.to(torch.bfloat16)
    pk = dict(a_packed=kinds[0] == 2, b_packed=kinds[1] == 2)
    c, row = qmatmul_fused(a, b, out_fmt=(5, 2), pack_out=pack_out, **pk,
                           **kw)
    c0, row0 = qmatmul_fused(a, b, **pk, **kw)
    pc = qmatmul_fused_reference(a, b, **pk, out_fmt=(5, 2),
                                 pack_out=pack_out,
                                 **{k_: v for k_, v in kw.items()
                                    if k_ != "collect_stats"})
    torch.cuda.synchronize()
    assert torch.equal(row, row0)
    assert torch.equal(c.cpu(), emit_output(c0, (5, 2), pack_out).cpu())
    assert torch.equal(c.cpu(), pc.cpu())


def test_qdot_variants_on_the_card(dev):
    """``qdot`` under ``out_fmt`` with f32 residuals bitwise the packed
    one (y, dx, dw) and the plain versions; ``qdot_packed`` the codes of
    the no-grad ``qdot``; the variants' launch counts."""
    from repro_torch.core.policy import GEMMPrecision
    from repro_torch.kernels.ops import QDotConfig, qdot, qdot_packed

    p = GEMMPrecision(m_acc=5, chunk=64)
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((2, 64, 1536), generator=gen, device=dev)
    w = (torch.randn((1536, 256), generator=gen, device=dev) / 40).to(
        torch.bfloat16)
    g = torch.randn((2, 64, 256), generator=gen, device=dev)
    runs = []
    for packs in (True, False):
        cfg = QDotConfig(fwd=p, bwd=p, grad=p, repr_fmt=FP8_152,
                         out_fmt=FP8_152, pack_residuals=packs)
        f = qmatmul_fused
        n0 = (f.emitq_out_launches, f.emitq_f32_launches)
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = qdot(xg, wg, cfg)
        y.backward(g)
        torch.cuda.synchronize()
        assert (f.emitq_out_launches - n0[0], f.emitq_f32_launches - n0[1]) \
            == ((1, 0) if packs else (0, 1))
        runs.append((y.detach(), xg.grad, wg.grad))
        assert torch.equal(quantize_block(y.detach(), 5, 2), y.detach())
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    cfg = QDotConfig(fwd=p, repr_fmt=FP8_152, out_fmt=FP8_152)
    n0 = qmatmul_fused.out_launches
    qt = qdot_packed(x[0, :8], w, cfg)
    with torch.no_grad():
        y = qdot(x[0, :8], w, cfg)
    torch.cuda.synchronize()
    assert qmatmul_fused.out_launches - n0 == 2
    assert qt.payload.dtype == torch.int8
    assert torch.equal(qt.payload, pack_block(y, 5, 2))


def test_variant_entries_match_their_mirrors(dev):
    """The variant kernels' shared memory equals kernels/sm90.py's mirror
    and two 256-thread blocks fit an SM at the paths' kinds."""
    import ctypes

    from repro_torch.kernels import build, sm90

    i3, i2 = [ctypes.c_int] * 3, [ctypes.c_int] * 2
    t_smem = build.function("qgemm", "qgemm_tile_out_smem", i3)
    t_occ = build.function("qgemm", "qgemm_tile_out_occupancy", i3)
    e_smem = build.function("qgemm_emitq", "qgemm_emitq_out_smem", i2)
    e_occ = build.function("qgemm_emitq", "qgemm_emitq_out_occupancy", i2)
    s_occ = build.function("qgemm_stats", "qgemm_stats_out_occupancy", i3)
    for a in (0, 1, 2):
        for b in (0, 1, 2):
            for groups in (1, 2, 4):
                assert t_smem(a, b, groups) == sm90.smem_bytes(
                    sm90.stage_bytes(a, b), groups, False)
            assert t_occ(a, b, 4) >= 2
            assert s_occ(a, b, 4) >= 1
    for f32 in (0, 1):
        assert e_smem(f32, 4) == sm90.emitq_schedule(
            512, 1536, 1536, 64, f32=bool(f32)).smem
        assert e_occ(f32, 4) >= 2
    occ = build.function("qgemm", "qgemm_decode_out_occupancy",
                         [ctypes.c_int] * 6)
    for _, k, n in QWEN_DECODE:
        s = sm90.decode_schedule(8, n, k, 64, 1)
        for sr in (0, 1):
            assert occ(0, 1, int(n == 151936), s.slots, 64, sr) >= 1


@pytest.mark.parametrize("rounding", ["rne", "sr"])
def test_remat_full_bitwise_none_on_the_card(dev, monkeypatch, rounding):
    """Two layers of qwen2-1.5b at full width (batch 1 x seq 256) through
    the kernels: the loss and every gradient under ``REPRO_REMAT_POLICY``
    ``full`` (the layer forward recomputed in the backward) bitwise those
    under ``none``; E runs twice a layer GEMM under ``full``, once under
    ``none``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.models.api import get_model
    from repro_torch.train.loop import _grads, compute_copy
    from repro_torch.train.optimizer import tree_leaves

    cfg = plan_for_model(
        dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2),
        seq_len=256, global_batch=1,
        policy=AccumulationPolicy(mode="predicted", chunk=64,
                                  rounding=rounding, sr_seed=7))
    model = get_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (1, 256)).astype(np.int32)).to(dev)
    counter = "sr_emitq_launches" if rounding == "sr" else "emitq_launches"
    out = {}
    for pol in ("full", "none"):
        monkeypatch.setenv("REPRO_REMAT_POLICY", pol)
        n0 = getattr(qmatmul_fused, counter)
        c = compute_copy(params)
        loss, _ = model.loss_fn(c, {"tokens": tokens}, cfg)
        loss.backward()
        torch.cuda.synchronize()
        out[pol] = (loss.detach(), tree_leaves(_grads(c, params)),
                    getattr(qmatmul_fused, counter) - n0)
    assert out["full"][2] == 2 * out["none"][2] == 2 * 7 * 2
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(out["full"][1], out["none"][1]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# serving's compiled step: CUDA graphs, P's device geometry, verify
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,kv,dh,ps,t,width", [
    (12, 2, 128, 16, 64, 24), (14, 2, 64, 16, 32, 8), (4, 2, 8, 4, 8, 6)])
def test_prefill_device_geometry_matches_host_entry(dev, h, kv, dh, ps, t,
                                                    width):
    """P's device-geometry entry (one launch shape for every geometry:
    the schedule from T and the row width) bitwise the launch-argument
    entry and the plain version on the live rows, padded rows exactly 0,
    on 22 slab geometries including ragged tails and single rows."""
    from repro_torch.kernels.attention import (
        flash_prefill_paged_geom, flash_prefill_paged_geom_reference,
        prefill_geom)

    gen = torch.Generator(device=dev).manual_seed(31)
    n_pages = width + 1
    kc = torch.randint(-127, 128, (n_pages, kv, ps, dh), generator=gen,
                       device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, (n_pages, kv, ps, dh), generator=gen,
                       device=dev, dtype=torch.int8)
    kse = torch.randint(-3, 3, (n_pages,), generator=gen, device=dev,
                        dtype=torch.int32)
    vse = torch.randint(-3, 3, (n_pages,), generator=gen, device=dev,
                        dtype=torch.int32)
    row = (torch.randperm(width, generator=gen, device=dev) + 1).to(
        torch.int32)
    kw = dict(kv_fmt=FP8_152, acc=(6, 5))
    rng = np.random.RandomState(3)
    geoms = [(0, t), (0, 1), (0, t - 3)] + [
        (ps * int(rng.randint(0, width - t // ps)), int(rng.randint(1, t + 1)))
        for _ in range(19)]
    n0 = flash_prefill_paged_geom.launches
    for t0, q_len in geoms:
        q_len = min(q_len, width * ps - t0)
        q = torch.zeros((t, h, dh), device=dev)
        q[:q_len] = torch.randn((q_len, h, dh), generator=gen, device=dev)
        geom = prefill_geom(t0, q_len, device=dev)
        got = flash_prefill_paged_geom(q, kc, vc, kse, vse, row, geom, **kw)
        want = flash_prefill_paged(q[:q_len].contiguous(), kc, vc, kse, vse,
                                   row, t0, q_len, t0 + q_len, **kw)
        plain = flash_prefill_paged_geom_reference(q, kc, vc, kse, vse, row,
                                                   geom, **kw)
        assert torch.equal(got[:q_len], want), (t0, q_len)
        assert torch.equal(got, plain), (t0, q_len)
        assert bool((got[q_len:] == 0).all()), (t0, q_len)
    assert flash_prefill_paged_geom.launches == n0 + len(geoms)


def _serve_smoke(dev, n_layers=2):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.models.api import get_model

    cfg = plan_for_model(
        dataclasses.replace(get_config("qwen2-1.5b"), n_layers=n_layers),
        seq_len=160, global_batch=4,
        policy=AccumulationPolicy(mode="predicted", chunk=64))
    model = get_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)

    def bf16(t):
        return ({k: bf16(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to(torch.bfloat16))

    return model, bf16(params)


@pytest.mark.parametrize("chunk", [None, 32])
def test_graph_replay_bitwise_eager(dev, chunk):
    """The serve engine on CUDA graphs (warmed: 0 steady-state captures)
    against the eager executor at 2 layers of qwen2-1.5b: tokens, every
    decode step's logits and the arena bitwise; launches counted over the
    replays."""
    from repro_torch.serve.kvcache import PagedKVConfig
    from repro_torch.serve.scheduler import ModelExecutor, ServeEngine

    model, params = _serve_smoke(dev)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, model.cfg.vocab_size, n).tolist()
               for n in (17, 40, 96, 5)]
    runs = {}
    for graphs in (False, True):
        pc = PagedKVConfig.for_model(model.cfg, n_pages=24, page_size=16)
        ex = ModelExecutor(model, params, pc, kv_fmt=FP8_152, max_batch=4,
                           device=dev, graphs=graphs)
        logits = []
        inner = ex.decode_logits

        def rec(req, inner=inner, logits=logits):
            out = inner(req)
            logits.append(out.float().cpu())
            return out

        ex.decode_logits = rec
        eng = ServeEngine(model, params, n_pages=24, page_size=16,
                          max_batch=4, prefill_chunk_tokens=chunk,
                          executor=ex, device=dev)
        eng.warmup()
        n0 = paged_attn_decode.launches
        with ex.compile_stats_scope() as delta:
            rids = [eng.submit(p, 6) for p in prompts]
            out = eng.run()
        torch.cuda.synchronize()
        runs[graphs] = ([out[r] for r in rids], logits,
                        {k: v.clone() for k, v in ex.kv.items()},
                        paged_attn_decode.launches - n0, delta)
    (t0, l0, a0, d0, _), (t1, l1, a1, d1, delta) = runs[False], runs[True]
    assert t0 == t1
    assert len(l0) == len(l1) and all(torch.equal(a, b)
                                      for a, b in zip(l0, l1))
    for k in a0:
        assert torch.equal(a0[k], a1[k]), k
    assert d0 == d1 > 0
    assert delta["compiles"] == 0 and delta["misses"] == 0
    assert delta["hits"] > 0


def test_collected_graph_executor_frees_its_pool(dev):
    """A warmed graph executor at 2 layers of qwen2-1.5b: once it is
    collected the process cache drops its graphs, and its pool's memory
    goes back to the card."""
    import gc
    import weakref

    from repro_torch.serve.kvcache import PagedKVConfig
    from repro_torch.serve.plan import plan_attention
    from repro_torch.serve.scheduler import ModelExecutor

    model, params = _serve_smoke(dev)
    pc = PagedKVConfig.for_model(model.cfg, n_pages=24, page_size=16)
    ex = ModelExecutor(model, params, pc, kv_fmt=FP8_152, max_batch=4,
                       device=dev, graphs=True)
    ex.warmup(plan_attention(pc.tokens_capacity, 16))
    torch.cuda.synchronize()
    pool = ex.pool_bytes()
    held = torch.cuda.memory_reserved(dev)
    entry = ex._cache
    assert pool > 0 and entry["fns"]
    ref = weakref.ref(ex)
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    assert ref() is None
    assert entry["fns"] == {} and entry["pool"] is None
    assert torch.cuda.memory_reserved(dev) <= held - pool


def test_verify_bitwise_sequential_decode_on_the_card(dev):
    """One batched verify of k + 1 = 5 tokens a row at 8 rows (40 GEMM
    rows) bitwise 5 sequential decode steps at 2 layers of qwen2-1.5b:
    logits and arena."""
    from repro_torch.models import lm
    from repro_torch.models.api import paged_init_state
    from repro_torch.serve.plan import plan_attention

    model, params = _serve_smoke(dev)
    cfg = model.cfg
    b, s_v, ps = 8, 5, 16
    plan = plan_attention(256, ps)
    _, bucket = plan.bucket_for(160)
    kv = paged_init_state(cfg, n_pages=1 + b * 8, page_size=ps, device=dev)
    rng = np.random.RandomState(4)
    lens = rng.randint(1, 100, b)
    pt = torch.zeros((b, 8), dtype=torch.int32, device=dev)
    for i, n in enumerate(lens):
        pages = torch.arange(1 + 8 * i, 1 + 8 * i + 8, dtype=torch.int32,
                             device=dev)
        pt[i] = pages
        used = pages[:-(-int(n) // ps)]
        toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, n))).to(dev)
        with torch.no_grad():
            lm.paged_prefill(params, toks, kv, pages, used.long(), 0, int(n),
                             cfg, kv_fmt=FP8_152, acc=bucket.acc,
                             want_logits=False)
    pos = torch.from_numpy(lens).to(dev)
    cand = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s_v))).to(dev)
    kv_seq = {k: v.clone() for k, v in kv.items()}
    with torch.no_grad():
        lv = lm.paged_verify(params, cand, kv, pt, pos,
                             (pos + 1).to(torch.int32), cfg, kv_fmt=FP8_152,
                             acc=bucket.acc)
        for j in range(s_v):
            lj = lm.paged_decode(params, cand[:, j:j + 1], kv_seq, pt,
                                 pos + j, (pos + 1 + j).to(torch.int32), cfg,
                                 kv_fmt=FP8_152, acc=bucket.acc)
            assert torch.equal(lv[:, j], lj[:, 0]), j
    for k in kv:
        assert torch.equal(kv[k], kv_seq[k]), k


def test_legacy_decode_step_on_the_card(dev):
    """The legacy static batch at 2 layers of qwen2-1.5b: the prompt
    replayed through ``decode_step`` (positions a device tensor) bitwise
    the training forward's logits on the card, ``prefill`` bitwise its last
    row, every GEMM through G (its launches counted), and the cache written
    at the replayed positions only."""
    model, params = _serve_smoke(dev)
    cfg = model.cfg
    b, s = 4, 32
    toks = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (b, s))).to(dev)
    pos = torch.arange(s + 4, dtype=torch.int32, device=dev)
    n0 = qmatmul_fused.launches
    with torch.no_grad():
        fwd = model.forward(params, {"tokens": toks}, cfg, remat=False)
        pre = model.prefill(params, {"tokens": toks}, cfg)
        state = model.init_decode_state(cfg, b, s + 4, dev)
        rows = []
        for i in range(s):
            logits, state = model.decode_step(params, toks[:, i:i + 1],
                                              state, pos[i], cfg)
            rows.append(logits[:, 0])
    torch.cuda.synchronize()
    replay = torch.stack(rows, dim=1)
    assert torch.equal(replay, fwd)
    assert torch.equal(pre, fwd[:, -1])
    # per step: 7 layer GEMMs a layer and the head
    assert qmatmul_fused.launches - n0 >= s * (7 * cfg.n_layers + 1)
    for name in ("k", "v"):
        t = state["layers"][name]
        assert bool(t[:, :, :s].abs().sum(dim=(0, 2, 3, 4)).gt(0).all())
        assert not bool(t[:, :, s:].any())


def test_obs_on_engine_bitwise_obs_off_on_the_card(dev):
    """The engine with a tracer and a metrics registry, eager and on CUDA
    graphs, at 2 layers of qwen2-1.5b: streams and arena bitwise the same
    engine without them; one request root a request; the token counter the
    tokens generated."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer, span_forest
    from repro_torch.serve.kvcache import PagedKVConfig
    from repro_torch.serve.scheduler import ModelExecutor, ServeEngine

    model, params = _serve_smoke(dev)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, model.cfg.vocab_size, n).tolist()
               for n in (17, 40, 70)]
    for graphs in (False, True):
        runs = []
        for obs in (False, True):
            pc = PagedKVConfig.for_model(model.cfg, n_pages=24, page_size=16)
            ex = ModelExecutor(model, params, pc, kv_fmt=FP8_152,
                               max_batch=4, device=dev, graphs=graphs)
            tracer = Tracer() if obs else None
            reg = MetricsRegistry() if obs else None
            eng = ServeEngine(model, params, n_pages=24, page_size=16,
                              max_batch=4, prefill_chunk_tokens=32,
                              executor=ex, device=dev, tracer=tracer,
                              metrics=reg)
            rids = [eng.submit(p, 6) for p in prompts]
            out = eng.run()
            torch.cuda.synchronize()
            runs.append(([out[r] for r in rids],
                         {k: v.clone() for k, v in ex.kv.items()}))
        (s0, a0), (s1, a1) = runs
        assert s0 == s1
        for k in a0:
            assert torch.equal(a0[k], a1[k]), (graphs, k)
        roots = [n for n in span_forest(tracer.spans).values()
                 if n["span"]["name"] == "request"]
        assert len(roots) == len(prompts)
        tokens = reg.counter("repro_serve_tokens_total").value()
        assert tokens == sum(len(x) for x in s1)


def test_oracle_executor_streams_equal_the_kernels(dev):
    """``ModelExecutor(oracle=True)`` (JAX's flag: the attention through
    D's and P's plain versions, eager) at 2 layers of qwen2-1.5b: streams
    and arena bitwise the kernels' eager executor, and no D or P launch."""
    from repro_torch.kernels.attention import flash_prefill_paged_geom
    from repro_torch.serve.kvcache import PagedKVConfig
    from repro_torch.serve.scheduler import ModelExecutor, ServeEngine

    model, params = _serve_smoke(dev)
    prompts = [np.random.RandomState(9).randint(
        0, model.cfg.vocab_size, n).tolist() for n in (20, 45)]
    runs = []
    for oracle in (False, True):
        pc = PagedKVConfig.for_model(model.cfg, n_pages=16, page_size=16)
        ex = ModelExecutor(model, params, pc, kv_fmt=FP8_152, max_batch=4,
                           device=dev, graphs=False, oracle=oracle)
        eng = ServeEngine(model, params, n_pages=16, page_size=16,
                          max_batch=4, executor=ex, device=dev)
        n0 = (paged_attn_decode.launches, flash_prefill_paged.launches,
              flash_prefill_paged_geom.launches)
        rids = [eng.submit(p, 5) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
        n1 = (paged_attn_decode.launches, flash_prefill_paged.launches,
              flash_prefill_paged_geom.launches)
        runs.append(([out[r] for r in rids],
                     {k: v.clone() for k, v in ex.kv.items()},
                     [b - a for a, b in zip(n0, n1)]))
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k
    assert runs[0][2][0] > 0 and sum(runs[1][2]) == 0


# --------------------------------------------------------------------------
# training over a mesh's data axis: B and K9 on K-slices, 2 ranks on one
# card
# --------------------------------------------------------------------------


@pytest.mark.parametrize("stats", [False, True], ids=["B", "K9"])
def test_pair_on_k_slices_bitwise_whole_call(dev, stats):
    """B and K9 as the data-parallel backward calls them (every row of g,
    a rank's K columns of the residual codes and K rows of w) at every
    layer shape of the training step (T = 512) and each of 2 and 4 ranks'
    slices: dx and dw bitwise the whole call's slices."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
    from repro_torch.kernels.ops import _acc_params, _pair_chunks
    from repro_torch.models.api import dense_gemm_shapes

    cfg = plan_for_model(get_config("qwen2-1.5b"), seq_len=64,
                         global_batch=8,
                         policy=AccumulationPolicy(mode="predicted",
                                                   chunk=64))
    gen = torch.Generator(device=dev).manual_seed(11)
    seen = set()
    for tag, t, k, n, qc in dense_gemm_shapes(cfg, seq_len=64,
                                              global_batch=8)[1:]:
        if (k, n) in seen:
            continue
        seen.add((k, n))
        e = _acc_params(qc.fwd)
        x = torch.randn((t, k), generator=gen, device=dev)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        _, xq, wq = qmatmul_fused(x, w, repr_fmt=qc.repr_fmt, e_acc=e[0],
                                  m_acc=e[1], block_k=e[2] or 128,
                                  return_quantized=True)
        g = torch.randn((t, n), generator=gen, device=dev) / math.sqrt(n)
        gc_, bc = _pair_chunks(qc)
        (eb, mb, _), (eg, mg, _) = _acc_params(qc.bwd), _acc_params(qc.grad)
        kw = dict(repr_fmt=qc.repr_fmt, bwd_acc=(eb, mb), grad_acc=(eg, mg),
                  bwd_chunk=bc, grad_chunk=gc_, packed=True,
                  collect_stats=stats)
        whole = qmatmul_bwd_pair(g, xq, wq, **kw)
        for ranks in (2, 4):
            ks = k // ranks
            for r in range(ranks):
                sl = slice(r * ks, (r + 1) * ks)
                part = qmatmul_bwd_pair(g, xq[:, sl].contiguous(), wq[sl],
                                        **kw)
                assert torch.equal(part[0], whole[0][:, sl]), (tag, ranks, r)
                assert torch.equal(part[1], whole[1][sl]), (tag, ranks, r)


@pytest.mark.parametrize("policy", ["predicted", "exact"])
def test_mesh_train_step_on_one_card_bitwise_single_device(dev, policy):
    """2 ranks sharing the card (gloo) train qwen2-1.5b at full width and
    2 layers for 2 steps through the launcher's ``--mesh 2x1``: losses,
    grad norms and each rank's blocks of the final params and both
    moments (by digests) bitwise the single device's.  Under the exact
    plan the layer GEMMs are cuBLAS's ``torch.matmul`` on a rank's rows
    and K-slices, whose bits depend on the row count (ROADMAP Queue 3,
    F8): losses and grad norms within 1e-3 relative (2.63e-5 measured
    over the 2 steps on the H100)."""
    from chip_smoke import block_digests, rank_digests
    from repro_torch.launch import train as LT

    argv = ["--arch", "qwen2-1.5b", "--n-layers", "2", "--policy",
            policy, "--chunk", "64", "--steps", "2", "--global-batch",
            "8", "--seq-len", "64", "--log-every", "1", "--device", "cuda"]
    shape = {"data": 2, "model": 1}
    one = LT.train(LT.parse_args(argv),
                   finish=functools.partial(block_digests, (shape,)))
    torch.cuda.empty_cache()
    ranks = LT.run_mesh([LT.MeshJob(LT.parse_args(argv + ["--mesh", "2x1"]),
                                    shape)],
                        finish=rank_digests, timeout_s=600)
    for r, [res] in enumerate(ranks):
        got = [(x["loss"], x["grad_norm"]) for x in res["records"]]
        want = [(x["loss"], x["grad_norm"]) for x in one["records"]]
        if policy == "exact":
            gap = max(abs(a - b) / abs(b) for g, w in zip(got, want)
                      for a, b in zip(g, w))
            print(f"exact plan, rank {r}: largest relative gap {gap:.3g} "
                  f"over {got} against {want}")
            assert len(got) == len(want) and gap <= 1e-3
        else:
            assert got == want
            assert res["digests"] == one["block_digests"][
                "2x1 (data, model)"][r]


def test_model_axis_step_on_one_card_bitwise_single_device(dev):
    """``--mesh 1x2``: 2 ranks sharing the card (gloo) split every GEMM's
    output columns and its backward's K-slices over the model axis;
    qwen2-1.5b at full width and 2 layers, 2 steps of the predicted plan:
    losses, grad norms and each rank's blocks of the final state (by
    digests) bitwise the single device's."""
    from chip_smoke import block_digests, rank_digests
    from repro_torch.launch import train as LT

    argv = ["--arch", "qwen2-1.5b", "--n-layers", "2", "--policy",
            "predicted", "--chunk", "64", "--steps", "2", "--global-batch",
            "8", "--seq-len", "64", "--log-every", "1", "--device", "cuda"]
    shape = {"data": 1, "model": 2}
    one = LT.train(LT.parse_args(argv),
                   finish=functools.partial(block_digests, (shape,)))
    torch.cuda.empty_cache()
    ranks = LT.run_mesh([LT.MeshJob(LT.parse_args(argv + ["--mesh", "1x2"]),
                                    shape)],
                        finish=rank_digests, timeout_s=600)
    for r, [res] in enumerate(ranks):
        assert [(x["loss"], x["grad_norm"]) for x in res["records"]] == \
            [(x["loss"], x["grad_norm"]) for x in one["records"]]
        assert res["digests"] == one["block_digests"]["1x2 (data, model)"][r]


def _sr_plan_kw():
    """E's and B's SR keywords at every distinct layer shape of the train
    cell (T = 512, the plan's chunk 64, the SR plan's role seeds)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import AccumulationPolicy, plan_for_model
    from repro_torch.kernels.ops import _fwd_kw, _pair_kw
    from repro_torch.models.api import dense_gemm_shapes

    cfg = plan_for_model(get_config("qwen2-1.5b"), seq_len=64,
                         global_batch=8,
                         policy=AccumulationPolicy(mode="predicted",
                                                   chunk=64, rounding="sr",
                                                   sr_seed=7))
    out, seen = [], set()
    for tag, t, k, n, qc in dense_gemm_shapes(cfg, seq_len=64,
                                              global_batch=8)[1:]:
        if (k, n) not in seen:
            seen.add((k, n))
            ekw = _fwd_kw(qc, qc.sr_seed)
            ekw.pop("out_fmt")
            out.append((tag, t, k, n, ekw, _pair_kw(qc, qc.sr_seed)))
    return out


def test_sr_origins_match_whole_call_and_plain(dev):
    """The SR keys' origins at every layer shape of the training step (T =
    512): E, K8 (on E's codes) and G (both routes: the tile at a rank's
    256 rows, the decode kernel at 8 of 16) on each of 2 ranks' rows
    (``row0``) and columns (``col0``, ``n_cols``), bitwise the whole SR
    call's block and the plain version on rank 1's block; B and K9 on 2
    ranks' K-slices (``k_offset``, ``k_total``) bitwise the whole SR
    pair's slices and, rank 1's, the plain version."""
    from repro_torch.kernels import sm90
    from repro_torch.kernels.bwd_pair import (qmatmul_bwd_pair,
                                              qmatmul_bwd_pair_reference)
    from repro_torch.kernels.fused import (qmatmul_fused_stats_reference,
                                           qmatmul_fused_with)

    gen = torch.Generator(device=dev).manual_seed(29)
    for tag, t, k, n, ekw, bkw in _sr_plan_kw():
        x = torch.randn((t, k), generator=gen, device=dev)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        g = torch.randn((t, n), generator=gen, device=dev) / math.sqrt(n)
        y, xq, wq = qmatmul_fused(x, w, return_quantized=True, **ekw)
        k8 = dict(ekw, quantize_a=False, quantize_b=False, a_packed=True,
                  b_packed=True)
        for r in range(2):
            for rows, cols in ((slice(r * t // 2, (r + 1) * t // 2),
                                slice(0, n)),
                               (slice(0, t),
                                slice(r * n // 2, (r + 1) * n // 2))):
                o = dict(row0=rows.start, col0=cols.start, n_cols=n)
                want = y[rows, cols]
                got = [qmatmul_fused(x[rows], w[:, cols], **ekw, **o),
                       qmatmul_fused(x[rows], w[:, cols],
                                     return_quantized=True, **ekw, **o)[0],
                       qmatmul_fused(xq[rows], wq[:, cols],
                                     collect_stats=True, **k8, **o)[0]]
                for c in got:
                    assert torch.equal(c, want), (tag, r, o)
                if r == 1:
                    plain = qmatmul_fused_stats_reference(
                        xq[rows], wq[:, cols], **k8, **o)[0]
                    assert torch.equal(got[2], plain), (tag, o)
                    assert torch.equal(got[0], qmatmul_fused_reference(
                        x[rows], w[:, cols], **ekw, **o)), (tag, o)
        dec = sm90.decode_schedule(8, n, k, ekw["block_k"], 1)
        whole = qmatmul_fused(x[:16], w, **ekw)
        for r in range(2):
            got = qmatmul_fused_with(x[8 * r:8 * r + 8], w, dec, row0=8 * r,
                                     **ekw)
            assert torch.equal(got, whole[8 * r:8 * r + 8]), (tag, r)
        dx, dw = qmatmul_bwd_pair(g, xq, wq, **bkw)
        ks = k // 2
        for r in range(2):
            sl = slice(r * ks, (r + 1) * ks)
            o = dict(k_offset=r * ks, k_total=k)
            xs, ws = xq[:, sl].contiguous(), wq[sl]
            for stats in (False, True):
                part = qmatmul_bwd_pair(g, xs, ws, collect_stats=stats,
                                        **bkw, **o)
                assert torch.equal(part[0], dx[:, sl]), (tag, r, stats)
                assert torch.equal(part[1], dw[sl]), (tag, r, stats)
            if r == 1:
                pdx, pdw = qmatmul_bwd_pair_reference(g, xs, ws, **bkw, **o)
                assert torch.equal(part[0], pdx) and \
                    torch.equal(part[1], pdw), tag


# the MoE expert GEMMs ([families]): moonshot-v1-16b-a3b's gate/up (K 2048,
# N 1408) and down (K 1408, N 2048) at the expert capacities of a decode
# step (1), a 64-token slab (7) and the 8 x 64 training step (60); no
# representation format, the (8, 23) carry at chunk 128 in all three roles
EXPERT_SHAPES = ((2048, 1408), (1408, 2048))


def _expert_operands(gen, shape, dev, lattice):
    """f32 operands: (1,5,2) lattice points, or bf16-rounded normals (the
    experts' activations and weights are bf16 values)."""
    if lattice:
        return _lattice(gen, shape, dev)
    return torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16).float()


@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("m", [1, 7, 60])
@pytest.mark.parametrize("k,n", EXPERT_SHAPES)
def test_expert_g_matches_plain(dev, k, n, m, lattice):
    """G at the expert shapes, f32 operands and the weights as bf16 (the
    layer's call), bitwise its plain version; after the decode kernel's
    occupancy report at a shorter chunk (``chip_smoke``'s ``[build]``
    lines), which must not lower its shared memory limit under a chunk-128
    launch's."""
    import ctypes

    from repro_torch.kernels import build

    occ = build.function("qgemm", "qgemm_decode_occupancy",
                         [ctypes.c_int] * 6)
    for b_bf16 in (0, 1):
        for slots in (1, 2, 4, 8):
            assert occ(0, b_bf16, 0, slots, 64, 0) > 0
    gen = torch.Generator(device=dev).manual_seed(m * 7 + k)
    kw = dict(repr_fmt=None, e_acc=8, m_acc=23, block_k=128)
    a = _expert_operands(gen, (m, k), dev, lattice)
    b = _expert_operands(gen, (k, n), dev, lattice) / 8
    for w in (b, b.to(torch.bfloat16)):
        n0 = qmatmul_fused.launches
        got = qmatmul_fused(a, w, **kw)
        want = qmatmul_fused_reference(a, w, **kw)
        torch.cuda.synchronize()
        assert qmatmul_fused.launches == n0 + 1
        assert torch.equal(got, want)


@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("k,n", EXPERT_SHAPES)
def test_expert_b_matches_plain(dev, k, n, lattice):
    """B at T = 60 (the training step's capacity) with raw f32 residuals
    (and the weights as bf16), g unquantized, both chunks 128 at (8, 23):
    dx and dw bitwise the plain version."""
    from repro_torch.kernels.bwd_pair import (
        qmatmul_bwd_pair, qmatmul_bwd_pair_reference)

    gen = torch.Generator(device=dev).manual_seed(k + 60)
    kw = dict(repr_fmt=None, bwd_acc=(8, 23), grad_acc=(8, 23),
              bwd_chunk=128, grad_chunk=128, packed=False, quantize_g=False)
    g = _expert_operands(gen, (60, n), dev, lattice)
    x = _expert_operands(gen, (60, k), dev, lattice)
    w = _expert_operands(gen, (k, n), dev, lattice) / 8
    for wq in (w, w.to(torch.bfloat16)):
        n0 = qmatmul_bwd_pair.launches
        got = qmatmul_bwd_pair(g, x, wq, **kw)
        want = qmatmul_bwd_pair_reference(g, x, wq, **kw)
        torch.cuda.synchronize()
        assert qmatmul_bwd_pair.launches == n0 + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)
