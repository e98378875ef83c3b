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


@pytest.mark.parametrize("h,kv,dh,acc", [(12, 2, 128, (6, 5)),
                                         (4, 2, 16, (8, 23))])
def test_decode_kernel_matches_plain(dev, h, kv, dh, acc):
    gen = torch.Generator(device=dev).manual_seed(h * dh)
    lens = [0, 17, 64, 100, 129, 256, 311, 384]
    width = 24
    n_pages = 1 + sum(-(-s // 16) for s in lens)
    kc, vc, kse, vse = _arena(gen, dev, n_pages, kv, 16, dh)
    pt = torch.zeros((len(lens), width), dtype=torch.int32, device=dev)
    nxt = 1
    for b, s in enumerate(lens):
        np_ = -(-s // 16)
        pt[b, :np_] = torch.arange(nxt, nxt + np_, device=dev)
        nxt += np_
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((len(lens), h, dh), generator=gen, device=dev)
    args = (kc, vc, kse, vse, pt, sl)
    got = paged_attn_decode(q, *args, kv_fmt=FP8_152, acc=acc)
    want = paged_attn_decode_reference(q, *args, kv_fmt=FP8_152, acc=acc)
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all())
    _attn_ok(got, want, acc)


@pytest.mark.parametrize("t,q_off,q_len,start_page", [
    (64, 320, 64, 0), (24, 16, 21, 0), (16, 48, 16, 2)])
def test_prefill_kernel_matches_plain(dev, t, q_off, q_len, start_page):
    gen = torch.Generator(device=dev).manual_seed(t + q_off)
    h, kv, dh, acc = 12, 2, 128, (6, 5)
    kv_len = q_off + q_len
    n_used = -(-kv_len // 16)
    kc, vc, kse, vse = _arena(gen, dev, n_used + 1, kv, 16, dh)
    row = torch.zeros((n_used + 3,), dtype=torch.int32, device=dev)
    row[:n_used] = torch.randperm(n_used, generator=gen, device=dev) + 1
    q = torch.randn((t, h, dh), generator=gen, device=dev)
    args = (kc, vc, kse, vse, row, q_off, q_len, kv_len)
    kw = dict(kv_fmt=FP8_152, acc=acc, start_page=start_page)
    got = flash_prefill_paged(q, *args, **kw)
    want = flash_prefill_paged_reference(q, *args, **kw)
    torch.cuda.synchronize()
    assert bool((got[q_len:] == 0).all())
    _attn_ok(got, want, acc)


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
