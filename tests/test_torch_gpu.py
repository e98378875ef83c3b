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
