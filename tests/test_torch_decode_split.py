"""D's and K12's split page walk (``csrc/paged_decode.cu``) on the CPU.

A plain model of the kernel's schedule: each rank of a cluster takes the
contiguous pages ``decode_rounds`` gives it (the kernel's own split of a
round, mirrored here), forms their scores and
publishes each page's ceil max (phase A); the running max comes from the
ranks' maxima in page order; each page's probabilities, l sum and p.v are
formed from its own running max alone (phase B); the carries fold in page
order; K12's row is summed from one partial row a (sequence, KV head,
rank), each over the rank's slice of the outputs.  Held bitwise against
the sequential walk ``_decode_walk`` on random operands at every cluster
size 1..8, with rows that take several rounds; K12's counters and
MAX_ABS bitwise, its sums within ``SUM_REL``/``SUM_ABS``.  Then the
schedule function pinned at the serve shapes.  The kernel itself runs
only on the card (``tests/test_torch_gpu.py``).
"""

from __future__ import annotations

import inspect
import struct

import numpy as np
import pytest
import torch

from repro_torch.kernels import sm90
from repro_torch.kernels.attention import (
    NEG,
    _decode_walk,
    _page_values,
    _scale,
    _scale_f32,
    _seq_dot,
    paged_attn_decode,
)
from repro_torch.kernels.common import N_STATS, quantize_block, stats_gap
from repro_torch.quant.formats import FP8_152, fmt_tuple
from repro_torch.quant.qtensor import pack_block

KV, G, DH, PS = 2, 3, 16, 4
# rows ending mid-page, a length-0 row, whole pages; the table is wider
LENS = [0, 3, 17, 40, 61, 8]
WIDTH = 20
FMT = fmt_tuple(FP8_152)
# one page a rank a round: the 16-page row takes 16 / cluster rounds (2
# to 16).  The round size cannot change the result, since the rounds walk
# the pages once in order (test_rounds_cover_each_page_once_in_order).
RANK_PAGES = 1


def decode_rounds(n_pages: int, cluster: int, rank_pages: int):
    """The kernel's page walk of a row of ``n_pages`` pages
    (``csrc/paged_decode.cu``, a round's ``npr``/``per``/``my0``): a list
    of rounds, each the ``cluster`` ranks' contiguous ``[start, end)``
    page ranges in page order, together the round's ``cluster *
    rank_pages`` pages (fewer in the last), split as evenly as whole
    pages allow."""
    cap = cluster * rank_pages
    rounds = []
    for base in range(0, n_pages, cap):
        npr = min(cap, n_pages - base)
        per = -(-npr // cluster)
        rounds.append([(base + min(q * per, npr), base + min((q + 1) * per, npr))
                       for q in range(cluster)])
    return rounds


def _operands(seed):
    rng = np.random.RandomState(seed)
    n_pages = 1 + sum(-(-s // PS) for s in LENS)

    def codes():
        x = torch.from_numpy(rng.randn(n_pages, KV, PS, DH).astype(np.float32))
        return pack_block(quantize_block(x, 5, 2), 5, 2)

    kc, vc = codes(), codes()
    kse = torch.from_numpy(rng.randint(-2, 3, n_pages).astype(np.int32))
    vse = torch.from_numpy(rng.randint(-2, 3, n_pages).astype(np.int32))
    pt = np.zeros((len(LENS), WIDTH), np.int32)
    perm = rng.permutation(n_pages - 1) + 1
    used = 0
    for b, s in enumerate(LENS):
        n = -(-s // PS)
        pt[b, :n] = perm[used:used + n]
        used += n
    q = torch.from_numpy(rng.randn(len(LENS), KV * G, DH).astype(np.float32))
    return q, kc, vc, kse, vse, torch.from_numpy(pt), torch.tensor(
        LENS, dtype=torch.int32)


def _split_decode(q, kc, vc, kse, vse, pt, sl, *, acc, cluster):
    """The kernel's schedule in plain PyTorch: ``(out, row)``.

    Every elementwise step runs on tensors of the walk's shapes (a page
    column of every row at once), so a transcendental sees its operands
    where the walk's does."""
    b, h, dh = q.shape
    g, e_acc, m_acc = h // KV, *acc
    q4 = q.reshape(b, KV, g, dh)
    scale = _scale(dh)
    lens = sl.long()
    n_pages = [-(-int(n) // PS) for n in sl.tolist()]
    # phase A: every page's scores and ceil max, each page on its own
    s, valid, cmax = [], [], []
    for p in range(pt.shape[1]):
        pid = pt[:, p].long()
        sp = _seq_dot(q4, _page_values(kc[pid], kse[pid], FMT)) * scale
        tok = p * PS + torch.arange(PS)
        vp = (tok < lens[:, None, None, None]).expand_as(sp)
        sp = torch.where(vp, sp, torch.full_like(sp, NEG))
        s.append(sp)
        valid.append(vp)
        cmax.append(torch.ceil(torch.amax(sp, dim=-1, keepdim=True)))
    # the running max: every rank reads the round's maxima of every rank
    # in page order, from the max carried out of the round before
    m_prev = [torch.full((b, KV, g, 1), NEG) for _ in s]
    m_new = [torch.full((b, KV, g, 1), NEG) for _ in s]
    for row in range(b):
        m = torch.full((KV, g, 1), NEG)
        for rnd in decode_rounds(n_pages[row], cluster, RANK_PAGES):
            for lo, hi in rnd:
                for p in range(lo, hi):
                    mn = torch.maximum(m, cmax[p][row])
                    m_prev[p][row], m_new[p][row] = m, mn
                    m = mn
    # phase B: each page's rescale, probabilities, l sum and p.v from its
    # own running max alone
    parts = []
    for p, sp in enumerate(s):
        pid = pt[:, p].long()
        vb = _page_values(vc[pid], vse[pid], FMT)
        alpha = torch.exp2(m_prev[p] - m_new[p])
        pr = torch.where(valid[p], torch.exp2(sp - m_new[p]),
                         torch.zeros_like(sp))
        lsum = torch.zeros((b, KV, g, 1))
        pv = torch.zeros((b, KV, g, dh))
        for t in range(PS):
            lsum = lsum + pr[..., t:t + 1]
            pv = pv + pr[..., t:t + 1] * vb[..., None, t, :]
        parts.append((alpha, lsum, pv))
    # the fold in page order, stopping at each row's last page
    o = torch.zeros((b, KV, g, dh))
    l = torch.zeros((b, KV, g, 1))
    oi = torch.zeros_like(o)
    adds = torch.zeros_like(o, dtype=torch.float64)
    swamped = torch.zeros_like(adds)
    max_abs = torch.zeros_like(o)
    for p, (alpha, lsum, pv) in enumerate(parts):
        live = torch.tensor([p < n for n in n_pages])[:, None, None, None]
        scaled = o * alpha
        o_new = quantize_block(scaled + pv, e_acc, m_acc)
        nz = (pv != 0.0) & live
        adds += nz
        swamped += nz & (o_new == scaled)
        o = torch.where(live, o_new, o)
        oi = torch.where(live, oi * alpha + pv, oi)
        l = torch.where(live, quantize_block(l * alpha + lsum, e_acc, m_acc), l)
        max_abs = torch.where(live, torch.maximum(max_abs, o.abs()), max_abs)
    pos = l > 0.0
    out = torch.where(pos, o / torch.where(pos, l, torch.ones_like(l)),
                      torch.zeros_like(o)).reshape(b, h, dh)
    # one partial row a (sequence, KV head, rank), over the rank's slice
    # of the g * dh outputs, then the rows summed in order
    per_o = -(-g * dh // cluster)
    flat = lambda x: x.reshape(b, KV, g * dh).double()
    qo, wo, a, sw, mx = map(flat, (o, oi, adds, swamped, max_abs))
    rows = []
    for row in range(b):
        for hk in range(KV):
            for rank in range(cluster):
                sl_ = slice(rank * per_o, (rank + 1) * per_o)
                r = torch.zeros(N_STATS, dtype=torch.float64)
                r[7] = a[row, hk, sl_].sum()
                r[6] = sw[row, hk, sl_].sum()
                r[5] = mx[row, hk, sl_].max() if mx[row, hk, sl_].numel() else 0.0
                if n_pages[row]:
                    x, w = qo[row, hk, sl_], wo[row, hk, sl_]
                    r[0] = x.numel()
                    r[1], r[2] = x.sum(), (x * x).sum()
                    r[3], r[4] = w.sum(), (w * w).sum()
                    r[8], r[9] = (x - w).sum(), ((x - w) ** 2).sum()
                rows.append(r)
    total = torch.zeros(N_STATS, dtype=torch.float64)
    for r in rows:
        mx5 = torch.maximum(total[5], r[5])
        total = total + r
        total[5] = mx5
    return out, total.float()


@pytest.mark.parametrize("cluster", range(1, 9))
@pytest.mark.parametrize("acc", [(6, 5), (5, 2), (8, 23)])
def test_split_walk_is_bitwise_the_walk(cluster, acc):
    """D's output bitwise the walk's and K12's counters and MAX_ABS
    bitwise, its sums within the bound, at every cluster size (which sets
    K12's partition of the outputs into partial rows) and at the serve
    carry, a narrow one that swamps often and the f32 identity."""
    args = _operands(cluster)
    want, want_row = _decode_walk(*args, kv_fmt=FP8_152, acc=acc, stats=True)
    got, row = _split_decode(*args, acc=acc, cluster=cluster)
    assert torch.equal(got, want)
    assert bool((got[0] == 0).all())            # the length-0 row
    exact, ratio = stats_gap(row, want_row)
    assert exact, (row, want_row)
    assert ratio <= 1.0
    assert float(row[0]) == (len(LENS) - 1) * KV * G * DH


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("rank_pages", [1, 3, 8])
def test_rounds_cover_each_page_once_in_order(cluster, rank_pages):
    """Each round is ``cluster * rank_pages`` pages (fewer in the last),
    split into contiguous rank ranges of at most ``rank_pages``, and the
    rounds together walk pages 0..n-1 once, in order."""
    for n in range(0, 70):
        rounds = decode_rounds(n, cluster, rank_pages)
        walked = [p for rnd in rounds for lo, hi in rnd for p in range(lo, hi)]
        assert walked == list(range(n))
        for rnd in rounds:
            assert len(rnd) == cluster
            assert all(0 <= hi - lo <= rank_pages for lo, hi in rnd)
            assert all(rnd[i][1] == rnd[i + 1][0] for i in range(cluster - 1))
        assert len(rounds) == -(-n // (cluster * rank_pages))


def _pinned(width: int):
    """(cluster, rank_pages) at B 1 or 8 and KV 2: the largest power of two
    up to 8 and up to the width, then enough pages a block for the width
    in one round, at most 6 (7 pages would take more than 112 KB)."""
    cl = 1 if width < 2 else 2 if width < 4 else 4 if width < 8 else 8
    return cl, min(6, -(-width // cl))


# qwen2-1.5b's decode attention (g 6, page 16, dh 128): a block's shared
# memory at each (cluster, rank_pages) the serve shapes give
SMEM_AT = {(1, 1): 28528, (2, 1): 25504, (2, 2): 41680, (4, 1): 24112,
           (4, 2): 40432, (8, 1): 23632, (8, 2): 40240, (8, 3): 56896,
           (8, 4): 73504, (8, 6): 106784}


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("width", list(range(1, 27)) + [64, 119, 256])
def test_decode_same_shape_same_schedule(b, width):
    """The schedule is a function of B, KV and the page-table width alone,
    pinned at the serve arena (B 8), the monitor's B 1, widths 1..26, the
    serve plan's buckets (16, 64 and 119 pages) and the 4096-token row (256
    pages: 8 blocks of 6 pages a round, 6 rounds)."""
    sm90.attn_decode_schedule.cache_clear()
    got = sm90.attn_decode_schedule(b, 2, width, 6, 16, 128)
    cl, r = _pinned(width)
    assert got == sm90.AttnDecodeSchedule(cl, r, SMEM_AT[(cl, r)], b * 2 * cl)
    assert sm90.decode_cluster(b, 2, width) == cl


def test_decode_schedule_bounds_and_grid():
    """Shared memory stays within a block's for any width and every head
    shape the kernel takes; the grid stays within the card's SMs where
    the cluster is larger than one."""
    for width in (1, 7, 26, 256, 4096, 10 ** 6):
        for g, ps, dh in ((1, 1, 4), (6, 16, 128), (8, 32, 128), (8, 32, 3)):
            for b in (1, 8, 16, 33, 500):
                s = sm90.attn_decode_schedule(b, 2, width, g, ps, dh)
                assert s.smem <= sm90.SMEM_LIMIT - 1024
                assert s.rank_pages == 1 or s.smem <= sm90.ATTN_SMEM_BUDGET
                assert 1 <= s.cluster <= sm90.ATTN_CLUSTER_MAX
                assert s.cluster == 1 or s.blocks <= sm90.SMS
                assert s.cluster <= width
    assert sm90.decode_cluster(16, 2, 26) == 4
    assert sm90.decode_cluster(33, 2, 26) == 2      # 132 blocks
    assert sm90.decode_cluster(34, 2, 26) == 1


def test_scale_f32_has_the_scale_bits():
    """The launch's cached score scale has ``_scale(dh)``'s f32 bits."""
    for dh in range(1, 257):
        got = struct.pack("<f", _scale_f32(dh))
        assert got == _scale(dh).numpy().tobytes(), dh


def test_decode_wrapper_adds_no_host_sync():
    """The CUDA path reads only host-known shapes: no device value is
    brought to the host."""
    src = inspect.getsource(paged_attn_decode)
    for call in (".item(", ".tolist(", ".cpu(", "int(seq_lens", ".numpy("):
        assert call not in src
