"""P's and K10's split page walk (``csrc/attn_prefill_sm90.cuh``) on the CPU.

A plain model of the kernels' schedule: the query rows are cut into tiles
of ``rows``; each tile walks its pages from the first it attends to the
last its last live row can see, in rounds of ``cluster * rank_pages``
pages (``prefill_rounds``, the kernel's own split of a round, mirrored
here), each rank a contiguous run.  Phase A forms every page's scores
and ceil maxima; the running max of each page comes from the round's
maxima in page order alone; phase B forms each page's rescale,
probabilities, l sum and p.v from its own running max alone, p.v a rank's
slice of the head's columns at a time; the carries fold in page order.
Held bitwise against the sequential walks ``flash_prefill_paged_reference``
(P: ``start_page > 0``, padded rows, a row that ends mid-page) and
``flash_prefill_reference`` (K10 at chunk 16, 64 and 128, one-shot, and
with the carry out at a chunk multiple and then in), for g in {1, 3, 6}
at every tile, cluster and round size the schedule can pick.  Every
transcendental runs on tensors of the plain version's shapes, so that
``exp2`` sees its operands where the walk's does.  Then the schedule
pinned at the serve shapes.  The kernels themselves run only on the card
(``tests/test_torch_gpu.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import sm90
from repro_torch.kernels.attention import (
    NEG,
    _page_values,
    _scale,
    _seq_dot,
    flash_prefill_paged_reference,
    flash_prefill_reference,
)
from repro_torch.kernels.common import quantize_block
from repro_torch.quant.formats import FP8_152, fmt_tuple
from repro_torch.quant.qtensor import pack_block

KV, DH, PS = 2, 16, 4
FMT = fmt_tuple(FP8_152)
ACC = (6, 5)


def prefill_rounds(first: int, end: int, cluster: int, rank_pages: int):
    """The kernel's page walk of a tile over pages ``[first, end)``
    (``attn_prefill_sm90.cuh``, a round's ``npr``/``per``/``my0``): a list
    of rounds, each the ``cluster`` ranks' contiguous ``[start, end)``
    page ranges in page order, together the round's ``cluster *
    rank_pages`` pages (fewer in the last)."""
    cap, rounds = cluster * rank_pages, []
    for base in range(first, end, cap):
        npr = min(cap, end - base)
        per = -(-npr // cluster)
        rounds.append([(base + min(r * per, npr), base + min((r + 1) * per, npr))
                       for r in range(cluster)])
    return rounds


def _split_walk(qt, steps, *, ps, q_offset, col0, live_rows, first, rows,
                cluster, rank_pages, acc, carry=None):
    """The kernels' schedule in plain PyTorch over ``steps``, the walk's
    pages of ``ps`` tokens as the plain version forms them: ``(kb, vb,
    valid)`` with kb, vb (h, tokens, dh) and valid (h, T, tokens), the
    last of them at the last column.  Returns the raw (o, m, l),
    (h, T, dh), (h, T, 1), (h, T, 1)."""
    h, t, dh = qt.shape
    e_acc, m_acc = acc
    scale = _scale(dh)
    if carry is None:
        o = torch.zeros((h, t, dh))
        m = torch.full((h, t, 1), NEG)
        l = torch.zeros((h, t, 1))
    else:
        o, m, l = (c.clone() for c in carry)
    # each tile's walk: from `first` to its last live row's causal reach
    walks = []
    for r0 in range(0, t, rows):
        last = min(r0 + rows, live_rows) - 1
        reach = q_offset + last - col0
        n_causal = reach // ps + 1 if last >= r0 and reach >= 0 else 0
        walks.append((r0, min(r0 + rows, t), min(len(steps), n_causal)))
    # phase A: every page's scores and ceil max, each page on its own
    s, cmax = [], []
    for kb, _, valid in steps:
        sp = _seq_dot(qt, kb) * scale
        sp = torch.where(valid, sp, torch.full_like(sp, NEG))
        s.append(sp)
        cmax.append(torch.ceil(torch.amax(sp, dim=-1, keepdim=True)))
    # the running max of every walked page: each tile's rounds read every
    # rank's maxima in page order, from the max carried out of the round
    # before
    m_prev = [m.clone() for _ in steps]
    m_new = [m.clone() for _ in steps]
    for r0, r1, end in walks:
        mm = m[:, r0:r1]
        for rnd in prefill_rounds(first, end, cluster, rank_pages):
            for lo, hi in rnd:
                for p in range(lo, hi):
                    mn = torch.maximum(mm, cmax[p][:, r0:r1])
                    m_prev[p][:, r0:r1], m_new[p][:, r0:r1] = mm, mn
                    mm = mn
    # phase B: each page's rescale, probabilities, l sum and p.v from its
    # own running max alone, the p.v a rank's columns at a time
    dsl = (-(-dh // cluster) + 3) // 4 * 4       # a rank's columns
    parts = []
    for p, (kb, vb, valid) in enumerate(steps):
        alpha = torch.exp2(m_prev[p] - m_new[p])
        pr = torch.where(valid, torch.exp2(s[p] - m_new[p]),
                         torch.zeros_like(s[p]))
        lsum = torch.zeros((h, t, 1))
        for j in range(pr.shape[-1]):
            lsum = lsum + pr[..., j:j + 1]
        pv = torch.zeros((h, t, dh))
        for rank in range(cluster):
            cols = slice(rank * dsl, (rank + 1) * dsl)
            acc_ = torch.zeros_like(pv[..., cols])
            for j in range(pr.shape[-1]):
                acc_ = acc_ + pr[..., j:j + 1] * vb[..., None, j, cols]
            pv[..., cols] = acc_
        parts.append((alpha, lsum, pv))
    # the fold: each tile's pages in page order, round by round
    for r0, r1, end in walks:
        for rnd in prefill_rounds(first, end, cluster, rank_pages):
            for lo, hi in rnd:
                for p in range(lo, hi):
                    alpha, lsum, pv = (x[:, r0:r1] for x in parts[p])
                    o[:, r0:r1] = quantize_block(o[:, r0:r1] * alpha + pv,
                                                 e_acc, m_acc)
                    l[:, r0:r1] = quantize_block(l[:, r0:r1] * alpha + lsum,
                                                 e_acc, m_acc)
                    m[:, r0:r1] = m_new[p][:, r0:r1]
    return o, m, l


def _finalize(o, l):
    pos = l > 0.0
    return torch.where(pos, o / torch.where(pos, l, torch.ones_like(l)),
                       torch.zeros_like(o))


# --------------------------------------------------------------------------
# P: the bucketed prefill off the paged arena
# --------------------------------------------------------------------------

# a 20-row slab (3 padded rows) at q_offset 8 over 25 live tokens (the last
# row ends one token into its page), pages before 1 masked, a wider row
P_T, P_Q_OFF, P_Q_LEN, P_START, P_WIDTH = 20, 8, 17, 1, 9
P_KV_LEN = P_Q_OFF + P_Q_LEN


def _p_operands(seed, g):
    rng = np.random.RandomState(seed)
    n_used = -(-P_KV_LEN // PS)

    def codes():
        x = torch.from_numpy(rng.randn(n_used + 2, KV, PS, DH).astype(
            np.float32))
        return pack_block(quantize_block(x, 5, 2), 5, 2)

    kc, vc = codes(), codes()
    kse = torch.from_numpy(rng.randint(-2, 3, n_used + 2).astype(np.int32))
    vse = torch.from_numpy(rng.randint(-2, 3, n_used + 2).astype(np.int32))
    row = np.zeros(P_WIDTH, np.int32)
    row[:n_used] = rng.permutation(n_used + 1)[:n_used] + 1
    q = torch.from_numpy(rng.randn(P_T, KV * g, DH).astype(np.float32))
    return q, kc, vc, kse, vse, torch.from_numpy(row)


def _p_steps(q, kc, vc, kse, vse, row):
    """P's pages as ``flash_prefill_paged_reference`` forms them."""
    g = q.shape[1] // KV
    rloc = torch.arange(q.shape[0])[:, None]
    steps = []
    for p in range(-(-P_KV_LEN // PS)):
        pid = row[p].long()
        kb = _page_values(kc[pid], kse[pid], FMT).repeat_interleave(g, dim=0)
        vb = _page_values(vc[pid], vse[pid], FMT).repeat_interleave(g, dim=0)
        cols = p * PS + torch.arange(PS)[None, :]
        valid = ((cols <= P_Q_OFF + rloc) & (cols < P_KV_LEN)
                 & (rloc < P_Q_LEN) & (p >= P_START))
        steps.append((kb, vb, valid.expand(q.shape[1], -1, -1)))
    return steps


# (rows, cluster, rank_pages): every tile, cluster and round size the
# schedule can pick, with walks of several rounds
SPLITS = [(1, 1, 1), (2, 2, 2), (4, 4, 1), (8, 8, 1), (8, 2, 3), (4, 1, 8)]


@pytest.mark.parametrize("g", [1, 3, 6])
@pytest.mark.parametrize("rows,cluster,rank_pages", SPLITS)
def test_split_walk_is_bitwise_p(g, rows, cluster, rank_pages):
    """P's schedule bitwise ``flash_prefill_paged_reference`` on random
    operands; padded rows exactly 0."""
    args = _p_operands(100 * g + 10 * rows + cluster, g)
    want = flash_prefill_paged_reference(
        *args, P_Q_OFF, P_Q_LEN, P_KV_LEN, kv_fmt=FP8_152, acc=ACC,
        start_page=P_START)
    o, _, l = _split_walk(
        args[0].transpose(0, 1), _p_steps(*args), ps=PS, q_offset=P_Q_OFF,
        col0=0, live_rows=P_Q_LEN, first=P_START, rows=rows,
        cluster=cluster, rank_pages=rank_pages, acc=ACC)
    got = _finalize(o, l).transpose(0, 1)
    assert torch.equal(got, want)
    assert bool((got[P_Q_LEN:] == 0).all())


# --------------------------------------------------------------------------
# K10: the dense resumable prefill
# --------------------------------------------------------------------------


def _k10_steps(qt, k, v, chunk, q_offset, kv_offset):
    """K10's chunks as ``flash_prefill_reference`` forms them (the last one
    as long as the rows left)."""
    g = qt.shape[0] // k.shape[1]
    kh = k.repeat_interleave(g, dim=1).transpose(0, 1)
    vh = v.repeat_interleave(g, dim=1).transpose(0, 1)
    rows = q_offset + torch.arange(qt.shape[1])[:, None]
    steps = []
    for c0 in range(0, k.shape[0], chunk):
        kb, vb = kh[:, c0:c0 + chunk], vh[:, c0:c0 + chunk]
        cols = c0 + torch.arange(kb.shape[1])[None, :]
        steps.append((kb, vb, (kv_offset + cols <= rows).expand(
            qt.shape[0], -1, -1)))
    return steps


# (chunk, S, g, rows, cluster, rank_pages): the serve chunk and K10's
# chunk-128 calls, the split cut short of the serve widths
K10_CASES = [(16, 40, 1, 8, 8, 1), (16, 40, 3, 2, 2, 2), (16, 40, 6, 1, 4, 1),
             (64, 150, 3, 8, 2, 1), (64, 150, 6, 4, 1, 3),
             (128, 300, 6, 4, 2, 1), (128, 300, 1, 8, 1, 2)]


@pytest.mark.parametrize("chunk,s,g,rows,cluster,rank_pages", K10_CASES)
def test_split_walk_is_bitwise_k10(chunk, s, g, rows, cluster, rank_pages):
    """K10's schedule bitwise ``flash_prefill_reference`` one-shot, and with
    the carry out at a chunk multiple (o, m, l bitwise the plain version's)
    and then in: bitwise the one-shot walk."""
    rng = np.random.RandomState(chunk + s + g)
    q, k, v = (torch.from_numpy(rng.randn(s, n, DH).astype(np.float32))
               for n in (KV * g, KV, KV))
    kw = dict(acc=ACC, chunk=chunk)
    sched = dict(rows=rows, cluster=cluster, rank_pages=rank_pages, acc=ACC)
    qt = q.transpose(0, 1)
    want = flash_prefill_reference(q, k, v, **kw)
    o, _, l = _split_walk(qt, _k10_steps(qt, k, v, chunk, 0, 0), ps=chunk,
                          q_offset=0, col0=0, live_rows=s, first=0, **sched)
    assert torch.equal(_finalize(o, l).transpose(0, 1), want)
    split = chunk * (s // (2 * chunk))
    co, cm, cl = flash_prefill_reference(q, k[:split], v[:split],
                                         return_carry=True, **kw)
    c = _split_walk(qt, _k10_steps(qt, k[:split], v[:split], chunk, 0, 0),
                    ps=chunk, q_offset=0, col0=0, live_rows=s, first=0,
                    **sched)
    assert torch.equal(c[0].transpose(0, 1), co)
    assert torch.equal(c[1][..., 0].T, cm)
    assert torch.equal(c[2][..., 0].T, cl)
    o, _, l = _split_walk(qt, _k10_steps(qt, k[split:], v[split:], chunk, 0,
                                         split), ps=chunk, q_offset=0,
                          col0=split, live_rows=s, first=0, carry=c, **sched)
    assert torch.equal(_finalize(o, l).transpose(0, 1), want)


# --------------------------------------------------------------------------
# the schedule
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("rank_pages", [1, 3, 8])
def test_rounds_cover_each_page_once_in_order(cluster, rank_pages):
    """Each round is ``cluster * rank_pages`` pages (fewer in the last),
    split into contiguous rank ranges of at most ``rank_pages``, and the
    rounds walk pages first..end-1 once, in order."""
    for first in (0, 2):
        for end in range(first, 60):
            rounds = prefill_rounds(first, end, cluster, rank_pages)
            walked = [p for rnd in rounds for lo, hi in rnd
                      for p in range(lo, hi)]
            assert walked == list(range(first, end))
            for rnd in rounds:
                assert all(0 <= hi - lo <= rank_pages for lo, hi in rnd)
                assert all(rnd[i][1] == rnd[i + 1][0]
                           for i in range(cluster - 1))


# qwen2-1.5b's prefill attention (KV 2, g 6, dh 128): (what, rows, page or
# chunk, pages the longest tile walks, the schedule).  P's 64-token slab
# at q_offset 320 and a 2048-token one-shot prompt, the serve cell's 8
# one-shot prompts (P and K10 at chunk 16 walk the same pages), and K10's
# S = 512 calls at chunks 64 and 128.
SERVE_SCHEDULES = [
    ("P slab", 64, 16, 24, (8, 8, 3, 85024, 128)),
    ("P 2048-token prompt", 2048, 16, 128, (8, 1, 7, 112672, 512)),
    ("prompt 17", 17, 16, 2, (1, 2, 1, 39248, 68)),
    ("prompt 40", 40, 16, 3, (2, 2, 2, 47056, 80)),
    ("prompt 64", 64, 16, 4, (4, 4, 1, 46256, 128)),
    ("prompt 96", 96, 16, 6, (8, 4, 2, 76256, 96)),
    ("prompt 150", 150, 16, 10, (8, 8, 2, 73792, 304)),
    ("prompt 200", 200, 16, 13, (8, 8, 2, 73792, 400)),
    ("prompt 300", 300, 16, 19, (8, 4, 5, 102896, 304)),
    ("prompt 384", 384, 16, 24, (8, 4, 6, 111776, 384)),
    ("K10 S 512 chunk 64", 512, 64, 8, (8, 4, 1, 87856, 512)),
    ("K10 S 512 chunk 128", 512, 128, 4, (8, 4, 1, 112432, 512)),
]


@pytest.mark.parametrize("what,t,ps,n_pages,want", SERVE_SCHEDULES)
def test_prefill_schedule_at_serve_shapes(what, t, ps, n_pages, want):
    """The schedule is a function of the rows, heads, page and the longest
    walk alone, pinned at the serve shapes: (rows a tile, cluster, pages a
    block a round, shared memory, blocks)."""
    sm90.attn_prefill_schedule.cache_clear()
    got = sm90.attn_prefill_schedule(t, 2, 6, ps, 128, n_pages)
    assert got == sm90.AttnPrefillSchedule(*want), what
    assert got.smem <= sm90.ATTN_SMEM_BUDGET


def test_prefill_pages_follow_the_last_live_row():
    """The longest walk: from the first page to the last live row's causal
    reach and the last column."""
    assert sm90.prefill_pages(16, 320, 64, 0, 384) == 24
    assert sm90.prefill_pages(16, 320, 64, 0, 384, 2) == 22
    assert sm90.prefill_pages(16, 320, 17, 0, 337) == 22
    assert sm90.prefill_pages(16, 0, 0, 0, 10) == 0
    assert sm90.prefill_pages(16, 0, 40, 256, 512) == 0     # all in the future
    assert sm90.prefill_pages(128, 0, 512, 256, 256) == 2


def test_prefill_schedule_bounds():
    """Shared memory stays within the budget (or, at one row and one page,
    within a block's) for every head shape the kernels take, at any length
    and chunk; the cluster is a power of two up to ATTN_CLUSTER_MAX and no
    larger than the walk."""
    for t in (1, 17, 64, 384, 2048, 10 ** 5):
        for g, ps, dh in ((1, 1, 4), (6, 16, 128), (8, 32, 128), (8, 128, 128),
                          (3, 5, 7), (8, 100, 128)):
            for n_pages in (1, 3, 24, 129, 10 ** 4):
                s = sm90.attn_prefill_schedule(t, 2, g, ps, dh, n_pages)
                assert s.smem <= sm90.ATTN_SMEM_BUDGET or (
                    s.rows == 1 and s.rank_pages == 1
                    and s.smem <= sm90.SMEM_LIMIT - 1024)
                assert s.cluster in (1, 2, 4, 8) and s.cluster <= n_pages
                assert 1 <= s.rank_pages <= sm90.PREFILL_RANK_PAGES
                assert s.blocks == 2 * -(-t // s.rows) * s.cluster
                assert s.smem == sm90.attn_prefill_smem(
                    g, s.rows, ps, dh, s.cluster, s.rank_pages)
