"""Serve-path attention: over the paged int8 KV arena, and dense.

Three CUDA C++ kernels replace the TPU kernels of ``repro/kernels/
attention.py``:

* ``paged_attn_decode`` (``csrc/paged_decode.cu``) replaces
  ``_decode_kernel``: one query token per sequence; the g query heads of
  a KV head (kv-major grouping: head ``hh = hk * g + gg``) attend over the
  pages ``p < ceil(seq_len / page_size)`` of the sequence's page-table
  row, each int8 K/V page decoded with its 2^se scale.  The page walk of
  each (sequence, KV head) is split over the blocks of a thread-block
  cluster (``sm90.attn_decode_schedule``): each block forms the scores of
  a contiguous run of pages and publishes their ceil maxima, reads every
  rank's maxima through distributed shared memory to form the walk's
  running max and rescales, forms its pages' probabilities, l sums and
  p.v, and the carries fold in page order.  The running max is the prefix
  max of the pages' maxima, so every partial is the sequential walk's and
  the output is bitwise the walk's.  Bound on the H100: the bytes of the
  int8 pages it reads (plus q and out), microseconds at 3.35 TB/s; at the
  serve shapes the launch and each page's dependent chains bound it.
* ``flash_prefill_paged`` (``csrc/paged_prefill.cu``) replaces
  ``_prefill_paged_kernel`` and ``flash_prefill`` (``csrc/flash_prefill.cu``,
  K10) replaces ``_prefill_kernel``: one prefill walk
  (``csrc/attn_prefill_sm90.cuh``), over the int8 arena's pages for P and
  over float32 K/V rows in ``chunk``-long steps for K10 (the dense,
  resumable prefill of one sequence over the arena's dequantized view,
  ``serve.kvcache``, query and KV rows at absolute positions
  ``q_offset + i`` and ``kv_offset + j``, a carry ``(o, m, l)`` in and
  ``return_carry`` out).  A block serves a tile of query rows of one KV
  head for all g of its query heads, so each page is loaded and decoded
  once for all of them; the tile's page walk is split over the blocks of
  a thread-block cluster (``sm90.attn_prefill_schedule``) by the same
  exact prefix maxima as D's, with the carries folded in page order.
  K10 also takes ``rounding="sr"`` (the walk's SR instantiation, JAX's
  ``_prefill_kernel`` SR branch): the o and l carries round
  stochastically with dither keyed on the absolute KV block, query row,
  head and feature (``_sr_attn_bits``; l under a salted seed), so a
  resumed walk stays bitwise the one-shot walk.
  Pages before ``start_page``, past the last column or wholly in the
  causal future of the tile are not walked (carry no-ops).  On the same
  values K10 is bitwise P; a walk resumed at a chunk multiple is bitwise
  the one-shot walk.  Bound: the score and value contractions, 4 * rows *
  attended tokens * dh flops a query head, in f32 on the CUDA cores.

Accumulation discipline (``_online_update``): base-2 scores pre-scaled by
``LOG2E / sqrt(dh)``, a running max on the integer lattice (``ceil``) so
the rescale ``alpha = 2^(m - m')`` is an exact power of two, and the o/l
carries rounded to the planner's (1, e_acc, m_acc) once per page.  Within
a page, every sum runs in a fixed order: a score is the f32 sum over d in
increasing d, ``l`` adds the page's probabilities in token order, and
``p @ v`` adds the token terms in token order (each product rounded, then
added).  The kernels and the plain versions here follow the same order,
so on the card they agree bit for bit; against the JAX package, whose
contractions are XLA dots, they agree to the carry's rounding.

The carry variants serve tensor-parallel serving, where each rank walks
its own heads and the ranks' carries merge exactly (``merge_carries``,
``finalize_carry``; ``repro_torch.dist.psum_carry`` across processes):
``paged_attn_decode(..., return_carry=True)`` (``paged_decode_carry``, D's
``CARRY`` instantiation, JAX's ``emit_carry``) returns the raw ``(o, m,
l)``; ``flash_prefill_paged`` takes a ``carry`` covering the pages before
``start_page`` and resumes the walk there (``has_carry``), and returns the
raw carry with ``return_carry=True`` (``paged_prefill_carry``).  A walk
resumed at ``start_page`` is bitwise the one-shot walk: the carry is a
point of the carry format with a running max on the integer lattice.

``paged_attn_decode(..., collect_stats=True)`` is K12's port
(``paged_decode_stats`` in ``csrc/paged_decode.cu``, replacing
``_decode_kernel_stats``, the serve-time swamping monitor's probe): D's
output, bitwise, plus the (N_STATS,) float32 stats row of the o carry
against an f32 shadow ``o_i = o_i * alpha + p.v`` of the same rescaled
addends, over the outputs of the sequences with ``seq_len > 0``, formed
in the same fold; one partial row a block, summed by a second launch.

On CPU tensors the wrappers run the ``*_reference`` plain versions; on
CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, sm90
from repro_torch.kernels.common import (
    N_STATS,
    exp2_int,
    qfmt_args,
    quantize_carry,
    sr_random_bits,
    stats_delta_row,
    stats_row,
    stats_update,
)
from repro_torch.kernels.fused import as_sr_seed, check_rounding
from repro_torch.quant.formats import fmt_tuple
from repro_torch.quant.qtensor import unpack_block

__all__ = [
    "AttnCall",
    "paged_attn_decode",
    "paged_attn_decode_reference",
    "paged_attn_decode_stats_reference",
    "flash_prefill_paged",
    "flash_prefill_paged_reference",
    "flash_prefill_paged_geom",
    "flash_prefill_paged_geom_reference",
    "prefill_geom",
    "flash_prefill",
    "flash_prefill_reference",
    "merge_carries",
    "finalize_carry",
    "NEG",
    "LOG2E",
    "BLOCK_Q",
]

# Mask value for invalid scores: finite, so exp2(NEG - m) underflows to
# exactly 0 and a fully-masked block never computes inf - inf.
NEG = -1e30
# base-2 softmax: scores are pre-scaled by log2(e)
LOG2E = 1.4426950408889634
# the JAX kernels' query rows a block, taken by ``flash_prefill`` and
# ``AttnCall`` for the JAX signature; the port's walk takes its tiles from
# ``sm90.attn_prefill_schedule`` and reads no ``block_q`` (any value gives
# the same bits, since every row's page walk is its own)
BLOCK_Q = 16
# limits of the kernels' tiles (csrc/common.cuh, csrc/flash_prefill.cu)
MAX_DH = 128
MAX_G = 8
MAX_PAGE = 32
MAX_CHUNK = 128
# the ``block_q`` values ``flash_prefill`` takes (the JAX kernel's)
BLOCK_QS = (8, 16, 32)

_WIDE = (8, 23)

# the l carry's dither comes from a salted seed, so that it never shares
# bits with the o carry of the same (row, block) (the JAX package's salt)
_L_SALT = 0x6A09E667


@dataclass(frozen=True)
class AttnCall:
    """One attention call, the fields of ``repro.kernels.autotune.AttnCall``
    the port's prefill kernels read.  The paged prefill takes the carry
    format, the KV code format and the padded page-row width ``max_pages``
    (0 = any): the serve plan's ``kernel_call``.  The dense
    ``flash_prefill`` takes the carry format, the KV block length
    ``chunk`` (0 = the caller's), ``block_q`` (0 = ``BLOCK_Q``; schedule
    only, checked against ``BLOCK_QS``), the offsets and
    ``return_carry``: the dense-prefill layers' calls
    (``models.layers.attn_prefill_paged``, ``attn_prefill_chunk_paged``)."""

    e_acc: int = 8
    m_acc: int = 23
    kv_fmt: tuple | None = None
    max_pages: int = 0
    chunk: int = 0
    block_q: int = 0
    q_offset: int = 0
    kv_offset: int = 0
    return_carry: bool = False

    def __post_init__(self):
        object.__setattr__(self, "kv_fmt", fmt_tuple(self.kv_fmt))

    @property
    def acc(self) -> tuple[int, int]:
        return (self.e_acc, self.m_acc)

    def resolve_block_q(self) -> int:
        """``block_q``, or the port's default (it has no tuner)."""
        return self.block_q or BLOCK_Q


def _scale(dh: int) -> torch.Tensor:
    return torch.tensor(LOG2E / math.sqrt(dh), dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _scale_f32(dh: int) -> float:
    """``_scale(dh)`` as a Python float, the same f32 bits, formed once per
    dh (a kernel launch takes it without building a tensor)."""
    return float(_scale(dh))


def _seq_dot(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """sum_d q[..., :, d] * k[..., :, d] over the last axis, in increasing
    d, each product rounded then added: q (..., R, D), k (..., T, D) ->
    (..., R, T)."""
    acc = torch.zeros(q.shape[:-1] + (k.shape[-2],), dtype=torch.float32,
                      device=q.device)
    for d in range(q.shape[-1]):
        acc = acc + q[..., :, d:d + 1] * k[..., None, :, d]
    return acc


def _sr_attn_bits(seed: int, step, *, abs_row0: int, h: int, s: int,
                  dh: int, device=None):
    """``(rbits_o, rbits_l)``, the dither of one KV-block carry update of
    a slab of ``s`` query rows from absolute row ``abs_row0``, shaped
    (h, s, dh) and (h, s, 1): bitwise ``repro.kernels.attention.
    _sr_attn_bits`` with ``shape3=(h, s, dh)``.  Keyed on the seed, the
    absolute KV block ``step``, the absolute row, the head and the
    feature: o's flat index is ``row * h * dh + head * dh + d``, l's
    ``row * h + head`` under ``seed ^ _L_SALT``.  Int64 tensors of uint32
    values on ``device``."""
    seed = as_sr_seed(seed)
    rows = torch.arange(s, dtype=torch.int64, device=device)[None, :, None]
    heads = torch.arange(h, dtype=torch.int64, device=device)[:, None, None]
    feats = torch.arange(dh, dtype=torch.int64, device=device)
    rows = rows + abs_row0
    rbits_o = sr_random_bits(seed, step, rows, heads * dh + feats, h * dh)
    rbits_l = sr_random_bits(seed ^ _L_SALT, step, rows, heads, h)
    return rbits_o, rbits_l


def _online_update(o, m, l, t, valid, v, e_acc: int, m_acc: int,
                   rounding: str = "rne", rbits=None):
    """One page step of the online softmax with the chunked carry.

    ``o`` (..., R, D), ``m``/``l`` (..., R, 1) carries; ``t`` (..., R, T)
    base-2 scores (NEG where invalid); ``v`` (..., T, D).  Sums in token
    order (see module docstring).  A fully-masked page is a carry no-op,
    under SR too (a representable carry is a fixed point of the dither).
    ``rounding="sr"`` rounds the carries with ``rbits``, an ``(rbits_o,
    rbits_l)`` pair from ``_sr_attn_bits``.  Returns ``(o, m, l, alpha,
    pv)``: the new carries, the rescale and the page's value sum (the
    stats variant's shadow takes the same two).
    """
    m_new = torch.maximum(m, torch.ceil(torch.amax(t, dim=-1, keepdim=True)))
    alpha = torch.exp2(m - m_new)
    p = torch.where(valid, torch.exp2(t - m_new), torch.zeros_like(t))
    lsum = torch.zeros_like(l)
    pv = torch.zeros_like(o)
    for j in range(t.shape[-1]):
        lsum = lsum + p[..., j:j + 1]
        pv = pv + p[..., j:j + 1] * v[..., None, j, :]
    rbits_o, rbits_l = rbits if rounding == "sr" else (None, None)
    l_new = quantize_carry(l * alpha + lsum, e_acc, m_acc, rounding, rbits_l)
    o_new = quantize_carry(o * alpha + pv, e_acc, m_acc, rounding, rbits_o)
    return o_new, m_new, l_new, alpha, pv


def _finalize(o, l):
    """out = o / l; exactly 0 where nothing was attended (l == 0)."""
    pos = l > 0.0
    return torch.where(pos, o / torch.where(pos, l, torch.ones_like(l)),
                       torch.zeros_like(o))


def _page_values(pages, se, fmt):
    return unpack_block(pages, *fmt) * exp2_int(se).reshape(
        se.shape + (1,) * (pages.ndim - se.ndim))


def _check_pages(q, k_pages, v_pages, kv_fmt):
    if k_pages.shape != v_pages.shape or k_pages.ndim != 4:
        raise ValueError(f"bad pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError("pages must be int8 codes")
    if q.shape[-2] % k_pages.shape[1] != 0:
        raise ValueError(f"H={q.shape[-2]} not a multiple of "
                         f"KV={k_pages.shape[1]}")
    fmt = fmt_tuple(kv_fmt)
    if fmt is None:
        raise ValueError("packed pages need kv_fmt to decode")
    return fmt


def _check_cuda(*ts):
    dev = ts[0].device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _launch_limits(g, dh, page_size):
    if dh > MAX_DH or g > MAX_G or page_size > MAX_PAGE:
        raise NotImplementedError(
            f"kernel tiles hold dh <= {MAX_DH}, g <= {MAX_G}, page_size <= "
            f"{MAX_PAGE}; got dh={dh}, g={g}, page_size={page_size}")



_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# --------------------------------------------------------------------------
# paged decode
# --------------------------------------------------------------------------


def paged_attn_decode_reference(q, k_pages, v_pages, k_se, v_se, page_table,
                                seq_lens, *, kv_fmt=None, acc=_WIDE,
                                return_carry: bool = False):
    """Plain PyTorch version of ``paged_attn_decode``: gathers pages
    through the page table, dequantizes with the per-page scales and walks
    every page-table column in order (columns past a row's length are
    masked, hence carry no-ops), with the kernel's summation order.
    ``return_carry=True`` returns the raw ``(o (B,H,dh), m (B,H), l
    (B,H))``."""
    return _decode_walk(q, k_pages, v_pages, k_se, v_se, page_table,
                        seq_lens, kv_fmt=kv_fmt, acc=acc, stats=False,
                        carry=return_carry)


def paged_attn_decode_stats_reference(q, k_pages, v_pages, k_se, v_se,
                                      page_table, seq_lens, *, kv_fmt=None,
                                      acc=_WIDE):
    """Plain PyTorch version of K12's kernel: ``(out, row)``.  It walks
    every page-table column, as the TPU kernel does, and takes the ensemble
    moments on the last one; the kernel stops at each sequence's last valid
    page, where the row is already complete (a masked page changes neither
    carry nor shadow and counts no add)."""
    return _decode_walk(q, k_pages, v_pages, k_se, v_se, page_table,
                        seq_lens, kv_fmt=kv_fmt, acc=acc, stats=True)


def _decode_walk(q, k_pages, v_pages, k_se, v_se, page_table, seq_lens, *,
                 kv_fmt, acc, stats: bool, carry: bool = False):
    fmt = _check_pages(q, k_pages, v_pages, kv_fmt)
    b, h, dh = q.shape
    kv, page_size = k_pages.shape[1], k_pages.shape[2]
    g = h // kv
    e_acc, m_acc = acc
    dev = q.device
    q4 = q.to(torch.float32).reshape(b, kv, g, dh)
    o = torch.zeros((b, kv, g, dh), dtype=torch.float32, device=dev)
    m = torch.full((b, kv, g, 1), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, 1), dtype=torch.float32, device=dev)
    scale = _scale(dh).to(dev)
    seq_lens = seq_lens.to(device=dev, dtype=torch.int64)
    page_table = page_table.to(device=dev, dtype=torch.int64)
    if stats:
        ideal = torch.zeros_like(o)
        row = stats_row(dev)
        mask = (seq_lens > 0)[:, None, None, None].expand_as(o)
    n_cols = page_table.shape[1]
    for p in range(n_cols):
        pid = page_table[:, p]
        kb = _page_values(k_pages[pid], k_se[pid], fmt)  # (B, KV, ps, dh)
        vb = _page_values(v_pages[pid], v_se[pid], fmt)
        s = _seq_dot(q4, kb) * scale                     # (B, KV, g, ps)
        tok = p * page_size + torch.arange(page_size, device=dev)
        valid = (tok < seq_lens[:, None, None, None]).expand_as(s)
        s = torch.where(valid, s, torch.full_like(s, NEG))
        prev = o
        o, m, l, alpha, pv = _online_update(o, m, l, s, valid, vb, e_acc,
                                            m_acc)
        if stats:
            ideal = ideal * alpha + pv
            row = stats_update(row, *stats_delta_row(
                o, prev * alpha, ideal, pv, mask, p == n_cols - 1))
    if carry:
        return o.reshape(b, h, dh), m.reshape(b, h), l.reshape(b, h)
    out = _finalize(o, l).reshape(b, h, dh)
    if stats:
        return out, row.to(torch.float32)
    return out


_DECODE_ARGS = [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                _I, _F, _I, _I, _I, _I, _F, _F, _P]


@functools.lru_cache(maxsize=None)
def _attn_consts(dh: int, acc) -> tuple:
    """The launch's constant C arguments of a head width and carry format:
    the score scale and the carry quantizer's."""
    return (ctypes.c_float(_scale_f32(dh)), *qfmt_args(acc))


def paged_attn_decode(q, k_pages, v_pages, k_se, v_se, page_table, seq_lens,
                      *, kv_fmt=None, acc=_WIDE, collect_stats: bool = False,
                      return_carry: bool = False, rounding: str = "rne"):
    """One decode token of attention per sequence against the paged arena.

    * ``q`` (B, H, dh) float32, heads kv-major;
    * ``k_pages``/``v_pages`` (P, KV, page_size, dh) int8 ``kv_fmt`` codes,
      ``k_se``/``v_se`` (P,) int32 page scale exponents;
    * ``page_table`` (B, max_pages) int32, padded with the null page 0;
    * ``seq_lens`` (B,) int32 attended tokens (0 = padded row, output 0);
    * ``acc`` the (e_acc, m_acc) carry of the context bucket;
    * ``collect_stats=True`` is K12's kernel: returns ``(out, row)``, out
      bitwise the stats-off call's and ``row`` the (N_STATS,) float32
      swamping stats on the device, counted once a call on
      ``stats_launches``; each call is two launches, the kernel and the
      second pass that sums the blocks' partial rows;
    * ``return_carry=True`` skips the finalize and returns the raw carry
      ``(o (B,H,dh), m (B,H), l (B,H))`` (exclusive with
      ``collect_stats``), counted on ``carry_launches``;
    * ``rounding``: only ``"rne"``, as the JAX package's decode kernel
      (SR raises).

    The launch reads only host-known shapes (the schedule follows B, KV
    and the page-table width); it allocates only its outputs, and K12 its
    row and partial rows.  Returns (B, H, dh) float32 [, row], or the
    carry triple.
    """
    if collect_stats and return_carry:
        raise ValueError("collect_stats and return_carry are exclusive")
    if rounding != "rne":
        raise NotImplementedError("the decode kernel's carries round to "
                                  "nearest only, as the JAX package's do")
    if q.device.type == "cpu":
        if collect_stats:
            return paged_attn_decode_stats_reference(
                q, k_pages, v_pages, k_se, v_se, page_table, seq_lens,
                kv_fmt=kv_fmt, acc=acc)
        return paged_attn_decode_reference(
            q, k_pages, v_pages, k_se, v_se, page_table, seq_lens,
            kv_fmt=kv_fmt, acc=acc, return_carry=return_carry)
    fmt = _check_pages(q, k_pages, v_pages, kv_fmt)
    if q.dtype != torch.float32 or q.ndim != 3:
        raise TypeError(f"q must be (B, H, dh) float32, got {q.dtype} "
                        f"{tuple(q.shape)}")
    for t in (k_se, v_se, page_table, seq_lens):
        if t.dtype != torch.int32:
            raise TypeError("page scales, page table and lengths are int32")
    _check_cuda(q, k_pages, v_pages, k_se, v_se, page_table, seq_lens)
    b, h, dh = q.shape
    kv, page_size = k_pages.shape[1], k_pages.shape[2]
    g, width = h // kv, page_table.shape[1]
    _launch_limits(g, dh, page_size)
    out = torch.empty_like(q)
    if collect_stats:
        row = torch.zeros((N_STATS,), dtype=torch.float32, device=q.device)
    if return_carry:
        om = torch.empty((b, h), dtype=torch.float32, device=q.device)
        ol = torch.empty_like(om)
    if b == 0:
        return ((out, row) if collect_stats
                else (out, om, ol) if return_carry else out)
    sched = sm90.attn_decode_schedule(b, kv, width, g, page_size, dh)
    scale, *qacc = _attn_consts(dh, tuple(acc))
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_se.data_ptr(), v_se.data_ptr(), page_table.data_ptr(), width,
            seq_lens.data_ptr(), out.data_ptr(), b, kv, g, page_size, dh,
            sched.cluster, sched.rank_pages, scale, *fmt, *qacc)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if collect_stats:
        part = torch.empty((sched.blocks, N_STATS), dtype=torch.float64,
                           device=q.device)
        rc = build.function("paged_decode", "paged_decode_stats",
                            _DECODE_ARGS[:-1] + [_P, _P, _P])(
            *args, part.data_ptr(), row.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"paged_decode_stats launch failed: CUDA "
                               f"error {rc}")
        paged_attn_decode.stats_launches += 1
        return out, row
    if return_carry:
        rc = build.function("paged_decode", "paged_decode_carry",
                            _DECODE_ARGS[:-1] + [_P, _P, _P])(
            *args, om.data_ptr(), ol.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"paged_decode_carry launch failed: CUDA "
                               f"error {rc}")
        paged_attn_decode.carry_launches += 1
        return out, om, ol
    rc = build.function("paged_decode", "paged_decode", _DECODE_ARGS)(
        *args, stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {rc}")
    paged_attn_decode.launches += 1
    return out


paged_attn_decode.launches = 0
paged_attn_decode.stats_launches = 0
paged_attn_decode.carry_launches = 0


# --------------------------------------------------------------------------
# the exact carry merge (tensor-parallel serving)
# --------------------------------------------------------------------------


def merge_carries(carries):
    """Fold a list of ``(o (..., dh), m (...), l (...))`` carries into one
    with the exponent-shift rescale: ``m = max(m1, m2)``, each side scaled
    by ``2^(m_i - m)`` (an exact power of two: the running maxima are on
    the integer lattice), then added.  The plain counterpart of
    ``repro_torch.dist.psum_carry``; with one owner a (row, head) and the
    neutral ``(0, NEG, 0)`` elsewhere (head-sharded serving) the fold is
    exact in any order.  JAX's ``merge_carries``, op for op."""
    o, m, l = carries[0]
    for o2, m2, l2 in carries[1:]:
        m_new = torch.maximum(m, m2)
        a1 = torch.exp2(m - m_new)
        a2 = torch.exp2(m2 - m_new)
        o = o * a1[..., None] + o2 * a2[..., None]
        l = l * a1 + l2 * a2
        m = m_new
    return o, m, l


def finalize_carry(o, l):
    """``o / l`` where attended, exactly 0 where nothing was (``l ==
    0``): the kernels' own finalize on a merged carry."""
    return _finalize(o, l[..., None])


# --------------------------------------------------------------------------
# bucketed paged prefill
# --------------------------------------------------------------------------


def flash_prefill_paged_reference(q, k_pages, v_pages, k_se, v_se, page_row,
                                  q_offset: int, q_len: int, kv_len: int, *,
                                  kv_fmt=None, acc=_WIDE, carry=None,
                                  start_page: int = 0,
                                  return_carry: bool = False,
                                  call: AttnCall | None = None):
    """Plain PyTorch version of ``flash_prefill_paged``: walks the pages
    ``[0, ceil(kv_len / page_size))`` of the page row in order (the rest
    are masked, hence carry no-ops), pages before ``start_page`` masked
    and ``carry`` as the state before them, with the kernel's summation
    order; ``return_carry=True`` returns the raw ``(o, m, l)``.  With the
    geometry as 0-d tensors (``flash_prefill_paged_geom_reference``) it
    enters only the masks and every column of the page row is walked, so
    nothing reads it on the host; the bits are the same."""
    if call is not None:
        acc, kv_fmt = call.acc, call.kv_fmt
        return_carry = bool(return_carry or call.return_carry)
    fmt = _check_pages(q, k_pages, v_pages, kv_fmt)
    _check_carry(q, carry)
    t, h, dh = q.shape
    kv, page_size = k_pages.shape[1], k_pages.shape[2]
    g = h // kv
    e_acc, m_acc = acc
    dev = q.device
    qt = q.to(torch.float32).transpose(0, 1)             # (h, t, dh)
    o, m, l = _carry_state(carry, h, t, dh, dev)
    scale = _scale(dh).to(dev)
    rloc = torch.arange(t, device=dev)[:, None]
    rows = q_offset + rloc
    page_row = page_row.to(device=dev, dtype=torch.int64)
    n_walk = (page_row.shape[0] if isinstance(kv_len, torch.Tensor)
              else -(-kv_len // page_size))
    for p in range(n_walk):
        pid = page_row[p]
        kb = _page_values(k_pages[pid], k_se[pid], fmt)  # (kv, ps, dh)
        vb = _page_values(v_pages[pid], v_se[pid], fmt)
        kb = kb.repeat_interleave(g, dim=0)              # (h, ps, dh)
        vb = vb.repeat_interleave(g, dim=0)
        s = _seq_dot(qt, kb) * scale                     # (h, t, ps)
        cols = p * page_size + torch.arange(page_size, device=dev)[None, :]
        valid = ((cols <= rows) & (cols < kv_len) & (rloc < q_len)
                 & (p >= start_page)).expand_as(s)
        s = torch.where(valid, s, torch.full_like(s, NEG))
        o, m, l, _, _ = _online_update(o, m, l, s, valid, vb, e_acc,
                                        m_acc)
    if return_carry:
        return o.transpose(0, 1), m[..., 0].T, l[..., 0].T
    return _finalize(o, l).transpose(0, 1)


def _carry_state(carry, h: int, t: int, dh: int, dev):
    """The walk's (o (h,t,dh), m (h,t,1), l (h,t,1)) state: a carry in the
    JAX layouts ((t,h,dh), (t,h), (t,h)), or the empty walk's."""
    if carry is None:
        return (torch.zeros((h, t, dh), dtype=torch.float32, device=dev),
                torch.full((h, t, 1), NEG, dtype=torch.float32, device=dev),
                torch.zeros((h, t, 1), dtype=torch.float32, device=dev))
    co, cm, cl = (c.to(device=dev, dtype=torch.float32) for c in carry)
    return (co.transpose(0, 1).contiguous(), cm.T[..., None].contiguous(),
            cl.T[..., None].contiguous())


def _check_carry(q, carry):
    """A carry in the JAX layouts of q (T, H, dh): (T, H, dh), (T, H),
    (T, H)."""
    if carry is None:
        return
    t, h, dh = q.shape
    co, cm, cl = carry
    if (tuple(co.shape) != (t, h, dh) or tuple(cm.shape) != (t, h)
            or tuple(cl.shape) != (t, h)):
        raise ValueError(
            f"carry shapes {tuple(co.shape)}/{tuple(cm.shape)}/"
            f"{tuple(cl.shape)} do not match q {tuple(q.shape)}")


_PREFILL_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                 _I, _F, _I, _I, _I, _I, _F, _F, _I, _I, _I, _P]
# paged_prefill_carry: q, pages, scales, page row, (co, cm, cl), out,
# (om, ol), then paged_prefill's ints and floats
_PREFILL_CARRY_ARGS = [_P] * 12 + _PREFILL_ARGS[7:]


def flash_prefill_paged(q, k_pages, v_pages, k_se, v_se, page_row,
                        q_offset: int, q_len: int, kv_len: int, *,
                        kv_fmt=None, acc=_WIDE, carry=None,
                        start_page: int = 0, return_carry: bool = False,
                        call: AttnCall | None = None):
    """Causal prefill of one query slab straight off the paged arena.

    * ``q`` (T, H, dh) float32: the slab's queries; rows ``>= q_len`` are
      padding and come out exactly 0;
    * pages and scales as in ``paged_attn_decode``, AFTER the slab's K/V
      were written: history and slab are walked in one pass;
    * ``page_row`` (max_pages,) int32: the sequence's pages in token order;
    * ``q_offset``/``q_len``/``kv_len``: host ints (absolute position of
      row 0, live rows, live KV tokens), passed to the kernel as launch
      arguments;
    * ``carry``/``start_page``/``return_carry``: the resumable walk of the
      JAX kernel, ``carry`` ((T,H,dh), (T,H), (T,H) float32) the state
      after the pages ``[0, start_page)``, where the walk resumes; a
      resumed walk is bitwise the one-shot walk; ``return_carry=True``
      returns the raw ``(o, m, l)`` instead of ``o / l``.  Without a carry,
      ``start_page`` masks the pages before it;
    * ``call`` supplies ``acc``/``kv_fmt`` (and ``return_carry``) from the
      bucket's ``AttnCall``.

    The launch reads only host ints and shapes (the schedule follows T,
    the heads and the pages the last live row walks); it allocates only
    its outputs.  Launches are counted on ``launches`` (no carry),
    ``carry_launches`` (carry out, no carry in) and ``resume_launches``
    (carry in).  Returns (T, H, dh) float32, or the carry triple.
    """
    if call is not None:
        acc, kv_fmt = call.acc, call.kv_fmt
        return_carry = bool(return_carry or call.return_carry)
        if call.max_pages and page_row.shape[0] != call.max_pages:
            raise ValueError(f"page_row width {page_row.shape[0]} != bucket "
                             f"max_pages {call.max_pages}")
    if q.device.type == "cpu":
        return flash_prefill_paged_reference(
            q, k_pages, v_pages, k_se, v_se, page_row, q_offset, q_len,
            kv_len, kv_fmt=kv_fmt, acc=acc, carry=carry,
            start_page=start_page, return_carry=return_carry)
    fmt = _check_pages(q, k_pages, v_pages, kv_fmt)
    _check_carry(q, carry)
    if q.dtype != torch.float32 or q.ndim != 3:
        raise TypeError(f"q must be (T, H, dh) float32, got {q.dtype} "
                        f"{tuple(q.shape)}")
    for x in (k_se, v_se, page_row):
        if x.dtype != torch.int32:
            raise TypeError("page scales and page row are int32")
    carry = None if carry is None else tuple(carry)
    for x in carry or ():
        if x.dtype != torch.float32:
            raise TypeError(f"the carry is float32, got {x.dtype}")
    _check_cuda(q, k_pages, v_pages, k_se, v_se, page_row, *(carry or ()))
    t, h, dh = q.shape
    kv, page_size = k_pages.shape[1], k_pages.shape[2]
    _launch_limits(h // kv, dh, page_size)
    if -(-kv_len // page_size) > page_row.shape[0]:
        raise ValueError(f"kv_len {kv_len} needs more pages than the row's "
                         f"{page_row.shape[0]}")
    out = torch.empty_like(q)
    om = ol = None
    if return_carry:
        om = torch.empty((t, h), dtype=torch.float32, device=q.device)
        ol = torch.empty_like(om)
    sched = sm90.attn_prefill_schedule(t, kv, h // kv, page_size, dh,
                                       sm90.prefill_pages(
                                           page_size, q_offset, q_len, 0,
                                           kv_len, start_page))
    scale, *qacc = _attn_consts(dh, tuple(acc))
    geom = (t, h, kv, page_size, dh, int(q_offset), int(q_len), int(kv_len),
            int(start_page), scale, *fmt, *qacc, sched.rows, sched.cluster,
            sched.rank_pages, torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_se.data_ptr(), v_se.data_ptr(), page_row.data_ptr())
    if carry is None and not return_carry:
        rc = build.function("paged_prefill", "paged_prefill", _PREFILL_ARGS)(
            *ptrs, out.data_ptr(), *geom)
    else:
        co, cm, cl = (None,) * 3 if carry is None else (
            x.data_ptr() for x in carry)
        rc = build.function("paged_prefill", "paged_prefill_carry",
                            _PREFILL_CARRY_ARGS)(
            *ptrs, co, cm, cl, out.data_ptr(),
            None if om is None else om.data_ptr(),
            None if ol is None else ol.data_ptr(), *geom)
    if rc != 0:
        raise RuntimeError(f"paged_prefill launch failed: CUDA error {rc}")
    if carry is not None:
        flash_prefill_paged.resume_launches += 1
    elif return_carry:
        flash_prefill_paged.carry_launches += 1
    else:
        flash_prefill_paged.launches += 1
    return (out, om, ol) if return_carry else out


flash_prefill_paged.launches = 0
flash_prefill_paged.carry_launches = 0
flash_prefill_paged.resume_launches = 0


# --------------------------------------------------------------------------
# bucketed paged prefill, geometry on the device
# --------------------------------------------------------------------------


def prefill_geom(q_offset, q_len, kv_len=None, start_page=0,
                 device=None) -> torch.Tensor:
    """P's device geometry: the int32[4] tensor ``(q_offset, q_len, kv_len,
    start_page)`` (JAX's ``geom`` operand).  Each entry an int or a 0-d
    integer tensor; ``kv_len`` defaults to ``q_offset + q_len``.  Tensors
    are stacked where they lie (no host read); ints are placed on
    ``device``."""
    parts = [q_offset, q_len,
             q_offset + q_len if kv_len is None else kv_len, start_page]
    dev = next((x.device for x in parts if isinstance(x, torch.Tensor)),
               device)
    # an int is filled on the device (no host-to-device copy, so the call
    # can be captured in a CUDA graph)
    return torch.stack([x.reshape(()).to(torch.int32)
                        if isinstance(x, torch.Tensor)
                        else torch.full((), int(x), dtype=torch.int32,
                                        device=dev)
                        for x in parts])


def flash_prefill_paged_geom_reference(q, k_pages, v_pages, k_se, v_se,
                                       page_row, geom, *, kv_fmt=None,
                                       acc=_WIDE, call: AttnCall | None = None):
    """Plain PyTorch version of ``flash_prefill_paged_geom``:
    ``flash_prefill_paged_reference`` with the geometry as tensors, which
    enter only the masks (every column of the page row is walked; the
    columns past ``kv_len`` or before ``start_page`` are carry no-ops), so
    the output is bitwise the host-int walk's."""
    q_offset, q_len, kv_len, start_page = geom.to(
        device=q.device, dtype=torch.int64).unbind()
    return flash_prefill_paged_reference(
        q, k_pages, v_pages, k_se, v_se, page_row, q_offset, q_len, kv_len,
        kv_fmt=kv_fmt, acc=acc, start_page=start_page, call=call)


_PREFILL_GEOM_ARGS = ([_P] * 8 + [_I] * 6
                      + [_F, _I, _I, _I, _I, _F, _F, _I, _I, _I, _P])


def flash_prefill_paged_geom(q, k_pages, v_pages, k_se, v_se, page_row,
                             geom, *, kv_fmt=None, acc=_WIDE,
                             call: AttnCall | None = None):
    """``flash_prefill_paged`` with its geometry on the device, JAX's
    traced ``geom`` operand (``_prefill_paged_kernel``'s ``gm_ref``):
    ``geom`` an int32[4] tensor ``(q_offset, q_len, kv_len, start_page)``
    on q's device (``prefill_geom``), read by the kernel, never by the
    host.  The launch depends on the shapes only: the schedule
    (``sm90.attn_prefill_schedule``) is picked from the slab width T and
    the page row's width, so one captured CUDA graph serves every slab of
    a bucket.  Bitwise ``flash_prefill_paged`` on the same geometry (the
    walk is the same code; the schedule changes no bit).  No carries.
    Counted on ``flash_prefill_paged_geom.launches``.  Returns (T, H, dh) float32; rows
    ``>= q_len`` exactly 0."""
    if call is not None:
        acc, kv_fmt = call.acc, call.kv_fmt
        if call.max_pages and page_row.shape[0] != call.max_pages:
            raise ValueError(f"page_row width {page_row.shape[0]} != bucket "
                             f"max_pages {call.max_pages}")
    if tuple(geom.shape) != (4,):
        raise ValueError(f"geom must be int32[4], got {tuple(geom.shape)}")
    if q.device.type == "cpu":
        return flash_prefill_paged_geom_reference(
            q, k_pages, v_pages, k_se, v_se, page_row, geom, kv_fmt=kv_fmt,
            acc=acc)
    fmt = _check_pages(q, k_pages, v_pages, kv_fmt)
    if q.dtype != torch.float32 or q.ndim != 3:
        raise TypeError(f"q must be (T, H, dh) float32, got {q.dtype} "
                        f"{tuple(q.shape)}")
    for x in (k_se, v_se, page_row, geom):
        if x.dtype != torch.int32:
            raise TypeError("page scales, page row and geom are int32")
    _check_cuda(q, k_pages, v_pages, k_se, v_se, page_row, geom)
    t, h, dh = q.shape
    kv, page_size = k_pages.shape[1], k_pages.shape[2]
    _launch_limits(h // kv, dh, page_size)
    width = page_row.shape[0]
    out = torch.empty_like(q)
    sched = sm90.attn_prefill_schedule(t, kv, h // kv, page_size, dh, width)
    scale, *qacc = _attn_consts(dh, tuple(acc))
    rc = build.function("paged_prefill", "paged_prefill_geom",
                        _PREFILL_GEOM_ARGS)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_se.data_ptr(), v_se.data_ptr(), page_row.data_ptr(),
        geom.data_ptr(), out.data_ptr(), t, h, kv, page_size, dh, width,
        scale, *fmt, *qacc, sched.rows, sched.cluster, sched.rank_pages,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_prefill_geom launch failed: CUDA error "
                           f"{rc}")
    flash_prefill_paged_geom.launches += 1
    return out


flash_prefill_paged_geom.launches = 0


# --------------------------------------------------------------------------
# dense resumable prefill
# --------------------------------------------------------------------------


def _check_dense(q, k, v, carry, chunk, kv_offset):
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if q.shape[1] % k.shape[1] != 0 or q.shape[2] != k.shape[2]:
        raise ValueError(f"H={q.shape[1]} not a multiple of KV={k.shape[1]}"
                         f" or head dims differ")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if kv_offset % chunk != 0:
        raise ValueError(
            f"kv_offset {kv_offset} must be a multiple of chunk {chunk}: a "
            "mid-block resumption would insert an extra carry-rounding "
            "event and break bit-exactness vs the one-shot walk")
    _check_carry(q, carry)


def flash_prefill_reference(q, k, v, *, acc=_WIDE, chunk: int = 128,
                            block_q: int = BLOCK_Q, q_offset: int = 0,
                            kv_offset: int = 0, carry=None,
                            return_carry: bool = False,
                            rounding: str = "rne", sr_seed: int = 0,
                            call: AttnCall | None = None):
    """Plain PyTorch version of ``flash_prefill``: every ``chunk``-long KV
    block in order (blocks in a row's causal future are masked, hence
    carry no-ops), with the kernels' summation order (``_seq_dot``,
    ``_online_update``).  It has no query blocks: ``block_q``, schedule
    only, is taken and ignored so that the two share a signature (``call``
    too, read as ``flash_prefill`` reads it).  Under ``rounding="sr"``
    block ``kk`` of this call is KV block ``kv_offset // chunk + kk``, its
    dither ``_sr_attn_bits`` of the whole slab."""
    if call is not None:
        acc, chunk = call.acc, call.chunk or chunk
        q_offset, kv_offset = call.q_offset, call.kv_offset
        return_carry = bool(return_carry or call.return_carry)
    _check_dense(q, k, v, carry, chunk, kv_offset)
    sr = check_rounding(rounding)
    s, h, dh = q.shape
    sk = k.shape[0]
    g = h // k.shape[1]
    e_acc, m_acc = acc
    dev = q.device
    qt = q.to(torch.float32).transpose(0, 1)                        # (h, s, dh)
    kh = k.to(torch.float32).repeat_interleave(g, dim=1).transpose(0, 1)
    vh = v.to(torch.float32).repeat_interleave(g, dim=1).transpose(0, 1)
    o, m, l = _carry_state(carry, h, s, dh, dev)
    scale = _scale(dh).to(dev)
    rows = q_offset + torch.arange(s, device=dev)[:, None]
    for c0 in range(0, sk, chunk):
        kb = kh[:, c0:c0 + chunk]
        vb = vh[:, c0:c0 + chunk]
        sc = _seq_dot(qt, kb) * scale                              # (h, s, t)
        cols = c0 + torch.arange(kb.shape[1], device=dev)[None, :]
        valid = (kv_offset + cols <= rows).expand_as(sc)
        sc = torch.where(valid, sc, torch.full_like(sc, NEG))
        rbits = None
        if sr:
            rbits = _sr_attn_bits(sr_seed, kv_offset // chunk + c0 // chunk,
                                  abs_row0=q_offset, h=h, s=s, dh=dh,
                                  device=dev)
        o, m, l, _, _ = _online_update(o, m, l, sc, valid, vb, e_acc, m_acc,
                                       rounding, rbits)
    if return_carry:
        return o.transpose(0, 1), m[..., 0].T, l[..., 0].T
    return _finalize(o, l).transpose(0, 1)


_DENSE_ARGS = ([_P] * 9 + [_I] * 8
               + [_F, _I, _I, _F, _F, _I, _I, _I, _I, ctypes.c_uint, _P])


def flash_prefill(q, k, v, *, acc=_WIDE, chunk: int = 128,
                  block_q: int = BLOCK_Q, q_offset: int = 0,
                  kv_offset: int = 0, carry=None, return_carry: bool = False,
                  call: AttnCall | None = None, rounding: str = "rne",
                  sr_seed: int = 0):
    """Causal flash attention for one sequence's prefill (resumable).

    * ``q`` (S, H, dh): query rows at absolute positions ``q_offset + i``;
      ``k``/``v`` (Sk, KV, dh): KV rows at ``kv_offset + j`` (heads
      kv-major: head ``hh`` reads KV head ``hh // (H / KV)``), the values
      the KV arena holds (``serve.kvcache.write_prompt``'s view);
    * ``acc``: the (e_acc, m_acc) carry format; ``chunk``: the KV block
      length n1 (numerics: the carry rounding cadence; the serve path pins
      it to the page size); ``block_q``: the JAX kernel's query rows a
      block (8, 16 or 32), checked and otherwise not read: the port's walk
      takes its tiles from ``sm90.attn_prefill_schedule``;
    * ``carry``: a previous call's ``(o, m, l)``, shapes (S, H, dh), (S, H),
      (S, H), covering KV ``[0, kv_offset)``; ``return_carry=True`` returns
      the raw state instead of the finalized output.  ``kv_offset`` must be
      a multiple of ``chunk``; resuming there is bitwise the one-shot walk;
    * ``call``: an ``AttnCall`` supplying acc, chunk (when set), block_q,
      the offsets and ``return_carry``;
    * ``rounding``: ``"rne"`` or ``"sr"``, the o and l carries' rounding;
      ``sr_seed`` (an int, taken mod 2^32) keys SR's dither, on the
      absolute KV block, row, head and feature, so resuming at a chunk
      multiple is bitwise the one-shot walk under SR too.

    The kernel holds dh <= ``MAX_DH`` and chunk <= ``MAX_CHUNK``.  Returns
    (S, H, dh) float32, or ``(o, m, l)``.  Launches are counted on
    ``flash_prefill.launches``, SR ones on ``flash_prefill.sr_launches``.
    """
    sr = check_rounding(rounding)
    seed = as_sr_seed(sr_seed)
    if call is not None:
        acc = call.acc
        chunk = call.chunk or chunk
        block_q = call.resolve_block_q()
        q_offset, kv_offset = call.q_offset, call.kv_offset
        return_carry = bool(return_carry or call.return_carry)
    _check_dense(q, k, v, carry, chunk, kv_offset)
    if block_q not in BLOCK_QS:
        raise NotImplementedError(f"the kernel is built for block_q in "
                                  f"{BLOCK_QS}, got {block_q}")
    kw = dict(acc=acc, chunk=chunk, q_offset=q_offset, kv_offset=kv_offset,
              carry=carry, return_carry=return_carry, rounding=rounding,
              sr_seed=seed)
    if q.device.type == "cpu":
        return flash_prefill_reference(q, k, v, **kw)
    s, h, dh = q.shape
    sk, kv = k.shape[0], k.shape[1]
    if dh > MAX_DH or chunk > MAX_CHUNK:
        raise NotImplementedError(
            f"the kernel's tiles hold dh <= {MAX_DH} and chunk <= "
            f"{MAX_CHUNK}; got dh={dh}, chunk={chunk}")
    ts = [q, k, v] + ([] if carry is None else list(carry))
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"flash_prefill takes float32, got {t.dtype}")
    _check_cuda(*ts)
    out = torch.empty_like(q)
    om = ol = None
    if return_carry:
        om = torch.empty((s, h), dtype=torch.float32, device=q.device)
        ol = torch.empty_like(om)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    co, cm, cl = carry if carry is not None else (None, None, None)
    if s > 0:
        sched = sm90.attn_prefill_schedule(
            s, kv, h // kv, chunk, dh,
            sm90.prefill_pages(chunk, q_offset, s, kv_offset, sk))
        scale, *qacc = _attn_consts(dh, tuple(acc))
        rc = build.function("flash_prefill", "flash_prefill", _DENSE_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(co), ptr(cm),
            ptr(cl), out.data_ptr(), ptr(om), ptr(ol), s, h, sk, kv, dh,
            chunk, int(q_offset), int(kv_offset), scale, *qacc, sched.rows,
            sched.cluster, sched.rank_pages, int(sr), seed,
            torch.cuda.current_stream(q.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_prefill launch failed: CUDA error "
                               f"{rc}")
        if sr:
            flash_prefill.sr_launches += 1
        else:
            flash_prefill.launches += 1
    if return_carry:
        return out, om, ol
    return out


flash_prefill.launches = 0
flash_prefill.sr_launches = 0
