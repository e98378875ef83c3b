"""Serve-path attention over the paged int8 KV arena.

Two CUDA C++ kernels replace the TPU kernels of ``repro/kernels/
attention.py``:

* ``paged_attn_decode`` (``csrc/paged_decode.cu``) replaces
  ``_decode_kernel``: one query token per sequence, one thread block per
  (sequence, KV head) holding its g query heads (kv-major grouping: head
  ``hh = hk * g + gg``).  It walks only the pages ``p < ceil(seq_len /
  page_size)`` of the sequence's page-table row, decodes each int8 K/V
  page in shared memory with the page's 2^se scale, and folds it into the
  online softmax.  Bound on the H100: the bytes of the int8 pages it
  reads (plus q and out), a few MB per decode step, i.e. microseconds at
  3.35 TB/s; the sequential page walk (the carry is rounded once per
  page, so pages cannot be split across blocks) makes it latency-bound
  instead.  The design keeps the next page's codes in flight (loaded into
  registers) while the current page is computed.
* ``flash_prefill_paged`` (``csrc/paged_prefill.cu``) replaces
  ``_prefill_paged_kernel``: a grid of (query head, block of
  ``BLOCK_Q`` rows); query head ``hh`` reads KV head ``hh // g`` straight
  from the arena.  Pages before ``start_page``, past ``kv_len`` or wholly
  in the causal future of the block are skipped (provable carry no-ops).
  Bound: its score and value contractions, 4 * T * kv_len * dh * H flops
  for a T-row slab, in f32 on the CUDA cores in this simple design.

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

On CPU tensors the wrappers run the ``*_reference`` plain versions; on
CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import exp2_int, qfmt_args, quantize_block
from repro_torch.quant.formats import fmt_tuple
from repro_torch.quant.qtensor import unpack_block

__all__ = [
    "AttnCall",
    "paged_attn_decode",
    "paged_attn_decode_reference",
    "flash_prefill_paged",
    "flash_prefill_paged_reference",
    "NEG",
    "LOG2E",
    "BLOCK_Q",
]

# Mask value for invalid scores: finite, so exp2(NEG - m) underflows to
# exactly 0 and a fully-masked block never computes inf - inf.
NEG = -1e30
# base-2 softmax: scores are pre-scaled by log2(e)
LOG2E = 1.4426950408889634
# query rows per thread block of the prefill kernel (schedule only: any
# value gives the same bits, since every row's page walk is its own)
BLOCK_Q = 16
# limits of the kernels' shared-memory tiles (csrc/common.cuh)
MAX_DH = 128
MAX_G = 8
MAX_PAGE = 32

_WIDE = (8, 23)


@dataclass(frozen=True)
class AttnCall:
    """One paged-prefill call of an attention bucket: the fields of
    ``repro.kernels.autotune.AttnCall`` the paged prefill uses, i.e. the
    bucket's carry format, the KV code format and the padded page-row
    width ``max_pages`` (0 = any)."""

    e_acc: int = 8
    m_acc: int = 23
    kv_fmt: tuple | None = None
    max_pages: int = 0

    def __post_init__(self):
        object.__setattr__(self, "kv_fmt", fmt_tuple(self.kv_fmt))

    @property
    def acc(self) -> tuple[int, int]:
        return (self.e_acc, self.m_acc)


def _scale(dh: int) -> torch.Tensor:
    return torch.tensor(LOG2E / math.sqrt(dh), dtype=torch.float32)


def _seq_dot(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """sum_d q[..., :, d] * k[..., :, d] over the last axis, in increasing
    d, each product rounded then added: q (..., R, D), k (..., T, D) ->
    (..., R, T)."""
    acc = torch.zeros(q.shape[:-1] + (k.shape[-2],), dtype=torch.float32,
                      device=q.device)
    for d in range(q.shape[-1]):
        acc = acc + q[..., :, d:d + 1] * k[..., None, :, d]
    return acc


def _online_update(o, m, l, t, valid, v, e_acc: int, m_acc: int):
    """One page step of the online softmax with the chunked carry.

    ``o`` (..., R, D), ``m``/``l`` (..., R, 1) carries; ``t`` (..., R, T)
    base-2 scores (NEG where invalid); ``v`` (..., T, D).  Sums in token
    order (see module docstring).  A fully-masked page is a carry no-op.
    """
    m_new = torch.maximum(m, torch.ceil(torch.amax(t, dim=-1, keepdim=True)))
    alpha = torch.exp2(m - m_new)
    p = torch.where(valid, torch.exp2(t - m_new), torch.zeros_like(t))
    lsum = torch.zeros_like(l)
    pv = torch.zeros_like(o)
    for j in range(t.shape[-1]):
        lsum = lsum + p[..., j:j + 1]
        pv = pv + p[..., j:j + 1] * v[..., None, j, :]
    l_new = quantize_block(l * alpha + lsum, e_acc, m_acc)
    o_new = quantize_block(o * alpha + pv, e_acc, m_acc)
    return o_new, m_new, l_new


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
                                seq_lens, *, kv_fmt=None, acc=_WIDE):
    """Plain PyTorch version of ``paged_attn_decode``: gathers pages
    through the page table, dequantizes with the per-page scales and walks
    every page-table column in order (columns past a row's length are
    masked, hence carry no-ops), with the kernel's summation order."""
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
    for p in range(page_table.shape[1]):
        pid = page_table[:, p]
        kb = _page_values(k_pages[pid], k_se[pid], fmt)  # (B, KV, ps, dh)
        vb = _page_values(v_pages[pid], v_se[pid], fmt)
        s = _seq_dot(q4, kb) * scale                     # (B, KV, g, ps)
        tok = p * page_size + torch.arange(page_size, device=dev)
        valid = (tok < seq_lens[:, None, None, None]).expand_as(s)
        s = torch.where(valid, s, torch.full_like(s, NEG))
        o, m, l = _online_update(o, m, l, s, valid, vb, e_acc, m_acc)
    return _finalize(o, l).reshape(b, h, dh)


_DECODE_ARGS = [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _F,
                _I, _I, _I, _I, _F, _F, _P]


def paged_attn_decode(q, k_pages, v_pages, k_se, v_se, page_table, seq_lens,
                      *, kv_fmt=None, acc=_WIDE):
    """One decode token of attention per sequence against the paged arena.

    * ``q`` (B, H, dh) float32, heads kv-major;
    * ``k_pages``/``v_pages`` (P, KV, page_size, dh) int8 ``kv_fmt`` codes,
      ``k_se``/``v_se`` (P,) int32 page scale exponents;
    * ``page_table`` (B, max_pages) int32, padded with the null page 0;
    * ``seq_lens`` (B,) int32 attended tokens (0 = padded row, output 0);
    * ``acc`` the (e_acc, m_acc) carry of the context bucket.

    Returns (B, H, dh) float32.
    """
    if q.device.type == "cpu":
        return paged_attn_decode_reference(
            q, k_pages, v_pages, k_se, v_se, page_table, seq_lens,
            kv_fmt=kv_fmt, acc=acc)
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
    _launch_limits(h // kv, dh, page_size)
    out = torch.empty_like(q)
    rc = build.function("paged_decode", "paged_decode", _DECODE_ARGS)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_se.data_ptr(), v_se.data_ptr(), page_table.data_ptr(),
        page_table.shape[1], seq_lens.data_ptr(), out.data_ptr(),
        b, kv, h // kv, page_size, dh, ctypes.c_float(float(_scale(dh))),
        *fmt, *qfmt_args(acc), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {rc}")
    paged_attn_decode.launches += 1
    return out


paged_attn_decode.launches = 0


# --------------------------------------------------------------------------
# bucketed paged prefill
# --------------------------------------------------------------------------


def flash_prefill_paged_reference(q, k_pages, v_pages, k_se, v_se, page_row,
                                  q_offset: int, q_len: int, kv_len: int, *,
                                  kv_fmt=None, acc=_WIDE, start_page: int = 0,
                                  call: AttnCall | None = None):
    """Plain PyTorch version of ``flash_prefill_paged``: walks the pages
    ``[0, ceil(kv_len / page_size))`` of the page row in order (the rest
    are masked, hence carry no-ops), pages before ``start_page`` masked,
    with the kernel's summation order."""
    if call is not None:
        acc, kv_fmt = call.acc, call.kv_fmt
    fmt = _check_pages(q, k_pages, v_pages, kv_fmt)
    t, h, dh = q.shape
    kv, page_size = k_pages.shape[1], k_pages.shape[2]
    g = h // kv
    e_acc, m_acc = acc
    dev = q.device
    qt = q.to(torch.float32).transpose(0, 1)             # (h, t, dh)
    o = torch.zeros((h, t, dh), dtype=torch.float32, device=dev)
    m = torch.full((h, t, 1), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((h, t, 1), dtype=torch.float32, device=dev)
    scale = _scale(dh).to(dev)
    rloc = torch.arange(t, device=dev)[:, None]
    rows = q_offset + rloc
    page_row = page_row.to(device=dev, dtype=torch.int64)
    for p in range(-(-kv_len // page_size)):
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
        o, m, l = _online_update(o, m, l, s, valid, vb, e_acc, m_acc)
    return _finalize(o, l).transpose(0, 1)


_PREFILL_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                 _I, _F, _I, _I, _I, _I, _F, _F, _P]


def flash_prefill_paged(q, k_pages, v_pages, k_se, v_se, page_row,
                        q_offset: int, q_len: int, kv_len: int, *,
                        kv_fmt=None, acc=_WIDE, start_page: int = 0,
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
    * ``call`` supplies ``acc``/``kv_fmt`` from the bucket's ``AttnCall``.

    Returns (T, H, dh) float32.
    """
    if call is not None:
        acc, kv_fmt = call.acc, call.kv_fmt
        if call.max_pages and page_row.shape[0] != call.max_pages:
            raise ValueError(f"page_row width {page_row.shape[0]} != bucket "
                             f"max_pages {call.max_pages}")
    if q.device.type == "cpu":
        return flash_prefill_paged_reference(
            q, k_pages, v_pages, k_se, v_se, page_row, q_offset, q_len,
            kv_len, kv_fmt=kv_fmt, acc=acc, start_page=start_page)
    fmt = _check_pages(q, k_pages, v_pages, kv_fmt)
    if q.dtype != torch.float32 or q.ndim != 3:
        raise TypeError(f"q must be (T, H, dh) float32, got {q.dtype} "
                        f"{tuple(q.shape)}")
    for x in (k_se, v_se, page_row):
        if x.dtype != torch.int32:
            raise TypeError("page scales and page row are int32")
    _check_cuda(q, k_pages, v_pages, k_se, v_se, page_row)
    t, h, dh = q.shape
    kv, page_size = k_pages.shape[1], k_pages.shape[2]
    _launch_limits(h // kv, dh, page_size)
    if -(-kv_len // page_size) > page_row.shape[0]:
        raise ValueError(f"kv_len {kv_len} needs more pages than the row's "
                         f"{page_row.shape[0]}")
    out = torch.empty_like(q)
    rc = build.function("paged_prefill", "paged_prefill", _PREFILL_ARGS)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_se.data_ptr(), v_se.data_ptr(), page_row.data_ptr(), out.data_ptr(),
        t, h, kv, page_size, dh, int(q_offset), int(q_len), int(kv_len),
        int(start_page), ctypes.c_float(float(_scale(dh))), *fmt,
        *qfmt_args(acc), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_prefill launch failed: CUDA error {rc}")
    flash_prefill_paged.launches += 1
    return out


flash_prefill_paged.launches = 0
