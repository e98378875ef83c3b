"""Both backward GEMMs of a quantized dense layer in one launch: kernel B.

Replaces the TPU kernels ``repro/kernels/bwd_pair.py::_pair_kernel`` (K6)
and, with a dx carry in, ``_pair_kernel_seg`` (K7, one N segment of the
split pair) with the CUDA C++ kernel ``csrc/bwd_pair.cu``::

    dx[T, K] = Q(g)[T, N] @ w[K, N]^T   carry (1, bwd_acc) every bwd_chunk
                                        of N, in increasing N
    dw[K, N] = x[T, K]^T @ Q(g)[T, N]   carry (1, grad_acc) every grad_chunk
                                        of T, in increasing T

``xq``/``wq`` are the forward's residuals: int8 codes of Q(x) and Q(w)
(``packed``) or raw float32/bfloat16 tensors of any strides (the lm_head,
whose ``repr_fmt`` is None, passes the ``embed.T`` view; no copy is made).
``g`` is quantized to ``repr_fmt`` on load when ``quantize_g``.

``dx_carry`` resumes dx from a running carry: calling the pair on
consecutive N segments whose widths are multiples of ``bwd_chunk``, each
with the previous segment's dx as its carry, is bitwise the unsplit call
(``qmatmul_bwd_pair_nsplit``, the counterpart of the TPU's VMEM-driven
split).  Hopper has no dw slab to fit, so the port's training step makes
one unsplit call per layer; the carry entry is counted apart, on
``qmatmul_bwd_pair.carry_launches``.

What bounds it on the H100: the f32 arithmetic, 4TKN multiply-adds on the
CUDA cores (a tensor-core MMA does not form the sequential f32 chunk
partial the contract fixes).  The kernel runs the Hopper tile
``csrc/qgemm_sm90.cuh``: 8 x 8 partials a thread, the carries in shared
memory, and chunk groups that form the partials of different chunks of one
output tile at once and fold them in chunk order, so the long sums (the
lm_head's dx walks N = 151936 columns over only (T/64)(K/64) output tiles)
run on 4 x 64 threads a tile; ``kernels.sm90`` picks the groups from the
shape.  When ``quantize_g`` with a format of at most 7 mantissa bits, g is
quantized once a call into a bf16 scratch (Q(Q(v)) = Q(v), and such a
format's values are exact in bf16), which both roles then land and widen.

``collect_stats=True`` is K9's port (``bwd_pair_stats`` in the same
source, replacing ``_pair_kernel_stats``): B's grid, schedule and Q(g)
scratch on the same tile with its shadow carries, so dx and dw are B's,
bitwise, plus a (2, N_STATS) float32 stats row, row 0 the dx (BWD)
accumulator and row 1 the dw (GRAD) one, each from f32 shadow carries of
the same partials; every block writes its tile's partial row, and the dx
tiles' and dw tiles' rows are summed apart by a fixed-order second pass.
The shadow carry takes a second 16 KiB tile a block: at the layers'
operands two 256-thread blocks still fit an SM, at the lm_head's (f32 x
and g) one does (``kernels.sm90.pair_schedule``).

``rounding="sr"`` rounds both carries stochastically, each with its own
seed: dx draws from ``sr_seed_bwd`` at its (t, k) output of N = K columns
and its N-chunk index, dw from ``sr_seed_grad`` at its (k, n) output and
its T-chunk index, so dx is bitwise ``qmatmul_fused(Q(g), Q(w)^T,
sr_seed=sr_seed_bwd)`` and dw ``qmatmul_fused(Q(x)^T, Q(g),
sr_seed=sr_seed_grad)`` (the JAX package's contract).  SR launches of B and
K9 are counted apart (``sr_launches``, ``sr_stats_launches``).  The dx
carry-in entry keys its dither on the global N-chunk and dw column, which
needs an N offset the entry does not take yet: it raises under SR.

On CPU tensors the wrappers run the plain PyTorch version; on CUDA tensors
they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, sm90
from repro_torch.kernels.common import N_STATS, qfmt_args, quantize_block
from repro_torch.kernels.fused import (as_sr_seed, check_rounding,
                                       chunked_gemm_reference)
from repro_torch.quant.formats import fmt_tuple
from repro_torch.quant.qtensor import unpack_block

__all__ = ["qmatmul_bwd_pair", "qmatmul_bwd_pair_nsplit", "qmatmul_bwd_pair_reference",
           "qmatmul_bwd_pair_stats_reference", "pair_segment_width"]

_WIDE = (8, 23)
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check(g, xq, wq, fmt, packed, dx_carry, bwd_chunk, grad_chunk):
    if g.ndim != 2 or xq.ndim != 2 or wq.ndim != 2:
        raise ValueError("2-D operands required")
    t, n = g.shape
    if xq.shape[0] != t or wq.shape[1] != n or wq.shape[0] != xq.shape[1]:
        raise ValueError(f"bad shapes g{tuple(g.shape)} x{tuple(xq.shape)} "
                         f"w{tuple(wq.shape)}")
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g.dtype}")
    if packed:
        if fmt is None:
            raise ValueError("packed residuals need repr_fmt to decode")
        if xq.dtype != torch.int8 or wq.dtype != torch.int8:
            raise TypeError(f"packed=True expects int8 codes, got "
                            f"{xq.dtype}/{wq.dtype}")
    elif xq.dtype not in (torch.float32, torch.bfloat16) or \
            wq.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"raw residuals must be float32 or bfloat16, got "
                        f"{xq.dtype}/{wq.dtype}")
    if bwd_chunk < 1 or grad_chunk < 1:
        raise ValueError(f"chunks must be positive, got {bwd_chunk}, "
                         f"{grad_chunk}")
    if dx_carry is not None and tuple(dx_carry.shape) != (t, xq.shape[1]):
        raise ValueError(f"dx_carry {tuple(dx_carry.shape)} != "
                         f"{(t, xq.shape[1])}")


def _operands32(g, xq, wq, fmt, packed, quantize_g):
    if packed:
        x32, w32 = unpack_block(xq, *fmt), unpack_block(wq, *fmt)
    else:
        x32, w32 = xq.to(torch.float32), wq.to(torch.float32)
    g32 = quantize_block(g, *fmt) if (quantize_g and fmt is not None) else g
    return g32, x32, w32


def _check_sr(rounding, dx_carry) -> bool:
    sr = check_rounding(rounding)
    if sr and dx_carry is not None:
        raise NotImplementedError(
            "the dx carry-in entry under stochastic rounding keys its dither "
            "on the global N chunk and dw column: its N offset is not "
            "ported yet (ROADMAP [sr-rest])")
    return sr


def qmatmul_bwd_pair_reference(g, xq, wq, *, repr_fmt, bwd_acc, grad_acc,
                               bwd_chunk: int, grad_chunk: int, packed: bool,
                               quantize_g: bool = True, dx_carry=None,
                               rounding: str = "rne", sr_seed_bwd: int = 0,
                               sr_seed_grad: int = 0):
    """Plain PyTorch version: unpack the residuals, quantize g, then the two
    chunked GEMMs in the kernel's order (``chunked_gemm_reference``), dx
    resuming from ``dx_carry``.  Bitwise the kernel."""
    fmt = fmt_tuple(repr_fmt)
    _check(g, xq, wq, fmt, packed, dx_carry, bwd_chunk, grad_chunk)
    _check_sr(rounding, dx_carry)
    g32, x32, w32 = _operands32(g, xq, wq, fmt, packed, quantize_g)
    dx = chunked_gemm_reference(g32, w32.T, e_acc=bwd_acc[0],
                                m_acc=bwd_acc[1], block_k=bwd_chunk,
                                carry=dx_carry, rounding=rounding,
                                sr_seed=as_sr_seed(sr_seed_bwd))
    dw = chunked_gemm_reference(x32.T, g32, e_acc=grad_acc[0],
                                m_acc=grad_acc[1], block_k=grad_chunk,
                                rounding=rounding,
                                sr_seed=as_sr_seed(sr_seed_grad))
    return dx, dw


def qmatmul_bwd_pair_stats_reference(g, xq, wq, *, repr_fmt, bwd_acc,
                                     grad_acc, bwd_chunk: int,
                                     grad_chunk: int, packed: bool,
                                     quantize_g: bool = True,
                                     rounding: str = "rne",
                                     sr_seed_bwd: int = 0,
                                     sr_seed_grad: int = 0):
    """Plain PyTorch version of K9's kernel: ``(dx, dw, rows)`` with dx, dw
    as ``qmatmul_bwd_pair_reference`` and ``rows`` the (2, N_STATS)
    float32 stats of the dx and dw accumulators
    (``chunked_gemm_reference(..., stats=True)``)."""
    fmt = fmt_tuple(repr_fmt)
    _check(g, xq, wq, fmt, packed, None, bwd_chunk, grad_chunk)
    check_rounding(rounding)
    g32, x32, w32 = _operands32(g, xq, wq, fmt, packed, quantize_g)
    dx, rx = chunked_gemm_reference(g32, w32.T, e_acc=bwd_acc[0],
                                    m_acc=bwd_acc[1], block_k=bwd_chunk,
                                    stats=True, rounding=rounding,
                                    sr_seed=as_sr_seed(sr_seed_bwd))
    dw, rw = chunked_gemm_reference(x32.T, g32, e_acc=grad_acc[0],
                                    m_acc=grad_acc[1], block_k=grad_chunk,
                                    stats=True, rounding=rounding,
                                    sr_seed=as_sr_seed(sr_seed_grad))
    return dx, dw, torch.stack([rx, rw])


_LL, _I, _P, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_U = ctypes.c_uint
_ARGTYPES = ([_P, _LL, _LL, _P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _P, _P,
              _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I]
             + [_I, _I, _F, _F] * 2 + [_I, _I, _U, _U, _P, _P])


_STATS_ARGTYPES = ([_P, _LL, _LL, _P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I]
                   + [_I, _I, _F, _F] * 2 + [_I, _I, _U, _U, _P, _P, _P, _P])


def _check_devices(*ts):
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1 or not ts[0].is_cuda:
        raise ValueError(f"operands on {sorted(map(str, devs))}")


def _g_scratch(g, fmt, quantize_g):
    """(quant, e_r, m_r, gq): whether g is quantized, the representation
    format, and the [T, N] bf16 scratch that takes Q(g) once a call (exact
    for formats of at most 7 mantissa bits), or None."""
    quant = quantize_g and fmt is not None
    e_r, m_r = fmt or _WIDE
    gq = (torch.empty(g.shape, dtype=torch.bfloat16, device=g.device)
          if quant and m_r <= 7 else None)
    return quant, e_r, m_r, gq


def _launch_stats(g, xq, wq, *, fmt, bwd_acc, grad_acc, bwd_chunk,
                  grad_chunk, quantize_g, sr, seeds):
    """K9, ``qmatmul_bwd_pair(..., collect_stats=True)``."""
    _check_devices(g, xq, wq)
    t, n = g.shape
    k = xq.shape[1]
    dev = g.device
    dx = torch.zeros((t, k), dtype=torch.float32, device=dev)
    dw = torch.zeros((k, n), dtype=torch.float32, device=dev)
    rows = torch.zeros((2, N_STATS), dtype=torch.float32, device=dev)
    if t == 0 or k == 0 or n == 0:
        return dx, dw, rows
    blocks = build.function("bwd_pair", "bwd_pair_stats_blocks",
                            [_I, _I, _I])(t, k, n)
    if blocks < 0:
        raise ValueError(f"pair of {t}x{k}x{n} needs too many blocks")
    part = torch.empty((blocks, N_STATS), dtype=torch.float64, device=dev)
    quant, e_r, m_r, gq = _g_scratch(g, fmt, quantize_g)
    sched = sm90.pair_schedule(t, k, n, bwd_chunk, grad_chunk,
                               _KINDS[xq.dtype], _KINDS[wq.dtype],
                               0 if gq is None else 1, stats=True)
    rc = build.function("bwd_pair", "bwd_pair_stats", _STATS_ARGTYPES)(
        g.data_ptr(), g.stride(0), g.stride(1),
        xq.data_ptr(), _KINDS[xq.dtype], xq.stride(0), xq.stride(1),
        wq.data_ptr(), _KINDS[wq.dtype], wq.stride(0), wq.stride(1),
        dx.data_ptr(), dw.data_ptr(), t, k, n, bwd_chunk, grad_chunk,
        e_r, m_r, *qfmt_args(fmt or _WIDE), int(quant),
        *qfmt_args(bwd_acc), *qfmt_args(grad_acc), sched.groups, int(sr),
        *seeds, None if gq is None else gq.data_ptr(), part.data_ptr(),
        rows.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bwd_pair_stats launch failed: CUDA error {rc}")
    if sr:
        qmatmul_bwd_pair.sr_stats_launches += 1
    else:
        qmatmul_bwd_pair.stats_launches += 1
    return dx, dw, rows


def _launch(g, xq, wq, dx_carry, *, fmt, bwd_acc, grad_acc, bwd_chunk,
            grad_chunk, quantize_g, sr, seeds):
    _check_devices(g, xq, wq, dx_carry)
    t, n = g.shape
    k = xq.shape[1]
    dev = g.device
    dx = torch.empty((t, k), dtype=torch.float32, device=dev)
    dw = torch.empty((k, n), dtype=torch.float32, device=dev)
    carry = None
    if dx_carry is not None:
        carry = dx_carry.to(torch.float32).contiguous()
    if t == 0 or k == 0 or n == 0:
        dx.zero_()
        if carry is not None:
            dx.copy_(carry)
        dw.zero_()
        return dx, dw
    quant, e_r, m_r, gq = _g_scratch(g, fmt, quantize_g)
    sched = sm90.pair_schedule(t, k, n, bwd_chunk, grad_chunk,
                               _KINDS[xq.dtype], _KINDS[wq.dtype],
                               0 if gq is None else 1)
    rc = build.function("bwd_pair", "bwd_pair", _ARGTYPES)(
        g.data_ptr(), g.stride(0), g.stride(1),
        xq.data_ptr(), _KINDS[xq.dtype], xq.stride(0), xq.stride(1),
        wq.data_ptr(), _KINDS[wq.dtype], wq.stride(0), wq.stride(1),
        carry.data_ptr() if carry is not None else None,
        dx.data_ptr(), dw.data_ptr(), t, k, n, bwd_chunk, grad_chunk,
        e_r, m_r, *qfmt_args(fmt or _WIDE), int(quant),
        *qfmt_args(bwd_acc), *qfmt_args(grad_acc), sched.groups, int(sr),
        *seeds, None if gq is None else gq.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bwd_pair launch failed: CUDA error {rc}")
    if sr:
        qmatmul_bwd_pair.sr_launches += 1
    elif dx_carry is None:
        qmatmul_bwd_pair.launches += 1
    else:
        qmatmul_bwd_pair.carry_launches += 1
    return dx, dw


def qmatmul_bwd_pair(g, xq, wq, *, repr_fmt, bwd_acc=_WIDE, grad_acc=_WIDE,
                     bwd_chunk: int = 128, grad_chunk: int = 128,
                     packed: bool = True, quantize_g: bool = True,
                     dx_carry=None, collect_stats: bool = False,
                     rounding: str = "rne", sr_seed_bwd: int = 0,
                     sr_seed_grad: int = 0):
    """``(dx, dw)`` of one dense layer, both float32, in one launch.

    * ``g`` [T, N] float32, any strides; quantized to ``repr_fmt`` on load
      when ``quantize_g`` (and ``repr_fmt`` is not None);
    * ``xq`` [T, K], ``wq`` [K, N]: int8 codes of the quantized forward
      operands when ``packed``, else raw float32/bfloat16 of any strides;
    * ``bwd_acc``/``grad_acc``: (e, m) carry formats; ``bwd_chunk`` rounds
      dx's carry over N, ``grad_chunk`` dw's over T;
    * ``dx_carry`` [T, K]: resume dx from this running carry (the segment
      entry, K7): dw is then this N segment's columns.  Launches with a
      carry are counted on ``carry_launches``, the others on ``launches``;
    * ``collect_stats=True`` is K9's kernel: returns ``(dx, dw, rows)``
      with ``rows`` the (2, N_STATS) float32 stats on the device (row 0
      dx, row 1 dw), counted on ``stats_launches``; no ``dx_carry``;
    * ``rounding``: ``"rne"`` or ``"sr"``, both carries' rounding;
      ``sr_seed_bwd`` keys dx's dither and ``sr_seed_grad`` dw's (ints,
      taken mod 2^32).  SR launches count on ``sr_launches`` (B) and
      ``sr_stats_launches`` (K9); SR with ``dx_carry`` raises.
    """
    sr = _check_sr(rounding, dx_carry)
    seeds = (as_sr_seed(sr_seed_bwd), as_sr_seed(sr_seed_grad))
    fmt = fmt_tuple(repr_fmt)
    bwd_acc, grad_acc = tuple(bwd_acc), tuple(grad_acc)
    tensors = [t for t in (g, xq, wq, dx_carry) if t is not None]
    sr_kw = dict(rounding=rounding, sr_seed_bwd=seeds[0],
                 sr_seed_grad=seeds[1])
    if collect_stats:
        if dx_carry is not None:
            raise ValueError("collect_stats takes no dx_carry (the stats "
                             "pair is the unsplit one)")
        kw = dict(repr_fmt=fmt, bwd_acc=bwd_acc, grad_acc=grad_acc,
                  bwd_chunk=bwd_chunk, grad_chunk=grad_chunk,
                  quantize_g=quantize_g)
        if all(t.device.type == "cpu" for t in tensors):
            return qmatmul_bwd_pair_stats_reference(g, xq, wq, packed=packed,
                                                    **kw, **sr_kw)
        _check(g, xq, wq, fmt, packed, None, bwd_chunk, grad_chunk)
        kw["fmt"] = kw.pop("repr_fmt")
        return _launch_stats(g, xq, wq, sr=sr, seeds=seeds, **kw)
    if all(t.device.type == "cpu" for t in tensors):
        return qmatmul_bwd_pair_reference(
            g, xq, wq, repr_fmt=fmt, bwd_acc=bwd_acc, grad_acc=grad_acc,
            bwd_chunk=bwd_chunk, grad_chunk=grad_chunk, packed=packed,
            quantize_g=quantize_g, dx_carry=dx_carry, **sr_kw)
    _check(g, xq, wq, fmt, packed, dx_carry, bwd_chunk, grad_chunk)
    return _launch(g, xq, wq, dx_carry, fmt=fmt, bwd_acc=bwd_acc,
                   grad_acc=grad_acc, bwd_chunk=bwd_chunk,
                   grad_chunk=grad_chunk, quantize_g=quantize_g, sr=sr,
                   seeds=seeds)


qmatmul_bwd_pair.launches = 0
qmatmul_bwd_pair.carry_launches = 0
qmatmul_bwd_pair.stats_launches = 0
qmatmul_bwd_pair.sr_launches = 0
qmatmul_bwd_pair.sr_stats_launches = 0


def pair_segment_width(n: int, n_split: int, block_n: int) -> int:
    """``block_n``-aligned width of one of ``n_split`` N segments (the JAX
    package's formula)."""
    return max(-(-(-(-n // n_split)) // block_n) * block_n, block_n)


def qmatmul_bwd_pair_nsplit(g, xq, wq, *, n_split: int, **kw):
    """The pair over ``n_split`` N segments of ``bwd_chunk``-aligned width
    (the JAX package's ``pair_segment_width``), dx chained through
    ``dx_carry``: bitwise the unsplit ``qmatmul_bwd_pair``."""
    if n_split < 2:
        raise ValueError("n_split >= 2; use qmatmul_bwd_pair for one pass")
    t, n = g.shape
    seg = pair_segment_width(n, n_split, kw.get("bwd_chunk", 128))
    dx = torch.zeros((t, xq.shape[1]), dtype=torch.float32, device=g.device)
    dws = []
    for lo in range(0, n, seg):
        hi = min(lo + seg, n)
        dx, dw = qmatmul_bwd_pair(g[:, lo:hi], xq, wq[:, lo:hi],
                                  dx_carry=dx, **kw)
        dws.append(dw)
    return dx, torch.cat(dws, dim=1)
