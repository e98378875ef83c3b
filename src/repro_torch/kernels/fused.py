"""Fused quantized GEMM with a chunked low-precision carry: G, E and K8.

G replaces the TPU kernel ``repro/kernels/fused.py::_fused_kernel`` (RNE
carry, f32 or bf16 operands, no ``out_fmt``/``pack_out`` epilogue); E
replaces ``_fused_kernel_emitq``, the training forward, which also emits
the int8 codes of both quantized operands for the backward.  G is the CUDA
C++ kernel of ``csrc/qgemm.cu``, E that of ``csrc/qgemm_emitq.cu``::

    C[M, N] = sum over chunks of K:  carry = q_acc(carry + Q(A_c) @ Q(B_c))

``Q`` rounds each operand to ``repr_fmt`` (skipped when it is None) before
it enters a product; the intra-chunk partial is an f32 sum in increasing k
order kept apart from the carry, and the carry is rounded to (1, e_acc,
m_acc) once per ``block_k`` (= the plan's chunk) products.  Products of
(1,5,2) values, and of bf16 values, are exact in f32, so a fused
multiply-add equals a multiply then add here.

What bounds it on the H100: at decode (M = max_batch = 8) every GEMM reads
its whole weight once: the 197 GEMMs of one qwen2-1.5b decode step read
3.1 GB of bf16 weights, about 0.93 ms at 3.35 TB/s; the arithmetic is
negligible.  At training (M = 512 tokens) it is the arithmetic, in f32 on
the CUDA cores: the bitwise contract fixes each chunk's partial to the
sequential round-to-nearest f32 chain, which a tensor-core MMA (``wgmma``,
``mma.sync``) does not form, so the tensor cores are not an option for
these kernels.

G has two routes (``kernels.sm90.g_schedule`` picks one from the shape;
every output is bitwise either way).  Up to ``sm90.DECODE_MAX_M`` rows
(twice that where the tile would leave SMs idle) it runs the decode
kernel of ``csrc/qgemm.cu``: a thread forms the 8 x V
partials of one chunk for V columns (one 32-bit word of the weight's type),
reading the bf16 weights along whichever axis is contiguous (a warp takes
a 128-byte row of the row-major (K, N) layout a load, or 16 bytes of k a
column of the tied embedding through its transposed strides, so no 467 MB
copy is made per step) and quantizing each once in registers; the chunks
of a column strip are split over blocks at chunk boundaries where the
strips alone leave the card short of warps, and their partials are folded
in chunk order from an f32 workspace by a second kernel.  Above it G
runs the Hopper tile below without the shadow carry, so its C is bitwise
K8's.

E and K8 run the Hopper tile ``csrc/qgemm_sm90.cuh``: 8 x 8 partials a
thread in registers, the carries in shared memory, chunk groups that form
the partials of different chunks of one tile at once and fold them in
chunk order (``kernels.sm90`` picks the groups from the shape), operands
landed by ``cp.async`` in their stored type.  E (``csrc/qgemm_emitq.cu``)
first runs one quantize-and-pack pass over both operands: it writes the
int8 codes, each once, and bf16 scratches of Q(A) and Q(B) (exact for a
packable format; NaN stays NaN), on which the tile then runs with nothing
left to quantize.  C is bitwise G's and K8's.  On the CPU every route runs
the plain version; on the card ``python3 chip_smoke.py`` holds each
against it.

``collect_stats=True`` is K8's port (``csrc/qgemm_stats.cu``, replacing
``_fused_kernel_stats``): the same C as G, bitwise, plus the
swamping-telemetry stats row (``kernels.common.N_STATS``) of the carry
against an f32 shadow carry of the same partials.  Its operands may also
be int8 codes of ``repr_fmt`` (``a_packed``/``b_packed``: the saved
residuals of the in-graph telemetry's FWD replay), and
``quantize_a``/``quantize_b`` turn the operand quantization off per
operand (the telemetry probe's backward roles, whose residual operand is
already quantized).  Every block of the kernel reduces its tile to a
partial row in float64 and a second, fixed-order pass sums the rows and
rounds once to float32, so the row is the same bits on every launch.

``rounding="sr"`` rounds every chunk carry stochastically: the dither of
an output's carry update is a Threefry draw keyed on the seed, the chunk's
index in the K walk and the output's flat logical index
(``kernels.common.sr_random_bits``), the JAX package's stream bit for
bit, so E's and K8's C agree under one seed.  E and K8 carry it on the
card (the tile's fold, ``csrc/qgemm_sm90.cuh``); G's kernels do not yet
(ROADMAP [sr-rest]), and G's SR call raises on CUDA tensors.  SR launches
are counted apart (``sr_emitq_launches``, ``sr_stats_launches``).

On CPU tensors each wrapper runs its plain PyTorch version; on CUDA tensors
it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, sm90
from repro_torch.kernels.common import (
    N_STATS,
    ROUNDINGS,
    qfmt_args,
    quantize_block,
    quantize_carry,
    sr_bits,
    sr_flat_index,
    stats_delta_row,
    stats_row,
    stats_update,
)
from repro_torch.quant.formats import fmt_tuple
from repro_torch.quant.qtensor import pack_block, unpack_block

__all__ = ["qmatmul_fused", "qmatmul_fused_reference", "qmatmul_fused_with",
           "qmatmul_fused_stats_reference", "chunked_gemm_reference",
           "as_sr_seed"]

_WIDE = (8, 23)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def as_sr_seed(seed) -> int:
    """An SR seed as the kernels take it: an int masked to 32 bits (the
    JAX package's ``as_sr_seed`` casts to uint32)."""
    return int(seed) & 0xFFFFFFFF


def check_rounding(rounding: str) -> bool:
    """True for ``"sr"``; ValueError for a mode that is not a rounding."""
    if rounding not in ROUNDINGS:
        raise ValueError(f"rounding must be one of {ROUNDINGS}, "
                         f"got {rounding!r}")
    return rounding == "sr"


def _check(a, b, fmt=None, a_packed=False, b_packed=False):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if (a_packed or b_packed) and fmt is None:
        raise ValueError("packed operands need repr_fmt to decode")
    for name, t, packed in (("a", a, a_packed), ("b", b, b_packed)):
        if packed and t.dtype != torch.int8:
            raise TypeError(f"{name}_packed expects int8 codes, got {t.dtype}")
        if not packed and t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")


def chunked_gemm_reference(a32: torch.Tensor, b32: torch.Tensor, *,
                           e_acc: int, m_acc: int, block_k: int,
                           carry: torch.Tensor | None = None,
                           stats: bool = False, rounding: str = "rne",
                           sr_seed: int = 0):
    """The kernels' chunked carry on float32 operands taken as they are:
    per chunk of K, an f32 partial of rank-1 updates in increasing k (one
    multiply-add each), then ``carry = q_acc(carry + partial)``, with a
    ragged last chunk.  ``carry`` resumes a running carry (the dx segment
    chain); a fresh one starts at 0.  The kernels' order, so bitwise them.

    ``rounding="sr"`` rounds each update stochastically, the dither keyed
    on ``sr_seed``, the chunk's index (from 0, the first chunk dithered
    too) and the flat index ``row * N + col`` of the (M, N) output.

    ``stats=True`` also keeps the f32 shadow carry ``ideal += partial`` and
    returns ``(carry, row)``: the float32 (N_STATS,) stats row, reduced in
    float64 (``kernels.common.stats_delta_row``) and rounded once."""
    m, k = a32.shape
    n = b32.shape[1]
    carry = (torch.zeros((m, n), dtype=torch.float32, device=a32.device)
             if carry is None else carry.to(torch.float32).clone())
    if stats:
        ideal = torch.zeros_like(carry)
        acc = stats_row(carry.device)
        mask = torch.ones((m, n), dtype=torch.bool, device=carry.device)
    flat = None
    if rounding == "sr":
        dev = carry.device
        flat = sr_flat_index(
            torch.arange(m, dtype=torch.int64, device=dev)[:, None],
            torch.arange(n, dtype=torch.int64, device=dev)[None, :], n)
    for k0 in range(0, k, block_k):
        part = torch.zeros_like(carry)
        for kk in range(k0, min(k0 + block_k, k)):
            part = torch.addcmul(part, a32[:, kk:kk + 1], b32[kk:kk + 1, :])
        prev = carry
        rbits = None if flat is None else sr_bits(sr_seed, k0 // block_k,
                                                  flat)
        carry = quantize_carry(carry + part, e_acc, m_acc, rounding, rbits)
        if stats:
            ideal = ideal + part
            acc = stats_update(acc, *stats_delta_row(
                carry, prev, ideal, part, mask, k0 + block_k >= k))
    if stats:
        return carry, acc.to(torch.float32)
    return carry


def _operand32(x, packed: bool, quantize: bool, fmt):
    """An operand as the kernels see it after its load: int8 codes
    unpacked, float values widened and quantized to ``fmt`` when asked."""
    if packed:
        return unpack_block(x, *fmt)
    x32 = x.to(torch.float32)
    return quantize_block(x32, *fmt) if (quantize and fmt is not None) else x32


def qmatmul_fused_reference(a: torch.Tensor, b: torch.Tensor, *,
                            repr_fmt=None, e_acc: int = 8, m_acc: int = 23,
                            block_k: int = 128,
                            return_quantized: bool = False,
                            rounding: str = "rne", sr_seed: int = 0):
    """Plain PyTorch version of G (and of E with ``return_quantized``), in
    the kernel's order: quantize both operands, then
    ``chunked_gemm_reference`` (under ``rounding``/``sr_seed``); E's codes
    are ``pack_block`` of the quantized operands.  Bitwise the kernels;
    bitwise the JAX reference wherever the intra-chunk f32 sums are exact
    (the reference's dot sums in another order)."""
    _check(a, b)
    check_rounding(rounding)
    fmt = fmt_tuple(repr_fmt)
    if return_quantized:
        _check_packable(fmt)
    a32 = _operand32(a, False, True, fmt)
    b32 = _operand32(b, False, True, fmt)
    y = chunked_gemm_reference(a32, b32, e_acc=e_acc, m_acc=m_acc,
                               block_k=block_k, rounding=rounding,
                               sr_seed=as_sr_seed(sr_seed))
    if return_quantized:
        return y, pack_block(a32, *fmt), pack_block(b32, *fmt)
    return y


def qmatmul_fused_stats_reference(a: torch.Tensor, b: torch.Tensor, *,
                                  repr_fmt=None, e_acc: int = 8,
                                  m_acc: int = 23, block_k: int = 128,
                                  quantize_a: bool = True,
                                  quantize_b: bool = True,
                                  a_packed: bool = False,
                                  b_packed: bool = False,
                                  rounding: str = "rne", sr_seed: int = 0):
    """Plain PyTorch version of K8's kernel: ``(C, row)``, C as
    ``qmatmul_fused_reference`` and the float32 (N_STATS,) stats row of
    ``chunked_gemm_reference(..., stats=True)``.  C, the counters and
    MAX_ABS are bitwise the kernel's; the float64 sums add the same terms
    in another order."""
    fmt = fmt_tuple(repr_fmt)
    _check(a, b, fmt, a_packed, b_packed)
    check_rounding(rounding)
    a32 = _operand32(a, a_packed, quantize_a, fmt)
    b32 = _operand32(b, b_packed, quantize_b, fmt)
    return chunked_gemm_reference(a32, b32, e_acc=e_acc, m_acc=m_acc,
                                  block_k=block_k, stats=True,
                                  rounding=rounding,
                                  sr_seed=as_sr_seed(sr_seed))


def _check_packable(fmt) -> None:
    if fmt is None or 1 + fmt[0] + fmt[1] > 8:
        raise ValueError(f"return_quantized emits int8 codes: repr_fmt must "
                         f"fit in 8 bits, got {fmt}")



_LL, _I, _P, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_ARGTYPES = [_P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _I, _I, _I, _I,
             _I, _I, _F, _F, _I, _I, _I, _I, _F, _F, _I, _I, _I, _P, _P]


def qmatmul_fused_with(a: torch.Tensor, b: torch.Tensor, schedule, *,
                       repr_fmt=None, e_acc: int = 8, m_acc: int = 23,
                       block_k: int = 128) -> torch.Tensor:
    """G on CUDA tensors under a given schedule: a ``sm90.DecodeSchedule``
    (the decode route, any split) or a ``sm90.Schedule`` (the tile).
    Every schedule gives the same bits; ``qmatmul_fused`` takes
    ``sm90.g_schedule``'s.  Counts nothing: it serves route timings and
    the tests of each schedule."""
    _check(a, b)
    _check_cuda(a, b, block_k)
    return _g(a, b, schedule, fmt_tuple(repr_fmt), e_acc, m_acc, block_k)


# qfmt_args of the few formats in use, built once (G runs ~200 times a
# decode step, where the host's work a call is what the step waits on)
_qfmt = functools.lru_cache(maxsize=64)(qfmt_args)


def _g(a, b, schedule, fmt, e_acc, m_acc, block_k) -> torch.Tensor:
    """G's launch on checked CUDA operands."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    ws = None
    if isinstance(schedule, sm90.DecodeSchedule):
        route, par, slices = 0, schedule.slots, schedule.slices
        if slices > 1:
            ws = torch.empty((schedule.ws_floats,), dtype=torch.float32,
                             device=a.device)
    else:
        route, par, slices = 1, schedule.groups, 1
    quant = int(fmt is not None)
    rc = build.function("qgemm", "qgemm", _ARGTYPES)(
        a.data_ptr(), _DTYPES[a.dtype], a.stride(0), a.stride(1),
        b.data_ptr(), _DTYPES[b.dtype], b.stride(0), b.stride(1),
        out.data_ptr(), m, n, k, block_k, *_qfmt(fmt or _WIDE), quant, quant,
        *_qfmt((e_acc, m_acc)), route, par, slices,
        None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qgemm launch failed: CUDA error {rc}")
    return out


def qmatmul_fused(a: torch.Tensor, b: torch.Tensor, *, repr_fmt=None,
                  e_acc: int = 8, m_acc: int = 23, block_k: int = 128,
                  quantize_a: bool = True, quantize_b: bool = True,
                  a_packed: bool = False, b_packed: bool = False,
                  return_quantized: bool = False,
                  collect_stats: bool = False, rounding: str = "rne",
                  sr_seed: int = 0):
    """C[M, N] = Q(A) @ Q(B) with a (1, e_acc, m_acc) carry rounded every
    ``block_k`` products (the chunk n1).

    * ``a`` (M, K), ``b`` (K, N): float32 or bfloat16, any strides (the
      tied lm_head passes ``embed.T`` as a view);
    * ``repr_fmt``: operand format (``FPFormat``/``(e, m)``), None = no
      operand quantization;
    * ``collect_stats`` only: ``quantize_a``/``quantize_b`` turn the
      quantization off per operand, and ``a_packed``/``b_packed`` take the
      operand as int8 codes of ``repr_fmt`` (not quantized again);
    * returns float32 (M, N);
    * ``return_quantized=True`` is kernel E: returns ``(C, xq, wq)``, the
      int8 codes (``quant.qtensor`` layout) of Q(A) [M, K] and Q(B) [K, N]
      each written once; ``repr_fmt`` must then fit in 8 bits;
    * ``collect_stats=True`` is K8's kernel: returns ``(C, row)``, C
      bitwise the stats-off call's and ``row`` the float32 (N_STATS,)
      swamping stats on the device (read with
      ``telemetry.stats.EnsembleStats.from_raw``); exclusive with
      ``return_quantized``;
    * ``rounding``: ``"rne"`` or ``"sr"``, the carry's rounding;
      ``sr_seed`` (an int, taken mod 2^32) keys SR's dither.  E and K8
      carry SR on the card; G's SR runs only as the plain version (CPU
      tensors) and raises on CUDA tensors.

    G's calls are counted on ``launches`` (one a call) and the fold
    kernels of its split decode calls, each a second launch, on
    ``fold_launches``; E's on ``emitq_launches``, K8's on
    ``stats_launches``; E's and K8's SR launches apart, on
    ``sr_emitq_launches`` and ``sr_stats_launches``.
    """
    sr = check_rounding(rounding)
    seed = as_sr_seed(sr_seed)
    if collect_stats and return_quantized:
        raise ValueError("collect_stats is a probe-path epilogue; residual "
                         "emission is a train-path epilogue: pick one")
    if collect_stats:
        return _stats(a, b, repr_fmt=repr_fmt, e_acc=e_acc, m_acc=m_acc,
                      block_k=block_k, quantize_a=quantize_a,
                      quantize_b=quantize_b, a_packed=a_packed,
                      b_packed=b_packed, rounding=rounding, seed=seed)
    if not (quantize_a and quantize_b) or a_packed or b_packed:
        raise ValueError("per-operand quantization and packed operands are "
                         "K8's (collect_stats=True)")
    if return_quantized:
        return _emitq(a, b, repr_fmt=repr_fmt, e_acc=e_acc, m_acc=m_acc,
                      block_k=block_k, rounding=rounding, seed=seed)
    _check(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return qmatmul_fused_reference(a, b, repr_fmt=repr_fmt, e_acc=e_acc,
                                       m_acc=m_acc, block_k=block_k,
                                       rounding=rounding, sr_seed=seed)
    if sr:
        raise NotImplementedError(
            "G's stochastic-rounding carry (its decode kernel, its fold "
            "kernel and its tile route) is not ported yet (ROADMAP "
            "[sr-rest])")
    _check_cuda(a, b, block_k)
    m, k = a.shape
    n = b.shape[1]
    sched = sm90.g_schedule(m, n, k, block_k, _KINDS[a.dtype],
                            _KINDS[b.dtype])
    out = _g(a, b, sched, fmt_tuple(repr_fmt), e_acc, m_acc, block_k)
    if m and n:
        qmatmul_fused.launches += 1
        if isinstance(sched, sm90.DecodeSchedule) and sched.slices > 1:
            qmatmul_fused.fold_launches += 1
    return out


qmatmul_fused.launches = 0
qmatmul_fused.fold_launches = 0
qmatmul_fused.emitq_launches = 0
qmatmul_fused.stats_launches = 0
qmatmul_fused.sr_emitq_launches = 0
qmatmul_fused.sr_stats_launches = 0

_U = ctypes.c_uint
_STATS_ARGTYPES = ([_P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _I, _I, _I, _I,
                    _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _F, _F, _I, _I,
                    _U, _P, _P, _P])


def _stats(a, b, *, repr_fmt, e_acc, m_acc, block_k, quantize_a, quantize_b,
           a_packed, b_packed, rounding, seed):
    """K8, ``qmatmul_fused(..., collect_stats=True)``."""
    fmt = fmt_tuple(repr_fmt)
    _check(a, b, fmt, a_packed, b_packed)
    kw = dict(repr_fmt=fmt, e_acc=e_acc, m_acc=m_acc, block_k=block_k,
              quantize_a=quantize_a, quantize_b=quantize_b,
              a_packed=a_packed, b_packed=b_packed, rounding=rounding,
              sr_seed=seed)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return qmatmul_fused_stats_reference(a, b, **kw)
    _check_cuda(a, b, block_k)
    m, k = a.shape
    n = b.shape[1]
    dev = a.device
    out = torch.zeros((m, n), dtype=torch.float32, device=dev)
    row = torch.zeros((N_STATS,), dtype=torch.float32, device=dev)
    if m == 0 or n == 0 or k == 0:
        return out, row
    blocks = build.function("qgemm_stats", "qgemm_stats_blocks", [_I, _I])(
        m, n)
    part = torch.empty((blocks, N_STATS), dtype=torch.float64, device=dev)
    e_r, m_r = fmt or _WIDE
    quant = fmt is not None
    sched = sm90.gemm_schedule(m, n, k, block_k, _KINDS[a.dtype],
                               _KINDS[b.dtype])
    rc = build.function("qgemm_stats", "qgemm_stats", _STATS_ARGTYPES)(
        a.data_ptr(), _KINDS[a.dtype], a.stride(0), a.stride(1),
        b.data_ptr(), _KINDS[b.dtype], b.stride(0), b.stride(1),
        out.data_ptr(), m, n, k, block_k, e_r, m_r, *qfmt_args(fmt or _WIDE),
        int(quant and quantize_a and not a_packed),
        int(quant and quantize_b and not b_packed),
        *qfmt_args((e_acc, m_acc)), sched.groups, int(rounding == "sr"),
        seed, part.data_ptr(), row.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qgemm_stats launch failed: CUDA error {rc}")
    if rounding == "sr":
        qmatmul_fused.sr_stats_launches += 1
    else:
        qmatmul_fused.stats_launches += 1
    return out, row


def _check_cuda(a, b, block_k) -> None:
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    if block_k < 1:
        raise ValueError(f"block_k must be positive, got {block_k}")


_EMITQ_ARGTYPES = [_P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _I, _I, _I, _I,
                   _I, _I, _I, _I, _F, _F, _I, _I, _F, _F, _I, _I, _U, _P, _P,
                   _P, _P, _P]


def _emitq(a, b, *, repr_fmt, e_acc, m_acc, block_k, rounding, seed):
    """Kernel E, ``qmatmul_fused(..., return_quantized=True)``: the
    quantize-and-pack pass, then the GEMM; one count a call."""
    _check(a, b)
    fmt = fmt_tuple(repr_fmt)
    _check_packable(fmt)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return qmatmul_fused_reference(a, b, repr_fmt=fmt, e_acc=e_acc,
                                       m_acc=m_acc, block_k=block_k,
                                       return_quantized=True,
                                       rounding=rounding, sr_seed=seed)
    _check_cuda(a, b, block_k)
    m, k = a.shape
    n = b.shape[1]
    dev = a.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    aq = torch.empty((m, k), dtype=torch.int8, device=dev)
    bq = torch.empty((k, n), dtype=torch.int8, device=dev)
    if m == 0 or n == 0 or k == 0:
        out.zero_()
        return out, aq, bq
    # the bf16 values of Q(A) and Q(B) the GEMM reads
    qa = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
    qb = torch.empty((k, n), dtype=torch.bfloat16, device=dev)
    sched = sm90.emitq_schedule(m, n, k, block_k)
    rc = build.function("qgemm_emitq", "qgemm_emitq", _EMITQ_ARGTYPES)(
        a.data_ptr(), _DTYPES[a.dtype], a.stride(0), a.stride(1),
        b.data_ptr(), _DTYPES[b.dtype], b.stride(0), b.stride(1),
        out.data_ptr(), m, n, k, block_k, fmt[0], fmt[1], *qfmt_args(fmt),
        *qfmt_args((e_acc, m_acc)), sched.groups, int(rounding == "sr"),
        seed, aq.data_ptr(), bq.data_ptr(), qa.data_ptr(), qb.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qgemm_emitq launch failed: CUDA error {rc}")
    if rounding == "sr":
        qmatmul_fused.sr_emitq_launches += 1
    else:
        qmatmul_fused.emitq_launches += 1
    return out, aq, bq
