"""Fused quantized GEMM with a chunked low-precision carry: G, E and K8.

G replaces the TPU kernel ``repro/kernels/fused.py::_fused_kernel`` (RNE
and SR carries; f32, bf16 or int8-code operands, each quantized or not;
the ``out_fmt``/``pack_out`` epilogue); E replaces
``_fused_kernel_emitq``, the training forward, which also emits both
quantized operands for the backward, as int8 codes or as float32.  G is the CUDA
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
bit, so G's, E's and K8's C agree under one seed.  ``row0``, ``col0`` and
``n_cols`` place the output in a whole one (a mesh rank's rows or
columns), so each block draws the whole call's bits there; the kernels
take them as three more arguments and only their SR folds read them.
All three carry it on
the card: the tile's fold (``csrc/qgemm_sm90.cuh``) for E, K8 and G's
tile route, and G's decode kernel and its split call's fold kernel
(``csrc/qgemm.cu``), each an SR instantiation beside the RNE one.  The
route and the split do not depend on the rounding.  SR launches are
counted apart (``sr_launches`` and ``sr_fold_launches`` for G,
``sr_emitq_launches``, ``sr_stats_launches``).

The output epilogue (``out_fmt``, ``pack_out``; ``_emit_output`` of the
JAX kernel): the finished carry is rounded to nearest even into the
consumer's format, whatever the carry's rounding, and with ``pack_out``
written as int8 codes.  It runs where C is stored, in variant kernels of
their own (``csrc/qgemm_sm90.cuh``'s OUT flag, and G's decode and fold
kernels with it), so the base kernels keep their code: G's decode
kernel's store, its split call's fold kernel (the partials' store into
the workspace never), and the tile's store for G's tile route, E and K8.
K8's stats row reads the carry, so it is the same with and without it.
E's f32 residuals (``pack_residuals=False``, any ``repr_fmt``, also one
wider than 8 bits): its pass writes Q(A) and Q(B) as floats, the
residuals, and the tile runs on them.  G's int8-code operands
(``a_packed``/``b_packed``) take the tile at every M
(``sm90.g_schedule``): the tile lands and unpacks codes as it does for
K8, and the decode kernel reads float words only; an unquantized operand
(``quantize_a``/``quantize_b`` off) is a flag of either route.

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
           "emit_output", "as_sr_seed", "check_origin"]

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


def _check_out(out_fmt, pack_out: bool):
    """The output epilogue's (e_o, m_o), None without one, after the JAX
    package's checks (``pack_out`` needs an ``out_fmt`` that packs)."""
    out = fmt_tuple(out_fmt)
    if pack_out:
        if out is None:
            raise ValueError("pack_out needs out_fmt to define the code layout")
        if 1 + out[0] + out[1] > 8:
            raise ValueError(f"(1,{out[0]},{out[1]}) needs {1 + sum(out)} "
                             "bits; int8 packing requires <= 8")
    return out


def emit_output(y: torch.Tensor, out_fmt=None,
                pack_out: bool = False) -> torch.Tensor:
    """Plain version of the output epilogue (``_emit_output`` of the JAX
    kernel): the finished carry rounded to nearest even into ``out_fmt``
    (skipped for None and the identity (8, 23)), then, with ``pack_out``,
    ``pack_block`` into int8 codes."""
    out = fmt_tuple(out_fmt) or _WIDE
    if out != _WIDE:
        y = quantize_block(y, *out)
    return pack_block(y, *out) if pack_out else y


def chunked_gemm_reference(a32: torch.Tensor, b32: torch.Tensor, *,
                           e_acc: int, m_acc: int, block_k: int,
                           carry: torch.Tensor | None = None,
                           stats: bool = False, rounding: str = "rne",
                           sr_seed: int = 0, step0: int = 0, col0: int = 0,
                           n_cols: int | None = None, row0: int = 0):
    """The kernels' chunked carry on float32 operands taken as they are:
    per chunk of K, an f32 partial of rank-1 updates in increasing k (one
    multiply-add each), then ``carry = q_acc(carry + partial)``, with a
    ragged last chunk.  ``carry`` resumes a running carry (the dx segment
    chain); a fresh one starts at 0.  The kernels' order, so bitwise them.

    ``rounding="sr"`` rounds each update stochastically, the dither keyed
    on ``sr_seed``, the chunk's index ``step0 + c`` (c from 0, the first
    chunk dithered too) and the flat index ``(row0 + row) * n_cols + col0
    + col`` of the (M, N) output (``n_cols`` None: N).  ``step0``,
    ``row0``, ``col0`` and ``n_cols`` place a block in a longer GEMM, as
    K7's kernel does and as a mesh rank's rows, columns or K-slice do.

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
            row0 + torch.arange(m, dtype=torch.int64, device=dev)[:, None],
            col0 + torch.arange(n, dtype=torch.int64, device=dev)[None, :],
            n if n_cols is None else n_cols)
    for k0 in range(0, k, block_k):
        part = torch.zeros_like(carry)
        for kk in range(k0, min(k0 + block_k, k)):
            part = torch.addcmul(part, a32[:, kk:kk + 1], b32[kk:kk + 1, :])
        prev = carry
        rbits = None if flat is None else sr_bits(
            sr_seed, step0 + k0 // block_k, flat)
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
                            block_k: int = 128, quantize_a: bool = True,
                            quantize_b: bool = True, a_packed: bool = False,
                            b_packed: bool = False,
                            return_quantized: bool = False,
                            pack_residuals: bool = True, out_fmt=None,
                            pack_out: bool = False, rounding: str = "rne",
                            sr_seed: int = 0, row0: int = 0, col0: int = 0,
                            n_cols: int | None = None):
    """Plain PyTorch version of G (and of E with ``return_quantized``), in
    the kernel's order: each operand unpacked (int8 codes) or quantized
    (unless its ``quantize_*`` is off), then ``chunked_gemm_reference``
    (under ``rounding``/``sr_seed``, the output the block at ``row0``,
    ``col0`` of ``n_cols`` columns), then the output epilogue
    (``emit_output``); E's residuals are the quantized operands, as int8
    codes (``pack_block``) with ``pack_residuals`` or as float32.
    Bitwise the kernels; bitwise the JAX reference wherever the
    intra-chunk f32 sums are exact (the reference's dot sums in another
    order)."""
    fmt = fmt_tuple(repr_fmt)
    _check(a, b, fmt, a_packed, b_packed)
    _check_variants(return_quantized, a_packed, b_packed)
    _check_out(out_fmt, pack_out)
    check_rounding(rounding)
    if return_quantized and pack_residuals:
        _check_packable(fmt)
    n_cols = check_origin(row0, col0, n_cols, b.shape[1])
    a32 = _operand32(a, a_packed, quantize_a, fmt)
    b32 = _operand32(b, b_packed, quantize_b, fmt)
    y = chunked_gemm_reference(a32, b32, e_acc=e_acc, m_acc=m_acc,
                               block_k=block_k, rounding=rounding,
                               sr_seed=as_sr_seed(sr_seed), row0=row0,
                               col0=col0, n_cols=n_cols)
    y = emit_output(y, out_fmt, pack_out)
    if return_quantized and pack_residuals:
        return y, pack_block(a32, *fmt), pack_block(b32, *fmt)
    if return_quantized:
        return y, a32, b32
    return y


def qmatmul_fused_stats_reference(a: torch.Tensor, b: torch.Tensor, *,
                                  repr_fmt=None, e_acc: int = 8,
                                  m_acc: int = 23, block_k: int = 128,
                                  quantize_a: bool = True,
                                  quantize_b: bool = True,
                                  a_packed: bool = False,
                                  b_packed: bool = False, out_fmt=None,
                                  pack_out: bool = False,
                                  rounding: str = "rne", sr_seed: int = 0,
                                  row0: int = 0, col0: int = 0,
                                  n_cols: int | None = None):
    """Plain PyTorch version of K8's kernel: ``(C, row)``, C as
    ``qmatmul_fused_reference`` (the SR origin too) and the float32
    (N_STATS,) stats row of
    ``chunked_gemm_reference(..., stats=True)``, taken from the carry
    before the output epilogue.  C, the counters and MAX_ABS are bitwise
    the kernel's; the float64 sums add the same terms in another order."""
    fmt = fmt_tuple(repr_fmt)
    _check(a, b, fmt, a_packed, b_packed)
    _check_out(out_fmt, pack_out)
    check_rounding(rounding)
    n_cols = check_origin(row0, col0, n_cols, b.shape[1])
    a32 = _operand32(a, a_packed, quantize_a, fmt)
    b32 = _operand32(b, b_packed, quantize_b, fmt)
    c, row = chunked_gemm_reference(a32, b32, e_acc=e_acc, m_acc=m_acc,
                                    block_k=block_k, stats=True,
                                    rounding=rounding,
                                    sr_seed=as_sr_seed(sr_seed), row0=row0,
                                    col0=col0, n_cols=n_cols)
    return emit_output(c, out_fmt, pack_out), row


def check_origin(row0: int, col0: int, n_cols: int | None, n: int) -> int:
    """The SR origin's logical column count (``n_cols``, None: N) after
    its checks: the (M, N) output is the block at ``row0``, ``col0`` of a
    whole output of ``n_cols`` columns."""
    if n_cols is None:
        if col0:
            raise ValueError("col0 needs n_cols, the whole output's columns")
        n_cols = n
    if row0 < 0 or col0 < 0 or n_cols < col0 + n:
        raise ValueError(f"columns [{col0}, {col0 + n}) (row0 {row0}) "
                         f"outside n_cols {n_cols}")
    return n_cols


def _check_packable(fmt) -> None:
    if fmt is None or 1 + fmt[0] + fmt[1] > 8:
        raise ValueError(f"return_quantized with pack_residuals emits int8 "
                         f"codes: repr_fmt must fit in 8 bits, got {fmt}")


def _check_variants(return_quantized: bool, a_packed: bool,
                    b_packed: bool) -> None:
    if (a_packed or b_packed) and return_quantized:
        raise ValueError("residual emission is a forward-only epilogue; "
                         "packed operands are a backward-only input")


_LL, _I, _P, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_U = ctypes.c_uint
_Q = [_I, _I, _F, _F]           # a QFmt's four C arguments
# the operands, C, M, N, K, the chunk and the code layout (e_r, m_r)
_GEMM = [_P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _I, _I, _I, _I, _I, _I]
_ORIGIN = [_I, _I, _I]          # the SR origin: row0, col0, n_cols
_ARGTYPES = (_GEMM + _Q + [_I, _I] + _Q + _Q
             + [_I, _I, _I, _I, _U] + _ORIGIN + [_I, _I, _I, _P, _P])


def qmatmul_fused_with(a: torch.Tensor, b: torch.Tensor, schedule, *,
                       repr_fmt=None, e_acc: int = 8, m_acc: int = 23,
                       block_k: int = 128, quantize_a: bool = True,
                       quantize_b: bool = True, a_packed: bool = False,
                       b_packed: bool = False, out_fmt=None,
                       pack_out: bool = False, rounding: str = "rne",
                       sr_seed: int = 0, row0: int = 0, col0: int = 0,
                       n_cols: int | None = None) -> torch.Tensor:
    """G on CUDA tensors under a given schedule: a ``sm90.DecodeSchedule``
    (the decode route, any split; float operands only) or a
    ``sm90.Schedule`` (the tile), under ``rounding``/``sr_seed`` (and the
    SR origin), with G's operand and output variants.  Every schedule
    gives the same bits; ``qmatmul_fused`` takes ``sm90.g_schedule``'s.
    Counts nothing: it serves route timings and the tests of each
    schedule."""
    fmt = fmt_tuple(repr_fmt)
    _check(a, b, fmt, a_packed, b_packed)
    out = _check_out(out_fmt, pack_out)
    sr = check_rounding(rounding)
    _check_cuda(a, b, block_k)
    origin = (row0, col0, check_origin(row0, col0, n_cols, b.shape[1]))
    return _g(a, b, schedule, fmt, e_acc, m_acc, block_k, sr,
              as_sr_seed(sr_seed), qa=quantize_a, qb=quantize_b, out=out,
              pack=pack_out, origin=origin)


# qfmt_args of the few formats in use, built once (G runs ~200 times a
# decode step, where the host's work a call is what the step waits on)
_qfmt = functools.lru_cache(maxsize=64)(qfmt_args)


def _g(a, b, schedule, fmt, e_acc, m_acc, block_k, sr: bool, seed: int, *,
       qa: bool = True, qb: bool = True, out=None, pack: bool = False,
       origin=(0, 0, 0)) -> torch.Tensor:
    """G's launch on checked CUDA operands (SR: under ``seed`` at the
    checked ``origin``, (row0, col0, n_cols)), with the
    output format ``out`` (``pack``: as int8 codes).  ``qa``/``qb`` off:
    that operand is not quantized (codes never are)."""
    m, k = a.shape
    n = b.shape[1]
    dt = torch.int8 if pack else torch.float32
    c = torch.empty((m, n), dtype=dt, device=a.device)
    if m == 0 or n == 0:
        return c
    ws = None
    if isinstance(schedule, sm90.DecodeSchedule):
        route, par, slices = 0, schedule.slots, schedule.slices
        if slices > 1:
            ws = torch.empty((schedule.ws_floats,), dtype=torch.float32,
                             device=a.device)
    else:
        route, par, slices = 1, schedule.groups, 1
    quant = fmt is not None
    fmt, o = fmt or _WIDE, out or _WIDE
    ka, kb = _KINDS[a.dtype], _KINDS[b.dtype]
    rc = build.function("qgemm", "qgemm", _ARGTYPES)(
        a.data_ptr(), ka, a.stride(0), a.stride(1),
        b.data_ptr(), kb, b.stride(0), b.stride(1),
        c.data_ptr(), m, n, k, block_k, *fmt, *_qfmt(fmt),
        int(quant and qa and ka != 2), int(quant and qb and kb != 2),
        *_qfmt((e_acc, m_acc)), *_qfmt(o), int(pack), *o, int(sr), seed,
        *origin, route, par, slices, None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qgemm launch failed: CUDA error {rc}")
    return c


def qmatmul_fused(a: torch.Tensor, b: torch.Tensor, *, repr_fmt=None,
                  e_acc: int = 8, m_acc: int = 23, block_k: int = 128,
                  quantize_a: bool = True, quantize_b: bool = True,
                  a_packed: bool = False, b_packed: bool = False,
                  return_quantized: bool = False,
                  pack_residuals: bool = True, out_fmt=None,
                  pack_out: bool = False, collect_stats: bool = False,
                  rounding: str = "rne", sr_seed: int = 0, row0: int = 0,
                  col0: int = 0, n_cols: int | None = None):
    """C[M, N] = Q(A) @ Q(B) with a (1, e_acc, m_acc) carry rounded every
    ``block_k`` products (the chunk n1).

    * ``a`` (M, K), ``b`` (K, N): float32 or bfloat16, any strides (the
      tied lm_head passes ``embed.T`` as a view);
    * ``repr_fmt``: operand format (``FPFormat``/``(e, m)``), None = no
      operand quantization;
    * ``quantize_a``/``quantize_b`` off: that operand enters as it is;
      ``a_packed``/``b_packed``: it is int8 codes of ``repr_fmt``
      (``quant.qtensor`` layout), unpacked, not quantized again (the
      backward's saved residuals);
    * ``out_fmt``: the consumer's format, into which the finished carry is
      rounded to nearest even in the kernel's epilogue (whatever the
      carry's rounding); ``pack_out`` returns C as int8 codes of it;
    * returns C, float32 (M, N), or int8 (M, N) with ``pack_out``;
    * ``return_quantized=True`` is kernel E: returns ``(C, xq, wq)``, Q(A)
      [M, K] and Q(B) [K, N], each written once, as int8 codes with
      ``pack_residuals`` (``repr_fmt`` must then fit in 8 bits; the
      default here, where the JAX package's is False) or as float32
      (any ``repr_fmt``, or None: the operands as they are); exclusive
      with packed operands;
    * ``collect_stats=True`` is K8's kernel: returns ``(C, row)``, C
      bitwise the stats-off call's and ``row`` the float32 (N_STATS,)
      swamping stats of the carry (unchanged by ``out_fmt``) on the
      device (read with ``telemetry.stats.EnsembleStats.from_raw``);
      exclusive with ``return_quantized``;
    * ``rounding``: ``"rne"`` or ``"sr"``, the carry's rounding;
      ``sr_seed`` (an int, taken mod 2^32) keys SR's dither;
    * ``row0``, ``col0``, ``n_cols``: C is the block at row ``row0`` and
      column ``col0`` of a whole output of ``n_cols`` columns (None: N),
      so SR's dither keys on the whole output's flat index, the same bits
      as the whole call's there (a mesh rank's rows or columns); RNE
      ignores them.

    Counts, one a call: G's base calls on ``launches`` (RNE) or
    ``sr_launches``, the fold kernels of split decode calls on
    ``fold_launches``/``sr_fold_launches``; G's calls with an output
    format on ``out_launches`` (their folds on ``out_fold_launches``), with
    packed or unquantized operands and no output format on
    ``operand_launches``; E's base calls on ``emitq_launches`` or
    ``sr_emitq_launches``, its variant calls on ``emitq_out_launches``
    (int8 residuals) or ``emitq_f32_launches`` (f32 residuals); K8's on
    ``stats_launches`` or ``sr_stats_launches``, with an output format on
    ``stats_out_launches``.
    """
    sr = check_rounding(rounding)
    seed = as_sr_seed(sr_seed)
    fmt = fmt_tuple(repr_fmt)
    _check(a, b, fmt, a_packed, b_packed)
    out = (None if out_fmt is None and not pack_out
           else _check_out(out_fmt, pack_out))
    origin = (row0, col0, check_origin(row0, col0, n_cols, b.shape[1]))
    on_cpu = a.device.type == "cpu" and b.device.type == "cpu"
    if collect_stats or return_quantized or on_cpu:
        _check_variants(return_quantized, a_packed, b_packed)
        if collect_stats and return_quantized:
            raise ValueError("collect_stats is a probe-path epilogue; "
                             "residual emission is a train-path epilogue: "
                             "pick one")
        kw = dict(repr_fmt=fmt, e_acc=e_acc, m_acc=m_acc, block_k=block_k,
                  quantize_a=quantize_a, quantize_b=quantize_b, out_fmt=out,
                  pack_out=pack_out, rounding=rounding, sr_seed=seed,
                  row0=origin[0], col0=origin[1], n_cols=origin[2])
        if collect_stats:
            return _stats(a, b, a_packed=a_packed, b_packed=b_packed, **kw)
        if return_quantized:
            return _emitq(a, b, pack_residuals=pack_residuals, **kw)
        return qmatmul_fused_reference(a, b, a_packed=a_packed,
                                       b_packed=b_packed, **kw)
    _check_cuda(a, b, block_k)
    m, k = a.shape
    n = b.shape[1]
    sched = sm90.g_schedule(m, n, k, block_k, _KINDS[a.dtype],
                            _KINDS[b.dtype])
    c = _g(a, b, sched, fmt, e_acc, m_acc, block_k, sr, seed,
           qa=quantize_a, qb=quantize_b, out=out, pack=pack_out,
           origin=origin)
    if m and n:
        fold = isinstance(sched, sm90.DecodeSchedule) and sched.slices > 1
        operands = a_packed or b_packed or (
            fmt is not None and not (quantize_a and quantize_b))
        if out is not None:
            qmatmul_fused.out_launches += 1
            qmatmul_fused.out_fold_launches += fold
        elif operands:
            qmatmul_fused.operand_launches += 1
            qmatmul_fused.fold_launches += fold
        elif sr:
            qmatmul_fused.sr_launches += 1
            qmatmul_fused.sr_fold_launches += fold
        else:
            qmatmul_fused.launches += 1
            qmatmul_fused.fold_launches += fold
    return c


qmatmul_fused.launches = 0
qmatmul_fused.fold_launches = 0
qmatmul_fused.sr_launches = 0
qmatmul_fused.sr_fold_launches = 0
qmatmul_fused.out_launches = 0
qmatmul_fused.out_fold_launches = 0
qmatmul_fused.operand_launches = 0
qmatmul_fused.emitq_launches = 0
qmatmul_fused.stats_launches = 0
qmatmul_fused.sr_emitq_launches = 0
qmatmul_fused.sr_stats_launches = 0
qmatmul_fused.emitq_out_launches = 0
qmatmul_fused.emitq_f32_launches = 0
qmatmul_fused.stats_out_launches = 0

_STATS_ARGTYPES = (_GEMM + _Q + [_I, _I] + _Q + _Q
                   + [_I, _I, _I, _I, _I, _U] + _ORIGIN + [_P, _P, _P])


def _stats(a, b, *, repr_fmt, e_acc, m_acc, block_k, quantize_a, quantize_b,
           a_packed, b_packed, out_fmt, pack_out, rounding, sr_seed, row0,
           col0, n_cols):
    """K8, ``qmatmul_fused(..., collect_stats=True)``, on checked operands
    (``out_fmt`` as ``_check_out`` returns it, the origin checked)."""
    kw = dict(repr_fmt=repr_fmt, e_acc=e_acc, m_acc=m_acc, block_k=block_k,
              quantize_a=quantize_a, quantize_b=quantize_b,
              a_packed=a_packed, b_packed=b_packed, out_fmt=out_fmt,
              pack_out=pack_out, rounding=rounding, sr_seed=sr_seed,
              row0=row0, col0=col0, n_cols=n_cols)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return qmatmul_fused_stats_reference(a, b, **kw)
    _check_cuda(a, b, block_k)
    m, k = a.shape
    n = b.shape[1]
    dev = a.device
    out = torch.zeros((m, n), dtype=torch.int8 if pack_out else torch.float32,
                      device=dev)
    row = torch.zeros((N_STATS,), dtype=torch.float32, device=dev)
    if m == 0 or n == 0 or k == 0:
        return out, row
    blocks = build.function("qgemm_stats", "qgemm_stats_blocks", [_I, _I])(
        m, n)
    part = torch.empty((blocks, N_STATS), dtype=torch.float64, device=dev)
    e_r, m_r = repr_fmt or _WIDE
    quant = repr_fmt is not None
    sched = sm90.gemm_schedule(m, n, k, block_k, _KINDS[a.dtype],
                               _KINDS[b.dtype])
    o = out_fmt or _WIDE
    rc = build.function("qgemm_stats", "qgemm_stats", _STATS_ARGTYPES)(
        a.data_ptr(), _KINDS[a.dtype], a.stride(0), a.stride(1),
        b.data_ptr(), _KINDS[b.dtype], b.stride(0), b.stride(1),
        out.data_ptr(), m, n, k, block_k, e_r, m_r,
        *_qfmt(repr_fmt or _WIDE),
        int(quant and quantize_a and not a_packed),
        int(quant and quantize_b and not b_packed),
        *_qfmt((e_acc, m_acc)), *_qfmt(o), int(pack_out), *o, sched.groups,
        int(rounding == "sr"), sr_seed, row0, col0, n_cols, part.data_ptr(),
        row.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qgemm_stats launch failed: CUDA error {rc}")
    if out_fmt is not None:
        qmatmul_fused.stats_out_launches += 1
    elif rounding == "sr":
        qmatmul_fused.sr_stats_launches += 1
    else:
        qmatmul_fused.stats_launches += 1
    return out, row


def _check_cuda(a, b, block_k) -> None:
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    if block_k < 1:
        raise ValueError(f"block_k must be positive, got {block_k}")


_EMITQ_ARGTYPES = (_GEMM + _Q + _Q + _Q + _Q
                   + [_I, _I, _I, _I, _I, _I, _I, _U] + _ORIGIN
                   + [_P, _P, _P, _P, _P])


def _emitq(a, b, *, repr_fmt, e_acc, m_acc, block_k, quantize_a, quantize_b,
           pack_residuals, out_fmt, pack_out, rounding, sr_seed, row0, col0,
           n_cols):
    """Kernel E, ``qmatmul_fused(..., return_quantized=True)``, on checked
    operands: the quantize-and-pack pass, then the GEMM; one count a
    call, the base calls (int8 residuals of both operands quantized, no
    output format) apart from the variants."""
    fmt, packr = repr_fmt, pack_residuals
    if packr:
        _check_packable(fmt)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return qmatmul_fused_reference(
            a, b, repr_fmt=fmt, e_acc=e_acc, m_acc=m_acc, block_k=block_k,
            quantize_a=quantize_a, quantize_b=quantize_b,
            return_quantized=True, pack_residuals=packr, out_fmt=out_fmt,
            pack_out=pack_out, rounding=rounding, sr_seed=sr_seed, row0=row0,
            col0=col0, n_cols=n_cols)
    _check_cuda(a, b, block_k)
    m, k = a.shape
    n = b.shape[1]
    dev = a.device
    qa = quantize_a and fmt is not None
    qb = quantize_b and fmt is not None
    variant = out_fmt is not None or not packr or not (qa and qb)
    rdt = torch.int8 if packr else torch.float32
    out = torch.empty((m, n), dtype=torch.int8 if pack_out else torch.float32,
                      device=dev)
    aq = torch.empty((m, k), dtype=rdt, device=dev)
    bq = torch.empty((k, n), dtype=rdt, device=dev)
    if m == 0 or n == 0 or k == 0:
        out.zero_()
        return out, aq, bq
    # the scratch the GEMM reads: the f32 residuals themselves, or beside
    # int8 codes a bf16 scratch (exact for a quantized packable format) or
    # an f32 one (an operand taken as it is)
    f32 = not (packr and qa and qb)
    sa = sb = None
    if packr:
        sdt = torch.float32 if f32 else torch.bfloat16
        sa = torch.empty((m, k), dtype=sdt, device=dev)
        sb = torch.empty((k, n), dtype=sdt, device=dev)
    sched = sm90.emitq_schedule(m, n, k, block_k, f32=f32)
    o = out_fmt or _WIDE
    e_r, m_r = fmt or (5, 2)    # the code layout (unused without codes)
    sr = int(rounding == "sr")
    rc = build.function("qgemm_emitq", "qgemm_emitq", _EMITQ_ARGTYPES)(
        a.data_ptr(), _DTYPES[a.dtype], a.stride(0), a.stride(1),
        b.data_ptr(), _DTYPES[b.dtype], b.stride(0), b.stride(1),
        out.data_ptr(), m, n, k, block_k, e_r, m_r,
        *_qfmt(fmt if qa else _WIDE), *_qfmt(fmt if qb else _WIDE),
        *_qfmt((e_acc, m_acc)), *_qfmt(o), int(pack_out), *o, int(packr),
        int(f32), sched.groups, sr, sr_seed, row0, col0, n_cols,
        aq.data_ptr(), bq.data_ptr(),
        None if sa is None else sa.data_ptr(),
        None if sb is None else sb.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qgemm_emitq launch failed: CUDA error {rc}")
    if variant:
        if packr:
            qmatmul_fused.emitq_out_launches += 1
        else:
            qmatmul_fused.emitq_f32_launches += 1
    elif sr:
        qmatmul_fused.sr_emitq_launches += 1
    else:
        qmatmul_fused.emitq_launches += 1
    return out, aq, bq
