"""Elementwise helpers shared by the kernels' plain versions.

Counterpart of ``repro.kernels.common``: the (1, e, m) quantizer under
round-to-nearest-even and under stochastic rounding (SR), the
counter-based Threefry-2x32 that makes SR's dither bits, the carry update
and the swamping-stats row.  The CUDA kernels carry the same arithmetic
in ``csrc/common.cuh``; the two are held against each other on the card
and against the JAX package here.

Bit math runs on ``x.view(torch.int32)`` widened to int64 and masked to
32 bits after every add and shift: torch's uint32 support is partial, and
int64 keeps the rounding carry of a NaN payload from overflowing.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["quantize_block", "quantize_block_sr", "quantize_carry",
           "carry_update", "threefry2x32", "sr_random_bits", "sr_bits",
           "sr_flat_index", "ROUNDINGS",
           "qfmt_params", "qfmt_args", "pad2d",
           "exp2_int", "N_STATS", "STAT_COUNT", "STAT_SUM_Q", "STAT_SUMSQ_Q",
           "STAT_SUM_I", "STAT_SUMSQ_I", "STAT_MAX_ABS", "STAT_SWAMPED",
           "STAT_ADDS", "STAT_SUM_ERR", "STAT_SUMSQ_ERR", "stats_delta_row",
           "stats_update", "stats_row", "SUM_REL", "SUM_ABS", "stats_gap"]


def qfmt_params(e: int, m: int) -> tuple[bool, int, float, float]:
    """(identity, shift, max_value, min_normal) of the (1, e, m) quantizer:
    the constants the CUDA kernels take as launch arguments.  Both float
    constants are exact in f32 (at most 24 significant bits)."""
    identity = m >= 23 and e >= 8
    max_value = float(2.0 ** (2 ** (e - 1) - 1) * (2.0 - 2.0 ** (-m)))
    min_normal = float(2.0 ** -(2 ** (e - 1) - 1))
    return identity, max(23 - m, 0), max_value, min_normal


def qfmt_args(fmt) -> tuple:
    """``qfmt_params`` of ``fmt`` = (e, m) as the C arguments of a
    ``QFmt`` (``csrc/common.cuh``): int, int, c_float, c_float."""
    identity, shift, maxv, minn = qfmt_params(*fmt)
    return (int(identity), shift, ctypes.c_float(maxv), ctypes.c_float(minn))


def _as_float(bits: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> float32 with that pattern."""
    bits = bits & 0xFFFFFFFF
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def quantize_block(x: torch.Tensor, e: int, m: int) -> torch.Tensor:
    """(1, e, m) round-to-nearest-even quantization of a float32 tensor.

    Saturating (inf and overflow go to +-max_value), subnormals flushed to
    zero with the sign kept (so -0.0 stays -0.0), NaN passed through.
    Bitwise the JAX ``quantize_block``.
    """
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_block takes float32, got {x.dtype}")
    identity, shift, max_value, min_normal = qfmt_params(e, m)
    if identity:
        return x
    y = x.abs()
    if shift > 0:
        xi = y.view(torch.int32).to(torch.int64)
        lsb = (xi >> shift) & 1
        xi = (xi + (1 << (shift - 1)) - 1 + lsb) & ~((1 << shift) - 1)
        y = _as_float(xi)
    # python-float bounds (exact in f32): no host-to-device copy per call
    y = torch.where(torch.isinf(x), max_value, y)
    y = torch.clamp(y, max=max_value)
    y = torch.where(y < min_normal, 0.0, y)
    y = torch.where(torch.signbit(x), -y, y)
    return torch.where(torch.isnan(x), x, y)


# --------------------------------------------------------------------------
# stochastic-rounding carry (rounding="sr")
# --------------------------------------------------------------------------
#
# The dither of a carry update is a pure function of (seed, chunk step,
# flat logical output index): never of the tile or the schedule, so every
# kernel variant of one GEMM draws the same bits.  Values are python ints
# or int64 tensors holding uint32 patterns.

ROUNDINGS = ("rne", "sr")

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(key0, key1, ctr0, ctr1):
    """The 20-round Threefry-2x32 block: (key, counter) -> two uint32
    words, bitwise ``repro.kernels.common.threefry2x32``.  Arguments are
    python ints or int64 tensors of uint32 values and broadcast; every add
    wraps mod 2^32."""
    k0, k1 = key0 & _M32, key1 & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = ((ctr0 & _M32) + ks[0]) & _M32
    x1 = ((ctr1 & _M32) + ks[1]) & _M32
    for g in range(5):
        for d in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, d) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def sr_flat_index(row_ids, col_ids, n_cols: int):
    """``row * n_cols + col`` mod 2^32, the row taken as uint32 first (as
    the JAX package casts it): the Threefry counter of an output element
    of a GEMM with ``n_cols`` logical output columns."""
    return ((row_ids & _M32) * (n_cols & _M32) + (col_ids & _M32)) & _M32


def sr_random_bits(seed: int, step, row_ids, col_ids, n_cols: int):
    """The uint32 dither of one carry update (an int64 tensor), bitwise
    ``repro.kernels.common.sr_random_bits``: key (seed, seed ^
    0x9E3779B9), counter (flat logical output index, chunk step).  Padded
    elements may alias a logical index; their outputs are discarded."""
    return sr_bits(seed, step, sr_flat_index(row_ids, col_ids, n_cols))


def sr_bits(seed: int, step, flat):
    """The dither of the output with flat index ``flat`` at chunk
    ``step`` (``csrc/common.cuh`` ``sr_bits``)."""
    seed = int(seed) & _M32
    out, _ = threefry2x32(seed, seed ^ 0x9E3779B9, flat, step)
    return out


def quantize_block_sr(x: torch.Tensor, e: int, m: int,
                      rbits: torch.Tensor) -> torch.Tensor:
    """(1, e, m) stochastic rounding of a float32 tensor: add ``rbits &
    (2^(23-m) - 1)`` to the magnitude's bits, then truncate the dropped
    mantissa bits (rounds up with probability the discarded fraction).
    Saturation, flush to zero, the sign and NaN as ``quantize_block``; an
    exact format is the identity.  Bitwise the JAX
    ``quantize_block_sr``."""
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_block_sr takes float32, got {x.dtype}")
    identity, shift, max_value, min_normal = qfmt_params(e, m)
    if identity:
        return x
    y = x.abs()
    if shift > 0:
        low = (1 << shift) - 1
        xi = y.view(torch.int32).to(torch.int64)
        y = _as_float((xi + (rbits & low)) & ~low)
    y = torch.where(torch.isinf(x), max_value, y)
    y = torch.clamp(y, max=max_value)
    y = torch.where(y < min_normal, 0.0, y)
    y = torch.where(torch.signbit(x), -y, y)
    return torch.where(torch.isnan(x), x, y)


def quantize_carry(x: torch.Tensor, e: int, m: int, rounding: str,
                   rbits=None) -> torch.Tensor:
    """The carry's quantizer: RNE, or SR with the caller's dither bits."""
    if rounding == "sr":
        return quantize_block_sr(x, e, m, rbits)
    return quantize_block(x, e, m)


def carry_update(prev, partial, *, e_acc: int, m_acc: int, rounding: str,
                 seed: int = 0, step: int = 0, row0: int = 0,
                 col0: int = 0, n_cols: int = 1) -> torch.Tensor:
    """One chunk's carry update ``q(prev + partial)`` of a 2-D tile whose
    first element is logical output (row0, col0); SR draws its dither
    from the seed, the chunk step and each element's flat logical index.
    Bitwise the JAX ``carry_update``."""
    if rounding != "sr":
        return quantize_block(prev + partial, e_acc, m_acc)
    r, c = prev.shape
    dev = prev.device
    rows = row0 + torch.arange(r, dtype=torch.int64, device=dev)[:, None]
    cols = col0 + torch.arange(c, dtype=torch.int64, device=dev)[None, :]
    rbits = sr_random_bits(seed, step, rows, cols, n_cols)
    return quantize_block_sr(prev + partial, e_acc, m_acc, rbits)


def pad2d(x: torch.Tensor, rows: int, cols: int,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Zero-pad a 2-D tensor up to (rows, cols) multiples, as ``dtype``.

    Zero padding composes exactly with the quantizer (q(0) = 0) and with
    the chunked carry (adding an all-zero chunk product leaves an
    already-quantized carry unchanged), so padded and unpadded GEMMs agree
    bit for bit on the valid region.
    """
    r, c = x.shape
    rp = -(-r // rows) * rows
    cp = -(-c // cols) * cols
    return torch.nn.functional.pad(x.to(dtype), (0, cp - c, 0, rp - r))


def exp2_int(se: torch.Tensor) -> torch.Tensor:
    """2^se as float32 for integer ``se`` in [-126, 127], built from the
    exponent bits (exact; the page scales are clipped to +-120)."""
    return ((se.to(torch.int32) + 127) << 23).view(torch.float32)


# --------------------------------------------------------------------------
# swamping-telemetry stats row
# --------------------------------------------------------------------------
#
# One row of N_STATS slots per monitored accumulator, reduced over the whole
# output by the stats kernels (csrc/common.cuh, the same layout) and read
# by ``repro_torch.telemetry.stats.EnsembleStats``.  The row is float32;
# the kernels and the plain versions below reduce it in float64 and round
# once, so the counters are exact integers up to 2^24 events and the sums
# are the float64 sums rounded (the JAX row adds f32 tile sums: ROADMAP F6).

N_STATS = 10
(
    STAT_COUNT,     # valid output elements (the ensemble size)
    STAT_SUM_Q,     # sum of reduced-precision outputs
    STAT_SUMSQ_Q,   # sum of squared reduced-precision outputs
    STAT_SUM_I,     # sum of ideal (f32-accumulated) outputs
    STAT_SUMSQ_I,   # sum of squared ideal outputs
    STAT_MAX_ABS,   # max |carry| over all chunk updates
    STAT_SWAMPED,   # chunk-carry adds fully absorbed: q(c + p) == c, p != 0
    STAT_ADDS,      # chunk-carry adds with a non-zero addend
    STAT_SUM_ERR,   # sum of (q - ideal) over final outputs
    STAT_SUMSQ_ERR,  # sum of (q - ideal)^2 over final outputs
) = range(N_STATS)


def stats_delta_row(new, prev, ideal, partial, mask, emit_out: bool):
    """One chunk-carry update's contribution, in float64.

    ``new``/``prev`` are the carry after/before ``q(prev + partial)``,
    ``ideal`` the f32 shadow carry after it, ``mask`` the valid outputs and
    ``emit_out`` True on the last chunk, when the carry is the output and
    its ensemble moments are taken.  Returns ``(delta, step_max)``: the
    additive (N_STATS,) float64 contribution (0 in the MAX_ABS slot) and
    the update's max |carry| over the valid outputs."""
    f64 = torch.float64
    nz = (partial != 0.0) & mask
    delta = torch.zeros((N_STATS,), dtype=f64, device=new.device)
    delta[STAT_ADDS] = nz.sum()
    delta[STAT_SWAMPED] = ((new == prev) & nz).sum()
    if emit_out:
        q = new.to(f64)[mask]
        w = ideal.to(f64)[mask]
        err = q - w
        delta[STAT_COUNT] = q.numel()
        delta[STAT_SUM_Q] = q.sum()
        delta[STAT_SUMSQ_Q] = (q * q).sum()
        delta[STAT_SUM_I] = w.sum()
        delta[STAT_SUMSQ_I] = (w * w).sum()
        delta[STAT_SUM_ERR] = err.sum()
        delta[STAT_SUMSQ_ERR] = (err * err).sum()
    a = new.abs()[mask]
    step_max = a.max().to(f64) if a.numel() else delta.new_zeros(())
    return delta, step_max


def stats_update(acc, delta, step_max):
    """Fold one contribution into the float64 accumulator row ``acc``
    (N_STATS,): every slot adds, MAX_ABS max-merges."""
    mx = torch.maximum(acc[STAT_MAX_ABS], step_max)
    acc = acc + delta
    acc[STAT_MAX_ABS] = mx
    return acc


def stats_row(device) -> torch.Tensor:
    """A fresh float64 accumulator row (all zero: the merge identity)."""
    return torch.zeros((N_STATS,), dtype=torch.float64, device=device)


# A stats row against its plain version: the counters (COUNT, SWAMPED,
# ADDS) and MAX_ABS bitwise; the sum slots add the same float64 terms in
# another order and round once to f32, so each is held to SUM_REL (2 f32
# ulps) of its value, plus, for the first-moment slots (whose terms may
# cancel), SUM_ABS times the Cauchy-Schwarz bound sqrt(count * sum of
# squares) on the sum of |terms|.
STAT_EXACT = (STAT_COUNT, STAT_MAX_ABS, STAT_SWAMPED, STAT_ADDS)
STAT_FIRST = {STAT_SUM_Q: STAT_SUMSQ_Q, STAT_SUM_I: STAT_SUMSQ_I,
              STAT_SUM_ERR: STAT_SUMSQ_ERR}   # first moment -> its square
STAT_SQUARE = (STAT_SUMSQ_Q, STAT_SUMSQ_I, STAT_SUMSQ_ERR)
SUM_REL, SUM_ABS = 2.0 ** -22, 2.0 ** -40


def stats_gap(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, float]:
    """(exact slots bitwise equal, largest |got - want| / bound over the
    sum slots) for two rows of the same shape (..., N_STATS)."""
    got = got.detach().double().cpu().reshape(-1, N_STATS)
    want = want.detach().double().cpu().reshape(-1, N_STATS)
    exact = bool(torch.equal(got[:, list(STAT_EXACT)],
                             want[:, list(STAT_EXACT)]))
    ratio = 0.0
    for i in range(got.shape[0]):
        for s in STAT_SQUARE:
            bound = SUM_REL * abs(float(want[i, s]))
            ratio = max(ratio, _over(got[i, s], want[i, s], bound))
        for s, sq in STAT_FIRST.items():
            bound = SUM_REL * abs(float(want[i, s])) + SUM_ABS * math.sqrt(
                max(float(want[i, STAT_COUNT] * want[i, sq]), 0.0))
            ratio = max(ratio, _over(got[i, s], want[i, s], bound))
    return exact, ratio


def _over(a, b, bound: float) -> float:
    d = abs(float(a) - float(b))
    return 0.0 if d == 0.0 else (d / bound if bound > 0 else math.inf)
