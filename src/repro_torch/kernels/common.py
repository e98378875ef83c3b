"""Elementwise helpers shared by the kernels' plain versions.

Counterpart of ``repro.kernels.common`` (RNE branch).  The CUDA kernels
carry the same arithmetic in ``csrc/common.cuh``; the two are held
against each other on the card and against the JAX package here.

Bit math runs on ``x.view(torch.int32)`` widened to int64 and masked to
32 bits: torch's uint32 support is partial, and int64 keeps the rounding
carry of a NaN payload from overflowing.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["quantize_block", "qfmt_params", "qfmt_args", "pad2d",
           "exp2_int"]


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
