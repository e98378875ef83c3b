"""int8 code layout of (1, e, m) values.

Counterpart of ``repro.quant.qtensor`` (``pack_block`` / ``unpack_block``).
Code layout, low ``1 + e + m`` bits of each int8::

    [ sign (1) | exponent field (e) | mantissa field (m) ]

Exponent field 0 encodes +-0 (the formats flush subnormals); field ``b``
in [1, 2^e - 1] encodes E = b - 1 - bias.  Non-finite inputs pack to
(signed) zero.
"""

from __future__ import annotations

import torch

__all__ = ["pack_block", "unpack_block"]


def _check_packable(e: int, m: int) -> None:
    if 1 + e + m > 8:
        raise ValueError(
            f"(1,{e},{m}) needs {1 + e + m} bits; int8 packing requires <= 8")


def pack_block(x: torch.Tensor, e: int, m: int) -> torch.Tensor:
    """Encode (1, e, m)-representable float32 values as int8 codes (the
    mantissa is truncated, not rounded: quantize first)."""
    _check_packable(e, m)
    bias = 2 ** (e - 1) - 1
    xi = x.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = (xi >> 31) & 1
    ieee_exp = (xi >> 23) & 0xFF
    man = (xi >> (23 - m)) & (2 ** m - 1)
    normal = (ieee_exp != 0) & torch.isfinite(x)
    exp_field = torch.where(normal, ieee_exp - (127 - bias - 1),
                            torch.zeros_like(ieee_exp))
    man = torch.where(normal, man, torch.zeros_like(man))
    code = (sign << (e + m)) | (exp_field << m) | man
    return torch.where(code >= 128, code - 256, code).to(torch.int8)


def unpack_block(code: torch.Tensor, e: int, m: int) -> torch.Tensor:
    """Decode int8 codes to the exact float32 values ``pack_block`` took."""
    _check_packable(e, m)
    bias = 2 ** (e - 1) - 1
    c = code.to(torch.int32) & 0xFF
    sign = (c >> (e + m)) & 1
    exp_field = (c >> m) & (2 ** e - 1)
    man = c & (2 ** m - 1)
    ieee_exp = exp_field + (127 - bias - 1)
    mag = torch.where(exp_field > 0, (ieee_exp << 23) | (man << (23 - m)),
                      torch.zeros_like(c))
    bits = (sign << 31) | mag
    return bits.view(torch.float32)
