"""Packed quantized tensors: int8-carried (1, e, m) values.

Counterpart of ``repro.quant.qtensor``: ``pack_block`` / ``unpack_block``
(the code layout), and ``QTensor``, an int8 payload with the format that
interprets it (or, in linear mode, a per-tensor scale), with
``pack_tree`` / ``unpack_tree`` over nested dicts, lists and tuples; a
checkpoint stores a ``QTensor`` as its int8 codes.
Code layout, low ``1 + e + m`` bits of each int8::

    [ sign (1) | exponent field (e) | mantissa field (m) ]

Exponent field 0 encodes +-0 (the formats flush subnormals); field ``b``
in [1, 2^e - 1] encodes E = b - 1 - bias.  Non-finite inputs pack to
(signed) zero.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.quant.formats import FPFormat
from repro_torch.quant.qnum import quantize

__all__ = ["QTensor", "pack_block", "unpack_block", "pack_tree", "unpack_tree"]


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


@dataclass(frozen=True)
class QTensor:
    """int8 payload and the metadata that interprets it.

    * packed (``fmt`` set, ``scale`` None): each int8 holds one (1, e, m)
      code; ``unpack`` is the exact inverse of ``pack``.
    * linear (``fmt`` None, ``scale`` set): value = payload * scale, an
      affine code whose payloads sum exactly in int32.
    """

    payload: torch.Tensor
    fmt: FPFormat | None = None
    scale: torch.Tensor | None = None

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.payload.shape)

    @property
    def ndim(self) -> int:
        return self.payload.ndim

    @property
    def nbytes(self) -> int:
        return self.payload.numel()  # 1 byte an element

    @classmethod
    def pack(cls, x: torch.Tensor, fmt: FPFormat, *,
             assume_quantized: bool = False) -> "QTensor":
        """Quantize ``x`` to ``fmt`` (skipped when ``assume_quantized``: the
        quantizer is idempotent) and pack it into int8 codes."""
        if not assume_quantized:
            x = quantize(x, fmt)
        return cls(payload=pack_block(x, fmt.e, fmt.m), fmt=fmt)

    @classmethod
    def pack_linear(cls, x: torch.Tensor,
                    scale: torch.Tensor | None = None) -> "QTensor":
        """Affine int8 code: round(x / scale) clipped to [-127, 127]; with
        no ``scale``, the tensor's own amax / 127."""
        if scale is None:
            scale = (torch.max(torch.abs(x)) + 1e-12) / 127.0
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return cls(payload=q, scale=scale)

    def unpack(self) -> torch.Tensor:
        if self.fmt is not None:
            return unpack_block(self.payload, self.fmt.e, self.fmt.m)
        if self.scale is not None:
            return self.payload.to(torch.float32) * self.scale
        raise ValueError("QTensor with neither fmt nor scale")


def _map(fn, tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples (a QTensor
    is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def pack_tree(tree: Any, fmt: FPFormat, *, assume_quantized: bool = False
              ) -> Any:
    """Every tensor leaf as a packed ``QTensor`` (lossy unless the leaves
    are already quantized to ``fmt``)."""
    return _map(lambda x: QTensor.pack(x, fmt,
                                       assume_quantized=assume_quantized),
                tree)


def unpack_tree(tree: Any) -> Any:
    """Inverse of ``pack_tree``: every ``QTensor`` decoded to float32,
    other leaves left as they are."""
    return _map(lambda x: x.unpack() if isinstance(x, QTensor) else x, tree)
