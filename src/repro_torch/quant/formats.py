"""(1, e, m) floating-point format descriptors (paper §2).

Counterpart of ``repro.quant.formats``.  The exponent range follows that
module's CODE: ``min_exp = -(2^(e-1) - 1)`` and ``max_exp = 2^(e-1) - 1``
(all exponent codes usable, saturating, subnormals flushed to zero).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["FPFormat", "FP8_152"]


@dataclass(frozen=True)
class FPFormat:
    """A saturating (1, e, m) binary floating-point format."""

    e: int
    m: int

    @property
    def bits(self) -> int:
        return 1 + self.e + self.m

    @property
    def max_exp(self) -> int:
        return 2 ** (self.e - 1) - 1

    @property
    def min_exp(self) -> int:
        return -(2 ** (self.e - 1) - 1)

    @property
    def max_value(self) -> float:
        return float(2.0 ** self.max_exp * (2.0 - 2.0 ** (-self.m)))

    @property
    def min_normal(self) -> float:
        return float(2.0 ** self.min_exp)

    def __str__(self) -> str:
        return f"(1,{self.e},{self.m})"


# the paper's representation format for weights/activations/KV codes
FP8_152 = FPFormat(e=5, m=2)


def fmt_tuple(fmt) -> tuple[int, int] | None:
    """``FPFormat`` / ``(e, m)`` / None -> ``(e, m)`` or None."""
    if fmt is None:
        return None
    if isinstance(fmt, FPFormat):
        return (fmt.e, fmt.m)
    e, m = fmt
    return (int(e), int(m))
