"""The plain (1, e, m) quantizer: the numerical foundation of the emulation.

Counterpart of ``repro.quant.qnum``.  Round-to-nearest-even on the float32
bit pattern, saturating at +-max_value (inf included), subnormals flushed
to zero with the sign kept, NaN passed through: the semantics of
``repro_torch.kernels.common.quantize_block``, which this calls.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import quantize_block
from repro_torch.quant.formats import FPFormat

__all__ = ["quantize"]


def quantize(x: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """``x`` (any float dtype) rounded to ``fmt``, returned as float32."""
    return quantize_block(x.to(torch.float32), fmt.e, fmt.m)
