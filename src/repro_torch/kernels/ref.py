"""Plain oracles of the oracle kernels K2 and K3.

Counterpart of ``repro.kernels.ref``: ``ref_quantize`` for
``kernels/quantize.py`` and ``ref_qmatmul`` for ``kernels/qmatmul.py``,
with the JAX package's signatures: thin names for ``quant.qnum.quantize``
and ``kernels.qmatmul.qmatmul_reference`` (the chunked carry that
``kernels.fused.chunked_gemm_reference`` computes for every GEMM kernel of
the port).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.qmatmul import qmatmul_reference
from repro_torch.quant.formats import FPFormat
from repro_torch.quant.qnum import quantize

__all__ = ["ref_quantize", "ref_qmatmul"]


def ref_quantize(x: torch.Tensor, *, e: int, m: int) -> torch.Tensor:
    """Oracle for ``kernels/quantize.py``."""
    return quantize(x, FPFormat(e=e, m=m))


def ref_qmatmul(a: torch.Tensor, b: torch.Tensor, *, e_acc: int = 8,
                m_acc: int = 23, block_k: int = 128) -> torch.Tensor:
    """Oracle for ``kernels/qmatmul.py``: each ``block_k`` chunk of K
    contracted in f32, the carry rounded to (1, e_acc, m_acc) after every
    chunk; a ragged last chunk folds what it has (the JAX oracle's zero
    padding adds nothing to a representable carry)."""
    return qmatmul_reference(a, b, e_acc=e_acc, m_acc=m_acc, block_k=block_k)
