"""``qdot``: a dense GEMM under a per-role accumulation plan.

Counterpart of ``repro.kernels.ops`` for inference: ``QDotConfig`` and the
forward ``qdot``.  The forward reshapes to 2-D and runs the fused GEMM
(``kernels.fused.qmatmul_fused``) under ``cfg.fwd``.  The backward (the
``torch.autograd.Function`` with its BWD and GRAD GEMMs) belongs to the
training slice; until then ``qdot`` refuses inputs that would need a
gradient rather than return a silently wrong one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.policy import GEMMPrecision
from repro_torch.kernels.common import quantize_block
from repro_torch.kernels.fused import qmatmul_fused
from repro_torch.quant.formats import FPFormat

__all__ = ["QDotConfig", "qdot"]


@dataclass(frozen=True)
class QDotConfig:
    """Precision configuration of one logical dense layer.

    ``None`` for a role means ideal (wide) accumulation for that GEMM;
    ``repr_fmt=None`` disables operand quantization; ``out_fmt`` rounds the
    forward output to a consumer's representation format.
    """

    fwd: GEMMPrecision | None = None
    bwd: GEMMPrecision | None = None
    grad: GEMMPrecision | None = None
    repr_fmt: FPFormat | None = None
    out_fmt: FPFormat | None = None

    @property
    def is_exact(self) -> bool:
        return (self.fwd is None and self.bwd is None and self.grad is None
                and self.repr_fmt is None and self.out_fmt is None)


def _acc_params(p: GEMMPrecision | None) -> tuple[int, int, int]:
    """(e_acc, m_acc, block_k) of a role; a wide role rounds nothing, so
    its block_k only sets the f32 partial's grouping."""
    if p is None:
        return 8, 23, 128
    return p.e_acc, p.m_acc, p.chunk if p.chunk > 0 else 128


def qdot(x: torch.Tensor, w: torch.Tensor, cfg: QDotConfig) -> torch.Tensor:
    """y[..., N] = x[..., K] @ w[K, N] with the FWD role's accumulation;
    float32 out.  Inference only."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "qdot has no backward yet (training slice); call it under "
            "torch.no_grad() or on tensors that do not require grad")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    e_acc, m_acc, block_k = _acc_params(cfg.fwd)
    y = qmatmul_fused(x2, w, repr_fmt=cfg.repr_fmt, e_acc=e_acc,
                      m_acc=m_acc, block_k=block_k)
    if cfg.out_fmt is not None:
        y = quantize_block(y, cfg.out_fmt.e, cfg.out_fmt.m)
    return y.reshape(*lead, w.shape[1])
