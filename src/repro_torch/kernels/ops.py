"""``qdot``: a dense GEMM under a per-role accumulation plan.

Counterpart of ``repro.kernels.ops``: ``QDotConfig`` and the differentiable
``qdot``.  Its three GEMMs are the paper's Fig. 2 roles, each with its own
solver-assigned carry format:

* FWD, ``y = Q(x) @ Q(w)``: kernel E (``qmatmul_fused(...,
  return_quantized=True)``), which also emits the int8 codes of Q(x) and
  Q(w) as the saved residuals, when ``repr_fmt`` fits in 8 bits; kernel G
  with the raw operands saved when ``repr_fmt`` is None (the lm_head).
  Without a gradient to take (serving, ``torch.no_grad()``) the forward is
  G alone and saves nothing.
* BWD ``dx = Q(g) @ Q(w)^T`` and GRAD ``dw = Q(x)^T @ Q(g)``: one launch
  of kernel B (``qmatmul_bwd_pair``) per layer.

``out_fmt`` rounds the forward output to a consumer's format and is
straight-through in the backward.  dx and dw come back in the dtypes of x
and w, as the JAX package's casts round them (bf16 weights get bf16
gradients).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.policy import GEMMPrecision
from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
from repro_torch.kernels.common import quantize_block
from repro_torch.kernels.fused import qmatmul_fused
from repro_torch.quant.formats import FPFormat

__all__ = ["QDotConfig", "qdot"]

# f32 grouping of the partial sum when a role accumulates wide (chunk 0):
# schedule only, the carry is not rounded
_WIDE_CHUNK = 128


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

    @property
    def packs(self) -> bool:
        """Whether the forward's residuals are int8 codes."""
        return self.repr_fmt is not None and self.repr_fmt.bits <= 8


def _acc_params(p: GEMMPrecision | None) -> tuple[int, int, int]:
    """(e_acc, m_acc, chunk) of a role; chunk 0 means wide (the carry is
    not rounded and the chunk only groups the f32 partial)."""
    if p is None:
        return 8, 23, 0
    return p.e_acc, p.m_acc, p.chunk if p.chunk > 0 else 0


def _pair_chunks(cfg: QDotConfig) -> tuple[int, int]:
    """(grad_chunk, bwd_chunk): the backward pair's rounding cadences over
    T and over N."""
    _, _, bwd_chunk = _acc_params(cfg.bwd)
    _, _, grad_chunk = _acc_params(cfg.grad)
    return grad_chunk or _WIDE_CHUNK, bwd_chunk or _WIDE_CHUNK


def _fwd_kw(cfg: QDotConfig) -> dict:
    e_acc, m_acc, chunk = _acc_params(cfg.fwd)
    return dict(repr_fmt=cfg.repr_fmt, e_acc=e_acc, m_acc=m_acc,
                block_k=chunk or _WIDE_CHUNK)


def _out(y: torch.Tensor, cfg: QDotConfig) -> torch.Tensor:
    if cfg.out_fmt is None:
        return y
    return quantize_block(y, cfg.out_fmt.e, cfg.out_fmt.m)


class _QDot(torch.autograd.Function):
    """FWD through E (or G), BWD and GRAD through one B launch."""

    @staticmethod
    def forward(ctx, x2, w, cfg):
        if cfg.packs:
            y, xq, wq = qmatmul_fused(x2, w, return_quantized=True,
                                      **_fwd_kw(cfg))
        elif cfg.repr_fmt is None:
            y, xq, wq = qmatmul_fused(x2, w, **_fwd_kw(cfg)), x2, w
        else:
            raise NotImplementedError(
                f"residuals of a {cfg.repr_fmt} representation need more "
                "than 8 bits: f32 residuals are not ported")
        ctx.save_for_backward(xq, wq)
        ctx.cfg = cfg
        ctx.dtypes = (x2.dtype, w.dtype)
        return _out(y, cfg)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        cfg = ctx.cfg
        e_b, m_b, _ = _acc_params(cfg.bwd)
        e_g, m_g, _ = _acc_params(cfg.grad)
        grad_chunk, bwd_chunk = _pair_chunks(cfg)
        # out_fmt's rounding is straight-through: g passes unscaled
        dx, dw = qmatmul_bwd_pair(
            g.to(torch.float32), xq, wq, repr_fmt=cfg.repr_fmt,
            bwd_acc=(e_b, m_b), grad_acc=(e_g, m_g), bwd_chunk=bwd_chunk,
            grad_chunk=grad_chunk, packed=cfg.packs,
            quantize_g=cfg.repr_fmt is not None)
        x_dtype, w_dtype = ctx.dtypes
        return dx.to(x_dtype), dw.to(w_dtype), None


def qdot(x: torch.Tensor, w: torch.Tensor, cfg: QDotConfig) -> torch.Tensor:
    """y[..., N] = x[..., K] @ w[K, N] with the plan's per-role
    accumulation; float32 out.  Differentiable in x and w."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _QDot.apply(x2, w, cfg)
    else:
        y = _out(qmatmul_fused(x2, w, **_fwd_kw(cfg)), cfg)
    return y.reshape(*lead, w.shape[1])
