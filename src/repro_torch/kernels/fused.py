"""Fused quantized GEMM with a chunked low-precision carry: G and E.

G replaces the TPU kernel ``repro/kernels/fused.py::_fused_kernel`` (RNE
carry, f32 or bf16 operands, no ``out_fmt``/``pack_out`` epilogue); E
replaces ``_fused_kernel_emitq``, the training forward, which also emits
the int8 codes of both quantized operands for the backward.  Both are the
CUDA C++ kernels of ``csrc/qgemm.cu``::

    C[M, N] = sum over chunks of K:  carry = q_acc(carry + Q(A_c) @ Q(B_c))

``Q`` rounds each operand tile to ``repr_fmt`` (skipped when it is None)
right after the tile lands in shared memory; the intra-chunk partial is an
f32 sum in increasing k order kept apart from the carry, and the carry is
rounded to (1, e_acc, m_acc) once per ``block_k`` (= the plan's chunk)
products.  Products of (1,5,2) values, and of bf16 values, are exact in
f32, so a fused multiply-add equals a multiply then add here.

What bounds it on the H100: at decode (M = max_batch = 8) every GEMM reads
its whole weight once: the 197 GEMMs of one qwen2-1.5b decode step read
3.1 GB of bf16 weights, about 0.93 ms at 3.35 TB/s; the arithmetic is
negligible.  At training (M = 512 tokens) it is the arithmetic, which this
simple design runs in f32 on the CUDA cores.  The kernel reads the bf16
weights straight from their row-major (K, N) layout (or the tied embedding
through its transposed strides, so no 467 MB copy is made per step),
converts and quantizes them in shared memory, and keeps the carry in
registers; each block prefetches its next K tile into registers while it
computes the current one.  There is no split over K (the carry is
sequential in chunks), so a GEMM with few N tiles runs on few SMs.
``wgmma`` and TMA are for a later change.

On CPU tensors each wrapper runs its plain PyTorch version; on CUDA tensors
it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import qfmt_args, quantize_block
from repro_torch.quant.formats import fmt_tuple
from repro_torch.quant.qtensor import pack_block

__all__ = ["qmatmul_fused", "qmatmul_fused_reference",
           "chunked_gemm_reference"]

_WIDE = (8, 23)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(a, b):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")


def chunked_gemm_reference(a32: torch.Tensor, b32: torch.Tensor, *,
                           e_acc: int, m_acc: int, block_k: int,
                           carry: torch.Tensor | None = None) -> torch.Tensor:
    """The kernels' chunked carry on float32 operands taken as they are:
    per chunk of K, an f32 partial of rank-1 updates in increasing k (one
    multiply-add each), then ``carry = q_acc(carry + partial)``, with a
    ragged last chunk.  ``carry`` resumes a running carry (the dx segment
    chain); a fresh one starts at 0.  The kernels' order, so bitwise them."""
    m, k = a32.shape
    n = b32.shape[1]
    carry = (torch.zeros((m, n), dtype=torch.float32, device=a32.device)
             if carry is None else carry.to(torch.float32).clone())
    for k0 in range(0, k, block_k):
        part = torch.zeros_like(carry)
        for kk in range(k0, min(k0 + block_k, k)):
            part = torch.addcmul(part, a32[:, kk:kk + 1], b32[kk:kk + 1, :])
        carry = quantize_block(carry + part, e_acc, m_acc)
    return carry


def qmatmul_fused_reference(a: torch.Tensor, b: torch.Tensor, *,
                            repr_fmt=None, e_acc: int = 8, m_acc: int = 23,
                            block_k: int = 128,
                            return_quantized: bool = False):
    """Plain PyTorch version of G (and of E with ``return_quantized``), in
    the kernel's order: quantize both operands, then
    ``chunked_gemm_reference``; E's codes are ``pack_block`` of the
    quantized operands.  Bitwise the kernels; bitwise the JAX reference
    wherever the intra-chunk f32 sums are exact (the reference's dot sums
    in another order)."""
    _check(a, b)
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    fmt = fmt_tuple(repr_fmt)
    if return_quantized:
        _check_packable(fmt)
    if fmt is not None:
        a32, b32 = quantize_block(a32, *fmt), quantize_block(b32, *fmt)
    y = chunked_gemm_reference(a32, b32, e_acc=e_acc, m_acc=m_acc,
                               block_k=block_k)
    if return_quantized:
        return y, pack_block(a32, *fmt), pack_block(b32, *fmt)
    return y


def _check_packable(fmt) -> None:
    if fmt is None or 1 + fmt[0] + fmt[1] > 8:
        raise ValueError(f"return_quantized emits int8 codes: repr_fmt must "
                         f"fit in 8 bits, got {fmt}")



_LL, _I, _P, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_ARGTYPES = [_P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _I, _I, _I, _I,
             _I, _I, _F, _F, _I, _I, _I, _I, _F, _F, _P]


def qmatmul_fused(a: torch.Tensor, b: torch.Tensor, *, repr_fmt=None,
                  e_acc: int = 8, m_acc: int = 23, block_k: int = 128,
                  return_quantized: bool = False):
    """C[M, N] = Q(A) @ Q(B) with a (1, e_acc, m_acc) carry rounded every
    ``block_k`` products (the chunk n1).

    * ``a`` (M, K), ``b`` (K, N): float32 or bfloat16, any strides (the
      tied lm_head passes ``embed.T`` as a view);
    * ``repr_fmt``: operand format (``FPFormat``/``(e, m)``), None = no
      operand quantization;
    * returns float32 (M, N);
    * ``return_quantized=True`` is kernel E: returns ``(C, xq, wq)``, the
      int8 codes (``quant.qtensor`` layout) of Q(A) [M, K] and Q(B) [K, N]
      each written once; ``repr_fmt`` must then fit in 8 bits.

    G's launches are counted on ``launches``, E's on ``emitq_launches``.
    """
    if return_quantized:
        return _emitq(a, b, repr_fmt=repr_fmt, e_acc=e_acc, m_acc=m_acc,
                      block_k=block_k)
    _check(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return qmatmul_fused_reference(a, b, repr_fmt=repr_fmt, e_acc=e_acc,
                                       m_acc=m_acc, block_k=block_k)
    _check_cuda(a, b, block_k)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    fmt = fmt_tuple(repr_fmt)
    quant = fmt is not None
    rc = build.function("qgemm", "qgemm", _ARGTYPES)(
        a.data_ptr(), _DTYPES[a.dtype], a.stride(0), a.stride(1),
        b.data_ptr(), _DTYPES[b.dtype], b.stride(0), b.stride(1),
        out.data_ptr(), m, n, k, block_k,
        *qfmt_args(fmt or _WIDE), int(quant), int(quant),
        *qfmt_args((e_acc, m_acc)),
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qgemm launch failed: CUDA error {rc}")
    qmatmul_fused.launches += 1
    return out


qmatmul_fused.launches = 0
qmatmul_fused.emitq_launches = 0


def _check_cuda(a, b, block_k) -> None:
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    if block_k < 1:
        raise ValueError(f"block_k must be positive, got {block_k}")


_EMITQ_ARGTYPES = [_P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _I, _I, _I, _I,
                   _I, _I, _I, _I, _F, _F, _I, _I, _F, _F, _P, _P, _P]


def _emitq(a, b, *, repr_fmt, e_acc, m_acc, block_k):
    """Kernel E, ``qmatmul_fused(..., return_quantized=True)``."""
    _check(a, b)
    fmt = fmt_tuple(repr_fmt)
    _check_packable(fmt)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return qmatmul_fused_reference(a, b, repr_fmt=fmt, e_acc=e_acc,
                                       m_acc=m_acc, block_k=block_k,
                                       return_quantized=True)
    _check_cuda(a, b, block_k)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    aq = torch.empty((m, k), dtype=torch.int8, device=a.device)
    bq = torch.empty((k, n), dtype=torch.int8, device=a.device)
    if m == 0 or n == 0 or k == 0:
        out.zero_()
        return out, aq, bq
    rc = build.function("qgemm", "qgemm_emitq", _EMITQ_ARGTYPES)(
        a.data_ptr(), _DTYPES[a.dtype], a.stride(0), a.stride(1),
        b.data_ptr(), _DTYPES[b.dtype], b.stride(0), b.stride(1),
        out.data_ptr(), m, n, k, block_k, fmt[0], fmt[1], *qfmt_args(fmt),
        *qfmt_args((e_acc, m_acc)), aq.data_ptr(), bq.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qgemm_emitq launch failed: CUDA error {rc}")
    qmatmul_fused.emitq_launches += 1
    return out, aq, bq
