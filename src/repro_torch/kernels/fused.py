"""Fused quantized GEMM with a chunked low-precision carry.

Replaces the TPU kernel ``repro/kernels/fused.py::_fused_kernel`` (RNE
carry, f32 or bf16 operands, no ``out_fmt``/``pack_out`` epilogue) with
the CUDA C++ kernel ``csrc/qgemm.cu``::

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
negligible.  The simple design reads the bf16 weights straight from their
row-major (K, N) layout (or the tied embedding through its transposed
strides, so no 467 MB copy is made per step), converts and quantizes them
in shared memory, and keeps the carry in registers; each block prefetches
its next K tile into registers while it computes the current one.  There
is no split over K (the carry is sequential in chunks), so a GEMM with few
N tiles runs on few SMs.  ``wgmma`` and TMA are for a later change.

On CPU tensors the wrapper runs ``qmatmul_fused_reference``, the plain
PyTorch version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import qfmt_params, quantize_block
from repro_torch.quant.formats import fmt_tuple

__all__ = ["qmatmul_fused", "qmatmul_fused_reference"]

_WIDE = (8, 23)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(a, b):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")


def qmatmul_fused_reference(a: torch.Tensor, b: torch.Tensor, *,
                            repr_fmt=None, e_acc: int = 8, m_acc: int = 23,
                            block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version, in the kernel's order: quantize both operands;
    per chunk, an f32 partial of rank-1 updates in increasing k (one
    multiply-add each), then ``carry = q_acc(carry + partial)``.  Bitwise
    the kernel; bitwise the JAX reference wherever the intra-chunk f32
    sums are exact (the reference's dot sums in another order)."""
    _check(a, b)
    m, k = a.shape
    n = b.shape[1]
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    fmt = fmt_tuple(repr_fmt)
    if fmt is not None:
        a32, b32 = quantize_block(a32, *fmt), quantize_block(b32, *fmt)
    carry = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, block_k):
        part = torch.zeros_like(carry)
        for kk in range(k0, min(k0 + block_k, k)):
            part = torch.addcmul(part, a32[:, kk:kk + 1], b32[kk:kk + 1, :])
        carry = quantize_block(carry + part, e_acc, m_acc)
    return carry


def _qfmt_args(fmt):
    identity, shift, maxv, minn = qfmt_params(*fmt)
    return (int(identity), shift, ctypes.c_float(maxv), ctypes.c_float(minn))


_LL, _I, _P, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_ARGTYPES = [_P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _I, _I, _I, _I,
             _I, _I, _F, _F, _I, _I, _I, _I, _F, _F, _P]


def qmatmul_fused(a: torch.Tensor, b: torch.Tensor, *, repr_fmt=None,
                  e_acc: int = 8, m_acc: int = 23,
                  block_k: int = 128) -> torch.Tensor:
    """C[M, N] = Q(A) @ Q(B) with a (1, e_acc, m_acc) carry rounded every
    ``block_k`` products (the chunk n1).

    * ``a`` (M, K), ``b`` (K, N): float32 or bfloat16, any strides (the
      tied lm_head passes ``embed.T`` as a view);
    * ``repr_fmt``: operand format (``FPFormat``/``(e, m)``), None = no
      operand quantization;
    * returns float32 (M, N).
    """
    _check(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return qmatmul_fused_reference(a, b, repr_fmt=repr_fmt, e_acc=e_acc,
                                       m_acc=m_acc, block_k=block_k)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    if block_k < 1:
        raise ValueError(f"block_k must be positive, got {block_k}")
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
        *_qfmt_args(fmt or _WIDE), int(quant), int(quant),
        *_qfmt_args((e_acc, m_acc)),
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qgemm launch failed: CUDA error {rc}")
    qmatmul_fused.launches += 1
    return out


qmatmul_fused.launches = 0
