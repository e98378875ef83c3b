"""Both backward GEMMs of a quantized dense layer in one launch: kernel B.

Replaces the TPU kernels ``repro/kernels/bwd_pair.py::_pair_kernel`` (K6)
and, with a dx carry in, ``_pair_kernel_seg`` (K7, one N segment of the
split pair) with the CUDA C++ kernel ``csrc/bwd_pair.cu``::

    dx[T, K] = Q(g)[T, N] @ w[K, N]^T   carry (1, bwd_acc) every bwd_chunk
                                        of N, in increasing N
    dw[K, N] = x[T, K]^T @ Q(g)[T, N]   carry (1, grad_acc) every grad_chunk
                                        of T, in increasing T

``xq``/``wq`` are the forward's residuals: int8 codes of Q(x) and Q(w)
(``packed``) or raw float32/bfloat16 tensors of any strides (the lm_head,
whose ``repr_fmt`` is None, passes the ``embed.T`` view; no copy is made).
``g`` is quantized to ``repr_fmt`` on load when ``quantize_g``.

``dx_carry`` resumes dx from a running carry: calling the pair on
consecutive N segments whose widths are multiples of ``bwd_chunk``, each
with the previous segment's dx as its carry, is bitwise the unsplit call
(``qmatmul_bwd_pair_nsplit``, the counterpart of the TPU's VMEM-driven
split).  Hopper has no dw slab to fit, so the port's training step makes
one unsplit call per layer; the carry entry is counted apart, on
``qmatmul_bwd_pair.carry_launches``.

What bounds it on the H100: the f32 arithmetic, 4TKN operations on the
CUDA cores.  The lm_head's dx is the longest sum of the step (N = 151936
columns, one sequential carry per output) over only (T/64)(K/64) output
tiles, so it runs on part of the card.

On CPU tensors the wrappers run the plain PyTorch version; on CUDA tensors
they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import qfmt_args, quantize_block
from repro_torch.kernels.fused import chunked_gemm_reference
from repro_torch.quant.formats import fmt_tuple
from repro_torch.quant.qtensor import unpack_block

__all__ = ["qmatmul_bwd_pair", "qmatmul_bwd_pair_nsplit", "qmatmul_bwd_pair_reference",
           "pair_segment_width"]

_WIDE = (8, 23)
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check(g, xq, wq, fmt, packed, dx_carry, bwd_chunk, grad_chunk):
    if g.ndim != 2 or xq.ndim != 2 or wq.ndim != 2:
        raise ValueError("2-D operands required")
    t, n = g.shape
    if xq.shape[0] != t or wq.shape[1] != n or wq.shape[0] != xq.shape[1]:
        raise ValueError(f"bad shapes g{tuple(g.shape)} x{tuple(xq.shape)} "
                         f"w{tuple(wq.shape)}")
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g.dtype}")
    if packed:
        if fmt is None:
            raise ValueError("packed residuals need repr_fmt to decode")
        if xq.dtype != torch.int8 or wq.dtype != torch.int8:
            raise TypeError(f"packed=True expects int8 codes, got "
                            f"{xq.dtype}/{wq.dtype}")
    elif xq.dtype not in (torch.float32, torch.bfloat16) or \
            wq.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"raw residuals must be float32 or bfloat16, got "
                        f"{xq.dtype}/{wq.dtype}")
    if bwd_chunk < 1 or grad_chunk < 1:
        raise ValueError(f"chunks must be positive, got {bwd_chunk}, "
                         f"{grad_chunk}")
    if dx_carry is not None and tuple(dx_carry.shape) != (t, xq.shape[1]):
        raise ValueError(f"dx_carry {tuple(dx_carry.shape)} != "
                         f"{(t, xq.shape[1])}")


def qmatmul_bwd_pair_reference(g, xq, wq, *, repr_fmt, bwd_acc, grad_acc,
                               bwd_chunk: int, grad_chunk: int, packed: bool,
                               quantize_g: bool = True, dx_carry=None):
    """Plain PyTorch version: unpack the residuals, quantize g, then the two
    chunked GEMMs in the kernel's order (``chunked_gemm_reference``), dx
    resuming from ``dx_carry``.  Bitwise the kernel."""
    fmt = fmt_tuple(repr_fmt)
    _check(g, xq, wq, fmt, packed, dx_carry, bwd_chunk, grad_chunk)
    if packed:
        x32, w32 = unpack_block(xq, *fmt), unpack_block(wq, *fmt)
    else:
        x32, w32 = xq.to(torch.float32), wq.to(torch.float32)
    g32 = quantize_block(g, *fmt) if (quantize_g and fmt is not None) else g
    dx = chunked_gemm_reference(g32, w32.T, e_acc=bwd_acc[0],
                                m_acc=bwd_acc[1], block_k=bwd_chunk,
                                carry=dx_carry)
    dw = chunked_gemm_reference(x32.T, g32, e_acc=grad_acc[0],
                                m_acc=grad_acc[1], block_k=grad_chunk)
    return dx, dw


_LL, _I, _P, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_ARGTYPES = ([_P, _LL, _LL, _P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _P, _P,
              _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I]
             + [_I, _I, _F, _F] * 2 + [_P])


def _launch(g, xq, wq, dx_carry, *, fmt, bwd_acc, grad_acc, bwd_chunk,
            grad_chunk, quantize_g):
    devs = {t.device for t in (g, xq, wq)} | (
        {dx_carry.device} if dx_carry is not None else set())
    if len(devs) != 1 or not g.is_cuda:
        raise ValueError(f"operands on {sorted(map(str, devs))}")
    t, n = g.shape
    k = xq.shape[1]
    dev = g.device
    dx = torch.empty((t, k), dtype=torch.float32, device=dev)
    dw = torch.empty((k, n), dtype=torch.float32, device=dev)
    carry = None
    if dx_carry is not None:
        carry = dx_carry.to(torch.float32).contiguous()
    if t == 0 or k == 0 or n == 0:
        dx.zero_()
        if carry is not None:
            dx.copy_(carry)
        dw.zero_()
        return dx, dw
    quant = quantize_g and fmt is not None
    e_r, m_r = fmt or _WIDE
    rc = build.function("bwd_pair", "bwd_pair", _ARGTYPES)(
        g.data_ptr(), g.stride(0), g.stride(1),
        xq.data_ptr(), _KINDS[xq.dtype], xq.stride(0), xq.stride(1),
        wq.data_ptr(), _KINDS[wq.dtype], wq.stride(0), wq.stride(1),
        carry.data_ptr() if carry is not None else None,
        dx.data_ptr(), dw.data_ptr(), t, k, n, bwd_chunk, grad_chunk,
        e_r, m_r, *qfmt_args(fmt or _WIDE), int(quant),
        *qfmt_args(bwd_acc), *qfmt_args(grad_acc),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bwd_pair launch failed: CUDA error {rc}")
    if dx_carry is None:
        qmatmul_bwd_pair.launches += 1
    else:
        qmatmul_bwd_pair.carry_launches += 1
    return dx, dw


def qmatmul_bwd_pair(g, xq, wq, *, repr_fmt, bwd_acc=_WIDE, grad_acc=_WIDE,
                     bwd_chunk: int = 128, grad_chunk: int = 128,
                     packed: bool = True, quantize_g: bool = True,
                     dx_carry=None):
    """``(dx, dw)`` of one dense layer, both float32, in one launch.

    * ``g`` [T, N] float32, any strides; quantized to ``repr_fmt`` on load
      when ``quantize_g`` (and ``repr_fmt`` is not None);
    * ``xq`` [T, K], ``wq`` [K, N]: int8 codes of the quantized forward
      operands when ``packed``, else raw float32/bfloat16 of any strides;
    * ``bwd_acc``/``grad_acc``: (e, m) carry formats; ``bwd_chunk`` rounds
      dx's carry over N, ``grad_chunk`` dw's over T;
    * ``dx_carry`` [T, K]: resume dx from this running carry (the segment
      entry, K7): dw is then this N segment's columns.  Launches with a
      carry are counted on ``carry_launches``, the others on ``launches``.
    """
    fmt = fmt_tuple(repr_fmt)
    bwd_acc, grad_acc = tuple(bwd_acc), tuple(grad_acc)
    tensors = [t for t in (g, xq, wq, dx_carry) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return qmatmul_bwd_pair_reference(
            g, xq, wq, repr_fmt=fmt, bwd_acc=bwd_acc, grad_acc=grad_acc,
            bwd_chunk=bwd_chunk, grad_chunk=grad_chunk, packed=packed,
            quantize_g=quantize_g, dx_carry=dx_carry)
    _check(g, xq, wq, fmt, packed, dx_carry, bwd_chunk, grad_chunk)
    return _launch(g, xq, wq, dx_carry, fmt=fmt, bwd_acc=bwd_acc,
                   grad_acc=grad_acc, bwd_chunk=bwd_chunk,
                   grad_chunk=grad_chunk, quantize_g=quantize_g)


qmatmul_bwd_pair.launches = 0
qmatmul_bwd_pair.carry_launches = 0


def pair_segment_width(n: int, n_split: int, block_n: int) -> int:
    """``block_n``-aligned width of one of ``n_split`` N segments (the JAX
    package's formula)."""
    return max(-(-(-(-n // n_split)) // block_n) * block_n, block_n)


def qmatmul_bwd_pair_nsplit(g, xq, wq, *, n_split: int, **kw):
    """The pair over ``n_split`` N segments of ``bwd_chunk``-aligned width
    (the JAX package's ``pair_segment_width``), dx chained through
    ``dx_carry``: bitwise the unsplit ``qmatmul_bwd_pair``."""
    if n_split < 2:
        raise ValueError("n_split >= 2; use qmatmul_bwd_pair for one pass")
    t, n = g.shape
    seg = pair_segment_width(n, n_split, kw.get("bwd_chunk", 128))
    dx = torch.zeros((t, xq.shape[1]), dtype=torch.float32, device=g.device)
    dws = []
    for lo in range(0, n, seg):
        hi = min(lo + seg, n)
        dx, dw = qmatmul_bwd_pair(g[:, lo:hi], xq, wq[:, lo:hi],
                                  dx_carry=dx, **kw)
        dws.append(dw)
    return dx, torch.cat(dws, dim=1)
