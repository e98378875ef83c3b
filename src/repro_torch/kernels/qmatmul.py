"""GEMM with a chunked low-precision carry, operands taken as they are:
the K3 kernel.

Replaces the TPU kernel ``repro/kernels/qmatmul.py::_qmatmul_kernel``
(``qmatmul_pallas``) with the CUDA C++ kernel ``csrc/qmatmul.cu``::

    C[M, N] = sum over chunks of K:  carry = q_acc(carry + A_c @ B_c)

The intra-chunk partial is an f32 sum of fused multiply-adds in increasing
k, kept apart from the carry; the carry is rounded to (1, e_acc, m_acc)
once per ``block_k`` (= the chunk n1) products, a ragged last chunk
included.  With the wide (8, 23) carry the rounding is the identity and
this is a plain chunked f32 GEMM, the oracle's wide roles.

It is the GEMM of the unfused ``qdot`` oracle (``kernels.ops``,
``QDotConfig(fused=False)``): FWD ``Q(x) @ Q(w)``, BWD ``Q(g) @ Q(w)^T``
and GRAD ``Q(x)^T @ Q(g)``, the operands already quantized by K2 (or raw,
where ``repr_fmt`` is None).  Its tile is written apart from G's kernels
(``csrc/qgemm.cu``) and from the Hopper tile of E, K8, B and K9
(``csrc/qgemm_sm90.cuh``), and includes only ``csrc/common.cuh``, so the
oracle on the card is an independent check of them; the operation
sequence of each output is the same.

The design (``csrc/qmatmul.cu``): a block computes a 64 x 64 tile of C
with ``slices`` chunk slices of 64 threads (``slices_for``: 1, 2 or 4 from
the chunk count); in each round slice s forms the 8 x 8 partials a thread
of chunk ``round * slices + s``, and after one block barrier all threads
fold the round's partials in chunk order into carries held in shared
memory.  Partials of different chunks are independent, so a split at
chunk boundaries with an in-order fold keeps every bit.  Loads are 16
bytes along each operand's contiguous axis, element by element where a
ragged edge, a chunk end or the layout cuts a piece.  Its work is bound
by the bytes (f32 operands and C, PERF.md section 6); the bitwise
contract keeps it on the CUDA cores, at their f32 FMA rate.

On CPU tensors ``qmatmul`` runs the plain version; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import qfmt_args
from repro_torch.kernels.fused import chunked_gemm_reference

__all__ = ["qmatmul", "qmatmul_reference", "slices_for", "smem_bytes"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LL, _I, _P, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_ARGTYPES = [_P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _I, _I, _I, _I,
             _I, _I, _F, _F, _I, _P]

TILE = 64           # output rows and columns of a block
SLICE_THREADS = 64  # threads of a chunk slice (8 x 8 outputs each)
_KT, _PITCH = 16, TILE + 4


def slices_for(n_chunks: int) -> int:
    """Chunk slices a block: one for a single chunk, two for two or three,
    four from four chunks on (the same shape always gets the same)."""
    return 1 if n_chunks <= 1 else 2 if n_chunks <= 3 else 4


def smem_bytes(slices: int) -> int:
    """Dynamic shared memory of one block (``csrc/qmatmul.cu``'s
    ``smem_bytes``): the carry tile, then each slice's region, which holds
    its A and B step tiles or its round's partials."""
    region = max(2 * _KT * _PITCH, TILE * TILE)
    return (TILE * TILE + slices * region) * 4


def _check(a: torch.Tensor, b: torch.Tensor, block_k: int) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if block_k < 1:
        raise ValueError(f"block_k must be positive, got {block_k}")


def qmatmul_reference(a: torch.Tensor, b: torch.Tensor, *, e_acc: int = 8,
                      m_acc: int = 23, block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version: both operands widened to float32, then
    ``chunked_gemm_reference`` (the kernel's order, so bitwise it)."""
    _check(a, b, block_k)
    return chunked_gemm_reference(a.to(torch.float32), b.to(torch.float32),
                                  e_acc=e_acc, m_acc=m_acc, block_k=block_k)


def qmatmul(a: torch.Tensor, b: torch.Tensor, *, e_acc: int = 8,
            m_acc: int = 23, block_k: int = 128) -> torch.Tensor:
    """C[M, N] = A[M, K] @ B[K, N] with a (1, e_acc, m_acc) carry rounded
    every ``block_k`` products; ``a``/``b`` float32 or bfloat16 of any
    strides (a transposed view is read in place).  Returns float32 (M, N).
    Launches are counted on ``qmatmul.launches``."""
    _check(a, b, block_k)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return qmatmul_reference(a, b, e_acc=e_acc, m_acc=m_acc,
                                 block_k=block_k)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    rc = build.function("qmatmul", "qmatmul", _ARGTYPES)(
        a.data_ptr(), _DTYPES[a.dtype], a.stride(0), a.stride(1),
        b.data_ptr(), _DTYPES[b.dtype], b.stride(0), b.stride(1),
        out.data_ptr(), m, n, k, block_k, *qfmt_args((e_acc, m_acc)),
        slices_for(-(-k // block_k)),
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul launch failed: CUDA error {rc}")
    qmatmul.launches += 1
    return out


qmatmul.launches = 0
