"""Elementwise (1, e, m) quantization: the K2 kernel.

Replaces the TPU kernel ``repro/kernels/quantize.py::_quantize_kernel``
(``quantize_pallas``) with the CUDA C++ kernel ``csrc/quantize.cu``: every
element of a float32 or bfloat16 tensor rounded to (1, e, m) with RNE,
saturating (inf and overflow to +-max_value), subnormals flushed to zero
with the sign kept, NaN passed through, returned as float32.  The kernel
applies ``quantize_rne`` of ``csrc/common.cuh``, so it is bitwise
``kernels.common.quantize_block`` on every input.

The TPU kernel streams the flattened tensor as (rows, 128) tiles through
VMEM; the tiling is the TPU's, not the function's.  Here one thread takes
four neighbouring elements a step (one 16-byte load of f32, 8 bytes of
bf16) in a grid-stride loop.  What bounds it on the H100: the bytes, one
read of the input and one f32 write; the bit arithmetic is a few integer
operations an element.

It is the unfused ``qdot`` oracle's operand quantizer (``kernels.ops``,
``QDotConfig(fused=False)``): Q(x), Q(w), Q(g) and the ``out_fmt``
rounding, each one launch.

On CPU tensors ``quantize`` runs the plain version; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import qfmt_args, quantize_block

__all__ = ["quantize", "quantize_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LL, _I, _P, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_ARGTYPES = [_P, _I, _P, _LL, _I, _I, _I, _F, _F, _P]


def _check(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize takes float32 or bfloat16, got {x.dtype}")


def quantize_reference(x: torch.Tensor, *, e: int, m: int) -> torch.Tensor:
    """Plain PyTorch version: ``quantize_block`` of ``x`` as float32."""
    _check(x)
    return quantize_block(x.to(torch.float32), e, m)


def quantize(x: torch.Tensor, *, e: int, m: int) -> torch.Tensor:
    """``x`` (float32 or bfloat16, any shape) quantized to (1, e, m), as a
    new contiguous float32 tensor of the same shape (a non-contiguous
    ``x`` is copied to a contiguous one first).  Launches are counted on
    ``quantize.launches``."""
    _check(x)
    if x.device.type == "cpu":
        return quantize_reference(x, e=e, m=m)
    if not x.is_cuda:
        raise ValueError(f"quantize runs on CUDA tensors, got {x.device}")
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    align = 16 if x.dtype == torch.float32 else 8
    rc = build.function("quantize", "quantize", _ARGTYPES)(
        x.data_ptr(), _DTYPES[x.dtype], out.data_ptr(), n,
        int(x.data_ptr() % align == 0), *qfmt_args((e, m)),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize launch failed: CUDA error {rc}")
    quantize.launches += 1
    return out


quantize.launches = 0
