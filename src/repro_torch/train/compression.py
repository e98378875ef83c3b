"""Int8 compression of a cross-rank sum, carried in the ``QTensor``
container.

Counterpart of ``repro.train.compression``.  The wire code is
``QTensor``'s linear mode (int8 payload times a per-tensor float32
scale), not its packed (1, e, m) mode: summing is the point of the
collective, and affine codes sum exactly in an int32 accumulator while
floating-point codes do not.

``compressed_psum`` packs each rank's tensor under a scale shared by a
pmax, sums the int32 payloads over the ranks and decodes; the
quantization residual is returned for error feedback.  Tensor-parallel
serving uses it as the int8 logit wire (``--logit-wire int8``); its use
for gradients comes with the training half of the distribution work.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.dist import Dist, pmax, psum
from repro_torch.quant.qtensor import QTensor

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum",
           "ef_compress_tree"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The linear int8 code of ``x`` under its own amax scale, as
    ``(payload, scale)``."""
    qt = QTensor.pack_linear(x)
    return qt.payload, qt.scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return QTensor(q, scale=scale).unpack()


def compressed_psum(x: torch.Tensor, dist: Dist
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sum of ``x`` over the ranks of ``dist`` with an int8 payload on
    the wire: ``(sum, residual)``.

    Every rank quantizes its own tensor, so the scale is shared: a pmax of
    the ranks' amax fixes one scale, then the int8 payloads sum exactly in
    int32.  The residual against the shared-scale reconstruction is
    returned for error feedback.  Exact wherever ``x`` sits on the wire's
    lattice; lossy otherwise."""
    amax = pmax(torch.amax(torch.abs(x)), dist) + 1e-12
    qt = QTensor.pack_linear(x, scale=amax / 127.0)
    residual = x - qt.unpack()
    # int32 sums cannot overflow below 2^24 ranks
    total = psum(qt.payload.to(torch.int32), dist).to(torch.float32) * qt.scale
    return total, residual


def _map2(fn, a: Any, b: Any):
    if isinstance(a, dict):
        pairs = {k: _map2(fn, a[k], b[k]) for k in a}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    return fn(a, b)


def ef_compress_tree(grads: Any, errors: Any) -> tuple[Any, Any]:
    """Error-feedback compression of a gradient tree (nested dicts of
    tensors), the local half (the caller sums): each leaf plus its error
    ships as a linear ``QTensor``; returns ``(reconstructed grads, new
    errors)``."""

    def one(g, e):
        g = g + e
        recon = QTensor.pack_linear(g).unpack()
        return recon, g - recon

    return _map2(one, grads, errors)
