"""GEMM-operand capture for the telemetry probe.

A forward pass run inside ``capture_gemms()`` makes every quantized
``qdot`` record its 2-D operands and ``QDotConfig`` here; the probe then
replays each recorded GEMM through the stats kernel (``collect_stats=True``)
on the live operands.  ``suspended()`` turns recording off for a region:
the layer loop of ``models.lm.forward_hidden`` runs under it, so that the
captured set is the JAX package's (whose layer blocks run under
``lax.scan``, where operands are tracers and are never recorded).

Dependency-free (stdlib only): ``repro_torch.kernels.ops`` imports it at
module load.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Iterator

__all__ = ["capture_gemms", "suspended", "active", "record"]

_STACK: list[list[dict[str, Any]] | None] = []


@contextmanager
def capture_gemms() -> Iterator[list[dict[str, Any]]]:
    """Collect ``{"x": (T, K), "w": (K, N), "cfg": QDotConfig, "sr_seed"}``
    records from every quantized ``qdot`` in the body."""
    buf: list[dict[str, Any]] = []
    _STACK.append(buf)
    try:
        yield buf
    finally:
        _STACK.pop()


@contextmanager
def suspended() -> Iterator[None]:
    """No recording in the body, even inside ``capture_gemms()``."""
    _STACK.append(None)
    try:
        yield
    finally:
        _STACK.pop()


def active() -> bool:
    return bool(_STACK) and _STACK[-1] is not None


def record(**entry: Any) -> None:
    if active():
        _STACK[-1].append(entry)
