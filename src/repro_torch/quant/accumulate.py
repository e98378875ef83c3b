"""Software reduced-precision accumulators (the Monte-Carlo oracle).

Counterpart of ``repro.quant.accumulate``: deliberately sequential
emulations of the paper's FPU semantics, every add rounding the partial
sum to the accumulator format.  They check Theorem 1 / Corollary 1
against simulation and give Table 1's "normal accumulation" column.  The
JAX package writes them in plain ``jnp`` (a ``lax.scan``), not Pallas; here
they are plain PyTorch on the device of their input: the scan is a loop
over the last axis, each step ``quantize(carry + t)``.
"""

from __future__ import annotations

import torch

from repro_torch.quant.formats import FPFormat
from repro_torch.quant.qnum import quantize

__all__ = ["sequential_accumulate", "chunked_accumulate", "swamped_variance"]


def sequential_accumulate(terms: torch.Tensor, acc_fmt: FPFormat) -> torch.Tensor:
    """Sum ``terms`` along the last axis, rounding after every add.

    terms: (..., n) float32, already representable in the product format.
    Returns (...,) float32: the reduced-precision sum.
    """
    steps = terms.to(torch.float32).movedim(-1, 0).contiguous()
    carry = torch.zeros(terms.shape[:-1], dtype=torch.float32,
                        device=terms.device)
    done = 0
    if steps.is_cuda and steps.shape[0] >= 2 * GRAPH_STEPS:
        carry, done = _scan_graphed(steps, carry, acc_fmt)
    for t in steps[done:]:
        carry = quantize(carry + t, acc_fmt)
    return carry


# Steps a CUDA graph of the scan holds.  Each step is some fifteen small
# PyTorch launches; eagerly the host's launch cost bounds a long scan on
# the card (about 0.29 ms a step at an ensemble of 2048).
GRAPH_STEPS = 256


def _scan_graphed(steps: torch.Tensor, carry: torch.Tensor, acc_fmt: FPFormat):
    """The scan's whole blocks of ``GRAPH_STEPS`` steps, each a replay of
    one CUDA graph of those steps (the same operations in the same order)
    fed through a static window; returns (carry, steps done)."""
    win = torch.empty((GRAPH_STEPS,) + steps.shape[1:], dtype=torch.float32,
                      device=steps.device)
    side = torch.cuda.Stream(steps.device)
    side.wait_stream(torch.cuda.current_stream(steps.device))
    with torch.cuda.stream(side):     # warm-up before the capture
        quantize(carry + win[0], acc_fmt)
    torch.cuda.current_stream(steps.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = carry
        for j in range(GRAPH_STEPS):
            c = quantize(c + win[j], acc_fmt)
        carry.copy_(c)
    done = steps.shape[0] // GRAPH_STEPS * GRAPH_STEPS
    for i in range(0, done, GRAPH_STEPS):
        win.copy_(steps[i:i + GRAPH_STEPS])
        graph.replay()
    return carry.clone(), done


def chunked_accumulate(terms: torch.Tensor, acc_fmt: FPFormat,
                       chunk: int) -> torch.Tensor:
    """Two-level chunked accumulation (paper §4.2): each chunk of ``chunk``
    terms summed at ``acc_fmt``, then the chunk sums in order at
    ``acc_fmt``; a ragged tail chunk is padded with zeros."""
    n = terms.shape[-1]
    pad = (-n) % chunk
    if pad:
        terms = torch.nn.functional.pad(terms, (0, pad))
    chunks = terms.reshape(terms.shape[:-1] + (terms.shape[-1] // chunk, chunk))
    return sequential_accumulate(sequential_accumulate(chunks, acc_fmt),
                                 acc_fmt)


def swamped_variance(gen: torch.Generator, n: int, acc_fmt: FPFormat,
                     prod_fmt: FPFormat, *, ensemble: int = 4096,
                     chunk: int = 0, device="cuda") -> torch.Tensor:
    """Monte-Carlo estimate of Var(s_n) under swamping, over the variance
    of the products: an ensemble of length-``n`` i.i.d. N(0, 1) streams
    drawn from ``gen`` (a generator on ``device``), quantized to
    ``prod_fmt`` and accumulated at ``acc_fmt`` (chunked when ``chunk``).
    Compare with ``VRR(m_acc, m_p, n) * n``.  The population variance,
    as ``jnp.var``."""
    terms = torch.randn((ensemble, n), generator=gen, device=device,
                        dtype=torch.float32)
    terms = quantize(terms, prod_fmt)
    sums = (chunked_accumulate(terms, acc_fmt, chunk) if chunk
            else sequential_accumulate(terms, acc_fmt))
    return torch.var(sums, correction=0) / torch.var(terms, correction=0)
