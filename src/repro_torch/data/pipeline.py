"""Synthetic deterministic LM data pipeline.

Counterpart of ``repro.data.pipeline`` (``DataConfig``, ``SyntheticLM``):
an infinite, seeded, learnable token stream with an O(1) checkpointable
cursor (the step index).  Each sequence follows the affine recurrence
t_{i+1} = (a t_i + b) mod V in int32 arithmetic, as the JAX package
computes it (the product wraps at 2^31 for large vocabularies, so the
next-token map is the JAX one), with i.i.d. noise tokens replacing a
``noise`` fraction of positions.  (a, b) are a property of the dataset
(drawn from ``seed``); start tokens and noise are drawn per step.  One
host: the JAX pipeline's per-host sharding is not ported.

The draws come from ``torch.Generator``s seeded from (seed, step),
not from JAX's threefry stream, so the two packages make different
batches from one seed: tests hand both the same token arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["DataConfig", "SyntheticLM"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05    # fraction of positions replaced with noise tokens


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value it wraps to."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def affine_next(t: torch.Tensor, a: int, b: int, vocab: int) -> torch.Tensor:
    """(a t + b) mod V with int32 wrap-around and a non-negative remainder:
    the JAX pipeline's ``(a_coef * t + b_coef) % vocab_size``."""
    return _wrap32(_wrap32(a * t.to(torch.int64)) + b) % vocab


class SyntheticLM:
    """Iterator of {"tokens": (B, S) int32} batches on ``device``."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device="cpu"):
        self.cfg = cfg
        self.step = start_step
        self.device = device
        g = torch.Generator().manual_seed(cfg.seed)
        v = cfg.vocab_size
        self.a_coef = 1 + 2 * int(torch.randint(0, max(v // 2, 1), (),
                                                generator=g))
        self.b_coef = int(torch.randint(0, v, (), generator=g))

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        g = torch.Generator().manual_seed((c.seed + 7919) * 1_000_003 + step)
        b, v = c.global_batch, c.vocab_size
        t = torch.randint(0, v, (b,), generator=g)
        cols = [t]
        for _ in range(c.seq_len - 1):
            t = affine_next(t, self.a_coef, self.b_coef, v)
            cols.append(t)
        tokens = torch.stack(cols, dim=1)
        noise_mask = torch.rand(tokens.shape, generator=g) < c.noise
        noise_tok = torch.randint(0, v, tokens.shape, generator=g)
        tokens = torch.where(noise_mask, noise_tok, tokens)
        return {"tokens": tokens.to(torch.int32).to(self.device)}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        out = self.batch_at(self.step)
        self.step += 1
        return out

    # ----- checkpointable cursor -----
    def state_dict(self) -> dict:
        return {"step": int(self.step), "seed": int(self.cfg.seed)}

    def load_state_dict(self, d: dict) -> None:
        if int(d["seed"]) != self.cfg.seed:
            raise ValueError("data seed mismatch on resume")
        self.step = int(d["step"])
