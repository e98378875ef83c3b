"""Synthetic deterministic LM data pipeline.

Counterpart of ``repro.data.pipeline`` (``DataConfig``, ``SyntheticLM``):
an infinite, seeded, learnable token stream, sharded per host, with an O(1)
checkpointable cursor (the step index).  Each sequence follows the affine
recurrence t_{i+1} = (a t_i + b) mod V in int32 arithmetic, as the JAX
package computes it (the product wraps at 2^31 for large vocabularies, so
the next-token map is the JAX one), with i.i.d. noise tokens replacing a
``noise`` fraction of positions.  (a, b) are a property of the dataset
(drawn from ``seed``); start tokens and noise are drawn per step and host.

The draws are JAX's threefry stream (``repro_torch.data.prng``), key for
key as the JAX pipeline derives them, so both packages make the same
batches, bit for bit, from one seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.data import prng

__all__ = ["DataConfig", "SyntheticLM"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05    # fraction of positions replaced with noise tokens
    host_id: int = 0
    n_hosts: int = 1


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value it wraps to."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def affine_next(t: torch.Tensor, a: int, b: int, vocab: int) -> torch.Tensor:
    """(a t + b) mod V with int32 wrap-around and a non-negative remainder:
    the JAX pipeline's ``(a_coef * t + b_coef) % vocab_size``."""
    return _wrap32(_wrap32(a * t.to(torch.int64)) + b) % vocab


class SyntheticLM:
    """Iterator of {"tokens": (B_host, S) int32} batches on ``device``."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device="cpu"):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide by n_hosts")
        self.cfg = cfg
        self.step = start_step
        self.device = device
        # the affine map (a, b) is a dataset property (seed-derived): the
        # next-token function is a fixed learnable bigram map
        v = cfg.vocab_size
        kd = prng.prng_key(cfg.seed)
        self.a_coef = 1 + 2 * int(prng.randint(kd, (), 0, max(v // 2, 1)))
        self.b_coef = int(prng.randint(prng.fold_in(kd, 1), (), 0, v))

    @property
    def host_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        key = prng.fold_in(prng.prng_key(c.seed + 7919), step)
        key = prng.fold_in(key, c.host_id)
        _, _, k3, k4 = prng.split(key, 4)
        b, v = self.host_batch, c.vocab_size
        t = prng.randint(k3, (b, 1), 0, v)[:, 0].to(torch.int64)
        cols = [t]
        for _ in range(c.seq_len - 1):
            t = affine_next(t, self.a_coef, self.b_coef, v)
            cols.append(t)
        tokens = torch.stack(cols, dim=1).to(torch.int32)
        # one key feeds both draws, as in the JAX pipeline
        noise_mask = prng.bernoulli(k4, c.noise, tokens.shape)
        noise_tok = prng.randint(k4, tokens.shape, 0, v)
        tokens = torch.where(noise_mask, noise_tok, tokens)
        return {"tokens": tokens.to(self.device)}

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
