"""AdamW with global-norm clipping, warmup-cosine schedule and loss scaling.

Counterpart of ``repro.train.optimizer`` (A2Q is not ported: it raises).
Written out op by op in the JAX package's order, in float32, rather than
``torch.optim.AdamW``, which applies the weight decay differently (it
shrinks the parameter before the Adam step; here the decay joins the
update).  Python floats enter as float32 constants, as JAX's weak types
do; divisions by a constant divide by a float32 tensor on the device, so
they are true divisions on every backend (PyTorch may multiply by a
reciprocal when the divisor is a Python number).

Trees are nested dicts (and lists) of tensors; every reduction over a tree
visits the leaves in sorted-key order, as ``jax.tree.leaves`` does.
``adamw_update`` updates the parameters and moments in place (JAX returns
new arrays): the full qwen2-1.5b state would otherwise exist twice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

__all__ = ["OptConfig", "schedule", "init_opt_state", "global_norm",
           "adamw_update", "LossScaleConfig", "init_scaler",
           "unscale_and_check", "all_finite", "tree_leaves", "tree_map"]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree: Any) -> list:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """float32 constant on ``like``'s device (a fill, no host copy)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine to ``lr * min_lr_ratio``."""
    step = step.to(torch.float32)
    warm = step / _c(max(cfg.warmup_steps, 1), step)
    frac = (step - cfg.warmup_steps) / _c(
        max(cfg.total_steps - cfg.warmup_steps, 1), step)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any) -> dict:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    some = tree_leaves(params)[0]
    return {"m": zeros, "v": tree_map(torch.clone, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=some.device)}


def global_norm(tree: Any) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def adamw_update(params: Any, grads: Any, opt: dict, cfg: OptConfig, *,
                 skip: torch.Tensor | None = None,
                 a2q=None) -> tuple[Any, dict, dict]:
    """One AdamW step, in place.  ``skip`` (bool tensor) makes the whole
    update a no-op without a host round-trip.  Returns ``(params, opt,
    {"grad_norm", "lr"})`` (the same tensors, updated)."""
    if a2q is not None:
        raise NotImplementedError("A2Q is not ported")
    step = opt["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.minimum(_c(1.0, gnorm),
                          _c(cfg.grad_clip, gnorm) / (gnorm + 1e-12))
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(_c(b1, stepf), stepf)
    c2 = 1.0 - torch.pow(_c(b2, stepf), stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        update = (m2 / c1) / (torch.sqrt(v2 / c2) + cfg.eps)
        update = update + cfg.weight_decay * p.to(torch.float32)
        p2 = p.to(torch.float32) - lr * update
        if skip is not None:
            p2, m2, v2 = (torch.where(skip, p, p2.to(p.dtype)),
                          torch.where(skip, m, m2), torch.where(skip, v, v2))
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt["m"]), tree_leaves(opt["v"])):
        upd(p, g, m, v)
    if skip is not None:
        step = torch.where(skip, opt["step"], step)
    opt["step"] = step
    return params, opt, {"grad_norm": gnorm, "lr": lr}


# ------------------------------ loss scaling -------------------------------


@dataclass(frozen=True)
class LossScaleConfig:
    init_scale: float = 1000.0   # the paper's static value
    dynamic: bool = True
    growth_interval: int = 200
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    max_scale: float = 2.0 ** 24


def init_scaler(cfg: LossScaleConfig, device="cpu") -> dict:
    return {"scale": torch.full((), cfg.init_scale, dtype=torch.float32,
                                device=device),
            "good_steps": torch.zeros((), dtype=torch.int32, device=device)}


def all_finite(tree: Any) -> torch.Tensor:
    finite = None
    for g in tree_leaves(tree):
        f = torch.all(torch.isfinite(g))
        finite = f if finite is None else torch.logical_and(finite, f)
    return finite


def unscale_and_check(grads: Any, scaler: dict, cfg: LossScaleConfig):
    """Unscale the gradients, detect overflow, update the scaler state.

    Returns ``(grads, new_scaler, skip)``; skip is True on non-finite
    gradients, which are then zeroed so the skipped update stays finite."""
    grads = tree_map(lambda g: g.to(torch.float32) / scaler["scale"], grads)
    skip = torch.logical_not(all_finite(grads))
    if not cfg.dynamic:
        return grads, scaler, skip
    good = torch.where(skip, 0, scaler["good_steps"] + 1)
    grow = good >= cfg.growth_interval
    s = scaler["scale"]
    scale = torch.where(
        skip, torch.clamp(s * cfg.backoff_factor, min=1.0),
        torch.where(grow, torch.clamp(s * cfg.growth_factor,
                                      max=cfg.max_scale), s))
    good = torch.where(grow, 0, good).to(torch.int32)
    grads = tree_map(lambda g: torch.where(skip, torch.zeros_like(g), g),
                     grads)
    return grads, {"scale": scale, "good_steps": good}, skip
