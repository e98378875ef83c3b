"""AdamW with global-norm clipping, warmup-cosine schedule and loss scaling.

Counterpart of ``repro.train.optimizer``, A2Q included.  Written out op by op in the JAX package's order, in float32, rather than
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

Under FSDP the params and moments are this rank's blocks: the update is
elementwise on them, with the clip norm of the whole gradients passed in
(``adamw_update(grad_norm=)``), and the A2Q projection's columns are whole
on every rank (the data axis splits the embedding's D, never its V).

A2Q (accumulator-aware weight norms, Colbert et al. arXiv:2301.13376, as
the JAX package adapts it to the chunked carries): a GEMM's reduced
carry can never reach its saturation clamp if every output column of the
weight satisfies ``||w_col||_1 * x_bound <= acc_max / 2^margin_bits``,
since ``|sum_i w_i x_i| <= ||w||_1 max|x|``.  ``a2q_penalty`` is the soft
form (added to the loss), ``a2q_project`` the hard one (inside
``adamw_update``, after the step), ``a2q_certificate`` the verdict.  As
in the JAX package, they act on every 2-D leaf of the parameter tree (the
stacked layers' norm scales and biases, the tied embedding), whose
columns are the second axis.  Column l1 sums are f32 reductions, so they
differ from XLA's in the last bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.quant.formats import FPFormat

__all__ = ["OptConfig", "schedule", "init_opt_state", "global_norm",
           "adamw_update", "LossScaleConfig", "init_scaler",
           "unscale_and_check", "all_finite", "tree_leaves", "tree_map",
           "A2QConfig", "acc_format_max", "a2q_l1_cap", "a2q_penalty",
           "a2q_project", "a2q_certificate"]


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


# ------------------------- A2Q overflow avoidance ---------------------------


def acc_format_max(e_acc: int, m_acc: int) -> float:
    """Largest magnitude of the saturating (1, e_acc, m_acc) carry: the
    budget the A2Q cap divides up."""
    return FPFormat(e=e_acc, m=m_acc).max_value


@dataclass(frozen=True)
class A2QConfig:
    """The weight-norm constraint for one accumulator format.
    ``x_bound`` bounds the other operand's magnitude; ``margin_bits >= 1``
    keeps certified carries strictly below the clamp (so the stats row's
    MAX_ABS tells constrained from unconstrained weights); ``strength`` is
    the soft penalty's coefficient (0: projection only); ``project`` the
    hard rescale inside ``adamw_update``."""

    e_acc: int = 6
    m_acc: int = 9
    x_bound: float = 16.0
    margin_bits: int = 1
    strength: float = 0.0
    project: bool = True


def a2q_l1_cap(cfg: A2QConfig) -> float:
    """Per-output-column l1 budget: ``acc_max / 2^margin / x_bound``."""
    return (acc_format_max(cfg.e_acc, cfg.m_acc)
            / (2.0 ** cfg.margin_bits) / max(cfg.x_bound, 1e-30))


def _col_l1(w: torch.Tensor) -> torch.Tensor:
    # a (K, N) weight accumulates once an output column
    return torch.sum(torch.abs(w.to(torch.float32)), dim=0)


def a2q_penalty(params: Any, cfg: A2QConfig) -> torch.Tensor:
    """Soft constraint: the squared l1 excess over the cap, summed over
    the columns of every 2-D leaf, times ``cfg.strength`` (a float32
    scalar to add to the loss; differentiable)."""
    cap = a2q_l1_cap(cfg)
    leaves = tree_leaves(params)
    excess = torch.zeros((), dtype=torch.float32,
                         device=leaves[0].device if leaves else "cpu")
    for p in leaves:
        if p.ndim == 2:
            over = torch.clamp(_col_l1(p) - cap, min=0.0)
            excess = excess + torch.sum(over * over)
    return cfg.strength * excess


def _a2q_leaf(p: torch.Tensor, cap: float) -> torch.Tensor:
    """One 2-D leaf with every column over the cap scaled onto it."""
    norm = _col_l1(p)
    scale = torch.where(norm > cap,
                        _c(cap, norm) / torch.clamp(norm, min=1e-30),
                        _c(1.0, norm))
    return (p.to(torch.float32) * scale[None, :]).to(p.dtype)


def a2q_project(params: Any, cfg: A2QConfig) -> Any:
    """Hard constraint: a new tree whose 2-D leaves have every column with
    an l1 norm over the cap rescaled onto it (magnitudes shrink uniformly;
    signs, zeros and the column's shape stay); other leaves as they are."""
    cap = a2q_l1_cap(cfg)
    return tree_map(lambda p: _a2q_leaf(p, cap) if p.ndim == 2 else p,
                    params)


def a2q_certificate(params: Any, cfg: A2QConfig, dist=None) -> dict:
    """The guarantee, stated: the worst column l1 norm and carry bound
    against the cap and the format's ceiling; ``ok`` is the verdict that no
    carry can overflow.  Under FSDP (``dist`` with a mesh, ``params`` this
    rank's blocks, each column whole) the worst is the max over the
    ranks."""
    cap = a2q_l1_cap(cfg)
    worst = 0.0
    for p in tree_leaves(params):
        if p.ndim == 2 and p.numel():
            worst = max(worst, float(torch.max(_col_l1(p))))
    if dist is not None and dist.mesh is not None and dist.fsdp_axis:
        from repro_torch.dist import pmax

        some = tree_leaves(params)[0]
        worst = float(pmax(torch.tensor(worst, dtype=torch.float32,
                                        device=some.device), dist,
                           dist.fsdp_axis))
    return {"l1_cap": cap, "max_col_l1": worst,
            "carry_bound": worst * cfg.x_bound,
            "acc_max": acc_format_max(cfg.e_acc, cfg.m_acc),
            "ok": worst <= cap * (1.0 + 1e-6)}


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
                 a2q: A2QConfig | None = None,
                 grad_norm: torch.Tensor | None = None
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step, in place.  ``skip`` (bool tensor) makes the whole
    update a no-op without a host round-trip.  ``a2q`` (with ``project``)
    rescales every 2-D leaf's columns onto the A2Q cap after the step, so
    the certificate holds at every step boundary.  Returns ``(params,
    opt, {"grad_norm", "lr"})`` (the same tensors, updated).  Under FSDP
    the trees are this rank's blocks and ``grad_norm`` the whole
    gradients' norm."""
    cap = a2q_l1_cap(a2q) if (a2q is not None and a2q.project) else None
    step = opt["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
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
        p2 = (p.to(torch.float32) - lr * update).to(p.dtype)
        if cap is not None and p.ndim == 2:
            p2 = _a2q_leaf(p2, cap)
        if skip is not None:
            p2, m2, v2 = (torch.where(skip, p, p2),
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
    grads = tree_map(lambda g: torch.where(skip, torch.zeros_like(g), g),
                     grads)
    return grads, update_scaler(scaler, skip, cfg), skip


def update_scaler(scaler: dict, skip: torch.Tensor,
                  cfg: LossScaleConfig) -> dict:
    """The dynamic loss scale after a step that ``skip`` says overflowed
    or not."""
    good = torch.where(skip, 0, scaler["good_steps"] + 1)
    grow = good >= cfg.growth_interval
    s = scaler["scale"]
    scale = torch.where(
        skip, torch.clamp(s * cfg.backoff_factor, min=1.0),
        torch.where(grow, torch.clamp(s * cfg.growth_factor,
                                      max=cfg.max_scale), s))
    good = torch.where(grow, 0, good).to(torch.int32)
    return {"scale": scale, "good_steps": good}
