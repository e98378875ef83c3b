"""The train step: bf16 compute copy, microbatches, loss scaling, AdamW.

Counterpart of ``repro.train.loop`` (``TrainConfig``, ``init_train_state``,
``make_train_step``) for one device.  The JAX step differentiates with
respect to a bf16 copy of every parameter of two or more dimensions (the
stacked layer tensors, norms and biases included, and the embedding),
made once per step; so every such gradient is rounded to bf16 before it
is widened to float32 and accumulated.  The port builds that copy as
autograd leaves, one per layer (the per-layer leaves keep autograd from
summing a full stacked gradient for every layer), reads their bf16
gradients after each microbatch's backward and accumulates them in
float32, as the JAX step's scan does.

``TrainConfig.a2q`` turns on A2Q (``train.optimizer``): its penalty joins
the loss before the loss scale, so its gradient is unscaled with the
rest, and ``adamw_update`` projects after the step.  Both take the 2-D
leaves of the stacked parameter tree, as the JAX step does: of the
per-layer compute copy, the layers' vectors stacked back into their
(layers, width) leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.api import Model
from repro_torch.train import optimizer as O

__all__ = ["TrainConfig", "init_train_state", "make_train_step",
           "run_telemetry_tick"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: O.OptConfig = O.OptConfig()
    scaler: O.LossScaleConfig = O.LossScaleConfig(dynamic=True)
    microbatches: int = 1
    use_loss_scaling: bool = False
    # A2Q accumulator-aware weight-norm constraint (train.optimizer)
    a2q: O.A2QConfig | None = None


def init_train_state(model: Model, gen: torch.Generator, device,
                     train_cfg: TrainConfig) -> dict:
    params = model.init_params(gen, device)
    return {"params": params, "opt": O.init_opt_state(params),
            "scaler": O.init_scaler(train_cfg.scaler, device)}


def compute_copy(params: dict) -> dict:
    """The leaves the step differentiates: bf16 copies of the params of two
    or more dimensions (decided on the stacked shapes, as the JAX cast
    tree does), the rest as they are; the layer stack as a list of
    per-layer trees."""
    def leaf(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if p.dtype == torch.float32 and p.ndim >= 2:
            t = t.to(torch.bfloat16)
        return t.requires_grad_()

    out = {}
    for k, v in params.items():
        if k == "layers":
            n = O.tree_leaves(v)[0].shape[0]
            out[k] = [O.tree_map(lambda p, i=i: leaf(p, p[i]), v)
                      for i in range(n)]
        else:
            out[k] = O.tree_map(lambda p: leaf(p, p), v)
    return out


def _grads(compute: dict, params: dict) -> dict:
    """float32 gradients of ``compute``'s leaves, stacked like ``params``;
    a leaf without a gradient contributes zeros."""
    def g32(leaf):
        if leaf.grad is None:
            return torch.zeros(leaf.shape, dtype=torch.float32,
                               device=leaf.device)
        return leaf.grad.to(torch.float32)

    out = {}
    for k, v in params.items():
        if k == "layers":
            per = [O.tree_map(g32, c) for c in compute[k]]
            out[k] = O.tree_map(lambda *xs: torch.stack(xs), *per) \
                if per else {}
        else:
            out[k] = O.tree_map(g32, compute[k])
    return out


def stacked_2d(compute: dict) -> list:
    """The leaves of ``compute`` that are 2-D in the stacked parameter tree,
    in its sorted-key order: the per-layer vectors stacked back into
    (layers, width) leaves (differentiable), and the 2-D leaves outside the
    layers (the embedding).  The per-layer matrices are 3-D there."""
    out = []
    for k in sorted(compute):
        v = compute[k]
        if k != "layers":
            out += [x for x in O.tree_leaves(v) if x.ndim == 2]
        elif v:
            per = [O.tree_leaves(layer) for layer in v]
            out += [torch.stack([p[i] for p in per])
                    for i, x in enumerate(per[0]) if x.ndim == 1]
    return out


def make_train_step(model: Model, train_cfg: TrainConfig
                    ) -> Callable[[dict, dict], tuple[dict, dict]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state's
    tensors are updated in place."""
    cfg = model.cfg
    nmb = train_cfg.microbatches
    a2q = train_cfg.a2q

    def grads_of(compute, batch, scale):
        loss, _ = model.loss_fn(compute, batch, cfg)
        if a2q is not None and a2q.strength > 0:
            # before the loss scale: its gradient is unscaled with the rest
            loss = loss + O.a2q_penalty(stacked_2d(compute), a2q)
        (loss * scale).backward()
        return loss.detach()

    def microbatched_grads(params, batch, scale):
        compute = compute_copy(params)
        if nmb == 1:
            loss = grads_of(compute, batch, scale) * scale
            return loss, _grads(compute, params)
        mbs = {k: v.reshape(nmb, v.shape[0] // nmb, *v.shape[1:])
               for k, v in batch.items()}
        acc = O.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        acc_loss = torch.zeros((), dtype=torch.float32,
                               device=scale.device)
        for i in range(nmb):
            loss = grads_of(compute, {k: v[i] for k, v in mbs.items()},
                            scale)
            acc_loss = acc_loss + loss * scale
            g = _grads(compute, params)
            acc = O.tree_map(lambda a, b: a + b, acc, g)
            for leaf in O.tree_leaves(compute):
                leaf.grad = None
        inv = 1.0 / nmb
        return acc_loss * inv, O.tree_map(lambda g: g * inv, acc)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        scaler = state["scaler"]
        scale = scaler["scale"] if train_cfg.use_loss_scaling else \
            torch.ones((), dtype=torch.float32, device=scaler["scale"].device)
        loss, grads = microbatched_grads(state["params"], batch, scale)
        if train_cfg.use_loss_scaling:
            grads, scaler, skip = O.unscale_and_check(grads, scaler,
                                                      train_cfg.scaler)
            loss = loss / state["scaler"]["scale"]
        else:
            skip = torch.logical_not(O.all_finite(grads))
            grads = O.tree_map(
                lambda g: torch.where(skip, torch.zeros_like(g), g), grads)
        params, opt, stats = O.adamw_update(state["params"], grads,
                                            state["opt"], train_cfg.opt,
                                            skip=skip, a2q=a2q)
        new_state = {"params": params, "opt": opt, "scaler": scaler}
        metrics = {"loss": loss, "skipped": skip.to(torch.float32),
                   "loss_scale": scaler["scale"], **stats}
        return new_state, metrics

    return train_step


def run_telemetry_tick(controller, model: Model, state: dict, batch: dict, *,
                       step: int, gen: torch.Generator, seq_len: int,
                       global_batch: int):
    """One swamping-telemetry cadence tick (``repro_torch.telemetry``):
    probe every quantized GEMM's accumulators on the live params and batch
    (one forward without autograd, then K8 replays), feed the measurements
    to the closed-loop controller and, when it changed some ``m_acc``,
    return the re-planned model (the caller builds its train step anew).

    Returns ``(events, new_model_or_None)``.  The training numerics are
    untouched by the tick.  The JAX package's ``retune`` (re-warming the
    autotuner for the new widths) has no counterpart: the port's kernels
    take no tuned schedule.
    """
    from repro_torch.models.api import get_model
    from repro_torch.telemetry.controller import apply_schedule
    from repro_torch.telemetry.probe import probe_model_stats

    probes = probe_model_stats(model, state["params"], batch, gen=gen)
    events = controller.observe(step, probes)
    if not controller.dirty:
        return events, None
    new_cfg = apply_schedule(model.cfg, controller.policy,
                             controller.schedule(), seq_len=seq_len,
                             global_batch=global_batch)
    return events, get_model(new_cfg)
