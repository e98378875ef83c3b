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

Data parallelism over a mesh (``make_train_step(..., dist=)``, JAX's
``Dist`` under ``ShardingRules``): the state holds this rank's FSDP
blocks of the float32 masters and of both moments (``param_specs``); the
step takes the global batch and runs this rank's rows of each
microbatch (the single device's microbatch i, split over the batch ranks
in rank order); the bf16 compute copy is gathered from the blocks (the
cast is elementwise, so it is the single device's copy); the backward
gives every rank the single device's whole bf16 gradients (``models.lm``,
``kernels.ops``: each rank's K-slice of dw, gathered).  From them every
rank forms the single device's float32 gradients one whole leaf at a
time (``block_grads``): the skip flag and the clip norm take each leaf
with the single device's ops, no collective needed, and the rank keeps
its block of it.  So every rank's losses, grad norms, params and moments
are the single device's, bit for bit, and a rank holds the whole bf16
gradients and one whole float32 leaf, never the whole float32 gradients
(under ``--microbatches`` the float32 accumulator stays whole).  The
model axis changes none of this: its ranks hold the same rows, each GEMM
splits its output columns over them (``kernels.ops``), and the backward's
K-slices run over every rank of the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.dist import LOCAL, Dist
from repro_torch.models.api import Model
from repro_torch.train import optimizer as O

__all__ = ["TrainConfig", "init_train_state", "make_train_step",
           "run_telemetry_tick", "param_specs", "whole_params",
           "check_model_axis"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: O.OptConfig = O.OptConfig()
    scaler: O.LossScaleConfig = O.LossScaleConfig(dynamic=True)
    microbatches: int = 1
    use_loss_scaling: bool = False
    # A2Q accumulator-aware weight-norm constraint (train.optimizer)
    a2q: O.A2QConfig | None = None


def param_specs(model: Model, dist: Dist) -> dict | None:
    """The training specs of the model's params over ``dist``'s mesh
    (``sharding.specs.build_param_specs`` of the shapes), None off a
    mesh."""
    if dist.mesh is None:
        return None
    from repro_torch.sharding.specs import ShardingRules, build_param_specs

    shapes = model.init_params(torch.Generator(), "meta")
    return build_param_specs(shapes, ShardingRules(dist.mesh))


def check_model_axis(cfg, n: int) -> None:
    """Refuse a MoE config under any mesh (its expert-parallel branch is
    not ported), and a model axis of ``n`` ranks that does not divide the
    KV heads, d_ff or the vocab (JAX's head and column splits)."""
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE under a mesh is not ported yet (ROADMAP [moe-ep]: "
            "moe_apply's expert-parallel branch)")
    if n <= 1:
        return
    for what, size in (("KV heads", cfg.n_kv_heads), ("d_ff", cfg.d_ff),
                       ("vocab", cfg.vocab_size)):
        if size % n:
            raise ValueError(f"a model axis of {n} ranks does not divide "
                             f"the {size} {what} of {cfg.name}")


def init_train_state(model: Model, gen: torch.Generator, device,
                     train_cfg: TrainConfig, dist: Dist = LOCAL) -> dict:
    """The seeded state; under a mesh each rank draws the single device's
    params and keeps its blocks."""
    params = model.init_params(gen, device)
    if dist.mesh is not None:
        from repro_torch.sharding.specs import local_shard

        params = local_shard(params, param_specs(model, dist), dist.mesh)
    return {"params": params, "opt": O.init_opt_state(params),
            "scaler": O.init_scaler(train_cfg.scaler, device)}


def whole_params(params: dict, dist: Dist, specs) -> dict:
    """The whole params from this rank's blocks (every rank gathers)."""
    if dist.mesh is None:
        return params
    from repro_torch.sharding.specs import tree_specs_map, unshard

    return tree_specs_map(lambda p, s: unshard(p, s, dist), params, specs)


def compute_copy(params: dict, dist: Dist = LOCAL, specs=None) -> dict:
    """The leaves the step differentiates: bf16 copies of the params of two
    or more dimensions (decided on the stacked shapes, as the JAX cast
    tree does), the rest as they are; the layer stack as a list of
    per-layer trees.  Under a mesh the copies are gathered from the
    blocks, cast first."""
    def leaf(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if p.dtype == torch.float32 and p.ndim >= 2:
            t = t.to(torch.bfloat16)
        return t.requires_grad_()

    if dist.mesh is not None:
        from repro_torch.sharding.specs import tree_specs_map, unshard

        params = tree_specs_map(
            lambda p, s: unshard(p.detach().to(torch.bfloat16)
                                 if p.ndim >= 2 else p.detach(), s, dist),
            params, specs)
    out = {}
    for k, v in params.items():
        if k == "layers":
            n = O.tree_leaves(v)[0].shape[0]
            out[k] = [O.tree_map(lambda p, i=i: leaf(p, p[i]), v)
                      for i in range(n)]
        else:
            out[k] = O.tree_map(lambda p: leaf(p, p), v)
    return out


def _grad_fns(compute: dict, params: dict) -> dict:
    """A tree stacked like ``params`` of functions that each build one
    float32 gradient of ``compute``'s leaves (whole, also under a mesh);
    a leaf without a gradient contributes zeros."""
    def g32(leaf):
        if leaf.grad is None:
            return torch.zeros(leaf.shape, dtype=torch.float32,
                               device=leaf.device)
        return leaf.grad.to(torch.float32)

    def stacked(xs):
        # the layers' gradients widened straight into the stacked leaf
        out = torch.zeros((len(xs), *xs[0].shape), dtype=torch.float32,
                          device=xs[0].device)
        for i, x in enumerate(xs):
            if x.grad is not None:
                out[i].copy_(x.grad)
        return out

    out = {}
    for k in params:
        if k == "layers":
            per = compute[k]
            out[k] = O.tree_map(lambda *xs: lambda: stacked(xs),
                                *per) if per else {}
        else:
            out[k] = O.tree_map(lambda x: lambda: g32(x), compute[k])
    return out


def _grads(compute: dict, params: dict) -> dict:
    """float32 gradients of ``compute``'s leaves, stacked like ``params``."""
    return O.tree_map(lambda f: f(), _grad_fns(compute, params))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def block_grads(fns: dict, specs: dict, mesh, *, unscale=None,
                zero_on_skip: bool = True):
    """This rank's FSDP blocks of the whole float32 gradients that ``fns``
    (``_grad_fns``'s tree) builds, one whole leaf at a time in
    ``global_norm``'s leaf order: each leaf divided by ``unscale`` (the
    loss scale) when given, checked for finiteness, its square added to
    the norm, cut to this rank's block and freed before the next.  So only
    one whole float32 leaf exists at a time, and the skip flag and clip
    norm are the single device's bits (a skipped step's zeroed gradients
    have norm +0.0).  Returns ``(blocks, skip, grad_norm)``."""
    from repro_torch.sharding.specs import shard

    blocks, finite, total = {}, None, 0
    for path, fn in _paths(fns):
        g = fn()
        if unscale is not None:
            g = g.to(torch.float32) / unscale
        f = torch.all(torch.isfinite(g))
        finite = f if finite is None else torch.logical_and(finite, f)
        total = total + torch.sum(torch.square(g.to(torch.float32)))
        spec = specs
        for k in path:
            spec = spec[k]
        node = blocks
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = shard(g, spec, mesh).clone(
            memory_format=torch.contiguous_format)
        del g
    skip = torch.logical_not(finite)
    gnorm = torch.sqrt(total)
    if zero_on_skip:
        gnorm = torch.where(skip, torch.zeros_like(gnorm), gnorm)
        blocks = O.tree_map(
            lambda b: torch.where(skip, torch.zeros_like(b), b), blocks)
    return blocks, skip, gnorm


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


def make_train_step(model: Model, train_cfg: TrainConfig,
                    dist: Dist = LOCAL
                    ) -> Callable[[dict, dict], tuple[dict, dict]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state's
    tensors are updated in place.  Under a mesh ``dist`` the state holds
    this rank's blocks and ``batch`` is the global batch (module
    docstring)."""
    cfg = model.cfg
    nmb = train_cfg.microbatches
    a2q = train_cfg.a2q
    specs = param_specs(model, dist)
    if dist.mesh is not None:
        check_model_axis(cfg, dist.mesh.axis_size("model"))
    # the MoE aux of the step's (last micro)batch, as JAX's loss_fn
    # reports it
    aux = {}

    def grads_of(compute, batch, scale):
        batch = {k: dist.local_rows(v) for k, v in batch.items()}
        loss, metrics = model.loss_fn(compute, batch, cfg, dist)
        if "aux" in metrics:
            aux["aux"] = metrics["aux"].detach()
        if a2q is not None and a2q.strength > 0:
            # before the loss scale: its gradient is unscaled with the rest
            loss = loss + O.a2q_penalty(stacked_2d(compute), a2q)
        (loss * scale).backward()
        return loss.detach()

    def microbatched_grads(params, batch, scale):
        """The loss and ``_grad_fns``'s tree of the step's whole float32
        gradients."""
        compute = compute_copy(params, dist, specs)
        if nmb == 1:
            loss = grads_of(compute, batch, scale) * scale
            return loss, _grad_fns(compute, params)
        mbs = {k: v.reshape(nmb, v.shape[0] // nmb, *v.shape[1:])
               for k, v in batch.items()}
        acc = None
        acc_loss = torch.zeros((), dtype=torch.float32,
                               device=scale.device)
        for i in range(nmb):
            loss = grads_of(compute, {k: v[i] for k, v in mbs.items()},
                            scale)
            acc_loss = acc_loss + loss * scale
            g = _grads(compute, params)
            if acc is None:     # whole shapes, also under a mesh
                acc = O.tree_map(torch.zeros_like, g)
            acc = O.tree_map(lambda a, b: a + b, acc, g)
            for leaf in O.tree_leaves(compute):
                leaf.grad = None
        inv = 1.0 / nmb
        return acc_loss * inv, O.tree_map(lambda a: lambda: a * inv, acc)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        scaler = state["scaler"]
        scale = scaler["scale"] if train_cfg.use_loss_scaling else \
            torch.ones((), dtype=torch.float32, device=scaler["scale"].device)
        loss, fns = microbatched_grads(state["params"], batch, scale)
        # fns holds the compute copy and its gradients (or the float32
        # accumulator): each branch drops it once the gradients are built
        gnorm = None
        if specs is not None:
            grads, skip, gnorm = block_grads(
                fns, specs, dist.mesh,
                unscale=scale if train_cfg.use_loss_scaling else None,
                zero_on_skip=(not train_cfg.use_loss_scaling
                              or train_cfg.scaler.dynamic))
            del fns
            if train_cfg.use_loss_scaling:
                if train_cfg.scaler.dynamic:
                    scaler = O.update_scaler(scaler, skip, train_cfg.scaler)
                loss = loss / state["scaler"]["scale"]
        elif train_cfg.use_loss_scaling:
            grads = O.tree_map(lambda f: f(), fns)
            del fns
            grads, scaler, skip = O.unscale_and_check(grads, scaler,
                                                      train_cfg.scaler)
            loss = loss / state["scaler"]["scale"]
        else:
            grads = O.tree_map(lambda f: f(), fns)
            del fns
            skip = torch.logical_not(O.all_finite(grads))
            grads = O.tree_map(
                lambda g: torch.where(skip, torch.zeros_like(g), g), grads)
        params, opt, stats = O.adamw_update(state["params"], grads,
                                            state["opt"], train_cfg.opt,
                                            skip=skip, a2q=a2q,
                                            grad_norm=gnorm)
        new_state = {"params": params, "opt": opt, "scaler": scaler}
        metrics = {"loss": loss, "skipped": skip.to(torch.float32),
                   "loss_scale": scaler["scale"], **stats, **aux}
        return new_state, metrics

    return train_step


def run_telemetry_tick(controller, model: Model, state: dict, batch: dict, *,
                       step: int, gen: torch.Generator, seq_len: int,
                       global_batch: int, dist: Dist = LOCAL):
    """One swamping-telemetry cadence tick (``repro_torch.telemetry``):
    probe every quantized GEMM's accumulators on the live params and batch
    (one forward without autograd, then K8 replays), feed the measurements
    to the closed-loop controller and, when it changed some ``m_acc``,
    return the re-planned model (the caller builds its train step anew).

    Returns ``(events, new_model_or_None)``.  The training numerics are
    untouched by the tick.  The JAX package's ``retune`` (re-warming the
    autotuner for the new widths) has no counterpart: the port's kernels
    take no tuned schedule.  Under a mesh ``dist`` every rank probes the
    whole params (gathered) and the global batch's lm_head operands
    (``probe_model_stats``), so every rank's probes and verdicts are the
    single device's.
    """
    from repro_torch.models.api import get_model
    from repro_torch.telemetry.controller import apply_schedule
    from repro_torch.telemetry.probe import probe_model_stats

    params = whole_params(state["params"], dist, param_specs(model, dist))
    probes = probe_model_stats(model, params, batch, gen=gen, dist=dist)
    events = controller.observe(step, probes)
    if not controller.dirty:
        return events, None
    new_cfg = apply_schedule(model.cfg, controller.policy,
                             controller.schedule(), seq_len=seq_len,
                             global_batch=global_batch)
    return events, get_model(new_cfg)
