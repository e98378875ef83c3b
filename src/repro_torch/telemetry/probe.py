"""Model-level telemetry probe: measure swamping on live operands.

Counterpart of ``repro.telemetry.probe``.  ``probe_model_stats`` runs one
forward pass of the model (no autograd) inside ``capture.capture_gemms()``
and replays each recorded GEMM through K8's kernel for the three
back-propagation roles:

* **FWD**  Q(x) @ Q(w), the captured operands;
* **BWD**  Q(g) @ Q(w)^T over the fan-out (accumulation length N);
* **GRAD** Q(x)^T @ Q(g) over the tokens (the paper's long accumulation),

with a unit-variance synthetic gradient g ~ N(0, 1) (the paper's VRR model
is an i.i.d. Gaussian-product one; true gradients are the in-graph
telemetry's, ``repro_torch.obs.ingraph``).

Records are attributed to their QuantPlan field by config; layers sharing a
field merge their windows.  The captured set is the JAX package's: the
layer loop does not record (``models.lm.forward_hidden``), so the lm_head
is captured and every layer GEMM is probed on synthetic unit-Gaussian
operands at the geometry ``dense_gemm_shapes`` reports for it, which gives
every plan field a verdict.

An SR config is replayed with SR carries at the per-role seeds its
training kernels derive (``kernels.ops.sr_role_seed`` of the recorded
seed, or of the config's own for the synthetic fallback), so the probe
measures the jitter the model trains in; each probe carries the config's
``rounding``, which picks the controller's knee statistic.

Random draws go through ``_normal`` (one ``torch.Generator``): the same
seed gives other draws than the JAX package's ``jax.random`` keys (ROADMAP
F5); the parity tests replace ``_normal`` to feed both the same arrays.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.kernels.common import quantize_block
from repro_torch.telemetry import capture
from repro_torch.telemetry.controller import PLAN_FIELDS, GemmProbe
from repro_torch.telemetry.stats import gemm_stats

__all__ = ["probe_model_stats", "probe_gemm", "role_operands"]

# dense_gemm_shapes tag -> QuantPlan field (for the synthetic fallback)
_TAG_FIELD = {
    "attn_q": "attn_qkv", "attn_k": "attn_qkv", "attn_v": "attn_qkv",
    "attn_out": "attn_out", "mlp_gate": "mlp_up", "mlp_up": "mlp_up",
    "mlp_down": "mlp_down", "lm_head": "lm_head",
}


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    """One N(0, 1) float32 draw on ``gen``'s device."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def _plan_field(plan, qcfg) -> str | None:
    """The QuantPlan field a captured QDotConfig came from (out_fmt
    ignored, as the JAX package's)."""
    anon = replace(qcfg, out_fmt=None)
    for name in PLAN_FIELDS:
        f = getattr(plan, name, None)
        if f is not None and replace(f, out_fmt=None) == anon:
            return name
    return None


def _chunk(p) -> int:
    return p.chunk if (p is not None and p.chunk > 0) else 128


def _q(x: torch.Tensor, fmt) -> torch.Tensor:
    x32 = x.to(torch.float32)
    return x32 if fmt is None else quantize_block(x32, fmt.e, fmt.m)


def role_operands(x: torch.Tensor, w: torch.Tensor, qcfg,
                  g: torch.Tensor | None) -> dict[str, tuple]:
    """The K8 call ``probe_gemm`` makes for each role of x[T, K] @ w[K, N]
    with the synthetic gradient g[T, N] (None: no backward role):
    ``{role: (a, b, precision, flags, n)}``, ``flags`` the per-operand
    ``quantize_a``/``quantize_b`` and ``n`` the accumulation length."""
    t, k = x.shape
    n = w.shape[1]
    out: dict[str, tuple] = {}
    if qcfg.fwd is not None:
        out["fwd"] = (x, w, qcfg.fwd, {}, k)
    if g is None:
        return out
    if qcfg.repr_fmt is not None:
        xq, wq = _q(x, qcfg.repr_fmt), _q(w, qcfg.repr_fmt)
    else:
        xq, wq = x, w
    if qcfg.bwd is not None:
        out["bwd"] = (g, wq.T, qcfg.bwd, dict(quantize_b=False), n)
    if qcfg.grad is not None:
        out["grad"] = (xq.T, g, qcfg.grad, dict(quantize_a=False), t)
    return out


def probe_gemm(x: torch.Tensor, w: torch.Tensor, qcfg, *,
               gen: torch.Generator, sr_seed: int | None = None
               ) -> dict[str, GemmProbe]:
    """Stats for all three roles of one dense GEMM x[T, K] @ w[K, N];
    under SR at the role seeds of ``sr_seed`` (default the config's)."""
    from repro_torch.kernels.ops import sr_role_seed

    rnd = qcfg.rounding
    base = qcfg.sr_seed if sr_seed is None else sr_seed
    g = (None if qcfg.bwd is None and qcfg.grad is None
         else _normal(gen, (x.shape[0], w.shape[1])))
    out: dict[str, GemmProbe] = {}
    for role, (a, b, p, flags, n) in role_operands(x, w, qcfg, g).items():
        seed = sr_role_seed(base, role) if rnd == "sr" else 0
        _, st = gemm_stats(a, b, precision=p, repr_fmt=qcfg.repr_fmt,
                           rounding=rnd, sr_seed=seed, **flags)
        out[role] = GemmProbe(stats=st, n=n, n1=_chunk(p), m_acc=p.m_acc,
                              rounding=rnd)
    return out


def probe_model_stats(model, params, batch, *, gen: torch.Generator
                      ) -> dict[tuple[str, str], GemmProbe]:
    """One telemetry tick: capture the quantized GEMMs of a forward pass
    and measure their three accumulators.  Returns ``{(plan_field, role):
    GemmProbe}`` with same-field GEMMs merged.  ``gen`` (a generator on the
    params' device) draws the synthetic gradients and operands."""
    cfg = model.cfg
    with torch.no_grad(), capture.capture_gemms() as buf:
        model.loss_fn(params, batch, cfg)

    probes: dict[tuple[str, str], GemmProbe] = {}

    def ingest(name, x, w, qcfg, sr_seed=None):
        with torch.no_grad():
            found = probe_gemm(x, w, qcfg, gen=gen, sr_seed=sr_seed)
        for role, p in found.items():
            prev = probes.get((name, role))
            if prev is None:
                probes[(name, role)] = p
            else:
                # one plan field, one precision assignment: merge the
                # ensembles, keep the longest accumulation
                probes[(name, role)] = GemmProbe(
                    stats=prev.stats.merge(p.stats),
                    n=max(prev.n, p.n), n1=prev.n1, m_acc=prev.m_acc,
                    rounding=prev.rounding)

    for rec in buf:
        name = _plan_field(cfg.quant, rec["cfg"])
        if name is not None:
            ingest(name, rec["x"], rec["w"], rec["cfg"], rec.get("sr_seed"))

    # synthetic fallback for the plan fields the forward did not record
    from repro_torch.models.api import dense_gemm_shapes

    seen = {name for name, _ in probes}
    gb, sl = batch["tokens"].shape[0], batch["tokens"].shape[1]
    for tag, t, k, n, qcfg in dense_gemm_shapes(cfg, seq_len=sl,
                                                global_batch=gb):
        name = _TAG_FIELD.get(tag)
        if name is None or name in seen:
            continue
        ingest(name, _normal(gen, (t, k)), _normal(gen, (k, n)), qcfg)
    return probes
