"""``qdot``: a dense GEMM under a per-role accumulation plan.

Counterpart of ``repro.kernels.ops``: ``QDotConfig`` and the differentiable
``qdot``.  Its three GEMMs are the paper's Fig. 2 roles, each with its own
solver-assigned carry format:

* FWD, ``y = Q(x) @ Q(w)``: kernel E (``qmatmul_fused(...,
  return_quantized=True)``), which also emits the int8 codes of Q(x) and
  Q(w) as the saved residuals, when ``repr_fmt`` fits in 8 bits; kernel G
  with the raw operands saved when ``repr_fmt`` is None (the lm_head).
  Without a gradient to take (serving, ``torch.no_grad()``) the forward is
  G alone and saves nothing.
* BWD ``dx = Q(g) @ Q(w)^T`` and GRAD ``dw = Q(x)^T @ Q(g)``: one launch
  of kernel B (``qmatmul_bwd_pair``) per layer.

``QDotConfig(fused=False)`` is the unfused reference oracle, as in the JAX
package: ``y = out_fmt(Q(x) @ Q(w))`` with Q the standalone quantize
kernel K2 (``kernels.quantize``, ``quantize_op``) and the GEMM the chunked
kernel K3 (``kernels.qmatmul``, ``_mm``), the f32 outputs of K2 saved as
the residuals; the backward quantizes g once and runs
``dx = Q(g) @ Q(w)^T`` and ``dw = Q(x)^T @ Q(g)`` as two K3 calls.  It is
the fused path's function bit for bit, forward and both gradients, and
its kernels are written apart from G, E and B.

``out_fmt`` rounds the forward output to a consumer's format and is
straight-through in the backward.  dx and dw come back in the dtypes of x
and w, as the JAX package's casts round them (bf16 weights get bf16
gradients).

``rounding="sr"`` (fused only) rounds the carries of all three roles
stochastically.  Each role draws its own stream from one base seed
(``sr_role_seed``: ``cfg.sr_seed``, or ``qdot``'s ``sr_seed`` for one
call): E takes the FWD seed, B the BWD seed for dx and the GRAD seed for
dw, as the JAX package's kernels do.  G has no SR carry on the card yet
(ROADMAP [sr-rest]), so under SR a forward without a gradient to take
runs E and drops its codes (its C is the G call's, bitwise).

Telemetry: inside ``telemetry.capture.capture_gemms()`` every quantized
``qdot`` records its 2-D operands and config (the eager probe's replay
list).  A config with ``stats_tag`` (``obs.ingraph.tag_quant_plan``) runs
its backward through the stats variant of B (K9's kernel: the same dx and
dw, bitwise, plus the BWD and GRAD rows) and replays the forward on the
saved residuals through K8's kernel (the FWD row), and hands the three
device rows to the active in-graph collector (``obs.ingraph``) without a
host sync.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.policy import GEMMPrecision
from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
from repro_torch.kernels.common import ROUNDINGS, quantize_block, threefry2x32
from repro_torch.kernels.fused import as_sr_seed, qmatmul_fused
from repro_torch.kernels.qmatmul import qmatmul
from repro_torch.kernels.quantize import quantize
from repro_torch.quant.formats import FPFormat
from repro_torch.telemetry import capture as _capture

__all__ = ["QDotConfig", "qdot", "quantize_op", "sr_role_seed"]

# f32 grouping of the partial sum when a role accumulates wide (chunk 0):
# schedule only, the carry is not rounded
_WIDE_CHUNK = 128

# Threefry key salts deriving the three roles' SR streams from one base
# seed (the JAX package's)
_ROLE_SALT = {"fwd": 0x9E3779B1, "bwd": 0x85EBCA77, "grad": 0xC2B2AE3D}


def sr_role_seed(seed: int, role: str) -> int:
    """A role's SR seed from the base seed: the first word of
    ``threefry2x32(seed, salt, 0, 1)``, bitwise JAX's ``sr_role_seed``."""
    out, _ = threefry2x32(as_sr_seed(seed), _ROLE_SALT[role], 0, 1)
    return int(out)


@dataclass(frozen=True)
class QDotConfig:
    """Precision configuration of one logical dense layer.

    ``None`` for a role means ideal (wide) accumulation for that GEMM;
    ``repr_fmt=None`` disables operand quantization; ``fused=False`` runs
    the unfused oracle composition (K2 and K3, f32 residuals);
    ``out_fmt`` rounds the forward output to a consumer's representation
    format.  ``stats_tag`` turns on the in-graph telemetry of the backward
    (numerics untouched; fused path only so far); ``stats_axis``, the mesh
    axis to reduce the rows over, comes with the sharding slice and must
    be None.  ``rounding`` is the carries' rounding in all three roles,
    ``"rne"`` or ``"sr"`` (fused only); ``sr_seed`` the base seed the
    roles' SR streams derive from.
    """

    fwd: GEMMPrecision | None = None
    bwd: GEMMPrecision | None = None
    grad: GEMMPrecision | None = None
    repr_fmt: FPFormat | None = None
    fused: bool = True
    out_fmt: FPFormat | None = None
    stats_tag: str | None = None
    stats_axis: str | None = None
    rounding: str = "rne"
    sr_seed: int = 0

    def __post_init__(self):
        if self.stats_axis is not None:
            raise NotImplementedError(
                "stats_axis (a mesh-wide reduction of the stats rows) comes "
                "with the sharding slice (ROADMAP [dist])")
        if self.stats_tag is not None and not self.fused:
            raise NotImplementedError(
                "stats rows of the unfused oracle (K8 on its f32 residuals) "
                "are not ported yet (ROADMAP [sr-rest])")
        if self.rounding not in ROUNDINGS:
            raise ValueError(f"rounding must be one of {ROUNDINGS}, got "
                             f"{self.rounding!r}")

    @property
    def is_exact(self) -> bool:
        return (self.fwd is None and self.bwd is None and self.grad is None
                and self.repr_fmt is None and self.out_fmt is None)

    @property
    def packs(self) -> bool:
        """Whether the forward's residuals are int8 codes."""
        return (self.fused and self.repr_fmt is not None
                and self.repr_fmt.bits <= 8)


def _acc_params(p: GEMMPrecision | None) -> tuple[int, int, int]:
    """(e_acc, m_acc, chunk) of a role; chunk 0 means wide (the carry is
    not rounded and the chunk only groups the f32 partial)."""
    if p is None:
        return 8, 23, 0
    return p.e_acc, p.m_acc, p.chunk if p.chunk > 0 else 0


def _pair_chunks(cfg: QDotConfig) -> tuple[int, int]:
    """(grad_chunk, bwd_chunk): the backward pair's rounding cadences over
    T and over N."""
    _, _, bwd_chunk = _acc_params(cfg.bwd)
    _, _, grad_chunk = _acc_params(cfg.grad)
    return grad_chunk or _WIDE_CHUNK, bwd_chunk or _WIDE_CHUNK


def _fwd_kw(cfg: QDotConfig, seed: int) -> dict:
    """The forward's ``qmatmul_fused`` keywords under base seed ``seed``."""
    e_acc, m_acc, chunk = _acc_params(cfg.fwd)
    return dict(repr_fmt=cfg.repr_fmt, e_acc=e_acc, m_acc=m_acc,
                block_k=chunk or _WIDE_CHUNK, rounding=cfg.rounding,
                sr_seed=_role_seed(cfg, seed, "fwd"))


def _role_seed(cfg: QDotConfig, seed: int, role: str) -> int:
    return sr_role_seed(seed, role) if cfg.rounding == "sr" else 0


def _out(y: torch.Tensor, cfg: QDotConfig) -> torch.Tensor:
    if cfg.out_fmt is None:
        return y
    return quantize_block(y, cfg.out_fmt.e, cfg.out_fmt.m)


# ------------------------- unfused reference oracle -------------------------


def quantize_op(x: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """``x`` rounded to ``fmt`` as float32 by the standalone kernel K2."""
    return quantize(x, e=fmt.e, m=fmt.m)


def _maybe_q(x: torch.Tensor, fmt: FPFormat | None) -> torch.Tensor:
    return x if fmt is None else quantize_op(x, fmt)


def _mm(a: torch.Tensor, b: torch.Tensor,
        p: GEMMPrecision | None) -> torch.Tensor:
    """One role's GEMM through K3: the role's carry format and chunk; a
    wide role (None) is the (8, 23) carry at chunk 128."""
    e_acc, m_acc, chunk = _acc_params(p)
    return qmatmul(a, b, e_acc=e_acc, m_acc=m_acc,
                   block_k=chunk or _WIDE_CHUNK)


def _oracle_fwd(x2: torch.Tensor, w: torch.Tensor, cfg: QDotConfig):
    """(y, xq, wq): the oracle forward and its f32 residuals."""
    xq, wq = _maybe_q(x2, cfg.repr_fmt), _maybe_q(w, cfg.repr_fmt)
    return _maybe_q(_mm(xq, wq, cfg.fwd), cfg.out_fmt), xq, wq


class _QDot(torch.autograd.Function):
    """FWD through E (or G), BWD and GRAD through one B launch; the
    oracle through K2 and K3."""

    @staticmethod
    def forward(ctx, x2, w, cfg, seed):
        ctx.cfg = cfg
        ctx.seed = seed
        ctx.dtypes = (x2.dtype, w.dtype)
        if not cfg.fused:
            y, xq, wq = _oracle_fwd(x2, w, cfg)
            ctx.save_for_backward(xq, wq)
            return y
        if cfg.packs:
            y, xq, wq = qmatmul_fused(x2, w, return_quantized=True,
                                      **_fwd_kw(cfg, seed))
        elif cfg.repr_fmt is None:
            y, xq, wq = qmatmul_fused(x2, w, **_fwd_kw(cfg, seed)), x2, w
        else:
            raise NotImplementedError(
                f"residuals of a {cfg.repr_fmt} representation need more "
                "than 8 bits: f32 residuals are not ported")
        ctx.save_for_backward(xq, wq)
        return _out(y, cfg)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        cfg = ctx.cfg
        x_dtype, w_dtype = ctx.dtypes
        if not cfg.fused:
            # out_fmt is straight-through here too: g passes unscaled
            gq = _maybe_q(g.to(torch.float32), cfg.repr_fmt)
            dx = _mm(gq, wq.T, cfg.bwd)
            dw = _mm(xq.T, gq, cfg.grad)
            return dx.to(x_dtype), dw.to(w_dtype), None, None
        e_b, m_b, _ = _acc_params(cfg.bwd)
        e_g, m_g, _ = _acc_params(cfg.grad)
        grad_chunk, bwd_chunk = _pair_chunks(cfg)
        # out_fmt's rounding is straight-through: g passes unscaled
        kw = dict(repr_fmt=cfg.repr_fmt, bwd_acc=(e_b, m_b),
                  grad_acc=(e_g, m_g), bwd_chunk=bwd_chunk,
                  grad_chunk=grad_chunk, packed=cfg.packs,
                  quantize_g=cfg.repr_fmt is not None,
                  rounding=cfg.rounding,
                  sr_seed_bwd=_role_seed(cfg, ctx.seed, "bwd"),
                  sr_seed_grad=_role_seed(cfg, ctx.seed, "grad"))
        if cfg.stats_tag is None:
            dx, dw = qmatmul_bwd_pair(g.to(torch.float32), xq, wq, **kw)
        else:
            dx, dw, rows = qmatmul_bwd_pair(g.to(torch.float32), xq, wq,
                                            collect_stats=True, **kw)
            _emit_qdot_stats(cfg, xq, wq, rows, ctx.seed)
        return dx.to(x_dtype), dw.to(w_dtype), None, None


def _emit_qdot_stats(cfg: QDotConfig, xq, wq, pair_rows, seed: int) -> None:
    """The three roles' stats rows of one tagged backward, to the active
    in-graph collector: BWD and GRAD from the stats pair's rows, FWD from
    one K8 replay of the saved residuals (the forward itself stays G/E),
    under the forward's rounding and role seed.  Geometry as the eager
    probe's: accumulation length K / N / T, chunk the role's rounding
    cadence."""
    from repro_torch.obs.ingraph import dispatch_raw
    from repro_torch.telemetry.stats import stats_kw

    tag = cfg.stats_tag
    t, k = xq.shape
    n = wq.shape[1]
    if cfg.fwd is not None:
        _, raw = qmatmul_fused(xq, wq, repr_fmt=cfg.repr_fmt,
                               quantize_a=False, quantize_b=False,
                               a_packed=cfg.packs, b_packed=cfg.packs,
                               collect_stats=True, rounding=cfg.rounding,
                               sr_seed=_role_seed(cfg, seed, "fwd"),
                               **stats_kw(cfg.fwd))
        dispatch_raw(tag, "fwd", k, stats_kw(cfg.fwd)["block_k"],
                     cfg.fwd.m_acc, raw)
    for role, p, length, row in (("bwd", cfg.bwd, n, 0),
                                 ("grad", cfg.grad, t, 1)):
        if p is not None:
            dispatch_raw(tag, role, length, stats_kw(p)["block_k"], p.m_acc,
                         pair_rows[row])


def qdot(x: torch.Tensor, w: torch.Tensor, cfg: QDotConfig, *,
         sr_seed: int | None = None) -> torch.Tensor:
    """y[..., N] = x[..., K] @ w[K, N] with the plan's per-role
    accumulation; float32 out.  Differentiable in x and w.  ``sr_seed``
    overrides ``cfg.sr_seed`` for this call (SR only)."""
    if cfg.rounding == "sr" and not cfg.fused:
        raise ValueError("rounding='sr' requires cfg.fused=True")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    seed = as_sr_seed(cfg.sr_seed if sr_seed is None else sr_seed)
    if _capture.active() and not cfg.is_exact:
        # the telemetry probe replays each recorded GEMM through the stats
        # kernel at the roles' seeds of this one (repro_torch.telemetry.probe)
        _capture.record(x=x2, w=w, cfg=cfg, sr_seed=seed)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _QDot.apply(x2, w, cfg, seed)
    elif not cfg.fused:
        y = _oracle_fwd(x2, w, cfg)[0]
    elif cfg.rounding == "sr" and cfg.packs:
        # G carries no SR on the card yet: E's C is G's, bitwise
        y = _out(qmatmul_fused(x2, w, return_quantized=True,
                               **_fwd_kw(cfg, seed))[0], cfg)
    else:
        y = _out(qmatmul_fused(x2, w, **_fwd_kw(cfg, seed)), cfg)
    return y.reshape(*lead, w.shape[1])
