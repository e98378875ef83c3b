"""``qdot``: a dense GEMM under a per-role accumulation plan.

Counterpart of ``repro.kernels.ops``: ``QDotConfig`` and the differentiable
``qdot``.  Its three GEMMs are the paper's Fig. 2 roles, each with its own
solver-assigned carry format:

* FWD, ``y = Q(x) @ Q(w)``: kernel E (``qmatmul_fused(...,
  return_quantized=True)``), which also emits Q(x) and Q(w) as the saved
  residuals: int8 codes when ``repr_fmt`` fits in 8 bits
  (``QDotConfig.packs``), else float32 (a wider ``repr_fmt``, or
  ``pack_residuals=False``); kernel G with the raw operands saved when
  ``repr_fmt`` is None (the lm_head).  Without a gradient to take
  (serving, ``torch.no_grad()``) the forward is G alone and saves
  nothing; ``qdot_packed`` returns its output as int8 codes.
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

``out_fmt`` rounds the forward output to a consumer's format in the
kernel's epilogue (G's or E's; the oracle's K2) and is straight-through
in the backward.  dx and dw come back in the dtypes of x
and w, as the JAX package's casts round them (bf16 weights get bf16
gradients).

``rounding="sr"`` (fused only) rounds the carries of all three roles
stochastically.  Each role draws its own stream from one base seed
(``sr_role_seed``: ``cfg.sr_seed``, or ``qdot``'s ``sr_seed`` for one
call): E and G take the FWD seed, B the BWD seed for dx and the GRAD seed
for dw, as the JAX package's kernels do.

Telemetry: inside ``telemetry.capture.capture_gemms()`` every quantized
``qdot`` records its 2-D operands and config (the eager probe's replay
list).  A config with ``stats_tag`` (``obs.ingraph.tag_quant_plan``) runs
its backward through the stats variant of B (K9's kernel: the same dx and
dw, bitwise, plus the BWD and GRAD rows) and replays the forward on the
saved residuals through K8's kernel (the FWD row), and hands the three
device rows to the active in-graph collector (``obs.ingraph``) without a
host sync.  A tagged oracle (``fused=False``) replays all three roles
through K8's kernel on its f32 residuals and g, as the JAX package does.

Under a mesh (``qdot(..., dist=)`` with ``dist.mesh_split``) the port
splits outputs, never a contraction (a split contraction would sum
partial sums in another order).  FWD runs on the rank's rows (the batch
axes split them) and, over the replica axes (the model axis; ranks that
hold the same rows), on the rank's block of w's columns, the blocks
gathered after it: every element is the single device's, and under SR
its dither keys on its place in the whole output (``row0``, ``col0``,
``n_cols``).  The backward runs on K-slices over every rank: g is
gathered over the batch ranks in row order, each rank receives the
residuals of every row for its slice of K's columns (an all-to-all over
the batch axes inside its replica block of K), and one B launch on that
K-slice gives ``dx[:, ks]`` for every row and ``dw[ks, :]``, each element
the single device's chunked sum in its order (``k_offset``/``k_total``
key SR there).  dx returns to the rows' owners (an all-to-all, then the
replica blocks gathered) and dw's K-slices are gathered, so every rank
holds the single device's dw bit for bit.  The oracle splits alike (K2
and K3 on the same blocks).  A tagged backward reduces each stats row
over the axes its role's work is split over (``_psum_row``, JAX's
``_emit_stats_row``); every rank keeps the global row, since each rank's
controller must reach the same verdicts.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.policy import GEMMPrecision
from repro_torch.dist import (LOCAL, Dist, all_gather, all_to_all, cat_over,
                              gather_rows, k_slice, split_size)
from repro_torch.kernels.bwd_pair import qmatmul_bwd_pair
from repro_torch.kernels.common import ROUNDINGS, threefry2x32
from repro_torch.kernels.fused import as_sr_seed, qmatmul_fused
from repro_torch.kernels.qmatmul import qmatmul
from repro_torch.kernels.quantize import quantize
from repro_torch.quant.formats import FPFormat
from repro_torch.quant.qtensor import QTensor
from repro_torch.telemetry import capture as _capture

__all__ = ["QDotConfig", "qdot", "qdot_packed", "quantize_op",
           "sr_role_seed"]

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
    ``pack_residuals`` carries the fused forward's residuals as int8 codes
    where ``repr_fmt`` fits in 8 bits (float32 otherwise, e.g. (1,6,9));
    ``out_fmt`` rounds the forward output to a consumer's representation
    format.  ``stats_tag`` turns on the in-graph telemetry of the backward
    (numerics untouched; under a mesh each role's rows reduce over the
    axes its work is split over, ``_emit_qdot_stats``).
    ``rounding`` is the carries' rounding in all three roles,
    ``"rne"`` or ``"sr"`` (fused only); ``sr_seed`` the base seed the
    roles' SR streams derive from.
    """

    fwd: GEMMPrecision | None = None
    bwd: GEMMPrecision | None = None
    grad: GEMMPrecision | None = None
    repr_fmt: FPFormat | None = None
    fused: bool = True
    pack_residuals: bool = True
    out_fmt: FPFormat | None = None
    stats_tag: str | None = None
    rounding: str = "rne"
    sr_seed: int = 0

    def __post_init__(self):
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
        return (self.fused and self.pack_residuals
                and self.repr_fmt is not None and self.repr_fmt.bits <= 8)


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
    """The forward's ``qmatmul_fused`` keywords under base seed ``seed``,
    the output format included."""
    e_acc, m_acc, chunk = _acc_params(cfg.fwd)
    return dict(repr_fmt=cfg.repr_fmt, e_acc=e_acc, m_acc=m_acc,
                block_k=chunk or _WIDE_CHUNK, out_fmt=cfg.out_fmt,
                rounding=cfg.rounding, sr_seed=_role_seed(cfg, seed, "fwd"))


def _role_seed(cfg: QDotConfig, seed: int, role: str) -> int:
    return sr_role_seed(seed, role) if cfg.rounding == "sr" else 0


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
    oracle through K2 and K3; under a mesh, ``_mesh_forward`` and
    ``_mesh_backward``."""

    @staticmethod
    def forward(ctx, x2, w, cfg, seed, dist):
        ctx.cfg = cfg
        ctx.seed = seed
        ctx.dist = dist
        ctx.dtypes = (x2.dtype, w.dtype)
        if dist.mesh_split:
            y, xq, wq, ctx.w_whole = _mesh_forward(x2, w, cfg, seed, dist)
            ctx.save_for_backward(xq, wq)
            return y
        if not cfg.fused:
            y, xq, wq = _oracle_fwd(x2, w, cfg)
            ctx.save_for_backward(xq, wq)
            return y
        if cfg.repr_fmt is None:
            y, xq, wq = qmatmul_fused(x2, w, **_fwd_kw(cfg, seed)), x2, w
        else:
            y, xq, wq = qmatmul_fused(x2, w, return_quantized=True,
                                      pack_residuals=cfg.packs,
                                      **_fwd_kw(cfg, seed))
        ctx.save_for_backward(xq, wq)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.dist.mesh_split:
            return _mesh_backward(ctx, g)
        xq, wq = ctx.saved_tensors
        cfg = ctx.cfg
        x_dtype, w_dtype = ctx.dtypes
        if not cfg.fused:
            # out_fmt is straight-through here too: g passes unscaled
            g32 = g.to(torch.float32)
            gq = _maybe_q(g32, cfg.repr_fmt)
            dx = _mm(gq, wq.T, cfg.bwd)
            dw = _mm(xq.T, gq, cfg.grad)
            if cfg.stats_tag is not None:
                _emit_qdot_stats(cfg, xq, wq, None, ctx.seed, g=g32)
            return dx.to(x_dtype), dw.to(w_dtype), None, None, None
        kw = _pair_kw(cfg, ctx.seed)
        if cfg.stats_tag is None:
            dx, dw = qmatmul_bwd_pair(g.to(torch.float32), xq, wq, **kw)
        else:
            dx, dw, rows = qmatmul_bwd_pair(g.to(torch.float32), xq, wq,
                                            collect_stats=True, **kw)
            _emit_qdot_stats(cfg, xq, wq, rows, ctx.seed)
        return dx.to(x_dtype), dw.to(w_dtype), None, None, None


def _pair_kw(cfg: QDotConfig, seed: int) -> dict:
    """B's keywords under base seed ``seed``: the roles' carries, chunks
    and seeds.  ``out_fmt``'s rounding is straight-through: g passes
    unscaled."""
    e_b, m_b, _ = _acc_params(cfg.bwd)
    e_g, m_g, _ = _acc_params(cfg.grad)
    grad_chunk, bwd_chunk = _pair_chunks(cfg)
    return dict(repr_fmt=cfg.repr_fmt, bwd_acc=(e_b, m_b),
                grad_acc=(e_g, m_g), bwd_chunk=bwd_chunk,
                grad_chunk=grad_chunk, packed=cfg.packs,
                quantize_g=cfg.repr_fmt is not None, rounding=cfg.rounding,
                sr_seed_bwd=_role_seed(cfg, seed, "bwd"),
                sr_seed_grad=_role_seed(cfg, seed, "grad"))


def _mesh_forward(x2, w, cfg: QDotConfig, seed: int, dist: Dist):
    """(y, xq, wq, whole) of a qdot under a mesh: x2 holds this rank's
    rows, and each rank of the replica axes computes its block of the
    output columns (every output element the single device's: a column's
    sum over K does not depend on the split; under SR its dither keys on
    the whole output's row and column, ``row0``/``col0``/``n_cols``); the
    blocks are gathered, so every replica holds the rows' whole y.  The residuals are
    this rank's rows of Q(x) and its columns of Q(w) (the oracle's float32
    ones), or x and the whole w for the lm_head (``whole``)."""
    n = w.shape[1]
    width = split_size(n, dist.replica_size, "N")
    c0 = dist.replica_rank * width
    w_c = w if width == n else w[:, c0:c0 + width]
    if not cfg.fused:
        y, xq, wq = _oracle_fwd(x2, w_c, cfg)
    else:
        kw = dict(_fwd_kw(cfg, seed), row0=dist.batch_rank * x2.shape[0],
                  col0=c0, n_cols=n)
        if cfg.repr_fmt is None:
            y = qmatmul_fused(x2, w_c, **kw)
            return cat_over(y, dist, dist.replica_axes, 1), x2, w, True
        y, xq, wq = qmatmul_fused(x2, w_c, return_quantized=True,
                                  pack_residuals=cfg.packs, **kw)
    return cat_over(y, dist, dist.replica_axes, 1), xq, wq, width == n


def _mesh_backward(ctx, g):
    """BWD and GRAD of a qdot under a mesh: one B launch (two K3 calls for
    the oracle) on this rank's K-slice over every row of the batch (see
    the module docstring), at the slice's place in K under SR."""
    xq, wq = ctx.saved_tensors
    cfg, dist = ctx.cfg, ctx.dist
    x_dtype, w_dtype = ctx.dtypes
    baxes, raxes = dist.batch_axes, dist.replica_axes
    k = xq.shape[1]
    r0, k0, width = k_slice(k, dist)
    per = k // dist.replica_size
    if not ctx.w_whole:     # the whole Q(w): the replicas' columns
        wq = cat_over(wq, dist, raxes, 1)
    g_all = gather_rows(g.to(torch.float32), dist)
    x_cols = all_to_all(xq[:, r0:r0 + per], dist, baxes, split_dim=1,
                        cat_dim=0).contiguous()
    w_rows = wq[k0:k0 + width]
    stats = cfg.stats_tag is not None
    if cfg.fused:
        kw = dict(_pair_kw(cfg, ctx.seed), k_offset=k0, k_total=k)
        out = qmatmul_bwd_pair(g_all, x_cols, w_rows, collect_stats=stats,
                               **kw)
        dx_s, dw_s = out[0], out[1]
        if stats:
            _emit_qdot_stats(cfg, xq, wq, out[2], ctx.seed, dist=dist,
                             t=g_all.shape[0])
    else:
        gq = _maybe_q(g_all, cfg.repr_fmt)
        dx_s = _mm(gq, w_rows.T, cfg.bwd)
        dw_s = _mm(x_cols.T, gq, cfg.grad)
        if stats:
            _emit_qdot_stats(cfg, xq, wq, None, ctx.seed, g=g_all,
                             pair=(x_cols, w_rows), dist=dist,
                             t=g_all.shape[0])
    dx = all_to_all(dx_s.to(x_dtype), dist, baxes, split_dim=0, cat_dim=1)
    dx = cat_over(dx, dist, raxes, 1)
    dw = cat_over(torch.cat(all_gather(dw_s.to(w_dtype), dist, baxes),
                             dim=0), dist, raxes, 0)
    return dx, dw, None, None, None


def _emit_qdot_stats(cfg: QDotConfig, xq, wq, pair_rows, seed: int, *,
                     g=None, pair=None, dist: Dist = LOCAL,
                     t: int | None = None) -> None:
    """The three roles' stats rows of one tagged backward, to the active
    in-graph collector.  FWD is one K8 replay of the saved residuals (the
    forward itself stays G/E/K3), under the forward's rounding and role
    seed.  BWD and GRAD come from the stats pair's rows (``pair_rows``),
    or, without them (the oracle), from K8 replays of the same
    contractions on the f32 ``g``: (g, wq^T) with g quantized and (xq^T,
    g) with g quantized, the residuals taken as they are (the JAX
    package's branch without ``raw_pair``).  Geometry as the eager
    probe's: accumulation length K / N / T (``t``, the global tokens
    under a row split), chunk the role's rounding cadence.

    Under a mesh xq holds this rank's rows (and wq is whole): the FWD row
    is reduced over the batch axes, the replay keyed at the rows' place
    under SR.  The pair's rows, or the oracle's replays on this rank's
    K-slice (``pair``: the slice's x columns and w rows, g every row), are
    reduced over every split axis (``_psum_row``).  Every rank keeps the
    global rows (the reduction JAX's ``stats_axis`` names)."""
    from repro_torch.obs.ingraph import dispatch_raw
    from repro_torch.telemetry.stats import stats_kw

    tag = cfg.stats_tag
    t_loc, k = xq.shape
    t = t_loc if t is None else t
    n = wq.shape[1]
    quantize = cfg.repr_fmt is not None

    def replay(role, p, a, b, **kw):
        _, raw = qmatmul_fused(a, b, repr_fmt=cfg.repr_fmt,
                               collect_stats=True, rounding=cfg.rounding,
                               sr_seed=_role_seed(cfg, seed, role),
                               **kw, **stats_kw(p))
        return raw

    def merged(raw, axes):
        return _psum_row(raw, axes, dist) if dist.mesh_split else raw

    if cfg.fwd is not None:
        raw = replay("fwd", cfg.fwd, xq, wq, quantize_a=False,
                     quantize_b=False, a_packed=cfg.packs,
                     b_packed=cfg.packs, row0=dist.batch_rank * t_loc)
        dispatch_raw(tag, "fwd", k, stats_kw(cfg.fwd)["block_k"],
                     cfg.fwd.m_acc, merged(raw, dist.batch_axes))
    x_p, w_p = (xq, wq) if pair is None else pair
    for role, p, length, row in (("bwd", cfg.bwd, n, 0),
                                 ("grad", cfg.grad, t, 1)):
        if p is None:
            continue
        if pair_rows is not None:
            raw = pair_rows[row]
        elif role == "bwd":
            raw = replay(role, p, g, w_p.T, quantize_a=quantize,
                         quantize_b=False)
        else:
            raw = replay(role, p, x_p.T, g, quantize_a=False,
                         quantize_b=quantize)
        dispatch_raw(tag, role, length, stats_kw(p)["block_k"], p.m_acc,
                     merged(raw, dist.slice_axes))


def _psum_row(raw: torch.Tensor, axis, dist: Dist) -> torch.Tensor:
    """One stats row reduced over mesh ``axis``, on the row's device: the
    ranks' rows gathered and merged in rank order in float64 (slot-wise
    ``+``, ``max`` for MAX_ABS), the ensemble union that
    ``EnsembleStats.psum`` forms from the Welford moments (JAX's
    ``_emit_stats_row``), without their float32 round trip, so the sums
    stay within ``SUM_REL``/``SUM_ABS`` of the single device's."""
    from repro_torch.kernels.common import STAT_MAX_ABS

    rows = [r.reshape(-1).to(torch.float64)
            for r in all_gather(raw.reshape(-1), dist, axis)]
    out = rows[0].clone()
    for r in rows[1:]:
        out = out + r
    out[STAT_MAX_ABS] = torch.stack([r[STAT_MAX_ABS] for r in rows]).max()
    return out


def qdot(x: torch.Tensor, w: torch.Tensor, cfg: QDotConfig, *,
         sr_seed: int | None = None, dist: Dist = LOCAL) -> torch.Tensor:
    """y[..., N] = x[..., K] @ w[K, N] with the plan's per-role
    accumulation; float32 out.  Differentiable in x and w.  ``sr_seed``
    overrides ``cfg.sr_seed`` for this call (SR only).  Under ``dist``
    with a row split, x holds this rank's rows and the backward runs on
    K-slices (module docstring)."""
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
        y = _QDot.apply(x2, w, cfg, seed, dist)
    elif not cfg.fused:
        y = _oracle_fwd(x2, w, cfg)[0]
    else:
        # under a row split, at the rows' place in the batch (SR)
        y = qmatmul_fused(x2, w, row0=dist.batch_rank * x2.shape[0],
                          **_fwd_kw(cfg, seed))
    return y.reshape(*lead, w.shape[1])


def qdot_packed(x: torch.Tensor, w: torch.Tensor, cfg: QDotConfig, *,
                sr_seed: int | None = None) -> QTensor:
    """Inference-only ``qdot`` whose output leaves the kernel as int8 codes
    of ``cfg.out_fmt`` (G's ``pack_out`` epilogue: no f32 activation is
    written), the serve path's and the wire's carrier; with
    ``fused=False`` the oracle's forward (K2, K3, then K2 for
    ``out_fmt``), then ``QTensor.pack``.
    Not differentiable: training uses ``qdot``."""
    if cfg.out_fmt is None or cfg.out_fmt.bits > 8:
        raise ValueError("qdot_packed needs an out_fmt with <= 8 bits")
    if cfg.rounding == "sr" and not cfg.fused:
        raise ValueError("rounding='sr' requires cfg.fused=True")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not cfg.fused:
        # rounded by K2 as the oracle rounds out_fmt, then packed
        y = _oracle_fwd(x2, w, cfg)[0]
        return QTensor.pack(y.reshape(*lead, w.shape[1]), cfg.out_fmt,
                            assume_quantized=True)
    seed = as_sr_seed(cfg.sr_seed if sr_seed is None else sr_seed)
    codes = qmatmul_fused(x2, w, pack_out=True, **_fwd_kw(cfg, seed))
    return QTensor(codes.reshape(*lead, w.shape[1]), fmt=cfg.out_fmt)
