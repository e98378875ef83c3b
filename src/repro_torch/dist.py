"""Ranks across processes: the groups, their collectives and the spawning
of ranks, for tensor-parallel serving and data-parallel training.

Counterpart of ``repro.models.layers.Dist``, ``repro.launch.mesh.
make_serve_mesh`` and ``repro.kernels.attention.psum_carry``.  The JAX
engine runs every shard in one process under ``shard_map``; here each
shard is a process (a rank) of a
``torch.distributed`` group, and the collectives are explicit calls:

* ``psum_carry``: the cross-rank merge of online-softmax carries, in
  JAX's order (an all-reduce MAX of m, the scale ``2^(m - m_g)``, an
  all-reduce SUM of o and of l);
* ``gather_cols``: a tiled all-gather on the last dim (pure movement);
* ``pmax``: an all-reduce MAX (the KV page scales);
* ``psum``: an all-reduce SUM (the int8 logit wire's int32 payloads).

Training over a mesh (``launch.mesh.Mesh``; ``Dist.mesh``) splits the
batch's rows over ``Dist.batch_axes`` and the params and moments over
``Dist.fsdp_axis`` (FSDP).  Its collectives name the axes they run over,
each on the mesh's subgroup: ``all_gather`` and ``gather_rows`` (rows in
rank order, the global batch's), ``all_to_all`` (an all-gather and a
slice: pure movement), ``cat_over`` (an all-gather concatenated on a
dim), ``psum`` (the gathered values summed in rank order, so every rank
holds the same bits) and ``pmax``; ``k_slice`` says which slice of a
contraction's K a rank's backward takes.

Backend rule (``serve_backend``): NCCL when every rank has a card of its
own, gloo when ranks share one (NCCL refuses two ranks on one device) and
on the CPU.  A failure is never retried on another backend.  Gloo's
all-reduce and all-gather take CUDA tensors in torch 2.11 (probed on the
H100 by ``chip_smoke.py``'s ``[tp]`` phase), staging them through host
memory themselves: pure movement, so exact.  Every group is made with a
timeout, so a rank
that falls out of lockstep fails its collective instead of hanging, and
``spawn`` joins its ranks within a deadline.
"""

from __future__ import annotations

import datetime
import os
import socket
import traceback
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as tdist

__all__ = ["Dist", "LOCAL", "serve_backend", "init_group", "init_mesh",
           "init_meshes",
           "psum_carry", "gather_cols", "gather_rows", "all_to_all", "pmax",
           "split_size", "k_slice", "cat_over",
           "psum", "all_gather", "spawn", "rank_device", "GROUP_TIMEOUT_S"]

# a collective that waits longer than this fails (a desync, a dead rank)
GROUP_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class Dist:
    """How the serve-path layer functions meet the other ranks.

    ``size == 1`` is the single-device engine (every collective is the
    identity); otherwise this process is rank ``rank`` of a group of
    ``size`` whose params are their output-dim slices
    (``sharding.specs.serve_param_specs``) and whose arena holds its
    KV-head slice.  ``logit_wire`` picks the unembed: ``"gather"`` (exact
    movement) or ``"int8"`` (``train.compression.compressed_psum``).

    Training: ``mesh`` (a ``launch.mesh.Mesh`` with its subgroups) splits
    the batch's rows over ``batch_axes`` (JAX's ``batch_spec``) and the
    params and AdamW moments over ``fsdp_axis``."""

    rank: int = 0
    size: int = 1
    group: Any = None
    logit_wire: str = "gather"
    mesh: Any = None
    batch_axes: tuple = ()
    fsdp_axis: str | None = None

    @property
    def sharded(self) -> bool:
        return self.size > 1

    @property
    def batch_split(self) -> bool:
        """Whether the batch's rows are split over ranks."""
        return self.mesh is not None and \
            self.mesh.axis_size(self.batch_axes) > 1

    @property
    def batch_size(self) -> int:
        return 1 if self.mesh is None else \
            self.mesh.axis_size(self.batch_axes)

    @property
    def batch_rank(self) -> int:
        return 0 if self.mesh is None else \
            self.mesh.axis_index(self.batch_axes)

    @property
    def replica_axes(self) -> tuple:
        """The mesh axes of more than one rank off the batch split (the
        model axis; a data axis that does not divide the batch): the ranks
        along them hold the same rows, and each GEMM splits its output
        columns, and its backward's K-slices, over them."""
        if self.mesh is None:
            return ()
        return tuple(a for a in self.mesh.axis_names
                     if a not in self.batch_axes and self.mesh.shape[a] > 1)

    @property
    def replica_size(self) -> int:
        return 1 if self.mesh is None else \
            self.mesh.axis_size(self.replica_axes)

    @property
    def replica_rank(self) -> int:
        return 0 if self.mesh is None else \
            self.mesh.axis_index(self.replica_axes)

    @property
    def mesh_split(self) -> bool:
        """Whether the GEMMs run on a mesh of more than one rank (their
        backward on K-slices over every rank)."""
        return self.batch_split or self.replica_size > 1

    @property
    def slice_axes(self) -> tuple:
        """Every split axis: the K-slices' (batch and replica axes)."""
        return tuple(self.batch_axes) + self.replica_axes

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch tensor (a contiguous block,
        in rank order)."""
        n = self.batch_size
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n} "
                             "ranks")
        per = x.shape[0] // n
        return x[self.batch_rank * per:(self.batch_rank + 1) * per]


LOCAL = Dist()


def serve_backend(device: torch.device, n_ranks: int) -> tuple[str, str]:
    """``(backend, rule)``: NCCL when every rank has a card of its own,
    gloo when ranks share one or run on the CPU."""
    if device.type != "cuda":
        return "gloo", "the CPU: gloo"
    cards = torch.cuda.device_count()
    if cards >= n_ranks:
        return "nccl", f"{n_ranks} ranks on {cards} cards, one each: nccl"
    return "gloo", (f"{n_ranks} ranks share {cards} card(s) (NCCL refuses "
                    f"two ranks on one device): gloo")


def init_group(rank: int, size: int, init_method: str, backend: str, *,
               timeout_s: float = GROUP_TIMEOUT_S,
               device: torch.device | None = None, **kw) -> Dist:
    """Join the process group (``tcp://localhost:<port>``) and return this
    rank's ``Dist``."""
    if backend == "nccl" and device is not None:
        torch.cuda.set_device(device)
    tdist.init_process_group(
        backend, init_method=init_method, world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return Dist(rank=rank, size=size, group=tdist.group.WORLD, **kw)


def init_mesh(rank: int, mesh_shape: dict, init_method: str, backend: str,
              *, batch_axes: tuple, fsdp_axis: str | None = "data",
              timeout_s: float = GROUP_TIMEOUT_S,
              device: torch.device | None = None) -> Dist:
    """Join the world group as rank ``rank`` of a training mesh of
    ``mesh_shape`` (axis -> size), make the subgroups its collectives run
    over (the batch axes, the FSDP axis), and return this rank's
    ``Dist``."""
    return init_meshes(rank, [(mesh_shape, batch_axes)], init_method,
                       backend, fsdp_axis=fsdp_axis, timeout_s=timeout_s,
                       device=device)[0]


def init_meshes(rank: int, meshes: list, init_method: str, backend: str, *,
                fsdp_axis: str | None = "data",
                timeout_s: float = GROUP_TIMEOUT_S,
                device: torch.device | None = None) -> list[Dist]:
    """``init_mesh`` for several meshes over the same ranks (``meshes``:
    (axis sizes, batch axes) pairs of one size): the world group joined
    once, each mesh's subgroups made in order (every rank passes the same
    list), one ``Dist`` each."""
    from repro_torch.launch.mesh import Mesh

    if backend == "nccl" and device is not None:
        torch.cuda.set_device(device)
    size = Mesh(dict(meshes[0][0])).size
    tdist.init_process_group(
        backend, init_method=init_method, world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    out = []
    for shape, batch_axes in meshes:
        mesh = Mesh(dict(shape), rank)
        if mesh.size != size:
            raise ValueError(f"meshes of {size} and {mesh.size} ranks")
        dist = Dist(mesh=mesh, batch_axes=tuple(batch_axes),
                    fsdp_axis=fsdp_axis)
        # the batch axes, FSDP's, each axis a param's storage splits over,
        # and the replica and slice axes of the GEMMs
        mesh.init_groups([tuple(batch_axes)]
                         + [(a,) for a in mesh.axis_names]
                         + [dist.replica_axes, dist.slice_axes])
        out.append(dist)
    return out


def _group(dist: Dist, axis):
    """(process group, ranks) of ``axis`` (the TP group when None)."""
    if axis is None:
        return dist.group, dist.size
    if dist.mesh is None:
        return None, 1
    return dist.mesh.group(axis), dist.mesh.axis_size(axis)


def _all_reduce(t: torch.Tensor, op, dist: Dist, axis=None) -> torch.Tensor:
    """All-reduce a fresh contiguous copy of ``t`` (``t`` is not touched)."""
    out = t.contiguous().clone()
    group, n = _group(dist, axis)
    if n > 1:
        tdist.all_reduce(out, op=op, group=group)
    return out


def pmax(x: torch.Tensor, dist: Dist, axis=None) -> torch.Tensor:
    """Elementwise max over the ranks (of mesh ``axis`` when given)."""
    return _all_reduce(x, tdist.ReduceOp.MAX, dist, axis)


def psum(x: torch.Tensor, dist: Dist, axis=None) -> torch.Tensor:
    """Elementwise sum over the ranks.  Over a mesh ``axis`` the ranks'
    values are gathered and summed in rank order, so every rank holds the
    same bits whatever the backend's reduction order."""
    if axis is None:
        return _all_reduce(x, tdist.ReduceOp.SUM, dist)
    parts = all_gather(x, dist, axis)
    out = parts[0].clone()
    for p in parts[1:]:
        out = out + p
    return out


def all_gather(x: torch.Tensor, dist: Dist, axis=None) -> list[torch.Tensor]:
    """Every rank's ``x``, in rank order (pure movement); over mesh
    ``axis`` when given, else the TP group."""
    x = x.contiguous()
    group, n = _group(dist, axis)
    if n == 1:
        return [x]
    parts = [torch.empty_like(x) for _ in range(n)]
    tdist.all_gather(parts, x, group=group)
    return parts


def gather_rows(x: torch.Tensor, dist: Dist) -> torch.Tensor:
    """The global batch's rows of a row-split tensor: every batch rank's
    ``x`` concatenated on dim 0 in rank order (pure movement)."""
    if not dist.batch_split:
        return x
    return torch.cat(all_gather(x, dist, dist.batch_axes), dim=0)


def all_to_all(x: torch.Tensor, dist: Dist, axis, split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """JAX's ``all_to_all`` over mesh ``axis``: ``x`` split in equal blocks
    on ``split_dim``, block q to rank q, the received blocks concatenated
    on ``cat_dim`` in rank order.  Built from an all-gather and slicing
    (gloo takes all-gathers of CUDA tensors): pure movement."""
    n = dist.mesh.axis_size(axis) if dist.mesh is not None else 1
    if n == 1:
        return x
    me = dist.mesh.axis_index(axis)
    size = x.shape[split_dim] // n
    parts = all_gather(x, dist, axis)
    return torch.cat([p.narrow(split_dim, me * size, size) for p in parts],
                     dim=cat_dim)


def split_size(n: int, parts: int, what: str) -> int:
    """``n`` over ``parts`` ranks; raises naming ``what`` where it does not
    split evenly."""
    if n % parts:
        raise ValueError(f"{what} = {n} does not split over {parts} ranks")
    return n // parts


def k_slice(k: int, dist: Dist) -> tuple[int, int, int]:
    """(replica block's first column, slice's first column, slice width) of
    this rank's slice of K: K in replica blocks over the replica axes, each
    block in slices over the batch axes."""
    per = split_size(k, dist.replica_size, "K")
    width = split_size(per, dist.batch_size, "K")
    r0 = dist.replica_rank * per
    return r0, r0 + dist.batch_rank * width, width


def cat_over(x: torch.Tensor, dist: Dist, axes, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along mesh ``axes``, concatenated on ``dim`` in
    rank order (pure movement); ``x`` itself along axes of one rank."""
    if dist.mesh is None or dist.mesh.axis_size(axes) == 1:
        return x
    return torch.cat(all_gather(x, dist, axes), dim=dim)


def gather_cols(y: torch.Tensor, dist: Dist) -> torch.Tensor:
    """Concatenate an output-dim-split result over the ranks on its last
    dim: JAX's tiled ``all_gather``.  Pure movement: bitwise the unsplit
    GEMM wherever each output column's sum does not depend on the split."""
    if not dist.sharded:
        return y
    return torch.cat(all_gather(y, dist), dim=-1)


def psum_carry(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
               dist: Dist):
    """Merge the ranks' online-softmax carries: ``o`` (..., dh), ``m``/``l``
    (...).  The global max ``m_g`` stays on the integer lattice, so each
    rescale ``2^(m - m_g)`` is an exact power of two and the merge rounds
    no carry mantissa.  With one owner a (row, head) and the neutral
    ``(0, NEG, 0)`` on the others, the owner's scale is 1, a non-owner's
    ``2^(NEG - m_g)`` underflows to +0, and the sums add exact zeros: the
    merged carry is the owner's (an owner's -0.0 becomes +0.0, as under
    JAX's psum)."""
    m_g = pmax(m, dist)
    alpha = torch.exp2(m - m_g)
    o = psum(o * alpha[..., None], dist)
    l = psum(l * alpha, dist)
    return o, m_g, l


# --------------------------------------------------------------------------
# spawning the ranks
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, size, init_method, args, queue):
    # gloo connects the ranks over the loopback device (the address is
    # localhost; the host's name may resolve to no reachable interface)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        queue.put((rank, True, fn(rank, size, init_method, *args)))
    except Exception:  # noqa: BLE001 -- the rank's failure, reported
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def spawn(fn: Callable, n_ranks: int, args: tuple = (), *,
          timeout_s: float = 900.0) -> list:
    """Run ``fn(rank, n_ranks, init_method, *args)`` in ``n_ranks`` fresh
    processes (``spawn`` start method) and return their results in rank
    order.  ``init_method`` is a ``tcp://localhost`` address for
    ``init_group``.  A rank that raises fails the call with its traceback;
    ranks still running after ``timeout_s`` are killed and the call fails,
    so a desync never blocks the caller."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    ctx = mp.get_context("spawn")
    results_q = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, n_ranks, init_method, args, results_q),
                         daemon=False)
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    results: dict[int, Any] = {}
    errors: list[str] = []
    try:
        while len(results) + len(errors) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{n_ranks - len(results) - len(errors)} of {n_ranks} "
                    f"ranks did not finish within {timeout_s:.0f} s")
            try:
                rank, ok, val = results_q.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                # a rank that died without reporting (killed, out of memory)
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"ranks {dead} exited with codes "
                        f"{[procs[r].exitcode for r in dead]}") from None
                continue
            if ok:
                results[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
                break
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=max(1.0, min(30.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results_q.close()
    return [results[r] for r in range(n_ranks)]


def rank_device(rank: int, device: torch.device) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % cards)``, or the CPU."""
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())
