"""Schedule of the Hopper tile ``csrc/qgemm_sm90.cuh`` (E, K8, B and K9).

One thread block computes one ``TILE`` x ``TILE`` output tile with
``groups`` chunk groups of ``GROUP_THREADS`` threads; group g forms the
partials of chunks g, g + groups, ... and the groups fold into the carry
in chunk order.  More groups put more threads on a tile's long sum; they
change no output bit.  The groups come from the number of chunks of the
call, so the same shape always gets the same schedule.

The shared-memory sizes mirror ``qgemm_sm90.cuh`` (``stage_bytes``,
``ring_stages``, ``smem_bytes``); the kernels' ``*_smem`` entry points
report theirs, which the GPU tests hold against these.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["TILE", "KT", "GROUP_THREADS", "SMEM_LIMIT", "Schedule",
           "chunk_groups", "gemm_schedule", "emitq_schedule", "pair_schedule",
           "gemm_tile", "pair_tile", "pair_blocks"]

TILE = 64               # output rows and columns of a block
KT = 16                 # K values a pipeline step stages
GROUP_THREADS = 64      # threads of a chunk group (8 x 8 outputs each)
SMEM_LIMIT = 232448     # shared memory one block may use on the H100
_ELEM = {0: 4, 1: 2, 2: 1}   # operand kind (f32, bf16, int8 codes): bytes


def chunk_groups(n_chunks: int) -> int:
    """Chunk groups a block: one for a single chunk, two for two or three,
    four from four chunks on."""
    return 1 if n_chunks <= 1 else 2 if n_chunks <= 3 else 4


def _tiles(n: int) -> int:
    return -(-n // TILE)


def _chunks(k: int, chunk: int) -> int:
    return -(-k // chunk)


def stage_bytes(a_kind: int, b_kind: int) -> int:
    """One ring step: A's and B's raw KT x TILE tiles in their stored type."""
    return TILE * KT * (_ELEM[a_kind] + _ELEM[b_kind])


def ring_stages(stage: int) -> int:
    """Ring depth: a ring of at most 16 KiB a group, two steps at least."""
    return 4 if stage * 4 <= 16384 else 3 if stage * 3 <= 16384 else 2


def smem_bytes(stage: int, groups: int, stats: bool) -> int:
    """The carry tile (and the shadow carry's), then each group's two f32
    step buffers and ring."""
    group = 2 * KT * TILE * 4 + ring_stages(stage) * stage
    return (2 if stats else 1) * TILE * TILE * 4 + groups * group


@dataclass(frozen=True)
class Schedule:
    groups: int         # chunk groups a block
    stages: int         # ring depth
    smem: int           # dynamic shared memory a block, bytes
    blocks: int         # blocks of the launch (one output tile each)

    @property
    def threads(self) -> int:
        return self.groups * GROUP_THREADS


def gemm_schedule(m: int, n: int, k: int, chunk: int, a_kind: int,
                  b_kind: int, stats: bool = True) -> Schedule:
    """K8's launch for C[m, n] over k in chunks of ``chunk`` (without the
    shadow carry's tile when not ``stats``)."""
    stage = stage_bytes(a_kind, b_kind)
    g = chunk_groups(_chunks(k, chunk))
    return Schedule(g, ring_stages(stage), smem_bytes(stage, g, stats),
                    _tiles(m) * _tiles(n))


def emitq_schedule(m: int, n: int, k: int, chunk: int) -> Schedule:
    """E's GEMM launch: K8's grid without stats, on the bf16 scratches of
    Q(A) and Q(B) that E's pass writes."""
    return gemm_schedule(m, n, k, chunk, 1, 1, stats=False)


def gemm_tile(block: int, m: int, n: int) -> tuple[int, int]:
    """Origin (m0, n0) of K8's or E's block ``block`` (row-major over the
    grid's (y, x) = (m tiles, n tiles))."""
    return (block // _tiles(n)) * TILE, (block % _tiles(n)) * TILE


def pair_blocks(t: int, k: int, n: int) -> tuple[int, int]:
    """B's grid: (dx blocks, all blocks); the dx tiles come first."""
    dx = _tiles(t) * _tiles(k)
    return dx, dx + _tiles(k) * _tiles(n)


def pair_tile(block: int, t: int, k: int, n: int) -> tuple[str, int, int]:
    """(role, m0, n0) of B's block ``block``: dx [t, k] tiles, then dw
    [k, n] tiles."""
    dx, _ = pair_blocks(t, k, n)
    if block < dx:
        return "dx", (block // _tiles(k)) * TILE, (block % _tiles(k)) * TILE
    d = block - dx
    return "dw", (d // _tiles(n)) * TILE, (d % _tiles(n)) * TILE


def pair_schedule(t: int, k: int, n: int, bwd_chunk: int, grad_chunk: int,
                  x_kind: int, w_kind: int, g_kind: int,
                  stats: bool = False) -> Schedule:
    """B's launch (K9's with ``stats``, the same grid with the shadow
    carry's tile): dx sums N in ``bwd_chunk``s, dw sums T in
    ``grad_chunk``s; one block size for both roles, so the groups follow
    the longer role's chunk count, and one ring step holds either role's
    tiles (g f32, or bf16 when Q(g) is formed once first)."""
    stage = max(stage_bytes(g_kind, w_kind), stage_bytes(x_kind, g_kind))
    g = chunk_groups(max(_chunks(n, bwd_chunk), _chunks(t, grad_chunk)))
    return Schedule(g, ring_stages(stage), smem_bytes(stage, g, stats),
                    pair_blocks(t, k, n)[1])
