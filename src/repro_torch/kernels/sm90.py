"""Schedules of the Hopper GEMM kernels: the tile ``csrc/qgemm_sm90.cuh``
(E, K8, B, K9 and G's large route) and G's decode route (``csrc/qgemm.cu``).

One thread block computes one ``TILE`` x ``TILE`` output tile with
``groups`` chunk groups of ``GROUP_THREADS`` threads; group g forms the
partials of chunks g, g + groups, ... and the groups fold into the carry
in chunk order.  More groups put more threads on a tile's long sum; they
change no output bit.  The groups come from the number of chunks of the
call, so the same shape always gets the same schedule.

The shared-memory sizes mirror ``qgemm_sm90.cuh`` (``stage_bytes``,
``ring_stages``, ``smem_bytes``); the kernels' ``*_smem`` entry points
report theirs, which the GPU tests hold against these.

G (``g_schedule``) takes the decode route up to ``DECODE_MAX_M`` rows and
the tile above: ``decode_schedule`` gives a thread one chunk of V columns
(one 32-bit word of the weight's type) for a row group of 8 rows, a strip
of 32 V columns to a warp and ``slots`` chunks of a strip to a block, and
splits the chunks over ``slices`` blocks, at chunk boundaries, where the
strips alone leave the card short of warps; a split call's partials go to
a workspace that a fold kernel folds in chunk order.  Either route and any
split gives the same bits.  At qwen2-1.5b's shapes the workspace is at
most 6.9 MB at M = 8 and 27.5 MB at 32, inside the H100's 50 MB L2;
mlp_down's at a 64-row slab is 55 MB, past it, and the decode route still
beat the tile there (PERF.md, PR 17).

D and K12 (``csrc/paged_decode.cu``, ``attn_decode_schedule``) split the
page walk of each (sequence, KV head) over the ``cluster`` blocks of a
thread-block cluster: ``decode_cluster`` picks the cluster from the
batch, the KV heads and the page-table width alone (never from the
lengths, which live on the device); each rank takes a contiguous run of
at most ``rank_pages`` pages a round, worked out on the device from the
row's length.  Any cluster and any round size give the same bits.

P and K10 (``csrc/attn_prefill_sm90.cuh``, ``attn_prefill_schedule``)
give a block a tile of ``rows`` query rows of one KV head, all g of its
query heads, and split each tile's page walk over the ``cluster`` blocks
of a thread-block cluster, ``rank_pages`` pages a block a round: from the
rows, the KV heads, the head shape and the pages the longest tile walks,
all host-known.  Any tile, cluster and round size give the same bits.

The JAX package's autotuner (``repro.kernels.autotune``) has no module
here, on purpose: its choices are of Pallas blocks under a TPU's VMEM, and
the schedules above follow from the shapes alone (and never change a bit).
What of it a ported caller reaches lives elsewhere: ``AttnCall`` in
``kernels.attention`` (the serve plan's and the dense-prefill layers'
call), ``fmt_tuple`` in ``kernels.common``.  No counterpart, each on
purpose:

* ``register_kernel``/``get_kernel``/``registered_kernels``: a registry of
  Pallas entry points; each wrapper here is imported where it is used.
* ``vmem_budget``/``VMEM_PER_GENERATION``/``vmem_block_bytes``/
  ``attn_vmem_bytes``: TPU VMEM sizing; the shared-memory sizes here are
  ``smem_bytes``-style functions held against the kernels' ``*_smem``.
* ``candidate_blocks``/``time_kernel``/``autotune_qmatmul``/
  ``autotune_bwd_pair``/``autotune_flash_prefill``: a search over Pallas
  blocks; a Hopper kernel's schedule is picked from the shape here.
* ``TuningTable``/``get_table``/``set_table_path``/``blocks_for``/
  ``pair_blocks_for``/``attn_blocks_for``: the table of that search's
  winners, consulted at trace time; nothing here has a block to look up.
* ``operand_dtype``: a table key's part.
* ``train.loop.warmup_gemm_autotune`` and the in-graph tick's re-tune
  after a re-plan: they fill that table; a re-planned model here needs no
  new schedule.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

__all__ = ["TILE", "KT", "GROUP_THREADS", "SMEM_LIMIT", "Schedule",
           "chunk_groups", "gemm_schedule", "emitq_schedule", "pair_schedule",
           "gemm_tile", "pair_tile", "pair_blocks", "DECODE_MAX_M",
           "DecodeSchedule", "decode_schedule", "decode_smem", "decode_ws",
           "g_schedule", "ATTN_THREADS", "ATTN_CLUSTER_MAX", "ATTN_RANK_PAGES",
           "ATTN_SMEM_BUDGET",
           "AttnDecodeSchedule", "decode_cluster", "attn_decode_smem",
           "attn_decode_schedule", "PREFILL_THREADS", "PREFILL_PIECE",
           "PREFILL_ROWS", "PREFILL_RANK_PAGES", "AttnPrefillSchedule",
           "attn_prefill_smem", "prefill_pages", "attn_prefill_schedule"]

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


def emitq_schedule(m: int, n: int, k: int, chunk: int,
                   f32: bool = False) -> Schedule:
    """E's GEMM launch: K8's grid without stats, on the bf16 scratches of
    Q(A) and Q(B) that E's pass writes (on f32 ones, or on the f32
    residuals, with ``f32``)."""
    kind = 0 if f32 else 1
    return gemm_schedule(m, n, k, chunk, kind, kind, stats=False)


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


# ------------------------------------------------------- G's decode route

# G takes the decode route up to this many rows, and up to twice as many
# where the tile would have fewer output tiles than the card has SMs: on
# the H100 it is at least as fast as the tile at every qwen2-1.5b shape up
# to M = 32, and at M = 64 faster on attn_* and mlp_down (24 and 4 tiles)
# but slower on mlp_gate/up (140) and the lm_head (2374) (chip_smoke.py's
# per-shape G lines, PERF.md PR 17)
DECODE_MAX_M = 32
DECODE_ROWS = 8         # rows of A a block takes (its row group)
DECODE_LANES = 32       # threads across a strip (a warp), V columns each
DECODE_SLOTS = 8        # chunk slots (warps) a block, at most
SMS = 132               # the H100's SMs
DECODE_WARPS = 16 * SMS  # warps a decode grid should give the card


@dataclass(frozen=True)
class DecodeSchedule:
    slots: int          # chunk slots (warps) a block
    slices: int         # blocks along the chunks (1: no split, no workspace)
    strips: int         # blocks along N
    row_groups: int     # blocks along M (8 rows each)
    width: int          # columns of a strip
    ws_floats: int      # the workspace of a split call: chunks x M x N
    smem: int           # dynamic shared memory a block, bytes

    @property
    def threads(self) -> int:
        return self.slots * DECODE_LANES

    @property
    def blocks(self) -> int:
        return self.strips * self.slices * self.row_groups


def decode_smem(slots: int, chunk: int, width: int) -> int:
    """``csrc/qgemm.cu``'s ``decode_smem``: one region for a round's rows
    of A (slots chunks, 8 rows) or its partials (slots x 8 x width), then
    the carries (8 x width)."""
    return (slots * DECODE_ROWS * max(chunk, width)
            + DECODE_ROWS * width) * 4


def decode_ws(m: int, n: int, k: int, chunk: int, slices: int) -> int:
    """Workspace floats of a decode call (``qgemm_decode_ws``)."""
    return _chunks(k, chunk) * m * n if slices > 1 else 0


@functools.lru_cache(maxsize=4096)
def decode_schedule(m: int, n: int, k: int, chunk: int,
                    b_kind: int) -> DecodeSchedule | None:
    """G's decode launch for C[m, n] over k in chunks of ``chunk``, B of
    kind ``b_kind`` (0 f32, 1 bf16), or None where even one chunk slot
    overflows a block's shared memory (the tile takes that call).

    A warp takes one chunk of a strip.  Blocks hold up to DECODE_SLOTS
    slots; where the strips (times the row groups) with that many warps
    each give the card DECODE_WARPS warps, a block walks all chunks of its
    strip in rounds and nothing is split.  Otherwise the chunks are split
    at chunk boundaries over blocks of DECODE_SLOTS slots, a warp a chunk
    of every strip."""
    width = DECODE_LANES * (4 // _ELEM[b_kind])
    strips, groups = -(-n // width), -(-m // DECODE_ROWS)
    nc = _chunks(k, chunk)
    slots = max(1, min(DECODE_SLOTS, nc))
    while slots > 1 and decode_smem(slots, chunk, width) > SMEM_LIMIT:
        slots //= 2
    if decode_smem(slots, chunk, width) > SMEM_LIMIT:
        return None
    split = strips * groups * slots < DECODE_WARPS and nc > slots
    slices = -(-nc // slots) if split else 1
    return DecodeSchedule(slots, slices, strips, groups, width,
                          decode_ws(m, n, k, chunk, slices),
                          decode_smem(slots, chunk, width))


@functools.lru_cache(maxsize=4096)
def g_schedule(m: int, n: int, k: int, chunk: int, a_kind: int,
               b_kind: int) -> Schedule | DecodeSchedule:
    """G's launch: the decode route up to ``DECODE_MAX_M`` rows, or up to
    twice that where the tile's grid would leave SMs idle (where a
    block's shared memory holds it), else the tile over K8's grid without
    the shadow carry.  An operand of int8 codes (kind 2) takes the tile at
    every M: it lands and unpacks codes as K8 does, and the decode kernel
    reads float words only."""
    if 2 in (a_kind, b_kind):
        return gemm_schedule(m, n, k, chunk, a_kind, b_kind, stats=False)
    if m <= DECODE_MAX_M or (m <= 2 * DECODE_MAX_M
                             and _tiles(m) * _tiles(n) < SMS):
        sched = decode_schedule(m, n, k, chunk, b_kind)
        if sched is not None:
            return sched
    return gemm_schedule(m, n, k, chunk, a_kind, b_kind, stats=False)


# ------------------------------------------------ D's and K12's page walk

ATTN_THREADS = 256      # threads of a decode-attention block
ATTN_CLUSTER_MAX = 8    # blocks of a cluster, at most (the portable size)
ATTN_RANK_PAGES = 8     # pages a block holds a round, at most
# shared memory a block takes where it can, so that two blocks fit an SM
# (each also holds 1 KiB for the system and its static shared memory)
ATTN_SMEM_BUDGET = 112 * 1024


def _al4(n: int) -> int:
    return (n + 3) & ~3


@dataclass(frozen=True)
class AttnDecodeSchedule:
    cluster: int        # blocks a (sequence, KV head), one cluster
    rank_pages: int     # pages a block holds a round
    smem: int           # dynamic shared memory a block, bytes
    blocks: int         # blocks of the launch


def decode_cluster(b: int, kv: int, width: int) -> int:
    """Blocks a (sequence, KV head) of D and K12: the largest power of two
    up to ATTN_CLUSTER_MAX that keeps the grid within the card's SMs and
    no larger than the page-table width (a row has at most that many
    pages).  B 8 and KV 2 give 8 (128 blocks); the monitor's B 1 gives 8
    (16 blocks) from a width of 8 on."""
    cap = min(ATTN_CLUSTER_MAX, width, SMS // max(1, b * kv))
    cl = 1
    while cl * 2 <= cap:
        cl *= 2
    return cl


def attn_decode_smem(g: int, ps: int, dh: int, cluster: int,
                     rank_pages: int) -> int:
    """``csrc/paged_decode.cu``'s ``Layout``: q; the round's K values,
    whose region then takes the partials gathered for the fold; scores
    (then probabilities); the value partials; the published page maxima
    and l sums; the round's maxima, rescales and l sums of every rank; the
    m and l carries; the block's o carries and (K12) their f32 shadows;
    (K12) each thread's counters; the pages' scales and ids; then the K
    and V codes."""
    r, dp = rank_pages, _al4(dh)
    per_o = -(-g * dh // cluster)
    floats = (_al4(g * dp) + _al4(max(r * ps * (dp + 4), cluster * r * per_o))
              + _al4(r * g * ps) + _al4(r * g * dh) + 2 * _al4(r * g)
              + 3 * _al4(cluster * r * g) + _al4(2 * g) + 2 * _al4(per_o)
              + 3 * ATTN_THREADS + _al4(2 * r) + _al4(r))
    return floats * 4 + 2 * r * ((ps * dh + 15) & ~15)


@functools.lru_cache(maxsize=4096)
def attn_decode_schedule(b: int, kv: int, width: int, g: int, ps: int,
                         dh: int) -> AttnDecodeSchedule:
    """D's and K12's launch for B sequences, KV heads and a page table of
    ``width`` columns: the cluster, and pages a block a round enough for
    the widest row in one round, at most ATTN_RANK_PAGES and within
    ATTN_SMEM_BUDGET (a longer row takes rounds), so shared memory is
    bounded at any width.  Heads too wide for the budget at one page take
    one page a round in up to a block's whole shared memory."""
    cl = decode_cluster(b, kv, width)
    r = max(1, min(ATTN_RANK_PAGES, -(-width // cl)))
    while r > 1 and attn_decode_smem(g, ps, dh, cl, r) > ATTN_SMEM_BUDGET:
        r -= 1
    return AttnDecodeSchedule(cl, r, attn_decode_smem(g, ps, dh, cl, r),
                              b * kv * cl)


# ------------------------------------------------- P's and K10's page walk

PREFILL_THREADS = 256   # threads of a prefill block
PREFILL_PIECE = 32      # K tokens a block stages a step, at most
PREFILL_PV_PAGES = 4    # pages of p.v chains a thread runs at once
PREFILL_V_FLOATS = 4096  # a V piece's floats, at most, where pages fit
PREFILL_ROWS = 8        # query rows a tile, at most
PREFILL_RANK_PAGES = 8  # pages a block holds a round, at most


@dataclass(frozen=True)
class AttnPrefillSchedule:
    rows: int           # query rows a tile (a block serves its g heads)
    cluster: int        # blocks a tile, one cluster
    rank_pages: int     # pages a block holds a round
    smem: int           # dynamic shared memory a block, bytes
    blocks: int         # blocks of the launch


def _piece(ps: int) -> int:
    return (PREFILL_PIECE // ps) * ps if ps <= PREFILL_PIECE else PREFILL_PIECE


def _vpiece(ps: int, dsl: int) -> int:
    if ps > PREFILL_PIECE:
        return PREFILL_PIECE
    return max(1, min(PREFILL_PV_PAGES, PREFILL_V_FLOATS // (ps * dsl))) * ps


def attn_prefill_smem(g: int, rows: int, ps: int, dh: int, cluster: int,
                      rank_pages: int) -> int:
    """``csrc/attn_prefill_sm90.cuh``'s ``Layout``: the tile's q rows; a K
    piece; the block's scores (then probabilities) and, in a cluster, one
    other block's copied; a V piece (up to PREFILL_PV_PAGES pages) of the
    block's output columns; their p.v partials (pages longer than a piece
    only) and o carries; the published page maxima and l sums; the round's
    maxima, rescales and l sums; the m and l carries; the pages' ids and
    scales."""
    hr, dp = g * rows, _al4(dh)
    qst, dsl = dp + 4, _al4(-(-dh // cluster))
    sst = (_al4(rank_pages * ps) // 4 | 1) * 4
    cap, pl = cluster * rank_pages, _piece(ps)
    floats = (hr * qst + pl * qst + _al4(hr * sst)
              + (_al4(hr * sst) if cluster > 1 else 0) + _vpiece(ps, dsl) * dsl
              + (hr * dsl if ps > PREFILL_PIECE else 0) + hr * dsl
              + 2 * _al4(rank_pages * hr) + 3 * _al4(cap * hr) + _al4(2 * hr)
              + 3 * _al4(cap))
    return floats * 4


def prefill_pages(ps: int, q_offset: int, live_rows: int, kv_offset: int,
                  n_cols: int, first_page: int = 0) -> int:
    """Pages the walk of the last live row takes: from ``first_page`` up to
    that row's causal reach and the last column (the tile of that row
    walks the most)."""
    reach = q_offset + live_rows - 1 - kv_offset
    if live_rows < 1 or reach < 0:
        return 0
    return max(0, min(-(-n_cols // ps), reach // ps + 1) - first_page)


@functools.lru_cache(maxsize=4096)
def attn_prefill_schedule(t: int, kv: int, g: int, ps: int, dh: int,
                          n_pages: int) -> AttnPrefillSchedule:
    """P's and K10's launch for ``t`` query rows, KV heads of g query heads,
    pages (chunks) of ``ps`` tokens, head width ``dh``, and a longest walk
    of ``n_pages`` pages.  Rows a tile: PREFILL_ROWS, halved while the
    tiles times the largest cluster would leave more than half the SMs
    idle (short prompts).  The cluster: the largest power of two up to
    ATTN_CLUSTER_MAX and the pages that keeps the grid within four blocks
    an SM (more blocks than two an SM shorten the tail of a one-shot
    prompt, whose last tiles walk the most; PERF.md, PR 19).  Pages a block
    a round: enough for the walk in one round, at most PREFILL_RANK_PAGES
    and within ATTN_SMEM_BUDGET; where even one page overflows the budget,
    the tile's rows halve."""
    n_pages = max(1, n_pages)
    rows = PREFILL_ROWS
    while rows > 1 and 2 * kv * -(-t // rows) * min(
            ATTN_CLUSTER_MAX, n_pages) <= SMS:
        rows //= 2
    while True:
        tiles = kv * -(-t // rows)
        cap = min(ATTN_CLUSTER_MAX, n_pages, max(1, 4 * SMS // tiles))
        cl = 1
        while cl * 2 <= cap:
            cl *= 2
        r = max(1, min(PREFILL_RANK_PAGES, -(-n_pages // cl)))
        while r > 1 and attn_prefill_smem(g, rows, ps, dh, cl,
                                          r) > ATTN_SMEM_BUDGET:
            r -= 1
        smem = attn_prefill_smem(g, rows, ps, dh, cl, r)
        if rows == 1 or smem <= ATTN_SMEM_BUDGET:
            return AttnPrefillSchedule(rows, cl, r, smem, tiles * cl)
        rows //= 2
