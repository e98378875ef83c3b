"""The schedules of G's two routes and of K3 (``kernels/sm90.py``,
``kernels/qmatmul.py``) on the CPU: G's decode grid covers every (output,
chunk) exactly once at any split, the same shape always gets the same
schedule, the workspace stays small at the model's shapes, K3's slice
count follows the chunk count, and K3's source stays independent of the
tiles it checks.  The kernels run only on the card
(``tests/test_torch_gpu.py``)."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import sm90
from repro_torch.kernels.build import CSRC_DIR
from repro_torch.kernels.qmatmul import slices_for, smem_bytes

# qwen2-1.5b's (K, N): attn_q/attn_o, attn_k/attn_v, mlp_gate/mlp_up,
# mlp_down, and the tied lm_head
LAYER_KN = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)]
HEAD_KN = (1536, 151936)


def _coverage(s: sm90.DecodeSchedule, m: int, n: int, k: int, chunk: int):
    """hits[c, i, j]: how many threads of the decode grid form output (i, j)'s
    partial of chunk c (csrc/qgemm.cu's block and thread mapping)."""
    nc = -(-k // chunk)
    v = s.width // sm90.DECODE_LANES
    assert v == (2 if s.width == 64 else 1)
    hits = np.zeros((nc, m, n), dtype=np.int32)
    for x in range(s.strips):
        for y in range(s.slices):
            first = y * s.slots
            end = nc if s.slices == 1 else min(nc, first + s.slots)
            for z in range(s.row_groups):
                rows = slice(z * sm90.DECODE_ROWS, (z + 1) * sm90.DECODE_ROWS)
                for c0 in range(first, end, s.slots):     # rounds
                    for slot in range(s.slots):
                        c = c0 + slot
                        if c >= end:
                            continue
                        for lane in range(sm90.DECODE_LANES):
                            col = x * s.width + lane * v
                            hits[c, rows, col:col + v] += 1
    return hits


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("k,n", LAYER_KN)
def test_decode_grid_covers_every_output_and_chunk_once(m, k, n):
    s = sm90.decode_schedule(m, n, k, 64, 1)
    assert bool((_coverage(s, m, n, k, 64) == 1).all())


@pytest.mark.parametrize("m,k,n,chunk,b_kind", [
    (5, 200, 75, 64, 1), (7, 300, 260, 20, 1), (13, 700, 90, 48, 1),
    (8, 8960, 136, 64, 1), (2, 130, 33, 16, 0), (16, 1536, 256, 64, 1),
    (1, 1, 1, 1, 1), (8, 8192, 100, 4096, 1),
])
def test_decode_grid_covers_ragged_shapes_once(m, k, n, chunk, b_kind):
    s = sm90.decode_schedule(m, n, k, chunk, b_kind)
    assert bool((_coverage(s, m, n, k, chunk) == 1).all())


def test_decode_splits_where_strips_leave_the_card_short_of_warps():
    """At M = 8 the strips of every layer GEMM alone give the card fewer
    than DECODE_WARPS warps, so their chunks are split (a warp a chunk of
    every strip); the lm_head's 2374 strips are not split and write no
    workspace."""
    sched = {kn: sm90.decode_schedule(8, kn[1], kn[0], 64, 1)
             for kn in LAYER_KN + [HEAD_KN]}
    for k, n in LAYER_KN:
        s = sched[(k, n)]
        assert s.slices == -(-k // 64 // s.slots) and s.slices > 1
        assert s.slots == sm90.DECODE_SLOTS
    s = sched[HEAD_KN]
    assert s.slices == 1 and s.ws_floats == 0 and s.strips == 2374
    assert s.strips * s.slots >= sm90.DECODE_WARPS


@pytest.mark.parametrize("m", [1, 3, 8])
def test_decode_workspace_within_its_bound(m):
    """A split call's workspace (chunks x M x N f32) stays L2-resident:
    at most 7 MiB at every layer shape; the lm_head writes none."""
    for k, n in LAYER_KN + [HEAD_KN]:
        s = sm90.decode_schedule(m, n, k, 64, 1)
        assert s.ws_floats == sm90.decode_ws(m, n, k, 64, s.slices)
        assert s.ws_floats * 4 <= 7 * 2 ** 20
        assert s.smem <= sm90.SMEM_LIMIT


# The largest workspace G's decode route writes at M rows (bytes): mlp_down's
# 140 chunks x M x 1536 f32, 27.5 MB at 32, inside the H100's 50 MB L2, and
# 55 MB at 64, past it, where the route was timed faster than the tile all
# the same (PERF.md, PR 17)
WS_BOUND = {32: 140 * 32 * 1536 * 4, 64: 140 * 64 * 1536 * 4}


@pytest.mark.parametrize("m", [32, 64])
@pytest.mark.parametrize("k,n", LAYER_KN + [HEAD_KN])
def test_decode_workspace_above_decode_within_its_bound(m, k, n):
    """At M = 32 and at a 64-row slab, where G still takes the decode
    route (at 64 only where the tile has fewer output tiles than SMs), a
    split call's workspace stays within the largest the route was timed
    at; mlp_down's reaches it."""
    s = sm90.g_schedule(m, n, k, 64, 0, 1)
    if not isinstance(s, sm90.DecodeSchedule):
        assert m == 64 and n in (8960, 151936)
        return
    assert s.ws_floats == sm90.decode_ws(m, n, k, 64, s.slices)
    assert s.ws_floats * 4 <= WS_BOUND[m]
    assert (s.ws_floats * 4 == WS_BOUND[m]) == ((k, n) == (8960, 1536))
    assert s.smem <= sm90.SMEM_LIMIT


# G's schedule at the model's shapes, worked out by hand from
# csrc/qgemm.cu's mapping: a strip of 32 V columns a warp (V = 2 bf16 or
# 1 f32), 8 rows a row group, 8 chunk slots a block, and a split into
# ceil(chunks / 8) slices where strips x row groups x 8 warps fall short
# of 16 warps an SM (2112); the tile's blocks are 64 x 64 output tiles
SCHED_AT = {
    # (m, k, n, chunk, b_kind): (slots, slices, strips, row_groups, width,
    #                            ws_floats, smem)
    (8, 1536, 8960, 64, 1): (8, 3, 140, 1, 64, 24 * 8 * 8960,
                             (8 * 8 * 64 + 8 * 64) * 4),
    (3, 700, 90, 48, 0): (8, 2, 3, 1, 32, 15 * 3 * 90,
                          (8 * 8 * 48 + 8 * 32) * 4),
    (64, 1536, 1536, 64, 1): (8, 3, 24, 8, 64, 24 * 64 * 1536,
                              (8 * 8 * 64 + 8 * 64) * 4),
    (8, 1536, 151936, 64, 1): (8, 1, 2374, 1, 64, 0,
                               (8 * 8 * 64 + 8 * 64) * 4),
}


@pytest.mark.parametrize("shape", [(8, 1536, 8960, 64, 1), (3, 700, 90, 48, 0),
                                   (64, 1536, 1536, 64, 1),
                                   (8, 1536, 151936, 64, 1),
                                   (512, 1536, 151936, 64, 1)])
def test_g_same_shape_same_schedule(shape):
    """G's schedule is a function of the shape alone, pinned to the
    mapping's values: computed afresh it is the same, field by field.  The
    lm_head's forward at T = 512 takes the tile: 4 chunk groups (24
    chunks), a 2-deep ring of 6 KiB steps (f32 A, bf16 B), 8 x 2374
    tiles."""
    m, k, n, chunk, b_kind = shape
    sm90.decode_schedule.cache_clear()
    sm90.g_schedule.cache_clear()
    got = sm90.g_schedule(m, n, k, chunk, 0, b_kind)
    if shape in SCHED_AT:
        want = sm90.DecodeSchedule(*SCHED_AT[shape])
    else:
        want = sm90.Schedule(groups=4, stages=2,
                             smem=64 * 64 * 4 + 4 * (2 * 16 * 64 * 4
                                                     + 2 * 64 * 16 * 6),
                             blocks=8 * 2374)
    assert got == want


def test_g_route_switch():
    """The decode route up to DECODE_MAX_M rows, and up to twice that
    where the tile would have fewer output tiles than SMs (attn_* and
    mlp_down at a 64-token slab, not mlp_gate or the lm_head); the tile
    (K8's grid without the shadow carry) above, and where a chunk is too
    long for a decode block's shared memory."""
    m = sm90.DECODE_MAX_M
    for n in (256, 1536, 8960, 151936):
        assert isinstance(sm90.g_schedule(m, n, 1536, 64, 0, 1),
                          sm90.DecodeSchedule)
    for n, decode in ((256, True), (1536, True), (8960, False),
                      (151936, False)):
        s = sm90.g_schedule(2 * m, n, 1536, 64, 0, 1)
        assert isinstance(s, sm90.DecodeSchedule) == decode
    tile = sm90.g_schedule(2 * m + 1, 1536, 1536, 64, 0, 1)
    assert tile == sm90.gemm_schedule(2 * m + 1, 1536, 1536, 64, 0, 1,
                                      stats=False)
    assert sm90.decode_schedule(8, 1536, 8192, 4096, 1).slots == 1
    assert sm90.decode_schedule(8, 1536, 100000, 8192, 1) is None
    assert isinstance(sm90.g_schedule(8, 1536, 100000, 8192, 0, 1),
                      sm90.Schedule)


@pytest.mark.parametrize("n_chunks,slices", [
    (0, 1), (1, 1), (2, 2), (3, 2), (4, 4), (24, 4), (140, 4), (2374, 4)])
def test_qmatmul_slices_follow_the_chunk_count(n_chunks, slices):
    assert slices_for(n_chunks) == slices


def test_qmatmul_two_blocks_of_four_slices_fit_an_sm():
    """K3's block at 4 slices (the carries and four 16 KiB regions, 80 KiB)
    leaves room for a second on an SM."""
    assert smem_bytes(1) < smem_bytes(2) < smem_bytes(4) == 81920
    assert 2 * (smem_bytes(4) + 1024) <= 233472


def _local_includes(path: Path) -> list[str]:
    return re.findall(r'^\s*#include\s+"([^"]+)"', path.read_text(), re.M)


def test_qmatmul_source_is_independent_of_the_tiles_it_checks():
    """K3, the oracle's GEMM, includes common.cuh and nothing of G's or
    the Hopper tile's code."""
    assert _local_includes(CSRC_DIR / "qmatmul.cu") == ["common.cuh"]
    assert "sm90::" not in (CSRC_DIR / "qmatmul.cu").read_text()


def test_old_g_tile_is_gone():
    """qgemm_core.cuh is deleted, and no source or kernel module names
    it."""
    assert not (CSRC_DIR / "qgemm_core.cuh").exists()
    kernels = CSRC_DIR.parent / "kernels"
    for f in [*CSRC_DIR.iterdir(), *kernels.glob("*.py")]:
        assert "qgemm_core" not in f.read_text(), f
