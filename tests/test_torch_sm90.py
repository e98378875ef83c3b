"""The schedule of the Hopper tile of E, K8, B and K9 (``kernels/sm90.py``): the
shape-to-schedule logic and the sizes the kernels' launches take, on the
CPU.  The kernels themselves run only on the card (``tests/test_torch_gpu.py``
holds every schedule against the plain versions there)."""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import sm90
from repro_torch.kernels.common import N_STATS

# the training path's GEMMs at T = 512 tokens: (K, N) of a qwen2-1.5b layer
# and of the tied lm_head
LAYER_KN = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)]
HEAD_KN = (1536, 151936)
SM_BYTES = 233472          # shared memory of one H100 SM
BLOCK_RESERVED = 1024      # the runtime's share of it a resident block


@pytest.mark.parametrize("n_chunks,groups", [
    (1, 1), (2, 2), (3, 2), (4, 4), (24, 4), (140, 4), (2374, 4)])
def test_chunk_groups_follow_the_chunk_count(n_chunks, groups):
    assert sm90.chunk_groups(n_chunks) == groups


@pytest.mark.parametrize("m,n", [(37, 75), (64, 64), (100, 130), (512, 1536),
                                 (512, 8960), (1, 1)])
def test_gemm_grid_covers_every_output_once(m, n):
    sched = sm90.gemm_schedule(m, n, 200, 64, 0, 0)
    hits = torch.zeros((m, n), dtype=torch.int32)
    for b in range(sched.blocks):
        m0, n0 = sm90.gemm_tile(b, m, n)
        assert m0 < m and n0 < n
        hits[m0:m0 + sm90.TILE, n0:n0 + sm90.TILE] += 1
    assert bool((hits == 1).all())


@pytest.mark.parametrize("t,k,n", [(40, 70, 50), (96, 80, 520), (33, 40, 260),
                                   (512, 1536, 256), (512, 8960, 1536)])
def test_pair_grid_covers_every_output_once(t, k, n):
    """B's one grid: every dx [t, k] and dw [k, n] output in exactly one
    block, the dx blocks first."""
    dx_blocks, blocks = sm90.pair_blocks(t, k, n)
    sched = sm90.pair_schedule(t, k, n, 64, 64, 2, 2, 1)
    assert sched.blocks == blocks
    hits = {"dx": torch.zeros((t, k), dtype=torch.int32),
            "dw": torch.zeros((k, n), dtype=torch.int32)}
    for b in range(blocks):
        role, m0, n0 = sm90.pair_tile(b, t, k, n)
        assert role == ("dx" if b < dx_blocks else "dw")
        hits[role][m0:m0 + sm90.TILE, n0:n0 + sm90.TILE] += 1
    assert all(bool((h == 1).all()) for h in hits.values())


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_shared_memory_within_a_block_limit(groups, stats):
    for a in (0, 1, 2):
        for b in (0, 1, 2):
            smem = sm90.smem_bytes(sm90.stage_bytes(a, b), groups, stats)
            assert smem <= sm90.SMEM_LIMIT
            assert sm90.ring_stages(sm90.stage_bytes(a, b)) >= 2


def test_training_path_fits_two_blocks_an_sm():
    """At T = 512 every K8 and B launch of the training path takes 4 chunk
    groups (256 threads) and leaves room for a second block on the SM."""
    for k, n in LAYER_KN:
        for sched in (sm90.gemm_schedule(512, n, k, 64, 2, 2),
                      sm90.pair_schedule(512, k, n, 64, 64, 2, 2, 1)):
            assert sched.groups == 4 and sched.threads == 256
            assert 2 * (sched.smem + BLOCK_RESERVED) <= SM_BYTES
    k, n = HEAD_KN
    for sched in (sm90.gemm_schedule(512, n, k, 64, 0, 1),
                  sm90.pair_schedule(512, k, n, 64, 64, 0, 1, 0)):
        assert sched.groups == 4
        assert 2 * (sched.smem + BLOCK_RESERVED) <= SM_BYTES


@pytest.mark.parametrize("shape", [(512, 1536, 8960, 64, 64), (70, 96, 300, 100, 100),
                                   (40, 70, 50, 64, 64)])
def test_same_shape_same_schedule(shape):
    t, k, n, bc, gc = shape
    assert sm90.pair_schedule(t, k, n, bc, gc, 2, 2, 1) == \
        sm90.pair_schedule(t, k, n, bc, gc, 2, 2, 1)
    assert sm90.gemm_schedule(t, n, k, bc, 2, 2) == \
        sm90.gemm_schedule(t, n, k, bc, 2, 2)


def test_pair_groups_follow_the_longer_role():
    # dx sums N = 520 in 9 chunks, dw sums T = 40 in 1: 4 groups for both
    assert sm90.pair_schedule(40, 70, 520, 64, 64, 2, 2, 1).groups == 4
    # dx 1 chunk, dw 3 chunks
    assert sm90.pair_schedule(150, 70, 50, 64, 64, 2, 2, 1).groups == 2
    assert sm90.pair_schedule(40, 70, 50, 64, 64, 2, 2, 1).groups == 1


def test_stats_workspace_is_one_row_a_tile():
    """K8's workspace is one float64 N_STATS row a block, one block a tile
    (the kernels' ``qgemm_stats_blocks``)."""
    m, n = 512, 151936
    sched = sm90.gemm_schedule(m, n, 1536, 64, 0, 1)
    assert sched.blocks == -(-m // sm90.TILE) * -(-n // sm90.TILE) == 18992
    assert sched.blocks * N_STATS * 8 < 2 ** 24


@pytest.mark.parametrize("m,n", [(37, 75), (64, 64), (100, 130), (512, 1536),
                                 (512, 256), (1, 1)])
def test_emitq_grid_covers_every_output_once(m, n):
    """E's GEMM grid (K8's layout): every output in exactly one block."""
    sched = sm90.emitq_schedule(m, n, 200, 64)
    hits = torch.zeros((m, n), dtype=torch.int32)
    for b in range(sched.blocks):
        m0, n0 = sm90.gemm_tile(b, m, n)
        assert m0 < m and n0 < n
        hits[m0:m0 + sm90.TILE, n0:n0 + sm90.TILE] += 1
    assert bool((hits == 1).all())


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_emitq_and_k9_shared_memory_within_a_block_limit(groups):
    """E's and K9's launches at each group count and operand kind stay
    within a block's shared memory with a ring of two steps at least; K9
    is B's schedule plus the shadow carry's tile."""
    k = 64 * groups                 # chunks of 64: `groups` of them
    e = sm90.emitq_schedule(64, 64, k, 64)
    assert e.groups == groups and e.smem <= sm90.SMEM_LIMIT and e.stages >= 2
    for x, w in ((2, 2), (0, 0), (0, 1), (1, 1), (1, 0)):
        for g in (0, 1):
            b = sm90.pair_schedule(64, 64, k, 64, 64, x, w, g)
            k9 = sm90.pair_schedule(64, 64, k, 64, 64, x, w, g, stats=True)
            assert k9.groups == b.groups == groups
            assert (k9.stages, k9.blocks) == (b.stages, b.blocks)
            assert k9.stages >= 2
            assert k9.smem == b.smem + sm90.TILE * sm90.TILE * 4
            assert k9.smem <= sm90.SMEM_LIMIT


def test_training_path_e_and_k9_fit_two_blocks_an_sm():
    """At T = 512 every layer call of E (bf16 scratches) and of K9 (int8
    codes, bf16 Q(g)) takes 4 chunk groups and 114688 bytes (112 KiB), so
    two 256-thread blocks are resident on an SM."""
    for k, n in LAYER_KN:
        for sched in (sm90.emitq_schedule(512, n, k, 64),
                      sm90.pair_schedule(512, k, n, 64, 64, 2, 2, 1,
                                         stats=True)):
            assert sched.groups == 4 and sched.threads == 256
            assert sched.stages == 4 and sched.smem == 114688
            assert 2 * (sched.smem + BLOCK_RESERVED) <= SM_BYTES


def test_k9_lm_head_call_fits_one_block_an_sm():
    """K9's lm_head call (f32 x, bf16 embed.T, f32 g: no format to round g
    to) stages 8192 bytes a step, a ring of 2, and with the shadow carry
    takes 131072 bytes: one block an SM (B's, without the shadow, fits
    two)."""
    k, n = HEAD_KN
    sched = sm90.pair_schedule(512, k, n, 64, 64, 0, 1, 0, stats=True)
    assert sched.groups == 4 and sched.stages == 2
    assert sched.smem == 131072
    assert sched.smem + BLOCK_RESERVED <= SM_BYTES
    assert 2 * (sched.smem + BLOCK_RESERVED) > SM_BYTES


@pytest.mark.parametrize("m,k,n,chunk", [(512, 1536, 8960, 64),
                                         (70, 300, 96, 100), (40, 50, 70, 64)])
def test_emitq_same_shape_same_schedule(m, k, n, chunk):
    assert sm90.emitq_schedule(m, n, k, chunk) == \
        sm90.emitq_schedule(m, n, k, chunk)
    assert sm90.emitq_schedule(m, n, k, chunk).groups == \
        sm90.chunk_groups(-(-k // chunk))
