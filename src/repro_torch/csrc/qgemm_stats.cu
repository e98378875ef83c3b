// K8-on-Hopper: the fused quantized GEMM with the swamping-telemetry stats
// epilogue.
//
// Replaces repro/kernels/fused.py::_fused_kernel_stats (RNE and SR carry):
// G's chunked carry, bitwise (G runs the same tile above decode, and its
// decode kernel holds the same per-output contract), plus an f32 shadow
// carry and the N_STATS row of common.cuh reduced over the whole output.
// Under stochastic rounding (sr, seed) C is bitwise E's under the same seed
// (the dither keys on the output element and the chunk only); the shadow
// carry and the counters are the same in form.  Operands are
// f32, bf16 or int8 codes of the representation format (unpacked on load,
// the in-graph telemetry's FWD replay of the saved residuals); quantize_a /
// quantize_b apply to float operands only.
//
// Each block writes one partial row of doubles (its tile's contributions
// in a fixed order); stats_finish sums them in a fixed order and rounds
// once to f32, so two launches on the same inputs give the same bits.
//
// Bound on the H100: the f32 FMAs on the CUDA cores (2MNK operations at
// 67 TFLOP/s): the bitwise contract fixes each chunk's partial to the
// sequential round-to-nearest f32 chain, which a tensor-core MMA does not
// form (qgemm_sm90.cuh).  The design is qgemm_sm90.cuh's: 64 x 64 output
// tiles, G chunk groups of 64 threads each forming 8 x 8 partials in
// registers, the carry and the shadow carry in shared memory and folded
// once a chunk in chunk order, operands landed by cp.async in their stored
// type and decoded once a block.  The shadow adds one shared-memory add a
// output a chunk and a handful of compares to the fold.
#include "qgemm_sm90.cuh"

namespace {

using bf = __nv_bfloat16;
using sm90::TILE;

template <typename TA, typename TB, bool SR>
__global__ void __launch_bounds__(4 * sm90::GT, 2)
    qgemm_stats_kernel(sm90::Gemm p, double* part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  sm90::block_tile<TA, TB, sm90::stage_bytes<TA, TB>(), true, SR>(
      p, blockIdx.y * TILE, blockIdx.x * TILE, smem, part + blk * N_STATS);
}

bool valid_groups(int groups) { return groups == 1 || groups == 2 || groups == 4; }

template <typename TA, typename TB>
int smem(int groups) {
  return sm90::smem_bytes(sm90::stage_bytes<TA, TB>(), groups, true);
}

template <typename TA, typename TB, bool SR>
int launch(const void* A, long long sam, long long sak, const void* B,
           long long sbk, long long sbn, float* C, int M, int N, int K,
           int chunk, QFmt qr, int qa, int qb, sm90::Dec dec, QFmt qacc,
           int groups, unsigned seed, double* part, float* stats, cudaStream_t s) {
  if (!valid_groups(groups)) return static_cast<int>(cudaErrorInvalidValue);
  sm90::Gemm p{sm90::operand(A, sizeof(TA), sam, sak, M, chunk, qa),
               sm90::operand(B, sizeof(TB), sbn, sbk, N, chunk, qb),
               C, N, nullptr, M, N, K, chunk, sm90::quant_of(qr), sm90::quant_of(qacc), dec,
               seed};
  const int bytes = smem<TA, TB>(groups);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      qgemm_stats_kernel<TA, TB, SR>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc != 0) return rc;
  dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  qgemm_stats_kernel<TA, TB, SR><<<grid, groups * sm90::GT, bytes, s>>>(p, part);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int blocks = (int)(grid.x * grid.y);
  return stats_finish(part, blocks, blocks, 1, stats, s);
}

// Resident blocks an SM at `groups` chunk groups (or a negative error).
template <typename TA, typename TB>
int occupancy(int groups) {
  if (!valid_groups(groups)) return -static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem<TA, TB>(groups);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      qgemm_stats_kernel<TA, TB, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  int n = 0;
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, qgemm_stats_kernel<TA, TB, false>, groups * sm90::GT, bytes));
  return rc != 0 ? -rc : n;
}

// f(TA, TB) over the operand kinds: 0 f32, 1 bf16, 2 int8 codes
template <typename F>
int by_kinds(int a_kind, int b_kind, F f) {
  auto b_of = [&](auto ta) -> int {
    using TA = decltype(ta);
    if (b_kind == 0) return f(TA{}, float{});
    if (b_kind == 1) return f(TA{}, bf{});
    if (b_kind == 2) return f(TA{}, int8_t{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (a_kind == 0) return b_of(float{});
  if (a_kind == 1) return b_of(bf{});
  if (a_kind == 2) return b_of(int8_t{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Partial rows the kernel writes for an M x N output (the workspace the
// caller passes as `part`, in doubles: this times N_STATS).
extern "C" int qgemm_stats_blocks(int M, int N) {
  return ((M + TILE - 1) / TILE) * ((N + TILE - 1) / TILE);
}

// Dynamic shared memory of one block (bytes) and resident blocks an SM at
// `groups` chunk groups; kernels/sm90.py mirrors the first.
extern "C" int qgemm_stats_smem(int a_kind, int b_kind, int groups) {
  return by_kinds(a_kind, b_kind, [&](auto ta, auto tb) {
    return smem<decltype(ta), decltype(tb)>(groups);
  });
}
extern "C" int qgemm_stats_occupancy(int a_kind, int b_kind, int groups) {
  return by_kinds(a_kind, b_kind, [&](auto ta, auto tb) {
    return occupancy<decltype(ta), decltype(tb)>(groups);
  });
}

// K8.  a_kind / b_kind: 0 f32, 1 bf16, 2 int8 codes of (1, e_r, m_r).
// Strides are in elements; C [M, N] row-major; stats [N_STATS] f32;
// groups: chunk groups a block (1, 2 or 4; kernels/sm90.py picks them); sr:
// stochastic rounding of the carry, dithered under seed.  Returns the
// cudaError_t of the launches.
extern "C" int qgemm_stats(const void* A, int a_kind, long long sam,
                           long long sak, const void* B, int b_kind,
                           long long sbk, long long sbn, void* C, int M,
                           int N, int K, int chunk, int e_r, int m_r,
                           int r_identity, int r_shift, float r_max,
                           float r_min, int quant_a, int quant_b,
                           int c_identity, int c_shift, float c_max,
                           float c_min, int groups, int sr, unsigned seed,
                           void* part, void* stats, void* stream) {
  const QFmt qr{r_identity, r_shift, r_max, r_min};
  const QFmt qacc{c_identity, c_shift, c_max, c_min};
  const sm90::Dec dec = sm90::dec_of(e_r, m_r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(C);
  double* P = static_cast<double*>(part);
  float* S = static_cast<float*>(stats);
  return by_kinds(a_kind, b_kind, [&](auto ta, auto tb) {
    using TA = decltype(ta);
    using TB = decltype(tb);
    return sr ? launch<TA, TB, true>(A, sam, sak, B, sbk, sbn, out, M, N, K, chunk, qr,
                                     quant_a, quant_b, dec, qacc, groups, seed, P, S, s)
              : launch<TA, TB, false>(A, sam, sak, B, sbk, sbn, out, M, N, K, chunk, qr,
                                      quant_a, quant_b, dec, qacc, groups, seed, P, S, s);
  });
}
