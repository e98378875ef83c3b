// K8-on-Hopper: the fused quantized GEMM with the swamping-telemetry stats
// epilogue.
//
// Replaces repro/kernels/fused.py::_fused_kernel_stats (RNE carry): G's
// chunked carry (qgemm_core.cuh, the same code, so C is bitwise G's) plus
// an f32 shadow carry and the N_STATS row of common.cuh reduced over the
// whole output.  Operands are f32, bf16 or int8 codes of the representation
// format (unpacked on load, the in-graph telemetry's FWD replay of the
// saved residuals); quantize_a / quantize_b apply to float operands only.
//
// Each block writes one partial row of doubles (its tile's contributions in
// a fixed order); stats_finish sums them in a fixed order and rounds once
// to f32, so two launches on the same inputs give the same bits.  The tile
// is G's 64 x 64 one at every M (the probe and the replay run at M = T
// tokens or K features, never at decode's M = 8).
//
// Bound on the H100: as G at training sizes, the f32 arithmetic on the
// CUDA cores; the stats add a shadow add per output per chunk and a
// handful of compares.
#include "qgemm_core.cuh"

namespace {

using bf = __nv_bfloat16;
constexpr int BM = 64, BN = 64, TM = 4, TN = 4, KT = 32, NT = 256;

// Two resident blocks an SM: the shadow carry and counters take the tile to
// 151-167 registers a thread, which leaves one 256-thread block an SM; the
// bound caps it at 128 (a few dozen bytes spill) and the tile runs at G's
// occupancy.  Schedule only: the output bits are the same.
template <typename TA, typename TB>
__global__ void __launch_bounds__(NT, 2)
    qgemm_stats_kernel(qcore::Args<TA, TB> p, double* part) {
  __shared__ float As[KT][BM + 1];
  __shared__ float Bs[KT][BN + 1];
  __shared__ double sh[NT / 32 * N_STATS];
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  qcore::tile<BM, BN, TM, TN, KT, NT, false, true>(
      p, blockIdx.y * BM, blockIdx.x * BN, false, false, As, Bs,
      part + blk * N_STATS, sh);
}

template <typename TA, typename TB>
int launch(const void* A, long long sam, long long sak, const void* B,
           long long sbk, long long sbn, float* C, int M, int N, int K,
           int chunk, QFmt qr, int qa, int qb, qcore::Dec dec, QFmt qacc,
           double* part, float* stats, cudaStream_t s) {
  qcore::Args<TA, TB> p{static_cast<const TA*>(A), sam, sak,
                        static_cast<const TB*>(B), sbk, sbn, C, N, nullptr,
                        M, N, K, chunk, qr, qa, qb, dec, qacc,
                        nullptr, nullptr, dec};
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qgemm_stats_kernel<TA, TB><<<grid, NT, 0, s>>>(p, part);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int blocks = (int)(grid.x * grid.y);
  return stats_finish(part, blocks, blocks, 1, stats, s);
}

template <typename TA>
int dispatch_b(int b_kind, const void* A, long long sam, long long sak,
               const void* B, long long sbk, long long sbn, float* C, int M,
               int N, int K, int chunk, QFmt qr, int qa, int qb,
               qcore::Dec dec, QFmt qacc, double* part, float* stats,
               cudaStream_t s) {
#define QGS_ARGS A, sam, sak, B, sbk, sbn, C, M, N, K, chunk, qr, qa, qb, dec, qacc, part, stats, s
  if (b_kind == 0) return launch<TA, float>(QGS_ARGS);
  if (b_kind == 1) return launch<TA, bf>(QGS_ARGS);
  if (b_kind == 2) return launch<TA, int8_t>(QGS_ARGS);
#undef QGS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Partial rows the kernel writes for an M x N output (the workspace the
// caller passes as `part`, in doubles: this times N_STATS).
extern "C" int qgemm_stats_blocks(int M, int N) {
  return ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// K8.  a_kind / b_kind: 0 f32, 1 bf16, 2 int8 codes of (1, e_r, m_r).
// Strides are in elements; C [M, N] row-major; stats [N_STATS] f32.
// Returns the cudaError_t of the launches.
extern "C" int qgemm_stats(const void* A, int a_kind, long long sam,
                           long long sak, const void* B, int b_kind,
                           long long sbk, long long sbn, void* C, int M,
                           int N, int K, int chunk, int e_r, int m_r,
                           int r_identity, int r_shift, float r_max,
                           float r_min, int quant_a, int quant_b,
                           int c_identity, int c_shift, float c_max,
                           float c_min, void* part, void* stats,
                           void* stream) {
  const QFmt qr{r_identity, r_shift, r_max, r_min};
  const QFmt qacc{c_identity, c_shift, c_max, c_min};
  const qcore::Dec dec{e_r, m_r};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(C);
  double* P = static_cast<double*>(part);
  float* S = static_cast<float*>(stats);
#define QGS_ARGS b_kind, A, sam, sak, B, sbk, sbn, out, M, N, K, chunk, qr, quant_a, quant_b, dec, qacc, P, S, s
  if (a_kind == 0) return dispatch_b<float>(QGS_ARGS);
  if (a_kind == 1) return dispatch_b<bf>(QGS_ARGS);
  if (a_kind == 2) return dispatch_b<int8_t>(QGS_ARGS);
#undef QGS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
