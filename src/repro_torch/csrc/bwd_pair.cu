// B: both backward GEMMs of one quantized dense layer in one launch.
//
// Replaces repro/kernels/bwd_pair.py::_pair_kernel (K6) and, with a dx
// carry in, ::_pair_kernel_seg (K7, one N segment of the split pair):
//
//   dx[T, K] = Q(g)[T, N] . w[K, N]^T   carry (1, e_bwd, m_bwd) rounded
//                                       every bwd_chunk of N, N increasing
//   dw[K, N] = x[T, K]^T . Q(g)[T, N]   carry (1, e_grad, m_grad) rounded
//                                       every grad_chunk of T, T increasing
//
// x and w are the forward's residuals: int8 codes of Q(x) and Q(w), unpacked
// on load, or raw f32/bf16 of any strides (the lm_head passes the embed.T
// view).  g is quantized to the representation format once a block, as its
// tile lands, which equals the TPU kernel's quantize-once-per-landing value
// (Q(Q(v)) = Q(v)).
//
// The grid is one dimension: the first blocks are the dx tiles (each walks
// all of N, the long sums), the rest the dw tiles (each walks T); each
// block's role is uniform.  A tile is qgemm_sm90.cuh's on strided views, so
// nothing is transposed in memory.  A dx carry in (dx_carry) resumes a
// running dx: chaining block-aligned N segments, each with the previous
// segment's dx as its carry, is bitwise the unsplit call (the carry values
// are exact format points and the chunk cadence is unchanged).
//
// Bound on the H100: the f32 FMAs on the CUDA cores, 2 x 2TKN operations at
// 67 TFLOP/s.  The bitwise contract fixes each chunk's partial to the
// sequential round-to-nearest f32 chain, which a tensor-core MMA does not
// form (qgemm_sm90.cuh).  The design is qgemm_sm90.cuh's: registers hold
// only 8 x 8 partials a thread, the carries live in shared memory, and the
// chunk groups put 4 x 64 threads on each tile of the long sums (the
// lm_head's dx walks 2374 chunks of 64 over 192 tiles; a layer's dx at
// T = 512 has 192 tiles), so the dx tiles and the many short dw tiles
// together fill the card.  The groups come from the chunk count of the
// longer role (kernels/sm90.py); one launch, one block size.
//
// bwd_pair_stats is the swamping-telemetry variant (K9, replacing
// ::_pair_kernel_stats), still on qgemm_core.cuh's tile: the same tiles
// with its STATS shadow carries, so dx and dw are bitwise B's, plus a
// (2, N_STATS) f32 row: the dx tiles' partial rows are summed into row 0
// (BWD) and the dw tiles' into row 1 (GRAD) by common.cuh's fixed-order
// second pass.  The TPU kernel keeps a (block_k, N) dw slab in VMEM so
// that g lands once; here each role reads g itself.
#include "qgemm_core.cuh"
#include "qgemm_sm90.cuh"

#include <algorithm>
#include <type_traits>

namespace {

using bf = __nv_bfloat16;
using sm90::TILE;

// ---- B (and its dx carry-in entry): qgemm_sm90.cuh's tile ----

struct Pair {
  sm90::Gemm dx;   // A = g [T, N], B = w^T [N, K]
  sm90::Gemm dw;   // A = x^T [K, T], B = g [T, N]
  int dx_tiles_n;  // dx column tiles (over K)
  int dx_blocks;   // dx tiles in all
  int dw_tiles_n;  // dw column tiles (over N)
};

// one ring step holds either role's raw tiles (g's type TG)
template <typename TX, typename TW, typename TG>
__host__ __device__ constexpr int pair_stage() {
  return sm90::stage_bytes<TG, TW>() > sm90::stage_bytes<TX, TG>()
             ? sm90::stage_bytes<TG, TW>()
             : sm90::stage_bytes<TX, TG>();
}

template <typename TX, typename TW, typename TG>
__global__ void __launch_bounds__(4 * sm90::GT, 2) bwd_pair_kernel(Pair p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STAGE = pair_stage<TX, TW, TG>();
  const int b = blockIdx.x;
  if (b < p.dx_blocks) {
    sm90::block_tile<TG, TW, STAGE, false>(p.dx, (b / p.dx_tiles_n) * TILE,
                                           (b % p.dx_tiles_n) * TILE, smem, nullptr);
  } else {
    const int d = b - p.dx_blocks;
    sm90::block_tile<TX, TG, STAGE, false>(p.dw, (d / p.dw_tiles_n) * TILE,
                                           (d % p.dw_tiles_n) * TILE, smem, nullptr);
  }
}

// g's representation once a call: gq = Q(g) as bf16 (exact: a format of at
// most 7 mantissa bits and 8 exponent bits is a subset of bf16's values;
// NaN stays NaN), row-major [T, N].  Both roles then land 2 bytes an element
// of g and widen it, instead of 4 bytes quantized in every block.
__global__ void __launch_bounds__(256) quantize_g_kernel(const float* g, long long sgt,
                                                         long long sgn, int T, int N,
                                                         sm90::Quant q, __nv_bfloat16* gq) {
  const long long n_all = (long long)T * N;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_all;
       i += (long long)gridDim.x * blockDim.x) {
    const long long t = i / N, n = i % N;
    const float v = sm90::quant(g[t * sgt + n * sgn], q);
    gq[i] = __ushort_as_bfloat16(
        isnan(v) ? (unsigned short)0x7fc0u : (unsigned short)(__float_as_uint(v) >> 16));
  }
}

long long pair_blocks(int T, int K, int N) {
  return (long long)((T + TILE - 1) / TILE) * ((K + TILE - 1) / TILE)
         + (long long)((K + TILE - 1) / TILE) * ((N + TILE - 1) / TILE);
}

bool valid_groups(int groups) { return groups == 1 || groups == 2 || groups == 4; }

template <typename TX, typename TW, typename TG>
int pair_smem(int groups) {
  return sm90::smem_bytes(pair_stage<TX, TW, TG>(), groups, false);
}

// TG bf16: g goes through quantize_g_kernel into gq first; TG float: g is
// read as it is and quantized on landing where quant_g.
template <typename TX, typename TW, typename TG>
int launch(const float* g, long long sgt, long long sgn, const void* x,
           long long sxt, long long sxk, const void* w, long long swk,
           long long swn, const float* dx_carry, float* dx, float* dw, int T,
           int K, int N, int bwd_chunk, int grad_chunk, sm90::Quant qr, int quant_g,
           sm90::Dec dec, sm90::Quant qbwd, sm90::Quant qgrad, int groups,
           __nv_bfloat16* gq, cudaStream_t s) {
  if (!valid_groups(groups)) return static_cast<int>(cudaErrorInvalidValue);
  const void* G = g;
  if constexpr (std::is_same<TG, __nv_bfloat16>::value) {
    const long long n_all = (long long)T * N;
    const int blocks = (int)std::min<long long>((n_all + 255) / 256, 65536LL);
    quantize_g_kernel<<<blocks, 256, 0, s>>>(g, sgt, sgn, T, N, qr, gq);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    G = gq;
    sgt = N;
    sgn = 1;
    quant_g = 0;
  }
  Pair p;
  // dx[t, k] = sum_n g[t, n] w[k, n]: A = g (m = t, k = n), B = w^T
  // (k = n, n = k)
  p.dx = sm90::Gemm{sm90::operand(G, sizeof(TG), sgt, sgn, T, bwd_chunk, quant_g),
                    sm90::operand(w, sizeof(TW), swk, swn, K, bwd_chunk, 0),
                    dx, K, dx_carry, T, K, N, bwd_chunk, qr, qbwd, dec};
  // dw[k, n] = sum_t x[t, k] g[t, n]: A = x^T (m = k, k = t), B = g
  p.dw = sm90::Gemm{sm90::operand(x, sizeof(TX), sxk, sxt, K, grad_chunk, 0),
                    sm90::operand(G, sizeof(TG), sgn, sgt, N, grad_chunk, quant_g),
                    dw, N, nullptr, K, N, T, grad_chunk, qr, qgrad, dec};
  p.dx_tiles_n = (K + TILE - 1) / TILE;
  p.dx_blocks = ((T + TILE - 1) / TILE) * p.dx_tiles_n;
  p.dw_tiles_n = (N + TILE - 1) / TILE;
  const long long blocks = pair_blocks(T, K, N);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = pair_smem<TX, TW, TG>(groups);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      bwd_pair_kernel<TX, TW, TG>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc != 0) return rc;
  bwd_pair_kernel<TX, TW, TG><<<(unsigned)blocks, groups * sm90::GT, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW, typename TG>
int occupancy(int groups) {
  if (!valid_groups(groups)) return -static_cast<int>(cudaErrorInvalidValue);
  const int bytes = pair_smem<TX, TW, TG>(groups);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      bwd_pair_kernel<TX, TW, TG>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  int n = 0;
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bwd_pair_kernel<TX, TW, TG>, groups * sm90::GT, bytes));
  return rc != 0 ? -rc : n;
}

// f(TX, TW) over the residual kinds B takes: (int8, int8) codes, or raw
// f32/bf16 pairs
template <typename F>
int by_kinds(int x_kind, int w_kind, F f) {
  if (x_kind == 2 && w_kind == 2) return f(int8_t{}, int8_t{});
  if (x_kind == 0 && w_kind == 0) return f(float{}, float{});
  if (x_kind == 0 && w_kind == 1) return f(float{}, bf{});
  if (x_kind == 1 && w_kind == 1) return f(bf{}, bf{});
  if (x_kind == 1 && w_kind == 0) return f(bf{}, float{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// ... and g's: 0 f32 as it is, 1 bf16 through quantize_g_kernel
template <typename F>
int by_kinds(int x_kind, int w_kind, int g_kind, F f) {
  return by_kinds(x_kind, w_kind, [&](auto tx, auto tw) {
    if (g_kind == 1) return f(tx, tw, bf{});
    if (g_kind == 0) return f(tx, tw, float{});
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// ---- K9: qgemm_core.cuh's tile with STATS ----

constexpr int BM = 64, BN = 64, TM = 4, TN = 4, KT = 32, NT = 256;

template <typename TX, typename TW>
struct PairArgs {
  qcore::Args<float, TW> dx;  // A = g [T, N], B = w^T [N, K]
  qcore::Args<TX, float> dw;  // A = x^T [K, T], B = g [T, N]
  int dx_tiles_n;             // dx column tiles (over K)
  int dx_blocks;              // dx tiles in all
  int dw_tiles_n;             // dw column tiles (over N)
};

// Two resident blocks an SM, as qgemm_stats.cu asked for on this tile (its
// shadow carries need 166-175 registers otherwise).
template <typename TX, typename TW>
__global__ void __launch_bounds__(NT, 2)
    bwd_pair_stats_kernel(PairArgs<TX, TW> p, double* part) {
  __shared__ float As[KT][BM + 1];
  __shared__ float Bs[KT][BN + 1];
  __shared__ double sh[NT / 32 * N_STATS];
  const int b = blockIdx.x;
  double* row = part + (long long)b * N_STATS;
  if (b < p.dx_blocks) {
    const int tm = b / p.dx_tiles_n, tn = b % p.dx_tiles_n;
    qcore::tile<BM, BN, TM, TN, KT, NT, false, true>(
        p.dx, tm * BM, tn * BN, false, false, As, Bs, row, sh);
  } else {
    const int d = b - p.dx_blocks;
    const int tm = d / p.dw_tiles_n, tn = d % p.dw_tiles_n;
    qcore::tile<BM, BN, TM, TN, KT, NT, false, true>(
        p.dw, tm * BM, tn * BN, false, false, As, Bs, row, sh);
  }
}

template <typename TX, typename TW>
int launch_stats(const float* g, long long sgt, long long sgn, const void* x,
                 long long sxt, long long sxk, const void* w, long long swk,
                 long long swn, float* dx, float* dw, int T, int K, int N,
                 int bwd_chunk, int grad_chunk, QFmt qr, int quant_g,
                 qcore::Dec dec, QFmt qbwd, QFmt qgrad, double* part,
                 float* stats, cudaStream_t s) {
  const TX* X = static_cast<const TX*>(x);
  const TW* W = static_cast<const TW*>(w);
  PairArgs<TX, TW> p;
  p.dx = qcore::Args<float, TW>{g, sgt, sgn, W, swn, swk, dx, K, nullptr,
                                T, K, N, bwd_chunk, qr, quant_g, 0, dec,
                                qbwd, nullptr, nullptr, dec};
  p.dw = qcore::Args<TX, float>{X, sxk, sxt, g, sgt, sgn, dw, N, nullptr,
                                K, N, T, grad_chunk, qr, 0, quant_g, dec,
                                qgrad, nullptr, nullptr, dec};
  p.dx_tiles_n = (K + BN - 1) / BN;
  p.dx_blocks = ((T + BM - 1) / BM) * p.dx_tiles_n;
  p.dw_tiles_n = (N + BN - 1) / BN;
  const long long blocks = pair_blocks(T, K, N);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bwd_pair_stats_kernel<TX, TW><<<(unsigned)blocks, NT, 0, s>>>(p, part);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return stats_finish(part, p.dx_blocks, (int)blocks, 2, stats, s);
}

}  // namespace

// Strides are in elements; dx [T, K] and dw [K, N] are row-major; dx_carry
// is [T, K] row-major or null.  x_kind / w_kind: 0 f32, 1 bf16, 2 int8
// codes of (1, e_r, m_r).  gq: null (g read as f32), or a [T, N] bf16
// scratch that takes Q(g) first (quant_g with m_r <= 7).  groups: chunk
// groups a block (1, 2 or 4; kernels/sm90.py picks them).  Returns the
// cudaError_t of the launches.
extern "C" int bwd_pair(const void* g, long long sgt, long long sgn,
                        const void* x, int x_kind, long long sxt,
                        long long sxk, const void* w, int w_kind,
                        long long swk, long long swn, const void* dx_carry,
                        void* dx, void* dw, int T, int K, int N,
                        int bwd_chunk, int grad_chunk, int e_r, int m_r,
                        int r_identity, int r_shift, float r_max, float r_min,
                        int quant_g, int b_identity, int b_shift, float b_max,
                        float b_min, int w_identity, int w_shift,
                        float w_max, float w_min, int groups, void* gq,
                        void* stream) {
  const sm90::Quant qr = sm90::quant_of(QFmt{r_identity, r_shift, r_max, r_min});
  const sm90::Quant qbwd = sm90::quant_of(QFmt{b_identity, b_shift, b_max, b_min});
  const sm90::Quant qgrad = sm90::quant_of(QFmt{w_identity, w_shift, w_max, w_min});
  const sm90::Dec dec = sm90::dec_of(e_r, m_r);
  const float* G = static_cast<const float*>(g);
  const float* Cin = static_cast<const float*>(dx_carry);
  float* DX = static_cast<float*>(dx);
  float* DW = static_cast<float*>(dw);
  __nv_bfloat16* GQ = static_cast<__nv_bfloat16*>(gq);
  if (GQ != nullptr && !quant_g) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_kinds(x_kind, w_kind, GQ != nullptr, [&](auto tx, auto tw, auto tg) {
    return launch<decltype(tx), decltype(tw), decltype(tg)>(
        G, sgt, sgn, x, sxt, sxk, w, swk, swn, Cin, DX, DW, T, K, N, bwd_chunk, grad_chunk,
        qr, quant_g, dec, qbwd, qgrad, groups, GQ, s);
  });
}

// B's dynamic shared memory a block (bytes) and resident blocks an SM at
// `groups` chunk groups; g_kind 0 f32, 1 bf16 (gq); kernels/sm90.py
// mirrors the first.
extern "C" int bwd_pair_smem(int x_kind, int w_kind, int g_kind, int groups) {
  return by_kinds(x_kind, w_kind, g_kind, [&](auto tx, auto tw, auto tg) {
    return pair_smem<decltype(tx), decltype(tw), decltype(tg)>(groups);
  });
}
extern "C" int bwd_pair_occupancy(int x_kind, int w_kind, int g_kind, int groups) {
  return by_kinds(x_kind, w_kind, g_kind, [&](auto tx, auto tw, auto tg) {
    return occupancy<decltype(tx), decltype(tw), decltype(tg)>(groups);
  });
}

// Partial rows bwd_pair_stats writes (its workspace `part`, in doubles:
// this times N_STATS).
extern "C" int bwd_pair_stats_blocks(int T, int K, int N) {
  const long long b = pair_blocks(T, K, N);
  return b > 0x7fffffffLL ? -1 : (int)b;
}

// K9: bwd_pair (no carry in) plus stats [2, N_STATS] f32: row 0 dx (BWD),
// row 1 dw (GRAD).
extern "C" int bwd_pair_stats(const void* g, long long sgt, long long sgn,
                              const void* x, int x_kind, long long sxt,
                              long long sxk, const void* w, int w_kind,
                              long long swk, long long swn, void* dx,
                              void* dw, int T, int K, int N, int bwd_chunk,
                              int grad_chunk, int e_r, int m_r,
                              int r_identity, int r_shift, float r_max,
                              float r_min, int quant_g, int b_identity,
                              int b_shift, float b_max, float b_min,
                              int w_identity, int w_shift, float w_max,
                              float w_min, void* part, void* stats,
                              void* stream) {
  const qcore::Dec dec{e_r, m_r};
  const QFmt qr{r_identity, r_shift, r_max, r_min};
  const QFmt qbwd{b_identity, b_shift, b_max, b_min};
  const QFmt qgrad{w_identity, w_shift, w_max, w_min};
  const float* G = static_cast<const float*>(g);
  float* DX = static_cast<float*>(dx);
  float* DW = static_cast<float*>(dw);
  double* P = static_cast<double*>(part);
  float* S = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_kinds(x_kind, w_kind, [&](auto tx, auto tw) {
    return launch_stats<decltype(tx), decltype(tw)>(G, sgt, sgn, x, sxt, sxk, w, swk, swn,
                                                    DX, DW, T, K, N, bwd_chunk, grad_chunk,
                                                    qr, quant_g, dec, qbwd, qgrad, P, S, s);
  });
}
