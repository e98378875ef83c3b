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
// view).  g is quantized to the representation format once a call into a
// bf16 scratch (quantize_g_kernel) when the format has at most 7 mantissa
// bits, else in every block as its tile lands; either equals the TPU
// kernel's quantize-once-per-landing value (Q(Q(v)) = Q(v)).
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
// Under stochastic rounding (sr) each role's fold dithers its carry
// (qgemm_sm90.cuh): dx under seed_bwd at its (t, k) output of N = K columns
// and its N-chunk, dw under seed_grad at its (k, n) output and its
// T-chunk, so dx is bitwise the fused GEMM of Q(g) and w^T under seed_bwd,
// and dw that of x^T and Q(g) under seed_grad (repro/kernels/bwd_pair.py's
// contract).  The dx carry-in entry takes no SR: its dither would key on
// the global N chunk and dw column, an offset the entry does not take.
//
// bwd_pair_stats is the swamping-telemetry variant (K9, replacing
// ::_pair_kernel_stats): the same pair grid on the same tile with its STATS
// shadow carries, so dx and dw are bitwise B's, plus a (2, N_STATS) f32
// row: each block writes its tile's partial row, and common.cuh's
// fixed-order second pass sums the dx tiles' rows into row 0 (BWD) and the
// dw tiles' into row 1 (GRAD).  The TPU kernel keeps a (block_k, N) dw slab
// in VMEM so that g lands once; here each role reads g (or its bf16 Q(g))
// itself.
#include "qgemm_sm90.cuh"

#include <algorithm>
#include <type_traits>

namespace {

using bf = __nv_bfloat16;
using sm90::TILE;

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

// The block's role and tile; with STATS its partial row goes to part[b].
template <typename TX, typename TW, typename TG, bool STATS, bool SR>
__device__ __forceinline__ void pair_tile(const Pair& p, unsigned char* smem, double* part) {
  constexpr int STAGE = pair_stage<TX, TW, TG>();
  const int b = blockIdx.x;
  double* row = STATS ? part + (long long)b * N_STATS : nullptr;
  if (b < p.dx_blocks) {
    sm90::block_tile<TG, TW, STAGE, STATS, SR>(p.dx, (b / p.dx_tiles_n) * TILE,
                                               (b % p.dx_tiles_n) * TILE, smem, row);
  } else {
    const int d = b - p.dx_blocks;
    sm90::block_tile<TX, TG, STAGE, STATS, SR>(p.dw, (d / p.dw_tiles_n) * TILE,
                                               (d % p.dw_tiles_n) * TILE, smem, row);
  }
}

template <typename TX, typename TW, typename TG, bool SR>
__global__ void __launch_bounds__(4 * sm90::GT, 2) bwd_pair_kernel(Pair p, double*) {
  extern __shared__ __align__(16) unsigned char smem[];
  pair_tile<TX, TW, TG, false, SR>(p, smem, nullptr);
}

template <typename TX, typename TW, typename TG, bool SR>
__global__ void __launch_bounds__(4 * sm90::GT, 2) bwd_pair_stats_kernel(Pair p, double* part) {
  extern __shared__ __align__(16) unsigned char smem[];
  pair_tile<TX, TW, TG, true, SR>(p, smem, part);
}

using PairKernel = void (*)(Pair, double*);

template <typename TX, typename TW, typename TG, bool STATS, bool SR = false>
PairKernel pair_kernel() {
  if constexpr (STATS)
    return bwd_pair_stats_kernel<TX, TW, TG, SR>;
  else
    return bwd_pair_kernel<TX, TW, TG, SR>;
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
    gq[i] = sm90::bf16_exact(sm90::quant(g[t * sgt + n * sgn], q));
  }
}

long long pair_blocks(int T, int K, int N) {
  return (long long)((T + TILE - 1) / TILE) * ((K + TILE - 1) / TILE)
         + (long long)((K + TILE - 1) / TILE) * ((N + TILE - 1) / TILE);
}

bool valid_groups(int groups) { return groups == 1 || groups == 2 || groups == 4; }

template <typename TX, typename TW, typename TG, bool STATS>
int pair_smem(int groups) {
  return sm90::smem_bytes(pair_stage<TX, TW, TG>(), groups, STATS);
}

template <typename TX, typename TW, typename TG, bool STATS, bool SR = false>
int set_smem(int groups) {
  return static_cast<int>(cudaFuncSetAttribute(pair_kernel<TX, TW, TG, STATS, SR>(),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               pair_smem<TX, TW, TG, STATS>(groups)));
}

// TG bf16: g goes through quantize_g_kernel into gq first; TG float: g is
// read as it is and quantized on landing where quant_g.  STATS (K9): each
// block's partial row into part, then the two rows into stats.  SR: dx's
// carry dithered under seed_bwd, dw's under seed_grad.
template <typename TX, typename TW, typename TG, bool STATS, bool SR>
int launch(const float* g, long long sgt, long long sgn, const void* x,
           long long sxt, long long sxk, const void* w, long long swk,
           long long swn, const float* dx_carry, float* dx, float* dw, int T,
           int K, int N, int bwd_chunk, int grad_chunk, sm90::Quant qr, int quant_g,
           sm90::Dec dec, sm90::Quant qbwd, sm90::Quant qgrad, int groups,
           unsigned seed_bwd, unsigned seed_grad, __nv_bfloat16* gq, double* part,
           float* stats, cudaStream_t s) {
  if (!valid_groups(groups)) return static_cast<int>(cudaErrorInvalidValue);
  if (SR && dx_carry != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = pair_blocks(T, K, N);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const void* G = g;
  if constexpr (std::is_same<TG, __nv_bfloat16>::value) {
    const long long n_all = (long long)T * N;
    const int qblocks = (int)std::min<long long>((n_all + 255) / 256, 65536LL);
    quantize_g_kernel<<<qblocks, 256, 0, s>>>(g, sgt, sgn, T, N, qr, gq);
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
                    dx, K, dx_carry, T, K, N, bwd_chunk, qr, qbwd, dec, seed_bwd};
  // dw[k, n] = sum_t x[t, k] g[t, n]: A = x^T (m = k, k = t), B = g
  p.dw = sm90::Gemm{sm90::operand(x, sizeof(TX), sxk, sxt, K, grad_chunk, 0),
                    sm90::operand(G, sizeof(TG), sgn, sgt, N, grad_chunk, quant_g),
                    dw, N, nullptr, K, N, T, grad_chunk, qr, qgrad, dec, seed_grad};
  p.dx_tiles_n = (K + TILE - 1) / TILE;
  p.dx_blocks = ((T + TILE - 1) / TILE) * p.dx_tiles_n;
  p.dw_tiles_n = (N + TILE - 1) / TILE;
  int rc = set_smem<TX, TW, TG, STATS, SR>(groups);
  if (rc != 0) return rc;
  const PairKernel kernel = pair_kernel<TX, TW, TG, STATS, SR>();
  kernel<<<(unsigned)blocks, groups * sm90::GT, pair_smem<TX, TW, TG, STATS>(groups), s>>>(
      p, part);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || !STATS) return rc;
  return stats_finish(part, p.dx_blocks, (int)blocks, 2, stats, s);
}

template <typename TX, typename TW, typename TG, bool STATS>
int occupancy(int groups) {
  if (!valid_groups(groups)) return -static_cast<int>(cudaErrorInvalidValue);
  int rc = set_smem<TX, TW, TG, STATS>(groups);
  int n = 0;
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, pair_kernel<TX, TW, TG, STATS>(), groups * sm90::GT,
        pair_smem<TX, TW, TG, STATS>(groups)));
  return rc != 0 ? -rc : n;
}

// f(TX, TW, TG) over the residual kinds B takes, (int8, int8) codes or raw
// f32/bf16 pairs, and g's: 0 f32 as it is, 1 bf16 through quantize_g_kernel
template <typename F>
int by_kinds(int x_kind, int w_kind, int g_kind, F f) {
  auto g_of = [&](auto tx, auto tw) {
    if (g_kind == 1) return f(tx, tw, bf{});
    if (g_kind == 0) return f(tx, tw, float{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (x_kind == 2 && w_kind == 2) return g_of(int8_t{}, int8_t{});
  if (x_kind == 0 && w_kind == 0) return g_of(float{}, float{});
  if (x_kind == 0 && w_kind == 1) return g_of(float{}, bf{});
  if (x_kind == 1 && w_kind == 1) return g_of(bf{}, bf{});
  if (x_kind == 1 && w_kind == 0) return g_of(bf{}, float{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The two entries' shared arguments, converted
struct Call {
  sm90::Quant qr, qbwd, qgrad;
  sm90::Dec dec;
  int sr;
  unsigned seed_bwd, seed_grad;
  __nv_bfloat16* gq;
  cudaStream_t s;
};

template <bool STATS>
int run(const void* g, long long sgt, long long sgn, const void* x, int x_kind,
        long long sxt, long long sxk, const void* w, int w_kind, long long swk,
        long long swn, const void* dx_carry, void* dx, void* dw, int T, int K, int N,
        int bwd_chunk, int grad_chunk, int quant_g, int groups, const Call& c,
        void* part, void* stats) {
  if (c.gq != nullptr && !quant_g) return static_cast<int>(cudaErrorInvalidValue);
  return by_kinds(x_kind, w_kind, c.gq != nullptr, [&](auto tx, auto tw, auto tg) {
    using TX = decltype(tx);
    using TW = decltype(tw);
    using TG = decltype(tg);
    auto go = [&](auto sr) {
      return launch<TX, TW, TG, STATS, decltype(sr)::value>(
          static_cast<const float*>(g), sgt, sgn, x, sxt, sxk, w, swk, swn,
          static_cast<const float*>(dx_carry), static_cast<float*>(dx),
          static_cast<float*>(dw), T, K, N, bwd_chunk, grad_chunk, c.qr, quant_g, c.dec,
          c.qbwd, c.qgrad, groups, c.seed_bwd, c.seed_grad, c.gq,
          static_cast<double*>(part), static_cast<float*>(stats), c.s);
    };
    return c.sr ? go(std::true_type{}) : go(std::false_type{});
  });
}

Call call_of(int e_r, int m_r, QFmt qr, QFmt qbwd, QFmt qgrad, int sr, unsigned seed_bwd,
             unsigned seed_grad, void* gq, void* stream) {
  return Call{sm90::quant_of(qr), sm90::quant_of(qbwd), sm90::quant_of(qgrad),
              sm90::dec_of(e_r, m_r), sr, seed_bwd, seed_grad,
              static_cast<__nv_bfloat16*>(gq), static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Strides are in elements; dx [T, K] and dw [K, N] are row-major; dx_carry
// is [T, K] row-major or null.  x_kind / w_kind: 0 f32, 1 bf16, 2 int8
// codes of (1, e_r, m_r).  gq: null (g read as f32), or a [T, N] bf16
// scratch that takes Q(g) first (quant_g with m_r <= 7).  groups: chunk
// groups a block (1, 2 or 4; kernels/sm90.py picks them).  sr: stochastic
// rounding of both carries, dx's dithered under seed_bwd and dw's under
// seed_grad (no dx_carry then).  Returns the cudaError_t of the launches.
extern "C" int bwd_pair(const void* g, long long sgt, long long sgn,
                        const void* x, int x_kind, long long sxt,
                        long long sxk, const void* w, int w_kind,
                        long long swk, long long swn, const void* dx_carry,
                        void* dx, void* dw, int T, int K, int N,
                        int bwd_chunk, int grad_chunk, int e_r, int m_r,
                        int r_identity, int r_shift, float r_max, float r_min,
                        int quant_g, int b_identity, int b_shift, float b_max,
                        float b_min, int w_identity, int w_shift,
                        float w_max, float w_min, int groups, int sr,
                        unsigned seed_bwd, unsigned seed_grad, void* gq,
                        void* stream) {
  const Call c = call_of(e_r, m_r, QFmt{r_identity, r_shift, r_max, r_min},
                         QFmt{b_identity, b_shift, b_max, b_min},
                         QFmt{w_identity, w_shift, w_max, w_min}, sr, seed_bwd,
                         seed_grad, gq, stream);
  return run<false>(g, sgt, sgn, x, x_kind, sxt, sxk, w, w_kind, swk, swn, dx_carry, dx,
                    dw, T, K, N, bwd_chunk, grad_chunk, quant_g, groups, c, nullptr,
                    nullptr);
}

// K9: bwd_pair (no carry in; sr and the seeds as there) plus stats
// [2, N_STATS] f32: row 0 dx (BWD), row 1 dw (GRAD); part holds
// bwd_pair_stats_blocks(T, K, N) rows of N_STATS doubles.
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
                              float w_min, int groups, int sr,
                              unsigned seed_bwd, unsigned seed_grad, void* gq,
                              void* part, void* stats, void* stream) {
  const Call c = call_of(e_r, m_r, QFmt{r_identity, r_shift, r_max, r_min},
                         QFmt{b_identity, b_shift, b_max, b_min},
                         QFmt{w_identity, w_shift, w_max, w_min}, sr, seed_bwd,
                         seed_grad, gq, stream);
  return run<true>(g, sgt, sgn, x, x_kind, sxt, sxk, w, w_kind, swk, swn, nullptr, dx, dw,
                   T, K, N, bwd_chunk, grad_chunk, quant_g, groups, c, part, stats);
}

// Partial rows bwd_pair_stats writes (its workspace `part`, in doubles:
// this times N_STATS).
extern "C" int bwd_pair_stats_blocks(int T, int K, int N) {
  const long long b = pair_blocks(T, K, N);
  return b > 0x7fffffffLL ? -1 : (int)b;
}

// Dynamic shared memory a block (bytes) and resident blocks an SM at
// `groups` chunk groups, of B and of K9; g_kind 0 f32, 1 bf16 (gq);
// kernels/sm90.py mirrors the first.
extern "C" int bwd_pair_smem(int x_kind, int w_kind, int g_kind, int groups) {
  return by_kinds(x_kind, w_kind, g_kind, [&](auto tx, auto tw, auto tg) {
    return pair_smem<decltype(tx), decltype(tw), decltype(tg), false>(groups);
  });
}
extern "C" int bwd_pair_occupancy(int x_kind, int w_kind, int g_kind, int groups) {
  return by_kinds(x_kind, w_kind, g_kind, [&](auto tx, auto tw, auto tg) {
    return occupancy<decltype(tx), decltype(tw), decltype(tg), false>(groups);
  });
}
extern "C" int bwd_pair_stats_smem(int x_kind, int w_kind, int g_kind, int groups) {
  return by_kinds(x_kind, w_kind, g_kind, [&](auto tx, auto tw, auto tg) {
    return pair_smem<decltype(tx), decltype(tw), decltype(tg), true>(groups);
  });
}
extern "C" int bwd_pair_stats_occupancy(int x_kind, int w_kind, int g_kind, int groups) {
  return by_kinds(x_kind, w_kind, g_kind, [&](auto tx, auto tw, auto tg) {
    return occupancy<decltype(tx), decltype(tw), decltype(tg), true>(groups);
  });
}
