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
// view).  g is quantized to the representation format on load in both
// roles, which equals the TPU kernel's quantize-once-per-landing value.
//
// The grid is one dimension: the first blocks are the dx tiles (each walks
// all of N, the long sums), the rest the dw tiles (each walks T).  A tile is
// qgemm_core.cuh's loop on strided views, so nothing is transposed in
// memory.  A dx carry in (dx_carry) resumes a running dx: chaining block-aligned
// N segments, each with the previous segment's dx as its carry, is bitwise
// the unsplit call (the carry values are exact format points and the chunk
// cadence is unchanged).
//
// The TPU kernel keeps a (block_k, N) dw slab in VMEM so that g lands once;
// here each role reads g itself, and the dw carry lives in the registers of
// its own tile.  Bound on the H100: the f32 arithmetic (2 x 2TKN operations
// on the CUDA cores); the lm_head's dx has only (T/64)(K/64) tiles, each
// walking all 151936 columns, so it runs on part of the card.
#include "qgemm_core.cuh"

namespace {

using bf = __nv_bfloat16;
constexpr int BM = 64, BN = 64, TM = 4, TN = 4, KT = 32, NT = 256;

template <typename TX, typename TW>
struct PairArgs {
  qcore::Args<float, TW> dx;  // A = g [T, N], B = w^T [N, K]
  qcore::Args<TX, float> dw;  // A = x^T [K, T], B = g [T, N]
  int dx_tiles_n;             // dx column tiles (over K)
  int dx_blocks;              // dx tiles in all
  int dw_tiles_n;             // dw column tiles (over N)
};

template <typename TX, typename TW>
__global__ void __launch_bounds__(NT) bwd_pair_kernel(PairArgs<TX, TW> p) {
  __shared__ float As[KT][BM + 1];
  __shared__ float Bs[KT][BN + 1];
  const int b = blockIdx.x;
  if (b < p.dx_blocks) {
    const int tm = b / p.dx_tiles_n, tn = b % p.dx_tiles_n;
    qcore::tile<BM, BN, TM, TN, KT, NT, false>(p.dx, tm * BM, tn * BN, false,
                                               false, As, Bs);
  } else {
    const int d = b - p.dx_blocks;
    const int tm = d / p.dw_tiles_n, tn = d % p.dw_tiles_n;
    qcore::tile<BM, BN, TM, TN, KT, NT, false>(p.dw, tm * BM, tn * BN, false,
                                               false, As, Bs);
  }
}

template <typename TX, typename TW>
int launch(const float* g, long long sgt, long long sgn, const void* x,
           long long sxt, long long sxk, const void* w, long long swk,
           long long swn, const float* dx_carry, float* dx, float* dw, int T,
           int K, int N, int bwd_chunk, int grad_chunk, QFmt qr, int quant_g,
           qcore::Dec dec, QFmt qbwd, QFmt qgrad, cudaStream_t s) {
  const TX* X = static_cast<const TX*>(x);
  const TW* W = static_cast<const TW*>(w);
  PairArgs<TX, TW> p;
  // dx[t, k] = sum_n g[t, n] w[k, n]: A = g (m = t, k = n), B = w^T
  // (k = n, n = k)
  p.dx = qcore::Args<float, TW>{g, sgt, sgn, W, swn, swk, dx, K, dx_carry,
                                T, K, N, bwd_chunk, qr, quant_g, 0, dec,
                                qbwd, nullptr, nullptr, dec};
  // dw[k, n] = sum_t x[t, k] g[t, n]: A = x^T (m = k, k = t), B = g
  p.dw = qcore::Args<TX, float>{X, sxk, sxt, g, sgt, sgn, dw, N, nullptr,
                                K, N, T, grad_chunk, qr, 0, quant_g, dec,
                                qgrad, nullptr, nullptr, dec};
  p.dx_tiles_n = (K + BN - 1) / BN;
  p.dx_blocks = ((T + BM - 1) / BM) * p.dx_tiles_n;
  p.dw_tiles_n = (N + BN - 1) / BN;
  const long long blocks =
      (long long)p.dx_blocks + (long long)((K + BM - 1) / BM) * p.dw_tiles_n;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bwd_pair_kernel<TX, TW><<<(unsigned)blocks, NT, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements; dx [T, K] and dw [K, N] are row-major; dx_carry
// is [T, K] row-major or null.  x_kind / w_kind: 0 f32, 1 bf16, 2 int8
// codes of (1, e_r, m_r).  Returns the cudaError_t of the launch.
extern "C" int bwd_pair(const void* g, long long sgt, long long sgn,
                        const void* x, int x_kind, long long sxt,
                        long long sxk, const void* w, int w_kind,
                        long long swk, long long swn, const void* dx_carry,
                        void* dx, void* dw, int T, int K, int N,
                        int bwd_chunk, int grad_chunk, int e_r, int m_r,
                        int r_identity, int r_shift, float r_max, float r_min,
                        int quant_g, int b_identity, int b_shift, float b_max,
                        float b_min, int w_identity, int w_shift,
                        float w_max, float w_min, void* stream) {
  const QFmt qr{r_identity, r_shift, r_max, r_min};
  const QFmt qbwd{b_identity, b_shift, b_max, b_min};
  const QFmt qgrad{w_identity, w_shift, w_max, w_min};
  const qcore::Dec dec{e_r, m_r};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* G = static_cast<const float*>(g);
  const float* Cin = static_cast<const float*>(dx_carry);
  float* DX = static_cast<float*>(dx);
  float* DW = static_cast<float*>(dw);
#define PAIR_ARGS G, sgt, sgn, x, sxt, sxk, w, swk, swn, Cin, DX, DW, T, K, N, bwd_chunk, grad_chunk, qr, quant_g, dec, qbwd, qgrad, s
  if (x_kind == 2 && w_kind == 2) return launch<int8_t, int8_t>(PAIR_ARGS);
  if (x_kind == 0 && w_kind == 0) return launch<float, float>(PAIR_ARGS);
  if (x_kind == 0 && w_kind == 1) return launch<float, bf>(PAIR_ARGS);
  if (x_kind == 1 && w_kind == 1) return launch<bf, bf>(PAIR_ARGS);
  if (x_kind == 1 && w_kind == 0) return launch<bf, float>(PAIR_ARGS);
#undef PAIR_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
