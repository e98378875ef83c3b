// Device helpers shared by the Hopper kernels of repro_torch.
//
// Counterparts of repro/kernels/common.py::quantize_block, its
// stochastic-rounding quantize_block_sr and the Threefry-2x32 dither
// (threefry2x32, sr_random_bits), repro/quant/qtensor.py::unpack_block and
// the online-softmax constants of repro/kernels/attention.py.  Built without --use_fast_math and with
// --fmad=false, so every rounding below is the IEEE one the plain PyTorch
// versions perform.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// (1, e, m) quantizer constants, computed on the host (exact in f32).
struct QFmt {
  int identity;  // m >= 23 && e >= 8: quantization is the identity
  int shift;     // 23 - m: mantissa bits dropped
  float maxv;    // 2^(2^(e-1)-1) * (2 - 2^-m): saturation value
  float minn;    // 2^-(2^(e-1)-1): smallest normal; below flushes to 0
};

// Masked score: finite, so exp2f(NEG - m) is exactly 0 and a fully masked
// block never computes inf - inf.
#define REPRO_NEG (-1e30f)

// (1, e, m) round-to-nearest-even on the float's bits: saturating, flush to
// zero keeping the sign, NaN passed through.
__device__ __forceinline__ float quantize_rne(float x, const QFmt q) {
  if (q.identity) return x;
  unsigned xi = __float_as_uint(x) & 0x7fffffffu;  // |x| <= 0x7fffffff
  if (q.shift > 0) {
    const unsigned lsb = (xi >> q.shift) & 1u;
    xi = (xi + ((1u << (q.shift - 1)) - 1u + lsb)) & ~((1u << q.shift) - 1u);
  }
  float y = __uint_as_float(xi);
  if (isinf(x)) y = q.maxv;
  y = fminf(y, q.maxv);
  if (y < q.minn) y = 0.0f;
  if (signbit(x)) y = -y;
  return isnan(x) ? x : y;
}

// The 20-round Threefry-2x32 block on uint32 words: (key, counter) -> two
// words, every add mod 2^32 (repro/kernels/common.py::threefry2x32).
__device__ __forceinline__ uint2 threefry2x32(unsigned k0, unsigned k1, unsigned c0,
                                              unsigned c1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  unsigned x0 = c0 + ks[0], x1 = c1 + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rot[g % 2][r]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (unsigned)(g + 1);
  }
  return make_uint2(x0, x1);
}

// The stochastic-rounding dither of the output with flat logical index
// `flat` (row * n_cols + col, mod 2^32) at chunk `step`: key (seed, seed ^
// 0x9E3779B9), counter (flat, step), the first word (sr_random_bits).
__device__ __forceinline__ unsigned sr_bits(unsigned seed, unsigned step, unsigned flat) {
  return threefry2x32(seed, seed ^ 0x9E3779B9u, flat, step).x;
}

// (1, e, m) stochastic rounding: the dither's low 23 - m bits added to the
// magnitude's bits, then the dropped bits truncated; saturation, flush to
// zero, the sign and NaN as quantize_rne (quantize_block_sr).
__device__ __forceinline__ float quantize_sr(float x, const QFmt q, unsigned bits) {
  if (q.identity) return x;
  unsigned xi = __float_as_uint(x) & 0x7fffffffu;
  if (q.shift > 0) {
    const unsigned low = (1u << q.shift) - 1u;
    xi = (xi + (bits & low)) & ~low;
  }
  float y = __uint_as_float(xi);
  if (isinf(x)) y = q.maxv;
  y = fminf(y, q.maxv);
  if (y < q.minn) y = 0.0f;
  if (signbit(x)) y = -y;
  return isnan(x) ? x : y;
}

// int8 code [sign | exponent field (e) | mantissa (m)] -> exact float;
// exponent field 0 is +-0.
__device__ __forceinline__ float unpack_code(int8_t code, int e, int m) {
  const unsigned c = (unsigned)(uint8_t)code;
  const unsigned sign = (c >> (e + m)) & 1u;
  const unsigned ef = (c >> m) & ((1u << e) - 1u);
  const unsigned man = c & ((1u << m) - 1u);
  const unsigned bias = (1u << (e - 1)) - 1u;
  const unsigned mag = ef ? (((ef + 126u - bias) << 23) | (man << (23 - m))) : 0u;
  return __uint_as_float((sign << 31) | mag);
}

// float -> int8 code, the exact inverse of unpack_code on (1, e, m) values
// and bitwise repro_torch.quant.qtensor.pack_block on every float: the
// mantissa is truncated (quantize first), zero, subnormal and non-finite
// inputs pack to signed zero, and an exponent outside the format wraps in
// the low 8 bits exactly as pack_block's integer arithmetic does.
__device__ __forceinline__ int8_t pack_code(float x, int e, int m) {
  const unsigned xi = __float_as_uint(x);
  const unsigned sign = xi >> 31;
  const unsigned ieee_exp = (xi >> 23) & 0xffu;
  const unsigned bias = (1u << (e - 1)) - 1u;
  const bool normal = ieee_exp != 0u && ieee_exp != 0xffu;
  const unsigned ef = normal ? ieee_exp - (127u - bias - 1u) : 0u;
  const unsigned man = normal ? (xi >> (23 - m)) & ((1u << m) - 1u) : 0u;
  return (int8_t)(uint8_t)(((sign << (e + m)) | (ef << m) | man) & 0xffu);
}

// 2^se for an integer page scale exponent (|se| <= 120), exact.
__device__ __forceinline__ float exp2_int(int se) {
  return __uint_as_float((unsigned)(se + 127) << 23);
}

// Swamping-telemetry stats row (repro_torch/kernels/common.py: N_STATS and
// the STAT_* slots, the layout of repro/kernels/common.py).  Each block of a
// stats kernel reduces its tile's contributions to one partial row of
// doubles (fixed order: warp shuffles, then the warps in order); a second
// pass (stats_finish) sums the partial rows of each output row in a fixed
// order and rounds once to f32.  No float atomics: two launches on the same
// inputs give the same bits.
#define N_STATS 10
enum {
  STAT_COUNT, STAT_SUM_Q, STAT_SUMSQ_Q, STAT_SUM_I, STAT_SUMSQ_I,
  STAT_MAX_ABS, STAT_SWAMPED, STAT_ADDS, STAT_SUM_ERR, STAT_SUMSQ_ERR
};

// Ensemble moments of one final output: q the reduced-precision carry,
// w the ideal (f32) shadow; the error q - w is exact in double.
__device__ __forceinline__ void stats_moments(double* v, float q, float w) {
  const double dq = q, dw = w, err = dq - dw;
  v[STAT_COUNT] += 1.0;
  v[STAT_SUM_Q] += dq;
  v[STAT_SUMSQ_Q] += dq * dq;
  v[STAT_SUM_I] += dw;
  v[STAT_SUMSQ_I] += dw * dw;
  v[STAT_SUM_ERR] += err;
  v[STAT_SUMSQ_ERR] += err * err;
}

__device__ __forceinline__ double stats_merge(double a, double b, int slot) {
  return slot == STAT_MAX_ABS ? fmax(a, b) : a + b;
}

// The block's partial row: every thread of the block calls this with its
// own contributions v; sh holds NT / 32 * N_STATS doubles.
template <int NT>
__device__ __forceinline__ void stats_block_row(const double* v, double* out,
                                                double* sh) {
  static_assert(NT % 32 == 0, "");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < N_STATS; ++s) {
    double r = v[s];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      r = stats_merge(r, __shfl_down_sync(0xffffffffu, r, o), s);
    if (lane == 0) sh[warp * N_STATS + s] = r;
  }
  __syncthreads();
  if (threadIdx.x < N_STATS) {
    const int s = threadIdx.x;
    double acc = sh[s];
    for (int w = 1; w < NT / 32; ++w) acc = stats_merge(acc, sh[w * N_STATS + s], s);
    out[s] = acc;
  }
}

#define STATS_FINISH_THREADS 256

namespace {

// Second pass: output row r sums partial rows [lo, hi) with lo/hi = 0/split
// for r = 0 and split/total for r = 1; each thread takes a contiguous run
// of rows in order, then thread 0 adds the runs in order.
__global__ void __launch_bounds__(STATS_FINISH_THREADS) stats_finish_kernel(
    const double* __restrict__ part, int split, int total,
    float* __restrict__ out) {
  __shared__ double sh[STATS_FINISH_THREADS];
  const int r = blockIdx.x;
  const int lo = r == 0 ? 0 : split, hi = r == 0 ? split : total;
  const int per = (hi - lo + STATS_FINISH_THREADS - 1) / STATS_FINISH_THREADS;
  const int b0 = lo + threadIdx.x * per, b1 = min(b0 + per, hi);
  for (int s = 0; s < N_STATS; ++s) {
    double acc = 0.0;
    for (int b = b0; b < b1; ++b) acc = stats_merge(acc, part[(long long)b * N_STATS + s], s);
    sh[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      double t = sh[0];
      for (int i = 1; i < STATS_FINISH_THREADS; ++i) t = stats_merge(t, sh[i], s);
      out[r * N_STATS + s] = __double2float_rn(t);
    }
    __syncthreads();
  }
}

// rows = 1: out[0] over all partial rows; rows = 2: out[0] over [0, split),
// out[1] over [split, total).
static inline int stats_finish(const double* part, int split, int total,
                               int rows, float* out, cudaStream_t s) {
  stats_finish_kernel<<<rows, STATS_FINISH_THREADS, 0, s>>>(part, split, total, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// limits of the attention kernels' tiles (mirrored in
// repro_torch/kernels/attention.py)
#define MAX_DH 128
#define MAX_G 8
