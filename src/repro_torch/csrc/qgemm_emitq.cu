// E on Hopper: the training forward, the fused quantized GEMM that also
// emits the int8 codes of both quantized operands for the backward.
//
// Replaces repro/kernels/fused.py::_fused_kernel_emitq (RNE and SR carry):
// C[M, N] = sum over chunks of K of carry = q_acc(carry + Q(A_c) . Q(B_c)),
// chunk = the plan's n1, plus Aq [M, K] and Bq [K, N], the codes of Q(A) and
// Q(B) in row-major order (quant/qtensor.py's layout).  Under stochastic
// rounding (sr, seed) the tile's fold dithers each carry update
// (qgemm_sm90.cuh); the quantize-and-pack pass is the same, since SR
// touches only the carries.
//
// Two launches a call, one entry (qgemm_emitq):
// * quantize_pass_kernel, a grid-stride pass over A and B read once
//   through their strides (f32 or bf16; 8 elements a thread in 16-byte
//   pieces where the rows allow it): each element's Q(v) goes out as
//   its int8 code (pack_code, written exactly once) and as the value
//   itself into a row-major scratch.  A packable format (1 + e + m <=
//   8) has at most 7 mantissa bits, so its values are exact in a bf16
//   scratch; NaN stays NaN.  The GEMM does not run on the codes: pack_code
//   maps NaN and Inf to signed zero, and C must stay bitwise the plain
//   version there.
// * qgemm_emitq_kernel, qgemm_sm90.cuh's tile on the two bf16 scratches
//   with no quantization left to do: C is bitwise K8's on the same
//   operands, which decodes Q(v) to the same f32 values.
//
// Bound on the H100: the f32 FMAs on the CUDA cores (2MNK operations at
// 67 TFLOP/s): the bitwise contract fixes each chunk's partial to the
// sequential round-to-nearest f32 chain, which a tensor-core MMA does not
// form (qgemm_sm90.cuh).  The pass moves M*K + K*N elements in (f32 or
// bf16) and 3 bytes an element out; its 16-byte path took one training
// step's 196 E calls from 85.5 to 78.3 ms on the H100
// (tools/sm90/emitq_pass.py).  In exchange the tile lands 2 bytes an
// element and its decode only widens them (no quantize in the hot loop, as
// B's Q(g) scratch), and no block needs a role for writing the codes.
//
// The variants, through the same entry and the same pass: the output
// epilogue of repro/kernels/fused.py::_emit_output (out_fmt, pack_out) on
// the tile's store (qgemm_emitq_out_kernel, the tile's OUT flag); f32
// residuals (return_quantized without pack_residuals, any repr_fmt, also
// one wider than 8 bits): the pass writes Q(A) and Q(B) as floats and no
// codes, and the floats are both the residuals and the operands the tile
// runs on; and quantize_a / quantize_b off per operand (the residual is
// then the operand as it is, or its code).  The bf16 scratch is exact only
// for a quantized packable format; otherwise the scratch is f32 and the
// tile is the out kernel (its epilogue the identity without out_fmt).  The
// base call (codes, both operands quantized, no out_fmt) runs
// qgemm_emitq_kernel, so its code and registers stay as they were.
#include "qgemm_sm90.cuh"

#include <algorithm>
#include <type_traits>

namespace {

using bf = __nv_bfloat16;
using sm90::TILE;

// One operand of the pass: src[r, c] = src[r * s_r + c * s_c]; its Q
// values go out in row-major [rows, cols] order into q, of the scratch's
// type, and, unless codes is null (f32 residuals), as int8 codes.  vec:
// rows of 16-byte aligned runs of 8 elements (s_c 1, cols a multiple of 8,
// base and row pitch 16-byte aligned), which a thread takes at once.
struct Pass {
  const void* src;
  long long s_r, s_c;
  int rows, cols;
  int vec;
  int8_t* codes;
  void* q;
};

template <typename T>
Pass pass_of(const void* src, long long s_r, long long s_c, int rows, int cols, int8_t* codes,
             void* q) {
  const int vec = s_c == 1 && cols % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                  (s_r * (long long)sizeof(T)) % 16 == 0;
  return Pass{src, s_r, s_c, rows, cols, vec, codes, q};
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf v) { return __bfloat162float(v); }

// 8 elements from a 16-byte aligned address, as f32 (bf16 widened by its
// bits, as __bfloat162float)
__device__ __forceinline__ void load8(const float* s, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf* s, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(s);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __uint_as_float(((w[e >> 1] >> ((e & 1) * 16)) & 0xffffu) << 16);
}

__device__ __forceinline__ void store1(bf* d, float x) { *d = sm90::bf16_exact(x); }
__device__ __forceinline__ void store1(float* d, float x) { *d = x; }
__device__ __forceinline__ void store8(bf* d, const float (&x)[8]) {
  unsigned qv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    qv[j >> 1] |= (unsigned)__bfloat16_as_ushort(sm90::bf16_exact(x[j])) << ((j & 1) * 16);
  *reinterpret_cast<uint4*>(d) = make_uint4(qv[0], qv[1], qv[2], qv[3]);
}
__device__ __forceinline__ void store8(float* d, const float (&x)[8]) {
  reinterpret_cast<float4*>(d)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(d)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// Elements (vec: runs of 8) a thread of the pass takes in turn.
__host__ __device__ inline long long pass_items(const Pass& p) {
  const long long n = (long long)p.rows * p.cols;
  return p.vec ? n / 8 : n;
}

// One operand through the pass: Q(v) under q into the TS scratch and, with
// codes, as its int8 code of (1, e, m)
template <typename T, typename TS>
__device__ __forceinline__ void pass(const Pass& p, const sm90::Quant& q, int e, int m) {
  const T* src = static_cast<const T*>(p.src);
  TS* dst = static_cast<TS*>(p.q);
  const long long items = pass_items(p), stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < items; t += stride) {
    if (p.vec) {  // 16-byte loads, 8 codes and 8 values stored at once
      const long long i = t * 8, r = i / p.cols, c = i % p.cols;
      float v[8], x[8];
      load8(src + r * p.s_r + c, v);
      unsigned codes[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[j] = sm90::quant(v[j], q);
        codes[j >> 2] |= (unsigned)(uint8_t)pack_code(x[j], e, m) << ((j & 3) * 8);
      }
      if (p.codes != nullptr)
        *reinterpret_cast<uint2*>(p.codes + i) = make_uint2(codes[0], codes[1]);
      store8(dst + i, x);
    } else {
      const long long r = t / p.cols, c = t % p.cols;
      const float x = sm90::quant(widen(src[r * p.s_r + c * p.s_c]), q);
      if (p.codes != nullptr) p.codes[t] = pack_code(x, e, m);
      store1(dst + t, x);
    }
  }
}

// blockIdx.y 0 passes A (quantized under qa), 1 passes B (under qb)
template <typename TA, typename TB, typename TS>
__global__ void __launch_bounds__(256) quantize_pass_kernel(Pass a, Pass b, sm90::Quant qa,
                                                            sm90::Quant qb, int e, int m) {
  if (blockIdx.y == 0)
    pass<TA, TS>(a, qa, e, m);
  else
    pass<TB, TS>(b, qb, e, m);
}

bool valid_groups(int groups) { return groups == 1 || groups == 2 || groups == 4; }

// The GEMM on the scratches: the base kernel on bf16 ones, and the out
// kernel (the tile's OUT flag: the output epilogue in its store) on bf16
// or f32 ones
template <bool SR>
__global__ void __launch_bounds__(4 * sm90::GT, 2) qgemm_emitq_kernel(sm90::Gemm p) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::block_tile<bf, bf, sm90::stage_bytes<bf, bf>(), false, SR>(
      p, blockIdx.y * TILE, blockIdx.x * TILE, smem, nullptr);
}

template <typename TS, bool SR>
__global__ void __launch_bounds__(4 * sm90::GT, 2) qgemm_emitq_out_kernel(sm90::Gemm p) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::block_tile<TS, TS, sm90::stage_bytes<TS, TS>(), false, SR, true>(
      p, blockIdx.y * TILE, blockIdx.x * TILE, smem, nullptr);
}

template <typename TS, bool SR, bool OUT>
auto gemm_kernel() {
  if constexpr (OUT)
    return qgemm_emitq_out_kernel<TS, SR>;
  else
    return qgemm_emitq_kernel<SR>;
}

template <typename TS>
int gemm_smem(int groups) {
  return sm90::smem_bytes(sm90::stage_bytes<TS, TS>(), groups, false);
}

template <typename TS, bool SR, bool OUT>
int set_smem(int groups) {
  return static_cast<int>(cudaFuncSetAttribute(gemm_kernel<TS, SR, OUT>(),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               gemm_smem<TS>(groups)));
}

template <typename TS, bool SR, bool OUT>
int gemm_launch(const sm90::Gemm& p, int groups, cudaStream_t s) {
  const int rc = set_smem<TS, SR, OUT>(groups);
  if (rc != 0) return rc;
  dim3 grid((p.N + TILE - 1) / TILE, (p.M + TILE - 1) / TILE);
  const auto kernel = gemm_kernel<TS, SR, OUT>();
  kernel<<<grid, groups * sm90::GT, gemm_smem<TS>(groups), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TS>
int occupancy(int groups, bool out) {
  if (!valid_groups(groups)) return -static_cast<int>(cudaErrorInvalidValue);
  int rc = out ? set_smem<TS, false, true>(groups) : set_smem<TS, false, false>(groups);
  int n = 0;
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, out ? (const void*)gemm_kernel<TS, false, true>()
                : (const void*)gemm_kernel<TS, false, false>(),
        groups * sm90::GT, gemm_smem<TS>(groups)));
  return rc != 0 ? -rc : n;
}

// The pass into codes (packr) and a TS scratch, or into the f32 residuals
// (Aq, Bq), then the tile on the scratch: the base kernel on a bf16 one
// without an output format, the out kernel otherwise
template <typename TA, typename TB, typename TS>
int launch(const void* A, long long sam, long long sak, const void* B, long long sbk,
           long long sbn, void* C, int M, int N, int K, int chunk, int e_r, int m_r, QFmt qa,
           QFmt qb, QFmt qacc, QFmt qout, int pack_out, int e_o, int m_o, int packr,
           int groups, int sr, unsigned seed, int row0, int col0, int n_cols, void* Aq,
           void* Bq, void* QA, void* QB, cudaStream_t s) {
  if (!valid_groups(groups)) return static_cast<int>(cudaErrorInvalidValue);
  void* sa = packr ? QA : Aq;
  void* sb = packr ? QB : Bq;
  int8_t* ca = packr ? static_cast<int8_t*>(Aq) : nullptr;
  int8_t* cb = packr ? static_cast<int8_t*>(Bq) : nullptr;
  const Pass pa = pass_of<TA>(A, sam, sak, M, K, ca, sa);
  const Pass pb = pass_of<TB>(B, sbk, sbn, K, N, cb, sb);
  const long long most = std::max(pass_items(pa), pass_items(pb));
  const int blocks = (int)std::min<long long>((most + 255) / 256, 65536LL);
  quantize_pass_kernel<TA, TB, TS><<<dim3(blocks, 2), 256, 0, s>>>(
      pa, pb, sm90::quant_of(qa), sm90::quant_of(qb), e_r, m_r);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  // Q(A) [M, K] along k, Q(B) [K, N] along n; no quantization left
  sm90::Gemm p{sm90::operand(sa, sizeof(TS), K, 1, M, chunk, 0),
               sm90::operand(sb, sizeof(TS), 1, N, N, chunk, 0),
               static_cast<float*>(C), N, nullptr, M, N, K, chunk, sm90::quant_of(qa),
               sm90::quant_of(qacc), sm90::dec_of(e_r, m_r), seed};
  p.row0 = row0;
  p.col0 = col0;
  p.ldf = n_cols;
  p.qout = sm90::quant_of(qout);
  p.pack = pack_out;
  p.e_o = e_o;
  p.m_o = m_o;
  if constexpr (std::is_same<TS, bf>::value) {
    if (qout.identity && !pack_out)
      return sr ? gemm_launch<bf, true, false>(p, groups, s)
                : gemm_launch<bf, false, false>(p, groups, s);
  }
  return sr ? gemm_launch<TS, true, true>(p, groups, s) : gemm_launch<TS, false, true>(p, groups, s);
}

}  // namespace

// Dynamic shared memory of one GEMM block (bytes) and resident blocks an SM
// at `groups` chunk groups (or a negative error); kernels/sm90.py mirrors
// the first.  The base kernel, and the out kernel on a bf16 (f32 0) or f32
// (1) scratch.
extern "C" int qgemm_emitq_smem(int groups) { return gemm_smem<bf>(groups); }
extern "C" int qgemm_emitq_occupancy(int groups) { return occupancy<bf>(groups, false); }
extern "C" int qgemm_emitq_out_smem(int f32, int groups) {
  return f32 ? gemm_smem<float>(groups) : gemm_smem<bf>(groups);
}
extern "C" int qgemm_emitq_out_occupancy(int f32, int groups) {
  return f32 ? occupancy<float>(groups, true) : occupancy<bf>(groups, true);
}

// E.  a_bf16 / b_bf16: the operand is bf16, else f32; strides in elements.
// C [M, N] f32 (with pack_out int8), row-major.  The quantization of A and
// of B apart (qa_*, qb_*: the identity where an operand is not quantized),
// the carry's format (c_*), the output epilogue (o_*: C rounded to nearest
// even into it, the identity leaving C as it is; pack_out: C is M x N int8
// codes of (1, e_o, m_o)).  The residuals: packr 1, Aq [M, K] and Bq [K, N]
// are int8 codes of (1, e_r, m_r) and QA and QB the scratches the GEMM
// reads, f32 (scratch_f32) or bf16 (exact only for a quantized packable
// format); packr 0, Aq and Bq are the f32 residuals and the GEMM reads them
// (QA, QB unused).  groups: chunk groups a block (1, 2 or 4;
// kernels/sm90.py picks them); sr: stochastic rounding of the carry,
// dithered under seed, C being the block at (row0, col0) of a whole output
// of n_cols columns (0: N; RNE ignores the three).  Returns the
// cudaError_t of the launches.
extern "C" int qgemm_emitq(const void* A, int a_bf16, long long sam, long long sak,
                           const void* B, int b_bf16, long long sbk, long long sbn,
                           void* C, int M, int N, int K, int chunk, int e_r, int m_r,
                           int qa_identity, int qa_shift, float qa_max, float qa_min,
                           int qb_identity, int qb_shift, float qb_max, float qb_min,
                           int c_identity, int c_shift, float c_max, float c_min,
                           int o_identity, int o_shift, float o_max, float o_min,
                           int pack_out, int e_o, int m_o, int packr, int scratch_f32,
                           int groups, int sr, unsigned seed, int row0, int col0,
                           int n_cols, void* Aq, void* Bq, void* QA, void* QB,
                           void* stream) {
  const QFmt qa{qa_identity, qa_shift, qa_max, qa_min};
  const QFmt qb{qb_identity, qb_shift, qb_max, qb_min};
  const QFmt qacc{c_identity, c_shift, c_max, c_min};
  const QFmt qout{o_identity, o_shift, o_max, o_min};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = scratch_f32 || !packr;
  auto go = [&](auto ta, auto tb) {
    using TA = decltype(ta);
    using TB = decltype(tb);
#define EMITQ_ARGS A, sam, sak, B, sbk, sbn, C, M, N, K, chunk, e_r, m_r, qa, qb, qacc, qout, \
                   pack_out, e_o, m_o, packr, groups, sr, seed, row0, col0, n_cols, Aq, Bq, \
                   QA, QB, s
    return f32 ? launch<TA, TB, float>(EMITQ_ARGS) : launch<TA, TB, bf>(EMITQ_ARGS);
#undef EMITQ_ARGS
  };
  if (a_bf16 && b_bf16) return go(bf{}, bf{});
  if (a_bf16) return go(bf{}, float{});
  if (b_bf16) return go(float{}, bf{});
  return go(float{}, float{});
}
