// E on Hopper: the training forward, the fused quantized GEMM that also
// emits the int8 codes of both quantized operands for the backward.
//
// Replaces repro/kernels/fused.py::_fused_kernel_emitq (RNE carry):
// C[M, N] = sum over chunks of K of carry = q_acc(carry + Q(A_c) . Q(B_c)),
// chunk = the plan's n1, plus Aq [M, K] and Bq [K, N], the codes of Q(A) and
// Q(B) in row-major order (quant/qtensor.py's layout).
//
// Two launches a call:
// * quantize_pack_kernel, a grid-stride pass over A and B read once
//   through their strides (f32 or bf16; 8 elements a thread in 16-byte
//   pieces where the rows allow it): each element's Q(v) goes out as
//   its int8 code (pack_code, written exactly once) and as the bf16 of the
//   same value into a row-major scratch.  A packable format (1 + e + m <=
//   8) has at most 7 mantissa bits, so its values are exact in bf16; NaN
//   stays NaN.  The GEMM does not run on the codes: pack_code maps NaN and
//   Inf to signed zero, and C must stay bitwise the plain version there.
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
#include "qgemm_sm90.cuh"

#include <algorithm>

namespace {

using bf = __nv_bfloat16;
using sm90::TILE;

constexpr int STAGE = sm90::stage_bytes<bf, bf>();

// One operand of the pass: src[r, c] = src[r * s_r + c * s_c], out in
// row-major [rows, cols] order.  vec: rows of 16-byte aligned runs of 8
// elements (s_c 1, cols a multiple of 8, base and row pitch 16-byte
// aligned), which a thread takes at once.
struct Pack {
  const void* src;
  long long s_r, s_c;
  int rows, cols;
  int vec;
  int8_t* codes;
  bf* q;
};

template <typename T>
Pack pack_of(const void* src, long long s_r, long long s_c, int rows, int cols, int8_t* codes,
             bf* q) {
  const int vec = s_c == 1 && cols % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                  (s_r * (long long)sizeof(T)) % 16 == 0;
  return Pack{src, s_r, s_c, rows, cols, vec, codes, q};
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

// Elements (vec: runs of 8) a thread of the pass takes in turn.
__host__ __device__ inline long long pack_items(const Pack& p) {
  const long long n = (long long)p.rows * p.cols;
  return p.vec ? n / 8 : n;
}

template <typename T>
__device__ __forceinline__ void pack(const Pack& p, const sm90::Quant& q, int e, int m) {
  const T* src = static_cast<const T*>(p.src);
  const long long items = pack_items(p), stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < items; t += stride) {
    if (p.vec) {  // 16-byte loads, 8 codes and 8 bf16 values stored at once
      const long long i = t * 8, r = i / p.cols, c = i % p.cols;
      float v[8];
      load8(src + r * p.s_r + c, v);
      unsigned codes[2] = {0u, 0u}, qv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = sm90::quant(v[j], q);
        codes[j >> 2] |= (unsigned)(uint8_t)pack_code(x, e, m) << ((j & 3) * 8);
        qv[j >> 1] |= (unsigned)__bfloat16_as_ushort(sm90::bf16_exact(x)) << ((j & 1) * 16);
      }
      *reinterpret_cast<uint2*>(p.codes + i) = make_uint2(codes[0], codes[1]);
      *reinterpret_cast<uint4*>(p.q + i) = make_uint4(qv[0], qv[1], qv[2], qv[3]);
    } else {
      const long long r = t / p.cols, c = t % p.cols;
      const float x = sm90::quant(widen(src[r * p.s_r + c * p.s_c]), q);
      p.codes[t] = pack_code(x, e, m);
      p.q[t] = sm90::bf16_exact(x);
    }
  }
}

// blockIdx.y 0 packs A, 1 packs B
template <typename TA, typename TB>
__global__ void __launch_bounds__(256) quantize_pack_kernel(Pack a, Pack b, sm90::Quant q,
                                                            int e, int m) {
  if (blockIdx.y == 0)
    pack<TA>(a, q, e, m);
  else
    pack<TB>(b, q, e, m);
}

__global__ void __launch_bounds__(4 * sm90::GT, 2) qgemm_emitq_kernel(sm90::Gemm p) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::block_tile<bf, bf, STAGE, false>(p, blockIdx.y * TILE, blockIdx.x * TILE, smem,
                                         nullptr);
}

bool valid_groups(int groups) { return groups == 1 || groups == 2 || groups == 4; }

int gemm_smem(int groups) { return sm90::smem_bytes(STAGE, groups, false); }

int set_smem(int groups) {
  return static_cast<int>(cudaFuncSetAttribute(
      qgemm_emitq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gemm_smem(groups)));
}

template <typename TA, typename TB>
int launch(const void* A, long long sam, long long sak, const void* B, long long sbk,
           long long sbn, float* C, int M, int N, int K, int chunk, int e_r, int m_r,
           QFmt qr, QFmt qacc, int groups, int8_t* Aq, int8_t* Bq, bf* QA, bf* QB,
           cudaStream_t s) {
  if (!valid_groups(groups)) return static_cast<int>(cudaErrorInvalidValue);
  const sm90::Quant q = sm90::quant_of(qr);
  const Pack pa = pack_of<TA>(A, sam, sak, M, K, Aq, QA);
  const Pack pb = pack_of<TB>(B, sbk, sbn, K, N, Bq, QB);
  const long long most = std::max(pack_items(pa), pack_items(pb));
  const int blocks = (int)std::min<long long>((most + 255) / 256, 65536LL);
  quantize_pack_kernel<TA, TB><<<dim3(blocks, 2), 256, 0, s>>>(pa, pb, q, e_r, m_r);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  // Q(A) [M, K] along k, Q(B) [K, N] along n; no quantization left
  const sm90::Gemm p{sm90::operand(QA, 2, K, 1, M, chunk, 0),
                     sm90::operand(QB, 2, 1, N, N, chunk, 0),
                     C, N, nullptr, M, N, K, chunk, q, sm90::quant_of(qacc),
                     sm90::dec_of(e_r, m_r)};
  rc = set_smem(groups);
  if (rc != 0) return rc;
  dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  qgemm_emitq_kernel<<<grid, groups * sm90::GT, gemm_smem(groups), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one GEMM block (bytes) and resident blocks an SM
// at `groups` chunk groups (or a negative error); kernels/sm90.py mirrors
// the first.
extern "C" int qgemm_emitq_smem(int groups) { return gemm_smem(groups); }
extern "C" int qgemm_emitq_occupancy(int groups) {
  if (!valid_groups(groups)) return -static_cast<int>(cudaErrorInvalidValue);
  int rc = set_smem(groups);
  int n = 0;
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, qgemm_emitq_kernel, groups * sm90::GT, gemm_smem(groups)));
  return rc != 0 ? -rc : n;
}

// E.  a_bf16 / b_bf16: the operand is bf16, else f32; strides in elements.
// C [M, N] f32, Aq [M, K] and Bq [K, N] int8 codes of (1, e_r, m_r), all
// row-major; QA [M, K] and QB [K, N] bf16 scratches; groups: chunk groups a
// block (1, 2 or 4; kernels/sm90.py picks them).  Returns the cudaError_t
// of the launches.
extern "C" int qgemm_emitq(const void* A, int a_bf16, long long sam, long long sak,
                           const void* B, int b_bf16, long long sbk, long long sbn,
                           void* C, int M, int N, int K, int chunk, int e_r, int m_r,
                           int r_identity, int r_shift, float r_max, float r_min,
                           int c_identity, int c_shift, float c_max, float c_min,
                           int groups, void* Aq, void* Bq, void* QA, void* QB,
                           void* stream) {
  const QFmt qr{r_identity, r_shift, r_max, r_min};
  const QFmt qacc{c_identity, c_shift, c_max, c_min};
  float* out = static_cast<float*>(C);
  int8_t* aq = static_cast<int8_t*>(Aq);
  int8_t* bq = static_cast<int8_t*>(Bq);
  bf* qa = static_cast<bf*>(QA);
  bf* qb = static_cast<bf*>(QB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EMITQ_ARGS A, sam, sak, B, sbk, sbn, out, M, N, K, chunk, e_r, m_r, qr, qacc, groups, \
                   aq, bq, qa, qb, s
  if (a_bf16 && b_bf16) return launch<bf, bf>(EMITQ_ARGS);
  if (a_bf16) return launch<bf, float>(EMITQ_ARGS);
  if (b_bf16) return launch<float, bf>(EMITQ_ARGS);
  return launch<float, float>(EMITQ_ARGS);
#undef EMITQ_ARGS
}
