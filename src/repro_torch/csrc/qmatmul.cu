// K3: C = A . B with a chunked (1, e_acc, m_acc) carry, operands taken as
// they are (no operand quantization).
//
// Replaces repro/kernels/qmatmul.py::_qmatmul_kernel (qmatmul_pallas), the
// GEMM of the unfused qdot oracle: there one grid step contracts one K tile
// (= one chunk, n1 = block_k) on the MXU in f32 and rounds the running
// carry to (1, e_acc, m_acc); here every output element forms
//
//   partial = sum over the chunk, in increasing k, of fma(a, b, partial)
//   carry   = q_acc(carry + partial)
//
// once per chunk (a ragged last chunk folds what it has).  This is its own
// tile loop, written apart from qgemm_core.cuh and qgemm_sm90.cuh, so that
// the oracle on the card checks G, E and B against an independent kernel;
// the operation sequence per output is the same by design.
//
// A block computes a 64 x 64 tile of C with 256 threads, each holding a
// 4 x 4 patch of partials and carries in registers.  K is staged 16 values
// at a time through shared memory; the next K tile's global loads are issued
// into registers before the current one is computed.  Shared tiles are read
// as float4 (each thread's four rows or columns are neighbours).  Operands
// are f32 or bf16 of any element strides (the tied head's embed.T, and the
// backward's w^T and x^T views); loads run along whichever axis is
// contiguous.
//
// Bound of the work on the H100 (chip_smoke.py, PERF.md section 6): the
// bytes, since the oracle's operands and C are f32 (A and B read once, C
// written once, over 3.35 TB/s); its 2MNK operations counted at the FP8
// rate for the layers' (1,5,2) operands and the bf16 rate for the lm_head
// take less.  This simple design runs them in f32 on the CUDA cores, far
// above that bound.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, KT = 16, NT = 256;
constexpr int TM = 4, TN = 4;        // each thread: rows ty*4.., columns tx*4..
constexpr int PAD = 4;               // keeps float4 rows aligned, spreads banks
constexpr int A_PER = BM * KT / NT;  // staged values a thread, per operand
constexpr int B_PER = KT * BN / NT;

__device__ __forceinline__ float val(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float val(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(NT) qmatmul_kernel(
    const TA* __restrict__ A, long long sam, long long sak,
    const TB* __restrict__ B, long long sbk, long long sbn,
    float* __restrict__ C, int M, int N, int K, int chunk, QFmt qacc) {
  __shared__ __align__(16) float As[KT][BM + PAD];  // As[k][m]
  __shared__ __align__(16) float Bs[KT][BN + PAD];  // Bs[k][n]
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool a_kfast = sak == 1;
  const bool b_kfast = sbk == 1 && sbn != 1;

  float ra[A_PER], rb[B_PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * NT;
      const int mm = a_kfast ? idx / KT : idx % BM;
      const int kk = a_kfast ? idx % KT : idx / BM;
      const int gm = m0 + mm, gk = k0 + kk;
      ra[i] = (gm < M && gk < K) ? val(A, gm * sam + gk * sak) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * NT;
      const int nn = b_kfast ? idx / KT : idx % BN;
      const int kk = b_kfast ? idx % KT : idx / BN;
      const int gk = k0 + kk, gn = n0 + nn;
      rb[i] = (gk < K && gn < N) ? val(B, gk * sbk + gn * sbn) : 0.0f;
    }
  };

  float part[TM][TN], carry[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) part[i][j] = carry[i][j] = 0.0f;

  int left = chunk;  // products until the current chunk ends
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();  // the previous tile's reads are done
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * NT;
      As[a_kfast ? idx % KT : idx / BM][a_kfast ? idx / KT : idx % BM] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * NT;
      Bs[b_kfast ? idx % KT : idx / BN][b_kfast ? idx / KT : idx % BN] = rb[i];
    }
    __syncthreads();
    if (k0 + KT < K) fetch(k0 + KT);  // in flight during the compute below
    const int kend = min(KT, K - k0);
    for (int kk = 0; kk < kend; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {av.x, av.y, av.z, av.w};
      const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = __fmaf_rn(a[i], b[j], part[i][j]);
      if (--left == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            carry[i][j] = quantize_rne(__fadd_rn(carry[i][j], part[i][j]), qacc);
            part[i][j] = 0.0f;
          }
        left = chunk;
      }
    }
  }
  if (left != chunk) {  // the ragged last chunk
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        carry[i][j] = quantize_rne(__fadd_rn(carry[i][j], part[i][j]), qacc);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) C[(long long)gm * N + gn] = carry[i][j];
    }
  }
}

template <typename TA, typename TB>
void launch(const void* A, long long sam, long long sak, const void* B,
            long long sbk, long long sbn, float* C, int M, int N, int K,
            int chunk, QFmt qacc, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmatmul_kernel<TA, TB><<<grid, NT, 0, s>>>(
      static_cast<const TA*>(A), sam, sak, static_cast<const TB*>(B), sbk,
      sbn, C, M, N, K, chunk, qacc);
}

}  // namespace

// A[m, k] = A[m * sam + k * sak], B[k, n] = B[k * sbk + n * sbn] (element
// strides; *_bf16 = 1 for bf16, 0 for f32); C (M, N) f32 row-major.
// Returns the cudaError_t of the launch.
extern "C" int qmatmul(const void* A, int a_bf16, long long sam,
                       long long sak, const void* B, int b_bf16,
                       long long sbk, long long sbn, void* C, int M, int N,
                       int K, int chunk, int c_identity, int c_shift,
                       float c_max, float c_min, void* stream) {
  using bf = __nv_bfloat16;
  const QFmt qacc{c_identity, c_shift, c_max, c_min};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(C);
#define QMM_ARGS A, sam, sak, B, sbk, sbn, out, M, N, K, chunk, qacc, s
  if (a_bf16 && b_bf16)
    launch<bf, bf>(QMM_ARGS);
  else if (a_bf16)
    launch<bf, float>(QMM_ARGS);
  else if (b_bf16)
    launch<float, bf>(QMM_ARGS);
  else
    launch<float, float>(QMM_ARGS);
#undef QMM_ARGS
  return static_cast<int>(cudaGetLastError());
}
