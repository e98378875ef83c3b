// G: fused quantized GEMM with a chunked (1, e_acc, m_acc) carry.
//
// Replaces repro/kernels/fused.py::_fused_kernel (RNE carry, f32 or bf16
// operands, no out_fmt/pack_out epilogue).  C[M,N] = sum over chunks of
// carry = q_acc(carry + Q(A_chunk) . Q(B_chunk)), chunk = the plan's n1.
//
// One thread block per (BM x BN) output tile walks the whole K axis: K is
// staged KT values at a time through shared memory, where each operand
// value is converted to f32 and quantized to the representation format
// right after its load lands.  Every thread keeps a TM x TN patch of the
// f32 intra-chunk partial and of the carry in registers; the partial sums
// in increasing k, and when a chunk ends it is added to the carry and the
// carry is rounded.  The carry never enters the multiply-add.  The next K
// tile's global loads are issued into registers before the current tile is
// computed, so they are in flight during the arithmetic.
//
// Bound on the H100: at decode (M = 8) the weights' bytes (each weight read
// once); the arithmetic is f32 on the CUDA cores.  Tile shapes are
// schedule only: every output's sum runs in the same order.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {


__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// BM x BN output tile, TM x TN outputs per thread, KT K values per stage,
// NT threads
template <int BM, int BN, int TM, int TN, int KT, int NT, typename TA,
          typename TB>
__global__ void __launch_bounds__(NT) qgemm_kernel(
    const TA* __restrict__ A, long long sam, long long sak,
    const TB* __restrict__ B, long long sbk, long long sbn,
    float* __restrict__ C, int M, int N, int K, int chunk,
    QFmt qr, int quant_a, int quant_b, QFmt qacc) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  static_assert(TX * TY == NT, "thread tile does not cover the block");
  constexpr int A_PER = BM * KT / NT;
  constexpr int B_PER = KT * BN / NT;
  static_assert(A_PER * NT == BM * KT && B_PER * NT == KT * BN, "");
  // +1 pad: stores along k (k-major operands) hit distinct banks
  __shared__ float As[KT][BM + 1];
  __shared__ float Bs[KT][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // coalesced load order: along whichever axis is contiguous in memory
  const bool a_kfast = (sak == 1);
  const bool b_kfast = (sbk == 1) && (sbn != 1);

  float ra[A_PER], rb[B_PER];
  float part[TM][TN], carry[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) part[i][j] = carry[i][j] = 0.0f;

  auto a_coord = [&](int idx, int& mm, int& kk) {
    if (a_kfast) { mm = idx / KT; kk = idx % KT; } else { kk = idx / BM; mm = idx % BM; }
  };
  auto b_coord = [&](int idx, int& kk, int& nn) {
    if (b_kfast) { nn = idx / KT; kk = idx % KT; } else { kk = idx / BN; nn = idx % BN; }
  };
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      int mm, kk;
      a_coord(tid + i * NT, mm, kk);
      const int gm = m0 + mm, gk = k0 + kk;
      ra[i] = (gm < M && gk < K) ? to_f32(A[gm * sam + gk * sak]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      int kk, nn;
      b_coord(tid + i * NT, kk, nn);
      const int gk = k0 + kk, gn = n0 + nn;
      rb[i] = (gk < K && gn < N) ? to_f32(B[gk * sbk + gn * sbn]) : 0.0f;
    }
  };

  int left = chunk;  // products until the current chunk ends
  load(0);
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();  // the previous tile's reads are done
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      int mm, kk;
      a_coord(tid + i * NT, mm, kk);
      As[kk][mm] = quant_a ? quantize_rne(ra[i], qr) : ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      int kk, nn;
      b_coord(tid + i * NT, kk, nn);
      Bs[kk][nn] = quant_b ? quantize_rne(rb[i], qr) : rb[i];
    }
    __syncthreads();
    if (k0 + KT < K) load(k0 + KT);  // in flight during the compute below
    const int kend = min(KT, K - k0);
    for (int kk = 0; kk < kend; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
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
  if (left != chunk) {  // ragged last chunk (the zero pad adds nothing)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        carry[i][j] = quantize_rne(__fadd_rn(carry[i][j], part[i][j]), qacc);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) C[(long long)gm * N + gn] = carry[i][j];
    }
  }
}

template <int BM, int BN, int TM, int TN, int KT, int NT, typename TA,
          typename TB>
void launch(const void* A, long long sam, long long sak, const void* B,
            long long sbk, long long sbn, float* C, int M, int N, int K,
            int chunk, QFmt qr, int qa, int qb, QFmt qacc, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qgemm_kernel<BM, BN, TM, TN, KT, NT, TA, TB><<<grid, NT, 0, s>>>(
      static_cast<const TA*>(A), sam, sak, static_cast<const TB*>(B), sbk,
      sbn, C, M, N, K, chunk, qr, qa, qb, qacc);
}

template <int BM, int BN, int TM, int TN, int KT, int NT>
void dispatch(const void* A, int a_bf16, long long sam, long long sak,
              const void* B, int b_bf16, long long sbk, long long sbn,
              float* C, int M, int N, int K, int chunk, QFmt qr, int qa,
              int qb, QFmt qacc, cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (a_bf16 && b_bf16)
    launch<BM, BN, TM, TN, KT, NT, bf, bf>(A, sam, sak, B, sbk, sbn, C, M, N, K, chunk, qr, qa, qb, qacc, s);
  else if (a_bf16)
    launch<BM, BN, TM, TN, KT, NT, bf, float>(A, sam, sak, B, sbk, sbn, C, M, N, K, chunk, qr, qa, qb, qacc, s);
  else if (b_bf16)
    launch<BM, BN, TM, TN, KT, NT, float, bf>(A, sam, sak, B, sbk, sbn, C, M, N, K, chunk, qr, qa, qb, qacc, s);
  else
    launch<BM, BN, TM, TN, KT, NT, float, float>(A, sam, sak, B, sbk, sbn, C, M, N, K, chunk, qr, qa, qb, qacc, s);
}

}  // namespace

// Strides are in elements.  Returns the cudaError_t of the launch.
extern "C" int qgemm(const void* A, int a_bf16, long long sam, long long sak,
                     const void* B, int b_bf16, long long sbk, long long sbn,
                     void* C, int M, int N, int K, int chunk,
                     int r_identity, int r_shift, float r_max, float r_min,
                     int quant_a, int quant_b,
                     int c_identity, int c_shift, float c_max, float c_min,
                     void* stream) {
  const QFmt qr{r_identity, r_shift, r_max, r_min};
  const QFmt qacc{c_identity, c_shift, c_max, c_min};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(C);
  if (M <= 8)  // decode: one 8-row tile, 64 columns per block
    dispatch<8, 64, 1, 2, 32, 256>(A, a_bf16, sam, sak, B, b_bf16, sbk, sbn, out, M, N, K, chunk, qr, quant_a, quant_b, qacc, s);
  else
    dispatch<64, 64, 4, 4, 32, 256>(A, a_bf16, sam, sak, B, b_bf16, sbk, sbn, out, M, N, K, chunk, qr, quant_a, quant_b, qacc, s);
  return static_cast<int>(cudaGetLastError());
}
