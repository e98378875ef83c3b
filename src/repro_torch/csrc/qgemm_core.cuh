// The tile loop of G, the serving path's quantized GEMM (qgemm.cu): one
// thread block computes one BM x BN tile of C = Q(A) . Q(B) with a chunked
// (1, e_acc, m_acc) carry.  The training path's GEMMs (E, K8, B, K9) run
// the Hopper tile qgemm_sm90.cuh, bitwise this one.
//
// K is staged KT values at a time through shared memory, where each operand
// value is converted to f32 (bf16 exactly) and,
// where asked, quantized to the representation format right after its load
// lands.  Every thread keeps a TM x TN patch of the f32 intra-chunk partial
// and of the carry in registers; the partial sums in increasing k, and when
// a chunk ends it is added to the carry and the carry is rounded.  The
// carry never enters the multiply-add.  The next K tile's global loads are
// issued into registers before the current tile is computed, so they are in
// flight during the arithmetic.  Tile shapes are schedule only: every
// output's sum runs in the same order for any tile.
//
// Operands are read through element strides, so a transposed view (the
// tied lm_head's embed.T) needs no copy; loads run along whichever axis is
// contiguous in memory.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace qcore {

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename TA, typename TB>
struct Args {
  const TA* A;  // A[m, k] = A[m * sam + k * sak]
  long long sam, sak;
  const TB* B;  // B[k, n] = B[k * sbk + n * sbn]
  long long sbk, sbn;
  float* C;  // C[m, n] = C[m * ldc + n]
  long long ldc;
  int M, N, K, chunk;
  QFmt qr;  // representation format of the operand quantization
  int quant_a, quant_b;
  QFmt qacc;
};

// One BM x BN tile at (m0, n0); As/Bs are the block's shared tiles.
template <int BM, int BN, int TM, int TN, int KT, int NT, typename TA, typename TB>
__device__ __forceinline__ void tile(const Args<TA, TB>& p, int m0, int n0,
                                     float (*As)[BM + 1], float (*Bs)[BN + 1]) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  static_assert(TX * TY == NT, "thread tile does not cover the block");
  constexpr int A_PER = BM * KT / NT;
  constexpr int B_PER = KT * BN / NT;
  static_assert(A_PER * NT == BM * KT && B_PER * NT == KT * BN, "");

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int M = p.M, N = p.N, K = p.K;
  const bool a_kfast = (p.sak == 1);
  const bool b_kfast = (p.sbk == 1) && (p.sbn != 1);

  float ra[A_PER], rb[B_PER];
  float part[TM][TN], carry[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      part[i][j] = 0.0f;
      carry[i][j] = 0.0f;
    }

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
      ra[i] = (gm < M && gk < K) ? ld(p.A, gm * p.sam + gk * p.sak) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      int kk, nn;
      b_coord(tid + i * NT, kk, nn);
      const int gk = k0 + kk, gn = n0 + nn;
      rb[i] = (gk < K && gn < N) ? ld(p.B, gk * p.sbk + gn * p.sbn) : 0.0f;
    }
  };

  // a chunk ends: carry = q(carry + partial), the partial restarts
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        carry[i][j] = quantize_rne(__fadd_rn(carry[i][j], part[i][j]), p.qacc);
        part[i][j] = 0.0f;
      }
  };

  int left = p.chunk;  // products until the current chunk ends
  load(0);
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();  // the previous tile's reads are done
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      int mm, kk;
      a_coord(tid + i * NT, mm, kk);
      As[kk][mm] = p.quant_a ? quantize_rne(ra[i], p.qr) : ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      int kk, nn;
      b_coord(tid + i * NT, kk, nn);
      Bs[kk][nn] = p.quant_b ? quantize_rne(rb[i], p.qr) : rb[i];
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
        fold();
        left = p.chunk;
      }
    }
  }
  if (left != p.chunk) fold();  // ragged last chunk (the zero pad adds nothing)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) p.C[(long long)gm * p.ldc + gn] = carry[i][j];
    }
  }
}

}  // namespace qcore
