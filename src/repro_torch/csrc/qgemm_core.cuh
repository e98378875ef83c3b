// The tile loop shared by the quantized GEMM kernels G, E (qgemm.cu) and
// the backward pair B (bwd_pair.cu): one thread block computes one BM x BN
// tile of C = Q(A) . Q(B) with a chunked (1, e_acc, m_acc) carry.
//
// K is staged KT values at a time through shared memory, where each operand
// value is converted to f32 (bf16 exactly, int8 codes by unpack_code) and,
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
// tied lm_head's embed.T, w^T in dx, x^T in dw) needs no copy; loads run
// along whichever axis is contiguous in memory.
//
// STATS (the swamping-telemetry variants K8/K9, qgemm_stats.cu and
// bwd_pair.cu) adds an f32 shadow carry ideal += partial beside the carry
// and, over the valid (unpadded) outputs, counts every chunk update whose
// partial is non-zero (adds) and those the carry absorbed (swamped: new ==
// prev), takes the max |carry|, and at the tile's last chunk the ensemble
// moments of (carry, ideal); the block's partial stats row goes to `stats`.
// The carry arithmetic is the same code, so the output is bitwise the
// stats-off tile's.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace qcore {

// format of int8 operand codes
struct Dec {
  int e, m;
};

__device__ __forceinline__ float ld(const float* p, long long i, Dec) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i, Dec) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ld(const int8_t* p, long long i, Dec d) {
  return unpack_code(p[i], d.e, d.m);
}

template <typename TA, typename TB>
struct Args {
  const TA* A;  // A[m, k] = A[m * sam + k * sak]
  long long sam, sak;
  const TB* B;  // B[k, n] = B[k * sbk + n * sbn]
  long long sbk, sbn;
  float* C;  // C[m, n] = C[m * ldc + n]
  long long ldc;
  const float* Cin;  // carry in, laid out as C, or nullptr (carry starts at 0)
  int M, N, K, chunk;
  QFmt qr;  // representation format of the operand quantization
  int quant_a, quant_b;
  Dec dec;  // format of int8 operands
  QFmt qacc;
  int8_t* Aq;  // EMIT: codes of Q(A) [M, K] row-major, written where emit_a
  int8_t* Bq;  // EMIT: codes of Q(B) [K, N] row-major, written where emit_b
  Dec enc;     // EMIT: code format
};

// One BM x BN tile at (m0, n0); As/Bs are the block's shared tiles; with
// STATS, `stats` receives the block's partial row and `sh` holds
// NT / 32 * N_STATS doubles of shared scratch.
template <int BM, int BN, int TM, int TN, int KT, int NT, bool EMIT,
          bool STATS = false, typename TA, typename TB>
__device__ __forceinline__ void tile(const Args<TA, TB>& p, int m0, int n0,
                                     bool emit_a, bool emit_b,
                                     float (*As)[BM + 1], float (*Bs)[BN + 1],
                                     double* stats = nullptr,
                                     double* sh = nullptr) {
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
  float ideal[TM][TN];          // STATS: the f32 shadow carry
  int n_adds = 0, n_swamped = 0;  // STATS: chunk updates over valid outputs
  float max_abs = 0.0f;           // STATS: max |carry| over those updates
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      part[i][j] = 0.0f;
      ideal[i][j] = 0.0f;
      const int gm = m0 + ty + i * TY, gn = n0 + tx + j * TX;
      carry[i][j] = (p.Cin != nullptr && gm < M && gn < N)
                        ? p.Cin[(long long)gm * p.ldc + gn]
                        : 0.0f;
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
      ra[i] = (gm < M && gk < K) ? ld(p.A, gm * p.sam + gk * p.sak, p.dec) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      int kk, nn;
      b_coord(tid + i * NT, kk, nn);
      const int gk = k0 + kk, gn = n0 + nn;
      rb[i] = (gk < K && gn < N) ? ld(p.B, gk * p.sbk + gn * p.sbn, p.dec) : 0.0f;
    }
  };

  // a chunk ends: carry = q(carry + partial), the partial restarts
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float prev = carry[i][j];
        carry[i][j] = quantize_rne(__fadd_rn(prev, part[i][j]), p.qacc);
        if constexpr (STATS) {
          ideal[i][j] = __fadd_rn(ideal[i][j], part[i][j]);
          if (m0 + ty + i * TY < M && n0 + tx + j * TX < N) {
            if (part[i][j] != 0.0f) {
              ++n_adds;
              if (carry[i][j] == prev) ++n_swamped;
            }
            max_abs = fmaxf(max_abs, fabsf(carry[i][j]));
          }
        }
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
      const float v = p.quant_a ? quantize_rne(ra[i], p.qr) : ra[i];
      As[kk][mm] = v;
      if (EMIT && emit_a) {  // first visit of this A block: its codes
        const int gm = m0 + mm, gk = k0 + kk;
        if (gm < M && gk < K)
          p.Aq[(long long)gm * K + gk] = pack_code(v, p.enc.e, p.enc.m);
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      int kk, nn;
      b_coord(tid + i * NT, kk, nn);
      const float v = p.quant_b ? quantize_rne(rb[i], p.qr) : rb[i];
      Bs[kk][nn] = v;
      if (EMIT && emit_b) {
        const int gk = k0 + kk, gn = n0 + nn;
        if (gk < K && gn < N)
          p.Bq[(long long)gk * N + gn] = pack_code(v, p.enc.e, p.enc.m);
      }
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
  if constexpr (STATS) {
    double v[N_STATS];
#pragma unroll
    for (int s = 0; s < N_STATS; ++s) v[s] = 0.0;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (m0 + ty + i * TY < M && n0 + tx + j * TX < N)
          stats_moments(v, carry[i][j], ideal[i][j]);
    v[STAT_MAX_ABS] = max_abs;
    v[STAT_SWAMPED] = n_swamped;
    v[STAT_ADDS] = n_adds;
    stats_block_row<NT>(v, stats, sh);
  }
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
