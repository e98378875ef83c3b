// K10: dense causal flash prefill of one sequence, resumable.
//
// Replaces repro/kernels/attention.py::_prefill_kernel (flash_prefill, RNE).
// q (S, H, dh) f32 at absolute rows q_off + i; k, v (Sk, KV, dh) f32 (the
// dequantized KV view) at absolute columns kv_off + j.  Grid (query head
// hh, block of BQ query rows); head hh reads KV head hh / g straight from
// k and v (no repeat).  The KV walk runs in chunk-long blocks and skips the
// blocks wholly in the causal future of the block's last row or past Sk
// (provable carry no-ops); the mask is
// (kv_off + col <= q_off + row) & (col < Sk).
//
// The accumulation discipline is the one of paged_prefill.cu (P), so K10 is
// bitwise P on the same values: scores are f32 sums over d in increasing d,
// times LOG2E / sqrt(dh); the running max sits on the integer lattice
// (ceilf), so alpha = exp2f(m - m') is a power of two; l and p.v add the
// block's terms in token order (each product rounded, then added); the o/l
// carries are rounded to (1, e_acc, m_acc) once per block.
//
// Carry in: (co, cm, cl) in the JAX layouts (S, H, dh), (S, H), (S, H)
// cover the KV before kv_off (kv_off is a multiple of chunk, so a resumed
// walk is bitwise the one-shot walk).  Carry out: out receives the raw o,
// om and ol the running max and l; otherwise out = o / l (0 where l = 0).
//
// Shared memory (dynamic, sized by chunk and dh): the BQ query rows, the
// block's K (padded rows, so score reads hit distinct banks) and V, and the
// scores and probabilities; about 153 KB at chunk 128 and dh 128, one block
// an SM; 26 KB at the serving path's chunk 16.
//
// Bound on the H100: the score and value contractions,
// 4 * (attended (row, column) pairs) * dh flops per head, in f32 on the
// CUDA cores in this simple design.
#include "common.cuh"

#define MAX_CHUNK 128

namespace {

template <int BQ>
__global__ void __launch_bounds__(ATTN_THREADS) flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ co,
    const float* __restrict__ cm, const float* __restrict__ cl,
    float* __restrict__ out, float* __restrict__ om, float* __restrict__ ol,
    int S, int H, int Sk, int KV, int DH, int chunk, int q_off, int kv_off,
    float scale, QFmt qacc) {
  extern __shared__ float smem[];
  const int ldk = DH + 1;
  float* qs = smem;                 // [BQ][DH + 1]
  float* ks = qs + BQ * ldk;        // [chunk][DH + 1]
  float* vs = ks + chunk * ldk;     // [chunk][DH]
  float* sc = vs + chunk * DH;      // [BQ][chunk]
  float* pr = sc + BQ * chunk;      // [BQ][chunk]
  float* m_s = pr + BQ * chunk;     // [BQ] each
  float* mnew_s = m_s + BQ;
  float* alpha_s = mnew_s + BQ;
  float* l_s = alpha_s + BQ;

  const int hh = blockIdx.x, r0 = blockIdx.y * BQ, tid = threadIdx.x;
  const int hk = hh / (H / KV);
  const bool carry_in = co != nullptr;

  for (int i = tid; i < BQ * DH; i += ATTN_THREADS) {
    const int r = i / DH, d = i % DH;
    qs[r * ldk + d] = r0 + r < S ? q[((long long)(r0 + r) * H + hh) * DH + d] : 0.0f;
  }
  if (tid < BQ) {
    const int r = r0 + tid;
    const bool live = carry_in && r < S;
    m_s[tid] = live ? cm[(long long)r * H + hh] : REPRO_NEG;
    l_s[tid] = live ? cl[(long long)r * H + hh] : 0.0f;
  }
  float o[BQ];
#pragma unroll
  for (int r = 0; r < BQ; ++r)
    o[r] = (carry_in && tid < DH && r0 + r < S)
               ? co[((long long)(r0 + r) * H + hh) * DH + tid]
               : 0.0f;

  // blocks this query block attends: past Sk, or wholly after the block's
  // last absolute row, the walk stops
  const int n_kv = (Sk + chunk - 1) / chunk;
  const int reach = q_off + r0 + BQ - 1 - kv_off;  // last visible local column
  const int n_causal = reach >= 0 ? reach / chunk + 1 : 0;
  const int kk_end = min(n_kv, n_causal);

  for (int kk = 0; kk < kk_end; ++kk) {
    const int c0 = kk * chunk;
    __syncthreads();  // the previous block's reads are done
    for (int i = tid; i < chunk * DH; i += ATTN_THREADS) {
      const int t = i / DH, d = i % DH;
      const bool in = c0 + t < Sk;
      const long long g = ((long long)(c0 + t) * KV + hk) * DH + d;
      ks[t * ldk + d] = in ? k[g] : 0.0f;
      vs[t * DH + d] = in ? v[g] : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < BQ * chunk; i += ATTN_THREADS) {
      const int r = i / chunk, t = i % chunk;
      float acc = 0.0f;
      for (int d = 0; d < DH; ++d)
        acc = __fadd_rn(acc, __fmul_rn(qs[r * ldk + d], ks[t * ldk + d]));
      const int col = c0 + t;
      const bool valid = kv_off + col <= q_off + r0 + r && col < Sk;
      sc[i] = valid ? __fmul_rn(acc, scale) : REPRO_NEG;
    }
    __syncthreads();
    if (tid < BQ) {
      float mx = REPRO_NEG;
      for (int t = 0; t < chunk; ++t) mx = fmaxf(mx, sc[tid * chunk + t]);
      const float mn = fmaxf(m_s[tid], ceilf(mx));
      alpha_s[tid] = exp2f(m_s[tid] - mn);
      mnew_s[tid] = mn;
    }
    __syncthreads();
    for (int i = tid; i < BQ * chunk; i += ATTN_THREADS) {
      const int r = i / chunk, t = i % chunk;
      const int col = c0 + t;
      const bool valid = kv_off + col <= q_off + r0 + r && col < Sk;
      pr[i] = valid ? exp2f(sc[i] - mnew_s[r]) : 0.0f;
    }
    __syncthreads();
    if (tid < BQ) {
      float lsum = 0.0f;
      for (int t = 0; t < chunk; ++t) lsum = __fadd_rn(lsum, pr[tid * chunk + t]);
      l_s[tid] = quantize_rne(__fadd_rn(__fmul_rn(l_s[tid], alpha_s[tid]), lsum), qacc);
      m_s[tid] = mnew_s[tid];
    }
    if (tid < DH) {
#pragma unroll
      for (int r = 0; r < BQ; ++r) {
        float pv = 0.0f;
        for (int t = 0; t < chunk; ++t)
          pv = __fadd_rn(pv, __fmul_rn(pr[r * chunk + t], vs[t * DH + tid]));
        o[r] = quantize_rne(__fadd_rn(__fmul_rn(o[r], alpha_s[r]), pv), qacc);
      }
    }
  }
  __syncthreads();
  const bool emit_carry = om != nullptr;
  if (tid < DH) {
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      if (r0 + r >= S) break;
      const long long at = ((long long)(r0 + r) * H + hh) * DH + tid;
      const float l = l_s[r];
      out[at] = emit_carry ? o[r] : (l > 0.0f ? __fdiv_rn(o[r], l) : 0.0f);
    }
  }
  if (emit_carry && tid < BQ && r0 + tid < S) {
    om[(long long)(r0 + tid) * H + hh] = m_s[tid];
    ol[(long long)(r0 + tid) * H + hh] = l_s[tid];
  }
}

template <int BQ>
int launch(const float* q, const float* k, const float* v, const float* co,
           const float* cm, const float* cl, float* out, float* om,
           float* ol, int S, int H, int Sk, int KV, int DH, int chunk,
           int q_off, int kv_off, float scale, QFmt qacc, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (DH + 1) + (size_t)chunk * (DH + 1) +
                                       (size_t)chunk * DH + 2 * (size_t)BQ * chunk + 4 * BQ);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(H, (S + BQ - 1) / BQ);
  flash_prefill_kernel<BQ><<<grid, ATTN_THREADS, smem, s>>>(
      q, k, v, co, cm, cl, out, om, ol, S, H, Sk, KV, DH, chunk, q_off, kv_off, scale, qacc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (S, H, dh), k/v (Sk, KV, dh), carry (S, H, dh), (S, H), (S, H) or null;
// out (S, H, dh); om/ol (S, H) or null (finalized output).  All f32,
// contiguous.  block_q is 8, 16 or 32 (schedule only); chunk <= MAX_CHUNK,
// dh <= MAX_DH.  Returns the cudaError_t of the launch.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* co, const void* cm, const void* cl,
                             void* out, void* om, void* ol, int S, int H,
                             int Sk, int KV, int DH, int chunk, int block_q,
                             int q_off, int kv_off, float scale,
                             int c_identity, int c_shift, float c_max,
                             float c_min, void* stream) {
  if (DH > MAX_DH || chunk > MAX_CHUNK || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const QFmt qacc{c_identity, c_shift, c_max, c_min};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FP_ARGS                                                                   \
  static_cast<const float*>(q), static_cast<const float*>(k),                     \
      static_cast<const float*>(v), static_cast<const float*>(co),                \
      static_cast<const float*>(cm), static_cast<const float*>(cl),               \
      static_cast<float*>(out), static_cast<float*>(om), static_cast<float*>(ol), \
      S, H, Sk, KV, DH, chunk, q_off, kv_off, scale, qacc, s
  switch (block_q) {
    case 8: return launch<8>(FP_ARGS);
    case 16: return launch<16>(FP_ARGS);
    case 32: return launch<32>(FP_ARGS);
    default: break;
  }
#undef FP_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
