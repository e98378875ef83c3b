// P: bucketed causal prefill straight off the paged int8 KV arena.
//
// Replaces repro/kernels/attention.py::_prefill_paged_kernel (no carry in,
// no carry out).  Grid (query head hh, block of BQ query rows); head hh
// reads KV head hh / g.  The block walks the sequence's page row in order
// and skips pages before start_page, past kv_len, or wholly in the causal
// future of its rows (all provable carry no-ops).  Per page: decode the
// int8 K/V codes with the page's 2^se scale into shared memory, form the
// base-2 scores under the mask (col <= q_offset + row) & (col < kv_len) &
// (row < q_len), and apply the online update with the o/l carries rounded
// to (1, e_acc, m_acc).  Rows >= q_len attend nothing and come out 0.
// Sums run in the fixed order of the plain PyTorch version (scores:
// increasing d; l and p.v: increasing token; each product rounded then
// added).  q_offset, q_len and kv_len are launch arguments.
//
// Bound on the H100: the score and value contractions,
// 4 * rows * attended tokens * dh flops per head, in f32 on the CUDA cores.
#include "common.cuh"

namespace {

constexpr int BQ = 16;  // query rows per block (schedule only)

__global__ void __launch_bounds__(ATTN_THREADS) paged_prefill_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ kp,
    const int8_t* __restrict__ vp, const int* __restrict__ kse,
    const int* __restrict__ vse, const int* __restrict__ page_row,
    float* __restrict__ out, int T, int H, int KV, int PS, int DH, int q_off,
    int q_len, int kv_len, int start_page, float scale, int e_kv, int m_kv,
    QFmt qacc) {
  __shared__ float qs[BQ][MAX_DH + 1];
  __shared__ float ks[MAX_PAGE][MAX_DH + 1];
  __shared__ float vs[MAX_PAGE][MAX_DH];
  __shared__ float sc[BQ][MAX_PAGE];
  __shared__ float pr[BQ][MAX_PAGE];
  __shared__ float m_s[BQ], mnew_s[BQ], alpha_s[BQ], l_s[BQ];

  const int hh = blockIdx.x, r0 = blockIdx.y * BQ, tid = threadIdx.x;
  const int hk = hh / (H / KV);
  const int page_elems = PS * DH;
  constexpr int PER = MAX_PAGE * MAX_DH / ATTN_THREADS;

  for (int i = tid; i < BQ * DH; i += ATTN_THREADS) {
    const int r = i / DH, d = i % DH;
    qs[r][d] = r0 + r < T ? q[((long long)(r0 + r) * H + hh) * DH + d] : 0.0f;
  }
  if (tid < BQ) { m_s[tid] = REPRO_NEG; l_s[tid] = 0.0f; }
  float o[BQ];
#pragma unroll
  for (int r = 0; r < BQ; ++r) o[r] = 0.0f;

  // pages this block attends: [start_page, last) -- past kv_len or wholly
  // after the block's last absolute row the walk stops
  const int n_kv = (kv_len + PS - 1) / PS;
  const int last_row = q_off + r0 + BQ - 1;
  const int n_causal = last_row >= 0 ? last_row / PS + 1 : 0;
  const int p_end = min(n_kv, n_causal);

  int8_t rk[PER], rv[PER];
  auto fetch = [&](int p) {
    const int pid = page_row[p];
    const long long base = ((long long)pid * KV + hk) * page_elems;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = tid + r * ATTN_THREADS;
      rk[r] = i < page_elems ? kp[base + i] : 0;
      rv[r] = i < page_elems ? vp[base + i] : 0;
    }
    return pid;
  };

  int pid = start_page < p_end ? fetch(start_page) : 0;
  for (int p = start_page; p < p_end; ++p) {
    __syncthreads();
    const float k_scale = exp2_int(kse[pid]), v_scale = exp2_int(vse[pid]);
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = tid + r * ATTN_THREADS;
      if (i < page_elems) {
        const int t = i / DH, d = i % DH;
        ks[t][d] = __fmul_rn(unpack_code(rk[r], e_kv, m_kv), k_scale);
        vs[t][d] = __fmul_rn(unpack_code(rv[r], e_kv, m_kv), v_scale);
      }
    }
    __syncthreads();
    if (p + 1 < p_end) pid = fetch(p + 1);

    for (int i = tid; i < BQ * PS; i += ATTN_THREADS) {
      const int r = i / PS, t = i % PS;
      float acc = 0.0f;
      for (int d = 0; d < DH; ++d) acc = __fadd_rn(acc, __fmul_rn(qs[r][d], ks[t][d]));
      const int col = p * PS + t;
      const bool valid = col <= q_off + r0 + r && col < kv_len && r0 + r < q_len;
      sc[r][t] = valid ? __fmul_rn(acc, scale) : REPRO_NEG;
    }
    __syncthreads();
    if (tid < BQ) {
      float mx = REPRO_NEG;
      for (int t = 0; t < PS; ++t) mx = fmaxf(mx, sc[tid][t]);
      const float mn = fmaxf(m_s[tid], ceilf(mx));
      alpha_s[tid] = exp2f(m_s[tid] - mn);
      mnew_s[tid] = mn;
    }
    __syncthreads();
    for (int i = tid; i < BQ * PS; i += ATTN_THREADS) {
      const int r = i / PS, t = i % PS;
      const int col = p * PS + t;
      const bool valid = col <= q_off + r0 + r && col < kv_len && r0 + r < q_len;
      pr[r][t] = valid ? exp2f(sc[r][t] - mnew_s[r]) : 0.0f;
    }
    __syncthreads();
    if (tid < BQ) {
      float lsum = 0.0f;
      for (int t = 0; t < PS; ++t) lsum = __fadd_rn(lsum, pr[tid][t]);
      l_s[tid] = quantize_rne(__fadd_rn(__fmul_rn(l_s[tid], alpha_s[tid]), lsum), qacc);
      m_s[tid] = mnew_s[tid];
    }
    if (tid < DH) {
#pragma unroll
      for (int r = 0; r < BQ; ++r) {
        float pv = 0.0f;
        for (int t = 0; t < PS; ++t) pv = __fadd_rn(pv, __fmul_rn(pr[r][t], vs[t][tid]));
        o[r] = quantize_rne(__fadd_rn(__fmul_rn(o[r], alpha_s[r]), pv), qacc);
      }
    }
  }
  __syncthreads();
  if (tid < DH) {
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      if (r0 + r >= T) break;
      const float l = l_s[r];
      out[((long long)(r0 + r) * H + hh) * DH + tid] = l > 0.0f ? __fdiv_rn(o[r], l) : 0.0f;
    }
  }
}

}  // namespace

// q (T, H, dh) f32; pages (P, KV, PS, dh) int8; scales (P,) int32;
// page_row (max_pages,) int32; out (T, H, dh) f32.
extern "C" int paged_prefill(const void* q, const void* kp, const void* vp,
                             const void* kse, const void* vse,
                             const void* page_row, void* out, int T, int H,
                             int KV, int PS, int DH, int q_off, int q_len,
                             int kv_len, int start_page, float scale,
                             int e_kv, int m_kv, int c_identity, int c_shift,
                             float c_max, float c_min, void* stream) {
  const QFmt qacc{c_identity, c_shift, c_max, c_min};
  dim3 grid(H, (T + BQ - 1) / BQ);
  paged_prefill_kernel<<<grid, ATTN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kp),
      static_cast<const int8_t*>(vp), static_cast<const int*>(kse),
      static_cast<const int*>(vse), static_cast<const int*>(page_row),
      static_cast<float*>(out), T, H, KV, PS, DH, q_off, q_len, kv_len,
      start_page, scale, e_kv, m_kv, qacc);
  return static_cast<int>(cudaGetLastError());
}
