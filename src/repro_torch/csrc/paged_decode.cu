// D: paged decode attention over the int8 KV arena.
//
// Replaces repro/kernels/attention.py::_decode_kernel (finalized output).
// One thread block per (sequence b, KV head hk) computes the g query heads
// hh = hk * g + gg.  It walks the pages p < ceil(seq_len / page_size) of
// the sequence's page-table row in order; for each page it decodes the int8
// K and V codes with the page's 2^se scale into shared memory, forms the
// base-2 scores, and applies the online update with the o/l carries rounded
// to (1, e_acc, m_acc) once per page.  Sums run in a fixed order (scores:
// increasing d; l and p.v: increasing token), each product rounded then
// added, which is the order of the plain PyTorch version.
//
// Bound on the H100: the bytes of the pages it reads, a few MB per decode
// step.  The page walk is sequential (the carry rounding is per page), so
// the kernel is latency-bound; it loads the next page's codes into
// registers while the current page is computed.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(ATTN_THREADS) paged_decode_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ kp,
    const int8_t* __restrict__ vp, const int* __restrict__ kse,
    const int* __restrict__ vse, const int* __restrict__ page_table,
    int max_pages, const int* __restrict__ seq_lens, float* __restrict__ out,
    int KV, int G, int PS, int DH, float scale, int e_kv, int m_kv, QFmt qacc) {
  __shared__ float qs[MAX_G][MAX_DH];
  __shared__ float ks[MAX_PAGE][MAX_DH + 1];  // +1: score reads hit distinct banks
  __shared__ float vs[MAX_PAGE][MAX_DH];
  __shared__ float sc[MAX_G][MAX_PAGE];
  __shared__ float pr[MAX_G][MAX_PAGE];
  __shared__ float m_s[MAX_G], mnew_s[MAX_G], alpha_s[MAX_G], l_s[MAX_G];

  const int b = blockIdx.x, hk = blockIdx.y, tid = threadIdx.x;
  const int H = KV * G;
  const int seq_len = seq_lens[b];
  const int n_pages = (seq_len + PS - 1) / PS;
  const int page_elems = PS * DH;
  // each thread stages at most this many codes of a page (PS*DH <= 4096)
  constexpr int PER = MAX_PAGE * MAX_DH / ATTN_THREADS;

  for (int i = tid; i < G * DH; i += ATTN_THREADS) {
    const int gg = i / DH, d = i % DH;
    qs[gg][d] = q[((long long)b * H + hk * G + gg) * DH + d];
  }
  if (tid < G) { m_s[tid] = REPRO_NEG; l_s[tid] = 0.0f; }
  float o[MAX_G];
#pragma unroll
  for (int gg = 0; gg < MAX_G; ++gg) o[gg] = 0.0f;

  int8_t rk[PER], rv[PER];
  auto fetch = [&](int p) {
    const int pid = page_table[(long long)b * max_pages + p];
    const long long base = ((long long)pid * KV + hk) * page_elems;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = tid + r * ATTN_THREADS;
      rk[r] = i < page_elems ? kp[base + i] : 0;
      rv[r] = i < page_elems ? vp[base + i] : 0;
    }
    return pid;
  };

  int pid = n_pages > 0 ? fetch(0) : 0;
  for (int p = 0; p < n_pages; ++p) {
    __syncthreads();  // previous page's reads of ks/vs/pr are done
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
    if (p + 1 < n_pages) pid = fetch(p + 1);  // in flight during the compute

    // base-2 scores, masked past seq_len
    for (int i = tid; i < G * PS; i += ATTN_THREADS) {
      const int gg = i / PS, t = i % PS;
      float acc = 0.0f;
      for (int d = 0; d < DH; ++d) acc = __fadd_rn(acc, __fmul_rn(qs[gg][d], ks[t][d]));
      const bool valid = p * PS + t < seq_len;
      sc[gg][t] = valid ? __fmul_rn(acc, scale) : REPRO_NEG;
    }
    __syncthreads();
    if (tid < G) {  // running max on the integer lattice; exact rescale
      float mx = REPRO_NEG;
      for (int t = 0; t < PS; ++t) mx = fmaxf(mx, sc[tid][t]);
      const float mn = fmaxf(m_s[tid], ceilf(mx));
      alpha_s[tid] = exp2f(m_s[tid] - mn);
      mnew_s[tid] = mn;
    }
    __syncthreads();
    for (int i = tid; i < G * PS; i += ATTN_THREADS) {
      const int gg = i / PS, t = i % PS;
      const bool valid = p * PS + t < seq_len;
      pr[gg][t] = valid ? exp2f(sc[gg][t] - mnew_s[gg]) : 0.0f;
    }
    __syncthreads();
    if (tid < G) {
      float lsum = 0.0f;
      for (int t = 0; t < PS; ++t) lsum = __fadd_rn(lsum, pr[tid][t]);
      l_s[tid] = quantize_rne(__fadd_rn(__fmul_rn(l_s[tid], alpha_s[tid]), lsum), qacc);
      m_s[tid] = mnew_s[tid];
    }
    if (tid < DH) {
#pragma unroll
      for (int gg = 0; gg < MAX_G; ++gg) {
        if (gg >= G) break;
        float pv = 0.0f;
        for (int t = 0; t < PS; ++t) pv = __fadd_rn(pv, __fmul_rn(pr[gg][t], vs[t][tid]));
        o[gg] = quantize_rne(__fadd_rn(__fmul_rn(o[gg], alpha_s[gg]), pv), qacc);
      }
    }
  }
  __syncthreads();
  if (tid < DH) {
#pragma unroll
    for (int gg = 0; gg < MAX_G; ++gg) {
      if (gg >= G) break;
      const float l = l_s[gg];
      out[((long long)b * H + hk * G + gg) * DH + tid] = l > 0.0f ? __fdiv_rn(o[gg], l) : 0.0f;
    }
  }
}

}  // namespace

// q (B, H, dh) f32; pages (P, KV, PS, dh) int8; scales (P,) int32;
// page_table (B, max_pages) int32; seq_lens (B,) int32; out (B, H, dh).
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* kse, const void* vse,
                            const void* page_table, int max_pages,
                            const void* seq_lens, void* out, int B, int KV,
                            int G, int PS, int DH, float scale, int e_kv,
                            int m_kv, int c_identity, int c_shift, float c_max,
                            float c_min, void* stream) {
  const QFmt qacc{c_identity, c_shift, c_max, c_min};
  dim3 grid(B, KV);
  paged_decode_kernel<<<grid, ATTN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kp),
      static_cast<const int8_t*>(vp), static_cast<const int*>(kse),
      static_cast<const int*>(vse), static_cast<const int*>(page_table),
      max_pages, static_cast<const int*>(seq_lens), static_cast<float*>(out),
      KV, G, PS, DH, scale, e_kv, m_kv, qacc);
  return static_cast<int>(cudaGetLastError());
}
