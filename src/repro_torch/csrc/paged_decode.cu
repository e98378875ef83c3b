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
//
// paged_decode_stats (STATS) replaces ::_decode_kernel_stats (K12): the
// same walk, so o is bitwise D's, plus an f32 shadow o_i = o_i * alpha + pv
// with D's alpha and pv, and the N_STATS row over the output ensemble of
// the sequences with seq_len > 0: per page update, adds (pv != 0) and
// swamped (the new carry equals the rescaled previous one, prev * alpha),
// max |o|; at the last page the moments of (o, o_i).  The TPU kernel walks
// every page-table column and takes the moments on the last one; a page
// past seq_len is a carry no-op there (alpha = 1, pv = 0, no add counted),
// so stopping at the last valid page gives the same row.  One partial row
// per (sequence, KV head) block, summed by common.cuh's second pass.
#include "common.cuh"

namespace {

template <bool STATS>
__global__ void __launch_bounds__(ATTN_THREADS) paged_decode_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ kp,
    const int8_t* __restrict__ vp, const int* __restrict__ kse,
    const int* __restrict__ vse, const int* __restrict__ page_table,
    int max_pages, const int* __restrict__ seq_lens, float* __restrict__ out,
    int KV, int G, int PS, int DH, float scale, int e_kv, int m_kv, QFmt qacc,
    double* __restrict__ part) {
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
  float oi[MAX_G];  // STATS: the f32 shadow of o
#pragma unroll
  for (int gg = 0; gg < MAX_G; ++gg) o[gg] = oi[gg] = 0.0f;
  int n_adds = 0, n_swamped = 0;  // STATS
  float max_abs = 0.0f;
  double v[N_STATS];
#pragma unroll
  for (int s = 0; s < N_STATS; ++s) v[s] = 0.0;

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
        const float scaled = __fmul_rn(o[gg], alpha_s[gg]);
        o[gg] = quantize_rne(__fadd_rn(scaled, pv), qacc);
        if constexpr (STATS) {
          oi[gg] = __fadd_rn(__fmul_rn(oi[gg], alpha_s[gg]), pv);
          if (pv != 0.0f) {
            ++n_adds;
            if (o[gg] == scaled) ++n_swamped;
          }
          max_abs = fmaxf(max_abs, fabsf(o[gg]));
          if (p == n_pages - 1) stats_moments(v, o[gg], oi[gg]);
        }
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
  if constexpr (STATS) {
    __shared__ double sh[ATTN_THREADS / 32 * N_STATS];
    v[STAT_MAX_ABS] = max_abs;
    v[STAT_SWAMPED] = n_swamped;
    v[STAT_ADDS] = n_adds;
    stats_block_row<ATTN_THREADS>(v, part + ((long long)b * KV + hk) * N_STATS, sh);
  }
}

template <bool STATS>
int launch(const void* q, const void* kp, const void* vp, const void* kse,
           const void* vse, const void* page_table, int max_pages,
           const void* seq_lens, void* out, int B, int KV, int G, int PS,
           int DH, float scale, int e_kv, int m_kv, QFmt qacc, double* part,
           float* stats, cudaStream_t s) {
  dim3 grid(B, KV);
  paged_decode_kernel<STATS><<<grid, ATTN_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kp),
      static_cast<const int8_t*>(vp), static_cast<const int*>(kse),
      static_cast<const int*>(vse), static_cast<const int*>(page_table),
      max_pages, static_cast<const int*>(seq_lens), static_cast<float*>(out),
      KV, G, PS, DH, scale, e_kv, m_kv, qacc, part);
  const int rc = static_cast<int>(cudaGetLastError());
  if (!STATS || rc != 0) return rc;
  return stats_finish(part, B * KV, B * KV, 1, stats, s);
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
  return launch<false>(q, kp, vp, kse, vse, page_table, max_pages, seq_lens,
                       out, B, KV, G, PS, DH, scale, e_kv, m_kv,
                       QFmt{c_identity, c_shift, c_max, c_min}, nullptr,
                       nullptr, static_cast<cudaStream_t>(stream));
}

// K12: paged_decode plus stats [N_STATS] f32; part is a workspace of
// B * KV * N_STATS doubles (one partial row per block).
extern "C" int paged_decode_stats(const void* q, const void* kp,
                                  const void* vp, const void* kse,
                                  const void* vse, const void* page_table,
                                  int max_pages, const void* seq_lens,
                                  void* out, int B, int KV, int G, int PS,
                                  int DH, float scale, int e_kv, int m_kv,
                                  int c_identity, int c_shift, float c_max,
                                  float c_min, void* part, void* stats,
                                  void* stream) {
  return launch<true>(q, kp, vp, kse, vse, page_table, max_pages, seq_lens,
                      out, B, KV, G, PS, DH, scale, e_kv, m_kv,
                      QFmt{c_identity, c_shift, c_max, c_min},
                      static_cast<double*>(part), static_cast<float*>(stats),
                      static_cast<cudaStream_t>(stream));
}
