// P: bucketed causal prefill straight off the paged int8 KV arena.
//
// Replaces repro/kernels/attention.py::_prefill_paged_kernel (no carry in,
// no carry out).  The walk is attn_prefill_sm90.cuh's, over the int8
// pages of the sequence's page row: each page's K/V codes are decoded with
// its 2^se scale once for all g query heads of a KV head and the tile's
// rows.  Pages before start_page, past kv_len or wholly in the causal
// future of a tile's last live row are not walked (carry no-ops); the mask
// is (col <= q_offset + row) & (col < kv_len) & (row < q_len), and rows
// >= q_len attend nothing and come out 0.  q_offset, q_len and kv_len are
// launch arguments.
//
// Bound on the H100: the score and value contractions, 4 * rows * attended
// tokens * dh flops a query head, in f32 on the CUDA cores (twice the FMA
// bound: every product is rounded before its add).
#include "attn_prefill_sm90.cuh"

// q (T, H, dh) f32; pages (P, KV, PS, dh) int8; scales (P,) int32;
// page_row (max_pages,) int32; out (T, H, dh) f32; BR rows a tile, CL
// blocks a tile (one cluster), R pages a block a round
// (sm90.attn_prefill_schedule).  Returns the cudaError_t of the launch.
extern "C" int paged_prefill(const void* q, const void* kp, const void* vp,
                             const void* kse, const void* vse,
                             const void* page_row, void* out, int T, int H,
                             int KV, int PS, int DH, int q_off, int q_len,
                             int kv_len, int start_page, float scale,
                             int e_kv, int m_kv, int c_identity, int c_shift,
                             float c_max, float c_min, int BR, int CL, int R,
                             void* stream) {
  prefill::PrefillArgs a = {};
  a.q = static_cast<const float*>(q);
  a.kp = static_cast<const int8_t*>(kp);
  a.vp = static_cast<const int8_t*>(vp);
  a.kse = static_cast<const int*>(kse);
  a.vse = static_cast<const int*>(vse);
  a.page_row = static_cast<const int*>(page_row);
  a.out = static_cast<float*>(out);
  a.T = T; a.H = H; a.KV = KV; a.G = H / KV; a.DH = DH; a.PS = PS;
  a.q_off = q_off; a.col0 = 0; a.ncols = kv_len; a.live_rows = q_len;
  a.first_page = start_page;
  a.BR = BR; a.R = R;
  a.scale = scale; a.e_kv = e_kv; a.m_kv = m_kv;
  a.qacc = QFmt{c_identity, c_shift, c_max, c_min};
  return prefill::launch<true>(a, CL, static_cast<cudaStream_t>(stream));
}

// a block's dynamic shared memory (sm90.attn_prefill_smem mirrors it)
extern "C" int paged_prefill_smem(int G, int BR, int PS, int DH, int CL, int R) {
  return prefill::Layout(G, BR, PS, DH, CL, R).bytes();
}

// resident blocks an SM, and clusters of CL that fit the card at once
extern "C" int paged_prefill_occupancy(int G, int BR, int PS, int DH, int CL, int R) {
  return prefill::occupancy<true>(G, BR, PS, DH, CL, R);
}
extern "C" int paged_prefill_clusters(int G, int BR, int PS, int DH, int CL, int R) {
  return prefill::clusters<true>(G, BR, PS, DH, CL, R);
}
