// P: bucketed causal prefill straight off the paged int8 KV arena.
//
// Replaces repro/kernels/attention.py::_prefill_paged_kernel: finalized
// (paged_prefill), and with its carries (paged_prefill_carry: has_carry, a
// carry in covering the pages before start_page, and emit_carry, the raw
// carry out, each optional).  The walk is attn_prefill_sm90.cuh's, over the int8
// pages of the sequence's page row: each page's K/V codes are decoded with
// its 2^se scale once for all g query heads of a KV head and the tile's
// rows.  Pages before start_page, past kv_len or wholly in the causal
// future of a tile's last live row are not walked (carry no-ops); the mask
// is (col <= q_offset + row) & (col < kv_len) & (row < q_len), and rows
// >= q_len attend nothing and come out 0.  q_offset, q_len and kv_len are
// launch arguments (paged_prefill, paged_prefill_carry), or read by every
// block from an int32[4] device tensor (q_offset, q_len, kv_len,
// start_page) at its start (paged_prefill_geom, JAX's traced geom operand):
// the launch then depends on the shapes only, so one captured CUDA graph
// serves every slab geometry of a bucket.  Its schedule is picked from the
// slab width and the page row's width; tiles past q_len and cluster ranks
// past the live pages walk nothing.  The walk, and so every bit, is the
// launch-argument entry's.
//
// Bound on the H100: the score and value contractions, 4 * rows * attended
// tokens * dh flops a query head, in f32 on the CUDA cores (twice the FMA
// bound: every product is rounded before its add).
#include "attn_prefill_sm90.cuh"

// q (T, H, dh) f32; pages (P, KV, PS, dh) int8; scales (P,) int32;
// page_row (max_pages,) int32; out (T, H, dh) f32; BR rows a tile, CL
// blocks a tile (one cluster), R pages a block a round
// (sm90.attn_prefill_schedule).  Returns the cudaError_t of the launch.
static int run(const void* q, const void* kp, const void* vp,
               const void* kse, const void* vse, const void* page_row,
               const void* co, const void* cm, const void* cl, void* out,
               void* om, void* ol, int T, int H, int KV, int PS, int DH,
               int q_off, int q_len, int kv_len, int start_page, float scale,
               int e_kv, int m_kv, int c_identity, int c_shift, float c_max,
               float c_min, int BR, int CL, int R, void* stream) {
  prefill::PrefillArgs a = {};
  a.q = static_cast<const float*>(q);
  a.kp = static_cast<const int8_t*>(kp);
  a.vp = static_cast<const int8_t*>(vp);
  a.kse = static_cast<const int*>(kse);
  a.vse = static_cast<const int*>(vse);
  a.page_row = static_cast<const int*>(page_row);
  a.co = static_cast<const float*>(co);
  a.cm = static_cast<const float*>(cm);
  a.cl = static_cast<const float*>(cl);
  a.out = static_cast<float*>(out);
  a.om = static_cast<float*>(om);
  a.ol = static_cast<float*>(ol);
  a.T = T; a.H = H; a.KV = KV; a.G = H / KV; a.DH = DH; a.PS = PS;
  a.q_off = q_off; a.col0 = 0; a.ncols = kv_len; a.live_rows = q_len;
  a.first_page = start_page;
  a.BR = BR; a.R = R;
  a.scale = scale; a.e_kv = e_kv; a.m_kv = m_kv;
  a.qacc = QFmt{c_identity, c_shift, c_max, c_min};
  return prefill::launch<true>(a, CL, static_cast<cudaStream_t>(stream));
}

// P with its geometry on the device: geom int32[4] = (q_offset, q_len,
// kv_len, start_page); row_pages the page row's width (the walk never
// passes it).  Finalized output, no carries.
extern "C" int paged_prefill_geom(const void* q, const void* kp, const void* vp,
                                  const void* kse, const void* vse,
                                  const void* page_row, const void* geom, void* out,
                                  int T, int H, int KV, int PS, int DH, int row_pages,
                                  float scale, int e_kv, int m_kv, int c_identity,
                                  int c_shift, float c_max, float c_min, int BR,
                                  int CL, int R, void* stream) {
  if (geom == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  prefill::PrefillArgs a = {};
  a.q = static_cast<const float*>(q);
  a.kp = static_cast<const int8_t*>(kp);
  a.vp = static_cast<const int8_t*>(vp);
  a.kse = static_cast<const int*>(kse);
  a.vse = static_cast<const int*>(vse);
  a.page_row = static_cast<const int*>(page_row);
  a.geom = static_cast<const int*>(geom);
  a.row_pages = row_pages;
  a.out = static_cast<float*>(out);
  a.T = T; a.H = H; a.KV = KV; a.G = H / KV; a.DH = DH; a.PS = PS;
  a.BR = BR; a.R = R;
  a.scale = scale; a.e_kv = e_kv; a.m_kv = m_kv;
  a.qacc = QFmt{c_identity, c_shift, c_max, c_min};
  return prefill::launch<true, false, true>(a, CL, static_cast<cudaStream_t>(stream));
}

extern "C" int paged_prefill(const void* q, const void* kp, const void* vp,
                             const void* kse, const void* vse,
                             const void* page_row, void* out, int T, int H,
                             int KV, int PS, int DH, int q_off, int q_len,
                             int kv_len, int start_page, float scale,
                             int e_kv, int m_kv, int c_identity, int c_shift,
                             float c_max, float c_min, int BR, int CL, int R,
                             void* stream) {
  return run(q, kp, vp, kse, vse, page_row, nullptr, nullptr, nullptr, out,
             nullptr, nullptr, T, H, KV, PS, DH, q_off, q_len, kv_len,
             start_page, scale, e_kv, m_kv, c_identity, c_shift, c_max, c_min,
             BR, CL, R, stream);
}

// P with its carries, in the JAX layouts: (co, cm, cl) (T, H, dh), (T, H),
// (T, H) cover the pages before start_page (the walk's carry-in load and
// its pages from first_page = start_page), or null; with om and ol (T, H)
// set, out receives the raw o and om/ol the running max and l (rank 0 of
// a tile's cluster writes them), else out = o / l.
extern "C" int paged_prefill_carry(const void* q, const void* kp,
                                   const void* vp, const void* kse,
                                   const void* vse, const void* page_row,
                                   const void* co, const void* cm,
                                   const void* cl, void* out, void* om,
                                   void* ol, int T, int H, int KV, int PS,
                                   int DH, int q_off, int q_len, int kv_len,
                                   int start_page, float scale, int e_kv,
                                   int m_kv, int c_identity, int c_shift,
                                   float c_max, float c_min, int BR, int CL,
                                   int R, void* stream) {
  if ((co == nullptr) != (cm == nullptr) || (co == nullptr) != (cl == nullptr) ||
      (om == nullptr) != (ol == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return run(q, kp, vp, kse, vse, page_row, co, cm, cl, out, om, ol, T, H,
             KV, PS, DH, q_off, q_len, kv_len, start_page, scale, e_kv, m_kv,
             c_identity, c_shift, c_max, c_min, BR, CL, R, stream);
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
