// K10: dense causal flash prefill of one sequence, resumable.
//
// Replaces repro/kernels/attention.py::_prefill_kernel (flash_prefill, RNE
// and, with sr, its stochastic-rounding carries: the walk's SR
// instantiation, keyed on the absolute KV block, row, head and feature as
// _sr_attn_bits keys them, so a resumed walk stays bitwise the one-shot
// walk under SR too).
// q (S, H, dh) f32 at absolute rows q_off + i; k, v (Sk, KV, dh) f32 (the
// dequantized KV view) at absolute columns kv_off + j, walked in
// chunk-long steps by attn_prefill_sm90.cuh's walk: each chunk's K/V rows
// are staged once for all g query heads of a KV head and the tile's rows.
// Chunks wholly in the causal future of a tile's last row or past Sk are
// not walked (carry no-ops); the mask is (kv_off + col <= q_off + row) &
// (col < Sk).  It is P's walk on f32 rows, so on the same values K10 is
// bitwise P.
//
// Carry in: (co, cm, cl) in the JAX layouts (S, H, dh), (S, H), (S, H)
// cover the KV before kv_off (kv_off is a multiple of chunk, so a resumed
// walk is bitwise the one-shot walk).  Carry out: out receives the raw o,
// om and ol the running max and l; otherwise out = o / l (0 where l = 0).
// Shared memory is bounded at any chunk: K and V are staged 32 rows at a
// time, and the schedule sizes the rest.
//
// Bound on the H100: the score and value contractions,
// 4 * (attended (row, column) pairs) * dh flops a query head, in f32 on
// the CUDA cores (twice the FMA bound: every product is rounded first).
#include "attn_prefill_sm90.cuh"

#define MAX_CHUNK 128

// q (S, H, dh), k/v (Sk, KV, dh), carry (S, H, dh), (S, H), (S, H) or null;
// out (S, H, dh); om/ol (S, H) or null (finalized output).  All f32,
// contiguous.  chunk <= MAX_CHUNK, dh <= MAX_DH; BR rows a tile, CL blocks
// a tile (one cluster), R chunks a block a round
// (sm90.attn_prefill_schedule); sr: the carries round stochastically under
// `seed`.  Returns the cudaError_t of the launch.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* co, const void* cm, const void* cl,
                             void* out, void* om, void* ol, int S, int H,
                             int Sk, int KV, int DH, int chunk, int q_off,
                             int kv_off, float scale, int c_identity,
                             int c_shift, float c_max, float c_min, int BR,
                             int CL, int R, int sr, unsigned seed,
                             void* stream) {
  if (DH > MAX_DH || chunk > MAX_CHUNK || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  prefill::PrefillArgs a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.co = static_cast<const float*>(co);
  a.cm = static_cast<const float*>(cm);
  a.cl = static_cast<const float*>(cl);
  a.out = static_cast<float*>(out);
  a.om = static_cast<float*>(om);
  a.ol = static_cast<float*>(ol);
  a.T = S; a.H = H; a.KV = KV; a.G = H / KV; a.DH = DH; a.PS = chunk;
  a.q_off = q_off; a.col0 = kv_off; a.ncols = Sk; a.live_rows = S;
  a.first_page = 0;
  a.BR = BR; a.R = R;
  a.scale = scale;
  a.qacc = QFmt{c_identity, c_shift, c_max, c_min};
  a.seed = seed;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sr ? prefill::launch<false, true>(a, CL, s) : prefill::launch<false>(a, CL, s);
}

// a block's dynamic shared memory (sm90.attn_prefill_smem mirrors it)
extern "C" int flash_prefill_smem(int G, int BR, int chunk, int DH, int CL, int R) {
  return prefill::Layout(G, BR, chunk, DH, CL, R).bytes();
}

// resident blocks an SM, and clusters of CL that fit the card at once,
// under RNE and (the _sr_ entries) under SR
extern "C" int flash_prefill_occupancy(int G, int BR, int chunk, int DH, int CL, int R) {
  return prefill::occupancy<false>(G, BR, chunk, DH, CL, R);
}
extern "C" int flash_prefill_clusters(int G, int BR, int chunk, int DH, int CL, int R) {
  return prefill::clusters<false>(G, BR, chunk, DH, CL, R);
}
extern "C" int flash_prefill_sr_occupancy(int G, int BR, int chunk, int DH, int CL, int R) {
  return prefill::occupancy<false, true>(G, BR, chunk, DH, CL, R);
}
extern "C" int flash_prefill_sr_clusters(int G, int BR, int chunk, int DH, int CL, int R) {
  return prefill::clusters<false, true>(G, BR, chunk, DH, CL, R);
}
