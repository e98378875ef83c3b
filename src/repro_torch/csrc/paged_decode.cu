// D and K12: paged decode attention over the int8 KV arena, the page walk
// of each (sequence, KV head) split over the blocks of a thread-block
// cluster.
//
// Replaces repro/kernels/attention.py::_decode_kernel (D: the finalized
// output, and with CARRY its emit_carry variant, paged_decode_carry) and
// ::_decode_kernel_stats (K12, paged_decode_stats).  The query
// heads hh = hk * g + gg of KV head hk attend over the pages
// p < ceil(seq_len / page_size) of the sequence's page-table row.  A page
// is decoded with its 2^se scale, its base-2 scores are sums over d in
// increasing d, and the online update runs with a running max on the
// integer lattice and the o/l carries rounded to (1, e_acc, m_acc) once a
// page; l and p.v add the page's tokens in token order, each product
// rounded then added: the order of the plain PyTorch version.
//
// What bounds it on the H100.  At the serve shapes (B 8, KV 2, rows of up
// to 24 pages of 16 tokens, dh 128) the pages are a few hundred KB: the
// byte bound is about 0.23 us.  What is left is the launch and the
// dependent chains of a page: a score is a chain of dh adds, l and p.v
// chains of page_size adds, and the carry fold a chain of one rounded
// multiply-add per page.  One block per (sequence, KV head) would run
// those pages one after another on 16 blocks; here the cluster's CL
// blocks (sm90.decode_cluster: 128 blocks at B 8, 16 at the
// monitor's B 1) take a contiguous run of pages each, so a block's chains
// run side by side and only the fold stays sequential.
//
// Why the split is exact.  The running max after page p is
// m_p = max(m_{p-1}, ceil(max_t s_t)), the prefix max of the pages' ceil
// maxima: it does not depend on o or l.  So once the maxima are known,
// each page's alpha_p = exp2(m_{p-1} - m_p), its probabilities
// exp2(s - m_p), its l sum and its p.v are the walk's own, formed from
// the same floats in the same order, on any operands.  A round runs:
//   A. each block forms its pages' scores, keeps them in shared memory
//      and publishes each page's ceil max;
//   cluster barrier; each block reads every rank's maxima through
//      distributed shared memory and forms m_p and alpha_p of every page
//      of the round in page order, as the walk does;
//   B. each block forms its pages' probabilities, l sums and p.v;
//   cluster barrier; the fold o = Q(o * alpha_p + pv_p),
//      l = Q(l * alpha_p + lsum_p) runs in page order.  It is independent
//      per output (gg, d), so rank r folds the r-th slice of the g * dh
//      outputs, reading every rank's partials of that slice through
//      distributed shared memory (one gather, then local reads), and
//      finalizes them with o / l.  Folding rank by rank instead would
//      pass the carries through CL barriers one after another.
// The maxima are exact (max and ceil round nothing), and no sum changes
// its order, so D is bitwise the walk.
//
// Shared memory.  A block holds at most rank_pages pages a round
// (sm90.attn_decode_schedule: enough for the widest row in one round, at
// most 8 and within 112 KB, so that two blocks of at most 128 registers a
// thread fit an SM and a cluster of 8 finds room at once).  A row longer than cluster * rank_pages pages
// takes rounds of that many pages in page order, with m, l and o carried
// from one round to the next, so shared memory is bounded at any
// page-table width.  A page's K and V codes (one contiguous 2 KB slice at
// the serve shape) land by 16-byte cp.async in a ring of rank_pages
// slots; K is decoded to floats for the scores, V in the p.v threads.
//
// CARRY (paged_decode_carry, return_carry=True: the tensor-parallel
// engine's carry merge owns the finalize) writes the raw o carries of its
// slice instead of o / l, and rank 0 of the cluster writes each (row,
// head)'s m and l, which every rank holds.  The split and the page-order
// fold are D's, so the carry is bitwise the plain walk's before its
// finalize.
//
// K12 (STATS) keeps D's o bitwise and forms, in the fold, an f32 shadow
// o_i = o_i * alpha + pv with D's alpha and pv and the N_STATS row over
// the outputs of the sequences with seq_len > 0: per page update, adds
// (pv != 0) and swamped (the new carry equals prev * alpha), max |o|;
// after the row's last page the moments of (o, o_i).  The TPU kernel
// walks every page-table column and takes the moments on the last one; a
// page past seq_len is a carry no-op there (alpha = 1, pv = 0, no add
// counted), so stopping at the last valid page gives the same row.  Each block writes
// one partial row, B * KV * CL rows in all, summed in a fixed order by
// common.cuh's second pass: no float atomics.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// mirrored in repro_torch/kernels/sm90.py (ATTN_*)
#define DECODE_THREADS 256
#define DECODE_WARPS (DECODE_THREADS / 32)

namespace {

__host__ __device__ __forceinline__ int al4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// A block's dynamic shared memory, offsets in floats (each region 16-byte
// aligned), then the K and V codes; sm90.attn_decode_smem mirrors it.
struct Layout {
  int qs, kf, sc, pv, cmax, lsum, cm_all, alpha_all, lsum_all, ml, oc, st,
      scl, ids;
  int floats, code_bytes, R;
  __host__ __device__ Layout(int G, int PS, int DH, int CL, int R_)
      : R(R_) {
    const int dp = al4(DH), per_o = cdiv(G * DH, CL);
    const int kvals = R * PS * (dp + 4), gath = CL * R * per_o;
    int o = 0;
    qs = o;        o += al4(G * dp);
    kf = o;        o += al4(kvals > gath ? kvals : gath);
    sc = o;        o += al4(R * G * PS);
    pv = o;        o += al4(R * G * DH);
    cmax = o;      o += al4(R * G);
    lsum = o;      o += al4(R * G);
    cm_all = o;    o += al4(CL * R * G);
    alpha_all = o; o += al4(CL * R * G);
    lsum_all = o;  o += al4(CL * R * G);
    ml = o;        o += al4(2 * G);
    oc = o;        o += 2 * al4(per_o);
    st = o;        o += 3 * DECODE_THREADS;
    scl = o;       o += al4(2 * R);
    ids = o;       o += al4(R);
    floats = o;
    code_bytes = (PS * DH + 15) & ~15;
  }
  __host__ __device__ int bytes() const { return floats * 4 + 2 * R * code_bytes; }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the (page, KV head) codes of a block's n pages (ids from shared memory,
// each slice n_elems contiguous bytes at ((id * KV + hk) * n_elems)) into
// slots of `slot` bytes: 16 bytes a thread where the slices and the arena
// allow it, else a byte a thread
__device__ __forceinline__ void stage_pages(int8_t* dst, const int8_t* src,
                                            const int* ids, int n, int KV,
                                            int hk, int n_elems, int slot,
                                            bool vec) {
  const int w = vec ? 16 : 1, per = n_elems / w;
  for (int i = threadIdx.x; i < n * per; i += DECODE_THREADS) {
    const int j = i / per, c = (i - j * per) * w;
    const int8_t* from = src + ((long long)ids[j] * KV + hk) * n_elems + c;
    if (vec) cp_async16(dst + j * slot + c, from);
    else dst[j * slot + c] = *from;
  }
}

// NC score chains a thread: chains c0 + tid + i * DECODE_THREADS of the
// round's [page j][head gg][token t] scores, each a sum over d in
// increasing d (K and q rows padded to dp with zeros, which add exactly
// nothing: an f32 chain from +0 never holds -0)
template <int NC>
__device__ __forceinline__ void score_pass(int c0, int n, const float* kf,
                                           const float* qs, float* sc, int G,
                                           int PS, int dp, int tok0,
                                           int seq_len, float scale) {
  const float4* k4 = reinterpret_cast<const float4*>(kf);
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  int kr[NC], qr[NC];  // float4 offsets of the chain's K row and q row
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = c0 + threadIdx.x + i * DECODE_THREADS;
    const int cc = c < n ? c : 0;
    const int t = cc % PS, jg = cc / PS;
    kr[i] = ((jg / G) * PS + t) * (dp + 4) / 4;
    qr[i] = (jg % G) * dp / 4;
    acc[i] = 0.0f;
  }
#pragma unroll 2
  for (int d4 = 0; d4 < dp / 4; ++d4) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float4 k = k4[kr[i] + d4], x = q4[qr[i] + d4];
      acc[i] = __fadd_rn(acc[i], __fmul_rn(x.x, k.x));
      acc[i] = __fadd_rn(acc[i], __fmul_rn(x.y, k.y));
      acc[i] = __fadd_rn(acc[i], __fmul_rn(x.z, k.z));
      acc[i] = __fadd_rn(acc[i], __fmul_rn(x.w, k.w));
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = c0 + threadIdx.x + i * DECODE_THREADS;
    if (c < n) {
      const int t = c % PS, j = c / PS / G;
      sc[c] = tok0 + j * PS + t < seq_len ? __fmul_rn(acc[i], scale) : REPRO_NEG;
    }
  }
}

template <bool STATS, bool CARRY>
__global__ void __launch_bounds__(DECODE_THREADS, 2) paged_decode_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ kp,
    const int8_t* __restrict__ vp, const int* __restrict__ kse,
    const int* __restrict__ vse, const int* __restrict__ page_table,
    int max_pages, const int* __restrict__ seq_lens, float* __restrict__ out,
    int KV, int G, int PS, int DH, int R, float scale, int e_kv, int m_kv,
    QFmt qacc, double* __restrict__ part, float* __restrict__ om,
    float* __restrict__ ol) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per_o = cdiv(G * DH, CL), o_lo = rank * per_o;  // folded here
  const int row = blockIdx.x / CL;  // b * KV + hk
  const int b = row / KV, hk = row % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout L(G, PS, DH, CL, R);
  float* qs = smem + L.qs;
  float* kf = smem + L.kf;        // K values, then the gathered partials
  float* sc = smem + L.sc;        // scores, then probabilities
  float* pv = smem + L.pv;        // [j][gg * DH + d], read by the cluster
  float* cmax = smem + L.cmax;    // [j][gg] ceil maxima, read by the cluster
  float* lsum = smem + L.lsum;    // [j][gg] l sums, read by the cluster
  float* cm_all = smem + L.cm_all;  // [k][gg] every rank's maxima, then m_k
  float* alpha_all = smem + L.alpha_all;
  float* lsum_all = smem + L.lsum_all;
  float* ml = smem + L.ml;        // m carry [G], then l carry [G]
  float* oc = smem + L.oc;        // this rank's o carries, then (STATS) o_i
  float* oic = oc + al4(per_o);
  // STATS: each thread's adds, swamped adds and max |o| (kept out of
  // registers, which the page phases need)
  int* st_adds = reinterpret_cast<int*>(smem + L.st);
  int* st_swamped = st_adds + DECODE_THREADS;
  float* st_max = smem + L.st + 2 * DECODE_THREADS;
  float* scl = smem + L.scl;      // K scales [R], then V scales [R]
  int* ids = reinterpret_cast<int*>(smem + L.ids);  // the round's page ids
  int8_t* kc = reinterpret_cast<int8_t*>(smem + L.floats);
  int8_t* vc = kc + R * L.code_bytes;

  const int H = KV * G, GD = G * DH, dp = al4(DH), kst = dp + 4;
  const int seq_len = seq_lens[b];
  const int n_pages = (seq_len + PS - 1) / PS;
  const int page_elems = PS * DH;
  const bool vec = page_elems % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(kp) |
                     reinterpret_cast<uintptr_t>(vp)) & 15) == 0;
  const bool word = DH % 4 == 0;

  for (int i = tid; i < G * dp; i += DECODE_THREADS) {
    const int gg = i / dp, d = i % dp;
    qs[i] = d < DH ? q[((long long)b * H + hk * G + gg) * DH + d] : 0.0f;
  }
  if (tid < G) { ml[tid] = REPRO_NEG; ml[G + tid] = 0.0f; }
  for (int i = tid; i < per_o; i += DECODE_THREADS) oc[i] = oic[i] = 0.0f;
  st_adds[tid] = st_swamped[tid] = 0;
  st_max[tid] = 0.0f;

  const int cap = CL * R;
  for (int base = 0; base < n_pages; base += cap) {
    const int npr = min(cap, n_pages - base);  // the round's pages
    const int per = cdiv(npr, CL);
    const int my0 = min(rank * per, npr), mine = min(my0 + per, npr) - my0;
    __syncthreads();  // the last round's reads of codes and scales are done
    if (tid < mine) {  // the pages' ids and scales, all at once
      const int pid = page_table[(long long)b * max_pages + base + my0 + tid];
      ids[tid] = pid;
      scl[tid] = exp2_int(kse[pid]);
      scl[R + tid] = exp2_int(vse[pid]);
    }
    __syncthreads();
    stage_pages(kc, kp, ids, mine, KV, hk, page_elems, L.code_bytes, vec);
    cp_async_commit();
    stage_pages(vc, vp, ids, mine, KV, hk, page_elems, L.code_bytes, vec);
    cp_async_commit();
    cp_async_wait<1>();  // K has landed; V stays in flight through phase A
    __syncthreads();

    // phase A: decode K (a warp a token row, 4 d a lane), then the scores
    for (int r = warp; r < mine * PS; r += DECODE_WARPS) {
      const int j = r / PS, t = r - j * PS;
      const int8_t* src = kc + j * L.code_bytes + t * DH;
      const float s = scl[j];
      for (int d4 = lane; d4 < dp / 4; d4 += 32) {
        const int d = 4 * d4;
        int8_t c[4];
        if (word) {
          const int w = *reinterpret_cast<const int*>(src + d);
#pragma unroll
          for (int u = 0; u < 4; ++u) c[u] = static_cast<int8_t>(w >> (8 * u));
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) c[u] = d + u < DH ? src[d + u] : 0;
        }
        float4 x;
        x.x = __fmul_rn(unpack_code(c[0], e_kv, m_kv), s);
        x.y = __fmul_rn(unpack_code(c[1], e_kv, m_kv), s);
        x.z = __fmul_rn(unpack_code(c[2], e_kv, m_kv), s);
        x.w = __fmul_rn(unpack_code(c[3], e_kv, m_kv), s);
        if (d + 1 >= DH) x.y = 0.0f;  // padding past dh
        if (d + 2 >= DH) x.z = 0.0f;
        if (d + 3 >= DH) x.w = 0.0f;
        *reinterpret_cast<float4*>(kf + (j * PS + t) * kst + d) = x;
      }
    }
    __syncthreads();
    const int n_sc = mine * G * PS, tok0 = (base + my0) * PS;
    for (int c0 = 0; c0 < n_sc;) {
      if (n_sc - c0 > DECODE_THREADS) {
        score_pass<2>(c0, n_sc, kf, qs, sc, G, PS, dp, tok0, seq_len, scale);
        c0 += 2 * DECODE_THREADS;
      } else {
        score_pass<1>(c0, n_sc, kf, qs, sc, G, PS, dp, tok0, seq_len, scale);
        c0 += DECODE_THREADS;
      }
    }
    __syncthreads();
    if (tid < mine * G) {
      float mx = REPRO_NEG;
      for (int t = 0; t < PS; ++t) mx = fmaxf(mx, sc[tid * PS + t]);
      cmax[tid] = ceilf(mx);
    }
    cluster.sync();  // every rank's maxima are published

    // the round's running max and rescales, page by page, from every
    // rank's maxima (the pages of rank q are [q * per, (q + 1) * per))
    for (int i = tid; i < npr * G; i += DECODE_THREADS) {
      const int k = i / G, owner = k / per;
      cm_all[i] = *cluster.map_shared_rank(cmax + (k - owner * per) * G + i % G,
                                           owner);
    }
    __syncthreads();
    if (tid < G) {
      float m = ml[tid];
#pragma unroll 4
      for (int k = 0; k < npr; ++k) {
        const float mn = fmaxf(m, cm_all[k * G + tid]);
        alpha_all[k * G + tid] = exp2f(m - mn);
        cm_all[k * G + tid] = mn;
        m = mn;
      }
      ml[tid] = m;
    }
    cp_async_wait<0>();  // V has landed
    __syncthreads();

    // phase B: probabilities, then l sums and p.v in token order
    for (int i = tid; i < n_sc; i += DECODE_THREADS) {
      const int t = i % PS, jg = i / PS, j = jg / G;
      sc[i] = tok0 + j * PS + t < seq_len
                  ? exp2f(sc[i] - cm_all[(my0 + j) * G + jg % G])
                  : 0.0f;
    }
    __syncthreads();
    // the l sums on the last threads, which take the fewest p.v items
    if (tid >= DECODE_THREADS - mine * G) {
      const int jg = tid - (DECODE_THREADS - mine * G);
      float s = 0.0f;
      for (int t = 0; t < PS; ++t) s = __fadd_rn(s, sc[jg * PS + t]);
      lsum[jg] = s;
    }
    for (int i = tid; i < mine * DH; i += DECODE_THREADS) {
      const int j = i / DH, d = i - j * DH;
      const int8_t* src = vc + j * L.code_bytes + d;
      const float* pr = sc + j * G * PS;
      const float s = scl[R + j];
      float acc[MAX_G];
#pragma unroll
      for (int gg = 0; gg < MAX_G; ++gg) acc[gg] = 0.0f;
      for (int t = 0; t < PS; ++t) {
        const float x = __fmul_rn(unpack_code(src[t * DH], e_kv, m_kv), s);
#pragma unroll
        for (int gg = 0; gg < MAX_G; ++gg)
          if (gg < G) acc[gg] = __fadd_rn(acc[gg], __fmul_rn(pr[gg * PS + t], x));
      }
#pragma unroll
      for (int gg = 0; gg < MAX_G; ++gg)
        if (gg < G) pv[j * GD + gg * DH + d] = acc[gg];
    }
    cluster.sync();  // every rank's partials are published

    // the fold of this rank's outputs over the round's pages, in order
    float* gath = kf;  // [k][o - o_lo]
    for (int i = tid; i < npr * per_o; i += DECODE_THREADS) {
      const int k = i / per_o, oo = o_lo + (i - k * per_o);
      const int owner = k / per;
      if (oo < GD)
        gath[i] = *cluster.map_shared_rank(pv + (k - owner * per) * GD + oo, owner);
    }
    for (int i = tid; i < npr * G; i += DECODE_THREADS) {
      const int k = i / G, owner = k / per;
      lsum_all[i] = *cluster.map_shared_rank(
          lsum + (k - owner * per) * G + i % G, owner);
    }
    __syncthreads();
    if (tid >= DECODE_THREADS - G) {  // the l fold, beside the o folds
      const int gg = tid - (DECODE_THREADS - G);
      float l = ml[G + gg];
      for (int k = 0; k < npr; ++k)
        l = quantize_rne(__fadd_rn(__fmul_rn(l, alpha_all[k * G + gg]),
                                   lsum_all[k * G + gg]), qacc);
      ml[G + gg] = l;
    }
    for (int i = tid; i < per_o && o_lo + i < GD; i += DECODE_THREADS) {
      const int gg = (o_lo + i) / DH;
      float o = oc[i], oi = oic[i];  // STATS: oi the f32 shadow of o
      int n_adds = 0, n_swamped = 0;
      float max_abs = 0.0f;
      for (int k = 0; k < npr; ++k) {
        const float a = alpha_all[k * G + gg];
        const float p = gath[k * per_o + i];
        const float scaled = __fmul_rn(o, a);
        o = quantize_rne(__fadd_rn(scaled, p), qacc);
        if constexpr (STATS) {
          oi = __fadd_rn(__fmul_rn(oi, a), p);
          if (p != 0.0f) {
            ++n_adds;
            if (o == scaled) ++n_swamped;
          }
          max_abs = fmaxf(max_abs, fabsf(o));
        }
      }
      oc[i] = o;
      if constexpr (STATS) {
        oic[i] = oi;
        st_adds[tid] += n_adds;
        st_swamped[tid] += n_swamped;
        st_max[tid] = fmaxf(st_max[tid], max_abs);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < per_o && o_lo + i < GD; i += DECODE_THREADS) {
    float* o = out + ((long long)b * H + hk * G) * DH + o_lo + i;
    if constexpr (CARRY) {
      *o = oc[i];
    } else {
      const float l = ml[G + (o_lo + i) / DH];
      *o = l > 0.0f ? __fdiv_rn(oc[i], l) : 0.0f;
    }
  }
  if constexpr (CARRY) {
    if (rank == 0 && tid < G) {
      const long long at = (long long)b * H + hk * G + tid;
      om[at] = ml[tid];
      ol[at] = ml[G + tid];
    }
  }
  if constexpr (STATS) {
    // the moments of the outputs after the row's last page
    double v[N_STATS];
#pragma unroll
    for (int s = 0; s < N_STATS; ++s) v[s] = 0.0;
    for (int i = tid; n_pages > 0 && i < per_o && o_lo + i < GD;
         i += DECODE_THREADS)
      stats_moments(v, oc[i], oic[i]);
    __shared__ double sh[DECODE_WARPS * N_STATS];
    v[STAT_MAX_ABS] = st_max[tid];
    v[STAT_SWAMPED] = st_swamped[tid];
    v[STAT_ADDS] = st_adds[tid];
    stats_block_row<DECODE_THREADS>(v, part + ((long long)row * CL + rank) * N_STATS, sh);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// the dynamic shared memory a launch may take, raised once per size
template <bool STATS, bool CARRY>
int allow_smem(int bytes) {
  static int allowed = 48 * 1024;
  if (bytes <= allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      paged_decode_kernel<STATS, CARRY>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  allowed = bytes;
  return 0;
}

cudaLaunchConfig_t launch_config(int blocks, int smem, cudaStream_t s,
                                 cudaLaunchAttribute* attr, int CL) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(DECODE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool STATS, bool CARRY = false>
int launch(const void* q, const void* kp, const void* vp, const void* kse,
           const void* vse, const void* page_table, int max_pages,
           const void* seq_lens, void* out, int B, int KV, int G, int PS,
           int DH, int CL, int R, float scale, int e_kv, int m_kv, QFmt qacc,
           double* part, float* stats, cudaStream_t s, float* om = nullptr,
           float* ol = nullptr) {
  const int smem = Layout(G, PS, DH, CL, R).bytes();
  if (const int rc = allow_smem<STATS, CARRY>(smem)) return rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(B * KV * CL, smem, s, &attr, CL);
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_decode_kernel<STATS, CARRY>, static_cast<const float*>(q),
      static_cast<const int8_t*>(kp), static_cast<const int8_t*>(vp),
      static_cast<const int*>(kse), static_cast<const int*>(vse),
      static_cast<const int*>(page_table), max_pages,
      static_cast<const int*>(seq_lens), static_cast<float*>(out), KV, G, PS,
      DH, R, scale, e_kv, m_kv, qacc, part, om, ol);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (!STATS || e != cudaSuccess) return static_cast<int>(e);
  return stats_finish(part, B * KV * CL, B * KV * CL, 1, stats, s);
}

}  // namespace

// q (B, H, dh) f32; pages (P, KV, PS, dh) int8; scales (P,) int32;
// page_table (B, max_pages) int32; seq_lens (B,) int32; out (B, H, dh);
// CL blocks a (sequence, KV head), R pages a block a round
// (sm90.attn_decode_schedule).
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* kse, const void* vse,
                            const void* page_table, int max_pages,
                            const void* seq_lens, void* out, int B, int KV,
                            int G, int PS, int DH, int CL, int R, float scale,
                            int e_kv, int m_kv, int c_identity, int c_shift,
                            float c_max, float c_min, void* stream) {
  return launch<false>(q, kp, vp, kse, vse, page_table, max_pages, seq_lens,
                       out, B, KV, G, PS, DH, CL, R, scale, e_kv, m_kv,
                       QFmt{c_identity, c_shift, c_max, c_min}, nullptr,
                       nullptr, static_cast<cudaStream_t>(stream));
}

// D's carry entry (return_carry=True): out receives the raw o carry
// (B, H, dh), om and ol (B, H) the running max and the l carry.
extern "C" int paged_decode_carry(const void* q, const void* kp,
                                  const void* vp, const void* kse,
                                  const void* vse, const void* page_table,
                                  int max_pages, const void* seq_lens,
                                  void* out, int B, int KV, int G, int PS,
                                  int DH, int CL, int R, float scale, int e_kv,
                                  int m_kv, int c_identity, int c_shift,
                                  float c_max, float c_min, void* om, void* ol,
                                  void* stream) {
  return launch<false, true>(q, kp, vp, kse, vse, page_table, max_pages,
                             seq_lens, out, B, KV, G, PS, DH, CL, R, scale,
                             e_kv, m_kv, QFmt{c_identity, c_shift, c_max, c_min},
                             nullptr, nullptr, static_cast<cudaStream_t>(stream),
                             static_cast<float*>(om), static_cast<float*>(ol));
}

// K12: paged_decode plus stats [N_STATS] f32; part is a workspace of
// B * KV * CL * N_STATS doubles (one partial row per block).
extern "C" int paged_decode_stats(const void* q, const void* kp,
                                  const void* vp, const void* kse,
                                  const void* vse, const void* page_table,
                                  int max_pages, const void* seq_lens,
                                  void* out, int B, int KV, int G, int PS,
                                  int DH, int CL, int R, float scale, int e_kv,
                                  int m_kv, int c_identity, int c_shift,
                                  float c_max, float c_min, void* part,
                                  void* stats, void* stream) {
  return launch<true>(q, kp, vp, kse, vse, page_table, max_pages, seq_lens,
                      out, B, KV, G, PS, DH, CL, R, scale, e_kv, m_kv,
                      QFmt{c_identity, c_shift, c_max, c_min},
                      static_cast<double*>(part), static_cast<float*>(stats),
                      static_cast<cudaStream_t>(stream));
}

// a block's dynamic shared memory (sm90.attn_decode_smem mirrors it)
extern "C" int paged_decode_smem(int G, int PS, int DH, int CL, int R) {
  return Layout(G, PS, DH, CL, R).bytes();
}

// clusters of the kernel (kind 0: D, 1: K12, 2: D's carry entry) that fit
// the card at once, or minus the CUDA error
template <bool STATS, bool CARRY>
int fit_clusters(int smem, int CL) {
  if (const int rc = allow_smem<STATS, CARRY>(smem)) return -rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(CL * 1024, smem, nullptr, &attr, CL);
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, paged_decode_kernel<STATS, CARRY>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" int paged_decode_clusters(int kind, int G, int PS, int DH, int CL,
                                     int R) {
  const int smem = Layout(G, PS, DH, CL, R).bytes();
  return kind == 2 ? fit_clusters<false, true>(smem, CL)
       : kind == 1 ? fit_clusters<true, false>(smem, CL)
                   : fit_clusters<false, false>(smem, CL);
}
