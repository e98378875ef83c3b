// The causal prefill walk shared by P (paged_prefill.cu, over the int8 KV
// arena) and K10 (flash_prefill.cu, over f32 K/V rows, resumable).
//
// Replaces the page walk of repro/kernels/attention.py::_prefill_paged_kernel
// (P) and ::_prefill_kernel (K10).  Query head hh = hk * g + gg reads KV
// head hk.  The KV columns are walked in steps of PS ("pages": the page
// size for P, the chunk for K10).  A step's scores are f32 sums over d in
// increasing d times the scale; the running max is max(m, ceil(max_t s)),
// on the integer lattice, so alpha = exp2(m - m') is a power of two; l and
// p.v add the step's tokens in token order, each product rounded then
// added; the o and l carries are rounded to (1, e_acc, m_acc) once a step:
// the order of the plain PyTorch versions (_seq_dot, _online_update).
//
// What bounds it on the H100.  The score and value contractions, 4 * rows *
// attended tokens * dh flops a query head, in f32 on the CUDA cores, each
// product rounded before its add (--fmad=false): twice the FMA bound.  At
// the serve shapes the work an SM is a few microseconds of issue, so what
// costs is latency: a block per query head would load and decode each KV
// page g times and walk the pages one after another, each score one
// dependent chain.
//
// The design.  A block serves one tile of BR query rows of one KV head, for
// all g of its query heads: HR = g * BR (head, row) chains share every
// staged K and V value.  Each tile's page walk is split over the CL blocks
// (ranks) of a thread-block cluster.
//
// Why the split is exact.  The running max after page p is the prefix max
// m_p = max(m_{p-1}, ceil(max_t s_t)) of the pages' ceil maxima: it does not
// depend on o or l.  Once the maxima are known, each page's alpha_p =
// exp2(m_{p-1} - m_p), its probabilities exp2(s - m_p), its l sum and its
// p.v are the walk's own, formed from the same floats in the same order, on
// any operands; only the carries o = Q(o * alpha_p + pv_p), l = Q(l *
// alpha_p + lsum_p) need the pages in order.  A round of CL * R pages runs:
//   A.  rank r forms the scores of its contiguous run of at most R pages
//       (K staged a piece of PIECE tokens at a time, decoded once for all
//       HR chains; each thread holds 2 rows x 4 tokens of chains, q and K
//       read as float4) and publishes each page's ceil max per chain;
//   cluster barrier; every rank reads the round's maxima of every rank
//       through distributed shared memory and forms m_p and alpha_p of every
//       page in page order, as the walk does;
//   B1. rank r turns its pages' scores into probabilities and publishes
//       their l sums per chain;
//   cluster barrier; every rank folds l over the round's pages in order;
//   B2. rank r owns the output columns [r * dsl, (r + 1) * dsl): for each
//       rank's pages in page order it copies that rank's probabilities
//       (distributed shared memory) and stages its V columns up to 4 pages
//       at a time; a thread takes one or two chains and 4 columns and runs
//       the staged pages' p.v chains side by side, each in token order,
//       then folds o over them in page order;
//   cluster barrier: no rank reads this round's data any more.
// The maxima are exact (max and ceil round nothing) and no sum changes its
// order, so the output is bitwise the walk's.  Schedule parameters (BR, CL,
// R and PIECE) change no bit.  No tensor-core MMA forms a sum: its order
// would differ from the sequential chains.
//
// Stochastic rounding (K10 only; an SR template flag, so P and K10 under
// RNE keep their code): the o and l carries round with quantize_sr and
// dither bits keyed as repro/kernels/attention.py::_sr_attn_bits keys
// them.  Page p of the walk is KV block col0 / PS + p of the sequence (the
// step); o's flat index is (absolute row) * H * DH + head * DH + d, l's
// (absolute row) * H + head under seed ^ L_SALT, every product mod 2^32.
// The bits depend on the absolute block, row, head and feature only, so a
// resumed walk draws the one-shot walk's.  Pages the walk skips are
// carry no-ops under SR too: a representable carry is a fixed point of the
// dither, as the JAX package's predication argues.
//
// Shared memory.  q of the tile, one K piece, the rank's R pages of scores,
// one copied rank's probabilities, one V piece of the rank's columns, the
// o carries (and the p.v partials of a page longer than a piece), and the
// round's maxima, rescales and l sums; sm90.attn_prefill_schedule picks R
// and BR so that two blocks fit an SM, and a longer walk takes rounds with
// m, l and o carried, so shared memory is bounded at any length or chunk.
// sm90.attn_prefill_smem mirrors Layout.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// the l carry's seed salt (repro/kernels/attention.py::_L_SALT)
#define PREFILL_L_SALT 0x6A09E667u

// mirrored in repro_torch/kernels/sm90.py (PREFILL_*)
#define PREFILL_THREADS 256
#define PREFILL_PIECE 32        // K tokens staged a step (at most)
#define PREFILL_PV_PAGES 4      // pages of p.v chains a thread runs at once
// p.v outputs (chains x 4 columns) of a block from which a thread takes
// two chains (and half the pages at once)
#define PREFILL_PV_TWO_ROWS 256
#define PREFILL_V_FLOATS 4096   // a V piece's floats (at most), where pages fit

// internal linkage: a library that loads beside another built from this
// header (an ablation's variants) keeps its own allow_smem state
namespace prefill {
namespace {

__host__ __device__ __forceinline__ int al4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// K tokens a piece: whole pages where a page fits, else PREFILL_PIECE
__host__ __device__ __forceinline__ int piece_len(int PS) {
  return PS <= PREFILL_PIECE ? (PREFILL_PIECE / PS) * PS : PREFILL_PIECE;
}

// V tokens a piece: up to PREFILL_PV_PAGES whole pages within
// PREFILL_V_FLOATS where a page fits a K piece, else PREFILL_PIECE tokens
// of one page
__host__ __device__ __forceinline__ int vpiece_len(int PS, int dsl) {
  if (PS > PREFILL_PIECE) return PREFILL_PIECE;
  const int nb = PREFILL_V_FLOATS / (PS * dsl);
  return (nb < 1 ? 1 : nb > PREFILL_PV_PAGES ? PREFILL_PV_PAGES : nb) * PS;
}

// A block's dynamic shared memory, offsets in floats (each region 16-byte
// aligned); sm90.attn_prefill_smem mirrors it.
struct Layout {
  int HR, dp, qst, sst, dsl, cap, pl, plv;
  int qs, kf, sc, pb, vf, pva, oc, cpub, lpub, cm_all, al_all, ls_all, ml,
      ids, ksc, vsc, floats;
  __host__ __device__ Layout(int G, int BR, int PS, int DH, int CL, int R) {
    HR = G * BR;
    dp = al4(DH);
    qst = dp + 4;              // q and K rows, padded: float4 reads hit
                               // distinct banks across rows
    sst = (al4(R * PS) / 4 | 1) * 4;  // score rows: float4 reads of 8
                                      // consecutive rows hit distinct banks
    dsl = al4(cdiv(DH, CL));   // output columns a rank
    cap = CL * R;              // pages a round
    pl = piece_len(PS);
    plv = vpiece_len(PS, dsl);
    int o = 0;
    qs = o;     o += HR * qst;
    kf = o;     o += pl * qst;
    sc = o;     o += al4(HR * sst);
    pb = o;     o += CL > 1 ? al4(HR * sst) : 0;
    vf = o;     o += plv * dsl;
    pva = o;    o += PS > PREFILL_PIECE ? HR * dsl : 0;
    oc = o;     o += HR * dsl;
    cpub = o;   o += al4(R * HR);
    lpub = o;   o += al4(R * HR);
    cm_all = o; o += al4(cap * HR);
    al_all = o; o += al4(cap * HR);
    ls_all = o; o += al4(cap * HR);
    ml = o;     o += al4(2 * HR);
    ids = o;    o += al4(cap);
    ksc = o;    o += al4(cap);
    vsc = o;    o += al4(cap);
    floats = o;
  }
  __host__ __device__ int bytes() const { return floats * 4; }
};

// The walk's operands.  P: the arena's int8 pages (P, KV, PS, DH) with
// their 2^se scales and the sequence's page row; K10: f32 rows (Sk, KV,
// DH).  Both take the carry in (co, cm, cl; the walk then starts at
// first_page, P's start_page) and out (om, ol), each optional, indexed by
// the slab's row.  Column c of the walk is absolute column col0 + c; row i
// is absolute row q_off + i.
struct PrefillArgs {
  const float* q;  // (T, H, DH)
  const int8_t* kp;
  const int8_t* vp;
  const int* kse;
  const int* vse;
  const int* page_row;
  const float* k;
  const float* v;
  const float* co;
  const float* cm;
  const float* cl;
  float* out;  // (T, H, DH)
  float* om;   // (T, H) or null
  float* ol;
  int T, H, KV, G, DH, PS;
  int q_off, col0, ncols, live_rows, first_page;
  // P's device geometry (GEOM instantiations): int32 (q_off, live_rows,
  // ncols, first_page) read at the kernel's start instead of the four
  // launch arguments above; row_pages bounds the walk to the page row
  const int* geom;
  int row_pages;
  int BR, R;
  int vec;  // DH % 4 == 0 and aligned operands: 4 codes or floats a load
  float scale;
  int e_kv, m_kv;
  QFmt qacc;
  unsigned seed;  // the SR dither's seed (SR instantiations only)
};

// SR: the flat index of chain hr's carry column 0 over absolute rows, o's
// (width H * DH, the chain's head * DH on) with d = DH, l's (width H) with
// d = 1
__device__ __forceinline__ unsigned sr_flat(const PrefillArgs& a, int r0, int hk, int hr,
                                            int d) {
  const unsigned row = (unsigned)(a.q_off + r0 + hr / a.G);
  return row * (unsigned)(a.H * d) + (unsigned)((hk * a.G + hr % a.G) * d);
}

// 4 codes of a K or V page row from d, packed in an int (zero past DH)
__device__ __forceinline__ int code4(const PrefillArgs& a, const int8_t* codes,
                                     const int* ids, int hk, int page0, int c,
                                     int d) {
  const int8_t* src =
      codes + (((long long)ids[c / a.PS - page0] * a.KV + hk) * a.PS + c % a.PS) * a.DH + d;
  if (a.vec) return *reinterpret_cast<const int*>(src);
  int w = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (d + u < a.DH) w |= static_cast<int>(static_cast<uint8_t>(src[u])) << (8 * u);
  return w;
}

// 4 floats of a K or V row from d (zero past DH or past the columns)
__device__ __forceinline__ float4 row4(const PrefillArgs& a, const float* rows,
                                       int hk, int c, int d) {
  if (c >= a.ncols) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* src = rows + ((long long)c * a.KV + hk) * a.DH + d;
  if (a.vec) return *reinterpret_cast<const float4*>(src);
  float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (d + u < a.DH) x[u] = src[u];
  return make_float4(x[0], x[1], x[2], x[3]);
}

// 4 codes decoded with the page's 2^se scale: each an exact product
__device__ __forceinline__ float4 decode4(int w, const PrefillArgs& a, float s) {
  return make_float4(
      __fmul_rn(unpack_code(static_cast<int8_t>(w), a.e_kv, a.m_kv), s),
      __fmul_rn(unpack_code(static_cast<int8_t>(w >> 8), a.e_kv, a.m_kv), s),
      __fmul_rn(unpack_code(static_cast<int8_t>(w >> 16), a.e_kv, a.m_kv), s),
      __fmul_rn(unpack_code(static_cast<int8_t>(w >> 24), a.e_kv, a.m_kv), s));
}

// K of columns [c0, c0 + n) into kf rows (dp floats each), or V of output
// columns [d0, d0 + width) into vf rows (width floats each); zero past DH
// and past the columns; P decodes the codes with the page's scale
template <bool PAGED>
__device__ __forceinline__ void stage(const PrefillArgs& a, float* dst,
                                      int ld, int width, const int8_t* codes,
                                      const float* rows, const int* ids,
                                      const float* scl, int hk, int page0,
                                      int c0, int n, int d0) {
  const int nd4 = width / 4;
  for (int i = threadIdx.x; i < n * nd4; i += PREFILL_THREADS) {
    const int t = i / nd4, dd = 4 * (i - t * nd4);
    const int c = c0 + t, d = d0 + dd;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (d < a.DH) {
      if constexpr (PAGED)
        x = decode4(code4(a, codes, ids, hk, page0, c, d), a, scl[c / a.PS - page0]);
      else
        x = row4(a, rows, hk, c, d);
    }
    *reinterpret_cast<float4*>(dst + t * ld + dd) = x;
  }
}

// one token of 4 p.v chains: each product rounded, then added
__device__ __forceinline__ void pv_step(float4& acc, float x, float4 v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(x, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(x, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(x, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(x, v.w));
}

// A V piece's p.v and o fold over this rank's columns: a thread takes RB
// chains (rows hp, hp + HR / RB, ...) x 4 columns and runs KB pages of
// their p.v chains side by side, each in token order (probabilities read 4
// tokens at a time where aligned), then folds the KB pages into o in page
// order.  A piece holds nb whole pages of len tokens, or (nb = 1) a run of
// len tokens of one page: its p.v goes on from pva unless the run starts
// the page (first), and is left in pva unless it ends the page (last).
// SR: page k of the round is the walk's step step0 + k; the tile's rows
// start at r0, its KV head is hk and this rank's columns at d0.
template <int RB, int KB, bool SR>
__device__ __forceinline__ void pv_piece(const PrefillArgs& a, const Layout& L,
                                         const float* P, const float* vf,
                                         float* oc, float* pva,
                                         const float* al_all, int o0, int s0,
                                         int len, int nb, bool first, bool last,
                                         int step0, int r0, int hk, int d0) {
  const int HR = L.HR, nd4 = L.dsl / 4, HH = cdiv(HR, RB);
  const float4* V = reinterpret_cast<const float4*>(vf);
  const bool vec = (len | s0) % 4 == 0;
  for (int gi = threadIdx.x; gi < HH * nd4; gi += PREFILL_THREADS) {
    const int hp = gi % HH, dq = gi / HH;
    int hr[RB];  // the chains' rows (a row past HR repeats hp, unstored)
#pragma unroll
    for (int r = 0; r < RB; ++r) hr[r] = hp + r * HH < HR ? hp + r * HH : hp;
    for (int kb = 0; kb < nb; kb += KB) {
      float4 acc[RB][KB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int k = 0; k < KB; ++k) acc[r][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (!first) {
#pragma unroll
        for (int r = 0; r < RB; ++r)
          acc[r][0] = reinterpret_cast<const float4*>(pva + hr[r] * L.dsl)[dq];
      }
      if (vec) {
        for (int t = 0; t < len; t += 4) {
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (kb + k >= nb) continue;
            const int tk = (kb + k) * len + t;
            float x[RB][4];
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const float4 x4 = *reinterpret_cast<const float4*>(P + hr[r] * L.sst + s0 + tk);
              x[r][0] = x4.x; x[r][1] = x4.y; x[r][2] = x4.z; x[r][3] = x4.w;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 vv = V[(tk + u) * nd4 + dq];
#pragma unroll
              for (int r = 0; r < RB; ++r) pv_step(acc[r][k], x[r][u], vv);
            }
          }
        }
      } else {
        for (int t = 0; t < len; ++t) {
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (kb + k >= nb) continue;
            const int tk = (kb + k) * len + t;
            const float4 vv = V[tk * nd4 + dq];
#pragma unroll
            for (int r = 0; r < RB; ++r) pv_step(acc[r][k], P[hr[r] * L.sst + s0 + tk], vv);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r > 0 && hp + r * HH >= HR) continue;
        if (!last) {  // the page goes on in the next piece
          reinterpret_cast<float4*>(pva + hr[r] * L.dsl)[dq] = acc[r][0];
          continue;
        }
        float4* ov = reinterpret_cast<float4*>(oc + hr[r] * L.dsl) + dq;
        float4 o = *ov;
        unsigned flat = 0;  // SR: the flat index of the thread's first column
        if constexpr (SR) flat = sr_flat(a, r0, hk, hr[r], a.DH) + (unsigned)(d0 + 4 * dq);
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          if (kb + k >= nb) continue;
          const int pg = o0 + (s0 + (kb + k) * len) / a.PS;
          const float al = al_all[pg * HR + hr[r]];
          if constexpr (SR) {
            const unsigned st = (unsigned)(step0 + pg);
            o.x = quantize_sr(__fadd_rn(__fmul_rn(o.x, al), acc[r][k].x), a.qacc,
                              sr_bits(a.seed, st, flat));
            o.y = quantize_sr(__fadd_rn(__fmul_rn(o.y, al), acc[r][k].y), a.qacc,
                              sr_bits(a.seed, st, flat + 1u));
            o.z = quantize_sr(__fadd_rn(__fmul_rn(o.z, al), acc[r][k].z), a.qacc,
                              sr_bits(a.seed, st, flat + 2u));
            o.w = quantize_sr(__fadd_rn(__fmul_rn(o.w, al), acc[r][k].w), a.qacc,
                              sr_bits(a.seed, st, flat + 3u));
          } else {
            o.x = quantize_rne(__fadd_rn(__fmul_rn(o.x, al), acc[r][k].x), a.qacc);
            o.y = quantize_rne(__fadd_rn(__fmul_rn(o.y, al), acc[r][k].y), a.qacc);
            o.z = quantize_rne(__fadd_rn(__fmul_rn(o.z, al), acc[r][k].z), a.qacc);
            o.w = quantize_rne(__fadd_rn(__fmul_rn(o.w, al), acc[r][k].w), a.qacc);
          }
        }
        *ov = o;
      }
    }
  }
}

// The walk's geometry: the launch arguments, or (GEOM) P's device tensor
// (q_offset, q_len, kv_len, start_page), clamped to the slab and the page
// row by a one-thread kernel and copied on the launch's stream into
// constant memory just before the walk (a kernel and a device-to-constant
// copy, which a CUDA graph captures as nodes).  Both are constant-bank
// operands, so the GEOM walk fits the launch-argument walk's 128 registers
// (a copy of the geometry in registers, in shared memory, or each chain's
// last visible column in shared memory, spilled there).  The constant
// copy is one a module: P's GEOM launches on one stream are ordered, and
// none may run on another stream at the same time.
__constant__ int geom_c[4];  // q_off, live_rows, ncols, first_page
__device__ int geom_clamped[4];

__global__ void geom_clamp_kernel(const int* geom, int T, int row_cols) {
  geom_clamped[0] = geom[0];
  geom_clamped[1] = min(geom[1], T);
  geom_clamped[2] = min(geom[2], row_cols);
  geom_clamped[3] = max(geom[3], 0);
}

template <bool GEOM>
__device__ __forceinline__ int g_q_off(const PrefillArgs& a) {
  if constexpr (GEOM) return geom_c[0]; else return a.q_off;
}
template <bool GEOM>
__device__ __forceinline__ int g_live(const PrefillArgs& a) {
  if constexpr (GEOM) return geom_c[1]; else return a.live_rows;
}
template <bool GEOM>
__device__ __forceinline__ int g_ncols(const PrefillArgs& a) {
  if constexpr (GEOM) return geom_c[2]; else return a.ncols;
}
template <bool GEOM>
__device__ __forceinline__ int g_first(const PrefillArgs& a) {
  if constexpr (GEOM) return geom_c[3]; else return a.first_page;
}

template <bool GEOM>
__device__ __forceinline__ bool visible(const PrefillArgs& a, int row, int c) {
  return row < g_live<GEOM>(a) && a.col0 + c <= g_q_off<GEOM>(a) + row && c < g_ncols<GEOM>(a);
}

template <bool GEOM>
__device__ __forceinline__ void score_piece(const PrefillArgs& a,
                                            const Layout& L, const float* qs,
                                            const float* kf, float* sc,
                                            int r0, int c0, int n, int s0) {
  const int HR = L.HR, HH = cdiv(HR, 2), ntq = cdiv(n, 4), q4 = L.qst / 4;
  const float4* Q = reinterpret_cast<const float4*>(qs);
  const float4* K = reinterpret_cast<const float4*>(kf);
  for (int gi = threadIdx.x; gi < HH * ntq; gi += PREFILL_THREADS) {
    const int hp = gi % HH, tq = gi / HH;
    const int qa = hp * q4, qb = (hp + HH < HR ? hp + HH : hp) * q4;
    int kr[4];  // float4 offsets of the chains' K rows
#pragma unroll
    for (int j = 0; j < 4; ++j) kr[j] = min(4 * tq + j, n - 1) * q4;
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[0][j] = acc[1][j] = 0.0f;
#pragma unroll 2
    for (int d4 = 0; d4 < L.dp / 4; ++d4) {
      const float4 x0 = Q[qa + d4], x1 = Q[qb + d4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kk = K[kr[j] + d4];
        acc[0][j] = __fadd_rn(acc[0][j], __fmul_rn(x0.x, kk.x));
        acc[0][j] = __fadd_rn(acc[0][j], __fmul_rn(x0.y, kk.y));
        acc[0][j] = __fadd_rn(acc[0][j], __fmul_rn(x0.z, kk.z));
        acc[0][j] = __fadd_rn(acc[0][j], __fmul_rn(x0.w, kk.w));
        acc[1][j] = __fadd_rn(acc[1][j], __fmul_rn(x1.x, kk.x));
        acc[1][j] = __fadd_rn(acc[1][j], __fmul_rn(x1.y, kk.y));
        acc[1][j] = __fadd_rn(acc[1][j], __fmul_rn(x1.z, kk.z));
        acc[1][j] = __fadd_rn(acc[1][j], __fmul_rn(x1.w, kk.w));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hr = i ? hp + HH : hp;
      if (hr >= HR) continue;
      const int row = r0 + hr / a.G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * tq + j;
        if (t < n)
          sc[hr * L.sst + s0 + t] =
              visible<GEOM>(a, row, c0 + t) ? __fmul_rn(acc[i][j], a.scale) : REPRO_NEG;
      }
    }
  }
}

template <bool PAGED, bool SR, bool GEOM>
__global__ void __launch_bounds__(PREFILL_THREADS, 2)
    attn_prefill_kernel(const __grid_constant__ PrefillArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const Layout L(a.G, a.BR, a.PS, a.DH, CL, a.R);
  const int HR = L.HR, G = a.G, DH = a.DH, PS = a.PS, dsl = L.dsl;
  float* qs = smem + L.qs;
  float* kf = smem + L.kf;
  float* sc = smem + L.sc;          // [hr][tt] scores, then probabilities
  float* pb = smem + L.pb;          // another rank's probabilities
  float* vf = smem + L.vf;          // [t][dd] a V piece of this rank's columns
  float* pva = smem + L.pva;        // [hr][dd] p.v of a page longer than a piece
  float* oc = smem + L.oc;          // [hr][dd] o carries of this rank's columns
  float* cpub = smem + L.cpub;      // [j][hr] ceil maxima, read by the cluster
  float* lpub = smem + L.lpub;      // [j][hr] l sums, read by the cluster
  float* cm_all = smem + L.cm_all;  // [k][hr] the round's maxima, then m_k
  float* al_all = smem + L.al_all;  // [k][hr] alpha_k
  float* ls_all = smem + L.ls_all;  // [k][hr] l sums
  float* ml = smem + L.ml;          // m carries [HR], then l carries [HR]
  int* ids = reinterpret_cast<int*>(smem + L.ids);  // the round's page ids
  float* ksc = smem + L.ksc;
  float* vsc = smem + L.vsc;

  // tiles of the last rows first: in a one-shot prompt they walk the most
  const int tile = blockIdx.x / CL, n_rt = cdiv(a.T, a.BR);
  const int hk = tile % a.KV, r0 = (n_rt - 1 - tile / a.KV) * a.BR;
  const int d0 = rank * dsl;
  const bool carry_in = a.co != nullptr;

  // q rows, 4 floats a load
  for (int i = tid; i < HR * L.dp / 4; i += PREFILL_THREADS) {
    const int hr = i / (L.dp / 4), d = 4 * (i - hr * (L.dp / 4)), row = r0 + hr / G;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (row < a.T) {
      const float* src = a.q + ((long long)row * a.H + hk * G + hr % G) * DH + d;
      if (a.vec) {
        const float4 w = *reinterpret_cast<const float4*>(src);
        x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (d + u < DH) x[u] = src[u];
      }
    }
    *reinterpret_cast<float4*>(qs + hr * L.qst + d) = make_float4(x[0], x[1], x[2], x[3]);
  }
  for (int hr = tid; hr < HR; hr += PREFILL_THREADS) {
    const int row = r0 + hr / G;
    const long long at = (long long)row * a.H + hk * G + hr % G;
    const bool live = carry_in && row < a.T;
    ml[hr] = live ? a.cm[at] : REPRO_NEG;
    ml[HR + hr] = live ? a.cl[at] : 0.0f;
  }
  for (int i = tid; i < HR * dsl; i += PREFILL_THREADS) {
    const int hr = i / dsl, d = d0 + i - hr * dsl, row = r0 + hr / G;
    oc[i] = carry_in && row < a.T && d < DH
        ? a.co[((long long)row * a.H + hk * G + hr % G) * DH + d] : 0.0f;
  }

  // the pages the tile attends: from first_page, up to the last live row's
  // causal reach and the last column (later pages are carry no-ops); GEOM:
  // from the device geometry, which is data, so one launch shape serves
  // every slab
  const int last_row = min(r0 + a.BR, g_live<GEOM>(a)) - 1;
  const int reach = g_q_off<GEOM>(a) + last_row - a.col0;
  const int n_causal = last_row >= r0 && reach >= 0 ? reach / PS + 1 : 0;
  const int p_end = min(cdiv(g_ncols<GEOM>(a), PS), n_causal);
  const int cap = CL * a.R, pl = L.pl;

  for (int base = g_first<GEOM>(a); base < p_end; base += cap) {
    const int npr = min(cap, p_end - base);  // the round's pages
    const int step0 = a.col0 / PS + base;    // SR: the round's first KV block
    const int per = cdiv(npr, CL);
    const int my0 = min(rank * per, npr), mine = min(my0 + per, npr) - my0;
    if constexpr (PAGED) {
      for (int k = tid; k < npr; k += PREFILL_THREADS) {
        const int pid = a.page_row[base + k];
        ids[k] = pid;
        ksc[k] = exp2_int(a.kse[pid]);
        vsc[k] = exp2_int(a.vse[pid]);
      }
    }
    __syncthreads();

    // A: the scores of this rank's pages, a piece at a time
    const int c_own = (base + my0) * PS, n_own = mine * PS;
    for (int s0 = 0; s0 < n_own; s0 += pl) {
      const int n = min(pl, n_own - s0);
      stage<PAGED>(a, kf, L.qst, L.dp, a.kp, a.k, ids, ksc, hk, base, c_own + s0, n, 0);
      __syncthreads();
      score_piece<GEOM>(a, L, qs, kf, sc, r0, c_own + s0, n, s0);
      __syncthreads();
    }
    for (int i = tid; i < mine * HR; i += PREFILL_THREADS) {
      const int j = i / HR, hr = i - j * HR;
      const float* s = sc + hr * L.sst + j * PS;
      float mx = REPRO_NEG;
      for (int t = 0; t < PS; ++t) mx = fmaxf(mx, s[t]);
      cpub[i] = ceilf(mx);
    }
    cluster.sync();  // every rank's maxima are published

    // the running max and rescales of every page of the round, in order
    for (int i = tid; i < npr * HR; i += PREFILL_THREADS) {
      const int k = i / HR, owner = k / per;
      cm_all[i] = *cluster.map_shared_rank(cpub + i - owner * per * HR, owner);
    }
    __syncthreads();
    for (int hr = tid; hr < HR; hr += PREFILL_THREADS) {
      float m = ml[hr];
      for (int k = 0; k < npr; ++k) {  // al_all holds m before page k
        const float mn = fmaxf(m, cm_all[k * HR + hr]);
        al_all[k * HR + hr] = m;
        cm_all[k * HR + hr] = mn;
        m = mn;
      }
      ml[hr] = m;
    }
    __syncthreads();
    for (int i = tid; i < npr * HR; i += PREFILL_THREADS)
      al_all[i] = exp2f(al_all[i] - cm_all[i]);
    __syncthreads();

    // B1: this rank's probabilities and l sums, in token order
    for (int i = tid; i < HR * n_own; i += PREFILL_THREADS) {
      const int hr = i / n_own, tt = i - hr * n_own;
      float* s = sc + hr * L.sst + tt;
      *s = visible<GEOM>(a, r0 + hr / G, c_own + tt)
               ? exp2f(*s - cm_all[(my0 + tt / PS) * HR + hr]) : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < mine * HR; i += PREFILL_THREADS) {
      const int j = i / HR, hr = i - j * HR;
      const float* s = sc + hr * L.sst + j * PS;
      float acc = 0.0f;
      for (int t = 0; t < PS; ++t) acc = __fadd_rn(acc, s[t]);
      lpub[i] = acc;
    }
    cluster.sync();  // every rank's probabilities and l sums are published

    for (int i = tid; i < npr * HR; i += PREFILL_THREADS) {
      const int k = i / HR, owner = k / per;
      ls_all[i] = *cluster.map_shared_rank(lpub + i - owner * per * HR, owner);
    }
    __syncthreads();
    // the l fold on the last threads, which take the fewest p.v outputs
    for (int hr = PREFILL_THREADS - 1 - tid; hr < HR; hr += PREFILL_THREADS) {
      float l = ml[HR + hr];
      const unsigned flat = SR ? sr_flat(a, r0, hk, hr, 1) : 0u;
      for (int k = 0; k < npr; ++k) {
        const float v = __fadd_rn(__fmul_rn(l, al_all[k * HR + hr]), ls_all[k * HR + hr]);
        if constexpr (SR)
          l = quantize_sr(v, a.qacc, sr_bits(a.seed ^ PREFILL_L_SALT, (unsigned)(step0 + k), flat));
        else
          l = quantize_rne(v, a.qacc);
      }
      ml[HR + hr] = l;
    }

    // B2: p.v of this rank's columns over every page of the round, in page
    // order (rank by rank), and the o fold at each page end (pv_piece).  A V
    // piece holds nb whole pages or, for pages longer than a K piece, a run
    // of one page
    for (int owner = 0; owner < CL; ++owner) {
      const int o0 = min(owner * per, npr), on = min(o0 + per, npr) - o0;
      if (on == 0) break;
      const float* P = sc;
      if (owner != rank) {
        __syncthreads();  // the last rank's probabilities are read
        const float4* src = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(sc, owner));
        float4* dst = reinterpret_cast<float4*>(pb);
        for (int i = tid; i < HR * L.sst / 4; i += PREFILL_THREADS) dst[i] = src[i];
        P = pb;
      }
      const int c_on = (base + o0) * PS, n_on = on * PS;
      for (int s0 = 0; s0 < n_on;) {
        const bool whole = PS <= PREFILL_PIECE;
        const int n = whole ? min(L.plv, n_on - s0) : min(L.plv, PS - s0 % PS);
        const int nb = whole ? n / PS : 1, len = whole ? PS : n;
        const bool first = s0 % PS == 0, last = (s0 + n) % PS == 0;
        __syncthreads();  // the last piece is read (and pb is copied)
        stage<PAGED>(a, vf, dsl, dsl, a.vp, a.v, ids, vsc, hk, base, c_on + s0, n, d0);
        __syncthreads();
        if (HR * (dsl / 4) >= PREFILL_PV_TWO_ROWS)
          pv_piece<2, PREFILL_PV_PAGES / 2, SR>(a, L, P, vf, oc, pva, al_all, o0, s0, len, nb,
                                                first, last, step0, r0, hk, d0);
        else
          pv_piece<1, PREFILL_PV_PAGES, SR>(a, L, P, vf, oc, pva, al_all, o0, s0, len, nb, first,
                                            last, step0, r0, hk, d0);
        s0 += n;
      }
    }
    cluster.sync();  // no rank reads this round's scores, maxima or sums
  }
  __syncthreads();

  // this rank's columns: o / l (0 where nothing was attended), or the raw
  // carry; rank 0 writes m and l
  const bool emit_carry = a.om != nullptr;
  for (int i = tid; i < HR * dsl; i += PREFILL_THREADS) {
    const int hr = i / dsl, d = d0 + i - hr * dsl, row = r0 + hr / G;
    if (row >= a.T || d >= DH) continue;
    const float l = ml[HR + hr];
    a.out[((long long)row * a.H + hk * G + hr % G) * DH + d] =
        emit_carry ? oc[i] : (l > 0.0f ? __fdiv_rn(oc[i], l) : 0.0f);
  }
  if (emit_carry && rank == 0) {
    for (int hr = tid; hr < HR; hr += PREFILL_THREADS) {
      const int row = r0 + hr / G;
      if (row >= a.T) continue;
      const long long at = (long long)row * a.H + hk * G + hr % G;
      a.om[at] = ml[hr];
      a.ol[at] = ml[HR + hr];
    }
  }
}

// the dynamic shared memory a launch may take, raised once per size
template <bool PAGED, bool SR, bool GEOM>
int allow_smem(int bytes) {
  static int allowed = 48 * 1024;
  if (bytes <= allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      attn_prefill_kernel<PAGED, SR, GEOM>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  allowed = bytes;
  return 0;
}

inline cudaLaunchConfig_t launch_config(int blocks, int smem, cudaStream_t s,
                                        cudaLaunchAttribute* attr, int CL) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(PREFILL_THREADS);
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

// one launch over every (KV head, row tile), CL blocks a tile
template <bool PAGED, bool SR = false, bool GEOM = false>
int launch(PrefillArgs a, int CL, cudaStream_t s) {
  if (a.T <= 0) return 0;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) & 15 | (PAGED
      ? (reinterpret_cast<uintptr_t>(a.kp) | reinterpret_cast<uintptr_t>(a.vp)) & 3
      : (reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v)) & 15);
  a.vec = a.DH % 4 == 0 && ptrs == 0;
  const int smem = Layout(a.G, a.BR, a.PS, a.DH, CL, a.R).bytes();
  if (const int rc = allow_smem<PAGED, SR, GEOM>(smem)) return rc;
  if constexpr (GEOM) {
    geom_clamp_kernel<<<1, 1, 0, s>>>(a.geom, a.T, a.row_pages * a.PS);
    void* clamped = nullptr;
    cudaError_t c = cudaGetLastError();
    if (c == cudaSuccess) c = cudaGetSymbolAddress(&clamped, geom_clamped);
    if (c == cudaSuccess)
      c = cudaMemcpyToSymbolAsync(geom_c, clamped, sizeof(geom_c), 0,
                                  cudaMemcpyDeviceToDevice, s);
    if (c != cudaSuccess) return static_cast<int>(c);
  }
  cudaLaunchAttribute attr;
  const int blocks = a.KV * cdiv(a.T, a.BR) * CL;
  const cudaLaunchConfig_t cfg = launch_config(blocks, smem, s, &attr, CL);
  cudaError_t e = cudaLaunchKernelEx(&cfg, attn_prefill_kernel<PAGED, SR, GEOM>, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

// resident blocks an SM, or minus the CUDA error
template <bool PAGED, bool SR = false, bool GEOM = false>
int occupancy(int G, int BR, int PS, int DH, int CL, int R) {
  const int smem = Layout(G, BR, PS, DH, CL, R).bytes();
  if (const int rc = allow_smem<PAGED, SR, GEOM>(smem)) return -rc;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, attn_prefill_kernel<PAGED, SR, GEOM>, PREFILL_THREADS, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// clusters that fit the card at once, or minus the CUDA error
template <bool PAGED, bool SR = false, bool GEOM = false>
int clusters(int G, int BR, int PS, int DH, int CL, int R) {
  const int smem = Layout(G, BR, PS, DH, CL, R).bytes();
  if (const int rc = allow_smem<PAGED, SR, GEOM>(smem)) return -rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(CL * 1024, smem, nullptr, &attr, CL);
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, attn_prefill_kernel<PAGED, SR, GEOM>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace
}  // namespace prefill
