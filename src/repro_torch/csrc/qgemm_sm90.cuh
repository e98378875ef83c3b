// The Hopper tile of the GEMMs: E (qgemm_emitq.cu), K8 (qgemm_stats.cu),
// the backward pair B and its stats variant K9 (bwd_pair.cu; B's dx
// carry-in entry is K7), and G above decode (qgemm.cu).  One thread block
// computes one 64 x 64 tile of C = Q(A) . Q(B) with a chunked (1, e_acc,
// m_acc) carry, bitwise the plain versions (kernels/fused.py
// chunked_gemm_reference) and the oracle's independent K3 (qmatmul.cu).
//
// The contract per output: within a chunk (length `chunk` from k = 0; a
// ragged last chunk folds what it has) part = fma(a_k, b_k, part) in
// increasing k from 0, f32 round to nearest; once a chunk
// carry = q_acc(carry + part).  Tensor cores cannot form that partial: an
// MMA with f32 accumulation aligns the products of a k-group and truncates,
// so its partial differs from the FMA chain wherever the chain rounds (a
// chunk's products span up to 20 binades on training operands).  The
// partials therefore run on the CUDA cores and the tile is bounded by the
// f32 FMA rate (67 TFLOP/s on the H100), in practice by the instructions
// it issues.  What the design does about it:
//
// * Chunk groups.  The block's 64 G threads (G = 1, 2 or 4, blockDim / 64,
//   chosen by the caller from the number of chunks) form G groups; group g
//   forms the partials of chunks g, g + G, g + 2G, ... of the block's one
//   output tile.  Partials of different chunks are independent; only the
//   fold is sequential, and it runs in chunk order: the group folding chunk
//   c waits on a named barrier for the fold of chunk c - 1 (the group
//   before it) and then signals the next group.  A tile's long sum thus
//   runs on G x 64 threads, so few output tiles (the dx of T = 512 tokens,
//   192 tiles) still fill the card.
// * Registers hold only the partial: each thread an 8 x 8 patch (rows
//   ty*4 + i and 32 + ty*4 + i, columns alike), fed by float4 fragments
//   from the group's f32 step buffers (4 shared loads a 64 FMAs).  The
//   carry and K8's f32 shadow carry live in shared memory and are touched
//   once a chunk, so two 256-thread blocks fit an SM.  The FMA loop and
//   the fold stay rolled (small code), and the fold and decode use
//   branch-free forms of common.cuh's quantize_rne and unpack_code.
// * Operands land in their stored type (int8 codes, bf16 or f32) in a ring
//   of ring_stages() steps per group, by 16-byte cp.async copies that
//   zero-fill past the ragged edges and past the chunk's end, and each
//   landed element is decoded once (unpacked, bf16 widened, then quantized
//   where asked) into the group's f32 step buffers.  cp.async
//   rather than TMA: the operands of one call are transposed views, slices
//   and ragged tiles whose strides and alignment vary per operand, which
//   cp.async takes per 16-byte piece with no tensor map to encode per call
//   (and no -lcuda).  An operand whose layout allows no 16-byte pieces
//   (a base or row pitch off 16 bytes, a chunk that cuts a piece, neither
//   stride 1) is staged element by element instead, into the same layout.
//
// Stochastic rounding (the SR template flag of block_tile; E, K8, B, K9 and
// G's tile route instantiate both): the fold rounds carry + partial with
// quant_sr and the dither sr_bits(seed, chunk0 + c, (row0 + m0 + r) * ldf +
// col0 + n0 + col) of common.cuh, c the chunk's index in this call's K walk
// (the global one: under chunk groups, group g folds chunks g, g + G, ...),
// every product mod 2^32 as the JAX package's uint32 arithmetic.  chunk0,
// row0, col0 and ldf place a block of a longer GEMM (K7's dx carry entry:
// its N segment's first chunk, and the dw segment's first column of ldf;
// under a mesh, a rank's rows and columns of the whole output, and a
// K-slice's dx columns and dw rows); by default they are 0, 0, 0 and N,
// the whole output.  The dither depends on
// the output element and the chunk only, so every tile, group count and
// kernel variant of one GEMM draws the same bits.  The Threefry rounds run
// in the fold, once a chunk an output, outside the FMA loop; the RNE
// instantiations are the same code as without the flag.
//
// The output epilogue (the OUT template flag of block_tile; the variant
// kernels of G, E and K8 instantiate it): the finished carry is rounded to
// nearest even into a consumer's format and, with pack, stored as its int8
// code, as repro/kernels/fused.py::_emit_output does, in the store loop
// after the walk.  The format is a runtime Quant whose identity stores the
// carry as it is; the instantiations without the flag are the same code
// as before it.
//
// Transposed views (w^T in dx, x^T in dw, the tied lm_head's embed.T) are
// read through their strides: the ring keeps each operand along whichever
// of its axes is contiguous in memory, and the decode transposes.  The
// schedule (G, the ring's depth) changes no output bit: every output's sum
// runs in the same order for any of them.
#pragma once

#include <cuda_bf16.h>

#include <cstring>

#include "common.cuh"

namespace sm90 {

constexpr int TILE = 64;  // output rows and columns of a block
constexpr int KT = 16;    // K values a pipeline step stages
constexpr int GT = 64;    // threads of a chunk group (8 x 8 outputs each)

// A (1, e, m) format as the tile uses it, from QFmt on the host (quant_of):
// quant() below is common.cuh's quantize_rne, bit for bit, without its
// branches and with its constants precomputed.
struct Quant {
  int identity, shift;
  unsigned half, lsb, mask;  // RNE: (x + half + (lsb & x >> shift)) & mask
  float maxv, minn;
};

// The format of int8 operand codes, from (e, m) on the host (dec_of):
// unpack() below is common.cuh's unpack_code, bit for bit.
struct Dec {
  unsigned magmask;  // the code's exponent and mantissa bits
  unsigned minmag;   // the smallest non-zero exponent field, in place
  int sh;            // 23 - m: the magnitude bits into an f32's place
  int sbit;          // e + m: the sign bit
  float scale;       // 2^(126 - bias): f32 exponent bias to the format's
};

// One operand seen as a (TILE-wide mn) x (K) matrix: A[m, k] (mn = m) or
// B[k, n] (mn = n); element (mn, k) at p[mn * s_mn + k * s_k].
struct Opnd {
  const void* p;
  long long s_mn, s_k;
  int ext;    // extent along mn (M or N)
  int kfast;  // ring layout along k (contiguous in k), else along mn
  int vec;    // 16-byte cp.async pieces, else element loads
  int quant;  // quantize the loaded value to qr
};

struct Gemm {
  Opnd a, b;
  float* C;  // C[m, n] = C[m * ldc + n]
  long long ldc;
  const float* Cin;  // carry in, laid out as C, or nullptr (carry starts at 0)
  int M, N, K, chunk;
  Quant qr, qacc;
  Dec dec;
  // SR instantiations only: the dither's seed, the K-walk index of this
  // call's first chunk, the logical column of output column 0, the
  // logical output's column count (0: N) and the logical row of output
  // row 0
  unsigned seed = 0;
  int chunk0 = 0, col0 = 0, ldf = 0, row0 = 0;
  // OUT instantiations only (block_tile's output epilogue): the output's
  // format (the identity: C as the carry) and, with pack, C as int8 codes
  // of (1, e_o, m_o) instead of floats
  Quant qout{1, 0, 0u, 0u, ~0u, 0.0f, 0.0f};
  int pack = 0, e_o = 5, m_o = 2;
};

// Bytes of one ring step (A's and B's raw tiles), the ring's depth, and the
// block's dynamic shared memory: the carry (and shadow) tiles, then each
// group's f32 step buffers and ring.  kernels/sm90.py mirrors these.
template <typename TA, typename TB>
__host__ __device__ constexpr int stage_bytes() {
  return TILE * KT * (int)(sizeof(TA) + sizeof(TB));
}
__host__ __device__ constexpr int ring_stages(int stage) {
  return stage * 4 <= 16384 ? 4 : (stage * 3 <= 16384 ? 3 : 2);
}
__host__ __device__ constexpr int group_bytes(int stage) {
  return 2 * KT * TILE * 4 + ring_stages(stage) * stage;
}
__host__ __device__ constexpr int smem_bytes(int stage, int groups, bool stats) {
  return (stats ? 2 : 1) * TILE * TILE * 4 + groups * group_bytes(stage);
}

// The operand descriptor for elements of `esize` bytes.  The ring runs along
// k when k is the contiguous axis; 16-byte pieces need a 16-byte aligned
// base and row pitch and, along k, chunks that start on a piece.
inline Opnd operand(const void* p, int esize, long long s_mn, long long s_k,
                    int ext, int chunk, int quant) {
  Opnd o{p, s_mn, s_k, ext, 0, 0, quant};
  o.kfast = (s_k == 1 && s_mn != 1);
  const long long fast = o.kfast ? s_k : s_mn;
  const long long pitch = o.kfast ? s_mn : s_k;
  o.vec = fast == 1 && reinterpret_cast<unsigned long long>(p) % 16 == 0 &&
          (pitch * esize) % 16 == 0 &&
          (!o.kfast || ((long long)chunk * esize) % 16 == 0);
  return o;
}

inline Quant quant_of(const QFmt q) {
  Quant r{q.identity, q.shift, 0u, 0u, ~0u, q.maxv, q.minn};
  if (q.shift > 0) {
    r.half = (1u << (q.shift - 1)) - 1u;
    r.lsb = 1u;
    r.mask = ~((1u << q.shift) - 1u);
  }
  return r;
}

inline Dec dec_of(int e, int m) {
  Dec d{(1u << (e + m)) - 1u, 1u << m, 23 - m, e + m, 1.0f};
  const int bias = (1 << (e - 1)) - 1;
  unsigned bits = (unsigned)(126 - bias + 127) << 23;
  memcpy(&d.scale, &bits, sizeof bits);
  return d;
}

// f(TA, TB) over two operands' kinds (0 f32, 1 bf16, 2 int8 codes):
// G's variants and K8 dispatch their instantiations through it
template <typename F>
int by_kinds(int a_kind, int b_kind, F f) {
  auto b_of = [&](auto ta) -> int {
    using TA = decltype(ta);
    if (b_kind == 0) return f(TA{}, float{});
    if (b_kind == 1) return f(TA{}, __nv_bfloat16{});
    if (b_kind == 2) return f(TA{}, int8_t{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (a_kind == 0) return b_of(float{});
  if (a_kind == 1) return b_of(__nv_bfloat16{});
  if (a_kind == 2) return b_of(int8_t{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// quantize_rne (common.cuh), branch-free: a rounded-up infinity stays
// infinite and fminf saturates it as quantize_rne's isinf case does; the
// sign goes back on as a bit (the magnitude is never NaN there).
__device__ __forceinline__ float quant(float x, const Quant& q) {
  const unsigned xb = __float_as_uint(x), xi = xb & 0x7fffffffu;
  const unsigned r = (xi + q.half + ((xi >> q.shift) & q.lsb)) & q.mask;
  float y = fminf(__uint_as_float(r), q.maxv);
  y = y < q.minn ? 0.0f : y;
  y = __uint_as_float(__float_as_uint(y) | (xb & 0x80000000u));
  y = isnan(x) ? x : y;
  return q.identity ? x : y;
}

// quantize_sr (common.cuh), branch-free as quant: the dither's bits below
// the kept mantissa (~mask; none for an exact mantissa) are added to the
// magnitude, then dropped.
__device__ __forceinline__ float quant_sr(float x, const Quant& q, unsigned bits) {
  const unsigned sign = __float_as_uint(x) & 0x80000000u;
  const unsigned mag = __float_as_uint(x) & 0x7fffffffu;
  const unsigned r = (mag + (bits & ~q.mask)) & q.mask;
  float y = fminf(__uint_as_float(r), q.maxv);
  y = y < q.minn ? 0.0f : y;
  y = __uint_as_float(__float_as_uint(y) | sign);
  y = isnan(x) ? x : y;
  return q.identity ? x : y;
}

// v, a value of a format with at most 7 mantissa and 8 exponent bits, as
// the bf16 of the same value (exact: such values are a subset of bf16's);
// NaN as the canonical 0x7fc0.  The operand scratches of E and B/K9.
__device__ __forceinline__ __nv_bfloat16 bf16_exact(float v) {
  return __ushort_as_bfloat16(
      isnan(v) ? (unsigned short)0x7fc0u : (unsigned short)(__float_as_uint(v) >> 16));
}

// unpack_code (common.cuh) of the code in the low byte of b: a non-zero
// exponent field makes the magnitude bits a normal f32 that a power of two
// scales exactly to the format's value; a zero one is +-0.
__device__ __forceinline__ float unpack(unsigned b, const Dec& d) {
  const unsigned mag = b & d.magmask;
  const float f = mag >= d.minmag ? __fmul_rn(__uint_as_float(mag << d.sh), d.scale) : 0.0f;
  return __uint_as_float(__float_as_uint(f) | (((b >> d.sbit) & 1u) << 31));
}

// The output epilogue of repro/kernels/fused.py::_emit_output on one
// finished carry v: rounded to nearest even into the output format q (the
// identity leaves v, NaN included), then, with pack, stored as its int8
// code (pack_code: NaN and Inf become signed zero, as pack_block), else as
// the float.  Whatever the carry's rounding, the epilogue is RNE.
__device__ __forceinline__ void emit_out(float* C, long long i, float v, const Quant& q,
                                         int pack, int e, int m) {
  const float y = quant(v, q);
  if (pack)
    reinterpret_cast<int8_t*>(C)[i] = pack_code(y, e, m);
  else
    C[i] = y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes to shared memory, the first `bytes` of them from src, the rest 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// named barriers: a group's own (64 threads), the fold hand-off (128)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// Element e of landed little-endian words as f32: f32 as is, bf16 widened
// (its bits above 16 zeros, as __bfloat162float), int8 codes unpacked.
__device__ __forceinline__ float elem(const unsigned* w, int e, const float*, const Dec&) {
  return __uint_as_float(w[e]);
}
__device__ __forceinline__ float elem(const unsigned* w, int e, const __nv_bfloat16*,
                                      const Dec&) {
  return __uint_as_float(((w[e >> 1] >> ((e & 1) * 16)) & 0xffffu) << 16);
}
__device__ __forceinline__ float elem(const unsigned* w, int e, const int8_t*, const Dec& d) {
  return unpack(w[e >> 2] >> ((e & 3) * 8), d);
}

// The element-by-element staging of one 16-byte piece whose first element
// is (mn, k): nv elements along the ring's axis, zeros after them.  A
// rolled loop: it is the slow path of odd layouts, kept small in the hot
// loop's code.
template <typename T>
__device__ __forceinline__ void stage_elems(const Opnd& o, int mn, int k, int nv, T* dd) {
  const T* base = static_cast<const T*>(o.p);
#pragma unroll 1
  for (int e = 0; e < 16 / (int)sizeof(T); ++e) {
    const long long off = o.kfast ? (long long)mn * o.s_mn + (long long)(k + e) * o.s_k
                                  : (long long)(mn + e) * o.s_mn + (long long)k * o.s_k;
    dd[e] = e < nv ? base[off] : zero<T>();
  }
}

// Issue the copies of one operand's raw tile for k in [k0, k0 + KT), valid
// below kmax (the chunk's end or K) and mn below ext.  Ring layout, in
// 16-byte pieces: along k, piece (kq, mn) at kq * TILE + mn (PER values of
// k each); along mn, row k of TILE values.
template <typename T>
__device__ __forceinline__ void stage(const Opnd& o, int mn0, int k0, int kmax,
                                      unsigned char* dst, int gt) {
  constexpr int E = sizeof(T), PER = 16 / E, PIECES = TILE * KT * E / 16;
  const T* base = static_cast<const T*>(o.p);
#pragma unroll
  for (int r = 0; r < PIECES / GT; ++r) {
    const int u = gt + r * GT;
    int mn, k, nv;  // first element of the piece, and how many are valid
    if (o.kfast) {
      mn = u % TILE;
      k = (u / TILE) * PER;
      nv = mn0 + mn < o.ext ? min(max(kmax - (k0 + k), 0), PER) : 0;
    } else {
      mn = (u % (TILE / PER)) * PER;
      k = u / (TILE / PER);
      nv = k0 + k < kmax ? min(max(o.ext - (mn0 + mn), 0), PER) : 0;
    }
    unsigned char* d = dst + u * 16;
    if (o.vec) {
      const T* src = nv > 0 ? base + (long long)(mn0 + mn) * o.s_mn + (long long)(k0 + k) * o.s_k
                            : base;
      cp_async16(d, src, nv * E);
    } else {
      stage_elems<T>(o, mn0 + mn, k0 + k, nv, reinterpret_cast<T*>(d));
    }
  }
}

// Decode one landed raw tile into the f32 step buffer X[k][mn] (KT x TILE).
template <typename T>
__device__ __forceinline__ void decode(const Opnd& o, const unsigned char* src, float* X,
                                       int gt, const Quant& qr, const Dec& dec) {
  constexpr int E = sizeof(T), PER = 16 / E;
  const T* tag = nullptr;
  if (o.kfast) {  // a 16-byte piece is PER values of k at one mn
#pragma unroll
    for (int r = 0; r < TILE * KT * E / 16 / GT; ++r) {
      const int u = gt + r * GT, mn = u % TILE, k = (u / TILE) * PER;
      const uint4 q = *reinterpret_cast<const uint4*>(src + u * 16);
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const float v = elem(w, e, tag, dec);
        X[(k + e) * TILE + mn] = o.quant ? quant(v, qr) : v;
      }
    }
  } else {  // 4 values of mn at one k: one float4 of X
#pragma unroll
    for (int r = 0; r < TILE * KT / 4 / GT; ++r) {
      const int u = gt + r * GT, k = u / (TILE / 4), mn = (u % (TILE / 4)) * 4;
      const unsigned char* s = src + (k * TILE + mn) * E;
      unsigned w[4] = {0u, 0u, 0u, 0u};
      if constexpr (E == 4) {
        const uint4 q = *reinterpret_cast<const uint4*>(s);
        w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
      } else if constexpr (E == 2) {
        const uint2 q = *reinterpret_cast<const uint2*>(s);
        w[0] = q.x; w[1] = q.y;
      } else {
        w[0] = *reinterpret_cast<const unsigned*>(s);
      }
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = elem(w, e, tag, dec);
        if (o.quant) v[e] = quant(v[e], qr);
      }
      *reinterpret_cast<float4*>(X + k * TILE + mn) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// KT rank-1 updates of the thread's 8 x 8 partial, k increasing.  The k
// loop stays rolled, as the fold's: the hot loop's code stays small (on
// the H100 the tile ran up to 1.15x slower with it unrolled 16-fold;
// tools/sm90/ablate.py).
__device__ __forceinline__ void fma_step(const float* As, const float* Bs, float (&acc)[8][8],
                                         int tx, int ty) {
  const float4* A4 = reinterpret_cast<const float4*>(As);
  const float4* B4 = reinterpret_cast<const float4*>(Bs);
#pragma unroll 1
  for (int k = 0; k < KT; ++k) {
    const float4 a0 = A4[k * (TILE / 4) + ty], a1 = A4[k * (TILE / 4) + 8 + ty];
    const float4 b0 = B4[k * (TILE / 4) + tx], b1 = B4[k * (TILE / 4) + 8 + tx];
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
  }
}

// STATS: chunk updates over the valid outputs (partial non-zero: adds;
// carry unchanged by it: swamped) and the max |carry| over them.
struct Counts {
  int adds = 0, swamped = 0;
  float max_abs = 0.0f;
};

// A chunk ends: carry = q(carry + partial) (and ideal += partial) for the
// thread's 64 outputs, and the partial restarts at 0.  The partials pass
// through P, the group's f32 step buffers (free between steps), 32 a
// thread at a time, so that the fold is a rolled loop (small code, as the
// FMA loop).  rows / cols: bit i of rows (bit h * 4 + j of cols) is set
// where the thread's output row i (column h * 32 + tx * 4 + j) lies inside
// the output.  SR: q is quant_sr with the dither of chunk p.chunk0 + chunk
// at the output's logical flat index in the tile at (m0, n0) of p.
template <bool STATS, bool SR>
__device__ __forceinline__ void fold(float (&acc)[8][8], float4* P, float* Cs, float* Is,
                                     int gt, int tx, int ty, unsigned rows, unsigned cols,
                                     const Quant& qacc, Counts& n, const Gemm& p, int m0,
                                     int n0, int chunk) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {  // rows half * 4 + q / 2, column half q % 2
      const float* a = acc[half * 4 + (q >> 1)] + (q & 1) * 4;
      P[q * GT + gt] = make_float4(a[0], a[1], a[2], a[3]);
    }
#pragma unroll 1
    for (int q = 0; q < 8; ++q) {
      const int i = half * 4 + (q >> 1), h = q & 1;
      const int r = half * 32 + ty * 4 + (q >> 1), c = h * 32 + tx * 4;
      const float4 p4 = P[q * GT + gt];
      const float part[4] = {p4.x, p4.y, p4.z, p4.w};
      float4* cp = reinterpret_cast<float4*>(Cs + r * TILE + c);
      const float4 c4 = *cp;
      float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      float iv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if constexpr (STATS) {
        const float4 i4 = *reinterpret_cast<const float4*>(Is + r * TILE + c);
        iv[0] = i4.x; iv[1] = i4.y; iv[2] = i4.z; iv[3] = i4.w;
      }
      // the logical flat index of the row's first output here (SR)
      const unsigned flat0 = (unsigned)(p.row0 + m0 + r) * (unsigned)(p.ldf ? p.ldf : p.N) +
                             (unsigned)(p.col0 + n0 + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float prev = cv[j];
        if constexpr (SR)
          cv[j] = quant_sr(__fadd_rn(prev, part[j]), qacc,
                           sr_bits(p.seed, (unsigned)(p.chunk0 + chunk), flat0 + (unsigned)j));
        else
          cv[j] = quant(__fadd_rn(prev, part[j]), qacc);
        if constexpr (STATS) {
          iv[j] = __fadd_rn(iv[j], part[j]);
          const bool live = (rows >> i) & (cols >> (h * 4 + j)) & 1u;
          const bool added = live && part[j] != 0.0f;
          n.adds += added;
          n.swamped += added && cv[j] == prev;
          if (live) n.max_abs = fmaxf(n.max_abs, fabsf(cv[j]));
        }
      }
      *cp = make_float4(cv[0], cv[1], cv[2], cv[3]);
      if constexpr (STATS)
        *reinterpret_cast<float4*>(Is + r * TILE + c) = make_float4(iv[0], iv[1], iv[2], iv[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

// One chunk group's walk over its chunks: ring, decode, FMAs, and the fold
// hand-off in chunk order.  Barrier ids: 1 + g the group's own, 1 + G + g
// the hand-off into group g.
template <typename TA, typename TB, int STAGE, bool STATS, bool SR>
__device__ __forceinline__ void run_group(const Gemm& p, int m0, int n0, unsigned char* gsm,
                                          float* Cs, float* Is, Counts& n) {
  constexpr int S = ring_stages(STAGE);
  constexpr int B_OFF = TILE * KT * (int)sizeof(TA);
  const int G = blockDim.x / GT, g = threadIdx.x / GT, gt = threadIdx.x % GT;
  const int tx = gt % 8, ty = gt / 8;
  float* As = reinterpret_cast<float*>(gsm);
  float* Bs = As + KT * TILE;
  unsigned char* ring = gsm + 2 * KT * TILE * 4;
  const int n_chunks = (p.K + p.chunk - 1) / p.chunk;
  const int spc = (p.chunk + KT - 1) / KT;  // steps a chunk (the last may pad)
  const int steps = (g < n_chunks ? (n_chunks - 1 - g) / G + 1 : 0) * spc;
  unsigned rows = 0, cols = 0;  // the thread's outputs inside the output (STATS)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (m0 + (i >> 2) * 32 + ty * 4 + (i & 3) < p.M) rows |= 1u << i;
    if (n0 + (i >> 2) * 32 + tx * 4 + (i & 3) < p.N) cols |= 1u << i;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // s < 0: the ring's first steps are only issued
#pragma unroll 1
  for (int s = 1 - S; s < steps; ++s) {
    const unsigned char* slot = ring + (s % S + S) % S * STAGE;
    if (s >= 0) {
      cp_async_wait<S - 2>();  // step s has landed (this thread's pieces)
      bar_sync(1 + g, GT);     // ... everyone's; step s - 1's FMAs are done
      decode<TA>(p.a, slot, As, gt, p.qr, p.dec);
      decode<TB>(p.b, slot + B_OFF, Bs, gt, p.qr, p.dec);
    }
    const int si = s + S - 1;  // issued into the slot decoded at step s - 1
    if (si < steps) {
      const long long kc = (long long)(g + (si / spc) * G) * p.chunk;
      const int k0 = (int)(kc + (si % spc) * KT);
      const int kmax = (int)min(kc + p.chunk, (long long)p.K);
      unsigned char* to = ring + (si % S) * STAGE;
      stage<TA>(p.a, m0, k0, kmax, to, gt);
      stage<TB>(p.b, n0, k0, kmax, to + B_OFF, gt);
    }
    cp_async_commit();  // an empty group past the end keeps the count
    if (s < 0) continue;
    bar_sync(1 + g, GT);
    fma_step(As, Bs, acc, tx, ty);
    if (s % spc == spc - 1) {
      const int c = g + (s / spc) * G;
      bar_sync(1 + g, GT);  // the step buffers are free to take the partials
      if (G > 1 && c > 0) bar_sync(1 + G + g, 2 * GT);  // chunk c - 1 folded
      fold<STATS, SR>(acc, reinterpret_cast<float4*>(As), Cs, Is, gt, tx, ty, rows, cols,
                      p.qacc, n, p, m0, n0, c);
      if (G > 1 && c + 1 < n_chunks) {
        __threadfence_block();
        bar_arrive(1 + G + (g + 1) % G, 2 * GT);
      }
    }
  }
  cp_async_wait<0>();
}

// The block's tile at (m0, n0): carry in, the groups, then C (and, with
// STATS, the block's partial stats row into `stats`).  smem holds
// smem_bytes(STAGE, blockDim / GT, STATS) bytes.  SR: the carries round
// stochastically under p.seed.  OUT: C leaves through emit_out under
// p.qout / p.pack (the stats row still reads the carry, so it is the same
// with and without the epilogue); the instantiations without it keep
// their code.
template <typename TA, typename TB, int STAGE, bool STATS, bool SR = false, bool OUT = false>
__device__ __forceinline__ void block_tile(const Gemm& p, int m0, int n0, unsigned char* smem,
                                           double* stats) {
  float* Cs = reinterpret_cast<float*>(smem);
  float* Is = STATS ? Cs + TILE * TILE : nullptr;
  unsigned char* groups = smem + (STATS ? 2 : 1) * TILE * TILE * 4;
  for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x) {
    const int gm = m0 + i / TILE, gn = n0 + i % TILE;
    Cs[i] = (p.Cin != nullptr && gm < p.M && gn < p.N) ? p.Cin[(long long)gm * p.ldc + gn]
                                                       : 0.0f;
    if constexpr (STATS) Is[i] = 0.0f;
  }
  __syncthreads();
  Counts n;
  run_group<TA, TB, STAGE, STATS, SR>(p, m0, n0,
                                      groups + (threadIdx.x / GT) * group_bytes(STAGE), Cs,
                                      Is, n);
  __syncthreads();
  double v[N_STATS];
#pragma unroll
  for (int s = 0; s < N_STATS; ++s) v[s] = 0.0;
  for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x) {
    const int gm = m0 + i / TILE, gn = n0 + i % TILE;
    if (gm < p.M && gn < p.N) {
      if constexpr (OUT)
        emit_out(p.C, (long long)gm * p.ldc + gn, Cs[i], p.qout, p.pack, p.e_o, p.m_o);
      else
        p.C[(long long)gm * p.ldc + gn] = Cs[i];
      if constexpr (STATS) stats_moments(v, Cs[i], Is[i]);
    }
  }
  if constexpr (STATS) {
    v[STAT_MAX_ABS] = n.max_abs;
    v[STAT_SWAMPED] = n.swamped;
    v[STAT_ADDS] = n.adds;
    double* sh = reinterpret_cast<double*>(groups);  // group 0's step buffers, free now
    if (blockDim.x == GT)
      stats_block_row<GT>(v, stats, sh);
    else if (blockDim.x == 2 * GT)
      stats_block_row<2 * GT>(v, stats, sh);
    else
      stats_block_row<4 * GT>(v, stats, sh);
  }
}

}  // namespace sm90
