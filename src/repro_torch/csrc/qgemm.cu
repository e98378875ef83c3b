// G: fused quantized GEMM with a chunked (1, e_acc, m_acc) carry, the
// serving path's GEMM (decode, prefill slabs, the tied lm_head) and the
// training step's lm_head forward and the eager telemetry tick's forwards.
//
// G replaces repro/kernels/fused.py::_fused_kernel (RNE and SR carries, f32
// or bf16 operands, either one unquantized, and int8 codes; the out_fmt /
// pack_out epilogue).  C[M,N] = sum over chunks of
// carry = q_acc(carry + Q(A_chunk) . Q(B_chunk)), chunk = the plan's n1:
// within a chunk part = fma(a_k, b_k, part) in increasing k from 0, f32
// round to nearest; once a chunk carry = q_acc(carry + part); a ragged last
// chunk folds what it has.  Partials of different chunks are independent
// and only the fold is sequential, so a split at chunk boundaries whose
// partials are folded in chunk order keeps every bit.
//
// Two routes; kernels/sm90.py picks one per call from the shape, and every
// output is bitwise either way:
//
// * decode (M up to sm90.DECODE_MAX_M, or twice that where the tile's
//   grid would leave SMs idle): bound by the weights' bytes, each read
//   once.  qgemm_decode_kernel gives a thread V columns (one 32-bit
//   word of the weight's type: 2 bf16) of one chunk for a row group of 8
//   rows: 8 x V partials in registers, the chunk's k walked in increasing
//   order 8 k a step, each weight quantized once, in registers.  A warp
//   covers a strip of 32 V columns of one chunk, so a row-major weight's
//   row arrives as one 128-byte line a warp; the tied head's embed.T (k
//   contiguous) arrives 16 bytes (8 k of a column) a load.  A block holds
//   `slots` warps, one chunk each, and four blocks fit an SM (64 registers
//   a thread): their warps hide the loads' latency.  The block's rows of A
//   are quantized once into shared memory for the chunks it takes.  Where
//   the strips alone give the card enough warps (the lm_head, N = 151936:
//   2374 strips) a block walks every chunk of its strip in rounds and
//   folds each round's partials in chunk order in shared memory, with no
//   workspace.  Otherwise the chunks are split over `slices` blocks at
//   chunk boundaries: each writes its partials to an f32 workspace
//   [chunks, M, N], and a second kernel, one thread an output, folds them
//   in chunk order.  At qwen2-1.5b's shapes the workspace is at most 6.9 MB
//   at M = 8 and 27.5 MB at 32, inside the H100's 50 MB L2; mlp_down's at
//   M = 64 is 55 MB, past it, and the route still beat the tile there.
//   (A fold by the last block of a strip to finish, behind a ticket
//   counter, saves that launch but ran slower on the H100: its few threads
//   fold whole strips; PERF.md, PR 17.)  Rows past M are zeros in shared
//   memory and are never stored.
// * tile (larger M): the Hopper tile of qgemm_sm90.cuh without the shadow
//   carry over K8's grid (chunk groups from the chunk count), bounded by
//   the f32 FMAs on the CUDA cores since the bitwise contract keeps the
//   tensor cores out; its C is bitwise K8's on the same operands.
//
// Stochastic rounding (an SR template flag on the decode kernel, its fold
// kernel and the tile): each carry update rounds with quant_sr and the
// dither sr_bits(seed, c, (row0 + m) * n_cols + col0 + n) of common.cuh, c
// the chunk's index in the K walk, (m, n) the output and (row0, col0) its
// place in a whole output of n_cols columns (0, 0 and N by default; a mesh
// rank's rows and columns otherwise), every product mod 2^32: the stream of
// the JAX package's SR kernel and of E, K8 and the plain version, so C is
// bitwise theirs under one seed on either route and any split.  In the
// unsplit decode route a block folds its chunks in rounds of `slots`, so a
// round's chunk q is c0 + q; the split call's fold kernel walks c from 0.
// The flag is a template argument, so the RNE kernels keep their code,
// their 64 registers and their four blocks an SM.
//
// The output epilogue (fused.py::_emit_output): the finished carry
// rounded to nearest even into the output format and, with pack, stored as
// its int8 code (qgemm_sm90.cuh's emit_out).  It runs where C is stored:
// the unsplit decode kernel's store, the split call's fold kernel (never
// the partials' store into the workspace) and the tile's store loop, in
// kernels of their own (qgemm_decode_out_kernel, qgemm_fold_out_kernel,
// qgemm_tile_out_kernel) whose bodies are the base kernels' with an OUT
// flag, so the base kernels keep their code.  The one entry, qgemm, runs
// the base kernels where the output format is the identity.  int8 operand
// codes (a_packed / b_packed) take the tile's out kernel, which lands and
// unpacks them as K8's does; kernels/sm90.py routes them there at every
// M.  An unquantized operand is a flag of either route.
//
// Both kernels take their arguments in the parameter space
// (__grid_constant__): passed by value, nvcc 12.9 built G's earlier tile
// with 190-194 registers a thread against 101-126, and G ran 1.26x slower
// at decode on the H100.  (The Hopper tile builds to 103-104 registers
// either way: E's kernel takes them by value.)
#include "qgemm_sm90.cuh"

#include <type_traits>

namespace {

using bf = __nv_bfloat16;

// ------------------------------------------------------------- decode ---

constexpr int ROWS = 8;    // rows of A a block takes (its row group)
constexpr int LANES = 32;  // threads across a strip: a warp, V columns each
constexpr int KS = 8;      // k a step loads
constexpr int MAX_SLOTS = 8;
constexpr int FOLD_THREADS = 256;

// V: the columns a thread owns, one 32-bit word of B a row; a strip is
// LANES * V columns wide.
template <typename TB>
__host__ __device__ constexpr int vlen() {
  return 4 / (int)sizeof(TB);
}

// Dynamic shared memory (bytes): one region for a round's rows of A
// (slots chunks of k, 8 rows each) or, after its FMAs, its partials
// (slots x 8 x width), then the carries (8 x width).  kernels/sm90.py
// mirrors it.
__host__ __device__ constexpr int decode_smem(int slots, int chunk, int width) {
  return (slots * ROWS * (chunk > width ? chunk : width) + ROWS * width) * 4;
}

struct Decode {
  const void* A;  // A[m, k] = A[m * sam + k * sak]
  long long sam, sak;
  const void* B;  // B[k, n] = B[k * sbk + n * sbn]
  long long sbk, sbn;
  float* C;       // [M, N] row-major
  float* ws;      // [chunks, M, N] partials of a split call
  int M, N, K, chunk;
  int slices;     // blocks along the chunks (1: no split)
  int b_vec;      // whole-word (row) or 16-byte (k-contiguous) loads of B
  sm90::Quant qa, qb, qacc;  // qa/qb: the identity where not quantized
  unsigned seed;  // the SR dither's seed (SR instantiations only)
  // the output epilogue (OUT bodies only): format, int8 codes, code layout
  sm90::Quant qout;
  int pack, e_o, m_o;
  // SR only: the logical row and column of output (0, 0) in a whole
  // output of ldf columns (0: N), a block of a longer GEMM (a mesh rank's)
  int row0 = 0, col0 = 0, ldf = 0;
};

// The SR counter of output (m, n): its flat index in the whole output
__device__ __forceinline__ unsigned sr_flat(const Decode& p, int m, int n) {
  return (unsigned)(p.row0 + m) * (unsigned)(p.ldf ? p.ldf : p.N) + (unsigned)(p.col0 + n);
}

// A carry update: carry + part rounded to q, stochastically (SR) with the
// dither of chunk c at flat index `flat`
template <bool SR>
__device__ __forceinline__ float carry_add(float carry, float part, const Decode& p,
                                           unsigned c, unsigned flat) {
  const float v = __fadd_rn(carry, part);
  if constexpr (SR) return sm90::quant_sr(v, p.qacc, sr_bits(p.seed, c, flat));
  return sm90::quant(v, p.qacc);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf v) { return __bfloat162float(v); }
__device__ __forceinline__ unsigned raw_bits(const float* p, long long i) {
  return __float_as_uint(p[i]);
}
__device__ __forceinline__ unsigned raw_bits(const bf* p, long long i) {
  return __bfloat16_as_ushort(p[i]);
}

// A step's weights in eight 32-bit words (32 bytes: KS rows of V columns).
// Row-major B: word kk holds the V columns of row k0 + kk.  KFAST (the
// tied head's embed.T): the KS values of k of column j are words
// j * KS * sizeof(TB) / 4 on.  Element e of the words, in TB units, is
// (kk, j) at e = kk * V + j, or j * KS + kk with KFAST.
template <typename TB>
__device__ __forceinline__ float weight(const unsigned (&w)[8], int e) {
  if constexpr (sizeof(TB) == 4) {
    return __uint_as_float(w[e]);
  } else {
    return __uint_as_float(((w[e >> 1] >> ((e & 1) * 16)) & 0xffffu) << 16);
  }
}

// nv elements of B from off, stride apart, into elements [e0, e0 + nv) of
// the words (the rest of them left 0): the element path of a piece that an
// edge or the layout cuts
template <typename TB, int CNT>
__device__ __forceinline__ void elems(const TB* B, long long off, long long stride, int nv,
                                      unsigned (&w)[8], int e0) {
#pragma unroll
  for (int e = 0; e < CNT; ++e) {
    if (e >= nv) break;
    const int at = e0 + e;
    w[at * (int)sizeof(TB) / 4] |= raw_bits(B, off + e * stride)
                                   << ((at * (int)sizeof(TB) % 4) * 8);
  }
}

// One step's weights: columns [n, n + V), k in [k0, k0 + KS) below ke,
// zeros past the edges
template <typename TB, bool KFAST>
__device__ __forceinline__ void load_step(const Decode& p, int n, int k0, int ke,
                                          unsigned (&w)[8]) {
  constexpr int V = vlen<TB>();
  const TB* B = static_cast<const TB*>(p.B);
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = 0u;
  if constexpr (KFAST) {
    constexpr int PIECES = KS * (int)sizeof(TB) / 16;  // 16-byte pieces a column
    const int nv = min(KS, ke - k0);
    const bool full = p.b_vec && nv == KS;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (n + j >= p.N) continue;
      const long long off = (long long)(n + j) * p.sbn + (long long)k0 * p.sbk;
      if (full) {
#pragma unroll
        for (int q = 0; q < PIECES; ++q) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(B + off) + q);
          const int at = (j * PIECES + q) * 4;
          w[at] = v.x; w[at + 1] = v.y; w[at + 2] = v.z; w[at + 3] = v.w;
        }
      } else {
        elems<TB, KS>(B, off, p.sbk, nv, w, j * KS);
      }
    }
  } else {
    const int nv = max(min(V, p.N - n), 0);
    const bool full = p.b_vec && nv == V;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (k0 + kk >= ke) break;
      const long long off = (long long)(k0 + kk) * p.sbk + (long long)n * p.sbn;
      if (full)
        w[kk] = __ldg(reinterpret_cast<const unsigned*>(B + off));
      else
        elems<TB, V>(B, off, p.sbn, nv, w, kk * V);
    }
  }
}

// kn (<= KS) rank-1 updates of the 8 x V partial, k increasing; As holds
// the step's rows of A as [k][8].  A past the chunk's end is the next
// chunk's, so the updates stop at kn.
template <typename TB, bool KFAST, bool QB>
__device__ __forceinline__ void step_fma(const Decode& p, const unsigned (&t)[8],
                                         const float* As, int kn,
                                         float (&part)[ROWS][vlen<TB>()]) {
  constexpr int V = vlen<TB>();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk < kn) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * ROWS);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * ROWS + 4);
      const float a[ROWS] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float w[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = weight<TB>(t, KFAST ? j * KS + kk : kk * V + j);
        w[j] = QB ? sm90::quant(v, p.qb) : v;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) part[i][j] = __fmaf_rn(a[i], w[j], part[i][j]);
    }
  }
}

// The partial of one chunk, k in [kb, ke), for columns [n, n + V).  A
// step's loads are issued just before its FMAs: the warps of four resident
// blocks an SM hide their latency, and the kernel fits 64 registers a
// thread with no spill (issued a step ahead, it spills and runs slower;
// tools/sm90/g_ablate.py).
template <typename TB, bool KFAST, bool QB>
__device__ __forceinline__ void chunk_partial(const Decode& p, const float* As, int kb, int ke,
                                              int n, float (&part)[ROWS][vlen<TB>()]) {
  unsigned cur[8];
#pragma unroll 1
  for (int k0 = kb; k0 < ke; k0 += KS) {
    load_step<TB, KFAST>(p, n, k0, ke, cur);
    step_fma<TB, KFAST, QB>(p, cur, As + (k0 - kb) * ROWS, min(KS, ke - k0), part);
  }
}

// The block's 8 rows of A for k in [kr0, kr0 + len), quantized, into
// As[k][8] (zeros past M).  Each thread has NB loads of W consecutive k in
// flight at once (W = 4: float4 loads of a row-major f32 A); neighbouring
// threads take neighbouring rows, so the stores spread over the banks.
template <int W, typename TA>
__device__ __forceinline__ void stage_a(const Decode& p, const TA* A, int m0, long long kr0,
                                        int len, float* As) {
  constexpr int NB = 8;
  const int items = ROWS * (len / W);
  for (int i0 = threadIdx.x; i0 < items; i0 += NB * blockDim.x) {
    float v[NB][W];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int i = i0 + b * blockDim.x, r = i % ROWS, k = (i / ROWS) * W;
      const long long off = (long long)(m0 + r) * p.sam + (kr0 + k) * p.sak;
      if (i < items && m0 + r < p.M) {
        if constexpr (W == 4) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(A + off));
          v[b][0] = q.x; v[b][1] = q.y; v[b][2] = q.z; v[b][3] = q.w;
        } else {
          v[b][0] = widen(A[off]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) v[b][e] = 0.0f;
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int i = i0 + b * blockDim.x, r = i % ROWS, k = (i / ROWS) * W;
      if (i < items) {
#pragma unroll
        for (int e = 0; e < W; ++e) As[(k + e) * ROWS + r] = sm90::quant(v[b][e], p.qa);
      }
    }
  }
}

// C[i] of an unsplit call or a fold: the carry as it is, or (OUT) through
// the output epilogue
template <bool OUT>
__device__ __forceinline__ void store_c(const Decode& p, long long i, float v) {
  if constexpr (OUT)
    sm90::emit_out(p.C, i, v, p.qout, p.pack, p.e_o, p.m_o);
  else
    p.C[i] = v;
}

// One warp takes one chunk of a strip (a chunk slot) for the block's row
// group; the block's slots take consecutive chunks, in rounds of `slots`
// chunks where the call is not split.
template <typename TA, typename TB, bool KFAST, bool SR, bool OUT>
__device__ __forceinline__ void decode_body(const Decode& p) {
  constexpr int V = vlen<TB>(), W = LANES * V;
  extern __shared__ __align__(16) float sm[];
  const int slots = blockDim.x / LANES, slot = threadIdx.x / LANES;
  const int m0 = blockIdx.z * ROWS, n0 = blockIdx.x * W;
  const int n = n0 + (threadIdx.x % LANES) * V;
  const int nc = (int)(((long long)p.K + p.chunk - 1) / p.chunk);
  const int c_first = blockIdx.y * slots;
  const int c_end = p.slices == 1 ? nc : min(nc, c_first + slots);
  float* As = sm;  // a round's rows of A [k][8], quantized; then its partials
  float* Cs = sm + slots * ROWS * max(p.chunk, W);  // the carries [8][W]
  for (int o = threadIdx.x; o < ROWS * W; o += blockDim.x) Cs[o] = 0.0f;

  const TA* A = static_cast<const TA*>(p.A);
  const bool qb = !p.qb.identity;
  const bool a_vec = sizeof(TA) == 4 && p.sak == 1 && p.sam % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(A) % 16 == 0;
#pragma unroll 1
  for (int c0 = c_first; c0 < c_end; c0 += slots) {
    const long long kr0 = (long long)c0 * p.chunk;
    const int len = (int)(min(kr0 + (long long)slots * p.chunk, (long long)p.K) - kr0);
    __syncthreads();  // the previous round's fold is done with the region
    if (a_vec && kr0 % 4 == 0 && len % 4 == 0)
      stage_a<4>(p, A, m0, kr0, len, As);
    else
      stage_a<1>(p, A, m0, kr0, len, As);
    __syncthreads();
    const int c = c0 + slot;
    float part[ROWS][V];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) part[i][j] = 0.0f;
    if (c < c_end) {
      const int kb = (int)((long long)c * p.chunk);
      const int ke = (int)min((long long)kb + p.chunk, (long long)p.K);
      const float* Ac = As + (kb - kr0) * ROWS;
      if (qb)
        chunk_partial<TB, KFAST, true>(p, Ac, kb, ke, n, part);
      else
        chunk_partial<TB, KFAST, false>(p, Ac, kb, ke, n, part);
    }
    __syncthreads();  // the rows of A are read: the partials take the region
    if (c < c_end) {
      if (p.slices == 1) {
        float* P = As + slot * ROWS * W + (n - n0);
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < V; ++j) P[i * W + j] = part[i][j];
      } else {
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          if (m0 + i >= p.M) break;
          float* dst = p.ws + ((long long)c * p.M + m0 + i) * p.N + n;
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (n + j < p.N) dst[j] = part[i][j];
        }
      }
    }
    if (p.slices == 1) {
      __syncthreads();
      const int nr = min(slots, c_end - c0);
      for (int o = threadIdx.x; o < ROWS * W; o += blockDim.x) {
        // rows past M and columns past N alias flat indices: never stored
        const unsigned flat = sr_flat(p, m0 + o / W, n0 + o % W);
        float carry = Cs[o];
        for (int q = 0; q < nr; ++q)
          carry = carry_add<SR>(carry, As[q * ROWS * W + o], p, (unsigned)(c0 + q), flat);
        Cs[o] = carry;
      }
    }
  }
  if (p.slices > 1) return;
  __syncthreads();
  for (int o = threadIdx.x; o < ROWS * W; o += blockDim.x) {
    const int m = m0 + o / W, nn = n0 + o % W;
    if (m < p.M && nn < p.N) store_c<OUT>(p, (long long)m * p.N + nn, Cs[o]);
  }
}

template <typename TA, typename TB, bool KFAST, bool SR>
__global__ void __launch_bounds__(MAX_SLOTS * LANES, 4)
    qgemm_decode_kernel(const __grid_constant__ Decode p) {
  decode_body<TA, TB, KFAST, SR, false>(p);
}

template <typename TA, typename TB, bool KFAST, bool SR>
__global__ void __launch_bounds__(MAX_SLOTS * LANES, 4)
    qgemm_decode_out_kernel(const __grid_constant__ Decode p) {
  decode_body<TA, TB, KFAST, SR, true>(p);
}

// A split call's fold, one thread an output: its chunk partials in chunk
// order
template <bool SR, bool OUT>
__device__ __forceinline__ void fold_body(const Decode& p) {
  const long long o = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (o >= (long long)p.M * p.N) return;
  const int nc = (int)(((long long)p.K + p.chunk - 1) / p.chunk);
  const long long stride = (long long)p.M * p.N;
  const unsigned flat = sr_flat(p, (int)(o / p.N), (int)(o % p.N));
  float carry = 0.0f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c)
    carry = carry_add<SR>(carry, p.ws[o + c * stride], p, (unsigned)c, flat);
  store_c<OUT>(p, o, carry);
}

template <bool SR>
__global__ void __launch_bounds__(FOLD_THREADS) qgemm_fold_kernel(const __grid_constant__ Decode p) {
  fold_body<SR, false>(p);
}

template <bool SR>
__global__ void __launch_bounds__(FOLD_THREADS)
    qgemm_fold_out_kernel(const __grid_constant__ Decode p) {
  fold_body<SR, true>(p);
}

// The decode and fold kernels of an instantiation, with or without the
// output epilogue
template <typename TA, typename TB, bool KFAST, bool SR, bool OUT>
auto decode_kernel() {
  if constexpr (OUT)
    return qgemm_decode_out_kernel<TA, TB, KFAST, SR>;
  else
    return qgemm_decode_kernel<TA, TB, KFAST, SR>;
}
template <bool SR, bool OUT>
auto fold_kernel() {
  if constexpr (OUT)
    return qgemm_fold_out_kernel<SR>;
  else
    return qgemm_fold_kernel<SR>;
}

bool valid_slots(int slots) { return slots >= 1 && slots <= MAX_SLOTS; }

template <typename TA, typename TB, bool KFAST, bool SR = false, bool OUT = false>
int decode_set_smem(int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(decode_kernel<TA, TB, KFAST, SR, OUT>(),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename TA, typename TB, bool KFAST, bool SR, bool OUT>
int decode_launch(const Decode& p, int slots, cudaStream_t s) {
  constexpr int W = LANES * vlen<TB>();
  const long long nc = ((long long)p.K + p.chunk - 1) / p.chunk;
  const bool split = p.slices > 1;
  if (!valid_slots(slots) || p.slices < 1 ||
      (split && (p.slices != (nc + slots - 1) / slots || p.ws == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = decode_smem(slots, p.chunk, W);
  // above the default 48 KiB only (a long chunk): the call costs host time
  int rc = bytes > 48 * 1024 ? decode_set_smem<TA, TB, KFAST, SR, OUT>(bytes) : 0;
  if (rc != 0) return rc;
  dim3 grid((p.N + W - 1) / W, p.slices, (p.M + ROWS - 1) / ROWS);
  const auto kernel = decode_kernel<TA, TB, KFAST, SR, OUT>();
  kernel<<<grid, slots * LANES, bytes, s>>>(p);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || !split) return rc;
  const long long outs = (long long)p.M * p.N;
  const auto fold = fold_kernel<SR, OUT>();
  fold<<<(unsigned)((outs + FOLD_THREADS - 1) / FOLD_THREADS), FOLD_THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// B's layout: KFAST where k is the contiguous axis (the tied head's embed.T)
bool b_kfast(long long sbk, long long sbn) { return sbk == 1 && sbn != 1; }

template <typename TA, typename TB, bool SR, bool OUT = false>
int decode(const Decode& p0, int slots, cudaStream_t s) {
  Decode p = p0;
  const long long E = sizeof(TB);
  const uintptr_t base = reinterpret_cast<uintptr_t>(p.B);
  if (b_kfast(p.sbk, p.sbn)) {  // 16-byte pieces of KS values of k
    p.b_vec = base % 16 == 0 && (p.sbn * E) % 16 == 0 && ((long long)p.chunk * E) % 16 == 0;
    return decode_launch<TA, TB, true, SR, OUT>(p, slots, s);
  }
  p.b_vec = base % 4 == 0 && p.sbn == 1 && (p.sbk * E) % 4 == 0;  // one word a row
  return decode_launch<TA, TB, false, SR, OUT>(p, slots, s);
}

// --------------------------------------------------------------- tile ---

template <typename TA, typename TB, bool SR>
__global__ void __launch_bounds__(4 * sm90::GT, 2)
    qgemm_tile_kernel(const __grid_constant__ sm90::Gemm p) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::block_tile<TA, TB, sm90::stage_bytes<TA, TB>(), false, SR>(
      p, blockIdx.y * sm90::TILE, blockIdx.x * sm90::TILE, smem, nullptr);
}

// The tile with the output epilogue, on f32, bf16 or int8-code operands
template <typename TA, typename TB, bool SR>
__global__ void __launch_bounds__(4 * sm90::GT, 2)
    qgemm_tile_out_kernel(const __grid_constant__ sm90::Gemm p) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::block_tile<TA, TB, sm90::stage_bytes<TA, TB>(), false, SR, true>(
      p, blockIdx.y * sm90::TILE, blockIdx.x * sm90::TILE, smem, nullptr);
}

template <typename TA, typename TB, bool SR, bool OUT>
auto tile_kernel() {
  if constexpr (OUT)
    return qgemm_tile_out_kernel<TA, TB, SR>;
  else
    return qgemm_tile_kernel<TA, TB, SR>;
}

bool valid_groups(int groups) { return groups == 1 || groups == 2 || groups == 4; }

template <typename TA, typename TB>
int tile_smem(int groups) {
  return sm90::smem_bytes(sm90::stage_bytes<TA, TB>(), groups, false);
}

template <typename TA, typename TB, bool SR = false, bool OUT = false>
int tile_set_smem(int groups) {
  return static_cast<int>(cudaFuncSetAttribute(
      tile_kernel<TA, TB, SR, OUT>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      tile_smem<TA, TB>(groups)));
}

template <typename TA, typename TB, bool SR, bool OUT>
int tile(const sm90::Gemm& p, int groups, cudaStream_t s) {
  if (!valid_groups(groups)) return static_cast<int>(cudaErrorInvalidValue);
  int rc = tile_set_smem<TA, TB, SR, OUT>(groups);
  if (rc != 0) return rc;
  dim3 grid((p.N + sm90::TILE - 1) / sm90::TILE, (p.M + sm90::TILE - 1) / sm90::TILE);
  const auto kernel = tile_kernel<TA, TB, SR, OUT>();
  kernel<<<grid, groups * sm90::GT, tile_smem<TA, TB>(groups), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// f(TA, TB) over the operand types (bf16 flags)
template <typename F>
int by_types(int a_bf16, int b_bf16, F f) {
  if (a_bf16 && b_bf16) return f(bf{}, bf{});
  if (a_bf16) return f(bf{}, float{});
  if (b_bf16) return f(float{}, bf{});
  return f(float{}, float{});
}

int occupancy_of(const void* kernel, int threads, int bytes, int rc) {
  int n = 0;
  if (rc == 0)
    rc = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes));
  return rc != 0 ? -rc : n;
}

}  // namespace

// The decode route's workspace (floats) for `slices` blocks along the
// chunks, its dynamic shared memory (bytes) and its resident blocks an SM
// (or a negative error) under RNE (sr 0) or SR (sr 1); kernels/sm90.py
// mirrors the first two.
extern "C" long long qgemm_decode_ws(int M, int N, int K, int chunk, int slices) {
  return slices > 1 ? (((long long)K + chunk - 1) / chunk) * M * N : 0;
}
extern "C" int qgemm_decode_smem(int b_bf16, int slots, int chunk) {
  return decode_smem(slots, chunk, LANES * (b_bf16 ? vlen<bf>() : vlen<float>()));
}
extern "C" int qgemm_decode_occupancy(int a_bf16, int b_bf16, int kfast, int slots, int chunk,
                                      int sr) {
  if (!valid_slots(slots)) return -static_cast<int>(cudaErrorInvalidValue);
  return by_types(a_bf16, b_bf16, [&](auto ta, auto tb) {
    using TA = decltype(ta);
    using TB = decltype(tb);
    const int bytes = decode_smem(slots, chunk, LANES * vlen<TB>());
    auto go = [&](auto kf, auto rounds_sr) {
      constexpr bool KF = decltype(kf)::value, SR = decltype(rounds_sr)::value;
      return occupancy_of((const void*)qgemm_decode_kernel<TA, TB, KF, SR>, slots * LANES,
                          bytes, decode_set_smem<TA, TB, KF, SR>(bytes));
    };
    if (kfast)
      return sr ? go(std::true_type{}, std::true_type{}) : go(std::true_type{}, std::false_type{});
    return sr ? go(std::false_type{}, std::true_type{}) : go(std::false_type{}, std::false_type{});
  });
}

// The same for the decode kernel with the output epilogue
extern "C" int qgemm_decode_out_occupancy(int a_bf16, int b_bf16, int kfast, int slots,
                                          int chunk, int sr) {
  if (!valid_slots(slots)) return -static_cast<int>(cudaErrorInvalidValue);
  return by_types(a_bf16, b_bf16, [&](auto ta, auto tb) {
    using TA = decltype(ta);
    using TB = decltype(tb);
    const int bytes = decode_smem(slots, chunk, LANES * vlen<TB>());
    auto go = [&](auto kf, auto rounds_sr) {
      constexpr bool KF = decltype(kf)::value, SR = decltype(rounds_sr)::value;
      return occupancy_of((const void*)qgemm_decode_out_kernel<TA, TB, KF, SR>, slots * LANES,
                          bytes, decode_set_smem<TA, TB, KF, SR, true>(bytes));
    };
    if (kfast)
      return sr ? go(std::true_type{}, std::true_type{}) : go(std::true_type{}, std::false_type{});
    return sr ? go(std::false_type{}, std::true_type{}) : go(std::false_type{}, std::false_type{});
  });
}

// The tile route's dynamic shared memory (bytes) and resident blocks an SM
// at `groups` chunk groups (or a negative error).
extern "C" int qgemm_tile_smem(int a_bf16, int b_bf16, int groups) {
  return by_types(a_bf16, b_bf16, [&](auto ta, auto tb) {
    return tile_smem<decltype(ta), decltype(tb)>(groups);
  });
}
extern "C" int qgemm_tile_occupancy(int a_bf16, int b_bf16, int groups) {
  if (!valid_groups(groups)) return -static_cast<int>(cudaErrorInvalidValue);
  return by_types(a_bf16, b_bf16, [&](auto ta, auto tb) {
    using TA = decltype(ta);
    using TB = decltype(tb);
    return occupancy_of((const void*)qgemm_tile_kernel<TA, TB, false>, groups * sm90::GT,
                        tile_smem<TA, TB>(groups), tile_set_smem<TA, TB>(groups));
  });
}

// The tile's out kernel at operand kinds (0 f32, 1 bf16, 2 int8 codes):
// dynamic shared memory (bytes) and resident blocks an SM at `groups`
// chunk groups (or a negative error).
extern "C" int qgemm_tile_out_smem(int a_kind, int b_kind, int groups) {
  return sm90::by_kinds(a_kind, b_kind, [&](auto ta, auto tb) {
    return tile_smem<decltype(ta), decltype(tb)>(groups);
  });
}
extern "C" int qgemm_tile_out_occupancy(int a_kind, int b_kind, int groups) {
  if (!valid_groups(groups)) return -static_cast<int>(cudaErrorInvalidValue);
  return sm90::by_kinds(a_kind, b_kind, [&](auto ta, auto tb) {
    using TA = decltype(ta);
    using TB = decltype(tb);
    return occupancy_of((const void*)qgemm_tile_out_kernel<TA, TB, false>, groups * sm90::GT,
                        tile_smem<TA, TB>(groups), tile_set_smem<TA, TB, false, true>(groups));
  });
}

// G.  A and B: f32 (kind 0), bf16 (1) or int8 codes of (1, e_r, m_r) (2;
// never quantized again); strides in elements.  quant_a / quant_b: the
// operand is rounded to r_* on its load.  C [M, N] row-major: the carry
// (c_*) rounded to nearest even into o_* (o_identity: as it is) and, with
// pack, written as int8 codes of (1, e_o, m_o) (M x N bytes) instead of
// floats.  route 0 is decode (float operands only): `par` chunk slots a
// block (warps, 1 to 8), `slices` blocks along the chunks (1: no split;
// else a fold kernel follows), `ws` the workspace of qgemm_decode_ws
// floats.  route 1 is the tile: `par` chunk groups a block (1, 2 or 4).
// kernels/sm90.py picks all of them.  sr: the carries round stochastically
// under `seed`, C being the block at (row0, col0) of a whole output of
// n_cols columns (0: N); RNE ignores the three.  Float operands without an output format run the base
// kernels, the rest the out kernels.  Returns the cudaError_t of the
// launches.
extern "C" int qgemm(const void* A, int a_kind, long long sam, long long sak,
                     const void* B, int b_kind, long long sbk, long long sbn,
                     void* C, int M, int N, int K, int chunk, int e_r, int m_r,
                     int r_identity, int r_shift, float r_max, float r_min,
                     int quant_a, int quant_b,
                     int c_identity, int c_shift, float c_max, float c_min,
                     int o_identity, int o_shift, float o_max, float o_min,
                     int pack, int e_o, int m_o, int sr, unsigned seed,
                     int row0, int col0, int n_cols, int route, int par, int slices, void* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const QFmt qr{r_identity, r_shift, r_max, r_min};
  const sm90::Quant qacc = sm90::quant_of(QFmt{c_identity, c_shift, c_max, c_min});
  const sm90::Quant qout = sm90::quant_of(QFmt{o_identity, o_shift, o_max, o_min});
  const bool out = !o_identity || pack;
  if (route == 1) {
    const sm90::Dec dec = sm90::dec_of(e_r, m_r);
    return sm90::by_kinds(a_kind, b_kind, [&](auto ta, auto tb) {
      using TA = decltype(ta);
      using TB = decltype(tb);
      sm90::Gemm p{sm90::operand(A, sizeof(TA), sam, sak, M, chunk, quant_a),
                   sm90::operand(B, sizeof(TB), sbn, sbk, N, chunk, quant_b),
                   static_cast<float*>(C), N, nullptr, M, N, K, chunk, sm90::quant_of(qr),
                   qacc, dec, seed};
      p.row0 = row0;
      p.col0 = col0;
      p.ldf = n_cols;
      p.qout = qout;
      p.pack = pack;
      p.e_o = e_o;
      p.m_o = m_o;
      auto go = [&](auto rounds_sr) {
        constexpr bool SR = decltype(rounds_sr)::value;
        // int8 codes have the out kernel only (its epilogue the identity)
        if constexpr (sizeof(TA) == 1 || sizeof(TB) == 1)
          return tile<TA, TB, SR, true>(p, par, s);
        else
          return out ? tile<TA, TB, SR, true>(p, par, s) : tile<TA, TB, SR, false>(p, par, s);
      };
      return sr ? go(std::true_type{}) : go(std::false_type{});
    });
  }
  if (route != 0 || chunk < 1 || a_kind > 1 || b_kind > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const QFmt ident{1, 0, 0.0f, 0.0f};
  const Decode p{A, sam, sak, B, sbk, sbn, static_cast<float*>(C), static_cast<float*>(ws),
                 M, N, K, chunk, slices, 0, sm90::quant_of(quant_a ? qr : ident),
                 sm90::quant_of(quant_b ? qr : ident), qacc, seed, qout, pack, e_o, m_o,
                 row0, col0, n_cols};
  return by_types(a_kind, b_kind, [&](auto ta, auto tb) {
    using TA = decltype(ta);
    using TB = decltype(tb);
    auto go = [&](auto rounds_sr) {
      constexpr bool SR = decltype(rounds_sr)::value;
      return out ? decode<TA, TB, SR, true>(p, par, s) : decode<TA, TB, SR, false>(p, par, s);
    };
    return sr ? go(std::true_type{}) : go(std::false_type{});
  });
}
