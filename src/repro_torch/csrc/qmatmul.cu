// K3: C = A . B with a chunked (1, e_acc, m_acc) carry, operands taken as
// they are (no operand quantization).
//
// Replaces repro/kernels/qmatmul.py::_qmatmul_kernel (qmatmul_pallas), the
// GEMM of the unfused qdot oracle: there one grid step contracts one K tile
// (= one chunk, n1 = block_k) on the MXU in f32 and rounds the running
// carry to (1, e_acc, m_acc); here every output element forms
//
//   partial = sum over the chunk, in increasing k, of fma(a, b, partial)
//   carry   = q_acc(carry + partial)
//
// once per chunk (a ragged last chunk folds what it has).  This is its own
// tile, written apart from G's kernels (qgemm.cu) and from the Hopper tile
// of E, K8, B and K9 (qgemm_sm90.cuh), and it includes nothing of them, so
// that the oracle on the card checks them against an independent kernel;
// the operation sequence per output is the same by design.
//
// Bound on the H100: its work needs only the bytes (the oracle's operands
// and C are f32, each read or written once, over 3.35 TB/s), but the
// bitwise contract fixes each chunk's partial to the sequential f32 FMA
// chain, which no tensor-core MMA forms, so it runs on the CUDA cores at
// their f32 rate (67 TFLOP/s), bounded in practice by the instructions it
// issues.  What the design does about it:
//
// * A block computes one 64 x 64 tile of C with S chunk slices of 64
//   threads (S = 1, 2 or 4, from the chunk count, kernels/qmatmul.py).  In
//   round r slice s forms the partials of chunk r * S + s, each thread an
//   8 x 8 patch in registers (rows ty*4 + i and 32 + ty*4 + i, columns
//   alike) fed by 4 float4 shared loads a k for 64 FMAs.  At the end of a
//   round every slice writes its partials to shared memory and, after one
//   block barrier, all threads fold the round's S partials in chunk order
//   into the carries, which stay in shared memory.  Partials of different
//   chunks are independent; only the fold is sequential, so a tile's long
//   sum runs on S x 64 threads and calls with few tiles (512 x 256: 32
//   tiles) still put 8192 threads on the card.
// * Each slice stages its chunk 16 k at a time through its own shared
//   tiles, synchronised on its own named barrier; the next step's loads
//   are issued into registers before the current step is computed.  Loads
//   are 16 bytes along whichever axis of an operand is contiguous (k for
//   the forward's x and the backward's w^T, m for the gradient's x^T, n
//   for w and g), and widened and transposed as they are stored; a piece
//   that a ragged edge, a chunk end or an unaligned layout cuts is loaded
//   element by element, zeros past the edge.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using bf = __nv_bfloat16;

constexpr int TILE = 64;          // output rows and columns of a block
constexpr int KT = 16;            // k a slice stages a step
constexpr int ST = 64;            // threads of a slice
constexpr int PITCH = TILE + 4;   // a staged k row: float4 aligned, banks spread
constexpr int STAGE = 2 * KT * PITCH;           // a slice's A and B step tiles
constexpr int SLICE = STAGE > TILE * TILE ? STAGE : TILE * TILE;  // or its partials

// Dynamic shared memory (bytes): the carries, then each slice's region
// (kernels/qmatmul.py mirrors this).
__host__ __device__ constexpr int smem_bytes(int slices) {
  return (TILE * TILE + slices * SLICE) * 4;
}

// One operand as a (mn) x (k) matrix: A[m, k] or B[k, n] seen as [n, k];
// element (mn, k) at p[mn * s_mn + k * s_k].
struct Op {
  const void* p;
  long long s_mn, s_k;
  int ext;    // extent along mn
  int kfast;  // 16-byte pieces along k, else along mn
  int vec;    // 16-byte loads allowed
};

struct Args {
  Op a, b;
  float* C;  // [M, N] row-major
  int M, N, K, chunk;
  QFmt qacc;
};

__device__ __forceinline__ unsigned bits(const float* p, long long i) {
  return __float_as_uint(p[i]);
}
__device__ __forceinline__ unsigned bits(const bf* p, long long i) {
  return __bfloat16_as_ushort(p[i]);
}

// element e of a 16-byte piece of T, as f32 (bf16 widened exactly)
template <typename T>
__device__ __forceinline__ float value(const unsigned (&w)[4], int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else {
    return __uint_as_float(((w[e >> 1] >> ((e & 1) * 16)) & 0xffffu) << 16);
  }
}

// The 16-byte piece of T whose first element is (mn, k): PER elements
// along the operand's fast axis, valid below kend (the chunk's end) and
// ext; zeros past them.
template <typename T>
__device__ __forceinline__ uint4 fetch_piece(const Op& o, int mn, int k, int kend) {
  constexpr int PER = 16 / (int)sizeof(T);
  const T* base = static_cast<const T*>(o.p);
  const int nv = o.kfast ? (mn < o.ext ? min(max(kend - k, 0), PER) : 0)
                         : (k < kend ? min(max(o.ext - mn, 0), PER) : 0);
  if (o.vec && nv == PER)
    return __ldg(reinterpret_cast<const uint4*>(base + (long long)mn * o.s_mn +
                                                (long long)k * o.s_k));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    if (e >= nv) break;
    const long long off = o.kfast ? (long long)mn * o.s_mn + (long long)(k + e) * o.s_k
                                  : (long long)(mn + e) * o.s_mn + (long long)k * o.s_k;
    w[e / (PER / 4)] |= bits(base, off) << ((e % (PER / 4)) * (32 / (PER / 4)));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// First element (mn, k) of a thread's piece i of a TILE x KT step tile
template <typename T>
__device__ __forceinline__ void piece_at(const Op& o, int u, int& mn, int& k) {
  constexpr int PER = 16 / (int)sizeof(T);
  if (o.kfast) {
    mn = u / (KT / PER);
    k = (u % (KT / PER)) * PER;
  } else {
    k = u / (TILE / PER);
    mn = (u % (TILE / PER)) * PER;
  }
}

// Store a landed piece into the step tile X[k][mn] as f32
template <typename T>
__device__ __forceinline__ void put_piece(const Op& o, uint4 v, int mn, int k, float* X) {
  constexpr int PER = 16 / (int)sizeof(T);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  if (o.kfast) {
#pragma unroll
    for (int e = 0; e < PER; ++e) X[(k + e) * PITCH + mn] = value<T>(w, e);
  } else {
#pragma unroll
    for (int e = 0; e < PER; e += 4)
      *reinterpret_cast<float4*>(X + k * PITCH + mn + e) =
          make_float4(value<T>(w, e), value<T>(w, e + 1), value<T>(w, e + 2),
                      value<T>(w, e + 3));
  }
}

__device__ __forceinline__ void slice_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(ST) : "memory");
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(4 * ST) qmatmul_kernel(const __grid_constant__ Args p) {
  constexpr int NA = TILE * KT * (int)sizeof(TA) / 16 / ST;  // pieces a thread
  constexpr int NB = TILE * KT * (int)sizeof(TB) / 16 / ST;
  extern __shared__ __align__(16) float sm[];
  const int S = blockDim.x / ST, s = threadIdx.x / ST, st = threadIdx.x % ST;
  const int tx = st % 8, ty = st / 8;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  float* Cs = sm;  // the carries [TILE][TILE]
  float* X = sm + TILE * TILE + s * SLICE;
  float* As = X;  // [KT][PITCH], then the round's partials [TILE][TILE]
  float* Bs = X + KT * PITCH;
  for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x) Cs[i] = 0.0f;

  const int nc = (int)(((long long)p.K + p.chunk - 1) / p.chunk);
  const int spc = (p.chunk + KT - 1) / KT;  // steps a chunk (the last may pad)
  const int rounds = (nc + S - 1) / S;
  const int mine = s < nc ? (nc - 1 - s) / S + 1 : 0;  // chunks of this slice
  const int steps = mine * spc;

  uint4 ra[NA], rb[NB];
  auto fetch = [&](int t) {  // the slice's step t: chunk s + (t / spc) * S
    const long long kc = (long long)(s + (t / spc) * S) * p.chunk;
    const int k0 = (int)(kc + (t % spc) * KT);
    const int kend = (int)min(kc + p.chunk, (long long)p.K);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      int mn, k;
      piece_at<TA>(p.a, st + i * ST, mn, k);
      ra[i] = fetch_piece<TA>(p.a, m0 + mn, k0 + k, kend);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      int mn, k;
      piece_at<TB>(p.b, st + i * ST, mn, k);
      rb[i] = fetch_piece<TB>(p.b, n0 + mn, k0 + k, kend);
    }
  };

  if (steps > 0) fetch(0);
  int t = 0;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    if (r < mine) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
      for (int j = 0; j < spc; ++j, ++t) {
        slice_sync(1 + s);  // the previous step's reads are done
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          int mn, k;
          piece_at<TA>(p.a, st + i * ST, mn, k);
          put_piece<TA>(p.a, ra[i], mn, k, As);
        }
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          int mn, k;
          piece_at<TB>(p.b, st + i * ST, mn, k);
          put_piece<TB>(p.b, rb[i], mn, k, Bs);
        }
        slice_sync(1 + s);
        if (t + 1 < steps) fetch(t + 1);  // in flight during the FMAs below
        const float4* A4 = reinterpret_cast<const float4*>(As);
        const float4* B4 = reinterpret_cast<const float4*>(Bs);
#pragma unroll 1
        for (int k = 0; k < KT; ++k) {
          const float4 a0 = A4[k * (PITCH / 4) + ty], a1 = A4[k * (PITCH / 4) + 8 + ty];
          const float4 b0 = B4[k * (PITCH / 4) + tx], b1 = B4[k * (PITCH / 4) + 8 + tx];
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) acc[i][jj] = __fmaf_rn(a[i], b[jj], acc[i][jj]);
        }
      }
      slice_sync(1 + s);  // the step tiles are free to take the partials
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = (i >> 2) * 32 + ty * 4 + (i & 3);
        float4* P4 = reinterpret_cast<float4*>(X + row * TILE);
        P4[tx] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        P4[8 + tx] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
    __syncthreads();  // the round's partials are in place
    const int nr = min(S, nc - r * S);
    for (int o = threadIdx.x; o < TILE * TILE; o += blockDim.x) {
      float c = Cs[o];
      for (int q = 0; q < nr; ++q)
        c = quantize_rne(__fadd_rn(c, sm[TILE * TILE + q * SLICE + o]), p.qacc);
      Cs[o] = c;
    }
    __syncthreads();  // the regions are free for the next round's steps
  }
  for (int o = threadIdx.x; o < TILE * TILE; o += blockDim.x) {
    const int gm = m0 + o / TILE, gn = n0 + o % TILE;
    if (gm < p.M && gn < p.N) p.C[(long long)gm * p.N + gn] = Cs[o];
  }
}

// The operand descriptor for T elements: pieces run along k where k is
// the contiguous axis; 16-byte loads need a 16-byte aligned base and
// pitch and, along k, chunks that start on a piece.
template <typename T>
Op operand(const void* p, long long s_mn, long long s_k, int ext, int chunk) {
  const long long E = sizeof(T);
  Op o{p, s_mn, s_k, ext, s_k == 1 && s_mn != 1, 0};
  const long long fast = o.kfast ? s_k : s_mn, pitch = o.kfast ? s_mn : s_k;
  o.vec = fast == 1 && reinterpret_cast<unsigned long long>(p) % 16 == 0 &&
          (pitch * E) % 16 == 0 && (!o.kfast || ((long long)chunk * E) % 16 == 0);
  return o;
}

bool valid_slices(int slices) { return slices == 1 || slices == 2 || slices == 4; }

template <typename TA, typename TB>
int set_smem(int slices) {
  return static_cast<int>(cudaFuncSetAttribute(
      qmatmul_kernel<TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(slices)));
}

template <typename TA, typename TB>
int launch(const void* A, long long sam, long long sak, const void* B, long long sbk,
           long long sbn, float* C, int M, int N, int K, int chunk, QFmt qacc, int slices,
           cudaStream_t s) {
  if (!valid_slices(slices)) return static_cast<int>(cudaErrorInvalidValue);
  const Args p{operand<TA>(A, sam, sak, M, chunk), operand<TB>(B, sbn, sbk, N, chunk), C, M,
               N, K, chunk, qacc};
  int rc = set_smem<TA, TB>(slices);
  if (rc != 0) return rc;
  dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  qmatmul_kernel<TA, TB><<<grid, slices * ST, smem_bytes(slices), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TB>
int occupancy(int slices) {
  if (!valid_slices(slices)) return -static_cast<int>(cudaErrorInvalidValue);
  int rc = set_smem<TA, TB>(slices), n = 0;
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, qmatmul_kernel<TA, TB>, slices * ST, smem_bytes(slices)));
  return rc != 0 ? -rc : n;
}

// f(TA, TB) over the operand types (bf16 flags)
template <typename F>
int by_types(int a_bf16, int b_bf16, F f) {
  if (a_bf16 && b_bf16) return f(bf{}, bf{});
  if (a_bf16) return f(bf{}, float{});
  if (b_bf16) return f(float{}, bf{});
  return f(float{}, float{});
}

}  // namespace

// Dynamic shared memory of one block (bytes) and resident blocks an SM at
// `slices` chunk slices (or a negative error); kernels/qmatmul.py mirrors
// the first.
extern "C" int qmatmul_smem(int slices) { return smem_bytes(slices); }
extern "C" int qmatmul_occupancy(int a_bf16, int b_bf16, int slices) {
  return by_types(a_bf16, b_bf16, [&](auto ta, auto tb) {
    return occupancy<decltype(ta), decltype(tb)>(slices);
  });
}

// A[m, k] = A[m * sam + k * sak], B[k, n] = B[k * sbk + n * sbn] (element
// strides; *_bf16 = 1 for bf16, 0 for f32); C (M, N) f32 row-major;
// slices: chunk slices a block (1, 2 or 4; kernels/qmatmul.py picks them).
// Returns the cudaError_t of the launch.
extern "C" int qmatmul(const void* A, int a_bf16, long long sam, long long sak,
                       const void* B, int b_bf16, long long sbk, long long sbn, void* C,
                       int M, int N, int K, int chunk, int c_identity, int c_shift,
                       float c_max, float c_min, int slices, void* stream) {
  const QFmt qacc{c_identity, c_shift, c_max, c_min};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(C);
  return by_types(a_bf16, b_bf16, [&](auto ta, auto tb) {
    return launch<decltype(ta), decltype(tb)>(A, sam, sak, B, sbk, sbn, out, M, N, K, chunk,
                                              qacc, slices, s);
  });
}
