// G and E: fused quantized GEMM with a chunked (1, e_acc, m_acc) carry.
//
// G replaces repro/kernels/fused.py::_fused_kernel (RNE carry, f32 or bf16
// operands, no out_fmt/pack_out epilogue); E replaces
// repro/kernels/fused.py::_fused_kernel_emitq, the training forward: the
// same GEMM plus the int8 codes of Q(A) [M, K] and Q(B) [K, N] for the
// backward.  C[M,N] = sum over chunks of carry = q_acc(carry + Q(A_chunk) .
// Q(B_chunk)), chunk = the plan's n1; the tile loop is qgemm_core.cuh's.
//
// E writes each code once, on its block's first visit: the blocks of
// column tile 0 write the A codes of their rows, the blocks of row tile 0
// the B codes of their columns (fused.py's pl.when on the orthogonal grid
// axis), straight from the quantized value the block stores to shared
// memory.  The codes add M*K + K*N bytes of writes to the GEMM's traffic.
//
// Bound on the H100: at decode (M = 8) the weights' bytes (each weight read
// once); at training (M = 512 tokens) the f32 arithmetic on the CUDA cores,
// since this simple design does not use the tensor cores.
#include "qgemm_core.cuh"

namespace {

using bf = __nv_bfloat16;

template <int BM, int BN, int TM, int TN, int KT, int NT, bool EMIT,
          typename TA, typename TB>
__global__ void __launch_bounds__(NT) qgemm_kernel(qcore::Args<TA, TB> p) {
  __shared__ float As[KT][BM + 1];  // +1 pad: stores along k hit distinct banks
  __shared__ float Bs[KT][BN + 1];
  qcore::tile<BM, BN, TM, TN, KT, NT, EMIT>(p, blockIdx.y * BM, blockIdx.x * BN,
                                            blockIdx.x == 0, blockIdx.y == 0,
                                            As, Bs);
}

template <int BM, int BN, int TM, int TN, int KT, int NT, bool EMIT,
          typename TA, typename TB>
void launch(const void* A, long long sam, long long sak, const void* B,
            long long sbk, long long sbn, float* C, int M, int N, int K,
            int chunk, QFmt qr, int qa, int qb, QFmt qacc, int8_t* Aq,
            int8_t* Bq, qcore::Dec enc, cudaStream_t s) {
  qcore::Args<TA, TB> p{static_cast<const TA*>(A), sam, sak,
                        static_cast<const TB*>(B), sbk, sbn, C, N, nullptr,
                        M, N, K, chunk, qr, qa, qb, qcore::Dec{8, 23}, qacc,
                        Aq, Bq, enc};
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qgemm_kernel<BM, BN, TM, TN, KT, NT, EMIT, TA, TB><<<grid, NT, 0, s>>>(p);
}

template <int BM, int BN, int TM, int TN, int KT, int NT, bool EMIT>
void dispatch(const void* A, int a_bf16, long long sam, long long sak,
              const void* B, int b_bf16, long long sbk, long long sbn,
              float* C, int M, int N, int K, int chunk, QFmt qr, int qa,
              int qb, QFmt qacc, int8_t* Aq, int8_t* Bq, qcore::Dec enc,
              cudaStream_t s) {
#define QGEMM_ARGS A, sam, sak, B, sbk, sbn, C, M, N, K, chunk, qr, qa, qb, qacc, Aq, Bq, enc, s
  if (a_bf16 && b_bf16)
    launch<BM, BN, TM, TN, KT, NT, EMIT, bf, bf>(QGEMM_ARGS);
  else if (a_bf16)
    launch<BM, BN, TM, TN, KT, NT, EMIT, bf, float>(QGEMM_ARGS);
  else if (b_bf16)
    launch<BM, BN, TM, TN, KT, NT, EMIT, float, bf>(QGEMM_ARGS);
  else
    launch<BM, BN, TM, TN, KT, NT, EMIT, float, float>(QGEMM_ARGS);
#undef QGEMM_ARGS
}

template <bool EMIT>
int run(const void* A, int a_bf16, long long sam, long long sak,
        const void* B, int b_bf16, long long sbk, long long sbn, void* C,
        int M, int N, int K, int chunk, QFmt qr, int quant_a, int quant_b,
        QFmt qacc, int8_t* Aq, int8_t* Bq, qcore::Dec enc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(C);
  if (M <= 8)  // decode: one 8-row tile, 64 columns per block
    dispatch<8, 64, 1, 2, 32, 256, EMIT>(A, a_bf16, sam, sak, B, b_bf16, sbk, sbn, out, M, N, K, chunk, qr, quant_a, quant_b, qacc, Aq, Bq, enc, s);
  else
    dispatch<64, 64, 4, 4, 32, 256, EMIT>(A, a_bf16, sam, sak, B, b_bf16, sbk, sbn, out, M, N, K, chunk, qr, quant_a, quant_b, qacc, Aq, Bq, enc, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G.  Strides are in elements.  Returns the cudaError_t of the launch.
extern "C" int qgemm(const void* A, int a_bf16, long long sam, long long sak,
                     const void* B, int b_bf16, long long sbk, long long sbn,
                     void* C, int M, int N, int K, int chunk,
                     int r_identity, int r_shift, float r_max, float r_min,
                     int quant_a, int quant_b,
                     int c_identity, int c_shift, float c_max, float c_min,
                     void* stream) {
  return run<false>(A, a_bf16, sam, sak, B, b_bf16, sbk, sbn, C, M, N, K,
                    chunk, QFmt{r_identity, r_shift, r_max, r_min}, quant_a,
                    quant_b, QFmt{c_identity, c_shift, c_max, c_min}, nullptr,
                    nullptr, qcore::Dec{8, 23}, stream);
}

// E: G with both operands quantized to the (1, e_r, m_r) representation
// format, plus their int8 codes Aq [M, K] and Bq [K, N] (row-major).
extern "C" int qgemm_emitq(const void* A, int a_bf16, long long sam,
                           long long sak, const void* B, int b_bf16,
                           long long sbk, long long sbn, void* C, int M,
                           int N, int K, int chunk, int e_r, int m_r,
                           int r_identity, int r_shift, float r_max,
                           float r_min, int c_identity, int c_shift,
                           float c_max, float c_min, void* Aq, void* Bq,
                           void* stream) {
  return run<true>(A, a_bf16, sam, sak, B, b_bf16, sbk, sbn, C, M, N, K,
                   chunk, QFmt{r_identity, r_shift, r_max, r_min}, 1, 1,
                   QFmt{c_identity, c_shift, c_max, c_min},
                   static_cast<int8_t*>(Aq), static_cast<int8_t*>(Bq),
                   qcore::Dec{e_r, m_r}, stream);
}
