// G: fused quantized GEMM with a chunked (1, e_acc, m_acc) carry, the
// serving path's GEMM (decode, prefill slabs, the tied lm_head) and the
// training step's lm_head forward.
//
// G replaces repro/kernels/fused.py::_fused_kernel (RNE carry, f32 or bf16
// operands, no out_fmt/pack_out epilogue).  C[M,N] = sum over chunks of
// carry = q_acc(carry + Q(A_chunk) . Q(B_chunk)), chunk = the plan's n1;
// the tile loop is qgemm_core.cuh's.
//
// Bound on the H100: at decode (M = 8) the weights' bytes (each weight read
// once); at larger M the f32 arithmetic on the CUDA cores, since the
// bitwise contract keeps the tensor cores out (qgemm_sm90.cuh).
#include "qgemm_core.cuh"

namespace {

using bf = __nv_bfloat16;

// The arguments stay in the kernel's parameter space (__grid_constant__).
// Passed by value, nvcc 12.9 built the 64 x 64 tile with 190-194 registers
// a thread (the decode tile with 128) against 101-126 (64-78), and G ran
// 1.26x slower at decode and 1.65x on the lm_head forward on the H100
// (tools/sm90/g_params.py).
template <int BM, int BN, int TM, int TN, int KT, int NT, typename TA, typename TB>
__global__ void __launch_bounds__(NT) qgemm_kernel(const __grid_constant__ qcore::Args<TA, TB> p) {
  __shared__ float As[KT][BM + 1];  // +1 pad: stores along k hit distinct banks
  __shared__ float Bs[KT][BN + 1];
  qcore::tile<BM, BN, TM, TN, KT, NT>(p, blockIdx.y * BM, blockIdx.x * BN, As, Bs);
}

template <int BM, int BN, int TM, int TN, int KT, int NT, typename TA, typename TB>
void launch(const void* A, long long sam, long long sak, const void* B,
            long long sbk, long long sbn, float* C, int M, int N, int K,
            int chunk, QFmt qr, int qa, int qb, QFmt qacc, cudaStream_t s) {
  qcore::Args<TA, TB> p{static_cast<const TA*>(A), sam, sak,
                        static_cast<const TB*>(B), sbk, sbn, C, N,
                        M, N, K, chunk, qr, qa, qb, qacc};
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qgemm_kernel<BM, BN, TM, TN, KT, NT, TA, TB><<<grid, NT, 0, s>>>(p);
}

template <int BM, int BN, int TM, int TN, int KT, int NT>
void dispatch(const void* A, int a_bf16, long long sam, long long sak,
              const void* B, int b_bf16, long long sbk, long long sbn,
              float* C, int M, int N, int K, int chunk, QFmt qr, int qa,
              int qb, QFmt qacc, cudaStream_t s) {
#define QGEMM_ARGS A, sam, sak, B, sbk, sbn, C, M, N, K, chunk, qr, qa, qb, qacc, s
  if (a_bf16 && b_bf16)
    launch<BM, BN, TM, TN, KT, NT, bf, bf>(QGEMM_ARGS);
  else if (a_bf16)
    launch<BM, BN, TM, TN, KT, NT, bf, float>(QGEMM_ARGS);
  else if (b_bf16)
    launch<BM, BN, TM, TN, KT, NT, float, bf>(QGEMM_ARGS);
  else
    launch<BM, BN, TM, TN, KT, NT, float, float>(QGEMM_ARGS);
#undef QGEMM_ARGS
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(C);
  const QFmt qr{r_identity, r_shift, r_max, r_min};
  const QFmt qacc{c_identity, c_shift, c_max, c_min};
  if (M <= 8)  // decode: one 8-row tile, 64 columns per block
    dispatch<8, 64, 1, 2, 32, 256>(A, a_bf16, sam, sak, B, b_bf16, sbk, sbn, out, M, N, K,
                                   chunk, qr, quant_a, quant_b, qacc, s);
  else
    dispatch<64, 64, 4, 4, 32, 256>(A, a_bf16, sam, sak, B, b_bf16, sbk, sbn, out, M, N, K,
                                    chunk, qr, quant_a, quant_b, qacc, s);
  return static_cast<int>(cudaGetLastError());
}
