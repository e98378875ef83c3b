// K2: elementwise (1, e, m) quantization, f32 or bf16 in, f32 out.
//
// Replaces repro/kernels/quantize.py::_quantize_kernel (quantize_pallas).
// Every element goes through quantize_rne (common.cuh): RNE on the float's
// bits, saturating, flush to zero keeping the sign, NaN passed through;
// bitwise repro_torch.kernels.common.quantize_block.  bf16 widens to f32
// exactly before the rounding.
//
// The TPU kernel streamed (rows, 128) tiles through VMEM.  Here each thread
// quantizes four neighbouring elements a step, loaded as one 16-byte (f32)
// or 8-byte (bf16) vector when the input is aligned, in a grid-stride loop;
// the tail (n mod 4) goes one element a thread.
//
// Bound on the H100: the bytes, n * (4 or 2) read and n * 4 written.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks an SM, then grid-stride

__device__ __forceinline__ float4 load4(const float* x, long long i) {
  return reinterpret_cast<const float4*>(x)[i];
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* x, long long i) {
  const uint2 raw = reinterpret_cast<const uint2*>(x)[i];
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

__device__ __forceinline__ float load1(const float* x, long long i) { return x[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) quantize_kernel(
    const T* __restrict__ x, float* __restrict__ y, long long n, int vec,
    QFmt q) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  float4* y4 = reinterpret_cast<float4*>(y);
  for (long long i = tid; i < n4; i += stride) {
    float4 v = load4(x, i);
    v.x = quantize_rne(v.x, q);
    v.y = quantize_rne(v.y, q);
    v.z = quantize_rne(v.z, q);
    v.w = quantize_rne(v.w, q);
    y4[i] = v;
  }
  for (long long i = n4 * 4 + tid; i < n; i += stride) y[i] = quantize_rne(load1(x, i), q);
}

}  // namespace

// x: n contiguous f32 (x_bf16 = 0) or bf16 values; y: n f32 (fresh, so
// 16-byte aligned).  vec = 1 when x is aligned for the vector loads.
// Returns the cudaError_t of the launch.
extern "C" int quantize(const void* x, int x_bf16, void* y, long long n,
                        int vec, int identity, int shift, float maxv,
                        float minn, void* stream) {
  const QFmt q{identity, shift, maxv, minn};
  const long long items = vec ? (n + 3) / 4 : n;
  const long long want = (items + THREADS - 1) / THREADS;
  const int blocks = (int)(want < MAX_BLOCKS ? (want > 0 ? want : 1) : MAX_BLOCKS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(y);
  if (x_bf16)
    quantize_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), out, n, vec, q);
  else
    quantize_kernel<float><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(x), out, n, vec, q);
  return static_cast<int>(cudaGetLastError());
}
