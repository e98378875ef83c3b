// The share of 64-term chunk partials where a bf16 mma.sync
// (m16n8k16, f32 accumulate, 4 k-groups chained through C) differs from the
// sequential f32 FMA chain the kernels' contract fixes.
#include <cuda_bf16.h>
#include <stdint.h>

// A [M, K] bf16 row-major, B [K, N] bf16 row-major; out_mma, out_fma [nchunks, M, N]
__global__ void mma_vs_fma(const __nv_bfloat16* A, const __nv_bfloat16* B, int M, int N, int K,
                           float* out_mma, float* out_fma) {
  const int lane = threadIdx.x & 31;
  const int tile_m = blockIdx.y * 16, tile_n = blockIdx.x * 8, chunk = blockIdx.z;
  const int g = lane >> 2, t = lane & 3;
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
  for (int kg = 0; kg < 4; ++kg) {
    const int k0 = chunk * 64 + kg * 16;
    auto a = [&](int r, int c) { return A[(long long)(tile_m + r) * K + k0 + c]; };
    auto b = [&](int r, int c) { return B[(long long)(k0 + r) * N + tile_n + c]; };
    __nv_bfloat162 a01 = __halves2bfloat162(a(g, t * 2), a(g, t * 2 + 1));
    __nv_bfloat162 a23 = __halves2bfloat162(a(g + 8, t * 2), a(g + 8, t * 2 + 1));
    __nv_bfloat162 a45 = __halves2bfloat162(a(g, t * 2 + 8), a(g, t * 2 + 9));
    __nv_bfloat162 a67 = __halves2bfloat162(a(g + 8, t * 2 + 8), a(g + 8, t * 2 + 9));
    __nv_bfloat162 b01 = __halves2bfloat162(b(t * 2, g), b(t * 2 + 1, g));
    __nv_bfloat162 b23 = __halves2bfloat162(b(t * 2 + 8, g), b(t * 2 + 9, g));
    const unsigned ra0 = *reinterpret_cast<unsigned*>(&a01), ra1 = *reinterpret_cast<unsigned*>(&a23);
    const unsigned ra2 = *reinterpret_cast<unsigned*>(&a45), ra3 = *reinterpret_cast<unsigned*>(&a67);
    const unsigned rb0 = *reinterpret_cast<unsigned*>(&b01), rb1 = *reinterpret_cast<unsigned*>(&b23);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "r"(ra0), "r"(ra1), "r"(ra2), "r"(ra3), "r"(rb0), "r"(rb1));
  }
  const long long base = (long long)chunk * M * N;
  const int r0 = tile_m + g, c0 = tile_n + t * 2;
  out_mma[base + (long long)r0 * N + c0] = d0;
  out_mma[base + (long long)r0 * N + c0 + 1] = d1;
  out_mma[base + (long long)(r0 + 8) * N + c0] = d2;
  out_mma[base + (long long)(r0 + 8) * N + c0 + 1] = d3;
  // the FMA chain for the same 4 outputs
  for (int o = 0; o < 4; ++o) {
    const int r = r0 + (o >> 1) * 8, c = c0 + (o & 1);
    float part = 0.f;
    for (int k = chunk * 64; k < chunk * 64 + 64; ++k)
      part = __fmaf_rn(__bfloat162float(A[(long long)r * K + k]), __bfloat162float(B[(long long)k * N + c]), part);
    out_fma[base + (long long)r * N + c] = part;
  }
}

extern "C" int run(const void* A, const void* B, int M, int N, int K, void* om, void* of) {
  dim3 grid(N / 8, M / 16, K / 64);
  mma_vs_fma<<<grid, 32>>>(static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B),
                           M, N, K, static_cast<float*>(om), static_cast<float*>(of));
  return (int)cudaGetLastError();
}
