// Device helpers shared by the Hopper kernels of repro_torch.
//
// Counterparts of repro/kernels/common.py::quantize_block (RNE branch),
// repro/quant/qtensor.py::unpack_block and the online-softmax constants of
// repro/kernels/attention.py.  Built without --use_fast_math and with
// --fmad=false, so every rounding below is the IEEE one the plain PyTorch
// versions perform.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// (1, e, m) quantizer constants, computed on the host (exact in f32).
struct QFmt {
  int identity;  // m >= 23 && e >= 8: quantization is the identity
  int shift;     // 23 - m: mantissa bits dropped
  float maxv;    // 2^(2^(e-1)-1) * (2 - 2^-m): saturation value
  float minn;    // 2^-(2^(e-1)-1): smallest normal; below flushes to 0
};

// Masked score: finite, so exp2f(NEG - m) is exactly 0 and a fully masked
// block never computes inf - inf.
#define REPRO_NEG (-1e30f)

// (1, e, m) round-to-nearest-even on the float's bits: saturating, flush to
// zero keeping the sign, NaN passed through.
__device__ __forceinline__ float quantize_rne(float x, const QFmt q) {
  if (q.identity) return x;
  unsigned xi = __float_as_uint(x) & 0x7fffffffu;  // |x| <= 0x7fffffff
  if (q.shift > 0) {
    const unsigned lsb = (xi >> q.shift) & 1u;
    xi = (xi + ((1u << (q.shift - 1)) - 1u + lsb)) & ~((1u << q.shift) - 1u);
  }
  float y = __uint_as_float(xi);
  if (isinf(x)) y = q.maxv;
  y = fminf(y, q.maxv);
  if (y < q.minn) y = 0.0f;
  if (signbit(x)) y = -y;
  return isnan(x) ? x : y;
}

// int8 code [sign | exponent field (e) | mantissa (m)] -> exact float;
// exponent field 0 is +-0.
__device__ __forceinline__ float unpack_code(int8_t code, int e, int m) {
  const unsigned c = (unsigned)(uint8_t)code;
  const unsigned sign = (c >> (e + m)) & 1u;
  const unsigned ef = (c >> m) & ((1u << e) - 1u);
  const unsigned man = c & ((1u << m) - 1u);
  const unsigned bias = (1u << (e - 1)) - 1u;
  const unsigned mag = ef ? (((ef + 126u - bias) << 23) | (man << (23 - m))) : 0u;
  return __uint_as_float((sign << 31) | mag);
}

// 2^se for an integer page scale exponent (|se| <= 120), exact.
__device__ __forceinline__ float exp2_int(int se) {
  return __uint_as_float((unsigned)(se + 127) << 23);
}

// limits of the attention kernels' shared-memory tiles (mirrored in
// repro_torch/kernels/attention.py)
#define ATTN_THREADS 128
#define MAX_DH 128
#define MAX_G 8
#define MAX_PAGE 32
