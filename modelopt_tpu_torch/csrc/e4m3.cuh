// e4m3 (float8_e4m3fn) KV-cache codes as the attention kernels read them.
//
// The reference decodes cache codes by bit assembly
// (modelopt_tpu/kernels/attention.py::_e4m3_to_bf16): for a code with
// exponent field e and mantissa m, the f32 exponent field is e + 120 and the
// mantissa m << 20 when e > 0, and the value is m * 2^-9 when e == 0; the
// sign bit goes on top. Every code decodes to a number, 0x7f and 0xff to
// +-480 (a float8_e4m3fn cast gives NaN there; the quantizer never writes
// them). Each value is exact in bf16 and f32.
#pragma once
#include <stdint.h>

// a cache element of one e4m3 code (the kernels' CT for e4m3 caches)
struct e4m3_t {
  uint8_t bits;
};

__device__ __forceinline__ float e4m3_to_f32(uint32_t b) {
  const uint32_t e = (b >> 3) & 0xFu, m = b & 0x7u;
  const uint32_t mag =
      e ? (((e + 120u) << 23) | (m << 20)) : __float_as_uint((float)m * 0.001953125f);
  return __uint_as_float(((b & 0x80u) << 24) | mag);
}
