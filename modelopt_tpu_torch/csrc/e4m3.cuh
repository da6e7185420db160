// e4m3 (float8_e4m3fn) KV-cache codes as the attention kernels read them.
//
// The reference decodes cache codes by bit assembly
// (modelopt_tpu/kernels/attention.py::_e4m3_to_bf16): for a code with
// exponent field e and mantissa m, the f32 exponent field is e + 120 and the
// mantissa m << 20 when e > 0, and the value is m * 2^-9 when e == 0; the
// sign bit goes on top. Every code decodes to a number, 0x7f and 0xff to
// +-480 (a float8_e4m3fn cast gives NaN there; the quantizer never writes
// them). Each value is exact in bf16 and f32.
//
// Weights and block scales (K8's e4m3 weights, K9's block scales) are
// float8_e4m3fn proper, whose NaN codes the quantizer never writes: they
// convert by the card's e4m3x2 -> f16x2 instruction (e4m3x2_to_bf16x2).
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
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

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// two e4m3 cache codes, in bytes 1 and 3 of r (bytes 0 and 2 are ignored) ->
// bf16x2, byte 1's value in the low half: the reference's decode of every
// code, 0x7f / 0xff to +-480 included. A code's exponent and mantissa
// fields shifted into a bf16's (sign apart) are 2^-120 times its value, a
// subnormal bf16 where the exponent field is 0, and one bf16 multiply by
// 2^120 gives the value exactly. A prmt puts any two bytes in place, so
// the latent cluster kernel builds its tensor-core operands from staged
// cache bytes with it (latent_decode.cuh).
__device__ __forceinline__ uint32_t e4m3_cache_pair(uint32_t r) {
  const uint32_t t = ((r >> 4) & 0x07F007F0u) | (r & 0x80008000u);  // 2^-120 x, in bf16
  return bits(__hmul2(as_bf16x2(t), as_bf16x2(0x7B807B80u)));        // x 2^120
}

// two float8_e4m3fn codes (the low 16 bits of p, not NaN) -> bf16x2, exact:
// the card's e4m3x2 -> f16x2 conversion (exact; every e4m3 value is a
// normal f16 or zero), then the f16 bits less their three low mantissa
// zeros, sign apart, are the bf16 of 2^-112 times the value (a normal bf16),
// and one bf16 multiply by 2^112 gives the value
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t p) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(p & 0xFFFF), __NV_E4M3);
  const uint32_t hb = (uint32_t)h.x | ((uint32_t)h.y << 16);
  const uint32_t t = ((hb >> 3) & 0x0FFF0FFFu) | (hb & 0x80008000u);  // 2^-112 x, in bf16
  return bits(__hmul2(as_bf16x2(t), as_bf16x2(0x77807780u)));         // x 2^112
}
