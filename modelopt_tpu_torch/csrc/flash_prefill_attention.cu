// Cached-prefill flash attention for Hopper (sm_90a): the queries of one
// prompt chunk against the slot's whole KV cache, which already holds the
// chunk's own keys at rows [start, start + T).
//
// Replaces: modelopt_tpu/kernels/flash_attention.py::flash_prefill_attention
// (Pallas body _flash_prefill_kernel).
//
// Numerics follow the Pallas kernel: q rounds to bf16; int8 and e4m3 cache
// codes dequantize as (code * scale in f32) rounded to bf16, once per element
// of a tile (an e4m3 code converts as the reference's astype(float32) does,
// by the hardware cvt of cuda_fp8.h); score products of bf16 values summed
// in f32 and scaled by 1/sqrt(D); keys past the query's absolute position
// start + t get -1e9; softmax in f32; PV with bf16 probabilities and f32
// sums. The Pallas kernel holds the whole cache row of a head in VMEM and
// normalizes before the PV product; shared memory cannot hold S = 2176 keys
// of D = 128, so this kernel runs an online softmax over 64-key tiles and
// divides at the end. The two differ by the bf16 rounding of the
// probabilities (about 2^-8 relative) and the order of the f32 sums.
//
// What bounds it on an H100: operations, the multiply-adds of the two
// products (4 * rows * keys * D; 7.36 us at a 544-row chunk from start 544,
// KH = 8, G = 4). The first version ran them in f32 on the CUDA cores at
// ~9 TFLOP/s.
//
// Design: the tensor-core tile of csrc/flash_tile.cuh. One CTA of 4 warps
// per (64-row tile, slot * KV head), row tiles issued heaviest (last) first;
// both products on bf16 mma.sync with f32 sums, the softmax in registers;
// bf16 caches stream through cp.async, int8 / e4m3 codes are dequantized
// into the double-buffered bf16 tile one tile ahead; only tiles that reach
// past a row's position (or the cache) are masked. Left for a later PR: a
// wgmma + TMA warp-specialised version (FA3's shape) and an fp8 PV product.
#include "flash_tile.cuh"

namespace {

using namespace flash_tile;
constexpr int D = 128;

template <int KIND, bool OUT_F32>
__global__ void __launch_bounds__(NT, 2)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ ck,
                     const void* __restrict__ cv, const int* __restrict__ start,
                     const float* __restrict__ kscale, const float* __restrict__ vscale,
                     void* __restrict__ out, int T, int S, int KH, int G, float sm_scale) {
  const int b = blockIdx.x / KH, h = blockIdx.x % KH;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the most keys first
  Args a{q, ck, cv, out, kscale != nullptr ? *kscale : 1.f,
         vscale != nullptr ? *vscale : 1.f, T, S, KH, G, sm_scale};
  attend<D, KIND, false, OUT_F32>(a, b, h, r0, start[b], PrefillMask{S});
}

template <int KIND, bool OUT_F32>
int launch(const void* q, const void* ck, const void* cv, const void* start,
           const void* kscale, const void* vscale, void* out, int B, int T, int S, int KH,
           int G, float sm_scale, cudaStream_t s) {
  static unsigned smem_set = 0;
  constexpr int smem = smem_bytes<D>();
  int e = allow_smem(flash_prefill_kernel<KIND, OUT_F32>, smem, smem_set);
  if (e != 0) return e;
  dim3 grid(B * KH, (T * G + BQ - 1) / BQ);
  flash_prefill_kernel<KIND, OUT_F32><<<grid, NT, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), ck, cv, static_cast<const int*>(start),
      static_cast<const float*>(kscale), static_cast<const float*>(vscale), out, T, S, KH,
      G, sm_scale);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_out(const void* q, const void* ck, const void* cv, const void* start,
               const void* kscale, const void* vscale, void* out_f32, void* out_bf16, int B,
               int T, int S, int KH, int G, float sm_scale, cudaStream_t s) {
  if (out_f32 != nullptr)
    return launch<KIND, true>(q, ck, cv, start, kscale, vscale, out_f32, B, T, S, KH, G,
                              sm_scale, s);
  return launch<KIND, false>(q, ck, cv, start, kscale, vscale, out_bf16, B, T, S, KH, G,
                             sm_scale, s);
}

}  // namespace

// q bf16 [B, T, KH, G, 128]; caches [B, S, KH*128] of bf16 (cache_kind 0,
// null scales), int8 (1) or e4m3 (2) codes with device scalar scales; start
// int32 [B]; the output has q's layout, f32 or bf16 (exactly one pointer
// non-null). Every pointer 16-byte aligned.
extern "C" int flash_prefill_attention(const void* q, const void* ck, const void* cv,
                                       const void* start, const void* kscale,
                                       const void* vscale, void* out_f32,
                                       void* out_bf16, int B, int T, int S, int KH,
                                       int G, float sm_scale, int cache_kind,
                                       void* stream) {
  if (B * KH * T * G == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_kind) {
    case KV_BF16:
      return launch_out<KV_BF16>(q, ck, cv, start, kscale, vscale, out_f32, out_bf16, B, T,
                                 S, KH, G, sm_scale, s);
    case KV_INT8:
      return launch_out<KV_INT8>(q, ck, cv, start, kscale, vscale, out_f32, out_bf16, B, T,
                                 S, KH, G, sm_scale, s);
    case KV_E4M3:
      return launch_out<KV_E4M3>(q, ck, cv, start, kscale, vscale, out_f32, out_bf16, B, T,
                                 S, KH, G, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
