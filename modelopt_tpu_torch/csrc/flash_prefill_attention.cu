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
// by the hardware cvt of cuda_fp8.h); score products of
// bf16 values summed in f32 and scaled by 1/sqrt(D); keys past the query's
// absolute position start + t get -1e9; softmax in f32; PV with bf16
// probabilities and f32 sums. The Pallas kernel holds the whole cache row
// of a head in VMEM and normalizes before the PV product; 227 KB of shared
// memory cannot hold S = 2176 keys of D = 128, so this kernel runs an online
// softmax over 64-key tiles and divides at the end. The two differ by the
// bf16 rounding of the probabilities (about 2^-8 relative).
//
// What bounds it on an H100: at a 512-token chunk, the multiply-adds of the
// two products (4 * rows * keys * D); this first version runs them in f32
// on the CUDA cores, not on the bf16 tensor cores.
//
// Design: rows are the flattened (t, g) query rows of one (slot, KV head),
// so grouped-query heads share every K/V tile. One CTA of 256 threads per
// (slot * KV head, 64-row tile); a loop over 64-key tiles that stops after
// the tile's last query position (causal skipping); Q, K, V and the score
// tile live in shared memory as f32 (116 KB), each thread holds a 4 x 4
// score tile and a 4 x 8 output tile in registers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int QP = D + 1;   // padded row pitch (floats) of the Q and K tiles
constexpr int PP = BK + 1;  // padded row pitch of the score tile
constexpr int NT = 256;
constexpr size_t SMEM_FLOATS = (size_t)BQ * QP + (size_t)BK * QP + (size_t)BK * D +
                               (size_t)BQ * PP + 3 * BQ;

template <typename CT>
__device__ __forceinline__ float load_kv(const CT* p, float scale) {
  if constexpr (std::is_same<CT, int8_t>::value)
    return __bfloat162float(__float2bfloat16((float)*p * scale));
  else if constexpr (std::is_same<CT, __nv_fp8_e4m3>::value)
    return __bfloat162float(__float2bfloat16(static_cast<float>(*p) * scale));
  else
    return __bfloat162float(*p);
}

template <typename CT>
__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const CT* __restrict__ ck,
                     const CT* __restrict__ cv, const int* __restrict__ start,
                     const float* __restrict__ kscale, const float* __restrict__ vscale,
                     float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16,
                     int T, int S, int KH, int G, float sm_scale) {
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][QP]
  float* Ks = Qs + BQ * QP;    // [BK][QP]
  float* Vs = Ks + BK * QP;    // [BK][D]
  float* Ps = Vs + BK * D;     // [BQ][PP]
  float* rm = Ps + BQ * PP;    // [BQ] running max
  float* rl = rm + BQ;         // [BQ] running sum
  float* ra = rl + BQ;         // [BQ] rescale factor of the current tile

  const int bh = blockIdx.y;
  const int b = bh / KH, h = bh % KH;
  const int rows = T * G;
  const int r0 = blockIdx.x * BQ;
  const int st = start[b];
  const int KHD = KH * D;
  const float ks = kscale != nullptr ? *kscale : 1.f;
  const float vs = vscale != nullptr ? *vscale : 1.f;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int i = idx / D, d = idx % D;
    const int r = r0 + i;
    float v = 0.f;
    if (r < rows) {
      const int t = r / G, g = r % G;
      v = __bfloat162float(q[(((size_t)b * T + t) * KH + h) * G * D + (size_t)g * D + d]);
    }
    Qs[i * QP + d] = v;
  }
  for (int i = tid; i < BQ; i += NT) {
    rm[i] = -1e30f;
    rl[i] = 0.f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  const int rlast = min(r0 + BQ, rows) - 1;
  const int kend = st + rlast / G;  // last key any row of this tile attends
  const CT* kb = ck + (size_t)b * S * KHD + h * D;
  const CT* vb = cv + (size_t)b * S * KHD + h * D;

  for (int k0 = 0; k0 <= kend && k0 < S; k0 += BK) {
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < S) {
        kv = load_kv(kb + (size_t)key * KHD + d, ks);
        vv = load_kv(vb + (size_t)key * KHD + d, vs);
      }
      Ks[j * QP + d] = kv;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = st + (r0 + row) / G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        Ps[row * PP + tx + 16 * j] =
            (key <= qpos && key < S) ? s[i][j] * sm_scale : -1e9f;
      }
    }
    __syncthreads();

    {  // online softmax: 4 lanes per row
      const int row = tid >> 2, part = tid & 3;
      float* pr = Ps + row * PP + part * 16;
      const float m_old = rm[row];
      float mx = -1e30f;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(pr[c] - m_new);
        sum += p;
        pr[c] = __bfloat162float(__float2bfloat16(p));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        ra[row] = alpha;
        rl[row] = rl[row] * alpha + sum;
        rm[row] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = ra[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * PP + j];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const int r = r0 + row;
    if (r >= rows) continue;
    const int t = r / G, g = r % G;
    const float l = fmaxf(rl[row], 1e-30f);
    const size_t o = (((size_t)b * T + t) * KH + h) * G * D + (size_t)g * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float v = acc[i][c] / l;
      if (out_bf16 != nullptr)
        out_bf16[o + tx + 16 * c] = __float2bfloat16(v);
      else
        out_f32[o + tx + 16 * c] = v;
    }
  }
}

template <typename CT>
int launch(const void* q, const void* ck, const void* cv, const void* start,
           const void* kscale, const void* vscale, void* out_f32, void* out_bf16,
           int B, int T, int S, int KH, int G, float sm_scale, cudaStream_t s) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_prefill_kernel<CT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T * G + BQ - 1) / BQ, B * KH);
  flash_prefill_kernel<CT><<<grid, NT, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const CT*>(ck),
      static_cast<const CT*>(cv), static_cast<const int*>(start),
      static_cast<const float*>(kscale), static_cast<const float*>(vscale),
      static_cast<float*>(out_f32), static_cast<__nv_bfloat16*>(out_bf16), T, S, KH,
      G, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q bf16 [B, T, KH, G, 128]; caches [B, S, KH*128] of bf16 (cache_kind 0,
// null scales), int8 (1) or e4m3 (2) codes with device scalar scales; start
// int32 [B]; the output has q's layout, f32 or bf16 (exactly one pointer
// non-null).
extern "C" int flash_prefill_attention(const void* q, const void* ck, const void* cv,
                                       const void* start, const void* kscale,
                                       const void* vscale, void* out_f32,
                                       void* out_bf16, int B, int T, int S, int KH,
                                       int G, float sm_scale, int cache_kind,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_kind) {
    case 0:
      return launch<__nv_bfloat16>(q, ck, cv, start, kscale, vscale, out_f32, out_bf16, B,
                                   T, S, KH, G, sm_scale, s);
    case 1:
      return launch<int8_t>(q, ck, cv, start, kscale, vscale, out_f32, out_bf16, B, T,
                            S, KH, G, sm_scale, s);
    case 2:
      return launch<__nv_fp8_e4m3>(q, ck, cv, start, kscale, vscale, out_f32, out_bf16, B,
                                   T, S, KH, G, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
