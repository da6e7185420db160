// Fused decode step for Hopper (sm_90a): write the new token's k/v row into
// the caches at pos[b] and attend the slot's G query rows of one KV head
// over keys [0, pos[b]] (the new token joins from registers).
//
// Replaces: modelopt_tpu/kernels/attention.py::fused_decode_attention
// (Pallas bodies _fused_decode_kernel and _attend_chunk).
//
// Numerics follow _attend_chunk exactly:
//  * keys are taken in chunks of 256 when S % 256 == 0, else as ONE chunk of
//    S; the running max, and with it the int8 probability codes, are taken
//    per chunk, so the chunk rule changes the result and is kept;
//  * int8 caches: q is rounded to bf16, then requantized per (head, group)
//    row to int8 with qmax = max|q_row|; scores are s8 x s8 -> s32 dots;
//    probabilities become 7-bit codes e8 = round(exp(s - m) * 127) and the
//    PV product is e8 x v8 -> s32 (both integer sums are exact, so their
//    order does not matter);
//  * bf16 and e4m3 caches: bf16 q x k with f32 sums, exp in f32, PV with
//    the probabilities rounded to bf16, the denominator from the f32
//    values; e4m3 codes are decoded exactly by the reference's bit assembly
//    (e4m3.cuh), k_scale rides in 1/sqrt(D) and v_scale on the output, as
//    for int8 (the reference's non-int8 branch of _attend_chunk; the 7-bit
//    probability codes are the int8 branch's alone);
//  * masked keys carry -1e30 (here they are simply not visited: their
//    exponentials are exactly 0);
//  * the new token scores in f32 against its unquantized codes (an e4m3
//    row through the same decode).
// A position past the cache (an idle slot at S) is clamped to S - 1, as the
// reference's CPU cache write clamps its start.
//
// What bounds it on an H100: bytes, the live K and V rows of every slot
// (2 * pos[b] * KH * D codes; one byte each for int8 and e4m3) over the
// 3.35 TB/s of HBM.
//
// Design: one CTA of 128 threads per (slot, KV head) holds that head's G
// query rows. For each live chunk it scores 16 keys at a time (8 lanes a
// key, 16-byte loads: one coalesced 128-byte int8 or e4m3 row per key, 256
// bytes of bf16), keeps the
// chunk's scores in shared memory (G * 2176 f32 = 34 KB at the serving
// length), takes the row max over the whole chunk, then one thread per
// head-dim column accumulates the PV product over the chunk's keys.
// Chunks past pos[b] are never read.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "e4m3.cuh"

namespace {

constexpr int D = 128;
constexpr int NT = 128;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(e4m3_t v) { return e4m3_to_f32(v.bits); }

template <int G>
__device__ __forceinline__ void block_max(float (&v)[G], float (*red)[NT / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[g] = fmaxf(v[g], __shfl_xor_sync(FULL, v[g], off));
    if (lane == 0) red[g][warp] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g)
    v[g] = fmaxf(fmaxf(red[g][0], red[g][1]), fmaxf(red[g][2], red[g][3]));
  __syncthreads();
}

template <int G, typename V>
__device__ __forceinline__ void block_sum(V (&v)[G], V (*red)[NT / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[g] += __shfl_xor_sync(FULL, v[g], off);
    if (lane == 0) red[g][warp] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) v[g] = (red[g][0] + red[g][1]) + (red[g][2] + red[g][3]);
  __syncthreads();
}

template <typename CT, int G>
__global__ void __launch_bounds__(NT)
fused_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const CT* __restrict__ knew, const CT* __restrict__ vnew,
                    CT* __restrict__ kc, CT* __restrict__ vc,
                    const int* __restrict__ pos, const float* __restrict__ kscale,
                    const float* __restrict__ vscale, float* __restrict__ out_f32,
                    __nv_bfloat16* __restrict__ out_bf16, int S, int KH, int chunk) {
  constexpr bool kInt8 = std::is_same<CT, int8_t>::value;
  extern __shared__ float sc[];  // [G][chunk]: scores, then exp / 7-bit codes
  __shared__ float sq[G][D];     // bf16-rounded q rows
  __shared__ int q8w[G][D / 4];  // int8 q codes, 4 to a word
  __shared__ float redf[G][NT / 32];
  __shared__ int redi[G][NT / 32];

  const int b = blockIdx.x / KH, h = blockIdx.x % KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KHD = KH * D;
  const int L = min(pos[b], S - 1);
  const float ks = kscale != nullptr ? *kscale : 1.f;
  const float vs = vscale != nullptr ? *vscale : 1.f;
  const float inv_sqrt_d = ks / sqrtf((float)D);
  const size_t qoff = (size_t)(b * KH + h) * G * D;

#pragma unroll
  for (int g = 0; g < G; ++g) sq[g][tid] = __bfloat162float(q[qoff + g * D + tid]);
  float fs[G];
  if constexpr (kInt8) {
    float a[G];
#pragma unroll
    for (int g = 0; g < G; ++g) a[g] = fabsf(sq[g][tid]);
    block_max<G>(a, redf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float qmax = fmaxf(a[g], 1e-30f);
      reinterpret_cast<int8_t*>(q8w[g])[tid] =
          (int8_t)(int)rintf(sq[g][tid] * (127.f / qmax));
      fs[g] = qmax * (inv_sqrt_d / 127.f);
    }
  }
  __syncthreads();

  float m_run[G], l_run[G], acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -1e30f;
    l_run[g] = 0.f;
    acc[g] = 0.f;
  }
  const CT* kbase = kc + (size_t)b * S * KHD + h * D;
  const CT* vbase = vc + (size_t)b * S * KHD + h * D;
  const int sub = lane & 7;

  for (int base = 0; base < L; base += chunk) {
    const int nk = min(chunk, L - base);
    // scores: 8 lanes per key, 16 keys per pass of the block
    for (int it = 0; it * 16 < nk; ++it) {
      const int kk = it * 16 + warp * 4 + (lane >> 3);
      const bool valid = kk < nk;
      float s[G];
      if constexpr (kInt8) {
        int d32[G];
#pragma unroll
        for (int g = 0; g < G; ++g) d32[g] = 0;
        if (valid) {
          const uint4 kv = *reinterpret_cast<const uint4*>(
              kbase + (size_t)(base + kk) * KHD + sub * 16);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            int t = __dp4a((int)kv.x, q8w[g][sub * 4 + 0], 0);
            t = __dp4a((int)kv.y, q8w[g][sub * 4 + 1], t);
            t = __dp4a((int)kv.z, q8w[g][sub * 4 + 2], t);
            d32[g] = __dp4a((int)kv.w, q8w[g][sub * 4 + 3], t);
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          d32[g] += __shfl_xor_sync(FULL, d32[g], 1);
          d32[g] += __shfl_xor_sync(FULL, d32[g], 2);
          d32[g] += __shfl_xor_sync(FULL, d32[g], 4);
          s[g] = (float)d32[g] * fs[g];
        }
      } else {
        float d[G];
#pragma unroll
        for (int g = 0; g < G; ++g) d[g] = 0.f;
        if (valid) {
          // a lane's 16 elements: two 16-byte loads of bf16, one of e4m3
          constexpr int NU = sizeof(CT);
          const uint4* p = reinterpret_cast<const uint4*>(
              kbase + (size_t)(base + kk) * KHD + sub * 16);
          uint4 u[NU];
#pragma unroll
          for (int i = 0; i < NU; ++i) u[i] = p[i];
          const CT* e = reinterpret_cast<const CT*>(u);
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            const float kf = to_f(e[c]);
#pragma unroll
            for (int g = 0; g < G; ++g) d[g] = fmaf(sq[g][sub * 16 + c], kf, d[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          d[g] += __shfl_xor_sync(FULL, d[g], 1);
          d[g] += __shfl_xor_sync(FULL, d[g], 2);
          d[g] += __shfl_xor_sync(FULL, d[g], 4);
          s[g] = d[g] * inv_sqrt_d;
        }
      }
      if (valid && sub == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g * chunk + kk] = s[g];
      }
    }
    __syncthreads();

    float m_cur[G], alpha[G], esum[G];
#pragma unroll
    for (int g = 0; g < G; ++g) m_cur[g] = -1e30f;
    for (int kk = tid; kk < nk; kk += NT)
#pragma unroll
      for (int g = 0; g < G; ++g) m_cur[g] = fmaxf(m_cur[g], sc[g * chunk + kk]);
    block_max<G>(m_cur, redf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_cur[g] = fmaxf(m_run[g], m_cur[g]);
      alpha[g] = expf(m_run[g] - m_cur[g]);
    }

    float y[G];
    if constexpr (kInt8) {
      int* e8 = reinterpret_cast<int*>(sc);
      int isum[G];
#pragma unroll
      for (int g = 0; g < G; ++g) isum[g] = 0;
      for (int kk = tid; kk < nk; kk += NT)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float e = expf(sc[g * chunk + kk] - m_cur[g]);
          const int code = (int)rintf(e * 127.f);
          e8[g * chunk + kk] = code;
          isum[g] += code;
        }
      block_sum<G, int>(isum, redi);
      int a[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        esum[g] = (float)isum[g] * (1.f / 127.f);
        a[g] = 0;
      }
      const CT* vrow = vbase + (size_t)base * KHD + tid;
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const int v = (int)vrow[(size_t)kk * KHD];
#pragma unroll
        for (int g = 0; g < G; ++g) a[g] += e8[g * chunk + kk] * v;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) y[g] = (float)a[g] * (1.f / 127.f);
    } else {
      float fsum[G];
#pragma unroll
      for (int g = 0; g < G; ++g) fsum[g] = 0.f;
      for (int kk = tid; kk < nk; kk += NT)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float e = expf(sc[g * chunk + kk] - m_cur[g]);
          sc[g * chunk + kk] = e;
          fsum[g] += e;
        }
      block_sum<G, float>(fsum, redf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        esum[g] = fsum[g];
        y[g] = 0.f;
      }
      const CT* vrow = vbase + (size_t)base * KHD + tid;
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const float v = to_f(vrow[(size_t)kk * KHD]);
#pragma unroll
        for (int g = 0; g < G; ++g)
          y[g] = fmaf(__bfloat162float(__float2bfloat16(sc[g * chunk + kk])), v, y[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l_run[g] = l_run[g] * alpha[g] + esum[g];
      acc[g] = acc[g] * alpha[g] + y[g];
      m_run[g] = m_cur[g];
    }
    __syncthreads();  // the next chunk reuses sc
  }

  // the new token, from its unquantized codes
  const size_t nrow = (size_t)b * KHD + h * D + tid;
  const CT kn_raw = knew[nrow];
  const CT vn_raw = vnew[nrow];
  const float kn = to_f(kn_raw);
  const float vn = to_f(vn_raw);
  float sn[G];
#pragma unroll
  for (int g = 0; g < G; ++g) sn[g] = sq[g][tid] * kn;
  block_sum<G, float>(sn, redf);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float s_n = sn[g] * inv_sqrt_d;
    const float m_fin = fmaxf(m_run[g], s_n);
    const float alpha = expf(m_run[g] - m_fin);
    const float e_n = expf(s_n - m_fin);
    const float l_fin = l_run[g] * alpha + e_n;
    const float a = acc[g] * alpha + e_n * vn;
    const float o = a * (vs / fmaxf(l_fin, 1e-30f));
    if (out_bf16 != nullptr)
      out_bf16[qoff + g * D + tid] = __float2bfloat16(o);
    else
      out_f32[qoff + g * D + tid] = o;
  }
  // this CTA reads rows < L only, and no other CTA reads this head's row L
  kc[((size_t)b * S + L) * KHD + h * D + tid] = kn_raw;
  vc[((size_t)b * S + L) * KHD + h * D + tid] = vn_raw;
}

template <typename CT, int G>
int launch(const void* q, const void* knew, const void* vnew, void* kc, void* vc,
           const void* pos, const void* kscale, const void* vscale, void* out_f32,
           void* out_bf16, int B, int S, int KH, int chunk, cudaStream_t s) {
  const size_t smem = (size_t)G * chunk * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_decode_kernel<CT, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_decode_kernel<CT, G><<<B * KH, NT, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const CT*>(knew),
      static_cast<const CT*>(vnew), static_cast<CT*>(kc), static_cast<CT*>(vc),
      static_cast<const int*>(pos), static_cast<const float*>(kscale),
      static_cast<const float*>(vscale), static_cast<float*>(out_f32),
      static_cast<__nv_bfloat16*>(out_bf16), S, KH, chunk);
  return (int)cudaGetLastError();
}

template <typename CT>
int dispatch_g(int G, const void* q, const void* knew, const void* vnew, void* kc,
               void* vc, const void* pos, const void* kscale, const void* vscale,
               void* out_f32, void* out_bf16, int B, int S, int KH, int chunk,
               cudaStream_t s) {
  switch (G) {
    case 1: return launch<CT, 1>(q, knew, vnew, kc, vc, pos, kscale, vscale, out_f32, out_bf16, B, S, KH, chunk, s);
    case 2: return launch<CT, 2>(q, knew, vnew, kc, vc, pos, kscale, vscale, out_f32, out_bf16, B, S, KH, chunk, s);
    case 4: return launch<CT, 4>(q, knew, vnew, kc, vc, pos, kscale, vscale, out_f32, out_bf16, B, S, KH, chunk, s);
    case 8: return launch<CT, 8>(q, knew, vnew, kc, vc, pos, kscale, vscale, out_f32, out_bf16, B, S, KH, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

__global__ void e4m3_decode_kernel(const uint8_t* __restrict__ codes,
                                   float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = e4m3_to_f32(codes[i]);
}

}  // namespace

// q bf16 [B, KH, G, 128]; knew/vnew [B, KH*128] and caches [B, S, KH*128] of
// bf16 (cache_kind 0), int8 (1) or e4m3 (2) codes; pos int32 [B];
// kscale/vscale f32 scalars on the device or null (scale 1); exactly one of
// out_f32 / out_bf16 non-null.
extern "C" int fused_decode_attention(const void* q, const void* knew,
                                      const void* vnew, void* kc, void* vc,
                                      const void* pos, const void* kscale,
                                      const void* vscale, void* out_f32,
                                      void* out_bf16, int B, int S, int KH, int G,
                                      int chunk, int cache_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_kind) {
    case 0:
      return dispatch_g<__nv_bfloat16>(G, q, knew, vnew, kc, vc, pos, kscale, vscale,
                                       out_f32, out_bf16, B, S, KH, chunk, s);
    case 1:
      return dispatch_g<int8_t>(G, q, knew, vnew, kc, vc, pos, kscale, vscale,
                                out_f32, out_bf16, B, S, KH, chunk, s);
    case 2:
      return dispatch_g<e4m3_t>(G, q, knew, vnew, kc, vc, pos, kscale, vscale,
                                out_f32, out_bf16, B, S, KH, chunk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The e4m3 decode the kernels read caches through (e4m3.cuh), applied to n
// codes: f32 out. A probe of the device function for the card check.
extern "C" int e4m3_decode(const void* codes, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  e4m3_decode_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
