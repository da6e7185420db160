// Cache-free causal flash attention for Hopper (sm_90a): grouped-query
// attention of a whole sequence against its own keys, with an optional
// sliding window and sink tokens (the training and uncached-prefill form).
//
// Replaces: modelopt_tpu/kernels/flash_attention.py::flash_attention
// (forward _flash_forward, Pallas body _flash_kernel). The gradient has no
// kernel there or here: the Python wrapper recomputes it through the plain
// version under autograd, as the reference's custom_vjp recomputes through
// _xla_reference.
//
// Numerics follow the Pallas kernel: q, k and v are taken to f32 as they
// are (bf16 values exactly); scores are f32 products summed in f32 and
// scaled by 1/sqrt(D); a key is valid when kpos <= qpos (causal) and, with
// a window, when kpos > qpos - window or kpos < sink; invalid keys get
// -1e9; softmax and the PV product stay in f32; the output takes q's
// dtype. Query rows are the flattened (t, g) rows of one (batch, KV head),
// and a row's position is row / G. The Pallas kernel holds the whole key
// row of a head in VMEM and normalizes before PV; this kernel runs an
// online softmax over 64-key tiles and divides at the end, so the two
// differ by the f32 rounding of the rescaled sums.
//
// What bounds it on an H100: operations, the causal half of 4 * rows * S * D
// multiply-adds; this first version runs them in f32 on the CUDA cores, not
// on the bf16 tensor cores.
//
// Design: K4's tile loop (csrc/flash_prefill_attention.cu) with start = 0,
// uncached K/V of the input's dtype, f32 probabilities into PV and the
// window / sink mask. One CTA of 256 threads per (batch * KV head, 64-row
// tile); a loop over 64-key tiles that stops after the tile's last query
// position (causal skipping); Q, K, V and the score tile live in shared
// memory as f32 (116 KB at D = 128), each thread holds a 4 x 4 score tile
// and a 4 x D/16 output tile in registers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int PP = BK + 1;  // padded row pitch of the score tile
constexpr int NT = 256;

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D + (size_t)BQ * PP + 3 * BQ;
}

template <typename IT>
__device__ __forceinline__ float to_f32(IT v) {
  if constexpr (std::is_same<IT, float>::value)
    return v;
  else
    return __bfloat162float(v);
}

template <typename IT>
__device__ __forceinline__ IT from_f32(float v) {
  if constexpr (std::is_same<IT, float>::value)
    return v;
  else
    return __float2bfloat16(v);
}

template <typename IT, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const IT* __restrict__ q, const IT* __restrict__ k,
                       const IT* __restrict__ v, IT* __restrict__ out, int T, int S, int KH,
                       int G, int causal, int window, int sink, float sm_scale) {
  constexpr int QP = D + 1;  // padded row pitch (floats) of the Q and K tiles
  constexpr int DC = D / 16;  // output columns per thread
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
  const int KHD = KH * D;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int i = idx / D, d = idx % D;
    const int r = r0 + i;
    float x = 0.f;
    if (r < rows) {
      const int t = r / G, g = r % G;
      x = to_f32(q[(((size_t)b * T + t) * KH + h) * G * D + (size_t)g * D + d]);
    }
    Qs[i * QP + d] = x;
  }
  for (int i = tid; i < BQ; i += NT) {
    rm[i] = -1e30f;
    rl[i] = 0.f;
  }
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int rlast = min(r0 + BQ, rows) - 1;
  const int kend = causal ? min(rlast / G, S - 1) : S - 1;  // last key any row may attend
  const IT* kb = k + (size_t)b * S * KHD + h * D;
  const IT* vb = v + (size_t)b * S * KHD + h * D;

  for (int k0 = 0; k0 <= kend; k0 += BK) {
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < S) {
        kv = to_f32(kb[(size_t)key * KHD + d]);
        vv = to_f32(vb[(size_t)key * KHD + d]);
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
      const int qpos = (r0 + row) / G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        bool ok = key < S && (!causal || key <= qpos);
        if (window >= 0) ok = ok && (key > qpos - window || key < sink);
        Ps[row * PP + tx + 16 * j] = ok ? __fmul_rn(s[i][j], sm_scale) : -1e9f;
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
        pr[c] = p;
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
      for (int c = 0; c < DC; ++c) acc[i][c] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
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
    for (int c = 0; c < DC; ++c) out[o + tx + 16 * c] = from_f32<IT>(acc[i][c] / l);
  }
}

template <typename IT, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int T, int S, int KH,
           int G, int causal, int window, int sink, float sm_scale, cudaStream_t s) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<IT, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T * G + BQ - 1) / BQ, B * KH);
  flash_attention_kernel<IT, D><<<grid, NT, smem, s>>>(
      static_cast<const IT*>(q), static_cast<const IT*>(k), static_cast<const IT*>(v),
      static_cast<IT*>(out), T, S, KH, G, causal, window, sink, sm_scale);
  return (int)cudaGetLastError();
}

template <typename IT>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out, int B, int T,
               int S, int KH, int G, int causal, int window, int sink, float sm_scale,
               cudaStream_t s) {
  switch (D) {
    case 64: return launch<IT, 64>(q, k, v, out, B, T, S, KH, G, causal, window, sink, sm_scale, s);
    case 128:
      return launch<IT, 128>(q, k, v, out, B, T, S, KH, G, causal, window, sink, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, T, KH, G, D], k / v [B, S, KH, D], out like q; all bf16 (f32 = 0)
// or all f32 (f32 = 1), contiguous. D = 64 or 128. causal 0/1; window < 0:
// no sliding window (then sink is unused).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int T, int S, int KH, int G, int D, int causal, int window,
                               int sink, float sm_scale, int f32, void* stream) {
  if (B * KH * T * G == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return dispatch_d<float>(D, q, k, v, out, B, T, S, KH, G, causal, window, sink, sm_scale, s);
  return dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, T, S, KH, G, causal, window, sink,
                                   sm_scale, s);
}
