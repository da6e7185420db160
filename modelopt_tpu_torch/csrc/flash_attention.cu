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
// -1e9; softmax and the PV product take f32 probabilities; the output takes
// q's dtype. Query rows are the flattened (t, g) rows of one (batch, KV
// head), and a row's position is row / G. The Pallas kernel holds the whole
// key row of a head in VMEM and normalizes before PV; this kernel runs an
// online softmax over 64-key tiles and divides at the end, so the two
// differ by the f32 rounding of the rescaled sums.
//
// What bounds it on an H100: operations, the causal half of 4 * rows * S * D
// multiply-adds (17.39 us at B = 2, T = S = 1024, KH = 8, G = 4, D = 128 in
// bf16). The first version ran them in f32 on the CUDA cores at ~10
// TFLOP/s.
//
// Design, bf16 inputs (every served path): the tensor-core tile of
// csrc/flash_tile.cuh with start = 0, K4's tile with uncached bf16 K / V
// streamed by cp.async, the causal / window / sink mask on the tiles that
// need it, tiles wholly outside every row's window (and past the sinks)
// skipped. The reference's PV takes f32 probabilities, so each p enters as
// hi = bf16(p) and lo = bf16(p - hi) in two bf16 products (p to ~2^-17
// relative, where bf16 alone would keep 2^-9). f32 inputs (off the served
// paths: the f32 skip-softmax parity) keep the first version's CUDA-core
// tile below: Q, K, V and the score tile in shared memory as f32 (116 KB at
// D = 128), each of 256 threads holding a 4 x 4 score tile and a 4 x D/16
// output tile. Left for a later PR: a wgmma + TMA warp-specialised version
// (FA3's shape) and an fp8 PV product.
#include "flash_tile.cuh"

namespace {

// the first version's CUDA-core tile, for f32 inputs
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int PP = BK + 1;  // padded row pitch of the score tile
constexpr int NT = 256;

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D + (size_t)BQ * PP + 3 * BQ;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int T, int S,
                           int KH, int G, int causal, int window, int sink, float sm_scale) {
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
      x = q[(((size_t)b * T + t) * KH + h) * G * D + (size_t)g * D + d];
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
  const float* kb = k + (size_t)b * S * KHD + h * D;
  const float* vb = v + (size_t)b * S * KHD + h * D;

  for (int k0 = 0; k0 <= kend; k0 += BK) {
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < S) {
        kv = kb[(size_t)key * KHD + d];
        vv = vb[(size_t)key * KHD + d];
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
    for (int c = 0; c < DC; ++c) out[o + tx + 16 * c] = acc[i][c] / l;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int T, int S,
               int KH, int G, int causal, int window, int sink, float sm_scale,
               cudaStream_t s) {
  static unsigned smem_set = 0;
  const int smem = (int)(smem_floats<D>() * sizeof(float));
  int e = flash_tile::allow_smem(flash_attention_f32_kernel<D>, smem, smem_set);
  if (e != 0) return e;
  dim3 grid((T * G + BQ - 1) / BQ, B * KH);
  flash_attention_f32_kernel<D><<<grid, NT, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), T, S, KH, G, causal, window, sink, sm_scale);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core tile, one CTA per (slot * KV head, 64-row tile),
// row tiles issued heaviest (last) first
template <int D>
__global__ void __launch_bounds__(flash_tile::NT, 2)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       int T, int S, int KH, int G, int causal, int window, int sink,
                       float sm_scale) {
  namespace ft = flash_tile;
  const int b = blockIdx.x / KH, h = blockIdx.x % KH;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * ft::BQ;
  const int rlast = min(r0 + ft::BQ, T * G) - 1;
  const ft::CausalMask mask(S, causal, window, sink, r0 / G, rlast / G);
  const ft::Args a{q, k, v, out, 1.f, 1.f, T, S, KH, G, sm_scale};
  ft::attend<D, ft::KV_BF16, true, false>(a, b, h, r0, 0, mask);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int T, int S,
                int KH, int G, int causal, int window, int sink, float sm_scale,
                cudaStream_t s) {
  static unsigned smem_set = 0;
  constexpr int smem = flash_tile::smem_bytes<D>();
  int e = flash_tile::allow_smem(flash_attention_kernel<D>, smem, smem_set);
  if (e != 0) return e;
  dim3 grid(B * KH, (T * G + flash_tile::BQ - 1) / flash_tile::BQ);
  flash_attention_kernel<D><<<grid, flash_tile::NT, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), T, S, KH, G,
      causal, window, sink, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, KH, G, D], k / v [B, S, KH, D], out like q; all bf16 (f32 = 0)
// or all f32 (f32 = 1), contiguous, 16-byte aligned. D = 64 or 128. causal
// 0/1; window < 0: no sliding window (then sink is unused).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int T, int S, int KH, int G, int D, int causal, int window,
                               int sink, float sm_scale, int f32, void* stream) {
  if (B * KH * T * G == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (f32)
    return D == 64 ? launch_f32<64>(q, k, v, out, B, T, S, KH, G, causal, window, sink, sm_scale, s)
                   : launch_f32<128>(q, k, v, out, B, T, S, KH, G, causal, window, sink, sm_scale, s);
  return D == 64 ? launch_bf16<64>(q, k, v, out, B, T, S, KH, G, causal, window, sink, sm_scale, s)
                 : launch_bf16<128>(q, k, v, out, B, T, S, KH, G, causal, window, sink, sm_scale, s);
}
