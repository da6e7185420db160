// Byte-weight GEMMs for Hopper (sm_90a): bf16 activations x int8 or e4m3
// weights on the bf16 tensor cores (mma.sync m16n8k16, f32 accumulate),
// then the f32 scale on the f32 result. One template serves both:
//   W8A16 (int8 weights, one f32 scale per output column) and
//   W(FP8)A16 (e4m3 weights, one f32 scale for the tensor).
//
// Replaces: modelopt_tpu/kernels/quant_gemm.py::w8a16_gemm (Pallas body
// _w8a16_kernel) and ::wfp8_gemm (_wfp8_kernel).
//
// Layout (quant/qtensor.py): W [K, N] of bytes, row-major; int8 scale f32
// [1, N], e4m3 scale f32 [1, 1] (read on the card: no host sync).
//
// Numerics, as the reference: every int8 and every e4m3 value is exact in
// bf16, so the weight is converted to bf16 in registers (int8 through f32,
// e4m3 through the hardware's e4m3 -> f16 conversion, exact, then f16 ->
// f32 -> bf16, exact) and multiplied with x in bf16 into f32. No fp8 MMA:
// that would quantize x to e4m3 and change the reference's numerics. The
// scale multiplies the f32 sum once, then the result rounds to the output
// type.
//
// What bounds it on an H100: at decode (M <= 16) the K*N weight bytes over
// 3.35 TB/s of HBM. This first version is a plain mma.sync tile without
// TMA, wgmma or a multi-stage pipeline: latency is hidden only by the
// several CTAs resident on each SM.
//
// Design (the K6 w4a16_gemm tile with one byte per weight): one CTA per
// (BM x BN) output tile and K split, a loop over its K range in steps of
// 128 rows. Per step the CTA stages x [BM, 128] and the weight tile
// [128, BN], transposed on the way in (4x4 byte transposes in registers)
// so one 32-bit word holds four consecutive k of one column: a thread's B
// fragment is one such word. The MMA's k order is permuted (A and B alike)
// so each thread takes four consecutive k. Two tilings: 16x64 (4 warps of
// 16x16) for M <= 16, 64x64 (4 warps of 32x32) above. Where the output has
// too few tiles to keep HBM busy (N = 4096 at decode: 64 CTAs), the wrapper
// splits K over `splits` CTAs per tile: each writes its f32 partial sum,
// and a second kernel adds the partials in split order (deterministic),
// applies the scale and rounds to the output type.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int KB = 128;      // k rows of one staging step
constexpr int XP = KB + 16;  // x tile pitch in bf16: 288 B, rows start 8 banks apart
constexpr int WP = KB + 16;  // transposed weight pitch in bytes: 36 words, 4 banks apart

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four int8 weights (bytes of w, k order) -> two bf16x2, exact
__device__ __forceinline__ void s8x4_to_bf16(uint32_t w, uint32_t& b0, uint32_t& b1) {
  b0 = bf16x2_bits((float)(int8_t)(w & 0xFF), (float)(int8_t)((w >> 8) & 0xFF));
  b1 = bf16x2_bits((float)(int8_t)((w >> 16) & 0xFF), (float)(int8_t)(w >> 24));
}

// two e4m3 codes (the low 16 bits of v) -> bf16x2, exact
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t v) {
  __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(v & 0xFFFF), __NV_E4M3);
  const float2 f = __half22float2(*reinterpret_cast<__half2*>(&h));
  return bf16x2_bits(f.x, f.y);
}

// the scale of output column n: per column (int8) or the tensor's (e4m3)
template <bool E4M3>
__device__ __forceinline__ float col_scale(const float* scale, int n) {
  return E4M3 ? scale[0] : scale[n];
}

template <int MT, int NT, int WM, int WN, bool E4M3>
__global__ void __launch_bounds__(32 * WM * WN)
w8_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scale, float* __restrict__ out_f32,
          __nv_bfloat16* __restrict__ out_bf16, float* __restrict__ part, int M, int N,
          int K) {
  constexpr int BM = WM * MT * 16;
  constexpr int BN = WN * NT * 8;
  constexpr int NTH = 32 * WM * WN;
  __shared__ __align__(16) __nv_bfloat16 xs[BM][XP];
  __shared__ __align__(16) uint8_t wt[BN][WP];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row / column group
  const int t = lane & 3;   // thread in group
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // this CTA's K range: steps [s * steps / splits, (s + 1) * steps / splits)
  const int steps = K / KB;
  const int split = blockIdx.z;
  const int k_end = (int)((long)(split + 1) * steps / gridDim.z) * KB;
  for (int k0 = (int)((long)split * steps / gridDim.z) * KB; k0 < k_end; k0 += KB) {
    for (int i = tid; i < BM * (KB / 8); i += NTH) {
      const int r = i / (KB / 8);
      const int c = i % (KB / 8);
      const int m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + c * 8);
      *reinterpret_cast<uint4*>(&xs[r][c * 8]) = v;
    }
    // weight tile [KB, BN], transposed to wt[n][k] 4 rows x 4 columns at a time
    for (int i = tid; i < (KB / 4) * (BN / 4); i += NTH) {
      const int kr = (i / (BN / 4)) * 4;
      const int nc = (i % (BN / 4)) * 4;
      const uint8_t* src = w + (size_t)(k0 + kr) * N + n0 + nc;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(src);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(src + N);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(src + 2 * (size_t)N);
      const uint32_t r3 = *reinterpret_cast<const uint32_t*>(src + 3 * (size_t)N);
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      *reinterpret_cast<uint32_t*>(&wt[nc + 0][kr]) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<uint32_t*>(&wt[nc + 1][kr]) = __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<uint32_t*>(&wt[nc + 2][kr]) = __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(&wt[nc + 3][kr]) = __byte_perm(t2, t3, 0x7632);
    }
    __syncthreads();

#pragma unroll 2
    for (int ks = 0; ks < KB / 16; ++ks) {
      // A fragments: MMA k slots (2t, 2t+1 | 2t+8, 2t+9) hold x columns
      // 4t..4t+3 of this 16-column step, rows g and g+8
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * MT * 16 + i * 16 + g;
        const uint2 l0 = *reinterpret_cast<const uint2*>(&xs[r][ks * 16 + 4 * t]);
        const uint2 l1 = *reinterpret_cast<const uint2*>(&xs[r + 8][ks * 16 + 4 * t]);
        a[i][0] = l0.x; a[i][1] = l1.x; a[i][2] = l0.y; a[i][3] = l1.y;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = wn * NT * 8 + j * 8 + g;
        const uint32_t wv = *reinterpret_cast<const uint32_t*>(&wt[c][ks * 16 + 4 * t]);
        uint32_t b0, b1;
        if (E4M3) {
          b0 = e4m3x2_to_bf16x2(wv);
          b1 = e4m3x2_to_bf16x2(wv >> 16);
        } else {
          s8x4_to_bf16(wv, b0, b1);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn * NT * 8 + j * 8 + 2 * t;
    const float s0 = part ? 0.f : col_scale<E4M3>(scale, n);
    const float s1 = part ? 0.f : col_scale<E4M3>(scale, n + 1);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + wm * MT * 16 + i * 16 + g + ((c & 2) ? 8 : 0);
        if (m >= M) continue;
        const size_t o = (size_t)m * N + n + (c & 1);
        if (part != nullptr) {  // a K split: its raw f32 sum
          part[(size_t)split * M * N + o] = acc[i][j][c];
          continue;
        }
        const float v = __fmul_rn(acc[i][j][c], (c & 1) ? s1 : s0);
        if (out_bf16 != nullptr)
          out_bf16[o] = __float2bfloat16(v);
        else
          out_f32[o] = v;
      }
  }
}

// out[m, n] = (sum over splits s in order of part[s, m, n]) * scale(n)
template <bool E4M3>
__global__ void __launch_bounds__(256)
w8_reduce_splits(const float* __restrict__ part, const float* __restrict__ scale,
                 float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16, int splits,
                 int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t MN = (size_t)M * N;
  if (i >= MN) return;
  float acc = part[i];
  for (int s = 1; s < splits; ++s) acc = __fadd_rn(acc, part[s * MN + i]);
  const float v = __fmul_rn(acc, col_scale<E4M3>(scale, (int)(i % N)));
  if (out_bf16 != nullptr)
    out_bf16[i] = __float2bfloat16(v);
  else
    out_f32[i] = v;
}

template <bool E4M3>
int launch(const void* x, const void* w, const void* scale, void* out_f32, void* out_bf16,
           void* part, int M, int N, int K, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out_f32);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out_bf16);
  float* pp = splits > 1 ? static_cast<float*>(part) : nullptr;
  if (M <= 16) {
    dim3 grid(N / 64, 1, splits);
    w8_kernel<1, 2, 1, 4, E4M3><<<grid, 128, 0, s>>>(xp, wp, sc, of, ob, pp, M, N, K);
  } else {
    dim3 grid(N / 64, (M + 63) / 64, splits);
    w8_kernel<2, 4, 2, 2, E4M3><<<grid, 128, 0, s>>>(xp, wp, sc, of, ob, pp, M, N, K);
  }
  if (pp != nullptr) {
    const size_t mn = (size_t)M * N;
    w8_reduce_splits<E4M3><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(pp, sc, of, ob,
                                                                        splits, M, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [M, K]; w int8 [K, N]; scale f32 [N]. Exactly one of out_f32 /
// out_bf16 [M, N] is non-null. splits: CTAs that share one output tile's
// K range (1 <= splits <= K / 128); above 1, part is f32 scratch of
// [splits, M, N]. Needs K % 128 == 0, N % 64 == 0 and 16-byte aligned x
// (checked by the Python wrapper).
extern "C" int w8a16_gemm(const void* x, const void* w, const void* scale, void* out_f32,
                          void* out_bf16, void* part, int M, int N, int K, int splits,
                          void* stream) {
  return launch<false>(x, w, scale, out_f32, out_bf16, part, M, N, K, splits, stream);
}

// x bf16 [M, K]; w e4m3 [K, N]; scale f32 [1]. As w8a16_gemm.
extern "C" int wfp8_gemm(const void* x, const void* w, const void* scale, void* out_f32,
                         void* out_bf16, void* part, int M, int N, int K, int splits,
                         void* stream) {
  return launch<true>(x, w, scale, out_f32, out_bf16, part, M, N, K, splits, stream);
}
