// W4A8 GEMM for Hopper (sm_90a): int8 activations x int4 weights, int32 dots
// per 128-row scale block, f32 block scales applied to an f32 accumulator.
//
// Replaces: modelopt_tpu/kernels/quant_gemm.py::w4a8_gemm (Pallas bodies
// _w4a8_kernel, _w4a8_kt_kernel, _w4a8_body).
//
// Layout (bit-identical to quant/qtensor.py::pack_int4): packed uint8 [K/2, N];
// the low nibble of row p holds weight row p as offset-binary q+8, the high
// nibble holds weight row K/2+p in two's complement. scale f32 [K/128, N]:
// rows [0, K/256) scale the low half, rows [K/256, K/128) the high half.
//
// What bounds it on an H100: at decode (M <= 8) the packed weight bytes
// (K/2 * N) over the 3.35 TB/s of HBM; at prefill (M = 512) the integer
// multiply-adds. This first version runs them as __dp4a on the CUDA cores
// (4 int8 products per instruction), not on the int8 tensor cores.
//
// Design: one CTA per (BM x BN) output tile, a loop over the 128-row scale
// blocks. Per block the CTA stages the x rows of both halves and the packed
// [128, BN] weight tile in shared memory; the weight tile is transposed on
// the way in (4x4 byte transpose in registers) so that one 32-bit word holds
// four consecutive k of one column. The nibbles are never widened: as in
// the Pallas kernel, (w & 0x0F) is q_lo + 8 (corrected by 8 * sum(x)) and
// (w & 0xF0) read as int8 is exactly 16 * q_hi, so each word feeds dp4a
// after one AND. The per-block f32 update is acc + qlo*s_lo + qhi*s_hi with
// explicit rounding (no fused multiply-add), the order of the plain version.
// Two tilings: 8x32 for decode (many CTAs over N to draw HBM bandwidth) and
// 64x64 with a 4x4 register tile per thread for prefill.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KB = 128;      // rows of one scale block
constexpr int XP = KB + 16;  // x tile row pitch in bytes (rows stay 16-byte aligned)
constexpr int WP = KB + 4;   // transposed weight tile pitch in bytes (33 words: no bank conflicts)

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
w4a8_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ out_f32,
            __nv_bfloat16* __restrict__ out_bf16, int M, int N, int K2) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  constexpr int NT = TX * TY;
  __shared__ __align__(16) int8_t xs[2][BM][XP];
  __shared__ __align__(16) uint8_t wt[BN][WP];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int K = 2 * K2;
  const int nblk = K2 / KB;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int blk = 0; blk < nblk; ++blk) {
    // x rows of this block, low half (cols blk*KB) and high half (K2 + blk*KB)
    for (int t = tid; t < 2 * BM * (KB / 16); t += NT) {
      const int half = t / (BM * (KB / 16));
      const int r = (t / (KB / 16)) % BM;
      const int c = t % (KB / 16);
      const int m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + half * K2 +
                                            blk * KB + c * 16);
      *reinterpret_cast<uint4*>(&xs[half][r][c * 16]) = v;
    }
    // packed [KB, BN] tile, transposed to wt[n][k] 4 rows x 4 columns at a time
    for (int t = tid; t < (KB / 4) * (BN / 4); t += NT) {
      const int kr = (t / (BN / 4)) * 4;
      const int nc = (t % (BN / 4)) * 4;
      const uint8_t* src = w + (size_t)(blk * KB + kr) * N + n0 + nc;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(src);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(src + N);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(src + 2 * (size_t)N);
      const uint32_t r3 = *reinterpret_cast<const uint32_t*>(src + 3 * (size_t)N);
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
      const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t2 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      *reinterpret_cast<uint32_t*>(&wt[nc + 0][kr]) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<uint32_t*>(&wt[nc + 1][kr]) = __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<uint32_t*>(&wt[nc + 2][kr]) = __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(&wt[nc + 3][kr]) = __byte_perm(t2, t3, 0x7632);
    }
    __syncthreads();

    int lo[TM][TN], hi[TM][TN], sx[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      sx[i] = 0;
#pragma unroll
      for (int j = 0; j < TN; ++j) lo[i][j] = hi[i][j] = 0;
    }
#pragma unroll 4
    for (int k4 = 0; k4 < KB / 4; ++k4) {
      int xl[TM], xh[TM], wl[TN], wh[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        xl[i] = *reinterpret_cast<const int*>(&xs[0][ty + TY * i][k4 * 4]);
        xh[i] = *reinterpret_cast<const int*>(&xs[1][ty + TY * i][k4 * 4]);
        sx[i] = __dp4a(xl[i], 0x01010101, sx[i]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int wv = *reinterpret_cast<const int*>(&wt[tx + TX * j][k4 * 4]);
        wl[j] = wv & 0x0F0F0F0F;         // q_lo + 8, bytes 0..15
        wh[j] = wv & (int)0xF0F0F0F0u;   // 16 * q_hi as int8
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          lo[i][j] = __dp4a(xl[i], wl[j], lo[i][j]);
          hi[i][j] = __dp4a(xh[i], wh[j], hi[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + TX * j;
      const float slo = scale[(size_t)blk * N + n];
      const float shi = scale[(size_t)(nblk + blk) * N + n];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int qlo = lo[i][j] - 8 * sx[i];
        const int qhi = hi[i][j] >> 4;
        acc[i][j] = __fadd_rn(__fadd_rn(acc[i][j], __fmul_rn((float)qlo, slo)),
                              __fmul_rn((float)qhi, shi));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + TY * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const size_t o = (size_t)m * N + n0 + tx + TX * j;
      if (out_bf16 != nullptr)
        out_bf16[o] = __float2bfloat16(acc[i][j]);
      else
        out_f32[o] = acc[i][j];
    }
  }
}

}  // namespace

// xq int8 [M, 2*K2]; packed uint8 [K2, N]; scale f32 [2*K2/128, N].
// Exactly one of out_f32 / out_bf16 is non-null. Needs K2 % 128 == 0,
// N % 64 == 0 and 16-byte aligned xq (checked by the Python wrapper).
extern "C" int w4a8_gemm(const void* xq, const void* packed, const void* scale,
                         void* out_f32, void* out_bf16, int M, int N, int K2,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out_f32);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out_bf16);
  if (M <= 8) {
    dim3 grid(N / 32, (M + 7) / 8);
    w4a8_kernel<8, 32, 1, 1><<<grid, 256, 0, s>>>(x, w, sc, of, ob, M, N, K2);
  } else {
    dim3 grid(N / 64, (M + 63) / 64);
    w4a8_kernel<64, 64, 4, 4><<<grid, 256, 0, s>>>(x, w, sc, of, ob, M, N, K2);
  }
  return (int)cudaGetLastError();
}
