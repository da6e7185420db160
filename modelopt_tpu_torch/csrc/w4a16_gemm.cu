// W4A16 GEMM for Hopper (sm_90a): bf16 activations x int4 block-quantized
// weights on the bf16 tensor cores (mma.sync m16n8k16, f32 accumulate), f32
// block scales applied to an f32 accumulator. One template serves the plain
// and the grouped (per-expert) product.
//
// Replaces: modelopt_tpu/kernels/quant_gemm.py::w4a16_gemm (Pallas bodies
// _w4a16_kernel, _w4a16_kt_kernel, _w4a16_body) and
// ::grouped_w4a16_gemm (_grouped_w4a16_kernel, the same body over a grid of
// (expert, N-tile)).
//
// Layout (bit-identical to quant/qtensor.py::pack_int4): packed uint8 [K/2, EN]
// with EN = E*N (the folded expert layout: expert e is columns e*N..e*N+N-1;
// E = 1 for the plain product). The low nibble of row p holds weight row p
// as offset-binary q+8, the high nibble weight row K/2+p in two's
// complement. scale f32 [K/128, EN]: rows [0, K/256) scale the low half.
//
// What bounds it on an H100: at decode (M <= 16) the packed weight bytes
// over 3.35 TB/s of HBM; at prefill (M = 544) the bf16 multiply-adds over
// the 989 TFLOP/s of the tensor cores. This first version is a plain
// mma.sync tile without TMA, wgmma or a multi-stage pipeline: latency is
// hidden only by the several CTAs resident on each SM.
//
// Design: one CTA per (BM x BN) output tile and expert, a loop over the
// 128-row scale blocks. Per block the CTA stages both halves' x columns and
// the packed [128, BN] tile, transposed on the way in (4x4 byte transposes
// in registers, as in w4a8_gemm.cu) so one 32-bit word holds four k of one
// column. A thread's B fragment is one such word: four offset-binary
// nibbles become bf16 by OR-ing them into the mantissa of 128.0 (0x4300)
// and subtracting 136.0, both exact, and the high nibbles the same way
// after XOR 8. The MMA's k order is permuted (A and B alike) so each thread
// takes four consecutive k: x then loads 8 bytes per row. Each scale block
// is dotted into fresh f32 fragments, then acc + d_lo*s_lo + d_hi*s_hi with
// explicit rounding (no fused multiply-add), the plain version's order.
// Two tilings: 16x64 (4 warps of 16x16) for M <= 16, 64x64 (4 warps of
// 32x32) above.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KB = 128;      // packed rows of one scale block (one staging step)
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

// two offset-binary nibbles u0, u1 (bytes 0 and 2 of `biased`, each OR-ed
// into 0x43) -> bf16x2 (u0 - 8, u1 - 8), exact
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t biased) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&biased);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
w4a16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
             const float* __restrict__ scale, float* __restrict__ out_f32,
             __nv_bfloat16* __restrict__ out_bf16, int M, int N, int K2, int EN) {
  constexpr int BM = WM * MT * 16;
  constexpr int BN = WN * NT * 8;
  constexpr int NTH = 32 * WM * WN;
  __shared__ __align__(16) __nv_bfloat16 xs[2][BM][XP];
  __shared__ __align__(16) uint8_t wt[BN][WP];

  const int e = blockIdx.z;
  const int K = 2 * K2;
  x += (size_t)e * M * K;
  w += (size_t)e * N;
  scale += (size_t)e * N;
  const size_t obase = (size_t)e * M * N;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row / column group
  const int t = lane & 3;   // thread in group
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nblk = K2 / KB;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int blk = 0; blk < nblk; ++blk) {
    // x columns of this block: low half at blk*KB, high half at K2 + blk*KB
    for (int i = tid; i < 2 * BM * (KB / 8); i += NTH) {
      const int half = i / (BM * (KB / 8));
      const int r = (i / (KB / 8)) % BM;
      const int c = i % (KB / 8);
      const int m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + half * K2 +
                                            blk * KB + c * 8);
      *reinterpret_cast<uint4*>(&xs[half][r][c * 8]) = v;
    }
    // packed [KB, BN] tile, transposed to wt[n][k] 4 rows x 4 columns at a time
    for (int i = tid; i < (KB / 4) * (BN / 4); i += NTH) {
      const int kr = (i / (BN / 4)) * 4;
      const int nc = (i % (BN / 4)) * 4;
      const uint8_t* src = w + (size_t)(blk * KB + kr) * EN + n0 + nc;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(src);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(src + EN);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(src + 2 * (size_t)EN);
      const uint32_t r3 = *reinterpret_cast<const uint32_t*>(src + 3 * (size_t)EN);
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

    float dlo[MT][NT][4], dhi[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dlo[i][j][c] = dhi[i][j][c] = 0.f;

#pragma unroll 2
    for (int ks = 0; ks < KB / 16; ++ks) {
      // A fragments: MMA k slots (2t, 2t+1 | 2t+8, 2t+9) hold x columns
      // 4t..4t+3 of this 16-column step, rows g and g+8
      uint32_t alo[MT][4], ahi[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * MT * 16 + i * 16 + g;
        const uint2 l0 = *reinterpret_cast<const uint2*>(&xs[0][r][ks * 16 + 4 * t]);
        const uint2 l1 = *reinterpret_cast<const uint2*>(&xs[0][r + 8][ks * 16 + 4 * t]);
        const uint2 h0 = *reinterpret_cast<const uint2*>(&xs[1][r][ks * 16 + 4 * t]);
        const uint2 h1 = *reinterpret_cast<const uint2*>(&xs[1][r + 8][ks * 16 + 4 * t]);
        alo[i][0] = l0.x; alo[i][1] = l1.x; alo[i][2] = l0.y; alo[i][3] = l1.y;
        ahi[i][0] = h0.x; ahi[i][1] = h1.x; ahi[i][2] = h0.y; ahi[i][3] = h1.y;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = wn * NT * 8 + j * 8 + g;
        const uint32_t wv = *reinterpret_cast<const uint32_t*>(&wt[c][ks * 16 + 4 * t]);
        const uint32_t lo = wv & 0x0F0F0F0Fu;                    // q_lo + 8
        const uint32_t hi = ((wv >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // q_hi + 8
        const uint32_t blo0 = nibbles_to_bf16x2(__byte_perm(lo, 0x43434343u, 0x4140));
        const uint32_t blo1 = nibbles_to_bf16x2(__byte_perm(lo, 0x43434343u, 0x4342));
        const uint32_t bhi0 = nibbles_to_bf16x2(__byte_perm(hi, 0x43434343u, 0x4140));
        const uint32_t bhi1 = nibbles_to_bf16x2(__byte_perm(hi, 0x43434343u, 0x4342));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(dlo[i][j], alo[i], blo0, blo1);
          mma_bf16(dhi[i][j], ahi[i], bhi0, bhi1);
        }
      }
    }
    // block scales on the f32 accumulator: columns 2t, 2t+1 of each n8 tile
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + wn * NT * 8 + j * 8 + 2 * t;
      const float2 slo = *reinterpret_cast<const float2*>(scale + (size_t)blk * EN + n);
      const float2 shi =
          *reinterpret_cast<const float2*>(scale + (size_t)(nblk + blk) * EN + n);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float sl = (c & 1) ? slo.y : slo.x;
          const float sh = (c & 1) ? shi.y : shi.x;
          acc[i][j][c] = __fadd_rn(__fadd_rn(acc[i][j][c], __fmul_rn(dlo[i][j][c], sl)),
                                   __fmul_rn(dhi[i][j][c], sh));
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + wm * MT * 16 + i * 16 + g + ((c & 2) ? 8 : 0);
        if (m >= M) continue;
        const size_t o = obase + (size_t)m * N + n0 + wn * NT * 8 + j * 8 + 2 * t + (c & 1);
        if (out_bf16 != nullptr)
          out_bf16[o] = __float2bfloat16(acc[i][j][c]);
        else
          out_f32[o] = acc[i][j][c];
      }
}

int launch(const void* x, const void* packed, const void* scale, void* out_f32,
           void* out_bf16, int E, int M, int N, int K2, int EN, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out_f32);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out_bf16);
  if (M <= 16) {
    dim3 grid(N / 64, 1, E);
    w4a16_kernel<1, 2, 1, 4><<<grid, 128, 0, s>>>(xp, w, sc, of, ob, M, N, K2, EN);
  } else {
    dim3 grid(N / 64, (M + 63) / 64, E);
    w4a16_kernel<2, 4, 2, 2><<<grid, 128, 0, s>>>(xp, w, sc, of, ob, M, N, K2, EN);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [M, 2*K2]; packed uint8 [K2, N]; scale f32 [2*K2/128, N]. Exactly
// one of out_f32 / out_bf16 [M, N] is non-null. Needs K2 % 128 == 0,
// N % 64 == 0 and 16-byte aligned x (checked by the Python wrapper).
extern "C" int w4a16_gemm(const void* x, const void* packed, const void* scale,
                          void* out_f32, void* out_bf16, int M, int N, int K2,
                          void* stream) {
  return launch(x, packed, scale, out_f32, out_bf16, 1, M, N, K2, N, stream);
}

// x bf16 [E, M, 2*K2]; packed uint8 [K2, E*N] (folded experts); scale f32
// [2*K2/128, E*N]; out [E, M, N]. Same requirements as w4a16_gemm.
extern "C" int grouped_w4a16_gemm(const void* x, const void* packed, const void* scale,
                                  void* out_f32, void* out_bf16, int E, int M, int N,
                                  int K2, void* stream) {
  return launch(x, packed, scale, out_f32, out_bf16, E, M, N, K2, E * N, stream);
}
