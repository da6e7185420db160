// NVFP4 weight GEMMs for Hopper (sm_90a): bf16 activations x e2m1 weights
// with e4m3 block-16 scales and one f32 scale2, on the bf16 tensor cores
// (mma.sync m16n8k16, f32 accumulate). One template serves the plain and
// the grouped (per-expert) product.
//
// Replaces: modelopt_tpu/kernels/quant_gemm.py::nvfp4_gemm (Pallas body
// _nvfp4_kernel, decode _decode_e2m1) and ::grouped_nvfp4_gemm
// (_grouped_nvfp4_kernel, the same body over a grid of (expert, N-tile)).
//
// Layout (quant/qtensor.py::quantize_nvfp4): packed uint8 [K/2, EN] with
// EN = E*N (the folded expert layout: expert e is columns e*N..e*N+N-1;
// E = 1 for the plain product). The low nibble of row p holds weight row p,
// the high nibble weight row K/2+p, each an e2m1 code (bit 3 the sign,
// magnitudes 0, .5, 1, 1.5, 2, 3, 4, 6). scale e4m3 [K/16, EN]: row r
// scales weight rows 16r..16r+15, so rows [0, K/32) the low half.
// scale2 f32 [1] (read on the card: no host sync).
//
// Numerics, as the reference: Hopper has no FP4 MMA, so each weight is
// decoded to bf16 in registers and multiplied by its block scale in bf16.
// An e2m1 value has at most 2 significant bits and an e4m3 scale at most
// 4, so the product (at most 6 bits, within bf16's range) is exact: the
// bf16 weight equals the reference's f32 decode * scale rounded to bf16.
// The bf16 MMA sums into f32; scale2 multiplies the f32 sum once, then the
// result rounds to the output type.
//
// Decode: four codes (one per byte, k order) at a time. Their magnitude
// indices (code & 7) become the nibbles of a byte-permute selector that
// picks each bf16's high and low byte from two 8-entry tables held in
// registers; the sign is code bit 3 moved to bit 15. No table in memory.
//
// What bounds it on an H100: at decode (M <= 16) the packed weight and
// scale bytes (K/2 + K/16 per column) over 3.35 TB/s of HBM. This first
// version is a plain mma.sync tile without TMA, wgmma or a multi-stage
// pipeline: latency is hidden only by the several CTAs resident on each
// SM.
//
// Design (the K6 w4a16_gemm tile): one CTA per (BM x BN) output tile and
// expert, a loop over 128 packed rows at a time. Per step the CTA stages
// both halves' x columns, the packed [128, BN] tile transposed on the way
// in (4x4 byte transposes in registers, one 32-bit word = four consecutive
// k of one column) and the 2 x 8 scale rows of the step. One MMA k-step of
// 16 rows is one scale block of one half, so a thread's four weights of a
// fragment share one scale. Two tilings: 16x64 (4 warps of 16x16) for
// M <= 16, 64x64 (4 warps of 32x32) above. Where the output has too few
// tiles to keep HBM busy (N = 512 at decode: 8 CTAs), the wrapper splits
// the packed rows over `splits` CTAs per tile: each writes its f32 partial
// sum, and a second kernel adds the partials in split order
// (deterministic), applies scale2 and rounds to the output type.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int KB = 128;      // packed rows of one staging step (8 scale blocks a half)
constexpr int BLK = 16;      // weight rows of one e4m3 scale
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

// four e2m1 codes (the low nibble of each byte of `codes`, k order) ->
// two bf16x2 (bytes 0, 1 -> w01; bytes 2, 3 -> w23), exact. The magnitudes
// 0, .5, 1, 1.5, 2, 3, 4, 6 are the bf16s 0x0000 0x3F00 0x3F80 0x3FC0
// 0x4000 0x4040 0x4080 0x40C0: high bytes 00 3F 3F 3F 40 40 40 40, low
// bytes 00 00 80 C0 00 40 80 C0.
__device__ __forceinline__ void e2m1x4_to_bf16(uint32_t codes, uint32_t& w01, uint32_t& w23) {
  const uint32_t idx = codes & 0x07070707u;
  // selector nibbles 0..3 = the four magnitude indices
  const uint32_t sel = __byte_perm(idx | (idx >> 4), 0u, 0x4420);
  const uint32_t hi = __byte_perm(0x3F3F3F00u, 0x40404040u, sel);
  const uint32_t lo = __byte_perm(0xC0800000u, 0xC0804000u, sel);
  w01 = __byte_perm(lo, hi, 0x5140) | ((codes << 12) & 0x00008000u) |
        ((codes << 20) & 0x80000000u);
  w23 = __byte_perm(lo, hi, 0x7362) | ((codes >> 4) & 0x00008000u) |
        ((codes << 4) & 0x80000000u);
}

__device__ __forceinline__ uint32_t scaled(uint32_t w, __nv_bfloat162 s) {
  __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&w), s);
  return *reinterpret_cast<uint32_t*>(&v);
}

// one e4m3 scale byte -> bf16x2 (both lanes), exact
__device__ __forceinline__ __nv_bfloat162 e4m3_to_bf16x2(uint8_t v) {
  __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)v, __NV_E4M3);
  return __float2bfloat162_rn(__half2float(*reinterpret_cast<__half*>(&h)));
}

template <int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
nvfp4_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
             const uint8_t* __restrict__ scale, const float* __restrict__ scale2,
             float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16,
             float* __restrict__ part, int M, int N, int K2, int EN, int splits) {
  constexpr int BM = WM * MT * 16;
  constexpr int BN = WN * NT * 8;
  constexpr int NTH = 32 * WM * WN;
  constexpr int SB = KB / BLK;  // scale rows of one half per step
  __shared__ __align__(16) __nv_bfloat16 xs[2][BM][XP];
  __shared__ __align__(16) uint8_t wt[BN][WP];
  __shared__ __align__(16) uint8_t ss[2][SB][BN];

  const int e = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
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
  const int nsrow_half = K2 / BLK;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // this CTA's packed rows: steps [s * steps / splits, (s + 1) * steps / splits)
  const int steps = K2 / KB;
  const int p_end = (int)((long)(split + 1) * steps / splits) * KB;
  for (int p0 = (int)((long)split * steps / splits) * KB; p0 < p_end; p0 += KB) {
    // x columns of this step: low half at p0, high half at K2 + p0
    for (int i = tid; i < 2 * BM * (KB / 8); i += NTH) {
      const int half = i / (BM * (KB / 8));
      const int r = (i / (KB / 8)) % BM;
      const int c = i % (KB / 8);
      const int m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + half * K2 + p0 + c * 8);
      *reinterpret_cast<uint4*>(&xs[half][r][c * 8]) = v;
    }
    // packed [KB, BN] tile, transposed to wt[n][k] 4 rows x 4 columns at a time
    for (int i = tid; i < (KB / 4) * (BN / 4); i += NTH) {
      const int kr = (i / (BN / 4)) * 4;
      const int nc = (i % (BN / 4)) * 4;
      const uint8_t* src = w + (size_t)(p0 + kr) * EN + n0 + nc;
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
    // the step's scale rows: low half p0/16.., high half K2/16 + p0/16..
    for (int i = tid; i < 2 * SB * (BN / 4); i += NTH) {
      const int half = i / (SB * (BN / 4));
      const int r = (i / (BN / 4)) % SB;
      const int c = (i % (BN / 4)) * 4;
      const size_t row = (size_t)half * nsrow_half + p0 / BLK + r;
      *reinterpret_cast<uint32_t*>(&ss[half][r][c]) =
          *reinterpret_cast<const uint32_t*>(scale + row * EN + n0 + c);
    }
    __syncthreads();

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
        const __nv_bfloat162 slo = e4m3_to_bf16x2(ss[0][ks][c]);
        const __nv_bfloat162 shi = e4m3_to_bf16x2(ss[1][ks][c]);
        uint32_t l01, l23, h01, h23;
        e2m1x4_to_bf16(wv & 0x0F0F0F0Fu, l01, l23);
        e2m1x4_to_bf16((wv >> 4) & 0x0F0F0F0Fu, h01, h23);
        const uint32_t blo0 = scaled(l01, slo), blo1 = scaled(l23, slo);
        const uint32_t bhi0 = scaled(h01, shi), bhi1 = scaled(h23, shi);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], alo[i], blo0, blo1);
          mma_bf16(acc[i][j], ahi[i], bhi0, bhi1);
        }
      }
    }
    __syncthreads();
  }

  const float s2 = scale2[0];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + wm * MT * 16 + i * 16 + g + ((c & 2) ? 8 : 0);
        if (m >= M) continue;
        const size_t o = (size_t)m * N + n0 + wn * NT * 8 + j * 8 + 2 * t + (c & 1);
        if (part != nullptr) {  // a split of the packed rows: its raw f32 sum
          part[((size_t)e * splits + split) * M * N + o] = acc[i][j][c];
          continue;
        }
        const float v = __fmul_rn(acc[i][j][c], s2);
        if (out_bf16 != nullptr)
          out_bf16[obase + o] = __float2bfloat16(v);
        else
          out_f32[obase + o] = v;
      }
}

// out[e, m, n] = (sum over splits s in order of part[e, s, m, n]) * scale2
__global__ void __launch_bounds__(256)
nvfp4_reduce_splits(const float* __restrict__ part, const float* __restrict__ scale2,
                    float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16, int E,
                    int splits, int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t MN = (size_t)M * N;
  if (i >= (size_t)E * MN) return;
  const float* p = part + (i / MN) * splits * MN + i % MN;
  float acc = p[0];
  for (int s = 1; s < splits; ++s) acc = __fadd_rn(acc, p[s * MN]);
  const float v = __fmul_rn(acc, scale2[0]);
  if (out_bf16 != nullptr)
    out_bf16[i] = __float2bfloat16(v);
  else
    out_f32[i] = v;
}

int launch(const void* x, const void* packed, const void* scale, const void* scale2,
           void* out_f32, void* out_bf16, void* part, int E, int M, int N, int K2, int EN,
           int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const uint8_t* sc = static_cast<const uint8_t*>(scale);
  const float* s2 = static_cast<const float*>(scale2);
  float* of = static_cast<float*>(out_f32);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out_bf16);
  float* pp = splits > 1 ? static_cast<float*>(part) : nullptr;
  if (M <= 16) {
    dim3 grid(N / 64, 1, E * splits);
    nvfp4_kernel<1, 2, 1, 4><<<grid, 128, 0, s>>>(xp, w, sc, s2, of, ob, pp, M, N, K2, EN,
                                                   splits);
  } else {
    dim3 grid(N / 64, (M + 63) / 64, E * splits);
    nvfp4_kernel<2, 4, 2, 2><<<grid, 128, 0, s>>>(xp, w, sc, s2, of, ob, pp, M, N, K2, EN,
                                                   splits);
  }
  if (pp != nullptr) {
    const size_t n_out = (size_t)E * M * N;
    nvfp4_reduce_splits<<<(unsigned)((n_out + 255) / 256), 256, 0, s>>>(pp, s2, of, ob, E,
                                                                        splits, M, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [M, 2*K2]; packed uint8 [K2, N]; scale e4m3 [2*K2/16, N]; scale2
// f32 [1]. Exactly one of out_f32 / out_bf16 [M, N] is non-null. splits:
// CTAs that share one output tile's packed rows (1 <= splits <= K2 / 128);
// above 1, part is f32 scratch of [splits, M, N]. Needs K2 % 128 == 0,
// N % 64 == 0 and 16-byte aligned x (checked by the Python wrapper).
extern "C" int nvfp4_gemm(const void* x, const void* packed, const void* scale,
                          const void* scale2, void* out_f32, void* out_bf16, void* part,
                          int M, int N, int K2, int splits, void* stream) {
  return launch(x, packed, scale, scale2, out_f32, out_bf16, part, 1, M, N, K2, N, splits,
                stream);
}

// x bf16 [E, M, 2*K2]; packed uint8 [K2, E*N] (folded experts); scale e4m3
// [2*K2/16, E*N]; scale2 f32 [1]; out [E, M, N]; part f32 [E, splits, M, N]
// when splits > 1. Same requirements as nvfp4_gemm.
extern "C" int grouped_nvfp4_gemm(const void* x, const void* packed, const void* scale,
                                  const void* scale2, void* out_f32, void* out_bf16,
                                  void* part, int E, int M, int N, int K2, int splits,
                                  void* stream) {
  return launch(x, packed, scale, scale2, out_f32, out_bf16, part, E, M, N, K2, E * N,
                splits, stream);
}
