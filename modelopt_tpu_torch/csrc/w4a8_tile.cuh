// The W4A8 decode tile's pieces (sm_90a) that K1's decode tile
// (w4a8_gemm.cu, dec::w4a8_dec_kernel) and the grouped kernels K11 / K12
// (grouped_w4a8_gemm.cu) share: a half-block stage of the cp.async ring,
// its loader, and the fragment builder with its int8 tensor-core products.
//
// The product is transposed, out^T = W^T x^T, so the weights are the A
// operand of mma.sync m16n8k32 (s8 x s8 -> s32) and the tokens the n8
// operand. A stage ("unit") holds 64 packed k-rows of a weight tile of 128
// columns, the x columns of TOK tokens for both nibbles, and the scale
// rows a block ends with:
//   * the raw packed tile [64][128] bytes: 16-byte chunk c of k-row r at
//     chunk c ^ (2 ((r >> 2) & 3));
//   * x [2 halves][TOK][64] bytes, chunk c of token m at chunk
//     c ^ ((m >> 1) & 3);
//   * the scale rows [2][128] f32.
// Every load a warp issues from it then falls in 32 distinct banks.
//
// Lane (g, t) of warp w loads the 32-bit words of columns c0 = 32 w + 4 g
// .. c0 + 3 at k-rows 4 t + j and 16 + 4 t + j (j < 4) of each 32-row step
// and transposes them in registers (transpose4): one word then holds four
// consecutive k of one column, an A register. A tile 0 takes columns c0
// (fragment row g) and c0 + 1 (row g + 8), tile 1 columns c0 + 2 and
// c0 + 3; the lane's x word of token 8 j + g at k 4 t (and 16 + 4 t) is its
// B register of n8 tile j. d[i][h][j][e] is then column c0 + 2 i + e / 2,
// token 8 j + 2 t + e % 2 of half h (0: 16 q_lo, 1: 16 q_hi). The nibbles
// are never widened: for a packed byte b, (b & 0xF0) read as int8 is
// exactly 16 q_hi and ((b << 4) & 0xF0) ^ 0x80 is exactly 16 q_lo.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace w4a8_tile {

constexpr int KB = 128;     // rows of one scale block
constexpr int SK = KB / 2;  // packed rows of a stage: half a block
constexpr int BN = 128;     // weight columns a CTA: 4 warps of 32
constexpr int NT = BN;      // threads a CTA

// a stage's shared memory: the raw tile, x's two halves of tok tokens, two scale rows
__host__ __device__ constexpr int stage_bytes(int tok) {
  return SK * BN + 2 * tok * SK + 2 * BN * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// the shared::cluster address of local shared memory `p` in CTA `rank` of
// the cluster, and a load from it
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// d (16 x 8 s32) += a (16 x 32 s8, row) * b (32 x 8 s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w[j]: the packed bytes of columns c .. c + 3 of k-row k + j -> col[i]:
// those of column c + i at k-rows k .. k + 3 (a 4 x 4 byte transpose)
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}
// four packed bytes -> int8 16 q_lo, 16 q_hi
__device__ __forceinline__ uint32_t lo16(uint32_t w) {
  return ((w << 4) & 0xF0F0F0F0u) ^ 0x80808080u;
}
__device__ __forceinline__ uint32_t hi16(uint32_t w) { return w & 0xF0F0F0F0u; }

// byte offset of chunk c of k-row r in a stage's raw tile
__device__ __forceinline__ int raw_offset(int r, int c) {
  return r * BN + ((c ^ (((r >> 2) & 3) << 1)) << 4);
}

// A thread's share of loading one stage, its offsets worked out once:
//  * 4 chunks of the raw tile's 64 k-rows (k-rows `wpitch` bytes apart),
//    each read only if it lies within the first `live` 16-byte chunks of
//    its k-row (the rest are past the weight's last column);
//  * up to XMAX chunks of the x columns of tokens 0 .. rows - 1 (tokens
//    `xpitch` bytes apart, the high nibbles' columns K2 bytes after the
//    low nibbles');
//  * at most one chunk of the scale rows (row h of [slo, shi]).
// issue() then takes the tile's first k-row, the low nibbles' first x
// column and the scale rows, and `srows`: the scale rows to load (bit h).
template <int TOK>
struct StageLoader {
  static constexpr int CPL = BN / 16, RAW = SK * CPL / NT;
  static constexpr int XMAX = (2 * TOK * (SK / 16) + NT - 1) / NT;
  int raw_s[RAW], raw_g[RAW], x_s[XMAX], x_g[XMAX], sc_s, sc_g, sc_h;

  __device__ __forceinline__ StageLoader(int tid, int wpitch, int live, int xpitch, int K2,
                                         int rows) {
#pragma unroll
    for (int k = 0; k < RAW; ++k) {
      const int i = tid + k * NT, r = i / CPL, c = i % CPL;
      raw_s[k] = raw_offset(r, c);
      raw_g[k] = c < live ? r * wpitch + 16 * c : -1;
    }
#pragma unroll
    for (int k = 0; k < XMAX; ++k) {
      const int i = tid + k * NT, h = i / (rows * (SK / 16)), m = (i / (SK / 16)) % rows;
      const int c = i % (SK / 16);
      x_s[k] = SK * BN + (h * TOK + m) * SK + ((c ^ ((m >> 1) & 3)) << 4);
      x_g[k] = i < 2 * rows * (SK / 16) ? h * K2 + m * xpitch + 16 * c : -1;
    }
    sc_h = tid < BN / 2 ? tid / (BN / 4) : -1;
    const int c = tid % (BN / 4);
    sc_s = SK * BN + 2 * TOK * SK + (sc_h * BN + 4 * c) * 4;
    sc_g = 4 * c;
    if (c >= 4 * live) sc_h = -1;
  }

  __device__ __forceinline__ void issue(unsigned char* s, const uint8_t* w, const int8_t* x,
                                        const float* slo, const float* shi, int srows) const {
#pragma unroll
    for (int k = 0; k < RAW; ++k)
      if (raw_g[k] >= 0) cp_async16(s + raw_s[k], w + raw_g[k]);
#pragma unroll
    for (int k = 0; k < XMAX; ++k)
      if (x_g[k] >= 0) cp_async16(s + x_s[k], x + x_g[k]);
    if (sc_h >= 0 && ((srows >> sc_h) & 1)) cp_async16(s + sc_s, (sc_h ? shi : slo) + sc_g);
  }
};

// The stage's s32 dots into d (see the header): both halves' products for
// this lane's four columns and the stage's TOK = 8 NJ tokens
template <int NJ>
__device__ __forceinline__ void stage_dots(const unsigned char* s, int c0, int g, int t,
                                           int (&d)[2][2][NJ][4]) {
  constexpr int TOK = 8 * NJ;
  const unsigned char* xs = s + SK * BN;
  const int wofs = (((c0 >> 4) ^ (t << 1)) << 4) + (c0 & 15);  // (r >> 2) & 3 == t below
#pragma unroll
  for (int ks = 0; ks < SK / 32; ++ks) {
    uint32_t raw[2][4], col[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        raw[q][j] = *reinterpret_cast<const uint32_t*>(s + (32 * ks + 16 * q + 4 * t + j) * BN +
                                                       wofs);
    transpose4(raw[0], col[0]);  // k-rows 4 t .. 4 t + 3 of the step
    transpose4(raw[1], col[1]);  // 16 + 4 t ..
    uint32_t xb[NJ][2][2];
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          xb[n][h][q] = *reinterpret_cast<const uint32_t*>(
              xs + (h * TOK + 8 * n + g) * SK + (((2 * ks + q) ^ ((g >> 1) & 3)) << 4) + 4 * t);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t alo[4] = {lo16(col[0][2 * i]), lo16(col[0][2 * i + 1]),
                               lo16(col[1][2 * i]), lo16(col[1][2 * i + 1])};
      const uint32_t ahi[4] = {hi16(col[0][2 * i]), hi16(col[0][2 * i + 1]),
                               hi16(col[1][2 * i]), hi16(col[1][2 * i + 1])};
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        mma_s8(d[i][0][n], alo, xb[n][0][0], xb[n][0][1]);
        mma_s8(d[i][1][n], ahi, xb[n][1][0], xb[n][1][1]);
      }
    }
  }
}

}  // namespace w4a8_tile
