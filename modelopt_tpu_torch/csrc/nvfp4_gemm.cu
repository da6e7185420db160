// NVFP4 weight GEMMs for Hopper (sm_90a): bf16 activations x e2m1 weights
// with e4m3 block-16 scales and one f32 scale2, on the bf16 tensor cores
// (f32 accumulate). One kernel of each tile serves the plain and the
// grouped (per-expert) product.
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
// scale bytes (K/2 + K/16 per column) over 3.35 TB/s of HBM; at M = 128
// and N = 98304 the bf16 multiply-adds over the 989 TFLOP/s of the tensor
// cores.
//
// Decode tile (M <= 16): mma.sync m16n8k16, one CTA of 4 warps per 16 x 64
// output tile and expert, a loop over 128 packed rows at a time. Per step
// the CTA stages both halves' x columns, the packed [128, 64] tile
// transposed on the way in (4x4 byte transposes in registers, one 32-bit
// word = four consecutive k of one column) and the 2 x 8 scale rows of the
// step. One MMA k-step of 16 rows is one scale block of one half, so a
// thread's four weights of a fragment share one scale. Where the output
// has too few tiles to keep HBM busy (N = 512: 8 CTAs), the wrapper splits
// the packed rows over `splits` CTAs per tile: each writes its f32 partial
// sum, and a second kernel adds the partials in split order
// (deterministic), applies scale2 and rounds to the output type.
//
// Tile above M = 16: K6's prefill tile (w4a16_gemm.cu, wgmma_tile.cuh),
// wgmma m64nBTk16 .f32.bf16.bf16 with the product transposed, out^T =
// W^T x^T, so that the weights are the A operand in registers and x the B
// operand, K-major in shared memory:
//  * a CTA of two warpgroups owns 128 weight columns (64 each) and BT
//    tokens: 128 where that leaves at least half the SMs a CTA, else 64;
//    the grid runs token tiles fastest (they share the weight tile in L2);
//  * a stage is one half of a 128-row block: thread 0 loads its x columns
//    (two 64-column boxes, a 3-D map over [E, M, K], rows past M zeros), its
//    8 e4m3 scale rows [8, 128] and, with a low half, the raw packed
//    [128, 128] tile (128-byte swizzle) by TMA onto an mbarrier, in a ring
//    of 4 stages, and refills a stage once all 8 warps released it (each
//    after its own reads of the raw tile and the scales);
//  * the codes go from the raw tile straight into A fragments (a thread's
//    two fragment rows are two adjacent weight columns: one 16-bit load per
//    k-row, two byte permutes, the e2m1 decode), each times its column's
//    block scale in bf16: one wgmma k16 step is one scale block of one half;
//  * so the scales are in the weights and a warpgroup keeps one f32
//    accumulator over its whole K walk, and scale2 multiplies once at the
//    end. A half's 8 products run while the next half's fragments are
//    built;
//  * where the output has few tiles (N = 512 at M = 128: 8), a thread-block
//    cluster of R in {1, 2, 4, 8} CTAs shares one tile, rank r walking a
//    contiguous run of the blocks; the ranks' f32 partials go to shared
//    memory and, after a cluster barrier, the rank that owns each slice of
//    the tile sums them in rank order over distributed shared memory. One
//    launch either way, and no second reduce launch as at M <= 16; the
//    Python wrapper picks R (64 tokens a CTA when R > 1).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "cluster_decode.cuh"  // the shared memory limit
#include "wgmma_tile.cuh"

namespace {

namespace cg = cooperative_groups;

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

__global__ void __launch_bounds__(128)
nvfp4_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
             const uint8_t* __restrict__ scale, const float* __restrict__ scale2,
             float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16,
             float* __restrict__ part, int M, int N, int K2, int EN, int splits) {
  constexpr int MT = 1, NT = 2, WM = 1, WN = 4;  // 4 warps of 16 x 16
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

// ---------------------------------------------------------------------------
// tile above M = 16: bf16 wgmma, x, the raw weight tile and the scales by TMA
// ---------------------------------------------------------------------------
namespace wg {

using namespace wgmma_tile;

constexpr int BN = 128;         // weight columns a CTA: two warpgroups of 64
constexpr int NU = 4;           // TMA stages: one half (lo or hi) of a block each
constexpr int NWB = 2;          // raw weight tiles in flight
constexpr int NT = 256;         // threads a CTA
constexpr int WT = KB * BN;     // the raw packed [128, BN] tile
constexpr int SB = KB / BLK;    // scale rows of one half of a block
constexpr int ST = SB * BN;     // a half's 8 e4m3 scale rows [8, BN]

// BT tokens a CTA (the wgmma's N): 64 or 128, chosen by launch() from M and
// the CTAs each gives
template <int BT>
struct Tile {
  static constexpr int XB = BT * 128;   // one TMA box of x: BT rows x 64 bf16 (128 bytes)
  static constexpr int XU = 2 * XB;     // one stage's x: a half's two 64-column boxes
  static constexpr int SMEM = 1024 + NU * XU + NWB * WT + NU * ST + 2 * NU * 8;
};

// Stages are halves of blocks: unit u = 2 blk + half holds x's two
// 64-column boxes of that half, its 8 scale rows and, for a low half, the
// block's raw weight tile (in a ring of NWB). Thread 0 loads unit u + NU
// once all 8 warps have released unit u (an mbarrier of eight arrivals: a
// warpgroup's products retiring does not mean its other warps are done
// reading the raw tile or the scales). A warp builds the high half's
// fragments of a block before it releases the low half, whose refill
// overwrites that block's raw tile.
// A-fragment row r of warp w holds weight column 16 w + 2 (r % 8) + r / 8
// of its warpgroup's 64; its accumulator's rows 2 r and 2 r + 1 are the
// columns c0 and c0 + 1.
template <int BT>
__global__ void __launch_bounds__(NT, 1)
nvfp4_wg_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap smap, const float* __restrict__ scale2,
                float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16, int M, int N,
                int K2, int R) {
  using T = Tile<BT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                      // [NU][box][BT][128 B], swizzled
  unsigned char* wr = xs + NU * T::XU;           // [NWB][128][BN] raw, swizzled
  unsigned char* sc = wr + NWB * WT;             // [NU][8][BN] e4m3
  const uint32_t full = smem_u32(sc + NU * ST);  // NU mbarriers: the unit landed
  const uint32_t empty = full + 8 * NU;          // NU mbarriers: all 8 warps are done

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgi = warp >> 2, wiw = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int rank = blockIdx.x % R, m0 = (blockIdx.x / R) * BT, n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int nblk = K2 / KB;
  const int b0 = rank * nblk / R, nb = (rank + 1) * nblk / R - b0;  // this rank's blocks
  const int nunits = 2 * nb;
  const int c0 = 64 * wgi + 16 * wiw + 2 * gid;  // this thread's two weight columns

  // unit u: half u & 1 of the rank's block u >> 1
  auto load_unit = [&](int u) {
    const int st = u % NU, blk = b0 + (u >> 1), half = u & 1;
    const uint32_t bar = full + 8 * st, xb = smem_u32(xs + st * T::XU);
    mbar_expect_tx(bar, T::XU + ST + (half == 0 ? WT : 0));
#pragma unroll
    for (int box = 0; box < 2; ++box)
      tma_load3(xb + box * T::XB, &xmap, half * K2 + blk * KB + 64 * box, m0, e, bar);
    tma_load2(smem_u32(sc + st * ST), &smap, e * N + n0, (half * K2 + blk * KB) / BLK, bar);
    if (half == 0)
      tma_load2(smem_u32(wr + ((u >> 1) % NWB) * WT), &wmap, e * N + n0, blk * KB, bar);
  };
  // A fragments of unit u (8 k-steps): k-rows 16 ks + 2 tig (+1, +8, +9)
  // of the thread's two columns, each times its column's block scale
  auto fragments = [&](uint32_t (&a)[8][4], int u) {
    const unsigned char* t = wr + ((u >> 1) % NWB) * WT;
    const unsigned char* s = sc + (u % NU) * ST;
    const int shift = 4 * (u & 1);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * ks + 2 * tig + (j & 1) + 8 * (j >> 1);
        w[j] = *reinterpret_cast<const uint16_t*>(t + r * BN + ((((c0 >> 4) ^ (r & 7)) << 4) |
                                                                (c0 & 15)));
      }
      // bytes (k, column): p0 = (2t, c) (2t+1, c) (2t, c+1) (2t+1, c+1), p1 the same 8 rows on
      const uint32_t p0 = (__byte_perm(w[0], w[1], 0x5140) >> shift) & 0x0F0F0F0Fu;
      const uint32_t p1 = (__byte_perm(w[2], w[3], 0x5140) >> shift) & 0x0F0F0F0Fu;
      const uint32_t sv = *reinterpret_cast<const uint16_t*>(s + ks * BN + c0);
      const __nv_bfloat162 s0 = e4m3_to_bf16x2((uint8_t)(sv & 0xFF));
      const __nv_bfloat162 s1 = e4m3_to_bf16x2((uint8_t)(sv >> 8));
      uint32_t c00, c01, c10, c11;
      e2m1x4_to_bf16(p0, c00, c01);  // column c: k 2t, 2t+1 | column c+1
      e2m1x4_to_bf16(p1, c10, c11);  // the same at k 2t+8, 2t+9
      a[ks][0] = scaled(c00, s0);
      a[ks][1] = scaled(c01, s1);
      a[ks][2] = scaled(c10, s0);
      a[ks][3] = scaled(c11, s1);
    }
  };
  float d[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) d[i] = 0.f;
  // the 8 products of unit u into d, one commit group
  auto products = [&](const uint32_t (&a)[8][4], int u) {
    const uint32_t xb = smem_u32(xs + (u % NU) * T::XU);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_rs(d, a[ks], desc(xb + (ks >> 2) * T::XB + 32 * (ks & 3)), 1);
    wgmma_commit();
  };
  // unit u's products done and this warp's reads of its raw tile and
  // scales too: release its stage (one arrival per warp, after the warp's
  // lanes are done), and thread 0 refills it with unit u + NU once all
  // warps have
  auto release = [&](int u) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (u % NU));
    if (tid == 0 && u + NU < nunits) {
      mbar_wait(empty + 8 * (u % NU), (u / NU) & 1);
      load_unit(u + NU);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NU; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int u = 0; u < NU && u < nunits; ++u) load_unit(u);
  }
  __syncthreads();

  uint32_t alo[8][4], ahi[8][4];
  mbar_wait(full, 0);
  fragments(alo, 0);
  // every product is issued unconditionally (a wgmma in a branch is
  // serialized by ptxas)
  for (int blk = 0; blk < nb; ++blk) {
    const int ulo = 2 * blk, uhi = ulo + 1;
    products(alo, ulo);
    mbar_wait(full + 8 * (uhi % NU), (uhi / NU) & 1);
    fragments(ahi, uhi);  // the raw tile landed with unit ulo
    wgmma_wait();
    fence_regs(d);
    release(ulo);
    products(ahi, uhi);
    if (blk + 1 < nb) {
      mbar_wait(full + 8 * ((ulo + 2) % NU), ((ulo + 2) / NU) & 1);
      fragments(alo, ulo + 2);
    }
    wgmma_wait();
    fence_regs(d);
    release(uhi);
  }

  const float s2 = scale2[0];
  auto store = [&](int m, int col, float v0, float v1) {  // columns col and col + 1
    const size_t o = ((size_t)e * M + m) * N + n0 + col;
    if (out_bf16 != nullptr)
      *reinterpret_cast<__nv_bfloat162*>(out_bf16 + o) = __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(out_f32 + o) = make_float2(v0, v1);
  };
  if (R > 1) {
    // the cluster's sum: every rank's f32 partial [BT][BN] to its x stages
    // (free once all warps are past the walk); rank r owns columns
    // [r BN / R, (r + 1) BN / R) and adds the ranks' partials in rank
    // order. Every CTA reaches both barriers; the second keeps each CTA's
    // shared memory alive while another still reads it.
    float* part = reinterpret_cast<float*>(xs);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part[(8 * j + 2 * tig + (c & 1)) * BN + c0 + (c >> 1)] = d[4 * j + c];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int pairs = BN / R / 2;  // column pairs a rank owns
    for (int i = tid; i < BT * pairs; i += NT) {
      const int tok = i / pairs, col = rank * (BN / R) + 2 * (i % pairs);
      if (m0 + tok >= M || n0 + col >= N) continue;
      float2 v = *reinterpret_cast<const float2*>(cluster.map_shared_rank(part, 0) + tok * BN + col);
      for (int q = 1; q < R; ++q) {
        const float2 p =
            *reinterpret_cast<const float2*>(cluster.map_shared_rank(part, q) + tok * BN + col);
        v = make_float2(__fadd_rn(v.x, p.x), __fadd_rn(v.y, p.y));
      }
      store(m0 + tok, col, __fmul_rn(v.x, s2), __fmul_rn(v.y, s2));
    }
    cluster.sync();
    return;
  }
  if (n0 + c0 >= N) return;  // (N % 128 == 64: the last tile's right half)
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = m0 + 8 * j + 2 * tig + c;
      if (m < M) store(m, c0, __fmul_rn(d[4 * j + c], s2), __fmul_rn(d[4 * j + 2 + c], s2));
    }
}

template <int BT>
int launch(const __nv_bfloat16* x, const uint8_t* w, const uint8_t* sc, const float* s2,
           float* of, __nv_bfloat16* ob, int E, int M, int N, int K2, int EN, int R,
           cudaStream_t s) {
  using T = Tile<BT>;
  CUtensorMap xmap, wmap, smap;
  if (!x_map(&xmap, x, E, M, 2 * K2, BT) ||
      !byte_map(&wmap, w, K2, EN, KB, BN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !byte_map(&smap, sc, 2 * K2 / BLK, EN, SB, BN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  static unsigned done = 0;  // devices whose shared memory limit is raised
  const int err = cluster_decode::allow_smem(nvfp4_wg_kernel<BT>, T::SMEM, done);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + BT - 1) / BT * R, (N + BN - 1) / BN, E);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, nvfp4_wg_kernel<BT>, xmap, wmap, smap, s2, of, ob, M, N,
                                 K2, R);
}

}  // namespace wg

int launch(const void* x, const void* packed, const void* scale, const void* scale2,
           void* out_f32, void* out_bf16, void* part, int E, int M, int N, int K2, int EN,
           int splits, int ranks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const uint8_t* sc = static_cast<const uint8_t*>(scale);
  const float* s2 = static_cast<const float*>(scale2);
  float* of = static_cast<float*>(out_f32);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out_bf16);
  float* pp = splits > 1 ? static_cast<float*>(part) : nullptr;
  if (M > 16) {
    if (splits != 1 || (ranks != 1 && ranks != 2 && ranks != 4 && ranks != 8) ||
        ranks > K2 / KB)
      return (int)cudaErrorInvalidValue;
    // 128 tokens a CTA halve the fragment work per product, where that still
    // leaves at least half the SMs a CTA (and the blocks are not split);
    // else 64
    const long ctas128 = (long)((M + 127) / 128) * ((N + wg::BN - 1) / wg::BN) * E;
    if (ranks == 1 && M > 64 && 2 * ctas128 >= wgmma_tile::sm_count())
      return wg::launch<128>(xp, w, sc, s2, of, ob, E, M, N, K2, EN, 1, s);
    return wg::launch<64>(xp, w, sc, s2, of, ob, E, M, N, K2, EN, ranks, s);
  }
  if (ranks != 1) return (int)cudaErrorInvalidValue;
  dim3 grid(N / 64, 1, E * splits);
  nvfp4_kernel<<<grid, 128, 0, s>>>(xp, w, sc, s2, of, ob, pp, M, N, K2, EN, splits);
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
// CTAs that share one output tile's packed rows (M <= 16: 1 <= splits <=
// K2 / 128; M > 16: 1); above 1, part is f32 scratch of [splits, M, N].
// ranks: above M = 16, the CTAs of one cluster that share an output tile
// (1, 2, 4 or 8, at most K2 / 128); 1 at M <= 16.
// Needs K2 % 128 == 0, N % 64 == 0 and 16-byte aligned x, packed and scale
// (checked by the Python wrapper).
extern "C" int nvfp4_gemm(const void* x, const void* packed, const void* scale,
                          const void* scale2, void* out_f32, void* out_bf16, void* part,
                          int M, int N, int K2, int splits, int ranks, void* stream) {
  return launch(x, packed, scale, scale2, out_f32, out_bf16, part, 1, M, N, K2, N, splits,
                ranks, stream);
}

// x bf16 [E, M, 2*K2]; packed uint8 [K2, E*N] (folded experts); scale e4m3
// [2*K2/16, E*N]; scale2 f32 [1]; out [E, M, N]; part f32 [E, splits, M, N]
// when splits > 1. Same requirements as nvfp4_gemm.
extern "C" int grouped_nvfp4_gemm(const void* x, const void* packed, const void* scale,
                                  const void* scale2, void* out_f32, void* out_bf16,
                                  void* part, int E, int M, int N, int K2, int splits,
                                  int ranks, void* stream) {
  return launch(x, packed, scale, scale2, out_f32, out_bf16, part, E, M, N, K2, E * N,
                splits, ranks, stream);
}
