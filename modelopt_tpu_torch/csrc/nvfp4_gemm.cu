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
// scale2 f32 [1] (read on the card: no host sync). K/2 is whole 128-row
// blocks and at most one tail of 64 packed rows (K/2 % 128 == 64:
// DeepSeek-V2-Lite's experts at K = 1408, K/2 = 5 x 128 + 64): the
// reference's K % 128 == 0 rule for its NVFP4 kernel. The scales are in
// the weights and the walk keeps one f32 sum, so the tail is four k16 steps
// a half at the end of the walk, counted as one block by the cluster split.
//
// Numerics, as the reference: Hopper has no FP4 MMA, so each weight is
// decoded to bf16 in registers and multiplied by its block scale in bf16.
// An e2m1 value has at most 2 significant bits and an e4m3 scale at most
// 4, so the product (at most 6 bits, within bf16's range) is exact: the
// bf16 weight equals the reference's f32 decode * scale rounded to bf16.
// The bf16 MMA sums into f32; scale2 multiplies the f32 sum once, then the
// result rounds to the output type.
//
// Decode: two codes (k order) at a time, a bf16x2. One integer multiply
// and one mask make each code's bits the bf16 of 2^-126 times its value
// (0 and 0.5 are bf16 subnormals), one bf16 multiply by 2^126 the value and
// one by the column's block scale the weight: three integer operations, a
// byte permute and two bf16 multiplies a pair of weights. The block scales
// go to bf16 by the card's e4m3x2 -> f16x2 conversion (e4m3.cuh).
//
// What bounds it on an H100: at decode (M <= 16) the packed weight and
// scale bytes (K/2 + K/16 per column) over 3.35 TB/s of HBM; at M = 128
// and N = 98304 the bf16 multiply-adds over the 989 TFLOP/s of the tensor
// cores.
//
// Both tiles run the product transposed, out^T = W^T x^T: the weights are
// the MMA's A operand, built in registers straight from the raw packed tile
// in shared memory by one fragment builder (a thread's two fragment rows are
// two adjacent weight columns: byte permutes of the raw k-rows, the e2m1
// decode, each weight times its column's e4m3 block scale in bf16: one MMA
// k16 step is one scale block of one half), and x is the B operand,
// K-major as it lies in device memory. No byte is transposed and no bf16
// weight tile is written. So the scales are in the weights, each tile keeps
// one f32 accumulator over its K walk, and scale2 multiplies it once.
//
// Decode tile (M <= 16): mma.sync m16n8k16, one CTA of 4 warps per 64
// weight columns (16 a warp) and 8 or 16 tokens (one or two n8 tiles) and
// expert; 128 columns (32 a warp: one 32-bit load of a k-row feeds two m16
// tiles) at up to 8 tokens where the blocks are not split and that leaves
// two CTAs an SM (the folded gate / up and K13's experts at decode). Each
// CTA streams its 128-row blocks through a ring of 3 cp.async stages (the
// raw packed tile, the block's 16 e4m3 scale rows, both halves' x rows),
// so the next blocks' bytes are in flight while a block's MMAs run, and
// each warp converts its columns' scales of a block once into a table of
// bf16 pairs, so a fragment's scale is one shared load. Where the output
// has few tiles, a thread-block cluster of R in {1, 2, 4, 8} CTAs shares
// one tile: rank r walks a contiguous run of the blocks, writes its f32
// partial to shared memory (the ring, after the walk), and after a cluster
// barrier the rank that owns each slice of the tile sums the ranks'
// partials in rank order over distributed shared memory, applies scale2
// and rounds once. One launch, no scratch tensor, a deterministic sum; the
// Python wrapper picks R.
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
//    the tile sums them in rank order over distributed shared memory, as
//    the decode tile's; the Python wrapper picks R (64 tokens a CTA when
//    R > 1).
//
// The tail has instances of its own (kTail; the aligned ones are
// unchanged): the decode tile's tail stage carries 64 packed rows, 4 scale
// rows a half and both halves' x columns of the tail, and zeros in the
// rest of the stage (cp.async's zero fill), which its k-steps 4-7 multiply
// (+0 products, and no branch in the product loop); in the wgmma tile the tail block's raw [128, 128] box
// reads zero bytes past row K/2 (code 0 with scale 0 or a finite scale is
// +0), each tail unit loads one 64-column x box (a second would read the
// other half's x or past K), and its k-steps 4-7 take a zeroed box of
// shared memory as x: +0 products, issued like every other (a wgmma in a
// branch is serialized).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "cluster_decode.cuh"  // cp.async, the shared memory limit
#include "wgmma_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int KB = 128;      // packed rows of one block (a decode stage; two wgmma stages)
constexpr int BLK = 16;      // weight rows of one e4m3 scale
constexpr int SB = KB / BLK; // scale rows of one half of a block

// cp.async of 16 bytes, or of none (`in` false): the 16 bytes at dst are
// zero-filled, src is not read
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two e2m1 codes -> bf16x2, exact: n holds their packed bytes at bits 0-7
// and 16-23, `half` 0 takes the low nibbles, 1 the high ones. Each
// code's magnitude bits e1 e0 m become the bf16's two lowest exponent bits
// and its top mantissa bit, its sign bit 15: one multiply puts the nibble
// at bits 6-9 and 12-15 (the two copies do not overlap) and one mask keeps
// bits 6-8 and 15. Then e1 e0 = 0 is a bf16 subnormal (codes 0 and 1: 0,
// 2^-127) and e1 e0 > 0 a normal, each exactly 2^-126 times the code's
// value (0, .5, 1, 1.5, 2, 3, 4, 6), which one bf16 multiply by 2^126 turns
// into the value.
__device__ __forceinline__ uint32_t e2m1x2_to_bf16x2(uint32_t n, int half) {
  const uint32_t v = half == 0 ? (n & 0x000F000Fu) * 4160u : (n & 0x00F000F0u) * 260u;
  return bits(__hmul2(as_bf16x2(v & 0x81C081C0u), as_bf16x2(0x7E807E80u)));  // x 2^126
}

// A fragments of one k16 step, which is one scale block of one half, for
// two adjacent weight columns c and c + 1 (fragment rows g and g + 8): p0
// holds the raw packed bytes (k, column) (2t, c) (2t+1, c) (2t, c+1)
// (2t+1, c+1), p1 the same at k-rows 2t+8, 2t+9; `half` 0 takes their low
// nibbles (the low half of K), 1 the high ones; s0, s1 the two columns'
// block scales, bf16 in both lanes. Each weight times its scale is exact
// in bf16.
__device__ __forceinline__ void scaled_fragments(uint32_t p0, uint32_t p1, int half,
                                                 uint32_t s0, uint32_t s1, uint32_t (&a)[4]) {
  // a fragment register's two k-rows of one column: bytes 0 and 2
  a[0] = bits(__hmul2(as_bf16x2(e2m1x2_to_bf16x2(__byte_perm(p0, 0u, 0x4140), half)),
                      as_bf16x2(s0)));
  a[1] = bits(__hmul2(as_bf16x2(e2m1x2_to_bf16x2(__byte_perm(p0, 0u, 0x4342), half)),
                      as_bf16x2(s1)));
  a[2] = bits(__hmul2(as_bf16x2(e2m1x2_to_bf16x2(__byte_perm(p1, 0u, 0x4140), half)),
                      as_bf16x2(s0)));
  a[3] = bits(__hmul2(as_bf16x2(e2m1x2_to_bf16x2(__byte_perm(p1, 0u, 0x4342), half)),
                      as_bf16x2(s1)));
}

// two e4m3 block scales (the low 16 bits of p) -> each one's bf16 in both
// lanes, exact
__device__ __forceinline__ void scale_pairs(uint32_t p, uint32_t& s0, uint32_t& s1) {
  const uint32_t t = e4m3x2_to_bf16x2(p);
  s0 = __byte_perm(t, 0u, 0x1010);
  s1 = __byte_perm(t, 0u, 0x3232);
}

// ---------------------------------------------------------------------------
// decode tile (M <= 16): mma.sync, the blocks split over a cluster
// ---------------------------------------------------------------------------
namespace dec {

constexpr int NS = 3;    // cp.async stages, one block each
constexpr int NT = 128;  // threads a CTA

// AT m16 tiles a warp (BN = 64 AT weight columns a CTA of 4 warps) and
// TOK = 8 MT tokens (MT n8 tiles of the transposed product)
template <int MT, int AT>
struct Tile {
  static constexpr int BN = 64 * AT;
  static constexpr int CH = BN / 16;      // 16-byte chunks of a k-row of the raw tile
  static constexpr int WB = KB * BN;      // the raw packed [128, BN] tile
  static constexpr int SCB = 2 * SB * BN; // the block's 16 e4m3 scale rows [16, BN]
  static constexpr int TOK = 8 * MT;
  static constexpr int XB = 2 * TOK * KB * 2;  // both halves' x rows, bf16
  static constexpr int BYTES = WB + SCB + XB;  // a stage
  // the ring, then the scale table (the scale rows as bf16 pairs (s, s));
  // after the walk the ring holds the rank's f32 partial
  static constexpr int SMEM = NS * BYTES + 4 * SCB;
  static_assert(TOK * BN * 4 <= NS * BYTES, "the partial fits in the ring");
};

// Shared memory of a stage: the raw tile [128][BN B], 16-byte chunk c of
// k-row r at chunk c ^ (AT ((r >> 1) & 3)) (the 4 k-rows 2t + j a fragment
// load reads fall in distinct chunks); the scale rows [16][BN B], rows
// 0-7 the low half's 8 blocks of 16 weight rows, 8-15 the high half's; x
// [half][TOK][128 bf16], chunk c of token m at chunk c ^ (m & 7) (the 8
// tokens a B load reads, likewise). Warp w owns columns 16 AT w .. 16 AT w
// + 16 AT - 1 and converts their scales of each block once into a table of
// bf16 pairs (s, s) [16][BN], which only it reads, so a fragment's scale is
// one load. A thread loads the 2 AT bytes of columns c0 = 16 AT w + 2 AT g
// .. c0 + 2 AT - 1 of a k-row at once; A tile i takes columns c0 + 2 i
// (fragment row g) and c0 + 2 i + 1 (row g + 8), so acc[i][mt][c] holds
// column c0 + 2 i + c / 2 for token 8 mt + 2 t + c % 2.
template <int MT, int AT, bool kTail>
__global__ void __launch_bounds__(NT)
nvfp4_dec_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                 const uint8_t* __restrict__ scale, const float* __restrict__ scale2,
                 float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16, int M,
                 int N, int K2, int EN, int R) {
  using S = Tile<MT, AT>;
  constexpr int BN = S::BN, CH = S::CH, WB = S::WB, SCB = S::SCB, TOK = S::TOK;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* table = reinterpret_cast<uint32_t*>(smem + NS * S::BYTES);  // [16][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % R, n0 = (blockIdx.x / R) * BN, e = blockIdx.z;
  // blocks (kTail: the last is the 64-row tail) and scale rows of one half
  const int K = 2 * K2, nblk = (K2 + KB - 1) / KB, nsrow = K2 / BLK;
  const int b0 = rank * nblk / R, nb = (rank + 1) * nblk / R - b0;  // this rank's blocks
  const int c0 = 16 * AT * warp + 2 * AT * g;
  x += (size_t)e * M * K;
  w += (size_t)e * N + n0;
  scale += (size_t)e * N + n0;

  // x rows past M stay zero: no load writes them
  for (int i = tid; i < NS * 2 * (TOK - M) * 16; i += NT) {
    const int st = i / (2 * (TOK - M) * 16), r = i % (2 * (TOK - M) * 16);
    const int row = (r / 16) % (TOK - M) + M, half = r / ((TOK - M) * 16);
    *reinterpret_cast<uint4*>(smem + st * S::BYTES + WB + SCB +
                              ((half * TOK + row) * 16 + r % 16) * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  auto load = [&](int st, int blk) {
    unsigned char* s = smem + st * S::BYTES;
    if (kTail && blk == nblk - 1) {
      // the 64-row tail: copies past its rows fill zeros (code 0 under
      // scale 0 by x 0: +0 products in k-steps 4-7, whatever an earlier
      // block left in the stage), from an address inside the tail
      for (int i = tid; i < KB * CH; i += NT) {
        const int r = i / CH, c = i % CH;
        cp_async16_zfill(s + r * BN + ((c ^ (AT * ((r >> 1) & 3))) << 4),
                         w + (size_t)(blk * KB + (r & (KB / 2 - 1))) * EN + 16 * c, r < KB / 2);
      }
      for (int i = tid; i < 2 * SB * CH; i += NT) {
        const int q = i / CH, c = i % CH;  // scale row q: half q / SB, block row q % SB
        cp_async16_zfill(s + WB + q * BN + 16 * c,
                         scale + (size_t)((q / SB) * nsrow + blk * SB + (q & (SB / 2 - 1))) * EN +
                             16 * c,
                         q % SB < SB / 2);
      }
      for (int i = tid; i < 2 * M * 16; i += NT) {
        const int half = i / (M * 16), m = (i / 16) % M, c = i & 15;
        cp_async16_zfill(s + WB + SCB + ((half * TOK + m) * 16 + (c ^ (m & 7))) * 16,
                         x + (size_t)m * K + half * K2 + blk * KB + 8 * (c & 7), c < 8);
      }
      return;
    }
    for (int i = tid; i < KB * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      cluster_decode::cp_async16(s + r * BN + ((c ^ (AT * ((r >> 1) & 3))) << 4),
                                 w + (size_t)(blk * KB + r) * EN + 16 * c);
    }
    for (int i = tid; i < 2 * SB * CH; i += NT) {
      const int q = i / CH, c = i % CH;  // scale row q: half q / SB, block row q % SB
      cluster_decode::cp_async16(s + WB + q * BN + 16 * c,
                                 scale + (size_t)((q / SB) * nsrow + blk * SB + q % SB) * EN +
                                     16 * c);
    }
    for (int i = tid; i < 2 * M * 16; i += NT) {
      const int half = i / (M * 16), m = (i / 16) % M, c = i & 15;
      cluster_decode::cp_async16(s + WB + SCB + ((half * TOK + m) * 16 + (c ^ (m & 7))) * 16,
                                 x + (size_t)m * K + half * K2 + blk * KB + 8 * c);
    }
  };

  // this warp's columns of a block's scale rows (raw, in a stage) to the
  // table: lane l takes 8 AT of row l / 2
  auto convert = [&](const unsigned char* raw) {
    const int off = (lane >> 1) * BN + 16 * AT * warp + 8 * AT * (lane & 1);
#pragma unroll
    for (int k = 0; k < 2 * AT; ++k) {
      const uint32_t r = *reinterpret_cast<const uint32_t*>(raw + off + 4 * k);
      uint4 v;
      scale_pairs(r, v.x, v.y);
      scale_pairs(r >> 16, v.z, v.w);
      *reinterpret_cast<uint4*>(table + off + 4 * k) = v;
    }
  };

#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < nb) load(st, b0 + st);
    cluster_decode::cp_async_commit();
  }
  float acc[AT][MT][4];
#pragma unroll
  for (int i = 0; i < AT; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][mt][c] = 0.f;

  for (int i = 0; i < nb; ++i) {
    cluster_decode::cp_async_wait<NS - 2>();
    // block i landed for every thread; stage (i - 1) % NS is free, and so is
    // the table (each warp is past its reads of block i - 1's)
    __syncthreads();
    if (i + NS - 1 < nb) load((i + NS - 1) % NS, b0 + i + NS - 1);
    cluster_decode::cp_async_commit();
    const unsigned char* s = smem + (i % NS) * S::BYTES;
    convert(s + WB);
    __syncwarp();
    const unsigned char* xs = s + WB + SCB;
#pragma unroll
    for (int ks = 0; ks < SB; ++ks) {
      uint32_t wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * ks + 2 * t + (j & 1) + 8 * (j >> 1);  // (r >> 1) & 3 == t
        const unsigned char* p = s + r * BN + (((c0 >> 4) ^ (AT * t)) << 4) + (c0 & 15);
        wv[j] = AT == 2 ? *reinterpret_cast<const uint32_t*>(p)
                        : *reinterpret_cast<const uint16_t*>(p);
      }
      uint32_t blo[MT][2], bhi[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = 8 * mt + g;
        const unsigned char* lo = xs + m * 256 + 4 * t;
        const unsigned char* hi = lo + TOK * 256;
        const int q0 = ((2 * ks) ^ (m & 7)) << 4, q1 = ((2 * ks + 1) ^ (m & 7)) << 4;
        blo[mt][0] = *reinterpret_cast<const uint32_t*>(lo + q0);
        blo[mt][1] = *reinterpret_cast<const uint32_t*>(lo + q1);
        bhi[mt][0] = *reinterpret_cast<const uint32_t*>(hi + q0);
        bhi[mt][1] = *reinterpret_cast<const uint32_t*>(hi + q1);
      }
#pragma unroll
      for (int i2 = 0; i2 < AT; ++i2) {
        // bytes (k, column) of A tile i2: (2t, c) (2t+1, c) (2t, c+1) (2t+1, c+1) of
        // c = c0 + 2 i2, then the same 8 rows on
        const uint32_t sel = i2 == 0 ? 0x5140u : 0x7362u;
        const uint32_t p0 = __byte_perm(wv[0], wv[1], sel), p1 = __byte_perm(wv[2], wv[3], sel);
        // the block scales of columns c and c + 1: low half, high half
        const uint2 slo = *reinterpret_cast<const uint2*>(table + ks * BN + c0 + 2 * i2);
        const uint2 shi = *reinterpret_cast<const uint2*>(table + (SB + ks) * BN + c0 + 2 * i2);
        uint32_t a[4];
        scaled_fragments(p0, p1, 0, slo.x, slo.y, a);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[i2][mt], a, blo[mt][0], blo[mt][1]);
        scaled_fragments(p0, p1, 1, shi.x, shi.y, a);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[i2][mt], a, bhi[mt][0], bhi[mt][1]);
      }
    }
  }

  const float s2 = scale2[0];
  auto store = [&](int m, int col, float v) {
    const size_t o = ((size_t)e * M + m) * N + n0 + col;
    if (out_bf16 != nullptr)
      out_bf16[o] = __float2bfloat16(v);
    else
      out_f32[o] = v;
  };
  if (R == 1) {
#pragma unroll
    for (int i = 0; i < AT; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = 8 * mt + 2 * t + (c & 1);
          if (m < M) store(m, c0 + 2 * i + (c >> 1), __fmul_rn(acc[i][mt][c], s2));
        }
    return;
  }
  // the cluster's sum: every rank's partial to its ring (free once every
  // warp is past the walk); rank r owns columns [r BN / R, (r + 1) BN / R)
  // of the tile, adds the ranks' partials in rank order and scales the sum.
  // Every CTA reaches both barriers; the second keeps each CTA's shared
  // memory alive while another still reads it.
  float* part = reinterpret_cast<float*>(smem);  // [TOK][BN]
  cluster_decode::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < AT; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part[(8 * mt + 2 * t + (c & 1)) * BN + c0 + 2 * i + (c >> 1)] = acc[i][mt][c];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int cols = BN / R;
  for (int i = tid; i < M * cols; i += NT) {
    const int m = i / cols, col = rank * cols + i % cols;
    float v = cluster.map_shared_rank(part, 0)[m * BN + col];
    for (int q = 1; q < R; ++q) v = __fadd_rn(v, cluster.map_shared_rank(part, q)[m * BN + col]);
    store(m, col, __fmul_rn(v, s2));
  }
  cluster.sync();
}

template <int MT, int AT, bool kTail>
int launch(const __nv_bfloat16* x, const uint8_t* w, const uint8_t* sc, const float* s2,
           float* of, __nv_bfloat16* ob, int E, int M, int N, int K2, int EN, int R,
           cudaStream_t s) {
  using S = Tile<MT, AT>;
  static unsigned done = 0;  // devices whose shared memory limit is raised
  const int err = cluster_decode::allow_smem(nvfp4_dec_kernel<MT, AT, kTail>, S::SMEM, done);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / S::BN * R, 1, E);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, nvfp4_dec_kernel<MT, AT, kTail>, x, w, sc, s2, of, ob, M,
                                 N, K2, EN, R);
}

}  // namespace dec

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
constexpr int ST = SB * BN;     // a half's 8 e4m3 scale rows [8, BN]

// BT tokens a CTA (the wgmma's N): 64 or 128, chosen by launch() from M and
// the CTAs each gives
template <int BT, bool kTail>
struct Tile {
  static constexpr int XB = BT * 128;   // one TMA box of x: BT rows x 64 bf16 (128 bytes)
  static constexpr int XU = 2 * XB;     // one stage's x: a half's two 64-column boxes
  static constexpr int ZB = kTail ? XB : 0;  // the tail's zeroed x box
  static constexpr int SMEM = 1024 + NU * XU + NWB * WT + NU * ST + ZB + 2 * NU * 8;
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
template <int BT, bool kTail>
__global__ void __launch_bounds__(NT, 1)
nvfp4_wg_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap smap, const float* __restrict__ scale2,
                float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16, int M, int N,
                int K2, int R) {
  using T = Tile<BT, kTail>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                      // [NU][box][BT][128 B], swizzled
  unsigned char* wr = xs + NU * T::XU;           // [NWB][128][BN] raw, swizzled
  unsigned char* sc = wr + NWB * WT;             // [NU][8][BN] e4m3
  unsigned char* zx = sc + NU * ST;              // kTail: a zeroed x box [BT][128 B]
  const uint32_t full = smem_u32(zx + T::ZB);    // NU mbarriers: the unit landed
  const uint32_t empty = full + 8 * NU;          // NU mbarriers: all 8 warps are done

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgi = warp >> 2, wiw = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int rank = blockIdx.x % R, m0 = (blockIdx.x / R) * BT, n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int nblk = (K2 + KB - 1) / KB;  // kTail: the last is the 64-row tail
  const int b0 = rank * nblk / R, nb = (rank + 1) * nblk / R - b0;  // this rank's blocks
  const int nunits = 2 * nb;
  const int c0 = 64 * wgi + 16 * wiw + 2 * gid;  // this thread's two weight columns
  // the rank's units of the tail block (kTail): its last two
  auto tail = [&](int u) { return kTail && b0 + (u >> 1) == nblk - 1; };

  // unit u: half u & 1 of the rank's block u >> 1
  auto load_unit = [&](int u) {
    const int st = u % NU, blk = b0 + (u >> 1), half = u & 1;
    const uint32_t bar = full + 8 * st, xb = smem_u32(xs + st * T::XU);
    const int boxes = tail(u) ? 1 : 2;
    mbar_expect_tx(bar, boxes * T::XB + ST + (half == 0 ? WT : 0));
    for (int box = 0; box < boxes; ++box)
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
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * ks + 2 * tig + (j & 1) + 8 * (j >> 1);
        w[j] = *reinterpret_cast<const uint16_t*>(t + r * BN + ((((c0 >> 4) ^ (r & 7)) << 4) |
                                                                (c0 & 15)));
      }
      uint32_t s0, s1;
      scale_pairs(*reinterpret_cast<const uint16_t*>(s + ks * BN + c0), s0, s1);
      // bytes (k, column): p0 = (2t, c) (2t+1, c) (2t, c+1) (2t+1, c+1), p1 the same 8 rows on
      scaled_fragments(__byte_perm(w[0], w[1], 0x5140), __byte_perm(w[2], w[3], 0x5140), u & 1,
                       s0, s1, a[ks]);
    }
  };
  float d[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) d[i] = 0.f;
  // the 8 products of unit u into d, one commit group (a tail unit's
  // k-steps 4-7 against the zeroed box)
  auto products = [&](const uint32_t (&a)[8][4], int u) {
    const uint32_t xb = smem_u32(xs + (u % NU) * T::XU);
    const uint32_t x1 = tail(u) ? smem_u32(zx) : xb + T::XB;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_rs(d, a[ks], desc((ks < 4 ? xb : x1) + 32 * (ks & 3)), 1);
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

  if (kTail) {  // the zeroed box, made visible to the tensor cores' reads
    for (int i = tid; i < T::ZB / 16; i += NT)
      reinterpret_cast<uint4*>(zx)[i] = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
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

template <int BT, bool kTail>
int launch(const __nv_bfloat16* x, const uint8_t* w, const uint8_t* sc, const float* s2,
           float* of, __nv_bfloat16* ob, int E, int M, int N, int K2, int EN, int R,
           cudaStream_t s) {
  using T = Tile<BT, kTail>;
  CUtensorMap xmap, wmap, smap;
  if (!x_map(&xmap, x, E, M, 2 * K2, BT) ||
      !byte_map(&wmap, w, K2, EN, KB, BN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !byte_map(&smap, sc, 2 * K2 / BLK, EN, SB, BN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  static unsigned done = 0;  // devices whose shared memory limit is raised
  const int err = cluster_decode::allow_smem(nvfp4_wg_kernel<BT, kTail>, T::SMEM, done);
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
  return (int)cudaLaunchKernelEx(&cfg, nvfp4_wg_kernel<BT, kTail>, xmap, wmap, smap, s2, of, ob,
                                 M, N, K2, R);
}

}  // namespace wg

// the tile and instance for M, the columns and the cluster
template <bool kTail>
int dispatch(const __nv_bfloat16* xp, const uint8_t* w, const uint8_t* sc, const float* s2,
             float* of, __nv_bfloat16* ob, int E, int M, int N, int K2, int EN, int ranks,
             cudaStream_t s) {
  if (M <= 16) {
    // 128 columns a CTA halve the x rows each weight byte is read with, where
    // the blocks are not split and that leaves two CTAs an SM (at up to 8
    // tokens: at 16 the narrow tile ran K13 as fast); else 64
    if (M <= 8 && ranks == 1 && N % 128 == 0 && (long)E * N / 128 >= 2 * wgmma_tile::sm_count())
      return dec::launch<1, 2, kTail>(xp, w, sc, s2, of, ob, E, M, N, K2, EN, 1, s);
    return M <= 8 ? dec::launch<1, 1, kTail>(xp, w, sc, s2, of, ob, E, M, N, K2, EN, ranks, s)
                  : dec::launch<2, 1, kTail>(xp, w, sc, s2, of, ob, E, M, N, K2, EN, ranks, s);
  }
  // 128 tokens a CTA halve the fragment work per product, where that still
  // leaves at least half the SMs a CTA (and the blocks are not split);
  // else 64
  const long ctas128 = (long)((M + 127) / 128) * ((N + wg::BN - 1) / wg::BN) * E;
  if (ranks == 1 && M > 64 && 2 * ctas128 >= wgmma_tile::sm_count())
    return wg::launch<128, kTail>(xp, w, sc, s2, of, ob, E, M, N, K2, EN, 1, s);
  return wg::launch<64, kTail>(xp, w, sc, s2, of, ob, E, M, N, K2, EN, ranks, s);
}

int launch(const void* x, const void* packed, const void* scale, const void* scale2,
           void* out_f32, void* out_bf16, int E, int M, int N, int K2, int EN, int ranks,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const uint8_t* sc = static_cast<const uint8_t*>(scale);
  const float* s2 = static_cast<const float*>(scale2);
  float* of = static_cast<float*>(out_f32);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out_bf16);
  if (K2 % 64 != 0 || K2 <= 0) return (int)cudaErrorInvalidValue;
  if ((ranks != 1 && ranks != 2 && ranks != 4 && ranks != 8) || ranks > (K2 + KB - 1) / KB)
    return (int)cudaErrorInvalidValue;
  return K2 % KB ? dispatch<true>(xp, w, sc, s2, of, ob, E, M, N, K2, EN, ranks, s)
                 : dispatch<false>(xp, w, sc, s2, of, ob, E, M, N, K2, EN, ranks, s);
}

}  // namespace

// x bf16 [M, 2*K2]; packed uint8 [K2, N]; scale e4m3 [2*K2/16, N]; scale2
// f32 [1]. Exactly one of out_f32 / out_bf16 [M, N] is non-null. ranks: the
// CTAs of one cluster that share an output tile's blocks (1, 2, 4 or 8, at
// most the blocks, a 64-row tail counted as one), at every M. Needs K2 % 64
// == 0, N % 64 == 0 and 16-byte aligned x, packed and scale (checked by the
// Python wrapper).
extern "C" int nvfp4_gemm(const void* x, const void* packed, const void* scale,
                          const void* scale2, void* out_f32, void* out_bf16, int M, int N,
                          int K2, int ranks, void* stream) {
  return launch(x, packed, scale, scale2, out_f32, out_bf16, 1, M, N, K2, N, ranks, stream);
}

// x bf16 [E, M, 2*K2]; packed uint8 [K2, E*N] (folded experts); scale e4m3
// [2*K2/16, E*N]; scale2 f32 [1]; out [E, M, N]. Same requirements as
// nvfp4_gemm.
extern "C" int grouped_nvfp4_gemm(const void* x, const void* packed, const void* scale,
                                  const void* scale2, void* out_f32, void* out_bf16, int E,
                                  int M, int N, int K2, int ranks, void* stream) {
  return launch(x, packed, scale, scale2, out_f32, out_bf16, E, M, N, K2, E * N, ranks, stream);
}
