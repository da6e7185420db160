// W4A16 GEMM for Hopper (sm_90a): bf16 activations x int4 block-quantized
// weights on the bf16 tensor cores (f32 accumulate), f32 block scales
// applied to an f32 accumulator. One kernel of each tile serves the plain
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
// Straddle K (K/2 % 128 == 64, DeepSeek-V2-Lite's experts at K = 1408):
// with nfull = K/2 / 128, scale row nfull covers the low half's 64-row tail
// and the high half's 64-row head, and the high half's blocks (packed rows
// 64 + 128 b) take rows nfull + 1 + b: scale row s covers rows [128 s,
// 128 s + 128) of the unpacked K, whichever nibble holds them.
//
// What bounds it on an H100: at decode (M <= 16) the packed weight bytes
// over 3.35 TB/s of HBM; at prefill (M = 544) the bf16 multiply-adds over
// the 989 TFLOP/s of the tensor cores.
//
// Both tiles run the product transposed, out^T = W^T x^T: the weights are
// the MMA's A operand, built in registers straight from the raw packed tile
// in shared memory (a thread's two fragment rows are two adjacent weight
// columns: one 16-bit load per k-row, two byte permutes, the exact
// conversion), and x is the B operand, K-major as it lies in device memory.
// So no byte is transposed and no bf16 weight tile is written.
//
// Numerics of both tiles: four offset-binary nibbles become bf16 by OR-ing
// them into the mantissa of 128.0 (0x4300) and subtracting 136.0, both
// exact, the high nibbles the same way after XOR 8; each 128-row scale
// block's halves are dotted into fresh f32 sums d_lo and d_hi, then
// acc = (acc + d_lo*s_lo) + d_hi*s_hi with every product and sum rounded on
// its own (no fused multiply-add), block by block: the plain version's
// order. The order of the f32 sums inside a block's dot differs, and where
// the decode tile splits the blocks over a cluster, each rank's recurrence
// starts from zero and the ranks' partials are summed in rank order.
// Straddle K follows the reference's stage order (_w4a16_body): the nfull
// low-half blocks, the straddle stage acc + (d_tail + d_head)*s_nfull, then
// the nfull high-half blocks, each stage one update acc + d*s; the decode
// tile's cluster splits these 2 nfull + 1 stages into contiguous runs.
//
// Decode tile (M <= 16): mma.sync m16n8k16, one CTA of 4 warps per 64
// weight columns (16 a warp) and 8 or 16 tokens (one or two n8 tiles) and
// expert. Where the output has few tiles (k / v at N = 512: 8 tiles), a
// thread-block cluster of R in {1, 2, 4, 8} CTAs shares one tile: rank r
// walks a contiguous run of the blocks, writes its f32 partial to shared
// memory, and after a cluster barrier the rank that owns each slice of the
// tile sums the ranks' partials in rank order over distributed shared
// memory and rounds once to the output type. One launch, no scratch tensor,
// a deterministic sum; the Python wrapper picks R. Each rank streams its
// blocks through a ring of 4 cp.async stages (the raw packed [128, 64]
// tile, both halves' x rows and both halves' scales), so the next blocks'
// bytes are in flight while a block's MMAs run.
//
// Prefill tile (M > 16): wgmma m64nBTk16 .f32.bf16.bf16 (wgmma_tile.cuh):
//  * a CTA of two warpgroups owns 128 weight columns (64 each) and BT
//    tokens: 128 where that leaves at least half the SMs a CTA, else 64;
//  * a stage is one half of a block: thread 0 loads its x columns (two
//    64-column boxes) and, with a low half, the raw packed [128, 128] tile
//    by TMA onto an mbarrier, with the 128-byte swizzle, in a ring of 4
//    stages (x through a 3-D map over [E, M, K], so rows past M arrive as
//    zeros), and refills a stage once all 8 warps have released it (each
//    after its own reads of the raw tile: the weight ring is reused two
//    blocks on);
//  * a warpgroup keeps one f32 accumulator: a half's 8 products run while
//    the next half's fragments are built, then the half is folded in while
//    the other warpgroup's products run;
//  * the grid runs token tiles fastest, so the tiles that share a weight
//    tile run together and read it from HBM once.
//
// Straddle K has two tiles of its own (the aligned ones above are
// unchanged):
//  * decode (M <= 16): K12's walk (grouped_w4a8_gemm.cu). A stage of the
//    ring is a unit of 64 packed rows carrying both nibbles (the raw [64, 64]
//    tile, both halves' x columns of the unit, the scale rows of the stages
//    it ends), in a ring of 3 (a shallow ring leaves room for more CTAs an
//    SM, which on the card ran K10 faster than rings of 4 to 8), so every
//    weight byte crosses the ring once.
//    Low block b ends at unit 2 b + 1 and updates acc there; high block b
//    (packed rows 64 + 128 b) ends at unit 2 b + 2, 64 rows later, so its
//    rounded product d*s is held in shared memory (each thread its own);
//    unit 0's high dots (the head) wait in registers; at the last unit,
//    2 nfull, the straddle stage acc + (d_tail + d_head)*s, then the held
//    high blocks in order. A cluster rank with a run of the stages walks
//    the units its stages need, in order;
//  * wgmma (M > 16): a stage is one scale row's 128 rows of the unpacked K,
//    two TMA boxes of [64 packed rows, 128 columns], each with its own
//    nibble (the straddle stage: the low half's tail, then the high half's
//    head at packed row 0), and x's two 64-column boxes. The stages come in
//    the recurrence's order, so one accumulator and one update a stage
//    suffice; the price is that a packed row is fetched twice, its low
//    nibble's stage and its high nibble's (the second time from L2 where it
//    still holds the row).
//    Holding the high blocks as the decode tile does would keep two wgmma
//    accumulators live (a low and a high block overlap by 64 rows): at 128
//    tokens 128 accumulator registers beside the update's 64. The 64-row
//    boxes never reach past row K/2, whose zero bytes are not zero weights
//    (offset-binary low nibbles decode 0 to -8).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cluster_decode.cuh"  // cp.async, the shared memory limit
#include "wgmma_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int KB = 128;  // packed rows of one scale block (one staging step)
constexpr int MAX_SMEM = 227 * 1024;  // a CTA's shared memory at most

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

// A fragments of one k16 step for both halves from four bytes-pairs of the
// raw tile: w[j] holds k-rows 2t, 2t+1, 2t+8, 2t+9 (j = 0..3) of the
// thread's two adjacent columns c, c+1 (low byte c). Fragment row g is
// column c, row g + 8 column c + 1.
__device__ __forceinline__ void int4_fragments(const uint32_t (&w)[4], uint32_t (&alo)[4],
                                               uint32_t (&ahi)[4]) {
  // bytes (k, column): p0 = (2t, c) (2t+1, c) (2t, c+1) (2t+1, c+1), p1 the same 8 rows on
  const uint32_t p0 = __byte_perm(w[0], w[1], 0x5140), p1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t l0 = p0 & 0x0F0F0F0Fu, l1 = p1 & 0x0F0F0F0Fu;  // q_lo + 8
  const uint32_t h0 = ((p0 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // q_hi + 8
  const uint32_t h1 = ((p1 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  alo[0] = nibbles_to_bf16x2(__byte_perm(l0, 0x43434343u, 0x4140));
  alo[1] = nibbles_to_bf16x2(__byte_perm(l0, 0x43434343u, 0x4342));
  alo[2] = nibbles_to_bf16x2(__byte_perm(l1, 0x43434343u, 0x4140));
  alo[3] = nibbles_to_bf16x2(__byte_perm(l1, 0x43434343u, 0x4342));
  ahi[0] = nibbles_to_bf16x2(__byte_perm(h0, 0x43434343u, 0x4140));
  ahi[1] = nibbles_to_bf16x2(__byte_perm(h0, 0x43434343u, 0x4342));
  ahi[2] = nibbles_to_bf16x2(__byte_perm(h1, 0x43434343u, 0x4140));
  ahi[3] = nibbles_to_bf16x2(__byte_perm(h1, 0x43434343u, 0x4342));
}

// ---------------------------------------------------------------------------
// decode tile (M <= 16): mma.sync, the blocks split over a cluster
// ---------------------------------------------------------------------------
namespace dec {

constexpr int BN = 64;         // weight columns a CTA: 4 warps of 16
constexpr int NS = 4;          // cp.async stages, one block each
constexpr int NT = 128;        // threads a CTA
constexpr int WB = KB * BN;    // the raw packed [128, 64] tile

// TOK = 8 MT tokens a CTA (MT n8 tiles of the transposed product)
template <int MT>
struct Stage {
  static constexpr int TOK = 8 * MT;
  static constexpr int XB = 2 * TOK * KB * 2;  // both halves' x rows, bf16
  static constexpr int SB = 2 * BN * 4;        // both halves' scales, f32
  static constexpr int BYTES = WB + XB + SB;
  static constexpr int SMEM = NS * BYTES + TOK * BN * 4;  // + the rank's partial
};

// The decode tiles' end: the thread's f32 sums (acc[mt][c]: column c0 + c / 2,
// token 8 mt + 2 t + c % 2) to the output, rounded once to its type. Where
// a cluster of R splits the stages, every rank's partial goes to `part`
// ([TOK][BN] f32 of shared memory); rank r owns columns [r BN / R,
// (r + 1) BN / R) of the tile and adds the ranks' partials in rank order.
// Every CTA reaches both barriers; the second keeps each CTA's shared
// memory alive while another still reads it.
template <int MT>
__device__ __forceinline__ void epilogue(const float (&acc)[MT][4], float* part,
                                         float* __restrict__ out_f32,
                                         __nv_bfloat16* __restrict__ out_bf16, int M, int N,
                                         int e, int n0, int c0, int t, int rank, int R) {
  auto store = [&](int m, int col, float v) {
    const size_t o = ((size_t)e * M + m) * N + n0 + col;
    if (out_bf16 != nullptr)
      out_bf16[o] = __float2bfloat16(v);
    else
      out_f32[o] = v;
  };
  if (R == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = 8 * mt + 2 * t + (c & 1);
        if (m < M) store(m, c0 + (c >> 1), acc[mt][c]);
      }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[(8 * mt + 2 * t + (c & 1)) * BN + c0 + (c >> 1)] = acc[mt][c];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int cols = BN / R;
  for (int i = threadIdx.x; i < M * cols; i += NT) {
    const int m = i / cols, col = rank * cols + i % cols;
    float v = cluster.map_shared_rank(part, 0)[m * BN + col];
    for (int q = 1; q < R; ++q) v = __fadd_rn(v, cluster.map_shared_rank(part, q)[m * BN + col]);
    store(m, col, v);
  }
  cluster.sync();
}

// Shared memory of a stage: the raw tile [128][64 B], 16-byte chunk c of
// k-row r at chunk c ^ ((r >> 1) & 3) (the 4 k-rows 2t + j a fragment load
// reads fall in 4 distinct chunks); x [half][TOK][128 bf16], chunk c of
// token m at chunk c ^ (m & 7) (the 8 tokens a B load reads, likewise);
// scales [half][64 f32]. A thread's A rows g and g + 8 are the columns
// c0 = 16 warp + 2 g and c0 + 1; its accumulator acc[mt][c] holds column
// c0 + c / 2 for token 8 mt + 2 t + c % 2.
template <int MT>
__global__ void __launch_bounds__(NT)
w4a16_dec_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ scale, float* __restrict__ out_f32,
                 __nv_bfloat16* __restrict__ out_bf16, int M, int N, int K2, int EN, int R) {
  using S = Stage<MT>;
  constexpr int TOK = S::TOK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem + NS * S::BYTES);  // [TOK][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % R, n0 = (blockIdx.x / R) * BN, e = blockIdx.z;
  const int K = 2 * K2, nblk = K2 / KB;
  const int b0 = rank * nblk / R, nb = (rank + 1) * nblk / R - b0;  // this rank's blocks
  const int c0 = 16 * warp + 2 * g;
  x += (size_t)e * M * K;
  w += (size_t)e * N + n0;
  scale += (size_t)e * N + n0;

  // x rows past M stay zero: no load writes them
  for (int i = tid; i < NS * 2 * (TOK - M) * 16; i += NT) {
    const int st = i / (2 * (TOK - M) * 16), r = i % (2 * (TOK - M) * 16);
    const int row = (r / 16) % (TOK - M) + M, half = r / ((TOK - M) * 16);
    *reinterpret_cast<uint4*>(smem + st * S::BYTES + WB + ((half * TOK + row) * 16 + r % 16) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  auto load = [&](int st, int blk) {
    unsigned char* s = smem + st * S::BYTES;
    for (int i = tid; i < KB * 4; i += NT) {
      const int r = i >> 2, c = i & 3;
      cluster_decode::cp_async16(s + r * BN + ((c ^ ((r >> 1) & 3)) << 4),
                                 w + (size_t)(blk * KB + r) * EN + 16 * c);
    }
    for (int i = tid; i < 2 * M * 16; i += NT) {
      const int half = i / (M * 16), m = (i / 16) % M, c = i & 15;
      cluster_decode::cp_async16(s + WB + ((half * TOK + m) * 16 + (c ^ (m & 7))) * 16,
                                 x + (size_t)m * K + half * K2 + blk * KB + 8 * c);
    }
    if (tid < 32) {
      const int half = tid >> 4, c = tid & 15;
      cluster_decode::cp_async16(s + WB + S::XB + half * BN * 4 + 16 * c,
                                 scale + (size_t)(half * nblk + blk) * EN + 4 * c);
    }
  };

#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < nb) load(st, b0 + st);
    cluster_decode::cp_async_commit();
  }
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int i = 0; i < nb; ++i) {
    cluster_decode::cp_async_wait<NS - 2>();
    __syncthreads();  // block i landed for every thread; stage (i - 1) % NS is free
    if (i + NS - 1 < nb) load((i + NS - 1) % NS, b0 + i + NS - 1);
    cluster_decode::cp_async_commit();
    const unsigned char* s = smem + (i % NS) * S::BYTES;
    const unsigned char* xs = s + WB;
    float dlo[MT][4], dhi[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) dlo[mt][c] = dhi[mt][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KB / 16; ++ks) {
      uint32_t wv[4], alo[4], ahi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * ks + 2 * t + (j & 1) + 8 * (j >> 1);
        wv[j] = *reinterpret_cast<const uint16_t*>(s + r * BN + ((warp ^ ((r >> 1) & 3)) << 4) +
                                                   2 * g);
      }
      int4_fragments(wv, alo, ahi);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = 8 * mt + g;
        const unsigned char* lo = xs + m * 256 + 4 * t;
        const unsigned char* hi = lo + TOK * 256;
        const int q0 = ((2 * ks) ^ (m & 7)) << 4, q1 = ((2 * ks + 1) ^ (m & 7)) << 4;
        mma_bf16(dlo[mt], alo, *reinterpret_cast<const uint32_t*>(lo + q0),
                 *reinterpret_cast<const uint32_t*>(lo + q1));
        mma_bf16(dhi[mt], ahi, *reinterpret_cast<const uint32_t*>(hi + q0),
                 *reinterpret_cast<const uint32_t*>(hi + q1));
      }
    }
    const float* ss = reinterpret_cast<const float*>(xs + S::XB);
    const float2 slo = *reinterpret_cast<const float2*>(ss + c0);
    const float2 shi = *reinterpret_cast<const float2*>(ss + BN + c0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float sl = (c & 2) ? slo.y : slo.x;
        const float sh = (c & 2) ? shi.y : shi.x;
        acc[mt][c] = __fadd_rn(__fadd_rn(acc[mt][c], __fmul_rn(dlo[mt][c], sl)),
                               __fmul_rn(dhi[mt][c], sh));
      }
  }

  epilogue<MT>(acc, part, out_f32, out_bf16, M, N, e, n0, c0, t, rank, R);
}

// the straddle decode tile: 64-row units in a ring of NS
constexpr int KU = 64;       // packed rows a unit
constexpr int WU = KU * BN;  // the raw packed [64, 64] tile

template <int MT>
struct Unit {
  static constexpr int NS = 3;  // cp.async stages, one unit each
  static constexpr int TOK = 8 * MT;
  static constexpr int XB = 2 * TOK * KU * 2;  // both halves' x columns of the unit, bf16
  static constexpr int SB = 2 * BN * 4;        // the scale rows of the stages it ends, f32
  static constexpr int BYTES = WU + XB + SB;
  static constexpr int SLOT = TOK * BN * 4;    // a held high block's products; the partial
};
// the unit ring, nfull held high blocks and the rank's partial
template <int MT>
constexpr int straddle_smem(int nfull) {
  return Unit<MT>::NS * Unit<MT>::BYTES + (nfull + 1) * Unit<MT>::SLOT;
}

// Shared memory of a unit: the raw tile [64][64 B] swizzled as the aligned
// tile's; x [half][TOK][64 bf16], chunk c of token m at chunk c ^ (m & 7);
// the two scale rows [2][64 f32] (low stage's, high stage's). The stages
// ending at unit u: the low block u / 2 at odd u, the straddle at u =
// 2 nfull (scale row nfull, slot 0), the high block (u - 2) / 2 at even
// u >= 2 (scale row nfull + u / 2, slot 1). Rank r owns stages [s0, s1) of
// the 2 nfull + 1 and walks the units they need: a run [a0, a1), then a
// run [b0, b1) (a rank that holds the straddle walks from unit 0, the
// head, to its last high block, then its low blocks up to the tail).
template <int MT>
__global__ void __launch_bounds__(NT)
w4a16_straddle_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                      const float* __restrict__ scale, float* __restrict__ out_f32,
                      __nv_bfloat16* __restrict__ out_bf16, int M, int N, int K2, int EN, int R) {
  using U = Unit<MT>;
  constexpr int TOK = U::TOK, NSU = U::NS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nfull = K2 / KB, nst = 2 * nfull + 1;
  float* hold = reinterpret_cast<float*>(smem + NSU * U::BYTES);  // [nfull][MT * 4][NT]
  float* part = hold + nfull * MT * 4 * NT;                         // [TOK][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % R, n0 = (blockIdx.x / R) * BN, e = blockIdx.z;
  const int K = 2 * K2;
  const int c0 = 16 * warp + 2 * g;
  x += (size_t)e * M * K;
  w += (size_t)e * N + n0;
  scale += (size_t)e * N + n0;

  const int s0 = rank * nst / R, s1 = (rank + 1) * nst / R;  // this rank's stages
  const bool strad = s0 <= nfull && nfull < s1;
  int a0, a1, b0 = 0, b1 = 0;  // the units walked: [a0, a1), then [b0, b1)
  if (s1 <= nfull) {           // low blocks only
    a0 = 2 * s0;
    a1 = 2 * s1;
  } else if (s0 > nfull) {     // high blocks only
    a0 = 2 * (s0 - nfull) - 1;
    a1 = 2 * (s1 - nfull) - 1;
  } else {                     // the straddle, high blocks 0 .. s1 - nfull - 2, low from s0
    a0 = 0;
    a1 = 2 * (s1 - nfull) - 1;
    b0 = max(2 * s0, a1);
    b1 = nst;
  }
  const int na = a1 - a0, nu = na + b1 - b0;
  auto unit = [&](int i) { return i < na ? a0 + i : b0 + i - na; };
  auto lo_on = [&](int u) { return u < 2 * nfull ? s0 <= (u >> 1) && (u >> 1) < s1 : strad; };
  auto hi_on = [&](int u) {
    return u == 0 ? strad : s0 <= nfull + 1 + ((u - 1) >> 1) && nfull + 1 + ((u - 1) >> 1) < s1;
  };

  // x rows past M stay zero: no load writes them
  for (int i = tid; i < NSU * 2 * (TOK - M) * 8; i += NT) {
    const int st = i / (2 * (TOK - M) * 8), r = i % (2 * (TOK - M) * 8);
    const int row = (r / 8) % (TOK - M) + M, half = r / ((TOK - M) * 8);
    *reinterpret_cast<uint4*>(smem + st * U::BYTES + WU + ((half * TOK + row) * 8 + r % 8) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  auto load = [&](int st, int u) {
    unsigned char* s = smem + st * U::BYTES;
    for (int i = tid; i < KU * 4; i += NT) {
      const int r = i >> 2, c = i & 3;
      cluster_decode::cp_async16(s + r * BN + ((c ^ ((r >> 1) & 3)) << 4),
                                 w + (size_t)(u * KU + r) * EN + 16 * c);
    }
    for (int i = tid; i < 2 * M * 8; i += NT) {
      const int half = i / (M * 8), m = (i / 8) % M, c = i & 7;
      cluster_decode::cp_async16(s + WU + ((half * TOK + m) * 8 + (c ^ (m & 7))) * 16,
                                 x + (size_t)m * K + half * K2 + u * KU + 8 * c);
    }
    if (tid < 32) {
      const int half = tid >> 4, c = tid & 15;
      const int row = half == 0 ? (u < 2 * nfull ? u >> 1 : nfull) : nfull + (u >> 1);
      cluster_decode::cp_async16(s + WU + U::XB + half * BN * 4 + 16 * c,
                                 scale + (size_t)row * EN + 4 * c);
    }
  };

#pragma unroll
  for (int st = 0; st < NSU - 1; ++st) {
    if (st < nu) load(st, unit(st));
    cluster_decode::cp_async_commit();
  }
  float acc[MT][4], dlo[MT][4], dhi[MT][4], head[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = dlo[i][c] = dhi[i][c] = head[i][c] = 0.f;

  for (int i = 0; i < nu; ++i) {
    cluster_decode::cp_async_wait<NSU - 2>();
    __syncthreads();  // unit i landed for every thread; stage (i - 1) % NSU is free
    if (i + NSU - 1 < nu) load((i + NSU - 1) % NSU, unit(i + NSU - 1));
    cluster_decode::cp_async_commit();
    const int u = unit(i);
    const unsigned char* s = smem + (i % NSU) * U::BYTES;
    const unsigned char* xs = s + WU;
    // the dots restart with each stage: a low block's at even units, a
    // high block's at odd ones, the head's at unit 0
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if ((u & 1) == 0) dlo[mt][c] = 0.f;
        if ((u & 1) == 1 || u == 0) dhi[mt][c] = 0.f;
      }
#pragma unroll
    for (int ks = 0; ks < KU / 16; ++ks) {
      uint32_t wv[4], alo[4], ahi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * ks + 2 * t + (j & 1) + 8 * (j >> 1);
        wv[j] = *reinterpret_cast<const uint16_t*>(s + r * BN + ((warp ^ ((r >> 1) & 3)) << 4) +
                                                   2 * g);
      }
      int4_fragments(wv, alo, ahi);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = 8 * mt + g;
        const unsigned char* lo = xs + m * 128 + 4 * t;
        const unsigned char* hi = lo + TOK * 128;
        const int q0 = ((2 * ks) ^ (m & 7)) << 4, q1 = ((2 * ks + 1) ^ (m & 7)) << 4;
        mma_bf16(dlo[mt], alo, *reinterpret_cast<const uint32_t*>(lo + q0),
                 *reinterpret_cast<const uint32_t*>(lo + q1));
        mma_bf16(dhi[mt], ahi, *reinterpret_cast<const uint32_t*>(hi + q0),
                 *reinterpret_cast<const uint32_t*>(hi + q1));
      }
    }
    const float* ss = reinterpret_cast<const float*>(xs + U::XB);
    const float2 slo = *reinterpret_cast<const float2*>(ss + c0);
    const float2 shi = *reinterpret_cast<const float2*>(ss + BN + c0);
    if ((u & 1) && lo_on(u)) {  // low block u / 2 ends: its update, in order
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[mt][c] = __fadd_rn(acc[mt][c], __fmul_rn(dlo[mt][c], (c & 2) ? slo.y : slo.x));
    }
    if (u == 0 && strad) {  // the high head waits for the straddle stage
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) head[mt][c] = dhi[mt][c];
    }
    if ((u & 1) == 0 && u >= 2 && hi_on(u)) {  // high block (u - 2) / 2 ends
      float* hb = hold + ((u - 2) >> 1) * MT * 4 * NT + tid;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = __fmul_rn(dhi[mt][c], (c & 2) ? shi.y : shi.x);
          if (strad)
            hb[(mt * 4 + c) * NT] = p;  // held until the straddle stage
          else
            acc[mt][c] = __fadd_rn(acc[mt][c], p);
        }
    }
    if (u == 2 * nfull && strad) {  // the straddle stage, then the held high blocks in order
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[mt][c] = __fadd_rn(acc[mt][c], __fmul_rn(__fadd_rn(dlo[mt][c], head[mt][c]),
                                                       (c & 2) ? slo.y : slo.x));
      for (int b = 0; b < s1 - nfull - 1; ++b) {
        const float* hb = hold + b * MT * 4 * NT + tid;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][c] = __fadd_rn(acc[mt][c], hb[(mt * 4 + c) * NT]);
      }
    }
  }
  epilogue<MT>(acc, part, out_f32, out_bf16, M, N, e, n0, c0, t, rank, R);
}

template <int MT>
int launch(const __nv_bfloat16* x, const uint8_t* w, const float* sc, float* of,
           __nv_bfloat16* ob, int E, int M, int N, int K2, int EN, int R, cudaStream_t s) {
  if (K2 % KB != 0) {
    const int smem = straddle_smem<MT>(K2 / KB);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    static unsigned done_s = 0;  // devices whose shared memory limit is raised
    const int err = cluster_decode::allow_smem(w4a16_straddle_kernel<MT>,
                                               MAX_SMEM, done_s);
    if (err != 0) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((N / BN) * R, 1, E);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = R;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, w4a16_straddle_kernel<MT>, x, w, sc, of, ob, M, N, K2,
                                   EN, R);
  }
  static unsigned done = 0;  // devices whose shared memory limit is raised
  const int err = cluster_decode::allow_smem(w4a16_dec_kernel<MT>, Stage<MT>::SMEM, done);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N / BN) * R, 1, E);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = Stage<MT>::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, w4a16_dec_kernel<MT>, x, w, sc, of, ob, M, N, K2, EN, R);
}

}  // namespace dec

// ---------------------------------------------------------------------------
// prefill tile (M > 16): bf16 wgmma, x and the raw weight tile by TMA
// ---------------------------------------------------------------------------
namespace wg {

using namespace wgmma_tile;

constexpr int BN = 128;         // weight columns a CTA: two warpgroups of 64
constexpr int NU = 4;           // TMA stages: one half (lo or hi) of a block's x each
constexpr int NWB = 2;          // raw weight tiles in flight
constexpr int NT = 256;         // threads a CTA
constexpr int WT = KB * BN;     // the raw packed [128, BN] tile

// BT tokens a CTA (the wgmma's N): 64 or 128, chosen by launch() from M and
// the CTAs each gives
template <int BT>
struct Tile {
  static constexpr int XB = BT * 128;   // one TMA box of x: BT rows x 64 bf16 (128 bytes)
  static constexpr int XU = 2 * XB;     // one stage: a half's two 64-column boxes
  static constexpr int SMEM = 1024 + NU * XU + NWB * WT + 2 * NU * 8;
};

// The tiles' end: rows 2 r and 2 r + 1 of a warpgroup's accumulator are the
// thread's columns c0 and c0 + 1, token m0 + 8 j + 2 tig + c in acc[4 j + c]
// and acc[4 j + 2 + c]; tokens past M are not written.
template <int BT>
__device__ __forceinline__ void store(const float (&acc)[BT / 2], float* __restrict__ out_f32,
                                      __nv_bfloat16* __restrict__ out_bf16, int M, int N, int e,
                                      int m0, int n0, int c0, int tig) {
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = m0 + 8 * j + 2 * tig + c;
      if (m >= M) continue;
      const size_t o = ((size_t)e * M + m) * N + n0 + c0;
      const float v0 = acc[4 * j + c], v1 = acc[4 * j + 2 + c];
      if (out_bf16 != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(out_bf16 + o) = __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(out_f32 + o) = make_float2(v0, v1);
    }
}

// The product runs transposed, out^T = W^T x^T: the weights are wgmma's A
// operand, which it takes from registers, and x is B, K-major in shared
// memory as it lies in device memory. So the nibbles go from the raw tile
// straight into A fragments: no operand tile of bf16 weights is written to
// shared memory and no byte is transposed. A-fragment row r of warp w holds
// weight column 16 w + 2 (r % 8) + r / 8 of its warpgroup's 64 (a thread's
// two rows are two adjacent columns, one 16-bit load of the raw tile per
// k-row); x's k order is the memory order, so the fragments follow it.
//
// Stages are halves of blocks: unit u = 2 blk + half holds x's two
// 64-column boxes of that half (and, for a low half, the block's raw weight
// tile, in a ring of NWB); thread 0 loads unit u + NU once all 8 warps
// have released unit u (an mbarrier of eight arrivals: a warpgroup's
// products retiring does not mean its other warps have read the raw tile,
// whose refill is that of unit u + NU). Each warpgroup walks
// the units with one accumulator: a half's 8 products, then its f32 update
// while the other warpgroup's products run.
template <int BT>
__global__ void __launch_bounds__(NT, 1)
w4a16_wg_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ scale, float* __restrict__ out_f32,
                __nv_bfloat16* __restrict__ out_bf16, int M, int N, int K2, int EN) {
  using T = Tile<BT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                      // [NU][box][BT][128 B], swizzled
  unsigned char* wr = xs + NU * T::XU;           // [NWB][128][BN] raw, swizzled
  const uint32_t full = smem_u32(wr + NWB * WT);  // NU mbarriers: the unit landed
  const uint32_t empty = full + 8 * NU;           // NU mbarriers: all 8 warps are done

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgi = warp >> 2, wiw = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int nblk = K2 / KB, nunits = 2 * nblk;
  const int c0 = 64 * wgi + 16 * wiw + 2 * gid;  // this thread's two weight columns
  const bool live = n0 + c0 < N;                  // (N % 128 == 64: the last tile's right half)
  const size_t col = (size_t)e * N + n0 + c0;     // in the folded [., EN] layout

  auto load_unit = [&](int u) {
    const int st = u % NU, blk = u >> 1, half = u & 1;
    const uint32_t bar = full + 8 * st, xb = smem_u32(xs + st * T::XU);
    mbar_expect_tx(bar, T::XU + (half == 0 ? WT : 0));
#pragma unroll
    for (int box = 0; box < 2; ++box)
      tma_load3(xb + box * T::XB, &xmap, half * K2 + blk * KB + 64 * box, m0, e, bar);
    if (half == 0) tma_load2(smem_u32(wr + (blk % NWB) * WT), &wmap, e * N + n0, blk * KB, bar);
  };
  // A fragments of one half of block blk, 8 k-steps: k-rows 16 ks + 2 tig
  // (+1, +8, +9) of the thread's two columns
  auto fragments = [&](uint32_t (&a)[8][4], int blk, int half) {
    const unsigned char* t = wr + (blk % NWB) * WT;
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
      uint32_t p0 = __byte_perm(w[0], w[1], 0x5140), p1 = __byte_perm(w[2], w[3], 0x5140);
      if (half == 0) {
        p0 &= 0x0F0F0F0Fu;  // q_lo + 8
        p1 &= 0x0F0F0F0Fu;
      } else {
        p0 = ((p0 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // q_hi + 8
        p1 = ((p1 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
      }
      a[ks][0] = nibbles_to_bf16x2(__byte_perm(p0, 0x43434343u, 0x4140));
      a[ks][1] = nibbles_to_bf16x2(__byte_perm(p0, 0x43434343u, 0x4342));
      a[ks][2] = nibbles_to_bf16x2(__byte_perm(p1, 0x43434343u, 0x4140));
      a[ks][3] = nibbles_to_bf16x2(__byte_perm(p1, 0x43434343u, 0x4342));
    }
  };
  // the 8 products of unit u into d, one commit group; the first k-step
  // does not accumulate
  float d[BT / 2];
  auto products = [&](const uint32_t (&a)[8][4], int u) {
    const uint32_t xb = smem_u32(xs + (u % NU) * T::XU);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_rs(d, a[ks], desc(xb + (ks >> 2) * T::XB + 32 * (ks & 3)), ks);
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
  // acc = acc + d * s, each product and sum rounded alone; rows 2 r and
  // 2 r + 1 of the accumulator are the columns c0 and c0 + 1
  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  auto update = [&](float2 s) {
#pragma unroll
    for (int i = 0; i < BT / 2; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(d[i], (i & 2) ? s.y : s.x));
  };
  auto scales = [&](int blk, int half) {
    return live ? __ldg(reinterpret_cast<const float2*>(scale + (size_t)(half * nblk + blk) * EN + col))
                : make_float2(0.f, 0.f);
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
  fragments(alo, 0, 0);
  // Every product is issued unconditionally (a wgmma in a branch is
  // serialized by ptxas); the updates keep the plain version's order
  // (lo 0, hi 0, lo 1, hi 1, ...).
  for (int blk = 0; blk < nblk; ++blk) {
    const int ulo = 2 * blk, uhi = ulo + 1;
    const float2 slo = scales(blk, 0), shi = scales(blk, 1);
    products(alo, ulo);
    fragments(ahi, blk, 1);  // the raw tile landed with unit ulo
    wgmma_wait();
    fence_regs(d);
    release(ulo);
    update(slo);
    mbar_wait(full + 8 * (uhi % NU), (uhi / NU) & 1);
    products(ahi, uhi);
    if (blk + 1 < nblk) {
      mbar_wait(full + 8 * ((ulo + 2) % NU), ((ulo + 2) / NU) & 1);
      fragments(alo, blk + 1, 0);
    }
    wgmma_wait();
    fence_regs(d);
    release(uhi);
    update(shi);
  }

  if (live) store<BT>(acc, out_f32, out_bf16, M, N, e, m0, n0, c0, tig);
}

// The straddle tile (K2 % 128 == 64): stage s (0 .. 2 nfull) is scale row
// s's 128 rows of the unpacked K, two boxes q = 2 s, 2 s + 1 of 64: box q
// is x's columns [64 q, 64 q + 64) and packed rows 64 (q mod nb2) of the
// low nibbles where q < nb2 = K2 / 64, else of the high ones. Each stage
// has its own two raw boxes [64][BN] (128-byte swizzle, stacked as one
// [128][BN] tile) beside its x boxes, in a ring of NU; one accumulator,
// one update acc + d * s_s a stage, in stage order. nst = 2 nfull + 1 is
// odd: stage 0, then pairs, so every product is issued unconditionally.
template <int BT>
struct STile {
  static constexpr int XU = Tile<BT>::XU;
  static constexpr int SU = XU + WT;  // a stage: x's two boxes and the raw tile
  static constexpr int SMEM = 1024 + NU * SU + 2 * NU * 8;
};

template <int BT>
__global__ void __launch_bounds__(NT, 1)
w4a16_wgs_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ scale, float* __restrict__ out_f32,
                 __nv_bfloat16* __restrict__ out_bf16, int M, int N, int K2, int EN) {
  using T = STile<BT>;
  constexpr int XB = Tile<BT>::XB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // stage st: x [box][BT][128 B] then the raw tile [128][BN], both swizzled
  const uint32_t full = smem_u32(smem + NU * T::SU);  // NU mbarriers: the stage landed
  const uint32_t empty = full + 8 * NU;               // NU mbarriers: all 8 warps are done

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgi = warp >> 2, wiw = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int nb2 = K2 / 64, nst = K2 / KB * 2 + 1;
  const int c0 = 64 * wgi + 16 * wiw + 2 * gid;  // this thread's two weight columns
  const bool live = n0 + c0 < N;                  // (N % 128 == 64: the last tile's right half)
  const size_t col = (size_t)e * N + n0 + c0;     // in the folded [., EN] layout

  auto load_stage = [&](int u) {
    const int st = u % NU;
    const uint32_t bar = full + 8 * st, base = smem_u32(smem + st * T::SU);
    mbar_expect_tx(bar, T::SU);
#pragma unroll
    for (int box = 0; box < 2; ++box) {
      const int q = 2 * u + box;
      tma_load3(base + box * XB, &xmap, 64 * q, m0, e, bar);
      tma_load2(base + T::XU + box * (WT / 2), &wmap, e * N + n0, 64 * (q < nb2 ? q : q - nb2),
                bar);
    }
  };
  // A fragments of stage u, 8 k-steps: k-rows 16 ks + 2 tig (+1, +8, +9)
  // of the thread's two columns, box ks / 4's nibble
  auto fragments = [&](uint32_t (&a)[8][4], int u) {
    const unsigned char* t = smem + (u % NU) * T::SU + T::XU;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const bool high = 2 * u + (ks >> 2) >= nb2;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * ks + 2 * tig + (j & 1) + 8 * (j >> 1);
        w[j] = *reinterpret_cast<const uint16_t*>(t + r * BN + ((((c0 >> 4) ^ (r & 7)) << 4) |
                                                                (c0 & 15)));
      }
      // bytes (k, column): p0 = (2t, c) (2t+1, c) (2t, c+1) (2t+1, c+1), p1 the same 8 rows on;
      // the low nibbles q_lo + 8, or the high ones (q_hi + 8 after XOR 8)
      const int sh = high ? 4 : 0;
      const uint32_t flip = high ? 0x08080808u : 0u;
      const uint32_t p0 = ((__byte_perm(w[0], w[1], 0x5140) >> sh) & 0x0F0F0F0Fu) ^ flip;
      const uint32_t p1 = ((__byte_perm(w[2], w[3], 0x5140) >> sh) & 0x0F0F0F0Fu) ^ flip;
      a[ks][0] = nibbles_to_bf16x2(__byte_perm(p0, 0x43434343u, 0x4140));
      a[ks][1] = nibbles_to_bf16x2(__byte_perm(p0, 0x43434343u, 0x4342));
      a[ks][2] = nibbles_to_bf16x2(__byte_perm(p1, 0x43434343u, 0x4140));
      a[ks][3] = nibbles_to_bf16x2(__byte_perm(p1, 0x43434343u, 0x4342));
    }
  };
  float d[BT / 2];
  auto products = [&](const uint32_t (&a)[8][4], int u) {
    const uint32_t xb = smem_u32(smem + (u % NU) * T::SU);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_rs(d, a[ks], desc(xb + (ks >> 2) * XB + 32 * (ks & 3)), ks);
    wgmma_commit();
  };
  // stage u's products done and this warp's reads of its raw tile too:
  // release it (one arrival per warp), and thread 0 refills it with stage
  // u + NU once all warps have
  auto release = [&](int u) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (u % NU));
    if (tid == 0 && u + NU < nst) {
      mbar_wait(empty + 8 * (u % NU), (u / NU) & 1);
      load_stage(u + NU);
    }
  };
  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  auto update = [&](int u) {
    const float2 s = live ? __ldg(reinterpret_cast<const float2*>(scale + (size_t)u * EN + col))
                          : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(d[i], (i & 2) ? s.y : s.x));
  };
  auto arrive = [&](int u) { mbar_wait(full + 8 * (u % NU), (u / NU) & 1); };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NU; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int u = 0; u < NU && u < nst; ++u) load_stage(u);
  }
  __syncthreads();

  uint32_t a0[8][4], a1[8][4];
  arrive(0);
  fragments(a0, 0);
  products(a0, 0);
  if (nst > 1) {
    arrive(1);
    fragments(a1, 1);
  }
  wgmma_wait();
  fence_regs(d);
  release(0);
  update(0);
  for (int u = 1; u < nst; u += 2) {
    products(a1, u);
    arrive(u + 1);
    fragments(a0, u + 1);
    wgmma_wait();
    fence_regs(d);
    release(u);
    update(u);
    products(a0, u + 1);
    if (u + 2 < nst) {
      arrive(u + 2);
      fragments(a1, u + 2);
    }
    wgmma_wait();
    fence_regs(d);
    release(u + 1);
    update(u + 1);
  }

  if (live) store<BT>(acc, out_f32, out_bf16, M, N, e, m0, n0, c0, tig);
}

template <int BT>
int launch_straddle(const __nv_bfloat16* x, const uint8_t* w, const float* sc, float* of,
                    __nv_bfloat16* ob, int E, int M, int N, int K2, int EN, cudaStream_t s) {
  using T = STile<BT>;
  CUtensorMap xmap, wmap;
  if (!x_map(&xmap, x, E, M, 2 * K2, BT) ||
      !byte_map(&wmap, w, K2, EN, KB / 2, BN, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static unsigned done = 0;  // devices whose shared memory limit is raised
  const int err = cluster_decode::allow_smem(w4a16_wgs_kernel<BT>, T::SMEM, done);
  if (err != 0) return err;
  dim3 grid((M + BT - 1) / BT, (N + BN - 1) / BN, E);
  w4a16_wgs_kernel<BT><<<grid, NT, T::SMEM, s>>>(xmap, wmap, sc, of, ob, M, N, K2, EN);
  return (int)cudaGetLastError();
}

template <int BT>
int launch(const __nv_bfloat16* x, const uint8_t* w, const float* sc, float* of,
           __nv_bfloat16* ob, int E, int M, int N, int K2, int EN, cudaStream_t s) {
  if (K2 % KB != 0) return launch_straddle<BT>(x, w, sc, of, ob, E, M, N, K2, EN, s);
  using T = Tile<BT>;
  CUtensorMap xmap, wmap;
  if (!x_map(&xmap, x, E, M, 2 * K2, BT) ||
      !byte_map(&wmap, w, K2, EN, KB, BN, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static unsigned done = 0;  // devices whose shared memory limit is raised
  const int err = cluster_decode::allow_smem(w4a16_wg_kernel<BT>, T::SMEM, done);
  if (err != 0) return err;
  dim3 grid((M + BT - 1) / BT, (N + BN - 1) / BN, E);
  w4a16_wg_kernel<BT><<<grid, NT, T::SMEM, s>>>(xmap, wmap, sc, of, ob, M, N, K2, EN);
  return (int)cudaGetLastError();
}

}  // namespace wg

int launch(const void* x, const void* packed, const void* scale, void* out_f32,
           void* out_bf16, int E, int M, int N, int K2, int EN, int ranks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out_f32);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out_bf16);
  if (K2 % 64 != 0 || K2 < 64) return (int)cudaErrorInvalidValue;
  if (M <= 16) {
    // the stages of the block recurrence a cluster splits
    const int stages = K2 % KB ? 2 * (K2 / KB) + 1 : K2 / KB;
    if ((ranks != 1 && ranks != 2 && ranks != 4 && ranks != 8) || ranks > stages)
      return (int)cudaErrorInvalidValue;
    return M <= 8 ? dec::launch<1>(xp, w, sc, of, ob, E, M, N, K2, EN, ranks, s)
                  : dec::launch<2>(xp, w, sc, of, ob, E, M, N, K2, EN, ranks, s);
  }
  if (ranks != 1) return (int)cudaErrorInvalidValue;
  // 128 tokens a CTA halve the fragment work per product, where that still
  // leaves at least half the SMs a CTA; else 64
  const long ctas128 = (long)((M + 127) / 128) * ((N + wg::BN - 1) / wg::BN) * E;
  if (M > 64 && 2 * ctas128 >= wgmma_tile::sm_count())
    return wg::launch<128>(xp, w, sc, of, ob, E, M, N, K2, EN, s);
  return wg::launch<64>(xp, w, sc, of, ob, E, M, N, K2, EN, s);
}

}  // namespace

// x bf16 [M, 2*K2]; packed uint8 [K2, N]; scale f32 [2*K2/128, N]. Exactly
// one of out_f32 / out_bf16 [M, N] is non-null. ranks: the decode tile's
// cluster size (M <= 16: 1, 2, 4 or 8, at most the recurrence's stages,
// K2 / 128 or, straddle K, 2 (K2 / 128) + 1; M > 16: 1). Needs K2 % 64 ==
// 0 (K2 % 128 == 64 is the straddle layout), N % 64 == 0 and 16-byte
// aligned x, packed and scale (checked by the Python wrapper).
extern "C" int w4a16_gemm(const void* x, const void* packed, const void* scale,
                          void* out_f32, void* out_bf16, int M, int N, int K2, int ranks,
                          void* stream) {
  return launch(x, packed, scale, out_f32, out_bf16, 1, M, N, K2, N, ranks, stream);
}

// x bf16 [E, M, 2*K2]; packed uint8 [K2, E*N] (folded experts); scale f32
// [2*K2/128, E*N]; out [E, M, N]. Same requirements as w4a16_gemm.
extern "C" int grouped_w4a16_gemm(const void* x, const void* packed, const void* scale,
                                  void* out_f32, void* out_bf16, int E, int M, int N,
                                  int K2, int ranks, void* stream) {
  return launch(x, packed, scale, out_f32, out_bf16, E, M, N, K2, E * N, ranks, stream);
}
