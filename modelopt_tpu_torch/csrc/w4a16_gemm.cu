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
//
// What bounds it on an H100: at decode (M <= 16) the packed weight bytes
// over 3.35 TB/s of HBM; at prefill (M = 544) the bf16 multiply-adds over
// the 989 TFLOP/s of the tensor cores.
//
// Numerics of both tiles: four offset-binary nibbles become bf16 by OR-ing
// them into the mantissa of 128.0 (0x4300) and subtracting 136.0, both
// exact, the high nibbles the same way after XOR 8; each 128-row scale
// block's halves are dotted into fresh f32 sums d_lo and d_hi, then
// acc = (acc + d_lo*s_lo) + d_hi*s_hi with every product and sum rounded on
// its own (no fused multiply-add), block by block: the plain version's
// order. Only the order of the f32 sums inside a block's dot differs.
//
// Decode tile (M <= 16): mma.sync m16n8k16, one CTA of 4 warps per 16 x 64
// output tile and expert. Per block the CTA stages both halves' x columns
// and the packed [128, 64] tile, transposed on the way in (4x4 byte
// transposes in registers) so one 32-bit word holds four k of one column,
// which becomes a thread's B fragment; the MMA's k order is permuted (A and
// B alike) so each thread takes four consecutive k.
//
// Prefill tile (M > 16): wgmma m64nBTk16 .f32.bf16.bf16 with the product
// transposed, out^T = W^T x^T, so that the weights are the A operand, which
// wgmma takes from registers, and x is the B operand, K-major in shared
// memory as it lies in device memory:
//  * a CTA of two warpgroups owns 128 weight columns (64 each) and BT
//    tokens: 128 where that leaves at least half the SMs a CTA, else 64;
//  * a stage is one half of a block: thread 0 loads its x columns (two
//    64-column boxes) and, with a low half, the raw packed [128, 128] tile
//    by TMA onto an mbarrier, with the 128-byte swizzle, in a ring of 4
//    stages (x through a 3-D map over [E, M, K], so rows past M arrive as
//    zeros), and refills a stage once both warpgroups have released it;
//  * the nibbles go from the raw tile straight into A fragments (a thread's
//    two fragment rows are two adjacent weight columns: one 16-bit load per
//    k-row, two byte permutes, the exact conversion), so no bf16 operand
//    tile is written to shared memory and no byte is transposed;
//  * a warpgroup keeps one f32 accumulator: a half's 8 products run while
//    the next half's fragments are built, then the half is folded in while
//    the other warpgroup's products run;
//  * the grid runs token tiles fastest, so the tiles that share a weight
//    tile run together and read it from HBM once.
// The tensor-map encoder is looked up through the runtime's entry-point
// query, so the library links against the CUDA runtime only; the weight's
// map is encoded once per (device, address, shape), x's on every call.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

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

// ---------------------------------------------------------------------------
// prefill tile (M > 16): bf16 wgmma, x and the raw weight tile by TMA
// ---------------------------------------------------------------------------
namespace wg {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// K-major operand with the 128-byte swizzle: rows of 128 bytes of K (16-byte
// chunk c of row r stored at chunk c ^ (r & 7)), 8-row atoms 1024 bytes
// apart; a tile starts 1024-byte aligned, a k-step adds 32 bytes
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// d (64 weight columns x BT tokens, f32, BT / 2 a thread) = (accumulate ? d :
// 0) + a (64 x 16 bf16, registers) * b (16 x BT bf16, K-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous window
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load2(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
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
// tile, in a ring of NWB); thread 0 loads unit u + NU once both warpgroups
// have released unit u (an mbarrier of two arrivals). Each warpgroup walks
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
  const uint32_t empty = full + 8 * NU;           // NU mbarriers: both warpgroups are done

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
  // unit u's products done: release its stage (one arrival per warpgroup),
  // and thread 0 refills it with unit u + NU once both have
  auto release = [&](int u) {
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * (u % NU));
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
      mbar_init(empty + 8 * s, 2);
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

  if (!live) return;
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

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (the library links against the CUDA runtime only)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// x bf16 [E, M, K] read in boxes of 64 columns x bt rows of one expert,
// 128-byte swizzle; rows past M arrive as zeros
bool x_map(CUtensorMap* map, const void* x, int E, int M, int K, int bt) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)M * K * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)bt, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the packed weight [K2, EN] in boxes of 128 rows x BN bytes, 128-byte
// swizzle, encoded once per (device, address, shape): the weights of a
// served model do not move, and each encoding is a driver call
bool weight_map(CUtensorMap* map, const uint8_t* w, int K2, int EN) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  const std::tuple<int, const void*, int, int> key(dev, w, K2, EN);
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int>, CUtensorMap> maps;
  std::lock_guard<std::mutex> lock(mu);
  auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return true;
  }
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)EN, (cuuint64_t)K2};
  const cuuint64_t strides[1] = {(cuuint64_t)EN};
  const cuuint32_t box[2] = {(cuuint32_t)BN, (cuuint32_t)KB};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<uint8_t*>(w), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (maps.size() >= 4096) maps.clear();  // addresses reused by other tensors
  maps.emplace(key, *map);
  return true;
}

template <int BT>
int launch(const __nv_bfloat16* x, const uint8_t* w, const float* sc, float* of,
           __nv_bfloat16* ob, int E, int M, int N, int K2, int EN, cudaStream_t s) {
  using T = Tile<BT>;
  CUtensorMap xmap, wmap;
  if (!x_map(&xmap, x, E, M, 2 * K2, BT) || !weight_map(&wmap, w, K2, EN))
    return (int)cudaErrorInvalidValue;
  static unsigned done = 0;  // devices whose shared memory limit is raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(done >> dev & 1u)) {
    err = cudaFuncSetAttribute(w4a16_wg_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) done |= 1u << dev;
  }
  dim3 grid((M + BT - 1) / BT, (N + BN - 1) / BN, E);
  w4a16_wg_kernel<BT><<<grid, NT, T::SMEM, s>>>(xmap, wmap, sc, of, ob, M, N, K2, EN);
  return (int)cudaGetLastError();
}

}  // namespace wg

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
    return (int)cudaGetLastError();
  }
  // 128 tokens a CTA halve the fragment work per product, where that still
  // leaves at least half the SMs a CTA; else 64
  static int sms[32] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long ctas128 = (long)((M + 127) / 128) * ((N + wg::BN - 1) / wg::BN) * E;
  if (M > 64 && 2 * ctas128 >= (dev < 32 ? sms[dev] : 132))
    return wg::launch<128>(xp, w, sc, of, ob, E, M, N, K2, EN, s);
  return wg::launch<64>(xp, w, sc, of, ob, E, M, N, K2, EN, s);
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
