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
// (K/2 * N) over the 3.35 TB/s of HBM; at prefill (M = 544) the integer
// multiply-adds over the int8 tensor cores' 1979 TOPS.
//
// The nibbles are never widened to a wider type. For one packed byte b:
// (b & 0xF0) read as int8 is exactly 16 * q_hi and ((b << 4) & 0xF0) ^ 0x80
// read as int8 is exactly 16 * q_lo. So one 32-bit word of four packed
// bytes gives four int8 operands of either half after one or two logic ops,
// and both tiles take c * (s / 16) for q * s (c the s32 sum of 16 q x).
//
// Why every tile is bit for bit the plain version (w4a8_gemm_plain): the
// dots of one 128-row scale block are integer sums (exact in any order and
// on any unit, CUDA cores or tensor cores); each block's f32 update is
// acc = (acc + q_lo * s_lo) + q_hi * s_hi with every product and sum
// rounded on its own (__fmul_rn / __fadd_rn, no fused multiply-add), block
// by block in the plain version's order. No tile splits an f32 sum (the
// decode tile's cluster splits only the integer dots).
//
// Decode tile (M <= 8): int8 tensor cores (mma.sync m16n8k32 s8 x s8 ->
// s32) on the transposed product out^T = W^T x^T, the weights the A
// operand: one CTA of 4 warps per 128 weight columns, the 8 tokens one n8
// tile (tokens past M zero). Each CTA streams half-blocks (the raw packed
// [64, 128] tile, each k-row one 128-byte line of W, and their x columns of
// both halves) through a ring of 4 cp.async stages, so the next half-blocks'
// bytes are in flight while one's products run. A lane turns the raw tile
// into A fragments in registers (a 4 x 4 byte transpose: four consecutive
// k of one column in a register) and takes 16 q_lo and 16 q_hi from each
// byte by two logic ops; no transposed tile is written. Where the output
// has few tiles, a thread-block cluster of R in {1, 2, 4, 8} CTAs shares
// one tile: each rank takes the exact s32 dots of its contiguous run of
// blocks and keeps their rounded f32 products (dot times block scale) in
// shared memory, and after a cluster barrier the rank owning each column
// slice replays the f32 block recurrence's sums over all blocks in order
// over distributed shared memory. One launch, no scratch tensor; f32 sums
// are never split across ranks. The Python wrapper picks R (_w4a8_ranks).
//
// Prefill tile (M > 8): int8 tensor cores through wgmma
// (m64n128k32.s32.s8.s8, both operands K-major in shared memory with the
// 128-byte swizzle). A CTA owns a BM x 128 output tile, one warpgroup per 64
// rows (BM = 128, or 64 for M <= 64), and walks the scale blocks:
//  * per block, one thread loads x's two 128-column halves and the raw
//    packed [128, 128] weight tile by TMA onto an mbarrier, two blocks
//    ahead in a 3-stage ring (rows past M, columns past N arrive as zeros);
//    the scale rows come by cp.async;
//  * the raw tile is transposed k-contiguous per column into two operand
//    tiles, 16 * q_lo and 16 * q_hi (wgmma takes 8-bit operands K-major
//    only), double-buffered, each warp's stores in 32 distinct banks;
//  * block b's low-half products run while block b-1's high-half f32
//    update runs, its high-half products while its low-half update and the
//    next tile's transposition run; the s32 sums restart each block (the
//    first k-step does not accumulate), and only one block's two sets of
//    s32 accumulators are live;
//  * the f32 update takes c * (s / 16): an exact int-to-float, one product
//    and one sum, each rounded alone;
//  * the grid runs M tiles fastest, so the tiles that share a weight tile
//    run together and read it from HBM once.
// The tensor-map encoder is looked up through the runtime's entry-point
// query, so the library links against the CUDA runtime only; the weight's
// map is encoded once per (device, address, shape), x's on every call.
// f32 output at M <= 256 and bf16 above (the wrapper's rule).
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "cluster_decode.cuh"  // cp.async, the shared memory limit
#include "w4a8_tile.cuh"       // the decode tile's stage, loader and fragment builder

namespace {

constexpr int KB = 128;  // rows of one scale block

// ---------------------------------------------------------------------------
// decode tile (M <= 8): int8 mma.sync on a cp.async ring, the blocks split
// over a cluster that replays the f32 block recurrence in order
// ---------------------------------------------------------------------------
namespace dec {

namespace cg = cooperative_groups;
using w4a8_tile::cluster_addr;
using w4a8_tile::ld_cluster;
using w4a8_tile::BN;               // weight columns a CTA: 4 warps of 32
using w4a8_tile::NT;               // threads a CTA
using w4a8_tile::SK;               // packed rows of a stage: half a block

constexpr int NS = 4;              // cp.async stages
constexpr int TOK = 8;             // tokens: the n8 of the transposed product
constexpr int WB = SK * BN;        // a stage's raw packed [64, 128] tile
constexpr int XB = 2 * TOK * SK;   // its x rows, both halves: [2][8][64]
constexpr int STAGE = w4a8_tile::stage_bytes(TOK);  // and a block's two scale rows
constexpr int HELD = 2 * TOK * BN * 4;  // one held block (R > 1): its f32 products, both halves
constexpr int KREG = 4;  // a rank's last blocks, kept aside until the ring is free
constexpr int MAX_SMEM = 227 * 1024;
static_assert(KREG * HELD <= NS * STAGE, "the ring takes the last blocks' products");

// dynamic shared memory of a CTA when a cluster of R splits nblk blocks
// (a rank holds at most nbmax = ceil(nblk / R)): the ring and, at R > 1,
// the products of all but a rank's last KREG blocks (those go into the
// ring once the main loop is done), then the replay's table of every
// block's shared::cluster address
__host__ __device__ constexpr int held_bytes(int nbmax) {
  return nbmax > KREG ? (nbmax - KREG) * HELD : 0;
}
constexpr int smem_bytes(int nblk, int R) {
  return NS * STAGE + (R > 1 ? held_bytes((nblk + R - 1) / R) + 4 * nblk : 0);
}

// A CTA of 4 warps owns 128 weight columns (tile n0 = blockIdx.x / R) and
// rank r = blockIdx.x % R of its cluster walks the contiguous run of blocks
// [r nblk / R, (r + 1) nblk / R), both halves of each: out^T = W^T x^T on
// mma.sync m16n8k32 s8 x s8 -> s32, the weights the A operand.
//
// Stage u of the ring (w4a8_tile.cuh): packed rows [64 u', 64 u' + 64) of
// the run (u' its index in W), their x columns of both halves and, on a
// block's second stage, its two scale rows; w4a8_tile::stage_dots takes
// each stage's products, d[i][h][0][e] column c0 + 2 i + e / 2 (c0 =
// 32 w + 4 g), token 2 t + e % 2 of half h (0: 16 q_lo, 1: 16 q_hi).
//
// The s32 dots restart every block. R = 1: after each block the f32 update
// acc = (acc + c_lo (s_lo / 16)) + c_hi (s_hi / 16) in registers. R > 1:
// the rank that holds a block rounds its two products c (s / 16) (each on
// its own, as the update would: a product is no sum) and keeps them,
// [2][8][128] f32 a block: past the ring in shared memory, except its last
// KREG blocks, which wait in local memory until the main loop is done and
// then go into the ring (so that three CTAs fit an SM at K = 14336, and a
// wave holds every cluster). After a cluster barrier rank r owns columns
// [r 128 / R, (r + 1) 128 / R) of the tile and replays the sums
// acc = (acc + p_lo) + p_hi over every block in block order, reading each
// block's products from the rank that holds it over distributed shared
// memory (ld.shared::cluster, its address from a table each CTA builds),
// eight blocks' loads in flight. No f32 sum is ever split: the result is
// the plain version's bit for bit.
__global__ void __launch_bounds__(NT)
w4a8_dec_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out_f32,
                __nv_bfloat16* __restrict__ out_bf16, int M, int N, int K2, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* held = smem + NS * STAGE;  // [blocks of the rank but the last KREG][HELD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % R, n0 = (blockIdx.x / R) * BN;
  const int nblk = K2 / KB, K = 2 * K2;
  const int b0 = rank * nblk / R, nb = (rank + 1) * nblk / R - b0;  // this rank's blocks
  const int nunits = 2 * nb;
  const int nsm = max(nb - KREG, 0);  // blocks whose products go to `held` (R > 1)
  // the replay's table: block b's products in its rank, as a shared::cluster address
  uint32_t* baddr = reinterpret_cast<uint32_t*>(held + held_bytes((nblk + R - 1) / R));
  const int c0 = 32 * warp + 4 * g;
  const int live = min(BN, N - n0) / 16;  // 16-byte chunks of a k-row inside W (N % 128 == 64)
  w += n0;
  scale += n0;

  // x rows past M stay zero: no load writes them
  for (int i = tid; i < NS * 2 * (TOK - M) * (SK / 16); i += NT) {
    const int st = i / (2 * (TOK - M) * (SK / 16)), r = i % (2 * (TOK - M) * (SK / 16));
    const int h = r / ((TOK - M) * (SK / 16)), c = r % ((TOK - M) * (SK / 16));
    *reinterpret_cast<uint4*>(smem + st * STAGE + WB + (h * TOK + M) * SK + 16 * c) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  // a block's products [2 halves][8 tokens][128 columns] f32 at pb
  auto store_products = [&](float* pb, const float (&p)[2][2][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(pb + (h * TOK + 2 * t + e) * BN + c0) =
            make_float4(p[0][h][e], p[0][h][e + 2], p[1][h][e], p[1][h][e + 2]);
  };
  const w4a8_tile::StageLoader<TOK> loader(tid, N, live, K, K2, M);
  auto load = [&](int st, int u) {
    const int k0 = (2 * b0 + u) * SK, blk = b0 + (u >> 1);
    loader.issue(smem + st * STAGE, w + (size_t)k0 * N, x + k0, scale + (size_t)blk * N,
                 scale + (size_t)(nblk + blk) * N, (u & 1) ? 3 : 0);
  };

#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < nunits) load(st, st);
    cluster_decode::cp_async_commit();
  }
  int d[2][2][1][4];
  float acc[2][4];
  // the last blocks' products (R > 1): block nsm + j in pr[j]. ptxas keeps
  // them in local memory (L1), which leaves the tile at ~66 registers; held
  // in registers by a shift they cost ~225, and two CTAs an SM
  float pr[KREG][2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int u = 0; u < nunits; ++u) {
    cluster_decode::cp_async_wait<NS - 2>();
    // unit u landed for every thread; every warp is done with stage (u - 1) % NS
    __syncthreads();
    if (u + NS - 1 < nunits) load((u + NS - 1) % NS, u + NS - 1);
    cluster_decode::cp_async_commit();
    if ((u & 1) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[i][h][0][e] = 0;
    }
    const unsigned char* s = smem + (u % NS) * STAGE;
    w4a8_tile::stage_dots<1>(s, c0, g, t, d);
    if ((u & 1) == 0) continue;
    // the block's products c (s / 16): c converts to f32 exactly (|16 q x|
    // sums < 2^24) and s / 16 is exact, so each rounds as q x s does in the
    // plain version
    float sc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(s + WB + XB + h * BN * 4 + 4 * c0);
      sc[h][0] = v.x * 0.0625f;
      sc[h][1] = v.y * 0.0625f;
      sc[h][2] = v.z * 0.0625f;
      sc[h][3] = v.w * 0.0625f;
    }
    float p[2][2][4];  // [tile][half][e]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[i][h][e] = __fmul_rn((float)d[i][h][0][e], sc[h][2 * i + (e >> 1)]);
    if (R == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][e] = __fadd_rn(__fadd_rn(acc[i][e], p[i][0][e]), p[i][1][e]);
    } else if ((u >> 1) < nsm) {
      store_products(reinterpret_cast<float*>(held + (u >> 1) * HELD), p);
    } else {
#pragma unroll
      for (int j = 0; j < KREG; ++j)
        if ((u >> 1) - nsm == j) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) pr[j][i][h][e] = p[i][h][e];
        }
    }
  }

  auto store4 = [&](int m, int col, float v0, float v1, float v2, float v3) {
    const size_t o = (size_t)m * N + n0 + col;
    if (out_bf16 != nullptr) {
      *reinterpret_cast<__nv_bfloat162*>(out_bf16 + o) = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(out_bf16 + o + 2) = __floats2bfloat162_rn(v2, v3);
    } else {
      *reinterpret_cast<float4*>(out_f32 + o) = make_float4(v0, v1, v2, v3);
    }
  };
  if (R == 1) {
    if (n0 + c0 >= N) return;  // (N % 128 == 64: the last tile's right half)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (2 * t + e < M)
        store4(2 * t + e, c0, acc[0][e], acc[0][e + 2], acc[1][e], acc[1][e + 2]);
    return;
  }
  // the last blocks' products into the ring (block nsm + k in ring slot k),
  // once every warp is done with it; the replay's table
  __syncthreads();
#pragma unroll
  for (int j = 0; j < KREG; ++j)
    if (j < nb - nsm) store_products(reinterpret_cast<float*>(smem + j * HELD), pr[j]);
  for (int b = tid; b < nblk; b += NT) {
    const int q = ((b + 1) * R - 1) / nblk;  // the runs start at q nblk / R
    const int qb0 = q * nblk / R, qs = max((q + 1) * nblk / R - qb0 - KREG, 0), lb = b - qb0;
    baddr[b] = cluster_addr(smem + (lb < qs ? NS * STAGE + lb * HELD : (lb - qs) * HELD), q);
  }
  // the replay: every CTA reaches both barriers; the second keeps each CTA's
  // shared memory alive while another still reads it. Thread i: token m,
  // column col of this rank's slice
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int cols = BN / R;
  for (int i = tid; i < M * cols; i += NT) {
    const int m = i / cols, col = rank * cols + i % cols;
    if (n0 + col >= N) continue;
    const uint32_t item = (m * BN + col) * 4;
    float a = 0.f;
    for (int bb = 0; bb < nblk; bb += 8) {
      float p[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t ad = baddr[min(bb + j, nblk - 1)] + item;
        p[j][0] = ld_cluster(ad);
        p[j][1] = ld_cluster(ad + TOK * BN * 4);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (bb + j < nblk) a = __fadd_rn(__fadd_rn(a, p[j][0]), p[j][1]);
    }
    const size_t o = (size_t)m * N + n0 + col;
    if (out_bf16 != nullptr)
      out_bf16[o] = __float2bfloat16(a);
    else
      out_f32[o] = a;
  }
  cluster.sync();
}

int launch(const int8_t* x, const uint8_t* w, const float* sc, float* of, __nv_bfloat16* ob,
           int M, int N, int K2, int R, cudaStream_t s) {
  const int nblk = K2 / KB;
  if (R < 1 || R > 8 || (R & (R - 1)) != 0 || R > nblk) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(nblk, R);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static unsigned done = 0;  // devices whose shared memory limit is raised
  const int err = cluster_decode::allow_smem(w4a8_dec_kernel, MAX_SMEM, done);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN * R, 1, 1);
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
  return (int)cudaLaunchKernelEx(&cfg, w4a8_dec_kernel, x, w, sc, of, ob, M, N, K2, R);
}

}  // namespace dec

// ---------------------------------------------------------------------------
// prefill tile: int8 wgmma (Hopper's warpgroup MMA), operands by TMA
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BN = 128;  // columns a CTA (one wgmma N)
constexpr int NS = 3;    // TMA stages of x and raw weight tiles, two in flight
constexpr int SN = 4;    // cp.async stages of scale rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// st.shared writes made visible to the async proxy that wgmma reads shared
// memory through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// K-major operand tile with the 128-byte swizzle: rows of 128 bytes of K
// (16-byte chunk c of row r stored at chunk c ^ (r & 7)), 8-row atoms
// 1024 bytes apart; the tile starts 1024-byte aligned, a k-step adds 32
// bytes to the start
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// d (64 x 128 s32, 64 a thread) = (accumulate ? d : 0) + a (64 x 32 s8) * b (32 x 128 s8)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
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
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a 2-D box of a tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

template <int WGS>
struct Tile {
  static constexpr int BM = 64 * WGS;            // one warpgroup per 64 rows
  static constexpr int NT = 128 * WGS;
  static constexpr int XS = 2 * BM * KB;         // x bytes a stage (both halves)
  static constexpr int WT = BN * KB;             // one weight tile (raw or operand)
  static constexpr int TASKS = 32 / (4 * WGS);   // weight warp-tasks a warp
  static constexpr int SMEM = 1024 + NS * (XS + WT) + 4 * WT + SN * 2 * BN * 4 + NS * 8;
};

// x tile (both halves) and raw weight tile of a block in stage blk % NS by
// TMA, two blocks ahead; the transposed operand tiles double-buffered; the
// scale rows by cp.async in a ring of SN stages (read one block later than
// the products, by the high half's update)
template <int WGS>
__global__ void __launch_bounds__(Tile<WGS>::NT, 1)
w4a8_wg_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ scale, float* __restrict__ out_f32,
               __nv_bfloat16* __restrict__ out_bf16, int M, int N, int K2) {
  using T = Tile<WGS>;
  constexpr int BM = T::BM, NT = T::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the operand tiles want 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                                  // [NS][2][BM][KB], swizzled
  unsigned char* wr = xs + NS * T::XS;                       // [NS][KB][BN] raw, swizzled
  unsigned char* wt = wr + NS * T::WT;                       // [2][lo, hi][BN][KB], swizzled
  float* ss = reinterpret_cast<float*>(wt + 4 * T::WT);      // [SN][2][BN]
  const uint32_t bars = smem_u32(ss + SN * 2 * BN);          // NS mbarriers

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgi = warp >> 2, wiw = warp & 3;  // warpgroup, warp in it
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nblk = K2 / KB;

  // one thread: the block's x halves and raw weight tile onto the stage's
  // barrier (rows past M and columns past N arrive as zeros)
  auto load_tiles = [&](int blk) {
    const int st = blk % NS;
    const uint32_t bar = bars + 8 * st, xb = smem_u32(xs + st * T::XS);
    mbar_expect_tx(bar, T::XS + T::WT);
    tma_load(xb, &xmap, blk * KB, m0, bar);
    tma_load(xb + BM * KB, &xmap, K2 + blk * KB, m0, bar);
    tma_load(smem_u32(wr + st * T::WT), &wmap, n0, blk * KB, bar);
  };
  auto load_scales = [&](int blk) {
    for (int t = tid; t < 2 * (BN / 4); t += NT) {
      const int half = t / (BN / 4), c4 = t % (BN / 4);
      const bool ok = n0 + 4 * c4 < N;
      const float* src = scale + (size_t)(half * nblk + blk) * N + (ok ? n0 + 4 * c4 : 0);
      cp_async16(smem_u32(ss + ((blk % SN) * 2 + half) * BN + 4 * c4), src, ok);
    }
  };
  // the raw tile of block `blk` (landed), transposed k-contiguous per column
  // into the low-half and high-half operand tiles of buffer `buf`. Warp-task
  // i of this warp is rows kr..kr+3 (kr = 4 (kq + 4 kk)) x columns nc..nc+3
  // (nc = 32 ng + 4 nq); store `it` of a lane writes column (it + nq / 2) % 4
  // of its four, so a warp's 32 words fall in 32 banks
  const int kq = lane >> 3, nq = lane & 7;
  auto transpose = [&](int blk, int buf) {
    const unsigned char* src_t = wr + (blk % NS) * T::WT;
    unsigned char* lo_t = wt + (2 * buf) * T::WT;
    unsigned char* hi_t = lo_t + T::WT;
#pragma unroll
    for (int i = 0; i < T::TASKS; ++i) {
      const int task = warp * T::TASKS + i, kk = task & 7, ng = task >> 3;
      const int kr = 4 * (kq + 4 * kk), nc = 32 * ng + 4 * nq;
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = kr + j;
        r[j] = *reinterpret_cast<const uint32_t*>(src_t + row * KB +
                                                  (((nc >> 4) ^ (row & 7)) << 4) + (nc & 15));
      }
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int c = (it + (nq >> 1)) & 3, nl = nc + c;
        const uint32_t word =
            __byte_perm(c < 2 ? t0 : t2, c < 2 ? t1 : t3, (c & 1) ? 0x7632 : 0x5410);
        const int off = nl * KB + (((kr >> 4) ^ (nl & 7)) << 4) + (kr & 15);
        *reinterpret_cast<uint32_t*>(lo_t + off) = ((word << 4) & 0xF0F0F0F0u) ^ 0x80808080u;
        *reinterpret_cast<uint32_t*>(hi_t + off) = word & 0xF0F0F0F0u;
      }
    }
  };

  // acc += (c / 16) * s for one half's s32 sums c and scale row s: c
  // converts to f32 exactly (|c| < 2^24) and c * (s / 16) is q * s exactly
  // (s / 16 is exact for the quantizer's scales, >= 1e-12 / 7), so each
  // product and sum is rounded alone, as in the plain version
  const int gid = lane >> 2, tig = lane & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  auto update = [&](const int (&c)[64], int blk, int half) {
    const float* sr = ss + ((blk % SN) * 2 + half) * BN + 2 * tig;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 s2 = *reinterpret_cast<const float2*>(sr + 8 * j);
      const float s16[2] = {s2.x * 0.0625f, s2.y * 0.0625f};
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[4 * j + r] = __fadd_rn(acc[4 * j + r], __fmul_rn((float)c[4 * j + r], s16[r & 1]));
    }
  };
  int clo[64], chi[64];
  // the products of one half of block `blk` into c, committed as one group
  auto products = [&](int (&c)[64], int blk, int half) {
    const uint32_t xa = smem_u32(xs + (blk % NS) * T::XS) + (half * BM + 64 * wgi) * KB;
    const uint32_t wb = smem_u32(wt + (2 * (blk & 1) + half) * T::WT);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KB / 32; ++ks) wgmma_s8(c, desc(xa + 32 * ks), desc(wb + 32 * ks), ks);
    wgmma_commit();
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (b < nblk) {
      if (tid == 0) load_tiles(b);
      load_scales(b);
    }
    cp_async_commit();
  }
  mbar_wait(bars, 0);
  transpose(0, 0);

  // Every warpgroup issues every product (rows past M are zeros), so no
  // wgmma sits in a divergent path. Block blk's low-half products run while
  // block blk - 1's high-half update runs, its high-half products while its
  // low-half update and the next weight transposition run.
  for (int blk = 0; blk < nblk; ++blk) {
    wgmma_wait();  // block blk - 1's high half
    fence_regs(chi);
    cp_async_wait<1>();  // scale rows of block blk
    fence_async_smem();  // the operand tiles' st.shared, for wgmma
    mbar_wait(bars + 8 * (blk % NS), (blk / NS) & 1);
    __syncthreads();
    if (blk + 2 < nblk) {
      if (tid == 0) load_tiles(blk + 2);
      load_scales(blk + 2);
    }
    cp_async_commit();

    products(clo, blk, 0);
    if (blk > 0) update(chi, blk - 1, 1);
    wgmma_wait();
    fence_regs(clo);
    products(chi, blk, 1);
    update(clo, blk, 0);
    const int next = min(blk + 1, nblk - 1);
    mbar_wait(bars + 8 * (next % NS), (next / NS) & 1);
    transpose(next, (blk + 1) & 1);
  }
  wgmma_wait();
  fence_regs(chi);
  update(chi, nblk - 1, 1);

  if (m0 + 64 * wgi >= M) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = m0 + 64 * wgi + 16 * wiw + gid + 8 * hr;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * tig;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      const float v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
      if (out_bf16 != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(out_bf16 + o) = __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(out_f32 + o) = make_float2(v0, v1);
    }
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

// a 2-D byte matrix [rows, cols] (row pitch `pitch`) read in boxes of
// box_rows x 128 bytes with the 128-byte swizzle, zeros past its edges
bool byte_map(CUtensorMap* map, const void* base, int rows, int cols, int pitch, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)KB, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the weight's tensor map, encoded once per (device, address, shape): the
// weights of a served model do not move, and each encoding is a driver call
bool weight_map(CUtensorMap* map, const uint8_t* w, int K2, int N) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  const std::tuple<int, const void*, int, int> key(dev, w, K2, N);
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int>, CUtensorMap> maps;
  std::lock_guard<std::mutex> lock(mu);
  auto it = maps.find(key);
  if (it == maps.end()) {
    if (!byte_map(map, w, K2, N, N, KB)) return false;
    if (maps.size() >= 4096) maps.clear();  // addresses reused by other tensors
    maps.emplace(key, *map);
  } else {
    *map = it->second;
  }
  return true;
}

// the dynamic shared memory limit, raised once per kernel and device
template <typename F>
int allow_smem(F* kernel, int bytes, unsigned& done_devices) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 32 && (done_devices >> dev & 1u)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  if (dev < 32) done_devices |= 1u << dev;
  return 0;
}

template <int WGS>
int launch(const int8_t* x, const uint8_t* w, const float* sc, float* of,
           __nv_bfloat16* ob, int M, int N, int K2, cudaStream_t s) {
  using T = Tile<WGS>;
  CUtensorMap xmap, wmap;
  if (!byte_map(&xmap, x, M, 2 * K2, 2 * K2, T::BM) || !weight_map(&wmap, w, K2, N))
    return (int)cudaErrorInvalidValue;
  static unsigned done = 0;
  const int e = allow_smem(w4a8_wg_kernel<WGS>, T::SMEM, done);
  if (e != 0) return e;
  dim3 grid((M + T::BM - 1) / T::BM, (N + BN - 1) / BN);
  w4a8_wg_kernel<WGS><<<grid, T::NT, T::SMEM, s>>>(xmap, wmap, sc, of, ob, M, N, K2);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// xq int8 [M, 2*K2]; packed uint8 [K2, N]; scale f32 [2*K2/128, N].
// Exactly one of out_f32 / out_bf16 is non-null. Needs K2 % 128 == 0,
// N % 64 == 0 and 16-byte aligned xq, packed and scale (checked by the
// Python wrapper). R: the decode tile's cluster size (M <= 8; 1, 2, 4 or 8,
// at most K2 / 128, its dots within the shared memory: the wrapper's
// _w4a8_ranks); the prefill tile ignores it.
extern "C" int w4a8_gemm(const void* xq, const void* packed, const void* scale,
                         void* out_f32, void* out_bf16, int M, int N, int K2, int R,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out_f32);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out_bf16);
  if (M <= 8) return dec::launch(x, w, sc, of, ob, M, N, K2, R, s);
  if (M <= 64) return wg::launch<1>(x, w, sc, of, ob, M, N, K2, s);
  return wg::launch<2>(x, w, sc, of, ob, M, N, K2, s);
}

// The decode tile's dynamic shared memory when a cluster of R CTAs splits
// nblk 128-row blocks, or -1 where it passes a CTA's limit (the launch
// refuses that R). The wrapper's rank picker counts the same bytes
// (quant_gemm._w4a8_smem); chip_smoke.py holds the two equal.
extern "C" int w4a8_dec_smem(int nblk, int R) {
  const int b = dec::smem_bytes(nblk, R);
  return b > dec::MAX_SMEM ? -1 : b;
}
