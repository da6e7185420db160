// Byte-weight GEMMs for Hopper (sm_90a): bf16 activations x int8 or e4m3
// weights on the bf16 tensor cores (f32 accumulate), then the f32 scale on
// the f32 result. One kernel of each tile serves both:
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
// bf16, so each weight becomes its exact bf16 in registers and multiplies
// x in bf16 into f32. No fp8 MMA: that would quantize x to e4m3 and change
// the reference's numerics. The scale multiplies the f32 sum once, after
// any cluster sum, then the result rounds to the output type.
//
// Conversions, on the tiles' hot ALU path (two weights a bf16x2):
//  * int8: the byte b under 0x43 is the bf16 2^s (128 + m), s its sign bit
//    (the exponent's lowest bit), m = b & 0x7F, so b = v * (s ? .5 : 1) -
//    (s ? 256 : 128): one bf16 fma whose factor and addend come from s by
//    bit operations, exact (an integer of at most 8 bits);
//  * e4m3: the hardware's e4m3x2 -> f16x2 conversion (exact; every e4m3
//    value is a normal f16 or zero), then the f16 bits less their three
//    low mantissa zeros, sign apart, are the bf16 of 2^-112 times the
//    value (a normal bf16): one bf16 multiply by 2^112, exact.
//
// What bounds it on an H100: at decode (M <= 16) the K*N weight bytes over
// 3.35 TB/s of HBM; at M = 128 and N = 28672 the bf16 multiply-adds over
// the 989 TFLOP/s of the tensor cores come near the bytes.
//
// Both tiles run the product transposed, out^T = W^T x^T: the weights are
// the MMA's A operand, built in registers straight from the raw byte tile in
// shared memory (a thread's fragment rows are adjacent weight columns: one
// 16-bit load per k-row for two of them, 32-bit for four, byte permutes,
// the conversion), and x is the B operand, K-major as it lies in device
// memory. No byte is transposed and no bf16 weight tile is written.
//
// Decode tile (M <= 16): mma.sync m16n8k16, one CTA of 4 warps per 128
// weight columns (32 a warp: two m16 tiles sharing each x fragment) and 8
// or 16 tokens (one or two n8 tiles). Each CTA streams half-blocks of 64
// k-rows (the raw [64, 128] byte tile, each k-row one 128-byte line of W,
// and the half-block's x rows) through a ring of 4 cp.async stages, so the
// next half-blocks' bytes are in flight while one's MMAs run (on the card
// 64-column tiles, 128-row stages or 6-8 stages ran the Llama decode shapes
// no faster). Where the output has few tiles, a
// thread-block cluster of R in {1, 2, 4, 8} CTAs shares one tile: rank r
// walks a contiguous run of the blocks, writes its f32 partial to shared
// memory, and after a cluster barrier the rank that owns each slice of the
// tile sums the ranks' partials in rank order over distributed shared
// memory, scales and rounds once. One launch, no scratch tensor, a
// deterministic sum; the Python wrapper picks R.
//
// Tile above M = 16: wgmma m64nBTk16 .f32.bf16.bf16 (wgmma_tile.cuh):
//  * a CTA of two warpgroups owns 128 weight columns (64 each) and BT
//    tokens: 128 where that leaves at least half the SMs a CTA, else 64;
//    the grid runs token tiles fastest (they share the weight tile in L2);
//  * a stage is one half of a 128-row block: thread 0 loads its x columns
//    (one 64-column box, a 3-D map over [1, M, K], rows past M zeros) and
//    its raw [64, 128] byte tile (128-byte swizzle) by TMA onto an
//    mbarrier, in a ring of 4 stages, and refills a stage once all 8 warps
//    released it (each after its own reads of the raw tile);
//  * a warpgroup keeps one f32 accumulator over its whole K walk: a half's
//    4 products run while the next half's fragments are built;
//  * where the output has few tiles, a cluster of R in {1, 2, 4, 8} CTAs
//    (64 tokens a CTA) splits the blocks and sums in rank order over
//    distributed shared memory as the decode tile does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "cluster_decode.cuh"  // cp.async, the shared memory limit
#include "e4m3.cuh"            // e4m3x2_to_bf16x2
#include "wgmma_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int KB = 128;  // k rows of one block (a decode stage; two wgmma stages)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two int8 weights, the bytes of p that `sel` puts in each lane's low byte
// (0x4140: bytes 0, 1; 0x4342: bytes 2, 3) -> bf16x2, exact
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t p, uint32_t sel) {
  const uint32_t v = __byte_perm(p, 0x43434343u, sel);  // lanes 0x43 | b: 2^s (128 + m)
  const uint32_t s = v & 0x00800080u;
  return bits(__hfma2(as_bf16x2(v), as_bf16x2(s ^ 0x3F803F80u),   // 1 or 0.5
                      as_bf16x2(s | 0xC300C300u)));               // -128 or -256
}

// A fragments of one k16 step from p0 = bytes (k, column) (2t, c) (2t+1, c)
// (2t, c+1) (2t+1, c+1) and p1 the same at k-rows 2t+8, 2t+9: fragment row
// g is column c, row g + 8 column c + 1
template <bool E4M3>
__device__ __forceinline__ void byte_fragments(uint32_t p0, uint32_t p1, uint32_t (&a)[4]) {
  if (E4M3) {
    a[0] = e4m3x2_to_bf16x2(p0);
    a[1] = e4m3x2_to_bf16x2(p0 >> 16);
    a[2] = e4m3x2_to_bf16x2(p1);
    a[3] = e4m3x2_to_bf16x2(p1 >> 16);
  } else {
    a[0] = s8x2_to_bf16x2(p0, 0x4140);
    a[1] = s8x2_to_bf16x2(p0, 0x4342);
    a[2] = s8x2_to_bf16x2(p1, 0x4140);
    a[3] = s8x2_to_bf16x2(p1, 0x4342);
  }
}

// the scales of output columns n and n + 1 (both inside W): per column
// (int8) or the tensor's (e4m3)
template <bool E4M3>
__device__ __forceinline__ float2 col_scales(const float* __restrict__ scale, int n) {
  return E4M3 ? make_float2(scale[0], scale[0]) : make_float2(scale[n], scale[n + 1]);
}

// ---------------------------------------------------------------------------
// decode tile (M <= 16): mma.sync, the blocks split over a cluster
// ---------------------------------------------------------------------------
namespace dec {

constexpr int BN = 128;        // weight columns a CTA: 4 warps of 32
constexpr int SK = KB / 2;     // k rows of a stage: half a block
constexpr int UB = KB / SK;    // stages a block
constexpr int NS = 4;          // cp.async stages
constexpr int NT = 128;        // threads a CTA
constexpr int WB = SK * BN;    // the raw byte [SK, 128] tile
constexpr int XC = SK / 8;     // 16-byte chunks of a token's x row in a stage

// TOK = 8 MT tokens a CTA (MT n8 tiles of the transposed product)
template <int MT>
struct Stage {
  static constexpr int TOK = 8 * MT;
  static constexpr int XB = TOK * SK * 2;  // the stage's x rows, bf16
  static constexpr int BYTES = WB + XB;
  static constexpr int SMEM = NS * BYTES + TOK * BN * 4;  // + the rank's partial
};

// Shared memory of a stage: the raw tile [64][128 B] (each k-row one
// 128-byte line of W), 16-byte chunk c of k-row r at chunk c ^ (2 ((r >> 1)
// & 3)) (the 4 k-rows 2t + j a fragment load reads fall in distinct
// chunks); x [TOK][64 bf16], chunk c of token m at chunk c ^ (m & 7) (the 8
// tokens a B load reads, likewise). Warp w owns columns 32 w .. 32 w + 31:
// a thread loads the 4 bytes of columns c0 = 32 w + 4 g .. c0 + 3 of a
// k-row at once; A tile i takes columns c0 + 2 i (fragment row g) and
// c0 + 2 i + 1 (row g + 8), so acc[i][mt][c] holds column c0 + 2 i + c / 2
// for token 8 mt + 2 t + c % 2.
template <int MT, bool E4M3>
__global__ void __launch_bounds__(NT)
w8_dec_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale, float* __restrict__ out_f32,
              __nv_bfloat16* __restrict__ out_bf16, int M, int N, int K, int R) {
  using S = Stage<MT>;
  constexpr int TOK = S::TOK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem + NS * S::BYTES);  // [TOK][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % R, n0 = (blockIdx.x / R) * BN;
  const int nblk = K / KB;
  const int b0 = rank * nblk / R, nb = (rank + 1) * nblk / R - b0;  // this rank's blocks
  const int nunits = UB * nb;
  const int c0 = 32 * warp + 4 * g;
  const int live = min(BN, N - n0) / 16;  // 16-byte chunks of a k-row inside W (N % 128 == 64)
  w += n0;

  // x rows past M stay zero: no load writes them
  for (int i = tid; i < NS * (TOK - M) * XC; i += NT) {
    const int st = i / ((TOK - M) * XC), r = i % ((TOK - M) * XC);
    *reinterpret_cast<uint4*>(smem + st * S::BYTES + WB + (M * XC + r) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  // unit u: k-rows [SK u, SK u + SK) of the rank's run
  auto load = [&](int st, int u) {
    unsigned char* s = smem + st * S::BYTES;
    const int k0 = (UB * b0 + u) * SK;
    for (int i = tid; i < SK * 8; i += NT) {
      const int r = i >> 3, c = i & 7;
      if (c < live)
        cluster_decode::cp_async16(s + r * BN + ((c ^ (((r >> 1) & 3) << 1)) << 4),
                                   w + (size_t)(k0 + r) * N + 16 * c);
    }
    for (int i = tid; i < M * XC; i += NT) {
      const int m = i / XC, c = i % XC;
      cluster_decode::cp_async16(s + WB + (m * XC + (c ^ (m & 7))) * 16,
                                 x + (size_t)m * K + k0 + 8 * c);
    }
  };

#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < nunits) load(st, st);
    cluster_decode::cp_async_commit();
  }
  float acc[2][MT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][mt][c] = 0.f;

  for (int u = 0; u < nunits; ++u) {
    cluster_decode::cp_async_wait<NS - 2>();
    __syncthreads();  // unit u landed for every thread; stage (u - 1) % NS is free
    if (u + NS - 1 < nunits) load((u + NS - 1) % NS, u + NS - 1);
    cluster_decode::cp_async_commit();
    const unsigned char* s = smem + (u % NS) * S::BYTES;
    const unsigned char* xs = s + WB;
#pragma unroll
    for (int ks = 0; ks < SK / 16; ++ks) {
      uint32_t wv[4], a[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * ks + 2 * t + (j & 1) + 8 * (j >> 1);
        wv[j] = *reinterpret_cast<const uint32_t*>(s + r * BN + (((c0 >> 4) ^ (t << 1)) << 4) +
                                                   (c0 & 15));
      }
      // bytes (k, column) of A tile 0: (2t, c0) (2t+1, c0) (2t, c0+1) (2t+1, c0+1),
      // then the same 8 rows on; tile 1 the same of columns c0 + 2, c0 + 3
      byte_fragments<E4M3>(__byte_perm(wv[0], wv[1], 0x5140), __byte_perm(wv[2], wv[3], 0x5140),
                           a[0]);
      byte_fragments<E4M3>(__byte_perm(wv[0], wv[1], 0x7362), __byte_perm(wv[2], wv[3], 0x7362),
                           a[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = 8 * mt + g;
        const unsigned char* xr = xs + m * (16 * XC) + 4 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr + (((2 * ks) ^ (m & 7)) << 4));
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + (((2 * ks + 1) ^ (m & 7)) << 4));
        mma_bf16(acc[0][mt], a[0], b0, b1);
        mma_bf16(acc[1][mt], a[1], b0, b1);
      }
    }
  }

  auto store = [&](int m, int col, float v) {
    const size_t o = (size_t)m * N + n0 + col;
    if (out_bf16 != nullptr)
      out_bf16[o] = __float2bfloat16(v);
    else
      out_f32[o] = v;
  };
  if (R == 1) {
    if (n0 + c0 >= N) return;  // (N % 128 == 64: the last tile's right half)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 sc = col_scales<E4M3>(scale, n0 + c0 + 2 * i);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = 8 * mt + 2 * t + (c & 1);
          if (m < M)
            store(m, c0 + 2 * i + (c >> 1), __fmul_rn(acc[i][mt][c], (c & 2) ? sc.y : sc.x));
        }
    }
    return;
  }
  // the cluster's sum: every rank's partial to shared memory; rank r owns
  // columns [r BN / R, (r + 1) BN / R) of the tile, adds the ranks' partials
  // in rank order and scales the sum. Every CTA reaches both barriers; the
  // second keeps each CTA's shared memory alive while another still reads it.
#pragma unroll
  for (int i = 0; i < 2; ++i)
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
    if (n0 + col >= N) continue;
    float v = cluster.map_shared_rank(part, 0)[m * BN + col];
    for (int q = 1; q < R; ++q) v = __fadd_rn(v, cluster.map_shared_rank(part, q)[m * BN + col]);
    store(m, col, __fmul_rn(v, E4M3 ? scale[0] : scale[n0 + col]));
  }
  cluster.sync();
}

template <int MT, bool E4M3>
int launch(const __nv_bfloat16* x, const uint8_t* w, const float* sc, float* of,
           __nv_bfloat16* ob, int M, int N, int K, int R, cudaStream_t s) {
  static unsigned done = 0;  // devices whose shared memory limit is raised
  const int err = cluster_decode::allow_smem(w8_dec_kernel<MT, E4M3>, Stage<MT>::SMEM, done);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN * R, 1, 1);
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
  return (int)cudaLaunchKernelEx(&cfg, w8_dec_kernel<MT, E4M3>, x, w, sc, of, ob, M, N, K, R);
}

}  // namespace dec

// ---------------------------------------------------------------------------
// tile above M = 16: bf16 wgmma, x and the raw byte tile by TMA
// ---------------------------------------------------------------------------
namespace wg {

using namespace wgmma_tile;

constexpr int BN = 128;          // weight columns a CTA: two warpgroups of 64
constexpr int HK = KB / 2;       // k rows of a stage: one half of a block
constexpr int NU = 4;            // TMA stages
constexpr int NT = 256;          // threads a CTA
constexpr int WT = HK * BN;      // a stage's raw byte [64, BN] tile

// BT tokens a CTA (the wgmma's N): 64 or 128, chosen by launch() from M and
// the CTAs each gives
template <int BT>
struct Tile {
  static constexpr int XB = BT * 128;   // a stage's x: one TMA box of BT rows x 64 bf16
  static constexpr int SMEM = 1024 + NU * (XB + WT) + 2 * NU * 8;
};

// Stages are halves of blocks: unit u holds x's 64-column box and the raw
// weight tile of k-rows [64 u, 64 u + 64) of the rank's run. Thread 0 loads
// unit u + NU once all 8 warps have released unit u (an mbarrier of eight
// arrivals: a warpgroup's products retiring does not mean its other warps
// are done reading the raw tile). A-fragment row r of warp w holds weight
// column 16 w + 2 (r % 8) + r / 8 of its warpgroup's 64; its accumulator's
// rows 2 r and 2 r + 1 are the columns c0 and c0 + 1.
template <int BT, bool E4M3>
__global__ void __launch_bounds__(NT, 1)
w8_wg_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
             const float* __restrict__ scale, float* __restrict__ out_f32,
             __nv_bfloat16* __restrict__ out_bf16, int M, int N, int K, int R) {
  using T = Tile<BT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                       // [NU][BT][128 B], swizzled
  unsigned char* wr = xs + NU * T::XB;            // [NU][64][BN] raw, swizzled
  const uint32_t full = smem_u32(wr + NU * WT);   // NU mbarriers: the unit landed
  const uint32_t empty = full + 8 * NU;           // NU mbarriers: all 8 warps are done

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgi = warp >> 2, wiw = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int rank = blockIdx.x % R, m0 = (blockIdx.x / R) * BT, n0 = blockIdx.y * BN;
  const int nblk = K / KB;
  const int b0 = rank * nblk / R, nb = (rank + 1) * nblk / R - b0;  // this rank's blocks
  const int nunits = 2 * nb;
  const int c0 = 64 * wgi + 16 * wiw + 2 * gid;  // this thread's two weight columns

  auto load_unit = [&](int u) {
    const int st = u % NU, k = (2 * b0 + u) * HK;
    const uint32_t bar = full + 8 * st;
    mbar_expect_tx(bar, T::XB + WT);
    tma_load3(smem_u32(xs + st * T::XB), &xmap, k, m0, 0, bar);
    tma_load2(smem_u32(wr + st * WT), &wmap, n0, k, bar);
  };
  // A fragments of unit u (4 k-steps): k-rows 16 ks + 2 tig (+1, +8, +9)
  // of the thread's two columns
  auto fragments = [&](uint32_t (&a)[4][4], int u) {
    const unsigned char* t = wr + (u % NU) * WT;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * ks + 2 * tig + (j & 1) + 8 * (j >> 1);
        w[j] = *reinterpret_cast<const uint16_t*>(t + r * BN + ((((c0 >> 4) ^ (r & 7)) << 4) |
                                                                (c0 & 15)));
      }
      // the 16-bit loads of k-rows 2t, 2t+1, 2t+8, 2t+9 of columns c0, c0 + 1
      byte_fragments<E4M3>(__byte_perm(w[0], w[1], 0x5140), __byte_perm(w[2], w[3], 0x5140),
                           a[ks]);
    }
  };
  float d[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) d[i] = 0.f;
  // the 4 products of unit u into d, one commit group
  auto products = [&](const uint32_t (&a)[4][4], int u) {
    const uint32_t xb = smem_u32(xs + (u % NU) * T::XB);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs(d, a[ks], desc(xb + 32 * ks), 1);
    wgmma_commit();
  };
  // unit u's products done and this warp's reads of its raw tile too:
  // release its stage (one arrival per warp, after the warp's lanes are
  // done), and thread 0 refills it with unit u + NU once all warps have
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

  uint32_t a0[4][4], a1[4][4];
  mbar_wait(full, 0);
  fragments(a0, 0);
  // every product is issued unconditionally (a wgmma in a branch is
  // serialized by ptxas)
  for (int blk = 0; blk < nb; ++blk) {
    const int u0 = 2 * blk, u1 = u0 + 1;
    products(a0, u0);
    mbar_wait(full + 8 * (u1 % NU), (u1 / NU) & 1);
    fragments(a1, u1);
    wgmma_wait();
    fence_regs(d);
    release(u0);
    products(a1, u1);
    if (blk + 1 < nb) {
      mbar_wait(full + 8 * ((u0 + 2) % NU), ((u0 + 2) / NU) & 1);
      fragments(a0, u0 + 2);
    }
    wgmma_wait();
    fence_regs(d);
    release(u1);
  }

  auto store = [&](int m, int col, float v0, float v1) {  // columns col and col + 1
    const size_t o = (size_t)m * N + n0 + col;
    if (out_bf16 != nullptr)
      *reinterpret_cast<__nv_bfloat162*>(out_bf16 + o) = __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(out_f32 + o) = make_float2(v0, v1);
  };
  if (R > 1) {
    // the cluster's sum: every rank's f32 partial [BT][BN] to its x stages
    // (free once all warps are past the walk); rank r owns columns
    // [r BN / R, (r + 1) BN / R), adds the ranks' partials in rank order
    // and scales the sum. Every CTA reaches both barriers; the second keeps
    // each CTA's shared memory alive while another still reads it.
    static_assert(BT * BN * 4 <= NU * T::XB, "the partial fits the x stages");
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
      const float2 sc = col_scales<E4M3>(scale, n0 + col);
      store(m0 + tok, col, __fmul_rn(v.x, sc.x), __fmul_rn(v.y, sc.y));
    }
    cluster.sync();
    return;
  }
  if (n0 + c0 >= N) return;  // (N % 128 == 64: the last tile's right half)
  const float2 sc = col_scales<E4M3>(scale, n0 + c0);
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = m0 + 8 * j + 2 * tig + c;
      if (m < M)
        store(m, c0, __fmul_rn(d[4 * j + c], sc.x), __fmul_rn(d[4 * j + 2 + c], sc.y));
    }
}

template <int BT, bool E4M3>
int launch(const __nv_bfloat16* x, const uint8_t* w, const float* sc, float* of,
           __nv_bfloat16* ob, int M, int N, int K, int R, cudaStream_t s) {
  using T = Tile<BT>;
  CUtensorMap xmap, wmap;
  if (!x_map(&xmap, x, 1, M, K, BT) ||
      !byte_map(&wmap, w, K, N, HK, BN, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static unsigned done = 0;  // devices whose shared memory limit is raised
  const int err = cluster_decode::allow_smem(w8_wg_kernel<BT, E4M3>, T::SMEM, done);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + BT - 1) / BT * R, (N + BN - 1) / BN, 1);
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
  return (int)cudaLaunchKernelEx(&cfg, w8_wg_kernel<BT, E4M3>, xmap, wmap, sc, of, ob, M, N, K,
                                 R);
}

}  // namespace wg

template <bool E4M3>
int launch(const void* x, const void* w, const void* scale, void* out_f32, void* out_bf16, int M,
           int N, int K, int ranks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out_f32);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out_bf16);
  if ((ranks != 1 && ranks != 2 && ranks != 4 && ranks != 8) || ranks > K / KB)
    return (int)cudaErrorInvalidValue;
  if (M <= 16)
    return M <= 8 ? dec::launch<1, E4M3>(xp, wp, sc, of, ob, M, N, K, ranks, s)
                  : dec::launch<2, E4M3>(xp, wp, sc, of, ob, M, N, K, ranks, s);
  // 128 tokens a CTA halve the fragment work per product, where that still
  // leaves at least half the SMs a CTA (and the blocks are not split); else 64
  const long ctas128 = (long)((M + 127) / 128) * ((N + wg::BN - 1) / wg::BN);
  if (ranks == 1 && M > 64 && 2 * ctas128 >= wgmma_tile::sm_count())
    return wg::launch<128, E4M3>(xp, wp, sc, of, ob, M, N, K, 1, s);
  return wg::launch<64, E4M3>(xp, wp, sc, of, ob, M, N, K, ranks, s);
}

}  // namespace

// x bf16 [M, K]; w int8 [K, N]; scale f32 [N]. Exactly one of out_f32 /
// out_bf16 [M, N] is non-null. ranks: the CTAs of one cluster that share an
// output tile (1, 2, 4 or 8, at most K / 128). Needs K % 128 == 0,
// N % 64 == 0 and 16-byte aligned x and w (checked by the Python wrapper).
extern "C" int w8a16_gemm(const void* x, const void* w, const void* scale, void* out_f32,
                          void* out_bf16, int M, int N, int K, int ranks, void* stream) {
  return launch<false>(x, w, scale, out_f32, out_bf16, M, N, K, ranks, stream);
}

// x bf16 [M, K]; w e4m3 [K, N]; scale f32 [1]. As w8a16_gemm.
extern "C" int wfp8_gemm(const void* x, const void* w, const void* scale, void* out_f32,
                         void* out_bf16, int M, int N, int K, int ranks, void* stream) {
  return launch<true>(x, w, scale, out_f32, out_bf16, M, N, K, ranks, stream);
}
