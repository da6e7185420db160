// Grouped W4A8 GEMMs for Hopper (sm_90a), two entry points:
//   K12 grouped_w4a8_combine_gemm, fused with the routed MoE combine:
//     out[m, n] = sum_e gscale[e, m] * (xq[e, m, :] @ W_e)[:, n]
//   K11 grouped_w4a8_gemm, one product per expert with no gates:
//     out[e, m, n] = (xq[e, m, :] @ W_e)[:, n]
// with int8 activations, int4 block-quantized expert weights, exact int32
// dots on the int8 tensor cores (mma.sync m16n8k32) and f32 block scales.
//
// Replaces: modelopt_tpu/kernels/quant_gemm.py::grouped_w4a8_combine_gemm
// (Pallas body _grouped_w4a8_combine_kernel over _w4a8_body) and
// ::grouped_w4a8_gemm (Pallas body _grouped_w4a8_kernel over _w4a8_body).
//
// Layout: xq int8 [E, M, K]; gscale f32 [E, M] (routing gate x the row's
// activation scale); packed uint8 [K/2, E*N] and scale f32 [K/128, E*N] in
// the folded expert layout (expert e is columns e*N..e*N+N-1, each a
// split-half int4 tensor as in w4a8_gemm.cu). K12 returns f32 [M, N], K11
// f32 [E, M, N].
//
// K/2 need not be a multiple of 128. With rem = K/2 % 128 (then always 64,
// since K % 128 == 0) one scale block straddles the half boundary, and the
// reference's _w4a8_body takes the blocks in this order: the nfull = K/2 /
// 128 low-half blocks (scale rows 0..nfull-1), then the straddle block, whose
// integer dot is the low-nibble tail (packed rows [nfull*128, K/2), x columns
// the same) plus the high-nibble head (packed rows [0, rem), x columns
// [K/2, K/2+rem)) under scale row nfull, then the high-half blocks at packed
// rows rem + b*128 (x columns K/2 + rem + b*128) under scale rows
// nfull+1+b. Each such "stage" updates the f32 accumulator once,
// acc + q*s, in that order. Without a straddle a stage is one block with
// both halves, acc + q_lo*s_lo + q_hi*s_hi.
//
// What bounds it on an H100: the packed bytes and scale rows of the experts
// the kernel must read, over 3.35 TB/s of HBM. K12 reads only the experts
// some row is routed to (a non-zero gscale): at the Qwen3-30B-A3B decode
// shape (E=128, K=768, N=2048, M=8, top-8, about 53 experts used) about
// 44.7 MB, 13.3 us. K11 reads every expert and writes the f32 output
// E*M*N*4: at the same shape about 116 MB, 35 us.
//
// Design: K1's decode tile per expert (w4a8_tile.cuh): out^T = W^T x^T on
// mma.sync, the weights the A operand built in registers from the raw
// packed tile (a 4 x 4 byte transpose; b & 0xF0 is 16 q_hi, ((b << 4) &
// 0xF0) ^ 0x80 is 16 q_lo), the tokens the n8 operand: 8, 16 or 32 tokens
// a CTA for K11, 8 or 16 for K12 (1, 2 or 4 n8 tiles, the template's NJ),
// so that at M <= 32 (K12: 16) each weight byte is read from HBM once. A
// CTA of 4 warps owns 128 weight columns and streams "units" of 64 packed
// rows (each k-row one 128-byte line) with their x columns and the scale
// rows of the stages they end, through a ring of 4 cp.async stages that
// flows from one expert into the next: the next units' bytes are in flight
// while one unit's products run. Each thread's copy offsets are worked out
// once (w4a8_tile::StageLoader). Every unit carries both nibbles of its 64
// packed rows, so each weight byte passes through the ring once. Aligned
// K: block j is units 2 j and 2 j + 1, and ends with the plain version's
// update acc =
// (acc + c_lo (s_lo / 16)) + c_hi (s_hi / 16). Straddle K: the low blocks
// end at odd units and update acc as they end, in order; the high
// nibbles' blocks sit 64 rows later, so high block b ends at unit 2 b + 2:
// its product c (s / 16) is rounded then and held in shared memory (each
// thread its own), and the high head's s32 dots (unit 0) wait in
// registers; at the last unit, 2 nfull, the straddle stage acc + (c_tail +
// c_head) (s / 16), then the held high blocks, in the stage walk's order.
// The s32 dots restart with each block; each product and sum is rounded on
// its own: c = 16 q is exact in f32 and s / 16 is exact, so c (s / 16)
// rounds as q s does.
//
// K12: grid (token tiles, column tiles x R), a thread-block cluster of R
// in {1, 2, 4, 8, 16} CTAs along y (16 is a non-portable cluster size; the
// Python wrapper picks R and the held slots: _combine_plan, which keeps a
// CTA within 75 KB so that three fit an SM and 16 clusters of 16 run in
// one wave: on the card both the cluster count and the CTAs an SM set the
// speed, since a unit costs ~1,900 cycles of issue at three CTAs an SM and
// the waits on the ring are 3-21% of the loop). Every CTA reads
// gscale's rows of its token tile, marks an expert used if any of them is
// non-zero, and builds the ordered list of used experts in shared memory
// (a ballot and a prefix sum a pass of 64 experts): nothing is read back to
// the host. Rank r takes list entries r, r + R, r + 2R, ... in order. For
// each it computes the expert's product, then the gated term p_e =
// acc_e * gscale[e, m], rounded. R = 1: out = out + p_e in shared memory
// (each thread its own elements), in list order. R > 1: the rank holds p_e
// in shared memory; after a cluster
// barrier the rank that owns each column slice replays out = out + p_e
// over the list in list order (expert order), reading each term from the
// rank that holds it over distributed shared memory (ld.shared::cluster),
// eight terms' loads in flight; a second barrier keeps every CTA's terms
// alive until all are read. Where a rank's terms would not fit its slots,
// the list runs in rounds of R x slots consecutive entries, each with its
// barriers and replay, the order unchanged. One launch, no scratch tensor,
// no atomics.
//
// Why skipping unused experts is the plain version bit for bit
// (grouped_w4a8_combine_gemm_plain adds every expert's term): a skipped
// term is acc * (+-0) = +-0, since acc is finite; out starts at +0, and
// under round-to-nearest a sum of finite terms is never -0 (x + y is -0
// only if both are -0); and x + (+-0) = x for every x that is not -0. So
// dropping those additions changes no bit, -0.0 entries of gscale included.
// The used experts' terms are summed in the plain version's order.
//
// K11: no gates and no sum over experts: one CTA of 128 columns per (token
// tile, expert, column tile), grid (token tiles, column tiles x E); each
// writes its f32 fragment to out[e, m, n] as it stands, the plain version
// bit for bit.
//
// Above their token tile both take grid rows of tiles (K11 32 tokens, K12
// 16), the token tiles fastest, so that the tiles that share a weight tile
// run together and read it from L2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_decode.cuh"  // cp.async groups, the shared memory limit
#include "w4a8_tile.cuh"       // K1's stage, loader and fragment builder

namespace {

namespace cg = cooperative_groups;
using w4a8_tile::BN;  // weight columns a CTA: 4 warps of 32
using w4a8_tile::KB;
using w4a8_tile::NT;
using w4a8_tile::SK;

constexpr int MAX_SMEM = 227 * 1024;
constexpr int NS = 4;           // cp.async stages
constexpr int MAX_RANKS = 16;   // a cluster's CTAs (16 is a non-portable cluster size)
constexpr int MISC = 16 + 4 * MAX_RANKS;  // the list builder's warp counts, the replay's rank table

__host__ __device__ constexpr int ring_bytes(int tok) {
  return NS * w4a8_tile::stage_bytes(tok);
}
// tokens a CTA: K11 8, 16 or 32; K12 8 or 16 (its 32-token instance's
// ~250 registers left two CTAs an SM, and clusters of 16 then ran in two
// waves: two 16-token tiles ran 32 tokens faster)
__host__ __device__ constexpr int tokens(int M, bool combine) {
  return M <= 8 ? 8 : M <= 16 || combine ? 16 : 32;
}
// straddle K: the high blocks' rounded products a thread holds until the
// straddle stage, [K2 / 128][2][NJ][4] f32 a thread (0 for aligned K)
__host__ __device__ constexpr int hold_bytes(int tok, int K2) {
  return K2 % KB ? (K2 / KB) * tok * BN * 4 : 0;
}
// K12's dynamic shared memory: the ring, the straddle hold, `slots`
// [TOK][BN] f32 (R > 1: the held gated terms; R = 1: one, the running
// sum), the list of used experts, MISC
__host__ __device__ constexpr int combine_smem(int E, int tok, int K2, int slots) {
  return ring_bytes(tok) + hold_bytes(tok, K2) + slots * tok * BN * 4 + 4 * E + MISC;
}

// The body of both kernels. kCombine: K12 (R ranks a cluster, `slots`
// held terms a rank), else K11 (R = E: blockIdx.y % R is the expert).
// kStraddle: K2 % 128 == 64.
template <int NJ, bool kStraddle, bool kCombine>
__device__ __forceinline__ void grouped_body(const int8_t* __restrict__ xq,
                                             const float* __restrict__ gscale,
                                             const uint8_t* __restrict__ w,
                                             const float* __restrict__ scale,
                                             float* __restrict__ out, int E, int M, int N, int K2,
                                             int R, int slots) {
  constexpr int TOK = 8 * NJ;
  constexpr int STAGE = w4a8_tile::stage_bytes(TOK), SLOT = TOK * BN * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* hold = reinterpret_cast<float*>(smem + NS * STAGE);  // straddle: [nfull][8 NJ][BN]
  unsigned char* held = smem + NS * STAGE + hold_bytes(TOK, K2);  // [slots][TOK][BN]
  int* list = reinterpret_cast<int*>(held + slots * SLOT);  // K12: the used experts
  int* wcount = list + E;                                     // [NT / 32]
  uint32_t* rbase = reinterpret_cast<uint32_t*>(wcount + 4);  // [R]: each rank's `held`

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, c0 = 32 * warp + 4 * g;
  const int m0 = blockIdx.x * TOK, rows = min(TOK, M - m0);
  const int rank = blockIdx.y % R, n0 = (blockIdx.y / R) * BN;
  const int K = 2 * K2, nfull = K2 / KB;
  const size_t EN = (size_t)E * N;
  const int nunits = K2 / SK;  // units of 64 packed rows, both nibbles of each

  // x rows past M stay zero: no load writes them
  for (int i = tid; i < NS * 2 * (TOK - rows) * (SK / 16); i += NT) {
    const int st = i / (2 * (TOK - rows) * (SK / 16)), r = i % (2 * (TOK - rows) * (SK / 16));
    const int h = r / ((TOK - rows) * (SK / 16)), c = r % ((TOK - rows) * (SK / 16));
    *reinterpret_cast<uint4*>(smem + st * STAGE + SK * BN + (h * TOK + rows) * SK + 16 * c) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  // the entries: K12 the experts a row of the token tile is routed to, in
  // expert order; K11 every expert
  int nused = E;
  if (kCombine) {
    nused = 0;
    for (int e0 = 0; e0 < E; e0 += NT) {
      const int e = e0 + tid;
      bool used = false;
      if (e < E)
        for (int m = 0; m < rows; ++m) used |= gscale[(size_t)e * M + m0 + m] != 0.f;
      const unsigned b = __ballot_sync(0xffffffffu, used);
      if (lane == 0) wcount[warp] = __popc(b);
      __syncthreads();
      int before = 0, all = 0;
#pragma unroll
      for (int q = 0; q < NT / 32; ++q) {
        before += q < warp ? wcount[q] : 0;
        all += wcount[q];
      }
      if (used) list[nused + before + __popc(b & ((1u << lane) - 1u))] = e;
      nused += all;
      __syncthreads();
    }
  }
  const bool split = kCombine && R > 1;
  // this rank's entries: list[rank + R s], s < ns
  const int ns = nused > rank ? (nused - rank + R - 1) / R : 0;
  const int total = ns * nunits;
  const int nrounds = split ? max((nused + R * slots - 1) / (R * slots), 1) : 1;
  auto expert = [&](int s) { return kCombine ? list[rank + R * s] : rank + R * s; };

  // unit u of an expert: packed rows [64 u, 64 u + 64), x columns 64 u (low
  // nibbles) and K2 + 64 u (high), and the scale rows of the stages it
  // ends: aligned, u odd, block u / 2's two rows; straddle, the low
  // block's row u / 2 (u odd) or the straddle row nfull (u = 2 nfull), and
  // the high block's row nfull + u / 2 (u even, u >= 2). The load cursor:
  // unit lu of entry ls (expert le) goes into ring slot lst next.
  const w4a8_tile::StageLoader<TOK> loader(tid, (int)EN, BN / 16, K, K2, rows);
  int ls = 0, lu = 0, lst = 0, le = ns > 0 ? expert(0) : 0;
  auto load_next = [&]() {
    const float* sc = scale + (size_t)le * N + n0;
    int rlo = lu >> 1, rhi = nfull + (lu >> 1), srows = (lu & 1) ? 3 : 0;
    if (kStraddle) {
      rlo = (lu & 1) ? lu >> 1 : nfull;
      srows = ((lu & 1) || lu == 2 * nfull ? 1 : 0) | ((lu & 1) == 0 && lu >= 2 ? 2 : 0);
    }
    loader.issue(smem + lst * STAGE, w + (size_t)SK * lu * EN + (size_t)le * N + n0,
                 xq + ((size_t)le * M + m0) * K + SK * lu, sc + (size_t)rlo * EN,
                 sc + (size_t)rhi * EN, srows);
    lst = lst + 1 == NS ? 0 : lst + 1;
    if (++lu == nunits) {
      lu = 0;
      if (++ls < ns) le = expert(ls);
    }
  };
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < total) load_next();
    cluster_decode::cp_async_commit();
  }
  if (split && tid < R) rbase[tid] = w4a8_tile::cluster_addr(held, tid);

  // the halves whose stage ends with unit u (bit h): aligned, both at odd
  // u; straddle, the low half at odd u and at u = 2 nfull, the high half at
  // even u (u = 0: the high head)
  auto ends = [&](int u) {
    if (!kStraddle) return (u & 1) ? 3 : 0;
    return ((u & 1) || u == 2 * nfull ? 1 : 0) | ((u & 1) == 0 ? 2 : 0);
  };
  int d[2][2][NJ][4], head[2][NJ][4];  // head: straddle, the high head's dots
  float acc[2][NJ][4], gs[NJ][2], psc[2][4];  // psc: a stage's scale rows / 16
  float rr[TOK];  // R > 1: the replayed sums of this thread's items of the rank's slice
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
#pragma unroll
  for (int q = 0; q < TOK; ++q) rr[q] = 0.f;
  // K12 at R = 1: the running sum out = out + p_e in held slot 0, each
  // thread's own elements, from +0
  float* runs = reinterpret_cast<float*>(held) + c0;
  if (kCombine && !split) {
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        *reinterpret_cast<float4*>(runs + (8 * n + 2 * t + p) * BN) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int cols = BN / R, items = rows * cols;

  // the stage updates unit pu (of entry ps, expert pe) ends, with its
  // scales psc (c (s / 16) for q s)
  auto finish = [&](int pu, int ps, int pe, int k) {
    if (!kStraddle) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][n][e] = __fadd_rn(
                __fadd_rn(acc[i][n][e], __fmul_rn((float)d[i][0][n][e], psc[0][2 * i + (e >> 1)])),
                __fmul_rn((float)d[i][1][n][e], psc[1][2 * i + (e >> 1)]));
    } else {
      // the low blocks' updates in order as they end (u odd); the high
      // head's dots kept (u = 0); each high block's product rounded and
      // held as it ends (u even, u >= 2); at u = 2 nfull the straddle
      // stage (low tail plus high head), then the held high blocks in order
      if (pu == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) head[i][n][e] = d[i][1][n][e];
      }
      if (pu & 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][n][e] = __fadd_rn(
                  acc[i][n][e], __fmul_rn((float)d[i][0][n][e], psc[0][2 * i + (e >> 1)]));
      } else if (pu >= 2) {
        float* hb = hold + ((pu - 2) >> 1) * 8 * NJ * BN + tid;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              hb[((i * NJ + n) * 4 + e) * BN] =
                  __fmul_rn((float)d[i][1][n][e], psc[1][2 * i + (e >> 1)]);
      }
      if (pu == 2 * nfull) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][n][e] = __fadd_rn(acc[i][n][e],
                                       __fmul_rn((float)(d[i][0][n][e] + head[i][n][e]),
                                                 psc[0][2 * i + (e >> 1)]));
        for (int b = 0; b < nfull; ++b) {
          const float* hb = hold + b * 8 * NJ * BN + tid;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int n = 0; n < NJ; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[i][n][e] = __fadd_rn(acc[i][n][e], hb[((i * NJ + n) * 4 + e) * BN]);
        }
      }
    }
    if (pu != nunits - 1) return;
    // the expert's product is done
    if (!kCombine) {
      float* oe = out + ((size_t)pe * M + m0) * N + n0 + c0;
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (8 * n + 2 * t + p < rows)
            *reinterpret_cast<float4*>(oe + (size_t)(8 * n + 2 * t + p) * N) =
                make_float4(acc[0][n][p], acc[0][n][p + 2], acc[1][n][p], acc[1][n][p + 2]);
    } else {
      float pt[2][NJ][4];  // the gated term acc_e * gscale[e, m], rounded
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pt[i][n][e] = __fmul_rn(acc[i][n][e], gs[n][e & 1]);
      float* hp = split ? reinterpret_cast<float*>(held + (ps - k * slots) * SLOT) + c0 : runs;
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float4* q = reinterpret_cast<float4*>(hp + (8 * n + 2 * t + p) * BN);
          float4 v = make_float4(pt[0][n][p], pt[0][n][p + 2], pt[1][n][p], pt[1][n][p + 2]);
          if (!split) {
            const float4 o = *q;
            v = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y), __fadd_rn(o.z, v.z),
                            __fadd_rn(o.w, v.w));
          }
          *q = v;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  };

  // the compute cursor: unit U is unit u of entry s (expert ce), in ring slot cst
  int U = 0, s = 0, u = 0, cst = 0, ce = 0;
  for (int k = 0; k < nrounds; ++k) {
    const int uend = (split ? min((k + 1) * slots, ns) : ns) * nunits;
    for (; U < uend;
         ++U, cst = cst + 1 == NS ? 0 : cst + 1, u = u + 1 == nunits ? 0 : u + 1, s += u == 0) {
      cluster_decode::cp_async_wait<NS - 2>();
      // unit U landed for every thread; every warp is done with the slot before cst
      __syncthreads();
      if (U + NS - 1 < total) load_next();
      cluster_decode::cp_async_commit();
      // the s32 dots restart with each stage: a low half's at even units, a
      // high half's (straddle) at odd ones and at u = 0
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if ((h == 0 || !kStraddle) ? (u & 1) == 0 : (u & 1) == 1 || u == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int n = 0; n < NJ; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) d[i][h][n][e] = 0;
        }
      if (u == 0) {
        ce = expert(s);
        if (kCombine) {  // the expert's gates, read while its units stream
#pragma unroll
          for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              const int tok = 8 * n + 2 * t + p;
              gs[n][p] = tok < rows ? gscale[(size_t)ce * M + m0 + tok] : 0.f;
            }
        }
      }
      const unsigned char* sp = smem + cst * STAGE;
      w4a8_tile::stage_dots<NJ>(sp, c0, g, t, d);
      if (ends(u) == 0) continue;
      const float* ss = reinterpret_cast<const float*>(sp + SK * BN + 2 * TOK * SK);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(ss + h * BN + c0);
        psc[h][0] = v.x * 0.0625f;
        psc[h][1] = v.y * 0.0625f;
        psc[h][2] = v.z * 0.0625f;
        psc[h][3] = v.w * 0.0625f;
      }
      finish(u, s, ce, k);
    }
    if (split) {
      // the round's replay: rank r owns columns [r BN / R, (r + 1) BN / R);
      // entry i's term lies in rank i % R, slot i / R - k slots
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      const int ib = k * R * slots, ie = min(ib + R * slots, nused);
#pragma unroll
      for (int q = 0; q < TOK; ++q) {
        const int it = tid + q * NT;
        if (it >= items) continue;
        const uint32_t off = ((it / cols) * BN + rank * cols + it % cols) * 4;
        float a = rr[q];
        for (int i0 = ib; i0 < ie; i0 += 8) {
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int i = min(i0 + j, ie - 1);
            v[j] = w4a8_tile::ld_cluster(rbase[i % R] + (i / R - k * slots) * SLOT + off);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (i0 + j < ie) a = __fadd_rn(a, v[j]);
        }
        rr[q] = a;
      }
      cluster.sync();
    }
  }
  if constexpr (kCombine) {
    if (!split) {
      float* o = out + (size_t)m0 * N + n0 + c0;
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (8 * n + 2 * t + p < rows)
            *reinterpret_cast<float4*>(o + (size_t)(8 * n + 2 * t + p) * N) =
                *reinterpret_cast<const float4*>(runs + (8 * n + 2 * t + p) * BN);
      return;
    }
#pragma unroll
    for (int q = 0; q < TOK; ++q) {
      const int it = tid + q * NT;
      if (it < items) out[(size_t)(m0 + it / cols) * N + n0 + rank * cols + it % cols] = rr[q];
    }
  }
}

// K12 and K11 under names of their own (the profile windows count them apart)
template <int NJ, bool kStraddle>
__global__ void __launch_bounds__(BN)
grouped_w4a8_combine_kernel(const int8_t* __restrict__ xq, const float* __restrict__ gscale,
                            const uint8_t* __restrict__ w, const float* __restrict__ scale,
                            float* __restrict__ out, int E, int M, int N, int K2, int R,
                            int slots) {
  grouped_body<NJ, kStraddle, true>(xq, gscale, w, scale, out, E, M, N, K2, R, slots);
}
template <int NJ, bool kStraddle>
__global__ void __launch_bounds__(BN)
grouped_w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ gscale,
                    const uint8_t* __restrict__ w, const float* __restrict__ scale,
                    float* __restrict__ out, int E, int M, int N, int K2, int R, int slots) {
  grouped_body<NJ, kStraddle, false>(xq, gscale, w, scale, out, E, M, N, K2, R, slots);
}

template <int NJ, bool kStraddle, bool kCombine>
int launch(const int8_t* xq, const float* gscale, const uint8_t* w, const float* sc, float* out,
           int E, int M, int N, int K2, int R, int slots, int smem, cudaStream_t s) {
  auto kernel = grouped_w4a8_kernel<NJ, kStraddle>;
  if constexpr (kCombine) kernel = grouped_w4a8_combine_kernel<NJ, kStraddle>;
  static unsigned done = 0;  // devices whose shared memory limit is raised
  const int err = cluster_decode::allow_smem(kernel, MAX_SMEM, done);
  if (err != 0) return err;
  if (kCombine && R > 8) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + 8 * NJ - 1) / (8 * NJ), N / BN * R, 1);
  cfg.blockDim = dim3(BN, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = kCombine ? R : 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, xq, gscale, w, sc, out, E, M, N, K2, R, slots);
}

// the instance for the token tile (M) and the straddle layout (K2)
template <bool kCombine>
int dispatch(const int8_t* xq, const float* gscale, const uint8_t* w, const float* sc,
             float* out, int E, int M, int N, int K2, int R, int slots, int smem,
             cudaStream_t s) {
  const bool straddle = K2 % KB != 0;
  const int tok = tokens(M, kCombine);
#define W4A8_GROUPED(NJ, ST)                                                                  \
  if constexpr (!kCombine || NJ < 4)                                                          \
    if (tok == 8 * NJ && straddle == ST)                                                      \
      return launch<NJ, ST, kCombine>(xq, gscale, w, sc, out, E, M, N, K2, R, slots, smem, s);
  W4A8_GROUPED(1, false)
  W4A8_GROUPED(2, false)
  W4A8_GROUPED(4, false)
  W4A8_GROUPED(1, true)
  W4A8_GROUPED(2, true)
  W4A8_GROUPED(4, true)
#undef W4A8_GROUPED
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K12: xq int8 [E, M, 2*K2]; gscale f32 [E, M]; packed uint8 [K2, E*N];
// scale f32 [2*K2/128, E*N]; out f32 [M, N]. Needs K2 % 64 == 0 (K2 % 128
// == 64 is the straddle layout), N % 128 == 0 and 16-byte aligned xq,
// packed and scale (checked by the Python wrapper). R: the cluster size (1,
// 2, 4, 8 or 16, at most E); slots: the gated terms a rank holds per round
// (R > 1), within the shared memory (the wrapper's _combine_plan).
extern "C" int grouped_w4a8_combine_gemm(const void* xq, const void* gscale, const void* packed,
                                         const void* scale, void* out, int E, int M, int N,
                                         int K2, int R, int slots, void* stream) {
  if (M <= 0 || E <= 0 || N <= 0) return 0;
  if (R < 1 || R > MAX_RANKS || (R & (R - 1)) != 0 || (R > 1 && (slots < 1 || R > E)) ||
      N % BN != 0 || K2 % SK != 0 || K2 <= 0)
    return (int)cudaErrorInvalidValue;
  if (R == 1) slots = 1;  // the running sum
  const int smem = combine_smem(E, tokens(M, true), K2, slots);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  return dispatch<true>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(gscale),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
      static_cast<float*>(out), E, M, N, K2, R, slots, smem,
      static_cast<cudaStream_t>(stream));
}

// K12's dynamic shared memory at (E, M, K2, R, slots), or -1 where it passes a
// CTA's limit (the launch refuses it). The wrapper's _combine_plan counts
// the same bytes (quant_gemm._combine_smem); chip_smoke.py holds the two
// equal.
extern "C" int grouped_w4a8_combine_smem(int E, int M, int K2, int R, int slots) {
  const int b = combine_smem(E, tokens(M, true), K2, R > 1 ? slots : 1);
  return b > MAX_SMEM ? -1 : b;
}

// K11: xq int8 [E, M, 2*K2]; packed uint8 [K2, E*N]; scale f32 [2*K2/128, E*N];
// out f32 [E, M, N], out[e] = xq[e] @ W_e with no gates and no activation
// scale. Needs K2 % 64 == 0, N % 128 == 0 and 16-byte aligned xq, packed
// and scale (checked by the Python wrapper).
extern "C" int grouped_w4a8_gemm(const void* xq, const void* packed, const void* scale,
                                 void* out, int E, int M, int N, int K2, void* stream) {
  if (E * M * N == 0) return 0;
  if (N % BN != 0 || K2 % SK != 0 || K2 <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<false>(static_cast<const int8_t*>(xq), nullptr,
                                  static_cast<const uint8_t*>(packed),
                                  static_cast<const float*>(scale), static_cast<float*>(out), E,
                                  M, N, K2, E, 0,
                                  ring_bytes(tokens(M, false)) + hold_bytes(tokens(M, false), K2),
                                  static_cast<cudaStream_t>(stream));
}
