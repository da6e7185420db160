// Read-only decode attention for Hopper (sm_90a): attend G query rows of one
// KV head over keys [0, lengths[b]) of a cache that is already written.
//
// Replaces: modelopt_tpu/kernels/attention.py::decode_attention
// (Pallas bodies _decode_attn_kernel, _attend_chunk and _finalize_out), and
// through the second entry point paged_decode_attention (K15),
// modelopt_tpu/kernels/paged_attention.py::paged_decode_attention (Pallas
// body _paged_attn_kernel: _attend_chunk over one page per grid step). The
// paged form (kernel paged_attention_kernel, the same body) walks the slot's
// keys in chunks of one page and takes each chunk's rows from the pool page
// its table names; nothing else differs,
// so the page walk rounds the 7-bit codes exactly where the reference's
// page-per-step grid does.
// The third entry point, block_sparse_decode_attention (K17), replaces
// modelopt_tpu/kernels/block_sparse_attention.py::block_sparse_decode_attention
// (Pallas body _bs_attn_kernel: _attend_chunk over one selected KV block per
// grid step). Its kernel block_sparse_attention_kernel runs the same body
// over the first nvalid[b] blocks that sel[b, :] names, in that order, one
// block per chunk at cache rows b * S + sel[b, p] * block_size; keys of a
// block at or past lengths[b] score -1e30, as in the reference, so even a
// block that holds no live key rounds its codes as the Pallas kernel does.
// MLA decode (models/mla.py) calls it with KH = 1, G = the query heads,
// D = the latent row padded to 128 lanes (640 for DeepSeek-V2-Lite) and the
// same latent tensor as K and V.
//
// Numerics follow _attend_chunk exactly, per (head, group) row:
//  * keys are taken in chunks of 256 when S % 256 == 0, else as ONE chunk of
//    S (paged: one page per chunk); the running max, and with it the int8
//    probability codes, are taken per chunk, so the chunk rule changes the
//    result and is kept;
//  * int8 caches: q is rounded to bf16, then requantized per row to int8
//    with qmax = max|q_row| over the head's D lanes; scores are exact
//    s8 x s8 -> s32 dots scaled by qmax * k_scale / (127 sqrt(D));
//    probabilities become 7-bit codes e8 = round(exp(s - m) * 127) against
//    the running max m, and numerator (e8 x v8 -> s32, exact) and
//    denominator (sum of e8) use the same codes; the f32 updates
//    l = l*alpha + esum and acc = acc*alpha + y are rounded op by op in the
//    plain version's order;
//  * bf16 caches: bf16 q x k with f32 sums, exp in f32, PV with the
//    probabilities rounded to bf16, the denominator from the f32 values
//    (sums in another order than the plain version); e4m3 caches the same
//    (all three entries), the codes decoded exactly by the reference's bit
//    assembly (e4m3.cuh), k_scale in the score scale and v_scale on the
//    output, as for int8;
//  * keys at or past lengths[b] carry -1e30 in the reference (exp gives 0):
//    dense and paged, they are not visited (a length past the cache is
//    clamped to S); block-sparse, they score -1e30 here too;
//  * out = acc * (v_scale / max(l, 1e-30)).
// Only the order of exact integer sums differs from the plain version, so
// on int8 caches the two differ only where expf rounds a code e8 across .5.
//
// What bounds it on an H100: bytes, the live cache rows (lengths[b] * KH * D
// codes, one byte each for int8 and e4m3; K and V once each, or once when
// they are one tensor) over the
// 3.35 TB/s of HBM; paged, the same rows wherever their pages lie;
// block-sparse, the rows of the selected blocks only.
//
// Design of the one-CTA body (K5 and K15 off both cluster geometries below,
// e.g. a bf16 latent cache; K17 off its own): the reference's arithmetic is
// independent per (head, group) row, so the grid is (slot, KV head, pair of
// rows): B * KH * G/2 CTAs of 256 threads, each reading the slot's live
// rows; the CTAs of one slot meet the same rows in L2. Each CTA walks all keys of its slot. Per chunk: each
// warp scores one key at a time (a lane takes 4 columns of each 128, the
// row is one coalesced read, a warp shuffle sums it) into shared memory; a
// block reduction gives the chunk max; threads turn scores into codes;
// then each warp accumulates e8 x v over its share of the keys for all D
// columns in registers and the eight warps' integer partials are summed in
// shared memory into the running f32 output.
//
// K15 at paths E's and L's geometry and K17 at path J's (D = 128, G in
// {1, 2, 4, 8}, pages or blocks of 8 to 512 rows) run the cluster kernels
// of cluster_decode.cuh instead, one body with two maps from page to cache
// rows: one cluster of 8 CTAs per (slot, KV head) splits the slot's pages
// (K17: its selected blocks, in sel order, each whole with its keys past
// the length at -1e30). A code depends only on its score and its page's
// running max m_p = max(m_{p-1}, max_p), and a max is the same in any
// order: each CTA scores a contiguous run of pages and takes each page's
// max, the cluster exchanges the page maxima over distributed shared
// memory, each CTA rounds its codes against its pages' running maxima and
// forms each page's partials (int8: s32, exact), and each rank replays the
// f32 recurrence over all pages in order for its 16 columns. So an int8
// output is the same arithmetic on the same integers as one CTA that walks
// every page.
//
// K5, and K15 off the D = 128 cluster geometry, at MLA's geometry (KH = 1,
// G <= 16, D a multiple of 128 up to 640, an int8 or e4m3 cache given as
// both K and V, chunks of at most 2176 keys: the decode steps of paths D
// and F (int8) and N and O (e4m3)) run
// latent_decode.cuh's tensor-core cluster kernel instead (latent_ok): one
// cluster of 16 CTAs a slot that splits the slot's latent rows into pieces
// of at most 68 keys inside chunk boundaries, each CTA staging its rows once
// for both the scores and PV. The argument is K15's: a code depends only on
// its score and its chunk's running max, and a max is the same in any
// order, so once the ranks agree on every chunk's running max (exchanged
// over distributed shared memory) before any code is rounded, each rank's
// codes are those of one CTA walking every key; integer partials sum
// exactly in any order, so the owner of each column slice sums a chunk's
// partials over the ranks that hold it and replays the f32 recurrence
// chunk by chunk in order, as the body here does. An int8 output is the
// same arithmetic on the same integers, bit for bit this body's; an e4m3
// output is the same arithmetic with its f32 sums in another order (the
// bf16 rounding of each probability against its chunk's running max is
// the reference's). With one piece in the slot (the short contexts), rank
// 0 alone runs it. Every other geometry (bf16 at D = 640, K and V two
// buffers, the MHA decodes K2 turns away, K17 off its cluster geometry)
// keeps the one-CTA body.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "cluster_decode.cuh"
#include "e4m3.cuh"
#include "latent_decode.cuh"

namespace {

constexpr int NT = 256;      // threads per CTA
constexpr int NW = NT / 32;  // warps per CTA
constexpr unsigned FULL = 0xffffffffu;

template <int GB>
__device__ __forceinline__ void block_max(float (&v)[GB], float (*red)[NW]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[g] = fmaxf(v[g], __shfl_xor_sync(FULL, v[g], off));
    if (lane == 0) red[g][warp] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float r = red[g][0];
#pragma unroll
    for (int w = 1; w < NW; ++w) r = fmaxf(r, red[g][w]);
    v[g] = r;
  }
  __syncthreads();
}

template <int GB, typename V>
__device__ __forceinline__ void block_sum(V (&v)[GB], V (*red)[NW]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[g] += __shfl_xor_sync(FULL, v[g], off);
    if (lane == 0) red[g][warp] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    V r = red[g][0];
#pragma unroll
    for (int w = 1; w < NW; ++w) r += red[g][w];
    v[g] = r;
  }
  __syncthreads();
}

// byte c of a word, sign-extended
__device__ __forceinline__ int sbyte(int w, int c) { return (w << (24 - 8 * c)) >> 24; }

// columns 4 * idx .. 4 * idx + 3 of a bf16 or e4m3 cache row, as f32
template <typename CT>
__device__ __forceinline__ void load4(const CT* row, int idx, float (&f)[4]) {
  if constexpr (std::is_same<CT, e4m3_t>::value) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(row)[idx];
#pragma unroll
    for (int c = 0; c < 4; ++c) f[c] = e4m3_to_f32((w >> (8 * c)) & 0xFFu);
  } else {
    const uint2 u = reinterpret_cast<const uint2*>(row)[idx];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int c = 0; c < 4; ++c) f[c] = __bfloat162float(e[c]);
  }
}

// The body of the three kernels; page_table and sel null: dense cache rows.
template <typename CT, int GB, int DJ>
__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ q,
                                       const CT* __restrict__ kc, const CT* __restrict__ vc,
                                       const int* __restrict__ lengths,
                                       const float* __restrict__ kscale,
                                       const float* __restrict__ vscale,
                                       float* __restrict__ out_f32,
                                       __nv_bfloat16* __restrict__ out_bf16,
                                       const int* __restrict__ page_table,
                                       const int* __restrict__ sel,
                                       const int* __restrict__ nvalid, int nsel, int S, int KH,
                                       int G, int chunk) {
  constexpr bool kInt8 = std::is_same<CT, int8_t>::value;
  constexpr int D = 128 * DJ;
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;                     // [GB][chunk] scores, then e / e8 codes
  float* red = sc + ((GB * chunk + 3) & ~3);  // [NW][GB][D] per-warp PV partials
  float* acc_s = red + NW * GB * D;     // [GB][D] running output
  float* sq = acc_s + GB * D;           // [GB][D] q rows (bf16 values)
  int* q8w = reinterpret_cast<int*>(sq + GB * D);  // [GB][D/4] int8 q codes
  int* e8 = reinterpret_cast<int*>(sc);
  int* redi = reinterpret_cast<int*>(red);
  __shared__ float rf[GB][NW];
  __shared__ int ri[GB][NW];

  const int ngrp = G / GB;
  const int bh = blockIdx.x / ngrp;  // b * KH + h
  const int b = bh / KH, h = bh % KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KHD = KH * D;
  const int L = sel != nullptr ? lengths[b] : min(lengths[b], S);
  const float ks = kscale != nullptr ? *kscale : 1.f;
  const float vs = vscale != nullptr ? *vscale : 1.f;
  const float inv_sqrt_d = __fdiv_rn(ks, sqrtf((float)D));
  const size_t qoff = ((size_t)bh * G + (blockIdx.x % ngrp) * GB) * D;

  for (int i = tid; i < GB * D; i += NT) {
    sq[i] = __bfloat162float(q[qoff + i]);
    acc_s[i] = 0.f;
  }
  __syncthreads();
  float fs[GB] = {};
  if constexpr (kInt8) {
    float a[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      a[g] = 0.f;
      for (int i = tid; i < D; i += NT) a[g] = fmaxf(a[g], fabsf(sq[g * D + i]));
    }
    block_max<GB>(a, rf);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float qmax = fmaxf(a[g], 1e-30f);
      const float r = __fdiv_rn(127.f, qmax);
      int8_t* q8 = reinterpret_cast<int8_t*>(q8w + g * (D / 4));
      for (int i = tid; i < D; i += NT) q8[i] = (int8_t)(int)rintf(__fmul_rn(sq[g * D + i], r));
      fs[g] = __fmul_rn(qmax, __fdiv_rn(inv_sqrt_d, 127.f));
    }
    __syncthreads();
  }
  // a lane's columns: 4 * (lane + 32 j) .. +3 for j < DJ
  int qw[GB][DJ];
  float qf[GB][DJ][4];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      if constexpr (kInt8) {
        qw[g][j] = q8w[g * (D / 4) + lane + 32 * j];
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) qf[g][j][c] = sq[g * D + 4 * (lane + 32 * j) + c];
      }
    }

  float m_run[GB], l_run[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m_run[g] = -1e30f;
    l_run[g] = 0.f;
  }
  const CT* kh = kc + (size_t)h * D;
  const CT* vh = vc + (size_t)h * D;

  // dense and paged: the chunks holding keys [0, L) in order; block-sparse:
  // the first nvalid[b] blocks of sel[b, :], each whole, keys >= L masked
  const int nchunks = sel != nullptr ? min(nvalid[b], nsel) : (L + chunk - 1) / chunk;
  for (int it = 0; it < nchunks; ++it) {
    const int base = sel != nullptr ? sel[(size_t)b * nsel + it] * chunk : it * chunk;
    const int nk = sel != nullptr ? chunk : min(chunk, L - base);
    const int lim = L - base;  // keys kk >= lim lie at or past L
    // the chunk's first cache row: dense and block-sparse, row base of slot
    // b; paged (chunk = page), row 0 of the pool page the slot's table names
    const size_t row0 = page_table != nullptr
                            ? (size_t)page_table[(size_t)b * (S / chunk) + base / chunk] * chunk
                            : (size_t)b * S + base;
    const CT* kbase = kh + row0 * KHD;
    const CT* vbase = vh + row0 * KHD;
    // scores: one key per warp at a time
#pragma unroll 2
    for (int kk = warp; kk < nk; kk += NW) {
      if (kk >= lim) {  // block-sparse only: a masked key
        if (lane == 0) {
#pragma unroll
          for (int g = 0; g < GB; ++g) sc[g * chunk + kk] = -1e30f;
        }
        continue;
      }
      const CT* krow = kbase + (size_t)kk * KHD;
      if constexpr (kInt8) {
        const int* kw = reinterpret_cast<const int*>(krow);
        int w[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) w[j] = kw[lane + 32 * j];
        int d[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          d[g] = 0;
#pragma unroll
          for (int j = 0; j < DJ; ++j) d[g] = __dp4a(w[j], qw[g][j], d[g]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) d[g] += __shfl_xor_sync(FULL, d[g], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int g = 0; g < GB; ++g) sc[g * chunk + kk] = __fmul_rn((float)d[g], fs[g]);
        }
      } else {
        float d[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) d[g] = 0.f;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          float kf[4];
          load4(krow, lane + 32 * j, kf);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
#pragma unroll
            for (int g = 0; g < GB; ++g) d[g] = fmaf(qf[g][j][c], kf[c], d[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) d[g] += __shfl_xor_sync(FULL, d[g], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int g = 0; g < GB; ++g) sc[g * chunk + kk] = __fmul_rn(d[g], inv_sqrt_d);
        }
      }
    }
    __syncthreads();

    float mc[GB], alpha[GB], esum[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      mc[g] = -1e30f;
      for (int kk = tid; kk < nk; kk += NT) mc[g] = fmaxf(mc[g], sc[g * chunk + kk]);
    }
    block_max<GB>(mc, rf);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      mc[g] = fmaxf(m_run[g], mc[g]);
      alpha[g] = expf(__fsub_rn(m_run[g], mc[g]));
    }

    if constexpr (kInt8) {
      int is[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        is[g] = 0;
        for (int kk = tid; kk < nk; kk += NT) {
          const float e = expf(__fsub_rn(sc[g * chunk + kk], mc[g]));
          const int code = (int)rintf(__fmul_rn(e, 127.f));
          e8[g * chunk + kk] = code;
          is[g] += code;
        }
      }
      block_sum<GB, int>(is, ri);
#pragma unroll
      for (int g = 0; g < GB; ++g) esum[g] = __fmul_rn((float)is[g], 1.f / 127.f);
      // e8 x v over this warp's keys, all columns of the lane
      int a[GB][DJ][4];
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int j = 0; j < DJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) a[g][j][c] = 0;
#pragma unroll 2
      for (int kk = warp; kk < nk; kk += NW) {
        const int* vw = reinterpret_cast<const int*>(vbase + (size_t)kk * KHD);
        int w[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) w[j] = vw[lane + 32 * j];
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const int ev = e8[g * chunk + kk];
#pragma unroll
          for (int j = 0; j < DJ; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) a[g][j][c] += ev * sbyte(w[j], c);
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          *reinterpret_cast<int4*>(&redi[(warp * GB + g) * D + 4 * (lane + 32 * j)]) =
              make_int4(a[g][j][0], a[g][j][1], a[g][j][2], a[g][j][3]);
      __syncthreads();
#pragma unroll
      for (int g = 0; g < GB; ++g)
        for (int col = tid; col < D; col += NT) {
          int t = 0;
#pragma unroll
          for (int w = 0; w < NW; ++w) t += redi[(w * GB + g) * D + col];
          const float y = __fmul_rn((float)t, 1.f / 127.f);
          acc_s[g * D + col] = __fadd_rn(__fmul_rn(acc_s[g * D + col], alpha[g]), y);
        }
    } else {
      float fsum[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        fsum[g] = 0.f;
        for (int kk = tid; kk < nk; kk += NT) {
          const float e = expf(__fsub_rn(sc[g * chunk + kk], mc[g]));
          sc[g * chunk + kk] = e;
          fsum[g] += e;
        }
      }
      block_sum<GB, float>(fsum, rf);
#pragma unroll
      for (int g = 0; g < GB; ++g) esum[g] = fsum[g];
      float a[GB][DJ][4];
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int j = 0; j < DJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) a[g][j][c] = 0.f;
#pragma unroll 2
      for (int kk = warp; kk < nk; kk += NW) {
        const CT* vrow = vbase + (size_t)kk * KHD;
        float ev[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g)
          ev[g] = __bfloat162float(__float2bfloat16(sc[g * chunk + kk]));
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          float vf[4];
          load4(vrow, lane + 32 * j, vf);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
#pragma unroll
            for (int g = 0; g < GB; ++g) a[g][j][c] = fmaf(ev[g], vf[c], a[g][j][c]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          *reinterpret_cast<float4*>(&red[(warp * GB + g) * D + 4 * (lane + 32 * j)]) =
              make_float4(a[g][j][0], a[g][j][1], a[g][j][2], a[g][j][3]);
      __syncthreads();
#pragma unroll
      for (int g = 0; g < GB; ++g)
        for (int col = tid; col < D; col += NT) {
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < NW; ++w) t += red[(w * GB + g) * D + col];
          acc_s[g * D + col] = __fadd_rn(__fmul_rn(acc_s[g * D + col], alpha[g]), t);
        }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      l_run[g] = __fadd_rn(__fmul_rn(l_run[g], alpha[g]), esum[g]);
      m_run[g] = mc[g];
    }
    __syncthreads();  // the next chunk reuses sc and red
  }

#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const float r = __fdiv_rn(vs, fmaxf(l_run[g], 1e-30f));
    for (int col = tid; col < D; col += NT) {
      const float o = __fmul_rn(acc_s[g * D + col], r);
      if (out_bf16 != nullptr)
        out_bf16[qoff + g * D + col] = __float2bfloat16(o);
      else
        out_f32[qoff + g * D + col] = o;
    }
  }
}

// K5: rows of slot b at b * S
template <typename CT, int GB, int DJ>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const CT* __restrict__ kc,
                        const CT* __restrict__ vc, const int* __restrict__ lengths,
                        const float* __restrict__ kscale, const float* __restrict__ vscale,
                        float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16,
                        int S, int KH, int G, int chunk) {
  attend<CT, GB, DJ>(q, kc, vc, lengths, kscale, vscale, out_f32, out_bf16, nullptr, nullptr,
                     nullptr, 0, S, KH, G, chunk);
}

// K15: rows of slot b in the pool pages page_table[b, :] names, chunk = page
template <typename CT, int GB, int DJ>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q, const CT* __restrict__ kc,
                       const CT* __restrict__ vc, const int* __restrict__ lengths,
                       const float* __restrict__ kscale, const float* __restrict__ vscale,
                       float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16,
                       const int* __restrict__ page_table, int S, int KH, int G,
                       int page_size) {
  attend<CT, GB, DJ>(q, kc, vc, lengths, kscale, vscale, out_f32, out_bf16, page_table, nullptr,
                     nullptr, 0, S, KH, G, page_size);
}

// K17: the nvalid[b] blocks of slot b that sel[b, :] names, chunk = block
template <typename CT, int GB, int DJ>
__global__ void __launch_bounds__(NT)
block_sparse_attention_kernel(const __nv_bfloat16* __restrict__ q, const CT* __restrict__ kc,
                              const CT* __restrict__ vc, const int* __restrict__ lengths,
                              const float* __restrict__ kscale,
                              const float* __restrict__ vscale, float* __restrict__ out_f32,
                              __nv_bfloat16* __restrict__ out_bf16,
                              const int* __restrict__ sel, const int* __restrict__ nvalid,
                              int nsel, int S, int KH, int G, int block_size) {
  attend<CT, GB, DJ>(q, kc, vc, lengths, kscale, vscale, out_f32, out_bf16, nullptr, sel,
                     nvalid, nsel, S, KH, G, block_size);
}

// one launch's operands (the kernel's pointer arguments, untyped)
struct Args {
  const void *q, *kc, *vc, *lengths, *kscale, *vscale, *page_table, *sel, *nvalid;
  void *out_f32, *out_bf16;
  int B, S, KH, G, chunk, nsel;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename CT, int GB, int DJ>
int launch(const Args& a, cudaStream_t s) {
  constexpr int D = 128 * DJ;
  const size_t smem =
      sizeof(float) * (((size_t)GB * a.chunk + 3) / 4 * 4 + (size_t)NW * GB * D + 2 * GB * D +
                       GB * D / 4);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const bool paged = a.page_table != nullptr, sparse = a.sel != nullptr;
  const cudaError_t e = paged    ? allow_smem(paged_attention_kernel<CT, GB, DJ>, smem)
                        : sparse ? allow_smem(block_sparse_attention_kernel<CT, GB, DJ>, smem)
                                 : allow_smem(decode_attention_kernel<CT, GB, DJ>, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = a.B * a.KH * (a.G / GB);
  const auto* q = static_cast<const __nv_bfloat16*>(a.q);
  const auto* kc = static_cast<const CT*>(a.kc);
  const auto* vc = static_cast<const CT*>(a.vc);
  const auto* lengths = static_cast<const int*>(a.lengths);
  const auto* ks = static_cast<const float*>(a.kscale);
  const auto* vs = static_cast<const float*>(a.vscale);
  auto* of = static_cast<float*>(a.out_f32);
  auto* ob = static_cast<__nv_bfloat16*>(a.out_bf16);
  if (paged) {
    paged_attention_kernel<CT, GB, DJ><<<grid, NT, smem, s>>>(
        q, kc, vc, lengths, ks, vs, of, ob, static_cast<const int*>(a.page_table), a.S, a.KH,
        a.G, a.chunk);
  } else {
    if (sparse)
      block_sparse_attention_kernel<CT, GB, DJ><<<grid, NT, smem, s>>>(
          q, kc, vc, lengths, ks, vs, of, ob, static_cast<const int*>(a.sel),
          static_cast<const int*>(a.nvalid), a.nsel, a.S, a.KH, a.G, a.chunk);
    else
      decode_attention_kernel<CT, GB, DJ><<<grid, NT, smem, s>>>(
          q, kc, vc, lengths, ks, vs, of, ob, a.S, a.KH, a.G, a.chunk);
  }
  return (int)cudaGetLastError();
}

template <typename CT, int GB>
int dispatch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 128: return launch<CT, GB, 1>(a, s);
    case 256: return launch<CT, GB, 2>(a, s);
    case 384: return launch<CT, GB, 3>(a, s);
    case 512: return launch<CT, GB, 4>(a, s);
    case 640: return launch<CT, GB, 5>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename CT>
int dispatch_g(int D, const Args& a, cudaStream_t s) {
  return a.G % 2 == 0 ? dispatch_d<CT, 2>(D, a, s) : dispatch_d<CT, 1>(D, a, s);
}

// cache_kind: 0 bf16, 1 int8, 2 e4m3
int dispatch(int D, int cache_kind, const Args& a, cudaStream_t s) {
  if (a.B * a.KH * a.G == 0) return 0;
  switch (cache_kind) {
    case 0: return dispatch_g<__nv_bfloat16>(D, a, s);
    case 1: return dispatch_g<int8_t>(D, a, s);
    case 2: return dispatch_g<e4m3_t>(D, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K15 and K17 at D = 128, G in {1, 2, 4, 8} and pages (blocks) of at most SB
// rows: the cluster kernels of cluster_decode.cuh, one cluster of C CTAs per
// (slot, KV head); a.sel non-null: K17's
template <typename CT, int G>
int launch_cluster(const Args& a, int pmax, cudaStream_t s) {
  namespace cd = cluster_decode;
  const int grid = a.B * a.KH * cd::C, smem = cd::paged_smem_bytes(G);
  const auto* q = static_cast<const __nv_bfloat16*>(a.q);
  const auto* kc = static_cast<const CT*>(a.kc);
  const auto* vc = static_cast<const CT*>(a.vc);
  const auto* lengths = static_cast<const int*>(a.lengths);
  const auto* ks = static_cast<const float*>(a.kscale);
  const auto* vs = static_cast<const float*>(a.vscale);
  auto* of = static_cast<float*>(a.out_f32);
  auto* ob = static_cast<__nv_bfloat16*>(a.out_bf16);
  if (a.sel != nullptr) {
    static unsigned done = 0;
    const int e = cd::allow_smem(cd::sparse_cluster_kernel<CT, G>, smem, done);
    if (e != 0) return e;
    cd::sparse_cluster_kernel<CT, G><<<grid, cd::NT, smem, s>>>(
        q, kc, vc, static_cast<const int*>(a.sel), static_cast<const int*>(a.nvalid), lengths,
        ks, vs, of, ob, a.nsel, a.S, a.chunk, a.KH);
  } else {
    static unsigned done = 0;
    const int e = cd::allow_smem(cd::paged_cluster_kernel<CT, G>, smem, done);
    if (e != 0) return e;
    cd::paged_cluster_kernel<CT, G><<<grid, cd::NT, smem, s>>>(
        q, kc, vc, static_cast<const int*>(a.page_table), lengths, ks, vs, of, ob, pmax, a.chunk,
        a.KH);
  }
  return (int)cudaGetLastError();
}

template <typename CT>
int cluster_g(const Args& a, int pmax, cudaStream_t s) {
  switch (a.G) {
    case 1: return launch_cluster<CT, 1>(a, pmax, s);
    case 2: return launch_cluster<CT, 2>(a, pmax, s);
    case 4: return launch_cluster<CT, 4>(a, pmax, s);
    default: return launch_cluster<CT, 8>(a, pmax, s);
  }
}

// whether the cluster kernels take the geometry (else the one-CTA body)
bool cluster_ok(int D, int G, int ps) {
  return D == cluster_decode::D && (G == 1 || G == 2 || G == 4 || G == 8) && ps % 8 == 0 &&
         ps <= cluster_decode::SB;
}

// whether latent_decode.cuh's cluster kernel takes the geometry (else the
// one-CTA body): int8 or e4m3, one KV head, G <= 16, K and V one buffer
// (its rows are staged once for both), D a multiple of 128 up to 640 and a
// chunk (dense: 256 keys or all of S; paged: a page) that fits one round
bool latent_ok(const Args& a, int D, int cache_kind) {
  return (cache_kind == 1 || cache_kind == 2) && a.KH == 1 && a.G <= latent::GM && D % 128 == 0 && D <= 640 &&
         a.kc == a.vc && a.sel == nullptr && a.chunk <= latent::MAX_CHUNK;
}

template <bool E4>
int launch_latent(const Args& a, int D, int pmax, cudaStream_t s) {
  const auto* q = static_cast<const __nv_bfloat16*>(a.q);
  const auto* c = static_cast<const unsigned char*>(a.kc);
  const auto* lengths = static_cast<const int*>(a.lengths);
  const auto* pt = static_cast<const int*>(a.page_table);
  const auto* ks = static_cast<const float*>(a.kscale);
  const auto* vs = static_cast<const float*>(a.vscale);
  auto* of = static_cast<float*>(a.out_f32);
  auto* ob = static_cast<__nv_bfloat16*>(a.out_bf16);
  switch (D) {
    case 128: return latent::launch<1, E4>(q, c, lengths, pt, ks, vs, of, ob, a.B, a.S, a.chunk, pmax, a.G, s);
    case 256: return latent::launch<2, E4>(q, c, lengths, pt, ks, vs, of, ob, a.B, a.S, a.chunk, pmax, a.G, s);
    case 384: return latent::launch<3, E4>(q, c, lengths, pt, ks, vs, of, ob, a.B, a.S, a.chunk, pmax, a.G, s);
    case 512: return latent::launch<4, E4>(q, c, lengths, pt, ks, vs, of, ob, a.B, a.S, a.chunk, pmax, a.G, s);
    case 640: return latent::launch<5, E4>(q, c, lengths, pt, ks, vs, of, ob, a.B, a.S, a.chunk, pmax, a.G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_latent(const Args& a, int D, int cache_kind, int pmax, cudaStream_t s) {
  return cache_kind == 2 ? launch_latent<true>(a, D, pmax, s) : launch_latent<false>(a, D, pmax, s);
}

}  // namespace

// q bf16 [B, KH, G, D]; caches [B, S, KH*D] of bf16 (cache_kind 0), int8
// (1) or e4m3 (2), 16-byte aligned (K and V may be the same buffer); lengths int32 [B];
// kscale/vscale f32 scalars on the device or null (scale 1); exactly one of
// out_f32 / out_bf16 non-null, [B, KH, G, D]. D a multiple of 128 up to 640,
// G >= 1 (checked by the Python wrapper).
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* lengths, const void* kscale, const void* vscale,
                                void* out_f32, void* out_bf16, int B, int S, int KH, int G,
                                int D, int chunk, int cache_kind, void* stream) {
  const Args a{q, kc, vc, lengths, kscale, vscale, nullptr, nullptr, nullptr, out_f32, out_bf16,
               B, S, KH, G, chunk, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * KH * G > 0 && latent_ok(a, D, cache_kind)) return launch_latent(a, D, cache_kind, 0, s);
  return dispatch(D, cache_kind, a, s);
}

// K15, paged decode attention: at D = 128, G in {1, 2, 4, 8} and pages of
// 8 to 512 rows (paths E and L) the cluster kernel; at MLA's geometry
// (latent_ok: paths F and O) latent_decode.cuh's cluster kernel, one page a
// chunk; else the same kernel as K5 with chunk = page. Pools
// [n_pages, page_size, KH*D] (bf16, int8 or e4m3: cache_kind 0, 1, 2;
// 16-byte aligned; K and V may be one buffer); page_table int32 [B, pmax] of pool page ids, every entry a
// valid page (unused ones 0); keys [0, min(lengths[b], pmax * page_size)).
// Other operands as decode_attention's.
extern "C" int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* page_table, const void* lengths,
                                      const void* kscale, const void* vscale, void* out_f32,
                                      void* out_bf16, int B, int pmax, int page_size, int KH,
                                      int G, int D, int cache_kind, void* stream) {
  const Args a{q, k_pages, v_pages, lengths, kscale, vscale, page_table, nullptr, nullptr,
               out_f32, out_bf16, B, pmax * page_size, KH, G, page_size, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * KH * G == 0) return 0;
  if (!cluster_ok(D, G, page_size))
    return latent_ok(a, D, cache_kind) ? launch_latent(a, D, cache_kind, pmax, s)
                                       : dispatch(D, cache_kind, a, s);
  switch (cache_kind) {
    case 0: return cluster_g<__nv_bfloat16>(a, pmax, s);
    case 1: return cluster_g<int8_t>(a, pmax, s);
    case 2: return cluster_g<e4m3_t>(a, pmax, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K17, block-sparse decode attention: at D = 128, G in {1, 2, 4, 8} and
// blocks of 8 to 512 rows (paths J and P) K15's cluster kernel body over the
// selected blocks, else (D up to 640, G up to 16) the one-CTA body over them.
// Caches [B, S, KH*D] as decode_attention's, S a multiple of block_size;
// sel int32 [B, nsel] block indices, each in [0, S / block_size); nvalid
// int32 [B] (entries p >= nvalid[b] are never read); keys [0, lengths[b]).
extern "C" int block_sparse_decode_attention(const void* q, const void* kc, const void* vc,
                                             const void* sel, const void* nvalid,
                                             const void* lengths, const void* kscale,
                                             const void* vscale, void* out_f32, void* out_bf16,
                                             int B, int S, int nsel, int block_size, int KH,
                                             int G, int D, int cache_kind, void* stream) {
  const Args a{q, kc, vc, lengths, kscale, vscale, nullptr, sel, nvalid,
               out_f32, out_bf16, B, S, KH, G, block_size, nsel};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * KH * G == 0 || !cluster_ok(D, G, block_size)) return dispatch(D, cache_kind, a, s);
  switch (cache_kind) {
    case 0: return cluster_g<__nv_bfloat16>(a, 0, s);
    case 1: return cluster_g<int8_t>(a, 0, s);
    case 2: return cluster_g<e4m3_t>(a, 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory of one CTA of latent_decode.cuh's cluster kernel at
// D for cache_kind 1 (int8) or 2 (e4m3) (0 for a D it does not take):
// kernels/attention.py's latent_smem must agree
template <bool E4>
int latent_smem_of(int D) {
  switch (D) {
    case 128: return latent::Geo<1, E4>::SMEM;
    case 256: return latent::Geo<2, E4>::SMEM;
    case 384: return latent::Geo<3, E4>::SMEM;
    case 512: return latent::Geo<4, E4>::SMEM;
    case 640: return latent::Geo<5, E4>::SMEM;
    default: return 0;
  }
}

extern "C" int latent_decode_smem(int D, int cache_kind) {
  return cache_kind == 2 ? latent_smem_of<true>(D) : cache_kind == 1 ? latent_smem_of<false>(D) : 0;
}

__global__ void e4m3_pair_kernel(const uint8_t* __restrict__ codes, float* __restrict__ out,
                                 int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const uint32_t v = e4m3_cache_pair((uint32_t)codes[i] << 8);  // the code in byte 1
    out[i] = __uint_as_float(v << 16);                            // the low half's bf16
  }
}

// the latent cluster kernel's e4m3 operand decode (e4m3.cuh's
// e4m3_cache_pair) applied to every code of codes [n], f32 out: a probe of
// the device function, not a kernel of the port (chip_smoke.py reads all
// 256 codes back against the reference's decode)
extern "C" int e4m3_pair_decode(const void* codes, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  e4m3_pair_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
