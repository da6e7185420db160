// Fused decode step for Hopper (sm_90a): write the new token's k/v row into
// the caches at pos[b] and attend the slot's G query rows of one KV head
// over keys [0, pos[b]] (the new token joins from registers).
//
// Replaces: modelopt_tpu/kernels/attention.py::fused_decode_attention
// (Pallas bodies _fused_decode_kernel and _attend_chunk).
//
// Numerics follow _attend_chunk exactly:
//  * keys are taken in chunks of 256 when S % 256 == 0, else as ONE chunk of
//    S; the running max, and with it the int8 probability codes, are taken
//    per chunk, so the chunk rule changes the result and is kept;
//  * int8 caches: q is rounded to bf16, then requantized per (head, group)
//    row to int8 with qmax = max|q_row|; scores are s8 x s8 -> s32 dots;
//    probabilities become 7-bit codes e8 = round(exp(s - m) * 127) and the
//    PV product is e8 x v8 -> s32 (both integer sums are exact, so their
//    order does not matter);
//  * bf16 and e4m3 caches: bf16 q x k with f32 sums, exp in f32, PV with
//    the probabilities rounded to bf16, the denominator from the f32
//    values; e4m3 codes are decoded exactly by the reference's bit assembly
//    (e4m3.cuh), k_scale rides in 1/sqrt(D) and v_scale on the output, as
//    for int8 (the reference's non-int8 branch of _attend_chunk; the 7-bit
//    probability codes are the int8 branch's alone);
//  * masked keys carry -1e30 (here they are simply not visited: their
//    exponentials are exactly 0);
//  * the new token scores in f32 against its unquantized codes (an e4m3
//    row through the same decode).
// A position past the cache (an idle slot at S) is clamped to S - 1, as the
// reference's CPU cache write clamps its start.
//
// What bounds it on an H100: bytes, the live K and V rows of every slot
// (2 * pos[b] * KH * D codes; one byte each for int8 and e4m3) over the
// 3.35 TB/s of HBM.
//
// Design: one thread-block cluster of C = 8 CTAs per (slot, KV head) splits
// the slot's live keys [0, L) (L = min(pos, S-1), read on the device) in
// rounds. A CTA takes one piece of keys a round, and a piece lies in one
// chunk: with one chunk of S there is one round and CTA r takes
// [L r/C, L (r+1)/C); with chunks of 256, round k gives CTA r chunk kC + r.
// A CTA's shared memory is fixed by G and the cache's element size (scores
// of SB keys, two V buffers, one chunk's partials), never by S, so every
// cache length runs and the occupancy does not depend on it. A piece longer
// than SB (one chunk of S > 8 SB) is scored twice: once for its max, once
// for its codes.
//
// Why the split over keys is exact. A probability code depends only on its
// score and its chunk's running max m_c = max(m_{c-1}, max of chunk c), and
// a max is the same in any order. So, each round:
//  1. each CTA scores its piece into its own shared memory and takes, per
//     query row, the max of its keys. The scores run on the tensor cores: a
//     warp takes 8 keys at a time, each lane loads 16-byte pieces of one key
//     row straight into B fragments (two or four 8-key tiles in flight), and
//     q's A fragment holds the same columns in the same order; int8 is
//     s8 x s8 -> s32 (m16n8k32, exact, q requantized per row from the row's
//     four lanes), bf16 and e4m3 (decoded exactly to bf16 first) are
//     bf16 x bf16 -> f32 (m16n8k16, exact products, f32 sums in the MMA's
//     order); rows past G are zero;
//  2. cluster barrier; every CTA reads all ranks' maxima over distributed
//     shared memory and forms the running max at each rank's chunk (with
//     one chunk of S: the max of all ranks);
//  3. each CTA rounds its codes against its chunk's running max (expf, as
//     the single-CTA kernel did) and forms the chunk's partials: int8
//     sum(e8) and e8 . v8 as s32 (exact); bf16 / e4m3 the f32 sum of e and
//     the f32 sum of bf16(e) * v. V rows come by cp.async into two buffers,
//     the first two at the round's start, so their latency hides behind
//     the scores; each warp takes 32 columns, each lane 4 columns of every
//     fourth key;
//  4. cluster barrier; CTA r owns columns [16r, 16r + 16): it sums each
//     chunk's partials over the ranks that hold it (integer sums are exact,
//     so int8 results do not depend on the split) and replays the f32
//     recurrence l = l * alpha_c + esum_c, acc = acc * alpha_c + y_c over
//     the round's chunks in order, each product and sum rounded on its own
//     (no fused multiply-add), as the plain version's tensor ops round them.
// Then the owner adds the new token from registers (its score summed over
// the 128 columns in a fixed order) and writes its columns; rank 0 writes
// the new k/v row at row L, which no CTA reads. A last cluster barrier: no
// CTA leaves while another can still read its shared memory.
// So an int8 output is the same f32 arithmetic on the same integers as a
// single CTA that walks every key; for bf16 and e4m3 only the order of the
// f32 score, PV and esum sums moves. Every CTA reaches every barrier, also
// one with no keys (a max of -1e30 and zero sums). Between rounds nothing
// is overwritten early: a round's maxima are read before its second
// barrier and its partials before the next round's first.
#include "cluster_decode.cuh"

namespace {

// the cluster's constants (C, NT, SB, VBYTES, ...) and its primitives (the
// MMAs, cp.async, the V swizzle, the K load order), shared with K15
using namespace cluster_decode;

__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(e4m3_t v) { return e4m3_to_f32(v.bits); }

// dynamic shared memory of one CTA: scores [G][SB], V buffers [2][VBYTES],
// one chunk's PV partials [G][D]
constexpr int smem_bytes(int G) { return 4 * G * SB + 2 * VBYTES + 4 * G * D; }

// block-wide sum of one value per query row; every thread gets the
// result, in the order ((w0 + w1) + (w2 + w3)) after a butterfly in each
// warp
template <int G>
__device__ __forceinline__ void block_sum(float (&v)[G], float (*red)[NW]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[g] += __shfl_xor_sync(FULL, v[g], off);
    if (lane == 0) red[g][warp] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) v[g] = (red[g][0] + red[g][1]) + (red[g][2] + red[g][3]);
  __syncthreads();
}

template <typename CT, int G>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(NT, 4)
fused_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const CT* __restrict__ knew, const CT* __restrict__ vnew,
                    CT* __restrict__ kc, CT* __restrict__ vc,
                    const int* __restrict__ pos, const float* __restrict__ kscale,
                    const float* __restrict__ vscale, float* __restrict__ out_f32,
                    __nv_bfloat16* __restrict__ out_bf16, int S, int KH, int chunk) {
  constexpr bool kInt8 = std::is_same<CT, int8_t>::value;
  constexpr int ELEM = sizeof(CT);
  constexpr int ROW = D * ELEM;          // bytes of one head's row
  constexpr int CH = ROW / 16;           // 16-byte chunks of it
  constexpr int NL = ROW / 64;           // 16-byte K loads a lane takes a key
  constexpr int TU = ELEM == 2 ? 2 : 4;  // 8-key tiles a warp keeps in flight
  constexpr int VH = VBYTES / ROW;       // V rows a buffer
  constexpr int GW = (G + NW - 1) / NW;  // query rows a warp takes the max of
  using Acc = typename std::conditional<kInt8, int, float>::type;
  static_assert(NT == D && G * 16 <= NT && SB % VH == 0, "one thread per column");

  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);                          // [G][SB]
  unsigned char* vbuf = smem + 4 * G * SB;                             // [2][VH][ROW]
  Acc* part = reinterpret_cast<Acc*>(vbuf + 2 * VBYTES);               // [G][D]
  __shared__ Acc psum[G];       // this round's sum of e8 / e
  __shared__ float cmax[G];     // this round's max of this CTA's keys
  __shared__ float mr[C][G];    // this round's running max at each rank's chunk
  __shared__ float redf[G][NW];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int KHD = KH * D;
  const int bh = blockIdx.x / C, h = bh % KH, b = bh / KH;
  const size_t qoff = (size_t)(b * KH + h) * G * D;

  // the loads nothing else waits on go first: this lane's q fragment (row
  // gid, the columns its K loads hold), the position and the scales
  uint4 qraw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bf16 q elements [kcol(i'), +8) for bf16 caches, [kcol(i'), +16) for codes
    const int e0 = ELEM == 2 ? kcol<2>(i, tig) : kcol<1>(i >> 1, tig) + 8 * (i & 1);
    qraw[i] = gid < G ? *reinterpret_cast<const uint4*>(q + qoff + gid * D + e0)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
  const int L = min(pos[b], S - 1);
  const float ks = kscale != nullptr ? *kscale : 1.f;
  const float vs = vscale != nullptr ? *vscale : 1.f;

  const bool one_chunk = chunk >= S;
  const int ncl = (L + chunk - 1) / chunk;  // live chunks of the slot
  const int nrounds = (ncl + C - 1) / C;
  const CT* kbase = kc + (size_t)b * S * KHD + h * D;
  const CT* vbase = vc + (size_t)b * S * KHD + h * D;
  // keys [lo, hi) of rank r in round k
  auto piece = [&](int k, int r, int& lo, int& hi) {
    if (one_chunk) {
      lo = L * r / C;
      hi = L * (r + 1) / C;
    } else {
      lo = min((k * C + r) * chunk, L);
      hi = min(lo + chunk, L);
    }
  };

  // A fragments of q: int8 codes (requantized per row with qmax = max|q|,
  // the row's four lanes agreeing by shuffles) or bf16 pairs. The code of
  // cluster_decode.cuh's q_load / q_fragments, kept inline here: called
  // through them, ptxas spills more in the bf16 instances (G = 4: 168
  // bytes against 16) and the bf16 G = 4 row runs 12% slower.
  const float inv_sqrt_d = ks / sqrtf((float)D);
  uint32_t qa[16];
  float fs = 0.f;
  {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(qraw);
    if constexpr (kInt8) {
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) a = fmaxf(a, fabsf(__bfloat162float(e[c])));
      a = fmaxf(a, __shfl_xor_sync(FULL, a, 1));
      a = fmaxf(a, __shfl_xor_sync(FULL, a, 2));
      const float qmax = fmaxf(a, 1e-30f);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int code = (int)rintf(__bfloat162float(e[4 * w + i]) * (127.f / qmax));
          word |= (uint32_t)(code & 0xff) << (8 * i);
        }
        qa[w] = word;
      }
      fs = qmax * (inv_sqrt_d / 127.f);
    } else {
#pragma unroll
      for (int w = 0; w < 16; ++w) qa[w] = reinterpret_cast<const uint32_t*>(qraw)[w];
    }
  }

  // scores of keys [base, base + n), n <= SB, into sc[g][0, n) on the
  // tensor cores: warp w takes 8-key tiles w, w + NW, ...; lane (gid, tig)
  // loads key gid's bytes [64 i + 16 tig, +16) straight into B fragments,
  // TU tiles in flight
  auto score = [&](int base, int n) {
    for (int t0 = warp; t0 * 8 < n; t0 += NW * TU) {
      uint4 kr[TU][NL];
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        const int key = (t0 + u * NW) * 8 + gid;
        const unsigned char* row =
            reinterpret_cast<const unsigned char*>(kbase + (size_t)(base + min(key, n - 1)) * KHD);
#pragma unroll
        for (int i = 0; i < NL; ++i)
          kr[u][i] = key < n ? *reinterpret_cast<const uint4*>(row + 64 * i + 16 * tig)
                             : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        const int k0 = (t0 + u * NW) * 8;
        if (k0 >= n) continue;  // uniform over the warp
        const uint32_t* kw = reinterpret_cast<const uint32_t*>(kr[u]);
        float s0, s1;
        if constexpr (kInt8) {
          int c[4] = {0, 0, 0, 0};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(c, qa[2 * j], qa[2 * j + 1], kw[2 * j], kw[2 * j + 1]);
          s0 = (float)c[0] * fs;
          s1 = (float)c[1] * fs;
        } else {
          uint32_t kb[16];
          if constexpr (ELEM == 2) {
#pragma unroll
            for (int w = 0; w < 16; ++w) kb[w] = kw[w];
          } else {  // e4m3 codes, decoded exactly to bf16 pairs in element order
#pragma unroll
            for (int w = 0; w < 8; ++w) {
              kb[2 * w] = pack_bf16(e4m3_to_f32(kw[w] & 0xffu), e4m3_to_f32((kw[w] >> 8) & 0xffu));
              kb[2 * w + 1] =
                  pack_bf16(e4m3_to_f32((kw[w] >> 16) & 0xffu), e4m3_to_f32(kw[w] >> 24));
            }
          }
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_bf16(c, qa[2 * j], qa[2 * j + 1], kb[2 * j], kb[2 * j + 1]);
          s0 = c[0] * inv_sqrt_d;
          s1 = c[1] * inv_sqrt_d;
        }
        const int kk = k0 + 2 * tig;  // c[0], c[1]: row gid, keys kk and kk + 1
        if (gid < G) {
          if (kk < n) sc[gid * SB + kk] = s0;
          if (kk + 1 < n) sc[gid * SB + kk + 1] = s1;
        }
      }
    }
  };

  // V rows [VH i, VH (i + 1)) of the piece [lo, lo + nk) into buffer i % 2
  // (one commit group, empty past the piece)
  auto stage_v = [&](int lo, int nk, int i) {
    const int n = min(VH, nk - VH * i);
    unsigned char* buf = vbuf + (i & 1) * VBYTES;
    for (int t = tid; t < n * CH; t += NT) {
      const int r = t / CH, ch = t % CH;
      cp_async16(buf + r * ROW + vswz<ELEM>(r, ch) * 16,
                 reinterpret_cast<const unsigned char*>(vbase + (size_t)(lo + VH * i + r) * KHD) +
                     ch * 16);
    }
    cp_async_commit();
  };

  // the owner's state of the recurrence: query row og, column od
  const int og = tid >> 4, od = rank * 16 + (tid & 15);
  float m_run = -1e30f, l_run = 0.f, acc = 0.f;
  float m_prev = -1e30f;  // tid < G: the running max before this round

  // PV lanes: warp w takes columns [32 w, +32), lane (kq, cq) the 4 columns
  // at 32 w + 4 cq of keys kq, kq + 4, ...
  const int kq = lane >> 3, cq = lane & 7;
  const int col = warp * 32 + cq * 4;

  for (int k = 0; k < nrounds; ++k) {
    int lo, hi;
    piece(k, rank, lo, hi);
    const int nk = hi - lo;
    stage_v(lo, nk, 0);
    stage_v(lo, nk, 1);

    // 1. the max of this CTA's keys, SB keys at a time
    float pm[GW];
#pragma unroll
    for (int j = 0; j < GW; ++j) pm[j] = -1e30f;
    for (int s0 = 0; s0 < nk; s0 += SB) {
      const int n = min(SB, nk - s0);
      __syncthreads();  // every read of the scores before is done
      score(lo + s0, n);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < GW; ++j) {
        const int g = warp + NW * j;
        if (g < G)
          for (int kk = lane; kk < n; kk += 32) pm[j] = fmaxf(pm[j], sc[g * SB + kk]);
      }
    }
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      const int g = warp + NW * j;
      if (g < G) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) pm[j] = fmaxf(pm[j], __shfl_xor_sync(FULL, pm[j], off));
        if (lane == 0) cmax[g] = pm[j];
      }
    }

    // 2. the running max at every rank's chunk, from all ranks' maxima (with
    // one chunk of S, every rank's is the last one's)
    cluster.sync();
    if (tid < G) {
      float m = m_prev;
#pragma unroll
      for (int r = 0; r < C; ++r) {
        m = fmaxf(m, cluster.map_shared_rank(cmax, r)[tid]);
        mr[r][tid] = m;
      }
      m_prev = m;
    }
    __syncthreads();
    const int mine = one_chunk ? C - 1 : rank;  // the row of mr this CTA's codes take

    // 3. codes (int8) or exponentials against this chunk's running max,
    // and the chunk's partials
    Acc y[G][4], es[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      es[g] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) y[g][i] = 0;
    }
    for (int s0 = 0; s0 < nk; s0 += SB) {
      const int n = min(SB, nk - s0);
      if (nk > SB) {  // the scores held are another block's
        __syncthreads();
        score(lo + s0, n);
        __syncthreads();
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float m = mr[mine][g];
        for (int kk = tid; kk < n; kk += NT) {
          const float e = expf(sc[g * SB + kk] - m);
          if constexpr (kInt8)
            reinterpret_cast<int*>(sc)[g * SB + kk] = (int)rintf(e * 127.f);
          else
            sc[g * SB + kk] = e;
        }
      }
      for (int i = s0 / VH; VH * i < s0 + n; ++i) {
        cp_async_wait<1>();  // buffer i has landed (i + 1 may be in flight)
        __syncthreads();
        const unsigned char* buf = vbuf + (i & 1) * VBYTES;
        const int re = min(VH, nk - VH * i);  // rows of this buffer
        for (int r0 = kq; r0 < re; r0 += 16) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = r0 + 4 * u;
            if (r < re) {
              const int byte = col * ELEM;
              const unsigned char* p = buf + r * ROW + vswz<ELEM>(r, byte >> 4) * 16 + (byte & 15);
              const int kk = VH * i + r - s0;  // the key's index in sc
              float vf[4];
              int vi[4];
              if constexpr (ELEM == 2) {
                const uint2 w = *reinterpret_cast<const uint2*>(p);
                const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
                for (int c = 0; c < 4; ++c) vf[c] = __bfloat162float(e[c]);
              } else {
                const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  if constexpr (kInt8)
                    vi[c] = (int)(int8_t)(w >> (8 * c));
                  else
                    vf[c] = e4m3_to_f32((w >> (8 * c)) & 0xffu);
                }
              }
#pragma unroll
              for (int g = 0; g < G; ++g) {
                if constexpr (kInt8) {
                  const int code = reinterpret_cast<const int*>(sc)[g * SB + kk];
                  es[g] += code;
#pragma unroll
                  for (int c = 0; c < 4; ++c) y[g][c] += code * vi[c];
                } else {
                  const float e = sc[g * SB + kk];
                  const float pb = __bfloat162float(__float2bfloat16(e));
                  es[g] += e;
#pragma unroll
                  for (int c = 0; c < 4; ++c) y[g][c] = fmaf(pb, vf[c], y[g][c]);
                }
              }
            }
          }
        }
        __syncthreads();  // every read of buffer i is done
        stage_v(lo, nk, i + 2);
      }
    }
    cp_async_wait<0>();
    // the sums over a warp's 4 key lanes; lanes kq == 0 hold the chunk's
    // partials of their 4 columns (every warp holds the exponential sums)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      es[g] += __shfl_xor_sync(FULL, es[g], 8);
      es[g] += __shfl_xor_sync(FULL, es[g], 16);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        y[g][c] += __shfl_xor_sync(FULL, y[g][c], 8);
        y[g][c] += __shfl_xor_sync(FULL, y[g][c], 16);
      }
    }
    if (kq == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int c = 0; c < 4; ++c) part[g * D + col + c] = y[g][c];
        if (tid == 0) psum[g] = es[g];
      }
    }

    // 4. this rank's 16 columns: each chunk's partials summed over the
    // ranks that hold it, the recurrence over the round's chunks in order
    cluster.sync();
    if (tid < G * 16) {
      Acc esc = 0, yc = 0;
      bool held = false;
      for (int r = 0; r < C; ++r) {
        int rlo, rhi;
        piece(k, r, rlo, rhi);
        if (rhi > rlo) {
          esc = esc + cluster.map_shared_rank(psum, r)[og];
          yc = yc + cluster.map_shared_rank(part, r)[og * D + od];
          held = true;
        }
        if (held && (!one_chunk || r == C - 1)) {
          float esum, yv;
          if constexpr (kInt8) {
            esum = (float)esc * (1.f / 127.f);
            yv = (float)yc * (1.f / 127.f);
          } else {
            esum = esc;
            yv = yc;
          }
          const float m_cur = mr[r][og];
          const float alpha = expf(m_run - m_cur);
          l_run = __fadd_rn(__fmul_rn(l_run, alpha), esum);
          acc = __fadd_rn(__fmul_rn(acc, alpha), yv);
          m_run = m_cur;
          esc = yc = 0;
          held = false;
        }
      }
    }
  }

  // the new token's score from its unquantized codes, thread tid taking
  // column tid
  const size_t nrow = (size_t)b * KHD + h * D;
  float sn[G];
  {
    const float kn = to_f(knew[nrow + tid]);
#pragma unroll
    for (int g = 0; g < G; ++g) sn[g] = __bfloat162float(q[qoff + g * D + tid]) * kn;
  }
  block_sum<G>(sn, redf);
  if (tid < G * 16) {
    const float vn = to_f(vnew[nrow + od]);
    const float s_n = sn[og] * inv_sqrt_d;
    const float m_fin = fmaxf(m_run, s_n);
    const float alpha = expf(m_run - m_fin);
    const float e_n = expf(s_n - m_fin);
    const float l_fin = __fadd_rn(__fmul_rn(l_run, alpha), e_n);
    const float a = __fadd_rn(__fmul_rn(acc, alpha), __fmul_rn(e_n, vn));
    const float o = a * (vs / fmaxf(l_fin, 1e-30f));
    if (out_bf16 != nullptr)
      out_bf16[qoff + og * D + od] = __float2bfloat16(o);
    else
      out_f32[qoff + og * D + od] = o;
  }
  // every CTA reads rows < L only: the new row L is written by rank 0
  if (rank == 0) {
    kc[((size_t)b * S + L) * KHD + h * D + tid] = knew[nrow + tid];
    vc[((size_t)b * S + L) * KHD + h * D + tid] = vnew[nrow + tid];
  }
  // no CTA leaves while another may read its shared memory
  cluster.sync();
}

template <typename CT, int G>
int launch(const void* q, const void* knew, const void* vnew, void* kc, void* vc,
           const void* pos, const void* kscale, const void* vscale, void* out_f32,
           void* out_bf16, int B, int S, int KH, int chunk, cudaStream_t s) {
  static unsigned done = 0;
  const int e = allow_smem(fused_decode_kernel<CT, G>, smem_bytes(G), done);
  if (e != 0) return e;
  fused_decode_kernel<CT, G><<<B * KH * C, NT, smem_bytes(G), s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const CT*>(knew),
      static_cast<const CT*>(vnew), static_cast<CT*>(kc), static_cast<CT*>(vc),
      static_cast<const int*>(pos), static_cast<const float*>(kscale),
      static_cast<const float*>(vscale), static_cast<float*>(out_f32),
      static_cast<__nv_bfloat16*>(out_bf16), S, KH, chunk);
  return (int)cudaGetLastError();
}

template <typename CT>
int dispatch_g(int G, const void* q, const void* knew, const void* vnew, void* kc,
               void* vc, const void* pos, const void* kscale, const void* vscale,
               void* out_f32, void* out_bf16, int B, int S, int KH, int chunk,
               cudaStream_t s) {
  switch (G) {
    case 1: return launch<CT, 1>(q, knew, vnew, kc, vc, pos, kscale, vscale, out_f32, out_bf16, B, S, KH, chunk, s);
    case 2: return launch<CT, 2>(q, knew, vnew, kc, vc, pos, kscale, vscale, out_f32, out_bf16, B, S, KH, chunk, s);
    case 4: return launch<CT, 4>(q, knew, vnew, kc, vc, pos, kscale, vscale, out_f32, out_bf16, B, S, KH, chunk, s);
    case 8: return launch<CT, 8>(q, knew, vnew, kc, vc, pos, kscale, vscale, out_f32, out_bf16, B, S, KH, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

__global__ void e4m3_decode_kernel(const uint8_t* __restrict__ codes,
                                   float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = e4m3_to_f32(codes[i]);
}

}  // namespace

// q bf16 [B, KH, G, 128], 16-byte aligned; knew/vnew [B, KH*128] and caches
// [B, S, KH*128] of bf16 (cache_kind 0), int8 (1) or e4m3 (2) codes,
// 16-byte aligned; pos int32 [B]; kscale/vscale f32 scalars on the device
// or null (scale 1); exactly one of out_f32 / out_bf16 non-null.
extern "C" int fused_decode_attention(const void* q, const void* knew,
                                      const void* vnew, void* kc, void* vc,
                                      const void* pos, const void* kscale,
                                      const void* vscale, void* out_f32,
                                      void* out_bf16, int B, int S, int KH, int G,
                                      int chunk, int cache_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_kind) {
    case 0:
      return dispatch_g<__nv_bfloat16>(G, q, knew, vnew, kc, vc, pos, kscale, vscale,
                                       out_f32, out_bf16, B, S, KH, chunk, s);
    case 1:
      return dispatch_g<int8_t>(G, q, knew, vnew, kc, vc, pos, kscale, vscale,
                                out_f32, out_bf16, B, S, KH, chunk, s);
    case 2:
      return dispatch_g<e4m3_t>(G, q, knew, vnew, kc, vc, pos, kscale, vscale,
                                out_f32, out_bf16, B, S, KH, chunk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The e4m3 decode the kernels read caches through (e4m3.cuh), applied to n
// codes: f32 out. A probe of the device function for the card check.
extern "C" int e4m3_decode(const void* codes, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  e4m3_decode_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
