// Decode attention split over keys by a thread-block cluster (sm_90a): the
// pieces K2 (fused_decode_attention.cu) and the cluster kernels of K15 and
// K17 (decode_attention.cu) share, and those two kernels themselves (one
// body over a slot's pages; K17's pages are its selected blocks).
//
// The kernels run one cluster of C = 8 CTAs of 128 threads per (slot, KV
// head) at D = 128 and G in {1, 2, 4, 8}. A CTA scores its keys on the
// tensor cores (a warp takes 8 keys at a time, each lane loads 16-byte
// pieces of one key row straight into B fragments, and q's A fragment holds
// the same columns in the same order; int8 is s8 x s8 -> s32, m16n8k32,
// with q requantized per row; bf16 and e4m3, the latter decoded exactly to
// bf16 first, are bf16 x bf16 -> f32, m16n8k16; rows past G are zero), then
// the cluster agrees on the running max over distributed shared memory
// before any probability code is rounded, each CTA forms its keys'
// partials, and a last pass replays the f32 recurrence in key order.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "e4m3.cuh"

namespace cluster_decode {

namespace cg = cooperative_groups;

constexpr int D = 128;
constexpr int C = 8;                // CTAs a cluster (the portable cluster size)
constexpr int NT = 128;             // threads a CTA: one per column
constexpr int NW = NT / 32;
constexpr int SB = 512;             // keys a CTA holds scores of
constexpr int VBYTES = 16 * 1024;   // bytes of one of the two V buffers
constexpr unsigned FULL = 0xffffffffu;

// 16-byte chunk `ch` of staged V row `r`, XOR-swizzled so that the PV
// loop's 4 consecutive rows a warp reads (int8 / e4m3: 32 bytes each; bf16:
// 2 rows of 64 bytes a half-warp) fall in distinct banks
template <int ELEM>
__device__ __forceinline__ int vswz(int r, int ch) {
  return ELEM == 1 ? (ch ^ ((r & 3) << 1)) : (ch ^ ((r & 1) << 2));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte load i (of 2 for 1-byte codes, 4 for bf16) a lane takes of a K
// row in the score product: bytes [64 i + 16 tig, +16). The same element
// order is used for q, so that k-index j of the MMA pairs the same d on
// both sides.
template <int ELEM>
__device__ __forceinline__ int kcol(int i, int tig) { return (64 * i + 16 * tig) / ELEM; }

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
// c += a (16 x 32 s8, row) * b (32 x 8 s8, col), s32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
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

// this lane's piece of q for the score MMAs (row gid, the columns its K
// loads hold) from bf16 q [G][D] at `qg`; rows past G are zero. K2 keeps
// its own inline copy of this and of q_fragments (see
// fused_decode_attention.cu).
template <int ELEM, int G>
__device__ __forceinline__ void q_load(const __nv_bfloat16* __restrict__ qg, uint4 (&qraw)[4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bf16 q elements [kcol(i'), +8) for bf16 caches, [kcol(i'), +16) for codes
    const int e0 = ELEM == 2 ? kcol<2>(i, tig) : kcol<1>(i >> 1, tig) + 8 * (i & 1);
    qraw[i] = gid < G ? *reinterpret_cast<const uint4*>(qg + gid * D + e0)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
}

// A fragments of q: int8 codes (requantized per row with qmax = max|q|,
// the row's four lanes agreeing by shuffles; `fs` gets
// qmax * inv_sqrt_d / 127) or bf16 pairs
template <bool kInt8>
__device__ __forceinline__ void q_fragments(const uint4 (&qraw)[4], float inv_sqrt_d,
                                            uint32_t (&qa)[16], float& fs) {
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

// ---------------------------------------------------------------------------
// K15 and K17: decode attention over a slot's pages, one cluster per (slot,
// KV head)
// ---------------------------------------------------------------------------
constexpr int PP = 8;  // pages a CTA holds a round (at most; SB / page_size if fewer)

// dynamic shared memory of one CTA: scores [G][SB], V buffers [2][VBYTES],
// each held page's PV partials [PP][G][D]
constexpr int paged_smem_bytes(int G) { return 4 * G * SB + 2 * VBYTES + 4 * PP * G * D; }

// Where a slot's pages lie, the one thing K15 and K17 do differently. A
// Slot gives the slot's page count, the first cache row of page p and (K17)
// the keys of page p below the slot's length; kWhole says whether a page is held
// whole, its keys at or past the length scored -1e30 (K17, as the
// reference's block-sparse kernel masks them), or cut at the length, keys
// past it never visited (K15).
//
// K15: page p of slot b is pool page page_table[b, p]; keys [0, L) with
// L = min(lengths[b], pmax * ps), so only the last page is cut.
struct PoolPages {
  const int* page_table;
  const int* lengths;
  int pmax, ps;
  struct Slot {
    const int* pt;
    int L, ps;
    static constexpr bool kWhole = false;
    __device__ int pages() const { return (L + ps - 1) / ps; }
    __device__ int row0(int p) const { return pt[p] * ps; }
  };
  __device__ Slot slot(int b) const {
    return {page_table + (size_t)b * pmax, max(min(lengths[b], pmax * ps), 0), ps};
  }
};

// K17: page p of slot b is block sel[b, p] of the slot's dense cache rows
// [b S, b S + S), for p < min(nvalid[b], nsel), each block_size rows held
// whole; keys at or past lengths[b] (not clamped to S) are masked, so a
// block that holds no live key still rounds its codes as the reference's
// does (exp(0) -> 127 while the running max is -1e30).
struct SelectedBlocks {
  const int* sel;
  const int* nvalid;
  const int* lengths;
  int nsel, S, bs;
  struct Slot {
    const int* sel;
    int base, n, L, ps;
    static constexpr bool kWhole = true;
    __device__ int pages() const { return n; }
    __device__ int row0(int p) const { return base + sel[p] * ps; }
    __device__ int live(int p) const { return min(max(L - sel[p] * ps, 0), ps); }
  };
  __device__ Slot slot(int b) const {
    return {sel + (size_t)b * nsel, b * S, max(min(nvalid[b], nsel), 0), lengths[b], bs};
  }
};

// Replaces (through decode_attention.cu's entries paged_decode_attention
// and block_sparse_decode_attention)
// modelopt_tpu/kernels/paged_attention.py::paged_decode_attention (Pallas
// body _paged_attn_kernel) and
// modelopt_tpu/kernels/block_sparse_attention.py::block_sparse_decode_attention
// (_bs_attn_kernel); bound by bytes, the rows of every slot's pages (K17:
// its selected blocks) over the 3.35 TB/s of HBM.
//
// Attention of the slot's G query rows over its pages in page order, one
// chunk per page, as the reference's page-per-step grid takes them. Rounds
// of C * P pages (P = min(PP, SB / ps) a CTA):
//  1. each CTA takes a contiguous run of the round's pages (balanced over
//     the ranks), scores their keys into its shared memory (K17: keys past
//     the length -1e30) and takes the max of each page per query row;
//  2. cluster barrier; every CTA copies all ranks' page maxima over
//     distributed shared memory and forms the running max at every page of
//     the round, m_p = max(m_{p-1}, max_p), in page order from the running
//     max the rounds before left;
//  3. each CTA rounds its codes against its page's running max (expf) and
//     forms each page's partials: int8 sum(e8) and e8 . v8 as s32 (exact),
//     bf16 / e4m3 the f32 sum of e and the f32 sum of bf16(e) * v;
//  4. cluster barrier; CTA r owns columns [16 r, 16 r + 16) and replays the
//     f32 recurrence l = l * alpha_p + esum_p, acc = acc * alpha_p + y_p over
//     all the round's pages in order, reading each page's partials from the
//     rank that holds it, each product and sum rounded on its own.
// A last cluster barrier: no CTA leaves while another can still read its
// shared memory. Every CTA reaches every barrier, also one with no pages
// (a slot with none writes 0: l = 0).
template <typename CT, int G, typename Pages>
__device__ __forceinline__ void cluster_attend(
    const __nv_bfloat16* __restrict__ q, const CT* __restrict__ kp, const CT* __restrict__ vp,
    const Pages& pages, const float* __restrict__ kscale, const float* __restrict__ vscale,
    float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16, int KH) {
  constexpr bool kInt8 = std::is_same<CT, int8_t>::value;
  constexpr int ELEM = sizeof(CT);
  constexpr int ROW = D * ELEM;          // bytes of one head's row
  constexpr int CH = ROW / 16;           // 16-byte chunks of it
  constexpr int NL = ROW / 64;           // 16-byte K loads a lane takes a key
  constexpr int TU = ELEM == 2 ? 2 : 4;  // 8-key tiles a warp keeps in flight
  constexpr int VH = VBYTES / ROW;       // V rows a buffer
  using Acc = typename std::conditional<kInt8, int, float>::type;
  static_assert(NT == D && G * 16 <= NT, "one thread per column");

  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);                          // [G][SB]
  unsigned char* vbuf = smem + 4 * G * SB;                             // [2][VH][ROW]
  Acc* part = reinterpret_cast<Acc*>(vbuf + 2 * VBYTES);               // [PP][G][D]
  __shared__ Acc psum[PP][G];        // each held page's sum of e8 / e
  __shared__ float pmx[PP][G];       // each held page's max
  __shared__ float mr[C * PP][G];    // the running max at every page of the round
  __shared__ int prow[PP];           // first cache rows of the held pages
  __shared__ int plive[PP];          // keys of each held page below the length (kWhole)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int KHD = KH * D;
  const int bh = blockIdx.x / C, h = bh % KH, b = bh / KH;
  const size_t qoff = (size_t)(b * KH + h) * G * D;

  uint4 qraw[4];
  q_load<ELEM, G>(q + qoff, qraw);
  const float ks = kscale != nullptr ? *kscale : 1.f;
  const float vs = vscale != nullptr ? *vscale : 1.f;
  const float inv_sqrt_d = ks / sqrtf((float)D);
  uint32_t qa[16];
  float fs = 0.f;
  q_fragments<kInt8>(qraw, inv_sqrt_d, qa, fs);

  using Slot = typename Pages::Slot;
  const Slot slot = pages.slot(b);
  const int ps = slot.ps;
  const int npages = slot.pages();
  const int P = min(PP, SB / ps);    // pages a CTA a round
  const int nrounds = (npages + C * P - 1) / (C * P);
  // the pages [p0, p1) rank r holds in round k
  auto run = [&](int k, int r, int& p0, int& p1) {
    const int base = k * C * P, n = min(C * P, npages - base);
    p0 = base + n * r / C;
    p1 = base + n * (r + 1) / C;
  };
  // the cache row of key j of the held run (p0 the run's first page)
  auto row = [&](const CT* pool, int j) {
    return reinterpret_cast<const unsigned char*>(
        pool + ((size_t)prow[j / ps] + j % ps) * KHD + h * D);
  };
  // whether held key j lies below the slot's length (always, where pages
  // are cut at it)
  auto live_key = [&](int j) { return !Slot::kWhole || j % ps < plive[j / ps]; };

  // scores of the held keys [0, n) into sc[g][0, n) on the tensor cores:
  // warp w takes 8-key tiles w, w + NW, ... (a tile lies in one page, as
  // ps % 8 == 0); lane (gid, tig) loads key gid's bytes [64 i + 16 tig, +16)
  // straight into B fragments, TU tiles in flight; a masked key's row is
  // not read and its score is -1e30
  auto score = [&](int n) {
    for (int t0 = warp; t0 * 8 < n; t0 += NW * TU) {
      uint4 kr[TU][NL];
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        const int key = (t0 + u * NW) * 8 + gid;
        const unsigned char* r = row(kp, min(key, n - 1));
#pragma unroll
        for (int i = 0; i < NL; ++i)
          kr[u][i] = key < n && live_key(key)
                         ? *reinterpret_cast<const uint4*>(r + 64 * i + 16 * tig)
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
          if (kk < n) sc[gid * SB + kk] = live_key(kk) ? s0 : -1e30f;
          if (kk + 1 < n) sc[gid * SB + kk + 1] = live_key(kk + 1) ? s1 : -1e30f;
        }
      }
    }
  };

  // V rows [VH i, VH (i + 1)) of the held keys [0, nk) into buffer i % 2
  // (one commit group, empty past the keys)
  auto stage_v = [&](int nk, int i) {
    const int n = min(VH, nk - VH * i);
    unsigned char* buf = vbuf + (i & 1) * VBYTES;
    for (int t = tid; t < n * CH; t += NT) {
      const int r = t / CH, ch = t % CH;
      cp_async16(buf + r * ROW + vswz<ELEM>(r, ch) * 16, row(vp, VH * i + r) + ch * 16);
    }
    cp_async_commit();
  };

  // the owner's state of the recurrence: query row og, column od
  const int og = tid >> 4, od = rank * 16 + (tid & 15);
  float m_run = -1e30f, l_run = 0.f, acc = 0.f;
  float m_prev = -1e30f;  // tid < G: the running max the rounds before left

  // PV lanes: warp w takes columns [32 w, +32), lane (kq, cq) the 4 columns
  // at 32 w + 4 cq of keys kq, kq + 4, ...
  const int kq = lane >> 3, cq = lane & 7;
  const int col = warp * 32 + cq * 4;

  for (int k = 0; k < nrounds; ++k) {
    int p0, p1;
    run(k, rank, p0, p1);
    const int np = p1 - p0;
    const int nk = Slot::kWhole ? np * ps : max(min(slot.L, p1 * ps) - p0 * ps, 0);
    __syncthreads();  // the last round's reads of prow, sc and the buffers are done
    if (tid < np) {
      prow[tid] = slot.row0(p0 + tid);
      if constexpr (Slot::kWhole) plive[tid] = slot.live(p0 + tid);
    }
    __syncthreads();
    stage_v(nk, 0);
    stage_v(nk, 1);

    // 1. scores, and the max of each held page per query row
    score(nk);
    __syncthreads();
    for (int i = warp; i < np * G; i += NW) {
      const int lp = i / G, g = i % G;
      float m = -1e30f;
      for (int j = lp * ps + lane; j < min(nk, (lp + 1) * ps); j += 32) m = fmaxf(m, sc[g * SB + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
      if (lane == 0) pmx[lp][g] = m;
    }

    // 2. every rank's page maxima, then the running max at each page of
    // the round in page order
    cluster.sync();
    int first = 0;  // the round index of this CTA's first page
    for (int r = 0; r < C; ++r) {
      int q0, q1;
      run(k, r, q0, q1);
      if (r == rank) first = q0 - k * C * P;
      const float* rm = cluster.map_shared_rank(&pmx[0][0], r);
      for (int i = tid; i < (q1 - q0) * G; i += NT)
        mr[q0 - k * C * P + i / G][i % G] = rm[i];
    }
    __syncthreads();
    if (tid < G) {
      const int n = min(C * P, npages - k * C * P);
      float m = m_prev;
      for (int i = 0; i < n; ++i) {
        m = fmaxf(m, mr[i][tid]);
        mr[i][tid] = m;
      }
      m_prev = m;
    }
    __syncthreads();

    // 3. codes (int8) or exponentials against each page's running max
#pragma unroll
    for (int g = 0; g < G; ++g)
      for (int j = tid; j < nk; j += NT) {
        const float e = expf(sc[g * SB + j] - mr[first + j / ps][g]);
        if constexpr (kInt8)
          reinterpret_cast<int*>(sc)[g * SB + j] = (int)rintf(e * 127.f);
        else
          sc[g * SB + j] = e;
      }
    // each held page's partials, buffer by buffer, page segment by segment
    Acc y[G][4], es[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      es[g] = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) y[g][c] = 0;
    }
    for (int i = 0; VH * i < nk; ++i) {
      cp_async_wait<1>();  // buffer i has landed (i + 1 may be in flight)
      __syncthreads();     // and the codes are written
      const unsigned char* buf = vbuf + (i & 1) * VBYTES;
      const int end = min(VH * (i + 1), nk);
      for (int j0 = VH * i; j0 < end;) {
        const int lp = j0 / ps, j1 = min(end, (lp + 1) * ps);
#pragma unroll 4
        for (int j = j0 + kq; j < j1; j += 4) {
          const int r = j - VH * i;
          const int byte = col * ELEM;
          const unsigned char* p = buf + r * ROW + vswz<ELEM>(r, byte >> 4) * 16 + (byte & 15);
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
              const int code = reinterpret_cast<const int*>(sc)[g * SB + j];
              es[g] += code;
#pragma unroll
              for (int c = 0; c < 4; ++c) y[g][c] += code * vi[c];
            } else {
              const float e = sc[g * SB + j];
              const float pb = __bfloat162float(__float2bfloat16(e));
              es[g] += e;
#pragma unroll
              for (int c = 0; c < 4; ++c) y[g][c] = fmaf(pb, vf[c], y[g][c]);
            }
          }
        }
        if (j1 == min(nk, (lp + 1) * ps)) {
          // page lp ends here: the sums over a warp's 4 key lanes, written
          // by lanes kq == 0 (every warp holds the exponential sums)
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
              for (int c = 0; c < 4; ++c) part[(lp * G + g) * D + col + c] = y[g][c];
              if (tid == 0) psum[lp][g] = es[g];
            }
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            es[g] = 0;
#pragma unroll
            for (int c = 0; c < 4; ++c) y[g][c] = 0;
          }
        }
        j0 = j1;
      }
      __syncthreads();  // every read of buffer i is done
      stage_v(nk, i + 2);
    }
    cp_async_wait<0>();

    // 4. this rank's 16 columns: the recurrence over every page of the
    // round in order, each page's partials from the rank that holds it
    cluster.sync();
    if (tid < G * 16) {
      for (int r = 0; r < C; ++r) {
        int q0, q1;
        run(k, r, q0, q1);
        const Acc* rp = cluster.map_shared_rank(part, r);
        const Acc* rs = cluster.map_shared_rank(&psum[0][0], r);
        for (int lp = 0; lp < q1 - q0; ++lp) {
          float esum, yv;
          if constexpr (kInt8) {
            esum = (float)rs[lp * G + og] * (1.f / 127.f);
            yv = (float)rp[(lp * G + og) * D + od] * (1.f / 127.f);
          } else {
            esum = rs[lp * G + og];
            yv = rp[(lp * G + og) * D + od];
          }
          const float m_cur = mr[q0 - k * C * P + lp][og];
          const float alpha = expf(m_run - m_cur);
          l_run = __fadd_rn(__fmul_rn(l_run, alpha), esum);
          acc = __fadd_rn(__fmul_rn(acc, alpha), yv);
          m_run = m_cur;
        }
      }
    }
  }

  if (tid < G * 16) {
    const float o = acc * (vs / fmaxf(l_run, 1e-30f));
    if (out_bf16 != nullptr)
      out_bf16[qoff + og * D + od] = __float2bfloat16(o);
    else
      out_f32[qoff + og * D + od] = o;
  }
  // no CTA leaves while another may read its shared memory
  cluster.sync();
}

// K15 (PoolPages)
template <typename CT, int G>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(NT, 2)
paged_cluster_kernel(const __nv_bfloat16* __restrict__ q, const CT* __restrict__ kp,
                     const CT* __restrict__ vp, const int* __restrict__ page_table,
                     const int* __restrict__ lengths, const float* __restrict__ kscale,
                     const float* __restrict__ vscale, float* __restrict__ out_f32,
                     __nv_bfloat16* __restrict__ out_bf16, int pmax, int ps, int KH) {
  cluster_attend<CT, G>(q, kp, vp, PoolPages{page_table, lengths, pmax, ps}, kscale, vscale,
                        out_f32, out_bf16, KH);
}

// K17 (SelectedBlocks): dense caches [B, S, KH * D], blocks of bs rows
template <typename CT, int G>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(NT, 2)
sparse_cluster_kernel(const __nv_bfloat16* __restrict__ q, const CT* __restrict__ kc,
                      const CT* __restrict__ vc, const int* __restrict__ sel,
                      const int* __restrict__ nvalid, const int* __restrict__ lengths,
                      const float* __restrict__ kscale, const float* __restrict__ vscale,
                      float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16,
                      int nsel, int S, int bs, int KH) {
  cluster_attend<CT, G>(q, kc, vc, SelectedBlocks{sel, nvalid, lengths, nsel, S, bs}, kscale,
                        vscale, out_f32, out_bf16, KH);
}

}  // namespace cluster_decode
