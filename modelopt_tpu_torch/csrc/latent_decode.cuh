// K5 decode_attention and K15 paged_decode_attention at MLA's geometry (one
// shared KV head, G <= 16 query rows, D a multiple of 128 up to 640, one
// int8 or e4m3 latent tensor as K and V), on the tensor cores, one
// thread-block cluster of up to C = 16 CTAs a slot that splits the slot's
// latent rows (decode_attention.cu routes those geometries here; see its
// header for the arithmetic, which is K5's unchanged).
//
// What bounds it on an H100: bytes, each live latent row read once (K = V),
// over the 3.35 TB/s of HBM; below ~1 MB a slot, the latency of the rounds
// (one load of a CTA's rows, three cluster barriers).
//
// The split. A slot's keys [0, L) fall in chunks (dense: 256-key chunks
// where they tile S, else one chunk of S; paged: one page a chunk), and a
// chunk in pieces of at most PK = 68 keys (a chunk of n keys in
// ceil(n / PK) balanced pieces), each inside one chunk. Rounds take whole
// chunks, at most C * SLOTS = 32 pieces a round (MAX_CHUNK = 2176 keys: a
// chunk always fits one round); rank r takes the round's pieces
// [n r / R, n (r + 1) / R), R = min(C, n), so at most SLOTS = 2. Every CTA
// reads its slot's length and works the same plan out, so the cluster
// agrees on it without a barrier. Per round:
//  1. each CTA stages its pieces' rows in shared memory once (cp.async,
//     16-byte chunks XOR-swizzled by row so that both loads below are free
//     of bank conflicts) and scores them on the tensor cores: mma.sync
//     m16n8k32 s8 x s8 -> s32, q's 16 rows the A operand (rows past G are
//     zero; its fragments prepared once in shared memory), each key row a
//     column of B read straight from the staged row (a lane's 16-byte load
//     feeds two k-steps; q's fragments hold the same columns in the same
//     order), D / 32 k-steps for 8 keys; the max of each piece per row;
//  2. cluster barrier; every CTA gathers all ranks' piece maxima over
//     distributed shared memory and forms the running max at each chunk of
//     the round, in chunk order from the running max the rounds before
//     left;
//  3. each CTA rounds its codes e8 = rint(exp(s - m_c) 127) against its
//     chunk's running max and forms its partials on the tensor cores from
//     the same staged rows: m16n8k32 with the codes as A [16 x keys] and
//     the rows as B, whose k-contiguous fragments a lane builds from four
//     32-bit loads of four rows by a 4 x 4 byte transpose (prmt); a warp
//     takes 64 columns. Pieces of one chunk sum in the same registers; each
//     chunk's s32 partial [16][D + 1] is written over its first piece's
//     staged rows (64 (D + 1) * 4 <= 68 D bytes), the sum of its codes per
//     row beside it;
//  4. cluster barrier; rank o owns columns [o D / C, (o + 1) D / C) and
//     replays the f32 recurrence over the round's chunks in order, each
//     chunk's partials summed exactly over the ranks that hold it (read over
//     distributed shared memory), then l = l alpha + esum / 127,
//     acc = acc alpha + y / 127, each product and sum rounded on its own;
//     a last cluster barrier before the rows are staged again (or the CTA
//     leaves) keeps every partial alive while an owner reads it.
//
// The e4m3 instance (E4) keeps the plan, the staged bytes, the exchanges
// and the replay, and runs the reference's e4m3 arithmetic in between:
//  1. scores by mma.sync m16n8k16 bf16 x bf16 -> f32, q's rows as they are
//     (bf16, not requantized) the A operand from shared memory, B built
//     from the staged bytes by a prmt and e4m3_cache_pair (e4m3.cuh: the
//     reference's decode, exact); the same 16-byte load a lane makes for
//     the int8 scores feeds four k-steps, q's fragments holding the same
//     columns in the same order; s = dot * (k_scale / sqrt(D)). A warp keeps
//     its 8-key tiles' scores in registers (shared memory has no room for
//     them beside q's bf16 fragments); the piece maxima go through a small
//     per-warp table. Step 3 scores the staged rows again (the same
//     products, so the same scores): held in registers over the exchange,
//     they made the D = 640 instance spill at its 96 registers a thread;
//  3. e = exp(s - m_c) in f32 against the chunk's running max, from the
//     registers: its f32 sum per row (lanes, then warps in order) is the
//     piece's esum, and e rounded to bf16 is written as PV's A operand for
//     one piece at a time; PV is m16n8k16 with B from four key rows'
//     bytes (4 tig + 0..3 of each 16-key step, so a lane's four 32-bit
//     loads are the int8 body's), two bytes put in place by a prmt and
//     decoded; partials are f32 [16][D + 1] over the first piece's rows;
//  4. the owner sums a chunk's f32 partials and esums over its ranks in
//     rank order, then l = l alpha + esum, acc = acc alpha + y.
// The f32 sums run in another order than the one-CTA body's (and than the
// plain version's), so the e4m3 instance is held to both within an order
// bar, not bit for bit; the rounding of e to bf16 against each chunk's
// running max, which decides PV's operands, is the reference's.
//
// One rank. Where the slot has at most one piece (L <= min(PK, chunk): the
// serving paths' short contexts), rank 0 does the whole slot with the same
// pieces (its piece's max is its chunk's running max, so max and codes take
// one pass) and writes the output straight from its PV registers (one
// chunk: one f32 update from acc = 0, l = 0), and ranks 1..C-1 return at
// once, before any cluster barrier or distributed shared memory access.
// The decision is the length's, the same in every CTA of the cluster, so no
// CTA that returned is ever waited for or read, and no barrier is left
// short. Nothing is decided on the host: no readback, and the launch stays
// capturable in a CUDA graph. Rank 0's first piece always starts at key 0,
// so its rows are in flight with q's before the length is read.
//
// Shared memory budget (D = 640; two CTAs an SM, so that 8 clusters of 16
// fit in one wave): staged rows 2 x 68 x 640 = 87,040 bytes (the partials
// overlay them). int8: q's fragments 16 x 640 = 10,240, scores 2 x 16 x
// 72 x 4 = 9,216, codes 2 x 16 x 112 = 3,584 (the gathered maxima and code
// sums overlay them); static: chunk maxima and code sums 2 x 32 x 16 x 4,
// piece maxima and sums, row scales, the piece and segment tables 5,008.
// 115,088 bytes of the 115,712 that each of two CTAs an SM may take. e4m3:
// q's bf16 fragments 16 x 640 x 2 = 20,480 and a 4,096-byte region that
// holds in turn the warps' piece maxima, the gathered maxima, one piece's
// bf16 e with the warps' esums, and the gathered esums with the chunk
// esums; static 2,896 (ptxas): 114,512 bytes (kernels/attention.py's
// latent_smem counts the dynamic part).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "e4m3.cuh"

namespace latent {

namespace cg = cooperative_groups;

constexpr int C = 16;                  // CTAs a cluster (non-portable)
constexpr int PK = 68;                 // keys a piece at most
constexpr int SLOTS = 2;               // pieces a CTA holds a round
constexpr int ROWS = SLOTS * PK;       // staged rows
constexpr int MAX_CHUNK = C * SLOTS * PK;  // the longest chunk taken (2176)
constexpr int GM = 16;                 // query rows: the MMA's m16
constexpr int SCW = 72;                // scores a (slot, row): 9 tiles of 8 keys
constexpr int KMAX = 96;               // codes a (slot, row): 3 k-steps of 32 keys
constexpr int CODEW = 112;             // their row stride in bytes (28 words: no bank conflicts)
constexpr int MAXP = C * SLOTS;        // pieces (and chunks) a round at most
constexpr int NTILE = 10;              // e4m3: 8-key tiles of e a piece (5 k-steps of 16 keys)
constexpr int EW = 40;                 // e4m3: words of a row of bf16 e (80 keys; 8 mod 32: no bank conflicts)
constexpr unsigned FULL = 0xffffffffu;

template <int DJ, bool E4>
struct Geo {
  static constexpr int D = 128 * DJ;
  static constexpr int NT = D / 2;         // threads: a warp takes 64 columns of PV
  static constexpr int NW = NT / 32;
  static constexpr int CH = D / 16;        // 16-byte chunks of a row
  static constexpr int PSTRIDE = D + 1;    // words of a held partial's row
  static constexpr int TPW = (NTILE + NW - 1) / NW;  // e4m3: tiles a warp scores a piece
  static constexpr int ROWS_B = ROWS * D;
  // q's A fragments: int8 D / 32 k-steps x 32 lanes x 16 bytes; bf16 twice that
  static constexpr int QF_B = (E4 ? 2 : 1) * GM * D;
  static constexpr int SC_B = 4 * SLOTS * GM * SCW;
  static constexpr int CODE_B = SLOTS * GM * CODEW;
  // e4m3: the region after q's fragments, in turn the warps' piece maxima
  // [SLOTS][NW][GM], the gathered maxima [MAXP][GM], one piece's e
  // [GM][EW] words with the warps' esums [NW][GM] at EBUF_B, and the
  // gathered esums with the chunk esums [MAXP][GM] at 4 MAXP GM
  static constexpr int EBUF_B = 4 * GM * EW;
  static constexpr int REG_B = 8 * MAXP * GM;
  static constexpr int SMEM = E4 ? ROWS_B + QF_B + REG_B : ROWS_B + QF_B + SC_B + CODE_B;
  static_assert(4 * GM * PSTRIDE <= PK * D, "a chunk's partial fits over its piece's rows");
  static_assert(4 * MAXP * GM <= CODE_B, "the gathered maxima fit over the codes");
  static_assert(4 * SLOTS * NW * GM <= EBUF_B && EBUF_B + 4 * NW * GM <= REG_B &&
                    4 * MAXP * GM <= EBUF_B,
                "e4m3: the region holds each phase's tables");
};

// 16-byte chunk `ch` of staged row `r`: swizzled within its group of 8 so
// that the score loads (rows 2m, 2m + 1 in one 8-lane phase) and the PV
// loads (rows 4 apart) meet distinct banks
__device__ __forceinline__ int swz(int r, int ch) {
  return ch ^ ((((r >> 2) & 3) << 1) ^ ((r & 1) << 2));
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

// c += a (16 x 32 s8, row) * b (32 x 8 s8, col), s32 sums; a = {a0, a1, a2, a3}
__device__ __forceinline__ void mma_s8(int (&c)[4], uint4 a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// c += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint4 a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even), x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The plan of a slot of L keys in chunks of `ch` keys (see the header)
struct Plan {
  int L, ch, nchunks, p_full, p_last, cpr, nrounds, total;
  __device__ Plan(int L_, int ch_) : L(L_), ch(ch_) {
    nchunks = (L + ch - 1) / ch;
    p_full = (ch + PK - 1) / PK;
    p_last = nchunks > 0 ? (L - (nchunks - 1) * ch + PK - 1) / PK : 0;
    cpr = MAXP / p_full;
    nrounds = (nchunks + cpr - 1) / cpr;
    total = nchunks > 0 ? (nchunks - 1) * p_full + p_last : 0;
  }
  // pieces of round k
  __device__ int pieces(int k) const {
    const int c1 = min(nchunks, (k + 1) * cpr);
    return (c1 - k * cpr - 1) * p_full + (c1 == nchunks ? p_last : p_full);
  }
  // piece q of round k: its chunk and keys [lo, hi)
  __device__ void piece(int k, int q, int& c, int& lo, int& hi) const {
    c = k * cpr + q / p_full;
    const int i = q % p_full, n = min(ch, L - c * ch), p = c == nchunks - 1 ? p_last : p_full;
    lo = c * ch + n * i / p;
    hi = c * ch + n * (i + 1) / p;
  }
};

// 4 x 4 byte transpose: out[t] holds byte t of w[0..3], in order
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&out)[4]) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140), x1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t y0 = __byte_perm(w[2], w[3], 0x5140), y1 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(x0, y0, 0x5410);
  out[1] = __byte_perm(x0, y0, 0x7632);
  out[2] = __byte_perm(x1, y1, 0x5410);
  out[3] = __byte_perm(x1, y1, 0x7632);
}

// q [B, 1, G, D] bf16; cache [B, S, D] (page_table null) or pool
// [n_pages, chunk, D] (page_table [B, pmax]) of int8 codes (E4: e4m3
// codes), read as K and V; out [B, 1, G, D]. S: the keys a slot may hold
// (paged: pmax * chunk).
template <int DJ, bool E4>
__global__ void __launch_bounds__(Geo<DJ, E4>::NT, 2)
latent_cluster_kernel(const __nv_bfloat16* __restrict__ q, const unsigned char* __restrict__ cache,
                      const int* __restrict__ lengths, const int* __restrict__ page_table,
                      const float* __restrict__ kscale, const float* __restrict__ vscale,
                      float* __restrict__ out_f32, __nv_bfloat16* __restrict__ out_bf16, int S,
                      int chunk, int pmax, int G) {
  using Gm = Geo<DJ, E4>;
  using Acc = std::conditional_t<E4, float, int>;  // PV partials and esums
  constexpr int D = Gm::D, NT = Gm::NT, NW = Gm::NW, CH = Gm::CH, PS = Gm::PSTRIDE;
  constexpr int TPW = Gm::TPW;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* rows = smem;                                                  // [ROWS][D]
  uint4* qf = reinterpret_cast<uint4*>(smem + Gm::ROWS_B);  // int8 [D/32][32]; e4m3 [D/64][4][32]
  unsigned char* reg = smem + Gm::ROWS_B + Gm::QF_B;
  float* sc = reinterpret_cast<float*>(reg);                         // int8: [SLOTS][GM][SCW]
  unsigned char* codes = reg + Gm::SC_B;                             // int8: [SLOTS][GM][CODEW]
  // the gathered maxima and esums [MAXP][GM]: int8 over the codes, e4m3 at
  // the region's start
  float* gath = reinterpret_cast<float*>(E4 ? reg : codes);
  float* wmax = reinterpret_cast<float*>(reg);                       // e4m3: [SLOTS][NW][GM]
  uint32_t* ebuf = reinterpret_cast<uint32_t*>(reg);                 // e4m3: [GM][EW]
  float* wsum = reinterpret_cast<float*>(reg + Gm::EBUF_B);          // e4m3: [NW][GM]
  __shared__ float pmx[SLOTS][GM];   // this CTA's piece maxima
  __shared__ Acc pes[SLOTS][GM];     // this CTA's esums (int8: sums of codes), by segment's first slot
  __shared__ float cmax[MAXP][GM];   // the running max at each chunk of the round
  __shared__ int ces_s[E4 ? 1 : MAXP][GM];  // int8: each chunk's sum of codes
  __shared__ float fsr[E4 ? 1 : GM];  // int8: score scale of each query row
  __shared__ float mprev[GM];        // the running max the rounds before left
  __shared__ Acc* segp[MAXP];        // each segment's partial (its rank's held slot)
  __shared__ int segc[MAXP];         // the chunk a segment ends, or -1
  __shared__ int nseg;               // segments in the round
  // each piece of the round: rank (bits 0-4), slot (5), chunk of the round
  // (6-11), first piece of its rank's segment (12), last of its chunk (13)
  __shared__ int pinf[MAXP];
  // each chunk's esum: e4m3 in the region, after the gathered esums
  Acc (*ces)[GM] = E4 ? reinterpret_cast<Acc (*)[GM]>(reg + 4 * MAXP * GM)
                      : reinterpret_cast<Acc (*)[GM]>(ces_s);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t qoff = (size_t)b * G * D;

  // a staged row's byte, swizzled; rows past the staging area read its last
  // row (their codes are 0)
  auto at = [&](int r, int byte) {
    r = min(r, ROWS - 1);
    return rows + r * D + swz(r, byte >> 4) * 16 + (byte & 15);
  };
  // rows [0, n) from src into slot s, one commit group
  auto stage = [&](int s, const unsigned char* src, int n) {
    for (int t = tid; t < n * CH; t += NT) {
      const int r = s * PK + t / CH, ch = t % CH;
      cp_async16(rows + r * D + swz(r, ch) * 16, src + (size_t)(t / CH) * D + ch * 16);
    }
    cp_async_commit();
  };
  // The slot's length and the scales first (the plan waits on the length);
  // rank 0's first piece is keys [0, n0) of chunk 0, n0 <= min(PK, chunk),
  // so its rows are in flight with warp w's rows w, w + NW, ... of q while
  // the length is read
  const int len = lengths[b];
  const float ks = kscale != nullptr ? *kscale : 1.f;
  const float vs = vscale != nullptr ? *vscale : 1.f;
  if (rank == 0) {
    const size_t row0 = page_table != nullptr ? (size_t)page_table[(size_t)b * pmax] * chunk
                                              : (size_t)b * S;
    stage(0, cache + row0 * D, min(PK, chunk));
  }
  constexpr int QR = (GM + NW - 1) / NW;
  uint2 qraw[E4 ? 1 : QR][DJ];
  if constexpr (!E4) {
#pragma unroll
    for (int u = 0; u < QR; ++u) {
      const int g = warp + u * NW;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        qraw[u][j] = g < G ? *reinterpret_cast<const uint2*>(q + qoff + g * D + 4 * (lane + 32 * j))
                           : make_uint2(0u, 0u);
    }
  }
  const Plan plan(max(min(len, S), 0), chunk);
  const bool solo = plan.total <= 1;
  if (solo && rank != 0) return;  // see the header: no CTA waits for or reads this one

  const float inv_sqrt_d = __fdiv_rn(ks, sqrtf((float)D));

  // round k's pieces of this CTA, their rows staged (a piece lies in one
  // chunk: one page; rank 0's first is in flight already), each slot one
  // commit group; in cluster mode, the round's piece and segment tables
  int n = 0, R = 1, nm = 0, pc[SLOTS], plo[SLOTS], pn[SLOTS];
  auto begin_round = [&](int k) {
    n = plan.pieces(k);
    R = min(C, n);
    const int q0 = rank < R ? n * rank / R : n, q1 = rank < R ? n * (rank + 1) / R : n;
    nm = q1 - q0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      pc[s] = -1 - s;
      plo[s] = pn[s] = 0;
      if (s < nm) {
        int hi;
        plan.piece(k, q0 + s, pc[s], plo[s], hi);
        pn[s] = hi - plo[s];
      }
      if (s < nm && !(k == 0 && s == 0 && rank == 0)) {
        const size_t r = page_table != nullptr
                             ? (size_t)page_table[(size_t)b * pmax + plo[s] / chunk] * chunk +
                                   plo[s] % chunk
                             : (size_t)b * S + plo[s];
        stage(s, cache + r * D, pn[s]);
      } else {
        cp_async_commit();  // an empty group: two a round
      }
    }
    // the last warp (it requantizes the fewest of q's rows), lane q: piece
    // q's rank, slot and chunk, and the round's segments (a rank's pieces
    // of one chunk) in order: a ballot in place of a walk with divisions
    if (!solo && warp == NW - 1) {
      int r = 0, sl = 0, c = 0;
      bool st = false, en = false;
      if (lane < n) {
        r = ((lane + 1) * R - 1) / n;
        sl = lane - n * r / R;
        c = lane / plan.p_full;
        st = sl == 0 || (lane - 1) / plan.p_full != c;
        en = lane == n - 1 || (lane + 1) / plan.p_full != c;
        pinf[lane] = r | sl << 5 | c << 6 | (int)st << 12 | (int)en << 13;
      }
      const unsigned starts = __ballot_sync(FULL, st), ends = __ballot_sync(FULL, en);
      if (st) {
        const unsigned later = starts & ~((2u << lane) - 1u);
        const int last = later != 0u ? __ffs(later) - 2 : n - 1;  // the segment's last piece
        const int idx = __popc(starts & ((1u << lane) - 1u));
        segp[idx] = reinterpret_cast<Acc*>(cluster.map_shared_rank(reinterpret_cast<int*>(rows), r)) +
                    sl * (PK * D / 4);
        segc[idx] = (ends >> last & 1u) ? c : -1;
      }
      if (lane == 0) nseg = __popc(starts);
    }
  };
  if (plan.nrounds > 0) begin_round(0);

  if constexpr (!E4) {
    // q rounded to bf16 (it is), requantized per row to int8 with
    // qmax = max|q_row|, into A fragments: step 2i + h, lane (gid, tig) holds
    // rows gid, gid + 8 at columns [64 i + 16 tig + 8 h, +8)
    uint32_t* qw = reinterpret_cast<uint32_t*>(qf);
#pragma unroll
    for (int u = 0; u < QR; ++u) {
      const int g = warp + u * NW;
      if (g >= GM) break;  // uniform over the warp
      const uint2* raw = qraw[u];
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw[j]);
#pragma unroll
        for (int c = 0; c < 4; ++c) a = fmaxf(a, fabsf(__bfloat162float(e[c])));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(FULL, a, off));
      const float qmax = fmaxf(a, 1e-30f);
      const float r = __fdiv_rn(127.f, qmax);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw[j]);
        uint32_t word = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int code = (int)rintf(__fmul_rn(__bfloat162float(e[c]), r));
          word |= (uint32_t)(code & 0xff) << (8 * c);
        }
        const int d = 4 * (lane + 32 * j);
        const int i = d >> 6, tg = (d >> 4) & 3, h = (d >> 3) & 1, w = (d >> 2) & 1;
        qw[((2 * i + h) * 32 + (g & 7) * 4 + tg) * 4 + 2 * w + (g >> 3)] = word;
      }
      if (lane == 0) {
        fsr[g] = __fmul_rn(qmax, __fdiv_rn(inv_sqrt_d, 127.f));
        mprev[g] = -1e30f;
      }
    }
  } else {
    // q's bf16 rows as A fragments: k-step 4 i + j, lane (gid, tig) holds
    // rows gid, gid + 8 at columns 64 i + 16 tig + 4 j + {0, 1} (a0, a1)
    // and + {2, 3} (a2, a3), the columns a score lane's staged bytes
    // 4 j .. 4 j + 3 give B; rows past G zero
    for (int e = tid; e < (D / 64) * 4 * 32; e += NT) {
      const int ln = e & 31, col = 64 * (e >> 7) + 16 * (ln & 3) + 4 * ((e >> 5) & 3);
      const int g = ln >> 2;
      const uint2 lo = g < G ? *reinterpret_cast<const uint2*>(q + qoff + g * D + col)
                             : make_uint2(0u, 0u);
      const uint2 hi = g + 8 < G ? *reinterpret_cast<const uint2*>(q + qoff + (g + 8) * D + col)
                                 : make_uint2(0u, 0u);
      qf[e] = make_uint4(lo.x, hi.x, lo.y, hi.y);
    }
    if (tid < GM) mprev[tid] = -1e30f;
  }

  // int8: scores of slot s's staged keys into sc[s][g][0, 72) (-1e30 past
  // the piece): warp w takes 8-key tiles w, w + NW, ...
  auto score = [&](int s) {
    const int nk = pn[s];
    for (int t = warp; t * 8 < nk; t += NW) {
      const int r = s * PK + t * 8 + gid;
      int c[4] = {0, 0, 0, 0}, c2[4] = {0, 0, 0, 0};  // two chains, summed exactly
#pragma unroll
      for (int i = 0; i < D / 64; ++i) {
        const uint4 kv = *reinterpret_cast<const uint4*>(at(r, 64 * i + 16 * tig));
        mma_s8(c, qf[(2 * i) * 32 + lane], kv.x, kv.y);
        mma_s8(c2, qf[(2 * i + 1) * 32 + lane], kv.z, kv.w);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] += c2[j];
      const int k0 = t * 8 + 2 * tig;  // c[0], c[1]: row gid, keys k0, k0 + 1; c[2], c[3]: row gid + 8
      float* s0 = sc + (s * GM + gid) * SCW;
      float* s1 = s0 + 8 * SCW;
      s0[k0] = k0 < nk ? __fmul_rn((float)c[0], fsr[gid]) : -1e30f;
      s0[k0 + 1] = k0 + 1 < nk ? __fmul_rn((float)c[1], fsr[gid]) : -1e30f;
      s1[k0] = k0 < nk ? __fmul_rn((float)c[2], fsr[gid + 8]) : -1e30f;
      s1[k0 + 1] = k0 + 1 < nk ? __fmul_rn((float)c[3], fsr[gid + 8]) : -1e30f;
    }
  };
  // e4m3: scores of slot s's staged keys, this warp's tiles warp + i NW
  // (i < TPW) into registers: scr[s][i][0, 1] row gid, keys 8 t + 2 tig
  // + {0, 1}; [2, 3] row gid + 8; -1e30 past the piece
  float scr[SLOTS][E4 ? TPW : 1][4];
  auto score_e4 = [&](int s) {
    const int nk = pn[s];
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int t = warp + i * NW;
      float c[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};  // two chains
      if (t * 8 < nk) {  // uniform over the warp
        const int r = s * PK + t * 8 + gid;
#pragma unroll
        for (int i2 = 0; i2 < D / 64; ++i2) {
          const uint4 kv = *reinterpret_cast<const uint4*>(at(r, 64 * i2 + 16 * tig));
          const uint4* qa = qf + i2 * 128 + lane;
          mma_bf16(c, qa[0], e4m3_cache_pair(__byte_perm(kv.x, 0u, 0x1100)),
                   e4m3_cache_pair(__byte_perm(kv.x, 0u, 0x3322)));
          mma_bf16(c2, qa[32], e4m3_cache_pair(__byte_perm(kv.y, 0u, 0x1100)),
                   e4m3_cache_pair(__byte_perm(kv.y, 0u, 0x3322)));
          mma_bf16(c, qa[64], e4m3_cache_pair(__byte_perm(kv.z, 0u, 0x1100)),
                   e4m3_cache_pair(__byte_perm(kv.z, 0u, 0x3322)));
          mma_bf16(c2, qa[96], e4m3_cache_pair(__byte_perm(kv.w, 0u, 0x1100)),
                   e4m3_cache_pair(__byte_perm(kv.w, 0u, 0x3322)));
        }
      }
      const int k0 = t * 8 + 2 * tig;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        scr[s][i][j] = k0 + (j & 1) < nk ? __fmul_rn(__fadd_rn(c[j], c2[j]), inv_sqrt_d) : -1e30f;
    }
  };
  // e4m3: this warp's max of slot s's scores of rows gid and gid + 8 into
  // wmax[s][warp][row]
  auto warp_max_e4 = [&](int s) {
    float m0 = -1e30f, m1 = -1e30f;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      m0 = fmaxf(m0, fmaxf(scr[s][i][0], scr[s][i][1]));
      m1 = fmaxf(m1, fmaxf(scr[s][i][2], scr[s][i][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(FULL, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(FULL, m1, off));
    }
    if (tig == 0) {
      wmax[(s * NW + warp) * GM + gid] = m0;
      wmax[(s * NW + warp) * GM + gid + 8] = m1;
    }
  };
  // e4m3: slot s's e = exp(s - m) against the running max m of its chunk
  // (0 past the piece), rounded to bf16 into ebuf (rows gid, gid + 8; the
  // 80 keys of PV's five k-steps), and this warp's f32 sums of e of each
  // row into wsum[warp][row]: a lane's in tile order, then over its row's
  // four lanes
  auto codes_e4 = [&](int s, float mlo, float mhi) {
    const int nk = pn[s];
    float e0 = 0.f, e1 = 0.f;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int t = warp + i * NW;
      if (t >= NTILE) break;  // uniform over the warp
      const int k0 = t * 8 + 2 * tig;
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[j] = k0 + (j & 1) < nk ? expf(__fsub_rn(scr[s][i][j], j < 2 ? mlo : mhi)) : 0.f;
      e0 = __fadd_rn(__fadd_rn(e0, e[0]), e[1]);
      e1 = __fadd_rn(__fadd_rn(e1, e[2]), e[3]);
      ebuf[gid * EW + 4 * t + tig] = pack_bf16(e[0], e[1]);
      ebuf[(gid + 8) * EW + 4 * t + tig] = pack_bf16(e[2], e[3]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      e0 = __fadd_rn(e0, __shfl_xor_sync(FULL, e0, off));
      e1 = __fadd_rn(e1, __shfl_xor_sync(FULL, e1, off));
    }
    if (tig == 0) {
      wsum[warp * GM + gid] = e0;
      wsum[warp * GM + gid + 8] = e1;
    }
  };
  // row g of slot s: its codes against the running max m (0 past the
  // piece, to the end of its last k-step) and their sum, by the W lanes
  // (32 or 16, aligned) of one warp that hold the row
  auto round_codes = [&](int s, int g, float m, int W) {
    int es = 0;
    for (int kk = lane & (W - 1); kk < KMAX; kk += W) {
      int code = 0;
      if (kk < pn[s]) {
        const float e = expf(__fsub_rn(sc[(s * GM + g) * SCW + kk], m));
        code = (int)rintf(__fmul_rn(e, 127.f));
      }
      codes[(s * GM + g) * CODEW + kk] = (unsigned char)code;
      es += code;
    }
    for (int off = W / 2; off > 0; off >>= 1) es += __shfl_xor_sync(FULL, es, off);
    if ((lane & (W - 1)) == 0) pes[s][g] = (Acc)es;
  };
  // the max of slot s's scores of row g, by W lanes as above
  auto piece_max = [&](int s, int g, int W) {
    float m = -1e30f;
    for (int kk = lane & (W - 1); kk < pn[s]; kk += W) m = fmaxf(m, sc[(s * GM + g) * SCW + kk]);
    for (int off = W / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    return m;
  };
  Acc acc[2][4][4];  // PV: [32-column group][n-tile][fragment]
  auto zero_acc = [&]() {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[u][t][c] = (Acc)0;
  };
  // acc += slot s's codes (A) x its staged rows (B); warp w takes columns
  // [64 w, 64 w + 64), column 64 w + 32 u + 4 gid + t of n-tile t. e4m3:
  // A is the bf16 e of ebuf, a 16-key step's k-slots 2 tig, 2 tig + 1,
  // 2 tig + 8, 2 tig + 9 the keys 4 tig + 0..3, whose rows a lane reads
  auto pv = [&](int s) {
    if constexpr (E4) {
      for (int kb = 0; kb < pn[s]; kb += 16) {
        const uint2 r0w = *reinterpret_cast<const uint2*>(ebuf + gid * EW + kb / 2 + 2 * tig);
        const uint2 r1w = *reinterpret_cast<const uint2*>(ebuf + (gid + 8) * EW + kb / 2 + 2 * tig);
        const uint4 a = make_uint4(r0w.x, r1w.x, r0w.y, r1w.y);
        const int r0 = s * PK + kb + 4 * tig;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int byte = 64 * warp + 32 * u + 4 * gid;
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(at(r0 + i, byte));
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            // byte t of rows 4 tig, 4 tig + 1 (b0) and 4 tig + 2, 4 tig + 3 (b1)
            // into bytes 1 and 3
            const uint32_t sel = t | t << 4 | (4 + t) << 8 | (4 + t) << 12;
            mma_bf16(acc[u][t], a, e4m3_cache_pair(__byte_perm(w[0], w[1], sel)),
                     e4m3_cache_pair(__byte_perm(w[2], w[3], sel)));
          }
        }
      }
    } else {
      const unsigned char* cs = codes + s * GM * CODEW;
      for (int k0 = 0; k0 < pn[s]; k0 += 32) {
        uint4 a;
        a.x = *reinterpret_cast<const uint32_t*>(cs + gid * CODEW + k0 + 4 * tig);
        a.y = *reinterpret_cast<const uint32_t*>(cs + (gid + 8) * CODEW + k0 + 4 * tig);
        a.z = *reinterpret_cast<const uint32_t*>(cs + gid * CODEW + k0 + 16 + 4 * tig);
        a.w = *reinterpret_cast<const uint32_t*>(cs + (gid + 8) * CODEW + k0 + 16 + 4 * tig);
        const int r0 = s * PK + k0 + 4 * tig;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int byte = 64 * warp + 32 * u + 4 * gid;  // columns [byte, +4) of 4 rows
          uint32_t w[4], b0[4], b1[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(at(r0 + i, byte));
          transpose4(w, b0);
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(at(r0 + 16 + i, byte));
          transpose4(w, b1);
#pragma unroll
          for (int t = 0; t < 4; ++t) mma_s8(acc[u][t], a, b0[t], b1[t]);
        }
      }
    }
  };
  // e4m3: the piece maxima of slots [0, ns) from the warps' table
  auto piece_max_e4 = [&](int ns) {
    if (tid < ns * GM) {
      const int s = tid / GM, g = tid % GM;
      float m = -1e30f;
      for (int w = 0; w < NW; ++w) m = fmaxf(m, wmax[(s * NW + w) * GM + g]);
      pmx[s][g] = m;
    }
  };
  // e4m3: slot s's esum of each row, the warps' sums in order
  auto piece_sum_e4 = [&](int s) {
    if (tid < GM) {
      float e = 0.f;
      for (int w = 0; w < NW; ++w) e = __fadd_rn(e, wsum[w * GM + tid]);
      pes[s][tid] = (Acc)e;
    }
  };
  // y = the partial as a value: int8's sums of codes times 1/127
  auto value = [](Acc t) {
    if constexpr (E4)
      return t;
    else
      return __fmul_rn((float)t, 1.f / 127.f);
  };

  __syncthreads();  // q's fragments and scales
  if (solo) {
    // at most one piece: its max is its chunk's running max (from -1e30),
    // and the output is written straight from the PV registers
    cp_async_wait<0>();
    if (plan.nrounds == 0) {  // no key: l = 0, out 0
      const float o = __fmul_rn(0.f, __fdiv_rn(vs, 1e-30f));
      for (int i = tid; i < G * D; i += NT) {
        if (out_bf16 == nullptr)
          out_f32[qoff + i] = o;
        else
          out_bf16[qoff + i] = __float2bfloat16(o);
      }
      return;
    }
    __syncthreads();
    if constexpr (E4) {
      score_e4(0);
      warp_max_e4(0);
      __syncthreads();
      piece_max_e4(1);
      __syncthreads();
      codes_e4(0, pmx[0][gid], pmx[0][gid + 8]);
      __syncthreads();
      piece_sum_e4(0);
      __syncthreads();
    } else {
      score(0);
      __syncthreads();
      for (int g = 2 * warp + (lane >> 4); g < GM; g += 2 * NW) {  // a half-warp a row
        const float m = piece_max(0, g, 16);
        round_codes(0, g, m, 16);
        if ((lane & 15) == 0) pmx[0][g] = m;
      }
      __syncthreads();
    }
    zero_acc();
    pv(0);
    // one f32 update from acc = 0, l = 0 a value; a thread's 8 consecutive
    // columns of a row go out in one 16-byte store (bf16) or two (f32)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = gid + 8 * h;
      if (g >= G) continue;
      const float alpha = expf(__fsub_rn(-1e30f, pmx[0][g]));
      const float es = E4 ? (float)pes[0][g] : __fmul_rn((float)pes[0][g], 1.f / 127.f);
      const float l = __fadd_rn(__fmul_rn(0.f, alpha), es);
      const float ratio = __fdiv_rn(vs, fmaxf(l, 1e-30f));
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float o[8];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y = value(acc[u][t][2 * h + e]);
            o[4 * e + t] = __fmul_rn(__fadd_rn(__fmul_rn(0.f, alpha), y), ratio);
          }
        const size_t at_o = qoff + g * D + 64 * warp + 32 * u + 8 * tig;
        if (out_bf16 == nullptr) {
          reinterpret_cast<float4*>(out_f32 + at_o)[0] = make_float4(o[0], o[1], o[2], o[3]);
          reinterpret_cast<float4*>(out_f32 + at_o)[1] = make_float4(o[4], o[5], o[6], o[7]);
        } else {
          uint4 w;
          uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            __nv_bfloat162 v = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
            wp[i] = *reinterpret_cast<uint32_t*>(&v);
          }
          *reinterpret_cast<uint4*>(out_bf16 + at_o) = w;
        }
      }
    }
    return;
  }

  // the owner's recurrence state: rank o's columns [o D / C, (o + 1) D / C)
  constexpr int PER = 2;  // (row, column) pairs a thread owns: GM * (D / C) / NT
  static_assert(GM * (D / C) == PER * NT, "two owned pairs a thread");
  float m_run[PER], l_run[PER], acc_o[PER];
  int og[PER], od[PER];  // the pairs: row og, column od
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    m_run[p] = -1e30f;
    l_run[p] = 0.f;
    acc_o[p] = 0.f;
    og[p] = (tid + p * NT) / (D / C);
    od[p] = rank * (D / C) + (tid + p * NT) % (D / C);
  }
  // this segment's partial [GM][PS] (s32; e4m3 f32) over the rows of slot j
  auto flush = [&](int j) {
    Acc* part = reinterpret_cast<Acc*>(rows + j * PK * D);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = 64 * warp + 32 * u + 8 * tig + t;
        part[gid * PS + col] = acc[u][t][0];
        part[gid * PS + col + 4] = acc[u][t][1];
        part[(gid + 8) * PS + col] = acc[u][t][2];
        part[(gid + 8) * PS + col + 4] = acc[u][t][3];
      }
    zero_acc();
  };

  for (int k = 0; k < plan.nrounds; ++k) {
    if (k > 0) begin_round(k);
    const bool merged = nm == 2 && pc[0] == pc[1];

    // 1. score each slot's staged rows as they land, then each piece's max
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if (s == 0)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      if constexpr (E4) {
        score_e4(s);
        warp_max_e4(s);
      } else {
        score(s);
      }
    }
    __syncthreads();
    if constexpr (E4) {
      piece_max_e4(SLOTS);
    } else {
      for (int i = warp; i < SLOTS * GM; i += NW) {
        const float m = piece_max(i / GM, i % GM, 32);
        if (lane == 0) pmx[i / GM][i % GM] = m;
      }
    }

    // 2. every piece's max, then the running max at each chunk of the round
    cluster.sync();
    for (int i = tid; i < n * GM; i += NT) {
      const int pq = i / GM, g = i % GM, inf = pinf[pq];
      gath[pq * GM + g] = cluster.map_shared_rank(&pmx[0][0], inf & 31)[(inf >> 5 & 1) * GM + g];
    }
    __syncthreads();
    if (tid < GM) {
      float m = mprev[tid];
      for (int pq = 0; pq < n; ++pq) {
        const int inf = pinf[pq];
        m = fmaxf(m, gath[pq * GM + tid]);
        if (inf >> 13 & 1) cmax[inf >> 6 & 63][tid] = m;
      }
      mprev[tid] = m;
    }
    __syncthreads();

    // 3. codes against the chunk's running max, each row's sum of them;
    // then the partials, a chunk's pieces summed in the same registers
    if constexpr (E4) {
      // one piece at a time through ebuf
      zero_acc();
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        if (s < nm) {  // uniform over the block
          if (s == 1) __syncthreads();  // every warp's PV of slot 0 has read ebuf
          const int cc = pc[s] - k * plan.cpr;
          score_e4(s);  // again: scores held over the exchange would spill (96 registers)
          codes_e4(s, cmax[cc][gid], cmax[cc][gid + 8]);
          __syncthreads();
          piece_sum_e4(s);
          if (s == 1 && !merged) flush(0);  // a new chunk: slot 0's partial goes over its rows
          pv(s);
        }
      }
      if (nm > 0) {
        __syncthreads();
        flush(nm == 2 && !merged ? 1 : 0);
      }
      if (merged && tid < GM) pes[0][tid] = __fadd_rn(pes[0][tid], pes[1][tid]);
    } else {
      for (int i = warp; i < SLOTS * GM; i += NW) {
        const int s = i / GM, g = i % GM;
        if (s < nm) round_codes(s, g, cmax[pc[s] - k * plan.cpr][g], 32);  // uniform over the warp
      }
      __syncthreads();
      if (merged && tid < GM) pes[0][tid] += pes[1][tid];
      zero_acc();
      for (int s = 0; s < nm; ++s) {
        if (s == 1 && !merged) {  // a new chunk: slot 0's partial goes over its rows
          __syncthreads();
          flush(0);
        }
        pv(s);
      }
      if (nm > 0) {
        __syncthreads();
        flush(nm == 2 && !merged ? 1 : 0);
      }
    }

    // 4. each chunk's sum of codes (e4m3: esum), then the owner's
    // recurrence over the round's chunks in order
    cluster.sync();
    Acc* gsum = reinterpret_cast<Acc*>(gath);
    for (int i = tid; i < n * GM; i += NT) {
      const int pq = i / GM, g = i % GM, inf = pinf[pq];
      gsum[pq * GM + g] =
          inf >> 12 & 1 ? cluster.map_shared_rank(&pes[0][0], inf & 31)[(inf >> 5 & 1) * GM + g]
                        : (Acc)0;
    }
    __syncthreads();
    if (tid < GM) {
      Acc e = 0;
      for (int pq = 0; pq < n; ++pq) {
        const int inf = pinf[pq];
        e += gsum[pq * GM + tid];
        if (inf >> 13 & 1) {
          ces[inf >> 6 & 63][tid] = e;
          e = 0;
        }
      }
    }
    __syncthreads();
    // this thread's (row, column) pairs: each segment's partial read over
    // distributed shared memory (8 in flight), a chunk's summed, then one
    // f32 update a chunk
    {
      Acc t[PER];
#pragma unroll
      for (int p = 0; p < PER; ++p) t[p] = 0;
      const int ns = nseg;
      for (int i0 = 0; i0 < ns; i0 += 8) {
        Acc v[8][PER];
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int p = 0; p < PER; ++p)
            v[u][p] = i0 + u < ns && og[p] < G ? segp[i0 + u][og[p] * PS + od[p]] : (Acc)0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (i0 + u >= ns) break;
          const int cc = segc[i0 + u];
#pragma unroll
          for (int p = 0; p < PER; ++p) {
            t[p] += v[u][p];
            if (cc >= 0) {
              const float y = value(t[p]);
              const float es = value(ces[cc][og[p]]);
              const float mc = cmax[cc][og[p]];
              const float alpha = expf(__fsub_rn(m_run[p], mc));
              l_run[p] = __fadd_rn(__fmul_rn(l_run[p], alpha), es);
              acc_o[p] = __fadd_rn(__fmul_rn(acc_o[p], alpha), y);
              m_run[p] = mc;
              t[p] = 0;
            }
          }
        }
      }
    }
    cluster.sync();  // every read of this round's partials is done
  }

#pragma unroll
  for (int p = 0; p < PER; ++p) {
    if (og[p] >= G) continue;
    const float o = __fmul_rn(acc_o[p], __fdiv_rn(vs, fmaxf(l_run[p], 1e-30f)));
    if (out_bf16 != nullptr)
      out_bf16[qoff + og[p] * D + od[p]] = __float2bfloat16(o);
    else
      out_f32[qoff + og[p] * D + od[p]] = o;
  }
}

// the dynamic shared memory limit and the cluster size of 16, raised once
// per device
template <typename F>
int allow(F* kernel, int bytes, unsigned& done_devices) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 32 && (done_devices >> dev & 1u)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  if (dev < 32) done_devices |= 1u << dev;
  return 0;
}

template <int DJ, bool E4>
int launch(const __nv_bfloat16* q, const unsigned char* cache, const int* lengths,
           const int* page_table, const float* ks, const float* vs, float* of,
           __nv_bfloat16* ob, int B, int S, int chunk, int pmax, int G, cudaStream_t s) {
  using Gm = Geo<DJ, E4>;
  static unsigned done = 0;
  const int err = allow(latent_cluster_kernel<DJ, E4>, Gm::SMEM, done);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C, 1, 1);
  cfg.blockDim = dim3(Gm::NT, 1, 1);
  cfg.dynamicSmemBytes = Gm::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, latent_cluster_kernel<DJ, E4>, q, cache, lengths,
                                 page_table, ks, vs, of, ob, S, chunk, pmax, G);
}

}  // namespace latent
