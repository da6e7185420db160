// One tensor-core flash-attention tile for Hopper (sm_90a), shared by K4
// (csrc/flash_prefill_attention.cu) and K14's bf16 branch
// (csrc/flash_attention.cu).
//
// A CTA of 4 warps owns 64 flattened query rows (t, g) of one (slot, KV
// head); each warp owns 16 rows, so grouped-query heads share every K/V
// tile. Q is copied once with cp.async into XOR-swizzled shared memory and
// kept as bf16 A-fragments in registers (ldmatrix). K and V come in 64-key
// bf16 tiles, double-buffered in swizzled shared memory (16-byte chunks,
// chunk ^ (row & 7): no padding, no ldmatrix bank conflict): a bf16 cache
// streams in with cp.async.cg while the previous tile is computed; int8 and
// e4m3 codes are loaded 16 bytes a thread into registers one tile ahead and
// dequantized into the other buffer after the tile's products, one barrier
// a tile either way.
//
// S = Q K^T and O += P V run on mma.sync.m16n8k16 bf16 with f32 sums: bf16
// products are exact in f32, so only the order of the f32 sums differs from
// a one-pass reference. The score accumulator fragment is the PV product's
// A operand (rows g and g + 8 of the warp, quad-shared), so the online
// softmax stays in registers: row max and row sum by quad shuffles, the
// row sum kept per thread and reduced once at the end; exp(s - m) is taken
// in f32 as exp2(s * log2(e) - m * log2(e)) (one FMA and ex2, within
// 2^-19 relative of expf at these scores). Only tiles that reach past a
// row's position (or the keys) are masked. P enters PV as bf16
// (K4, as the reference) or split as hi = bf16(p), lo = bf16(p - hi) in two
// products (K14: p kept to ~2^-17 relative, for the reference's f32
// probabilities). The epilogue divides by max(l, 1e-30) and writes 16-byte
// rows through shared memory.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>
#include <type_traits>

namespace flash_tile {

constexpr int BQ = 64;   // query rows a CTA owns (16 a warp)
constexpr int BK = 64;   // keys a K / V tile holds
constexpr int NT = 128;  // threads a CTA: 4 warps
constexpr float LOG2E = 1.4426950408889634f;

enum Kind { KV_BF16 = 0, KV_INT8 = 1, KV_E4M3 = 2 };

// Q tile plus two stages of K and V tiles, all bf16. The epilogue's staging
// (16 rows of D + 8 f32 a warp) reuses it.
template <int D>
constexpr int smem_bytes() {
  return (BQ * D + 2 * 2 * BK * D) * 2;
}

extern __shared__ __align__(16) unsigned char flash_smem[];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src must still be valid)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even), x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// element offset of 16-byte chunk `chunk` of row `row` in a [rows][D] bf16 tile
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// 8 codes (two words) -> 8 bf16 of (code as f32) * scale, each rounded once
template <int KIND>
__device__ __forceinline__ uint4 dequant8(uint32_t w0, uint32_t w1, float scale) {
  float f[8];
  if constexpr (KIND == KV_INT8) {
    // (float)code exactly: the biased byte in the mantissa of 2^23, minus 2^23 + 128
    const uint32_t x0 = w0 ^ 0x80808080u, x1 = w1 ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = __uint_as_float(__byte_perm(x0, 0x4B000000u, 0x7650 + i)) - 8388736.f;
      f[4 + i] = __uint_as_float(__byte_perm(x1, 0x4B000000u, 0x7650 + i)) - 8388736.f;
    }
  } else {
    // the hardware e4m3 -> f16 cvt (as static_cast<float> of __nv_fp8_e4m3),
    // exact in f32
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w = i < 2 ? w0 : w1;
      const __nv_fp8x2_storage_t pair =
          static_cast<__nv_fp8x2_storage_t>((w >> (16 * (i & 1))) & 0xffffu);
      const __half2 h = __half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3));
      const float2 v = __half22float2(h);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  uint4 r;
  r.x = pack_bf16(f[0] * scale, f[1] * scale);
  r.y = pack_bf16(f[2] * scale, f[3] * scale);
  r.z = pack_bf16(f[4] * scale, f[5] * scale);
  r.w = pack_bf16(f[6] * scale, f[7] * scale);
  return r;
}

// K4's rule: query row r sits at absolute position start + r / G and
// attends the keys up to it that lie in the cache (key < S).
struct PrefillMask {
  int S;
  __device__ int last_key(int qmax) const { return min(qmax, S - 1); }
  __device__ int next_tile(int j) const { return j + 1; }
  // may a key of tile k0 be invalid for a row of positions [qmin, qmax]?
  __device__ bool tile_masked(int k0, int qmin, int) const {
    return k0 + BK - 1 > qmin || k0 + BK > S;
  }
  __device__ bool valid(int key, int qpos) const { return key <= qpos && key < S; }
};

// K14's rule: causal (key <= qpos), and with a window (window >= 0) a key
// also needs key > qpos - window or key < sink. Tiles that lie wholly
// before every row's window and past the sinks are skipped when each row
// keeps a valid key (its own position) in a tile that is visited.
struct CausalMask {
  int S, causal, window, sink;
  int skip_lo, skip_hi;  // skipped tiles [skip_lo, skip_hi] (empty if lo > hi)

  __device__ CausalMask(int S_, int causal_, int window_, int sink_, int qmin, int qmax)
      : S(S_), causal(causal_), window(window_), sink(sink_), skip_lo(1), skip_hi(0) {
    if (window >= 1 && qmax < S && qmin - window + 1 >= BK) {
      skip_lo = (sink + BK - 1) / BK;
      skip_hi = (qmin - window + 1) / BK - 1;
    }
  }
  __device__ int last_key(int qmax) const { return causal ? min(qmax, S - 1) : S - 1; }
  __device__ int next_tile(int j) const {
    ++j;
    return (j >= skip_lo && j <= skip_hi) ? skip_hi + 1 : j;
  }
  __device__ bool tile_masked(int k0, int qmin, int qmax) const {
    if (k0 + BK > S || (causal && k0 + BK - 1 > qmin)) return true;
    return window >= 0 && max(k0, sink) <= min(k0 + BK - 1, qmax - window);
  }
  __device__ bool valid(int key, int qpos) const {
    bool ok = key < S && (!causal || key <= qpos);
    if (window >= 0) ok = ok && (key > qpos - window || key < sink);
    return ok;
  }
};

struct Args {
  const __nv_bfloat16* q;  // [B, T, KH, G, D]
  const void* k;           // [B, S, KH * D]: bf16, int8 or e4m3
  const void* v;
  void* out;               // q's layout, bf16 or f32
  float kscale, vscale;    // codes only
  int T, S, KH, G;
  float sm_scale;
};

// One CTA: query rows [r0, r0 + 64) of (slot b, KV head h), the row at
// position pos0 + r / G, against the keys `mask` lets it see.
template <int D, int KIND, bool SPLIT_P, bool OUT_F32, class Mask>
__device__ __forceinline__ void attend(const Args& a, int b, int h, int r0, int pos0,
                                       const Mask& mask) {
  constexpr int CH = D / 8;                 // 16-byte chunks of a bf16 row
  constexpr int KD = D / 16;                // k-steps of Q K^T
  constexpr int CC = D / 16;                // 16-byte chunks of a code row
  constexpr int NC = BK * CC / NT;          // code chunks a thread loads per tensor
  static_assert(KIND == KV_BF16 || NC >= 1, "tile too small for the code loader");
  using OT = typename std::conditional<OUT_F32, float, __nv_bfloat16>::type;

  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  __nv_bfloat16* KV = Qs + BQ * D;  // [stage][K, V][BK][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.G, S = a.S;
  const int rows = a.T * G;
  const int KHD = a.KH * D;
  const size_t kvbase = (size_t)b * S * KHD + (size_t)h * D;
  auto row_off = [&](int r) {  // element offset of query row r in q / out
    return (((size_t)b * a.T + r / G) * a.KH + h) * (size_t)G * D + (size_t)(r % G) * D;
  };

  // Q tile, then the first K / V tile
  for (int c = tid; c < BQ * CH; c += NT) {
    const int i = c / CH, ch = c % CH, r = r0 + i;
    const bool ok = r < rows;
    cp_async16(smem_u32(Qs + swz<D>(i, ch)), ok ? a.q + row_off(r) + ch * 8 : a.q, ok);
  }

  uint4 kr[KIND == KV_BF16 ? 1 : NC], vr[KIND == KV_BF16 ? 1 : NC];
  auto issue_bf16 = [&](int j, int st) {
    const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + kvbase;
    const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + kvbase;
    __nv_bfloat16* Ks = KV + (2 * st) * BK * D;
    __nv_bfloat16* Vs = Ks + BK * D;
#pragma unroll
    for (int u = 0; u < BK * CH / NT; ++u) {
      const int c = tid + u * NT, i = c / CH, ch = c % CH, key = j * BK + i;
      const bool ok = key < S;
      const size_t off = ok ? (size_t)key * KHD + ch * 8 : 0;
      cp_async16(smem_u32(Ks + swz<D>(i, ch)), kg + off, ok);
      cp_async16(smem_u32(Vs + swz<D>(i, ch)), vg + off, ok);
    }
  };
  auto load_codes = [&](int j) {
    const uint8_t* kg = static_cast<const uint8_t*>(a.k) + kvbase;
    const uint8_t* vg = static_cast<const uint8_t*>(a.v) + kvbase;
#pragma unroll
    for (int u = 0; u < (KIND == KV_BF16 ? 1 : NC); ++u) {
      const int c = tid + u * NT, i = c / CC, cc = c % CC, key = j * BK + i;
      if (key < S) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kg + (size_t)key * KHD + cc * 16));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vg + (size_t)key * KHD + cc * 16));
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  auto store_codes = [&](int st) {
    __nv_bfloat16* Ks = KV + (2 * st) * BK * D;
    __nv_bfloat16* Vs = Ks + BK * D;
#pragma unroll
    for (int u = 0; u < (KIND == KV_BF16 ? 1 : NC); ++u) {
      const int c = tid + u * NT, i = c / CC, cc = c % CC;
      *reinterpret_cast<uint4*>(Ks + swz<D>(i, 2 * cc)) = dequant8<KIND>(kr[u].x, kr[u].y, a.kscale);
      *reinterpret_cast<uint4*>(Ks + swz<D>(i, 2 * cc + 1)) = dequant8<KIND>(kr[u].z, kr[u].w, a.kscale);
      *reinterpret_cast<uint4*>(Vs + swz<D>(i, 2 * cc)) = dequant8<KIND>(vr[u].x, vr[u].y, a.vscale);
      *reinterpret_cast<uint4*>(Vs + swz<D>(i, 2 * cc + 1)) = dequant8<KIND>(vr[u].z, vr[u].w, a.vscale);
    }
  };

  const int rlast = min(r0 + BQ, rows) - 1;
  const int jlast = mask.last_key(pos0 + rlast / G) / BK;
  int j = mask.next_tile(-1);
  if constexpr (KIND == KV_BF16) {
    issue_bf16(j, 0);
    cp_async_commit();
  } else {
    cp_async_commit();
    load_codes(j);
    store_codes(0);
  }
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 Q rows as A fragments, all of D
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldsm_x4(smem_u32(Qs + swz<D>(warp * 16 + (lane & 15), 2 * kd + (lane >> 4))), qf[kd]);

  // rows g and g + 8 of the warp's 16 (the fragments' row layout)
  const int ra = r0 + warp * 16 + (lane >> 2);
  const int qpos[2] = {pos0 + ra / G, pos0 + (ra + 8) / G};
  const int qmin = pos0 + (r0 + warp * 16) / G, qmax = pos0 + (r0 + warp * 16 + 15) / G;
  const int kq = (lane & 3) * 2;  // this thread's first column in an 8-column tile

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float mrow[2] = {-1e30f, -1e30f}, lrow[2] = {0.f, 0.f};

  int st = 0;
  while (j <= jlast) {
    const int jn = mask.next_tile(j);
    const bool more = jn <= jlast;
    if constexpr (KIND == KV_BF16) {
      if (more) issue_bf16(jn, st ^ 1);
      cp_async_commit();
    } else {
      if (more) load_codes(jn);
    }
    const __nv_bfloat16* Ks = KV + (2 * st) * BK * D;
    const __nv_bfloat16* Vs = Ks + BK * D;
    const int k0 = j * BK;

    // S = Q K^T: 8 key tiles of 8 columns
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_x4(smem_u32(Ks + swz<D>(np * 16 + ((lane >> 4) << 3) + (lane & 7),
                                     2 * kd + ((lane >> 3) & 1))), kb);
        mma_bf16(s[2 * np], qf[kd], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kd], kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], a.sm_scale);
    if (mask.tile_masked(k0, qmin, qmax)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!mask.valid(k0 + n * 8 + kq + (e & 1), qpos[e >> 1])) s[n][e] = -1e9f;
    }

    // online softmax over the tile, in registers (a row lives in one quad)
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    // exp(x - m) as exp2(x * log2(e) - m * log2(e)): one FMA and ex2 a score
    float alpha[2], mlog2[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f((mrow[i] - mx[i]) * LOG2E);
      mrow[i] = mx[i];
      mlog2[i] = mx[i] * LOG2E;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(fmaf(s[n][e], LOG2E, -mlog2[e >> 1]));
        lsum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) lrow[i] = lrow[i] * alpha[i] + lsum[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: the score fragments of key tiles 2kk, 2kk + 1 are the A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float p0 = s[2 * kk + (x >> 1)][2 * (x & 1)];
        const float p1 = s[2 * kk + (x >> 1)][2 * (x & 1) + 1];
        pa[x] = pack_bf16(p0, p1);
        if constexpr (SPLIT_P)  // the rounding's remainders, exact in f32
          pl[x] = pack_bf16(p0 - __uint_as_float(pa[x] << 16),
                            p1 - __uint_as_float(pa[x] & 0xffff0000u));
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(smem_u32(Vs + swz<D>(kk * 16 + (lane & 15), 2 * dp + (lane >> 4))), vb);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
        if constexpr (SPLIT_P) {
          mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
        }
      }
    }

    if constexpr (KIND == KV_BF16) {
      cp_async_wait_all();
    } else {
      if (more) store_codes(st ^ 1);
    }
    __syncthreads();
    st ^= 1;
    j = jn;
  }

  // epilogue: O / max(l, 1e-30) through this warp's staging rows, then 16-byte stores
  constexpr int PITCH = D + 8;  // staging row pitch, elements
  OT* stage = reinterpret_cast<OT*>(flash_smem) + warp * 16 * PITCH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lrow[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    OT* srow = stage + ((lane >> 2) + 8 * i) * PITCH + kq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x = o[n][2 * i] / l, y = o[n][2 * i + 1] / l;
      if constexpr (OUT_F32)
        *reinterpret_cast<float2*>(srow + n * 8) = make_float2(x, y);
      else
        *reinterpret_cast<uint32_t*>(srow + n * 8) = pack_bf16(x, y);
    }
  }
  __syncwarp();
  constexpr int CO = D * (int)sizeof(OT) / 16;  // 16-byte chunks of an output row
#pragma unroll
  for (int u = 0; u < 16 * CO / 32; ++u) {
    const int c = lane + u * 32, i = c / CO, cc = c % CO;
    const int r = r0 + warp * 16 + i;
    if (r < rows)
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(static_cast<OT*>(a.out) + row_off(r)) +
                                cc * 16) =
          *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(stage + i * PITCH) +
                                          cc * 16);
  }
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and device
template <class F>
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

}  // namespace flash_tile
