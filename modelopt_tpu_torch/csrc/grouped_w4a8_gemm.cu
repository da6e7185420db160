// Grouped W4A8 GEMM fused with the routed MoE combine, for Hopper (sm_90a):
//   out[m, n] = sum_e gscale[e, m] * (xq[e, m, :] @ W_e)[:, n]
// with int8 activations, int4 block-quantized expert weights, exact int32
// dots on the int8 tensor cores (mma.sync m16n8k32) and f32 block scales.
//
// Replaces: modelopt_tpu/kernels/quant_gemm.py::grouped_w4a8_combine_gemm
// (Pallas body _grouped_w4a8_combine_kernel over _w4a8_body).
//
// Layout: xq int8 [E, M, K]; gscale f32 [E, M] (routing gate x the row's
// activation scale); packed uint8 [K/2, E*N] and scale f32 [K/128, E*N] in
// the folded expert layout (expert e is columns e*N..e*N+N-1, each a
// split-half int4 tensor as in w4a8_gemm.cu). Returns f32 [M, N].
//
// What bounds it on an H100: the packed expert bytes (K/2 * E*N) over
// 3.35 TB/s of HBM; at the Qwen3-30B-A3B decode shape (E=128, K=768,
// N=2048, M=8) about 108 MB, 32 us.
//
// Design: the Pallas grid runs (N-tile, expert) with the expert innermost
// and carries the sum in the revisited output block. Hopper CTAs run in no
// order, so here one CTA owns a 16-row x 16-column output tile for ALL
// experts: its 16 warps each take every 16th expert, compute that expert's
// product in full (per 128-row scale block: exact int32 fragments, then
// acc + qlo*s_lo + qhi*s_hi in f32 with explicit rounding, K1's order) and
// the gated term p_e = acc_e * gscale[e, m]; after each round of 16 experts
// the CTA adds the round's terms to its output in expert order,
// out = out + p_e, e = 0..E-1. Each expert's term is computed alone and the
// sum runs in one fixed order, so the result is bit-identical to the plain
// version and to itself from run to run (no atomics). The nibbles are never
// widened: (w & 0x0F) is q_lo + 8 (corrected by 8 * sum(x) per row), and
// (w & 0xF0) read as int8 is 16 * q_hi. Each warp stages its own x rows and
// its expert's packed tile (transposed 4x4 bytes at a time, so one word is
// four k of one column) in shared memory and syncs only with itself.
// At the decode shape the 16-column tiles give 128 CTAs for 132 SMs, each
// with 16 experts' loads in flight; wider tiles would leave SMs idle, and
// splitting E across CTAs would change the order of the sum. Each warp
// still waits on its own loads before its MMAs: a pipeline that stages the
// next block while the current one computes is the next redesign target.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KB = 128;      // rows of one scale block
constexpr int BM = 16;       // output rows per CTA (one m16 MMA tile)
constexpr int BN = 16;       // output columns per CTA (two n8 MMA tiles)
constexpr int NT = BN / 8;   // n8 MMA tiles per warp
constexpr int NW = 16;       // warps per CTA; warp w takes experts w, w+16, ...
constexpr int NTH = 32 * NW;
constexpr int PER = (BM * BN + NTH - 1) / NTH;  // output elements per thread
constexpr int PITCH = KB + 16;  // smem row pitch in bytes: 36 words, 4 banks apart
constexpr int PP = BN + 1;   // pitch of the per-warp gated-term tile in floats

struct WarpSmem {
  int8_t xs[2][BM][PITCH];   // x rows, low and high half of one scale block
  uint8_t wt[BN][PITCH];     // packed tile transposed: wt[n][k]
  int sx[BM];                // per-row sum of the low-half x (the +8 offset)
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(NTH, 1)
grouped_w4a8_combine_kernel(const int8_t* __restrict__ xq, const float* __restrict__ gscale,
                            const uint8_t* __restrict__ w, const float* __restrict__ scale,
                            float* __restrict__ out, int E, int M, int N, int K2) {
  extern __shared__ __align__(16) unsigned char smem[];
  WarpSmem* ws = reinterpret_cast<WarpSmem*>(smem);
  float* ps = reinterpret_cast<float*>(smem + NW * sizeof(WarpSmem));  // [NW][BM][PP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int K = 2 * K2;
  const int EN = E * N;
  const int nblk = K2 / KB;
  WarpSmem& my = ws[warp];
  float* myp = ps + warp * BM * PP;

  // the CTA's output, PER elements per thread, summed in expert order
  float o[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) o[k] = 0.f;

  for (int e0 = 0; e0 < E; e0 += NW) {
    const int e = e0 + warp;
    if (e < E) {
      const int8_t* xe = xq + (size_t)e * M * K;
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

      for (int blk = 0; blk < nblk; ++blk) {
        // x rows m0..m0+15 (zero past M), both halves: 16 x 2 x 8 uint4
#pragma unroll
        for (int i = lane; i < 2 * BM * (KB / 16); i += 32) {
          const int half = i / (BM * (KB / 16));
          const int r = (i / (KB / 16)) % BM;
          const int c = i % (KB / 16);
          const int m = m0 + r;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (m < M)
            v = *reinterpret_cast<const uint4*>(xe + (size_t)m * K + half * K2 + blk * KB +
                                                c * 16);
          *reinterpret_cast<uint4*>(&my.xs[half][r][c * 16]) = v;
        }
        // packed [KB, BN] tile of expert e, transposed 4 rows x 4 columns at a time
#pragma unroll 4
        for (int i = lane; i < (KB / 4) * (BN / 4); i += 32) {
          const int kr = (i / (BN / 4)) * 4;
          const int nc = (i % (BN / 4)) * 4;
          const uint8_t* src = w + (size_t)(blk * KB + kr) * EN + (size_t)e * N + n0 + nc;
          const uint32_t r0 = *reinterpret_cast<const uint32_t*>(src);
          const uint32_t r1 = *reinterpret_cast<const uint32_t*>(src + EN);
          const uint32_t r2 = *reinterpret_cast<const uint32_t*>(src + 2 * (size_t)EN);
          const uint32_t r3 = *reinterpret_cast<const uint32_t*>(src + 3 * (size_t)EN);
          const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
          const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
          const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
          const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
          *reinterpret_cast<uint32_t*>(&my.wt[nc + 0][kr]) = __byte_perm(t0, t1, 0x5410);
          *reinterpret_cast<uint32_t*>(&my.wt[nc + 1][kr]) = __byte_perm(t0, t1, 0x7632);
          *reinterpret_cast<uint32_t*>(&my.wt[nc + 2][kr]) = __byte_perm(t2, t3, 0x5410);
          *reinterpret_cast<uint32_t*>(&my.wt[nc + 3][kr]) = __byte_perm(t2, t3, 0x7632);
        }
        __syncwarp();
        if (lane < BM) {
          int s = 0;
#pragma unroll 8
          for (int k4 = 0; k4 < KB / 4; ++k4)
            s = __dp4a(*reinterpret_cast<const int*>(&my.xs[0][lane][k4 * 4]), 0x01010101, s);
          my.sx[lane] = s;
        }
        __syncwarp();

        int lo[NT][4], hi[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) lo[j][c] = hi[j][c] = 0;
#pragma unroll
        for (int ks = 0; ks < KB / 32; ++ks) {
          const int k = ks * 32 + 4 * t;
          uint32_t al[4], ah[4];
          al[0] = *reinterpret_cast<const uint32_t*>(&my.xs[0][g][k]);
          al[1] = *reinterpret_cast<const uint32_t*>(&my.xs[0][g + 8][k]);
          al[2] = *reinterpret_cast<const uint32_t*>(&my.xs[0][g][k + 16]);
          al[3] = *reinterpret_cast<const uint32_t*>(&my.xs[0][g + 8][k + 16]);
          ah[0] = *reinterpret_cast<const uint32_t*>(&my.xs[1][g][k]);
          ah[1] = *reinterpret_cast<const uint32_t*>(&my.xs[1][g + 8][k]);
          ah[2] = *reinterpret_cast<const uint32_t*>(&my.xs[1][g][k + 16]);
          ah[3] = *reinterpret_cast<const uint32_t*>(&my.xs[1][g + 8][k + 16]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&my.wt[j * 8 + g][k]);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&my.wt[j * 8 + g][k + 16]);
            mma_s8(lo[j], al, b0 & 0x0F0F0F0Fu, b1 & 0x0F0F0F0Fu);  // q_lo + 8
            mma_s8(hi[j], ah, b0 & 0xF0F0F0F0u, b1 & 0xF0F0F0F0u);  // 16 * q_hi
          }
        }
        const int sx0 = my.sx[g];
        const int sx1 = my.sx[g + 8];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const size_t col = (size_t)e * N + n0 + j * 8 + 2 * t;
          const float2 slo = *reinterpret_cast<const float2*>(scale + (size_t)blk * EN + col);
          const float2 shi =
              *reinterpret_cast<const float2*>(scale + (size_t)(nblk + blk) * EN + col);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int qlo = lo[j][c] - 8 * ((c & 2) ? sx1 : sx0);
            const int qhi = hi[j][c] >> 4;
            acc[j][c] = __fadd_rn(
                __fadd_rn(acc[j][c], __fmul_rn((float)qlo, (c & 1) ? slo.y : slo.x)),
                __fmul_rn((float)qhi, (c & 1) ? shi.y : shi.x));
          }
        }
        __syncwarp();
      }
      // this expert's gated term p_e = acc_e * gscale[e, m]
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = g + ((c & 2) ? 8 : 0);
          const int m = m0 + r;
          const float gs = m < M ? gscale[(size_t)e * M + m] : 0.f;
          myp[r * PP + j * 8 + 2 * t + (c & 1)] = __fmul_rn(acc[j][c], gs);
        }
    }
    __syncthreads();
    // out = out + p_e in expert order for this round
    const int ne = min(NW, E - e0);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = tid + k * NTH;
      if (idx >= BM * BN) continue;
      const int r = idx / BN;
      const int c = idx % BN;
      for (int i = 0; i < ne; ++i) o[k] = __fadd_rn(o[k], ps[i * BM * PP + r * PP + c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = tid + k * NTH;
    const int m = m0 + idx / BN;
    if (idx < BM * BN && m < M) out[(size_t)m * N + n0 + idx % BN] = o[k];
  }
}

constexpr size_t SMEM_BYTES = NW * sizeof(WarpSmem) + NW * BM * PP * sizeof(float);

}  // namespace

// xq int8 [E, M, 2*K2]; gscale f32 [E, M]; packed uint8 [K2, E*N]; scale f32
// [2*K2/128, E*N]; out f32 [M, N]. Needs K2 % 128 == 0, N % 16 == 0 and
// 16-byte aligned xq (checked by the Python wrapper).
extern "C" int grouped_w4a8_combine_gemm(const void* xq, const void* gscale, const void* packed,
                                         const void* scale, void* out, int E, int M, int N,
                                         int K2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(grouped_w4a8_combine_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  grouped_w4a8_combine_kernel<<<grid, NTH, SMEM_BYTES, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(gscale),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
      static_cast<float*>(out), E, M, N, K2);
  return (int)cudaGetLastError();
}
