// Dense KV-cache write for Hopper (sm_90a): copy vals [B, T, row] into
// cache [B, S, row] at per-slot row offset start[b], in place.
//
// Replaces: modelopt_tpu/kernels/attention.py::dense_kv_write (Pallas body
// _kv_write_kernel: one DMA per slot into the aliased HBM cache).
//
// Semantics follow the reference's CPU path, a vmapped
// dynamic_update_slice: start[b] is clamped to [0, S - T].
//
// What bounds it on an H100: bytes, T * row read once and written once per
// slot, over the 3.35 TB/s of HBM.
//
// Design: one CTA per (slot, group of rows); every thread moves 16-byte
// vectors, so a warp writes 512 contiguous bytes. Only the touched rows
// move; the rest of the cache is never read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void kv_write_kernel(uint4* __restrict__ cache,
                                const uint4* __restrict__ vals,
                                const int* __restrict__ start, int S, int T,
                                int row_vecs, int rows_per_cta) {
  const int b = blockIdx.y;
  const int s = max(0, min(start[b], S - T));
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(T, r0 + rows_per_cta);
  const uint4* src = vals + (size_t)b * T * row_vecs;
  uint4* dst = cache + ((size_t)b * S + s) * row_vecs;
  for (int i = r0 * row_vecs + threadIdx.x; i < r1 * row_vecs; i += blockDim.x)
    dst[i] = src[i];
}

}  // namespace

// cache [B, S, row_bytes] and vals [B, T, row_bytes] as raw bytes; start int32
// [B] on the device. row_bytes % 16 == 0 and both pointers 16-byte aligned.
extern "C" int kv_write(void* cache, const void* vals, const void* start, int B,
                        int S, int T, int row_bytes, void* stream) {
  const int row_vecs = row_bytes / 16;
  int rows_per_cta = 1024 / row_vecs;  // 4 vectors a thread
  if (rows_per_cta < 1) rows_per_cta = 1;
  dim3 grid((T + rows_per_cta - 1) / rows_per_cta, B);
  kv_write_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache), static_cast<const uint4*>(vals),
      static_cast<const int*>(start), S, T, row_vecs, rows_per_cta);
  return (int)cudaGetLastError();
}
