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
// slot, over the 3.35 TB/s of HBM; below ~1 MB (every shape the paths run:
// 557 KB for a 544-row chunk of 1024-byte rows, 5-8 KB for a decode step's
// one row a slot) the latency of one round trip, a load and the store that
// depends on it.
//
// Design: the grid is sized to the copy, one 16-byte vector a thread, so
// every load of the update is issued at once and each thread's store
// waits only on its own load (a thread that looped over several vectors
// would wait out one round trip a vector). Consecutive threads take
// consecutive vectors: a warp moves 512 contiguous bytes, and at T = 1 a
// 1024-byte row is two warps, a 640-byte row 40 lanes, with no CTA of idle
// threads. Only the touched rows move; the rest of the cache is never read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads a CTA

__global__ void __launch_bounds__(NT)
kv_write_kernel(uint4* __restrict__ cache, const uint4* __restrict__ vals,
                const int* __restrict__ start, int S, int T, int row_vecs, int total) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= total) return;
  const uint4 v = vals[i];  // in flight while start[b] is read
  const int slot_vecs = T * row_vecs;
  const int b = i / slot_vecs;
  const int s = max(0, min(start[b], S - T));
  cache[((size_t)b * S + s) * row_vecs + (i - b * slot_vecs)] = v;
}

}  // namespace

// cache [B, S, row_bytes] and vals [B, T, row_bytes] as raw bytes; start int32
// [B] on the device. row_bytes % 16 == 0 and both pointers 16-byte aligned.
extern "C" int kv_write(void* cache, const void* vals, const void* start, int B,
                        int S, int T, int row_bytes, void* stream) {
  const int row_vecs = row_bytes / 16;
  const int total = B * T * row_vecs;
  if (total == 0) return 0;
  kv_write_kernel<<<(total + NT - 1) / NT, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache), static_cast<const uint4*>(vals),
      static_cast<const int*>(start), S, T, row_vecs, total);
  return (int)cudaGetLastError();
}
