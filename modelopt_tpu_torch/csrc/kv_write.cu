// Dense KV-cache write for Hopper (sm_90a): copy vals [B, T, row] into
// cache [B, S, row] at per-slot row offset start[b], in place; one or two
// caches of one shape (an MHA layer's K and V) in one launch.
//
// Replaces: modelopt_tpu/kernels/attention.py::dense_kv_write (Pallas body
// _kv_write_kernel: one DMA per slot into the aliased HBM cache), which
// the reference calls once for K and once for V.
//
// Semantics follow the reference's CPU path, a vmapped
// dynamic_update_slice: start[b] is clamped to [0, S - T].
//
// What bounds it on an H100: bytes, T * row read once and written once per
// slot and cache, over the 3.35 TB/s of HBM; below ~1 MB (every shape the
// paths run: 1.1 MB for a 544-row chunk of K and V, 16 KB for a decode
// step's two rows a slot) the latency of one round trip, a load and the
// store that depends on it, and the launch itself.
//
// Design: the grid is sized to the copy, one 16-byte vector a thread, so
// every load of the update is issued at once and each thread's store
// waits only on its own load (a thread that looped over several vectors
// would wait out one round trip a vector). Consecutive threads take
// consecutive vectors: a warp moves 512 contiguous bytes, and at T = 1 a
// 1024-byte row is two warps, a 640-byte row 40 lanes, with no CTA of idle
// threads. The second cache's vectors follow the first's in the same grid,
// so K and V cost one launch. Only the touched rows move; the rest of the
// cache is never read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads a CTA

__global__ void __launch_bounds__(NT)
kv_write_kernel(uint4* __restrict__ cache0, uint4* __restrict__ cache1,
                const uint4* __restrict__ vals0, const uint4* __restrict__ vals1,
                const int* __restrict__ start, int S, int T, int row_vecs, int per_cache,
                int total) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= total) return;
  const bool second = i >= per_cache;
  const int j = second ? i - per_cache : i;
  const uint4 v = (second ? vals1 : vals0)[j];  // in flight while start[b] is read
  const int slot_vecs = T * row_vecs;
  const int b = j / slot_vecs;
  const int s = max(0, min(start[b], S - T));
  (second ? cache1 : cache0)[((size_t)b * S + s) * row_vecs + (j - b * slot_vecs)] = v;
}

}  // namespace

// n_caches (1 or 2) caches [B, S, row_bytes] and their vals [B, T, row_bytes]
// as raw bytes (cache1 / vals1 unused when n_caches == 1); start int32 [B]
// on the device. row_bytes % 16 == 0 and every pointer 16-byte aligned.
extern "C" int kv_write(void* cache0, void* cache1, const void* vals0, const void* vals1,
                        const void* start, int n_caches, int B, int S, int T, int row_bytes,
                        void* stream) {
  const int row_vecs = row_bytes / 16;
  const int per_cache = B * T * row_vecs;
  const int total = n_caches * per_cache;
  if (total == 0) return 0;
  kv_write_kernel<<<(total + NT - 1) / NT, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache0), static_cast<uint4*>(cache1),
      static_cast<const uint4*>(vals0), static_cast<const uint4*>(vals1),
      static_cast<const int*>(start), S, T, row_vecs, per_cache, total);
  return (int)cudaGetLastError();
}
