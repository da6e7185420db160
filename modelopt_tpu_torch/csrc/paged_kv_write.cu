// Paged KV write for Hopper (sm_90a): scatter vals [B, T, row] into a page
// pool [n_pages, page_size, row] at (pids[b, t], offs[b, t]), in place.
//
// Replaces: modelopt_tpu/kernels/paged_attention.py::paged_kv_write (Pallas
// body _kv_write_kernel: one DMA per (slot, token) to the page-table-routed
// row of the aliased pool).
//
// Semantics follow the reference's CPU path, pool.at[pids, offs].set(vals):
// a target outside the pool (pid not in [0, n_pages) or off not in
// [0, page_size)) is dropped, as XLA's scatter drops it. Two rows aimed at
// one target (idle slots all writing the null page 0) land in no set order;
// the reference leaves that order open too.
//
// What bounds it on an H100: bytes, B * T rows read once and written once
// over the 3.35 TB/s of HBM.
//
// Design: one warp per (slot, token) row; each lane moves 16-byte vectors,
// so a warp moves 512 contiguous bytes a step (a 1024-byte MHA row in two,
// a 640-byte latent row in one and a quarter). Only the touched rows move;
// the rest of the pool is never read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                // threads per CTA
constexpr int ROWS_PER_CTA = NT / 32;  // one warp per row

__global__ void __launch_bounds__(NT)
page_write_kernel(uint4* __restrict__ pool, const uint4* __restrict__ vals,
                  const int* __restrict__ pids, const int* __restrict__ offs, int n_rows,
                  int n_pages, int page_size, int row_vecs) {
  const int r = blockIdx.x * ROWS_PER_CTA + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int pid = pids[r], off = offs[r];
  if (pid < 0 || pid >= n_pages || off < 0 || off >= page_size) return;
  const uint4* src = vals + (size_t)r * row_vecs;
  uint4* dst = pool + ((size_t)pid * page_size + off) * row_vecs;
  for (int i = threadIdx.x & 31; i < row_vecs; i += 32) dst[i] = src[i];
}

}  // namespace

// pool [n_pages, page_size, row_bytes] and vals [n_rows, row_bytes] as raw
// bytes, row_bytes % 16 == 0 and both 16-byte aligned; pids, offs int32
// [n_rows] on the device (n_rows = B * T, row-major over (b, t)).
extern "C" int paged_kv_write(void* pool, const void* vals, const void* pids, const void* offs,
                              int n_rows, int n_pages, int page_size, int row_bytes,
                              void* stream) {
  if (n_rows == 0 || row_bytes == 0) return 0;
  const int grid = (n_rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  page_write_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(pool), static_cast<const uint4*>(vals),
      static_cast<const int*>(pids), static_cast<const int*>(offs), n_rows, n_pages,
      page_size, row_bytes / 16);
  return (int)cudaGetLastError();
}
