// Paged KV write for Hopper (sm_90a): scatter per-token rows into page
// pools [n_pages, page_size, row], in place.
//
// Replaces: modelopt_tpu/kernels/paged_attention.py::paged_kv_write (Pallas
// body _kv_write_kernel: one DMA per (slot, token) to the page-table-routed
// row of the aliased pool), and around it the reference's write of a paged
// layer (modelopt_tpu/models/transformer.py:481-492, models/mla.py:164-177):
// the page-table gather, MLA's zero pad and one scatter per pool.
//
// Two entries on one body:
//  - paged_kv_write: the reference kernel's signature, targets given as
//    pids, offs [B, T];
//  - paged_kv_write_rows: a layer's whole write. For row (b, t) of every
//    pool, col = min(pos // page_size, PMAX - 1) (the reference's gather
//    clamps the column, not the offset), pid = page_table[b, col],
//    off = pos % page_size; the row's w bytes, then zeros up to the pool's
//    row (MLA pads its 576-byte latent rows to 640).
// Semantics follow the reference's CPU path, pool.at[pids, offs].set(vals):
// a target outside the pool (pid not in [0, n_pages) or off not in
// [0, page_size)) is dropped, as XLA's scatter drops it; so is a row at a
// negative position, which no caller writes. Two rows aimed at one target
// (idle slots all writing the null page 0) land in no set order; the
// reference leaves that order open too.
//
// What bounds it on an H100: bytes, B * T rows read once and written once
// a pool over the 3.35 TB/s of HBM (a decode step's 8 rows: 16 KB), so in
// practice the latency of the launch and of one dependent chain of loads.
//
// Design: the grid is sized to the output, one 16-byte vector a thread
// across every pool and row (K3's shape: a 1024-byte K + V pair at T = 1 is
// 128 threads, a 640-byte latent row 40). Each thread issues its value
// load (none in the pad) and its position load together; the page-table
// entry follows the position, and the store waits on both chains. No
// shared memory, no atomics. Only the touched rows move; the rest of the
// pool is never read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads a CTA

// kLookup: a = positions [B * T], tab = page_table [B, pmax];
// else a = pids, tab = offs, both [B * T].
template <bool kLookup>
__global__ void __launch_bounds__(NT)
page_write_kernel(uint4* __restrict__ pool0, uint4* __restrict__ pool1,
                  const uint4* __restrict__ rows0, const uint4* __restrict__ rows1,
                  const int* __restrict__ a, const int* __restrict__ tab, int per_pool,
                  int total, int row_vecs, int w_vecs, int n_pages, int page_size, int T,
                  int pmax) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= total) return;
  const bool second = i >= per_pool;
  const int j = second ? i - per_pool : i;
  const int r = j / row_vecs;  // the (b, t) row
  const int c = j - r * row_vecs;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (c < w_vecs) v = (second ? rows1 : rows0)[(size_t)r * w_vecs + c];
  int pid, off;
  if constexpr (kLookup) {
    const int pos = a[r];
    if (pos < 0) return;
    pid = tab[(r / T) * pmax + min(pos / page_size, pmax - 1)];
    off = pos % page_size;
  } else {
    pid = a[r];
    off = tab[r];
    if (off < 0 || off >= page_size) return;
  }
  if (pid < 0 || pid >= n_pages) return;
  (second ? pool1 : pool0)[((size_t)pid * page_size + off) * row_vecs + c] = v;
}

int launch(bool lookup, void* pool0, void* pool1, const void* rows0, const void* rows1,
           const void* a, const void* tab, int n_pools, int n_rows, int row_bytes,
           int w_bytes, int n_pages, int page_size, int T, int pmax, void* stream) {
  const int row_vecs = row_bytes / 16;
  const int per_pool = n_rows * row_vecs;
  const int total = n_pools * per_pool;
  if (total == 0) return 0;
  const int grid = (total + NT - 1) / NT;
  auto s = static_cast<cudaStream_t>(stream);
  auto* p0 = static_cast<uint4*>(pool0);
  auto* p1 = static_cast<uint4*>(pool1);
  auto* v0 = static_cast<const uint4*>(rows0);
  auto* v1 = static_cast<const uint4*>(rows1);
  auto* ia = static_cast<const int*>(a);
  auto* it = static_cast<const int*>(tab);
  if (lookup)
    page_write_kernel<true><<<grid, NT, 0, s>>>(p0, p1, v0, v1, ia, it, per_pool, total,
                                                 row_vecs, w_bytes / 16, n_pages, page_size,
                                                 T, pmax);
  else
    page_write_kernel<false><<<grid, NT, 0, s>>>(p0, p1, v0, v1, ia, it, per_pool, total,
                                                  row_vecs, row_vecs, n_pages, page_size, T,
                                                  pmax);
  return (int)cudaGetLastError();
}

}  // namespace

// pool [n_pages, page_size, row_bytes] and vals [n_rows, row_bytes] as raw
// bytes, row_bytes % 16 == 0 and both 16-byte aligned; pids, offs int32
// [n_rows] on the device (n_rows = B * T, row-major over (b, t)).
extern "C" int paged_kv_write(void* pool, const void* vals, const void* pids, const void* offs,
                              int n_rows, int n_pages, int page_size, int row_bytes,
                              void* stream) {
  return launch(false, pool, nullptr, vals, nullptr, pids, offs, 1, n_rows, row_bytes,
                row_bytes, n_pages, page_size, 1, 0, stream);
}

// n_pools (1 or 2) pools [n_pages, page_size, row_bytes] and their rows
// [B, T, w_bytes] as raw bytes (pool1 / rows1 unused when n_pools == 1),
// row_bytes and w_bytes multiples of 16 with w_bytes <= row_bytes, every
// pointer 16-byte aligned; positions int32 [B, T] and page_table int32
// [B, pmax] on the device.
extern "C" int paged_kv_write_rows(void* pool0, void* pool1, const void* rows0,
                                   const void* rows1, const void* positions,
                                   const void* page_table, int n_pools, int B, int T, int pmax,
                                   int n_pages, int page_size, int row_bytes, int w_bytes,
                                   void* stream) {
  return launch(true, pool0, pool1, rows0, rows1, positions, page_table, n_pools, B * T,
                row_bytes, w_bytes, n_pages, page_size, T, pmax, stream);
}
