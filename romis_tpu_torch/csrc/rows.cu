// Kernel 2: planes-first row gather, out[c, p] = table[idx[p], c].
//
// Replaces romis_tpu/ops/pallas_rows.py gather_rows / _rows_gather_pallas /
// _rows_kernel (a VMEM-resident transposed table read with windowed lane
// gathers). Here one thread per index reads its row through the read-only
// cache (__ldg: the table is small and hot, every row is reused by many
// pixels) and writes C planes, each store coalesced along the pixels. Bound:
// device-memory bandwidth, (C + 1) x 4 B per pixel. Out-of-range indices
// are clamped into [0, T), as an XLA gather clamps them. The copy is exact.
#include "common.cuh"

namespace romis {

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table, int n_rows, int n_cols,
                   const int* __restrict__ idx, long long n,
                   float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int r = min(max(idx[p], 0), n_rows - 1);
  const float* row = table + static_cast<long long>(r) * n_cols;
  for (int c = 0; c < n_cols; ++c) out[c * n + p] = __ldg(row + c);
}

}  // namespace romis

extern "C" int romis_gather_rows(const float* table, int n_rows, int n_cols,
                                 const int* idx, long long n, float* out,
                                 cudaStream_t stream) {
  romis::gather_rows_kernel<<<romis::blocks_for(n), romis::kThreads, 0, stream>>>(
      table, n_rows, n_cols, idx, n, out);
  return static_cast<int>(cudaGetLastError());
}
