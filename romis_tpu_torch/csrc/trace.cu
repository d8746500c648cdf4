// Kernel 1: closest hit of primary rays against a triangle soup.
//
// Replaces romis_tpu/ops/pallas_trace.py pallas_closest / _closest_kernel
// (Möller–Trumbore over an on-chip triangle soup of at most 2048
// triangles). One thread per pixel; the [10, T] triangle columns are staged
// through shared memory in 512-triangle chunks and read by every thread of
// the block at the same address (a broadcast), so device-memory traffic is
// rays in + hits out (~40 B/pixel). Bound: compute, ~30 flops per
// ray-triangle test. The running best is kept in registers; the strict
// "t < best" over ascending triangle indices makes the lowest index win
// ties, as in the reference.
#include "common.cuh"

namespace romis {

__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   long long n, const float* __restrict__ cols, int n_tris,
                   float t_max, float* __restrict__ t_out,
                   int* __restrict__ tri_out, float* __restrict__ u_out,
                   float* __restrict__ v_out) {
  __shared__ float s[10][kTriChunk];
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = p < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    ox = o[p]; oy = o[n + p]; oz = o[2 * n + p];
    dx = d[p]; dy = d[n + p]; dz = d[2 * n + p];
  }
  float best_t = t_max, best_u = 0.f, best_v = 0.f;
  int best_i = -1;
  for (int base = 0; base < n_tris; base += kTriChunk) {
    const int cnt = min(kTriChunk, n_tris - base);
    __syncthreads();
    stage_tris(s, cols, n_tris, base, cnt);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      float t, u, v;
      if (mt_hit(ox, oy, oz, dx, dy, dz, &s[0][j], kTriChunk, t, u, v) &&
          t < best_t) {
        best_t = t;
        best_i = base + j;
        best_u = u;
        best_v = v;
      }
    }
  }
  if (live) {
    t_out[p] = best_i >= 0 ? best_t : INFINITY;
    tri_out[p] = best_i;
    u_out[p] = best_u;
    v_out[p] = best_v;
  }
}

}  // namespace romis

extern "C" int romis_closest_hit(const float* o, const float* d, long long n,
                                 const float* cols, int n_tris, float t_max,
                                 float* t, int* tri, float* u, float* v,
                                 cudaStream_t stream) {
  romis::closest_hit_kernel<<<romis::blocks_for(n), romis::kThreads, 0, stream>>>(
      o, d, n, cols, n_tris, t_max, t, tri, u, v);
  return static_cast<int>(cudaGetLastError());
}
