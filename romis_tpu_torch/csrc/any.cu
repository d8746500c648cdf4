// Kernel 6: boolean any-hit of ray batches against a triangle soup.
//
// Replaces romis_tpu/ops/pallas_trace.py pallas_any / _any_kernel (with
// occlusion_into): occluded = some triangle at t in (0, t_max). Leading
// sample axes are flattened by the wrapper: rays [S, 3, N], t_max [S, N],
// out [S, N] bool. The test is ops/intersect._mt (Möller–Trumbore with the
// reciprocal of the determinant, mt_hit in common.cuh), so the result
// agrees bit for bit with the plain intersect_any.
//
// One thread per ray; the [10, T] triangle columns are staged through
// shared memory in 512-triangle chunks (a broadcast read, as in kernel 1).
// A ray stops at its first hit, and a block stops staging chunks once none
// of its rays is pending (__syncthreads_or). Bound: compute, ~30 flops per
// live ray-triangle test up to the first hit; device-memory traffic is
// 7 floats in and 1 byte out per ray.
#include "common.cuh"

namespace romis {

__global__ void __launch_bounds__(kThreads)
any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, long long n_pix,
               long long n_rays, const float* __restrict__ cols, int n_tris,
               unsigned char* __restrict__ out) {
  __shared__ float s[10][kTriChunk];
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = r < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, tm = 0.f;
  if (live) {
    const long long si = r / n_pix, p = r - si * n_pix;
    const long long base = si * 3 * n_pix + p;
    ox = o[base]; oy = o[base + n_pix]; oz = o[base + 2 * n_pix];
    dx = d[base]; dy = d[base + n_pix]; dz = d[base + 2 * n_pix];
    tm = t_max[r];
  }
  bool pending = live;
  bool occluded = false;
  for (int base = 0; base < n_tris; base += kTriChunk) {
    // Also the barrier before the chunk buffer is overwritten.
    if (!__syncthreads_or(pending)) break;
    const int cnt = min(kTriChunk, n_tris - base);
    stage_tris(s, cols, n_tris, base, cnt);
    __syncthreads();
    if (!pending) continue;
    for (int j = 0; j < cnt; ++j) {
      float t, u, v;
      if (mt_hit(ox, oy, oz, dx, dy, dz, &s[0][j], kTriChunk, t, u, v) &&
          t < tm) {
        occluded = true;
        pending = false;
        break;
      }
    }
  }
  if (live) out[r] = occluded ? 1 : 0;
}

}  // namespace romis

extern "C" int romis_any_hit(const float* o, const float* d, const float* t_max,
                             long long n_pix, long long n_rays, const float* cols,
                             int n_tris, unsigned char* out, cudaStream_t stream) {
  romis::any_hit_kernel<<<romis::blocks_for(n_rays), romis::kThreads, 0, stream>>>(
      o, d, t_max, n_pix, n_rays, cols, n_tris, out);
  return static_cast<int>(cudaGetLastError());
}
