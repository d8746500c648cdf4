// Kernels 18-20: closest hit and any-hit by walking the BVH (walk.cuh).
//
// Replace romis_tpu/ops/pallas_bvh.py paged_closest / _closest_kernel
// (kernel 18), paged_any / _any_kernel with occlusion_paged_into (kernel 19)
// and paged_any_k / _any_k_kernel with occlusion_paged_k_into (kernel 20).
// The TPU kernels walk a shared-memory top tree with one cursor per ray
// TILE and DMA 512-triangle pages, because Mosaic has no per-lane control
// flow; here every thread walks the whole threaded tree with its own
// cursor, reading node records and leaf triangles through the read-only
// cache (the tree and the triangles of a 24k-triangle scene, ~2 MB, stay in
// L2). The plain versions are ops/traverse.bvh_closest and bvh_any, whose
// walk each thread repeats step for step.
//
// Kernel 18: one thread per primary ray; the running best t prunes.
// Kernel 19: one thread per ray of the flattened leading axes (rays
//   [S, 3, N], t_max [S, N], out [S, N] bool), stopping at the first hit.
// Kernel 20: one thread per pixel walks the tree once for its S <= 16 rays
//   (the K lanes of the initial check, the D1*K rays of the MIS ext_vis
//   batch), the still-unoccluded rays in a bit mask; each ray has its own
//   origin (wrs.visibility pushes it along its own direction).
//
// Bound: operations, the box and triangle tests the walk makes (about 22
// operations a box test, one Moller-Trumbore test a triangle); device
// memory sees only rays in and hits out (40 B a closest-hit ray, 29 B an
// any-hit ray). Ray indices are 64-bit: 12 x 1080 x 1920 rays go into one
// launch.
#include "walk.cuh"

namespace romis {

constexpr int kWalkThreads = 128;

inline int walk_blocks(long long n) {
  return static_cast<int>((n + kWalkThreads - 1) / kWalkThreads);
}

__global__ void __launch_bounds__(kWalkThreads)
bvh_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   long long n, const float4* __restrict__ nodes,
                   const float* __restrict__ cols, int n_tris, float t_max,
                   float* __restrict__ t_out, int* __restrict__ tri_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float best_t = t_max, best_u = 0.f, best_v = 0.f;
  int best_i = -1;
  walk_closest(nodes, cols, n_tris, o[p], o[n + p], o[2 * n + p], d[p],
               d[n + p], d[2 * n + p], best_t, best_i, best_u, best_v);
  t_out[p] = best_t;
  tri_out[p] = best_i;
  u_out[p] = best_u;
  v_out[p] = best_v;
}

__global__ void __launch_bounds__(kWalkThreads)
bvh_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, long long n_pix,
               long long n_rays, const float4* __restrict__ nodes,
               const float* __restrict__ cols, int n_tris,
               unsigned char* __restrict__ out) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const long long si = r / n_pix, p = r - si * n_pix;
  const long long base = si * 3 * n_pix + p;
  const float ox[1] = {o[base]}, oy[1] = {o[base + n_pix]},
              oz[1] = {o[base + 2 * n_pix]};
  const float dx[1] = {d[base]}, dy[1] = {d[base + n_pix]},
              dz[1] = {d[base + 2 * n_pix]};
  const float tm[1] = {t_max[r]};
  out[r] = walk_any<1>(nodes, cols, n_tris, ox, oy, oz, dx, dy, dz, tm, 1u)
               ? 1 : 0;
}

// S is the instantiated width (2, 4, 8, 12 or 16); the s_real <= S rays of
// the call are live, the rest never traced.
template <int S>
__global__ void __launch_bounds__(kWalkThreads)
bvh_any_k_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_max, long long n_pix, int s_real,
                 const float4* __restrict__ nodes,
                 const float* __restrict__ cols, int n_tris,
                 unsigned char* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  float ox[S], oy[S], oz[S], dx[S], dy[S], dz[S], tm[S];
  unsigned live = 0u;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool real = s < s_real;
    const long long base = static_cast<long long>(s) * 3 * n_pix + p;
    ox[s] = real ? o[base] : 0.f;
    oy[s] = real ? o[base + n_pix] : 0.f;
    oz[s] = real ? o[base + 2 * n_pix] : 0.f;
    dx[s] = real ? d[base] : 0.f;
    dy[s] = real ? d[base + n_pix] : 0.f;
    dz[s] = real ? d[base + 2 * n_pix] : 0.f;
    tm[s] = real ? t_max[static_cast<long long>(s) * n_pix + p] : 0.f;
    if (real) live |= 1u << s;
  }
  const unsigned occ = walk_any<S>(nodes, cols, n_tris, ox, oy, oz, dx, dy,
                                   dz, tm, live);
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (s < s_real) out[static_cast<long long>(s) * n_pix + p] = (occ >> s) & 1u;
}

template <int S>
int launch_any_k(const float* o, const float* d, const float* t_max,
                 long long n_pix, int s_real, const float4* nodes,
                 const float* cols, int n_tris, unsigned char* out,
                 cudaStream_t stream) {
  bvh_any_k_kernel<S><<<walk_blocks(n_pix), kWalkThreads, 0, stream>>>(
      o, d, t_max, n_pix, s_real, nodes, cols, n_tris, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace romis

extern "C" int romis_bvh_closest(const float* o, const float* d, long long n,
                                 const float* nodes, const float* cols,
                                 int n_tris, float t_max, float* t, int* tri,
                                 float* u, float* v, cudaStream_t stream) {
  using namespace romis;
  bvh_closest_kernel<<<walk_blocks(n), kWalkThreads, 0, stream>>>(
      o, d, n, reinterpret_cast<const float4*>(nodes), cols, n_tris, t_max, t,
      tri, u, v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int romis_bvh_any(const float* o, const float* d, const float* t_max,
                             long long n_pix, long long n_rays,
                             const float* nodes, const float* cols, int n_tris,
                             unsigned char* out, cudaStream_t stream) {
  using namespace romis;
  bvh_any_kernel<<<walk_blocks(n_rays), kWalkThreads, 0, stream>>>(
      o, d, t_max, n_pix, n_rays, reinterpret_cast<const float4*>(nodes), cols,
      n_tris, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int romis_bvh_any_k(const float* o, const float* d, const float* t_max,
                               long long n_pix, int s, const float* nodes,
                               const float* cols, int n_tris, unsigned char* out,
                               cudaStream_t stream) {
  using namespace romis;
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  if (s < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (s <= 2) return launch_any_k<2>(o, d, t_max, n_pix, s, nd, cols, n_tris, out, stream);
  if (s <= 4) return launch_any_k<4>(o, d, t_max, n_pix, s, nd, cols, n_tris, out, stream);
  if (s <= 8) return launch_any_k<8>(o, d, t_max, n_pix, s, nd, cols, n_tris, out, stream);
  if (s <= 12) return launch_any_k<12>(o, d, t_max, n_pix, s, nd, cols, n_tris, out, stream);
  if (s <= 16) return launch_any_k<16>(o, d, t_max, n_pix, s, nd, cols, n_tris, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
