// Variants of kernel 21 (the BVH final shade, csrc/shade.cu) that the
// package leaves out, for scripts/torch_scatter_shade_micro.py. The
// package's shade.cu is included for its helpers (shadow_ray, lane_term,
// load_material) and its walk (walk.cuh). Every variant reads kernel 4's packed planes (18 context planes, 10K
// reservoir planes), packed outside the timed call:
// - variant 1: the package's mapping (a thread per (pixel, lane)) walking
//   the [10, T] triangle columns instead of the 48-byte records, every
//   lane's Phong term computed;
// - variant 2: the same on the records (the mapping's first design);
// - variant 4: variant 2 with only lit lanes' Phong terms (the package's
//   arithmetic on the packed planes);
// - variant 3: a thread per pixel, its K rays walked one after another,
//   each alone, on the records (the walk per ray without the lanes side by
//   side).
#include "shade.cu"
#include "torch_walk_micro_coltris.cuh"

namespace micro {
using namespace romis;

template <int K, int kVariant>
__global__ void __launch_bounds__(kShadeBvhThreads)
shade_lanes(const float* __restrict__ ctx, const float* __restrict__ res,
            long long n, const float4* __restrict__ nodes,
            const float* __restrict__ cols, int n_tris,
            const float4* __restrict__ recs, bool unshaded,
            float* __restrict__ out) {
  constexpr int kPerWarp = 32 / K;
  const int wl = threadIdx.x & 31;
  const int slot = wl / K, lane = wl - slot * K;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long p = warp * kPerWarp + slot;
  const bool in_range = slot < kPerWarp && p < n;
  float term[3] = {0.f, 0.f, 0.f};
  if (in_range) {
    const float px = ctx[p], py = ctx[n + p], pz = ctx[2 * n + p];
    const float nx = ctx[3 * n + p], ny = ctx[4 * n + p], nz = ctx[5 * n + p];
    const bool valid = ctx[17 * n + p] > 0.5f;
    const float lx = res[(3 * lane) * n + p];
    const float ly = res[(3 * lane + 1) * n + p];
    const float lz = res[(3 * lane + 2) * n + p];
    const float big_w = res[(8 * K + lane) * n + p];
    const float col[3] = {res[(3 * K + 3 * lane) * n + p],
                          res[(3 * K + 3 * lane + 1) * n + p],
                          res[(3 * K + 3 * lane + 2) * n + p]};
    const ShadowRay r = shadow_ray(px, py, pz, nx, ny, nz, valid, unshaded,
                                   lx, ly, lz, big_w);
    bool occluded = false;
    if (r.pending)
      occluded = kVariant == 1
          ? walk_any(nodes, ColTris{cols, n_tris}, r.ox, r.oy, r.oz, r.dx,
                     r.dy, r.dz, r.tm)
          : walk_any(nodes, RecTris{recs}, r.ox, r.oy, r.oz, r.dx, r.dy,
                     r.dz, r.tm);
    if (kVariant != 4 || (r.gate && !occluded)) {
      const Material m = load_material(ctx + 6 * n, ctx + 9 * n, ctx + 12 * n,
                                       ctx + 15 * n, n, p, px, py, pz);
      lane_term(px, py, pz, nx, ny, nz, m.vx, m.vy, m.vz, m.kd, m.ks, m.shin,
                valid, unshaded, lx, ly, lz, col, big_w, occluded, term);
    } else {
      for (int c = 0; c < 3; ++c) term[c] = 0.0f * big_w;
    }
  }
  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < K; ++j)
    for (int c = 0; c < 3; ++c)
      acc[c] = acc[c] + __shfl_sync(0xffffffffu, term[c], slot * K + j);
  if (!in_range || lane != 0) return;
  const float kf = static_cast<float>(K);
  for (int c = 0; c < 3; ++c) out[c * n + p] = acc[c] / kf;
}

// Variant 3: a thread per pixel, its K rays walked one after another.
template <int K>
__global__ void __launch_bounds__(kShadeBvhThreads)
shade_pixel(const float* __restrict__ ctx, const float* __restrict__ res,
            long long n, const float4* __restrict__ nodes,
            const float4* __restrict__ recs, bool unshaded,
            float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float px = ctx[p], py = ctx[n + p], pz = ctx[2 * n + p];
  const float nx = ctx[3 * n + p], ny = ctx[4 * n + p], nz = ctx[5 * n + p];
  const bool valid = ctx[17 * n + p] > 0.5f;
  const Material m = load_material(ctx + 6 * n, ctx + 9 * n, ctx + 12 * n,
                                   ctx + 15 * n, n, p, px, py, pz);
  float acc[3] = {0.f, 0.f, 0.f};
  for (int lane = 0; lane < K; ++lane) {
    const float lx = res[(3 * lane) * n + p];
    const float ly = res[(3 * lane + 1) * n + p];
    const float lz = res[(3 * lane + 2) * n + p];
    const float big_w = res[(8 * K + lane) * n + p];
    const float col[3] = {res[(3 * K + 3 * lane) * n + p],
                          res[(3 * K + 3 * lane + 1) * n + p],
                          res[(3 * K + 3 * lane + 2) * n + p]};
    const ShadowRay r = shadow_ray(px, py, pz, nx, ny, nz, valid, unshaded,
                                   lx, ly, lz, big_w);
    const bool occluded =
        r.pending && walk_any(nodes, RecTris{recs}, r.ox, r.oy, r.oz, r.dx,
                              r.dy, r.dz, r.tm);
    float term[3];
    lane_term(px, py, pz, nx, ny, nz, m.vx, m.vy, m.vz, m.kd, m.ks, m.shin,
              valid, unshaded, lx, ly, lz, col, big_w, occluded, term);
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + term[c];
  }
  const float kf = static_cast<float>(K);
  for (int c = 0; c < 3; ++c) out[c * n + p] = acc[c] / kf;
}

template <int K>
int launch(int variant, const float* ctx, const float* res, long long n,
           const float4* nodes, const float* cols, int n_tris,
           const float4* recs, bool unshaded, float* out, cudaStream_t stream) {
  constexpr int kPerBlock = kShadeBvhThreads / 32 * (32 / K);
  const int grid = static_cast<int>((n + kPerBlock - 1) / kPerBlock);
  const int grid_pix = static_cast<int>((n + kShadeBvhThreads - 1) / kShadeBvhThreads);
  switch (variant) {
    case 1: shade_lanes<K, 1><<<grid, kShadeBvhThreads, 0, stream>>>(ctx, res, n, nodes, cols, n_tris, recs, unshaded, out); break;
    case 2: shade_lanes<K, 2><<<grid, kShadeBvhThreads, 0, stream>>>(ctx, res, n, nodes, cols, n_tris, recs, unshaded, out); break;
    case 4: shade_lanes<K, 4><<<grid, kShadeBvhThreads, 0, stream>>>(ctx, res, n, nodes, cols, n_tris, recs, unshaded, out); break;
    case 3: shade_pixel<K><<<grid_pix, kShadeBvhThreads, 0, stream>>>(ctx, res, n, nodes, recs, unshaded, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace micro

extern "C" int micro_shade_bvh(int variant, const float* ctx, const float* res,
                               long long n, int k, const float* nodes,
                               const float* cols, int n_tris, const float* recs,
                               int unshaded, float* out, cudaStream_t stream) {
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const float4* rc = reinterpret_cast<const float4*>(recs);
  switch (k) {
    case 1: return micro::launch<1>(variant, ctx, res, n, nd, cols, n_tris, rc, unshaded != 0, out, stream);
    case 2: return micro::launch<2>(variant, ctx, res, n, nd, cols, n_tris, rc, unshaded != 0, out, stream);
    case 4: return micro::launch<4>(variant, ctx, res, n, nd, cols, n_tris, rc, unshaded != 0, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
