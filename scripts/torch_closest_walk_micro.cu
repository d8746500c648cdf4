// Variants of kernels 18 (the BVH closest hit, csrc/walk.cu) and 1 (the
// soup closest hit, csrc/trace.cu) that the package leaves out, for
// scripts/torch_closest_walk_micro.py. The package's walk.cu and trace.cu
// are included for their walks (walk.cuh walk_closest_ordered and
// walk_closest, trace.cu tris_closest) and the staged soup (cull.cuh).
// Every variant reads the package's inputs (the node records, bvh.wide,
// the kept triangle records; the blocks of ops/trace.soup_blocks) and
// writes t, tri, u, v.
//
// Kernel 18, one thread a primary ray of an h x w frame, blocks of 128:
// - variant 1: a warp's rays a row of 32 pixels, no register bound (the
//   first design of the walk);
// - variant 2: 8 x 4 tiles a warp, no register bound;
// - variant 3: the parent's walk (preorder, one cursor) on the records,
//   rows of 32;
// - variant 4: the package's kernel reading the [10, T] columns.
// Kernel 1 on a culled soup, persistent blocks of 1024 threads:
// - variant 1: each lane's guard alone, its box rule only, all eight pair
//   cones a block, a warp's rays a row of 32 (the first design);
// - variant 2: variant 1 on 8 x 4 tiles;
// - variant 3: the box alone, no near-parallel guard, on tiles (timing
//   only: its answer may differ where the guard decides; the rays are
//   counted);
// - variant 4: variant 2 with the blocks visited nearest first, by the
//   distance of their centres from a block's first ray's origin (sorted
//   once a block after the staging; primary rays share their origin).
#include "trace.cu"
#include "walk.cu"
#include "torch_walk_micro_coltris.cuh"

namespace micro {
using namespace romis;

template <bool kTiles>
__device__ __forceinline__ long long pixel_of(long long i, int h, int w) {
  if (kTiles) return tile_pixel(i, h, w);
  return i < static_cast<long long>(h) * w ? i : -1;
}

template <bool kTiles, int kVariant>
__device__ __forceinline__ void walk_one(const float* __restrict__ o,
                                         const float* __restrict__ d, long long n,
                                         long long p, const float4* __restrict__ nodes,
                                         const float4* __restrict__ wide,
                                         const float4* __restrict__ recs,
                                         const float* __restrict__ cols, int n_tris,
                                         float t_max, float* t_out, int* tri_out,
                                         float* u_out, float* v_out) {
  const float ox = o[p], oy = o[n + p], oz = o[2 * n + p];
  const float dx = d[p], dy = d[n + p], dz = d[2 * n + p];
  float best_t = t_max, best_u = 0.f, best_v = 0.f;
  int best_i = -1;
  if (kVariant == 3) {
    walk_closest(nodes, RecTris{recs}, ox, oy, oz, dx, dy, dz, best_t, best_i,
                 best_u, best_v);
  } else {
    bool sure;
    if (kVariant == 4)
      sure = walk_closest_ordered(nodes, wide, ColTris{cols, n_tris}, ox, oy, oz,
                                  dx, dy, dz, t_max, best_t, best_i, best_u, best_v);
    else
      sure = walk_closest_ordered(nodes, wide, RecTris{recs}, ox, oy, oz, dx, dy,
                                  dz, t_max, best_t, best_i, best_u, best_v);
    if (!sure) {
      best_t = t_max;
      best_i = -1;
      best_u = best_v = 0.f;
      walk_closest(nodes, RecTris{recs}, ox, oy, oz, dx, dy, dz, best_t, best_i,
                   best_u, best_v);
    }
  }
  t_out[p] = best_t;
  tri_out[p] = best_i;
  u_out[p] = best_u;
  v_out[p] = best_v;
}

template <int kThr, int kMinBlocks, bool kTiles, int kVariant>
__global__ void __launch_bounds__(kThr, kMinBlocks)
walk_v(const float* __restrict__ o, const float* __restrict__ d, int h, int w,
       const float4* __restrict__ nodes, const float4* __restrict__ wide,
       const float4* __restrict__ recs, const float* __restrict__ cols, int n_tris,
       float t_max, float* t_out, int* tri_out, float* u_out, float* v_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long p = pixel_of<kTiles>(i, h, w);
  if (p < 0) return;
  walk_one<kTiles, kVariant>(o, d, static_cast<long long>(h) * w, p, nodes, wide,
                             recs, cols, n_tris, t_max, t_out, tri_out, u_out,
                             v_out);
}

template <int kThr, int kMinBlocks, bool kTiles, int kVariant>
int launch_walk(const float* o, const float* d, int h, int w, const float* nodes,
                const float* wide, const float* recs, const float* cols, int n_tris,
                float t_max, float* t, int* tri, float* u, float* v,
                cudaStream_t stream) {
  const long long rays = kTiles ? tiled_rays(h, w) : static_cast<long long>(h) * w;
  const int grid = static_cast<int>((rays + kThr - 1) / kThr);
  walk_v<kThr, kMinBlocks, kTiles, kVariant><<<grid, kThr, 0, stream>>>(
      o, d, h, w, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(wide), reinterpret_cast<const float4*>(recs),
      cols, n_tris, t_max, t, tri, u, v);
  return static_cast<int>(cudaGetLastError());
}

// ---- kernel 1 ----

// The first design's guard: the box rule alone, at the reach l0 + min(best
// t, kReach * l0), all eight pair cones a lane.
__device__ __forceinline__ bool box_rule_keeps(const CullSoup& s, int k, float ox,
                                               float oy, float oz, float dx, float dy,
                                               float dz, float best_t) {
  const float l0 = guard_l0(s, k, ox, oy, oz);
  return guard_keeps_at(s, k, dx, dy, dz, l0 + fminf(best_t, kReach * l0));
}

// A lane's walk with its own guard (box_rule_keeps), or the box alone
// (kGuard false), over the blocks in the order `order` (null: 0 .. nb -
// 1).
template <bool kGuard>
__device__ __forceinline__ void soup_closest_v(const CullSoup& s, const int* idx,
                                               const unsigned short* order, float ox,
                                               float oy, float oz, float dx, float dy,
                                               float dz, Best& b) {
  const int nb = s.nb;
  const float ix = slab_inv(dx), iy = slab_inv(dy), iz = slab_inv(dz);
  bool any_deferred = false;
  for (int q = 0; q < nb; ++q) {
    const int k = order != nullptr ? order[q] : q;
    const bool deferred = s.box[12 * nb + k] > 0.5f;
    any_deferred = any_deferred || deferred;
    if (box_hit(s.box, nb, k, ox, oy, oz, ix, iy, iz, b.t) ||
        (kGuard && !deferred && box_rule_keeps(s, k, ox, oy, oz, dx, dy, dz, b.t)))
      tris_closest(s, idx, k * kZBlock, k * kZBlock + static_cast<int>(s.box[11 * nb + k]),
                   ox, oy, oz, dx, dy, dz, b);
  }
  for (int k = 0; kGuard && any_deferred && k < nb; ++k) {
    if (!(s.box[12 * nb + k] > 0.5f) ||
        box_hit(s.box, nb, k, ox, oy, oz, ix, iy, iz, b.t) ||
        !box_rule_keeps(s, k, ox, oy, oz, dx, dy, dz, b.t))
      continue;
    tris_closest(s, idx, k * kZBlock, k * kZBlock + static_cast<int>(s.box[11 * nb + k]),
                 ox, oy, oz, dx, dy, dz, b);
  }
}

extern __shared__ float micro_smem[];

template <int kThr, bool kTiles, bool kGuard, bool kSort>
__global__ void __launch_bounds__(kThr)
soup_v(const float* __restrict__ o, const float* __restrict__ d, int h, int w,
       const float* __restrict__ cols, const float* __restrict__ boxes,
       const float* __restrict__ normals, const int* __restrict__ index, int n_tris,
       float t_max, float* t_out, int* tri_out, float* u_out, float* v_out) {
  const long long n = static_cast<long long>(h) * w;
  const int nb = n_tris / kZBlock;
  const CullSoup s = stage_cull(micro_smem, cols, boxes, normals, n_tris);
  int* idx = reinterpret_cast<int*>(micro_smem + 15 * n_tris + 13 * nb);
  unsigned short* order = reinterpret_cast<unsigned short*>(idx + n_tris);
  for (int i = threadIdx.x; i < n_tris; i += blockDim.x) idx[i] = index[i];
  __syncthreads();
  const long long rays = kTiles ? tiled_rays(h, w) : n;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x;
  if (kSort && threadIdx.x == 0) {  // the blocks by their centres' distance
    const long long p0 = pixel_of<kTiles>(first < rays ? first : 0, h, w);
    const long long q0 = p0 < 0 ? 0 : p0;
    const float ox = o[q0], oy = o[n + q0], oz = o[2 * n + q0];
    float* key = reinterpret_cast<float*>(order + nb + (nb & 1));
    for (int k = 0; k < nb; ++k) {
      const float cx = s.box[6 * nb + k] - ox, cy = s.box[7 * nb + k] - oy,
                  cz = s.box[8 * nb + k] - oz;
      const float kk = cx * cx + cy * cy + cz * cz;
      int j = k;
      while (j > 0 && key[j - 1] > kk) {
        key[j] = key[j - 1];
        order[j] = order[j - 1];
        --j;
      }
      key[j] = kk;
      order[j] = static_cast<unsigned short>(k);
    }
  }
  if (kSort) __syncthreads();
  for (long long i = first + threadIdx.x; i < rays;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = pixel_of<kTiles>(i, h, w);
    if (p < 0) continue;
    const float ox = o[p], oy = o[n + p], oz = o[2 * n + p];
    const float dx = d[p], dy = d[n + p], dz = d[2 * n + p];
    Best b{t_max, 0.f, 0.f, -1};
    soup_closest_v<kGuard>(s, idx, kSort ? order : nullptr, ox, oy, oz, dx, dy, dz, b);
    t_out[p] = b.i >= 0 ? b.t : INFINITY;
    tri_out[p] = b.i;
    u_out[p] = b.u;
    v_out[p] = b.v;
  }
}

template <int kThr, bool kTiles, bool kGuard, bool kSort>
int launch_soup(const float* o, const float* d, int h, int w, const float* cols,
                const float* boxes, const float* normals, const int* index, int n_tris,
                float t_max, float* t, int* tri, float* u, float* v,
                cudaStream_t stream) {
  static PersistentGrid grids;  // one a variant (this library alone has them)
  const int nb = n_tris / kZBlock;
  const size_t smem = cull_smem_bytes(n_tris) + sizeof(int) * n_tris +
                      sizeof(unsigned short) * (nb + 1) + sizeof(float) * nb;
  auto kernel = soup_v<kThr, kTiles, kGuard, kSort>;
  int blocks = 0;
  const int err = persistent_blocks(grids, kernel, kThr, smem, blocks);
  if (err != 0) return err;
  kernel<<<blocks, kThr, smem, stream>>>(o, d, h, w, cols, boxes, normals, index,
                                         n_tris, t_max, t, tri, u, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace micro

extern "C" int micro_walk(int variant, const float* o, const float* d, int h, int w,
                          const float* nodes, const float* wide, const float* recs,
                          const float* cols, int n_tris, float t_max, float* t,
                          int* tri, float* u, float* v, cudaStream_t stream) {
  using namespace micro;
#define MICRO_WALK(THR, MIN, TILES, V) \
  launch_walk<THR, MIN, TILES, V>(o, d, h, w, nodes, wide, recs, cols, n_tris, t_max, \
                                  t, tri, u, v, stream)
  switch (variant) {
    case 1: return MICRO_WALK(128, 1, false, 0);
    case 2: return MICRO_WALK(128, 1, true, 0);
    case 3: return MICRO_WALK(128, 1, false, 3);
    case 4: return MICRO_WALK(128, kClosestMinBlocks, true, 4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MICRO_WALK
}

extern "C" int micro_soup(int variant, const float* o, const float* d, int h, int w,
                          const float* cols, const float* boxes, const float* normals,
                          const int* index, int n_tris, float t_max, float* t, int* tri,
                          float* u, float* v, cudaStream_t stream) {
  using namespace micro;
#define MICRO_SOUP(THR, TILES, GUARD, SORT) \
  launch_soup<THR, TILES, GUARD, SORT>(o, d, h, w, cols, boxes, normals, index, n_tris, \
                                       t_max, t, tri, u, v, stream)
  switch (variant) {
    case 1: return MICRO_SOUP(1024, false, true, false);
    case 2: return MICRO_SOUP(1024, true, true, false);
    case 3: return MICRO_SOUP(1024, true, false, false);
    case 4: return MICRO_SOUP(1024, true, true, true);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MICRO_SOUP
}
