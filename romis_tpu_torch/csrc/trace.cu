// Kernel 1: closest hit of primary rays against a triangle soup.
//
// Replaces romis_tpu/ops/pallas_trace.py pallas_closest / _closest_kernel
// (Möller–Trumbore over an on-chip triangle soup of at most 2048
// triangles). One thread per ray, in persistent thread blocks that stage
// the soup into shared memory once and then loop over the rays, so device
// memory sees rays in and hits out (~40 B a ray). The running best is kept
// in registers; a hit replaces it where it comes first in (t, input index)
// order, so ties go to the lowest input index, as in the reference and the
// plain block scan (ops/intersect.intersect_closest), whatever the order
// the triangles are tested in.
//
// A soup of more than kZBlock triangles is culled as kernels 7 and 4 cull
// it (cull.cuh): the wrapper's blocks (ops/trace.soup_blocks, built once a
// soup, with each slot's input index) are staged with their grown boxes
// and guard data; a ray tests a block's box over [0, best t] before the
// block's triangles, and where the box rejects it the near-parallel guard
// keeps the block if mt_tri's rounding could still accept one of its
// triangles (deferred to a second pass over the final windows for a soup's
// flagged blocks). Until its first hit a ray's window is infinite, which
// would keep every block the guard looks at, so the guard takes the window
// min(best t, kReach * l0), l0 = |o - c|_1 + three half-diagonals; and
// where the ray's line passes far from a block, a growth g' from that
// distance in the place of the box's g (ops/trace.closest_hit_culled
// derives both rules and is the plain model of this walk). The guard's
// pair cones are tried once for a warp of neighbouring rays first
// (soup_closest). Bound: operations, the tests the cull needs (the
// box-alone walk's box and triangle tests; the guard's printed apart).
//
// A soup of at most kZBlock triangles (the flagship's 2, padded to 8) has
// nothing to cull: it is staged as given and each ray tests its triangles
// up to the last active one, the padding left out. Bound: bytes.
#include <algorithm>

#include "cull.cuh"

namespace romis {

constexpr float kReach = 1.0f;  // ops/trace.CLOSEST_REACH

struct Best {
  float t, u, v;
  int i;  // input index, -1 before the first hit
};

// mt_tri of the ray against the staged triangles [j0, j1) (input indices
// idx[j], or j where idx is null), each hit kept where it comes before the
// best in (t, index) order.
__device__ __forceinline__ void tris_closest(const CullSoup& s, const int* idx, int j0,
                                             int j1, float ox, float oy, float oz,
                                             float dx, float dy, float dz, Best& b) {
  for (int j = j0; j < j1; ++j) {
    float t, u, v;
    if (!mt_hit(ox, oy, oz, dx, dy, dz, s.tri + j, s.n_tris, t, u, v)) continue;
    const int i = idx != nullptr ? idx[j] : j;
    if (t < b.t || (t == b.t && i < b.i)) b = Best{t, u, v, i};
  }
}

// The guard of a closest-hit ray over block b (ops/trace.closest_hit_culled
// derives both of its rules) → the reach R: the block is kept where a
// triangle has |d.m| <= R, or wholly (`all`). The box rule: R = L = l0 +
// min(best t, kReach * l0), valid where L stays under the growth over 8u.
// The distance rule: R = 2 l0 g / g', g' = min(2.5 delta, 0.2 l0), delta a
// lower bound of the ray line's distance from the block (its centre's
// distance less the half-diagonal), valid where g' > g. The smaller R
// that is valid; every triangle kept where neither is.
__device__ __forceinline__ float closest_reach(const CullSoup& s, int b, float ox,
                                               float oy, float oz, float dx, float dy,
                                               float dz, float best_t, bool& all) {
  const int nb = s.nb;
  const float l0 = guard_l0(s, b, ox, oy, oz);
  const float reach = l0 + fminf(best_t, kReach * l0);
  const bool box_rule = reach < s.box[10 * nb + b];
  const float cx = s.box[6 * nb + b] - ox, cy = s.box[7 * nb + b] - oy,
              cz = s.box[8 * nb + b] - oz;
  const float qx = cy * dz - cz * dy, qy = cz * dx - cx * dz, qz = cx * dy - cy * dx;
  const float delta = sqrtf(qx * qx + qy * qy + qz * qz) * (1.0f - 0x1p-16f) -
                      s.box[9 * nb + b] * (1.0f / 3.0f) -
                      0x1p-16f * (fabsf(cx) + fabsf(cy) + fabsf(cz));
  const float g = s.box[10 * nb + b] * 0x1p-21f;  // row 10 = g / 8u
  const float gp = fminf(2.5f * delta, 0.2f * l0);
  const float r_delta = gp > g ? (2.0f * l0) * (g / gp) : INFINITY;
  all = !box_rule && !(gp > g);
  return box_rule ? fminf(reach, r_delta) : r_delta;
}

// A lane's guard of block b at the reach closest_reach gives.
__device__ __forceinline__ bool guard_closest(const CullSoup& s, int b, float ox, float oy,
                                              float oz, float dx, float dy, float dz,
                                              float best_t) {
  bool all;
  const float reach = closest_reach(s, b, ox, oy, oz, dx, dy, dz, best_t, all);
  if (all) return true;
  for (int q = 0; q < kZBlock / 2; ++q)
    if (pair_keeps(s, b, q, dx, dy, dz, reach)) return true;
  return false;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// One warp's walk over the culled soup's blocks, a ray a lane (`live`:
// whether the lane has one); every lane of the warp calls it. Per block, a
// lane's box test over [0, best t]; where it fails (and the block is not
// deferred) the near-parallel guard at its reach. The guard's pair cones
// are first tried once for the whole warp: lanes 0-7 test pair `lane`
// against the cone of the warp's directions (d0, the first live lane's,
// and eps, the farthest live direction from it) at the largest reach of the
// lanes that need the guard, |d0.a| - eps |a| - w - slack > reach_max; a
// pair that passes rules out both its triangles for every such lane (|d.a|
// >= |d0.a| - eps |a|; the slack, 2^-12 (|a| + |w| + reach_max), covers the
// roundings), and each lane runs the pair tests of the rest alone. A warp
// of neighbouring primary rays (an 8 x 4 tile) has eps ~ 0.005, so the
// warp's one round takes the place of a lane's eight.
__device__ __forceinline__ void soup_closest(const CullSoup& s, const int* idx, bool live,
                                             float ox, float oy, float oz, float dx,
                                             float dy, float dz, Best& b) {
  const int nb = s.nb;
  const int lane = threadIdx.x & 31;
  const unsigned lanes = __ballot_sync(kFull, live);
  if (lanes == 0u) return;
  const int src = __ffs(lanes) - 1;
  const float d0x = __shfl_sync(kFull, dx, src), d0y = __shfl_sync(kFull, dy, src),
              d0z = __shfl_sync(kFull, dz, src);
  const float ex = dx - d0x, ey = dy - d0y, ez = dz - d0z;
  const float eps = warp_max(live ? sqrtf(ex * ex + ey * ey + ez * ez) : 0.0f) *
                    (1.0f + 0x1p-20f);
  const float ix = slab_inv(dx), iy = slab_inv(dy), iz = slab_inv(dz);
  bool any_deferred = false;
  for (int k = 0; k < nb; ++k) {
    const bool deferred = s.box[12 * nb + k] > 0.5f;  // uniform
    any_deferred = any_deferred || deferred;
    bool keep = live && box_hit(s.box, nb, k, ox, oy, oz, ix, iy, iz, b.t);
    const bool need = live && !keep && !deferred;
    if (__any_sync(kFull, need)) {
      bool all = false;
      const float reach =
          need ? closest_reach(s, k, ox, oy, oz, dx, dy, dz, b.t, all) : 0.0f;
      const float rmax = warp_max(need && !all ? reach : 0.0f);
      bool out = false;
      if (lane < kZBlock / 2) {
        const float4 c = s.pairs[k * (kZBlock / 2) + lane];
        const float na = fabsf(c.x) + fabsf(c.y) + fabsf(c.z);
        out = c.w == -INFINITY ||
              fabsf(d0x * c.x + d0y * c.y + d0z * c.z) - eps * na - c.w -
                      0x1p-12f * (na + fabsf(c.w) + rmax) > rmax;
      }
      const unsigned pairs = ~__ballot_sync(kFull, out) & 0xffu;
      if (need) {
        keep = all;
        for (unsigned m = pairs; !keep && m != 0u; m &= m - 1u)
          keep = pair_keeps(s, k, __ffs(m) - 1, dx, dy, dz, reach);
      }
    }
    if (keep)
      tris_closest(s, idx, k * kZBlock, k * kZBlock + static_cast<int>(s.box[11 * nb + k]),
                   ox, oy, oz, dx, dy, dz, b);
  }
  // The flagged blocks' guard, lane by lane, over the windows the first
  // pass left.
  for (int k = 0; live && any_deferred && k < nb; ++k) {
    if (!(s.box[12 * nb + k] > 0.5f) ||
        box_hit(s.box, nb, k, ox, oy, oz, ix, iy, iz, b.t) ||
        !guard_closest(s, k, ox, oy, oz, dx, dy, dz, b.t))
      continue;
    tris_closest(s, idx, k * kZBlock, k * kZBlock + static_cast<int>(s.box[11 * nb + k]),
                 ox, oy, oz, dx, dy, dz, b);
  }
}

template <bool kMany>
constexpr int closest_threads() { return kMany ? 1024 : 256; }

extern __shared__ float closest_smem[];

// Persistent blocks: stage the soup (kMany: the culled soup and its input
// indices; else the columns as given), then one ray a thread at a time.
template <bool kMany>
__global__ void __launch_bounds__(closest_threads<kMany>())
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d, int h,
                   int w, const float* __restrict__ cols,
                   const float* __restrict__ boxes, const float* __restrict__ normals,
                   const int* __restrict__ index, int n_tris, float t_max,
                   float* __restrict__ t_out, int* __restrict__ tri_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  CullSoup s;
  int* idx = nullptr;
  if (kMany) {
    s = stage_cull(closest_smem, cols, boxes, normals, n_tris);
    idx = reinterpret_cast<int*>(closest_smem + 15 * n_tris + 13 * (n_tris / kZBlock));
    for (int i = threadIdx.x; i < n_tris; i += blockDim.x) idx[i] = index[i];
  } else {
    for (int i = threadIdx.x; i < 10 * n_tris; i += blockDim.x) closest_smem[i] = cols[i];
    s = CullSoup{closest_smem, nullptr, nullptr, nullptr, n_tris, 0};
  }
  __syncthreads();
  int end = 0;  // one past the last active triangle (the direct loop's)
  if (!kMany)
    for (int j = 0; j < n_tris; ++j)
      if (s.tri[9 * n_tris + j] > 0.0f) end = j + 1;
  const long long n = static_cast<long long>(h) * w;
  // A culled soup's rays in tiles, whole warps at a time (the walk's warp
  // votes); the direct loop's row by row.
  const long long rays = kMany ? tiled_rays(h, w) : n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < rays; i += stride) {
    const long long p = kMany ? tile_pixel(i, h, w) : i;
    const bool live = p >= 0;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    if (live) {
      ox = o[p]; oy = o[n + p]; oz = o[2 * n + p];
      dx = d[p]; dy = d[n + p]; dz = d[2 * n + p];
    }
    Best b{t_max, 0.f, 0.f, -1};
    if (kMany)
      soup_closest(s, idx, live, ox, oy, oz, dx, dy, dz, b);
    else
      tris_closest(s, nullptr, 0, end, ox, oy, oz, dx, dy, dz, b);
    if (live) {
      t_out[p] = b.i >= 0 ? b.t : INFINITY;
      tri_out[p] = b.i;
      u_out[p] = b.u;
      v_out[p] = b.v;
    }
  }
}

namespace {
PersistentGrid closest_grids[2];  // [kMany]
}  // namespace

template <bool kMany>
int launch_closest(const float* o, const float* d, int h, int w, const float* cols,
                   const float* boxes, const float* normals, const int* index,
                   int n_tris, float t_max, float* t, int* tri, float* u, float* v,
                   cudaStream_t stream) {
  PersistentGrid& grids = closest_grids[kMany];
  const size_t smem = kMany ? cull_smem_bytes(n_tris) + sizeof(int) * n_tris
                            : sizeof(float) * 10 * static_cast<size_t>(n_tris);
  auto kernel = closest_hit_kernel<kMany>;
  constexpr int kThr = closest_threads<kMany>();
  int blocks = 0;
  const int err = persistent_blocks(grids, kernel, kThr, smem, blocks);
  if (err != 0) return err;
  const long long rays = kMany ? tiled_rays(h, w) : static_cast<long long>(h) * w;
  const int grid = static_cast<int>(std::min<long long>((rays + kThr - 1) / kThr, blocks));
  kernel<<<grid, kThr, smem, stream>>>(o, d, h, w, cols, boxes, normals, index, n_tris,
                                       t_max, t, tri, u, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace romis

// A culled soup: cols [10, T] block-ordered, T a multiple of kZBlock above
// it (at most 2048), boxes [13, T / kZBlock], normals [5, T], index [T]
// (ops/trace.soup_blocks). A soup of at most kZBlock triangles: its cols
// [10, T] as given (T may be 0), boxes, normals and index null.
extern "C" int romis_closest_hit(const float* o, const float* d, int h, int w,
                                 const float* cols, const float* boxes,
                                 const float* normals, const int* index, int n_tris,
                                 float t_max, float* t, int* tri, float* u, float* v,
                                 cudaStream_t stream) {
  using namespace romis;
  const bool many = boxes != nullptr;
  if (many ? (normals == nullptr || index == nullptr || n_tris <= kZBlock ||
              n_tris % kZBlock != 0 || n_tris > 2048)
           : (normals != nullptr || index != nullptr || n_tris < 0 || n_tris > kZBlock))
    return static_cast<int>(cudaErrorInvalidValue);
  return many ? launch_closest<true>(o, d, h, w, cols, boxes, normals, index, n_tris,
                                     t_max, t, tri, u, v, stream)
              : launch_closest<false>(o, d, h, w, cols, boxes, normals, index, n_tris,
                                      t_max, t, tri, u, v, stream);
}
