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
// walk kernel 20 repeats step for step; kernels 18 and 19 walk in another
// order and give the plain walk's answer (walk_closest_ordered,
// walk_any_wide).
//
// Kernel 18: one thread per primary ray, a warp's rays an 8 x 4 tile of
//   pixels, walking the tree nearer child first from ops/bvh.wide_record's
//   two-box node record with a short stack (walk.cuh
//   walk_closest_ordered), its leaf triangles read as 48-byte records; the
//   running best t prunes. A ray whose answer may
//   not be the plain walk's is walked again in preorder (walk_closest,
//   the plain walk step for step).
// Kernel 19: one thread per ray of the flattened leading axes (rays
//   [S, 3, N], t_max [S, N], out [S, N] bool), a plane's rays in 8 x 4
//   pixel tiles a warp, walking the tree nearer child first from the
//   two-box records with a short stack (walk.cuh walk_any_wide), its leaf
//   triangles read as 48-byte records, stopping at the first accepted hit;
//   a ray whose stack fills is walked again in preorder (walk_any).
// Kernel 20: the S <= 16 rays of each pixel (the K lanes of the initial
//   check, the D1*K rays of the MIS ext_vis batch, the (R+1)*K Z rays of
//   the visibility check), each with its own origin (wrs.visibility pushes
//   it along its own direction).
//
// Bound: operations, the box and triangle tests the walk makes (about 22
// operations a box test, one Moller-Trumbore test a triangle); device
// memory sees only rays in and hits out (40 B a closest-hit ray, 29 B an
// any-hit ray). Ray indices are 64-bit: 12 x 1080 x 1920 rays go into one
// launch.
//
// What holds a walk back on the H100 is latency: every step is a dependent
// node load, so the card needs many walks in flight (occupancy), and each
// leaf triangle costs loads. Kernel 18's preorder walk (the parent design)
// took 27.7 dependent node loads a primary ray on the 5x5 torus field and
// met its closest hit late (children in build order); its redesign takes
// both children's boxes in one 64-byte load (12.7 steps a ray), the nearer
// child first, and reads leaf triangles as records. Kernel 19's first
// design walked the preorder on the [10, T] columns (ten scattered floats
// a leaf triangle), a warp's rays a row of 32 pixels; its redesign takes
// kernel 18's steps: the two-box records, 8 x 4 tiles, the triangle
// records, 40 registers. The TPU's kernel 20 shares ONE walk between a
// pixel's S rays to amortise its page DMAs; on this card that union walk
// visits every node any of the S rays needs (S rays going to S different
// light samples), runs up to S slab tests a node serially, and holds 10 S
// floats of ray state a thread (166 registers at S = 12): it lost to the
// per-ray walk of kernel 19. Kernel 20 is therefore a walk per ray: one
// thread per ray, 40 registers whatever S, with a pixel's S rays in
// adjacent lanes (their origins nearly coincide, so a warp shares the top
// of the tree in L1), and its leaf triangles read as 48-byte records (three
// float4, ops/walk.tri_records) instead of ten floats from ten [10, T]
// columns. Each ray's walk is ops/traverse.bvh_any's, operation for
// operation (--fmad=false), so its bool is the plain traversal's; for a
// fixed t_max the any-hit bool is the OR over the triangles of every leaf
// whose box and ancestors' boxes the ray passes, so it depends neither on
// the order of the visits nor on where a ray stops. A lane-per-ray walk of
// one shared cursor a pixel (the TPU's union walk with its S-loop made
// parallel, __any_sync over the group) was measured against it in the same
// call and lost (PERF.md).
#include "walk.cuh"

namespace romis {

constexpr int kWalkThreads = 128;

inline int walk_blocks(long long n) {
  return static_cast<int>((n + kWalkThreads - 1) / kWalkThreads);
}

// Kernel 18 at 12 blocks an SM (40 registers, the stack in local memory).
constexpr int kClosestMinBlocks = 12;

__global__ void __launch_bounds__(kWalkThreads, kClosestMinBlocks)
bvh_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   int h, int w, const float4* __restrict__ nodes,
                   const float4* __restrict__ wide,
                   const float4* __restrict__ recs, float t_max,
                   float* __restrict__ t_out, int* __restrict__ tri_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  const long long p = tile_pixel(
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x, h, w);
  if (p < 0) return;
  const long long n = static_cast<long long>(h) * w;
  const float ox = o[p], oy = o[n + p], oz = o[2 * n + p];
  const float dx = d[p], dy = d[n + p], dz = d[2 * n + p];
  float best_t = t_max, best_u = 0.f, best_v = 0.f;
  int best_i = -1;
  if (!walk_closest_ordered(nodes, wide, RecTris{recs}, ox, oy, oz, dx, dy, dz,
                            t_max, best_t, best_i, best_u, best_v)) {
    best_t = t_max;
    best_i = -1;
    best_u = best_v = 0.f;
    walk_closest(nodes, RecTris{recs}, ox, oy, oz, dx, dy, dz, best_t, best_i,
                 best_u, best_v);
  }
  t_out[p] = best_t;
  tri_out[p] = best_i;
  u_out[p] = best_u;
  v_out[p] = best_v;
}

// Kernel 19: one thread per ray, a plane's rays in 8 x 4 pixel tiles a
// warp (ray i of the launch is pixel tile_pixel(i mod tiled_rays) of plane
// i / tiled_rays), the nearer-first walk on the two-box records with the
// triangle records, the preorder walk again where its stack was full. At
// kAnyMinBlocks blocks an SM (40 registers, the stack in local memory), as
// kernel 18.
constexpr int kAnyMinBlocks = 12;

__global__ void __launch_bounds__(kWalkThreads, kAnyMinBlocks)
bvh_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, int h, int w, int s_n,
               const float4* __restrict__ nodes,
               const float4* __restrict__ wide,
               const float4* __restrict__ recs,
               unsigned char* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per_plane = tiled_rays(h, w);
  const long long si = i / per_plane;
  if (si >= s_n) return;
  const long long p = tile_pixel(i - si * per_plane, h, w);
  if (p < 0) return;
  const long long n_pix = static_cast<long long>(h) * w;
  const long long base = si * 3 * n_pix + p;
  const float ox = o[base], oy = o[base + n_pix], oz = o[base + 2 * n_pix];
  const float dx = d[base], dy = d[base + n_pix], dz = d[base + 2 * n_pix];
  const float tm = t_max[si * n_pix + p];
  int occ = walk_any_wide(nodes, wide, RecTris{recs}, ox, oy, oz, dx, dy, dz, tm);
  if (occ < 0)
    occ = walk_any(nodes, RecTris{recs}, ox, oy, oz, dx, dy, dz, tm) ? 1 : 0;
  out[si * n_pix + p] = static_cast<unsigned char>(occ);
}

// Kernel 20: one thread per ray, a pixel's S rays in adjacent lanes (ray
// p * S + s of the launch is ray s of pixel p), each walking the tree alone
// and stopping at its first hit.
__global__ void __launch_bounds__(kWalkThreads)
bvh_any_k_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_max, long long n_pix, int s_n,
                 const float4* __restrict__ nodes,
                 const float4* __restrict__ recs,
                 unsigned char* __restrict__ out) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_pix * s_n) return;
  const long long p = r / s_n;
  const long long s = r - p * s_n;
  const long long base = s * 3 * n_pix + p;
  const float ox = o[base], oy = o[base + n_pix], oz = o[base + 2 * n_pix];
  const float dx = d[base], dy = d[base + n_pix], dz = d[base + 2 * n_pix];
  const float tm = t_max[s * n_pix + p];
  out[s * n_pix + p] =
      walk_any(nodes, RecTris{recs}, ox, oy, oz, dx, dy, dz, tm) ? 1 : 0;
}

}  // namespace romis

extern "C" int romis_bvh_closest(const float* o, const float* d, int h, int w,
                                 const float* nodes, const float* wide,
                                 const float* recs, float t_max, float* t,
                                 int* tri, float* u, float* v,
                                 cudaStream_t stream) {
  using namespace romis;
  bvh_closest_kernel<<<walk_blocks(tiled_rays(h, w)), kWalkThreads, 0, stream>>>(
      o, d, h, w, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(wide), reinterpret_cast<const float4*>(recs),
      t_max, t, tri, u, v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int romis_bvh_any(const float* o, const float* d, const float* t_max,
                             int h, int w, int s, const float* nodes,
                             const float* wide, const float* recs,
                             unsigned char* out, cudaStream_t stream) {
  using namespace romis;
  bvh_any_kernel<<<walk_blocks(tiled_rays(h, w) * s), kWalkThreads, 0, stream>>>(
      o, d, t_max, h, w, s, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(wide), reinterpret_cast<const float4*>(recs),
      out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int romis_bvh_any_k(const float* o, const float* d, const float* t_max,
                               long long n_pix, int s, const float* nodes,
                               const float* recs, unsigned char* out,
                               cudaStream_t stream) {
  using namespace romis;
  if (s < 1 || s > 16) return static_cast<int>(cudaErrorInvalidValue);
  bvh_any_k_kernel<<<walk_blocks(n_pix * s), kWalkThreads, 0, stream>>>(
      o, d, t_max, n_pix, s, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(recs), out);
  return static_cast<int>(cudaGetLastError());
}
