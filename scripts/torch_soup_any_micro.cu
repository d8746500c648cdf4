// Variants of kernels 6 (the soup any-hit, romis_tpu_torch/csrc/any.cu)
// and 8 (the Plücker any-hit, csrc/plucker.cu) beside the package's, for
// scripts/torch_soup_any_micro.py. The package's sources are included for
// their kernels and walks; the parents (a thread a segment, the soup
// staged in chunks, no cull) are copied here as they were.
#include <type_traits>

#include "any.cu"
#include "plucker.cu"

namespace romis {
namespace {

// Kernel 6's parent: one thread per segment, the [10, T] columns staged in
// 512-triangle chunks, no cull.
__global__ void __launch_bounds__(kThreads)
parent_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max, long long n_pix, long long n_rays,
                  const float* __restrict__ cols, int n_tris, unsigned char* __restrict__ out) {
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
    if (!__syncthreads_or(pending)) break;
    const int cnt = min(kTriChunk, n_tris - base);
    stage_tris(s, cols, n_tris, base, cnt);
    __syncthreads();
    if (!pending) continue;
    for (int j = 0; j < cnt; ++j) {
      float t, u, v;
      if (mt_hit(ox, oy, oz, dx, dy, dz, &s[0][j], kTriChunk, t, u, v) && t < tm) {
        occluded = true;
        pending = false;
        break;
      }
    }
  }
  if (live) out[r] = occluded ? 1 : 0;
}

// Kernel 8's parent: one thread per segment, the [5T, 16] constants staged
// in 128-triangle chunks of 32-float slots, no cull (the table built by
// the caller).
constexpr int kParentChunk = 128;

__device__ __forceinline__ int parent_slot(int k, int j) {
  if (k < 3) return j < 6 ? 8 * k + j : -1;
  if (k == 3) return (j >= 6 && j < 10) ? 18 + j : -1;
  return j < 3 ? 28 + j : -1;
}

__global__ void __launch_bounds__(kThreads)
parent_plucker_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_max, long long n_pix, long long n_rays,
                      const float* __restrict__ cmat, int n_tris,
                      unsigned char* __restrict__ out) {
  __shared__ __align__(16) float s[kParentChunk][kSlots];
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = r < n_rays;
  SegRay sr{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    const long long si = r / n_pix, p = r - si * n_pix;
    const long long base = si * 3 * n_pix + p;
    sr = SegRay{o[base], o[base + n_pix], o[base + 2 * n_pix], d[base], d[base + n_pix],
                d[base + 2 * n_pix], t_max[r]};
  }
  const PluckerTris tris{reinterpret_cast<const float4*>(&s[0][0])};
  const PluckerTris::Ray rv = tris.ray(sr);
  bool pending = live;
  bool occluded = false;
  for (int base = 0; base < n_tris; base += kParentChunk) {
    if (!__syncthreads_or(pending)) break;
    const int cnt = min(kParentChunk, n_tris - base);
    for (int idx = threadIdx.x; idx < 5 * cnt * 16; idx += blockDim.x) {
      const int j = idx % 16, ki = idx / 16;
      const int k = ki / cnt, i = ki - k * cnt;
      const int slot = parent_slot(k, j);
      if (slot >= 0) s[i][slot] = cmat[(static_cast<long long>(k) * n_tris + base + i) * 16 + j];
    }
    __syncthreads();
    if (!pending) continue;
    for (int i = 0; i < cnt; ++i) {
      if (tris.hit(i, rv)) {
        occluded = true;
        pending = false;
        break;
      }
    }
  }
  if (live) out[r] = occluded ? 1 : 0;
}

// The segment orders the package does not take: each plane in 8 x 4
// pixel tiles (tile_pixel, as kernels 18 and 19 take their rays), the
// planes one after another; or the flat index itself.
struct TileMap {
  __host__ __device__ static long long slots(int h, int w, int planes) {
    return tiled_rays(h, w) * planes;
  }
  __device__ __forceinline__ static long long seg(long long i, int h, int w, int planes) {
    const long long per = tiled_rays(h, w);
    const long long plane = i / per;
    const long long p = tile_pixel(i - plane * per, h, w);
    return plane < planes && p >= 0 ? plane * static_cast<long long>(h) * w + p : -1;
  }
};

struct RowMap {
  __host__ __device__ static long long slots(int h, int w, int planes) {
    return (static_cast<long long>(h) * w * planes + 31) / 32 * 32;
  }
  __device__ __forceinline__ static long long seg(long long i, int h, int w, int planes) {
    return i < static_cast<long long>(h) * w * planes ? i : -1;
  }
};

// Kernel 8's constants read from device memory through the caches, not
// staged (the package's test on a device pointer).
struct CachedSlots {
  static size_t floats(int) { return 0; }
  __device__ __forceinline__ static PluckerTris stage(float*, const float* __restrict__ slots,
                                                      const float* __restrict__, int) {
    return PluckerTris{reinterpret_cast<const float4*>(slots)};
  }
};

PersistentGrid micro_any_grids[8];
PersistentGrid micro_plucker_grids[2][4][3];  // [tiles][defer][src]

// Every persistent grid forgets its launch set-up, so the next launch sets
// its kernel's shared-memory attribute again: the package's grids and
// these launch the same kernels at other sizes.
void forget_grids() {
  auto forget = [](PersistentGrid& g) {
    for (int& b : g.blocks) b = 0;
  };
  for (auto& g : any_grids) forget(g);
  for (auto& g : plucker_grids) forget(g);
  for (auto& g : micro_any_grids) forget(g);
  for (auto& a : micro_plucker_grids)
    for (auto& b : a)
      for (auto& g : b) forget(g);
}

// Kernel 8 culled with the triangles from `src` (-1: the package's choice,
// its constants staged where they fit, else formed from the columns; 0
// staged, 1 cached, 2 formed from the columns), the guard deferral kDefer,
// on the segment order Map.
template <class Map, int kDefer>
int micro_plucker_src(int src, const float* o, const float* d, const float* t_max, int h,
                      int w, int planes, const float* slots, const float* cols,
                      const float* boxes, const float* guard, const float* blocks,
                      int n_tris, unsigned char* out, cudaStream_t stream) {
  auto& g = micro_plucker_grids[std::is_same<Map, TileMap>::value][kDefer];
  if (src < 0) src = plucker_staged(n_tris) ? 0 : 2;
  if (src == 0 && !plucker_staged(n_tris)) return static_cast<int>(cudaErrorInvalidValue);
  switch (src) {
    case 0:
      return launch_plucker<true, StagedSlots, Map, kDefer>(
          g[0], o, d, t_max, h, w, planes, slots, cols, boxes, guard, blocks, n_tris, out,
          stream);
    case 1:
      return launch_plucker<true, CachedSlots, Map, kDefer>(
          g[1], o, d, t_max, h, w, planes, slots, cols, boxes, guard, blocks, n_tris, out,
          stream);
    default:
      return launch_plucker<true, StagedCols, Map, kDefer>(
          g[2], o, d, t_max, h, w, planes, slots, cols, boxes, guard, blocks, n_tris, out,
          stream);
  }
}

}  // namespace
}  // namespace romis

// Kernel 6's variants: 0 the package's (romis_any_hit: a pixel's planes in
// adjacent lanes, no guard deferred), 1 the parent, 2 the culled walk on
// 8 x 4 tiles of a plane, 3 rows, 4 every guard deferred, 5 none, 6 the
// unflagged blocks', 7 the flagged blocks' (kernel 4's deferral). A return above 1000 is an error left by a call before the
// entry (1000 + its code).
extern "C" int micro_any(int variant, const float* o, const float* d, const float* t_max,
                         int h, int w, int planes, const float* cols, const float* boxes,
                         const float* normals, int n_tris, const float* raw_cols, int raw_tris,
                         unsigned char* out, cudaStream_t stream) {
  using namespace romis;
  const cudaError_t stale = cudaGetLastError();
  if (stale != cudaSuccess) return 1000 + static_cast<int>(stale);
  forget_grids();
  const long long n = static_cast<long long>(h) * w;
  switch (variant) {
    case 0:
      return romis_any_hit(o, d, t_max, h, w, planes, cols, boxes, normals, n_tris, out,
                           stream);
    case 1:
      parent_any_kernel<<<blocks_for(n * planes), kThreads, 0, stream>>>(
          o, d, t_max, n, n * planes, raw_cols, raw_tris, out);
      return static_cast<int>(cudaGetLastError());
    case 2:
      return launch_any<true, TileMap>(micro_any_grids[2], o, d, t_max, h, w, planes, cols,
                                       boxes, normals, n_tris, out, stream);
    case 3:
      return launch_any<true, RowMap>(micro_any_grids[3], o, d, t_max, h, w, planes, cols,
                                      boxes, normals, n_tris, out, stream);
    case 4:
      return launch_any<true, PixelMap, kDeferAll>(micro_any_grids[4], o, d, t_max, h, w,
                                                  planes, cols, boxes, normals, n_tris, out,
                                                  stream);
    case 5:
      return launch_any<true, PixelMap, kDeferNone>(micro_any_grids[5], o, d, t_max, h, w,
                                                   planes, cols, boxes, normals, n_tris, out,
                                                   stream);
    case 6:
      return launch_any<true, PixelMap, kDeferUnflagged>(micro_any_grids[6], o, d, t_max, h,
                                                        w, planes, cols, boxes, normals,
                                                        n_tris, out, stream);
    case 7:
      return launch_any<true, PixelMap, kDeferFlagged>(micro_any_grids[7], o, d, t_max, h, w,
                                                      planes, cols, boxes, normals, n_tris,
                                                      out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel 8: variant 0 the package's (romis_any_hit_plucker), 1 the parent
// (cmat [5T, 16] in the input order), 2 the culled walk with the
// triangles from `src` (0 staged constants, 1 cached, 2 formed from the
// columns, -1 the package's choice), the guard deferral `defer` (0 none,
// 1 all, 2 the flagged blocks, 3 the others) and `tiles` (8 x 4 tiles of
// a plane, else a pixel's planes adjacent; tiles only with every guard
// deferred). A return above 1000 is an error left by a call before the
// entry (1000 + its code).
extern "C" int micro_plucker(int variant, int src, int defer, int tiles, const float* o,
                             const float* d, const float* t_max, int h, int w, int planes,
                             const float* slots, const float* cols, const float* boxes,
                             const float* guard, const float* blocks, int n_tris,
                             const float* cmat, int raw_tris, unsigned char* out,
                             cudaStream_t stream) {
  using namespace romis;
  const cudaError_t stale = cudaGetLastError();
  if (stale != cudaSuccess) return 1000 + static_cast<int>(stale);
  forget_grids();
  const long long n = static_cast<long long>(h) * w;
  if (variant == 0)
    return romis_any_hit_plucker(o, d, t_max, h, w, planes, slots, cols, boxes, guard,
                                 blocks, n_tris, out, stream);
  if (variant == 1) {
    parent_plucker_kernel<<<blocks_for(n * planes), kThreads, 0, stream>>>(
        o, d, t_max, n, n * planes, cmat, raw_tris, out);
    return static_cast<int>(cudaGetLastError());
  }
#define ROMIS_MICRO8(MAP, DEFER)                                                          \
  micro_plucker_src<MAP, DEFER>(src, o, d, t_max, h, w, planes, slots, cols, boxes, guard, \
                                blocks, n_tris, out, stream)
  if (tiles) return defer == kDeferAll ? ROMIS_MICRO8(TileMap, kDeferAll)
                                       : static_cast<int>(cudaErrorInvalidValue);
  switch (defer) {
    case kDeferNone: return ROMIS_MICRO8(PixelMap, kDeferNone);
    case kDeferAll: return ROMIS_MICRO8(PixelMap, kDeferAll);
    case kDeferFlagged: return ROMIS_MICRO8(PixelMap, kDeferFlagged);
    case kDeferUnflagged: return ROMIS_MICRO8(PixelMap, kDeferUnflagged);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ROMIS_MICRO8
}
