// Kernel 8: boolean occlusion of segments by the Plücker sign test.
//
// Replaces romis_tpu/ops/pallas_trace.py pallas_any_mxu / _any_mxu_kernel.
// Each triangle has five rows of side constants (ops/trace.plucker_matrix,
// [5T, 16]): its three Plücker edge rows [m_e, d_e], its plane row
// [n, -n·a] and the n·D row; inactive triangles have all-zero rows. A
// segment is the 10-vector R = [D, M, p0, 1] with D = t_max·d and
// M = p0 × D. It crosses the triangle where the three edge sides share a
// sign (inclusive: all >= 0 or all <= 0) and s0·(s0 + ds) < 0 (strict),
// s0 the plane row's product and ds the n·D row's. A zero row passes the
// sign test but fails the strict straddle, so it never occludes.
//
// The TPU kernel computes S = C·R as one MXU product per 1024-ray tile.
// Here a thread takes a segment, keeps its R in registers and forms the
// five products of a triangle in the kernel body, in float32 with no
// tensor cores, over each row's non-zero columns only
// (ops/trace.PLUCKER_COLS), summed left to right as the plain version
// (ops/trace.any_hit_plucker_plain) sums them; a term left out is exactly
// zero, so every finite side is that of the full 10-term product but for
// the sign of a zero, which the test does not read. Built with
// --fmad=false, kernel and plain version give the same bool on every
// segment, sign boundaries included. A segment stops at its first
// occluding triangle, which changes no bool.
//
// The constants are kept with the soup (ops/trace.plucker_blocks, built at
// its first call and rebuilt when its columns are written to), each
// triangle's non-zero columns in 32 floats (the edge rows at 0, 8 and 16,
// six floats each, the plane row at 24, the n·D row at 28): a triangle is
// eight 16-byte reads. A soup of more than kZBlock triangles is culled by
// the blocks of ops/trace.soup_blocks (the constants in the blocks'
// order), with cull.cuh's soup_any, the walk of kernels 4 and 6: a
// block's box over [0, t_max] before its triangles, and where the box
// rejects a segment kernel 8's own near-parallel guard, whose reach
// ops/trace.any_hit_plucker_culled derives from the Plücker test's
// rounding (world-frame terms, not the origin's distance to the block)
// and is the plain model of the walk; the guard of a block whose pairs
// have cones (zcount_blocks' row 12 unflagged) is deferred to a second
// pass over the segments left pending. The boxes and the guard
// are staged into shared memory once a persistent thread block, with the
// constants where they fit (StagedSlots: up to ~1500 triangles); a
// larger soup stages its [10, T] columns instead and forms each
// triangle's constants in the kernel, bit for bit as the table rounds
// them (StagedCols; 2048 triangles' constants are 256 KB, beyond a
// block's shared memory, and read through the caches they wait on L2). A
// pixel's planes go to adjacent lanes. Bound: operations, the walk's box
// tests and the 3 x 11 + 7 + 5 + 11 float operations of the products and
// the sign test a triangle test, a segment's set-up (the box alone
// deciding; the guard's printed apart).
//
// A soup of at most kZBlock triangles (the flagship's 2, padded to 8) is
// staged whole and each segment tests its triangles up to the last one
// whose plane row is not zero (the others never occlude), row by row.
#include <algorithm>

#include "cull.cuh"

namespace romis {

constexpr int kSlots = 32;  // a triangle's constants: 8 float4

// A segment as the Plücker test reads it: D = t_max·d, M = p0 x D, p0.
struct PluckerRay {
  float bx, by, bz, mx, my, mz, ox, oy, oz;
};

__device__ __forceinline__ PluckerRay plucker_ray(const SegRay& r) {
  const float bx = r.tm * r.dx, by = r.tm * r.dy, bz = r.tm * r.dz;
  return PluckerRay{bx, by, bz, r.oy * bz - r.oz * by, r.oz * bx - r.ox * bz,
                    r.ox * by - r.oy * bx, r.ox, r.oy, r.oz};
}

__device__ __forceinline__ PluckerRay shfl_plucker(const PluckerRay& r, int from) {
  return PluckerRay{__shfl_sync(kFull, r.bx, from), __shfl_sync(kFull, r.by, from),
                    __shfl_sync(kFull, r.bz, from), __shfl_sync(kFull, r.mx, from),
                    __shfl_sync(kFull, r.my, from), __shfl_sync(kFull, r.mz, from),
                    __shfl_sync(kFull, r.ox, from), __shfl_sync(kFull, r.oy, from),
                    __shfl_sync(kFull, r.oz, from)};
}

// The sign test and the straddle of the five sides.
__device__ __forceinline__ bool plucker_accepts(float e0, float e1, float e2, float s0,
                                                float ds) {
  const bool same = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
                    (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
  return same && s0 * (s0 + ds) < 0.0f;
}

// The Plücker test against triangles' constants [T, kSlots] (float4 *
// 8 a triangle).
struct PluckerTris {
  const float4* slot;
  using Ray = PluckerRay;
  __device__ __forceinline__ Ray ray(const SegRay& r) const { return plucker_ray(r); }
  __device__ __forceinline__ static Ray shfl(const Ray& r, int from) {
    return shfl_plucker(r, from);
  }
  __device__ __forceinline__ bool hit(int j, const Ray& r) const {
    const float4* c4 = slot + 8 * j;
    float edge[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // [m_e, d_e]·[D, M], summed left to right.
      const float4 a = c4[2 * k];
      const float4 b = c4[2 * k + 1];
      float acc = a.x * r.bx;
      acc = acc + a.y * r.by;
      acc = acc + a.z * r.bz;
      acc = acc + a.w * r.mx;
      acc = acc + b.x * r.my;
      acc = acc + b.y * r.mz;
      edge[k] = acc;
    }
    const float4 pl = c4[6];  // [n, -n·a]·[p0, 1]
    float s0 = pl.x * r.ox;
    s0 = s0 + pl.y * r.oy;
    s0 = s0 + pl.z * r.oz;
    s0 = s0 + pl.w * 1.0f;
    const float4 nd = c4[7];  // n·D
    float ds = nd.x * r.bx;
    ds = ds + nd.y * r.by;
    ds = ds + nd.z * r.bz;
    return plucker_accepts(edge[0], edge[1], edge[2], s0, ds);
  }
};

// The Plücker test with each triangle's constants formed in the kernel
// from the staged [10, T] columns, as ops/trace.plucker_rows rounds them
// (a = v0, b = v0 + e1, c = v0 + e2; an edge p -> q's m = p x q, each
// product rounded before the difference, d = q - p; n = e1 x e2, the
// plane's -((n0 a0 + n1 a1) + n2 a2)), so the sides are the table's
// bit for bit; an inactive triangle (all-zero rows) never occludes.
struct PluckerColTris {
  const float* tri;
  int n_tris;
  using Ray = PluckerRay;
  __device__ __forceinline__ Ray ray(const SegRay& r) const { return plucker_ray(r); }
  __device__ __forceinline__ static Ray shfl(const Ray& r, int from) {
    return shfl_plucker(r, from);
  }
  __device__ __forceinline__ static float side(float px, float py, float pz, float qx,
                                               float qy, float qz, const Ray& r) {
    float acc = (py * qz - pz * qy) * r.bx;
    acc = acc + (pz * qx - px * qz) * r.by;
    acc = acc + (px * qy - py * qx) * r.bz;
    acc = acc + (qx - px) * r.mx;
    acc = acc + (qy - py) * r.my;
    acc = acc + (qz - pz) * r.mz;
    return acc;
  }
  __device__ __forceinline__ bool hit(int j, const Ray& r) const {
    const Tri t = load_tri(tri + j, n_tris);
    if (!t.active) return false;
    const float bx = t.v0x + t.e1x, by = t.v0y + t.e1y, bz = t.v0z + t.e1z;
    const float cx = t.v0x + t.e2x, cy = t.v0y + t.e2y, cz = t.v0z + t.e2z;
    const float e0 = side(t.v0x, t.v0y, t.v0z, bx, by, bz, r);
    const float e1 = side(bx, by, bz, cx, cy, cz, r);
    const float e2 = side(cx, cy, cz, t.v0x, t.v0y, t.v0z, r);
    const float nx = t.e1y * t.e2z - t.e1z * t.e2y;
    const float ny = t.e1z * t.e2x - t.e1x * t.e2z;
    const float nz = t.e1x * t.e2y - t.e1y * t.e2x;
    const float w = -((nx * t.v0x + ny * t.v0y) + nz * t.v0z);
    float s0 = nx * r.ox;
    s0 = s0 + ny * r.oy;
    s0 = s0 + nz * r.oz;
    s0 = s0 + w * 1.0f;
    float ds = nx * r.bx;
    ds = ds + ny * r.by;
    ds = ds + nz * r.bz;
    return plucker_accepts(e0, e1, e2, s0, ds);
  }
};

// Kernel 8's guard (ops/trace._plucker_keeps; any_hit_plucker_culled
// derives it): the reach of the box rule (valid while the window stays
// under the growth over 8u) and of the line rule (valid where the line
// passes the block at a distance delta > 0), the smaller; the block is kept
// wholly where neither holds or the segment lies outside the bound's
// range, else where a pair's cone and then one of its triangles' m has
// |u.m| <= reach. `p` holds the staged boxes and kernel 8's guard [5, T]
// in zcount_blocks' layout (p.nrm, p.pairs); q its blocks' Q and Q'.
constexpr float kReachO = 1.17f;    // ops/trace.PLUCKER_REACH_O
constexpr float kReachLen = 0.17f;  // PLUCKER_REACH_LEN
constexpr float kReachG = 0.02f;    // PLUCKER_REACH_G
constexpr float kFar = 1e12f;       // PLUCKER_FAR
constexpr float kLenMin = 1e-12f;   // PLUCKER_LEN_MIN

template <int kDefer>
struct PluckerGuard {
  CullSoup p;
  const float* q;  // [2, nb]
  __device__ __forceinline__ bool deferred(int b) const { return defers<kDefer>(p, b); }
  __device__ __forceinline__ GuardRay ray(const SegRay& r) const { return guard_ray(r); }
  __device__ __forceinline__ bool pairs_keep(int b, const GuardRay& g, float reach) const {
#pragma unroll 2
    for (int k = 0; k < kZBlock / 2; ++k)
      if (pair_keeps(p, b, k, g.ux, g.uy, g.uz, reach)) return true;
    return false;
  }
  // The smaller reach of the rules that hold keeps a block where a pair's
  // triangle lies within it. The box rule's reach, the cheaper, is tried
  // first: a block it drops the smaller reach drops too.
  __device__ __forceinline__ bool keeps(int b, const SegRay& r, const GuardRay& g) const {
    const int nb = p.nb;
    if (!(g.len > kLenMin && g.len < kFar && g.norm_o < kFar)) return true;
    const float l0 = guard_l0(p, b, r.ox, r.oy, r.oz);
    const float gg = p.box[10 * nb + b] * 0x1p-21f;  // row 10 = g / 8u
    float reach = INFINITY;
    if (l0 + g.len < p.box[10 * nb + b]) {
      reach = (q[b] + kReachO * g.norm_o + kReachLen * g.len) * 1.001f + kReachG * gg;
      if (!pairs_keep(b, g, reach)) return false;
    }
    const float cx = p.box[6 * nb + b] - r.ox, cy = p.box[7 * nb + b] - r.oy,
                cz = p.box[8 * nb + b] - r.oz;
    const float qx = cy * g.uz - cz * g.uy, qy = cz * g.ux - cx * g.uz,
                qz = cx * g.uy - cy * g.ux;
    const float delta = sqrtf(qx * qx + qy * qy + qz * qz) * (1.0f - 0x1p-16f) -
                        p.box[9 * nb + b] * (1.0f / 3.0f) -
                        0x1p-16f * (fabsf(cx) + fabsf(cy) + fabsf(cz));
    if (!(delta > 0.0f)) return true;  // the box rule kept it, or neither holds
    const float line = (gg * 0.125f / delta) * (q[nb + b] + g.norm_o) * 1.001f + kReachG * gg;
    if (!(line < reach)) return true;  // the box rule's reach kept it
    return pairs_keep(b, g, line);
  }
};

template <bool kMany>
constexpr int plucker_threads() { return kMany ? 1024 : 256; }

// The guard deferred for the blocks with cones (cheap, and most segments
// hit before they need it), at once for the blocks without (its 16
// normals a block: run in step with the warp's other lanes, not by the
// few lanes a second pass leaves).
constexpr int kPluckerDefer = kDeferUnflagged;

// Where a culled soup's triangles come from: their constants staged into
// shared memory where they fit (StagedSlots), else the [10, T] columns
// staged and each triangle's constants formed in the kernel (StagedCols:
// 2048 triangles' constants are 256 KB, beyond a block's shared memory,
// and read through the caches they wait on L2). Each stages its data from
// `at` (16-byte aligned) and gives the test.
struct StagedSlots {
  static size_t floats(int n_tris) { return kSlots * static_cast<size_t>(n_tris); }
  __device__ __forceinline__ static PluckerTris stage(float* at, const float* __restrict__ slots,
                                                      const float* __restrict__, int n_tris) {
    float4* st4 = reinterpret_cast<float4*>(at);
    const float4* src = reinterpret_cast<const float4*>(slots);
    for (int i = threadIdx.x; i < 8 * n_tris; i += blockDim.x) st4[i] = src[i];
    return PluckerTris{st4};
  }
};

struct StagedCols {
  static size_t floats(int n_tris) { return 10 * static_cast<size_t>(n_tris); }
  __device__ __forceinline__ static PluckerColTris stage(float* at, const float* __restrict__,
                                                         const float* __restrict__ cols,
                                                         int n_tris) {
    for (int i = threadIdx.x; i < 10 * n_tris; i += blockDim.x) at[i] = cols[i];
    return PluckerColTris{at, n_tris};
  }
};

// Shared memory: the guard [5, T] (its pairs' float4 at 3T, 16-byte
// aligned), the boxes [13, nb], the blocks' Q and Q' [2, nb], then the
// triangles' source from the next 16-byte boundary; a soup of one block
// its constants alone.
__host__ __device__ inline int plucker_tris_at(int n_tris) {
  return (5 * n_tris + 15 * (n_tris / kZBlock) + 3) & ~3;
}

template <bool kMany, class Src>
size_t plucker_smem_bytes(int n_tris) {
  return sizeof(float) * (kMany ? plucker_tris_at(n_tris) + Src::floats(n_tris)
                                : StagedSlots::floats(n_tris));
}

extern __shared__ __align__(16) float plucker_smem[];

// The persistent loop: each thread's segments (whole warps on a culled
// soup) through soup_any with the triangles `tris`.
template <bool kMany, class Map, class Tris, class Guard>
__device__ __forceinline__ void plucker_segments(const CullSoup& s, const Tris& tris,
                                                 const Guard& pg, int end,
                                                 const float* __restrict__ o,
                                                 const float* __restrict__ d,
                                                 const float* __restrict__ t_max, int h,
                                                 int w, int planes,
                                                 unsigned char* __restrict__ out) {
  const long long n = static_cast<long long>(h) * w;
  const long long count = kMany ? Map::slots(h, w, planes) : n * planes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    const long long r = kMany ? Map::seg(i, h, w, planes) : i;
    const bool live = r >= 0;
    SegRay sr{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (live) {
      const long long base = r / n * 3 * n + r % n;
      sr = SegRay{o[base], o[base + n], o[base + 2 * n], d[base], d[base + n],
                  d[base + 2 * n], t_max[r]};
      // A negative t_max is the segment (-d, -t_max): the same D and M,
      // bit for bit, on a window the walk's box test reads.
      if (sr.tm < 0.0f) sr = SegRay{sr.ox, sr.oy, sr.oz, -sr.dx, -sr.dy, -sr.dz, -sr.tm};
    }
    // t_max = 0 (D = 0) and NaN never occlude: not traced.
    const bool occluded = soup_any<kMany>(s, tris, pg, end, live && sr.tm > 0.0f, sr);
    if (live) out[r] = occluded ? 1 : 0;
  }
}

template <bool kMany, class Src, class Map, int kDefer>
__global__ void __launch_bounds__(plucker_threads<kMany>())
any_hit_plucker_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ t_max, int h, int w, int planes,
                       const float* __restrict__ slots, const float* __restrict__ cols,
                       const float* __restrict__ boxes, const float* __restrict__ guard,
                       const float* __restrict__ blocks, int n_tris,
                       unsigned char* __restrict__ out) {
  if (!kMany) {  // at most one block: its constants staged, tested directly
    const PluckerTris tris = StagedSlots::stage(plucker_smem, slots, cols, n_tris);
    __syncthreads();
    int end = 0;  // one past the last triangle whose plane row is not zero
    for (int j = 0; j < n_tris; ++j) {
      const float4 pl = tris.slot[8 * j + 6];
      if (pl.x != 0.0f || pl.y != 0.0f || pl.z != 0.0f || pl.w != 0.0f) end = j + 1;
    }
    const CullSoup s{nullptr, nullptr, nullptr, nullptr, n_tris, 0};
    plucker_segments<false, Map>(s, tris, PluckerGuard<kDefer>{s, nullptr}, end, o, d, t_max,
                                 h, w, planes, out);
    return;
  }
  const int nb = n_tris / kZBlock;
  float* sm = plucker_smem;
  float* box = sm + 5 * n_tris;
  for (int i = threadIdx.x; i < 5 * n_tris; i += blockDim.x) sm[i] = guard[i];
  for (int i = threadIdx.x; i < 13 * nb; i += blockDim.x) box[i] = boxes[i];
  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) box[13 * nb + i] = blocks[i];
  const auto tris = Src::stage(sm + plucker_tris_at(n_tris), slots, cols, n_tris);
  __syncthreads();
  const CullSoup s{nullptr, sm, reinterpret_cast<const float4*>(sm + 3 * n_tris), box,
                   n_tris, nb};
  plucker_segments<true, Map>(s, tris, PluckerGuard<kDefer>{s, box + 13 * nb}, 0, o, d,
                              t_max, h, w, planes, out);
}

namespace {
PersistentGrid plucker_grids[3];  // the direct loop, StagedSlots, StagedCols
}  // namespace

template <bool kMany, class Src, class Map = PixelMap, int kDefer = kPluckerDefer>
int launch_plucker(PersistentGrid& grids, const float* o, const float* d, const float* t_max,
                   int h, int w, int planes, const float* slots, const float* cols,
                   const float* boxes, const float* guard, const float* blocks, int n_tris,
                   unsigned char* out, cudaStream_t stream) {
  const size_t smem = plucker_smem_bytes<kMany, Src>(n_tris);
  auto kernel = any_hit_plucker_kernel<kMany, Src, Map, kDefer>;
  constexpr int kThr = plucker_threads<kMany>();
  int blocks_ = 0;
  const int err = persistent_blocks(grids, kernel, kThr, smem, blocks_);
  if (err != 0) return err;
  const long long count = kMany ? Map::slots(h, w, planes)
                                : static_cast<long long>(h) * w * planes;
  const int grid = static_cast<int>(std::min<long long>((count + kThr - 1) / kThr, blocks_));
  kernel<<<grid, kThr, smem, stream>>>(o, d, t_max, h, w, planes, slots, cols, boxes, guard,
                                       blocks, n_tris, out);
  return static_cast<int>(cudaGetLastError());
}

// Whether a culled soup's constants fit in shared memory beside its boxes
// and guard (one block an SM); else they are formed from its columns.
inline bool plucker_staged(int n_tris) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return false;
  return plucker_smem_bytes<true, StagedSlots>(n_tris) <= static_cast<size_t>(optin);
}

}  // namespace romis

// A culled soup: slots [T, 32] of the constants and cols [10, T] of the
// columns, both in soup_blocks' order, T a multiple of kZBlock above it
// (at most 2048), boxes [13, T / kZBlock], guard [5, T], blocks
// [2, T / kZBlock] (ops/trace.plucker_blocks). A soup of at most kZBlock
// triangles: its slots [T, 32] as given (T may be 0), the rest null.
extern "C" int romis_any_hit_plucker(const float* o, const float* d, const float* t_max,
                                     int h, int w, int planes, const float* slots,
                                     const float* cols, const float* boxes,
                                     const float* guard, const float* blocks, int n_tris,
                                     unsigned char* out, cudaStream_t stream) {
  using namespace romis;
  const bool many = boxes != nullptr;
  if (many ? (cols == nullptr || guard == nullptr || blocks == nullptr || n_tris <= kZBlock ||
              n_tris % kZBlock != 0 || n_tris > 2048)
           : (cols != nullptr || guard != nullptr || blocks != nullptr || n_tris < 0 ||
              n_tris > kZBlock))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(h) * w * planes == 0) return 0;
  if (!many)
    return launch_plucker<false, StagedSlots>(plucker_grids[0], o, d, t_max, h, w, planes,
                                              slots, cols, boxes, guard, blocks, n_tris, out,
                                              stream);
  return plucker_staged(n_tris)
             ? launch_plucker<true, StagedSlots>(plucker_grids[1], o, d, t_max, h, w, planes,
                                                 slots, cols, boxes, guard, blocks, n_tris,
                                                 out, stream)
             : launch_plucker<true, StagedCols>(plucker_grids[2], o, d, t_max, h, w, planes,
                                                slots, cols, boxes, guard, blocks, n_tris, out,
                                                stream);
}
