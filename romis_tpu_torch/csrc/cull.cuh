// The soup's block cull, shared by kernel 7 (zcount.cu), kernels 4
// (shade.cu), 6 (any.cu), 8 (plucker.cu) and 1 (trace.cu):
// ops/trace.soup_blocks cuts the soup into blocks of kZBlock triangles,
// each with a grown box and the near-parallel guard's data. A ray tests a
// block's box over its window [0, dist] before the block's triangles;
// where the box test fails, the guard still keeps the block if the ray is
// within the rounding's reach of parallel to one of its triangles
// (zcount_blocks derives the bound; it covers both the division-free test
// of kernel 7 and the division form mt_tri of kernels 4, 6 and 1,
// ops/trace.any_hit_culled and closest_hit_culled; kernel 8's Plücker test
// has its own guard on the same boxes, ops/trace.any_hit_plucker_culled).
// soup_any, below, is the any-hit walk kernels 4, 6 and 8 share.
#pragma once

#include <mutex>

#include "common.cuh"

namespace romis {

constexpr int kZBlock = 16;  // triangles a box (ops/trace.ZCOUNT_BLOCK)
constexpr unsigned kFull = 0xffffffffu;

// Floats of shared memory the staged soup takes: the [10, T] columns, the
// guard's [3, T] normals and [T / 2] pair cones (float4), the [13, nb]
// boxes.
inline size_t cull_smem_bytes(int n_tris) {
  return sizeof(float) * (15 * static_cast<size_t>(n_tris) + 13 * (n_tris / kZBlock));
}

// The staged soup in shared memory (stage_cull).
struct CullSoup {
  const float* tri;     // [10, n_tris]
  const float* nrm;     // [3, n_tris]
  const float4* pairs;  // [n_tris / 2]
  const float* box;     // [13, nb]
  int n_tris, nb;
};

// The block-ordered columns, guard and boxes of ops/trace.zcount_blocks
// into shared memory `smem` (cull_smem_bytes); every thread of the block
// calls it, and a __syncthreads() must follow.
__device__ __forceinline__ CullSoup stage_cull(float* smem, const float* __restrict__ cols,
                                               const float* __restrict__ boxes,
                                               const float* __restrict__ normals,
                                               int n_tris) {
  const int nb = n_tris / kZBlock;
  for (int i = threadIdx.x; i < 10 * n_tris; i += blockDim.x) smem[i] = cols[i];
  for (int i = threadIdx.x; i < 5 * n_tris; i += blockDim.x) smem[10 * n_tris + i] = normals[i];
  for (int i = threadIdx.x; i < 13 * nb; i += blockDim.x) smem[15 * n_tris + i] = boxes[i];
  return CullSoup{smem, smem + 10 * n_tris,
                  reinterpret_cast<const float4*>(smem + 13 * n_tris),
                  smem + 15 * n_tris, n_tris, nb};
}

// The slab test of the ray (o, inverse direction i) against box b of the
// [6, nb] boxes over the window [0, dist].
__device__ __forceinline__ bool box_hit(const float* box, int nb, int b, float ox,
                                        float oy, float oz, float ix, float iy,
                                        float iz, float dist) {
  const float tx0 = (box[b] - ox) * ix, tx1 = (box[3 * nb + b] - ox) * ix;
  const float ty0 = (box[nb + b] - oy) * iy, ty1 = (box[4 * nb + b] - oy) * iy;
  const float tz0 = (box[2 * nb + b] - oz) * iz, tz1 = (box[5 * nb + b] - oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return tf >= tn && tf >= 0.0f && tn <= dist;
}

// A slab test's reciprocal: zero components become a huge finite slope.
// The fast reciprocal (2 ulp) is within the boxes' growth, which covers
// the slab test's rounding (ops/trace.zcount_blocks).
__device__ __forceinline__ float slab_inv(float c) {
  return __fdividef(c < 0.0f ? -1.0f : 1.0f, fmaxf(fabsf(c), 1e-20f));
}

// The guard's reach before its window: |o - c|_1 + three half-diagonals
// of block b.
__device__ __forceinline__ float guard_l0(const CullSoup& s, int b, float ox, float oy,
                                          float oz) {
  const int nb = s.nb;
  return fabsf(ox - s.box[6 * nb + b]) + fabsf(oy - s.box[7 * nb + b]) +
         fabsf(oz - s.box[8 * nb + b]) + s.box[9 * nb + b];
}

// The near-parallel guard of block b for one ray (o, unit d) whose box
// test failed, at the reach L = guard_l0 + the window's end → whether it
// keeps the block: L against the growth over 8u, then each pair's cone,
// then, only for the pairs the cone does not rule out, their two normals
// (soup_blocks' bound; kernel 7's guard_of does the same for K rays at
// once).
// Pair q of block b: whether its cone leaves the ray near-parallel to one
// of its two triangles, |d.m| <= reach.
__device__ __forceinline__ bool pair_keeps(const CullSoup& s, int b, int q, float dx,
                                           float dy, float dz, float reach) {
  const float4 c = s.pairs[b * (kZBlock / 2) + q];
  if (fabsf(dx * c.x + dy * c.y + dz * c.z) - c.w > reach) return false;
  for (int j = b * kZBlock + 2 * q; j < b * kZBlock + 2 * q + 2; ++j) {
    const float mx = s.nrm[j], my = s.nrm[s.n_tris + j], mz = s.nrm[2 * s.n_tris + j];
    if (fabsf(dx * mx + dy * my + dz * mz) <= reach) return true;
  }
  return false;
}

__device__ __forceinline__ bool guard_keeps_at(const CullSoup& s, int b, float dx,
                                               float dy, float dz, float reach) {
  if (reach >= s.box[10 * s.nb + b]) return true;
#pragma unroll 2
  for (int q = 0; q < kZBlock / 2; ++q)
    if (pair_keeps(s, b, q, dx, dy, dz, reach)) return true;
  return false;
}

// The guard over the window [0, dist] (an any-hit ray's).
__device__ __forceinline__ bool guard_keeps(const CullSoup& s, int b, float ox, float oy,
                                            float oz, float dx, float dy, float dz,
                                            float dist) {
  return guard_keeps_at(s, b, dx, dy, dz, guard_l0(s, b, ox, oy, oz) + dist);
}

// The persistent grid of one kernel instantiation (kernels 4 and 1): as
// many blocks as fit on the card at once, each looping over the rays (so
// the soup is staged once a block), worked out at the first launch on a
// device with a given staged size and kept; the shared-memory attribute is
// set then. Each source keeps its grids at file scope in an unnamed
// namespace: a function-local static of a template is a unique global
// symbol, which the loader shares with any other library (another build
// of these sources) that defines one of the same name.
struct PersistentGrid {
  static constexpr int kMaxDevices = 64;
  std::mutex mu;
  size_t smem[kMaxDevices] = {};
  int blocks[kMaxDevices] = {};  // 0: not worked out yet
};

template <class Kernel>
int persistent_blocks(PersistentGrid& g, Kernel kernel, int threads, size_t smem,
                      int& blocks) {
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  if (dev >= PersistentGrid::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(g.mu);
  if (g.blocks[dev] == 0 || g.smem[dev] != smem) {
    int sms = 0, per_sm = 0;
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (err == 0) err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    if (err == 0) err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem));
    if (err != 0) return err;
    g.smem[dev] = smem;
    g.blocks[dev] = sms * (per_sm > 1 ? per_sm : 1);
  }
  blocks = g.blocks[dev];
  return 0;
}

// ---- The any-hit walk of kernels 4, 6 and 8 (ops/trace.any_hit_culled,
// any_hit_plucker_culled) ----

// A segment: origin, direction (of any length) and window [0, tm].
struct SegRay {
  float ox, oy, oz, dx, dy, dz, tm;
};

__device__ __forceinline__ SegRay shfl_seg(const SegRay& r, int from) {
  return SegRay{__shfl_sync(kFull, r.ox, from), __shfl_sync(kFull, r.oy, from),
                __shfl_sync(kFull, r.oz, from), __shfl_sync(kFull, r.dx, from),
                __shfl_sync(kFull, r.dy, from), __shfl_sync(kFull, r.dz, from),
                __shfl_sync(kFull, r.tm, from)};
}

// What the guards read of a segment (ops/trace._guard_rays): the unit
// direction (0 for a zero one), the window's length tm·|d| and the
// origin's norm (kernel 8's reach).
struct GuardRay {
  float ux, uy, uz, len, norm_o;
};

__device__ __forceinline__ GuardRay guard_ray(const SegRay& r) {
  const float n = sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
  const bool ok = n > 0.0f;
  return GuardRay{ok ? r.dx / n : 0.0f, ok ? r.dy / n : 0.0f, ok ? r.dz / n : 0.0f,
                  r.tm * n, sqrtf(r.ox * r.ox + r.oy * r.oy + r.oz * r.oz)};
}

// Moller-Trumbore against the staged [10, T] columns (kernels 4 and 6):
// mt_tri, the plain any-hit's test, t in (0, tm).
struct MtTris {
  const float* tri;
  int n_tris;
  using Ray = SegRay;
  __device__ __forceinline__ Ray ray(const SegRay& r) const { return r; }
  __device__ __forceinline__ static Ray shfl(const Ray& r, int from) {
    return shfl_seg(r, from);
  }
  __device__ __forceinline__ bool hit(int j, const Ray& r) const {
    float t, u, v;
    return mt_hit(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, tri + j, n_tris, t, u, v) &&
           t < r.tm;
  }
};

// Which blocks' guard the walk defers to its second pass: none, all, the
// blocks zcount_blocks flags (row 12: those whose pairs mostly lack a
// cone), or the blocks it does not flag.
constexpr int kDeferNone = 0, kDeferAll = 1, kDeferFlagged = 2, kDeferUnflagged = 3;

template <int kDefer>
__device__ __forceinline__ bool defers(const CullSoup& s, int b) {
  if (kDefer == kDeferNone || kDefer == kDeferAll) return kDefer == kDeferAll;
  return (s.box[12 * s.nb + b] > 0.5f) == (kDefer == kDeferFlagged);
}

// The Moller-Trumbore guard (zcount_blocks' bound), deferred as kDefer
// says. kUnit: the caller's directions are unit vectors (kernel 4's, made
// so by the division by their norm, as the bound assumes), taken as they
// are; else each is divided by its norm and the window scaled by it
// (guard_ray).
template <bool kUnit, int kDefer = kDeferFlagged>
struct MtGuard {
  CullSoup s;
  __device__ __forceinline__ GuardRay ray(const SegRay& r) const {
    return kUnit ? GuardRay{r.dx, r.dy, r.dz, r.tm, 0.0f} : guard_ray(r);
  }
  __device__ __forceinline__ bool deferred(int b) const { return defers<kDefer>(s, b); }
  __device__ __forceinline__ bool keeps(int b, const SegRay& r, const GuardRay& g) const {
    return guard_keeps_at(s, b, g.ux, g.uy, g.uz, guard_l0(s, b, r.ox, r.oy, r.oz) + g.len);
  }
};

template <class Tris>
__device__ __forceinline__ bool tris_hit(const Tris& tris, int j0, int j1,
                                         const typename Tris::Ray& r) {
  for (int j = j0; j < j1; ++j)
    if (tris.hit(j, r)) return true;
  return false;
}

// One pending segment's walk over the culled soup (kMany: more than one
// block) → occluded. Every lane of the warp calls it (its block loops end
// by warp votes); `pending` says whether this lane's segment is traced.
// Per block, in order: the box test over [0, tm], then, where it fails
// and the block is not deferred, the guard. Where at most kDealMax lanes
// need a block, its triangles are dealt out to the warp as kernel 7 deals
// them: two segments a round, a half-warp each, a lane a triangle, the
// hits gathered by a vote; else each lane tests the block's triangles for
// its own segment (the warp waits for its slowest lane). Then the
// deferred blocks' guard, for the segments left pending. Without kMany
// (at most one block, stage_direct) the triangles up to direct_end are
// tested directly.
constexpr int kDealMax = 16;

template <bool kMany, class Tris, class Guard>
__device__ __forceinline__ bool soup_any(const CullSoup& s, const Tris& tris,
                                         const Guard& guard, int direct_end,
                                         bool pending, const SegRay& r) {
  const typename Tris::Ray tr = tris.ray(r);
  if (!kMany) return pending && tris_hit(tris, 0, direct_end, tr);
  const int nb = s.nb;
  const int lane = threadIdx.x & 31;
  const float ix = slab_inv(r.dx), iy = slab_inv(r.dy), iz = slab_inv(r.dz);
  const GuardRay g = guard.ray(r);
  bool occluded = false, any_deferred = false;
  for (int b = 0; b < nb; ++b) {
    if (!__any_sync(kFull, pending)) break;
    const bool deferred = guard.deferred(b);  // uniform
    any_deferred = any_deferred || deferred;
    const bool pass = pending && (box_hit(s.box, nb, b, r.ox, r.oy, r.oz, ix, iy, iz, r.tm) ||
                                  (!deferred && guard.keeps(b, r, g)));
    const int end = b * kZBlock + static_cast<int>(s.box[11 * nb + b]);
    unsigned need = __ballot_sync(kFull, pass);
    if (__popc(need) <= kDealMax) {  // uniform: a warp vote
      const int half = lane >> 4, j = b * kZBlock + (lane & 15);
      while (need != 0u) {
        const int src0 = __ffs(need) - 1;
        need &= need - 1u;
        const int src1 = need != 0u ? __ffs(need) - 1 : -1;
        if (src1 >= 0) need &= need - 1u;
        const int src = half ? src1 : src0;
        const typename Tris::Ray q = Tris::shfl(tr, src < 0 ? src0 : src);
        const bool hit = src >= 0 && j < end && tris.hit(j, q);
        const unsigned hits = __ballot_sync(kFull, hit);
        if ((lane == src0 && (hits & 0xffffu)) || (lane == src1 && (hits >> 16))) {
          occluded = true;
          pending = false;
        }
      }
    } else if (pass && tris_hit(tris, b * kZBlock, end, tr)) {
      occluded = true;
      pending = false;
    }
  }
  // The deferred guard: the deferred blocks whose box the segment failed,
  // for the segments the walk left unoccluded (a hit ends a segment
  // whatever the other blocks hold).
  for (int b = 0; any_deferred && b < nb; ++b) {  // any_deferred is uniform
    if (!__any_sync(kFull, pending)) break;
    if (!pending || !guard.deferred(b)) continue;
    if (!box_hit(s.box, nb, b, r.ox, r.oy, r.oz, ix, iy, iz, r.tm) && guard.keeps(b, r, g) &&
        tris_hit(tris, b * kZBlock, b * kZBlock + static_cast<int>(s.box[11 * nb + b]), tr)) {
      occluded = true;
      pending = false;
    }
  }
  return occluded;
}

// A soup of at most one block, staged as given: its [10, n_tris] columns
// alone (no boxes, no guard), tested directly (kernels 4 and 6).
__device__ __forceinline__ CullSoup stage_direct(float* smem, const float* __restrict__ cols,
                                                 int n_tris) {
  for (int i = threadIdx.x; i < 10 * n_tris; i += blockDim.x) smem[i] = cols[i];
  return CullSoup{smem, nullptr, nullptr, nullptr, n_tris, 0};
}

// One past the staged soup's last active triangle (after the staging's
// __syncthreads): a soup's padding, inactive, is not tested (the
// flagship's 2 triangles come padded to 8).
__device__ __forceinline__ int active_end(const CullSoup& s) {
  int end = 0;
  for (int j = 0; j < s.n_tris; ++j)
    if (s.tri[9 * s.n_tris + j] > 0.0f) end = j + 1;
  return end;
}

// The any-hit kernels' segments [planes, H, W] (kernels 6 and 8), a
// pixel's planes in adjacent slots, the pixels row by row (the initial
// check's segments of a pixel leave nearly one point): slot i of a launch
// → the segment's flat index plane·H·W + pixel, or -1 (no segment); the
// slots come in whole warps.
struct PixelMap {
  __host__ __device__ static long long slots(int h, int w, int planes) {
    return (static_cast<long long>(h) * w * planes + 31) / 32 * 32;
  }
  __device__ __forceinline__ static long long seg(long long i, int h, int w, int planes) {
    const long long n = static_cast<long long>(h) * w;
    const long long p = i / planes;
    return p < n ? (i - p * planes) * n + p : -1;
  }
};

}  // namespace romis
