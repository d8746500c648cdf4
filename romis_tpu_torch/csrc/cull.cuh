// The soup's block cull, shared by kernel 7 (zcount.cu), kernel 4
// (shade.cu) and kernel 1 (trace.cu): ops/trace.soup_blocks cuts the soup
// into blocks of kZBlock
// triangles, each with a grown box and the near-parallel guard's data. A
// ray tests a block's box over its window [0, dist] before the block's
// triangles; where the box test fails, the guard still keeps the block if
// the ray is within the rounding's reach of parallel to one of its
// triangles (zcount_blocks derives the bound; it covers both the
// division-free test of kernel 7 and the division form mt_tri of kernels 4
// and 1, ops/trace.any_hit_culled and closest_hit_culled).
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

}  // namespace romis
