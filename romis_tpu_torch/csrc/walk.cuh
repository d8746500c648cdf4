// The threaded BVH walk on the device, shared by kernels 18-20 (walk.cu)
// and the BVH final shade (kernel 21, shade.cu): the node record, the slab
// test, the closest-hit walk (18) and the one-ray any-hit walk walk_any
// (kernels 19, 20 and 21, each ray walking alone).
//
// The tree is ops/bvh.py's DFS-preorder skip-link layout: node i's record is
// 8 words, read as two float4 through the read-only cache, bmin xyz | bmax x
// and bmax yz | miss_link | leaf (int32 bit patterns; leaf = first << 5 |
// count, 0 for an inner node). A box hit descends to i + 1, a miss or a
// finished leaf follows miss_link, -1 ends the walk: one cursor and no
// stack. The leaves' triangles are read from the BVH-ordered [10, T]
// triangle columns or their 48-byte records (a leaf is contiguous in
// both). A 24k-triangle tree is about 1 MB
// of records and 1 MB of triangles, which stay in the 50 MB L2.
//
// Every step repeats ops/traverse.py's arithmetic operation for operation
// (the 1e-12 guard of the inverse direction, the slab test, mt_tri), and the
// library is compiled with --fmad=false, so a walk visits the same nodes in
// the same order as the plain traversal and agrees with it hit for hit.
#pragma once

#include "common.cuh"

namespace romis {

constexpr int kLeafCountBits = 5;  // ops/bvh.LEAF_COUNT_BITS

// ops/traverse.inv_direction.
__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : 1e12f;
}

struct Node {
  float4 a, b;  // (bmin xyz, bmax x), (bmax yz, miss, leaf)
  __device__ __forceinline__ int miss() const { return __float_as_int(b.z); }
  __device__ __forceinline__ int leaf() const { return __float_as_int(b.w); }
};

__device__ __forceinline__ Node load_node(const float4* __restrict__ nodes,
                                          int i) {
  return Node{__ldg(nodes + 2 * i), __ldg(nodes + 2 * i + 1)};
}

// ops/traverse.slab_test. The operands are finite for finite rays (the
// inverse direction is at most 1e12), so fminf / fmaxf agree with
// torch.minimum / maximum; a NaN ray component fails every triangle test
// either way.
__device__ __forceinline__ bool slab_hit(const Node& n, float ox, float oy,
                                         float oz, float ix, float iy,
                                         float iz, float t_max) {
  const float t0x = (n.a.x - ox) * ix, t1x = (n.a.w - ox) * ix;
  const float t0y = (n.a.y - oy) * iy, t1y = (n.b.x - oy) * iy;
  const float t0z = (n.a.z - oz) * iz, t1z = (n.b.y - oz) * iz;
  const float tnear =
      fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tfar =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tnear <= tfar && tfar >= 0.0f && tnear <= t_max;
}

// Closest hit of one ray (ops/traverse.bvh_closest): the running best t
// prunes the boxes, and a later triangle replaces the best only if strictly
// nearer, so ties go to the first hit in walk order. On a miss best_t keeps
// its initial value and best_i stays -1.
__device__ __forceinline__ void walk_closest(const float4* __restrict__ nodes,
                                             const float* __restrict__ cols,
                                             int n_tris, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, float& best_t,
                                             int& best_i, float& best_u,
                                             float& best_v) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  int cursor = 0;
  while (cursor >= 0) {
    const Node n = load_node(nodes, cursor);
    const bool hit = slab_hit(n, ox, oy, oz, ix, iy, iz, best_t);
    const int leaf = n.leaf();
    if (hit && leaf != 0) {
      const int first = leaf >> kLeafCountBits;
      const int count = leaf & ((1 << kLeafCountBits) - 1);
      for (int j = 0; j < count; ++j) {
        float t, u, v;
        if (mt_hit(ox, oy, oz, dx, dy, dz, cols + first + j, n_tris, t, u, v) &&
            t < best_t) {
          best_t = t;
          best_i = first + j;
          best_u = u;
          best_v = v;
        }
      }
      cursor = n.miss();
    } else {
      cursor = hit ? cursor + 1 : n.miss();
    }
  }
}

// A leaf's triangles as the walk reads them: from the [10, T] columns
// (kernels 18 and 19), or from 48-byte records (kernels 20 and 21;
// ops/walk.tri_records: v0 xyz | e1 xyz | e2 xyz | active | 0 0, three
// float4 from one record instead of ten floats from ten columns).
struct ColTris {
  const float* __restrict__ cols;
  int n_tris;
  __device__ __forceinline__ Tri operator()(int i) const {
    return load_tri(cols + i, n_tris);
  }
};

struct RecTris {
  const float4* __restrict__ recs;
  __device__ __forceinline__ Tri operator()(int i) const {
    const float4 a = __ldg(recs + 3 * i), b = __ldg(recs + 3 * i + 1),
                 c = __ldg(recs + 3 * i + 2);
    return Tri{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y > 0.0f};
  }
};

// Occlusion of one ray (ops/traverse.bvh_any): the ray walks the tree
// alone and stops at its first accepted hit. For a fixed t_max the any-hit
// bool is the OR over the triangles of every leaf whose box (and its
// ancestors') the ray passes, so it depends neither on the order of the
// visits nor on where the walk stops: it is the plain traversal's bool.
template <class Tris>
__device__ __forceinline__ bool walk_any(const float4* __restrict__ nodes,
                                         const Tris& tris, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float tm) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  bool occ = false;
  int cursor = 0;
  while (cursor >= 0 && !occ) {
    const Node n = load_node(nodes, cursor);
    const bool hit = slab_hit(n, ox, oy, oz, ix, iy, iz, tm);
    const int leaf = n.leaf();
    if (hit && leaf != 0) {
      const int first = leaf >> kLeafCountBits;
      const int count = leaf & ((1 << kLeafCountBits) - 1);
      for (int j = 0; j < count && !occ; ++j) {
        float t, u, v;
        occ = mt_tri(ox, oy, oz, dx, dy, dz, tris(first + j), t, u, v) &&
              t < tm;
      }
      cursor = n.miss();
    } else {
      cursor = hit ? cursor + 1 : n.miss();
    }
  }
  return occ;
}

}  // namespace romis
