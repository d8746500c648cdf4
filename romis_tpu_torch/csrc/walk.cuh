// The threaded BVH walk on the device, shared by kernels 18-20 (walk.cu)
// and the BVH final shade (kernel 21, shade.cu).
//
// The tree is ops/bvh.py's DFS-preorder skip-link layout: node i's record is
// 8 words, read as two float4 through the read-only cache, bmin xyz | bmax x
// and bmax yz | miss_link | leaf (int32 bit patterns; leaf = first << 5 |
// count, 0 for an inner node). A box hit descends to i + 1, a miss or a
// finished leaf follows miss_link, -1 ends the walk: one cursor and no
// stack. The leaves' triangles are read from the BVH-ordered [10, T]
// triangle columns (a leaf is contiguous). A 24k-triangle tree is about 1 MB
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

// Occlusion of S rays sharing one walk (ops/traverse.bvh_any for each):
// bit s of `live` marks ray s as still to trace. A node is entered if any
// live ray's slab test passes, and a leaf's triangles are tested against
// exactly the live rays whose own slab test passes there. A parent's box
// contains its children's, and the slab test is monotone in the box under
// rounding, so a ray whose test fails at a node fails below it too: each
// ray tests exactly the leaves its own walk would reach, and its result is
// the plain traversal's. A hit removes the ray; the walk ends when none is
// live. Returns the occluded rays' bits.
template <int S>
__device__ __forceinline__ unsigned walk_any(
    const float4* __restrict__ nodes, const float* __restrict__ cols,
    int n_tris, const float (&ox)[S], const float (&oy)[S],
    const float (&oz)[S], const float (&dx)[S], const float (&dy)[S],
    const float (&dz)[S], const float (&tm)[S], unsigned live) {
  float ix[S], iy[S], iz[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    ix[s] = inv_dir(dx[s]);
    iy[s] = inv_dir(dy[s]);
    iz[s] = inv_dir(dz[s]);
  }
  unsigned occ = 0u;
  int cursor = 0;
  while (cursor >= 0 && live != 0u) {
    const Node n = load_node(nodes, cursor);
    unsigned enter = 0u;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (((live >> s) & 1u) &&
          slab_hit(n, ox[s], oy[s], oz[s], ix[s], iy[s], iz[s], tm[s]))
        enter |= 1u << s;
    const int leaf = n.leaf();
    if (enter == 0u) {
      cursor = n.miss();
      continue;
    }
    if (leaf == 0) {
      cursor = cursor + 1;
      continue;
    }
    const int first = leaf >> kLeafCountBits;
    const int count = leaf & ((1 << kLeafCountBits) - 1);
    for (int j = 0; j < count && enter != 0u; ++j) {
      const Tri tr = load_tri(cols + first + j, n_tris);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float t, u, v;
        if (((enter >> s) & 1u) &&
            mt_tri(ox[s], oy[s], oz[s], dx[s], dy[s], dz[s], tr, t, u, v) &&
            t < tm[s]) {
          occ |= 1u << s;
          enter &= ~(1u << s);
          live &= ~(1u << s);
        }
      }
    }
    cursor = n.miss();
  }
  return occ;
}

}  // namespace romis
