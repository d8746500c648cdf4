// The threaded BVH walk on the device, shared by kernels 18-20 (walk.cu)
// and the BVH final shade (kernel 21, shade.cu): the node record, the slab
// test, the closest-hit walks (18: walk_closest_ordered, nearer child
// first, and walk_closest, the plain walk's preorder) and the one-ray
// any-hit walks (walk_any_wide, kernel 19's, on the two-box records;
// walk_any, the plain walk's preorder, kernels 20 and 21 and kernel 19's
// fallback), each ray walking alone.
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

// The slab test's tnear and tfar (slab_hit's operations) of the box
// (lo, hi) per axis.
__device__ __forceinline__ void slabs(float lox, float hix, float loy, float hiy,
                                      float loz, float hiz, float ox, float oy,
                                      float oz, float ix, float iy, float iz,
                                      float& tnear, float& tfar) {
  const float t0x = (lox - ox) * ix, t1x = (hix - ox) * ix;
  const float t0y = (loy - oy) * iy, t1y = (hiy - oy) * iy;
  const float t0z = (loz - oz) * iz, t1z = (hiz - oz) * iz;
  tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

// Closest hit of one ray (ops/traverse.bvh_closest): the running best t
// prunes the boxes, and a later triangle replaces the best only if strictly
// nearer, so ties go to the first hit in walk order. On a miss best_t keeps
// its initial value and best_i stays -1.
template <class Tris>
__device__ __forceinline__ void walk_closest(const float4* __restrict__ nodes,
                                             const Tris& tris, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float& best_t,
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
        if (mt_tri(ox, oy, oz, dx, dy, dz, tris(first + j), t, u, v) &&
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

// A leaf's triangles as the walks read them (kernels 18-21): 48-byte
// records (ops/walk.tri_records: v0 xyz | e1 xyz | e2 xyz | active | 0 0,
// three float4 from one record instead of ten floats from ten columns).
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

// Kernel 18's walk (ops/traverse.bvh_closest_ordered is its plain model):
// from ops/bvh.wide_record, an inner node's record gives both children's
// boxes and references (an inner child's node index, a leaf's word
// negated), so a step tests two boxes from one 64-byte load and goes to
// the nearer child, the farther waiting on a stack of kWalkStack entries.
// A box is entered where slab_hit passes it with the ray's t_max and where
// pm, the largest tnear on its path, is at most best_t * kLoose; a hit
// replaces the best where it comes first in (t, index) order. Returns
// false where the answer may not be the plain walk's (the best's pm above
// its t with another hit, t2, below that pm; or a full stack): the caller
// then walks the ray again in preorder (walk_closest). bvh_closest_ordered
// says why the answer stands otherwise.
constexpr int kWalkStack = 32;          // ops/traverse.WALK_STACK
constexpr float kLoose = 1.00006103515625f;  // 1 + 2^-14, ops/traverse.LOOSE

template <class Tris>
__device__ __forceinline__ bool walk_closest_ordered(
    const float4* __restrict__ nodes, const float4* __restrict__ wide,
    const Tris& tris, float ox, float oy, float oz, float dx, float dy,
    float dz, float t_max, float& best_t, int& best_i, float& best_u,
    float& best_v) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const Node root = load_node(nodes, 0);
  float pm, tf;
  slabs(root.a.x, root.a.w, root.a.y, root.b.x, root.a.z, root.b.y, ox, oy, oz,
        ix, iy, iz, pm, tf);
  if (!(pm <= tf && tf >= 0.0f && pm <= t_max)) return true;
  int ref = -root.leaf();  // 0: the root is inner
  float t2 = INFINITY, tau = -INFINITY;
  int2 stack[kWalkStack];
  int sp = 0;
  while (true) {
    if (ref < 0) {  // a leaf: its triangles, then the stack
      const int first = (-ref) >> kLeafCountBits;
      const int count = (-ref) & ((1 << kLeafCountBits) - 1);
      for (int j = 0; j < count; ++j) {
        float t, u, v;
        if (!mt_tri(ox, oy, oz, dx, dy, dz, tris(first + j), t, u, v)) continue;
        const int i = first + j;
        if (t < best_t || (t == best_t && i < best_i)) {
          if (best_i >= 0) t2 = fminf(t2, best_t);
          best_t = t;
          best_i = i;
          best_u = u;
          best_v = v;
          tau = pm;
        } else if (t < t_max) {
          t2 = fminf(t2, t);
        }
      }
    } else {  // an inner node: both children's boxes
      const float4* rec = wide + 4 * ref;
      const float4 x = __ldg(rec), y = __ldg(rec + 1), z = __ldg(rec + 2);
      const int4 kids = __ldg(reinterpret_cast<const int4*>(rec + 3));
      const float lim = best_t * kLoose;
      float tnl, tfl, tnr, tfr;
      slabs(x.x, x.y, y.x, y.y, z.x, z.y, ox, oy, oz, ix, iy, iz, tnl, tfl);
      slabs(x.z, x.w, y.z, y.w, z.z, z.w, ox, oy, oz, ix, iy, iz, tnr, tfr);
      const float pml = fmaxf(pm, tnl), pmr = fmaxf(pm, tnr);
      const bool gl = tnl <= tfl && tfl >= 0.0f && tnl <= t_max && pml <= lim;
      const bool gr = tnr <= tfr && tfr >= 0.0f && tnr <= t_max && pmr <= lim;
      if (gl || gr) {
        const bool left = gl && (!gr || tnl <= tnr);
        if (gl && gr) {
          if (sp == kWalkStack) return false;
          stack[sp++] = left ? make_int2(kids.y, __float_as_int(pmr))
                             : make_int2(kids.x, __float_as_int(pml));
        }
        ref = left ? kids.x : kids.y;
        pm = left ? pml : pmr;
        continue;
      }
    }
    // The stack's top entry, while its path can still hold the answer.
    bool found = false;
    while (sp > 0) {
      const int2 e = stack[--sp];
      if (__int_as_float(e.y) <= best_t * kLoose) {
        ref = e.x;
        pm = __int_as_float(e.y);
        found = true;
        break;
      }
    }
    if (!found) break;
  }
  return !(best_i >= 0 && tau > best_t && t2 < tau);
}

// Kernel 19's walk (ops/traverse.bvh_any_wide is its plain model): the
// root's box as the plain walk tests it, then at an inner node both
// children's boxes from one ops/bvh.wide_record (slab_hit's operations
// with the ray's t_max), the left child first and the right on a stack of
// kWalkStack entries; a leaf's triangles in order, stopping at the first
// accepted hit. The set of leaves whose box and ancestors' boxes pass is
// the plain walk's, so the bool (the OR over their triangles) is too,
// whatever the order and whoever stops where.
//
// The loop is a speculative while-while (Aila and Laine, "Understanding
// the efficiency of ray traversal on GPUs", HPG 2009): a lane that reaches
// a leaf puts it aside and goes on down the tree until every lane of the
// warp holds a leaf, then the warp tests its leaves together, so the
// divergent shadow rays of a warp spend fewer steps with most lanes idle.
// Returns 1 (occluded), 0 (visible) or -1 (the stack was full: the caller
// walks the ray again with walk_any).
constexpr int kWalkDone = -2147483647 - 1;  // no leaf word is this

template <class Tris>
__device__ __forceinline__ int walk_any_wide(const float4* __restrict__ nodes,
                                             const float4* __restrict__ wide,
                                             const Tris& tris, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float tm) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const Node root = load_node(nodes, 0);
  if (!slab_hit(root, ox, oy, oz, ix, iy, iz, tm)) return 0;
  int ref = -root.leaf();  // >= 0 an inner node, < 0 a leaf, or kWalkDone
  int leaf = 0;            // a leaf put aside (its word negated), 0 none
  if (ref < 0) {           // the root is a leaf
    leaf = ref;
    ref = kWalkDone;
  }
  int stack[kWalkStack];
  int sp = 0;
  while (ref != kWalkDone || leaf != 0) {
    while (ref >= 0) {  // inner nodes
      const float4* rec = wide + 4 * ref;
      const float4 x = __ldg(rec), y = __ldg(rec + 1), z = __ldg(rec + 2);
      const int4 kids = __ldg(reinterpret_cast<const int4*>(rec + 3));
      float tnl, tfl, tnr, tfr;
      slabs(x.x, x.y, y.x, y.y, z.x, z.y, ox, oy, oz, ix, iy, iz, tnl, tfl);
      slabs(x.z, x.w, y.z, y.w, z.z, z.w, ox, oy, oz, ix, iy, iz, tnr, tfr);
      const bool gl = tnl <= tfl && tfl >= 0.0f && tnl <= tm;
      const bool gr = tnr <= tfr && tfr >= 0.0f && tnr <= tm;
      if (gl && gr) {
        if (sp == kWalkStack) return -1;
        stack[sp++] = kids.y;
      }
      if (gl || gr)
        ref = gl ? kids.x : kids.y;
      else
        ref = sp > 0 ? stack[--sp] : kWalkDone;
      if (ref < 0 && ref != kWalkDone && leaf == 0) {  // put the leaf aside
        leaf = ref;
        ref = sp > 0 ? stack[--sp] : kWalkDone;
      }
      if (!__any_sync(__activemask(), leaf == 0)) break;
    }
    while (leaf != 0) {  // the leaf put aside, then the current one
      const int first = (-leaf) >> kLeafCountBits;
      const int count = (-leaf) & ((1 << kLeafCountBits) - 1);
      for (int j = 0; j < count; ++j) {
        float t, u, v;
        if (mt_tri(ox, oy, oz, dx, dy, dz, tris(first + j), t, u, v) && t < tm)
          return 1;
      }
      leaf = 0;
      if (ref < 0 && ref != kWalkDone) {
        leaf = ref;
        ref = sp > 0 ? stack[--sp] : kWalkDone;
      }
    }
  }
  return 0;
}

}  // namespace romis
