// Binned-SAH BVH builder producing a flattened, threaded (stackless) layout.
//
// romis_tpu_torch's own copy of the JAX package's native/bvh_builder.cpp,
// compiled at first use with the host C++ compiler (ops/_build.build_host,
// without -march=native) and called once per scene through ctypes
// (romis_tpu_torch/ops/bvh.py). It replaces Embree's BVH build (reference:
// src/ray_tracing/embree_interface.cpp:30-51 commits an
// RTC_BUILD_QUALITY_HIGH scene); the traversal is ops/traverse.py (plain)
// and csrc/walk.cuh (CUDA). Build speed matters less than output quality,
// but the binned SAH build is O(N log N) and fast anyway.
//
// Output layout (DFS order, "threaded"/skip-link form):
//   bbox_min[n][3], bbox_max[n][3]
//   miss_link[n] : node to jump to when the ray misses this box (or -1)
//   leaf_first[n]: first index into tri_order for leaves, -1 for inner nodes
//   leaf_count[n]: triangle count for leaves, 0 for inner nodes
//   tri_order[t] : triangle indices reordered so leaves are contiguous
// A ray traverses with a single cursor: hit an inner node -> cursor+1
// (first child is next in DFS order); miss or finish a leaf -> miss_link.
//
// Build: greedy top-down, 16-bin SAH over the centroid extent of the widest
// axis, leaf when SAH says stop or <= max_leaf triangles.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
    Vec3 lo{std::numeric_limits<float>::infinity(),
            std::numeric_limits<float>::infinity(),
            std::numeric_limits<float>::infinity()};
    Vec3 hi{-std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity()};
    void grow(const AABB& o) {
        lo = vmin(lo, o.lo);
        hi = vmax(hi, o.hi);
    }
    void grow(const Vec3& p) {
        lo = vmin(lo, p);
        hi = vmax(hi, p);
    }
    float area() const {
        float dx = std::max(hi.x - lo.x, 0.0f);
        float dy = std::max(hi.y - lo.y, 0.0f);
        float dz = std::max(hi.z - lo.z, 0.0f);
        return 2.0f * (dx * dy + dy * dz + dz * dx);
    }
};

struct Prim {
    AABB box;
    Vec3 centroid;
    int32_t index;
};

struct BuildNode {
    AABB box;
    int32_t left = -1;   // child BuildNode index
    int32_t right = -1;
    int32_t first = -1;  // leaf: first prim in prims[]
    int32_t count = 0;   // leaf: prim count
};

struct Builder {
    std::vector<Prim> prims;
    std::vector<BuildNode> nodes;
    int32_t max_leaf;

    int32_t build(int32_t first, int32_t count) {
        BuildNode node;
        AABB bounds, cbounds;
        for (int32_t i = first; i < first + count; ++i) {
            bounds.grow(prims[i].box);
            cbounds.grow(prims[i].centroid);
        }
        node.box = bounds;

        if (count <= max_leaf) {
            node.first = first;
            node.count = count;
            nodes.push_back(node);
            return static_cast<int32_t>(nodes.size()) - 1;
        }

        // Widest centroid axis.
        float ext[3] = {cbounds.hi.x - cbounds.lo.x,
                        cbounds.hi.y - cbounds.lo.y,
                        cbounds.hi.z - cbounds.lo.z};
        int axis = 0;
        if (ext[1] > ext[0]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;
        float clo = axis == 0 ? cbounds.lo.x : (axis == 1 ? cbounds.lo.y : cbounds.lo.z);
        float extent = ext[axis];

        int32_t mid;
        if (extent <= 1e-12f) {
            mid = first + count / 2;  // degenerate: median split
        } else {
            // 16-bin SAH.
            constexpr int NB = 16;
            AABB bin_box[NB];
            int32_t bin_cnt[NB] = {0};
            auto bin_of = [&](const Prim& p) {
                float c = axis == 0 ? p.centroid.x
                                    : (axis == 1 ? p.centroid.y : p.centroid.z);
                int b = static_cast<int>(NB * (c - clo) / extent);
                return std::min(std::max(b, 0), NB - 1);
            };
            for (int32_t i = first; i < first + count; ++i) {
                int b = bin_of(prims[i]);
                bin_box[b].grow(prims[i].box);
                bin_cnt[b]++;
            }
            // Sweep for best split.
            AABB right_acc[NB];
            AABB acc;
            for (int b = NB - 1; b >= 1; --b) {
                acc.grow(bin_box[b]);
                right_acc[b] = acc;
            }
            float best_cost = std::numeric_limits<float>::infinity();
            int best_split = -1;
            AABB lacc;
            int32_t lcnt = 0;
            for (int b = 0; b < NB - 1; ++b) {
                lacc.grow(bin_box[b]);
                lcnt += bin_cnt[b];
                int32_t rcnt = count - lcnt;
                if (lcnt == 0 || rcnt == 0) continue;
                float cost = lacc.area() * lcnt + right_acc[b + 1].area() * rcnt;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_split = b;
                }
            }
            float leaf_cost = bounds.area() * count;
            if (best_split < 0 ||
                (count <= 2 * max_leaf && best_cost >= leaf_cost)) {
                if (count <= 4 * max_leaf) {
                    node.first = first;
                    node.count = count;
                    nodes.push_back(node);
                    return static_cast<int32_t>(nodes.size()) - 1;
                }
                mid = first + count / 2;
            } else {
                auto it = std::partition(
                    prims.begin() + first, prims.begin() + first + count,
                    [&](const Prim& p) { return bin_of(p) <= best_split; });
                mid = static_cast<int32_t>(it - prims.begin());
                if (mid == first || mid == first + count)
                    mid = first + count / 2;
            }
        }
        if (mid == first || mid == first + count) mid = first + count / 2;

        // Order children along the split axis for a decent default
        // front-to-back DFS order (per-octant threading refines this).
        int32_t node_idx;
        {
            nodes.push_back(node);
            node_idx = static_cast<int32_t>(nodes.size()) - 1;
        }
        int32_t l = build(first, mid - first);
        int32_t r = build(mid, first + count - mid);
        nodes[node_idx].left = l;
        nodes[node_idx].right = r;
        return node_idx;
    }
};

}  // namespace

extern "C" {

// Builds the BVH. Inputs: v0/e1/e2 as [n_tris][3] float32 (Möller-Trumbore
// edge form, matching the device geometry arrays). Outputs are caller-
// allocated with capacity 2*n_tris (nodes) / n_tris (tri_order); returns the
// actual node count, or -1 on error.
//
// out arrays:
//   bbox_min, bbox_max      : [cap][3] f32
//   left_child, right_child : [cap] i32 (BuildNode indexing, DFS order)
//   leaf_first, leaf_count  : [cap] i32
//   tri_order               : [n_tris] i32
int32_t bvh_build_sah(const float* v0, const float* e1, const float* e2,
                      int32_t n_tris, int32_t max_leaf,
                      float* bbox_min, float* bbox_max,
                      int32_t* left_child, int32_t* right_child,
                      int32_t* leaf_first, int32_t* leaf_count,
                      int32_t* tri_order) {
    if (n_tris <= 0) return -1;
    Builder b;
    b.max_leaf = std::max(max_leaf, 1);
    b.prims.resize(n_tris);
    for (int32_t i = 0; i < n_tris; ++i) {
        Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
        Vec3 p1{a.x + e1[3 * i], a.y + e1[3 * i + 1], a.z + e1[3 * i + 2]};
        Vec3 p2{a.x + e2[3 * i], a.y + e2[3 * i + 1], a.z + e2[3 * i + 2]};
        AABB box;
        box.grow(a);
        box.grow(p1);
        box.grow(p2);
        b.prims[i].box = box;
        b.prims[i].centroid = {(box.lo.x + box.hi.x) * 0.5f,
                               (box.lo.y + box.hi.y) * 0.5f,
                               (box.lo.z + box.hi.z) * 0.5f};
        b.prims[i].index = i;
    }
    b.nodes.reserve(2 * n_tris);
    b.build(0, n_tris);

    int32_t n_nodes = static_cast<int32_t>(b.nodes.size());
    if (n_nodes > 2 * n_tris) return -1;  // capacity contract violated

    for (int32_t i = 0; i < n_nodes; ++i) {
        const BuildNode& n = b.nodes[i];
        bbox_min[3 * i] = n.box.lo.x;
        bbox_min[3 * i + 1] = n.box.lo.y;
        bbox_min[3 * i + 2] = n.box.lo.z;
        bbox_max[3 * i] = n.box.hi.x;
        bbox_max[3 * i + 1] = n.box.hi.y;
        bbox_max[3 * i + 2] = n.box.hi.z;
        left_child[i] = n.left;
        right_child[i] = n.right;
        leaf_first[i] = n.count > 0 ? n.first : -1;
        leaf_count[i] = n.count;
    }
    for (int32_t i = 0; i < n_tris; ++i) tri_order[i] = b.prims[i].index;
    return n_nodes;
}

}  // extern "C"
