// Timing variants of kernel 7 (romis_tpu_torch/csrc/zcount.cu) for
// scripts/torch_sweep_zcount_micro.py, which builds this file with the
// package's csrc/ on the include path. The kernel is the package's, with
// every way of testing a block's triangles and of running the
// near-parallel guard that was measured; the C entry micro_zcount_occ
// takes them in `variant` (see there).
#include "common.cuh"

namespace romis {

constexpr int kMaxOrigins = 9;  // ops/spatial.MAX_UNBIASED_NEIGHBOURS + 1
constexpr int kZBlock = 16;     // triangles a box (ops/trace.ZCOUNT_BLOCK)
constexpr unsigned kFull = 0xffffffffu;

extern __shared__ float zc_smem[];

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
__device__ __forceinline__ float inv_dir(float c) {
  return __fdividef(c < 0.0f ? -1.0f : 1.0f, fmaxf(fabsf(c), 1e-20f));
}

// The division-free test of ray (o, d, dist) against triangle j of the
// staged [10, T] columns: the kernel's and zcount_occ_plain's arithmetic.
__device__ __forceinline__ bool z_test(const float* tri, int n_tris, int j, float ox,
                                       float oy, float oz, float dx, float dy, float dz,
                                       float dist, float eps) {
  const float v0x = tri[j], v0y = tri[n_tris + j], v0z = tri[2 * n_tris + j];
  const float e1x = tri[3 * n_tris + j], e1y = tri[4 * n_tris + j],
              e1z = tri[5 * n_tris + j];
  const float e2x = tri[6 * n_tris + j], e2y = tri[7 * n_tris + j],
              e2z = tri[8 * n_tris + j];
  const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float e2q = e2x * qx + e2y * qy + e2z * qz;
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float ua = (tx * px + ty * py + tz * pz) * det;
  const float va = (dx * qx + dy * qy + dz * qz) * det;
  const float ta = e2q * det;
  const float aa = det * det;
  return aa > 1e-18f && ua >= 0.0f && va >= 0.0f && ua + va <= aa && ta > eps * aa &&
         ta < dist * aa && tri[9 * n_tris + j] > 0.0f;
}

// kMode: kLane, each lane tests its own rays that passed a block's box;
// kCoop, the rays that passed a block's box are
// dealt out two at a time to the warp's halves, a lane a triangle (the
// block's kZBlock = 16 triangles), the hits gathered by a warp vote;
// kHybrid, kCoop where the rays are few against the block's active
// triangles, else kLane (a block decides for the whole warp).
constexpr int kLane = 0, kCoop = 2, kHybrid = 3;
// kGuard: kEager guards a block whenever a ray's box test rejects it,
// kLazy only for the rays left unoccluded by the walk, kAuto each block
// as its flag says; kOff and
// kNotApplied (timing only) leave it out or
// compute it without using it.
constexpr int kEager = 0, kOff = 1, kNotApplied = 2, kLazy = 3, kAuto = 4;

template <int K, int kMode, int kGuard>
__global__ void __launch_bounds__(kThreads)
zcount_kernel(const float* __restrict__ origins, const float* __restrict__ targets,
              const unsigned char* __restrict__ mask, int h, int w, int n_orig,
              const float* __restrict__ cols, const float* __restrict__ boxes,
              const float* __restrict__ normals, int n_tris, int tile, float eps,
              unsigned char* __restrict__ out) {
  const int nb = n_tris / kZBlock;
  float* tri = zc_smem;                  // [10, n_tris]
  float* nrm = zc_smem + 10 * n_tris;    // [3, n_tris]
  float4* pairs = reinterpret_cast<float4*>(zc_smem + 13 * n_tris);  // [n_tris / 2]
  float* box = zc_smem + 15 * n_tris;    // [13, nb]
  for (int i = threadIdx.x; i < 10 * n_tris; i += blockDim.x) tri[i] = cols[i];
  for (int i = threadIdx.x; i < 5 * n_tris; i += blockDim.x) nrm[i] = normals[i];
  for (int i = threadIdx.x; i < 13 * nb; i += blockDim.x) box[i] = boxes[i];
  __syncthreads();

  const int n = h * w;
  const int lane = threadIdx.x & 31;
  int p;
  bool live;
  if (tile) {  // a block covers 32x8 pixels, a warp 8x4 of them
    const int bx = (w + 31) / 32;
    const int wp = threadIdx.x >> 5;
    const int x = (blockIdx.x % bx) * 32 + (wp & 3) * 8 + (lane & 7);
    const int y = (blockIdx.x / bx) * 8 + (wp >> 2) * 4 + (lane >> 3);
    live = x < w && y < h;
    p = live ? y * w + x : 0;
  } else {
    p = blockIdx.x * blockDim.x + threadIdx.x;
    live = p < n;
  }
  float gx[K], gy[K], gz[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    gx[l] = live ? targets[static_cast<size_t>(3 * l) * n + p] : 0.0f;
    gy[l] = live ? targets[static_cast<size_t>(3 * l + 1) * n + p] : 0.0f;
    gz[l] = live ? targets[static_cast<size_t>(3 * l + 2) * n + p] : 0.0f;
  }
  for (int r = 0; r < n_orig; ++r) {
    float ox = 0.0f, oy = 0.0f, oz = 0.0f;
    if (live) {
      ox = origins[static_cast<size_t>(3 * r) * n + p];
      oy = origins[static_cast<size_t>(3 * r + 1) * n + p];
      oz = origins[static_cast<size_t>(3 * r + 2) * n + p];
    }
    float dx[K], dy[K], dz[K], dist[K], ix[K], iy[K], iz[K];
    unsigned pending = 0u, occ = 0u;
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const float tox = gx[l] - ox, toy = gy[l] - oy, toz = gz[l] - oz;
      const float sq = tox * tox + toy * toy + toz * toz;
      float d = sq > 1e-30f ? sqrtf(sq) : 0.0f;
      const float dinv = 1.0f / fmaxf(d, 1e-20f);
      if (mask != nullptr && live &&
          mask[static_cast<size_t>(r * K + l) * n + p] == 0)
        d = 0.0f;
      dx[l] = tox * dinv;
      dy[l] = toy * dinv;
      dz[l] = toz * dinv;
      dist[l] = d;
      ix[l] = inv_dir(dx[l]);
      iy[l] = inv_dir(dy[l]);
      iz[l] = inv_dir(dz[l]);
      if (live && d > eps) pending |= 1u << l;
    }
    // The near-parallel guard (ops/trace.zcount_blocks) of block b for
    // the rays `cand` whose box test failed → those it keeps.
    auto guard_of = [&](int b, unsigned cand) -> unsigned {
      unsigned keep = 0u;
      const float l0 = fabsf(ox - box[6 * nb + b]) + fabsf(oy - box[7 * nb + b]) +
                       fabsf(oz - box[8 * nb + b]) + box[9 * nb + b];
      const float g_max = box[10 * nb + b];
      float reach[K];
#pragma unroll
      for (int l = 0; l < K; ++l) {
        reach[l] = l0 + dist[l];
        if (((cand >> l) & 1u) && reach[l] >= g_max) {
          keep |= 1u << l;
          cand &= ~(1u << l);
        }
      }
      // Every pair of consecutive triangles first, without a branch: one
      // product with its normals' cone (axis and radius, scaled; a pair of
      // two planes has radius inf and so always fails), then, only for the
      // pairs the cones do not rule out, each of their two normals.
      unsigned near = 0u;  // bit q * K + l
#pragma unroll
      for (int q = 0; q < kZBlock / 2; ++q) {
        const float4 c = pairs[b * (kZBlock / 2) + q];
#pragma unroll
        for (int l = 0; l < K; ++l)
          near |= static_cast<unsigned>(((cand >> l) & 1u) &&
                                        !(fabsf(dx[l] * c.x + dy[l] * c.y + dz[l] * c.z) -
                                              c.w > reach[l]))
                  << (q * K + l);
      }
      while (near != 0u) {
        const int bit = __ffs(near) - 1, q = bit / K, l = bit - q * K;
        near &= near - 1u;
        if (!((cand >> l) & 1u)) continue;
        for (int j = b * kZBlock + 2 * q; j < b * kZBlock + 2 * q + 2; ++j) {
          const float mx = nrm[j], my = nrm[n_tris + j], mz = nrm[2 * n_tris + j];
          float ddx = dx[0], ddy = dy[0], ddz = dz[0], rr = reach[0];
#pragma unroll
          for (int m = 1; m < K; ++m)
            if (m == l) { ddx = dx[m]; ddy = dy[m]; ddz = dz[m]; rr = reach[m]; }
          if (fabsf(ddx * mx + ddy * my + ddz * mz) <= rr) {
            keep |= 1u << l;
            cand &= ~(1u << l);
            break;
          }
        }
      }
      return keep;
    };
    // The triangles of block b against the rays `pass`; all lanes call it.
    auto test_block = [&](int b, unsigned pass) {
      if (kMode == kCoop || kMode == kHybrid) {
        unsigned needs[K];
        int n_need = 0;
#pragma unroll
        for (int l = 0; l < K; ++l) {
          needs[l] = __ballot_sync(kFull, (pass >> l) & 1u);
          n_need += __popc(needs[l]);
        }
        // kHybrid: dealt out while the rays are fewer than 8 a triangle of
        // the block (a round tests 2 rays; a lane's loop all its rays on
        // each triangle up to the last active one, but a warp waits for
        // its slowest lane).
        if (kMode == kCoop || n_need < 8 * static_cast<int>(box[11 * nb + b])) {
          const int half = lane >> 4, j = b * kZBlock + (lane & 15);
#pragma unroll
          for (int l = 0; l < K; ++l) {
            unsigned need = needs[l];
            while (need != 0u) {  // uniform: a warp vote
              const int src0 = __ffs(need) - 1;
              need &= need - 1u;
              const int src1 = need != 0u ? __ffs(need) - 1 : -1;
              if (src1 >= 0) need &= need - 1u;
              const int src = half ? src1 : src0;
              const int from = src < 0 ? src0 : src;
              const float rox = __shfl_sync(kFull, ox, from);
              const float roy = __shfl_sync(kFull, oy, from);
              const float roz = __shfl_sync(kFull, oz, from);
              const float rdx = __shfl_sync(kFull, dx[l], from);
              const float rdy = __shfl_sync(kFull, dy[l], from);
              const float rdz = __shfl_sync(kFull, dz[l], from);
              const float rdist = __shfl_sync(kFull, dist[l], from);
              const bool hit = src >= 0 && z_test(tri, n_tris, j, rox, roy, roz, rdx,
                                                  rdy, rdz, rdist, eps);
              const unsigned hits = __ballot_sync(kFull, hit);
              if ((lane == src0 && (hits & 0xffffu)) || (lane == src1 && (hits >> 16))) {
                occ |= 1u << l;
                pending &= ~(1u << l);
              }
            }
          }
          return;
        }
      }
      const int end = b * kZBlock + static_cast<int>(box[11 * nb + b]);
      for (int j = b * kZBlock; j < end && pass != 0u; ++j) {
        if (!(tri[9 * n_tris + j] > 0.0f)) continue;  // an inactive (padding) triangle
        const float v0x = tri[j], v0y = tri[n_tris + j], v0z = tri[2 * n_tris + j];
        const float e1x = tri[3 * n_tris + j], e1y = tri[4 * n_tris + j],
                    e1z = tri[5 * n_tris + j];
        const float e2x = tri[6 * n_tris + j], e2y = tri[7 * n_tris + j],
                    e2z = tri[8 * n_tris + j];
        // Shared by the K rays: tvec, qvec, e2·qvec.
        const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float e2q = e2x * qx + e2y * qy + e2z * qz;
#pragma unroll
        for (int l = 0; l < K; ++l) {
          if (!((pass >> l) & 1u)) continue;
          const float px = dy[l] * e2z - dz[l] * e2y;
          const float py = dz[l] * e2x - dx[l] * e2z;
          const float pz = dx[l] * e2y - dy[l] * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const float ua = (tx * px + ty * py + tz * pz) * det;
          const float va = (dx[l] * qx + dy[l] * qy + dz[l] * qz) * det;
          const float ta = e2q * det;
          const float aa = det * det;
          if (aa > 1e-18f && ua >= 0.0f && va >= 0.0f && ua + va <= aa &&
              ta > eps * aa && ta < dist[l] * aa) {
            occ |= 1u << l;
            pending &= ~(1u << l);
            pass &= ~(1u << l);
          }
        }
      }
    };
    auto box_pass = [&](int b) {
      unsigned pass = 0u;
#pragma unroll
      for (int l = 0; l < K; ++l)
        if (((pending >> l) & 1u) &&
            box_hit(box, nb, b, ox, oy, oz, ix[l], iy[l], iz[l], dist[l]))
          pass |= 1u << l;
      return pass;
    };
    // The walk: boxes (and the guard of the blocks they reject), then the
    // triangles of the blocks kept. A deferred block's guard runs only in
    // a second pass, for the rays the walk left unoccluded (a hit ends a
    // ray whatever the other blocks hold). Both loops are uniform over the
    // warp, so its votes are legal.
    // kAuto defers the guard of a block whose pairs mostly lack a cone
    // (box row 12: a soup's, where the guard tries each normal).
    auto deferred = [&](int b) {
      return kGuard == kLazy || (kGuard == kAuto && box[12 * nb + b] > 0.5f);
    };
    bool any_deferred = false;
    for (int b = 0; b < nb; ++b) {
      if (!__any_sync(kFull, pending != 0u)) break;
      unsigned pass = box_pass(b);
      if (kGuard == kNotApplied || (kGuard != kOff && !deferred(b))) {
        const unsigned cand = pending & ~pass;
        const unsigned keep = cand != 0u ? guard_of(b, cand) : 0u;
        if (kGuard != kNotApplied) pass |= keep;
        else if (keep == 0xdeadbeefu) out[0] = 1;  // computed, not applied
      }
      any_deferred = any_deferred || (kGuard != kOff && deferred(b));
      test_block(b, pass);
    }
    for (int b = 0; any_deferred && b < nb; ++b) {  // any_deferred is uniform
      if (!__any_sync(kFull, pending != 0u)) break;
      if (!deferred(b)) continue;
      const unsigned cand = pending & ~box_pass(b);
      test_block(b, cand != 0u ? guard_of(b, cand) : 0u);
    }
    if (live) {
#pragma unroll
      for (int l = 0; l < K; ++l)
        out[static_cast<size_t>(r * K + l) * n + p] = (occ >> l) & 1u;
    }
  }
}

template <int K, int kMode, int kGuard>
int launch_zcount(const float* origins, const float* targets, const unsigned char* mask,
                  int h, int w, int n_orig, const float* cols, const float* boxes,
                  const float* normals, int n_tris, int tile, float eps,
                  unsigned char* out, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (15 * static_cast<size_t>(n_tris) + 13 * (n_tris / kZBlock));
  const int err = static_cast<int>(cudaFuncSetAttribute(
      zcount_kernel<K, kMode, kGuard>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err != 0) return err;
  const long long n = static_cast<long long>(h) * w;
  const int grid = tile ? ((w + 31) / 32) * ((h + 7) / 8) : blocks_for(n);
  zcount_kernel<K, kMode, kGuard><<<grid, kThreads, smem, stream>>>(
      origins, targets, mask, h, w, n_orig, cols, boxes, normals, n_tris, tile, eps, out);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, int kGuard>
int launch_zcount_k(int k, const float* origins, const float* targets,
                    const unsigned char* mask, int h, int w, int n_orig,
                    const float* cols, const float* boxes, const float* normals,
                    int n_tris, int tile, float eps, unsigned char* out,
                    cudaStream_t stream) {
#define ROMIS_ZK(K) launch_zcount<K, kMode, kGuard>(origins, targets, mask, h, w, n_orig, \
                                                     cols, boxes, normals, n_tris, tile, \
                                                     eps, out, stream)
  if constexpr (kGuard == kOff || kGuard == kNotApplied) {  // timing only: K = 2
    return k == 2 ? ROMIS_ZK(2) : static_cast<int>(cudaErrorInvalidValue);
  } else {
    switch (k) {
      case 1: return ROMIS_ZK(1);
      case 2: return ROMIS_ZK(2);
      case 3: return ROMIS_ZK(3);
      case 4: return ROMIS_ZK(4);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef ROMIS_ZK
}

}  // namespace romis

// The package's romis_zcount_occ with one more argument, `variant`:
// bits 0-1 the mode (0 kLane, 2 kCoop, 3 kHybrid), bit 2 the 8x4 pixel
// tiles, bit 5 the lazy guard, bit 6 the guard deferred as each block's
// flag says, bits 3-4 (timing only) 1 the guard off (NOT the plain bool),
// 2 the guard computed, not applied. The package runs 71 on a soup of
// many blocks and 0 on a soup of one.
extern "C" int micro_zcount_occ(const float* origins, const float* targets,
                                const unsigned char* mask, int h, int w,
                                int n_orig, int k, const float* cols,
                                const float* boxes, const float* normals,
                                int n_tris, float eps, int variant,
                                unsigned char* out, cudaStream_t stream) {
  using namespace romis;
  if (n_orig < 1 || n_orig > kMaxOrigins || n_tris % kZBlock != 0 || n_tris > 2048 ||
      static_cast<long long>(h) * w >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = (variant >> 2) & 1;
  const int m = variant & 3;
#define ROMIS_Z(M, G) launch_zcount_k<M, G>(k, origins, targets, mask, h, w, n_orig, cols, \
                                             boxes, normals, n_tris, tile, eps, out, stream)
#define ROMIS_ZM(G) (m == kLane ? ROMIS_Z(kLane, G) : m == kCoop ? ROMIS_Z(kCoop, G) \
                                                   : ROMIS_Z(kHybrid, G))
  if (m == 1) return static_cast<int>(cudaErrorInvalidValue);
  const int g = (variant >> 3) & 3;
  if (g == 1) return ROMIS_ZM(kOff);
  if (g == 2) return ROMIS_ZM(kNotApplied);
  if (g != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (variant & 64) return ROMIS_ZM(kAuto);
  return (variant & 32) ? ROMIS_ZM(kLazy) : ROMIS_ZM(kEager);
#undef ROMIS_ZM
#undef ROMIS_Z
}
