// Kernel 7: the Z-count occlusion of the unbiased pass's visibility check.
//
// Replaces romis_tpu/ops/pallas_trace.py pallas_zcount_occ / _zcount_kernel
// (with occlusion_shared_origin_into): per pixel, the rays from each of the
// R+1 origins (the receiver, then the R neighbours' surface points) to each
// of the K winning samples; occluded = some triangle at t in (eps, dist)
// from the UNSHIFTED origin along the unit direction, which is
// ops/wrs.visibility_from's window (its origin pushed eps along a unit
// direction shifts every t by eps). dist <= eps is never occluded (the
// coincident pair), nor is a masked-off ray (its dist is 0): such rays are
// not traced. origins [R+1, 3, N], targets [K, 3, N], mask [R+1, K, N]
// bytes or null → out [R+1, K, N] bytes.
//
// The test is the reference's division-free Möller–Trumbore: the terms that
// depend on the origin alone (tvec, qvec = tvec x e1, e2·qvec) are computed
// once per (origin, triangle) and shared by its K rays, and each ray scales
// by det instead of dividing by it (ua = (tvec·pvec)·det, va = (d·qvec)·det,
// ta = e2q·det, aa = det²). ops/trace.zcount_occ_plain computes the same
// operations in the same order and the library is compiled with
// --fmad=false, so the two agree on every ray.
//
// What bounds it on the H100: operations, the ray-triangle tests. The
// earlier design tested every active triangle for every pending ray
// (~800 of the torus soup's 970 for a traced ray) and staged the soup again
// for each origin. This design culls as the TPU kernel did: the wrapper
// (ops/trace.zcount_blocks, once per soup) orders the soup (by the Morton
// code of its triangles' boxes where that gives smaller boxes than the
// input order), cuts it into blocks of kZBlock triangles and gives each
// block a grown box; a pending ray tests a block's box (the slab test over
// its window [0, dist]) before its triangles, stops at its first hit, and a
// warp leaves an origin's block loop once none of its rays is pending. The
// soup, its guard data and the boxes are staged into shared memory once a
// thread block for all R+1 origins (at most 2048 triangles: 127 KB).
//
// The any-hit bool is the OR over the triangles, so the order does not
// change it, but a box alone would: the plain test's rounding can accept a
// triangle the ray is nearly parallel to though the ray misses it by far
// (its errors grow as 1/|cos|; on the CPU, grazing and edge-on rays find
// such triangles). So where the box test fails, the near-parallel guard
// still takes the block if the ray is within the rounding's reach of
// parallel to one of its triangles (zcount_blocks derives the bound): one
// product a pair of consecutive triangles with their normals' cone (a
// mesh's quads share a plane), and only where the cone does not rule the
// pair out one a triangle. On a soup whose pairs share no plane the guard
// tries every normal; such a block (its flag) guards only the rays that
// the walk leaves unoccluded, in a second pass.
//
// Once the cull leaves few rays a block, the SIMT lanes idle: the rays that
// need a block are dealt out to the warp two at a time, a lane a triangle,
// where they are fewer than 8 a triangle of the block, and a warp covers
// an 8x4 tile of pixels, whose rays need more of the same blocks than a
// row's (kMany). A soup of one block has nothing to cull: each lane tests
// its own rays on rows of pixels and guards at once. The other ways of
// testing a block and of running the guard that were measured live in
// scripts/torch_sweep_zcount_micro_zcount.cu.
//
// Registers (ptxas -v, sm_90a, built for one H100): 62 at K = 2 for a
// soup of many blocks, 47 for a soup of one, no spills (40 B of spills
// at K = 3 for many blocks). PERF.md has the times of every variant measured
// (scripts/torch_sweep_zcount_micro.py).
#include "cull.cuh"

namespace romis {

constexpr int kMaxOrigins = 9;  // ops/spatial.MAX_UNBIASED_NEIGHBOURS + 1

extern __shared__ float zc_smem[];

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

// kMany (a soup of many blocks): a block's triangles are tested by the
// rays that passed its box dealt out two at a time to the warp's halves, a
// lane a triangle, the hits gathered by a warp vote, where the rays are
// fewer than 8 a triangle of the block, else each lane tests its own rays
// (a block decides for the whole warp); 8x4 pixel tiles; the guard of a
// flagged block deferred. Else each lane its own rays, rows of 32 pixels,
// every guard at once.
template <int K, bool kMany>
__global__ void __launch_bounds__(kThreads)
zcount_kernel(const float* __restrict__ origins, const float* __restrict__ targets,
              const unsigned char* __restrict__ mask, int h, int w, int n_orig,
              const float* __restrict__ cols, const float* __restrict__ boxes,
              const float* __restrict__ normals, int n_tris, float eps,
              unsigned char* __restrict__ out) {
  const CullSoup soup = stage_cull(zc_smem, cols, boxes, normals, n_tris);
  const int nb = soup.nb;
  const float* tri = soup.tri;      // [10, n_tris]
  const float* nrm = soup.nrm;      // [3, n_tris]
  const float4* pairs = soup.pairs;  // [n_tris / 2]
  const float* box = soup.box;      // [13, nb]
  __syncthreads();

  const int n = h * w;
  const int lane = threadIdx.x & 31;
  int p;
  bool live;
  if (kMany) {  // a block covers 32x8 pixels, a warp 8x4 of them
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
      ix[l] = slab_inv(dx[l]);
      iy[l] = slab_inv(dy[l]);
      iz[l] = slab_inv(dz[l]);
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
      if (kMany) {
        unsigned needs[K];
        int n_need = 0;
#pragma unroll
        for (int l = 0; l < K; ++l) {
          needs[l] = __ballot_sync(kFull, (pass >> l) & 1u);
          n_need += __popc(needs[l]);
        }
        // Dealt out while the rays are fewer than 8 a triangle of the
        // block (a round tests 2 rays; a lane's loop all its rays on each
        // triangle up to the last active one, but a warp waits for its
        // slowest lane).
        if (n_need < 8 * static_cast<int>(box[11 * nb + b])) {
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
    // ray whatever the other blocks hold): kMany defers the guard of a
    // block whose pairs mostly lack a cone (box row 12: a soup's, where
    // the guard tries each normal). Both loops are uniform over the warp,
    // so its votes are legal.
    auto deferred = [&](int b) { return kMany && box[12 * nb + b] > 0.5f; };
    bool any_deferred = false;
    for (int b = 0; b < nb; ++b) {
      if (!__any_sync(kFull, pending != 0u)) break;
      unsigned pass = box_pass(b);
      if (!deferred(b)) {
        const unsigned cand = pending & ~pass;
        pass |= cand != 0u ? guard_of(b, cand) : 0u;
      }
      any_deferred = any_deferred || deferred(b);
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

template <int K, bool kMany>
int launch_zcount(const float* origins, const float* targets, const unsigned char* mask,
                  int h, int w, int n_orig, const float* cols, const float* boxes,
                  const float* normals, int n_tris, float eps, unsigned char* out,
                  cudaStream_t stream) {
  const size_t smem = cull_smem_bytes(n_tris);
  const int err = static_cast<int>(cudaFuncSetAttribute(
      zcount_kernel<K, kMany>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err != 0) return err;
  const long long n = static_cast<long long>(h) * w;
  const int grid = kMany ? ((w + 31) / 32) * ((h + 7) / 8) : blocks_for(n);
  zcount_kernel<K, kMany><<<grid, kThreads, smem, stream>>>(
      origins, targets, mask, h, w, n_orig, cols, boxes, normals, n_tris, eps, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMany>
int launch_zcount_k(int k, const float* origins, const float* targets,
                    const unsigned char* mask, int h, int w, int n_orig,
                    const float* cols, const float* boxes, const float* normals,
                    int n_tris, float eps, unsigned char* out, cudaStream_t stream) {
#define ROMIS_ZK(K) launch_zcount<K, kMany>(origins, targets, mask, h, w, n_orig, cols, \
                                             boxes, normals, n_tris, eps, out, stream)
  switch (k) {
    case 1: return ROMIS_ZK(1);
    case 2: return ROMIS_ZK(2);
    case 3: return ROMIS_ZK(3);
    case 4: return ROMIS_ZK(4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ROMIS_ZK
}

}  // namespace romis

// cols: [10, T] block-ordered triangle columns, T a multiple of kZBlock
// (at most 2048); boxes: [13, T / kZBlock] (min xyz, max xyz, then the
// guard's centre xyz, three L1 half-diagonals and growth / 8u, then the
// block's slots up to its last active triangle and its deferred-guard
// flag); normals: [5, T] the guard's scaled normals [3, T], then its pair
// cones [T / 2] as float4 (ops/trace.zcount_blocks).
extern "C" int romis_zcount_occ(const float* origins, const float* targets,
                                const unsigned char* mask, int h, int w,
                                int n_orig, int k, const float* cols,
                                const float* boxes, const float* normals,
                                int n_tris, float eps, unsigned char* out,
                                cudaStream_t stream) {
  using namespace romis;
  if (n_orig < 1 || n_orig > kMaxOrigins || n_tris % kZBlock != 0 || n_tris > 2048 ||
      static_cast<long long>(h) * w >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tris / kZBlock > 1)
    return launch_zcount_k<true>(k, origins, targets, mask, h, w, n_orig, cols, boxes,
                                 normals, n_tris, eps, out, stream);
  return launch_zcount_k<false>(k, origins, targets, mask, h, w, n_orig, cols, boxes,
                                normals, n_tris, eps, out, stream);
}
