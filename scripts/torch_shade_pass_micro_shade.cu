// Variants of kernel 4 (the final shade on a triangle soup, csrc/shade.cu)
// that the package leaves out, for scripts/torch_shade_pass_micro.py. The
// package's shade.cu is included for its helpers (the fields, the lane's
// shadow ray and term, the lane-order sum) and cull.cuh for the soup's
// blocks. Every variant reads the package's inputs (the fields' own planes,
// the blocks of ops/trace.zcount_blocks), at K = 2:
// - variant 1: the package's kernel in blocks of 1024 threads (more warps
//   an SM where the staged soup leaves room for one block);
// - variant 2: a block's triangles dealt out to the warp, two rays at a
//   time, a lane a triangle, where at most kDealMax of its lanes need the
//   block (kernel 7's dealing);
// - variant 3: the box alone decides, no near-parallel guard (timing only:
//   its bool may miss a hit on a near-parallel ray);
// - variant 4: variants 1 and 2 together (the package's design);
// - variant 5: variant 4 with a warp's pixels a 4 x 4 tile (K = 2)
//   instead of a row of 16;
// - variants 6 and 7: variant 4 dealing where at most 24 or 8 lanes need a
//   block (the package: 16);
// - variant 8: variant 5 without the guard (timing only, as variant 3);
// - variant 9: the guard replaced by a near-parallel pass: the box walk
//   alone (dealt out, 1024 threads), then, for the rays left pending, the
//   soup's triangles clustered by the direction of their normals (built by
//   the script: parallel_sets), a cone a cluster of 16 ruling its members
//   out or leaving the ray to test those it is near parallel to (|d.m| <=
//   L, one reach L = |o - c|_1 + S + t_max a ray bounding every block's; a
//   ray whose L reaches every block's growth / 8u passes every box). The
//   same bool as the guard's (zcount_blocks' bound).
#include "shade.cu"

namespace micro {
using namespace romis;

template <bool kDeal, bool kGuard, int kDealMax>
__device__ __forceinline__ bool soup_any_v(const CullSoup& s, bool pending,
                                           const ShadowRay& r) {
  const int nb = s.nb;
  const int lane = threadIdx.x & 31;
  const float ix = slab_inv(r.dx), iy = slab_inv(r.dy), iz = slab_inv(r.dz);
  bool occluded = false, any_deferred = false;
  for (int b = 0; b < nb; ++b) {
    if (!__any_sync(kFull, pending)) break;
    const bool deferred = kGuard && s.box[12 * nb + b] > 0.5f;
    any_deferred = any_deferred || deferred;
    const bool pass =
        pending &&
        (box_hit(s.box, nb, b, r.ox, r.oy, r.oz, ix, iy, iz, r.tm) ||
         (kGuard && !deferred &&
          guard_keeps(s, b, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tm)));
    const int end = b * kZBlock + static_cast<int>(s.box[11 * nb + b]);
    if (kDeal) {
      unsigned need = __ballot_sync(kFull, pass);
      if (__popc(need) <= kDealMax) {  // uniform: a warp vote
        const int half = lane >> 4, j = b * kZBlock + (lane & 15);
        while (need != 0u) {
          const int src0 = __ffs(need) - 1;
          need &= need - 1u;
          const int src1 = need != 0u ? __ffs(need) - 1 : -1;
          if (src1 >= 0) need &= need - 1u;
          const int src = half ? src1 : src0;
          const int from = src < 0 ? src0 : src;
          const float ox = __shfl_sync(kFull, r.ox, from);
          const float oy = __shfl_sync(kFull, r.oy, from);
          const float oz = __shfl_sync(kFull, r.oz, from);
          const float dx = __shfl_sync(kFull, r.dx, from);
          const float dy = __shfl_sync(kFull, r.dy, from);
          const float dz = __shfl_sync(kFull, r.dz, from);
          const float tm = __shfl_sync(kFull, r.tm, from);
          float t, u, v;
          const bool hit = src >= 0 && j < end &&
                           mt_hit(ox, oy, oz, dx, dy, dz, s.tri + j, s.n_tris, t, u, v) &&
                           t < tm;
          const unsigned hits = __ballot_sync(kFull, hit);
          if ((lane == src0 && (hits & 0xffffu)) || (lane == src1 && (hits >> 16))) {
            occluded = true;
            pending = false;
          }
        }
        continue;
      }
    }
    if (pass && tris_hit(s, b * kZBlock, end, r)) {
      occluded = true;
      pending = false;
    }
  }
  for (int b = 0; any_deferred && b < nb; ++b) {
    if (!__any_sync(kFull, pending)) break;
    if (!pending || !(s.box[12 * nb + b] > 0.5f)) continue;
    if (!box_hit(s.box, nb, b, r.ox, r.oy, r.oz, ix, iy, iz, r.tm) &&
        guard_keeps(s, b, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tm) &&
        tris_hit(s, b * kZBlock, b * kZBlock + static_cast<int>(s.box[11 * nb + b]),
                 r)) {
      occluded = true;
      pending = false;
    }
  }
  return occluded;
}

template <int K, int kThr, bool kDeal, bool kGuard, bool kTile, int kDealMax>
__global__ void __launch_bounds__(kThr)
shade_v(const ShadeFields f, long long n, int h, int w, const float* __restrict__ cols,
        const float* __restrict__ boxes, const float* __restrict__ normals, int n_tris,
        bool unshaded, float* __restrict__ out) {
  const CullSoup s = stage_cull(shade_smem, cols, boxes, normals, n_tris);
  __syncthreads();
  constexpr int kPerWarp = 32 / K;
  constexpr int kTX = K == 1 ? 8 : 4, kTY = kPerWarp / kTX;  // a warp's tile
  const int wl = threadIdx.x & 31;
  const int slot = wl / K, lane = wl - slot * K;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const int tiles_x = (w + kTX - 1) / kTX;
  const long long chunks = kTile ? static_cast<long long>(tiles_x) * ((h + kTY - 1) / kTY)
                                 : (n + kPerWarp - 1) / kPerWarp;
  for (long long c = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       c < chunks; c += warps) {
    long long p = c * kPerWarp + slot;
    bool in_range = slot < kPerWarp && p < n;
    if (kTile) {
      const int x = static_cast<int>(c % tiles_x) * kTX + slot % kTX;
      const int y = static_cast<int>(c / tiles_x) * kTY + slot / kTX;
      in_range = slot < kPerWarp && x < w && y < h;
      p = static_cast<long long>(y) * w + x;
    }
    LaneIn a{};
    ShadowRay r{};
    if (in_range) {
      a = load_lane(f, n, p, lane);
      r = lane_ray(a, unshaded);
    }
    const bool occluded =
        soup_any_v<kDeal, kGuard, kDealMax>(s, in_range && r.pending, r);
    float term[3] = {0.f, 0.f, 0.f};
    if (in_range) {
      if (kThr == 1024) a = load_lane(f, n, p, lane);
      lane_shade(f, n, p, lane, a, r.gate, occluded, unshaded, term);
    }
    write_pixel<K>(term, slot, lane, in_range, n, p, out);
  }
}

template <int kThr, bool kDeal, bool kGuard, bool kTile, int kDealMax>
int launch_v(const ShadeFields& f, long long n, int h, int w, const float* cols,
             const float* boxes, const float* normals, int n_tris, bool unshaded,
             float* out, cudaStream_t stream) {
  constexpr int K = 2;
  const size_t smem = cull_smem_bytes(n_tris);
  auto kernel = shade_v<K, kThr, kDeal, kGuard, kTile, kDealMax>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == 0) err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err == 0)
    err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThr, smem));
  if (err != 0) return err;
  constexpr int kPerBlock = kThr / 32 * (32 / K);
  const long long need = (n + kPerBlock - 1) / kPerBlock;
  const int grid = static_cast<int>(
      std::min<long long>(need, static_cast<long long>(sms) * std::max(per_sm, 1)));
  kernel<<<grid, kThr, smem, stream>>>(f, n, h, w, cols, boxes, normals, n_tris, unshaded,
                                       out);
  return static_cast<int>(cudaGetLastError());
}


// Variant 9's soup in shared memory: the columns and boxes as the
// package's, then the clusters: nc cones (float4), the slots' guard
// normals [3, 16 nc] and triangles [16 nc] (-1: none), the soup's centre,
// reach S and least growth / 8u G.
struct ParSoup {
  const float4* cones;
  const float *tri, *m;
  const int* idx;
  const float *box, *soup;
  int n_tris, nb, nc;
};

inline size_t par_smem_bytes(int n_tris, int nc) {
  return sizeof(float) * (4 * static_cast<size_t>(nc) + 10 * static_cast<size_t>(n_tris) +
                          4 * kZBlock * static_cast<size_t>(nc) +
                          13 * static_cast<size_t>(n_tris / kZBlock) + 8);
}

__device__ __forceinline__ ParSoup stage_par(float* smem, const float* __restrict__ cols,
                                             const float* __restrict__ boxes,
                                             const int* __restrict__ idx,
                                             const float* __restrict__ m,
                                             const float* __restrict__ cones,
                                             const float* __restrict__ soup, int n_tris,
                                             int nc) {
  const int nb = n_tris / kZBlock, ns = kZBlock * nc;
  float* c = smem;                  // [nc] float4, first: 16-byte aligned
  float* tri = c + 4 * nc;          // [10, n_tris]
  float* mm = tri + 10 * n_tris;    // [3, ns]
  int* ix = reinterpret_cast<int*>(mm + 3 * ns);  // [ns]
  float* box = mm + 4 * ns;         // [13, nb]
  float* sp = box + 13 * nb;        // [8]
  for (int i = threadIdx.x; i < 4 * nc; i += blockDim.x) c[i] = cones[i];
  for (int i = threadIdx.x; i < 10 * n_tris; i += blockDim.x) tri[i] = cols[i];
  for (int i = threadIdx.x; i < 3 * ns; i += blockDim.x) mm[i] = m[i];
  for (int i = threadIdx.x; i < ns; i += blockDim.x) ix[i] = idx[i];
  for (int i = threadIdx.x; i < 13 * nb; i += blockDim.x) box[i] = boxes[i];
  for (int i = threadIdx.x; i < 8; i += blockDim.x) sp[i] = soup[i];
  return ParSoup{reinterpret_cast<const float4*>(c), tri, mm, ix, box, sp, n_tris, nb, nc};
}

__device__ __forceinline__ bool par_tris_hit(const ParSoup& s, int j0, int j1,
                                             const ShadowRay& r) {
  for (int j = j0; j < j1; ++j) {
    float t, u, v;
    if (mt_hit(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, s.tri + j, s.n_tris, t, u, v) &&
        t < r.tm)
      return true;
  }
  return false;
}

__device__ __forceinline__ bool par_any(const ParSoup& s, bool pending, const ShadowRay& r) {
  const int nb = s.nb;
  const int lane = threadIdx.x & 31;
  const float ix = slab_inv(r.dx), iy = slab_inv(r.dy), iz = slab_inv(r.dz);
  const float reach = fabsf(r.ox - s.soup[0]) + fabsf(r.oy - s.soup[1]) +
                      fabsf(r.oz - s.soup[2]) + s.soup[3] + r.tm;
  const bool far = reach >= s.soup[4];
  bool occluded = false;
  for (int b = 0; b < nb; ++b) {
    if (!__any_sync(kFull, pending)) break;
    const bool pass =
        pending && (far || box_hit(s.box, nb, b, r.ox, r.oy, r.oz, ix, iy, iz, r.tm));
    const int end = b * kZBlock + static_cast<int>(s.box[11 * nb + b]);
    unsigned need = __ballot_sync(kFull, pass);
    if (__popc(need) <= kDealMax) {
      const int half = lane >> 4, j = b * kZBlock + (lane & 15);
      while (need != 0u) {
        const int src0 = __ffs(need) - 1;
        need &= need - 1u;
        const int src1 = need != 0u ? __ffs(need) - 1 : -1;
        if (src1 >= 0) need &= need - 1u;
        const int src = half ? src1 : src0;
        const int from = src < 0 ? src0 : src;
        const ShadowRay q{__shfl_sync(kFull, r.ox, from), __shfl_sync(kFull, r.oy, from),
                          __shfl_sync(kFull, r.oz, from), __shfl_sync(kFull, r.dx, from),
                          __shfl_sync(kFull, r.dy, from), __shfl_sync(kFull, r.dz, from),
                          __shfl_sync(kFull, r.tm, from), true, true};
        const bool hit = src >= 0 && j < end && par_tris_hit(s, j, j + 1, q);
        const unsigned hits = __ballot_sync(kFull, hit);
        if ((lane == src0 && (hits & 0xffffu)) || (lane == src1 && (hits >> 16))) {
          occluded = true;
          pending = false;
        }
      }
    } else if (pass && par_tris_hit(s, b * kZBlock, end, r)) {
      occluded = true;
      pending = false;
    }
  }
  const int ns = kZBlock * s.nc;
  for (int c = 0; c < s.nc; ++c) {
    if (!__any_sync(kFull, pending && !far)) break;
    if (!pending || far) continue;
    const float4 cn = s.cones[c];
    if (fabsf(r.dx * cn.x + r.dy * cn.y + r.dz * cn.z) - cn.w > reach) continue;
    for (int q = c * kZBlock; q < (c + 1) * kZBlock; ++q) {
      const int j = s.idx[q];
      if (j < 0) break;
      if (fabsf(r.dx * s.m[q] + r.dy * s.m[ns + q] + r.dz * s.m[2 * ns + q]) <= reach &&
          par_tris_hit(s, j, j + 1, r)) {
        occluded = true;
        pending = false;
        break;
      }
    }
  }
  return occluded;
}

__global__ void __launch_bounds__(1024)
shade_par(const ShadeFields f, long long n, const float* __restrict__ cols,
          const float* __restrict__ boxes, const int* __restrict__ idx,
          const float* __restrict__ m, const float* __restrict__ cones,
          const float* __restrict__ soup, int n_tris, int nc, bool unshaded,
          float* __restrict__ out) {
  constexpr int K = 2, kPerWarp = 16;
  const ParSoup s = stage_par(shade_smem, cols, boxes, idx, m, cones, soup, n_tris, nc);
  __syncthreads();
  const int wl = threadIdx.x & 31;
  const int slot = wl / K, lane = wl - slot * K;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const long long chunks = (n + kPerWarp - 1) / kPerWarp;
  for (long long c = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       c < chunks; c += warps) {
    const long long p = c * kPerWarp + slot;
    const bool in_range = p < n;
    LaneIn a{};
    ShadowRay r{};
    if (in_range) {
      a = load_lane(f, n, p, lane);
      r = lane_ray(a, unshaded);
    }
    const bool occluded = par_any(s, in_range && r.pending, r);
    float term[3] = {0.f, 0.f, 0.f};
    if (in_range) {
      a = load_lane(f, n, p, lane);
      lane_shade(f, n, p, lane, a, r.gate, occluded, unshaded, term);
    }
    write_pixel<K>(term, slot, lane, in_range, n, p, out);
  }
}

}  // namespace micro

extern "C" int micro_shade_soup(int variant, const float* pos, const float* nrm,
                                const float* view, const float* kd, const float* ks,
                                const float* shin, const bool* valid, const float* lpos,
                                const float* lcol, const float* lw, long long n, int k,
                                int h, int w, const float* cols, const float* boxes,
                                const float* normals, int n_tris, int unshaded,
                                float* out, cudaStream_t stream) {
  using namespace micro;
  if (k != 2 || n_tris / kZBlock < 2) return static_cast<int>(cudaErrorInvalidValue);
  const ShadeFields f{pos, nrm, view, kd, ks, shin, valid, lpos, lcol, lw};
  const bool u = unshaded != 0;
#define MICRO_V(T, D, G, TL, M) \
  launch_v<T, D, G, TL, M>(f, n, h, w, cols, boxes, normals, n_tris, u, out, stream)
  switch (variant) {
    case 1: return MICRO_V(1024, false, true, false, 16);
    case 2: return MICRO_V(256, true, true, false, 16);
    case 3: return MICRO_V(256, false, false, false, 16);
    case 4: return MICRO_V(1024, true, true, false, 16);
    case 5: return MICRO_V(1024, true, true, true, 16);
    case 6: return MICRO_V(1024, true, true, false, 24);
    case 7: return MICRO_V(1024, true, true, false, 8);
    case 8: return MICRO_V(1024, true, false, true, 16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MICRO_V
}

extern "C" int micro_shade_par(const float* pos, const float* nrm, const float* view,
                               const float* kd, const float* ks, const float* shin,
                               const bool* valid, const float* lpos, const float* lcol,
                               const float* lw, long long n, const float* cols,
                               const float* boxes, const int* idx, const float* m,
                               const float* cones, const float* soup, int n_tris, int nc,
                               int unshaded, float* out, cudaStream_t stream) {
  using namespace micro;
  const ShadeFields f{pos, nrm, view, kd, ks, shin, valid, lpos, lcol, lw};
  const size_t smem = par_smem_bytes(n_tris, nc);
  int err = static_cast<int>(cudaFuncSetAttribute(
      shade_par, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == 0) err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err == 0)
    err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shade_par, 1024, smem));
  if (err != 0) return err;
  const long long need = (n + 511) / 512;
  const int grid = static_cast<int>(
      std::min<long long>(need, static_cast<long long>(sms) * std::max(per_sm, 1)));
  shade_par<<<grid, 1024, smem, stream>>>(f, n, cols, boxes, idx, m, cones, soup, n_tris,
                                          nc, unshaded != 0, out);
  return static_cast<int>(cudaGetLastError());
}
