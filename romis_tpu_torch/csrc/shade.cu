// Kernel 4: final shade — shadow ray x Phong x W, averaged over K lanes.
//
// Replaces romis_tpu/ops/pallas_shade.py final_shade_pallas / _shade_kernel
// (with _shade_lane_setup and _shade_phong_accum). Per pixel and lane: a
// shadow ray from the surface point pushed 1e-3 toward the reservoir sample,
// t_max = the remaining distance (ops/wrs.visibility; a coincident light
// counts as visible), any-hit against the triangle soup with an early exit
// per ray, then unshadowed Phong (ops/shading.phong_shade, falloff clamped
// at 1e-5) x visibility x W, summed over the lanes and divided by K. Dead
// rays — a missed pixel, a light behind the surface, or W = 0 — contribute
// nothing whatever the visibility, so they skip the trace. Output: the
// pre-tone-map color [3, H, W].
//
// One thread per pixel; the triangle columns are staged through shared
// memory in 512-triangle chunks (a broadcast read, as in kernel 1), with the
// K lanes' occlusion flags in registers across the chunks. Bound: compute,
// ~30 flops per live ray-triangle test until the first hit; device-memory
// traffic is 18 + 10K planes in, 3 out.
//
// Kernel 21, the BVH mode (kBvh, romis_final_shade_bvh), replaces
// romis_tpu/ops/pallas_shade.py final_shade_paged_pallas /
// _shade_paged_kernel: the same pixel, with the K live shadow rays traced by
// one shared walk of the BVH (walk.cuh walk_any, kernel 20's walk) instead
// of the soup loop, for scenes of any size. Its plain version is the same
// final_shade_plain, whose visibility then walks the tree
// (ops/traverse.bvh_any). Bound: the box and triangle tests of the walk.
//
// Both modes take the unshaded flag (Features.enable_shading=False): the
// shade of every lane is then kd, whatever the light's side and the
// receiver's validity (ops/shading.phong_shade), so every lane with W != 0
// traces its shadow ray.
#include "walk.cuh"

namespace romis {

// K is a template parameter so the per-lane ray state stays in registers.
template <int K, bool kBvh>
__global__ void __launch_bounds__(kThreads)
final_shade_kernel(const float* __restrict__ ctx, const float* __restrict__ res,
                   long long n, const float4* __restrict__ nodes,
                   const float* __restrict__ cols, int n_tris, bool unshaded,
                   float* __restrict__ out) {
  constexpr int k = K;
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in_range = p < n;

  float px = 0.f, py = 0.f, pz = 0.f;
  bool valid = false;
  // Per lane: shadow-ray origin, direction, t_max and whether it still needs
  // tracing (live and not yet occluded).
  float rox[K], roy[K], roz[K];
  float rdx[K], rdy[K], rdz[K], rtm[K];
  bool pending[K], occluded[K];
  float nx = 0.f, ny = 0.f, nz = 0.f;
  if (in_range) {
    px = ctx[p]; py = ctx[n + p]; pz = ctx[2 * n + p];
    nx = ctx[3 * n + p]; ny = ctx[4 * n + p]; nz = ctx[5 * n + p];
    valid = ctx[17 * n + p] > 0.5f;
  }
#pragma unroll
  for (int lane = 0; lane < K; ++lane) {
    pending[lane] = false;
    occluded[lane] = false;
    if (!in_range) continue;
    const float lx = res[(3 * lane) * n + p];
    const float ly = res[(3 * lane + 1) * n + p];
    const float lz = res[(3 * lane + 2) * n + p];
    const float big_w = res[(8 * k + lane) * n + p];
    const float tox = lx - px, toy = ly - py, toz = lz - pz;
    // ops/wrs.visibility
    const float vdist = safe_norm3(tox, toy, toz);
    const float dmax = fmaxf(vdist, 1e-20f);
    const float dx = tox / dmax, dy = toy / dmax, dz = toz / dmax;
    const float ox = px + kShadowEpsilon * dx;
    const float oy = py + kShadowEpsilon * dy;
    const float oz = pz + kShadowEpsilon * dz;
    rox[lane] = ox; roy[lane] = oy; roz[lane] = oz;
    rdx[lane] = dx; rdy[lane] = dy; rdz[lane] = dz;
    rtm[lane] = safe_norm3(lx - ox, ly - oy, lz - oz);
    // Dead-ray test with the Phong light direction (ops/shading.phong_shade).
    const float dist = sqrtf(fmaxf(tox * tox + toy * toy + toz * toz, 1e-24f));
    const float lmax = fmaxf(dist, 1e-20f);
    const float dot_nl = nx * (tox / lmax) + ny * (toy / lmax) + nz * (toz / lmax);
    pending[lane] = (unshaded || (valid && dot_nl >= 0.0f)) &&
                    big_w != 0.0f && vdist > kShadowEpsilon;
  }

  if constexpr (kBvh) {
    if (!in_range) return;
    unsigned live = 0u;
#pragma unroll
    for (int lane = 0; lane < K; ++lane)
      if (pending[lane]) live |= 1u << lane;
    const unsigned occ = walk_any<K>(nodes, cols, n_tris, rox, roy, roz, rdx,
                                     rdy, rdz, rtm, live);
#pragma unroll
    for (int lane = 0; lane < K; ++lane) occluded[lane] = (occ >> lane) & 1u;
  } else {
    __shared__ float s[10][kTriChunk];
    for (int base = 0; base < n_tris; base += kTriChunk) {
      const int cnt = min(kTriChunk, n_tris - base);
      __syncthreads();
      stage_tris(s, cols, n_tris, base, cnt);
      __syncthreads();
#pragma unroll
      for (int lane = 0; lane < K; ++lane) {
        if (!pending[lane]) continue;
        for (int j = 0; j < cnt; ++j) {
          float t, u, v;
          if (mt_hit(rox[lane], roy[lane], roz[lane], rdx[lane], rdy[lane],
                     rdz[lane], &s[0][j], kTriChunk, t, u, v) &&
              t < rtm[lane]) {
            occluded[lane] = true;
            pending[lane] = false;
            break;
          }
        }
      }
    }
    if (!in_range) return;
  }

  // Unit view vector (core/vec.vnormalize of view_origin - p).
  const float ax = ctx[6 * n + p] - px, ay = ctx[7 * n + p] - py,
              az = ctx[8 * n + p] - pz;
  const float ainv = 1.0f / fmaxf(safe_norm3(ax, ay, az), 1e-20f);
  const float vx = ax * ainv, vy = ay * ainv, vz = az * ainv;
  const float shin = ctx[15 * n + p];

  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int lane = 0; lane < K; ++lane) {
    const float lx = res[(3 * lane) * n + p];
    const float ly = res[(3 * lane + 1) * n + p];
    const float lz = res[(3 * lane + 2) * n + p];
    const float big_w = res[(8 * k + lane) * n + p];
    const float tox = lx - px, toy = ly - py, toz = lz - pz;
    const float dist = sqrtf(fmaxf(tox * tox + toy * toy + toz * toz, 1e-24f));
    const float lmax = fmaxf(dist, 1e-20f);
    const float ldx = tox / lmax, ldy = toy / lmax, ldz = toz / lmax;
    const float dot_nl = nx * ldx + ny * ldy + nz * ldz;
    const float rx0 = 2.0f * dot_nl * nx - ldx;
    const float ry0 = 2.0f * dot_nl * ny - ldy;
    const float rz0 = 2.0f * dot_nl * nz - ldz;
    const float rinv = 1.0f / fmaxf(safe_norm3(rx0, ry0, rz0), 1e-20f);
    const float cos_t = (rx0 * rinv) * vx + (ry0 * rinv) * vy + (rz0 * rinv) * vz;
    const float spec_pow = cos_t > 0.0f ? powf(fmaxf(cos_t, 1e-12f), shin) : 0.0f;
    const float falloff = dist < kZeroEpsilon ? 1.0f : dist;
    const bool lit = (unshaded || (valid && dot_nl >= 0.0f)) && !occluded[lane];
    for (int c = 0; c < 3; ++c) {
      const float col = res[(3 * k + 3 * lane + c) * n + p];
      const float kd = ctx[(9 + c) * n + p], ks = ctx[(12 + c) * n + p];
      const float o = unshaded ? kd
                               : (scrub(col * kd * dot_nl) + scrub(col * ks * spec_pow)) /
                                     (falloff * falloff);
      acc[c] = acc[c] + (lit ? o : 0.0f) * big_w;
    }
  }
  const float kf = static_cast<float>(k);
  for (int c = 0; c < 3; ++c) out[c * n + p] = acc[c] / kf;
}

template <bool kBvh>
int launch_shade(const float* ctx, const float* res, long long n, int k,
                 const float* nodes, const float* cols, int n_tris, bool unshaded,
                 float* out, cudaStream_t stream) {
  const int grid = blocks_for(n);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  switch (k) {
    case 1: final_shade_kernel<1, kBvh><<<grid, kThreads, 0, stream>>>(ctx, res, n, nd, cols, n_tris, unshaded, out); break;
    case 2: final_shade_kernel<2, kBvh><<<grid, kThreads, 0, stream>>>(ctx, res, n, nd, cols, n_tris, unshaded, out); break;
    case 3: final_shade_kernel<3, kBvh><<<grid, kThreads, 0, stream>>>(ctx, res, n, nd, cols, n_tris, unshaded, out); break;
    case 4: final_shade_kernel<4, kBvh><<<grid, kThreads, 0, stream>>>(ctx, res, n, nd, cols, n_tris, unshaded, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace romis

extern "C" int romis_final_shade(const float* ctx, const float* res,
                                 long long n, int k, const float* cols,
                                 int n_tris, int unshaded, float* out,
                                 cudaStream_t stream) {
  return romis::launch_shade<false>(ctx, res, n, k, nullptr, cols, n_tris,
                                    unshaded != 0, out, stream);
}

extern "C" int romis_final_shade_bvh(const float* ctx, const float* res,
                                     long long n, int k, const float* nodes,
                                     const float* cols, int n_tris,
                                     int unshaded, float* out,
                                     cudaStream_t stream) {
  return romis::launch_shade<true>(ctx, res, n, k, nodes, cols, n_tris,
                                   unshaded != 0, out, stream);
}
