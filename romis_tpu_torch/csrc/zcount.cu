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
// One thread per pixel. For each origin the K ray set-ups stay in registers
// (K is a template parameter, 1..4), and the soup is staged through shared
// memory in kTriChunk chunks as in kernel 6; a ray stops at its first hit,
// and a block stops staging chunks once none of its rays is pending
// (__syncthreads_or). The soup is staged again for each origin. Bound:
// operations, (R+1)·T origin set-ups and up to (R+1)·K·T ray tests per pixel
// (~20 and ~30 flops); device memory sees 3(R+1) + 3K floats and (R+1)·K
// mask bytes in and (R+1)·K bytes out. Neither shared-origin tiling across
// pixels nor a per-chunk box cull is done here yet.
#include "common.cuh"

namespace romis {

constexpr int kMaxOrigins = 9;  // ops/spatial.MAX_UNBIASED_NEIGHBOURS + 1

template <int K>
__global__ void __launch_bounds__(kThreads)
zcount_kernel(const float* __restrict__ origins, const float* __restrict__ targets,
              const unsigned char* __restrict__ mask, long long n, int n_orig,
              const float* __restrict__ cols, int n_tris, float eps,
              unsigned char* __restrict__ out) {
  __shared__ float s[10][kTriChunk];
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = p < n;
  float gx[K], gy[K], gz[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    gx[l] = live ? targets[(3 * l) * n + p] : 0.0f;
    gy[l] = live ? targets[(3 * l + 1) * n + p] : 0.0f;
    gz[l] = live ? targets[(3 * l + 2) * n + p] : 0.0f;
  }
  for (int r = 0; r < n_orig; ++r) {
    float ox = 0.0f, oy = 0.0f, oz = 0.0f;
    if (live) {
      ox = origins[(3 * r) * n + p];
      oy = origins[(3 * r + 1) * n + p];
      oz = origins[(3 * r + 2) * n + p];
    }
    float dx[K], dy[K], dz[K], dist[K];
    unsigned pending = 0u, occ = 0u;
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const float tox = gx[l] - ox, toy = gy[l] - oy, toz = gz[l] - oz;
      const float sq = tox * tox + toy * toy + toz * toz;
      float d = sq > 1e-30f ? sqrtf(sq) : 0.0f;
      const float dinv = 1.0f / fmaxf(d, 1e-20f);
      if (mask != nullptr && live && mask[(static_cast<long long>(r) * K + l) * n + p] == 0)
        d = 0.0f;
      dx[l] = tox * dinv;
      dy[l] = toy * dinv;
      dz[l] = toz * dinv;
      dist[l] = d;
      if (live && d > eps) pending |= 1u << l;
    }
    for (int base = 0; base < n_tris; base += kTriChunk) {
      // Also the barrier before the chunk buffer is overwritten.
      if (!__syncthreads_or(pending != 0u)) break;
      const int cnt = min(kTriChunk, n_tris - base);
      stage_tris(s, cols, n_tris, base, cnt);
      __syncthreads();
      for (int j = 0; j < cnt && pending != 0u; ++j) {
        if (!(s[9][j] > 0.0f)) continue;  // an inactive (padding) triangle
        const float v0x = s[0][j], v0y = s[1][j], v0z = s[2][j];
        const float e1x = s[3][j], e1y = s[4][j], e1z = s[5][j];
        const float e2x = s[6][j], e2y = s[7][j], e2z = s[8][j];
        // Shared by the K rays: tvec, qvec, e2·qvec.
        const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float e2q = e2x * qx + e2y * qy + e2z * qz;
#pragma unroll
        for (int l = 0; l < K; ++l) {
          if (!((pending >> l) & 1u)) continue;
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
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int l = 0; l < K; ++l)
        out[(static_cast<long long>(r) * K + l) * n + p] = (occ >> l) & 1u;
    }
  }
}

}  // namespace romis

extern "C" int romis_zcount_occ(const float* origins, const float* targets,
                                const unsigned char* mask, long long n,
                                int n_orig, int k, const float* cols,
                                int n_tris, float eps, unsigned char* out,
                                cudaStream_t stream) {
  using namespace romis;
  if (n_orig < 1 || n_orig > kMaxOrigins) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = blocks_for(n);
  switch (k) {
    case 1: zcount_kernel<1><<<grid, kThreads, 0, stream>>>(origins, targets, mask, n, n_orig, cols, n_tris, eps, out); break;
    case 2: zcount_kernel<2><<<grid, kThreads, 0, stream>>>(origins, targets, mask, n, n_orig, cols, n_tris, eps, out); break;
    case 3: zcount_kernel<3><<<grid, kThreads, 0, stream>>>(origins, targets, mask, n, n_orig, cols, n_tris, eps, out); break;
    case 4: zcount_kernel<4><<<grid, kThreads, 0, stream>>>(origins, targets, mask, n, n_orig, cols, n_tris, eps, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
