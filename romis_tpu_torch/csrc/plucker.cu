// Kernel 8: boolean occlusion of ray segments by the Plücker sign test.
//
// Replaces romis_tpu/ops/pallas_trace.py pallas_any_mxu / _any_mxu_kernel.
// Each triangle has five rows of side constants (plucker_matrix, [5T, 16],
// built by the wrapper): its three Plücker edge rows [m_e, d_e], its plane
// row [n, -n·a] and the n·D row; inactive triangles have all-zero rows.
// A ray is the 10-vector R = [D, M, p0, 1] with D = t_max·d and M = p0 × D.
// The segment p0 → p0 + D crosses the triangle where the three edge sides
// share a sign (inclusive: all >= 0 or all <= 0) and s0·(s0 + ds) < 0
// (strict), s0 the plane row's product and ds the n·D row's. A zero row
// passes the sign test but fails the strict straddle, so it never occludes.
//
// The TPU kernel computes S = C·R as one MXU product per 1024-ray tile and
// writes all 5T sides of a ray to VMEM before the sign test. Here one
// thread per ray keeps R in registers and takes the five products of a
// triangle in the kernel body, in float32 with no tensor cores. A row has
// at most six columns that can be non-zero (ops/trace.PLUCKER_COLS): the
// edge rows' 0-5, the plane row's 6-9, the n·D row's 0-2. Only those are
// summed, left to right, as the plain version (ops/trace.any_hit_plucker_plain)
// sums them; a term left out is exactly zero, so every finite side is that
// of the full 10-term product but for the sign of a zero, which the test
// does not read. Built with --fmad=false, kernel and plain version give the
// same bool on every ray, sign boundaries included. A ray stops at its
// first occluding triangle, which changes no bool, and a block stops
// staging once none of its rays is pending (__syncthreads_or).
//
// The [5T, 16] constants are staged through shared memory in chunks of
// 128 triangles, reading whole rows (coalesced) and keeping each
// triangle's non-zero columns in 32 floats (kSlots: the edge rows at 0, 8
// and 16, six floats each, the plane row at 24, the n·D row at 28; a chunk
// is 16 KB), so a triangle is eight 16- or 8-byte broadcast reads in the
// product loop. Bound: operations, the 3 x 11 + 7 + 5 float operations of
// the five products and the sign test per ray-triangle test up to the
// first hit; device memory sees 7 floats in and 1 byte out per ray.
#include "common.cuh"

namespace romis {

constexpr int kPluckerChunk = 128;
constexpr int kPluckerCols = 16;  // columns of the constants
constexpr int kTerms = 10;        // R = [D, M, p0, 1]
constexpr int kRows = 5;          // three edges, the plane, n·D
constexpr int kSlots = 32;        // a triangle in shared memory: 8 float4

// Where column j of row k goes in a triangle's kSlots floats, or -1 for a
// column that is zero in every table.
__device__ __forceinline__ int plucker_slot(int k, int j) {
  if (k < 3) return j < 6 ? 8 * k + j : -1;
  if (k == 3) return (j >= 6 && j < kTerms) ? 18 + j : -1;
  return j < 3 ? 28 + j : -1;
}

__global__ void __launch_bounds__(kThreads)
any_hit_plucker_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ t_max, long long n_pix,
                       long long n_rays, const float* __restrict__ cmat,
                       int n_tris, unsigned char* __restrict__ out) {
  __shared__ __align__(16) float s[kPluckerChunk][kSlots];
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = r < n_rays;
  float rv[kTerms];
  for (int q = 0; q < kTerms; ++q) rv[q] = 0.0f;
  if (live) {
    const long long si = r / n_pix, p = r - si * n_pix;
    const long long base = si * 3 * n_pix + p;
    const float ox = o[base], oy = o[base + n_pix], oz = o[base + 2 * n_pix];
    const float tm = t_max[r];
    const float bx = tm * d[base], by = tm * d[base + n_pix], bz = tm * d[base + 2 * n_pix];
    rv[0] = bx; rv[1] = by; rv[2] = bz;
    rv[3] = oy * bz - oz * by;
    rv[4] = oz * bx - ox * bz;
    rv[5] = ox * by - oy * bx;
    rv[6] = ox; rv[7] = oy; rv[8] = oz;
    rv[9] = 1.0f;
  }
  bool pending = live;
  bool occluded = false;
  for (int base = 0; base < n_tris; base += kPluckerChunk) {
    // Also the barrier before the chunk buffer is overwritten.
    if (!__syncthreads_or(pending)) break;
    const int cnt = min(kPluckerChunk, n_tris - base);
    // Row k of triangle base + i is cmat row k·T + base + i.
    for (int idx = threadIdx.x; idx < kRows * cnt * kPluckerCols; idx += blockDim.x) {
      const int j = idx % kPluckerCols, ki = idx / kPluckerCols;
      const int k = ki / cnt, i = ki - k * cnt;
      const int slot = plucker_slot(k, j);
      if (slot >= 0) {
        s[i][slot] =
            cmat[(static_cast<long long>(k) * n_tris + base + i) * kPluckerCols + j];
      }
    }
    __syncthreads();
    if (!pending) continue;
    for (int i = 0; i < cnt; ++i) {
      const float4* c4 = reinterpret_cast<const float4*>(s[i]);
      const float2* c2 = reinterpret_cast<const float2*>(s[i]);
      float edge[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        // [m_e, d_e]·[D, M], summed left to right.
        const float4 a = c4[2 * k];
        const float2 b = c2[4 * k + 2];
        float acc = a.x * rv[0];
        acc = acc + a.y * rv[1];
        acc = acc + a.z * rv[2];
        acc = acc + a.w * rv[3];
        acc = acc + b.x * rv[4];
        acc = acc + b.y * rv[5];
        edge[k] = acc;
      }
      const float4 pl = c4[6];  // [n, -n·a]·[p0, 1]
      float s0 = pl.x * rv[6];
      s0 = s0 + pl.y * rv[7];
      s0 = s0 + pl.z * rv[8];
      s0 = s0 + pl.w * rv[9];
      const float4 nd = c4[7];  // n·D
      float ds = nd.x * rv[0];
      ds = ds + nd.y * rv[1];
      ds = ds + nd.z * rv[2];
      const bool same = (edge[0] >= 0.0f && edge[1] >= 0.0f && edge[2] >= 0.0f) ||
                        (edge[0] <= 0.0f && edge[1] <= 0.0f && edge[2] <= 0.0f);
      if (same && s0 * (s0 + ds) < 0.0f) {
        occluded = true;
        pending = false;
        break;
      }
    }
  }
  if (live) out[r] = occluded ? 1 : 0;
}

}  // namespace romis

extern "C" int romis_any_hit_plucker(const float* o, const float* d,
                                     const float* t_max, long long n_pix,
                                     long long n_rays, const float* cmat,
                                     int n_tris, unsigned char* out,
                                     cudaStream_t stream) {
  romis::any_hit_plucker_kernel<<<romis::blocks_for(n_rays), romis::kThreads, 0, stream>>>(
      o, d, t_max, n_pix, n_rays, cmat, n_tris, out);
  return static_cast<int>(cudaGetLastError());
}
