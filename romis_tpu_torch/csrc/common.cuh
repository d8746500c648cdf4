// Device helpers shared by the romis_tpu_torch kernels.
//
// Every function here mirrors one plain PyTorch formulation operation for
// operation (same epsilons, same guards, same association order), and the
// library is compiled with --fmad=false, so a kernel rounds like the plain
// version it is checked against.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace romis {

constexpr int kThreads = 256;
constexpr float kMtEpsilon = 1e-9f;       // ops/intersect.MT_EPSILON
constexpr float kShadowEpsilon = 1e-3f;   // ops/wrs.SHADOW_RAY_EPSILON
constexpr float kZeroEpsilon = 1e-5f;     // ops/shading.ZERO_EPSILON

inline int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

// Primary rays in tiles (kernels 18 and 1): ray i of a launch traces pixel
// tile_pixel(i) of the h x w frame, a warp's 32 rays an 8 x 4 tile, the
// tiles row by row (the frame padded to whole tiles: -1 off the frame).
// Neighbouring pixels' rays take nearly the same path, so a warp's lanes
// stay together.
__host__ __device__ inline long long tiled_rays(int h, int w) {
  return static_cast<long long>((h + 3) / 4) * ((w + 7) / 8) * 32;
}

__device__ __forceinline__ long long tile_pixel(long long i, int h, int w) {
  const long long tile = i >> 5;
  const int lane = static_cast<int>(i & 31);
  const int tiles_x = (w + 7) / 8;
  const long long y = tile / tiles_x * 4 + lane / 8;
  const long long x = tile % tiles_x * 8 + (lane & 7);
  return (y < h && x < w) ? y * w + x : -1;
}

__device__ __forceinline__ float scrub(float x) { return isnan(x) ? 0.0f : x; }

// core/vec.vnorm: exactly 0 for the zero vector.
__device__ __forceinline__ float safe_norm3(float x, float y, float z) {
  float sq = x * x + y * y + z * z;
  return sq > 1e-30f ? sqrtf(sq) : 0.0f;
}

// One triangle of the [10, T] columns: v0, e1 = v1 - v0, e2 = v2 - v0 and
// the active flag.
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
  bool active;
};

__device__ __forceinline__ Tri load_tri(const float* tri, int stride) {
  return Tri{tri[0 * stride], tri[1 * stride], tri[2 * stride],
             tri[3 * stride], tri[4 * stride], tri[5 * stride],
             tri[6 * stride], tri[7 * stride], tri[8 * stride],
             tri[9 * stride] > 0.0f};
}

// Möller–Trumbore of one ray against one triangle (ops/intersect._mt_block).
// Returns true on a hit with t > 0; t, u, v are always written.
__device__ __forceinline__ bool mt_tri(float ox, float oy, float oz, float dx,
                                       float dy, float dz, const Tri& tr,
                                       float& t, float& u, float& v) {
  const float v0x = tr.v0x, v0y = tr.v0y, v0z = tr.v0z;
  const float e1x = tr.e1x, e1y = tr.e1y, e1z = tr.e1z;
  const float e2x = tr.e2x, e2y = tr.e2y, e2z = tr.e2z;
  const bool active = tr.active;
  // pvec = d x e2
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool det_ok = fabsf(det) > kMtEpsilon;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  // qvec = tvec x e1
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t > 0.0f && active;
}

// mt_tri against triangle column `tri` of columns `stride` apart.
__device__ __forceinline__ bool mt_hit(float ox, float oy, float oz, float dx,
                                       float dy, float dz, const float* tri,
                                       int stride, float& t, float& u,
                                       float& v) {
  return mt_tri(ox, oy, oz, dx, dy, dz, load_tri(tri, stride), t, u, v);
}

// Triangle columns [10, T] staged through shared memory in chunks.
constexpr int kTriChunk = 512;  // 10 x 512 x 4 B = 20 KB

__device__ __forceinline__ void stage_tris(float (*s)[kTriChunk],
                                           const float* __restrict__ cols,
                                           int n_tris, int base, int cnt) {
  for (int i = threadIdx.x; i < 10 * cnt; i += blockDim.x) {
    const int c = i / cnt, j = i - c * cnt;
    s[c][j] = cols[c * n_tris + base + j];
  }
}

// Receiver shading context of one pixel.
struct Receiver {
  float px, py, pz;   // surface position
  float nx, ny, nz;   // shading normal
  float ox, oy, oz;   // view origin
  float kd[3], ks[3];
  float shin;
  bool valid;
  bool unshaded;  // Features.enable_shading=False: the colour is kd
};

// ops/shading.phong_shade_planes: unshadowed Phong of the light sample
// (l, c) at the receiver → o[3], 0 for a light behind the surface or an
// invalid receiver. (vx, vy, vz) is the receiver's unit view vector,
// hoisted by the caller exactly as the plain version computes it. In the
// unshaded mode the colour is kd whatever the sample, the light's side and
// the receiver's validity (the plain version's enable_shading=False).
__device__ __forceinline__ void phong_rgb(const Receiver& r, float vx,
                                          float vy, float vz, float lx,
                                          float ly, float lz, float cr,
                                          float cg, float cb, float (&o)[3]) {
  if (r.unshaded) {
    for (int c = 0; c < 3; ++c) o[c] = r.kd[c];
    return;
  }
  const float tox = lx - r.px, toy = ly - r.py, toz = lz - r.pz;
  const float dist2 = tox * tox + toy * toy + toz * toz;
  const float dist = sqrtf(fmaxf(dist2, 1e-24f));
  const float dinv = 1.0f / fmaxf(dist, 1e-20f);
  const float ldx = tox * dinv, ldy = toy * dinv, ldz = toz * dinv;
  const float dot_nl = r.nx * ldx + r.ny * ldy + r.nz * ldz;
  const float rx0 = 2.0f * dot_nl * r.nx - ldx;
  const float ry0 = 2.0f * dot_nl * r.ny - ldy;
  const float rz0 = 2.0f * dot_nl * r.nz - ldz;
  const float rinv = 1.0f / fmaxf(safe_norm3(rx0, ry0, rz0), 1e-20f);
  const float cos_t = (rx0 * vx + ry0 * vy + rz0 * vz) * rinv;
  const float spec_pow = cos_t > 0.0f ? powf(fmaxf(cos_t, 1e-12f), r.shin) : 0.0f;
  const float falloff = dist < kZeroEpsilon ? 1.0f : dist;
  const float inv_f2 = 1.0f / (falloff * falloff);
  const bool dead = dot_nl < 0.0f || !r.valid;
  const float col[3] = {cr, cg, cb};
  for (int c = 0; c < 3; ++c) {
    o[c] = dead ? 0.0f
                : (scrub(col[c] * r.kd[c] * dot_nl) + scrub(col[c] * r.ks[c] * spec_pow)) *
                      inv_f2;
  }
}

// target_pdf_planes: the norm of phong_rgb → p-hat.
__device__ __forceinline__ float target_pdf(const Receiver& r, float vx,
                                            float vy, float vz, float lx,
                                            float ly, float lz, float cr,
                                            float cg, float cb) {
  float o[3];
  phong_rgb(r, vx, vy, vz, lx, ly, lz, cr, cg, cb, o);
  const float sq = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
  return sq > 1e-30f ? sqrtf(sq) : 0.0f;
}

// The dot product of the normal and the light direction as phong_rgb
// computes it (a sample whose dot_nl < 0 shades to 0).
__device__ __forceinline__ float light_dot_nl(const Receiver& r, float lx,
                                              float ly, float lz) {
  const float tox = lx - r.px, toy = ly - r.py, toz = lz - r.pz;
  const float dist = sqrtf(fmaxf(tox * tox + toy * toy + toz * toz, 1e-24f));
  const float dinv = 1.0f / fmaxf(dist, 1e-20f);
  return r.nx * (tox * dinv) + r.ny * (toy * dinv) + r.nz * (toz * dinv);
}

// Philox4x32-10 (Salmon et al., SC'11): counter-based random bits.
struct U4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U4 philox4x32_10(U4 ctr, uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = U4{hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0};
    k0 += W0;
    k1 += W1;
  }
  return ctr;
}

// Top 24 bits → float in [0, 1).
__device__ __forceinline__ float u01(uint32_t bits) {
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

// A uniform offset in [-radius, radius] from 32 random bits (the spatial
// passes' and the neighbour gather's draws).
__device__ __forceinline__ int offset_from(uint32_t bits, int radius) {
  const int span = 2 * radius + 1;
  return min(static_cast<int>(u01(bits) * static_cast<float>(span)), 2 * radius) - radius;
}

}  // namespace romis
