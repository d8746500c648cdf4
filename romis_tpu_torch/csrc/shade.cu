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
// Kernel 21, the BVH mode (romis_final_shade_bvh), replaces
// romis_tpu/ops/pallas_shade.py final_shade_paged_pallas /
// _shade_paged_kernel, for scenes of any size: one thread per (pixel,
// lane), a pixel's K lanes in adjacent threads of one warp (32 / K pixels a
// warp; at K = 3 two threads of each warp idle, so no pixel straddles two
// warps). Each thread sets up its lane's shadow ray, walks the tree alone
// (walk.cuh walk_any, kernel 20's walk, leaf triangles read as 48-byte
// records, ops/walk.tri_records) and computes its lane's Phong term; the
// pixel's first thread gathers the K terms by shuffles and sums them in
// lane order from 0, ((0 + t0) + t1) + ..., then divides by K, as kernel
// 4 does, so the output is kernel 4's arithmetic bit for bit; a lane that
// is not lit skips its material and Phong (its term is 0 x W either way).
// It reads the context's and the reservoirs' own planes (ShadeFields),
// not the packed 18 + 10K planes kernel 4 takes (two copies the wrapper
// makes). Its plain
// version is the same final_shade_plain, whose visibility then walks the
// tree (ops/traverse.bvh_any). Bound: the box and triangle tests of the
// walk. The TPU kernel shares one walk between a pixel's K rays to
// amortise its page DMAs; on this card that union walk visits every node
// any of the K rays needs and tests the K slabs of a node one after
// another (PERF.md, kernel 20), so each ray walks alone here.
//
// Both modes take the unshaded flag (Features.enable_shading=False): the
// shade of every lane is then kd, whatever the light's side and the
// receiver's validity (ops/shading.phong_shade), so every lane with W != 0
// traces its shadow ray.
#include "walk.cuh"

namespace romis {

// One lane's shadow ray (ops/wrs.visibility: the origin pushed 1e-3 toward
// the sample, t_max the remaining distance) and whether it is traced: a
// dead lane (a light behind the surface or an invalid receiver, when
// shaded; W = 0; a coincident light) is not.
struct ShadowRay {
  float ox, oy, oz, dx, dy, dz, tm;
  bool pending;
  bool gate;  // Phong's gate: unshaded, or a valid receiver facing the light
};

__device__ __forceinline__ ShadowRay shadow_ray(float px, float py, float pz,
                                                float nx, float ny, float nz,
                                                bool valid, bool unshaded,
                                                float lx, float ly, float lz,
                                                float big_w) {
  const float tox = lx - px, toy = ly - py, toz = lz - pz;
  // ops/wrs.visibility
  const float vdist = safe_norm3(tox, toy, toz);
  const float dmax = fmaxf(vdist, 1e-20f);
  const float dx = tox / dmax, dy = toy / dmax, dz = toz / dmax;
  const float ox = px + kShadowEpsilon * dx;
  const float oy = py + kShadowEpsilon * dy;
  const float oz = pz + kShadowEpsilon * dz;
  // Dead-ray test with the Phong light direction (ops/shading.phong_shade).
  const float dist = sqrtf(fmaxf(tox * tox + toy * toy + toz * toz, 1e-24f));
  const float lmax = fmaxf(dist, 1e-20f);
  const float dot_nl = nx * (tox / lmax) + ny * (toy / lmax) + nz * (toz / lmax);
  const bool gate = unshaded || (valid && dot_nl >= 0.0f);
  return ShadowRay{ox, oy, oz, dx, dy, dz,
                   safe_norm3(lx - ox, ly - oy, lz - oz),
                   gate && big_w != 0.0f && vdist > kShadowEpsilon, gate};
}

// One lane's term of the pixel's sum, (lit ? Phong : 0) x W, with the
// receiver's unit view vector (vx, vy, vz) and material (kd, ks, shin).
__device__ __forceinline__ void lane_term(
    float px, float py, float pz, float nx, float ny, float nz, float vx,
    float vy, float vz, const float (&kd)[3], const float (&ks)[3],
    float shin, bool valid, bool unshaded, float lx, float ly, float lz,
    const float (&col)[3], float big_w, bool occluded, float (&term)[3]) {
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
  const bool lit = (unshaded || (valid && dot_nl >= 0.0f)) && !occluded;
  for (int c = 0; c < 3; ++c) {
    const float o = unshaded ? kd[c]
                             : (scrub(col[c] * kd[c] * dot_nl) +
                                scrub(col[c] * ks[c] * spec_pow)) /
                                   (falloff * falloff);
    term[c] = (lit ? o : 0.0f) * big_w;
  }
}

// The receiver's unit view vector (core/vec.vnormalize of view_origin - p)
// and material, from its planes (each n floats apart).
struct Material {
  float vx, vy, vz, kd[3], ks[3], shin;
};

__device__ __forceinline__ Material load_material(
    const float* __restrict__ view, const float* __restrict__ kd,
    const float* __restrict__ ks, const float* __restrict__ shin, long long n,
    long long p, float px, float py, float pz) {
  Material m;
  const float ax = view[p] - px, ay = view[n + p] - py, az = view[2 * n + p] - pz;
  const float ainv = 1.0f / fmaxf(safe_norm3(ax, ay, az), 1e-20f);
  m.vx = ax * ainv; m.vy = ay * ainv; m.vz = az * ainv;
  for (int c = 0; c < 3; ++c) {
    m.kd[c] = kd[c * n + p];
    m.ks[c] = ks[c * n + p];
  }
  m.shin = shin[p];
  return m;
}

// Kernel 4: one thread per pixel, its K lanes' shadow rays tested against
// the soup's triangles staged through shared memory. K is a template
// parameter so the per-lane ray state stays in registers.
template <int K>
__global__ void __launch_bounds__(kThreads)
final_shade_kernel(const float* __restrict__ ctx, const float* __restrict__ res,
                   long long n, const float* __restrict__ cols, int n_tris,
                   bool unshaded, float* __restrict__ out) {
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
    const ShadowRay r = shadow_ray(
        px, py, pz, nx, ny, nz, valid, unshaded, res[(3 * lane) * n + p],
        res[(3 * lane + 1) * n + p], res[(3 * lane + 2) * n + p],
        res[(8 * K + lane) * n + p]);
    rox[lane] = r.ox; roy[lane] = r.oy; roz[lane] = r.oz;
    rdx[lane] = r.dx; rdy[lane] = r.dy; rdz[lane] = r.dz;
    rtm[lane] = r.tm;
    pending[lane] = r.pending;
  }

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

  const Material m = load_material(ctx + 6 * n, ctx + 9 * n, ctx + 12 * n,
                                   ctx + 15 * n, n, p, px, py, pz);
  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int lane = 0; lane < K; ++lane) {
    const float col[3] = {res[(3 * K + 3 * lane) * n + p],
                          res[(3 * K + 3 * lane + 1) * n + p],
                          res[(3 * K + 3 * lane + 2) * n + p]};
    float term[3];
    lane_term(px, py, pz, nx, ny, nz, m.vx, m.vy, m.vz, m.kd, m.ks, m.shin,
              valid, unshaded, res[(3 * lane) * n + p], res[(3 * lane + 1) * n + p],
              res[(3 * lane + 2) * n + p], col, res[(8 * K + lane) * n + p],
              occluded[lane], term);
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + term[c];
  }
  const float kf = static_cast<float>(K);
  for (int c = 0; c < 3; ++c) out[c * n + p] = acc[c] / kf;
}

// Kernel 21's inputs: the receivers' and the reservoirs' own planes (no
// packed copies), each [..., H, W] contiguous, n = H * W floats a plane.
struct ShadeFields {
  const float *pos, *nrm, *view, *kd, *ks, *shin;  // [3] x4, [3], [1]
  const bool* valid;                               // [H, W]
  const float *lpos, *lcol, *lw;                   // [K, 3], [K, 3], [K]
};

// Kernel 21: thread slot * K + lane of a warp shades lane `lane` of the
// warp's pixel `slot`; the pixel's first thread writes its colour. Only a
// lit lane (its Phong gate passed and its ray not occluded) loads its
// receiver's material and computes its Phong term; the others add 0 x W.
constexpr int kShadeBvhThreads = 128;

template <int K>
__global__ void __launch_bounds__(kShadeBvhThreads)
final_shade_bvh_kernel(const ShadeFields f, long long n,
                       const float4* __restrict__ nodes,
                       const float4* __restrict__ recs, bool unshaded,
                       float* __restrict__ out) {
  constexpr int kPerWarp = 32 / K;
  const int wl = threadIdx.x & 31;
  const int slot = wl / K, lane = wl - slot * K;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long p = warp * kPerWarp + slot;
  const bool in_range = slot < kPerWarp && p < n;
  float term[3] = {0.f, 0.f, 0.f};
  if (in_range) {
    const float px = f.pos[p], py = f.pos[n + p], pz = f.pos[2 * n + p];
    const float nx = f.nrm[p], ny = f.nrm[n + p], nz = f.nrm[2 * n + p];
    const bool valid = f.valid[p];
    const float* lp = f.lpos + 3 * lane * n;
    const float lx = lp[p], ly = lp[n + p], lz = lp[2 * n + p];
    const float big_w = f.lw[lane * n + p];
    const ShadowRay r = shadow_ray(px, py, pz, nx, ny, nz, valid, unshaded,
                                   lx, ly, lz, big_w);
    const bool occluded =
        r.pending && walk_any(nodes, RecTris{recs}, r.ox, r.oy, r.oz, r.dx,
                              r.dy, r.dz, r.tm);
    if (r.gate && !occluded) {
      const float* lc = f.lcol + 3 * lane * n;
      const float col[3] = {lc[p], lc[n + p], lc[2 * n + p]};
      const Material m = load_material(f.view, f.kd, f.ks, f.shin, n, p, px,
                                       py, pz);
      lane_term(px, py, pz, nx, ny, nz, m.vx, m.vy, m.vz, m.kd, m.ks, m.shin,
                valid, unshaded, lx, ly, lz, col, big_w, occluded, term);
    } else {
      for (int c = 0; c < 3; ++c) term[c] = 0.0f * big_w;
    }
  }
  // The lane-order sum, ((0 + t0) + t1) + ..., at the pixel's first thread.
  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < K; ++j)
    for (int c = 0; c < 3; ++c)
      acc[c] = acc[c] + __shfl_sync(0xffffffffu, term[c], slot * K + j);
  if (!in_range || lane != 0) return;
  const float kf = static_cast<float>(K);
  for (int c = 0; c < 3; ++c) out[c * n + p] = acc[c] / kf;
}

int launch_shade(const float* ctx, const float* res, long long n, int k,
                 const float* cols, int n_tris, bool unshaded, float* out,
                 cudaStream_t stream) {
  const int grid = blocks_for(n);
  switch (k) {
    case 1: final_shade_kernel<1><<<grid, kThreads, 0, stream>>>(ctx, res, n, cols, n_tris, unshaded, out); break;
    case 2: final_shade_kernel<2><<<grid, kThreads, 0, stream>>>(ctx, res, n, cols, n_tris, unshaded, out); break;
    case 3: final_shade_kernel<3><<<grid, kThreads, 0, stream>>>(ctx, res, n, cols, n_tris, unshaded, out); break;
    case 4: final_shade_kernel<4><<<grid, kThreads, 0, stream>>>(ctx, res, n, cols, n_tris, unshaded, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int K>
void launch_shade_bvh(const ShadeFields& f, long long n, const float4* nodes,
                      const float4* recs, bool unshaded, float* out,
                      cudaStream_t stream) {
  constexpr int kPerBlock = kShadeBvhThreads / 32 * (32 / K);
  const int grid = static_cast<int>((n + kPerBlock - 1) / kPerBlock);
  final_shade_bvh_kernel<K><<<grid, kShadeBvhThreads, 0, stream>>>(
      f, n, nodes, recs, unshaded, out);
}

}  // namespace romis

extern "C" int romis_final_shade(const float* ctx, const float* res,
                                 long long n, int k, const float* cols,
                                 int n_tris, int unshaded, float* out,
                                 cudaStream_t stream) {
  return romis::launch_shade(ctx, res, n, k, cols, n_tris, unshaded != 0, out,
                             stream);
}

extern "C" int romis_final_shade_bvh(
    const float* pos, const float* nrm, const float* view, const float* kd,
    const float* ks, const float* shin, const bool* valid, const float* lpos,
    const float* lcol, const float* lw, long long n, int k, const float* nodes,
    const float* recs, int unshaded, float* out, cudaStream_t stream) {
  using namespace romis;
  const ShadeFields f{pos, nrm, view, kd, ks, shin, valid, lpos, lcol, lw};
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const float4* rc = reinterpret_cast<const float4*>(recs);
  switch (k) {
    case 1: launch_shade_bvh<1>(f, n, nd, rc, unshaded != 0, out, stream); break;
    case 2: launch_shade_bvh<2>(f, n, nd, rc, unshaded != 0, out, stream); break;
    case 3: launch_shade_bvh<3>(f, n, nd, rc, unshaded != 0, out, stream); break;
    case 4: launch_shade_bvh<4>(f, n, nd, rc, unshaded != 0, out, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
