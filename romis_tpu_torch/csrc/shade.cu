// Kernel 4: final shade — shadow ray x Phong x W, averaged over K lanes.
//
// Replaces romis_tpu/ops/pallas_shade.py final_shade_pallas / _shade_kernel
// (with _shade_lane_setup, _shade_phong_accum and _occlusion_k_into). Per
// pixel and lane: a shadow ray from the surface point pushed 1e-3 toward
// the reservoir sample, t_max = the remaining distance (ops/wrs.visibility;
// a coincident light counts as visible), any-hit against the triangle soup
// with an early exit per ray, then unshadowed Phong (ops/shading.phong_shade,
// falloff clamped at 1e-5) x visibility x W, summed over the lanes and
// divided by K. Dead rays — a missed pixel, a light behind the surface, or
// W = 0 — contribute nothing whatever the visibility, so they skip the
// trace. Output: the pre-tone-map color [3, H, W].
//
// One thread per (pixel, lane), a pixel's K lanes in adjacent threads of
// one warp (32 / K pixels a warp), as kernel 21: each thread sets up its
// lane's shadow ray and computes its lane's Phong term only where the lane
// is lit; the pixel's first thread gathers the K terms by shuffles and sums
// them in lane order from 0, ((0 + t0) + t1) + ..., then divides by K, the
// arithmetic of the earlier one-thread-a-pixel design bit for bit. It reads
// the context's and the reservoirs' own planes (ShadeFields), no packed
// copies. The soup is culled as kernel 7 culls it (cull.cuh): the
// wrapper's blocks (ops/trace.zcount_blocks, built once a soup) are staged
// with their grown boxes and guard data into shared memory once a
// persistent thread block; a pending ray walks them with soup_any, the
// walk kernel 6 shares: a block's box over [0, t_max] before the block's
// triangles, the near-parallel guard keeping a block the box rejects where
// mt_tri's rounding could still accept one of its triangles (deferred to a
// second pass for a soup's flagged blocks), and the ray stops at its first
// hit. The triangle test is mt_tri, the plain version's
// (ops/intersect._mt), so the bool is any_hit_plain's on every ray
// (ops/trace.any_hit_culled is the plain model of this walk). A
// soup of at most one block (the flagship's 2 triangles), or none (every
// lane visible), has nothing to cull: it is staged as given, without the
// blocks, so the wrapper builds none, and its rays test its triangles
// directly. The wrapper may ask for each lane's occlusion byte as well (a
// check). Bound: the bytes this
// run's data needs (valid, W and out everywhere; position, normal and
// sample position for the live lanes; colour and material for the lit
// ones), or, on a culled soup, the walk's box, guard and triangle tests.
//
// Kernel 21, the BVH mode (romis_final_shade_bvh), replaces
// romis_tpu/ops/pallas_shade.py final_shade_paged_pallas /
// _shade_paged_kernel, for scenes of any size, with the same thread
// mapping and Phong: each thread walks the tree alone for its lane's live
// shadow ray (walk.cuh walk_any, kernel 20's walk, leaf triangles read as
// 48-byte records, ops/walk.tri_records). Its plain version is the same
// final_shade_plain, whose visibility then walks the tree
// (ops/traverse.bvh_any). Bound: the box and triangle tests of the walk.
// The TPU kernel shares one walk between a pixel's K rays to amortise its
// page DMAs; on this card that union walk visits every node any of the K
// rays needs and tests the K slabs of a node one after another (PERF.md,
// kernel 20), so each ray walks alone here.
//
// Both modes take the unshaded flag (Features.enable_shading=False): the
// shade of every lane is then kd, whatever the light's side and the
// receiver's validity (ops/shading.phong_shade), so every lane with W != 0
// traces its shadow ray.
#include <algorithm>

#include "cull.cuh"
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

// The kernels' inputs: the receivers' and the reservoirs' own planes (no
// packed copies), each [..., H, W] contiguous, n = H * W floats a plane.
struct ShadeFields {
  const float *pos, *nrm, *view, *kd, *ks, *shin;  // [3] x4, [3], [1]
  const bool* valid;                               // [H, W]
  const float *lpos, *lcol, *lw;                   // [K, 3], [K, 3], [K]
};

// One lane's receiver and sample, from the fields.
struct LaneIn {
  float px, py, pz, nx, ny, nz, lx, ly, lz, big_w;
  bool valid;
};

__device__ __forceinline__ LaneIn load_lane(const ShadeFields& f, long long n,
                                            long long p, int lane) {
  const float* lp = f.lpos + 3 * lane * n;
  return LaneIn{f.pos[p], f.pos[n + p], f.pos[2 * n + p],
                f.nrm[p], f.nrm[n + p], f.nrm[2 * n + p],
                lp[p], lp[n + p], lp[2 * n + p], f.lw[lane * n + p], f.valid[p]};
}

__device__ __forceinline__ ShadowRay lane_ray(const LaneIn& a, bool unshaded) {
  return shadow_ray(a.px, a.py, a.pz, a.nx, a.ny, a.nz, a.valid, unshaded, a.lx,
                    a.ly, a.lz, a.big_w);
}

// The lane's term, (lit ? Phong : 0) x W. Only a lit lane (its Phong gate
// passed and its ray not occluded) loads its colour and material and
// computes its Phong term; the others add 0 x W.
__device__ __forceinline__ void lane_shade(const ShadeFields& f, long long n,
                                           long long p, int lane, const LaneIn& a,
                                           bool gate, bool occluded, bool unshaded,
                                           float (&term)[3]) {
  if (gate && !occluded) {
    const float* lc = f.lcol + 3 * lane * n;
    const float col[3] = {lc[p], lc[n + p], lc[2 * n + p]};
    const Material m = load_material(f.view, f.kd, f.ks, f.shin, n, p, a.px,
                                     a.py, a.pz);
    lane_term(a.px, a.py, a.pz, a.nx, a.ny, a.nz, m.vx, m.vy, m.vz, m.kd, m.ks,
              m.shin, a.valid, unshaded, a.lx, a.ly, a.lz, col, a.big_w,
              occluded, term);
  } else {
    for (int c = 0; c < 3; ++c) term[c] = 0.0f * a.big_w;
  }
}

// The lane-order sum, ((0 + t0) + t1) + ..., at the pixel's first thread
// (thread slot * K of the warp), divided by K. Every lane of the warp
// calls it.
template <int K>
__device__ __forceinline__ void write_pixel(const float (&term)[3], int slot,
                                            int lane, bool in_range, long long n,
                                            long long p, float* __restrict__ out) {
  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < K; ++j)
    for (int c = 0; c < 3; ++c)
      acc[c] = acc[c] + __shfl_sync(kFull, term[c], slot * K + j);
  if (!in_range || lane != 0) return;
  const float kf = static_cast<float>(K);
  for (int c = 0; c < 3; ++c) out[c * n + p] = acc[c] / kf;
}

// Kernel 4: persistent blocks, each staging the culled soup once, whose
// warps take 32 / K pixels at a time (thread slot * K + lane of a warp
// shades lane `lane` of the pixel `slot`); occ, where given, gets each
// lane's occlusion byte [K, N]. A culled soup runs blocks of 1024 threads
// (its staged soup may leave room for one block an SM), and reads its
// lane's inputs again after the walk rather than hold them through it
// (registers: 64 a thread).
template <bool kMany>
constexpr int shade_threads() { return kMany ? 1024 : 256; }

extern __shared__ float shade_smem[];

template <int K, bool kMany>
__global__ void __launch_bounds__(shade_threads<kMany>())
final_shade_kernel(const ShadeFields f, long long n, const float* __restrict__ cols,
                   const float* __restrict__ boxes, const float* __restrict__ normals,
                   int n_tris, bool unshaded, float* __restrict__ out,
                   unsigned char* __restrict__ occ) {
  const CullSoup s = kMany ? stage_cull(shade_smem, cols, boxes, normals, n_tris)
                           : stage_direct(shade_smem, cols, n_tris);
  __syncthreads();
  const int end = kMany ? 0 : active_end(s);
  constexpr int kPerWarp = 32 / K;
  const int wl = threadIdx.x & 31;
  const int slot = wl / K, lane = wl - slot * K;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const long long chunks = (n + kPerWarp - 1) / kPerWarp;
  for (long long c = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       c < chunks; c += warps) {  // uniform over the warp
    const long long p = c * kPerWarp + slot;
    const bool in_range = slot < kPerWarp && p < n;
    LaneIn a{};
    ShadowRay r{};
    if (in_range) {
      a = load_lane(f, n, p, lane);
      r = lane_ray(a, unshaded);
    }
    const bool occluded =
        soup_any<kMany>(s, MtTris{s.tri, s.n_tris}, MtGuard<true>{s}, end, in_range && r.pending,
                        SegRay{r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tm});
    float term[3] = {0.f, 0.f, 0.f};
    if (in_range) {
      if (kMany) a = load_lane(f, n, p, lane);
      lane_shade(f, n, p, lane, a, r.gate, occluded, unshaded, term);
      if (occ != nullptr) occ[lane * n + p] = occluded;
    }
    write_pixel<K>(term, slot, lane, in_range, n, p, out);
  }
}

// Kernel 21: thread slot * K + lane of a warp shades lane `lane` of the
// warp's pixel `slot`; the pixel's first thread writes its colour.
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
    const LaneIn a = load_lane(f, n, p, lane);
    const ShadowRay r = lane_ray(a, unshaded);
    const bool occluded =
        r.pending && walk_any(nodes, RecTris{recs}, r.ox, r.oy, r.oz, r.dx,
                              r.dy, r.dz, r.tm);
    lane_shade(f, n, p, lane, a, r.gate, occluded, unshaded, term);
  }
  write_pixel<K>(term, slot, lane, in_range, n, p, out);
}

namespace {
PersistentGrid shade_grids[5][2];  // [K][kMany]
}  // namespace

template <int K, bool kMany>
int launch_shade(const ShadeFields& f, long long n, const float* cols,
                 const float* boxes, const float* normals, int n_tris,
                 bool unshaded, float* out, unsigned char* occ,
                 cudaStream_t stream) {
  PersistentGrid& grids = shade_grids[K][kMany];
  const size_t smem = kMany ? cull_smem_bytes(n_tris)
                            : sizeof(float) * 10 * static_cast<size_t>(n_tris);
  auto kernel = final_shade_kernel<K, kMany>;
  constexpr int kThr = shade_threads<kMany>();
  int blocks = 0;
  const int err = persistent_blocks(grids, kernel, kThr, smem, blocks);
  if (err != 0) return err;
  constexpr int kPerBlock = kThr / 32 * (32 / K);
  const long long need = (n + kPerBlock - 1) / kPerBlock;
  const int grid = static_cast<int>(std::min<long long>(need, blocks));
  kernel<<<grid, kThr, smem, stream>>>(f, n, cols, boxes, normals, n_tris,
                                       unshaded, out, occ);
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

// A culled soup: cols [10, T] block-ordered, T a multiple of kZBlock
// above it (at most 2048), boxes [13, T / kZBlock], normals [5, T]
// (ops/trace.zcount_blocks). A soup of at most kZBlock triangles: its
// cols [10, T] as given (T may be 0), boxes and normals null. occ [K, N]
// bytes or null.
extern "C" int romis_final_shade(
    const float* pos, const float* nrm, const float* view, const float* kd,
    const float* ks, const float* shin, const bool* valid, const float* lpos,
    const float* lcol, const float* lw, long long n, int k, const float* cols,
    const float* boxes, const float* normals, int n_tris, int unshaded,
    float* out, unsigned char* occ, cudaStream_t stream) {
  using namespace romis;
  const bool many = boxes != nullptr, u = unshaded != 0;
  if (many ? (normals == nullptr || n_tris <= kZBlock || n_tris % kZBlock != 0 ||
              n_tris > 2048)
           : (normals != nullptr || n_tris < 0 || n_tris > kZBlock))
    return static_cast<int>(cudaErrorInvalidValue);
  const ShadeFields f{pos, nrm, view, kd, ks, shin, valid, lpos, lcol, lw};
#define ROMIS_SHADE(K)                                                              \
  (many ? launch_shade<K, true>(f, n, cols, boxes, normals, n_tris, u, out, occ,   \
                                stream)                                             \
        : launch_shade<K, false>(f, n, cols, boxes, normals, n_tris, u, out, occ,  \
                                 stream))
  switch (k) {
    case 1: return ROMIS_SHADE(1);
    case 2: return ROMIS_SHADE(2);
    case 3: return ROMIS_SHADE(3);
    case 4: return ROMIS_SHADE(4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ROMIS_SHADE
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
