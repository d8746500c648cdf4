// Kernel 17: one R-MIS / R-OMIS iteration over the fixed neighbourhoods.
//
// Replaces romis_tpu/ops/pallas_mis.py mis_iteration_pallas / _mis_kernel.
// Per pixel: the D1 = D + 1 neighbourhood reservoirs (self, then the
// neighbours at the per-pixel offsets), K samples each, shaded at the
// receiver behind a shadow ray, then
//   R-MIS: contribution += w * W * f / K, w = 1/D1 (rmis_equal) or the
//          balance heuristic p_recv / (FLT_MIN + sum_j p-hat_j) under every
//          neighbourhood pixel's own context (rmis_balance);
//   R-OMIS: colvec_j = 1/W'_j under the D1 techniques, scale, w-hat, the
//          upper triangle of A and b (and the progressive sum).
// The arithmetic follows ops/mis.mis_iteration_plain operation for
// operation (its grad-safe double-where gates included), and the samples
// are summed in its order (d-major, then lane), so with --fmad=false the
// two round alike.
//
// The TPU kernel DMAs a halo window of the reservoir pack per tile and
// resolves every neighbour through a dense select chain over the row
// offsets. Here one thread per pixel reads the neighbour reservoirs at its
// offsets straight from the pack (in-image by construction, clamped all
// the same), served mostly by L1/L2 within the ±radius window; the
// neighbours' contexts come pre-gathered (14 planes each) and are re-read
// per technique instead of held in registers. The D1*K shadow rays share
// the receiver as origin (ops/wrs.visibility: pushed 1e-3 toward the
// sample, t_max the remaining distance, a coincident pair visible); the
// soup is staged through shared memory in 512-triangle chunks, each live
// ray stops at its first hit, and only a 64-bit occlusion mask stays in
// registers: the rays are rebuilt from the pack for each chunk. A ray whose
// sample shades to 0 whatever the visibility (invalid receiver, light
// behind the surface) is not traced. With ext_vis (scenes with a BVH,
// pallas_mis.py's ext_vis mode) the mask is read from visibility planes
// traced beforehand by the BVH walk (kernel 20). R-OMIS is templated on D1 so that
// colvec, A and b live in registers; the R-MIS modes loop over j at run
// time. The reads of ctx.shininess are per pixel (no scene-wide
// specialisation). With the unshaded flag (Features.enable_shading=False)
// every shade is the receiver's kd and every p-hat the norm of a kd
// (Receiver::unshaded), so every ray with a sample off the receiver is
// traced.
//
// Bound: compute, D1*K Phong evaluations at the receiver and, for balance
// and R-OMIS, D*D1*K more under the neighbours' contexts (one powf each),
// plus ~30 flops per live ray-triangle test; device memory sees
// 18 + C_res + 2D (+ 14D, + 3*D1) planes in and 3 (or the A, b and
// progressive planes) out.
#include "common.cuh"

namespace romis {

constexpr float kFltMin = 1.17549435e-38f;
constexpr int kRmisEqual = 0, kRmisBalance = 1, kRomis = 2;

struct MisArgs {
  const float* cen;     // [18, N] ops/shade.pack_center_ctx
  const float* res;     // [C_res, N] one iteration block of the pack
  const int* offs;      // [2D, N] dy block, then dx block
  const float* nbr;     // [14D, N] resolve_neighbour_ctx, or null
  const float* alphas;  // [3 * D1, N] or null
  const float* ext_vis;  // [D1 * K, N] visibility planes (1 = visible) or null
  const float* cols;    // [10, T] triangle columns (null with ext_vis)
  int n_tris, h, w, d1, k, s, num_lights;
  bool unshaded;
  float* out0;  // contribution [3, N] or A upper [D1(D1+1)/2, N]
  float* out1;  // b [3 * D1, N]
  float* out2;  // progressive sum [3, N] or null
};

// Pixel of neighbourhood member d (0 = self).
__device__ __forceinline__ long long member_pixel(const MisArgs& a, long long n,
                                                  long long p, int y, int x, int d) {
  if (d == 0) return p;
  const int dd = d - 1, dn = a.d1 - 1;
  const int yy = min(max(y + a.offs[dd * n + p], 0), a.h - 1);
  const int xx = min(max(x + a.offs[(dn + dd) * n + p], 0), a.w - 1);
  return static_cast<long long>(yy) * a.w + xx;
}

__device__ __forceinline__ Receiver load_receiver(const float* cen, long long n,
                                                  long long p, bool unshaded) {
  Receiver r;
  r.unshaded = unshaded;
  r.px = cen[p]; r.py = cen[n + p]; r.pz = cen[2 * n + p];
  r.nx = cen[3 * n + p]; r.ny = cen[4 * n + p]; r.nz = cen[5 * n + p];
  r.ox = cen[6 * n + p]; r.oy = cen[7 * n + p]; r.oz = cen[8 * n + p];
  for (int c = 0; c < 3; ++c) {
    r.kd[c] = cen[(9 + c) * n + p];
    r.ks[c] = cen[(12 + c) * n + p];
  }
  r.shin = cen[15 * n + p];
  r.valid = cen[17 * n + p] > 0.5f;
  return r;
}

// Neighbour j's context (j >= 1) with the receiver's view origin.
__device__ __forceinline__ Receiver load_neighbour(const MisArgs& a, long long n,
                                                   long long p, const Receiver& rc,
                                                   int j) {
  const float* c = a.nbr + static_cast<long long>(14 * (j - 1)) * n + p;
  Receiver r;
  r.unshaded = a.unshaded;
  r.px = c[0]; r.py = c[n]; r.pz = c[2 * n];
  r.nx = c[3 * n]; r.ny = c[4 * n]; r.nz = c[5 * n];
  r.ox = rc.ox; r.oy = rc.oy; r.oz = rc.oz;
  for (int q = 0; q < 3; ++q) {
    r.kd[q] = c[(6 + q) * n];
    r.ks[q] = c[(9 + q) * n];
  }
  r.shin = c[12 * n];
  r.valid = c[13 * n] > 0.5f;
  return r;
}

// core/vec.vnormalize of the view vector (view origin - position).
__device__ __forceinline__ void unit_view(const Receiver& r, float& vx,
                                          float& vy, float& vz) {
  const float ax = r.ox - r.px, ay = r.oy - r.py, az = r.oz - r.pz;
  const float inv = 1.0f / fmaxf(safe_norm3(ax, ay, az), 1e-20f);
  vx = ax * inv; vy = ay * inv; vz = az * inv;
}

// p-hat of a sample under neighbour j's context.
__device__ __forceinline__ float phat_j(const MisArgs& a, long long n, long long p,
                                        const Receiver& rc, int j, const float (&sp)[6]) {
  const Receiver r = load_neighbour(a, n, p, rc, j);
  float vx, vy, vz;
  unit_view(r, vx, vy, vz);
  return target_pdf(r, vx, vy, vz, sp[0], sp[1], sp[2], sp[3], sp[4], sp[5]);
}

// Sample (d, lane): pos3 | color3 from the pack at member d's pixel.
__device__ __forceinline__ void load_sample(const MisArgs& a, long long n, long long q,
                                            int lane, float (&sp)[6]) {
  for (int c = 0; c < 3; ++c) {
    sp[c] = a.res[(3 * lane + c) * n + q];
    sp[3 + c] = a.res[(3 * a.k + 3 * lane + c) * n + q];
  }
}

// The shadow ray of ops/wrs.visibility from the receiver to (lx, ly, lz).
struct ShadowRay {
  float ox, oy, oz, dx, dy, dz, t_max, dist;
};

__device__ __forceinline__ ShadowRay shadow_ray(const Receiver& r, float lx,
                                                float ly, float lz) {
  const float tox = lx - r.px, toy = ly - r.py, toz = lz - r.pz;
  ShadowRay s;
  s.dist = safe_norm3(tox, toy, toz);
  const float dmax = fmaxf(s.dist, 1e-20f);
  s.dx = tox / dmax; s.dy = toy / dmax; s.dz = toz / dmax;
  s.ox = r.px + kShadowEpsilon * s.dx;
  s.oy = r.py + kShadowEpsilon * s.dy;
  s.oz = r.pz + kShadowEpsilon * s.dz;
  s.t_max = safe_norm3(lx - s.ox, ly - s.oy, lz - s.oz);
  return s;
}

// Occlusion bits (bit d*K + lane) of every sample whose shade is not 0
// regardless; all threads of the block call it (it synchronises). In the
// ext_vis mode (scenes with a BVH) the bits come from the precomputed
// visibility planes (render/rmis.mis_ext_vis: one walk batch of the D1*K
// rays per pixel, the coincident-pair escape already applied) and no
// triangle is read; the branch is uniform across the grid.
__device__ unsigned long long occlusion_mask(const MisArgs& a, long long n,
                                             bool in_range, long long p, int y,
                                             int x, const Receiver& rc,
                                             float (*s)[kTriChunk]) {
  unsigned long long pending = 0ull, occ = 0ull;
  if (a.ext_vis != nullptr) {
    if (in_range)
      for (int b = 0; b < a.d1 * a.k; ++b)
        if (a.ext_vis[b * n + p] < 0.5f) occ |= 1ull << b;
    return occ;
  }
  if (in_range && (a.unshaded || rc.valid)) {
    for (int d = 0; d < a.d1; ++d) {
      const long long q = member_pixel(a, n, p, y, x, d);
      for (int lane = 0; lane < a.k; ++lane) {
        const float lx = a.res[(3 * lane) * n + q], ly = a.res[(3 * lane + 1) * n + q],
                    lz = a.res[(3 * lane + 2) * n + q];
        const ShadowRay ray = shadow_ray(rc, lx, ly, lz);
        if ((a.unshaded || light_dot_nl(rc, lx, ly, lz) >= 0.0f) &&
            ray.dist > kShadowEpsilon)
          pending |= 1ull << (d * a.k + lane);
      }
    }
  }
  for (int base = 0; base < a.n_tris; base += kTriChunk) {
    // Also the barrier before the chunk buffer is overwritten.
    if (!__syncthreads_or(pending != 0ull)) break;
    const int cnt = min(kTriChunk, a.n_tris - base);
    stage_tris(s, a.cols, a.n_tris, base, cnt);
    __syncthreads();
    for (int d = 0; d < a.d1 && pending != 0ull; ++d) {
      const long long q = member_pixel(a, n, p, y, x, d);
      for (int lane = 0; lane < a.k; ++lane) {
        const unsigned long long bit = 1ull << (d * a.k + lane);
        if (!(pending & bit)) continue;
        const ShadowRay ray = shadow_ray(rc, a.res[(3 * lane) * n + q],
                                         a.res[(3 * lane + 1) * n + q],
                                         a.res[(3 * lane + 2) * n + q]);
        for (int j = 0; j < cnt; ++j) {
          float t, u, v;
          if (mt_hit(ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, &s[0][j],
                     kTriChunk, t, u, v) &&
              t < ray.t_max) {
            occ |= bit;
            pending &= ~bit;
            break;
          }
        }
      }
    }
  }
  return occ;
}

// Shade of sample sp at the receiver, 0 where occluded → f[3], and the
// receiver's p-hat (the norm of the unshadowed shade).
__device__ __forceinline__ float shade_sample(const Receiver& rc, float vx, float vy,
                                              float vz, const float (&sp)[6],
                                              bool occluded, float (&f)[3]) {
  float o[3];
  phong_rgb(rc, vx, vy, vz, sp[0], sp[1], sp[2], sp[3], sp[4], sp[5], o);
  const float sq = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
  for (int c = 0; c < 3; ++c) f[c] = occluded ? 0.0f : o[c];
  return sq > 1e-30f ? sqrtf(sq) : 0.0f;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
rmis_kernel(MisArgs a) {
  __shared__ float s[10][kTriChunk];
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in_range = p < n;
  const int y = in_range ? static_cast<int>(p / a.w) : 0;
  const int x = in_range ? static_cast<int>(p - static_cast<long long>(y) * a.w) : 0;
  Receiver rc{};
  if (in_range) rc = load_receiver(a.cen, n, p, a.unshaded);
  const unsigned long long occ = occlusion_mask(a, n, in_range, p, y, x, rc, s);
  if (!in_range) return;
  float vx, vy, vz;
  unit_view(rc, vx, vy, vz);
  const float equal_w = 1.0f / static_cast<float>(a.d1);
  const float kf = static_cast<float>(a.k);
  float acc[3] = {0.f, 0.f, 0.f};
  for (int d = 0; d < a.d1; ++d) {
    const long long q = member_pixel(a, n, p, y, x, d);
    for (int lane = 0; lane < a.k; ++lane) {
      float sp[6], f[3];
      load_sample(a, n, q, lane, sp);
      const float p_recv = shade_sample(rc, vx, vy, vz, sp,
                                        (occ >> (d * a.k + lane)) & 1ull, f);
      float mis_w = equal_w;
      if (kMode == kRmisBalance) {
        float denom = kFltMin + p_recv;
        for (int j = 1; j < a.d1; ++j) denom = denom + phat_j(a, n, p, rc, j, sp);
        mis_w = p_recv / denom;
      }
      const float wgt = mis_w * a.res[(6 * a.k + lane) * n + q];
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + (wgt * f[c]) / kf;
    }
  }
  for (int c = 0; c < 3; ++c) a.out0[c * n + p] = acc[c];
}

template <int D1, bool kProg>
__global__ void __launch_bounds__(kThreads)
romis_kernel(MisArgs a) {
  __shared__ float s[10][kTriChunk];
  constexpr int kUp = D1 * (D1 + 1) / 2;
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in_range = p < n;
  const int y = in_range ? static_cast<int>(p / a.w) : 0;
  const int x = in_range ? static_cast<int>(p - static_cast<long long>(y) * a.w) : 0;
  Receiver rc{};
  if (in_range) rc = load_receiver(a.cen, n, p, a.unshaded);
  const unsigned long long occ = occlusion_mask(a, n, in_range, p, y, x, rc, s);
  if (!in_range) return;
  float vx, vy, vz;
  unit_view(rc, vx, vy, vz);
  const float kf = static_cast<float>(a.k);
  const float nl = static_cast<float>(a.num_lights);
  const float frac = kf / static_cast<float>(D1);
  const int sk = (a.s + a.k - 1) / a.k;
  long long qj[D1];
#pragma unroll
  for (int j = 0; j < D1; ++j) qj[j] = member_pixel(a, n, p, y, x, j);
  float a_acc[kUp], b_acc[3][D1], prog[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int u = 0; u < kUp; ++u) a_acc[u] = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < D1; ++j) b_acc[c][j] = 0.0f;

#pragma unroll 1
  for (int d = 0; d < D1; ++d) {
#pragma unroll 1
    for (int lane = 0; lane < a.k; ++lane) {
      float sp[6], f[3];
      load_sample(a, n, member_pixel(a, n, p, y, x, d), lane, sp);
      const float p_recv = shade_sample(rc, vx, vy, vz, sp,
                                        (occ >> (d * a.k + lane)) & 1ull, f);
      int count = 0;
      for (int t = 0; t < sk; ++t) count += t * a.k + lane < a.s;
      const float inv_m = 1.0f / fmaxf(static_cast<float>(count), 1e-37f);
      float colvec[D1];
#pragma unroll
      for (int j = 0; j < D1; ++j) {
        const float pj = j == 0 ? p_recv : phat_j(a, n, p, rc, j, sp);
        const bool ok_p = pj > 1e-18f;
        const float inv_p = ok_p ? 1.0f / pj : 0.0f;
        const float w_sum = a.res[(6 * a.k + lane) * n + qj[j]];
        const float chosen = a.res[(7 * a.k + lane) * n + qj[j]];
        const float w_prime = (inv_p * inv_m) * ((w_sum - chosen) + pj * nl);
        const bool ok_w = ok_p && fabsf(w_prime) > 1e-37f;
        colvec[j] = ok_w ? 1.0f / w_prime : 0.0f;
      }
      float s_cv = colvec[0];
#pragma unroll
      for (int j = 1; j < D1; ++j) s_cv = s_cv + colvec[j];
      const float scale = s_cv >= 1e-30f ? 1.0f / (kFltMin + kf * s_cv) : 1.0f / kFltMin;
      float w_hat[D1];
#pragma unroll
      for (int j = 0; j < D1; ++j) w_hat[j] = colvec[j] * scale;
      int u = 0;
#pragma unroll
      for (int i = 0; i < D1; ++i)
#pragma unroll
        for (int j = i; j < D1; ++j) {
          a_acc[u] = a_acc[u] + w_hat[i] * w_hat[j];
          ++u;
        }
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int j = 0; j < D1; ++j)
          b_acc[c][j] = b_acc[c][j] + (w_hat[j] * scale) * f[c];
      if (kProg) {
        const float sum_frac = kFltMin + frac * s_cv;
        const float inv_sf = sum_frac >= 1e-30f ? 1.0f / sum_frac : 1.0f / kFltMin;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float sap = a.alphas[(c * D1) * n + p] * colvec[0];
#pragma unroll
          for (int j = 1; j < D1; ++j)
            sap = sap + a.alphas[(c * D1 + j) * n + p] * colvec[j];
          prog[c] = prog[c] + (f[c] - sap) * inv_sf;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kUp; ++u) a.out0[u * n + p] = a_acc[u];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < D1; ++j) a.out1[(c * D1 + j) * n + p] = b_acc[c][j];
  if (kProg)
    for (int c = 0; c < 3; ++c) a.out2[c * n + p] = prog[c];
}

template <int D1>
int launch_romis(const MisArgs& a, cudaStream_t stream) {
  const long long n = static_cast<long long>(a.h) * a.w;
  if (a.alphas != nullptr)
    romis_kernel<D1, true><<<blocks_for(n), kThreads, 0, stream>>>(a);
  else
    romis_kernel<D1, false><<<blocks_for(n), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace romis

extern "C" int romis_mis_iteration(const float* cen, const float* res, const int* offs,
                                   const float* nbr, const float* alphas,
                                   const float* ext_vis, const float* cols,
                                   int n_tris, int h, int w,
                                   int d1, int k, int s, int num_lights, int mode,
                                   int unshaded, float* out0, float* out1,
                                   float* out2, cudaStream_t stream) {
  using namespace romis;
  const MisArgs a{cen, res, offs, nbr, alphas, ext_vis, cols, n_tris, h, w, d1,
                  k, s, num_lights, unshaded != 0, out0, out1, out2};
  const long long n = static_cast<long long>(h) * w;
  if (d1 * k > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kRmisEqual) {
    rmis_kernel<kRmisEqual><<<blocks_for(n), kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode == kRmisBalance) {
    rmis_kernel<kRmisBalance><<<blocks_for(n), kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  switch (d1) {
    case 2: return launch_romis<2>(a, stream);
    case 3: return launch_romis<3>(a, stream);
    case 4: return launch_romis<4>(a, stream);
    case 5: return launch_romis<5>(a, stream);
    case 6: return launch_romis<6>(a, stream);
    case 7: return launch_romis<7>(a, stream);
    case 8: return launch_romis<8>(a, stream);
    case 9: return launch_romis<9>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
