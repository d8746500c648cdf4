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
// are summed in its order (d-major, then lane; j in order), so with
// --fmad=false the two round alike.
//
// What bounds it on the H100: operations. A pixel evaluates Phong (a powf,
// three square roots, three divisions) D1*K times at the receiver and, for
// the balance heuristic and R-OMIS, D*D1*K times more under the neighbours'
// contexts, and R-OMIS forms D1*K*D1 mock weights (two divisions each).
// Every multiply-add is two instructions under --fmad=false, so the float
// peak this code can reach is half the FMA rate. The earlier design
// evaluated sample-major: for every sample it reloaded each neighbour's
// 14-plane context from device memory, recomputed its unit view, re-read
// the weights w_sum and chosen_w and the neighbour offsets, and its R-OMIS
// instantiation held the accumulators across all of it (229 registers at
// D1 = 6, 255 with spills at most other D1).
//
// This design is technique-major over chunks of the neighbourhood, with a
// per-thread stage in dynamic shared memory (one column a thread: slot i
// of thread t at smem[i * blockDim + t], so a warp's accesses never share
// a bank):
//   1. the members' pixels are found once (32-bit in-plane indices: the
//      wrapper refuses H*W >= 2^31) into the stage, and the occlusion bits
//      are traced (the soup staged through shared memory in chunks, each
//      ray stopping at its first hit) or read from the ext_vis planes;
//   2. balance and R-OMIS, for each chunk of `members` neighbourhood
//      members (kRomisMembers, kBalanceMembers): the chunk's samples
//      (pos3 | color3) into the stage; then for each neighbour j its
//      context is loaded and its unit view computed once a chunk, and
//      (R-OMIS) its K values w_sum - chosen_w, and p-hat_j is evaluated
//      for the chunk's samples, the stage keeping the R-OMIS colvec or the
//      balance p-hat (D * members * K values);
//   3. per sample of the chunk, in the plain version's order: the
//      receiver's shade, then scale, w-hat and the A / b (or contribution)
//      updates from the staged terms. The chunks run in member order, so
//      the sums keep the plain version's order (d-major, then lane).
// A chunk trades shared memory for reloads of the contexts: the stage is
// D1 + members * K * (6 + D) floats a thread, 72 at D = 5, K = 2 and 3
// members (37 KB for a block of 128 threads), where staging the whole
// neighbourhood (138 floats) held an SM to 12 warps; the launcher sets the
// dynamic size (at most 111 KB: D1 = 9, K = 4, with the soup's chunk). Equal
// weights stage only the pixels and read each sample from the pack once.
// A ray whose sample shades to 0 whatever the visibility (invalid
// receiver, light behind the surface) is not traced. With ext_vis (scenes
// with a BVH, pallas_mis.py's ext_vis mode) the mask is read from
// visibility planes traced beforehand by the BVH walk (kernel 20). R-OMIS
// is templated on D1 so that colvec, A and b live in registers. The reads
// of ctx.shininess are per pixel (no scene-wide specialisation). With the
// unshaded flag (Features.enable_shading=False) every shade is the
// receiver's kd and every p-hat the norm of a kd (Receiver::unshaded), so
// every ray with a sample off the receiver is traced.
//
// The band entry (romis_mis_iteration_band, parallel/mis.py): a launch may
// cover a row band of a frame of h_global rows whose first row is
// row_base. The reservoir pack then holds the band inside a halo of
// `res_halo` rows above and below (the neighbours' rows,
// parallel/halo.halo_extend, exchanged once a frame for every iteration);
// every other input (context, offsets, neighbour contexts, alphas,
// ext_vis) and every output the band's rows. The offsets are the frame's,
// pre-clipped to it; a member's row is clamped to [0, h_global) in frame
// rows (an edge band's outer halo is never read) and read at frame row -
// row_base + res_halo. Without a band res_halo = row_base = 0, h_global =
// h.
//
// Registers (ptxas -v, sm_90a, built for one H100): R-OMIS at D1 = 6 128
// (no spills; 112 at D1 = 5, 166 at D1 = 9), progressive R-OMIS capped at
// 128 by its launch bounds (44 B of spills at D1 = 6), balance 77, equal
// 69. PERF.md has the times of every variant measured
// (scripts/torch_sweep_zcount_micro.py, whose own copy of this file,
// scripts/torch_sweep_zcount_micro_mis.cu, builds them).
#include "common.cuh"

namespace romis {

constexpr float kFltMin = 1.17549435e-38f;
constexpr int kRmisEqual = 0, kRmisBalance = 1, kRomis = 2;
constexpr int kMisThreads = 128;
// Neighbourhood members a chunk of the stage: R-OMIS, balance (the
// fastest of 1, 2, 3 and all 6 at D = 5, K = 2: PERF.md).
constexpr int kRomisMembers = 3, kBalanceMembers = 2;

extern __shared__ float mis_smem[];

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
  // The band: the pack's halo rows, the band's first frame row, the
  // frame's rows, and the pack's pixels a plane ((h + 2·res_halo)·w).
  int res_halo, row_base, h_global, n_res;
  float* out0;  // contribution [3, N] or A upper [D1(D1+1)/2, N]
  float* out1;  // b [3 * D1, N]
  float* out2;  // progressive sum [3, N] or null
};

// Plane `c` of a [C, N] array at pixel p.
__device__ __forceinline__ float plane(const float* a, int c, int n, int p) {
  return a[static_cast<size_t>(c) * n + p];
}

// The stage of one thread: slot i at f[i * bs].
struct Stage {
  float* f;
  int bs;
  __device__ __forceinline__ float& operator[](int i) const { return f[i * bs]; }
  __device__ __forceinline__ int pixel(int d) const {
    return __float_as_int(f[d * bs]);
  }
};

__device__ __forceinline__ Receiver load_receiver(const float* cen, int n,
                                                  int p, bool unshaded) {
  Receiver r;
  r.unshaded = unshaded;
  r.px = plane(cen, 0, n, p); r.py = plane(cen, 1, n, p); r.pz = plane(cen, 2, n, p);
  r.nx = plane(cen, 3, n, p); r.ny = plane(cen, 4, n, p); r.nz = plane(cen, 5, n, p);
  r.ox = plane(cen, 6, n, p); r.oy = plane(cen, 7, n, p); r.oz = plane(cen, 8, n, p);
  for (int c = 0; c < 3; ++c) {
    r.kd[c] = plane(cen, 9 + c, n, p);
    r.ks[c] = plane(cen, 12 + c, n, p);
  }
  r.shin = plane(cen, 15, n, p);
  r.valid = plane(cen, 17, n, p) > 0.5f;
  return r;
}

// Neighbour j's context (j >= 1) with the receiver's view origin.
__device__ __forceinline__ Receiver load_neighbour(const MisArgs& a, int n, int p,
                                                   const Receiver& rc, int j) {
  const int b = 14 * (j - 1);
  Receiver r;
  r.unshaded = a.unshaded;
  r.px = plane(a.nbr, b, n, p); r.py = plane(a.nbr, b + 1, n, p);
  r.pz = plane(a.nbr, b + 2, n, p);
  r.nx = plane(a.nbr, b + 3, n, p); r.ny = plane(a.nbr, b + 4, n, p);
  r.nz = plane(a.nbr, b + 5, n, p);
  r.ox = rc.ox; r.oy = rc.oy; r.oz = rc.oz;
  for (int q = 0; q < 3; ++q) {
    r.kd[q] = plane(a.nbr, b + 6 + q, n, p);
    r.ks[q] = plane(a.nbr, b + 9 + q, n, p);
  }
  r.shin = plane(a.nbr, b + 12, n, p);
  r.valid = plane(a.nbr, b + 13, n, p) > 0.5f;
  return r;
}

// core/vec.vnormalize of the view vector (view origin - position).
__device__ __forceinline__ void unit_view(const Receiver& r, float& vx,
                                          float& vy, float& vz) {
  const float ax = r.ox - r.px, ay = r.oy - r.py, az = r.oz - r.pz;
  const float inv = 1.0f / fmaxf(safe_norm3(ax, ay, az), 1e-20f);
  vx = ax * inv; vy = ay * inv; vz = az * inv;
}

// The six stage slots from `slot` on: a staged sample, pos3 | color3.
__device__ __forceinline__ void load_sample(const Stage& st, int slot, float (&sp)[6]) {
  for (int c = 0; c < 6; ++c) sp[c] = st[slot + c];
}

// Sample (d, lane) from the pack at member d's pixel: pos3 | color3.
__device__ __forceinline__ void member_sample(const MisArgs& a, const Stage& st,
                                             int d, int lane, float (&sp)[6]) {
  const int q = st.pixel(d);
  for (int c = 0; c < 3; ++c) {
    sp[c] = plane(a.res, 3 * lane + c, a.n_res, q);
    sp[3 + c] = plane(a.res, 3 * a.k + 3 * lane + c, a.n_res, q);
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

// Phase 1: the receiver and the members' pixels in the pack (the band's
// rows inside its halo) into the stage, then the
// occlusion bits (bit d*K + lane) of every sample whose shade is not 0
// regardless. All threads of the block call it (it synchronises). In the
// ext_vis mode (scenes with a BVH) the bits come from the precomputed
// visibility planes (render/rmis.mis_ext_vis: one walk batch of the D1*K
// rays per pixel, the coincident-pair escape already applied) and no
// triangle is read; the branch is uniform across the grid. `tri` holds
// `chunk` triangles of the soup at a time, column-major.
__device__ unsigned long long stage_and_occlusion(const MisArgs& a, int n, bool in_range,
                                                  int p, Receiver& rc, const Stage& st,
                                                  float* tri, int chunk) {
  const int d1 = a.d1, k = a.k, nr = d1 * k;
  if (in_range) {
    rc = load_receiver(a.cen, n, p, a.unshaded);
    const int y = p / a.w, x = p - y * a.w;
    const int yg = a.row_base + y;  // the pixel's frame row
    for (int d = 0; d < d1; ++d) {
      int q = p + a.res_halo * a.w;
      if (d > 0) {
        const int yy = min(max(yg + a.offs[static_cast<size_t>(d - 1) * n + p], 0),
                           a.h_global - 1) - a.row_base + a.res_halo;
        const int xx = min(max(x + a.offs[static_cast<size_t>(d1 - 1 + d - 1) * n + p], 0),
                           a.w - 1);
        q = yy * a.w + xx;
      }
      st[d] = __int_as_float(q);
    }
  }
  unsigned long long pending = 0ull, occ = 0ull;
  if (a.ext_vis != nullptr) {
    if (in_range)
      for (int b = 0; b < nr; ++b)
        if (plane(a.ext_vis, b, n, p) < 0.5f) occ |= 1ull << b;
    return occ;
  }
  if (in_range && (a.unshaded || rc.valid)) {
    for (int d = 0; d < d1; ++d)
      for (int lane = 0; lane < k; ++lane) {
        float sp[6];
        member_sample(a, st, d, lane, sp);
        const ShadowRay ray = shadow_ray(rc, sp[0], sp[1], sp[2]);
        if ((a.unshaded || light_dot_nl(rc, sp[0], sp[1], sp[2]) >= 0.0f) &&
            ray.dist > kShadowEpsilon)
          pending |= 1ull << (d * k + lane);
      }
  }
  for (int base = 0; base < a.n_tris; base += chunk) {
    // Also the barrier before the chunk buffer is overwritten.
    if (!__syncthreads_or(pending != 0ull)) break;
    const int cnt = min(chunk, a.n_tris - base);
    for (int i = threadIdx.x; i < 10 * cnt; i += blockDim.x) {
      const int c = i / cnt, j = i - c * cnt;
      tri[c * chunk + j] = a.cols[static_cast<size_t>(c) * a.n_tris + base + j];
    }
    __syncthreads();
    for (int s = 0; s < nr && pending != 0ull; ++s) {
      const unsigned long long bit = 1ull << s;
      if (!(pending & bit)) continue;
      float sp[6];
      member_sample(a, st, s / k, s - (s / k) * k, sp);
      const ShadowRay ray = shadow_ray(rc, sp[0], sp[1], sp[2]);
      for (int j = 0; j < cnt; ++j) {
        float t, u, v;
        if (mt_hit(ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, tri + j, chunk,
                   t, u, v) &&
            t < ray.t_max) {
          occ |= bit;
          pending &= ~bit;
          break;
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

// 1/M of lane `lane`: M = #{t < ceil(S/K) : t*K + lane < S}, the lane
// layout of ops/wrs._lane_layout, floored at 1e-37 as the plain version
// floors it.
__device__ __forceinline__ float lane_inv_m(int s, int k, int lane) {
  const int count = s > lane ? (s - lane + k - 1) / k : 0;
  return 1.0f / fmaxf(static_cast<float>(count), 1e-37f);
}

// colvec of a sample under one technique: 1/W' with the grad-safe gates;
// wd = w_sum - chosen_w of the technique's reservoir in the sample's lane.
__device__ __forceinline__ float colvec_of(float pj, float inv_m, float wd, float nl) {
  const bool ok_p = pj > 1e-18f;
  const float inv_p = ok_p ? 1.0f / pj : 0.0f;
  const float w_prime = (inv_p * inv_m) * (wd + pj * nl);
  const bool ok_w = ok_p && fabsf(w_prime) > 1e-37f;
  return ok_w ? 1.0f / w_prime : 0.0f;
}

// The chunk of `gd` members from member d0 into the stage: their samples
// at sb + 6 * (c * K + lane) + component, c = d - d0.
__device__ __forceinline__ void stage_chunk(const MisArgs& a, const Stage& st,
                                            int d0, int gd, int sb) {
  for (int c = 0; c < gd; ++c)
    for (int lane = 0; lane < a.k; ++lane) {
      float sp[6];
      member_sample(a, st, d0 + c, lane, sp);
      for (int q = 0; q < 6; ++q) st[sb + 6 * (c * a.k + lane) + q] = sp[q];
    }
}

template <int kMode>
__global__ void __launch_bounds__(kMisThreads)
rmis_kernel(MisArgs a, int chunk, int members) {
  const int bs = blockDim.x;
  const int n = a.h * a.w;
  const int p = blockIdx.x * bs + threadIdx.x;
  const bool in_range = p < n;
  const Stage st{mis_smem + 10 * chunk + threadIdx.x, bs};
  Receiver rc{};
  const unsigned long long occ =
      stage_and_occlusion(a, n, in_range, p, rc, st, mis_smem, chunk);
  if (!in_range) return;
  const int d1 = a.d1, k = a.k, dn = d1 - 1;
  float vx, vy, vz;
  unit_view(rc, vx, vy, vz);
  const float equal_w = 1.0f / static_cast<float>(d1);
  const float kf = static_cast<float>(k);
  const int g = kMode == kRmisBalance ? members : d1;
  const int sb = d1, tb = d1 + 6 * g * k;  // the chunk's samples, its p-hats
  float acc[3] = {0.f, 0.f, 0.f};
  for (int d0 = 0; d0 < d1; d0 += g) {
    const int gd = min(g, d1 - d0);
    if (kMode == kRmisBalance) {
      // Phase 2, technique-major over the chunk: p-hat_j of its samples
      // under each neighbour's context, the view computed once.
      stage_chunk(a, st, d0, gd, sb);
#pragma unroll 1
      for (int j = 1; j < d1; ++j) {
        const Receiver r = load_neighbour(a, n, p, rc, j);
        float ux, uy, uz;
        unit_view(r, ux, uy, uz);
        for (int sl = 0; sl < gd * k; ++sl) {
          float sp[6];
          load_sample(st, sb + 6 * sl, sp);
          st[tb + sl * dn + j - 1] = target_pdf(r, ux, uy, uz, sp[0], sp[1], sp[2],
                                                sp[3], sp[4], sp[5]);
        }
      }
    }
    // Phase 3, sample-major in the plain version's order.
    for (int c = 0; c < gd; ++c) {
      const int q = st.pixel(d0 + c);
      for (int lane = 0; lane < k; ++lane) {
        const int s = (d0 + c) * k + lane, sl = c * k + lane;
        float sp[6], f[3];
        if (kMode == kRmisBalance)
          load_sample(st, sb + 6 * sl, sp);
        else
          member_sample(a, st, d0 + c, lane, sp);
        const float p_recv = shade_sample(rc, vx, vy, vz, sp, (occ >> s) & 1ull, f);
        float mis_w = equal_w;
        if (kMode == kRmisBalance) {
          float denom = kFltMin + p_recv;
          for (int j = 1; j < d1; ++j) denom = denom + st[tb + sl * dn + j - 1];
          mis_w = p_recv / denom;
        }
        const float wgt = mis_w * plane(a.res, 6 * k + lane, a.n_res, q);
        for (int q3 = 0; q3 < 3; ++q3) acc[q3] = acc[q3] + (wgt * f[q3]) / kf;
      }
    }
  }
  for (int c = 0; c < 3; ++c) a.out0[static_cast<size_t>(c) * n + p] = acc[c];
}

// Blocks an SM that the registers must allow: the progressive R-OMIS
// holds the 3*D1 alphas too, and at 4 blocks (at most 128 registers) runs
// 12 % faster than at its own 156 (PERF.md).
template <int D1, bool kProg>
__global__ void __launch_bounds__(kMisThreads, kProg ? 4 : 1)
romis_kernel(MisArgs a, int chunk, int members) {
  constexpr int kUp = D1 * (D1 + 1) / 2, D = D1 - 1;
  const int bs = blockDim.x;
  const int n = a.h * a.w;
  const int p = blockIdx.x * bs + threadIdx.x;
  const bool in_range = p < n;
  const Stage st{mis_smem + 10 * chunk + threadIdx.x, bs};
  Receiver rc{};
  const unsigned long long occ =
      stage_and_occlusion(a, n, in_range, p, rc, st, mis_smem, chunk);
  if (!in_range) return;
  const int k = a.k;
  const float kf = static_cast<float>(k);
  const float nl = static_cast<float>(a.num_lights);
  const float frac = kf / static_cast<float>(D1);
  const int g = members;
  const int sb = D1, cv = D1 + 6 * g * k;  // the chunk's samples, its colvec

  float vx, vy, vz;
  unit_view(rc, vx, vy, vz);
  float al[3][D1];
  if (kProg) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int j = 0; j < D1; ++j) al[c][j] = plane(a.alphas, c * D1 + j, n, p);
  }
  float a_acc[kUp], b_acc[3][D1], prog[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int u = 0; u < kUp; ++u) a_acc[u] = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < D1; ++j) b_acc[c][j] = 0.0f;

#pragma unroll 1
  for (int d0 = 0; d0 < D1; d0 += g) {
    const int gd = min(g, D1 - d0);
    stage_chunk(a, st, d0, gd, sb);
    // Phase 2, technique-major over the chunk: each neighbour's context,
    // view and weights once, then its colvec for the chunk's samples.
#pragma unroll 1
    for (int j = 1; j < D1; ++j) {
      const Receiver r = load_neighbour(a, n, p, rc, j);
      float ux, uy, uz;
      unit_view(r, ux, uy, uz);
      const int qj = st.pixel(j);
#pragma unroll 1
      for (int lane = 0; lane < k; ++lane) {
        const float wd = plane(a.res, 6 * k + lane, a.n_res, qj) -
                         plane(a.res, 7 * k + lane, a.n_res, qj);
        const float inv_m = lane_inv_m(a.s, k, lane);
#pragma unroll 1
        for (int c = 0; c < gd; ++c) {
          const int sl = c * k + lane;
          float sp[6];
          load_sample(st, sb + 6 * sl, sp);
          const float pj = target_pdf(r, ux, uy, uz, sp[0], sp[1], sp[2], sp[3],
                                      sp[4], sp[5]);
          st[cv + sl * D + j - 1] = colvec_of(pj, inv_m, wd, nl);
        }
      }
    }

    // Phase 3, sample-major in the plain version's order.
#pragma unroll 1
    for (int c = 0; c < gd; ++c) {
#pragma unroll 1
      for (int lane = 0; lane < k; ++lane) {
        const int s = (d0 + c) * k + lane, sl = c * k + lane;
        float sp[6], f[3];
        load_sample(st, sb + 6 * sl, sp);
        const float p_recv = shade_sample(rc, vx, vy, vz, sp, (occ >> s) & 1ull, f);
        float colvec[D1];
        const int q0 = st.pixel(0);  // the receiver in the pack
        colvec[0] = colvec_of(p_recv, lane_inv_m(a.s, k, lane),
                              plane(a.res, 6 * k + lane, a.n_res, q0) -
                                  plane(a.res, 7 * k + lane, a.n_res, q0),
                              nl);
#pragma unroll
        for (int j = 1; j < D1; ++j) colvec[j] = st[cv + sl * D + j - 1];
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
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int j = 0; j < D1; ++j)
            b_acc[q][j] = b_acc[q][j] + (w_hat[j] * scale) * f[q];
        if (kProg) {
          const float sum_frac = kFltMin + frac * s_cv;
          const float inv_sf = sum_frac >= 1e-30f ? 1.0f / sum_frac : 1.0f / kFltMin;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            float sap = al[q][0] * colvec[0];
#pragma unroll
            for (int j = 1; j < D1; ++j) sap = sap + al[q][j] * colvec[j];
            prog[q] = prog[q] + (f[q] - sap) * inv_sf;
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kUp; ++u) a.out0[static_cast<size_t>(u) * n + p] = a_acc[u];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < D1; ++j)
      a.out1[static_cast<size_t>(c * D1 + j) * n + p] = b_acc[c][j];
  if (kProg)
    for (int c = 0; c < 3; ++c) a.out2[static_cast<size_t>(c) * n + p] = prog[c];
}

// Dynamic shared memory of a launch: the soup's chunk and the stage.
inline size_t mis_smem_bytes(int mode, int members, int d1, int k, int chunk) {
  const int slots = mode == kRmisEqual ? d1 : d1 + 6 * members * k + (d1 - 1) * members * k;
  return sizeof(float) * (static_cast<size_t>(10) * chunk + static_cast<size_t>(kMisThreads) * slots);
}

template <typename Kernel>
int launch_mis(Kernel kernel, const MisArgs& a, int chunk, int members, size_t smem,
               cudaStream_t stream) {
  constexpr int bs = kMisThreads;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err != 0) return err;
  const long long n = static_cast<long long>(a.h) * a.w;
  kernel<<<static_cast<int>((n + bs - 1) / bs), bs, smem, stream>>>(a, chunk, members);
  return static_cast<int>(cudaGetLastError());
}

template <int D1>
int launch_romis(const MisArgs& a, int chunk, int members, size_t smem,
                 cudaStream_t stream) {
  if (a.alphas != nullptr)
    return launch_mis(romis_kernel<D1, true>, a, chunk, members, smem, stream);
  return launch_mis(romis_kernel<D1, false>, a, chunk, members, smem, stream);
}

}  // namespace romis

namespace {

int mis_iteration_entry(const float* cen, const float* res, const int* offs,
                        const float* nbr, const float* alphas,
                        const float* ext_vis, const float* cols, int n_tris,
                        int h, int w, int d1, int k, int s, int num_lights,
                        int mode, int unshaded, float* out0, float* out1,
                        float* out2, int res_halo, int row_base, int h_global,
                        cudaStream_t stream) {
  using namespace romis;
  const long long n_res = static_cast<long long>(h + 2 * res_halo) * w;
  // 32-bit in-plane indices; at most 64 occlusion bits; a band inside the
  // frame.
  if (n_res >= (1ll << 31) || d1 * k > 64 || d1 < 2 || d1 > 9 || res_halo < 0 ||
      row_base < 0 || row_base + h > h_global)
    return static_cast<int>(cudaErrorInvalidValue);
  const MisArgs a{cen, res, offs, nbr, alphas, ext_vis, cols, n_tris, h, w, d1,
                  k, s, num_lights, unshaded != 0, res_halo, row_base, h_global,
                  static_cast<int>(n_res), out0, out1, out2};
  const int chunk = ext_vis != nullptr ? 0 : (n_tris < kTriChunk ? n_tris : kTriChunk);
  int members = mode == kRomis ? kRomisMembers : kBalanceMembers;
  members = members < d1 ? members : d1;
  const size_t smem = mis_smem_bytes(mode, members, d1, k, chunk);
  if (mode == kRmisEqual)
    return launch_mis(rmis_kernel<kRmisEqual>, a, chunk, members, smem, stream);
  if (mode == kRmisBalance)
    return launch_mis(rmis_kernel<kRmisBalance>, a, chunk, members, smem, stream);
  switch (d1) {
    case 2: return launch_romis<2>(a, chunk, members, smem, stream);
    case 3: return launch_romis<3>(a, chunk, members, smem, stream);
    case 4: return launch_romis<4>(a, chunk, members, smem, stream);
    case 5: return launch_romis<5>(a, chunk, members, smem, stream);
    case 6: return launch_romis<6>(a, chunk, members, smem, stream);
    case 7: return launch_romis<7>(a, chunk, members, smem, stream);
    case 8: return launch_romis<8>(a, chunk, members, smem, stream);
    case 9: return launch_romis<9>(a, chunk, members, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int romis_mis_iteration(const float* cen, const float* res, const int* offs,
                                   const float* nbr, const float* alphas,
                                   const float* ext_vis, const float* cols,
                                   int n_tris, int h, int w,
                                   int d1, int k, int s, int num_lights, int mode,
                                   int unshaded, float* out0, float* out1,
                                   float* out2, cudaStream_t stream) {
  return mis_iteration_entry(cen, res, offs, nbr, alphas, ext_vis, cols, n_tris,
                             h, w, d1, k, s, num_lights, mode, unshaded, out0,
                             out1, out2, 0, 0, h, stream);
}

// The band entry: romis_mis_iteration's arguments for the band's h rows, the
// pack over its h + 2·res_halo rows, then res_halo, row_base and h_global
// (the frame's rows).
extern "C" int romis_mis_iteration_band(const float* cen, const float* res,
                                        const int* offs, const float* nbr,
                                        const float* alphas,
                                        const float* ext_vis,
                                        const float* cols, int n_tris, int h,
                                        int w, int d1, int k, int s,
                                        int num_lights, int mode, int unshaded,
                                        float* out0, float* out1, float* out2,
                                        int res_halo, int row_base,
                                        int h_global, cudaStream_t stream) {
  return mis_iteration_entry(cen, res, offs, nbr, alphas, ext_vis, cols, n_tris,
                             h, w, d1, k, s, num_lights, mode, unshaded, out0,
                             out1, out2, res_halo, row_base, h_global, stream);
}
