// Kernels 5 and 11: one spatial-reuse pass, biased (ReSTIR Alg. 5) or
// unbiased (Alg. 6).
//
// Replaces romis_tpu/ops/pallas_spatial.py spatial_pass_pallas /
// _pass_kernel (biased) and spatial_pass_unbiased_pallas /
// _pass_unbiased_kernel (unbiased, without the visibility check). The
// contract is the JAX XLA path (render/restir.spatial_reuse, per-pixel
// branch, then ops/wrs.combine_biased or combine_unbiased): per pixel,
// R offsets drawn uniformly in [-radius, radius] per pixel and per axis,
// each clamped to the screen; streams in the order [neighbours..., self];
// stream weight p-hat(receiver)·W·M; a Gumbel-max race per lane in which
// the first maximum wins (strict >, stream 0 holds the selection when no
// weight is positive, as argmax does); W = wSum / (p-hat(winner)·M).
// - Biased: a neighbour takes part only if its depth is within 10 % and
//   its normal within 25° of the receiver's and both are valid.
// - Unbiased: no gates; a second sweep re-reads each neighbour's context at
//   its stored offset (kept in registers) and Z counts the pre-pass m of
//   each input whose own p-hat of the winner is positive, self included;
//   W = wSum / (p-hat(winner)·Z).
// The TPU kernel shares dy along each row of a 128-wide tile (its row
// resolve is a one-hot matmul); here both offsets are per pixel.
//
// The unbiased kernel's vis_check mode (pallas_spatial.py's vis_check,
// Features.spatial_reuse_visibility_check) also writes what the caller
// needs to take the occluded inputs out of Z, in a [2K + 3R + RK, N] block:
// Z before visibility (K), p-hat of the winner at the receiver (K), each
// neighbour's resolved surface position (3R) and each (neighbour, lane)'s
// m·[p-hat_n(winner) > 0] (RK). The positions come from here because the
// offsets are drawn here. The caller traces the (R+1)·K rays (kernel 7 on a
// soup, the BVH walk otherwise) and re-derives W (ops/spatial.py).
//
// Both passes take the unshaded flag (Features.enable_shading=False): every
// target p-hat is then the norm of the evaluating context's kd
// (Receiver::unshaded, phong_rgb).
//
// Random numbers: the injected offsets [2, R, N] and Gumbel noise
// [R+1, K, N] (the plain version's own draws, so the two agree exactly), or
// Philox4x32-10 keyed by a 64-bit key read from device memory, counter
// (2·stream + hi, pixel, tag): tag = 0x5350 | unbiased in the high half and
// the pass index in the low half, disjoint from RIS's counters (tag 0).
//
// One thread per pixel on 32 x 8 blocks, so a block's neighbours fall in a
// (8 + 2r) x (32 + 2r) window that L1 and L2 serve. K is a template
// parameter so each lane's race state stays in registers. Bound: compute
// (R+1)·K target-PDF evaluations, one powf each, per pixel (2 R·K more for
// the unbiased Z sweep); device memory sees 18 + 10K planes in for the
// receiver and itself, 10K planes out, and the neighbour reads, which
// mostly hit the caches.
#include "common.cuh"

namespace romis {

constexpr float kDepthFrac = 0.1f;            // render/restir.SPATIAL_DEPTH_FRAC
constexpr float kNormalCos = 0.90630778703f;  // render/restir.SPATIAL_NORMAL_COS
constexpr int kMaxNbr = 8;                    // unbiased: offsets held in registers
constexpr int kBlockX = 32, kBlockY = 8;

struct PassArgs {
  const float* res;    // [10K, N] reservoir planes (pack_reservoir_planes order)
  const float* gates;  // [5, N] normal3 | depth | valid (biased only)
  const float* cen;    // [18, N] pack_center_ctx
  int h, w, n_nbr, radius;
  const long long* key;  // [1] Philox key, or null with injected noise
  uint32_t tag;
  const int* offs;      // [2, R, N] or null
  const float* gumbel;  // [R+1, K, N] or null
  bool unshaded;
  float* out;           // [10K, N]
  float* vis;           // vis_check: [2K + 3R + RK, N], or null
};

struct Lane {
  float w_sum, m, best, sel[6], sel_w, sel_ph;
};

__device__ __forceinline__ Receiver load_receiver(const float* __restrict__ cen,
                                                  long long n, long long p,
                                                  bool unshaded) {
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

// Unit view vector as ops/shading.target_pdf_planes computes it.
__device__ __forceinline__ void unit_view(const Receiver& r, float& vx,
                                          float& vy, float& vz) {
  const float x0 = r.ox - r.px, y0 = r.oy - r.py, z0 = r.oz - r.pz;
  const float inv = 1.0f / fmaxf(safe_norm3(x0, y0, z0), 1e-20f);
  vx = x0 * inv; vy = y0 * inv; vz = z0 * inv;
}

// ops/wrs.gumbel_noise of one uniform.
__device__ __forceinline__ float gumbel_from(uint32_t bits) {
  return -logf(-logf(fmaxf(u01(bits), 1e-37f)));
}

template <int K>
struct StreamNoise {
  int dy, dx;
  float g[K];
};

// Offsets and race noise of stream s (s == R is self: no offsets).
template <int K>
__device__ __forceinline__ StreamNoise<K> stream_noise(const PassArgs& a, int s,
                                                       long long n, long long p,
                                                       uint32_t k0, uint32_t k1) {
  StreamNoise<K> z;
  z.dy = 0; z.dx = 0;
  if (a.gumbel != nullptr) {
    for (int l = 0; l < K; ++l) z.g[l] = a.gumbel[(static_cast<long long>(s) * K + l) * n + p];
    if (s < a.n_nbr) {
      z.dy = a.offs[static_cast<long long>(s) * n + p];
      z.dx = a.offs[(static_cast<long long>(a.n_nbr) + s) * n + p];
    }
    return z;
  }
  const U4 b = philox4x32_10(U4{static_cast<uint32_t>(2 * s), static_cast<uint32_t>(p),
                                static_cast<uint32_t>(p >> 32), a.tag}, k0, k1);
  z.dy = offset_from(b.x, a.radius);
  z.dx = offset_from(b.y, a.radius);
  z.g[0] = gumbel_from(b.z);
  if constexpr (K > 1) z.g[1] = gumbel_from(b.w);
  if constexpr (K > 2) {
    const U4 c = philox4x32_10(U4{static_cast<uint32_t>(2 * s + 1), static_cast<uint32_t>(p),
                                  static_cast<uint32_t>(p >> 32), a.tag}, k0, k1);
    z.g[2] = gumbel_from(c.x);
    if constexpr (K > 3) z.g[3] = gumbel_from(c.y);
  }
  return z;
}

// One input stream (the reservoir at pixel q) into every lane's race.
template <int K>
__device__ __forceinline__ void race(Lane (&L)[K], bool first, bool mask,
                                     const PassArgs& a, long long n, long long q,
                                     const Receiver& r, float vx, float vy,
                                     float vz, const float (&g)[K]) {
#pragma unroll
  for (int l = 0; l < K; ++l) {
    float pos[3], col[3];
    for (int c = 0; c < 3; ++c) {
      pos[c] = a.res[(3 * l + c) * n + q];
      col[c] = a.res[(3 * K + 3 * l + c) * n + q];
    }
    const float big_w = a.res[(8 * K + l) * n + q];
    const float m = a.res[(7 * K + l) * n + q];
    const float ph = target_pdf(r, vx, vy, vz, pos[0], pos[1], pos[2], col[0], col[1], col[2]);
    const float w = mask ? ph * big_w * m : 0.0f;
    const float score = w > 0.0f ? logf(fmaxf(w, 1e-37f)) + g[l] : -INFINITY;
    if (first || score > L[l].best) {
      L[l].best = score;
      for (int c = 0; c < 3; ++c) {
        L[l].sel[c] = pos[c];
        L[l].sel[3 + c] = col[c];
      }
      L[l].sel_w = w;
      L[l].sel_ph = ph;
    }
    L[l].w_sum = L[l].w_sum + w;
    L[l].m = L[l].m + (mask ? m : 0.0f);
  }
}

template <int K, bool kUnbiased>
__global__ void __launch_bounds__(kBlockX * kBlockY)
spatial_pass_kernel(const PassArgs a) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= a.h || j >= a.w) return;
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p = static_cast<long long>(i) * a.w + j;
  const Receiver r = load_receiver(a.cen, n, p, a.unshaded);
  float vx, vy, vz;
  unit_view(r, vx, vy, vz);
  const float recv_depth = a.cen[16 * n + p];
  uint32_t k0 = 0, k1 = 0;
  if (a.key != nullptr) {
    const unsigned long long kk = static_cast<unsigned long long>(a.key[0]);
    k0 = static_cast<uint32_t>(kk);
    k1 = static_cast<uint32_t>(kk >> 32);
  }

  Lane L[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    L[l].w_sum = 0.0f; L[l].m = 0.0f; L[l].best = -INFINITY;
    for (int c = 0; c < 6; ++c) L[l].sel[c] = 0.0f;
    L[l].sel_w = 0.0f; L[l].sel_ph = 0.0f;
  }
  const int nn = a.n_nbr;

  // Source pixel of neighbour s, clamped to the screen.
  auto source = [&](const StreamNoise<K>& z) -> long long {
    const long long y = min(max(static_cast<long long>(i) + z.dy, 0LL), static_cast<long long>(a.h - 1));
    const long long x = min(max(static_cast<long long>(j) + z.dx, 0LL), static_cast<long long>(a.w - 1));
    return y * a.w + x;
  };

  int qs[kUnbiased ? kMaxNbr : 1];
  if constexpr (kUnbiased) {
#pragma unroll
    for (int s = 0; s < kMaxNbr; ++s) {
      if (s < nn) {
        const StreamNoise<K> z = stream_noise<K>(a, s, n, p, k0, k1);
        const long long q = source(z);
        qs[s] = static_cast<int>(q);
        race<K>(L, s == 0, true, a, n, q, r, vx, vy, vz, z.g);
      }
    }
  } else {
    qs[0] = 0;
    for (int s = 0; s < nn; ++s) {
      const StreamNoise<K> z = stream_noise<K>(a, s, n, p, k0, k1);
      const long long q = source(z);
      // Similarity gates (render/restir.spatial_pass).
      const float nd = a.gates[3 * n + q];
      const bool depth_ok = fabsf(1.0f - nd / fmaxf(recv_depth, 1e-20f)) <= kDepthFrac;
      const bool normal_ok = a.gates[q] * r.nx + a.gates[n + q] * r.ny +
                                 a.gates[2 * n + q] * r.nz >= kNormalCos;
      const bool mask = depth_ok && normal_ok && r.valid && a.gates[4 * n + q] > 0.5f;
      race<K>(L, s == 0, mask, a, n, q, r, vx, vy, vz, z.g);
    }
  }
  {
    const StreamNoise<K> z = stream_noise<K>(a, nn, n, p, k0, k1);
    race<K>(L, nn == 0, true, a, n, p, r, vx, vy, vz, z.g);
  }

  float denom_m[K];
#pragma unroll
  for (int l = 0; l < K; ++l) denom_m[l] = L[l].m;
  if constexpr (kUnbiased) {
    // Z-count: each input's pre-pass m where its own p-hat of the winner is
    // positive, in stream order [neighbours..., self].
    float z[K];
#pragma unroll
    for (int l = 0; l < K; ++l) z[l] = 0.0f;
#pragma unroll
    for (int s = 0; s < kMaxNbr; ++s) {
      if (s < nn) {
        const long long q = qs[s];
        const Receiver rn = load_receiver(a.cen, n, q, a.unshaded);
        float nvx, nvy, nvz;
        unit_view(rn, nvx, nvy, nvz);
#pragma unroll
        for (int l = 0; l < K; ++l) {
          const float* sl = L[l].sel;
          const float pn = target_pdf(rn, nvx, nvy, nvz, sl[0], sl[1], sl[2], sl[3], sl[4], sl[5]);
          const float mn = a.res[(7 * K + l) * n + q];
          const float mf = pn > 0.0f ? mn : 0.0f;
          z[l] = z[l] + mf;
          if (a.vis != nullptr) a.vis[(2 * K + 3 * nn + s * K + l) * n + p] = mf;
        }
        if (a.vis != nullptr) {
          a.vis[(2 * K + 3 * s) * n + p] = rn.px;
          a.vis[(2 * K + 3 * s + 1) * n + p] = rn.py;
          a.vis[(2 * K + 3 * s + 2) * n + p] = rn.pz;
        }
      }
    }
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const float ms = a.res[(7 * K + l) * n + p];
      denom_m[l] = z[l] + (L[l].sel_ph > 0.0f ? ms : 0.0f);
      if (a.vis != nullptr) {
        a.vis[l * n + p] = denom_m[l];
        a.vis[(K + l) * n + p] = L[l].sel_ph;
      }
    }
  }

#pragma unroll
  for (int l = 0; l < K; ++l) {
    const bool cond = L[l].sel_ph > 0.0f && denom_m[l] > 0.0f;
    const float big_w = cond ? L[l].w_sum / (L[l].sel_ph * denom_m[l]) : 0.0f;
    for (int c = 0; c < 3; ++c) {
      a.out[(3 * l + c) * n + p] = L[l].sel[c];
      a.out[(3 * K + 3 * l + c) * n + p] = L[l].sel[3 + c];
    }
    a.out[(6 * K + l) * n + p] = L[l].w_sum;
    a.out[(7 * K + l) * n + p] = L[l].m;
    a.out[(8 * K + l) * n + p] = big_w;
    a.out[(9 * K + l) * n + p] = L[l].sel_w;
  }
}

template <int K>
cudaError_t launch_pass(const PassArgs& a, bool unbiased, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((a.w + kBlockX - 1) / kBlockX, (a.h + kBlockY - 1) / kBlockY);
  if (unbiased) {
    spatial_pass_kernel<K, true><<<grid, block, 0, stream>>>(a);
  } else {
    spatial_pass_kernel<K, false><<<grid, block, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace romis

extern "C" int romis_spatial_pass(const float* res, const float* gates,
                                  const float* cen, int h, int w, int k,
                                  int n_nbr, int radius, int unbiased,
                                  const long long* key, unsigned int tag,
                                  const int* offs, const float* gumbel,
                                  int unshaded, float* out, float* vis,
                                  cudaStream_t stream) {
  using namespace romis;
  if (unbiased && n_nbr > kMaxNbr) return static_cast<int>(cudaErrorInvalidValue);
  if (!unbiased && vis != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (!unbiased && gates == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if ((offs == nullptr) != (gumbel == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (offs == nullptr && key == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const PassArgs a{res, gates, cen, h, w, n_nbr, radius, key, tag, offs, gumbel,
                   unshaded != 0, out, vis};
  const bool ub = unbiased != 0;
  switch (k) {
    case 1: return static_cast<int>(launch_pass<1>(a, ub, stream));
    case 2: return static_cast<int>(launch_pass<2>(a, ub, stream));
    case 3: return static_cast<int>(launch_pass<3>(a, ub, stream));
    case 4: return static_cast<int>(launch_pass<4>(a, ub, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
