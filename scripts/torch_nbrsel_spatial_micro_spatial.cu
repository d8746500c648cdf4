// Variants of kernel 11 (romis_tpu_torch/csrc/spatial.cu, the unbiased
// spatial pass) for scripts/torch_nbrsel_spatial_micro.py, K = 2.
// Variants (micro_spatial_unbiased's `variant`):
//   0  the plane layout: every neighbour float a gather from its plane,
//      each neighbour's view recomputed in the Z sweep (the design before
//      the records);
//   1  the first records design: a thread a pixel writes its records
//      ([pos 3K | col 3K | m K | W K] and the context), then the pass on
//      them with the neighbours' pixels in registers;  2  that pre-pass
//      alone;  3  that pass alone on records written before;
//   4  a shared-memory window per 32 x 8 block ((8 + 2r) x (32 + 2r)
//      pixels), staged coalesced in two phases through one buffer: the 8K
//      reservoir floats, then the context (view computed once a window
//      pixel, kd = ks = 0 where invalid, as the records) and K m; offsets
//      beyond ±radius read the planes;
//   5  the first design's records written through shared memory
//      (contiguous stores), then its pass;  7  that pre-pass alone;
//   6  the first design's pre-pass, then its pass asking for 3 blocks an
//      SM (at most 85 registers);  8  that pass alone;
//   9  the second records design: a lane's record fields together
//      ([pos 3 | col 3 | m | W] a lane), the records written through
//      shared memory (the package's pre-pass), the neighbours' pixels in
//      shared memory;  11  its pre-pass alone;  10  its pass alone;
//      12  its pass asking for 3 blocks an SM, alone;
//   13-18  that pass alone with the next neighbour's records loaded ahead
//      (13), the receiver from its own context record (14), the
//      neighbours' m kept in shared memory (15), all three (16), and all
//      three (17) or the last two (18) asking for 3 blocks an SM;
//      19, 20  18 on 16 x 16 (the package's pass) and 64 x 4 blocks.
// Every variant's outputs are the package kernel's, bit for bit.
#include "common.cuh"

namespace romis {

constexpr float kDepthFrac = 0.1f;            // render/restir.SPATIAL_DEPTH_FRAC
constexpr float kNormalCos = 0.90630778703f;  // render/restir.SPATIAL_NORMAL_COS
constexpr int kMaxNbr = 8;                    // unbiased: offsets held in registers
constexpr int kBlockX = 32, kBlockY = 8;
constexpr int kCtxRecord = 16;                // floats of a context record

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
  float* vis;           // unbiased vis_check: [2K + 3R + RK, N], or null
  float* rres;          // unbiased: [N, 8K] reservoir records
  float* rctx;          // unbiased: [N, 16] context records
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

// One lane of one input stream: its sample (pos, col), W and m into the
// lane's race.
__device__ __forceinline__ void race_lane(Lane& L, bool first, bool mask,
                                          const Receiver& r, float vx,
                                          float vy, float vz,
                                          const float (&pos)[3],
                                          const float (&col)[3], float big_w,
                                          float m, float g) {
  const float ph = target_pdf(r, vx, vy, vz, pos[0], pos[1], pos[2], col[0], col[1], col[2]);
  const float w = mask ? ph * big_w * m : 0.0f;
  const float score = w > 0.0f ? logf(fmaxf(w, 1e-37f)) + g : -INFINITY;
  if (first || score > L.best) {
    L.best = score;
    for (int c = 0; c < 3; ++c) {
      L.sel[c] = pos[c];
      L.sel[3 + c] = col[c];
    }
    L.sel_w = w;
    L.sel_ph = ph;
  }
  L.w_sum = L.w_sum + w;
  L.m = L.m + (mask ? m : 0.0f);
}

// One input stream (the reservoir at pixel q, from the planes) into every
// lane's race.
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
    race_lane(L[l], first, mask, r, vx, vy, vz, pos, col, big_w, m, g[l]);
  }
}

// The reservoir record of pixel q [pos 3K | col 3K | m K | W K] into every
// lane's race (kernel 11).
template <int K>
__device__ __forceinline__ void race_record_first(Lane (&L)[K], bool first,
                                            const float* __restrict__ rres,
                                            long long q, const Receiver& r,
                                            float vx, float vy, float vz,
                                            const float (&g)[K]) {
  float v[8 * K];
  const float4* src = reinterpret_cast<const float4*>(rres + q * 8 * K);
#pragma unroll
  for (int j = 0; j < 2 * K; ++j) {
    const float4 f = __ldg(src + j);
    v[4 * j] = f.x; v[4 * j + 1] = f.y; v[4 * j + 2] = f.z; v[4 * j + 3] = f.w;
  }
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float pos[3] = {v[3 * l], v[3 * l + 1], v[3 * l + 2]};
    const float col[3] = {v[3 * K + 3 * l], v[3 * K + 3 * l + 1], v[3 * K + 3 * l + 2]};
    race_lane(L[l], first, true, r, vx, vy, vz, pos, col, v[7 * K + l], v[6 * K + l], g[l]);
  }
}

template <int K>
__device__ __forceinline__ void init_lanes(Lane (&L)[K]) {
#pragma unroll
  for (int l = 0; l < K; ++l) {
    L[l].w_sum = 0.0f; L[l].m = 0.0f; L[l].best = -INFINITY;
    for (int c = 0; c < 6; ++c) L[l].sel[c] = 0.0f;
    L[l].sel_w = 0.0f; L[l].sel_ph = 0.0f;
  }
}

__device__ __forceinline__ void philox_key_words(const long long* key,
                                                 uint32_t& k0, uint32_t& k1) {
  k0 = 0; k1 = 0;
  if (key != nullptr) {
    const unsigned long long kk = static_cast<unsigned long long>(key[0]);
    k0 = static_cast<uint32_t>(kk);
    k1 = static_cast<uint32_t>(kk >> 32);
  }
}

// The lanes' reservoirs out: W = wSum / (p-hat(winner)·denom).
template <int K>
__device__ __forceinline__ void write_lanes(const PassArgs& a, long long n,
                                            long long p, const Lane (&L)[K],
                                            const float (&denom_m)[K]) {
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

// Kernel 11's pre-pass: each pixel's reservoir and context records.
template <int K>
__global__ void __launch_bounds__(kThreads)
records_first_kernel(const PassArgs a) {
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  float4* rr = reinterpret_cast<float4*>(a.rres + p * 8 * K);
#pragma unroll
  for (int j = 0; j < 2 * K; ++j) {
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int f = 4 * j + c;  // record float f: plane f, or f + K past col
      v[c] = a.res[(f < 6 * K ? f : f + K) * n + p];
    }
    rr[j] = make_float4(v[0], v[1], v[2], v[3]);
  }
  const Receiver r = load_receiver(a.cen, n, p, a.unshaded);
  float vx, vy, vz;
  unit_view(r, vx, vy, vz);
  const bool lit = r.valid || r.unshaded;  // else kd = ks = 0: Phong is 0
  float4* rc = reinterpret_cast<float4*>(a.rctx + p * kCtxRecord);
  rc[0] = make_float4(r.px, r.py, r.pz, r.nx);
  rc[1] = make_float4(r.ny, r.nz, vx, vy);
  rc[2] = make_float4(vz, lit ? r.kd[0] : 0.0f, lit ? r.kd[1] : 0.0f,
                      lit ? r.kd[2] : 0.0f);
  rc[3] = make_float4(lit ? r.ks[0] : 0.0f, lit ? r.ks[1] : 0.0f,
                      lit ? r.ks[2] : 0.0f, r.shin);
}

// Kernel 11: the unbiased pass on the records.
template <int K>
__global__ void __launch_bounds__(kBlockX * kBlockY)
unbiased_first_kernel(const PassArgs a) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= a.h || j >= a.w) return;
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p = static_cast<long long>(i) * a.w + j;
  const Receiver r = load_receiver(a.cen, n, p, a.unshaded);
  float vx, vy, vz;
  unit_view(r, vx, vy, vz);
  uint32_t k0, k1;
  philox_key_words(a.key, k0, k1);
  Lane L[K];
  init_lanes<K>(L);
  const int nn = a.n_nbr;
  int qs[kMaxNbr];
#pragma unroll
  for (int s = 0; s < kMaxNbr; ++s) {
    if (s < nn) {
      const StreamNoise<K> z = stream_noise<K>(a, s, n, p, k0, k1);
      // Source pixel of neighbour s, clamped to the screen.
      const long long y = min(max(static_cast<long long>(i) + z.dy, 0LL), static_cast<long long>(a.h - 1));
      const long long x = min(max(static_cast<long long>(j) + z.dx, 0LL), static_cast<long long>(a.w - 1));
      qs[s] = static_cast<int>(y * a.w + x);
      race_record_first<K>(L, s == 0, a.rres, qs[s], r, vx, vy, vz, z.g);
    }
  }
  {
    const StreamNoise<K> z = stream_noise<K>(a, nn, n, p, k0, k1);
    race_record_first<K>(L, nn == 0, a.rres, p, r, vx, vy, vz, z.g);
  }

  // Z-count: each input's pre-pass m where its own p-hat of the winner is
  // positive, in stream order [neighbours..., self].
  float z[K];
#pragma unroll
  for (int l = 0; l < K; ++l) z[l] = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxNbr; ++s) {
    if (s < nn) {
      const long long q = qs[s];
      const float4* src = reinterpret_cast<const float4*>(a.rctx + q * kCtxRecord);
      const float4 c0 = __ldg(src), c1 = __ldg(src + 1), c2 = __ldg(src + 2),
                   c3 = __ldg(src + 3);
      Receiver rn;
      rn.unshaded = a.unshaded;
      rn.valid = true;  // an invalid pixel's record has kd = ks = 0
      rn.px = c0.x; rn.py = c0.y; rn.pz = c0.z;
      rn.nx = c0.w; rn.ny = c1.x; rn.nz = c1.y;
      rn.ox = 0.0f; rn.oy = 0.0f; rn.oz = 0.0f;  // the view is in the record
      rn.kd[0] = c2.y; rn.kd[1] = c2.z; rn.kd[2] = c2.w;
      rn.ks[0] = c3.x; rn.ks[1] = c3.y; rn.ks[2] = c3.z;
      rn.shin = c3.w;
      const float nvx = c1.z, nvy = c1.w, nvz = c2.x;
#pragma unroll
      for (int l = 0; l < K; ++l) {
        const float* sl = L[l].sel;
        const float pn = target_pdf(rn, nvx, nvy, nvz, sl[0], sl[1], sl[2], sl[3], sl[4], sl[5]);
        const float mn = __ldg(a.rres + q * 8 * K + 6 * K + l);
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
  float denom_m[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float ms = a.res[(7 * K + l) * n + p];
    denom_m[l] = z[l] + (L[l].sel_ph > 0.0f ? ms : 0.0f);
    if (a.vis != nullptr) {
      a.vis[l * n + p] = denom_m[l];
      a.vis[(K + l) * n + p] = L[l].sel_ph;
    }
  }
  write_lanes<K>(a, n, p, L, denom_m);
}


// Variant 6: the package's pass asking for 3 blocks an SM.
template <int K>
__global__ void __launch_bounds__(kBlockX * kBlockY, 3)
unbiased_first_min3_kernel(const PassArgs a) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= a.h || j >= a.w) return;
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p = static_cast<long long>(i) * a.w + j;
  const Receiver r = load_receiver(a.cen, n, p, a.unshaded);
  float vx, vy, vz;
  unit_view(r, vx, vy, vz);
  uint32_t k0, k1;
  philox_key_words(a.key, k0, k1);
  Lane L[K];
  init_lanes<K>(L);
  const int nn = a.n_nbr;
  int qs[kMaxNbr];
#pragma unroll
  for (int s = 0; s < kMaxNbr; ++s) {
    if (s < nn) {
      const StreamNoise<K> z = stream_noise<K>(a, s, n, p, k0, k1);
      // Source pixel of neighbour s, clamped to the screen.
      const long long y = min(max(static_cast<long long>(i) + z.dy, 0LL), static_cast<long long>(a.h - 1));
      const long long x = min(max(static_cast<long long>(j) + z.dx, 0LL), static_cast<long long>(a.w - 1));
      qs[s] = static_cast<int>(y * a.w + x);
      race_record_first<K>(L, s == 0, a.rres, qs[s], r, vx, vy, vz, z.g);
    }
  }
  {
    const StreamNoise<K> z = stream_noise<K>(a, nn, n, p, k0, k1);
    race_record_first<K>(L, nn == 0, a.rres, p, r, vx, vy, vz, z.g);
  }

  // Z-count: each input's pre-pass m where its own p-hat of the winner is
  // positive, in stream order [neighbours..., self].
  float z[K];
#pragma unroll
  for (int l = 0; l < K; ++l) z[l] = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxNbr; ++s) {
    if (s < nn) {
      const long long q = qs[s];
      const float4* src = reinterpret_cast<const float4*>(a.rctx + q * kCtxRecord);
      const float4 c0 = __ldg(src), c1 = __ldg(src + 1), c2 = __ldg(src + 2),
                   c3 = __ldg(src + 3);
      Receiver rn;
      rn.unshaded = a.unshaded;
      rn.valid = true;  // an invalid pixel's record has kd = ks = 0
      rn.px = c0.x; rn.py = c0.y; rn.pz = c0.z;
      rn.nx = c0.w; rn.ny = c1.x; rn.nz = c1.y;
      rn.ox = 0.0f; rn.oy = 0.0f; rn.oz = 0.0f;  // the view is in the record
      rn.kd[0] = c2.y; rn.kd[1] = c2.z; rn.kd[2] = c2.w;
      rn.ks[0] = c3.x; rn.ks[1] = c3.y; rn.ks[2] = c3.z;
      rn.shin = c3.w;
      const float nvx = c1.z, nvy = c1.w, nvz = c2.x;
#pragma unroll
      for (int l = 0; l < K; ++l) {
        const float* sl = L[l].sel;
        const float pn = target_pdf(rn, nvx, nvy, nvz, sl[0], sl[1], sl[2], sl[3], sl[4], sl[5]);
        const float mn = __ldg(a.rres + q * 8 * K + 6 * K + l);
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
  float denom_m[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float ms = a.res[(7 * K + l) * n + p];
    denom_m[l] = z[l] + (L[l].sel_ph > 0.0f ? ms : 0.0f);
    if (a.vis != nullptr) {
      a.vis[l * n + p] = denom_m[l];
      a.vis[(K + l) * n + p] = L[l].sel_ph;
    }
  }
  write_lanes<K>(a, n, p, L, denom_m);
}


// Variants 5 and 7: the records written through shared memory, so a
// warp's stores are contiguous (a block of 128 pixels reads its planes,
// transposes them in shared memory with a padded stride, and writes its
// records as one run each).
constexpr int kRecThreads = 128;

template <int K>
__global__ void __launch_bounds__(kRecThreads)
records_first_staged_kernel(const PassArgs a) {
  constexpr int RW = 8 * K + 1, CW = kCtxRecord + 1;
  __shared__ float sres[kRecThreads * RW];
  __shared__ float sctx[kRecThreads * CW];
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p0 = static_cast<long long>(blockIdx.x) * kRecThreads;
  const long long p = p0 + threadIdx.x;
  if (p < n) {
#pragma unroll
    for (int f = 0; f < 8 * K; ++f)
      sres[threadIdx.x * RW + f] = a.res[(f < 6 * K ? f : f + K) * n + p];
    const Receiver r = load_receiver(a.cen, n, p, a.unshaded);
    float vx, vy, vz;
    unit_view(r, vx, vy, vz);
    const bool lit = r.valid || r.unshaded;
    const float c[kCtxRecord] = {
        r.px, r.py, r.pz, r.nx, r.ny, r.nz, vx, vy, vz,
        lit ? r.kd[0] : 0.0f, lit ? r.kd[1] : 0.0f, lit ? r.kd[2] : 0.0f,
        lit ? r.ks[0] : 0.0f, lit ? r.ks[1] : 0.0f, lit ? r.ks[2] : 0.0f, r.shin};
#pragma unroll
    for (int f = 0; f < kCtxRecord; ++f) sctx[threadIdx.x * CW + f] = c[f];
  }
  __syncthreads();
  const int cnt = static_cast<int>(min(static_cast<long long>(kRecThreads), n - p0));
  for (int i = threadIdx.x; i < cnt * 8 * K; i += kRecThreads)
    a.rres[p0 * 8 * K + i] = sres[(i / (8 * K)) * RW + i % (8 * K)];
  for (int i = threadIdx.x; i < cnt * kCtxRecord; i += kRecThreads)
    a.rctx[p0 * kCtxRecord + i] = sctx[(i / kCtxRecord) * CW + i % kCtxRecord];
}

// Variant 0: the kernel as it read the planes.
template <int K>
__global__ void __launch_bounds__(kBlockX * kBlockY)
planes_kernel(const PassArgs a) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= a.h || j >= a.w) return;
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p = static_cast<long long>(i) * a.w + j;
  const Receiver r = load_receiver(a.cen, n, p, a.unshaded);
  float vx, vy, vz;
  unit_view(r, vx, vy, vz);
  uint32_t k0, k1;
  philox_key_words(a.key, k0, k1);
  Lane L[K];
  init_lanes<K>(L);
  const int nn = a.n_nbr;
  int qs[kMaxNbr];
#pragma unroll
  for (int s = 0; s < kMaxNbr; ++s) {
    if (s < nn) {
      const StreamNoise<K> z = stream_noise<K>(a, s, n, p, k0, k1);
      const long long y = min(max(static_cast<long long>(i) + z.dy, 0LL), static_cast<long long>(a.h - 1));
      const long long x = min(max(static_cast<long long>(j) + z.dx, 0LL), static_cast<long long>(a.w - 1));
      qs[s] = static_cast<int>(y * a.w + x);
      race<K>(L, s == 0, true, a, n, qs[s], r, vx, vy, vz, z.g);
    }
  }
  {
    const StreamNoise<K> z = stream_noise<K>(a, nn, n, p, k0, k1);
    race<K>(L, nn == 0, true, a, n, p, r, vx, vy, vz, z.g);
  }
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
  float denom_m[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float ms = a.res[(7 * K + l) * n + p];
    denom_m[l] = z[l] + (L[l].sel_ph > 0.0f ? ms : 0.0f);
    if (a.vis != nullptr) {
      a.vis[l * n + p] = denom_m[l];
      a.vis[(K + l) * n + p] = L[l].sel_ph;
    }
  }
  write_lanes<K>(a, n, p, L, denom_m);
}

// Variant 4: the shared-memory window.
template <int K>
__global__ void __launch_bounds__(kBlockX * kBlockY)
window_kernel(const PassArgs a) {
  extern __shared__ float win[];
  const int r = a.radius;
  const int th = kBlockY + 2 * r, tw = kBlockX + 2 * r, cells = th * tw;
  const int y0 = blockIdx.y * kBlockY - r, x0 = blockIdx.x * kBlockX - r;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const long long n = static_cast<long long>(a.h) * a.w;
  auto clamped = [&](int cell) -> long long {
    const int yy = min(max(y0 + cell / tw, 0), a.h - 1);
    const int xx = min(max(x0 + cell % tw, 0), a.w - 1);
    return static_cast<long long>(yy) * a.w + xx;
  };
  for (int idx = tid; idx < 8 * K * cells; idx += kBlockX * kBlockY) {
    const int c = idx / cells;
    win[idx] = a.res[(c < 6 * K ? c : c + K) * n + clamped(idx - c * cells)];
  }
  __syncthreads();
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const bool live = i < a.h && j < a.w;
  const long long p = live ? static_cast<long long>(i) * a.w + j : 0;
  Receiver r0;
  float vx = 0.0f, vy = 0.0f, vz = 0.0f;
  Lane L[K];
  init_lanes<K>(L);
  const int nn = a.n_nbr;
  int qs[kMaxNbr], cs[kMaxNbr];  // source pixel, window cell or -1
  if (live) {
    r0 = load_receiver(a.cen, n, p, a.unshaded);
    unit_view(r0, vx, vy, vz);
    uint32_t k0, k1;
    philox_key_words(a.key, k0, k1);
    auto race_at = [&](bool first, long long q, int cell, const float (&g)[K]) {
#pragma unroll
      for (int l = 0; l < K; ++l) {
        float pos[3], col[3], bw, m;
        if (cell >= 0) {
          for (int c = 0; c < 3; ++c) {
            pos[c] = win[(3 * l + c) * cells + cell];
            col[c] = win[(3 * K + 3 * l + c) * cells + cell];
          }
          m = win[(6 * K + l) * cells + cell];
          bw = win[(7 * K + l) * cells + cell];
        } else {
          for (int c = 0; c < 3; ++c) {
            pos[c] = a.res[(3 * l + c) * n + q];
            col[c] = a.res[(3 * K + 3 * l + c) * n + q];
          }
          m = a.res[(7 * K + l) * n + q];
          bw = a.res[(8 * K + l) * n + q];
        }
        race_lane(L[l], first, true, r0, vx, vy, vz, pos, col, bw, m, g[l]);
      }
    };
#pragma unroll
    for (int s = 0; s < kMaxNbr; ++s) {
      if (s < nn) {
        const StreamNoise<K> z = stream_noise<K>(a, s, n, p, k0, k1);
        const long long y = min(max(static_cast<long long>(i) + z.dy, 0LL), static_cast<long long>(a.h - 1));
        const long long x = min(max(static_cast<long long>(j) + z.dx, 0LL), static_cast<long long>(a.w - 1));
        qs[s] = static_cast<int>(y * a.w + x);
        const int wy = i + z.dy - y0, wx = j + z.dx - x0;
        cs[s] = (z.dy >= -r && z.dy <= r && z.dx >= -r && z.dx <= r) ? wy * tw + wx : -1;
        race_at(s == 0, qs[s], cs[s], z.g);
      }
    }
    const StreamNoise<K> z = stream_noise<K>(a, nn, n, p, k0, k1);
    race_at(nn == 0, p, (i - y0) * tw + (j - x0), z.g);
  }
  __syncthreads();
  // Phase 2: the context of every window pixel, its view computed once.
  for (int cell = tid; cell < cells; cell += kBlockX * kBlockY) {
    const long long q = clamped(cell);
    const Receiver rc = load_receiver(a.cen, n, q, a.unshaded);
    float ux, uy, uz;
    unit_view(rc, ux, uy, uz);
    const bool lit = rc.valid || rc.unshaded;
    const float v[16] = {rc.px, rc.py, rc.pz, rc.nx, rc.ny, rc.nz, ux, uy, uz,
                         lit ? rc.kd[0] : 0.0f, lit ? rc.kd[1] : 0.0f, lit ? rc.kd[2] : 0.0f,
                         lit ? rc.ks[0] : 0.0f, lit ? rc.ks[1] : 0.0f, lit ? rc.ks[2] : 0.0f,
                         rc.shin};
    for (int c = 0; c < 16; ++c) win[c * cells + cell] = v[c];
    for (int l = 0; l < K; ++l) win[(16 + l) * cells + cell] = a.res[(7 * K + l) * n + q];
  }
  __syncthreads();
  if (!live) return;
  float z[K];
#pragma unroll
  for (int l = 0; l < K; ++l) z[l] = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxNbr; ++s) {
    if (s < nn) {
      const long long q = qs[s];
      const int cell = cs[s];
      Receiver rn;
      float nvx, nvy, nvz, mn[K];
      if (cell >= 0) {
        rn.unshaded = a.unshaded;
        rn.valid = true;
        rn.px = win[cell]; rn.py = win[cells + cell]; rn.pz = win[2 * cells + cell];
        rn.nx = win[3 * cells + cell]; rn.ny = win[4 * cells + cell]; rn.nz = win[5 * cells + cell];
        nvx = win[6 * cells + cell]; nvy = win[7 * cells + cell]; nvz = win[8 * cells + cell];
        for (int c = 0; c < 3; ++c) {
          rn.kd[c] = win[(9 + c) * cells + cell];
          rn.ks[c] = win[(12 + c) * cells + cell];
        }
        rn.shin = win[15 * cells + cell];
        rn.ox = 0.0f; rn.oy = 0.0f; rn.oz = 0.0f;
        for (int l = 0; l < K; ++l) mn[l] = win[(16 + l) * cells + cell];
      } else {
        rn = load_receiver(a.cen, n, q, a.unshaded);
        unit_view(rn, nvx, nvy, nvz);
        for (int l = 0; l < K; ++l) mn[l] = a.res[(7 * K + l) * n + q];
      }
#pragma unroll
      for (int l = 0; l < K; ++l) {
        const float* sl = L[l].sel;
        const float pn = target_pdf(rn, nvx, nvy, nvz, sl[0], sl[1], sl[2], sl[3], sl[4], sl[5]);
        const float mf = pn > 0.0f ? mn[l] : 0.0f;
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
  float denom_m[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float ms = a.res[(7 * K + l) * n + p];
    denom_m[l] = z[l] + (L[l].sel_ph > 0.0f ? ms : 0.0f);
    if (a.vis != nullptr) {
      a.vis[l * n + p] = denom_m[l];
      a.vis[(K + l) * n + p] = L[l].sel_ph;
    }
  }
  write_lanes<K>(a, n, p, L, denom_m);
}

// The second design (variants 9-12): a lane's record fields together, the
// records written through shared memory, the neighbours' pixels in shared
// memory.
// The reservoir record of pixel q (a lane's pos 3 | col 3 | m | W, lane
// after lane) into every lane's race (kernel 11).
template <int K>
__device__ __forceinline__ void race_record(Lane (&L)[K], bool first,
                                            const float* __restrict__ rres,
                                            long long q, const Receiver& r,
                                            float vx, float vy, float vz,
                                            const float (&g)[K]) {
  const float4* src = reinterpret_cast<const float4*>(rres + q * 8 * K);
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float4 f0 = __ldg(src + 2 * l), f1 = __ldg(src + 2 * l + 1);
    const float pos[3] = {f0.x, f0.y, f0.z};
    const float col[3] = {f0.w, f1.x, f1.y};
    race_lane(L[l], first, true, r, vx, vy, vz, pos, col, f1.w, f1.z, g[l]);
  }
}

// Kernel 11's pre-pass: each pixel's reservoir and context records. A
// block of 128 pixels reads its planes (coalesced), transposes them in
// shared memory (a padded stride: no bank conflicts) and writes its records
// as two contiguous runs.

template <int K>
__global__ void __launch_bounds__(kRecThreads)
records_kernel(const PassArgs a) {
  constexpr int RW = 8 * K + 1, CW = kCtxRecord + 1;
  __shared__ float sres[kRecThreads * RW];
  __shared__ float sctx[kRecThreads * CW];
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p0 = static_cast<long long>(blockIdx.x) * kRecThreads;
  const long long p = p0 + threadIdx.x;
  if (p < n) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      float* o = sres + threadIdx.x * RW + 8 * l;
      for (int c = 0; c < 3; ++c) {
        o[c] = a.res[(3 * l + c) * n + p];
        o[3 + c] = a.res[(3 * K + 3 * l + c) * n + p];
      }
      o[6] = a.res[(7 * K + l) * n + p];
      o[7] = a.res[(8 * K + l) * n + p];
    }
    const Receiver r = load_receiver(a.cen, n, p, a.unshaded);
    float vx, vy, vz;
    unit_view(r, vx, vy, vz);
    const bool lit = r.valid || r.unshaded;  // else kd = ks = 0: Phong is 0
    const float c[kCtxRecord] = {
        r.px, r.py, r.pz, r.nx, r.ny, r.nz, vx, vy, vz,
        lit ? r.kd[0] : 0.0f, lit ? r.kd[1] : 0.0f, lit ? r.kd[2] : 0.0f,
        lit ? r.ks[0] : 0.0f, lit ? r.ks[1] : 0.0f, lit ? r.ks[2] : 0.0f, r.shin};
#pragma unroll
    for (int f = 0; f < kCtxRecord; ++f) sctx[threadIdx.x * CW + f] = c[f];
  }
  __syncthreads();
  const int cnt = static_cast<int>(min(static_cast<long long>(kRecThreads), n - p0));
  for (int i = threadIdx.x; i < cnt * 8 * K; i += kRecThreads)
    a.rres[p0 * 8 * K + i] = sres[(i / (8 * K)) * RW + i % (8 * K)];
  for (int i = threadIdx.x; i < cnt * kCtxRecord; i += kRecThreads)
    a.rctx[p0 * kCtxRecord + i] = sctx[(i / kCtxRecord) * CW + i % kCtxRecord];
}

// Kernel 11: the unbiased pass on the records.
template <int K>
__global__ void __launch_bounds__(kBlockX * kBlockY)
spatial_unbiased_kernel(const PassArgs a) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= a.h || j >= a.w) return;
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p = static_cast<long long>(i) * a.w + j;
  const Receiver r = load_receiver(a.cen, n, p, a.unshaded);
  float vx, vy, vz;
  unit_view(r, vx, vy, vz);
  uint32_t k0, k1;
  philox_key_words(a.key, k0, k1);
  Lane L[K];
  init_lanes<K>(L);
  const int nn = a.n_nbr;
  // The neighbours' pixels, kept for the Z sweep (in shared memory: fewer
  // registers, more warps an SM).
  __shared__ int qs_s[kMaxNbr][kBlockX * kBlockY];
  int* qs = &qs_s[0][threadIdx.y * kBlockX + threadIdx.x];
  constexpr int kQsStride = kBlockX * kBlockY;
#pragma unroll
  for (int s = 0; s < kMaxNbr; ++s) {
    if (s < nn) {
      const StreamNoise<K> z = stream_noise<K>(a, s, n, p, k0, k1);
      // Source pixel of neighbour s, clamped to the screen.
      const long long y = min(max(static_cast<long long>(i) + z.dy, 0LL), static_cast<long long>(a.h - 1));
      const long long x = min(max(static_cast<long long>(j) + z.dx, 0LL), static_cast<long long>(a.w - 1));
      const int q = static_cast<int>(y * a.w + x);
      qs[s * kQsStride] = q;
      race_record<K>(L, s == 0, a.rres, q, r, vx, vy, vz, z.g);
    }
  }
  {
    const StreamNoise<K> z = stream_noise<K>(a, nn, n, p, k0, k1);
    race_record<K>(L, nn == 0, a.rres, p, r, vx, vy, vz, z.g);
  }

  // Z-count: each input's pre-pass m where its own p-hat of the winner is
  // positive, in stream order [neighbours..., self].
  float z[K];
#pragma unroll
  for (int l = 0; l < K; ++l) z[l] = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxNbr; ++s) {
    if (s < nn) {
      const long long q = qs[s * kQsStride];
      const float4* src = reinterpret_cast<const float4*>(a.rctx + q * kCtxRecord);
      const float4 c0 = __ldg(src), c1 = __ldg(src + 1), c2 = __ldg(src + 2),
                   c3 = __ldg(src + 3);
      Receiver rn;
      rn.unshaded = a.unshaded;
      rn.valid = true;  // an invalid pixel's record has kd = ks = 0
      rn.px = c0.x; rn.py = c0.y; rn.pz = c0.z;
      rn.nx = c0.w; rn.ny = c1.x; rn.nz = c1.y;
      rn.ox = 0.0f; rn.oy = 0.0f; rn.oz = 0.0f;  // the view is in the record
      rn.kd[0] = c2.y; rn.kd[1] = c2.z; rn.kd[2] = c2.w;
      rn.ks[0] = c3.x; rn.ks[1] = c3.y; rn.ks[2] = c3.z;
      rn.shin = c3.w;
      const float nvx = c1.z, nvy = c1.w, nvz = c2.x;
#pragma unroll
      for (int l = 0; l < K; ++l) {
        const float* sl = L[l].sel;
        const float pn = target_pdf(rn, nvx, nvy, nvz, sl[0], sl[1], sl[2], sl[3], sl[4], sl[5]);
        const float mn = __ldg(a.rres + q * 8 * K + 8 * l + 6);
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
  float denom_m[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float ms = a.res[(7 * K + l) * n + p];
    denom_m[l] = z[l] + (L[l].sel_ph > 0.0f ? ms : 0.0f);
    if (a.vis != nullptr) {
      a.vis[l * n + p] = denom_m[l];
      a.vis[(K + l) * n + p] = L[l].sel_ph;
    }
  }
  write_lanes<K>(a, n, p, L, denom_m);
}

// Variant 12: the second design's pass asking for 3 blocks an SM.
template <int K>
__global__ void __launch_bounds__(kBlockX * kBlockY, 3)
spatial_unbiased_min3_kernel(const PassArgs a) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= a.h || j >= a.w) return;
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p = static_cast<long long>(i) * a.w + j;
  const Receiver r = load_receiver(a.cen, n, p, a.unshaded);
  float vx, vy, vz;
  unit_view(r, vx, vy, vz);
  uint32_t k0, k1;
  philox_key_words(a.key, k0, k1);
  Lane L[K];
  init_lanes<K>(L);
  const int nn = a.n_nbr;
  // The neighbours' pixels, kept for the Z sweep (in shared memory: fewer
  // registers, more warps an SM).
  __shared__ int qs_s[kMaxNbr][kBlockX * kBlockY];
  int* qs = &qs_s[0][threadIdx.y * kBlockX + threadIdx.x];
  constexpr int kQsStride = kBlockX * kBlockY;
#pragma unroll
  for (int s = 0; s < kMaxNbr; ++s) {
    if (s < nn) {
      const StreamNoise<K> z = stream_noise<K>(a, s, n, p, k0, k1);
      // Source pixel of neighbour s, clamped to the screen.
      const long long y = min(max(static_cast<long long>(i) + z.dy, 0LL), static_cast<long long>(a.h - 1));
      const long long x = min(max(static_cast<long long>(j) + z.dx, 0LL), static_cast<long long>(a.w - 1));
      const int q = static_cast<int>(y * a.w + x);
      qs[s * kQsStride] = q;
      race_record<K>(L, s == 0, a.rres, q, r, vx, vy, vz, z.g);
    }
  }
  {
    const StreamNoise<K> z = stream_noise<K>(a, nn, n, p, k0, k1);
    race_record<K>(L, nn == 0, a.rres, p, r, vx, vy, vz, z.g);
  }

  // Z-count: each input's pre-pass m where its own p-hat of the winner is
  // positive, in stream order [neighbours..., self].
  float z[K];
#pragma unroll
  for (int l = 0; l < K; ++l) z[l] = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxNbr; ++s) {
    if (s < nn) {
      const long long q = qs[s * kQsStride];
      const float4* src = reinterpret_cast<const float4*>(a.rctx + q * kCtxRecord);
      const float4 c0 = __ldg(src), c1 = __ldg(src + 1), c2 = __ldg(src + 2),
                   c3 = __ldg(src + 3);
      Receiver rn;
      rn.unshaded = a.unshaded;
      rn.valid = true;  // an invalid pixel's record has kd = ks = 0
      rn.px = c0.x; rn.py = c0.y; rn.pz = c0.z;
      rn.nx = c0.w; rn.ny = c1.x; rn.nz = c1.y;
      rn.ox = 0.0f; rn.oy = 0.0f; rn.oz = 0.0f;  // the view is in the record
      rn.kd[0] = c2.y; rn.kd[1] = c2.z; rn.kd[2] = c2.w;
      rn.ks[0] = c3.x; rn.ks[1] = c3.y; rn.ks[2] = c3.z;
      rn.shin = c3.w;
      const float nvx = c1.z, nvy = c1.w, nvz = c2.x;
#pragma unroll
      for (int l = 0; l < K; ++l) {
        const float* sl = L[l].sel;
        const float pn = target_pdf(rn, nvx, nvy, nvz, sl[0], sl[1], sl[2], sl[3], sl[4], sl[5]);
        const float mn = __ldg(a.rres + q * 8 * K + 8 * l + 6);
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
  float denom_m[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float ms = a.res[(7 * K + l) * n + p];
    denom_m[l] = z[l] + (L[l].sel_ph > 0.0f ? ms : 0.0f);
    if (a.vis != nullptr) {
      a.vis[l * n + p] = denom_m[l];
      a.vis[(K + l) * n + p] = L[l].sel_ph;
    }
  }
  write_lanes<K>(a, n, p, L, denom_m);
}

// Variants 13-18: the package's pass with the next neighbour's record
// loaded before the current one is raced and swept (kPrefetch), the
// receiver read from its own context record (kOwnRec: valid forced on,
// kd = ks = 0 where invalid, as for a neighbour), the neighbours' m kept
// in shared memory from the race for the Z sweep (kMsm), and the launch
// bound's blocks an SM.
template <int K, bool kPrefetch, bool kOwnRec, bool kMsm, int kMinBlocks,
          int BX = kBlockX, int BY = kBlockY>
__global__ void __launch_bounds__(BX * BY, kMinBlocks)
unbiased_v2_kernel(const PassArgs a) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= a.h || j >= a.w) return;
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p = static_cast<long long>(i) * a.w + j;
  auto ctx_record = [&](long long q, Receiver& rc, float& ux, float& uy,
                        float& uz) {
    const float4* src = reinterpret_cast<const float4*>(a.rctx + q * kCtxRecord);
    const float4 c0 = __ldg(src), c1 = __ldg(src + 1), c2 = __ldg(src + 2),
                 c3 = __ldg(src + 3);
    rc.unshaded = a.unshaded;
    rc.valid = true;
    rc.px = c0.x; rc.py = c0.y; rc.pz = c0.z;
    rc.nx = c0.w; rc.ny = c1.x; rc.nz = c1.y;
    rc.ox = 0.0f; rc.oy = 0.0f; rc.oz = 0.0f;
    rc.kd[0] = c2.y; rc.kd[1] = c2.z; rc.kd[2] = c2.w;
    rc.ks[0] = c3.x; rc.ks[1] = c3.y; rc.ks[2] = c3.z;
    rc.shin = c3.w;
    ux = c1.z; uy = c1.w; uz = c2.x;
  };
  Receiver r;
  float vx, vy, vz;
  if (kOwnRec) {
    ctx_record(p, r, vx, vy, vz);
  } else {
    r = load_receiver(a.cen, n, p, a.unshaded);
    unit_view(r, vx, vy, vz);
  }
  uint32_t k0, k1;
  philox_key_words(a.key, k0, k1);
  Lane L[K];
  init_lanes<K>(L);
  const int nn = a.n_nbr;
  constexpr int kStride = BX * BY;
  const int tid = threadIdx.y * BX + threadIdx.x;
  __shared__ int qs_s[kMaxNbr * kStride];
  __shared__ float ms_s[(kMsm ? kMaxNbr * K : 1) * kStride];
  int* qs = qs_s + tid;
  float* msv = ms_s + tid;
  auto source = [&](const StreamNoise<K>& z) -> int {
    const long long y = min(max(static_cast<long long>(i) + z.dy, 0LL), static_cast<long long>(a.h - 1));
    const long long x = min(max(static_cast<long long>(j) + z.dx, 0LL), static_cast<long long>(a.w - 1));
    return static_cast<int>(y * a.w + x);
  };
  auto load_rec = [&](int q, float4 (&f)[2 * K]) {
    const float4* src = reinterpret_cast<const float4*>(a.rres + static_cast<long long>(q) * 8 * K);
#pragma unroll
    for (int t = 0; t < 2 * K; ++t) f[t] = __ldg(src + t);
  };
  auto race_f = [&](bool first, const float4 (&f)[2 * K], const float (&g)[K]) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const float pos[3] = {f[2 * l].x, f[2 * l].y, f[2 * l].z};
      const float col[3] = {f[2 * l].w, f[2 * l + 1].x, f[2 * l + 1].y};
      race_lane(L[l], first, true, r, vx, vy, vz, pos, col, f[2 * l + 1].w,
                f[2 * l + 1].z, g[l]);
    }
  };
  {
    StreamNoise<K> zc;
    int qc = 0;
    float4 fc[2 * K];
    if (kPrefetch && nn > 0) {
      zc = stream_noise<K>(a, 0, n, p, k0, k1);
      qc = source(zc);
      load_rec(qc, fc);
    }
#pragma unroll
    for (int s = 0; s < kMaxNbr; ++s) {
      if (s < nn) {
        if (kPrefetch) {
          StreamNoise<K> zn;
          int qn = 0;
          float4 fn[2 * K];
          if (s + 1 < nn) {
            zn = stream_noise<K>(a, s + 1, n, p, k0, k1);
            qn = source(zn);
            load_rec(qn, fn);
          }
          qs[s * kStride] = qc;
          race_f(s == 0, fc, zc.g);
          if (kMsm) {
#pragma unroll
            for (int l = 0; l < K; ++l) msv[(s * K + l) * kStride] = fc[2 * l + 1].z;
          }
          if (s + 1 < nn) {
            zc = zn;
            qc = qn;
#pragma unroll
            for (int t = 0; t < 2 * K; ++t) fc[t] = fn[t];
          }
        } else {
          const StreamNoise<K> z = stream_noise<K>(a, s, n, p, k0, k1);
          const int q = source(z);
          qs[s * kStride] = q;
          float4 f[2 * K];
          load_rec(q, f);
          race_f(s == 0, f, z.g);
          if (kMsm) {
#pragma unroll
            for (int l = 0; l < K; ++l) msv[(s * K + l) * kStride] = f[2 * l + 1].z;
          }
        }
      }
    }
  }
  {
    const StreamNoise<K> z = stream_noise<K>(a, nn, n, p, k0, k1);
    float4 f[2 * K];
    load_rec(static_cast<int>(p), f);
    race_f(nn == 0, f, z.g);
  }
  float z[K];
#pragma unroll
  for (int l = 0; l < K; ++l) z[l] = 0.0f;
  auto sweep = [&](int s, int q, const Receiver& rn, float nvx, float nvy, float nvz) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const float* sl = L[l].sel;
      const float pn = target_pdf(rn, nvx, nvy, nvz, sl[0], sl[1], sl[2], sl[3], sl[4], sl[5]);
      const float mn = kMsm ? msv[(s * K + l) * kStride]
                            : __ldg(a.rres + static_cast<long long>(q) * 8 * K + 8 * l + 6);
      const float mf = pn > 0.0f ? mn : 0.0f;
      z[l] = z[l] + mf;
      if (a.vis != nullptr) a.vis[(2 * K + 3 * nn + s * K + l) * n + p] = mf;
    }
    if (a.vis != nullptr) {
      a.vis[(2 * K + 3 * s) * n + p] = rn.px;
      a.vis[(2 * K + 3 * s + 1) * n + p] = rn.py;
      a.vis[(2 * K + 3 * s + 2) * n + p] = rn.pz;
    }
  };
  if (kPrefetch) {
    Receiver rc;
    float ux = 0.0f, uy = 0.0f, uz = 0.0f;
    if (nn > 0) ctx_record(qs[0], rc, ux, uy, uz);
#pragma unroll
    for (int s = 0; s < kMaxNbr; ++s) {
      if (s < nn) {
        Receiver rnx;
        float wx = 0.0f, wy = 0.0f, wz = 0.0f;
        if (s + 1 < nn) ctx_record(qs[(s + 1) * kStride], rnx, wx, wy, wz);
        sweep(s, qs[s * kStride], rc, ux, uy, uz);
        if (s + 1 < nn) { rc = rnx; ux = wx; uy = wy; uz = wz; }
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < kMaxNbr; ++s) {
      if (s < nn) {
        Receiver rn;
        float nvx, nvy, nvz;
        const int q = qs[s * kStride];
        ctx_record(q, rn, nvx, nvy, nvz);
        sweep(s, q, rn, nvx, nvy, nvz);
      }
    }
  }
  float denom_m[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float ms = a.res[(7 * K + l) * n + p];
    denom_m[l] = z[l] + (L[l].sel_ph > 0.0f ? ms : 0.0f);
    if (a.vis != nullptr) {
      a.vis[l * n + p] = denom_m[l];
      a.vis[(K + l) * n + p] = L[l].sel_ph;
    }
  }
  write_lanes<K>(a, n, p, L, denom_m);
}

}  // namespace romis

// The package's romis_spatial_pass arguments (unbiased, K = 2), then
// variant.
extern "C" int micro_spatial_unbiased(const float* res, const float* gates,
                                      const float* cen, int h, int w, int k,
                                      int n_nbr, int radius, int unbiased,
                                      const long long* key, unsigned int tag,
                                      const int* offs, const float* gumbel,
                                      int unshaded, float* out, float* vis,
                                      float* rres, float* rctx, int variant,
                                      cudaStream_t stream) {
  using namespace romis;
  if (k != 2 || !unbiased || n_nbr > kMaxNbr) return static_cast<int>(cudaErrorInvalidValue);
  if ((offs == nullptr) != (gumbel == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (offs == nullptr && key == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const PassArgs a{res, gates, cen, h, w, n_nbr, radius, key, tag, offs, gumbel,
                   unshaded != 0, out, vis, rres, rctx};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  const int rec_blocks = blocks_for(static_cast<long long>(h) * w);
  switch (variant) {
    case 0: planes_kernel<2><<<grid, block, 0, stream>>>(a); break;
    case 1:
      records_first_kernel<2><<<rec_blocks, kThreads, 0, stream>>>(a);
      unbiased_first_kernel<2><<<grid, block, 0, stream>>>(a);
      break;
    case 2: records_first_kernel<2><<<rec_blocks, kThreads, 0, stream>>>(a); break;
    case 3: unbiased_first_kernel<2><<<grid, block, 0, stream>>>(a); break;
    case 5: {
      const int blocks = static_cast<int>((static_cast<long long>(h) * w + kRecThreads - 1) / kRecThreads);
      records_first_staged_kernel<2><<<blocks, kRecThreads, 0, stream>>>(a);
      unbiased_first_kernel<2><<<grid, block, 0, stream>>>(a);
      break;
    }
    case 6:
      records_first_kernel<2><<<rec_blocks, kThreads, 0, stream>>>(a);
      unbiased_first_min3_kernel<2><<<grid, block, 0, stream>>>(a);
      break;
    case 7: {
      const int blocks = static_cast<int>((static_cast<long long>(h) * w + kRecThreads - 1) / kRecThreads);
      records_first_staged_kernel<2><<<blocks, kRecThreads, 0, stream>>>(a);
      break;
    }
    case 8: unbiased_first_min3_kernel<2><<<grid, block, 0, stream>>>(a); break;
    case 9: {
      const int blocks = static_cast<int>((static_cast<long long>(h) * w + kRecThreads - 1) / kRecThreads);
      records_kernel<2><<<blocks, kRecThreads, 0, stream>>>(a);
      spatial_unbiased_kernel<2><<<grid, block, 0, stream>>>(a);
      break;
    }
    case 10: spatial_unbiased_kernel<2><<<grid, block, 0, stream>>>(a); break;
    case 11: {
      const int blocks = static_cast<int>((static_cast<long long>(h) * w + kRecThreads - 1) / kRecThreads);
      records_kernel<2><<<blocks, kRecThreads, 0, stream>>>(a);
      break;
    }
    case 12: spatial_unbiased_min3_kernel<2><<<grid, block, 0, stream>>>(a); break;
    case 13: unbiased_v2_kernel<2, true, false, false, 1><<<grid, block, 0, stream>>>(a); break;
    case 14: unbiased_v2_kernel<2, false, true, false, 1><<<grid, block, 0, stream>>>(a); break;
    case 15: unbiased_v2_kernel<2, false, false, true, 1><<<grid, block, 0, stream>>>(a); break;
    case 16: unbiased_v2_kernel<2, true, true, true, 1><<<grid, block, 0, stream>>>(a); break;
    case 17: unbiased_v2_kernel<2, true, true, true, 3><<<grid, block, 0, stream>>>(a); break;
    case 18: unbiased_v2_kernel<2, false, true, true, 3><<<grid, block, 0, stream>>>(a); break;
    case 19: {
      const dim3 b16(16, 16), g16((w + 15) / 16, (h + 15) / 16);
      unbiased_v2_kernel<2, false, true, true, 3, 16, 16><<<g16, b16, 0, stream>>>(a);
      break;
    }
    case 20: {
      const dim3 b64(64, 4), g64((w + 63) / 64, (h + 3) / 4);
      unbiased_v2_kernel<2, false, true, true, 3, 64, 4><<<g64, b64, 0, stream>>>(a);
      break;
    }
    case 4: {
      const int smem = 18 * (kBlockY + 2 * radius) * (kBlockX + 2 * radius) * 4;
      if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
      const cudaError_t err = cudaFuncSetAttribute(
          window_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      window_kernel<2><<<grid, block, smem, stream>>>(a);
      break;
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
