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
// The band entry (romis_spatial_pass_band, parallel/): a launch may cover a
// row band of a frame of h_global rows, whose first row is row_base. Its
// input planes (reservoirs, gates, context) then hold the band inside a
// halo of `halo` >= radius rows above and below (the neighbours' rows,
// parallel/halo.halo_extend; an edge band's outer halo is never read), and
// its outputs, noise and vis_check block the band's rows only. The records
// pre-pass runs over every input row; a neighbour row is clamped to the
// frame, [0, h_global), in frame rows and read at frame row - row_base +
// halo; the Philox counter takes the frame's pixel index. So a band's
// pixels draw, read and compute what the whole frame's launch does for
// them, bit for bit. Without a band halo = row_base = 0, h_global = h.
//
// Kernel 5 reads its neighbours from pixel-major records, as kernel 11
// does: its offsets are random per pixel, so in the plane layout each of a
// neighbour's 5 gate floats and 8K reservoir floats cost a 32-byte sector
// of their own (21 at K = 2). Its pre-pass (records_kernel, in the same
// entry, counted in the kernel's time) writes each pixel's reservoir record
// (kernel 11's, below) and its gate record, [normal 3 | depth] as one
// float4, the depth NaN where the pixel is invalid: NaN fails the depth
// gate exactly as an invalid neighbour fails the plane kernel's mask, so a
// neighbour costs a 16-byte and a 64-byte load at K = 2. A neighbour that
// the gates reject adds 0 to every lane's race, so its reservoir record is
// read only where it passes (or is stream 0, which the race selects when
// no weight is positive). The receiver reads its own planes (coalesced)
// and its self stream its own record; every operation and its order are
// the plane kernel's, so the outputs are bit-equal to it. K is a template
// parameter so each lane's race state stays in registers. Bound: compute,
// (R+1)·K target-PDF evaluations, one powf each, and the Philox draws per
// pixel; device memory sees 18 + 13K planes in for the receiver and the
// pre-pass, 10K planes out, and the records once written and read back.
//
// Kernel 11 reads its neighbours from pixel-major records. Its offsets are
// random per pixel, so the 32 lanes of a warp read 32 unrelated pixels: in
// the plane layout each of the 8K reservoir floats and the 16 context and
// K m floats of a neighbour costs a 32-byte sector of its own (about 35
// sectors a neighbour at K = 2, where its two records cost 4). A pre-pass
// (records_kernel, in the same entry, counted in the kernel's time) writes
// per pixel the race's reservoir record [pos 3 | col 3 | m | W] a lane and
// the Z sweep's context record [pos 3 | normal 3 | unit view 3 | kd 3 |
// ks 3 | shininess], the view computed once a pixel by unit_view's
// operations instead of once a neighbour. An invalid pixel's record holds
// kd = ks = 0 (shaded mode): its Phong is then 0, as the plain version's
// dead receiver's, so p-hat decides alike, for a neighbour and for the
// receiver, which reads its own record. Records are 64 B for K = 2, read as
// 16-byte loads; every operation and its order are the plane kernel's, so
// the outputs are bit-equal to it. The pass keeps the neighbours' pixels and
// m for the Z sweep in shared memory, which leaves it 80 registers and 3
// blocks an SM at K <= 2. Bound: compute, (R+1)·K
// plus R·K target-PDF evaluations per pixel; device memory sees 18 + 10K
// planes in, 10K planes out (2K + 3R + RK more in the vis_check mode),
// and the records once written and read back.
#include "common.cuh"

namespace romis {

constexpr float kDepthFrac = 0.1f;            // render/restir.SPATIAL_DEPTH_FRAC
constexpr float kNormalCos = 0.90630778703f;  // render/restir.SPATIAL_NORMAL_COS
constexpr int kMaxNbr = 8;                    // unbiased: neighbours a pixel
constexpr int kPassX = 16, kPassY = 16;     // the passes' blocks
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
  float* rres;          // [N, 8K] reservoir records
  float* rctx;          // unbiased: [N, 16] context records
  float* rgate;         // biased: [N, 4] gate records
  // The band: input rows (h + 2·halo), the halo, the band's first frame
  // row and the frame's rows (h_in = h, 0, 0, h for the whole frame).
  int h_in, halo, row_base, h_global;
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

// Offsets and race noise of stream s (s == R is self: no offsets): the
// injected planes at output pixel p of n, or Philox at frame pixel pg.
template <int K>
__device__ __forceinline__ StreamNoise<K> stream_noise(const PassArgs& a, int s,
                                                       long long n, long long p,
                                                       long long pg, uint32_t k0,
                                                       uint32_t k1) {
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
  const U4 b = philox4x32_10(U4{static_cast<uint32_t>(2 * s), static_cast<uint32_t>(pg),
                                static_cast<uint32_t>(pg >> 32), a.tag}, k0, k1);
  z.dy = offset_from(b.x, a.radius);
  z.dx = offset_from(b.y, a.radius);
  z.g[0] = gumbel_from(b.z);
  if constexpr (K > 1) z.g[1] = gumbel_from(b.w);
  if constexpr (K > 2) {
    const U4 c = philox4x32_10(U4{static_cast<uint32_t>(2 * s + 1), static_cast<uint32_t>(pg),
                                  static_cast<uint32_t>(pg >> 32), a.tag}, k0, k1);
    z.g[2] = gumbel_from(c.x);
    if constexpr (K > 3) z.g[3] = gumbel_from(c.y);
  }
  return z;
}

// The input row of the neighbour dy rows from output row i: the frame row
// clamped to the frame, then its row in the input planes.
__device__ __forceinline__ long long source_row(const PassArgs& a, int i, int dy) {
  const long long gy = min(max(static_cast<long long>(a.row_base) + i + dy, 0LL),
                           static_cast<long long>(a.h_global - 1));
  return gy - a.row_base + a.halo;
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

// The reservoir record of pixel q (a lane's pos 3 | col 3 | m | W, lane
// after lane) into every lane's race, as race() with the gates' mask; each
// lane's m also goes to m_out[l · stride], where given.
template <int K>
__device__ __forceinline__ void race_record(Lane (&L)[K], bool first, bool mask,
                                            const float* __restrict__ rres,
                                            long long q, const Receiver& r,
                                            float vx, float vy, float vz,
                                            const float (&g)[K], float* m_out,
                                            int stride) {
  const float4* src = reinterpret_cast<const float4*>(rres + q * 8 * K);
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float4 f0 = __ldg(src + 2 * l), f1 = __ldg(src + 2 * l + 1);
    const float pos[3] = {f0.x, f0.y, f0.z};
    const float col[3] = {f0.w, f1.x, f1.y};
    race_lane(L[l], first, mask, r, vx, vy, vz, pos, col, f1.w, f1.z, g[l]);
    if (m_out != nullptr) m_out[l * stride] = f1.z;
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

// Kernel 5: the biased pass on the records, 3 blocks an SM at K <= 2 (its
// latency wants the warps more than the registers: 85 a thread at most),
// 2 above (no spills).
template <int K>
__global__ void __launch_bounds__(kPassX * kPassY, K <= 2 ? 3 : 2)
spatial_pass_kernel(const PassArgs a) {
  const int j = blockIdx.x * kPassX + threadIdx.x;
  const int i = blockIdx.y * kPassY + threadIdx.y;
  if (i >= a.h || j >= a.w) return;
  const long long n = static_cast<long long>(a.h) * a.w;  // outputs, noise
  const long long n_in = static_cast<long long>(a.h_in) * a.w;
  const long long p = static_cast<long long>(i) * a.w + j;
  const long long p_in = p + static_cast<long long>(a.halo) * a.w;
  const long long pg = p + static_cast<long long>(a.row_base) * a.w;
  const Receiver r = load_receiver(a.cen, n_in, p_in, a.unshaded);
  float vx, vy, vz;
  unit_view(r, vx, vy, vz);
  const float recv_depth = a.cen[16 * n_in + p_in];
  const float4* gate = reinterpret_cast<const float4*>(a.rgate);
  uint32_t k0, k1;
  philox_key_words(a.key, k0, k1);
  Lane L[K];
  init_lanes<K>(L);
  const int nn = a.n_nbr;
  if (!r.valid && !a.unshaded && nn > 0) {
    // A missed receiver, shaded: every neighbour fails the gates and every
    // p-hat is 0, so no weight is positive and the race keeps stream 0's
    // sample (w = 0, p-hat 0); w_sum and m sum stream 0's 0 and the self
    // stream's w = 0·W·m and m, the full race's operations.
    const StreamNoise<K> z = stream_noise<K>(a, 0, n, p, pg, k0, k1);
    const long long y = source_row(a, i, z.dy);
    const long long x = min(max(static_cast<long long>(j) + z.dx, 0LL), static_cast<long long>(a.w - 1));
    const float4* src = reinterpret_cast<const float4*>(a.rres + (y * a.w + x) * 8 * K);
    const float4* own = reinterpret_cast<const float4*>(a.rres + p_in * 8 * K);
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const float4 f0 = __ldg(src + 2 * l), f1 = __ldg(src + 2 * l + 1);
      const float4 m1 = __ldg(own + 2 * l + 1);  // (col yz, m, W) of the self stream
      const float sel[6] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y};
      for (int c = 0; c < 6; ++c) L[l].sel[c] = sel[c];
      L[l].w_sum = (0.0f + 0.0f) + 0.0f * m1.w * m1.z;
      L[l].m = (0.0f + 0.0f) + m1.z;
    }
  }
  for (int s = 0; s < nn && (r.valid || a.unshaded); ++s) {
    const StreamNoise<K> z = stream_noise<K>(a, s, n, p, pg, k0, k1);
    // Source pixel of neighbour s, clamped to the screen.
    const long long y = source_row(a, i, z.dy);
    const long long x = min(max(static_cast<long long>(j) + z.dx, 0LL), static_cast<long long>(a.w - 1));
    const long long q = y * a.w + x;
    // Similarity gates (render/restir.spatial_pass); an invalid
    // neighbour's NaN depth fails the first.
    const float4 g = __ldg(gate + q);
    const bool depth_ok = fabsf(1.0f - g.w / fmaxf(recv_depth, 1e-20f)) <= kDepthFrac;
    const bool normal_ok = g.x * r.nx + g.y * r.ny + g.z * r.nz >= kNormalCos;
    const bool mask = depth_ok && normal_ok && r.valid;
    if (s == 0 || mask)
      race_record<K>(L, s == 0, mask, a.rres, q, r, vx, vy, vz, z.g, nullptr, 0);
  }
  if (r.valid || a.unshaded || nn == 0) {
    const StreamNoise<K> z = stream_noise<K>(a, nn, n, p, pg, k0, k1);
    race_record<K>(L, nn == 0, true, a.rres, p_in, r, vx, vy, vz, z.g, nullptr, 0);
  }
  float denom_m[K];
#pragma unroll
  for (int l = 0; l < K; ++l) denom_m[l] = L[l].m;
  write_lanes<K>(a, n, p, L, denom_m);
}

// The passes' pre-pass: each pixel's reservoir record and, for kernel 11,
// its context record, for kernel 5 its gate record. A block of 128 pixels
// reads its planes (coalesced), transposes them in shared memory (a padded
// stride: no bank conflicts) and writes its records as two contiguous
// runs.
constexpr int kRecThreads = 128;
constexpr int kGateRecord = 4;  // floats of a gate record

template <int K, bool kUnbiased>
__global__ void __launch_bounds__(kRecThreads)
records_kernel(const PassArgs a) {
  constexpr int RW = 8 * K + 1;
  constexpr int CR = kUnbiased ? kCtxRecord : kGateRecord, CW = CR + 1;
  __shared__ float sres[kRecThreads * RW];
  __shared__ float sctx[kRecThreads * CW];
  const long long n = static_cast<long long>(a.h_in) * a.w;  // every input row
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
    float* o = sctx + threadIdx.x * CW;
    if constexpr (kUnbiased) {
      const Receiver r = load_receiver(a.cen, n, p, a.unshaded);
      float vx, vy, vz;
      unit_view(r, vx, vy, vz);
      const bool lit = r.valid || r.unshaded;  // else kd = ks = 0: Phong is 0
      const float c[kCtxRecord] = {
          r.px, r.py, r.pz, r.nx, r.ny, r.nz, vx, vy, vz,
          lit ? r.kd[0] : 0.0f, lit ? r.kd[1] : 0.0f, lit ? r.kd[2] : 0.0f,
          lit ? r.ks[0] : 0.0f, lit ? r.ks[1] : 0.0f, lit ? r.ks[2] : 0.0f, r.shin};
#pragma unroll
      for (int f = 0; f < kCtxRecord; ++f) o[f] = c[f];
    } else {
      for (int c = 0; c < 3; ++c) o[c] = a.gates[c * n + p];
      o[3] = a.gates[4 * n + p] > 0.5f ? a.gates[3 * n + p] : __int_as_float(0x7fc00000);
    }
  }
  __syncthreads();
  float* rout = kUnbiased ? a.rctx : a.rgate;
  const int cnt = static_cast<int>(min(static_cast<long long>(kRecThreads), n - p0));
  for (int i = threadIdx.x; i < cnt * 8 * K; i += kRecThreads)
    a.rres[p0 * 8 * K + i] = sres[(i / (8 * K)) * RW + i % (8 * K)];
  for (int i = threadIdx.x; i < cnt * CR; i += kRecThreads)
    rout[p0 * CR + i] = sctx[(i / CR) * CW + i % CR];
}

// A pixel's context record as a Receiver: valid, since an invalid pixel's
// record holds kd = ks = 0 (shaded), and its unit view.
__device__ __forceinline__ Receiver ctx_record(const float* __restrict__ rctx,
                                               long long q, bool unshaded,
                                               float& vx, float& vy, float& vz) {
  const float4* src = reinterpret_cast<const float4*>(rctx + q * kCtxRecord);
  const float4 c0 = __ldg(src), c1 = __ldg(src + 1), c2 = __ldg(src + 2),
               c3 = __ldg(src + 3);
  Receiver r;
  r.unshaded = unshaded;
  r.valid = true;
  r.px = c0.x; r.py = c0.y; r.pz = c0.z;
  r.nx = c0.w; r.ny = c1.x; r.nz = c1.y;
  r.ox = 0.0f; r.oy = 0.0f; r.oz = 0.0f;  // the view is in the record
  r.kd[0] = c2.y; r.kd[1] = c2.z; r.kd[2] = c2.w;
  r.ks[0] = c3.x; r.ks[1] = c3.y; r.ks[2] = c3.z;
  r.shin = c3.w;
  vx = c1.z; vy = c1.w; vz = c2.x;
  return r;
}

// Kernel 11: the unbiased pass on the records. The receiver is its own
// context record too (its Phong, 0 where invalid, is the plain version's),
// and the neighbours' pixels and m wait for the Z sweep in shared memory:
// 80 registers, 3 blocks an SM at K <= 2. Its 16 x 16 blocks draw their
// neighbours from a 36 x 36 window, 11 % fewer pixels than 32 x 8's.
template <int K>
__global__ void __launch_bounds__(kPassX * kPassY, K <= 2 ? 3 : 1)
spatial_unbiased_kernel(const PassArgs a) {
  constexpr int kStride = kPassX * kPassY;
  __shared__ int qs_s[kMaxNbr * kStride];
  __shared__ float ms_s[kMaxNbr * K * kStride];
  const int j = blockIdx.x * kPassX + threadIdx.x;
  const int i = blockIdx.y * kPassY + threadIdx.y;
  if (i >= a.h || j >= a.w) return;
  const long long n = static_cast<long long>(a.h) * a.w;  // outputs, noise
  const long long n_in = static_cast<long long>(a.h_in) * a.w;
  const long long p = static_cast<long long>(i) * a.w + j;
  const long long p_in = p + static_cast<long long>(a.halo) * a.w;
  const long long pg = p + static_cast<long long>(a.row_base) * a.w;
  int* qs = qs_s + threadIdx.y * kPassX + threadIdx.x;
  float* ms = ms_s + threadIdx.y * kPassX + threadIdx.x;
  float vx, vy, vz;
  const Receiver r = ctx_record(a.rctx, p_in, a.unshaded, vx, vy, vz);
  uint32_t k0, k1;
  philox_key_words(a.key, k0, k1);
  Lane L[K];
  init_lanes<K>(L);
  const int nn = a.n_nbr;
#pragma unroll
  for (int s = 0; s < kMaxNbr; ++s) {
    if (s < nn) {
      const StreamNoise<K> z = stream_noise<K>(a, s, n, p, pg, k0, k1);
      // Source pixel of neighbour s, clamped to the screen.
      const long long y = source_row(a, i, z.dy);
      const long long x = min(max(static_cast<long long>(j) + z.dx, 0LL), static_cast<long long>(a.w - 1));
      const int q = static_cast<int>(y * a.w + x);
      qs[s * kStride] = q;
      race_record<K>(L, s == 0, true, a.rres, q, r, vx, vy, vz, z.g, ms + s * K * kStride,
                     kStride);
    }
  }
  {
    const StreamNoise<K> z = stream_noise<K>(a, nn, n, p, pg, k0, k1);
    race_record<K>(L, nn == 0, true, a.rres, p_in, r, vx, vy, vz, z.g, nullptr, 0);
  }

  // Z-count: each input's pre-pass m where its own p-hat of the winner is
  // positive, in stream order [neighbours..., self].
  float z[K];
#pragma unroll
  for (int l = 0; l < K; ++l) z[l] = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxNbr; ++s) {
    if (s < nn) {
      float nvx, nvy, nvz;
      const Receiver rn = ctx_record(a.rctx, qs[s * kStride], a.unshaded, nvx, nvy, nvz);
#pragma unroll
      for (int l = 0; l < K; ++l) {
        const float* sl = L[l].sel;
        const float pn = target_pdf(rn, nvx, nvy, nvz, sl[0], sl[1], sl[2], sl[3], sl[4], sl[5]);
        const float mf = pn > 0.0f ? ms[(s * K + l) * kStride] : 0.0f;
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
    const float m_self = a.res[(7 * K + l) * n_in + p_in];
    denom_m[l] = z[l] + (L[l].sel_ph > 0.0f ? m_self : 0.0f);
    if (a.vis != nullptr) {
      a.vis[l * n + p] = denom_m[l];
      a.vis[(K + l) * n + p] = L[l].sel_ph;
    }
  }
  write_lanes<K>(a, n, p, L, denom_m);
}

template <int K>
cudaError_t launch_pass(const PassArgs& a, bool unbiased, cudaStream_t stream) {
  const int rec_blocks = static_cast<int>(
      (static_cast<long long>(a.h_in) * a.w + kRecThreads - 1) / kRecThreads);
  if (unbiased)
    records_kernel<K, true><<<rec_blocks, kRecThreads, 0, stream>>>(a);
  else
    records_kernel<K, false><<<rec_blocks, kRecThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 block(kPassX, kPassY);
  const dim3 grid((a.w + kPassX - 1) / kPassX, (a.h + kPassY - 1) / kPassY);
  if (unbiased)
    spatial_unbiased_kernel<K><<<grid, block, 0, stream>>>(a);
  else
    spatial_pass_kernel<K><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace romis

namespace {

int spatial_pass_entry(const float* res, const float* gates, const float* cen,
                       int h, int w, int k, int n_nbr, int radius,
                       int unbiased, const long long* key, unsigned int tag,
                       const int* offs, const float* gumbel, int unshaded,
                       float* out, float* vis, float* rres, float* rctx,
                       float* rgate, int halo, int row_base, int h_global,
                       cudaStream_t stream) {
  using namespace romis;
  if (unbiased && n_nbr > kMaxNbr) return static_cast<int>(cudaErrorInvalidValue);
  if (rres == nullptr || (rctx == nullptr) != (unbiased == 0) ||
      (rgate == nullptr) != (unbiased != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!unbiased && vis != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (!unbiased && gates == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if ((offs == nullptr) != (gumbel == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (offs == nullptr && key == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // A band's halo covers the neighbours' rows, inside the frame.
  if (halo < 0 || row_base < 0 || row_base + h > h_global ||
      (halo < radius && (row_base > 0 || row_base + h < h_global)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PassArgs a{res,   gates,        cen,  h,    w,   n_nbr,
                   radius, key,         tag,  offs, gumbel, unshaded != 0,
                   out,    vis,         rres, rctx, rgate,
                   h + 2 * halo, halo,  row_base, h_global};
  const bool ub = unbiased != 0;
  switch (k) {
    case 1: return static_cast<int>(launch_pass<1>(a, ub, stream));
    case 2: return static_cast<int>(launch_pass<2>(a, ub, stream));
    case 3: return static_cast<int>(launch_pass<3>(a, ub, stream));
    case 4: return static_cast<int>(launch_pass<4>(a, ub, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Scratch the pre-pass writes: rres [N, 8K] reservoir records; rctx
// [N, 16] context records (unbiased; null when biased); rgate [N, 4] gate
// records (biased; null when unbiased).
extern "C" int romis_spatial_pass(const float* res, const float* gates,
                                  const float* cen, int h, int w, int k,
                                  int n_nbr, int radius, int unbiased,
                                  const long long* key, unsigned int tag,
                                  const int* offs, const float* gumbel,
                                  int unshaded, float* out, float* vis,
                                  float* rres, float* rctx, float* rgate,
                                  cudaStream_t stream) {
  return spatial_pass_entry(res, gates, cen, h, w, k, n_nbr, radius, unbiased,
                            key, tag, offs, gumbel, unshaded, out, vis, rres,
                            rctx, rgate, 0, 0, h, stream);
}

// The band entry: romis_spatial_pass's arguments for the band's h output
// rows, its inputs and the records over its h + 2·halo rows, then halo,
// row_base and h_global (the frame's rows).
extern "C" int romis_spatial_pass_band(const float* res, const float* gates,
                                       const float* cen, int h, int w, int k,
                                       int n_nbr, int radius, int unbiased,
                                       const long long* key, unsigned int tag,
                                       const int* offs, const float* gumbel,
                                       int unshaded, float* out, float* vis,
                                       float* rres, float* rctx, float* rgate,
                                       int halo, int row_base, int h_global,
                                       cudaStream_t stream) {
  return spatial_pass_entry(res, gates, cen, h, w, k, n_nbr, radius, unbiased,
                            key, tag, offs, gumbel, unshaded, out, vis, rres,
                            rctx, rgate, halo, row_base, h_global, stream);
}
