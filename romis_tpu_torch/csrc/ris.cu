// Kernel 3: RIS candidate generation (canonical samples).
//
// Replaces romis_tpu/ops/pallas_ris.py gen_canonical_samples_pallas /
// _ris_kernel. Per pixel, S candidates spread over K lanes (candidate
// j = slot*K + lane, ops/wrs._lane_layout): uniform light pick, a point on
// the light (scene/lights.sample_lights_planes), the Phong target p-hat
// (ops/shading.target_pdf_planes), and a running exponential race per lane
// (argmax of w / E, E = -log u: the same winner as the plain version's
// Gumbel-max log w - log(-log u) for the same u). Output: the 10K
// reservoir planes in pack_reservoir_planes order.
//
// One thread per pixel walks its K lanes one after another, so the lane's
// whole state (w_sum, best score, winner) lives in registers. The light
// table ([L, 24] f32; 48 KB at the 512 lights of the flagship scene) is
// staged in shared memory when it fits 96 KB, else read through __ldg.
// Random numbers: Philox4x32-10 keyed by the 64-bit seed, counter
// (slot*K + lane, pixel, 0, 0) — a stream per (seed, pixel), one 4-word draw
// (pick, u, v, race) per candidate — or, when `uniforms` is given
// ([S/K, 4, K, N]), those numbers. Bound: compute, S x ~90 flops plus one
// powf per candidate; device-memory traffic is 17 planes in, 10K out.
//
// Kernel 14, the replay mode (kReplay), replaces
// romis_tpu/ops/pallas_ris.py gen_canonical_replay_pallas (the same
// _ris_kernel with replay=True): the detached candidate loop of the
// winner-replay surrogate gradient (ops/wrs.gen_canonical_surrogate). It
// runs TWO independent races per lane over the same candidates (Gumbel-max
// in log space, as the plain version, so the records are exact) and writes
// only their replay records, 7 planes per lane in the reference's order
// (w_sum, idx1, u1, v1, idx2, u2, v2; the light index as a float); the
// caller re-derives the reservoir differentiably from them. It needs 5
// uniforms per candidate (pick, u, v, race 1, race 2): Philox block
// (slot*K + lane, pixel, tag) gives the first four and block
// (..., tag | 1) the fifth, with tag = kReplayTag in the counter's last
// word, disjoint from the forward RIS (0) and the spatial passes
// (0x5350/0x5351 << 16); or they come from `uniforms` [S/K, 5, K, N]. The
// replay writes 7K planes instead of 10K and selects no position or
// colour, so it is the same compute bound with less traffic.
//
// Kernel 15, the MIS mode (kMis), replaces romis_tpu/ops/pallas_ris.py
// gen_mis_reservoir_planes (the same _ris_kernel in the MIS layout): every
// iteration of an R-MIS / R-OMIS frame draws its canonical reservoirs in
// ONE launch, `iters` x K lanes per thread, each iteration with the
// per-iteration lane counts and its own draws: Philox counter tag
// kMisTag | iteration, or the uniforms [iters, S/K, 4, K, N], which
// reproduce `iters` separate canonical calls exactly. The output is the
// sweep's pack, per iteration [pos 3K | color 3K | big_w K] (R-MIS, 7K
// planes) or [pos 3K | color 3K | w_sum K | chosen_w K] (R-OMIS, 8K), so
// no per-iteration repack follows. Same compute bound, iters times over;
// 17 planes in, iters x 7K or 8K out.
//
// Every mode takes the unshaded flag (Features.enable_shading=False): the
// target p-hat of a candidate is then the norm of the receiver's kd
// (Receiver::unshaded, phong_rgb), as in the plain version.
//
// The band entry (kernels 3, 14 and 15, parallel/): a launch may cover a
// row band of the frame, whose first pixel is `pix_base` = row_base * W in
// the frame. The Philox counter takes the frame's pixel index
// pix_base + p, so a band draws the numbers the whole frame's launch draws
// for its pixels; the RIS is pixel-local, so the band needs no halo.
// Without a band pix_base is 0.
#include "common.cuh"

namespace romis {

constexpr int kRowStride = 24;
constexpr int kMaxSmemLightBytes = 96 * 1024;
constexpr uint32_t kReplayTag = 0x5250u << 16;
constexpr uint32_t kMisTag = 0x4D49u << 16;
constexpr int kCanonical = 0, kReplayMode = 1, kMis = 2;

template <bool kSmem, int kMode>
__global__ void __launch_bounds__(kThreads)
ris_kernel(const float* __restrict__ ctx, long long n,
           const float* __restrict__ rows, int n_rows, int num_lights, int s,
           int k, uint32_t key0, uint32_t key1,
           const float* __restrict__ uniforms, float* __restrict__ out,
           int iters, bool romis, bool unshaded, long long pix_base) {
  constexpr bool kReplay = kMode == kReplayMode;
  constexpr int kUniforms = kReplay ? 5 : 4;
  extern __shared__ float s_rows[];
  if (kSmem) {
    for (int i = threadIdx.x; i < n_rows * kRowStride; i += blockDim.x)
      s_rows[i] = rows[i];
    __syncthreads();
  }
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const long long pg = pix_base + p;  // the pixel's index in the frame

  Receiver r;
  r.px = ctx[p]; r.py = ctx[n + p]; r.pz = ctx[2 * n + p];
  r.nx = ctx[3 * n + p]; r.ny = ctx[4 * n + p]; r.nz = ctx[5 * n + p];
  r.ox = ctx[6 * n + p]; r.oy = ctx[7 * n + p]; r.oz = ctx[8 * n + p];
  for (int c = 0; c < 3; ++c) {
    r.kd[c] = ctx[(9 + c) * n + p];
    r.ks[c] = ctx[(12 + c) * n + p];
  }
  r.shin = ctx[15 * n + p];
  r.valid = ctx[16 * n + p] > 0.5f;
  r.unshaded = unshaded;
  // Unit view vector, per pixel (hoisted out of the candidate loop).
  const float vx0 = r.ox - r.px, vy0 = r.oy - r.py, vz0 = r.oz - r.pz;
  const float vinv = 1.0f / fmaxf(safe_norm3(vx0, vy0, vz0), 1e-20f);
  const float vx = vx0 * vinv, vy = vy0 * vinv, vz = vz0 * vinv;

  const float nl = static_cast<float>(num_lights);
  const int sk = (s + k - 1) / k;
  for (int it = 0; it < iters; ++it) {
    const uint32_t tag = kReplay ? kReplayTag : kMode == kMis ? (kMisTag | it) : 0u;
    const float* u_it = uniforms == nullptr ? nullptr
        : uniforms + static_cast<long long>(it) * sk * kUniforms * k * n;
    for (int lane = 0; lane < k; ++lane) {
      float w_sum = 0.0f, best = -INFINITY, sel_w = 0.0f, sel_ph = 0.0f;
      float sel[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      // Replay records of the two races: (light index, u, v).
      float best2 = -INFINITY;
      float rec1[3] = {0.f, 0.f, 0.f}, rec2[3] = {0.f, 0.f, 0.f};
      int count = 0;
      for (int t = 0; t < sk; ++t) {
        const bool real = t * k + lane < s;
        count += real;
        float ui, u, v, ur, ur2 = 0.0f;
        if (u_it != nullptr) {
          const long long base = (static_cast<long long>(t) * kUniforms * k + lane) * n + p;
          ui = u_it[base];
          u = u_it[base + k * n];
          v = u_it[base + 2 * k * n];
          ur = u_it[base + 3 * k * n];
          if (kReplay) ur2 = u_it[base + 4 * k * n];
        } else {
          const U4 ctr{static_cast<uint32_t>(t * k + lane), static_cast<uint32_t>(pg),
                       static_cast<uint32_t>(pg >> 32), tag};
          const U4 b = philox4x32_10(ctr, key0, key1);
          ui = u01(b.x); u = u01(b.y); v = u01(b.z); ur = u01(b.w);
          if (kReplay) {
            const U4 b2 = philox4x32_10(U4{ctr.x, ctr.y, ctr.z, tag | 1u}, key0, key1);
            ur2 = u01(b2.x);
          }
        }
        const int pick = min(static_cast<int>(ui * nl), num_lights - 1);
        const int idx = min(max(pick, 0), n_rows - 1);
        const float* row = kSmem ? s_rows + idx * kRowStride : rows + idx * kRowStride;
        float q[21];
#pragma unroll
        for (int c = 0; c < 21; ++c) q[c] = kSmem ? row[c] : __ldg(row + c);
        const float lx = q[0] + u * q[3] + v * q[6];
        const float ly = q[1] + u * q[4] + v * q[7];
        const float lz = q[2] + u * q[5] + v * q[8];
        float col[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float lerp01 = q[9 + c] * (1.0f - u) + q[12 + c] * u;
          const float lerp23 = q[15 + c] * (1.0f - u) + q[18 + c] * u;
          col[c] = lerp01 * (1.0f - v) + lerp23 * v;
        }
        const float ph = target_pdf(r, vx, vy, vz, lx, ly, lz, col[0], col[1], col[2]);
        const float w = ph * nl * (real ? 1.0f : 0.0f);
        const float e_clock = -logf(fmaxf(ur, 1e-37f)) + 1e-37f;
        const float score = w > 0.0f ? w / e_clock : -INFINITY;
        w_sum = w_sum + w;
        if (kReplay) {
          // The plain version's Gumbel-max in log space, operation for
          // operation: the exponential race w / E picks the same winner in
          // exact arithmetic but rounds apart on a near tie (1 lane in 4 M
          // at 1080p on the flagship), and the replay records are exact.
          const float log_w = logf(fmaxf(w, 1e-37f));
          const float score1 =
              w > 0.0f ? log_w + -logf(-logf(fmaxf(ur, 1e-37f)) + 1e-37f) : -INFINITY;
          const float score2 =
              w > 0.0f ? log_w + -logf(-logf(fmaxf(ur2, 1e-37f)) + 1e-37f) : -INFINITY;
          if (score1 > best) {
            best = score1;
            rec1[0] = static_cast<float>(pick); rec1[1] = u; rec1[2] = v;
          }
          if (score2 > best2) {
            best2 = score2;
            rec2[0] = static_cast<float>(pick); rec2[1] = u; rec2[2] = v;
          }
        } else if (score > best) {
          best = score;
          sel[0] = lx; sel[1] = ly; sel[2] = lz;
          sel[3] = col[0]; sel[4] = col[1]; sel[5] = col[2];
          sel_w = w;
          sel_ph = ph;
        }
      }
      if (kReplay) {
        float* o = out + static_cast<long long>(7 * lane) * n + p;
        o[0] = w_sum;
        for (int c = 0; c < 3; ++c) {
          o[(1 + c) * n] = rec1[c];
          o[(4 + c) * n] = rec2[c];
        }
        continue;
      }
      const float m = static_cast<float>(count);
      const bool cond = sel_ph > 0.0f;
      const float big_w = cond ? w_sum / (sel_ph * m) : 0.0f;
      if (kMode == kMis) {
        // ops/mis.pack_mis_reservoirs order, one block per iteration.
        float* o = out + static_cast<long long>(it) * (romis ? 8 : 7) * k * n + p;
        for (int c = 0; c < 3; ++c) {
          o[(3 * lane + c) * n] = sel[c];
          o[(3 * k + 3 * lane + c) * n] = sel[3 + c];
        }
        if (romis) {
          o[(6 * k + lane) * n] = w_sum;
          o[(7 * k + lane) * n] = sel_w;
        } else {
          o[(6 * k + lane) * n] = big_w;
        }
        continue;
      }
      for (int c = 0; c < 3; ++c) {
        out[(3 * lane + c) * n + p] = sel[c];
        out[(3 * k + 3 * lane + c) * n + p] = sel[3 + c];
      }
      out[(6 * k + lane) * n + p] = w_sum;
      out[(7 * k + lane) * n + p] = m;
      out[(8 * k + lane) * n + p] = big_w;
      out[(9 * k + lane) * n + p] = sel_w;
    }
  }
}

}  // namespace romis

namespace {

template <int kMode>
int launch_ris(const float* ctx, long long n, const float* rows, int n_rows,
               int num_lights, int s, int k, unsigned long long seed,
               const float* uniforms, float* out, int iters, bool romis,
               bool unshaded, long long pix_base, cudaStream_t stream) {
  using namespace romis;
  const uint32_t key0 = static_cast<uint32_t>(seed);
  const uint32_t key1 = static_cast<uint32_t>(seed >> 32);
  const int smem = n_rows * kRowStride * static_cast<int>(sizeof(float));
  if (smem <= kMaxSmemLightBytes) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          ris_kernel<true, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    ris_kernel<true, kMode><<<blocks_for(n), kThreads, smem, stream>>>(
        ctx, n, rows, n_rows, num_lights, s, k, key0, key1, uniforms, out,
        iters, romis, unshaded, pix_base);
  } else {
    ris_kernel<false, kMode><<<blocks_for(n), kThreads, 0, stream>>>(
        ctx, n, rows, n_rows, num_lights, s, k, key0, key1, uniforms, out,
        iters, romis, unshaded, pix_base);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int romis_ris(const float* ctx, long long n, const float* rows,
                         int n_rows, int num_lights, int s, int k,
                         unsigned long long seed, const float* uniforms,
                         float* out, int unshaded, cudaStream_t stream) {
  return launch_ris<romis::kCanonical>(ctx, n, rows, n_rows, num_lights, s, k,
                                       seed, uniforms, out, 1, false,
                                       unshaded != 0, 0, stream);
}

// The band entry of kernel 3: romis_ris's arguments and pix_base, the
// frame's index of the launch's first pixel (a row band's row_base * W).
extern "C" int romis_ris_band(const float* ctx, long long n, const float* rows,
                              int n_rows, int num_lights, int s, int k,
                              unsigned long long seed, const float* uniforms,
                              float* out, int unshaded, long long pix_base,
                              cudaStream_t stream) {
  return launch_ris<romis::kCanonical>(ctx, n, rows, n_rows, num_lights, s, k,
                                       seed, uniforms, out, 1, false,
                                       unshaded != 0, pix_base, stream);
}

extern "C" int romis_ris_replay(const float* ctx, long long n, const float* rows,
                                int n_rows, int num_lights, int s, int k,
                                unsigned long long seed, const float* uniforms,
                                float* out, int unshaded, cudaStream_t stream) {
  return launch_ris<romis::kReplayMode>(ctx, n, rows, n_rows, num_lights, s,
                                        k, seed, uniforms, out, 1, false,
                                        unshaded != 0, 0, stream);
}

// The band entry of kernel 14: romis_ris_replay's arguments and pix_base,
// as in romis_ris_band.
extern "C" int romis_ris_replay_band(const float* ctx, long long n,
                                     const float* rows, int n_rows,
                                     int num_lights, int s, int k,
                                     unsigned long long seed,
                                     const float* uniforms, float* out,
                                     int unshaded, long long pix_base,
                                     cudaStream_t stream) {
  return launch_ris<romis::kReplayMode>(ctx, n, rows, n_rows, num_lights, s,
                                        k, seed, uniforms, out, 1, false,
                                        unshaded != 0, pix_base, stream);
}

extern "C" int romis_ris_mis(const float* ctx, long long n, const float* rows,
                             int n_rows, int num_lights, int s, int k,
                             unsigned long long seed, const float* uniforms,
                             float* out, int iters, int romis_pack,
                             int unshaded, cudaStream_t stream) {
  return launch_ris<romis::kMis>(ctx, n, rows, n_rows, num_lights, s, k, seed,
                                 uniforms, out, iters, romis_pack != 0,
                                 unshaded != 0, 0, stream);
}

// The band entry of kernel 15: romis_ris_mis's arguments and pix_base, as
// in romis_ris_band.
extern "C" int romis_ris_mis_band(const float* ctx, long long n,
                                  const float* rows, int n_rows,
                                  int num_lights, int s, int k,
                                  unsigned long long seed,
                                  const float* uniforms, float* out,
                                  int iters, int romis_pack, int unshaded,
                                  long long pix_base, cudaStream_t stream) {
  return launch_ris<romis::kMis>(ctx, n, rows, n_rows, num_lights, s, k, seed,
                                 uniforms, out, iters, romis_pack != 0,
                                 unshaded != 0, pix_base, stream);
}
