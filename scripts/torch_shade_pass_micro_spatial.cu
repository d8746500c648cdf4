// Variants of kernel 5 (the biased spatial pass, csrc/spatial.cu) that the
// package leaves out, for scripts/torch_shade_pass_micro.py. The package's
// spatial.cu is included for its helpers (the receiver, the Philox draws,
// the race on a reservoir record, the lanes' output) and its pre-pass
// (records_kernel), which every variant runs first. At K = 2:
// - variant 1: the pass in the parent's 32 x 8 blocks (the package: 16 x 16);
// - variant 2: the next neighbour's Philox draw and gate record loaded
//   before this neighbour's race (one stream of lookahead);
// - variant 3: the package's pass compiled for 4 blocks an SM (64
//   registers a thread);
// - variant 5: every neighbour's reservoir record read, whatever its gates
//   (the package skips a rejected neighbour's but stream 0's).
#include "spatial.cu"

namespace micro {
using namespace romis;

template <int K, int kBX, int kBY, bool kAhead, bool kSkip, int kMinBlocks>
__global__ void __launch_bounds__(kBX * kBY, kMinBlocks) pass_v(const PassArgs a) {
  const int j = blockIdx.x * kBX + threadIdx.x;
  const int i = blockIdx.y * kBY + threadIdx.y;
  if (i >= a.h || j >= a.w) return;
  const long long n = static_cast<long long>(a.h) * a.w;
  const long long p = static_cast<long long>(i) * a.w + j;
  const Receiver r = load_receiver(a.cen, n, p, a.unshaded);
  float vx, vy, vz;
  unit_view(r, vx, vy, vz);
  const float recv_depth = a.cen[16 * n + p];
  const float4* gate = reinterpret_cast<const float4*>(a.rgate);
  uint32_t k0, k1;
  philox_key_words(a.key, k0, k1);
  Lane L[K];
  init_lanes<K>(L);
  const int nn = a.n_nbr;
  auto draw = [&](int s, StreamNoise<K>& z, long long& q, float4& g) {
    z = stream_noise<K>(a, s, n, p, k0, k1);
    const long long y = min(max(static_cast<long long>(i) + z.dy, 0LL), static_cast<long long>(a.h - 1));
    const long long x = min(max(static_cast<long long>(j) + z.dx, 0LL), static_cast<long long>(a.w - 1));
    q = y * a.w + x;
    g = __ldg(gate + q);
  };
  StreamNoise<K> z{};
  long long q = 0;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kAhead && nn > 0) draw(0, z, q, g);
  for (int s = 0; s < nn; ++s) {
    StreamNoise<K> zn{};
    long long qn = 0;
    float4 gn = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kAhead) {
      if (s + 1 < nn) draw(s + 1, zn, qn, gn);
    } else {
      draw(s, z, q, g);
    }
    const bool depth_ok = fabsf(1.0f - g.w / fmaxf(recv_depth, 1e-20f)) <= kDepthFrac;
    const bool normal_ok = g.x * r.nx + g.y * r.ny + g.z * r.nz >= kNormalCos;
    const bool mask = depth_ok && normal_ok && r.valid;
    if (!kSkip || s == 0 || mask)
      race_record<K>(L, s == 0, mask, a.rres, q, r, vx, vy, vz, z.g, nullptr, 0);
    if (kAhead) {
      z = zn;
      q = qn;
      g = gn;
    }
  }
  {
    const StreamNoise<K> zs = stream_noise<K>(a, nn, n, p, k0, k1);
    race_record<K>(L, nn == 0, true, a.rres, p, r, vx, vy, vz, zs.g, nullptr, 0);
  }
  float denom_m[K];
#pragma unroll
  for (int l = 0; l < K; ++l) denom_m[l] = L[l].m;
  write_lanes<K>(a, n, p, L, denom_m);
}

template <int kBX, int kBY, bool kAhead, bool kSkip, int kMinBlocks>
int launch_v(const PassArgs& a, cudaStream_t stream) {
  constexpr int K = 2;
  const int rec_blocks = static_cast<int>(
      (static_cast<long long>(a.h) * a.w + kRecThreads - 1) / kRecThreads);
  records_kernel<K, false><<<rec_blocks, kRecThreads, 0, stream>>>(a);
  const dim3 block(kBX, kBY);
  const dim3 grid((a.w + kBX - 1) / kBX, (a.h + kBY - 1) / kBY);
  pass_v<K, kBX, kBY, kAhead, kSkip, kMinBlocks><<<grid, block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace micro

extern "C" int micro_spatial(int variant, const float* res, const float* gates,
                             const float* cen, int h, int w, int k, int n_nbr, int radius,
                             const long long* key, unsigned int tag, const int* offs,
                             const float* gumbel, int unshaded, float* out, float* rres,
                             float* rgate, cudaStream_t stream) {
  using namespace micro;
  if (k != 2) return static_cast<int>(cudaErrorInvalidValue);
  const PassArgs a{res,   gates, cen,  h,    w,      n_nbr,  radius, key,  tag,
                   offs,  gumbel, unshaded != 0, out, nullptr, rres, nullptr, rgate};
  switch (variant) {
    case 1: return launch_v<32, 8, false, true, 1>(a, stream);
    case 2: return launch_v<16, 16, true, true, 1>(a, stream);
    case 3: return launch_v<16, 16, false, true, 4>(a, stream);
    case 5: return launch_v<16, 16, false, false, 1>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
