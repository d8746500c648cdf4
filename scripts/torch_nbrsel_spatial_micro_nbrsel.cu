// Variants of kernel 16 (romis_tpu_torch/csrc/nbrsel.cu) for
// scripts/torch_nbrsel_spatial_micro.py: the selection in Philox mode with
// D = 5, built with -DMICRO_QUEUE=<entrants a lane holds> (default 4).
// Variants (micro_neighbour_select's `variant`):
//   0  the unfiltered race: two logarithms for every cell (the design
//      before the filter);
//   1  the filtered race scoring each passing cell at once (the warp idles
//      the lanes without one);
//   2  passing cells queued, scored in warp rounds (the package's design
//      but for its variant 19 below);
//   3  as 2, with the depth gate decided by products (a division only for
//      cells near the gate's edge; needs 0 <= depth_frac < 0.5);
//   +8 counts into counts[4] (unsigned long long): cells scored, cells
//      gated, warp scoring rounds (variants 1-3: log blocks a warp runs),
//      cells in the image;
//   +16 the staged window's path compiled alone (no read-only-cache path
//      in the loop), a cell's 5 gates read from one window index (19 is
//      the package's Philox kernel at a radius whose window fits);
//   +32 Philox's 20 round keys computed once a pixel.
// Every variant's outputs are the package kernel's, bit for bit.
#include "common.cuh"

namespace romis {

constexpr int kTileW = 32, kTileH = 8;
constexpr int kMaxTileBytes = 160 * 1024;
constexpr float kClassOffset = 1e6f;
constexpr int kPreferred = 1 << 24;  // class bit of a composite key
#ifndef MICRO_QUEUE
#define MICRO_QUEUE 4
#endif
constexpr int kQueue = MICRO_QUEUE;  // entrants a lane holds before its warp scores

struct SelArgs {
  const float* gates;  // [5, N]: geom_id | depth | normal3
  int h, w, radius;
  bool prefer_similar, same_geom;
  float depth_frac, normal_cos;
  const long long* key;  // [1] Philox key, or null with injected scores
  uint32_t tag;
  const float* scores;  // [(2r+1)^2 - 1, N] or null
  float* s_out;         // [classes, D, N]
  int* p_out;           // [classes, D, N]
  int* cnt;             // [2, N]
};

// The standard Gumbel score of a 24-bit uniform key: ops/wrs.gumbel_noise
// of u01 (common.cuh), -log(-log u) with u floored at 1e-37.
__device__ __forceinline__ float gumbel_of_key(uint32_t key) {
  return -logf(-logf(fmaxf(static_cast<float>(key) * (1.0f / 16777216.0f), 1e-37f)));
}

// Insert (score, pack) into the sorted slots; `pack` is later than every
// entry already there, so it enters only if strictly above the last slot.
template <int D>
__device__ __forceinline__ void race_insert(float (&s)[D], int (&p)[D],
                                            float score, int pack) {
  if (!(score > s[D - 1])) return;
  float cs = score;
  int cp = pack;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const bool take = cs > s[i] || (cs == s[i] && cp < p[i]);
    const float ts = s[i];
    const int tp = p[i];
    s[i] = take ? cs : ts;
    p[i] = take ? cp : tp;
    cs = take ? ts : cs;
    cp = take ? tp : cp;
  }
}

// The key race: the D largest composite keys so far, descending (-1 while
// fewer). Its last entry is the D-th largest key, and since g is
// non-decreasing, the D-th largest score of the race is g of it: a cell
// whose key is not above it cannot enter.
template <int D>
__device__ __forceinline__ void key_insert(int (&k)[D], int key) {
  if (key <= k[D - 1]) return;
  int c = key;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const int t = k[i];
    k[i] = c > t ? c : t;
    c = c > t ? t : c;
  }
}

// A lane's entrants waiting for their scores, first in first out.
struct Queue {
  int key[kQueue], pack[kQueue];  // composite key (class bit 24), box index
  int n;

  __device__ __forceinline__ void push(int k, int p) {
#pragma unroll
    for (int i = 0; i < kQueue; ++i) {
      if (i == n) { key[i] = k; pack[i] = p; }
    }
    ++n;
  }
  __device__ __forceinline__ void pop(int& k, int& p) {
    k = key[0]; p = pack[0];
#pragma unroll
    for (int i = 0; i + 1 < kQueue; ++i) { key[i] = key[i + 1]; pack[i] = pack[i + 1]; }
    --n;
  }
};


template <int D, bool kTwo, int kVar>
__global__ void __launch_bounds__(kTileW * kTileH)
micro_kernel(SelArgs a, bool use_smem, float lo_in, float hi_in, float lo_out,
             float hi_out, unsigned long long* counts) {
  constexpr int kDesign = kVar & 7;
  constexpr bool kCount = (kVar & 8) != 0;
  constexpr bool kHoist = (kVar & 16) != 0;  // the staged gates alone
  constexpr bool kKeys = (kVar & 32) != 0;   // Philox round keys once
  extern __shared__ float tile[];
  const int r = a.radius, side = 2 * r + 1;
  const int th = kTileH + 2 * r, tw = kTileW + 2 * r;
  const int x0 = blockIdx.x * kTileW - r, y0 = blockIdx.y * kTileH - r;
  const long long n = static_cast<long long>(a.h) * a.w;
  if (use_smem) {
    const int cells = th * tw;
    for (int i = threadIdx.y * kTileW + threadIdx.x; i < 5 * cells;
         i += kTileW * kTileH) {
      const int c = i / cells, rem = i - c * cells;
      const int yy = min(max(y0 + rem / tw, 0), a.h - 1);
      const int xx = min(max(x0 + rem % tw, 0), a.w - 1);
      tile[i] = a.gates[c * n + static_cast<long long>(yy) * a.w + xx];
    }
    __syncthreads();
  }
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  const unsigned warp = __ballot_sync(0xffffffffu, x < a.w && y < a.h);
  if (x >= a.w || y >= a.h) return;
  const long long p = static_cast<long long>(y) * a.w + x;
  auto gate = [&](int c, int yy, int xx) -> float {
    if (use_smem) return tile[(c * th + (yy - y0)) * tw + (xx - x0)];
    return __ldg(a.gates + c * n + static_cast<long long>(yy) * a.w + xx);
  };
  const float c_geom = a.gates[p], c_depth = a.gates[n + p];
  const float c_nx = a.gates[2 * n + p], c_ny = a.gates[3 * n + p],
              c_nz = a.gates[4 * n + p];
  unsigned long long n_scored = 0, n_gated = 0, n_rounds = 0, n_cells = 0;
  const int cells = th * tw;
  auto similar = [&](int yy, int xx) -> bool {
    if (kCount) ++n_gated;
    float g[5];
    if (kHoist) {
      const float* t = tile + (yy - y0) * tw + (xx - x0);
#pragma unroll
      for (int c = 0; c < 5; ++c) g[c] = t[c * cells];
    } else {
#pragma unroll
      for (int c = 0; c < 5; ++c) g[c] = gate(c, yy, xx);
    }
    bool sim = true;
    if (a.same_geom) sim = g[0] == c_geom;
    const float d = fmaxf(g[1], 1e-20f);
    bool depth_ok;
    if (kDesign == 3 && d < 1e30f) {
      // fl(c/d) in [1 - f, 1 + f] (Sterbenz: 1 - fl(c/d) is then exact)
      // when c lies between d·lo_in and d·hi_in, outside it when c lies
      // below d·lo_out or above d·hi_out (margins 2^-20 of the products'
      // and the quotient's roundings); between, or for NaN, divide.
      const float lo = d * lo_in, hi = d * hi_in;
      if (c_depth >= lo && c_depth <= hi) {
        depth_ok = true;
      } else if (c_depth < d * lo_out || c_depth > d * hi_out) {
        depth_ok = false;
      } else {
        depth_ok = fabsf(1.0f - c_depth / d) <= a.depth_frac;
      }
    } else {
      depth_ok = fabsf(1.0f - c_depth / d) <= a.depth_frac;
    }
    sim = sim && depth_ok;
    const float ndot = c_nx * g[2] + c_ny * g[3] + c_nz * g[4];
    return sim && ndot >= a.normal_cos;
  };
  float sa[D], sb[D];
  int pa[D], pb[D], ka[D], kb[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    sa[i] = -INFINITY; sb[i] = -INFINITY; pa[i] = -1; pb[i] = -1;
    ka[i] = -1; kb[i] = -1;
  }
  int cnt_sim = 0, cnt_dis = 0;
  const unsigned long long kk = static_cast<unsigned long long>(a.key[0]);
  const uint32_t k0 = static_cast<uint32_t>(kk), k1 = static_cast<uint32_t>(kk >> 32);
  uint32_t rk0[10], rk1[10];  // the round keys (kKeys)
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    rk0[i] = k0 + static_cast<uint32_t>(i) * 0x9E3779B9u;
    rk1[i] = k1 + static_cast<uint32_t>(i) * 0xBB67AE85u;
  }
  Queue qu;
  qu.n = 0;
  auto enter = [&](int ck, int pack) {
    if (kCount) ++n_scored;
    const float g = gumbel_of_key(static_cast<uint32_t>(ck) & (kPreferred - 1));
    const bool cls = (ck & kPreferred) != 0;
    if (kTwo) {
      if (cls) race_insert<D>(sa, pa, g, pack);
      else race_insert<D>(sb, pb, g, pack);
    } else {
      race_insert<D>(sa, pa, g + (cls ? kClassOffset : 0.0f), pack);
    }
  };
  auto score_one = [&]() {
    if (kCount) {
      const unsigned lead = __ballot_sync(warp, true);
      if ((threadIdx.x & 31) == __ffs(lead) - 1) ++n_rounds;
    }
    if (qu.n == 0) return;
    int ck, pack;
    qu.pop(ck, pack);
    enter(ck, pack);
  };
  U4 bits{0u, 0u, 0u, 0u};
  int o = 0;
  for (int dy = -r; dy <= r; ++dy) {
    const int yy = y + dy;
    const bool row_ok = yy >= 0 && yy < a.h;
    for (int dx = -r; dx <= r; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int xx = x + dx;
      const bool in_b = row_ok && xx >= 0 && xx < a.w;
      const int q = o & 3;
      if (q == 0) {
        const U4 ctr{static_cast<uint32_t>(o >> 2), static_cast<uint32_t>(p),
                     static_cast<uint32_t>(p >> 32), a.tag};
        if (kKeys) {
          U4 c = ctr;
#pragma unroll
          for (int i = 0; i < 10; ++i) {
            const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
            const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
            c = U4{hi1 ^ c.y ^ rk0[i], lo1, hi0 ^ c.w ^ rk1[i], lo0};
          }
          bits = c;
        } else {
          bits = philox4x32_10(ctr, k0, k1);
        }
      }
      ++o;
      const uint32_t b = q == 0 ? bits.x : q == 1 ? bits.y : q == 2 ? bits.z : bits.w;
      const int key = static_cast<int>(b >> 8);
      const int pack = (dy + r) * side + (dx + r);
      if (kCount && in_b) ++n_cells;
      if (kDesign == 0) {
        const float g = gumbel_of_key(static_cast<uint32_t>(key));
        if (in_b) {
          if (kCount) ++n_scored;
          const bool sim = similar(yy, xx);
          if (kTwo) {
            if (sim) { ++cnt_sim; race_insert<D>(sa, pa, g, pack); }
            else { ++cnt_dis; race_insert<D>(sb, pb, g, pack); }
          } else {
            const bool cls = a.prefer_similar ? sim : !sim;
            race_insert<D>(sa, pa, g + (cls ? kClassOffset : 0.0f), pack);
          }
        }
        continue;
      }
      int push = -1;
      if (kTwo) {
        if (in_b) {
          const bool sim = similar(yy, xx);
          cnt_sim += sim ? 1 : 0;
          cnt_dis += sim ? 0 : 1;
          if (sim && key > ka[D - 1]) {
            key_insert<D>(ka, key);
            push = kPreferred | key;
          } else if (!sim && key > kb[D - 1]) {
            key_insert<D>(kb, key);
            push = key;
          }
        }
      } else if (in_b && (kPreferred | key) > ka[D - 1]) {
        const bool sim = similar(yy, xx);
        const bool cls = a.prefer_similar ? sim : !sim;
        const int ck = (cls ? kPreferred : 0) | key;
        if (ck > ka[D - 1]) {
          key_insert<D>(ka, ck);
          push = ck;
        }
      }
      if (kDesign == 1) {
        if (kCount) {
          const bool any = __any_sync(warp, push >= 0);
          const unsigned lead = __ballot_sync(warp, true);
          if ((threadIdx.x & 31) == __ffs(lead) - 1 && any) ++n_rounds;
        }
        if (push >= 0) enter(push, pack);
      } else {
        if (push >= 0) qu.push(push, pack);
        if (__any_sync(warp, qu.n == kQueue)) score_one();
      }
    }
  }
  if (kDesign >= 2) {
    while (__any_sync(warp, qu.n > 0)) score_one();
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    a.s_out[i * n + p] = sa[i];
    a.p_out[i * n + p] = pa[i];
    if (kTwo) {
      a.s_out[(D + i) * n + p] = sb[i];
      a.p_out[(D + i) * n + p] = pb[i];
    }
  }
  a.cnt[p] = cnt_sim;
  a.cnt[n + p] = cnt_dis;
  if (kCount) {
    atomicAdd(counts, n_scored);
    atomicAdd(counts + 1, n_gated);
    atomicAdd(counts + 2, n_rounds);
    atomicAdd(counts + 3, n_cells);
  }
}

template <int D, bool kTwo, int kVar>
int launch_variant(const SelArgs& a, unsigned long long* counts,
                   cudaStream_t stream) {
  const int th = kTileH + 2 * a.radius, tw = kTileW + 2 * a.radius;
  const long long bytes = 5LL * th * tw * static_cast<long long>(sizeof(float));
  const bool use_smem = bytes <= kMaxTileBytes;
  const int smem = use_smem ? static_cast<int>(bytes) : 0;
  const dim3 grid((a.w + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH);
  const dim3 block(kTileW, kTileH);
  auto kernel = micro_kernel<D, kTwo, kVar>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // The product test's factors (see micro_kernel), from the host in double.
  const double f = a.depth_frac, m = 1.0 / (1 << 20);
  kernel<<<grid, block, smem, stream>>>(
      a, use_smem, static_cast<float>((1.0 - f) * (1.0 + m)),
      static_cast<float>((1.0 + f) * (1.0 - m)),
      static_cast<float>((1.0 - f) * (1.0 - m)),
      static_cast<float>((1.0 + f) * (1.0 + m)), counts);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTwo>
int launch_two(const SelArgs& a, int variant, unsigned long long* counts,
               cudaStream_t stream) {
  switch (variant) {
    case 0: return launch_variant<5, kTwo, 0>(a, counts, stream);
    case 1: return launch_variant<5, kTwo, 1>(a, counts, stream);
    case 2: return launch_variant<5, kTwo, 2>(a, counts, stream);
    case 3: return launch_variant<5, kTwo, 3>(a, counts, stream);
    case 8: return launch_variant<5, kTwo, 8>(a, counts, stream);
    case 9: return launch_variant<5, kTwo, 9>(a, counts, stream);
    case 10: return launch_variant<5, kTwo, 10>(a, counts, stream);
    case 18: return launch_variant<5, kTwo, 18>(a, counts, stream);
    case 19: return launch_variant<5, kTwo, 19>(a, counts, stream);
    case 50: return launch_variant<5, kTwo, 50>(a, counts, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace romis

// The package's romis_neighbour_select arguments (Philox key, D = 5), then
// variant and counts (device, 4 x u64, zeroed by the caller; null unless
// variant & 8).
extern "C" int micro_neighbour_select(const float* gates, int h, int w, int d,
                                      int radius, int two_classes,
                                      int prefer_similar, int same_geom,
                                      float depth_frac, float normal_cos,
                                      const long long* key, unsigned int tag,
                                      const float* scores, float* s_out,
                                      int* p_out, int* cnt, int variant,
                                      unsigned long long* counts,
                                      cudaStream_t stream) {
  using namespace romis;
  if (d != 5 || key == nullptr || scores != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if ((variant & 7) == 3 && !(depth_frac >= 0.0f && depth_frac < 0.5f))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((variant & 16) && 5LL * (kTileH + 2 * radius) * (kTileW + 2 * radius) * 4 > kMaxTileBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const SelArgs a{gates, h, w, radius, prefer_similar != 0, same_geom != 0,
                  depth_frac, normal_cos, key, tag, scores, s_out, p_out, cnt};
  return two_classes ? launch_two<true>(a, variant, counts, stream)
                     : launch_two<false>(a, variant, counts, stream);
}
