// Kernel 16: similarity-gated neighbour selection over the ±radius box.
//
// Replaces romis_tpu/ops/pallas_nbrsel.py neighbour_select_pallas /
// _nbrsel_kernel. Per pixel, every in-image cell of the (2r+1)^2 box but
// the pixel itself is classed similar (same geometry, depth within a
// fraction, normal within an angle: render/neighbours._similar_planes) or
// dissimilar and scored with one noise value; the D best scores survive per
// class. One class (SIMILAR / DISSIMILAR): score = noise + 1e6 for the
// preferred class, -inf out of the image. Two classes
// (EQUAL_SIMILAR_DISSIMILAR): each class races its own noise, and both
// class counts are written. The deficit tail stays in torch.
//
// The TPU kernel DMAs a halo window per tile (radius <= 64), races D slots
// by replace-the-minimum and sorts them at the end. Here one thread per
// pixel walks the box in the plain version's order (dy-major, dx-minor,
// (0, 0) skipped) and keeps the D slots as a sorted list in registers: a
// candidate enters only if strictly above the last slot, and the carried
// entry sinks past entries of lower score or, at equal score, of a later
// offset. That is the order of the plain version's repeated first-maximum
// merge, so the two agree slot for slot, ties included. The gate planes
// of the block's window ((8 + 2r) x (32 + 2r) cells, 5 planes) are staged
// in shared memory when they fit, else read through the read-only cache;
// any radius works.
//
// Noise: the injected score planes [(2r+1)^2-1, N] (one per offset, in the
// walk's order), or standard Gumbel noise -log(-log u) from Philox4x32-10
// keyed by the 64-bit key in device memory, counter (offset / 4, pixel,
// tag) with tag = 0x4E53 << 16, disjoint from RIS (0), replay (0x5250) and
// the spatial passes (0x5350/0x5351). Gumbel, not the TPU kernel's bare
// uniform: within a class both rank uniformly, but 1e6 + u in f32 has only
// 16 levels and its ties would favour the first offsets of the box.
//
// Bound: operations. Per cell (440 at r = 10): the gates and their depth
// division, and with Philox a quarter of a Philox call, the conversion and
// 2 logarithms, about 220 float32-operation equivalents at their
// instruction cost; device memory sees 5 planes in and 2D or 4D + 2 planes
// out.
#include "common.cuh"

namespace romis {

constexpr int kTileW = 32, kTileH = 8;
constexpr int kMaxTileBytes = 160 * 1024;
constexpr float kClassOffset = 1e6f;

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

template <int D, bool kTwo>
__global__ void __launch_bounds__(kTileW * kTileH)
nbrsel_kernel(SelArgs a, bool use_smem) {
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
  if (x >= a.w || y >= a.h) return;
  const long long p = static_cast<long long>(y) * a.w + x;

  // Gate plane c at image cell (yy, xx), which lies inside the window.
  auto gate = [&](int c, int yy, int xx) -> float {
    if (use_smem) return tile[(c * th + (yy - y0)) * tw + (xx - x0)];
    return __ldg(a.gates + c * n + static_cast<long long>(yy) * a.w + xx);
  };
  const float c_geom = a.gates[p], c_depth = a.gates[n + p];
  const float c_nx = a.gates[2 * n + p], c_ny = a.gates[3 * n + p],
              c_nz = a.gates[4 * n + p];

  uint32_t k0 = 0, k1 = 0;
  if (a.key != nullptr) {
    const unsigned long long kk = static_cast<unsigned long long>(a.key[0]);
    k0 = static_cast<uint32_t>(kk);
    k1 = static_cast<uint32_t>(kk >> 32);
  }
  float sa[D], sb[D];
  int pa[D], pb[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    sa[i] = -INFINITY; sb[i] = -INFINITY; pa[i] = -1; pb[i] = -1;
  }
  int cnt_sim = 0, cnt_dis = 0;
  U4 bits{0u, 0u, 0u, 0u};
  int o = 0;  // offset index in the walk's order
  for (int dy = -r; dy <= r; ++dy) {
    const int yy = y + dy;
    const bool row_ok = yy >= 0 && yy < a.h;
    for (int dx = -r; dx <= r; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int xx = x + dx;
      const bool in_b = row_ok && xx >= 0 && xx < a.w;
      float g = 0.0f;
      if (a.scores == nullptr) {
        const int q = o & 3;
        if (q == 0) {
          bits = philox4x32_10(
              U4{static_cast<uint32_t>(o >> 2), static_cast<uint32_t>(p),
                 static_cast<uint32_t>(p >> 32), a.tag}, k0, k1);
        }
        const uint32_t b = q == 0 ? bits.x : q == 1 ? bits.y : q == 2 ? bits.z : bits.w;
        g = -logf(-logf(fmaxf(u01(b), 1e-37f)));
      } else if (in_b) {
        g = a.scores[o * n + p];
      }
      const int pack = (dy + r) * side + (dx + r);
      ++o;
      if (!in_b) continue;
      bool sim = true;
      if (a.same_geom) sim = gate(0, yy, xx) == c_geom;
      const float df = fabsf(1.0f - c_depth / fmaxf(gate(1, yy, xx), 1e-20f));
      sim = sim && df <= a.depth_frac;
      const float ndot = c_nx * gate(2, yy, xx) + c_ny * gate(3, yy, xx) +
                         c_nz * gate(4, yy, xx);
      sim = sim && ndot >= a.normal_cos;
      if (kTwo) {
        if (sim) {
          ++cnt_sim;
          race_insert<D>(sa, pa, g, pack);
        } else {
          ++cnt_dis;
          race_insert<D>(sb, pb, g, pack);
        }
      } else {
        const bool cls = a.prefer_similar ? sim : !sim;
        race_insert<D>(sa, pa, g + (cls ? kClassOffset : 0.0f), pack);
      }
    }
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
}

template <int D>
int launch_nbrsel(const SelArgs& a, bool two, cudaStream_t stream) {
  const int th = kTileH + 2 * a.radius, tw = kTileW + 2 * a.radius;
  const long long bytes = 5LL * th * tw * static_cast<long long>(sizeof(float));
  const bool use_smem = bytes <= kMaxTileBytes;
  const int smem = use_smem ? static_cast<int>(bytes) : 0;
  const dim3 grid((a.w + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH);
  const dim3 block(kTileW, kTileH);
  auto kernel = two ? nbrsel_kernel<D, true> : nbrsel_kernel<D, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, stream>>>(a, use_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace romis

extern "C" int romis_neighbour_select(const float* gates, int h, int w, int d,
                                      int radius, int two_classes,
                                      int prefer_similar, int same_geom,
                                      float depth_frac, float normal_cos,
                                      const long long* key, unsigned int tag,
                                      const float* scores, float* s_out,
                                      int* p_out, int* cnt,
                                      cudaStream_t stream) {
  using namespace romis;
  if (scores == nullptr && key == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const SelArgs a{gates, h, w, radius, prefer_similar != 0, same_geom != 0,
                  depth_frac, normal_cos, key, tag, scores, s_out, p_out, cnt};
  const bool two = two_classes != 0;
  switch (d) {
    case 1: return launch_nbrsel<1>(a, two, stream);
    case 2: return launch_nbrsel<2>(a, two, stream);
    case 3: return launch_nbrsel<3>(a, two, stream);
    case 4: return launch_nbrsel<4>(a, two, stream);
    case 5: return launch_nbrsel<5>(a, two, stream);
    case 6: return launch_nbrsel<6>(a, two, stream);
    case 7: return launch_nbrsel<7>(a, two, stream);
    case 8: return launch_nbrsel<8>(a, two, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
