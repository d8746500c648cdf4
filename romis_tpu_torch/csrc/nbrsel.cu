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
// any radius works. The two ways are compiled apart: a choice made in the
// loop cost 2.0 of 7.2 ms at r = 10 (scripts/torch_nbrsel_spatial_micro.py,
// NVIDIA H100 80GB HBM3, 700 W).
// The depth gate's division is made only near the gate's edge; elsewhere
// two products decide the same bool (depth_factors).
//
// Noise: the injected score planes [(2r+1)^2-1, N] (one per offset, in the
// walk's order), or standard Gumbel noise -log(-log u) from Philox4x32-10
// keyed by the 64-bit key in device memory, counter (offset / 4, pixel,
// tag) with tag = 0x4E53 << 16, disjoint from RIS (0), replay (0x5250) and
// the spatial passes (0x5350/0x5351). Gumbel, not the TPU kernel's bare
// uniform: within a class both rank uniformly, but 1e6 + u in f32 has only
// 16 levels and its ties would favour the first offsets of the box.
//
// The filtered race (Philox mode). A cell's Gumbel score g(key) depends
// only on the top 24 bits of its word (u01), and the compiled g is
// non-decreasing in that key: chip_smoke.py checks all 2^24 keys through
// romis_gumbel_table, which runs the same inline function under the same
// flags. The class offset 1e6 rounds monotonically and puts every
// preferred score above every other, so a score is a non-decreasing
// function of the composite key (class << 24 | key). The D-th largest
// score so far is then g of the D-th largest composite key so far, which
// an integer race keeps (key_insert): a cell whose composite key is not
// above it cannot enter, and is skipped before its two logarithms (about
// 27 of 440 cells a race pass at D = 5, r = 10, on a random stream). In
// one class the gates are also skipped while even the cell's preferred
// composite key could not pass; two classes need every cell's gates for
// their counts. A cell that passes waits in its lane's queue: scoring it
// at once would idle the lanes that have none (a warp of 32 lanes meets a
// passing cell at about 258 of its 440 cells), so the warp scores in
// rounds, each lane its oldest waiting cell, when a queue is full and at
// the end. The scored cells enter the (score, pack) race in their walk
// order, so scores, packs, ties and counts are those of the unfiltered
// race, bit for bit. The skip is exact only while the compiled g is
// non-decreasing: chip_smoke.py requires table[i + 1] >= table[i] over the
// whole table, and a toolkit whose logf broke that would fail there.
//
// The band entry (romis_neighbour_select_band, parallel/): a launch may
// cover a row band of a frame of h_global rows whose first row is
// row_base. Its gate planes then hold the band inside a halo of `halo` >=
// radius rows above and below (parallel/halo.halo_extend), its score
// planes and outputs the band's rows only. A box cell is in the image when
// its frame row lies in [0, h_global) (an edge band's outer halo is never
// read), its gates are read at frame row - row_base + halo, and the
// Philox counter takes the frame's pixel index: a band's pixels select
// what the whole frame's launch selects for them, bit for bit. Without a
// band halo = row_base = 0, h_global = h.
//
// Bound: operations. Per cell (440 at r = 10): with Philox a quarter of a
// Philox call and the key test, the gates where the race needs the class;
// 2 logarithms and the conversion per scored cell; device memory sees 5
// planes in and 2D or 4D + 2 planes out. What remains is the Philox words
// and the gates: a warp evaluates a cell's gates whenever one of its lanes
// needs them, so the one-class skip of the gates saves little.
#include "common.cuh"

namespace romis {

constexpr int kTileW = 32, kTileH = 8;
constexpr int kMaxTileBytes = 160 * 1024;
constexpr float kClassOffset = 1e6f;
constexpr int kPreferred = 1 << 24;  // class bit of a composite key
constexpr int kQueue = 4;  // entrants a lane holds before its warp scores

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
  // The depth gate by products (both noise modes): c/d passes inside
  // [d·lo_in, d·hi_in], fails outside [d·lo_out, d·hi_out] (depth_factors).
  float lo_in, hi_in, lo_out, hi_out;
  // The band: the gate planes' rows (h + 2·halo), the halo, the band's
  // first frame row, the frame's rows (h, 0, 0, h for the whole frame).
  int h_in, halo, row_base, h_global;
};

// The products that decide the depth gate |1 - c/d| <= f for a cell of
// depth d (d = max(depth, 1e-20) < 1e30) and the pixel's depth c without
// the division, but near the gate's edge. For 0 <= f < 0.5, fl(c/d) lies
// in [1 - f, 1 + f] if c lies in [d·lo_in, d·hi_in], and outside it if c
// lies outside [d·lo_out, d·hi_out]: each factor is (1 ± f) moved by 2^-20,
// which covers the roundings of the factor, the product and the quotient
// (3 · 2^-24); and 1 - fl(c/d) is then exact (Sterbenz) or, beyond, rounds
// to at least 0.5 > f from the gate. Otherwise the factors make both tests
// fail and every cell divides.
inline void depth_factors(float f, float& lo_in, float& hi_in, float& lo_out,
                          float& hi_out) {
  if (f >= 0.0f && f < 0.5f) {
    const double m = 1.0 / (1 << 20);
    lo_in = static_cast<float>((1.0 - f) * (1.0 + m));
    hi_in = static_cast<float>((1.0 + f) * (1.0 - m));
    lo_out = static_cast<float>((1.0 - f) * (1.0 - m));
    hi_out = static_cast<float>((1.0 + f) * (1.0 + m));
  } else {
    lo_in = INFINITY; hi_in = -INFINITY; lo_out = -INFINITY; hi_out = INFINITY;
  }
}

// The depth gate |1 - c / max(d, 1e-20)| <= f, decided by the products where
// they decide it (depth_factors), else by the division.
__device__ __forceinline__ bool depth_gate(const SelArgs& a, float c, float depth) {
  const float d = fmaxf(depth, 1e-20f);
  if (d < 1e30f) {
    if (c >= d * a.lo_in && c <= d * a.hi_in) return true;
    if (c < d * a.lo_out || c > d * a.hi_out) return false;
  }
  return fabsf(1.0f - c / d) <= a.depth_frac;
}

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

// kPhilox: Philox noise (else injected scores); kStaged: the gates of the
// block's window staged in shared memory (else read through the read-only
// cache), as the radius allows. Each combination is compiled alone.
template <int D, bool kTwo, bool kPhilox, bool kStaged>
__global__ void __launch_bounds__(kTileW * kTileH)
nbrsel_kernel(SelArgs a) {
  extern __shared__ float tile[];
  const int r = a.radius, side = 2 * r + 1;
  const int th = kTileH + 2 * r, tw = kTileW + 2 * r, cells = th * tw;
  // The window's first row and column in the gate planes.
  const int x0 = blockIdx.x * kTileW - r, y0 = blockIdx.y * kTileH - r + a.halo;
  const long long n = static_cast<long long>(a.h) * a.w;  // scores, outputs
  const long long n_in = static_cast<long long>(a.h_in) * a.w;  // gates
  if (kStaged) {
    for (int i = threadIdx.y * kTileW + threadIdx.x; i < 5 * cells;
         i += kTileW * kTileH) {
      const int c = i / cells, rem = i - c * cells;
      const int yy = min(max(y0 + rem / tw, 0), a.h_in - 1);
      const int xx = min(max(x0 + rem % tw, 0), a.w - 1);
      tile[i] = a.gates[c * n_in + static_cast<long long>(yy) * a.w + xx];
    }
    __syncthreads();
  }
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  // A warp is a row of the tile: its lanes in the image vote together
  // (Philox mode).
  const unsigned warp = kPhilox ? __ballot_sync(0xffffffffu, x < a.w && y < a.h) : 0u;
  if (x >= a.w || y >= a.h) return;
  const long long p = static_cast<long long>(y) * a.w + x;
  const long long p_in = p + static_cast<long long>(a.halo) * a.w;
  const long long pg = p + static_cast<long long>(a.row_base) * a.w;
  const int yg = a.row_base + y;  // the pixel's frame row
  const int y_in = y + a.halo;    // its row in the gate planes

  const float c_geom = a.gates[p_in], c_depth = a.gates[n_in + p_in];
  const float c_nx = a.gates[2 * n_in + p_in], c_ny = a.gates[3 * n_in + p_in],
              c_nz = a.gates[4 * n_in + p_in];
  // The similarity gates of cell (yy, xx) of the gate planes
  // (render/neighbours._similar_planes):
  // its 5 gates from one window index, or from the planes; the depth gate
  // by products where they decide it (depth_gate).
  auto similar = [&](int yy, int xx) -> bool {
    float g[5];
    if (kStaged) {
      const float* t = tile + (yy - y0) * tw + (xx - x0);
#pragma unroll
      for (int c = 0; c < 5; ++c) g[c] = t[c * cells];
    } else {
      const float* t = a.gates + static_cast<long long>(yy) * a.w + xx;
#pragma unroll
      for (int c = 0; c < 5; ++c) g[c] = __ldg(t + c * n_in);
    }
    bool sim = true;
    if (a.same_geom) sim = g[0] == c_geom;
    sim = sim && depth_gate(a, c_depth, g[1]);
    const float ndot = c_nx * g[2] + c_ny * g[3] + c_nz * g[4];
    return sim && ndot >= a.normal_cos;
  };

  float sa[D], sb[D];
  int pa[D], pb[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    sa[i] = -INFINITY; sb[i] = -INFINITY; pa[i] = -1; pb[i] = -1;
  }
  int cnt_sim = 0, cnt_dis = 0;
  if (!kPhilox) {
    int o = 0;  // offset index in the walk's order
    for (int dy = -r; dy <= r; ++dy) {
      const int yy = y_in + dy;
      const bool row_ok = yg + dy >= 0 && yg + dy < a.h_global;
      for (int dx = -r; dx <= r; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const int xx = x + dx;
        const bool in_b = row_ok && xx >= 0 && xx < a.w;
        const int oo = o++;
        if (!in_b) continue;
        const float g = a.scores[oo * n + p];
        const int pack = (dy + r) * side + (dx + r);
        const bool sim = similar(yy, xx);
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
  } else {
    const unsigned long long kk = static_cast<unsigned long long>(a.key[0]);
    const uint32_t k0 = static_cast<uint32_t>(kk), k1 = static_cast<uint32_t>(kk >> 32);
    // The key races (one a class with two classes) and the lane's queue of
    // entrants. An entrant's score is computed in a round in which every
    // lane of the warp with a waiting entrant scores its oldest: a round
    // starts when a lane's queue is full, and at the end.
    int ka[D], kb[D];
#pragma unroll
    for (int i = 0; i < D; ++i) { ka[i] = -1; kb[i] = -1; }
    Queue qu;
    qu.n = 0;
    auto score_one = [&]() {
      if (qu.n == 0) return;
      int ck, pack;
      qu.pop(ck, pack);
      const float g = gumbel_of_key(static_cast<uint32_t>(ck) & (kPreferred - 1));
      const bool cls = (ck & kPreferred) != 0;
      if (kTwo) {
        if (cls) race_insert<D>(sa, pa, g, pack);
        else race_insert<D>(sb, pb, g, pack);
      } else {
        race_insert<D>(sa, pa, g + (cls ? kClassOffset : 0.0f), pack);
      }
    };
    U4 bits{0u, 0u, 0u, 0u};
    int o = 0;  // offset index in the walk's order
    for (int dy = -r; dy <= r; ++dy) {
      const int yy = y_in + dy;
      const bool row_ok = yg + dy >= 0 && yg + dy < a.h_global;
      for (int dx = -r; dx <= r; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const int xx = x + dx;
        const bool in_b = row_ok && xx >= 0 && xx < a.w;
        const int q = o & 3;
        if (q == 0) {
          bits = philox4x32_10(
              U4{static_cast<uint32_t>(o >> 2), static_cast<uint32_t>(pg),
                 static_cast<uint32_t>(pg >> 32), a.tag}, k0, k1);
        }
        ++o;
        const uint32_t b = q == 0 ? bits.x : q == 1 ? bits.y : q == 2 ? bits.z : bits.w;
        const int key = static_cast<int>(b >> 8);
        const int pack = (dy + r) * side + (dx + r);
        if (kTwo) {
          if (in_b) {
            const bool sim = similar(yy, xx);
            cnt_sim += sim ? 1 : 0;
            cnt_dis += sim ? 0 : 1;
            if (sim && key > ka[D - 1]) {
              key_insert<D>(ka, key);
              qu.push(kPreferred | key, pack);
            } else if (!sim && key > kb[D - 1]) {
              key_insert<D>(kb, key);
              qu.push(key, pack);
            }
          }
        } else if (in_b && (kPreferred | key) > ka[D - 1]) {
          // Gated only if, as a preferred cell, it could enter.
          const bool sim = similar(yy, xx);
          const bool cls = a.prefer_similar ? sim : !sim;
          const int ck = (cls ? kPreferred : 0) | key;
          if (ck > ka[D - 1]) {
            key_insert<D>(ka, ck);
            qu.push(ck, pack);
          }
        }
        if (__any_sync(warp, qu.n == kQueue)) score_one();
      }
    }
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
}

// g of every 24-bit key, by the kernel's own inline function: the check
// that the compiled g is non-decreasing, which the key skip needs.
__global__ void gumbel_table_kernel(float* out) {
  const uint32_t key = blockIdx.x * blockDim.x + threadIdx.x;
  if (key < (1u << 24)) out[key] = gumbel_of_key(key);
}

template <int D, bool kTwo, bool kPhilox>
int launch_classes(const SelArgs& a, cudaStream_t stream) {
  const int th = kTileH + 2 * a.radius, tw = kTileW + 2 * a.radius;
  const long long bytes = 5LL * th * tw * static_cast<long long>(sizeof(float));
  const bool staged = bytes <= kMaxTileBytes;
  const int smem = staged ? static_cast<int>(bytes) : 0;
  const dim3 grid((a.w + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH);
  const dim3 block(kTileW, kTileH);
  auto kernel = staged ? nbrsel_kernel<D, kTwo, kPhilox, true>
                       : nbrsel_kernel<D, kTwo, kPhilox, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_nbrsel(const SelArgs& a, bool two, cudaStream_t stream) {
  if (a.scores == nullptr) {
    return two ? launch_classes<D, true, true>(a, stream)
               : launch_classes<D, false, true>(a, stream);
  }
  return two ? launch_classes<D, true, false>(a, stream)
             : launch_classes<D, false, false>(a, stream);
}

}  // namespace romis

namespace {

int neighbour_select_entry(const float* gates, int h, int w, int d, int radius,
                           int two_classes, int prefer_similar, int same_geom,
                           float depth_frac, float normal_cos,
                           const long long* key, unsigned int tag,
                           const float* scores, float* s_out, int* p_out,
                           int* cnt, int halo, int row_base, int h_global,
                           cudaStream_t stream) {
  using namespace romis;
  if (scores == nullptr && key == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // A band's halo covers the box's rows, inside the frame.
  if (halo < 0 || row_base < 0 || row_base + h > h_global ||
      (halo < radius && (row_base > 0 || row_base + h < h_global)))
    return static_cast<int>(cudaErrorInvalidValue);
  SelArgs a{gates, h, w, radius, prefer_similar != 0, same_geom != 0,
            depth_frac, normal_cos, key, tag, scores, s_out, p_out, cnt,
            0.0f, 0.0f, 0.0f, 0.0f, h + 2 * halo, halo, row_base, h_global};
  depth_factors(depth_frac, a.lo_in, a.hi_in, a.lo_out, a.hi_out);
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

}  // namespace

extern "C" int romis_neighbour_select(const float* gates, int h, int w, int d,
                                      int radius, int two_classes,
                                      int prefer_similar, int same_geom,
                                      float depth_frac, float normal_cos,
                                      const long long* key, unsigned int tag,
                                      const float* scores, float* s_out,
                                      int* p_out, int* cnt,
                                      cudaStream_t stream) {
  return neighbour_select_entry(gates, h, w, d, radius, two_classes,
                                prefer_similar, same_geom, depth_frac,
                                normal_cos, key, tag, scores, s_out, p_out,
                                cnt, 0, 0, h, stream);
}

// The band entry: romis_neighbour_select's arguments for the band's h rows,
// the gates over its h + 2·halo rows, then halo, row_base and h_global
// (the frame's rows).
extern "C" int romis_neighbour_select_band(const float* gates, int h, int w,
                                           int d, int radius, int two_classes,
                                           int prefer_similar, int same_geom,
                                           float depth_frac, float normal_cos,
                                           const long long* key,
                                           unsigned int tag,
                                           const float* scores, float* s_out,
                                           int* p_out, int* cnt, int halo,
                                           int row_base, int h_global,
                                           cudaStream_t stream) {
  return neighbour_select_entry(gates, h, w, d, radius, two_classes,
                                prefer_similar, same_geom, depth_frac,
                                normal_cos, key, tag, scores, s_out, p_out,
                                cnt, halo, row_base, h_global, stream);
}

// out [2^24] f32: g of every key (gumbel_of_key).
extern "C" int romis_gumbel_table(float* out, cudaStream_t stream) {
  using namespace romis;
  gumbel_table_kernel<<<(1 << 24) / 256, 256, 0, stream>>>(out);
  return static_cast<int>(cudaGetLastError());
}
